"""The node mesh of the sharded solver backend (port of ``repro.launch.mesh``).

``make_node_mesh(n)`` is the substrate of ``comm="sharded"``
(``core.comm.ShardedComm``): one graph node per rank, and of the gossip
train step's ``ppermute`` backend (``core.gossip.PodExchange``): one pod
per rank. The JAX call hands
back a mesh of N devices that one controller drives; the port keeps that
API and returns a ``NodeMesh`` that owns N worker processes, started with
the ``spawn`` context of ``torch.multiprocessing``. Rank r is graph node
r, positional as in the reference. Every worker joins one gloo process
group (a ``file://`` rendezvous in a fresh temporary directory, so
parallel test processes never race for a TCP port, and an explicit
timeout, so a stuck exchange fails instead of hanging).

All ranks of a mesh on the card bind the same device, ``cuda:0``: N
processes share the one card, each keeping its node's state there and
launching its step's kernels there. The transport between them is gloo,
which moves host tensors only: ``ShardedComm`` stages each block through
a pinned host buffer. NCCL, which would keep the exchange on the device,
needs one card a rank.

The parent drives the ranks with ``NodeMesh.run(fn, jobs)``: it sends
rank r the module-level function ``fn`` and ``jobs[r]``, each worker calls
``fn(rank, job)`` (``rank`` a ``NodeRank``) and the parent returns the N
results in rank order. A worker that raises, dies or stops answering
makes ``run`` close the mesh and raise with that worker's traceback.

A mesh is built once and reused: ``make_node_mesh`` keeps a registry keyed
by ``(n, device)``. ``close()`` (also a context manager's exit, and an
``atexit`` hook for every mesh still open) stops and joins the workers.

The production and test meshes of the within-pod half
(``make_production_mesh`` and ``make_test_mesh``: the FSDP x TP layouts
inside a pod) are not ported yet (ROADMAP Queue 1 item 10).
"""
from __future__ import annotations

import atexit
import dataclasses
import datetime
import os
import shutil
import subprocess
import tempfile
import time
import traceback
from multiprocessing.connection import wait as _wait_any

import torch

#: seconds a rank waits for a peer in one exchange (gloo's timeout) and the
#: parent waits for a silent rank before it declares the mesh stuck
TIMEOUT_S = 120
_START_TIMEOUT_S = 300

_MESHES: dict[tuple[int, str], "NodeMesh"] = {}


@dataclasses.dataclass(frozen=True)
class NodeRank:
    """What a worker knows of itself: its rank (graph node), the mesh size
    and the device its tensors live on."""

    rank: int
    n: int
    device: torch.device


def _device_key(device) -> str:
    """The registry's name of a device: ``"cuda"`` (the card) or ``"cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"node mesh runs on the card or the CPU, not {dev}")
    return dev.type


def _check_card(n: int) -> None:
    """Raise the reference's ValueError when the card cannot host n ranks."""
    if not torch.cuda.is_available():
        raise ValueError(
            f"node mesh needs {n} ranks on the card, found no CUDA device; "
            "pass device='cpu' to run the ranks on the CPU"
        )
    try:
        mode = subprocess.run(
            ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.split("\n")[0].strip()
    except (OSError, subprocess.SubprocessError):
        mode = ""
    if mode.replace(" ", "_").lower().startswith("exclusive_process"):
        raise ValueError(
            f"node mesh needs {n} ranks on one card, but its compute mode is "
            f"{mode}: it admits one CUDA context"
        )


def _worker(rank: int, n: int, device: str, init_file: str, build_dir: str, conn):
    """A rank's loop: join the group, then run the parent's jobs until told
    to stop (or until the parent's end of the pipe closes)."""
    # the parent built the kernels; load its libraries, never build N times
    os.environ["REPRO_COMPILE_CACHE_DIR"] = build_dir
    os.environ.pop("REPRO_NO_COMPILE_CACHE", None)
    # every rank is on this host: gloo's transport stays on the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    import torch.distributed as dist

    if device == "cpu":
        torch.set_num_threads(1)  # N ranks must not oversubscribe the host
        dev = torch.device("cpu")
    else:
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
    try:
        dist.init_process_group(
            "gloo", init_method=f"file://{init_file}", rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=TIMEOUT_S),
        )
        me = NodeRank(rank, n, dev)
        conn.send(("ready", os.getpid()))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
        return
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                break
            if msg[0] == "stop":
                break
            _, fn, job = msg
            try:
                out = fn(me, job)
            except BaseException:
                conn.send(("error", traceback.format_exc()))
            else:
                conn.send(("ok", out))
    finally:
        dist.destroy_process_group()


class NodeMesh:
    """N worker processes, one graph node each, in one gloo group.

    ``n`` ranks on ``device`` (``cuda`` or ``cpu``); ``ranks`` are the
    workers' process ids (a mesh rebuilt after ``close`` gets new ones, so
    it keys new runners).
    """

    def __init__(self, n: int, device):
        """Spawn the ranks and wait until every one has joined the group."""
        if int(n) < 1:
            raise ValueError(f"node mesh needs n >= 1, got {n}")
        self.n = int(n)
        self.device = torch.device(_device_key(device))
        self._procs: list = []
        self._conns: list = []
        from repro_torch.kernels import _build

        if self.device.type == "cuda":
            _check_card(self.n)
            # the ranks launch the solver step's kernels: build them here,
            # once, so N workers never run N nvcc jobs at once
            _build.build("sparse_saga")
        build_dir = str(_build.build_dir())
        self._dir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
        ctx = torch.multiprocessing.get_context("spawn")
        init_file = os.path.join(self._dir, "rendezvous")
        try:
            for r in range(self.n):
                parent, child = ctx.Pipe()
                p = ctx.Process(
                    target=_worker,
                    args=(r, self.n, self.device.type, init_file, build_dir, child),
                    daemon=True, name=f"node-mesh-rank{r}",
                )
                p.start()
                child.close()
                self._procs.append(p)
                self._conns.append(parent)
            self.ranks = tuple(self._collect(("ready",), _START_TIMEOUT_S))
        except BaseException:
            self.close()
            raise
        atexit.register(self.close)

    @property
    def closed(self) -> bool:
        """True once ``close`` ran (or a failed job closed the mesh)."""
        return not self._procs

    def pids(self) -> list[int]:
        """The process ids of the live workers."""
        return [p.pid for p in self._procs if p.is_alive()]

    def _collect(self, kinds, timeout_s: float) -> list:
        """One reply a rank, in rank order; any failure closes and raises."""
        out = [None] * self.n
        pending = set(range(self.n))
        last = time.monotonic()
        while pending:
            conns = {self._conns[r]: r for r in pending}
            ready = _wait_any(list(conns), timeout=1.0)
            for c in ready:
                r = conns[c]
                try:
                    kind, val = c.recv()
                except EOFError:
                    kind, val = "error", (
                        f"rank {r} exited (code {self._procs[r].exitcode}) "
                        "without a reply")
                if kind == "error":
                    self.close()
                    raise RuntimeError(f"node mesh rank {r} failed:\n{val}")
                assert kind in kinds, kind
                out[r] = val
                pending.discard(r)
                last = time.monotonic()
            for r in list(pending):
                p = self._procs[r]
                if not p.is_alive() and not self._conns[r].poll():
                    code = p.exitcode
                    self.close()
                    raise RuntimeError(
                        f"node mesh rank {r} died (exit code {code}) without a reply")
            if pending and time.monotonic() - last > timeout_s:
                self.close()
                raise RuntimeError(
                    f"node mesh ranks {sorted(pending)} did not answer within "
                    f"{timeout_s} s")
        return out

    def run(self, fn, jobs: list) -> list:
        """``fn(rank, jobs[r])`` on every rank r at once; the N results in
        rank order. ``fn`` must be a module-level function (it is pickled by
        name)."""
        if self.closed:
            raise RuntimeError("node mesh is closed")
        if len(jobs) != self.n:
            raise ValueError(f"{len(jobs)} jobs for a mesh of {self.n} ranks")
        for c, job in zip(self._conns, jobs):
            c.send(("run", fn, job))
        # a rank stuck in an exchange raises after gloo's timeout and
        # replies; the margin covers a job's own work between exchanges
        return self._collect(("ok",), 2 * TIMEOUT_S)

    def close(self) -> None:
        """Stop and join every worker (terminating any that does not stop),
        remove the rendezvous directory and leave the registry."""
        procs, conns = self._procs, self._conns
        self._procs, self._conns = [], []
        for c in conns:
            try:
                c.send(("stop",))
            except (OSError, ValueError):
                pass
        deadline = time.monotonic() + 10.0
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        for c in conns:
            c.close()
        shutil.rmtree(self._dir, ignore_errors=True)
        key = (self.n, self.device.type)
        if _MESHES.get(key) is self:
            del _MESHES[key]

    def __enter__(self) -> "NodeMesh":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self) -> str:
        state = "closed" if self.closed else f"ranks={self.ranks}"
        return f"NodeMesh(n={self.n}, device={self.device.type!r}, {state})"


def make_node_mesh(n: int, device=None) -> NodeMesh:
    """The mesh of ``n`` ranks on ``device``, one graph node each.

    ``device`` defaults to the card (every rank binds ``cuda:0``); pass
    ``"cpu"`` to run the ranks on the CPU. An open mesh of the same
    ``(n, device)`` is reused; a closed one is replaced. Raises
    ``ValueError`` when the card cannot host the ranks (no card, or a
    compute mode that admits one context).
    """
    key = (int(n), _device_key(device))
    mesh = _MESHES.get(key)
    if mesh is None or mesh.closed:
        mesh = NodeMesh(*key)
        _MESHES[key] = mesh
    return mesh


def close_all() -> None:
    """Close every mesh of the registry."""
    for mesh in list(_MESHES.values()):
        mesh.close()
