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

Every job and reply crosses its pipe in bounded pieces (``_send_msg``,
``_recv_msg``): the object is pickled with protocol 5, so the data of its
numpy arrays (and other buffers) stays out of the pickle stream, and the
stream and each buffer go as messages of at most ``PIPE_PIECE_BYTES``,
received straight into buffers of their final size. A multi-GB state thus
never exists as one pickled copy on either side.

A mesh is built once and reused: ``make_node_mesh`` keeps a registry keyed
by ``(n, device)``. ``close()`` (also a context manager's exit, and an
``atexit`` hook for every mesh still open) stops and joins the workers.

The within-pod meshes: ``make_test_mesh(shape, axes)`` is a ``GridMesh``,
prod(shape) ranks laid out row-major over named axes (rank r of a
("data", "model") mesh of shape (D, M) sits at data r // M, model r % M:
the device order of the JAX ``make_test_mesh``). Each worker runs as a
``GridRank``, which also holds its coordinates and one gloo sub-group a
line of the grid along each axis (``train.collectives`` reduces over
them). ``make_production_mesh`` is the 16 x 16 (or 2 x 16 x 16) pod mesh:
it raises the JAX package's ``ValueError`` when fewer devices exist.
"""
from __future__ import annotations

import atexit
import dataclasses
import datetime
import io
import math
import os
import pickle
import shutil
import struct
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
#: the largest message any transport of a mesh carries: a job or reply in a
#: rank's pipe, one gloo send (``core.gossip.PodExchange``) or one piece of a
#: grid collective (``train.collectives``) goes in pieces of at most this
#: many bytes (gemma2-2b's embedding is 2.36 GB; gloo counts in 32 bits).
#: Those modules read it when they send, so a rank uses its parent's value
PIPE_PIECE_BYTES = 1 << 30

_MESHES: dict[tuple, "NodeMesh"] = {}


@dataclasses.dataclass(frozen=True)
class NodeRank:
    """What a worker knows of itself: its rank (graph node), the mesh size
    and the device its tensors live on."""

    rank: int
    n: int
    device: torch.device


@dataclasses.dataclass(frozen=True)
class GridRank(NodeRank):
    """A rank of a ``GridMesh``: also the mesh's axis names and shape, its
    own coordinates, and for each axis of more than one rank the gloo
    sub-group of its line along that axis with the line's global ranks in
    axis order."""

    axis_names: tuple[str, ...] = ()
    shape: tuple[int, ...] = ()
    coords: tuple[int, ...] = ()
    groups: dict = dataclasses.field(default_factory=dict, compare=False)

    @property
    def mesh_shape(self) -> dict[str, int]:
        """{axis name: size}, the JAX ``mesh.shape``."""
        return dict(zip(self.axis_names, self.shape))

    @property
    def coord(self) -> dict[str, int]:
        """{axis name: this rank's index along it}."""
        return dict(zip(self.axis_names, self.coords))


def grid_coords(rank: int, shape) -> tuple[int, ...]:
    """The row-major coordinates of `rank` in a grid of `shape`."""
    out = []
    for size in reversed(tuple(shape)):
        out.append(rank % size)
        rank //= size
    return tuple(reversed(out))


def _axis_lines(shape, axis: int) -> list[list[int]]:
    """The lines of a row-major grid along `axis`: each the ranks that share
    every other coordinate, in axis order; lines in row-major order of the
    other coordinates."""
    n = math.prod(shape)
    lines: dict[tuple, list[int]] = {}
    for r in range(n):
        c = grid_coords(r, shape)
        lines.setdefault(c[:axis] + c[axis + 1:], []).append(r)
    return [lines[k] for k in sorted(lines)]


def to_host(t: torch.Tensor):
    """A host copy of `t` that crosses a pipe as numpy (bfloat16 as its
    int16 bits): (array, is_bf16)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), True
    return t.numpy(), False


def from_host(h, device) -> torch.Tensor:
    """The tensor ``to_host`` made `h` of, on `device`."""
    arr, bf16 = h
    t = torch.from_numpy(arr)
    return (t.view(torch.bfloat16) if bf16 else t).to(device)


def _send_msg(conn, obj) -> None:
    """Send `obj` in pieces of at most ``PIPE_PIECE_BYTES``: a small header
    (the stream's and each out-of-band buffer's size), the protocol-5 pickle
    stream, then each buffer. Pickled by ``ForkingPickler``, as
    ``Connection.send`` does."""
    from multiprocessing.reduction import ForkingPickler

    bufs: list = []
    stream = io.BytesIO()
    pickler = pickle.Pickler(stream, 5, buffer_callback=bufs.append)
    # ForkingPickler's reducers (torch's among them), which its own
    # constructor installs but cannot take a buffer_callback
    pickler.dispatch_table = ForkingPickler._copyreg_dispatch_table.copy()
    pickler.dispatch_table.update(ForkingPickler._extra_reducers)
    pickler.dump(obj)
    del pickler
    raws = [b.raw() for b in bufs]
    head = stream.getbuffer()
    conn.send_bytes(pickle.dumps((head.nbytes, [r.nbytes for r in raws])))
    for view in (head, *raws):
        for lo in range(0, view.nbytes, PIPE_PIECE_BYTES):
            conn.send_bytes(view[lo:lo + PIPE_PIECE_BYTES])


def _read_exact(fd: int, view: memoryview) -> None:
    """Fill `view` from `fd` (EOFError if it closes first)."""
    lo = 0
    while lo < view.nbytes:
        got = os.readv(fd, [view[lo:]])
        if got == 0:
            raise EOFError
        lo += got


def _recv_piece(fd: int, view: memoryview) -> int:
    """One message of ``Connection.send_bytes``' framing (a 4-byte size, or
    -1 and an 8-byte size) read straight into `view`; its size.
    ``Connection.recv_bytes_into`` would read it into a growing BytesIO
    first, and ``os.read`` a buffer of the whole rest at every call."""
    head = memoryview(bytearray(8))
    _read_exact(fd, head[:4])
    (size,) = struct.unpack("!i", head[:4])
    if size == -1:
        _read_exact(fd, head)
        (size,) = struct.unpack("!Q", head)
    if size > view.nbytes:
        raise RuntimeError(f"a {size}-byte piece for a {view.nbytes}-byte buffer")
    _read_exact(fd, view[:size])
    return size


def _recv_into(conn, nbytes: int) -> bytearray:
    """`nbytes` received as pieces, each straight into its place."""
    out = bytearray(nbytes)
    view = memoryview(out)
    fd = conn.fileno()
    lo = 0
    while lo < nbytes:
        lo += _recv_piece(fd, view[lo:])
    return out


def _recv_msg(conn):
    """The object ``_send_msg`` sent (EOFError if the other end closed)."""
    n_head, sizes = pickle.loads(conn.recv_bytes())
    head = _recv_into(conn, n_head)
    return pickle.loads(head, buffers=[_recv_into(conn, s) for s in sizes])


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


def _worker(rank: int, n: int, device: str, init_file: str, build_dir: str, conn,
            piece_bytes: int = PIPE_PIECE_BYTES, grid=None):
    """A rank's loop: join the group (and, on a grid, build every line's
    sub-group in the same order as every other rank), then run the parent's
    jobs until told to stop (or until the parent's end of the pipe
    closes). `piece_bytes` is the parent's ``PIPE_PIECE_BYTES``."""
    global PIPE_PIECE_BYTES
    PIPE_PIECE_BYTES = piece_bytes
    # the parent built the kernels; load its libraries, never build N times
    os.environ["REPRO_COMPILE_CACHE_DIR"] = build_dir
    os.environ.pop("REPRO_NO_COMPILE_CACHE", None)
    # every rank is on this host: gloo's transport stays on the loopback
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    # the ranks share one card: growable segments keep a rank's cached
    # blocks from fragmenting into memory no other rank can use, and keep no
    # fragments beyond the rank's peak, so a rank keeps its cache between
    # jobs (emptying it after each costs a gemma2-2b gossip step about twice
    # its time). Set, whatever the caller's environment held
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
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
        if grid is None:
            me = NodeRank(rank, n, dev)
        else:
            shape, axes = grid
            coords = grid_coords(rank, shape)
            groups = {}
            for a, name in enumerate(axes):
                if shape[a] == 1:
                    continue
                for line in _axis_lines(shape, a):
                    g = dist.new_group(line)
                    if rank in line:
                        groups[name] = (g, tuple(line))
            me = GridRank(rank, n, dev, tuple(axes), tuple(shape), coords, groups)
        _send_msg(conn, ("ready", os.getpid()))
    except BaseException:
        _send_msg(conn, ("error", traceback.format_exc()))
        return
    try:
        while True:
            try:
                msg = _recv_msg(conn)
            except EOFError:
                break
            if msg[0] == "stop":
                break
            _, fn, job = msg
            del msg
            try:
                reply = ("ok", fn(me, job))
            except BaseException:
                reply = ("error", traceback.format_exc())
            del job  # the job's buffers go before the reply is pickled
            _send_msg(conn, reply)
            del reply
    finally:
        dist.destroy_process_group()


class NodeMesh:
    """N worker processes, one graph node each, in one gloo group.

    ``n`` ranks on ``device`` (``cuda`` or ``cpu``); ``ranks`` are the
    workers' process ids (a mesh rebuilt after ``close`` gets new ones, so
    it keys new runners).
    """

    def __init__(self, n: int, device, *, _grid=None):
        """Spawn the ranks and wait until every one has joined the group."""
        if int(n) < 1:
            raise ValueError(f"node mesh needs n >= 1, got {n}")
        self.n = int(n)
        self.device = torch.device(_device_key(device))
        self._key = (self.n, self.device.type) if _grid is None else (
            "grid", *_grid, self.device.type)
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
                    args=(r, self.n, self.device.type, init_file, build_dir, child,
                          PIPE_PIECE_BYTES, _grid),
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
                    kind, val = _recv_msg(c)
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
            _send_msg(c, ("run", fn, job))
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
                _send_msg(c, ("stop",))
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
        if _MESHES.get(self._key) is self:
            del _MESHES[self._key]

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


class GridMesh(NodeMesh):
    """A ``NodeMesh`` of prod(shape) ranks laid out row-major over the named
    axes: the within-pod ("data", "model") mesh. Its workers run as
    ``GridRank``s. ``devices`` is the grid of rank numbers (the JAX mesh's
    ``devices`` array, by rank); ``coords(r)`` rank r's coordinates."""

    def __init__(self, shape, axes, device):
        shape, axes = tuple(int(s) for s in shape), tuple(axes)
        if len(shape) != len(axes) or len(set(axes)) != len(axes):
            raise ValueError(f"mesh shape {shape} and axes {axes} do not match")
        if min(shape) < 1:
            raise ValueError(f"mesh shape {shape} has an empty axis")
        self.shape = shape
        self.axis_names = axes
        super().__init__(math.prod(shape), device, _grid=(shape, axes))

    @property
    def mesh_shape(self) -> dict[str, int]:
        """{axis name: size}, the JAX ``mesh.shape``."""
        return dict(zip(self.axis_names, self.shape))

    @property
    def devices(self):
        """The ranks laid out as the grid (a numpy int array of `shape`)."""
        import numpy as np

        return np.arange(self.n).reshape(self.shape)

    def coords(self, rank: int) -> dict[str, int]:
        """{axis name: index} of `rank`."""
        return dict(zip(self.axis_names, grid_coords(rank, self.shape)))

    def __repr__(self) -> str:
        state = "closed" if self.closed else f"ranks={self.ranks}"
        return (f"GridMesh({self.mesh_shape}, device={self.device.type!r}, {state})")


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device=None) -> GridMesh:
    """The small within-pod mesh: prod(shape) ranks on `device` (the card
    unless told otherwise; every rank binds ``cuda:0``), row-major over
    `axes`, from the registry (an open mesh of the same shape, axes and
    device is reused). Raises ``ValueError`` as ``make_node_mesh`` does when
    the card cannot host the ranks."""
    key = ("grid", tuple(int(s) for s in shape), tuple(axes), _device_key(device))
    mesh = _MESHES.get(key)
    if mesh is None or mesh.closed:
        mesh = GridMesh(key[1], key[2], key[3])
        _MESHES[key] = mesh
    return mesh


def make_production_mesh(*, multi_pod: bool = False) -> GridMesh:
    """The pod mesh: ("data", "model") of 16 x 16, or ("pod", "data",
    "model") of 2 x 16 x 16 with `multi_pod`. Raises the JAX package's
    ``ValueError`` when fewer devices exist than the mesh needs (one card,
    or the CPU, has far fewer). Its ranks bind ``cuda:0`` as a test mesh's
    do; a rank a card is not ported."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    # the CUDA cards, or the CPU's one device without a card
    avail = torch.cuda.device_count() if torch.cuda.is_available() else 1
    if avail < n:
        raise ValueError(
            f"production mesh {dict(zip(axes, shape))} needs {n} devices, "
            f"found {avail}; for a host dry-run set "
            f"XLA_FLAGS=--xla_force_host_platform_device_count={n}"
        )
    return make_test_mesh(shape, axes)


def echo(me, job):
    """A job that returns itself: one round trip of `job` through a rank's
    pipe, both ways in pieces (the transport's own check)."""
    del me
    return job
