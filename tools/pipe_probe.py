"""A multi-GB reply from each of N ranks through their pipes: sent the old
way (one ``Connection.send`` of the pickled reply, read by
``Connection.recv``) and the way ``repro_torch.launch.mesh`` sends it (in
pieces of ``PIPE_PIECE_BYTES``, protocol-5 buffers received in place),
with the host's memory and each rank's bytes written sampled every second
while it runs.

    python3 tools/pipe_probe.py                     # gemma2-2b x2's params, 2 ranks, host arrays
    python3 tools/pipe_probe.py --cuda              # the leaves made on cuda:0, copied to the host
    python3 tools/pipe_probe.py --ways old --deadline 300 --out pipe_probe.json
    python3 tools/pipe_probe.py --sweep 0.25,0.5,1,2 --deadline 60   # the old send, read two ways

A way that has not delivered every reply by its deadline is stopped
(its ranks killed) and reported as stalled, with its samples (also
appended to <--out>.samples.jsonl as they are taken, and each parent
sample has its read syscalls and page faults: bytes a read and faults a
read). The host's facts that shape a pipe (transparent huge pages, the
pipe socket's buffers, overcommit, the cgroup's memory limit) are read
and printed first. The last line of the output is the JSON record (also
written to --out).
"""
from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os
import sys
import threading
import time
from multiprocessing.connection import wait as wait_any
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402


def leaf_shapes(layers: int, reduced: bool = False) -> list[tuple[int, ...]]:
    """gemma2-2b's parameter shapes at full width (or reduced) cut to
    `layers` layers, with a leading pod dim of 1 (a gossip rank's rows)."""
    import dataclasses

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_leaves

    cfg = dataclasses.replace((get_reduced if reduced else get_config)("gemma2-2b"),
                              n_layers=layers)
    return [(1, *d.shape) for d in tree_leaves(T.model_defs(cfg))]


def make_reply(shapes, cuda: bool, rank: int) -> list:
    """The rank's reply: float32 leaves as ``launch.mesh.to_host`` gives
    them (made on the card and copied when `cuda`)."""
    import torch

    from repro_torch.launch.mesh import to_host

    dev = "cuda" if cuda else "cpu"
    if cuda:
        torch.cuda.set_device(0)
    return [to_host(torch.full(s, float(rank + 1), dtype=torch.float32, device=dev))
            for s in shapes]


def old_rank(conn, shapes, cuda, rank) -> None:
    """One reply, the old way: ``Connection.send`` of the whole object."""
    conn.recv()
    conn.send(("ok", make_reply(shapes, cuda, rank)))
    conn.recv()


def sweep_rank(conn, nbytes) -> None:
    """One reply of `nbytes` (a float32 array), the old way, made before the
    parent's go (so only the transfer is timed)."""
    reply = ("ok", np.ones(nbytes // 4, dtype=np.float32))
    conn.send("ready")
    conn.recv()
    conn.send(reply)
    conn.recv()


def _read_framed(conn) -> bytearray:
    """One ``Connection.send_bytes`` message read with ``os.readv`` straight
    into a buffer of its size (``launch.mesh``'s receive loop)."""
    from repro_torch.launch.mesh import _read_exact

    import struct

    fd = conn.fileno()
    head = memoryview(bytearray(8))
    _read_exact(fd, head[:4])
    (size,) = struct.unpack("!i", head[:4])
    if size == -1:
        _read_exact(fd, head)
        (size,) = struct.unpack("!Q", head)
    out = bytearray(size)
    _read_exact(fd, memoryview(out))
    return out


def run_sweep(sizes, deadline) -> list[dict]:
    """For each size, one rank's reply sent by ``Connection.send``, read two
    ways: by ``Connection.recv`` (CPython's loop of ``os.read(fd,
    remaining)``) and by reading the same framing into a buffer of its
    size: which side of the old transfer is slow, and how it grows with
    the size."""
    import pickle

    ctx = mp.get_context("spawn")
    out = []
    for nbytes in sizes:
        for reader in ("recv", "readv"):
            a, b = ctx.Pipe()
            p = ctx.Process(target=sweep_rank, args=(b, nbytes), daemon=True)
            p.start()
            b.close()
            got = {}

            def read(a=a, reader=reader, got=got):
                try:
                    got["v"] = a.recv() if reader == "recv" else pickle.loads(_read_framed(a))
                except (EOFError, OSError):
                    pass

            a.recv()  # ready
            a.send("go")
            t0 = time.perf_counter()
            th = threading.Thread(target=read, daemon=True)
            th.start()
            th.join(deadline)
            secs = time.perf_counter() - t0
            done = "v" in got
            try:
                a.send("stop")
            except OSError:
                pass
            p.join(timeout=5 if done else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
            th.join(30)
            a.close()
            row = {"bytes": nbytes, "reader": reader, "arrived": done,
                   "seconds": secs if done else None, "gb_per_s": nbytes / secs / 1e9 if done
                   else None}
            print(f"[pipe-probe] sweep: {json.dumps(row)}", flush=True)
            out.append(row)
    return out


def new_job(me, job):
    """The reply as a ``NodeMesh`` job (sent in pieces)."""
    return make_reply(job["shapes"], job["cuda"], me.rank)


def _status(pid: int) -> dict:
    """A process's RSS, page faults, bytes and read/write syscalls so far."""
    out = {}
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith(("VmRSS", "VmHWM")):
                    out[line.split(":")[0]] = int(line.split()[1]) * 1024
        with open(f"/proc/{pid}/io") as f:
            for line in f:
                if line.startswith(("wchar", "rchar", "syscr", "syscw")):
                    out[line.split(":")[0]] = int(line.split()[1])
        with open(f"/proc/{pid}/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        out["minflt"], out["majflt"] = int(fields[7]), int(fields[9])
    except (OSError, IndexError, ValueError):
        pass
    return out


def _meminfo() -> dict:
    keep = ("MemTotal", "MemAvailable", "Committed_AS", "CommitLimit", "Shmem",
            "AnonHugePages")
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k = line.split(":")[0]
            if k in keep:
                out[k] = int(line.split()[1]) * 1024
    return out


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError as e:
        return f"unreadable: {e.strerror}"


def host_facts(conn) -> dict:
    """What shapes a pipe's transfer on this host: transparent huge pages,
    the socket buffers of a pipe's socket pair, overcommit, the cgroup's
    memory limit (all read, none set)."""
    import socket

    sock = socket.socket(fileno=os.dup(conn.fileno()))
    try:
        bufs = {"SO_RCVBUF": sock.getsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF),
                "SO_SNDBUF": sock.getsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF)}
    finally:
        sock.close()
    return {"thp_enabled": _read("/sys/kernel/mm/transparent_hugepage/enabled"),
            "thp_defrag": _read("/sys/kernel/mm/transparent_hugepage/defrag"),
            "overcommit_memory": _read("/proc/sys/vm/overcommit_memory"),
            "rmem_default": _read("/proc/sys/net/core/rmem_default"),
            "wmem_default": _read("/proc/sys/net/core/wmem_default"),
            "cgroup_memory_max": _read("/sys/fs/cgroup/memory.max"),
            "pipe_socket": bufs, "mem": _meminfo(), "cpus": os.cpu_count()}


class Sampler(threading.Thread):
    """Every `period` s: the host's meminfo, this process's and each rank's
    RSS, faults, bytes and syscalls; each sample also appended to `path`
    as a JSON line at once (a run cut by its time limit keeps them)."""

    def __init__(self, pids, way, path=None, period=1.0):
        super().__init__(daemon=True)
        self.pids, self.way, self.path, self.period, self.rows = pids, way, path, period, []
        self.stop_evt = threading.Event()
        self.t0 = time.perf_counter()

    def run(self) -> None:
        while not self.stop_evt.is_set():
            row = {"way": self.way, "t": round(time.perf_counter() - self.t0, 2),
                   "mem": _meminfo(), "parent": _status(os.getpid()),
                   "ranks": [_status(p) for p in self.pids]}
            self.rows.append(row)
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(row) + "\n")
            self.stop_evt.wait(self.period)

    def stop(self) -> list:
        self.stop_evt.set()
        self.join()
        return self.rows


def run_old(shapes, ranks, cuda, deadline, samples=None) -> dict:
    """The replies the old way; each ``recv`` runs on a thread, so a reply
    that has not arrived by `deadline` s is abandoned and its rank killed."""
    ctx = mp.get_context("spawn")
    conns, procs = [], []
    for r in range(ranks):
        a, b = ctx.Pipe()
        p = ctx.Process(target=old_rank, args=(b, shapes, cuda, r), daemon=True)
        p.start()
        b.close()
        conns.append(a)
        procs.append(p)
    facts = host_facts(conns[0])
    print(f"[pipe-probe] host: {json.dumps(facts)}", flush=True)
    sampler = Sampler([p.pid for p in procs], "old", samples)
    sampler.start()
    t0 = time.perf_counter()
    for c in conns:
        c.send("go")
    got, arrived = {}, {}

    def read_all():
        pending = {c: r for r, c in enumerate(conns)}
        while pending:
            for c in wait_any(list(pending), timeout=1.0):
                r = pending.pop(c)
                try:
                    got[r] = c.recv()
                except (EOFError, OSError):
                    return
                arrived[r] = time.perf_counter() - t0
                print(f"[pipe-probe] old: rank {r} arrived at {arrived[r]:.1f} s", flush=True)

    reader = threading.Thread(target=read_all, daemon=True)
    reader.start()
    reader.join(deadline)
    stalled = [r for r in range(ranks) if r not in got]
    for c in conns:
        try:
            c.send("stop")
        except OSError:
            pass
    for p in procs:
        p.join(timeout=5 if not stalled else 0.1)
        if p.is_alive():
            p.kill()
            p.join()
    reader.join(30)
    rows = sampler.stop()
    ok = all(np.all(got[r][1][0][0] == r + 1) for r in got)
    return {"seconds": time.perf_counter() - t0, "arrived_s": arrived, "stalled_ranks": stalled,
            "values_ok": bool(ok), "host": facts, "samples": rows}


def run_new(shapes, ranks, cuda, deadline, samples=None) -> dict:
    from repro_torch.launch import mesh as M

    m = M.NodeMesh(ranks, "cpu")
    sampler = Sampler(m.pids(), "new", samples)
    sampler.start()
    t0 = time.perf_counter()
    out = m.run(new_job, [{"shapes": shapes, "cuda": cuda}] * ranks)
    secs = time.perf_counter() - t0
    m.close()
    rows = sampler.stop()
    ok = all(np.all(out[r][0][0] == r + 1) for r in range(ranks))
    return {"seconds": secs, "stalled_ranks": [], "values_ok": bool(ok),
            "piece_bytes": M.PIPE_PIECE_BYTES, "samples": rows}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--cuda", action="store_true")
    ap.add_argument("--reduced", action="store_true", help="the reduced config's shapes")
    ap.add_argument("--ways", default="old,new")
    ap.add_argument("--deadline", type=float, default=300.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--sweep", default=None,
                    help="comma-separated reply sizes in GB: time the old send read both ways")
    args = ap.parse_args()
    if args.sweep:
        rows = run_sweep([int(float(g) * 1e9) // 4 * 4 for g in args.sweep.split(",")],
                         args.deadline)
        if args.out:
            Path(args.out).write_text(json.dumps(rows))
        print(json.dumps({"sweep": rows}))
        return
    shapes = leaf_shapes(args.layers, args.reduced)
    nbytes = 4 * sum(int(np.prod(s)) for s in shapes)
    rec = {"reply_bytes_a_rank": nbytes, "ranks": args.ranks, "cuda": args.cuda,
           "host": _meminfo(), "cpus": os.cpu_count()}
    for way in args.ways.split(","):
        fn = run_old if way == "old" else run_new
        res = fn(shapes, args.ranks, args.cuda, args.deadline,
                 args.out + ".samples.jsonl" if args.out else None)
        peak = {"parent_rss_max": max(r["parent"].get("VmRSS", 0) for r in res["samples"]),
                "rank_rss_max": max((x.get("VmRSS", 0) for r in res["samples"]
                                     for x in r["ranks"]), default=0),
                "mem_available_min": min(r["mem"]["MemAvailable"] for r in res["samples"])}
        rec[way] = dict(res, **peak)
        print(f"[pipe-probe] {way}: {res['seconds']:.1f} s, stalled ranks "
              f"{res['stalled_ranks']}, {json.dumps(peak)}", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rec))
    print(json.dumps({k: v for k, v in rec.items() if k not in ("old", "new")}
                     | {w: {k: v for k, v in rec[w].items() if k != "samples"}
                        for w in ("old", "new") if w in rec}))


if __name__ == "__main__":
    main()
