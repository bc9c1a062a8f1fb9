#!/usr/bin/env python3
"""Time the port's decode_attention and sparse_axpy beside another build of
their CUDA sources (the parent commit's, say), in turns, in one process on
one card.

    python3 tools/turns_probe.py [--decode-baseline OLD.cu] [--axpy-baseline OLD.cu]
        [--lengths JSON] [--only decode|axpy]

- Shapes: decode_attention (bf16, minitron-8b's heads 32/8, D=128, pages of
  16) at a serve snapshot (``--lengths``, default chip_smoke.py's
  SERVE_BUSIEST_LENGTHS, over the serve pool), at B = 8 and at the
  reference's decode_32k (B = 128), every length 32,768 (chip_smoke.py's
  DECODE_LONG inputs); sparse_axpy (float64) at the solver step's shape
  (rcv1: N = 10, D = 47,236, k = 74), init_state's phibar scatter
  (D = 47,239, k = 7,400) and news20 (D = 1,355,191, k = 450).
- Contenders, each called through the port's wrapper path (checks, output
  allocation, launch; sparse_axpy with the contender's entry point in the
  port's place): the port, and ``--*-baseline``, another source with the
  single-split decode entry points (``decode_attention_<dt>(q, k_pool,
  v_pool, table, lengths, out, B, Hq, Hkv, D, n_blocks, block_size,
  n_pages, has_window, window, has_softcap, softcap, scale, device,
  stream)``) or ``sparse_axpy_<dt>`` as the port's, e.g. ``git show
  <commit>:src/repro_torch/kernels/csrc/decode_attention.cu`` saved under
  the ignored build directory.
- Each contender is held to the port (decode: the bf16 bar; sparse_axpy:
  bit for bit), then timed in turns (``in_turns``, two rounds): CUDA events
  over back-to-back calls, profiler device time under the contender's
  kernel names and, for sparse_axpy, host microseconds a call (no
  synchronisation). Last, with a sparse_axpy baseline, the dense dsba ridge
  step's wall and device time (rcv1, 30 steps) with the port's sparse_axpy
  and with the baseline's, in turns.

Prints one JSON object a line, the card's name and power limit first.
Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from in_turns import build, cuda_ms, device_ms, emit, emit_device, host_us, in_turns  # puts src/ on the path
from chip_smoke import (DECODE_LONG, SERVE_BUSIEST_LENGTHS, SERVE_POOL, decode_inputs,
                        decode_long_inputs, decode_rows, decode_split_count)
from repro_torch.kernels import _build, ops
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import sparse_saga as SS
from repro_torch.kernels.ref import decode_attention_ref

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
AXPY_SHAPES = {"step": (10, 47_236, 74), "init": (10, 47_239, 7_400),
               "news20": (10, 1_355_191, 450)}


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------


def decode_baseline(lib):
    """A call of a single-split decode library (no plan, no workspace) on `args`."""
    fn = lib.decode_attention_bf16
    fn.argtypes = [_P] * 6 + [_I] * 10 + [_F, _F, _I, _P]

    def make(args):
        q, kp, vp, table, lengths = args

        def call():  # what its wrapper did a call: check, allocate, launch
            B, Hq, hkv, D, nb, bs, n_pages = DA._check_inputs(*args)
            out = torch.empty_like(q)
            code = fn(q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
                      lengths.data_ptr(), out.data_ptr(), B, Hq, hkv, D, nb, bs, n_pages,
                      0, 0, 0, 0.0, 1.0 / math.sqrt(D), q.device.index, _build.stream(q))
            _build.check(lib, code, "baseline decode")
            return out
        return call
    return make


def decode_shapes(lengths, dev):
    """(name, bf16 inputs) of the serve snapshot, then of DECODE_LONG."""
    yield "serve", decode_inputs(lengths, 32, 8, 128, SERVE_POOL.n_blocks, SERVE_POOL.block_size,
                                 SERVE_POOL.max_len // SERVE_POOL.block_size, torch.bfloat16, dev)
    for name, (b, n) in DECODE_LONG.items():
        yield name, decode_long_inputs(b, n, dev)


def run_decode(args):
    contenders = {"port": (lambda a: (lambda: DA.decode_attention(*a)), ("flash_decode_kernel",))}
    if args.decode_baseline:
        contenders["baseline"] = (decode_baseline(build(args.decode_baseline, "decode_baseline")),
                                  ("decode_attention_kernel",))
    tol = ops.get_kernel("decode_attention").tolerance(torch.bfloat16)
    lengths = json.loads(args.lengths) if args.lengths else SERVE_BUSIEST_LENGTHS
    for shape, a in decode_shapes(lengths, torch.device("cuda")):
        B = a[0].shape[0]
        calls = {who: make(a) for who, (make, _) in contenders.items()}
        want = calls["port"]().clone()
        r = torch.tensor(decode_rows(B), device="cuda")
        plain = decode_attention_ref(a[0][r], a[1], a[2], a[3][r], a[4][r])
        rec = {"shape": shape, "B": B, "live": int(a[4].sum()),
               "port_splits": decode_split_count(a[0], a[1], a[3])}
        for who, call in calls.items():
            got = call()
            rec[f"{who}_vs_port_max_abs"] = (got.float() - want.float()).abs().max().item()
            rec[f"{who}_vs_plain"] = ops.assert_close(got[r], plain, tol)
        emit("decode_parity", rec)
        del plain
        iters = 200 if shape == "serve" else (50 if B <= 8 else 10)
        emit("decode_times", {"shape": shape, **in_turns(calls, lambda who: {
            "ms": cuda_ms(calls[who], iters, warmup=3),
            "device_ms": device_ms(calls[who], contenders[who][1], min(iters, 50))})})
        del a, calls, want
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# sparse_axpy
# ---------------------------------------------------------------------------


def axpy_inputs(n, d, k, seed=0):
    """float64 (psi, idx, val, coef, rho): indices drawn with replacement
    (duplicates), the last 3 entries of a row padding (idx 0, val 0)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, size=(n, k))
    val = rng.standard_normal((n, k))
    idx[:, k - 3:] = 0
    val[:, k - 3:] = 0.0
    dev = torch.device("cuda")
    return (torch.randn(n, d, dtype=torch.float64, device=dev),
            torch.as_tensor(idx, dtype=torch.int32, device=dev),
            torch.as_tensor(val, device=dev),
            torch.as_tensor(rng.standard_normal(n), device=dev),
            torch.as_tensor(rng.uniform(0.5, 1.5, n), device=dev))


def through_wrapper(a, fn):
    """sparse_axpy(*a) through the port's wrapper (its checks, allocation
    and launch path), with `fn` as its float64 entry point (None: the
    port's own)."""
    port_entry = SS._entry

    def call():
        if fn is not None:
            SS._entry = lambda kind, dtype: fn if kind == "axpy" else port_entry(kind, dtype)
        try:
            return SS.sparse_axpy(*a)
        finally:
            SS._entry = port_entry
    return call


def run_axpy(args):
    contenders = {"port": (None, ("sparse_axpy_kernel",))}
    base_fn = None
    if args.axpy_baseline:
        base_fn = build(args.axpy_baseline, "axpy_baseline").sparse_axpy_f64
        base_fn.argtypes = _build.SIGNATURES["sparse_saga"]["sparse_axpy_f64"]
        contenders["baseline"] = (base_fn, ("axpy_scale_kernel", "axpy_scatter_kernel"))
    for shape, (n, d, k) in AXPY_SHAPES.items():
        a = axpy_inputs(n, d, k)
        calls = {who: through_wrapper(a, fn) for who, (fn, _) in contenders.items()}
        want = calls["port"]().clone()
        exact = {who: bool(torch.equal(call(), want)) for who, call in calls.items()}
        ops.parity_check("sparse_axpy", *a)  # the port against its plain version, bit for bit
        emit("axpy_parity", {"shape": shape, "bit_equal_to_port": exact})
        if not all(exact.values()):
            raise AssertionError(f"sparse_axpy {shape}: {exact}")
        iters = 20 if shape == "init" else 200
        emit("axpy_times", {"shape": shape, "N": n, "D": d, "k": k, **in_turns(calls, lambda who: {
            "ms": cuda_ms(calls[who], iters, warmup=3),
            "device_ms": device_ms(calls[who], contenders[who][1], 50),
            "host_us": host_us(calls[who], 2000 if shape == "init" else 5000)})})
        del a, calls, want
    if base_fn is not None:
        ridge_steps(base_fn)


def ridge_steps(base_fn, steps=30):
    """The dense dsba ridge step (rcv1 preset) with the port's sparse_axpy
    and with the baseline's entry point in its place, in turns: wall ms a
    step (host clock around a synchronised run), device busy ms, launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.dsba_paper import EXPERIMENTS
    from repro_torch.convert import dataset_to_torch
    from repro_torch.core import mixing
    from repro_torch.core.comm import DenseComm
    from repro_torch.core.solvers import get_solver, make_problem
    from repro_torch.data.synthetic import DATASET_PRESETS, make_regression

    dev = torch.device("cuda")
    rcv1 = DATASET_PRESETS["rcv1"]
    problem = make_problem("ridge", make_regression(10, 100, rcv1["d"], rcv1["k"], seed=0),
                           mixing.erdos_renyi_graph(10, 0.4, seed=0))
    spec = get_solver("dsba")
    hp = {"alpha": EXPERIMENTS["ridge_rcv1"].alpha}
    data = dataset_to_torch(problem.data, dev)
    z0 = torch.zeros((10, problem.dim), dtype=torch.float64, device=dev)
    state0 = spec.init(problem, hp, data, z0)
    step = spec.step(problem, hp, data, DenseComm(problem.graph, dev))
    i_t = torch.as_tensor(np.random.default_rng(0).integers(0, 100, (steps, 10)), device=dev)

    def run():
        state = state0
        for t in range(steps):
            state = step(state, i_t[t])
        return state

    port_entry = SS._entry
    use = {"port": port_entry,
           "baseline": lambda kind, dtype: base_fn if kind == "axpy" else port_entry(kind, dtype)}
    finals, rows = {}, {}
    for who in ["baseline", "port", "port", "baseline"]:
        SS._entry = use[who]
        try:
            run()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            finals[who] = run().z.clone()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                run()
                torch.cuda.synchronize()
            kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
            rows.setdefault(who, []).append({
                "wall_ms_per_step": wall,
                "device_ms_per_step": sum(e.device_time_total for e in kern) / 1e3 / steps,
                "launches_per_step": sum(e.count for e in kern) / steps})
        finally:
            SS._entry = port_entry
    emit("ridge_step", {"steps": steps, "bit_equal": bool(torch.equal(finals["port"],
                                                                       finals["baseline"])),
                        **rows})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--decode-baseline", type=Path)
    ap.add_argument("--axpy-baseline", type=Path)
    ap.add_argument("--lengths", help="the serve snapshot's lengths, a JSON list")
    ap.add_argument("--only", choices=("decode", "axpy"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    emit_device()
    _build.build_all()
    if args.only != "axpy":
        run_decode(args)
    if args.only != "decode":
        run_axpy(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
