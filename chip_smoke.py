#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on a GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without a card, and prints
no result then. Imports nothing of JAX or of the JAX package. Phases, each
printed with its seconds:

1. device  -- ``nvidia-smi`` name and power limit, torch's device name/count.
2. build   -- compiles ``src/repro_torch/kernels/csrc/*.cu`` (first use).
3. kernels -- every kernel of the main path against its plain PyTorch
   version on the card, at the main path's shapes (rcv1 preset: N=10,
   D=47,236, k=74 for a step; D=47,239, k=7,400 for init_state's phibar
   scatter) and at ragged small shapes, float64 and float32, with
   padded entries and (for sparse_axpy) duplicate indices. float64
   sparse_axpy must be bit-exact, sparse_dot within 1e-12 (float32: 1e-5).
   Times per call from CUDA events after warm-up, beside the plain
   version's time and the least time the card could take (bound).
4. slice   -- the main path: ``solve()`` on the paper's Section-7 setup
   (rcv1 preset, N=10, q=100, Erdos-Renyi(0.4) seed 0, Laplacian W,
   lam = 1/(10 Q)) for dsba and dsa on ridge, logistic and AUC:
   dense for 200 steps on the card, held to the same port run on the CPU
   with the plain kernels (<= 1e-10: cuBLAS sums the 10x10 mixing product
   in another order than the CPU); sparse relay (verify=True) for 100
   steps on the card, held to the dense run (<= 1e-12) and to the
   closed-form steady-state doubles per iteration. The kernel launch
   counts of every run are set to 0 before it and must equal what the
   code predicts after it.
5. profile -- wall and device-busy time per step, the device's idle share
   and the kernels with the most device time (torch.profiler), for dense
   dsba on ridge and logistic and for the ridge relay.
6. widest  -- logistic_news20 (d=1,355,191, k=450) dense dsba, 20 steps.
7. serve   -- minitron-8b at full width (random bf16 weights from a seeded
   torch.Generator on the card) behind ``serve.Scheduler``:
   PoolConfig(max_batch=8, block_size=16, max_len=1024, prompt_pad=256,
   n_blocks=513), 24 requests with prompts of 16-256 tokens and 16-64 new
   tokens (numpy seed 0). Checks: every request finishes with its token
   count; decode_attention launches = decode steps x 32 layers; the pool
   is never reallocated (data_ptr); in the first 4 decode steps every
   layer's decode_attention call is held to the plain version on its own
   inputs (``ops.held_to_plain``, bf16 bar). Reports decode ms per step,
   tokens/s, wall vs device-busy time of a replayed decode step, its idle
   share and its weight-read bound, and (not gated, see 10) the on vs off
   and paged vs contiguous logit differences.
8. attention -- flash_attention and decode_attention against their plain
   versions on the card, bf16 and f32, within the registry bars (2e-2,
   2e-5): flash at S=2048 with minitron-8b's heads (32 q, 8 kv, D=128),
   a ragged S, causal and not, window, softcap, lse included; decode at
   the serve phase's shape (a snapshot of its table and lengths over the
   pool of layer 0, in bf16: its K/V reach ~100, far from the unit scale
   the f32 bar is set for), lengths 0, 1, a partial page and a full table, null
   pages past each length, GQA group 4 and MQA, window and softcap at
   small sizes. Times by CUDA events and by profiler device time, beside
   the bound, the plain version and the library call (SDPA; for decode,
   SDPA over the gathered pages), which only the timing table uses.
9. score   -- ``transformer.forward`` at full width, B=1, S=2048: 32
   flash_attention launches, each held to the plain version on its own
   inputs; finite logits of the expected shape.
10. conditioned -- the same weights with the attention projections
   rescaled to 1/sqrt(contracted width) (``condition_attention`` says why:
   with the reference's init the whole-model logits are a chaotic function
   of the attention outputs). Gated end to end: the first 4 serve decode
   steps, decode_kernel "on" vs "off" logits within the bf16 bar on the
   same pool state; request 0's first decode-step logits, paged vs the
   contiguous ``generate``, within the bf16 bar times the layer count
   (the reference's own paged-vs-contiguous rule, tests/test_serve.py);
   forward at S=2048, attention_kernel "on" vs "off" within the bf16 bar.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises: no phase catches its
own failure.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.dsba_paper import EXPERIMENTS  # noqa: E402
from repro_torch.core import mixing  # noqa: E402
from repro_torch.core.solvers import get_solver, make_problem, solve  # noqa: E402
from repro_torch.core.sparse_comm import sparse_doubles_per_iter  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    DATASET_PRESETS, make_classification, make_regression,
)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.ref import (  # noqa: E402
    attention_ref, decode_attention_ref, sparse_axpy_ref, sparse_dot_ref,
)
from repro_torch.kernels.sparse_saga import sparse_axpy, sparse_dot  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import tree_leaves  # noqa: E402
from repro_torch.serve import PoolConfig, Request, Scheduler, generate  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate; float32 and float64
# (non-tensor-core) arithmetic rates and the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12, torch.bfloat16: 989e12}

SOURCES = {
    "sparse_dot": "src/repro_torch/kernels/csrc/sparse_saga.cu",
    "sparse_axpy": "src/repro_torch/kernels/csrc/sparse_saga.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
}
REPLACES = {
    "sparse_dot": "src/repro/kernels/sparse_saga.py:56",
    "sparse_axpy": "src/repro/kernels/sparse_saga.py:122",
    "flash_attention": "src/repro/kernels/flash_attention.py:123",
    "decode_attention": "src/repro/kernels/decode_attention.py:116",
}
WRAPPERS = {"sparse_dot": sparse_dot, "sparse_axpy": sparse_axpy,
            "flash_attention": flash_attention, "decode_attention": decode_attention}
DENSE_TOL_CPU = 1e-10  # card vs CPU: cuBLAS mixing-product summation order
SPARSE_TOL = 1e-12  # relay vs dense (tests/test_sparse_comm.py's bar)


def log(phase: str, msg: str) -> None:
    """One progress line on stdout."""
    print(f"[{phase}] {msg}", flush=True)


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict[str, int]:
    """Current launch count of every kernel wrapper."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_inputs(n, d, k, dtype, device, seed=0, dups=True):
    """Seeded (psi, idx, val, coef, rho) on `device`.

    The last 3 entries of every row are padding (idx 0, val 0). With
    `dups`, indices are drawn with replacement (at k ~ D/6, as in
    init_state's phibar scatter, hundreds of columns repeat, in chunks far
    apart) and entries 1 and k//2 repeat entry 0's index; without, a row's
    indices are distinct.
    """
    pads = 3
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((n, d))
    if dups:
        idx = rng.integers(0, d, size=(n, k))
    else:
        idx = np.stack([rng.choice(d, size=k, replace=False) for _ in range(n)])
    val = rng.standard_normal((n, k))
    if dups and k > 2:
        idx[:, 1] = idx[:, 0]
        idx[:, k // 2] = idx[:, 0]
    idx[:, k - pads:] = 0
    val[:, k - pads:] = 0.0
    coef = rng.standard_normal(n)
    rho = rng.uniform(0.5, 1.5, n)

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    return t(psi), t(idx, torch.int32), t(val), t(coef), t(rho)


def kernel_parity(device, shapes) -> dict[str, float]:
    """Every kernel vs its plain version at each (n, d, k) in `shapes`.

    float64 and float32, with padding; duplicates for sparse_axpy only
    (sparse_dot's data has distinct indices per row). Raises on a miss;
    returns the largest float64 error per kernel at the first shape.
    """
    worst = {}
    for i, (n, d, k) in enumerate(shapes):
        for dtype in (torch.float64, torch.float32):
            args = kernel_inputs(n, d, k, dtype, device, seed=i)
            e_axpy = ops.parity_check("sparse_axpy", *args, mode="auto")
            clean = kernel_inputs(n, d, k, dtype, device, seed=i, dups=False)
            e_dot = ops.parity_check("sparse_dot", *clean[:3], mode="auto")
            if device.type == "cuda":
                torch.cuda.synchronize()
            log("kernels", f"{str(dtype):14s} N={n} D={d} k={k}: "
                f"sparse_axpy max_abs_err={e_axpy!r} "
                f"sparse_dot max_abs_err={e_dot!r}")
            if i == 0 and dtype == torch.float64:
                worst = {"sparse_axpy": e_axpy, "sparse_dot": e_dot}
    return worst


def cuda_ms(fn, iters=200, warmup=20) -> float:
    """Milliseconds per call from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters):
    """Run ``fn`` `iters` times under torch.profiler.

    Returns (device busy microseconds, {kernel name: (device us, count)})
    summed over the CUDA kernel events of the window.
    """
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kern = {e.key: (e.device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}
    return sum(t for t, _ in kern.values()), kern


def kernel_device_ms(fn, names, iters=50, windows=3):
    """Device milliseconds per call of ``fn``: for each CUDA kernel whose
    name contains one of `names`, its mean time per launch in a profiled
    window of `iters` calls, summed over those kernels (each is launched
    once per call). None when no window records any of them.

    Late in a long process the profiler has come back with fewer kernel
    events than calls, or none: the mean is over the launches it recorded,
    and a window without any is profiled again, up to `windows` times (each
    shortfall is logged)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        _, kern = device_profile(fn, iters)
        hits = [(t, c) for key, (t, c) in kern.items() if any(n in key for n in names)]
        if any(c != iters for _, c in hits) or not hits:
            log("profile", f"{names}: {[c for _, c in hits]} kernel events for "
                f"{iters} calls ({len(kern)} kernel names in the window)")
        if hits:
            return sum(t / c for t, c in hits) / 1e3
    return None


def bound(nbytes: float, nops: float, dtype) -> tuple[float, str]:
    """(least milliseconds, 'bytes' | 'operations') for this much work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(device, n, d, k, dtype=torch.float64) -> dict[str, dict]:
    """Kernel, plain version and library times at the main path's shape."""
    psi, idx, val, coef, rho = kernel_inputs(n, d, k, dtype, device, dups=False)
    esize = psi.element_size()
    distinct = len({(r, c) for r, row in enumerate(idx.cpu().tolist()) for c in row})
    out = {}

    b_axpy = bound(2 * n * d * esize + n * k * (4 + esize) + 2 * n * esize,
                   n * d + 2 * n * k, dtype)
    out["sparse_axpy"] = {
        "ms": cuda_ms(lambda: sparse_axpy(psi, idx, val, coef, rho)),
        # the kernels' own device time (ms above includes the host's launch
        # path whenever that is slower than the device)
        "device_ms": kernel_device_ms(lambda: sparse_axpy(psi, idx, val, coef, rho),
                                      ("axpy_scale_kernel", "axpy_scatter_kernel")),
        "plain_ms": cuda_ms(lambda: sparse_axpy_ref(psi, idx, val, coef, rho), iters=50),
        "bound_ms": b_axpy[0], "bound_by": b_axpy[1],
        "library_ms": None,  # no single PyTorch call computes rho*psi + coef*scatter
    }

    b_dot = bound(distinct * esize + n * k * (4 + esize) + n * esize, 2 * n * k, dtype)
    crow = torch.arange(0, n * k + 1, k, device=device)
    cols = (torch.arange(n, device=device)[:, None] * d + idx.long()).reshape(-1)
    csr = torch.sparse_csr_tensor(crow, cols, val.reshape(-1), size=(n, n * d))
    flat = psi.reshape(-1)
    lib_err = (csr @ flat - sparse_dot_ref(psi, idx, val)).abs().max().item()
    if lib_err > 1e-9:
        raise AssertionError(f"CSR library yardstick disagrees: {lib_err}")
    out["sparse_dot"] = {
        "ms": cuda_ms(lambda: sparse_dot(psi, idx, val)),
        "device_ms": kernel_device_ms(lambda: sparse_dot(psi, idx, val),
                                      ("sparse_dot_kernel",)),
        "plain_ms": cuda_ms(lambda: sparse_dot_ref(psi, idx, val)),
        "bound_ms": b_dot[0], "bound_by": b_dot[1],
        "library_ms": cuda_ms(lambda: csr @ flat),  # CSR sparse matrix x vector
    }
    for name, r in out.items():
        log("kernels", f"{name} N={n} D={d} k={k} {dtype}: {r}")
    return out


# ---------------------------------------------------------------------------
# phases 4-5: the main path through solve()
# ---------------------------------------------------------------------------


def paper_problem(task, d, k, n_nodes=10, q=100, seed=0):
    """The Section-7 problem at preset widths (d, k): the data from_preset makes."""
    if task == "ridge":
        data = make_regression(n_nodes, q, d, k, seed=seed)
    else:
        data = make_classification(n_nodes, q, d, k, seed=seed)
    graph = mixing.erdos_renyi_graph(n_nodes, 0.4, seed=seed)
    return make_problem(task, data, graph)


def expected_launches(steps: int, comm: str) -> dict[str, int]:
    """The kernel launches of one solve(): 1 sparse_axpy call for init,
    4 sparse_axpy + 1 sparse_dot calls a step and 1 more sparse_axpy call a
    relay step; each sparse_axpy call launches 2 kernels (scale, scatter)."""
    axpy_calls = 1 + 4 * steps + (steps if comm == "sparse" else 0)
    return {"sparse_dot": steps, "sparse_axpy": 2 * axpy_calls}


def counted_solve(problem, method, comm, device, steps, total, **kw):
    """solve() with the launch counts set to 0 before and checked after."""
    reset_launches()
    res = solve(problem, method, comm, steps=steps, device=device, **kw)
    got = launches()
    if device.type == "cuda":
        want = expected_launches(steps, comm)  # and no other kernel
        if got != {**dict.fromkeys(got, 0), **want} or min(want.values()) == 0:
            raise AssertionError(f"{method}/{comm}: launches {got} != {want}")
        for name, c in got.items():
            total[name] = total.get(name, 0) + c
    if not np.all(np.isfinite(res.z)):
        raise AssertionError(f"{method}/{comm}: non-finite iterates")
    return res


def slice_runs(device, d, k, n_nodes=10, q=100, dense_steps=200,
               sparse_steps=100, record_every=50) -> tuple[dict, list]:
    """The main path: dense and sparse solve() for dsba/dsa x 3 families.

    Returns (launch totals over every run, one summary dict per run pair).
    """
    cpu = torch.device("cpu")
    total, rows = {}, []
    alphas = {t: EXPERIMENTS[f"{t}_rcv1"].alpha for t in ("ridge", "logistic", "auc")}
    for task in ("ridge", "logistic", "auc"):
        problem = paper_problem(task, d, k, n_nodes, q)
        g = problem.graph
        depth = max(3, g.diameter + 2)
        ring_mb = depth * n_nodes * n_nodes * problem.dim * 8 / 1e6
        log("slice", f"{task}: d={d} k={k} N={n_nodes} q={q} "
            f"diameter={g.diameter} ring depth={depth} ring={ring_mb:.1f} MB")
        for method in ("dsba", "dsa"):
            # dsba takes the paper's step size; dsa its solver default
            hp = {"alpha": alphas[task]} if method == "dsba" else {}
            t0 = time.perf_counter()
            dense = counted_solve(problem, method, "dense", device, dense_steps,
                                  total, record_every=record_every,
                                  keep_snapshots=True, **hp)
            t_dense = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref = solve(problem, method, "dense", steps=dense_steps,
                        record_every=record_every, device=cpu, **hp)
            t_cpu = time.perf_counter() - t0
            err_cpu = float(np.max(np.abs(dense.z - ref.z)))
            if err_cpu > DENSE_TOL_CPU:
                raise AssertionError(f"{task}/{method}: card vs CPU {err_cpu}")
            t0 = time.perf_counter()
            sparse = counted_solve(problem, method, "sparse", device, sparse_steps,
                                   total, record_every=record_every,
                                   comm_options={"verify": True}, **hp)
            t_sparse = time.perf_counter() - t0
            at = list(dense.iters).index(sparse_steps)
            err_sparse = float(np.max(np.abs(sparse.z - dense.zs[at])))
            if err_sparse > SPARSE_TOL:
                raise AssertionError(f"{task}/{method}: sparse vs dense {err_sparse}")
            per_iter = np.diff(sparse.doubles_received, axis=0) / np.diff(sparse.iters)[:, None]
            want = sparse_doubles_per_iter(n_nodes, k, problem.spec.tail_dim)
            if not np.all(per_iter[-1] == want):
                raise AssertionError(f"{task}/{method}: doubles/iter {per_iter[-1]} != {want}")
            row = {
                "task": task, "method": method, "alpha": hp.get("alpha", get_solver(method).defaults["alpha"]),
                "dense_card_vs_cpu": err_cpu, "sparse_vs_dense": err_sparse,
                "recon_max_err": sparse.extras["recon_max_err"],
                "doubles_per_iter": int(per_iter[-1][0]), "consensus": float(dense.consensus[-1]),
                "s_dense": t_dense, "s_dense_cpu": t_cpu, "s_sparse": t_sparse,
            }
            rows.append(row)
            log("slice", json.dumps(row))
    return total, rows


def profile_steps(device, d, k, steps=30) -> list[dict]:
    """Where a step's time goes at the paper's rcv1 setup (CUDA only).

    For `steps` dense dsba steps (ridge, logistic) and a `steps`-step ridge
    relay solve: wall ms per step without the profiler (host clock around a
    synchronized run), device busy ms per step from the profiler's kernel
    events, the idle share 1 - busy/wall, kernel launches per step, and the
    five kernels with the most device time.
    """
    from repro_torch.convert import dataset_to_torch
    from repro_torch.core.comm import DenseComm

    i_t = torch.as_tensor(np.random.default_rng(0).integers(0, 100, (steps, 10)),
                          device=device)
    rows = []
    for task in ("ridge", "logistic"):
        problem = paper_problem(task, d, k)
        spec = get_solver("dsba")
        hp = {"alpha": EXPERIMENTS[f"{task}_rcv1"].alpha}
        data = dataset_to_torch(problem.data, device)
        z0 = torch.zeros((10, problem.dim), dtype=torch.float64, device=device)
        state0 = spec.init(problem, hp, data, z0)
        step = spec.step(problem, hp, data, DenseComm(problem.graph, device))

        def run(state=state0, step=step):
            for t in range(steps):
                state = step(state, i_t[t])

        rows.append(_profile_row(f"dense dsba {task}", run, steps))
    problem = paper_problem("ridge", d, k)
    rows.append(_profile_row(
        "relay dsba ridge (whole solve incl. setup)",
        lambda: solve(problem, "dsba", "sparse", steps=steps, device=device),
        steps))
    return rows


def _profile_row(name, run, steps):
    run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    busy_us, kern = device_profile(run, 1)
    busy_ms = busy_us / 1e3 / steps
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:5]
    row = {"what": name, "wall_ms_per_step": wall_ms,
           "device_busy_ms_per_step": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
           "kernel_launches_per_step": sum(c for _, c in kern.values()) / steps,
           "top_kernels_us_per_step": {key[:70]: t / steps for key, (t, _) in top}}
    log("profile", json.dumps(row))
    return row


def widest_run(device, d, k, steps=20) -> dict:
    """logistic_news20: dense dsba at the widest preset."""
    e = EXPERIMENTS["logistic_news20"]
    problem = paper_problem("logistic", d, k, e.n_nodes, e.q, e.seed)
    t0 = time.perf_counter()
    res = counted_solve(problem, "dsba", "dense", device, steps, {},
                        record_every=steps, alpha=e.alpha)
    out = {"d": d, "k": k, "steps": steps, "seconds": time.perf_counter() - t0,
           "consensus": float(res.consensus[-1]),
           "z_mb": res.z.size * res.z.itemsize / 1e6}
    log("widest", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phases 7-9: the dense model family (attention kernels, serve, score)
# ---------------------------------------------------------------------------

BF16_BAR = ops.get_kernel("decode_attention").tolerance(torch.bfloat16).atol  # 2e-2
SERVE_POOL = PoolConfig(max_batch=8, block_size=16, max_len=1024, prompt_pad=256,
                        n_blocks=8 * 64 + 1)


def within_bf16_bar(got, want) -> bool:
    """|got - want| <= bar + bar * |want| elementwise (the registry's bf16
    Tolerance, rtol = atol = 2e-2), computed on the card."""
    return bool(((got - want).abs() <= BF16_BAR + BF16_BAR * want.abs()).all())


def same_function(got, want) -> bool:
    """A library yardstick computes the same function: relative error norm
    within the bf16 bar (elementwise it rounds at other places, e.g. SDPA
    rounds the probabilities to bf16 before the value product)."""
    return (got - want).float().norm().item() <= BF16_BAR * want.float().norm().item()


def flash_inputs(b, hq, hkv, s, sk, d, dtype, device, seed=0):
    """Seeded (q, k, v) on `device`, heads-major."""
    g = torch.Generator(device=device).manual_seed(seed)

    def t(*shape):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    return t(b, hq, s, d), t(b, hkv, sk, d), t(b, hkv, sk, d)


def decode_inputs(lengths, hq, hkv, d, n_blocks, bs, n_pages, dtype, device, seed=0):
    """Seeded (q, k_pool, v_pool, table, lengths): distinct pages per
    sequence, the null page 0 past each length."""
    g = torch.Generator(device=device).manual_seed(seed)
    b = len(lengths)
    q = torch.randn(b, hq, d, generator=g, device=device).to(dtype)
    kp = torch.randn(n_blocks, bs, hkv, d, generator=g, device=device).to(dtype)
    vp = torch.randn(n_blocks, bs, hkv, d, generator=g, device=device).to(dtype)
    rng = np.random.default_rng(seed)
    pages = rng.permutation(np.arange(1, n_blocks))
    table = np.zeros((b, n_pages), np.int32)
    used = 0
    for i, n in enumerate(lengths):
        need = -(-n // bs)
        table[i, :need] = pages[used:used + need]
        used += need
    return (q, kp, vp, torch.as_tensor(table, device=device),
            torch.as_tensor(np.asarray(lengths, np.int32), device=device))


def attention_parity(device, decode_main) -> dict[str, float]:
    """Both attention kernels against their plain versions (raises on a
    miss); returns the bf16 error at the main path's shape per kernel."""
    flash_cases = [  # (B, Hq, Hkv, S, Sk, D, causal, window, softcap)
        (1, 32, 8, 2048, 2048, 128, True, None, None),  # the score phase's shape
        (2, 32, 8, 1000, 1000, 128, True, None, None),  # S not a tile multiple
        (1, 8, 2, 333, 333, 128, False, None, None),
        (1, 4, 4, 300, 300, 64, True, 100, None),
        (1, 4, 2, 257, 257, 128, True, None, 50.0),
        (2, 4, 1, 77, 129, 64, False, 40, 30.0),  # S < Sk, window without causal
    ]
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for i, (b, hq, hkv, s, sk, d, causal, window, cap) in enumerate(flash_cases):
            q, k, v = flash_inputs(b, hq, hkv, s, sk, d, dtype, device, seed=i)
            err = ops.parity_check("flash_attention", q, k, v, causal=causal,
                                   window=window, softcap=cap, return_lse=True)
            torch.cuda.synchronize()
            log("attention", f"flash {dtype} B={b} Hq={hq} Hkv={hkv} S={s} Sk={sk} D={d} "
                f"causal={causal} window={window} softcap={cap}: max_abs_err={err!r}")
            if i == 0 and dtype == torch.bfloat16:
                worst["flash_attention"] = err
        decode_cases = [  # (lengths, Hq, Hkv, D, n_blocks, bs, n_pages, window, softcap)
            ([0, 1, 17, 1024, 16, 31, 300, 5], 32, 8, 128, 513, 16, 64, None, None),
            ([0, 1, 7, 48], 32, 1, 128, 40, 16, 3, None, None),  # MQA
            ([3, 20, 13, 0], 4, 2, 64, 24, 4, 5, 6, None),
            ([16, 9, 1], 8, 2, 128, 12, 4, 4, None, 15.0),
            ([19, 40, 0], 4, 1, 64, 30, 8, 5, 4, 25.0),
        ]
        for i, (lens, hq, hkv, d, nb, bs, npg, window, cap) in enumerate(decode_cases):
            args = decode_inputs(lens, hq, hkv, d, nb, bs, npg, dtype, device, seed=i)
            err = ops.parity_check("decode_attention", *args, window=window, softcap=cap)
            torch.cuda.synchronize()
            log("attention", f"decode {dtype} lengths={lens} Hq={hq} Hkv={hkv} D={d} "
                f"bs={bs} window={window} softcap={cap}: max_abs_err={err!r}")
    # the serve snapshot in the path's own dtype (its K/V reach ~100, far
    # from the unit scale the float32 bar is set for)
    err = ops.parity_check("decode_attention", *decode_main)
    torch.cuda.synchronize()
    log("attention", f"decode {decode_main[0].dtype} at the serve snapshot "
        f"lengths={decode_main[4].tolist()}: max_abs_err={err!r}")
    worst["decode_attention"] = err
    return worst


def time_attention(device, decode_main) -> dict[str, dict]:
    """Kernel, plain and library times at the main paths' shapes (bf16)."""
    out = {}
    b, hq, hkv, s, d = 1, 32, 8, 2048, 128
    q, k, v = flash_inputs(b, hq, hkv, s, s, d, torch.bfloat16, device)
    pairs = b * hq * s * (s + 1) // 2  # causal: what this run's mask keeps
    bound_f = bound(2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * b * hq * s,
                    4 * pairs * d, torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out, plain_out = sdpa(q, k, v, is_causal=True, enable_gqa=True), attention_ref(q, k, v)
    if not same_function(lib_out, plain_out):
        raise AssertionError("SDPA yardstick disagrees with the plain version: "
                             f"{(lib_out.float() - plain_out.float()).abs().max().item()}")
    out["flash_attention"] = {
        "ms": cuda_ms(lambda: flash_attention(q, k, v), iters=20, warmup=3),
        "device_ms": kernel_device_ms(lambda: flash_attention(q, k, v), ("flash_fwd_kernel",),
                                      iters=5),
        "plain_ms": cuda_ms(lambda: attention_ref(q, k, v), iters=5, warmup=1),
        "bound_ms": bound_f[0], "bound_by": bound_f[1],
        "library_ms": cuda_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
                              iters=20, warmup=3),
    }

    qd, kp, vp, table, lengths = decode_main
    B, Hq, D = qd.shape
    hkv = kp.shape[2]
    live = int(lengths.sum())
    esize = kp.element_size()
    bound_d = bound(2 * qd.numel() * esize + 2 * live * hkv * D * esize
                    + 4 * (table.numel() + B), 4 * Hq * D * live, torch.bfloat16)
    L = table.shape[1] * kp.shape[1]
    kg = kp[table.long()].reshape(B, L, hkv, D).transpose(1, 2)
    vg = vp[table.long()].reshape(B, L, hkv, D).transpose(1, 2)
    mask = (torch.arange(L, device=device)[None] < lengths[:, None].long())[:, None, None]
    lib = lambda: sdpa(qd[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True)  # noqa: E731
    lib_out, plain_out = lib()[:, :, 0].float(), decode_attention_ref(*decode_main).float()
    if not same_function(lib_out, plain_out):
        raise AssertionError("SDPA decode yardstick disagrees: "
                             f"{(lib_out - plain_out).abs().max().item()}")
    out["decode_attention"] = {
        "ms": cuda_ms(lambda: decode_attention(*decode_main), iters=100),
        "device_ms": kernel_device_ms(lambda: decode_attention(*decode_main),
                                      ("decode_attention_kernel",)),
        "plain_ms": cuda_ms(lambda: decode_attention_ref(*decode_main), iters=20),
        "bound_ms": bound_d[0], "bound_by": bound_d[1],
        # SDPA over the pages gathered beforehand (the gather is not timed)
        "library_ms": cuda_ms(lib, iters=100),
    }
    for name, r in out.items():
        log("attention", f"{name}: {json.dumps(r)}")
    return out


def serve_requests(cfg, n=24, seed=0) -> list[Request]:
    """`n` requests: prompts of 16-256 tokens, 16-64 new tokens."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size, int(rng.integers(16, 257))),
                    int(rng.integers(16, 65))) for i in range(n)]


def on_vs_off_decode(sch, cfg, checked_steps, errs, first_step):
    """A decode_fn for `sch` that, for the first `checked_steps` decode
    steps, runs the step with decode_kernel "off" first and records the max
    abs logit difference of the live slots to the "on" step that follows
    ("on" rewrites the same pool entries, so both read one pool state);
    it keeps request 0's first decode-step logits in `first_step`."""
    cfg_off = dataclasses.replace(cfg, decode_kernel="off")
    inner = sch.decode_fn

    def decode_fn(params, tokens, pools, table, lengths):
        check = len(errs) < checked_steps
        if check:
            _, want = T.decode_step_paged(cfg_off, params, tokens, pools, table, lengths)
        out = inner(params, tokens, pools, table, lengths)
        live = list(sch._admit_order)
        if check:
            errs.append(((out[1][live] - want[live]).abs().max().item(),
                         within_bf16_bar(out[1][live], want[live])))
        for slot in live:
            st = sch.active[slot]
            if st.req.rid == 0 and len(st.generated) == 1:
                first_step["logits"] = out[1][slot].float().clone()
        return out

    return decode_fn


def serve_phase(device, cfg, params) -> tuple[dict, tuple, dict]:
    """The Scheduler at full width with the port's own random init.

    Hard checks: tokens, launches, an unmoved pool, and each layer's
    decode_attention call of the first 4 decode steps held to the plain
    version on its own inputs. The end-to-end logit differences (on vs off,
    paged vs contiguous) are reported: with this init they are chaotic (see
    ``conditioned_phase``). Returns (summary, decode snapshot (q, k_pool,
    v_pool, table, lengths) of layer 0 at the busiest step, launches).
    """
    sch = Scheduler(cfg, params, SERVE_POOL, device=device)
    ptrs = sch.pool.data_ptrs()
    reqs = serve_requests(cfg)
    mode_errs, first_step, busiest, layer_errs = [], {}, {}, []
    compare = on_vs_off_decode(sch, cfg, 4, mode_errs, first_step)

    def decode_fn(params_, tokens, pools, table, lengths):
        if len(layer_errs) < 4:
            with ops.held_to_plain("decode_attention") as errs:
                out = compare(params_, tokens, pools, table, lengths)
            layer_errs.append(max(errs))
        else:
            out = compare(params_, tokens, pools, table, lengths)
        live_tokens = int(lengths.sum())
        if live_tokens > busiest.get("live", -1):
            busiest.update(live=live_tokens, table=table.clone(), lengths=lengths.clone(),
                           tokens=tokens.clone())
        return out

    sch.decode_fn = decode_fn
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, stats = sch.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launches()
    want = stats.decode_steps * cfg.n_layers
    if got["decode_attention"] != want or want == 0:
        raise AssertionError(f"decode_attention launches {got} != {want}")
    if got["flash_attention"] != 0:  # prefill passes a cache: the inline path
        raise AssertionError(f"flash_attention launched in the serve phase: {got}")
    for r in reqs:
        toks = results[r.rid]
        if toks.shape != (r.max_new_tokens,) or not np.all((0 <= toks) & (toks < cfg.vocab_size)):
            raise AssertionError(f"request {r.rid}: tokens {toks.shape}")
    if sch.pool.data_ptrs() != ptrs:
        raise AssertionError("the pool was reallocated")
    r0 = reqs[0]
    gen = generate(cfg, params, torch.as_tensor(r0.tokens, device=device)[None],
                   max_new_tokens=1)
    paged_err = (first_step["logits"] - gen.logits[1][0]).abs().max().item()

    # a decode step at the busiest state, replayed: wall without the
    # profiler, device busy with it (the pages are free again, so the
    # replay's writes land in unused pages)
    args = (params, busiest["tokens"], sch.pool.pools, busiest["table"], busiest["lengths"])
    step = lambda: T.decode_step_paged(cfg, *args)  # noqa: E731
    step()
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    step_wall = (time.perf_counter() - t0) * 1e3 / n
    busy_us, kern = device_profile(step, n)
    step_busy = busy_us / 1e3 / n
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params)
                       if t.dtype == cfg.compute_dtype)
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:6]
    n_tokens = int(sum(len(v) for v in results.values()))
    summary = {
        "requests": len(reqs), "tokens": n_tokens,
        "decode_steps": stats.decode_steps, "preemptions": stats.preemptions,
        "peak_active": stats.peak_active, "peak_occupancy": stats.peak_occupancy,
        "wall_s": wall, "tokens_per_s": n_tokens / wall,
        "decode_ms_per_step_incl_admission": wall * 1e3 / stats.decode_steps,
        "kernel_vs_plain_per_layer_max_abs": layer_errs,
        "reported_on_vs_off_logits_max_abs": [e for e, _ in mode_errs],
        "reported_on_vs_off_within_bar": [ok for _, ok in mode_errs],
        "reported_paged_vs_contiguous_max_abs": paged_err,
        "reported_paged_vs_contiguous_same_first_token": int(gen.tokens[0, 0]) == int(results[0][0]),
        "busiest_live_tokens": busiest["live"],
        "decode_step_wall_ms": step_wall, "decode_step_device_ms": step_busy,
        "decode_step_idle_share": 1.0 - step_busy / step_wall,
        "decode_step_launches": sum(c for _, c in kern.values()) / n,
        "weight_bytes_read_per_step": weight_bytes,
        "decode_step_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "top_kernels_us_per_step": {key[:60]: t / n for key, (t, _) in top},
    }
    log("serve", json.dumps(summary))
    gen_q = torch.Generator(device=device).manual_seed(1)
    snap = (torch.randn(SERVE_POOL.max_batch, cfg.n_heads, cfg.head_dim, device=device,
                        generator=gen_q).to(cfg.compute_dtype),
            sch.pool.pools["k"][0], sch.pool.pools["v"][0],
            busiest["table"], busiest["lengths"] + 1)
    return summary, snap, got


def score_tokens(cfg, device, s):
    """One seeded (1, s) token batch."""
    return torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, s)),
                           device=device)


def score_phase(device, cfg, params, s=2048) -> tuple[dict, dict]:
    """forward() at full width, B=1, with the port's own random init: 32
    flash_attention launches, each held to the plain version on its own
    inputs; finite logits. The on vs off logit difference is reported."""
    tokens = score_tokens(cfg, device, s)
    cfg_on = dataclasses.replace(cfg, attention_kernel="on")
    cfg_off = dataclasses.replace(cfg, attention_kernel="off")
    T.forward(cfg_on, params, tokens[:, :128])  # warm-up (cuBLAS plans)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on = T.forward(cfg_on, params, tokens)
    torch.cuda.synchronize()
    t_on = time.perf_counter() - t0
    got = launches()
    if got["flash_attention"] != cfg.n_layers or got["decode_attention"] != 0:
        raise AssertionError(f"score launches {got}: want {cfg.n_layers} flash_attention")
    if on.shape != (1, s, cfg.vocab_size) or not torch.isfinite(on).all():
        raise AssertionError(f"score logits {tuple(on.shape)} not finite")
    with ops.held_to_plain("flash_attention") as layer_errs:
        T.forward(cfg_on, params, tokens)
    if len(layer_errs) != cfg.n_layers:
        raise AssertionError(f"{len(layer_errs)} flash calls held to the plain version")
    t0 = time.perf_counter()
    off = T.forward(cfg_off, params, tokens)
    torch.cuda.synchronize()
    t_off = time.perf_counter() - t0
    out = {"B": 1, "S": s, "seconds_on": t_on, "seconds_off": t_off,
           "tokens_per_s_on": s / t_on,
           "kernel_vs_plain_per_layer_max_abs": max(layer_errs),
           "reported_on_vs_off_logits_max_abs": (on - off).abs().max().item(),
           "reported_on_vs_off_within_bar": within_bf16_bar(on, off),
           "logits_abs_max": off.abs().max().item()}
    log("score", json.dumps(out))
    return out, got


def condition_attention(cfg, params) -> None:
    """Rescale the attention projections in place to a 1/sqrt(fan_in) init
    over the contracted width (d_model for wq, wk, wv; q_dim for wo).

    The reference's ParamDef takes shape[-2] as fan_in, which for the 3-D
    attention weights is the head count (32, 8) or head_dim (128): at
    minitron-8b's width the scores then have a standard deviation of about
    256, softmax is nearly an argmax, and a one-ulp bf16 change of one
    layer's attention output flips later layers' argmax: whole-model logits
    are a chaotic function of the attention outputs. With this scale the
    scores are O(1) and logits are a smooth function of them."""
    attn = params["blocks"]["attn"]
    d, q_dim = cfg.d_model, cfg.q_dim
    with torch.no_grad():
        attn["wq"].mul_(math.sqrt(cfg.n_heads / d))
        attn["wk"].mul_(math.sqrt(cfg.n_kv_heads / d))
        attn["wv"].mul_(math.sqrt(cfg.n_kv_heads / d))
        attn["wo"].mul_(math.sqrt(cfg.head_dim / q_dim))


def conditioned_phase(device, cfg, params, s=2048) -> dict:
    """End-to-end logit checks on the conditioned weights (hard checks):
    the first 4 serve decode steps on vs off within the bf16 bar; request
    0's first decode step, paged vs the contiguous generate(), within the
    bf16 bar times the layer count (test_serve.py's rule for logits that see
    one attention tolerance through every layer); forward at S=2048 on vs
    off within the bf16 bar."""
    condition_attention(cfg, params)
    sch = Scheduler(cfg, params, SERVE_POOL, device=device)
    reqs = serve_requests(cfg)
    for r in reqs:
        sch.submit(r)
    mode_errs, first_step = [], {}
    sch.decode_fn = on_vs_off_decode(sch, cfg, 4, mode_errs, first_step)
    for _ in range(4):
        sch.step()
    if not all(ok for _, ok in mode_errs) or len(mode_errs) != 4:
        raise AssertionError(f"decode on vs off logits outside the bf16 bar: {mode_errs}")
    gen = generate(cfg, params, torch.as_tensor(reqs[0].tokens, device=device)[None],
                   max_new_tokens=1)
    slot0 = next(sl for sl, st in sch.active.items() if st.req.rid == 0)
    if int(gen.tokens[0, 0]) != int(sch.active[slot0].generated[0]):
        raise AssertionError("request 0: paged and contiguous prefill pick other tokens")
    paged_err = (first_step["logits"] - gen.logits[1][0]).abs().max().item()
    paged_bar = BF16_BAR * cfg.n_layers
    if paged_err > paged_bar:
        raise AssertionError(f"request 0: paged vs contiguous {paged_err} > {paged_bar}")
    tokens = score_tokens(cfg, device, s)
    on = T.forward(dataclasses.replace(cfg, attention_kernel="on"), params, tokens)
    off = T.forward(dataclasses.replace(cfg, attention_kernel="off"), params, tokens)
    if not within_bf16_bar(on, off):
        raise AssertionError(f"score on vs off {(on - off).abs().max().item()}")
    out = {"decode_on_vs_off_logits_max_abs": [e for e, _ in mode_errs],
           "paged_vs_contiguous_max_abs": paged_err, "paged_vs_contiguous_bar": paged_bar,
           "score_on_vs_off_max_abs": (on - off).abs().max().item(),
           "score_on_vs_off_rel_norm": ((on - off).norm() / off.norm()).item(),
           "score_logits_abs_max": off.abs().max().item()}
    log("conditioned", json.dumps(out))
    return out


def main() -> int:
    """Run every phase; the last stdout line is the result object."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log("device", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{kind} x{count}")

    t0 = time.perf_counter()
    built = _build.build_all()  # one nvcc per source, all started together
    for name in _build.SIGNATURES:
        _build.load_library(name)
    log("build", f"{sorted(built)} built, {len(_build.SIGNATURES)} loaded in "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    rcv1, news20 = DATASET_PRESETS["rcv1"], DATASET_PRESETS["news20"]
    main_shape = (10, rcv1["d"], rcv1["k"])
    # + init_state's phibar scatter: all q*k = 7,400 entries of a node at
    # once, into D = d + 3 (AUC)
    init_shape = (10, rcv1["d"] + 3, 100 * rcv1["k"])
    errs = kernel_parity(dev, [main_shape, init_shape, (3, 1003, 9), (10, 2000, 1200)])
    times = time_kernels(dev, *main_shape)
    log("kernels", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    total, _ = slice_runs(dev, rcv1["d"], rcv1["k"])
    log("slice", f"launches {total}; done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    profile_steps(dev, rcv1["d"], rcv1["k"])
    log("profile", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    widest_run(dev, news20["d"], news20["k"])
    log("widest", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cfg = get_config("minitron-8b")
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log("model", f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count()} params, {nbytes / 1e9:.2f} GB on the card, "
        f"drawn in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    _, decode_main, serve_launches = serve_phase(dev, cfg, params)
    log("serve", f"launches {serve_launches}; done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    errs.update(attention_parity(dev, decode_main))
    times.update(time_attention(dev, decode_main))
    log("attention", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    _, score_launches = score_phase(dev, cfg, params)
    log("score", f"launches {score_launches}; done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    conditioned_phase(dev, cfg, params)
    log("conditioned", f"done in {time.perf_counter() - t0:.1f} s")

    total["decode_attention"] = serve_launches["decode_attention"]
    total["flash_attention"] = score_launches["flash_attention"]
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": total[name],
         "max_abs_err": errs[name], **times[name]}
        for name in ("sparse_dot", "sparse_axpy", "flash_attention", "decode_attention")
    ]
    log("all", f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
