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

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises: no phase catches its
own failure.
"""
from __future__ import annotations

import json
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
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.ref import sparse_axpy_ref, sparse_dot_ref  # noqa: E402
from repro_torch.kernels.sparse_saga import sparse_axpy, sparse_dot  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate; float32 and float64
# (non-tensor-core) arithmetic rates
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12}

KERNEL_SOURCE = "src/repro_torch/kernels/csrc/sparse_saga.cu"
REPLACES = {
    "sparse_dot": "src/repro/kernels/sparse_saga.py:56",
    "sparse_axpy": "src/repro/kernels/sparse_saga.py:122",
}
WRAPPERS = {"sparse_dot": sparse_dot, "sparse_axpy": sparse_axpy}
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


def kernel_device_ms(fn, names, iters=50):
    """Device milliseconds per call of ``fn`` spent in CUDA kernels whose
    name contains one of `names` (None when the profiler sees none)."""
    fn()
    torch.cuda.synchronize()
    _, kern = device_profile(fn, iters)
    hits = [t for key, (t, _) in kern.items() if any(n in key for n in names)]
    return sum(hits) / iters / 1e3 if hits else None


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
        want = expected_launches(steps, comm)
        if got != want or min(got.values()) == 0:
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
    lib = _build.load_library()
    log("build", f"{lib._name} in {time.perf_counter() - t0:.1f} s")

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

    kernels = [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[name], "launches": total[name],
         "max_abs_err": errs[name], **times[name]}
        for name in ("sparse_dot", "sparse_axpy")
    ]
    log("all", f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
