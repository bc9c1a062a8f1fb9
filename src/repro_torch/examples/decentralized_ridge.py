"""Paper Figure-1-style experiment: DSBA vs DSA vs EXTRA vs DLM vs SSDA on
sparse ridge regression, reporting suboptimality vs effective passes AND
communication cost C_max (DOUBLEs received by the hottest node) (the
counterpart of the JAX package's ``examples/decentralized_ridge.py``, with
``--device``).

Every method runs through the one registry entrypoint
``core.solvers.solve``; the communication numbers come straight from the
uniform ``SolveResult.doubles_received`` accounting (closed-form relay
accounting for the sparse runs, deg*d dense exchange otherwise).

    PYTHONPATH=src python -m repro_torch.examples.decentralized_ridge --device cpu
    python -m repro_torch.examples.decentralized_ridge --dataset rcv1 --d 47236   # on the card

Runs on the card unless --device (``device=``) says otherwise. The preset
width is capped at 4,000 unless --d is given (the cap exists for the CPU
reference solve).
"""
from __future__ import annotations

import argparse

from repro_torch.core import mixing
from repro_torch.core.solvers import make_problem, solve
from repro_torch.core.sparse_comm import sparse_doubles_per_iter
from repro_torch.data.synthetic import DATASET_PRESETS, make_regression


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="small", choices=list(DATASET_PRESETS))
    ap.add_argument("--q", type=int, default=50)
    ap.add_argument("--passes", type=int, default=40)
    ap.add_argument("--d", type=int, default=None,
                    help="override the preset dimension (smoke tests)")
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    device = args.device if device is None else device

    p = DATASET_PRESETS[args.dataset]
    d = min(p["d"], 4000) if args.d is None else args.d  # cap: CPU ref solve
    k = min(p["k"], max(1, d // 2))
    N = 10
    data = make_regression(N, args.q, d, k=k, seed=0)
    graph = mixing.erdos_renyi_graph(N, 0.4, seed=1)
    problem = make_problem("ridge", data, graph)  # lam = 1/(10 Q)
    problem.solve_star(device=device)

    q = data.q
    stoch_steps = args.passes * q  # 1 effective pass = q stochastic steps
    det_steps = args.passes  # deterministic methods touch all data per step

    results = {}
    res = solve(problem, "dsba", steps=stoch_steps, record_every=q, alpha=0.5, device=device)
    results["DSBA"] = (res.iters / q, res.dist2)
    res = solve(problem, "dsa", steps=stoch_steps, record_every=q, alpha=0.2, device=device)
    results["DSA"] = (res.iters / q, res.dist2)
    res = solve(problem, "extra", steps=det_steps, record_every=1, alpha=0.3, device=device)
    results["EXTRA"] = (res.iters, res.dist2)
    res = solve(problem, "dlm", steps=det_steps, record_every=1, c=0.3, beta=1.0,
                device=device)
    results["DLM"] = (res.iters, res.dist2)
    # SSDA's dual step must satisfy eta < 2*lam/||I-W||: tiny at the
    # paper's lambda = 1/(10Q) conditioning
    res = solve(problem, "ssda", steps=det_steps, record_every=1,
                eta=1e-4, momentum=0.0, device=device)
    results["SSDA"] = (res.iters, res.dist2)
    dense_res = res  # any dense run carries the deg*d accounting

    print(f"\ndataset={args.dataset} d={d} rho={data.rho:.4f} "
          f"N={N} q={q} lam={problem.lam:.2e}")
    print(f"{'passes':>7}", *[f"{m:>12}" for m in results])
    idx = range(0, args.passes, max(1, args.passes // 10))
    for i in idx:
        row = [f"{i + 1:7d}"]
        for m, (xs, ys) in results.items():
            j = min(i, len(ys) - 1)
            row.append(f"{ys[j]:12.2e}")
        print(*row)

    # communication cost per effective pass (DOUBLEs at the hottest node):
    # dense methods from the SolveResult accounting, DSBA-s from the relay's
    # closed-form steady state
    dense = int(dense_res.doubles_received[-1].max() // dense_res.iters[-1])
    sparse = sparse_doubles_per_iter(N, data.k, 0)
    print("\ncommunication per effective pass (hottest node, DOUBLEs):")
    print(f"  dense methods (EXTRA/DLM/SSDA): {dense}  (deg*d per iter x 1)")
    print(f"  DSBA/DSA dense exchange       : {dense * q}")
    print(f"  DSBA-s sparse exchange        : {sparse * q}   "
          f"({dense * q / (sparse * q):.1f}x less than dense stochastic)")
    return results


if __name__ == "__main__":
    main()
