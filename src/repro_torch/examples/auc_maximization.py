"""Paper Figure-3 experiment: decentralized l2-relaxed AUC maximization
(the counterpart of the JAX package's ``examples/auc_maximization.py``,
with ``--device``).

AUC involves PAIRWISE losses that classic decentralized methods cannot
handle with one sample per step; the saddle reformulation (Ying et al. 2016,
eq. 11-12) + DSBA's monotone-operator view makes it a one-sample-per-step
decentralized problem with closed-form resolvents (paper appendix 9.7).

    PYTHONPATH=src python -m repro_torch.examples.auc_maximization --device cpu

Runs on the card unless --device (``device=``) says otherwise.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import mixing, reference
from repro_torch.core.solvers import make_problem, solve
from repro_torch.data.synthetic import make_classification


def main(passes=30, record_passes=2, device=None):
    N, q, d = 10, 50, 300
    data = make_classification(N, q, d, k=10, positive_ratio=0.25, seed=0)
    graph = mixing.erdos_renyi_graph(N, 0.4, seed=1)
    problem = make_problem("auc", data, graph)  # z = [w; a; b; theta]
    z_star = problem.solve_star(device=device)
    p = problem.spec.p

    res = solve(problem, "dsba", steps=passes * q, record_every=record_passes * q,
                alpha=1.0, keep_snapshots=True, device=device)

    print(f"positive ratio p = {p:.3f};  z in R^{d + 3} = [w; a; b; theta]")
    print(f"{'passes':>7} {'dist^2 to saddle':>18} {'AUC (node mean)':>16}")
    for i, (it, d2) in enumerate(zip(res.iters, res.dist2)):
        w_nodes = res.zs[i][:, :d]
        auc = np.mean([reference.auc_score(w, data) for w in w_nodes])
        print(f"{it // q:7d} {d2:18.3e} {auc:16.4f}")
    auc_star = reference.auc_score(z_star[:d], data)
    print(f"\nAUC at the exact saddle point: {auc_star:.4f}")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    main(device=ap.parse_args().device)
