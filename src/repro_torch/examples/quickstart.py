"""Quickstart: decentralized ridge regression with DSBA in ~20 lines (the
counterpart of the JAX package's ``examples/quickstart.py``, with
``--device``).

    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Runs on the card unless --device (``device=``) says otherwise; the dense
DSBA step launches the ``sparse_dot`` and ``sparse_axpy`` kernels there.
"""
from __future__ import annotations

import argparse

from repro_torch.core import mixing
from repro_torch.core.solvers import make_problem, solve
from repro_torch.data.synthetic import make_regression


def main(steps=8000, record_every=500, device=None):
    # 10 nodes, Erdos-Renyi(0.4) topology — the paper's setup (Section 7)
    N, Q_PER_NODE, DIM = 10, 50, 200
    data = make_regression(n_nodes=N, q=Q_PER_NODE, d=DIM, k=10, seed=0)
    graph = mixing.erdos_renyi_graph(N, 0.4, seed=1)

    problem = make_problem("ridge", data, graph)  # lam = 1/(10 Q), W Laplacian
    problem.solve_star(device=device)  # centralized root, cached on the problem

    # backward steps: large alpha is stable
    res = solve(problem, method="dsba", steps=steps,
                record_every=record_every, alpha=2.0, device=device)

    print("iter   mean ||z_n - z*||^2      consensus error")
    for it, d2, ce in zip(res.iters, res.dist2, res.consensus):
        print(f"{it:5d}   {d2:20.3e}   {ce:16.3e}")
    print(f"\nlinear convergence to the centralized optimum: {res.dist2[-1]:.2e}")
    return res


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    main(device=ap.parse_args().device)
