"""Deprecated shims for the deterministic baselines (EXTRA / DLM / SSDA).

Port of ``repro.core.baselines``. The implementations live in the
``core.solvers`` registry (entries ``extra``, ``dlm``, ``ssda``);
``core.solvers.solve`` is the one run entrypoint. These wrappers keep the
legacy signatures for external callers and warn once per process at the
caller's line. Like every entry point of the port they run on CUDA unless
the caller passes ``device="cpu"``.

Background (paper Table 1):

  EXTRA  (Shi et al. 2015a)    — eq. (47) form: exact first-order correction
  DLM    (Ling et al. 2015)    — linearized decentralized ADMM
  SSDA   (Scaman et al. 2017)  — accelerated gradient on the dual, needs
                                 the conjugate gradient map grad f_n^*

All of them evaluate FULL local gradients/operators each iteration (cost
O(rho q d) per node) and exchange dense d-vectors with neighbors (cost
O(Delta(G) d)) — the two costs DSBA improves on.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core import solvers
from repro_torch.core.deprecation import warn_once
from repro_torch.core.dsba import RunResult
from repro_torch.core.mixing import Graph
from repro_torch.core.operators import OperatorSpec


def _deprecated(name: str, method: str) -> None:
    # once per process per shim; stacklevel=3 walks warn_once's caller
    # (this helper) -> the run_* shim -> the user's call site.
    warn_once(
        f"baselines.{name}",
        f"core.baselines.{name} is deprecated and will be REMOVED in v0.2 "
        f"(final warning); use core.solvers.solve("
        f"problem, method={method!r}, comm='dense') instead",
        stacklevel=3,
    )


def _legacy_solve(
    method: str,
    spec: OperatorSpec,
    data,
    graph: Graph,
    w: np.ndarray | None,
    lam: float,
    steps: int,
    z_star: np.ndarray | None,
    record_every: int,
    device,
    **hp,
) -> RunResult:
    problem = solvers.Problem(
        spec=spec, data=data, graph=graph, w=w, lam=lam, z_star=z_star
    )
    res = solvers.solve(
        problem, method=method, comm="dense", steps=steps,
        record_every=record_every, device=device, **hp,
    )
    return RunResult(res.state, res.iters, res.dist2, res.consensus, res.zs)


def run_extra(
    spec: OperatorSpec,
    data,
    w: np.ndarray,
    alpha: float,
    lam: float,
    steps: int,
    z_star: np.ndarray | None = None,
    record_every: int = 1,
    device=None,
) -> RunResult:
    """Deprecated: ``solve(problem, method="extra")`` replaces this."""
    _deprecated("run_extra", "extra")
    graph = solvers.graph_from_mixing(w)
    return _legacy_solve(
        "extra", spec, data, graph, w, lam, steps, z_star, record_every,
        device, alpha=alpha,
    )


def run_dlm(
    spec: OperatorSpec,
    data,
    graph: Graph,
    c: float,
    beta: float,
    lam: float,
    steps: int,
    z_star: np.ndarray | None = None,
    record_every: int = 1,
    device=None,
) -> RunResult:
    """Deprecated: ``solve(problem, method="dlm")`` replaces this."""
    _deprecated("run_dlm", "dlm")
    return _legacy_solve(
        "dlm", spec, data, graph, None, lam, steps, z_star, record_every,
        device, c=c, beta=beta,
    )


def run_ssda(
    spec: OperatorSpec,
    data,
    w: np.ndarray,
    eta: float,
    momentum: float,
    lam: float,
    steps: int,
    z_star: np.ndarray | None = None,
    record_every: int = 1,
    inner_newton: int = 8,
    device=None,
) -> RunResult:
    """Deprecated: ``solve(problem, method="ssda")`` replaces this."""
    _deprecated("run_ssda", "ssda")
    graph = solvers.graph_from_mixing(w)
    return _legacy_solve(
        "ssda", spec, data, graph, w, lam, steps, z_star, record_every,
        device, eta=eta, momentum=momentum, inner_newton=inner_newton,
    )
