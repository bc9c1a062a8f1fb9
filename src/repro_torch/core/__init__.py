"""The paper's primary contribution and its substrate (port of ``repro.core``).

DSBA/DSA plus monotone operators, mixing matrices, the deterministic and
accelerated baselines, the sparse communication relay, and the pod-axis
gossip generalization. The public run entrypoint is ``core.solvers.solve``
(Problem + SolverSpec registry); ``dsba.run`` and the ``baselines.run_*``
wrappers are deprecated shims. ``runner_cache_stats`` and
``clear_runner_caches`` read and reset the runner caches behind ``solve``
and ``solve_many``.
"""
from repro_torch.core.operators import OperatorSpec  # noqa: F401
from repro_torch.core.dsba import (  # noqa: F401
    DSBAConfig, DSBAState, dsba_step, init_state,
)
from repro_torch.core.solvers import (  # noqa: F401
    CapabilityError, Problem, SolveResult, SolverCapabilities, SolverSpec,
    available_solvers, clear_runner_caches, get_solver, make_problem,
    register_solver, runner_cache_stats, solve, solve_many,
)
from repro_torch.core import mixing, baselines, reference, solvers  # noqa: F401
