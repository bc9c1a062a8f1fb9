"""One solver API: ``Problem`` + ``SolverSpec`` registry + ``solve()``.

Port of the slice of ``repro.core.solvers`` that runs the paper's methods:
DSBA and DSA (Algorithm 1 and Remark 5.1) on the ridge, logistic, AUC and
bilinear families, over dense neighbor exchange (``comm="dense"``) or the
DSBA-s delta relay (``comm="sparse"``). Every run returns the same
``SolveResult`` as the JAX package, including cumulative DOUBLEs/ints per
node: from the relay's closed-form accounting, or ``deg(n) * D`` per
iteration for dense exchange.

PyTorch runs eagerly, so there is no compiled-runner cache: ``solve`` loops
over the iterations in Python on the chosen device (CUDA unless the caller
passes ``device="cpu"``). Not ported yet, and raising
``NotImplementedError`` rather than taking another path: ``comm="sharded"``
(ROADMAP Queue 1 item 10), graph schedules, fault plans and
checkpoint/resume (item 9), ``solve_many`` (item 8) and the other methods
(item 7).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.convert import dataset_to_torch
from repro_torch.core import reference
from repro_torch.core.comm import DenseComm
from repro_torch.core.dsba import DSBAConfig, draw_indices, init_state, make_step_fn
from repro_torch.core.mixing import Graph, laplacian_mixing
from repro_torch.core.operators import FAMILIES, OperatorSpec
from repro_torch.core.sparse_comm import dense_doubles_per_iter, run_sparse
from repro_torch.device import resolve_device

COMM_BACKENDS = ("dense", "sparse")
_NOT_PORTED = {
    "sharded": "comm='sharded' is not ported yet (ROADMAP Queue 1 item 10)",
    "schedule": "graph schedules are not ported yet (ROADMAP Queue 1 item 9)",
    "fault_plan": "fault plans are not ported yet (ROADMAP Queue 1 item 9)",
    "checkpoint": "checkpoint/resume is not ported yet (ROADMAP Queue 1 item 9)",
    "engine": "only the vectorized relay engine is ported (ROADMAP Queue 1 item 6b)",
    "solve_many": "solve_many is not ported yet (ROADMAP Queue 1 item 8)",
}
_COMM_OPTION_KEYS = {"dense": (), "sparse": ("verify", "engine")}


def graph_from_mixing(w: np.ndarray, atol: float = 1e-12) -> Graph:
    """Recover the communication ``Graph`` from a mixing matrix's support."""
    w = np.asarray(w)
    n = w.shape[0]
    edges = tuple(
        (i, j)
        for i in range(n)
        for j in range(i + 1, n)
        if abs(w[i, j]) > atol
    )
    return Graph(n, edges)


@dataclasses.dataclass
class Problem:
    """A decentralized root-finding problem instance.

    Bundles the operator family (``spec``), the per-node numpy data (a
    padded-CSR ``SparseDataset``), the communication ``graph``, the mixing
    matrix ``w`` (default: the paper's Laplacian weights), the l2
    regularizer ``lam`` (scalar, or (N,) per node on ``comm="dense"``) and
    an optional cached centralized root ``z_star``.
    """

    spec: OperatorSpec
    data: Any  # data.synthetic.SparseDataset (duck-typed)
    graph: Graph
    w: np.ndarray | None = None
    lam: float | np.ndarray = 0.0
    z_star: np.ndarray | None = None
    schedule: Any = None

    def __post_init__(self):
        """Default ``w`` to Laplacian mixing and sanity-check shapes."""
        if self.schedule is not None:
            raise NotImplementedError(_NOT_PORTED["schedule"])
        if self.w is None:
            self.w = laplacian_mixing(self.graph)
        self.w = np.asarray(self.w)
        if self.w.shape != (self.graph.n, self.graph.n):
            raise ValueError(
                f"mixing matrix {self.w.shape} != graph size {self.graph.n}"
            )
        if self.data.n_nodes != self.graph.n:
            raise ValueError(
                f"data has {self.data.n_nodes} nodes, graph {self.graph.n}"
            )
        if np.ndim(self.lam) > 0:
            self.lam = np.asarray(self.lam, dtype=np.float64)
            if self.lam.shape != (self.graph.n,):
                raise ValueError(
                    f"per-node lam must be ({self.graph.n},), "
                    f"got {self.lam.shape}"
                )

    @property
    def dim(self) -> int:
        """Total iterate dimension D = d + tail_dim."""
        return self.data.d + self.spec.tail_dim

    def solve_star(self, **kwargs) -> np.ndarray:
        """Compute (once) and cache the centralized root ``z*``.

        Delegates to ``reference.solve_root``; kwargs (``iters``, ``tol``,
        ``device``) pass through.
        """
        if self.z_star is None:
            if np.ndim(self.lam) > 0:
                raise ValueError("per-node lam has no centralized root")
            self.z_star = reference.solve_root(
                self.spec, self.data, self.lam, **kwargs
            )
        return self.z_star


def make_problem(
    task: str,
    data,
    graph: Graph,
    w: np.ndarray | None = None,
    lam: float | None = None,
    gamma: float = 1.0,
) -> Problem:
    """Build a ``Problem`` from a task name with the paper's conventions.

    task: ``"ridge" | "logistic" | "auc" | "bilinear"`` (AUC reads the
    positive-class ratio from the data). ``lam`` defaults to 1/(10 Q).
    """
    if task == "auc":
        spec = OperatorSpec("auc", p=data.positive_ratio())
    elif task == "bilinear":
        spec = OperatorSpec("bilinear", gamma=gamma)
    elif task in ("ridge", "logistic"):
        spec = OperatorSpec(task)
    else:
        raise ValueError(f"unknown task {task!r}; one of {FAMILIES}")
    if lam is None:
        lam = 1.0 / (10.0 * data.total)
    return Problem(spec=spec, data=data, graph=graph, w=w, lam=lam)


# ---------------------------------------------------------------------------
# SolverSpec registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SolverSpec:
    """One solver's contract with ``solve()``.

    - ``init(problem, hp, data, z0) -> state``: initial state on z0's
      device (``data`` is the problem's ``convert.TensorDataset``).
    - ``step(problem, hp, data, comm) -> fn(state, i_t) -> state``.
    - ``z_of(state) -> (N, D)`` iterate read-out.
    - ``defaults``: hyperparameters with default values (also the schema:
      ``solve()`` rejects unknown overrides).
    - ``sparse_run``: optional ``(problem, hp, steps, indices, z0, options,
      device) -> SparseRunResult`` (the relay); ``None`` = dense only.
    - ``problem_families``: operator families the method supports.
    """

    name: str
    init: Callable
    step: Callable
    z_of: Callable
    defaults: Mapping[str, float]
    sparse_run: Callable | None = None
    problem_families: tuple[str, ...] = ("ridge", "logistic", "auc")


class CapabilityError(ValueError):
    """A (method, comm backend, operator family) combination is unsupported."""

    def __init__(self, method: str, comm: str, family: str, reason: str):
        super().__init__(
            f"unsupported combination (method={method!r}, comm={comm!r}, "
            f"operator family={family!r}): {reason}"
        )
        self.method = method
        self.comm = comm
        self.family = family


_REGISTRY: dict[str, SolverSpec] = {}


def register_solver(spec: SolverSpec) -> SolverSpec:
    """Add a ``SolverSpec`` to the registry (name must be unused)."""
    if spec.name in _REGISTRY:
        raise ValueError(f"solver {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_solver(name: str) -> SolverSpec:
    """Look up a registered solver by name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown method {name!r}; registered: {sorted(_REGISTRY)} "
            "(the other methods are ROADMAP Queue 1 item 7)"
        ) from None


# ---------------------------------------------------------------------------
# SolveResult + the metrics recorder
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SolveResult:
    """Uniform result of ``solve()`` (the JAX package's schema).

    Record-point arrays share the leading axis R = len(iters); ``dist2`` is
    empty without a cached ``z_star``; ``doubles_received``/
    ``ints_received`` are cumulative per-node message counts. ``state`` is
    the final solver state (``None`` for sparse runs); ``extras`` carries
    the sparse backend's ``z_trace`` and ``recon_max_err``.
    """

    method: str
    comm: str
    iters: np.ndarray  # (R,) iteration counts at record points
    dist2: np.ndarray  # (R,) mean_n ||z_n - z*||^2 (empty without z_star)
    consensus: np.ndarray  # (R,) mean_n ||z_n - zbar||^2
    doubles_received: np.ndarray  # (R, N) cumulative DOUBLEs per node
    ints_received: np.ndarray  # (R, N) cumulative index ints per node
    wall_time: float  # seconds in the solver (setup + loop + metrics)
    z: np.ndarray  # (N, D) final iterates
    state: Any  # final solver state (None for sparse runs)
    zs: np.ndarray | None = None  # (R, N, D) snapshots if requested
    extras: dict = dataclasses.field(default_factory=dict)


def _record_points(steps: int, record_every: int) -> list[int]:
    """Iteration counts to record at: every ``record_every``, plus the end."""
    pts = list(range(record_every, steps + 1, record_every))
    if not pts or pts[-1] != steps:
        pts.append(steps)
    return pts


class _Recorder:
    """The metrics recorder shared by both comm backends (numpy, host side)."""

    def __init__(self, z_star: np.ndarray | None, keep_snapshots: bool):
        self.z_star = None if z_star is None else np.asarray(z_star)
        self.iters: list[int] = []
        self.dist2: list[float] = []
        self.consensus: list[float] = []
        self.zs: list[np.ndarray] | None = [] if keep_snapshots else None

    def push(self, it: int, z) -> None:
        """Record consensus / distance-to-z* of (N, D) iterates at step ``it``."""
        z = np.asarray(z)
        zbar = z.mean(-2, keepdims=True)
        self.iters.append(it)
        self.consensus.append(np.mean(np.sum((z - zbar) ** 2, -1), -1))
        if self.z_star is not None:
            self.dist2.append(np.mean(np.sum((z - self.z_star) ** 2, -1), -1))
        if self.zs is not None:
            self.zs.append(z)

    def arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, Any]:
        """(iters, dist2, consensus, zs) as numpy arrays."""
        zs = np.stack(self.zs) if self.zs else None
        return (
            np.asarray(self.iters),
            np.asarray(self.dist2) if self.dist2 else np.zeros(0),
            np.asarray(self.consensus),
            zs,
        )


# ---------------------------------------------------------------------------
# solve()
# ---------------------------------------------------------------------------


def _validate_options(comm: str, comm_options: Mapping | None) -> dict:
    """Reject unknown comm options and options of parts not ported yet."""
    opts = dict(comm_options or {})
    if "fault_plan" in opts:
        raise NotImplementedError(_NOT_PORTED["fault_plan"])
    unknown = sorted(set(opts) - set(_COMM_OPTION_KEYS[comm]))
    if unknown:
        raise ValueError(
            f"unknown {comm} comm_options {unknown}; accepts "
            f"{sorted(_COMM_OPTION_KEYS[comm])}"
        )
    if opts.pop("engine", "vectorized") != "vectorized":
        raise NotImplementedError(_NOT_PORTED["engine"])
    return opts


def solve(
    problem: Problem,
    method: str = "dsba",
    comm: str = "dense",
    *,
    steps: int,
    record_every: int = 50,
    seed: int = 0,
    z0: np.ndarray | None = None,
    indices: np.ndarray | None = None,
    keep_snapshots: bool = False,
    comm_options: dict | None = None,
    checkpoint=None,
    resume=None,
    device=None,
    **hyperparams,
) -> SolveResult:
    """Run ``method`` on ``problem`` over ``comm`` and return a SolveResult.

    method: ``"dsba"`` or ``"dsa"``. comm: ``"dense"`` (the mixing
        product) or ``"sparse"`` (the paper's delta relay).
    steps / record_every: iterations to run / metric recording period (the
        final iteration is always recorded).
    seed / indices: the per-node sample stream — drawn from ``seed``
        unless an explicit (>= steps, N) ``indices`` array is given (the
        JAX package draws the same stream from the same seed).
    z0: (N, D) numpy starting point, default zeros.
    comm_options: ``{"verify": bool}`` for ``comm="sparse"``.
    device: CUDA unless the caller passes ``"cpu"``; without a card and
        without ``device`` this raises.
    **hyperparams: overrides of the solver's ``defaults`` (``alpha``).
    """
    if comm == "sharded":
        raise NotImplementedError(_NOT_PORTED["sharded"])
    if comm not in COMM_BACKENDS:
        raise ValueError(f"unknown comm backend {comm!r}; one of {COMM_BACKENDS}")
    if checkpoint is not None or resume is not None:
        raise NotImplementedError(_NOT_PORTED["checkpoint"])
    spec = get_solver(method)
    family = problem.spec.kind
    if family not in spec.problem_families:
        raise CapabilityError(method, comm, family, "family not supported")
    if comm == "sparse" and spec.sparse_run is None:
        raise CapabilityError(method, comm, family, "no sparse protocol")
    if comm == "sparse" and np.ndim(problem.lam) > 0:
        raise CapabilityError(
            method, comm, family, "per-node lam runs on comm='dense' only"
        )
    opts = _validate_options(comm, comm_options)
    if steps < 1:
        raise ValueError("steps must be >= 1")
    if record_every < 1:
        raise ValueError("record_every must be >= 1")
    hp = dict(spec.defaults)
    unknown = set(hyperparams) - set(hp)
    if unknown:
        raise TypeError(
            f"{method!r} got unknown hyperparameters {sorted(unknown)}; "
            f"accepts {sorted(hp)}"
        )
    hp.update(hyperparams)
    dev = resolve_device(device)

    data = problem.data
    n, D = data.n_nodes, problem.dim
    if z0 is None:
        z0 = np.zeros((n, D), dtype=data.val.dtype)
    if indices is None:
        indices = draw_indices(steps, n, data.q, seed)
    indices = np.asarray(indices)
    if indices.ndim != 2 or indices.shape[0] < steps or indices.shape[1] != n:
        raise ValueError(
            f"indices must be (>= steps, N) = (>={steps}, {n}), "
            f"got {indices.shape}"
        )
    pts = _record_points(steps, record_every)
    rec = _Recorder(problem.z_star, keep_snapshots)

    if comm == "sparse":
        t0 = time.perf_counter()
        sres = spec.sparse_run(problem, hp, steps, indices, z0, opts, dev)
        wall = time.perf_counter() - t0
        for pt in pts:
            rec.push(pt, sres.z_trace[pt])
        iters, dist2, cons, zs = rec.arrays()
        sel = np.asarray(pts) - 1
        return SolveResult(
            method=method,
            comm=comm,
            iters=iters,
            dist2=dist2,
            consensus=cons,
            doubles_received=sres.doubles_received[sel],
            ints_received=sres.ints_received[sel],
            wall_time=wall,
            z=sres.z_trace[-1],
            state=None,
            zs=zs,
            extras={
                "z_trace": sres.z_trace,
                "recon_max_err": sres.recon_max_err,
            },
        )

    # ---- dense backend: an eager loop on the device -------------------------
    t0 = time.perf_counter()
    tdata = dataset_to_torch(data, dev)
    comm_b = DenseComm(problem.graph, dev)
    state = spec.init(
        problem, hp, tdata, torch.as_tensor(np.asarray(z0), device=dev)
    )
    step_fn = spec.step(problem, hp, tdata, comm_b)
    idx_t = torch.as_tensor(indices[:steps], dtype=torch.long, device=dev)
    prev = 0
    z_final = None
    for pt in pts:
        for t in range(prev, pt):
            state = step_fn(state, idx_t[t])
        prev = pt
        z_final = spec.z_of(state).cpu().numpy()
        rec.push(pt, z_final)
    wall = time.perf_counter() - t0

    iters, dist2, cons, zs = rec.arrays()
    per_node = dense_doubles_per_iter(problem.graph, D)  # (N,)
    doubles = iters[:, None] * per_node[None, :]
    return SolveResult(
        method=method,
        comm=comm,
        iters=iters,
        dist2=dist2,
        consensus=cons,
        doubles_received=doubles,
        ints_received=np.zeros_like(doubles),
        wall_time=wall,
        z=z_final,
        state=state,
        zs=zs,
    )


def solve_many(*args, **kwargs):
    """Batched sweeps: not ported yet."""
    raise NotImplementedError(_NOT_PORTED["solve_many"])


# ---------------------------------------------------------------------------
# Registry entries: DSBA / DSA (Algorithm 1 + Remark 5.1)
# ---------------------------------------------------------------------------


def _make_dsba_family(method: str, default_alpha: float) -> SolverSpec:
    """Registry entry for the stochastic family: shared step, both comms."""

    def cfg_of(problem, hp):
        return DSBAConfig(
            spec=problem.spec, alpha=hp["alpha"], lam=problem.lam, method=method
        )

    def init(problem, hp, data, z0):
        """SAGA-table warm start (Algorithm 1 line 1) at ``z0``."""
        return init_state(cfg_of(problem, hp), data, z0)

    def step(problem, hp, data, comm):
        """The Algorithm-1 step with mixing through ``comm.matvec``."""
        return make_step_fn(cfg_of(problem, hp), data, problem.w, comm=comm)

    def sparse_run(problem, hp, steps, indices, z0, options, device):
        """The Section-5.1 delta relay (``core.sparse_comm.run_sparse``)."""
        return run_sparse(
            cfg_of(problem, hp), problem.data, problem.graph, problem.w,
            steps, indices, z0=z0, device=device, **options,
        )

    return SolverSpec(
        name=method,
        init=init,
        step=step,
        z_of=lambda state: state.z,
        defaults={"alpha": default_alpha},
        sparse_run=sparse_run,
        problem_families=FAMILIES,
    )


register_solver(_make_dsba_family("dsba", default_alpha=0.5))
register_solver(_make_dsba_family("dsa", default_alpha=0.2))
