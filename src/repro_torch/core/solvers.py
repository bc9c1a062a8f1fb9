"""One solver API: ``Problem`` + ``SolverSpec`` registry + ``solve()``.

Port of ``repro.core.solvers``: the paper's methods DSBA and DSA
(Algorithm 1 and Remark 5.1) on the ridge, logistic, AUC and bilinear
families, over dense neighbor exchange (``comm="dense"``) or the DSBA-s
delta relay (``comm="sparse"``); the deterministic baselines of Table 1
(EXTRA, DLM, SSDA), accelerated consensus (Mudag) and communication
sliding, decentralized stochastic gradient descent ascent (DSGDA) on the
saddle families, and personalized consensus-regularized descent
(``personal``, with per-node ``lam``), all on the dense backend. Every run
returns the same ``SolveResult`` as the JAX package, including cumulative
DOUBLEs/ints per node: from the relay's closed-form accounting, or
``deg(n) * D`` per dense-exchange round (one round an iteration unless the
method's ``comm_rounds`` hook says otherwise). ``available_solvers()``
returns each method's capability record, the reference's field by field,
and ``solve()`` raises ``CapabilityError`` outside it.

PyTorch runs eagerly, so there is no compiled-runner cache: ``solve`` loops
over the iterations in Python on the chosen device (CUDA unless the caller
passes ``device="cpu"``). A solver's step counter is a host integer in its
state, so the ``t == 0`` and communication-round branches are host
branches and no step waits on the device. Not ported yet, and raising
``NotImplementedError`` rather than taking another path: ``comm="sharded"``
(ROADMAP Queue 1 item 10), graph schedules, fault plans and
checkpoint/resume (item 9) and ``solve_many`` (item 8).
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
from repro_torch.core.mixing import Graph, laplacian_mixing, w_tilde
from repro_torch.core.operators import (
    FAMILIES, MINIMIZATION_FAMILIES, OperatorSpec, logistic_coeff_prime,
)
from repro_torch.core.sparse_comm import dense_doubles_per_iter, run_sparse
from repro_torch.device import resolve_device

COMM_BACKENDS = ("dense", "sparse", "sharded")
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
      device (``data`` is the run's ``convert.TensorDataset``).
    - ``step(problem, hp, data, comm) -> fn(state, i_t) -> state``: one
      iteration; ``i_t`` is the (N,) sample draw (deterministic methods
      ignore it); all neighbor exchange goes through ``comm.matvec``.
    - ``z_of(problem, hp, data, comm) -> fn(state) -> (N, D)``: the iterate
      read-out (SSDA's is a real computation, hence a factory).
    - ``defaults``: hyperparameters with default values (also the schema:
      ``solve()`` rejects unknown overrides).
    - ``sparse_run``: optional ``(problem, hp, steps, indices, z0, options,
      device) -> SparseRunResult`` (the relay); ``None`` = no sparse
      protocol.
    - ``problem_families``: operator families the method supports.
    - ``supports_sharded``: the step is safe under the sharded backend.
    - ``comm_rounds``: optional ``(hp, cumulative iterations) ->
      cumulative dense-exchange rounds`` per node; ``None`` is one round
      an iteration (Mudag spends 2K, sliding 2 every ``comm_period``).
    - ``supports_schedule`` / ``supports_churn`` / ``supports_link_faults``
      / ``supports_stragglers``: the reference's dynamic-network and
      fault capabilities (ROADMAP Queue 1 item 9 runs them).
    - ``supports_per_node_lam``: the step takes ``lam`` as an (N,) array
      (personalized regularization), dense backend only.
    """

    name: str
    init: Callable
    step: Callable
    z_of: Callable
    defaults: Mapping[str, float]
    sparse_run: Callable | None = None
    problem_families: tuple[str, ...] = ("ridge", "logistic", "auc")
    supports_sharded: bool = True
    comm_rounds: Callable | None = None
    supports_schedule: bool = False
    supports_churn: bool = False
    supports_per_node_lam: bool = False
    supports_link_faults: bool = True
    supports_stragglers: bool = True

    def capabilities(self) -> "SolverCapabilities":
        """The typed capability record ``available_solvers()`` exposes."""
        return SolverCapabilities(
            supports_sparse_comm=self.sparse_run is not None,
            supports_sharded=self.supports_sharded,
            problem_families=tuple(self.problem_families),
            supports_schedule=self.supports_schedule,
            supports_churn=self.supports_churn,
            supports_per_node_lam=self.supports_per_node_lam,
            supports_link_faults=self.supports_link_faults,
            supports_stragglers=self.supports_stragglers,
        )


@dataclasses.dataclass(frozen=True)
class SolverCapabilities:
    """What one registered solver supports, as data.

    Returned per method by ``available_solvers()``. ``solve()`` enforces
    exactly this record: a combination outside it raises
    ``CapabilityError``, never a silent fallback to another backend.
    """

    supports_sparse_comm: bool
    supports_sharded: bool
    problem_families: tuple[str, ...]
    supports_schedule: bool = False
    supports_churn: bool = False
    supports_per_node_lam: bool = False
    supports_link_faults: bool = True
    supports_stragglers: bool = True

    def comm_backends(self) -> tuple[str, ...]:
        """The comm backends this solver accepts (dense is universal)."""
        out = ["dense"]
        if self.supports_sparse_comm:
            out.append("sparse")
        if self.supports_sharded:
            out.append("sharded")
        return tuple(out)

    def supports(self, comm: str, family: str) -> bool:
        """Whether (comm backend, operator family) is inside this record."""
        return comm in self.comm_backends() and family in self.problem_families


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


def _check_capability(
    spec: SolverSpec,
    comm: str,
    family: str,
    *,
    schedule: bool = False,
    churn: bool = False,
    per_node_lam: bool = False,
    link_faults: bool = False,
    stragglers: bool = False,
) -> None:
    """Raise ``CapabilityError`` unless (spec, comm, family) is supported.

    The keyword flags add the dynamic-network and fault axes (a
    multi-segment ``schedule``, a ``churn`` plan, a ``per_node_lam`` array,
    ``link_faults``, ``stragglers``). Runs before any solver factory.
    """
    caps = spec.capabilities()
    if family not in caps.problem_families:
        raise CapabilityError(
            spec.name, comm, family,
            f"method {spec.name!r} supports operator families "
            f"{list(caps.problem_families)}",
        )
    if comm == "sparse" and not caps.supports_sparse_comm:
        raise CapabilityError(
            spec.name, comm, family,
            f"method {spec.name!r} has no sparse-communication backend",
        )
    if comm == "sharded" and not caps.supports_sharded:
        raise CapabilityError(
            spec.name, comm, family,
            f"method {spec.name!r} does not run under the sharded backend",
        )
    if schedule and not caps.supports_schedule:
        raise CapabilityError(
            spec.name, comm, family,
            f"method {spec.name!r} does not support graph schedules: its "
            "state would carry a stale fixed point across a W change",
        )
    if churn and not caps.supports_churn:
        raise CapabilityError(
            spec.name, comm, family,
            f"method {spec.name!r} does not support node churn "
            "(fault_plan): its state cannot be elastically remapped",
        )
    if link_faults and not caps.supports_link_faults:
        raise CapabilityError(
            spec.name, comm, family,
            f"method {spec.name!r} does not support link faults: its "
            "neighbor exchange does not route through comm.matvec",
        )
    if stragglers and not caps.supports_stragglers:
        raise CapabilityError(
            spec.name, comm, family,
            f"method {spec.name!r} does not support stragglers: its "
            "matvec call sites are not fixed-count per iteration "
            "(inner gossip loop or traced round gating)",
        )
    if stragglers and comm != "dense":
        raise CapabilityError(
            spec.name, comm, family,
            "stragglers (delayed delivery buffers) run on comm='dense' "
            "only; link faults cover the sharded and sparse backends",
        )
    if per_node_lam and not caps.supports_per_node_lam:
        raise CapabilityError(
            spec.name, comm, family,
            f"method {spec.name!r} does not support per-node lam "
            "(personalization); see available_solvers()",
        )
    if per_node_lam and comm != "dense":
        raise CapabilityError(
            spec.name, comm, family,
            "per-node lam (personalization) runs on comm='dense' only",
        )


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
            f"unknown method {name!r}; registered: {sorted(_REGISTRY)}"
        ) from None


def available_solvers() -> dict[str, SolverCapabilities]:
    """{name: SolverCapabilities} for every registered solver, by name."""
    return {
        name: spec.capabilities() for name, spec in sorted(_REGISTRY.items())
    }


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


def _cumulative_rounds(spec: SolverSpec, hp: Mapping, iters) -> np.ndarray:
    """Cumulative dense-exchange rounds per node at each record point.

    One neighbor exchange an iteration unless ``spec.comm_rounds`` says
    otherwise (Mudag's inner gossip rounds, sliding's skipped rounds).
    """
    iters = np.asarray(iters)
    if spec.comm_rounds is None:
        return iters
    return np.rint(np.asarray(spec.comm_rounds(hp, iters))).astype(np.int64)


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

    method: a registered solver name (``available_solvers()`` lists them).
    comm: ``"dense"`` (the mixing product) or ``"sparse"`` (the paper's
        delta relay; methods with a sparse backend only).
    steps / record_every: iterations to run / metric recording period (the
        final iteration is always recorded).
    seed / indices: the per-node sample stream — drawn from ``seed``
        unless an explicit (>= steps, N) ``indices`` array is given (the
        JAX package draws the same stream from the same seed).
    z0: (N, D) numpy starting point, default zeros.
    comm_options: ``{"verify": bool}`` for ``comm="sparse"``.
    device: CUDA unless the caller passes ``"cpu"``; without a card and
        without ``device`` this raises.
    **hyperparams: overrides of the solver's ``defaults``.
    """
    spec = get_solver(method)
    if comm not in COMM_BACKENDS:
        raise ValueError(f"unknown comm backend {comm!r}; one of {COMM_BACKENDS}")
    _check_capability(
        spec, comm, problem.spec.kind, per_node_lam=np.ndim(problem.lam) > 0
    )
    if comm == "sharded":
        raise NotImplementedError(_NOT_PORTED["sharded"])
    if checkpoint is not None or resume is not None:
        raise NotImplementedError(_NOT_PORTED["checkpoint"])
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
    z_read = spec.z_of(problem, hp, tdata, comm_b)
    idx_t = torch.as_tensor(indices[:steps], dtype=torch.long, device=dev)
    prev = 0
    z_final = None
    for pt in pts:
        for t in range(prev, pt):
            state = step_fn(state, idx_t[t])
        prev = pt
        z_final = z_read(state).cpu().numpy()
        rec.push(pt, z_final)
    wall = time.perf_counter() - t0

    iters, dist2, cons, zs = rec.arrays()
    per_node = dense_doubles_per_iter(problem.graph, D)  # (N,)
    rounds = _cumulative_rounds(spec, hp, iters)
    doubles = rounds[:, None] * per_node[None, :]
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
        z_of=lambda problem, hp, data, comm: lambda state: state.z,
        defaults={"alpha": default_alpha},
        sparse_run=sparse_run,
        # the SAGA table stores scalars for any linear-predictor operator,
        # the bilinear saddle family included
        problem_families=FAMILIES,
        # the fixed point is W-independent and the state is all leading-N
        # tensors: schedules, churn and per-node lam are sound
        supports_schedule=True,
        supports_churn=True,
        supports_per_node_lam=True,
    )


register_solver(_make_dsba_family("dsba", default_alpha=0.5))
register_solver(_make_dsba_family("dsa", default_alpha=0.2))


# ---------------------------------------------------------------------------
# Registry entries: deterministic baselines (EXTRA / DLM / SSDA)
# ---------------------------------------------------------------------------


def _dense_setup(problem: Problem, data):
    """(feats (N, q, d), labels (N, q)) on the run's device, built once a run.

    The features come from the numpy ``SparseDataset.dense()`` the JAX
    package uses; ``data.derived`` keeps them for the run's other factories.
    """
    if "dense" not in data.derived:
        data.derived["dense"] = torch.as_tensor(
            problem.data.dense(), device=data.val.device
        )
    return data.derived["dense"], data.y


def _lam_of(problem: Problem, data):
    """``lam`` as a step takes it: a float, or per node an (N,) tensor."""
    if np.ndim(problem.lam) > 0:
        return torch.as_tensor(
            problem.lam, dtype=data.val.dtype, device=data.val.device
        )
    return float(problem.lam)


def _full_operator(spec: OperatorSpec, feats, labels):
    """G(Z, lam): (N, D) -> (N, D), the full local operator with ``lam Z``.

    ``lam`` is a call argument (``personal`` passes 0.0 and adds its
    per-node term itself). The contractions keep the JAX package's order.
    """
    t = spec.tail_dim
    d = feats.shape[-1]

    def G(Z, lam):
        head, tail = Z[:, :d], Z[:, d:]
        u = torch.einsum("nqd,nd->nq", feats, head)
        tails = tail[:, None, :].expand(*u.shape, t)
        g, tail_out = spec.coeff_and_tail(u, labels, tails)
        out_head = torch.einsum("nq,nqd->nd", g, feats) / feats.shape[1]
        out = torch.cat([out_head, tail_out.mean(1)], dim=1) if t else out_head
        return out + lam * Z

    return G


def _first_value(problem, hp, data, comm):
    """Read-out of every state whose first entry is the iterate block."""
    return lambda state: state[0]


def _extra_init(problem, hp, data, z0):
    """EXTRA state: (z, z_prev, g_prev, t), t a host int."""
    zeros = torch.zeros_like(z0)
    return (z0, zeros, zeros, 0)


def _extra_step(problem, hp, data, comm):
    """EXTRA (Shi et al. 2015a), eq. (47) form with first-step special case."""
    feats, labels = _dense_setup(problem, data)
    G = _full_operator(problem.spec, feats, labels)
    w_mix = comm.matvec(problem.w, feats.dtype)
    wt_mix = comm.matvec(w_tilde(problem.w), feats.dtype)
    alpha, lam = hp["alpha"], _lam_of(problem, data)

    def step(carry, i_t):
        z, z_prev, g_prev, t = carry
        g = G(z, lam)
        if t == 0:
            z1 = w_mix(z) - alpha * g
        else:
            z1 = z + w_mix(z) - wt_mix(z_prev) - alpha * (g - g_prev)
        return (z1, z, g, t + 1)

    return step


def _dlm_init(problem, hp, data, z0):
    """DLM state: (z, dual multipliers)."""
    return (z0, torch.zeros_like(z0))


def _dlm_step(problem, hp, data, comm):
    """DLM (Ling et al. 2015): linearized decentralized ADMM."""
    feats, labels = _dense_setup(problem, data)
    G = _full_operator(problem.spec, feats, labels)
    lap_mix = comm.matvec(problem.graph.laplacian, feats.dtype)
    deg = torch.as_tensor(
        problem.graph.degrees, dtype=feats.dtype, device=feats.device
    )[:, None]
    c, beta, lam = hp["c"], hp["beta"], _lam_of(problem, data)

    def step(carry, i_t):
        z, lam_dual = carry
        grad_aug = G(z, lam) + lam_dual + 2.0 * c * lap_mix(z)
        z1 = z - grad_aug / (2.0 * c * deg + beta)
        lam1 = lam_dual + c * lap_mix(z1)
        return (z1, lam1)

    return step


def _ssda_conj_grad(problem: Problem, data, inner_newton: int):
    """grad f*_n: (N, d) -> (N, d), built once a run and kept in ``data``.

    Ridge solves ``(A^T A / q + lam I) x = s + A^T y / q`` with a Cholesky
    factor per node. Logistic inverts grad f_n by ``inner_newton`` Newton
    steps from 0 with the closed-form Jacobian
    ``A^T diag(g'(u)) A / q + lam I`` (the JAX package's ``jacfwd`` of the
    same map). The step and the read-out share the factorization.
    """
    key = ("ssda", inner_newton)
    if key in data.derived:
        return data.derived[key]
    spec, lam = problem.spec, float(problem.lam)
    feats, labels = _dense_setup(problem, data)
    n, q, d = feats.shape
    eye = torch.eye(d, dtype=feats.dtype, device=feats.device)

    if spec.kind == "ridge":
        gram = torch.einsum("nqd,nqe->nde", feats, feats) / q
        chol = torch.linalg.cholesky(gram + lam * eye[None])
        rhs0 = torch.einsum("nqd,nq->nd", feats, labels) / q

        def conj_grad(S):
            return torch.cholesky_solve((S + rhs0)[..., None], chol)[..., 0]

    else:
        no_tail = feats.new_zeros((n, q, 0))

        def conj_grad(S):
            x = torch.zeros_like(S)
            for _ in range(inner_newton):
                u = torch.einsum("nqd,nd->nq", feats, x)
                g, _ = spec.coeff_and_tail(u, labels, no_tail)
                gn = torch.einsum("nqd,nq->nd", feats, g) / q + lam * x
                gp = logistic_coeff_prime(u, labels)
                jac = torch.einsum("nqd,nq,nqe->nde", feats, gp, feats) / q
                # solve_ex: no host sync on the card (the systems are
                # positive definite)
                x = x - torch.linalg.solve_ex(
                    jac + lam * eye, (gn - S)[..., None]
                )[0][..., 0]
            return x

    data.derived[key] = conj_grad
    return conj_grad


def _ssda_init(problem, hp, data, z0):
    """SSDA state: (momentum iterate, previous momentum iterate) on the dual."""
    zeros = data.val.new_zeros((problem.data.n_nodes, problem.data.d))
    return (zeros, zeros)


def _ssda_step(problem, hp, data, comm):
    """SSDA (Scaman et al. 2017): accelerated gradient ascent on the dual."""
    conj_grad = _ssda_conj_grad(problem, data, int(hp["inner_newton"]))
    n = problem.data.n_nodes
    imw_mix = comm.matvec(np.eye(n) - np.asarray(problem.w), data.val.dtype)
    eta, momentum = hp["eta"], hp["momentum"]

    def step(carry, i_t):
        m, m_prev = carry
        v = m + momentum * (m - m_prev)
        x = conj_grad(-v)  # primal: grad f*(-(U Lambda)_n)
        m1 = v + eta * imw_mix(x)
        return (m1, m)

    return step


def _ssda_z_of(problem, hp, data, comm):
    """Primal read-out grad f*(-m): a real computation, not a field access."""
    conj_grad = _ssda_conj_grad(problem, data, int(hp["inner_newton"]))
    return lambda state: conj_grad(-state[0])


register_solver(
    SolverSpec(
        name="extra",
        init=_extra_init,
        step=_extra_step,
        z_of=_first_value,
        defaults={"alpha": 0.3},
    )
)
register_solver(
    SolverSpec(
        name="dlm",
        init=_dlm_init,
        step=_dlm_step,
        z_of=_first_value,
        defaults={"c": 0.3, "beta": 1.0},
    )
)
register_solver(
    SolverSpec(
        name="ssda",
        init=_ssda_init,
        step=_ssda_step,
        z_of=_ssda_z_of,
        defaults={"eta": 0.05, "momentum": 0.5, "inner_newton": 8},
        # SSDA needs grad f*, which the saddle families do not have
        problem_families=MINIMIZATION_FAMILIES,
    )
)


# ---------------------------------------------------------------------------
# Registry entries: accelerated consensus (MUDAG) + communication sliding
# ---------------------------------------------------------------------------


def _fastmix_weight(w: np.ndarray) -> float:
    """The FastMix / Chebyshev momentum weight for mixing matrix ``w``.

    Liu & Morse (2011) accelerated gossip, as used by Mudag (Ye et al.
    2020):  x^{k+1} = (1 + eta_w) W x^k - eta_w x^{k-1}  with

        eta_w = (1 - sqrt(1 - sigma^2)) / (1 + sqrt(1 - sigma^2)),

    sigma the second-largest eigenvalue magnitude of W.
    """
    eigs = np.sort(np.abs(np.linalg.eigvalsh(np.asarray(w, dtype=np.float64))))
    sigma = float(eigs[-2]) if eigs.size > 1 else 0.0
    sigma = min(max(sigma, 0.0), 1.0 - 1e-12)
    root = float(np.sqrt(1.0 - sigma * sigma))
    return (1.0 - root) / (1.0 + root)


def _make_fastmix(comm, w, dt):
    """``fastmix(x, k)``: k rounds of accelerated gossip, each one
    ``comm.matvec`` application plus local arithmetic."""
    w_mix = comm.matvec(w, dt)
    eta_w = _fastmix_weight(w)

    def fastmix(x, k):
        cur, prev = x, x
        for _ in range(k):
            cur, prev = (1.0 + eta_w) * w_mix(cur) - eta_w * prev, cur
        return cur

    return fastmix


def _mudag_init(problem, hp, data, z0):
    """MUDAG state: (x, y, tracked s, previous gradient, t)."""
    zeros = torch.zeros_like(z0)
    return (z0, z0, zeros, zeros, 0)


def _mudag_step(problem, hp, data, comm):
    """Mudag (Ye et al. 2020): Nesterov descent + K-round FastMix gossip.

    Gradient tracking keeps mean(s) = mean(G(y)); each iteration spends 2K
    gossip rounds (one FastMix for the tracked gradient, one for the
    iterate). K is ``int(gossip_rounds)``, truncated as the JAX package's
    ``astype(int32)`` truncates, while ``_mudag_rounds`` ROUNDS it: the two
    differ for a non-integer ``gossip_rounds``, in both packages.
    """
    feats, labels = _dense_setup(problem, data)
    G = _full_operator(problem.spec, feats, labels)
    fastmix = _make_fastmix(comm, problem.w, feats.dtype)
    eta, beta = hp["eta"], hp["momentum"]
    lam = _lam_of(problem, data)
    k = int(hp["gossip_rounds"])

    def step(carry, i_t):
        x, y, s, g_prev, t = carry
        g = G(y, lam)
        s1 = fastmix(g if t == 0 else s + g - g_prev, k)
        x1 = fastmix(y - eta * s1, k)
        y1 = x1 + beta * (x1 - x)
        return (x1, y1, s1, g, t + 1)

    return step


def _sliding_init(problem, hp, data, z0):
    """Sliding state: (z, tracked s, previous gradient, t)."""
    zeros = torch.zeros_like(z0)
    return (z0, zeros, zeros, 0)


def _sliding_step(problem, hp, data, comm):
    """Communication sliding (Lan-Lee-Zhou 2017 style, tracking variant).

    The mixing products run only when ``t % comm_period == 0``; between
    rounds the nodes descend on their tracked gradient locally (the values
    are those of the JAX package's ``jnp.where`` select, which computes the
    products every step and drops them). The period is
    ``int(comm_period)``, truncated, while ``_sliding_rounds`` rounds it,
    as in the JAX package.
    """
    feats, labels = _dense_setup(problem, data)
    G = _full_operator(problem.spec, feats, labels)
    w_mix = comm.matvec(problem.w, feats.dtype)
    alpha, lam = hp["alpha"], _lam_of(problem, data)
    period = int(hp["comm_period"])
    if period < 1:
        raise ValueError(f"comm_period must be >= 1, got {hp['comm_period']!r}")

    def step(carry, i_t):
        z, s, g_prev, t = carry
        g = G(z, lam)
        s1 = g if t == 0 else s + g - g_prev
        if t % period == 0:
            z, s1 = w_mix(z), w_mix(s1)
        return (z - alpha * s1, s1, g, t + 1)

    return step


def _mudag_rounds(hp, iters):
    """2K dense-exchange rounds per iteration (s-mix and x-mix FastMix)."""
    return 2 * int(round(hp["gossip_rounds"])) * np.asarray(iters)


def _sliding_rounds(hp, iters):
    """2*ceil(iters/period): z and s exchanged on communication rounds only."""
    period = max(1, int(round(hp["comm_period"])))
    return 2 * np.ceil(np.asarray(iters) / period)


register_solver(
    SolverSpec(
        name="mudag",
        init=_mudag_init,
        step=_mudag_step,
        z_of=_first_value,
        defaults={"eta": 1.0, "momentum": 0.9, "gossip_rounds": 4},
        # Nesterov descent needs a convex minimization objective
        problem_families=MINIMIZATION_FAMILIES,
        comm_rounds=_mudag_rounds,
        supports_schedule=True,
        supports_churn=True,
        # FastMix applies the matvec a data-dependent number of times
        supports_stragglers=False,
    )
)
register_solver(
    SolverSpec(
        name="sliding",
        init=_sliding_init,
        step=_sliding_step,
        z_of=_first_value,
        defaults={"alpha": 0.1, "comm_period": 4},
        problem_families=MINIMIZATION_FAMILIES,
        comm_rounds=_sliding_rounds,
        supports_schedule=True,
        supports_churn=True,
        # off-round iterations exchange nothing to delay
        supports_stragglers=False,
    )
)


# ---------------------------------------------------------------------------
# Registry entry: DSGDA — decentralized stochastic gradient descent ascent
# ---------------------------------------------------------------------------


def _dsgda_init(problem, hp, data, z0):
    """DSGDA state: (z, SAGA tables, table mean, tracker, v_prev, t).

    The same warm start as Algorithm 1 line 1: the scalar tables hold the
    coefficient form of every component operator at z0 (from the dense
    features), phibar their assembled mean. The tracker and the previous
    estimate start at zero; the step's t == 0 branch seeds the tracker.
    The entry order is the JAX package's.
    """
    spec = problem.spec
    feats, labels = _dense_setup(problem, data)
    t = spec.tail_dim
    d = feats.shape[-1]
    head, tail = z0[:, :d], z0[:, d:]
    u = torch.einsum("nqd,nd->nq", feats, head)
    tails = tail[:, None, :].expand(*u.shape, t)
    g, tail_out = spec.coeff_and_tail(u, labels, tails)  # (N,q), (N,q,t)
    phibar_head = torch.einsum("nq,nqd->nd", g, feats) / feats.shape[1]
    phibar = torch.cat([phibar_head, tail_out.mean(1)], dim=1)
    zeros = torch.zeros_like(z0)
    return (z0, g, tail_out, phibar, zeros, zeros, 0)


def _dsgda_step(problem, hp, data, comm):
    """SAGA-variance-reduced decentralized SGDA with gradient tracking.

    One sampled component per node per iteration; the estimator
    v = (g_i - table_i) x_i (+) tail delta + phibar + lam z. Descent on the
    primal block (step ``alpha``) and ascent on the dual block (step
    ``eta``) happen in one update because the tail carries -dL/dtheta.
    """
    spec = problem.spec
    feats, labels = _dense_setup(problem, data)
    t = spec.tail_dim
    n, q, d = feats.shape
    w_mix = comm.matvec(problem.w, feats.dtype)
    alpha, eta, lam = hp["alpha"], hp["eta"], _lam_of(problem, data)
    head_mask = torch.cat([feats.new_ones((d,)), feats.new_zeros((t,))])
    scale = (alpha * head_mask + eta * (1.0 - head_mask))[None, :]
    node = torch.arange(n, device=feats.device)

    def step(carry, i_t):
        z, tab_g, tab_tail, phibar, y, v_prev, step_t = carry
        rows = feats[node, i_t]  # (N, d)
        ys = labels[node, i_t]
        head, tail = z[:, :d], z[:, d:]
        u = torch.sum(rows * head, dim=-1)
        g, tail_out = spec.coeff_and_tail(u, ys, tail)  # (N,), (N, t)
        dg = g - tab_g[node, i_t]
        dtail = tail_out - tab_tail[node, i_t]
        delta = torch.cat([dg[:, None] * rows, dtail], dim=1)
        v = delta + phibar + lam * z
        y1 = v if step_t == 0 else w_mix(y) + v - v_prev
        z1 = w_mix(z) - scale * y1
        return (
            z1,
            tab_g.index_put((node, i_t), g),
            tab_tail.index_put((node, i_t), tail_out),
            phibar + delta / q,
            y1,
            v,
            step_t + 1,
        )

    return step


register_solver(
    SolverSpec(
        name="dsgda",
        init=_dsgda_init,
        step=_dsgda_step,
        z_of=_first_value,
        defaults={"alpha": 0.3, "eta": 0.3},
        # descent-ascent targets the saddle families
        problem_families=("auc", "bilinear"),
        supports_schedule=True,
        supports_churn=True,
    )
)


# ---------------------------------------------------------------------------
# Registry entry: personalized consensus-regularized descent
# ---------------------------------------------------------------------------


def _personal_init(problem, hp, data, z0):
    """Personalized-descent state: just the iterate block."""
    return (z0,)


def _personal_step(problem, hp, data, comm):
    """Consensus-regularized personalization (per-node lam, mu-coupling).

    The fixed point solves G_n(z_n) + lam_n z_n + mu (L Z)_n = 0 for every
    node n (mu -> inf recovers consensus, mu = 0 fully local models);
    plain forward descent on this monotone map. ``lam`` may be (N,).
    """
    feats, labels = _dense_setup(problem, data)
    G = _full_operator(problem.spec, feats, labels)
    lap_mix = comm.matvec(problem.graph.laplacian, feats.dtype)
    alpha, mu = hp["alpha"], hp["mu"]
    lam = _lam_of(problem, data)
    lam_col = lam[:, None] if torch.is_tensor(lam) else lam

    def step(carry, i_t):
        (z,) = carry
        g = G(z, 0.0) + lam_col * z
        return (z - alpha * (g + mu * lap_mix(z)),)

    return step


def personalized_root(
    problem: Problem, mu: float = 1.0, iters: int = 100, tol: float = 1e-12,
    device=None,
) -> np.ndarray:
    """(N, D) root of the consensus-regularized personalization system.

    Damped Newton on the stacked map F(Z) = G(Z) + lam .* Z + mu L Z with
    its N·D x N·D Jacobian (``torch.func.jacfwd``): small problems only.
    Use the SAME ``mu`` as the ``personal`` run being measured. Runs on
    ``device`` (CUDA unless the caller passes ``"cpu"``).
    """
    dev = resolve_device(device)
    n, D = problem.graph.n, problem.dim
    feats = torch.as_tensor(problem.data.dense(), device=dev)
    labels = torch.as_tensor(problem.data.y, device=dev)
    dt = feats.dtype
    G = _full_operator(problem.spec, feats, labels)
    lap = torch.as_tensor(problem.graph.laplacian, dtype=dt, device=dev)
    lam = problem.lam
    lam_col = (
        torch.as_tensor(np.asarray(lam)[:, None], dtype=dt, device=dev)
        if np.ndim(lam) > 0 else float(lam)
    )

    def F(zf):
        Z = zf.reshape(n, D)
        out = G(Z, 0.0) + lam_col * Z + mu * (lap @ Z)
        return out.reshape(-1)

    jac_f = torch.func.jacfwd(F)
    z = torch.zeros((n * D,), dtype=dt, device=dev)
    eye = torch.eye(n * D, dtype=dt, device=dev)
    for _ in range(iters):
        f = F(z)
        nf = float(torch.linalg.norm(f))
        if nf < tol:
            break
        delta = torch.linalg.solve(jac_f(z) + 1e-12 * eye, f)
        t = 1.0
        z_try = z - delta
        for _ in range(30):  # backtracking damping
            z_try = z - t * delta
            if float(torch.linalg.norm(F(z_try))) <= (1.0 - 0.25 * t) * nf:
                break
            t *= 0.5
        z = z_try
    return z.cpu().numpy().reshape(n, D)


register_solver(
    SolverSpec(
        name="personal",
        init=_personal_init,
        step=_personal_step,
        z_of=_first_value,
        defaults={"alpha": 0.2, "mu": 1.0},
        # forward descent needs a monotone minimization operator
        problem_families=MINIMIZATION_FAMILIES,
        # an (N,) lam under a node-sharded step would reach every device
        # whole (the reference's reason; dense only)
        supports_sharded=False,
        supports_schedule=True,
        supports_per_node_lam=True,
    )
)
