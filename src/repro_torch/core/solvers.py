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

PyTorch runs eagerly: ``solve`` loops over the iterations in Python on the
chosen device (CUDA unless the caller passes ``device="cpu"``). A solver's
step counter is a host integer in its state, so the ``t == 0`` and
communication-round branches are host branches and no step waits on the
device. What a call would redo every time (the dataset on the device, the
dense features, SSDA's factorization, the relay's tables, the bound step
and read-out) lives in a keyed runner cache (``core.runner_cache``;
``runner_cache_stats()``, ``clear_runner_caches()``): hyperparameter
VALUES are call arguments (``SolverSpec``), so a sweep over them reuses
one runner. ``solve_many`` runs a whole grid (and/or seed list) as ONE
batched computation: every state tensor gains a leading B axis, the
hyperparameters become (B,) tensors, and each step launches what one run's
step launches (the DSBA/DSA sparse kernels take the B*N rows at once).

Dynamic networks and faults run through the same ``solve()``, as in the
JAX package: a ``Problem.schedule`` of (start, Graph-or-W) segments
(time-varying W), and ``comm_options={"fault_plan": FaultPlan(...)}``
composing node churn (kill/join, with each method's ``reanchor`` rule),
link faults and stragglers (``core.comm.FaultyDenseComm``; on the relay a
link fault suppresses a broadcast). A run splits into static phases; the
state carries across them as-is for a W switch and through
``ft.elastic.ElasticGossip`` for churn. A plan whose masks are all True
routes through the plain step, so p = 0 is bit-equal to a plan-free run.
``solve(checkpoint=CheckpointSpec(...))`` snapshots the state and the
recorder, and ``solve(resume=directory)`` continues bit-equal to an
uninterrupted run (dense and sparse), in the JAX package's checkpoint
layout.

``comm="sharded"`` runs each graph node as its own rank of a
``launch.mesh.NodeMesh`` (worker processes in one ``torch.distributed``
gloo group, on the card or on the CPU): the same step factories bind a
``ShardedComm``, whose ``mix`` is one neighbour exchange a edge colour and
whose ``local`` is the rank's row, so each rank steps its own node. The
parent hands each rank the problem, its column of the sample stream and
(for link faults) its rows of the delivery mask, gathers the (N, D)
iterates at the record points into the same recorder, and reports the
collective traffic by the reference's counting rule
(``extras["collectives"]``, ``measured_collective_bytes``). Schedules
and churn re-mesh per phase (meshes of other sizes come from the mesh
registry); a ``solve_many`` sweep runs its entries one after another.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from collections import OrderedDict
from typing import Any, Callable, Mapping

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import (  # noqa: F401  (re-exported)
    CheckpointManager,
    CheckpointSpec,
    load_checkpoint,
    restore_checkpoint,
)
from repro_torch.convert import dataset_to_torch
from repro_torch.core import reference, runner_cache
from repro_torch.core.comm import (
    PERMUTE, DenseComm, FaultyDenseComm, FaultyShardedComm, ShardedComm,
)
from repro_torch.core.dsba import DSBAConfig, draw_indices, init_state, make_hp_step_fn
from repro_torch.core.mixing import Graph, laplacian_mixing, spectral_gap, w_tilde
from repro_torch.core.operators import (
    FAMILIES, MINIMIZATION_FAMILIES, OperatorSpec, logistic_coeff_prime,
)
from repro_torch.core.sparse_comm import (
    batch_tree, dense_doubles_per_iter, run_sparse, run_sparse_many,
)
from repro_torch.device import resolve_device
from repro_torch.ft.faults import (  # noqa: F401  (re-exported)
    ChurnEvent,
    ChurnPlan,
    FaultPlan,
    LinkFault,
    StragglerSpec,
    as_fault_plan,
    delivered_in_messages,
    fault_message_totals,
    link_delivered_mask,
    source_sent_mask,
    straggler_delivered_mask,
)

COMM_BACKENDS = ("dense", "sparse", "sharded")
# SSDA ridge: above this many bytes of d x d factors (all nodes) a node's
# grad f* goes through its q x q Woodbury factor (``_ssda_conj_grad``)
SSDA_DENSE_BYTES = 8 << 30
#: per-backend comm_options schema enforced by ``_validate_options``
_COMM_OPTION_KEYS = {
    "dense": ("fault_plan",),
    "sparse": ("verify", "engine", "fault_plan"),
    "sharded": ("mesh", "fault_plan"),
}


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

    ``schedule`` makes the network time-varying: a sequence of
    ``(start_iter, Graph-or-W)`` segments, normalized to ``(start, Graph,
    W)``. ``solve()`` runs each segment on its own W, carrying the solver
    state across boundaries, and records each segment's spectral gap in
    ``SolveResult.extras["schedule"]``. A segment given as a ``Graph``
    gets the paper's Laplacian mixing; one given as a W matrix recovers
    its graph from the support. If no segment starts at 0, the problem's
    own (graph, w) opens the schedule.
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
        if self.schedule is not None:
            self.schedule = _normalize_schedule(
                self.schedule, self.graph, self.w, self.data.n_nodes
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


def _normalize_schedule(schedule, graph0: Graph, w0, n: int):
    """Normalize ``(start, Graph-or-W)`` entries to ``(start, Graph, W)``.

    Starts must be unique non-negative ints; segments are sorted and, when
    none starts at 0, the problem's own (graph, w) opens the schedule.
    """
    segs = []
    for start, g in schedule:
        start = int(start)
        if start < 0:
            raise ValueError(f"schedule segment start {start} < 0")
        if isinstance(g, Graph):
            seg_graph, seg_w = g, laplacian_mixing(g)
        else:
            seg_w = np.asarray(g)
            if seg_w.shape != (n, n):
                raise ValueError(
                    f"schedule segment W {seg_w.shape} != ({n}, {n})"
                )
            seg_graph = graph_from_mixing(seg_w)
        if seg_graph.n != n:
            raise ValueError(
                f"schedule segment graph has {seg_graph.n} nodes, "
                f"problem has {n}"
            )
        segs.append((start, seg_graph, seg_w))
    segs.sort(key=lambda s: s[0])
    starts = [s[0] for s in segs]
    if len(set(starts)) != len(starts):
        raise ValueError(f"duplicate schedule segment starts {starts}")
    if not segs or segs[0][0] != 0:
        segs.insert(0, (0, graph0, np.asarray(w0)))
    return tuple(segs)


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

    ``init``/``step``/``z_of`` are *factories* over ``(problem, hp, data,
    comm)``, run once per cached runner (``data`` is the runner's
    ``convert.TensorDataset``). Hyperparameter VALUES are not baked: at
    factory time ``hp`` is a ``_FactoryHP`` that resolves the static names
    only, and the functions a factory returns receive the run's
    hyperparameters as a final ``hp_run`` argument, so a sweep over values
    reuses one runner:

    - ``init(problem, hp, data, z0) -> state``: initial state on z0's
      device.
    - ``step(problem, hp, data, comm) -> fn(state, i_t, hp_run) -> state``:
      one iteration; ``i_t`` is the (N,) sample draw (deterministic methods
      ignore it); all neighbor exchange goes through ``comm.matvec``.
      ``hp_run`` carries every non-static hyperparameter plus ``"lam"``
      (unless ``bake_lam``), as tensors in the data dtype on the run's
      device: 0-d for one run, (B,) for a ``solve_many`` batch, whose state
      tensors carry a leading B axis (``lam`` is shared: 0-d, or (N,) per
      node). Names in ``host_hp`` arrive as host numbers instead (one, or
      a tuple of B).
    - ``z_of(problem, hp, data, comm) -> fn(state, hp_run) -> (N, D)``: the
      iterate read-out (SSDA's is a real computation, hence a factory);
      (B, N, D) for a batch.
    - ``defaults``: hyperparameters with default values (also the schema:
      ``solve()`` rejects unknown overrides).
    - ``static_hp``: names of structural hyperparameters (loop counts)
      baked at factory time; they join the runner cache key, and a
      ``solve_many`` grid varying one runs sequentially.
    - ``bake_lam``: bake ``problem.lam`` at factory time (SSDA's
      factorization is built around it); lam then joins the key.
    - ``host_hp``: names whose values decide host control flow (Mudag's
      ``gossip_rounds``, sliding's ``comm_period``): passed as host
      numbers, not tensors.
    - ``sparse_run``: optional ``(problem, hp, steps, indices, z0, options,
      device) -> SparseRunResult`` (the relay); ``None`` = no sparse
      protocol.
    - ``sparse_run_many``: optional ``(problem, merged, steps, idx_b, z0,
      options, device) -> list[SparseRunResult] | None`` (``merged``: one
      resolved hp dict a run; ``idx_b``: (B, >= steps, N) streams); ``None``
      declines the batch (``engine="reference"``) and ``solve_many`` runs
      the entries sequentially.
    - ``problem_families``: operator families the method supports.
    - ``supports_sharded``: the step is safe under the sharded backend.
    - ``comm_rounds``: optional ``(hp, cumulative iterations) ->
      cumulative dense-exchange rounds`` per node; ``None`` is one round
      an iteration (Mudag spends 2K, sliding 2 every ``comm_period``).
    - ``supports_schedule`` / ``supports_churn`` / ``supports_link_faults``
      / ``supports_stragglers``: the reference's dynamic-network and
      fault capabilities, enforced by ``_check_capability``.
    - ``reanchor``: optional ``(state) -> state`` applied after a churn
      remap. Difference-form methods (DSBA/DSA) and the trackers (Mudag,
      sliding, DSGDA) re-run their t = 0 anchor on the new membership, or
      the run converges to the old system's root. A W-only switch does
      not reanchor.
    - ``supports_per_node_lam``: the step takes ``lam`` as an (N,) array
      (personalized regularization), dense backend only.
    """

    name: str
    init: Callable
    step: Callable
    z_of: Callable
    defaults: Mapping[str, float]
    sparse_run: Callable | None = None
    sparse_run_many: Callable | None = None
    static_hp: tuple[str, ...] = ()
    bake_lam: bool = False
    host_hp: tuple[str, ...] = ()
    problem_families: tuple[str, ...] = ("ridge", "logistic", "auc")
    supports_sharded: bool = True
    comm_rounds: Callable | None = None
    supports_schedule: bool = False
    supports_churn: bool = False
    supports_per_node_lam: bool = False
    reanchor: Callable | None = None
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
# Runner cache: one bound runner per (method, problem shape, device); the
# hyperparameter values are call arguments, so a sweep builds once.
# ---------------------------------------------------------------------------


class TracedHPError(KeyError):
    """A factory read a per-run hyperparameter at build time."""

    def __str__(self):
        """The message verbatim (KeyError would repr-quote it)."""
        return self.args[0]


class _FactoryHP(Mapping):
    """Factory-time view of the hyperparameters: the *static* names only.

    Static names resolve to their values (they are part of the cache key);
    as a Mapping this contains nothing else, so ``in`` / ``.get`` /
    iteration answer honestly. Subscripting a per-run name raises
    ``TracedHPError`` (a KeyError) with a pointer to the ``hp_run``
    argument: a factory can never bake a value that later sweep calls
    would then reuse stale. (The error's wording is the JAX package's.)
    """

    def __init__(self, values: Mapping[str, float], static: tuple[str, ...]):
        self._values = dict(values)
        self._static = frozenset(static) & set(self._values)

    def __getitem__(self, name: str):
        if name in self._static:
            return self._values[name]
        if name in self._values:
            raise TracedHPError(
                f"hyperparameter {name!r} is runtime-traced; read it from "
                "the hp argument inside the step/z_of function, or declare "
                "it in SolverSpec.static_hp"
            )
        raise KeyError(name)

    def __iter__(self):
        return iter(k for k in self._values if k in self._static)

    def __len__(self):
        return len(self._static)


def _dynamic_hp(spec: SolverSpec, problem: Problem, hp: Mapping, dt, dev,
                merged: list[Mapping] | None = None) -> dict:
    """The per-run hp dict: non-static names + lam (unless baked).

    Each value is a tensor in the data dtype ``dt`` on ``dev`` (0-d; with
    ``merged``, one value a batch entry, shape (B,)), so one run and a
    batch share one arithmetic; ``host_hp`` names stay host floats (a
    tuple with ``merged``).
    """
    dyn = {}
    for k in hp:
        if k in spec.static_hp:
            continue
        vals = [float(hp[k])] if merged is None else [float(m[k]) for m in merged]
        if k in spec.host_hp:
            dyn[k] = vals[0] if merged is None else tuple(vals)
        else:
            dyn[k] = torch.tensor(vals[0] if merged is None else vals, dtype=dt, device=dev)
    if not spec.bake_lam:  # 0-d, or (N,) per node
        dyn["lam"] = torch.as_tensor(np.asarray(problem.lam, dtype=np.float64), dtype=dt,
                                     device=dev)
    return dyn


def _runner_key(spec: SolverSpec, problem: Problem, hp: Mapping, dev):
    """(key, guards) for one (method, problem shape, static-hp structure,
    device).

    The dataset enters by identity (guarded by a strong reference in the
    entry); the mixing matrix by content fingerprint, so problems rebuilt
    per sweep point (same data/graph, fresh equal W, different lam) share
    one runner. Hyperparameter *values* never enter the key; only the
    static structure does.
    """
    key = (
        spec.name,
        runner_cache.problem_fingerprint(
            problem.data, problem.spec, problem.graph, problem.w, dev
        ),
        tuple((k, float(hp[k])) for k in spec.static_hp),
        float(problem.lam) if spec.bake_lam else None,
    )
    return key, (problem.data,)


@dataclasses.dataclass
class _DenseRunner:
    """One bound dense-backend runner: the device data and the closures."""

    init: Callable  # (z0) -> state
    step: Callable  # (state, i_t, hp_run) -> state
    z_read: Callable  # (state, hp_run) -> (N, D)
    comm: DenseComm
    data: Any  # convert.TensorDataset


def _build_dense_runner(spec, problem, hp, dev, comm,
                        note=runner_cache.DENSE.note_trace) -> _DenseRunner:
    """Bind ``spec``'s factories on ``problem``'s data on ``dev`` (a rank of
    the sharded backend binds them too, with its ``ShardedComm``);
    ``note`` counts the two binds in the caller's cache stats."""
    note()  # build-time only: the step's binding
    data = dataset_to_torch(problem.data, dev)
    fhp = _FactoryHP(hp, spec.static_hp)
    step_fn = spec.step(problem, fhp, data, comm)
    note()  # and the read-out's
    z_fn = spec.z_of(problem, fhp, data, comm)
    return _DenseRunner(
        init=lambda z0: spec.init(problem, fhp, data, z0),
        step=step_fn, z_read=z_fn, comm=comm, data=data,
    )


def _get_dense_runner(spec: SolverSpec, problem: Problem, hp: Mapping, dev):
    """Fetch (or build) the dense runner for this (spec, problem, hp, dev)."""
    key, guards = _runner_key(spec, problem, hp, dev)
    return runner_cache.DENSE.get_or_build(
        key, guards,
        lambda: _build_dense_runner(spec, problem, hp, dev, DenseComm(problem.graph, dev)),
    )


def _get_dense_fault_runner(spec: SolverSpec, problem: Problem, hp: Mapping, dev,
                            *, has_link: bool, has_straggler: bool):
    """Fetch (or build) the fault-injecting dense runner: its comm is a
    ``FaultyDenseComm`` to which each run binds its own masks."""
    base_key, guards = _runner_key(spec, problem, hp, dev)
    key = base_key + (runner_cache.fault_fingerprint(has_link, has_straggler),)
    return runner_cache.DENSE.get_or_build(
        key, guards,
        lambda: _build_dense_runner(spec, problem, hp, dev, FaultyDenseComm(problem.graph, dev)),
    )


def _phase_runner(spec, problem, hp, dev, link_mask, strag_mask) -> _DenseRunner:
    """The runner for one static stretch of a run: the plain one when no
    mask has a False entry, else the fault runner with the masks bound."""
    if link_mask is None and strag_mask is None:
        return _get_dense_runner(spec, problem, hp, dev)
    runner = _get_dense_fault_runner(
        spec, problem, hp, dev,
        has_link=link_mask is not None, has_straggler=strag_mask is not None,
    )

    def up(m):
        return None if m is None else torch.as_tensor(m, device=dev)

    runner.comm.bind(up(link_mask), up(strag_mask))
    return runner


# ---------------------------------------------------------------------------
# The sharded backend: one rank a graph node (launch.mesh.NodeMesh)
# ---------------------------------------------------------------------------


def _node_partition(state, n: int, rank: int):
    """A rank's part of a solver state: the counterpart of the reference's
    ``_node_partition_specs``.

    Every registered solver keeps its per-node state with a leading N
    axis: such a leaf goes to the ranks by row (rank r keeps row r as a
    (1, ...) tensor). Scalars (0-d step counters, host ints) are
    replicated. A leaf that is neither is ambiguous and raises rather than
    being copied whole to every rank.
    """

    def part(leaf):
        shape = getattr(leaf, "shape", None)
        if shape is None or len(shape) == 0:
            return leaf
        if shape[0] == n:
            return leaf[rank:rank + 1].clone()
        raise ValueError(
            f"state leaf with shape {tuple(shape)} has no leading node axis "
            f"(N = {n}) and is not a scalar; the sharded backend cannot "
            "place it (see docs/solvers.md)"
        )

    from repro_torch.ft.elastic import _map_leaves  # see _elastic_remap

    return _map_leaves(part, state)


def _join_parts(parts: list):
    """The (N, ...) state from the ranks' numpy parts, in rank order: row
    leaves concatenate, replicated scalars come from rank 0."""
    t = parts[0]
    if isinstance(t, dict):
        return {k: _join_parts([p[k] for p in parts]) for k in t}
    if dataclasses.is_dataclass(t) and not isinstance(t, type):
        return dataclasses.replace(t, **{
            f.name: _join_parts([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(t) if f.init
        })
    if isinstance(t, (tuple, list)):
        return type(t)(_join_parts([p[i] for p in parts]) for i in range(len(t)))
    if isinstance(t, np.ndarray) and t.ndim >= 1:
        return np.concatenate(parts, axis=0)
    return t


def _state_to_numpy(state):
    """Tensors to host numpy arrays (host ints stay), to cross processes."""
    from repro_torch.ft.elastic import _map_leaves  # see _elastic_remap

    return _map_leaves(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, state)


def _state_to_torch(state, dev):
    """``_state_to_numpy``'s inverse on ``dev``."""
    from repro_torch.ft.elastic import _map_leaves  # see _elastic_remap

    return _map_leaves(
        lambda x: torch.as_tensor(x, device=dev) if isinstance(x, np.ndarray) else x, state)


_TOKENS = iter(range(1, 1 << 62))


def _get_sharded_runner(spec: SolverSpec, problem: Problem, hp: Mapping, mesh,
                        faulty: bool = False) -> int:
    """Fetch (or make) the sharded runner for (spec, problem, hp, mesh):
    the parent keeps only its token, under which every rank keeps its
    bound step (built from the job's problem at first use). ``faulty``
    selects the link-fault runner (its own key)."""
    base_key, guards = _runner_key(spec, problem, hp, mesh.device)
    key = base_key + (runner_cache.mesh_fingerprint(mesh),)
    if faulty:
        key += (runner_cache.fault_fingerprint(True, False),)

    def build() -> int:
        ShardedComm(problem.graph, mesh)  # the mesh-size check
        runner_cache.SHARDED.note_trace()  # the ranks' step binding
        runner_cache.SHARDED.note_trace()  # and read-out
        return next(_TOKENS)

    return runner_cache.SHARDED.get_or_build(key, (*guards, mesh), build)


# a rank's bound runners, by the parent's token (only ever filled in a rank)
_RANK_RUNNERS: "OrderedDict[int, _DenseRunner]" = OrderedDict()


def _rank_runner(me, job) -> _DenseRunner:
    """The bound step of ``job``'s runner on this rank (built at first use)."""
    token = job["token"]
    runner = _RANK_RUNNERS.get(token)
    if runner is None:
        problem = job["problem"]
        comm_cls = FaultyShardedComm if job["link"] is not None else ShardedComm
        runner = _build_dense_runner(
            get_solver(job["method"]), problem, job["hp"], me.device,
            comm_cls(problem.graph, me), note=lambda: None,
        )
        _RANK_RUNNERS[token] = runner
        while len(_RANK_RUNNERS) > runner_cache.SHARDED.capacity:
            _RANK_RUNNERS.popitem(last=False)
    _RANK_RUNNERS.move_to_end(token)
    return runner


def _rank_job(me, job) -> dict:
    """One static phase on one rank (runs in a ``NodeMesh`` worker).

    Starts from ``job["state"]`` (the whole (N, ...) state, as numpy) or
    from the method's init at ``job["z0"]`` (computed for all N nodes, so
    the rank's rows are the dense init's bits), keeps this rank's rows and
    steps them ``len(job["idx"])`` times on its column of the sample
    stream. Returns its iterate row and the counted collective bytes at
    each mark, its final state part, and what the run cost it.
    """
    from repro_torch.kernels import sparse_saga

    spec = get_solver(job["method"])
    problem = job["problem"]
    dev = me.device
    runner = _rank_runner(me, job)
    comm = runner.comm
    comm.reset_counters()
    if job["link"] is not None:
        comm.bind(job["link"])
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    launches0 = (sparse_saga.sparse_dot.launches, sparse_saga.sparse_axpy.launches)
    if job["state"] is None:
        full = runner.init(torch.as_tensor(job["z0"], device=dev))
    else:
        full = _state_to_torch(job["state"], dev)
    state = _node_partition(full, problem.graph.n, me.rank)
    del full
    hp_run = _dynamic_hp(spec, problem, job["hp"], runner.data.val.dtype, dev)
    idx_t = torch.as_tensor(np.asarray(job["idx"])[:, None], dtype=torch.long, device=dev)
    zs, counted = [], []
    t0 = time.perf_counter()
    prev = 0
    for mk in job["marks"]:
        state = _advance(state, runner.step, comm, idx_t, prev, mk, hp_run)
        prev = mk
        zs.append(runner.z_read(state, hp_run).cpu().numpy())
        counted.append(comm.bytes)
    loop_s = time.perf_counter() - t0
    return {
        "z": zs,
        "bytes": counted,
        "count": comm.count,
        "state": _state_to_numpy(state),
        "loop_s": loop_s,
        "exchange_s": comm.exchange_s,
        "staging_s": comm.staging_s,
        "sent_bytes": comm.sent_bytes,
        "launches": {
            "sparse_dot": sparse_saga.sparse_dot.launches - launches0[0],
            "sparse_axpy": sparse_saga.sparse_axpy.launches - launches0[1],
        },
        "peak_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    }


@dataclasses.dataclass
class _ShardedPhase:
    """What one static phase on a mesh returned to the parent."""

    zs: list  # (N, D) iterates at each mark
    counted: list  # cumulative counted collective bytes a device at each mark
    costs: dict  # the reference's per-iteration collectives record
    state: Any  # the (N, ...) final state on the parent's device
    ranks: list  # per rank: loop_s, exchange_s, staging_s, sent_bytes, launches, peak_bytes


def _run_sharded(spec, problem, hp, mesh, dev, idx, marks, link_mask, state0, z0
                 ) -> _ShardedPhase:
    """Run one static phase of ``len(idx)`` steps on ``mesh``.

    ``idx`` is the phase's (steps, N) sample stream (rank r gets column r),
    ``marks`` the phase-local step counts to gather the iterates at (the
    last is the phase's end), ``link_mask`` the phase's (steps, N, N)
    delivery mask or None (rank r gets its rows), ``state0`` the carried
    state on the parent (None: the method's init at ``z0``).
    """
    seg = len(idx)
    token = _get_sharded_runner(spec, problem, hp, mesh, faulty=link_mask is not None)
    # a clean problem: no cached root, schedule or churn children to ship
    clean = Problem(spec=problem.spec, data=problem.data, graph=problem.graph,
                    w=problem.w, lam=problem.lam)
    common = {
        "token": token, "method": spec.name, "problem": clean, "hp": dict(hp),
        "marks": list(marks),
        "state": None if state0 is None else _state_to_numpy(state0),
        "z0": None if state0 is not None else np.asarray(z0),
    }
    jobs = [
        dict(common, idx=np.ascontiguousarray(idx[:, r]),
             link=None if link_mask is None else np.ascontiguousarray(link_mask[:, r, :]))
        for r in range(mesh.n)
    ]
    res = mesh.run(_rank_job, jobs)
    total, count = res[0]["bytes"][-1], res[0]["count"]
    bytes_per_iter, count_per_iter = total / seg, count / seg
    costs = {
        "bytes_per_iter": bytes_per_iter,
        "count_per_iter": count_per_iter,
        "bytes_by_op": {PERMUTE: bytes_per_iter} if count else {},
        "count_by_op": {PERMUTE: count_per_iter} if count else {},
    }
    return _ShardedPhase(
        zs=[np.concatenate([r["z"][k] for r in res], axis=0) for k in range(len(marks))],
        counted=list(res[0]["bytes"]),
        costs=costs,
        state=_state_to_torch(_join_parts([r["state"] for r in res]), dev),
        ranks=[{k: r[k] for k in ("loop_s", "exchange_s", "staging_s", "sent_bytes",
                                  "launches", "peak_bytes")} for r in res],
    )


def _sharded_device(device, mesh) -> torch.device:
    """The parent's device of a sharded run: the mesh's, unless the caller
    names another (an error), or the card/``device`` with no mesh given."""
    if mesh is None:
        return resolve_device(device)
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(
            f"comm_options mesh runs on {mesh.device.type}, but device={device!r}"
        )
    return mesh.device


def _phase_mesh(mesh_opt, n: int, dev):
    """The given mesh when its size is the phase's N, else the registry's."""
    if mesh_opt is not None and mesh_opt.n == n:
        return mesh_opt
    from repro_torch.launch.mesh import make_node_mesh

    return make_node_mesh(n, dev)


def runner_cache_stats() -> dict[str, dict[str, int]]:
    """{cache name: {hits, misses, traces, evictions, size}} per runner cache."""
    return runner_cache.stats()


def clear_runner_caches() -> None:
    """Drop every cached runner (and the device tensors it holds) and zero
    the stats."""
    runner_cache.clear()


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
    the sparse backend's ``z_trace`` and ``recon_max_err``, a dynamic
    run's per-phase ``schedule`` (and ``churn_rows``, the accounting rows
    when membership changed), a fault plan's ``faults`` record and the
    sharded backend's ``collectives``, ``mesh_devices`` and ``ranks`` (each
    rank's loop, exchange and host-staging times, sent bytes, kernel
    launches and peak device memory).

    ``measured_collective_bytes`` is set by ``comm="sharded"`` only: the
    cumulative collective bytes a device at each record point, counted
    where each exchange is made by the reference's rule (one exchange a
    colour charges its block's bytes on every rank).
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
    measured_collective_bytes: np.ndarray | None = None  # (R,) a device


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

    def push(self, it: int, z, z_star=None) -> None:
        """Record consensus / distance-to-z* of iterates at step ``it``.

        ``z`` is (N, D), or (B, N, D) for a ``solve_many`` batch: the metrics
        reduce over the trailing (N, D) axes either way.

        ``z_star`` overrides the recorder's root for this push: churn
        phases measure dist2 against the current membership's own root
        (only when the recorder has a root at all, so ``dist2`` stays
        rectangular).
        """
        z = np.asarray(z)
        zbar = z.mean(-2, keepdims=True)
        self.iters.append(it)
        self.consensus.append(np.mean(np.sum((z - zbar) ** 2, -1), -1))
        if self.z_star is not None:
            ref = self.z_star if z_star is None else np.asarray(z_star)
            self.dist2.append(np.mean(np.sum((z - ref) ** 2, -1), -1))
        if self.zs is not None:
            self.zs.append(z)

    def arrays(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, Any]:
        """(iters, dist2, consensus, zs) as numpy arrays.

        Pushes of (N, D) iterates give (R,) metrics and (R, N, D)
        snapshots; pushes of a (B, N, D) batch give (B, R) metrics and
        (B, R, N, D) snapshots.
        """

        def stack_metric(vals):
            a = np.asarray(vals)  # (R,) or (R, B)
            return a if a.ndim == 1 else np.moveaxis(a, 0, 1)

        zs = None
        if self.zs:
            zs = np.stack(self.zs)  # (R, [B,] N, D)
            if zs.ndim == 4:
                zs = np.moveaxis(zs, 0, 1)
        return (
            np.asarray(self.iters),
            stack_metric(self.dist2) if self.dist2 else np.zeros(0),
            stack_metric(self.consensus),
            zs,
        )


# ---------------------------------------------------------------------------
# Dynamic networks: phase resolution for schedules and churn plans
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Phase:
    """One static stretch of a dynamic run: fixed graph, W and membership.

    ``entry`` says how the phase was entered: None (run start), "switch"
    (new W, same membership: the state carries as-is) or "kill"/"join"
    (elastic remap). ``row_map`` maps this phase's nodes into the global
    accounting rows (N0 original nodes + one row per joined node);
    ``cols`` maps them into the columns of the (steps, N0) sample stream.
    """

    start: int
    end: int
    problem: Problem
    entry: str | None
    event: ChurnEvent | None
    row_map: np.ndarray
    cols: np.ndarray


def _graph_fp(g: Graph | None):
    """Value fingerprint of an optional graph (the churn-child cache key)."""
    return None if g is None else (g.n, g.edges)


def _w_fp(w) -> bytes | None:
    """Value fingerprint of an optional mixing matrix."""
    return None if w is None else np.ascontiguousarray(w).tobytes()


def _churn_kill_child(problem: Problem, event: ChurnEvent, device):
    """(survivor Problem, keep list) for a kill event; memoized on problem.

    The child slices the parent's data arrays; a parent with a root gets
    the survivor system's own root, solved on ``device``.
    """
    n = problem.graph.n
    dead = sorted({int(x) for x in event.nodes})
    for x in dead:
        if not 0 <= x < n:
            raise ValueError(
                f"kill event names node {x} outside the current "
                f"membership 0..{n - 1}"
            )
    if len(dead) >= n:
        raise ValueError("kill event leaves no survivors")
    keep = [i for i in range(n) if i not in set(dead)]
    cache = problem.__dict__.setdefault("_churn_cache", {})
    key = ("kill", tuple(dead), _graph_fp(event.graph), _w_fp(event.w))
    if key not in cache:
        g = event.graph
        if g is None:
            g = problem.graph.subgraph(keep)
        if g.n != len(keep):
            raise ValueError(
                f"kill event graph has {g.n} nodes, {len(keep)} survive"
            )
        if not g.is_connected():
            raise ValueError(
                "survivor graph after kill is disconnected; pass "
                "ChurnEvent(graph=...) with a connected replacement"
            )
        data = problem.data
        ka = np.asarray(keep)
        child_data = dataclasses.replace(
            data, idx=data.idx[ka], val=data.val[ka], y=data.y[ka]
        )
        lam = problem.lam
        if np.ndim(lam) > 0:
            lam = np.asarray(lam)[ka]
        child = Problem(
            spec=problem.spec, data=child_data, graph=g, w=event.w, lam=lam
        )
        if problem.z_star is not None and np.ndim(lam) == 0:
            child.solve_star(device=device)  # the survivor system's root
        cache[key] = child
    return cache[key], keep


def _churn_join_child(problem: Problem, event: ChurnEvent, device) -> Problem:
    """Grown Problem for a join event; newcomers replicate ``seed_from``'s
    data shard (the seeding ``ElasticGossip.grow`` applies to the state).
    Memoized like the kill children."""
    n = problem.graph.n
    sf = int(event.seed_from)
    if not 0 <= sf < n:
        raise ValueError(f"join seed_from {sf} outside membership 0..{n - 1}")
    cache = problem.__dict__.setdefault("_churn_cache", {})
    key = ("join", int(event.n_new), sf, _graph_fp(event.graph), _w_fp(event.w))
    if key not in cache:
        g = event.graph  # required (validated by ChurnEvent)
        if g.n != n + event.n_new:
            raise ValueError(
                f"join event graph has {g.n} nodes, membership grows "
                f"{n} -> {n + event.n_new}"
            )
        if not g.is_connected():
            raise ValueError("graph after join is disconnected")
        data = problem.data

        def rep(a):
            seed = np.broadcast_to(a[sf][None], (event.n_new,) + a.shape[1:])
            return np.concatenate([a, seed], axis=0)

        child_data = dataclasses.replace(
            data, idx=rep(data.idx), val=rep(data.val), y=rep(data.y)
        )
        lam = problem.lam
        if np.ndim(lam) > 0:
            lam = np.concatenate(
                [np.asarray(lam), np.full(event.n_new, np.asarray(lam)[sf])]
            )
        child = Problem(
            spec=problem.spec, data=child_data, graph=g, w=event.w, lam=lam
        )
        if problem.z_star is not None and np.ndim(lam) == 0:
            child.solve_star(device=device)  # duplicated shards shift the root
        cache[key] = child
    return cache[key]


def _resolve_phases(problem: Problem, steps: int, churn_plan, device) -> list[_Phase]:
    """Split [0, steps) into static phases from a schedule or a churn plan.

    A single static phase is routed through the ordinary static path.
    """
    n0 = problem.graph.n
    rows = np.arange(n0)
    if churn_plan is None:
        segs = [s for s in problem.schedule if s[0] < steps]
        phases = []
        for k, (start, g, w) in enumerate(segs):
            end = segs[k + 1][0] if k + 1 < len(segs) else steps
            if g is problem.graph and w is problem.w:
                child = problem
            else:
                child = dataclasses.replace(problem, graph=g, w=w, schedule=None)
            phases.append(
                _Phase(start, end, child, None if k == 0 else "switch",
                       None, rows, rows)
            )
        return phases

    for e in churn_plan.events:
        if not 0 < e.at < steps:
            raise ValueError(
                f"churn event at iteration {e.at} outside (0, {steps})"
            )
    phases = []
    cur, cols, next_row = problem, np.arange(n0), n0
    start, entry, ev = 0, None, None
    for e in churn_plan.events:
        phases.append(_Phase(start, int(e.at), cur, entry, ev, rows, cols))
        if e.kind == "kill":
            cur, keep = _churn_kill_child(cur, e, device)
            keep = np.asarray(keep)
            rows, cols = rows[keep], cols[keep]
        else:
            cur = _churn_join_child(cur, e, device)
            rows = np.concatenate([rows, np.arange(next_row, next_row + e.n_new)])
            # newcomers replay seed_from's sample stream, consistent with
            # their replicated data shard
            cols = np.concatenate([cols, np.full(e.n_new, cols[int(e.seed_from)])])
            next_row += e.n_new
        start, entry, ev = int(e.at), e.kind, e
    phases.append(_Phase(start, steps, cur, entry, ev, rows, cols))
    return phases


def _schedule_extras(phases: list[_Phase]) -> list[dict]:
    """The per-phase record for ``SolveResult.extras["schedule"]``."""
    return [
        {
            "start": ph.start,
            "end": ph.end,
            "n": ph.problem.graph.n,
            "spectral_gap": spectral_gap(ph.problem.w),
            "entry": ph.entry,
        }
        for ph in phases
    ]


def _elastic_remap(state, phase: _Phase, n_prev: int, spec: SolverSpec):
    """Apply a phase's entry transform to the carried solver state.

    Kill/join entries remap leading-N leaves through ``ElasticGossip`` and
    then apply the solver's ``reanchor`` hook; a "switch" entry carries the
    state untouched (the mean-drift invariant only needs a doubly
    stochastic W, which every segment has).
    """
    if phase.entry not in ("kill", "join"):
        return state
    # imported here: ft.elastic pulls in the training stack via core.gossip
    from repro_torch.core.gossip import GossipConfig
    from repro_torch.ft.elastic import ElasticGossip

    eg = ElasticGossip(GossipConfig(n_pods=n_prev))
    if phase.entry == "kill":
        state, _ = eg.shrink(state, sorted({int(x) for x in phase.event.nodes}))
    else:
        state, _ = eg.grow(state, int(phase.event.n_new), int(phase.event.seed_from))
    if spec.reanchor is not None:
        state = spec.reanchor(state)
    return state


# ---------------------------------------------------------------------------
# Fault masks, delivered-only accounting, checkpoint metadata
# ---------------------------------------------------------------------------


def _static_fault_masks(plan, graph, steps: int, start: int = 0):
    """A plan's (link_mask, strag_mask) for one static phase, each None
    when all-delivered: a mask-free phase runs the plain step, which makes
    a p = 0 plan bit-equal to a plan-free run."""
    link_mask = strag_mask = None
    if plan is not None and plan.link is not None:
        m = link_delivered_mask(plan.link, graph, steps, start=start)
        if not bool(m.all()):
            link_mask = m
    if plan is not None and plan.straggler is not None:
        m = straggler_delivered_mask(plan.straggler, graph.n, steps, start=start)
        if not bool(m.all()):
            strag_mask = m
    return link_mask, strag_mask


def _advance(state, step_fn, comm, idx_t, lo: int, hi: int, hp_run):
    """Steps ``lo..hi-1`` of a phase (``idx_t`` rows and mask rows are the
    phase's own)."""
    begin = getattr(comm, "begin_step", None)  # the fault-injecting comms
    for t in range(lo, hi):
        if begin is not None:
            begin(t)
        state = step_fn(state, idx_t[t], hp_run)
    return state


def _fault_accounting(spec, hp, problem, link_mask, strag_mask, steps, iters):
    """Delivered-only doubles (R, N) plus the extras["faults"] record.

    One (D,)-double message per DELIVERED directed edge per exchange
    round; with all-True masks this is the standard ``rounds * degree * D``
    dense model.
    """
    D = problem.dim
    rr = _cumulative_rounds(spec, hp, np.arange(steps + 1))
    rdiff = np.diff(rr)  # rounds run during iteration t
    d_in = delivered_in_messages(problem.graph, link_mask, strag_mask, steps)
    per_step = rdiff[:, None] * d_in * D  # (steps, N)
    cumsum = np.cumsum(per_step, axis=0)
    doubles = cumsum[np.asarray(iters) - 1]  # (R, N)
    deg = np.asarray(problem.graph.degrees, dtype=np.int64)
    injected = int(rr[steps] * deg.sum())
    delivered = int((rdiff * d_in.sum(axis=1)).sum())
    extras = {
        "injected_messages": injected,
        "delivered_messages": delivered,
        "drop_rate": 0.0 if injected == 0 else 1.0 - delivered / injected,
    }
    return doubles, extras


def _ckpt_meta(method: str, comm: str, record_every: int, rec) -> dict:
    """The JSON metadata committed with each dense ``solve()`` checkpoint:
    the recorder's floats ride in the manifest (``repr`` round-trips them
    bit-exactly), so resume rebuilds the record history."""
    return {
        "method": method,
        "comm": comm,
        "record_every": int(record_every),
        "rec_iters": [int(x) for x in rec.iters],
        "rec_dist2": [float(x) for x in rec.dist2],
        "rec_consensus": [float(x) for x in rec.consensus],
    }


def _check_resume_meta(resume, step_r, meta, steps, want: dict) -> None:
    """The resume errors of the reference: nothing committed, another run's
    checkpoint, or one beyond ``steps``."""
    if step_r is None:
        raise ValueError(f"no committed checkpoint to resume in {resume!r}")
    for key, val in want.items():
        if meta.get(key) != val:
            raise ValueError(
                f"checkpoint {key}={meta.get(key)!r} does not match the "
                f"resuming run's {key}={val!r}"
            )
    if step_r > steps:
        raise ValueError(
            f"checkpoint at step {step_r} is beyond steps={steps}; "
            "resume with steps >= the checkpointed iteration"
        )


# ---------------------------------------------------------------------------
# solve()
# ---------------------------------------------------------------------------


def _validate_options(comm: str, comm_options: Mapping | None) -> dict:
    """The one comm_options gate: a mutable copy; unknown keys raise."""
    opts = dict(comm_options or {})
    allowed = _COMM_OPTION_KEYS[comm]
    unknown = sorted(set(opts) - set(allowed))
    if unknown:
        raise ValueError(
            f"unknown {comm} comm_options {unknown}; accepts {sorted(allowed)}"
        )
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
    checkpoint: CheckpointSpec | None = None,
    resume: str | None = None,
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
    comm_options: ``verify`` and ``engine`` ("vectorized" or the
        "reference" oracle) for ``comm="sparse"``; on every backend
        ``fault_plan``, an ``ft.FaultPlan`` (or a bare ``ChurnPlan`` /
        ``ChurnEvent``) composing churn, link faults and stragglers
        (stragglers on the dense backend only); ``extras["faults"]``
        reports injected-vs-delivered counts and the doubles accounting
        charges delivered traffic only.
    checkpoint: a ``CheckpointSpec``: snapshot the solver state and the
        recorder every ``checkpoint.every`` iterations (dense: at record
        boundaries).
    resume: a checkpoint directory: restore the newest committed snapshot
        and continue bit-equal to an uninterrupted run.
    device: CUDA unless the caller passes ``"cpu"``; without a card and
        without ``device`` this raises.
    **hyperparams: overrides of the solver's ``defaults``.
    """
    spec = get_solver(method)
    if comm not in COMM_BACKENDS:
        raise ValueError(f"unknown comm backend {comm!r}; one of {COMM_BACKENDS}")
    # peek at fault_plan before the schema check, so an unsupported (method,
    # comm) x fault-family combination surfaces as a CapabilityError
    plan = as_fault_plan((comm_options or {}).get("fault_plan"))
    churn_plan = plan.churn if plan is not None else None
    want_link = plan is not None and plan.link is not None
    want_strag = plan is not None and plan.straggler is not None
    multi = problem.schedule is not None and len(problem.schedule) > 1
    if problem.schedule is not None and plan is not None:
        raise ValueError(
            "a graph schedule and a fault_plan cannot be combined in one "
            "run; encode the W changes as schedule segments instead"
        )
    _check_capability(
        spec, comm, problem.spec.kind,
        schedule=multi,
        churn=churn_plan is not None,
        per_node_lam=np.ndim(problem.lam) > 0,
        link_faults=want_link,
        stragglers=want_strag,
    )
    opts = _validate_options(comm, comm_options)
    opts.pop("fault_plan", None)
    if churn_plan is not None and keep_snapshots:
        raise ValueError(
            "keep_snapshots is unavailable with a fault_plan: snapshot "
            "shapes change across churn events"
        )
    if churn_plan is not None:
        # node ids are relabeled across membership segments, so explicit
        # node/edge targets in the other families become ambiguous
        if want_link and plan.link.edges is not None:
            raise ValueError(
                "scheduled link faults (edges=) cannot be combined with "
                "node churn: node ids are relabeled across membership "
                "changes; use a probabilistic LinkFault(p=...)"
            )
        if want_strag and plan.straggler.nodes is not None:
            raise ValueError(
                "a straggler node subset (nodes=) cannot be combined with "
                "node churn: node ids are relabeled across membership "
                "changes; use a global StragglerSpec(p=...)"
            )
    if steps < 1:
        raise ValueError("steps must be >= 1")
    if record_every < 1:
        raise ValueError("record_every must be >= 1")
    if checkpoint is not None and not isinstance(checkpoint, CheckpointSpec):
        raise TypeError(
            f"checkpoint must be a CheckpointSpec, got "
            f"{type(checkpoint).__name__}"
        )
    if checkpoint is not None or resume is not None:
        if comm == "sharded":
            raise ValueError(
                "checkpoint/resume supports comm='dense' and comm='sparse'; "
                "the sharded backend is not checkpointable"
            )
        if problem.schedule is not None:
            raise ValueError(
                "checkpoint/resume cannot be combined with a graph schedule "
                "(phase boundaries are not checkpoint boundaries)"
            )
        if plan is not None:
            raise ValueError(
                "checkpoint/resume cannot be combined with a fault_plan: "
                "fault masks and straggler buffers are not part of the "
                "snapshot schema"
            )
        if keep_snapshots:
            raise ValueError("checkpoint/resume does not support keep_snapshots")
    if (
        checkpoint is not None
        and comm == "dense"
        and checkpoint.every % record_every != 0
    ):
        raise ValueError(
            f"checkpoint.every={checkpoint.every} must be a multiple of "
            f"record_every={record_every} on the dense backend (snapshots "
            "happen at record boundaries)"
        )
    hp = dict(spec.defaults)
    unknown = set(hyperparams) - set(hp)
    if unknown:
        raise TypeError(
            f"{method!r} got unknown hyperparameters {sorted(unknown)}; "
            f"accepts {sorted(hp)}"
        )
    hp.update(hyperparams)
    if comm == "sharded":
        dev = _sharded_device(device, opts.get("mesh"))
    else:
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
    # a schedule or churn plan becomes a list of static phases; a single
    # phase runs the static path below (only extras gains the segment log)
    phases = None
    sched_x = None
    if problem.schedule is not None or churn_plan is not None:
        phases = _resolve_phases(problem, steps, churn_plan, dev)
        sched_x = _schedule_extras(phases)
        if len(phases) == 1:
            problem = phases[0].problem
            phases = None

    pts = _record_points(steps, record_every)
    rec = _Recorder(problem.z_star, keep_snapshots)

    if comm == "sparse":
        if phases is not None:
            if any(ph.entry in ("kill", "join") for ph in phases):
                return _solve_sparse_churn(
                    spec, method, phases, hp, steps, pts, rec, indices,
                    z0, opts, sched_x, plan, dev,
                )
            return _solve_sparse_schedule(
                spec, method, phases, hp, steps, pts, rec, indices, z0,
                opts, sched_x, dev,
            )
        return _solve_sparse(
            spec, method, problem, hp, steps, pts, rec, indices, z0, opts,
            sched_x, plan, checkpoint, resume, dev,
        )
    if phases is not None:
        return _solve_phased(
            spec, method, comm, phases, hp, steps, pts, rec, indices, z0,
            opts, sched_x, plan, dev,
        )
    if comm == "sharded":
        return _solve_sharded(
            spec, method, problem, hp, steps, pts, rec, indices, z0, opts,
            sched_x, plan, dev,
        )

    # ---- dense backend: a cached runner, an eager loop on the device --------
    t0 = time.perf_counter()
    link_mask, strag_mask = _static_fault_masks(plan, problem.graph, steps)
    runner = _phase_runner(spec, problem, hp, dev, link_mask, strag_mask)
    dt = runner.data.val.dtype
    hp_run = _dynamic_hp(spec, problem, hp, dt, dev)
    idx_t = torch.as_tensor(indices[:steps], dtype=torch.long, device=dev)
    z0_t = torch.as_tensor(np.asarray(z0), device=dev)
    mgr = None
    if checkpoint is not None:
        mgr = CheckpointManager(checkpoint.directory, keep_last=checkpoint.keep_last)
    start = 0
    if resume is not None:
        state, start = _restore_dense(
            resume, runner.init(z0_t), rec, method=method,
            comm=comm, record_every=record_every, steps=steps,
        )
    else:
        state = runner.init(z0_t)
    prev = start
    z_final = None
    for pt in pts:
        if pt <= start:
            continue  # covered by the restored checkpoint
        state = _advance(state, runner.step, runner.comm, idx_t, prev, pt, hp_run)
        prev = pt
        z_final = runner.z_read(state, hp_run).cpu().numpy()
        rec.push(pt, z_final)
        if mgr is not None and pt % checkpoint.every == 0:
            mgr.save(pt, {"state": state},
                     metadata=_ckpt_meta(method, comm, record_every, rec))
    if mgr is not None:
        mgr.wait()
    if z_final is None:
        # resumed at (or past) the final record point: nothing to re-run
        z_final = runner.z_read(state, hp_run).cpu().numpy()
    wall = time.perf_counter() - t0

    iters, dist2, cons, zs = rec.arrays()
    extras = {} if sched_x is None else {"schedule": sched_x}
    if want_link or want_strag:
        # a p = 0 plan ran the plain step and still reports its record
        doubles, extras["faults"] = _fault_accounting(
            spec, hp, problem, link_mask, strag_mask, steps, iters
        )
    else:
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
        extras=extras,
    )


def _restore_dense(resume, template, rec, *, method, comm, record_every, steps):
    """``(state, start)`` from the newest committed dense checkpoint.

    The recorder history rides in the manifest as Python floats; the state
    restores strictly against ``template`` (the method's own init).
    """
    step_r, meta, _ = load_checkpoint(resume)
    _check_resume_meta(resume, step_r, meta, steps, {
        "method": method, "comm": comm, "record_every": record_every})
    tree, _ = restore_checkpoint(resume, {"state": template}, step=step_r)
    rec.iters.extend(int(x) for x in meta["rec_iters"])
    rec.dist2.extend(float(x) for x in meta["rec_dist2"])
    rec.consensus.extend(float(x) for x in meta["rec_consensus"])
    return tree["state"], int(step_r)


def _solve_sparse(spec, method, problem, hp, steps, pts, rec, indices, z0,
                  opts, sched_x, plan, checkpoint, resume, dev) -> SolveResult:
    """One relay run: link faults as a ``sent_mask``, and checkpointing."""
    fault_x = None
    if plan is not None and plan.link is not None:
        sent = source_sent_mask(plan.link, problem.graph, steps)
        n_bcast = steps * problem.graph.n
        fault_x = {
            "injected_broadcasts": int(n_bcast),
            "delivered_broadcasts": int(sent.sum()),
            "drop_rate": 1.0 - float(sent.sum()) / n_bcast,
        }
        if not bool(sent.all()):
            # an all-delivered plan runs the plain relay: p = 0 is bit-equal
            opts["sent_mask"] = sent
    if checkpoint is not None:
        mgr = CheckpointManager(checkpoint.directory, keep_last=checkpoint.keep_last)
        meta = {"method": method, "comm": "sparse"}
        opts["ckpt_every"] = int(checkpoint.every)
        opts["ckpt_save"] = lambda t_done, tree: mgr.save(
            t_done, tree, metadata=meta, async_=False)
    if resume is not None:
        step_r, meta_r, leaves = load_checkpoint(resume)
        _check_resume_meta(resume, step_r, meta_r, steps,
                           {"method": method, "comm": "sparse"})
        opts["resume"] = (int(step_r), leaves)
    t0 = time.perf_counter()
    sres = spec.sparse_run(problem, hp, steps, indices, z0, opts, dev)
    wall = time.perf_counter() - t0
    for pt in pts:
        rec.push(pt, sres.z_trace[pt])
    iters, dist2, cons, zs = rec.arrays()
    sel = np.asarray(pts) - 1
    extras = {"z_trace": sres.z_trace, "recon_max_err": sres.recon_max_err}
    if fault_x is not None:
        extras["faults"] = fault_x
    if sched_x is not None:
        extras["schedule"] = sched_x
    return SolveResult(
        method=method,
        comm="sparse",
        iters=iters,
        dist2=dist2,
        consensus=cons,
        doubles_received=sres.doubles_received[sel],
        ints_received=sres.ints_received[sel],
        wall_time=wall,
        z=sres.z_trace[-1],
        state=None,
        zs=zs,
        extras=extras,
    )


def _solve_sharded(spec, method, problem, hp, steps, pts, rec, indices, z0,
                   opts, sched_x, plan, dev) -> SolveResult:
    """One static run on a node mesh (``comm="sharded"``).

    The mesh is ``comm_options["mesh"]`` or the registry's of N ranks on
    ``dev``. Link faults run the fault runner (every exchange still runs,
    so the counted bytes equal the fault-free run's; the receivers drop
    masked messages); the doubles are counted by the dense formula (the
    delivered-only one under link faults), as the reference counts them.
    """
    t0 = time.perf_counter()
    mesh = opts.get("mesh") or _phase_mesh(None, problem.graph.n, dev)
    link_mask, _ = _static_fault_masks(plan, problem.graph, steps)
    out = _run_sharded(spec, problem, hp, mesh, dev, indices[:steps], pts,
                       link_mask, None, z0)
    for pt, z in zip(pts, out.zs):
        rec.push(pt, z)
    wall = time.perf_counter() - t0
    iters, dist2, cons, zs = rec.arrays()
    extras = {"collectives": out.costs, "mesh_devices": mesh.n, "ranks": out.ranks}
    if plan is not None and plan.link is not None:
        # a p = 0 plan ran the plain step and still reports its record
        doubles, extras["faults"] = _fault_accounting(
            spec, hp, problem, link_mask, None, steps, iters)
    else:
        per_node = dense_doubles_per_iter(problem.graph, problem.dim)  # (N,)
        doubles = _cumulative_rounds(spec, hp, iters)[:, None] * per_node[None, :]
    if sched_x is not None:
        extras["schedule"] = sched_x
    return SolveResult(
        method=method,
        comm="sharded",
        iters=iters,
        dist2=dist2,
        consensus=cons,
        doubles_received=doubles,
        ints_received=np.zeros_like(doubles),
        wall_time=wall,
        z=out.zs[-1],
        state=out.state,
        zs=zs,
        extras=extras,
        measured_collective_bytes=np.asarray(out.counted, dtype=np.float64),
    )


def _solve_phased(spec, method, comm, phases, hp, steps, pts, rec, indices,
                  z0, opts, sched_x, plan, dev) -> SolveResult:
    """Dense or sharded execution of a multi-phase (dynamic-network) run.

    Each phase runs through its own cached runner on its own W (and, after
    churn, its own data), carrying the state across boundaries: as-is for a W switch,
    elastically remapped for churn. A fault plan's masks are resolved per
    phase against the phase graph (their seeds fold the phase's global
    start, so the stream is one continuous draw), and a phase's straggler
    buffers start empty (its first iteration delivers). Accounting folds
    per-phase increments into global per-row cumulative counts: rows are
    the N0 original nodes plus one row per joined node
    (``extras["churn_rows"]`` when membership changed).

    Sharded phases run on the given mesh when its size is the phase's N,
    else on the registry's mesh of that size; each re-derives its edge
    colouring. The collectives are counted per phase and the measured
    bytes accumulate across phases; ``extras["collectives"]`` and
    ``extras["mesh_devices"]`` are the first phase's.
    """
    t0 = time.perf_counter()
    sharded = comm == "sharded"
    base = phases[0].problem
    D = base.dim
    total_rows = max(int(ph.row_map.max()) for ph in phases) + 1
    record_set = set(pts)
    cum = np.zeros(total_rows)
    doubles_rows: list[np.ndarray] = []
    measured: list[float] = []
    measured_base = 0.0
    costs0 = mesh_devices = None
    rank_stats: list = []
    state = None
    z_final = None
    n_prev = base.graph.n
    injected_tot = delivered_tot = 0
    want_fault = plan is not None and (
        plan.link is not None or plan.straggler is not None
    )
    for ph in phases:
        p = ph.problem
        seg = ph.end - ph.start
        if state is not None:
            state = _elastic_remap(state, ph, n_prev, spec)
        link_mask, strag_mask = _static_fault_masks(plan, p.graph, seg, start=ph.start)
        rdiff_ph = np.diff(
            _cumulative_rounds(spec, hp, np.arange(ph.start, ph.end + 1))
        )
        d_in_ph = delivered_in_messages(p.graph, link_mask, strag_mask, seg)
        cum_ph = np.cumsum(rdiff_ph[:, None] * d_in_ph * D, axis=0)
        deg_ph = np.asarray(p.graph.degrees, dtype=np.int64)
        injected_tot += int(rdiff_ph.sum() * deg_ph.sum())
        delivered_tot += int((rdiff_ph * d_in_ph.sum(axis=1)).sum())
        marks = sorted({pt for pt in pts if ph.start < pt <= ph.end} | {ph.end})
        idx_ph = indices[ph.start:ph.end][:, ph.cols]
        if sharded:
            mesh = _phase_mesh(opts.get("mesh"), p.graph.n, dev)
            out = _run_sharded(spec, p, hp, mesh, dev, idx_ph,
                               [mk - ph.start for mk in marks], link_mask, state, z0)
            state = out.state
            z_at = dict(zip(marks, out.zs))
            counted_at = dict(zip(marks, out.counted))
            if costs0 is None:
                costs0, mesh_devices = out.costs, mesh.n
            rank_stats.append(out.ranks)
        else:
            runner = _phase_runner(spec, p, hp, dev, link_mask, strag_mask)
            hp_run = _dynamic_hp(spec, p, hp, runner.data.val.dtype, dev)
            if state is None:
                state = runner.init(torch.as_tensor(np.asarray(z0), device=dev))
            idx_t = torch.as_tensor(idx_ph, dtype=torch.long, device=dev)
        prev = ph.start
        for mk in marks:
            if not sharded:
                state = _advance(state, runner.step, runner.comm, idx_t,
                                 prev - ph.start, mk - ph.start, hp_run)
            prev = mk
            if mk in record_set:
                if sharded:
                    z_final = z_at[mk]
                    measured.append(measured_base + counted_at[mk])
                else:
                    z_final = runner.z_read(state, hp_run).cpu().numpy()
                rec.push(mk, z_final, z_star=p.z_star)
                snap = cum.copy()
                snap[ph.row_map] += cum_ph[mk - ph.start - 1]
                doubles_rows.append(snap)
        cum[ph.row_map] += cum_ph[-1]
        if sharded:
            measured_base += out.counted[-1]
        n_prev = p.graph.n
    wall = time.perf_counter() - t0
    iters, dist2, cons, zs = rec.arrays()
    doubles = np.stack(doubles_rows)
    extras: dict = {"schedule": sched_x}
    if total_rows != base.graph.n or any(
        ph.entry in ("kill", "join") for ph in phases
    ):
        extras["churn_rows"] = total_rows
    if want_fault:
        extras["faults"] = {
            "injected_messages": injected_tot,
            "delivered_messages": delivered_tot,
            "drop_rate": (
                0.0 if injected_tot == 0 else 1.0 - delivered_tot / injected_tot
            ),
        }
    if sharded:
        extras.update(collectives=costs0, mesh_devices=mesh_devices, ranks=rank_stats)
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
        extras=extras,
        measured_collective_bytes=np.asarray(measured) if sharded else None,
    )


def _recon_max(recon) -> float:
    """The largest of the segments' ``recon_max_err`` (nan when none verified)."""
    rc = np.asarray(recon, dtype=np.float64)
    return float(np.nanmax(rc)) if not np.all(np.isnan(rc)) else float("nan")


def _solve_sparse_schedule(spec, method, phases, hp, steps, pts, rec, indices,
                           z0, opts, sched_x, dev) -> SolveResult:
    """Relay execution of a graph schedule: chained segment runs.

    Each segment re-derives the relay's tables for its own graph; the
    solver state chains through ``SparseRunResult.state`` -> the next
    segment's ``state0`` (which charges the restart flood). The counts
    concatenate, each segment offset by the previous one's final counts.
    """
    t0 = time.perf_counter()
    st = None
    z_traces = []
    doubles_parts, ints_parts = [], []
    d_off = i_off = 0  # int: keeps the concatenated counts integer-typed
    recon = []
    for k, ph in enumerate(phases):
        seg_steps = ph.end - ph.start
        o = dict(opts)
        if k == 0:
            sres = spec.sparse_run(ph.problem, hp, seg_steps,
                                   indices[ph.start:ph.end], z0, o, dev)
        else:
            o["state0"] = st
            sres = spec.sparse_run(ph.problem, hp, seg_steps,
                                   indices[ph.start:ph.end], None, o, dev)
        st = sres.state
        z_traces.append(sres.z_trace if k == 0 else sres.z_trace[1:])
        doubles_parts.append(sres.doubles_received + d_off)
        ints_parts.append(sres.ints_received + i_off)
        d_off = doubles_parts[-1][-1]
        i_off = ints_parts[-1][-1]
        recon.append(sres.recon_max_err)
    wall = time.perf_counter() - t0
    z_trace = np.concatenate(z_traces)  # (steps + 1, N, D)
    doubles_all = np.concatenate(doubles_parts)  # (steps, N) cumulative
    ints_all = np.concatenate(ints_parts)
    for pt in pts:
        rec.push(pt, z_trace[pt])
    iters, dist2, cons, zs = rec.arrays()
    sel = np.asarray(pts) - 1
    return SolveResult(
        method=method,
        comm="sparse",
        iters=iters,
        dist2=dist2,
        consensus=cons,
        doubles_received=doubles_all[sel],
        ints_received=ints_all[sel],
        wall_time=wall,
        z=z_trace[-1],
        state=None,
        zs=zs,
        extras={
            "z_trace": z_trace,
            "recon_max_err": _recon_max(recon),
            "schedule": sched_x,
        },
    )


def _solve_sparse_churn(spec, method, phases, hp, steps, pts, rec, indices,
                        z0, opts, sched_x, plan, dev) -> SolveResult:
    """Relay execution of node churn: one relay per membership segment.

    Each segment re-derives the relay's tables for its own graph and
    chains through ``run_sparse(state0=)``; the carried state is
    elastically remapped at each boundary and reanchored (DSBA resets its
    step counter, so the segment re-runs the eq. 31 update on the new
    membership and floods the remapped iterates once). Accounting folds
    per-segment counts into global per-row cumulative totals, as the dense
    churn path does.
    """
    t0 = time.perf_counter()
    total_rows = max(int(ph.row_map.max()) for ph in phases) + 1
    cum_d = np.zeros(total_rows, dtype=np.int64)
    cum_i = np.zeros(total_rows, dtype=np.int64)
    out_d: list[np.ndarray] = []
    out_i: list[np.ndarray] = []
    recon = []
    injected_tot = delivered_tot = 0
    want_link = plan is not None and plan.link is not None
    st = None
    z_final = None
    n_prev = phases[0].problem.graph.n
    for ph in phases:
        p = ph.problem
        seg = ph.end - ph.start
        o = dict(opts)
        if want_link:
            sent = source_sent_mask(plan.link, p.graph, seg, start=ph.start)
            injected_tot += seg * p.graph.n
            delivered_tot += int(sent.sum())
            if not bool(sent.all()):
                o["sent_mask"] = sent
        idx_seg = indices[ph.start:ph.end][:, ph.cols]
        if st is None:
            sres = spec.sparse_run(p, hp, seg, idx_seg, z0, o, dev)
        else:
            o["state0"] = _elastic_remap(st, ph, n_prev, spec)
            sres = spec.sparse_run(p, hp, seg, idx_seg, None, o, dev)
        st = sres.state
        n_prev = p.graph.n
        for pt in pts:
            if ph.start < pt <= ph.end:
                lt = pt - ph.start
                rec.push(pt, sres.z_trace[lt], z_star=p.z_star)
                snap_d = cum_d.copy()
                snap_d[ph.row_map] += sres.doubles_received[lt - 1]
                snap_i = cum_i.copy()
                snap_i[ph.row_map] += sres.ints_received[lt - 1]
                out_d.append(snap_d)
                out_i.append(snap_i)
        cum_d[ph.row_map] += sres.doubles_received[seg - 1]
        cum_i[ph.row_map] += sres.ints_received[seg - 1]
        recon.append(sres.recon_max_err)
        z_final = sres.z_trace[-1]
    wall = time.perf_counter() - t0
    iters, dist2, cons, zs = rec.arrays()
    extras: dict = {
        "recon_max_err": _recon_max(recon),
        "schedule": sched_x,
        "churn_rows": total_rows,
    }
    if want_link:
        extras["faults"] = {
            "injected_broadcasts": injected_tot,
            "delivered_broadcasts": delivered_tot,
            "drop_rate": (
                0.0 if injected_tot == 0 else 1.0 - delivered_tot / injected_tot
            ),
        }
    return SolveResult(
        method=method,
        comm="sparse",
        iters=iters,
        dist2=dist2,
        consensus=cons,
        doubles_received=np.stack(out_d),
        ints_received=np.stack(out_i),
        wall_time=wall,
        z=z_final,
        state=st,
        zs=zs,
        extras=extras,
    )


def solve_many(
    problem: Problem,
    method: str = "dsba",
    comm: str = "dense",
    *,
    steps: int,
    grid: list[Mapping[str, float]] | None = None,
    seeds: list[int] | None = None,
    record_every: int = 50,
    seed: int = 0,
    z0: np.ndarray | None = None,
    indices: np.ndarray | None = None,
    keep_snapshots: bool = False,
    comm_options: dict | None = None,
    device=None,
    **common_hp,
) -> SolveResult:
    """Run a hyperparameter/seed sweep as ONE batched computation.

    The sweep axis B is ``len(grid)`` (per-entry hyperparameter overrides),
    ``len(seeds)`` (per-entry sample streams), or both (paired: equal
    lengths required). On the dense backend the whole grid advances in
    lockstep through the cached runner with the batch written out as a
    leading axis: every state tensor is (B, ...), the per-run
    hyperparameters are (B,) tensors, and a step launches what one run's
    step launches (plus one mixing product a run: ``DenseComm`` takes B
    same-shape products so each run keeps its own bits). DSBA/DSA runs are
    bit-equal to their sequential ``solve()``.

    ``comm="sparse"`` batches too (``run_sparse_many``): B relays in
    lockstep, the closed-form message accounting applied per run after the
    loop, bit-equal to sequential calls. The entries run one after another
    through ``solve()`` (each warm after the first) when the grid is not
    batchable:

    - ``comm="sparse"`` with ``engine="reference"`` (the per-observer
      oracle loop) or a method without a batched sparse backend;
    - ``comm="sharded"``: one mesh run advances one run;
    - a grid entry overrides a ``static_hp`` (structural);
    - a schedule or a fault plan (the batched paths assume one static,
      fault-free graph for the whole run).

    Returns one ``SolveResult`` whose per-run arrays carry a leading B
    axis: ``dist2``/``consensus`` are (B, R), ``doubles_received``/
    ``ints_received`` (B, R, N), ``z`` (B, N, D), ``zs`` (B, R, N, D).
    ``iters`` stays (R,). ``state`` is the batched state (a list of the
    runs' states on the sequential route, None on the relay). ``extras``
    records ``grid``, ``seeds`` and whether the batched path ran
    (``"batched"``).

    indices: optional explicit sample streams, (>= steps, N) shared by
    every entry or (B, >= steps, N) per entry; by default ``draw_indices``
    per entry seed (``seeds[b]``, else the shared ``seed``).
    device: CUDA unless the caller passes ``"cpu"``.
    """
    spec = get_solver(method)
    if comm not in COMM_BACKENDS:
        raise ValueError(f"unknown comm backend {comm!r}; one of {COMM_BACKENDS}")
    fault_plan = as_fault_plan((comm_options or {}).get("fault_plan"))
    if problem.schedule is not None and fault_plan is not None:
        raise ValueError(
            "a graph schedule and a fault_plan cannot be combined in one run"
        )
    _check_capability(
        spec, comm, problem.spec.kind,
        schedule=problem.schedule is not None and len(problem.schedule) > 1,
        churn=fault_plan is not None and fault_plan.churn is not None,
        per_node_lam=np.ndim(problem.lam) > 0,
        link_faults=fault_plan is not None and fault_plan.link is not None,
        stragglers=fault_plan is not None and fault_plan.straggler is not None,
    )
    _validate_options(comm, comm_options)
    # dynamic-network and fault-injected runs are per-entry sequential: the
    # batched paths assume one static fault-free (graph, W, membership)
    dynamic = problem.schedule is not None or fault_plan is not None
    if grid is None and seeds is None:
        raise ValueError("solve_many needs a grid, seeds, or both")
    entries = [dict(e) for e in grid] if grid is not None else None
    if entries is not None and seeds is not None and len(entries) != len(seeds):
        raise ValueError(
            f"grid ({len(entries)}) and seeds ({len(seeds)}) must pair up"
        )
    n_runs = len(entries) if entries is not None else len(seeds)
    if n_runs < 1:
        raise ValueError("solve_many needs at least one grid/seed entry")
    if entries is None:
        entries = [{} for _ in range(n_runs)]
    seeds_list = list(seeds) if seeds is not None else [seed] * n_runs

    known = set(spec.defaults)
    for ent in (common_hp, *entries):
        unknown = set(ent) - known
        if unknown:
            raise TypeError(
                f"{method!r} got unknown hyperparameters {sorted(unknown)}; "
                f"accepts {sorted(known)}"
            )
    merged = [dict(spec.defaults, **common_hp, **e) for e in entries]

    data = problem.data
    n, q = data.n_nodes, data.q
    idx_b = _sweep_indices(indices, n_runs, steps, n, q, seeds_list)
    if comm == "sharded":
        # one mesh run advances one run: the entries go one after another
        # through the warm runner, as in the reference
        return _solve_many_sequential(
            problem, method, comm, steps=steps, record_every=record_every,
            z0=z0, keep_snapshots=keep_snapshots, comm_options=comm_options,
            merged=merged, entries=entries, seeds=seeds_list, idx_b=idx_b,
            dev=_sharded_device(device, (comm_options or {}).get("mesh")),
        )
    dev = resolve_device(device)

    ragged = any(k in spec.static_hp for e in entries for k in e)
    if comm == "sparse" and not ragged and not dynamic:
        res = _solve_many_sparse_batched(
            problem, method, spec, steps=steps, record_every=record_every,
            z0=z0, keep_snapshots=keep_snapshots, comm_options=comm_options,
            merged=merged, entries=entries, seeds=seeds_list, idx_b=idx_b, dev=dev,
        )
        if res is not None:
            return res
    if comm != "dense" or ragged or dynamic:
        return _solve_many_sequential(
            problem, method, comm, steps=steps, record_every=record_every,
            z0=z0, keep_snapshots=keep_snapshots, comm_options=comm_options,
            merged=merged, entries=entries, seeds=seeds_list, idx_b=idx_b, dev=dev,
        )

    # ---- batched path: the cached runner with a leading batch axis --------
    if steps < 1:
        raise ValueError("steps must be >= 1")
    if record_every < 1:
        raise ValueError("record_every must be >= 1")
    D = problem.dim
    if z0 is None:
        z0 = np.zeros((n, D), dtype=data.val.dtype)

    t0 = time.perf_counter()
    base_hp = dict(spec.defaults, **common_hp)
    runner = _get_dense_runner(spec, problem, base_hp, dev)
    hp_b = _dynamic_hp(spec, problem, base_hp, runner.data.val.dtype, dev, merged=merged)
    state = batch_tree(runner.init(torch.as_tensor(np.asarray(z0), device=dev)), n_runs)
    # (steps, B, N): row t is every run's draw of iteration t
    idx_t = torch.as_tensor(np.ascontiguousarray(idx_b[:, :steps].transpose(1, 0, 2)),
                            dtype=torch.long, device=dev)
    pts = _record_points(steps, record_every)
    rec = _Recorder(problem.z_star, keep_snapshots)
    prev = 0
    z_final = None
    for pt in pts:
        state = _advance(state, runner.step, runner.comm, idx_t, prev, pt, hp_b)
        prev = pt
        z_final = runner.z_read(state, hp_b).cpu().numpy()
        rec.push(pt, z_final)
    wall = time.perf_counter() - t0

    iters, dist2, cons, zs = rec.arrays()
    per_node = dense_doubles_per_iter(problem.graph, D)  # (N,)
    # rounds may differ per grid entry (e.g. a mudag gossip_rounds sweep)
    rounds_b = np.stack([_cumulative_rounds(spec, m, iters) for m in merged])
    doubles = rounds_b[:, :, None] * per_node[None, None, :]
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
        extras={"batched": True, "grid": entries, "seeds": seeds_list},
    )


def _sweep_indices(indices, n_runs, steps, n, q, seeds_list) -> np.ndarray:
    """(B, >= steps, N) sample streams for a sweep, drawn or validated."""
    if indices is None:
        return np.stack([draw_indices(steps, n, q, s) for s in seeds_list])
    indices = np.asarray(indices)
    if indices.ndim == 2:
        indices = np.broadcast_to(indices[None], (n_runs,) + indices.shape)
    if (
        indices.ndim != 3
        or indices.shape[0] != n_runs
        or indices.shape[1] < steps
        or indices.shape[2] != n
    ):
        raise ValueError(
            f"indices must be (>= steps, N) or (B, >= steps, N) = "
            f"({n_runs}, >={steps}, {n}), got {indices.shape}"
        )
    return indices


def _solve_many_sparse_batched(
    problem, method, spec, *, steps, record_every, z0, keep_snapshots,
    comm_options, merged, entries, seeds, idx_b, dev,
) -> SolveResult | None:
    """One lockstep relay run for the whole sparse sweep, or None to decline.

    Declines (returns ``None``, sending ``solve_many`` to the sequential
    route) when the method has no batched sparse backend or the backend
    itself declines (``engine="reference"``). Results are bit-equal to the
    sequential path (the relay's message accounting is closed-form over
    each run's nnz log, after the loop).
    """
    if spec.sparse_run_many is None:
        return None
    if steps < 1:
        raise ValueError("steps must be >= 1")
    if record_every < 1:
        raise ValueError("record_every must be >= 1")
    t0 = time.perf_counter()
    sres = spec.sparse_run_many(
        problem, merged, steps, idx_b, z0, dict(comm_options or {}), dev
    )
    if sres is None:
        return None
    wall = time.perf_counter() - t0
    pts = _record_points(steps, record_every)
    rec = _Recorder(problem.z_star, keep_snapshots)
    for pt in pts:
        rec.push(pt, np.stack([r.z_trace[pt] for r in sres]))
    iters, dist2, cons, zs = rec.arrays()
    sel = np.asarray(pts) - 1
    return SolveResult(
        method=method,
        comm="sparse",
        iters=iters,
        dist2=dist2,
        consensus=cons,
        doubles_received=np.stack([r.doubles_received[sel] for r in sres]),
        ints_received=np.stack([r.ints_received[sel] for r in sres]),
        wall_time=wall,
        z=np.stack([r.z_trace[-1] for r in sres]),
        state=None,
        zs=zs,
        extras={
            "batched": True,
            "grid": entries,
            "seeds": seeds,
            "per_run_extras": [
                {"z_trace": r.z_trace, "recon_max_err": r.recon_max_err}
                for r in sres
            ],
        },
    )


def _solve_many_sequential(
    problem, method, comm, *, steps, record_every, z0, keep_snapshots,
    comm_options, merged, entries, seeds, idx_b, dev,
) -> SolveResult:
    """The sequential route: one (warm after the first) ``solve()`` an entry."""
    results = [
        solve(
            problem, method, comm, steps=steps, record_every=record_every,
            z0=z0, indices=idx_b[b], keep_snapshots=keep_snapshots,
            comm_options=comm_options, device=dev, **merged[b],
        )
        for b in range(len(merged))
    ]
    r0 = results[0]
    return SolveResult(
        method=method,
        comm=comm,
        iters=r0.iters,
        dist2=np.stack([r.dist2 for r in results]),
        consensus=np.stack([r.consensus for r in results]),
        doubles_received=np.stack([r.doubles_received for r in results]),
        ints_received=np.stack([r.ints_received for r in results]),
        wall_time=sum(r.wall_time for r in results),
        z=np.stack([r.z for r in results]),
        state=[r.state for r in results],
        zs=(
            np.stack([r.zs for r in results])
            if keep_snapshots else None
        ),
        extras={
            "batched": False,
            "grid": entries,
            "seeds": seeds,
            "per_run_extras": [r.extras for r in results],
        },
    )


# ---------------------------------------------------------------------------
# Registry entries: DSBA / DSA (Algorithm 1 + Remark 5.1)
# ---------------------------------------------------------------------------


def _make_dsba_family(method: str, default_alpha: float) -> SolverSpec:
    """Registry entry for the stochastic family: shared step, both comms."""

    def placeholder_cfg(problem):
        """The step's config: alpha and lam arrive per run in ``hp_run``."""
        return DSBAConfig(spec=problem.spec, alpha=0.0, lam=0.0, method=method)

    def init(problem, hp, data, z0):
        """SAGA-table warm start (Algorithm 1 line 1) at ``z0``."""
        return init_state(placeholder_cfg(problem), data, z0)

    def step(problem, hp, data, comm):
        """The Algorithm-1 step with mixing through ``comm.matvec``."""
        return make_hp_step_fn(placeholder_cfg(problem), data, problem.w, comm)

    def sparse_run(problem, hp, steps, indices, z0, options, device):
        """The Section-5.1 delta relay (``core.sparse_comm.run_sparse``)."""
        return run_sparse(
            DSBAConfig(spec=problem.spec, alpha=hp["alpha"], lam=problem.lam, method=method),
            problem.data, problem.graph, problem.w,
            steps, indices, z0=z0, device=device, **options,
        )

    def sparse_run_many(problem, merged, steps, idx_b, z0, options, device):
        """B relays in lockstep (``run_sparse_many``); declines "reference"."""
        options = dict(options)
        options.pop("fault_plan", None)
        if options.pop("engine", "vectorized") != "vectorized":
            return None  # the oracle loop is per-run by construction
        return run_sparse_many(
            DSBAConfig(spec=problem.spec, alpha=merged[0]["alpha"], lam=problem.lam,
                       method=method),
            problem.data, problem.graph, problem.w, steps, idx_b,
            [hp["alpha"] for hp in merged], z0=z0, device=device, **options,
        )

    return SolverSpec(
        name=method,
        init=init,
        step=step,
        z_of=lambda problem, hp, data, comm: lambda state, hp_run: state.z,
        defaults={"alpha": default_alpha},
        sparse_run=sparse_run,
        sparse_run_many=sparse_run_many,
        # the SAGA table stores scalars for any linear-predictor operator,
        # the bilinear saddle family included
        problem_families=FAMILIES,
        # the fixed point is W-independent and the state is all leading-N
        # tensors: schedules, churn and per-node lam are sound
        supports_schedule=True,
        supports_churn=True,
        supports_per_node_lam=True,
        # after a churn remap, re-enter the t = 0 branch: the t >= 1
        # difference recursion is stationary at ANY consensus point with
        # settled tables; only the step-0 psi (the -alpha*phibar
        # injection) targets the new membership's root. Tables and
        # iterates are kept (phibar rows are node-local, so slicing or
        # seeding them is exact).
        reanchor=lambda st: dataclasses.replace(st, step=torch.zeros_like(st.step)),
    )


register_solver(_make_dsba_family("dsba", default_alpha=0.5))
register_solver(_make_dsba_family("dsa", default_alpha=0.2))


# ---------------------------------------------------------------------------
# Registry entries: deterministic baselines (EXTRA / DLM / SSDA)
# ---------------------------------------------------------------------------


def _bc(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-run hyperparameter (0-d, or (B,) for a batch) shaped to
    broadcast against ``x`` (N, D), or (B, N, D) for a batch."""
    return v.reshape(v.shape + (1,) * (x.dim() - v.dim()))


def _host_ints(v) -> tuple[int, ...]:
    """A ``host_hp`` value as one int a run, truncated as the JAX
    package's ``astype(int32)`` truncates."""
    return tuple(int(x) for x in (v if isinstance(v, tuple) else (v,)))


def _run_masks(device):
    """``mask(flags) -> (B, 1, 1)`` bool tensor on ``device``, memoized per
    flag tuple (a batch's per-run mixing or gossip rounds repeat)."""
    memo = {}

    def mask(flags: tuple[bool, ...]) -> torch.Tensor:
        if flags not in memo:
            memo[flags] = torch.tensor(flags, device=device).reshape(-1, 1, 1)
        return memo[flags]

    return mask


def _dense_setup(problem: Problem, data):
    """(feats (N, q, d), labels (N, q)) on the runner's device, built once.

    The features come from the numpy ``SparseDataset.dense()`` the JAX
    package uses; ``data.derived`` keeps them for the runner's other
    factories.
    """
    if "dense" not in data.derived:
        data.derived["dense"] = torch.as_tensor(
            problem.data.dense(), device=data.val.device
        )
    return data.derived["dense"], data.y


def _full_operator(spec: OperatorSpec, feats, labels):
    """G(Z, lam): (..., N, D) -> (..., N, D), the full local operator with
    ``lam Z``.

    ``lam`` is a call argument (``personal`` passes 0.0 and adds its
    per-node term itself). The contractions keep the JAX package's order;
    a (B, N, D) batch reads the features once for all B runs. The steps
    pass their nodes' rows (``comm.local``), so on a rank of the sharded
    backend the operator is the rank's node's alone.
    """
    t = spec.tail_dim
    d = feats.shape[-1]

    def G(Z, lam):
        head, tail = Z[..., :d], Z[..., d:]
        u = torch.einsum("nqd,...nd->...nq", feats, head)
        tails = tail[..., None, :].expand(*u.shape, t)
        g, tail_out = spec.coeff_and_tail(u, labels, tails)
        out_head = torch.einsum("...nq,nqd->...nd", g, feats) / feats.shape[1]
        out = torch.cat([out_head, tail_out.mean(-2)], dim=-1) if t else out_head
        return out + lam * Z

    return G


def _first_value(problem, hp, data, comm):
    """Read-out of every state whose first entry is the iterate block."""
    return lambda state, hp_run: state[0]


def _extra_init(problem, hp, data, z0):
    """EXTRA state: (z, z_prev, g_prev, t), t a host int."""
    zeros = torch.zeros_like(z0)
    return (z0, zeros, zeros, 0)


def _extra_step(problem, hp, data, comm):
    """EXTRA (Shi et al. 2015a), eq. (47) form with first-step special case."""
    feats, labels = _dense_setup(problem, data)
    G = _full_operator(problem.spec, comm.local(feats), comm.local(labels))
    w_mix = comm.matvec(problem.w, feats.dtype)
    wt_mix = comm.matvec(w_tilde(problem.w), feats.dtype)

    def step(carry, i_t, hp_run):
        z, z_prev, g_prev, t = carry
        alpha = _bc(hp_run["alpha"], z)
        g = G(z, hp_run["lam"])
        # both products every step, the t == 0 one unused: a straggler
        # buffer slot is one call site, taken the same number of times
        # every iteration (as the reference's select computes both)
        wz, wtz = w_mix(z), wt_mix(z_prev)
        if t == 0:
            z1 = wz - alpha * g
        else:
            z1 = z + wz - wtz - alpha * (g - g_prev)
        return (z1, z, g, t + 1)

    return step


def _dlm_init(problem, hp, data, z0):
    """DLM state: (z, dual multipliers)."""
    return (z0, torch.zeros_like(z0))


def _dlm_step(problem, hp, data, comm):
    """DLM (Ling et al. 2015): linearized decentralized ADMM."""
    feats, labels = _dense_setup(problem, data)
    G = _full_operator(problem.spec, comm.local(feats), comm.local(labels))
    lap_mix = comm.matvec(problem.graph.laplacian, feats.dtype)
    deg = comm.local(torch.as_tensor(
        problem.graph.degrees, dtype=feats.dtype, device=feats.device
    )[:, None])

    def step(carry, i_t, hp_run):
        z, lam_dual = carry
        c, beta = _bc(hp_run["c"], z), _bc(hp_run["beta"], z)
        grad_aug = G(z, hp_run["lam"]) + lam_dual + 2.0 * c * lap_mix(z)
        z1 = z - grad_aug / (2.0 * c * deg + beta)
        lam1 = lam_dual + c * lap_mix(z1)
        return (z1, lam1)

    return step


def _ssda_conj_grad(problem: Problem, data, inner_newton: int):
    """grad f*_n: (..., N, d) -> (..., N, d), built once a runner and kept in
    ``data``.

    Ridge solves ``(A^T A / q + lam I) x = s + A^T y / q`` with a Cholesky
    factor per node: of the d x d matrix, or, when a node has fewer rows
    than columns and the N d x d factors would take more than
    ``SSDA_DENSE_BYTES``, of the q x q ``q lam I + A A^T`` through the
    Woodbury identity (the same solve, rounded differently). Logistic inverts grad f_n by ``inner_newton`` Newton
    steps from 0 with the closed-form Jacobian
    ``A^T diag(g'(u)) A / q + lam I`` (the JAX package's ``jacfwd`` of the
    same map). The step and the read-out share the factorization; lam is
    baked (SSDA's ``bake_lam``: the runner key holds it). The closure is
    ``conj_grad(S, local)``: it reads its per-node constants (factors,
    features) through ``local``, the comm backend's node block (the
    identity on one device, the rank's row under the sharded backend).
    """
    spec, lam = problem.spec, float(problem.lam)
    key = ("ssda", inner_newton, lam)
    if key in data.derived:
        return data.derived[key]
    feats, labels = _dense_setup(problem, data)
    n, q, d = feats.shape
    eye = functools.partial(torch.eye, dtype=feats.dtype, device=feats.device)

    if spec.kind == "ridge" and q < d and n * d * d * feats.element_size() > SSDA_DENSE_BYTES:
        # Woodbury: (A^T A / q + lam I)^-1 = (I - A^T (q lam I + A A^T)^-1 A) / lam,
        # a q x q factor a node where the d x d ones would not fit the card
        # (rcv1, d = 47,236: 17.8 GB a node)
        chol = torch.linalg.cholesky(torch.einsum("nqd,npd->nqp", feats, feats)
                                     + q * lam * eye(q)[None])
        rhs0 = torch.einsum("nqd,nq->nd", feats, labels) / q

        def conj_grad(S, local):
            fe = local(feats)
            v = S + local(rhs0)
            w = torch.cholesky_solve(torch.einsum("nqd,...nd->...nq", fe, v)[..., None],
                                     local(chol))[..., 0]
            return (v - torch.einsum("nqd,...nq->...nd", fe, w)) / lam

    elif spec.kind == "ridge":
        gram = torch.einsum("nqd,nqe->nde", feats, feats) / q
        chol = torch.linalg.cholesky(gram + lam * eye(d)[None])
        rhs0 = torch.einsum("nqd,nq->nd", feats, labels) / q

        def conj_grad(S, local):
            return torch.cholesky_solve((S + local(rhs0))[..., None], local(chol))[..., 0]

    else:

        def conj_grad(S, local):
            fe, la = local(feats), local(labels)
            no_tail = fe.new_zeros(fe.shape[:2] + (0,))
            x = torch.zeros_like(S)
            for _ in range(inner_newton):
                u = torch.einsum("nqd,...nd->...nq", fe, x)
                g, _ = spec.coeff_and_tail(u, la, no_tail)
                gn = torch.einsum("nqd,...nq->...nd", fe, g) / q + lam * x
                gp = logistic_coeff_prime(u, la)
                jac = torch.einsum("nqd,...nq,nqe->...nde", fe, gp, fe) / q
                # solve_ex: no host sync on the card (the systems are
                # positive definite)
                x = x - torch.linalg.solve_ex(
                    jac + lam * eye(d), (gn - S)[..., None]
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

    def step(carry, i_t, hp_run):
        m, m_prev = carry
        eta, momentum = _bc(hp_run["eta"], m), _bc(hp_run["momentum"], m)
        v = m + momentum * (m - m_prev)
        x = conj_grad(-v, comm.local)  # primal: grad f*(-(U Lambda)_n)
        m1 = v + eta * imw_mix(x)
        return (m1, m)

    return step


def _ssda_z_of(problem, hp, data, comm):
    """Primal read-out grad f*(-m): a real computation, not a field access."""
    conj_grad = _ssda_conj_grad(problem, data, int(hp["inner_newton"]))
    return lambda state, hp_run: conj_grad(-state[0], comm.local)


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
        # inner_newton is a loop count (structural); lam is baked into the
        # Cholesky / Newton factorization of grad f*
        static_hp=("inner_newton",),
        bake_lam=True,
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

    sigma the second-largest eigenvalue magnitude of W (W's content is
    part of the runner key, so the baked weight never goes stale).
    """
    eigs = np.sort(np.abs(np.linalg.eigvalsh(np.asarray(w, dtype=np.float64))))
    sigma = float(eigs[-2]) if eigs.size > 1 else 0.0
    sigma = min(max(sigma, 0.0), 1.0 - 1e-12)
    root = float(np.sqrt(1.0 - sigma * sigma))
    return (1.0 - root) / (1.0 + root)


def _make_fastmix(comm, w, dt, device):
    """``fastmix(x, ks)``: k rounds of accelerated gossip, each one
    ``comm.matvec`` application plus local arithmetic; ``ks`` holds one k a
    run. A batch runs the largest k and freezes each finished run with a
    ``torch.where`` select (exact), as the JAX package's batched loop does."""
    w_mix = comm.matvec(w, dt)
    eta_w = _fastmix_weight(w)
    mask = _run_masks(device)

    def fastmix(x, ks):
        cur, prev = x, x
        for r in range(max(ks)):
            nxt = (1.0 + eta_w) * w_mix(cur) - eta_w * prev
            if r < min(ks):
                cur, prev = nxt, cur
            else:
                live = mask(tuple(r < k for k in ks))
                cur, prev = torch.where(live, nxt, cur), torch.where(live, cur, prev)
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
    differ for a non-integer ``gossip_rounds``, in both packages. K is a
    host number (``host_hp``): it sets the loop's trip count.
    """
    feats, labels = _dense_setup(problem, data)
    G = _full_operator(problem.spec, comm.local(feats), comm.local(labels))
    fastmix = _make_fastmix(comm, problem.w, feats.dtype, feats.device)

    def step(carry, i_t, hp_run):
        x, y, s, g_prev, t = carry
        eta, beta = _bc(hp_run["eta"], x), _bc(hp_run["momentum"], x)
        ks = _host_ints(hp_run["gossip_rounds"])
        g = G(y, hp_run["lam"])
        s1 = fastmix(g if t == 0 else s + g - g_prev, ks)
        x1 = fastmix(y - eta * s1, ks)
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
    as in the JAX package. In a batch whose runs are not all on a round,
    the products run for every run and a ``torch.where`` keeps them for
    the runs that are.
    """
    feats, labels = _dense_setup(problem, data)
    G = _full_operator(problem.spec, comm.local(feats), comm.local(labels))
    w_mix = comm.matvec(problem.w, feats.dtype)
    mask = _run_masks(feats.device)

    def step(carry, i_t, hp_run):
        z, s, g_prev, t = carry
        periods = _host_ints(hp_run["comm_period"])
        if min(periods) < 1:
            raise ValueError(f"comm_period must be >= 1, got {hp_run['comm_period']!r}")
        alpha = _bc(hp_run["alpha"], z)
        g = G(z, hp_run["lam"])
        s1 = g if t == 0 else s + g - g_prev
        on = tuple(t % p == 0 for p in periods)
        if all(on):
            z, s1 = w_mix(z), w_mix(s1)
        elif any(on):
            m = mask(on)
            z, s1 = torch.where(m, w_mix(z), z), torch.where(m, w_mix(s1), s1)
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
        host_hp=("gossip_rounds",),
        # Nesterov descent needs a convex minimization objective
        problem_families=MINIMIZATION_FAMILIES,
        comm_rounds=_mudag_rounds,
        supports_schedule=True,
        supports_churn=True,
        # churn resets the tracker: it encodes the departed membership's
        # mean gradient. The step counter rewinds, so the next step
        # re-seeds s = FastMix(g) on the new membership, with the momentum
        # restarted (y = x)
        reanchor=lambda st: (
            st[0], st[0], torch.zeros_like(st[2]), torch.zeros_like(st[3]), 0,
        ),
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
        host_hp=("comm_period",),
        problem_families=MINIMIZATION_FAMILIES,
        comm_rounds=_sliding_rounds,
        supports_schedule=True,
        supports_churn=True,
        # tracker reset on churn (see mudag); z itself carries over
        reanchor=lambda st: (
            st[0], torch.zeros_like(st[1]), torch.zeros_like(st[2]), 0,
        ),
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
    head_mask = torch.cat([feats.new_ones((d,)), feats.new_zeros((t,))])
    node = comm.local(torch.arange(n, device=feats.device))  # this caller's nodes
    memo = {}

    def scale_of(hp_run):
        """(1|B, 1, D) step sizes: alpha on the head, eta on the tail;
        built once a run (one hp dict a run)."""
        if memo.get("hp") is not hp_run:
            alpha, eta = hp_run["alpha"][..., None], hp_run["eta"][..., None]
            memo["hp"] = hp_run
            memo["scale"] = (alpha * head_mask + eta * (1.0 - head_mask))[..., None, :]
        return memo["scale"]

    def step(carry, i_t, hp_run):
        z, tab_g, tab_tail, phibar, y, v_prev, step_t = carry
        rows = feats[node, i_t]  # (..., N, d)
        ys = labels[node, i_t]
        head, tail = z[..., :d], z[..., d:]
        u = torch.sum(rows * head, dim=-1)
        g, tail_out = spec.coeff_and_tail(u, ys, tail)  # (..., N), (..., N, t)
        t_idx = i_t[..., None, None].expand(*i_t.shape, 1, t)
        dg = g - tab_g.gather(-1, i_t[..., None])[..., 0]
        dtail = tail_out - tab_tail.gather(-2, t_idx)[..., 0, :]
        delta = torch.cat([dg[..., None] * rows, dtail], dim=-1)
        v = delta + phibar + hp_run["lam"] * z
        # w_mix(y) every step, unused at t == 0: straggler slots are call
        # sites taken a fixed number of times an iteration (see EXTRA)
        wy = w_mix(y)
        y1 = v if step_t == 0 else wy + v - v_prev
        z1 = w_mix(z) - scale_of(hp_run) * y1
        return (
            z1,
            tab_g.scatter(-1, i_t[..., None], g[..., None]),
            tab_tail.scatter(-2, t_idx, tail_out[..., None, :]),
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
        # tracker reset on churn: keep the iterate and the SAGA tables
        # (remapped), zero the tracker y and v_prev, and rewind t so the
        # step re-seeds y = v on the new membership (see mudag)
        reanchor=lambda st: (
            st[0], st[1], st[2], st[3],
            torch.zeros_like(st[4]), torch.zeros_like(st[5]), 0,
        ),
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

    def step(carry, i_t, hp_run):
        (z,) = carry
        alpha, mu = _bc(hp_run["alpha"], z), _bc(hp_run["mu"], z)
        lam = hp_run["lam"]
        lam_col = lam[:, None] if lam.dim() > 0 else lam
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
