"""Unified fault-injection plans for ``solve()`` (counterpart of ``repro.ft.faults``).

The port keeps its own copy of the JAX package's numpy-only module: the
plan classes, the host-side mask functions and the delivered-message
accounting are the reference's line for line, so a plan resolves to the
SAME masks in both packages (each mask is drawn from numpy's
``default_rng([seed, tag, start])``).

One ``FaultPlan`` composes the three fault families a run can inject:

* **node churn** (``ChurnPlan`` / ``ChurnEvent``) -- kill/join events that
  split a run into membership segments (dense and sparse backends);
* **link faults** (``LinkFault``) -- per-directed-edge message drops,
  probabilistic (drop probability ``p`` per edge per iteration) or
  scheduled (explicit ``edges`` at explicit iterations ``at``), applied
  inside the dense mixing matvec as a masked mixing row with
  row-renormalization (dropped neighbor mass redirects to self, so the
  effective matrix stays row-stochastic for stochastic ``W``), and inside
  the sparse relay as a suppressed broadcast;
* **stragglers** (``StragglerSpec``) -- delayed delivery: a straggling
  sender's neighbors keep using its *last delivered* value, never more
  than ``max_staleness`` iterations old (delivery is forced when the bound
  is reached).

The plan is resolved to plain numpy masks host-side
(``link_delivered_mask`` / ``straggler_delivered_mask`` /
``source_sent_mask``); ``solve()`` uploads a phase's masks to the device
once and indexes them per step. ``delivered_in_messages`` counts only the
messages that arrived; ``solve()`` reports injected-vs-delivered totals in
``SolveResult.extras["faults"]``.

This module imports only numpy and ``core.mixing``, so building and
validating a plan never pulls in the training stack.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.mixing import Graph


# ---------------------------------------------------------------------------
# Node churn (re-exported by core.solvers)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class ChurnEvent:
    """One membership change at iteration ``at`` (after ``at`` steps ran).

    kind="kill": ``nodes`` (in the membership numbering CURRENT at ``at``)
    leave; survivors keep going on ``graph`` (default: the induced
    subgraph, which must be connected) with mixing ``w`` (default: the
    paper's Laplacian weights). kind="join": ``n_new`` nodes join,
    seeded — state rows AND data shard — from node ``seed_from``
    (matching ``ElasticGossip.grow``); ``graph`` over the grown
    membership is required (the old graph says nothing about the
    newcomers' wiring).
    """

    at: int
    kind: str  # "kill" | "join"
    nodes: tuple[int, ...] = ()
    n_new: int = 0
    seed_from: int = 0
    graph: Graph | None = None
    w: np.ndarray | None = None

    def __post_init__(self):
        """Validate the event's own fields (graph-vs-membership at use)."""
        if self.kind not in ("kill", "join"):
            raise ValueError(f"churn event kind {self.kind!r} is not kill|join")
        object.__setattr__(self, "nodes", tuple(int(x) for x in self.nodes))
        if self.kind == "kill" and not self.nodes:
            raise ValueError("kill event needs at least one node")
        if self.kind == "join":
            if self.n_new < 1:
                raise ValueError("join event needs n_new >= 1")
            if self.graph is None:
                raise ValueError(
                    "join event requires a graph over the grown membership"
                )


@dataclasses.dataclass(frozen=True, eq=False)
class ChurnPlan:
    """An ordered fault-injection plan: strictly increasing event times.

    Passed to ``solve()`` as ``comm_options={"fault_plan": plan}`` (all
    three backends; methods advertising ``supports_churn``). Tests
    use it to kill/join nodes deterministically and assert re-convergence
    on the survivor system.
    """

    events: tuple[ChurnEvent, ...]

    def __post_init__(self):
        """Normalize to a tuple and check event times are increasing."""
        object.__setattr__(self, "events", tuple(self.events))
        ats = [e.at for e in self.events]
        if any(b <= a for a, b in zip(ats, ats[1:])):
            raise ValueError(f"churn event times must strictly increase: {ats}")
        if not self.events:
            raise ValueError("ChurnPlan needs at least one event")


# ---------------------------------------------------------------------------
# Link faults and stragglers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)
class LinkFault:
    """Per-directed-edge message drops, probabilistic and/or scheduled.

    ``p``: per-iteration drop probability of each directed graph edge,
    drawn independently per (iteration, edge) from ``seed`` (host-side;
    the draw also folds in the churn-phase start so re-derived masks stay
    deterministic across membership segments). ``edges`` + ``at``:
    deterministic drops — every listed directed ``(src, dst)`` pair
    (default: ALL directed edges) is dropped at each iteration in ``at``.
    Both mechanisms compose by OR. On the sparse relay a drop suppresses
    the source's whole broadcast for that iteration (see module docs).
    """

    p: float = 0.0
    seed: int = 0
    edges: tuple[tuple[int, int], ...] | None = None
    at: tuple[int, ...] | None = None

    def __post_init__(self):
        """Validate probability range and normalize the schedule tuples."""
        if not 0.0 <= float(self.p) <= 1.0:
            raise ValueError(f"link drop probability p={self.p} not in [0, 1]")
        if self.edges is not None:
            object.__setattr__(
                self,
                "edges",
                tuple((int(a), int(b)) for a, b in self.edges),
            )
        if self.at is not None:
            ats = tuple(int(t) for t in self.at)
            if any(t < 0 for t in ats):
                raise ValueError(f"scheduled drop iterations must be >= 0: {ats}")
            object.__setattr__(self, "at", ats)
        if self.edges is not None and self.at is None:
            raise ValueError("LinkFault.edges without .at has no effect; set at=")


@dataclasses.dataclass(frozen=True, eq=False)
class StragglerSpec:
    """Delayed delivery: senders whose messages arrive late, bounded.

    Each iteration, each straggling node fails to deliver a fresh value
    with probability ``p`` (drawn from ``seed``); its neighbors keep
    using the last value it delivered. Delivery is FORCED once the
    buffered value is ``max_staleness`` iterations old — the bound of
    ``ft.elastic.BoundedStalenessBuffer``, here resolved host-side into
    a delivery mask the step consumes. ``nodes`` restricts
    straggling to a subset (default: every node can straggle).
    """

    p: float = 0.0
    max_staleness: int = 2
    nodes: tuple[int, ...] | None = None
    seed: int = 0

    def __post_init__(self):
        """Validate probability and bound; normalize the node subset."""
        if not 0.0 <= float(self.p) <= 1.0:
            raise ValueError(f"straggler probability p={self.p} not in [0, 1]")
        if int(self.max_staleness) < 1:
            raise ValueError(
                f"max_staleness must be >= 1, got {self.max_staleness}"
            )
        if self.nodes is not None:
            object.__setattr__(
                self, "nodes", tuple(int(x) for x in self.nodes)
            )


@dataclasses.dataclass(frozen=True, eq=False)
class FaultPlan:
    """The composed fault-injection plan ``solve()`` accepts.

    Any subset of the three families may be present (at least one must
    be). Passed as ``comm_options={"fault_plan": plan}``; a bare
    ``ChurnPlan`` / ``ChurnEvent`` / list of events is still accepted
    everywhere a plan is (``as_fault_plan`` normalizes).
    """

    churn: ChurnPlan | None = None
    link: LinkFault | None = None
    straggler: StragglerSpec | None = None

    def __post_init__(self):
        """Normalize the churn member and require at least one family."""
        churn = self.churn
        if isinstance(churn, ChurnEvent):
            churn = ChurnPlan((churn,))
        elif isinstance(churn, (list, tuple)):
            churn = ChurnPlan(tuple(churn))
        if churn is not None and not isinstance(churn, ChurnPlan):
            raise TypeError(
                f"FaultPlan.churn must be a ChurnPlan/ChurnEvent(s), got "
                f"{type(self.churn).__name__}"
            )
        object.__setattr__(self, "churn", churn)
        if self.link is not None and not isinstance(self.link, LinkFault):
            raise TypeError(
                f"FaultPlan.link must be a LinkFault, got "
                f"{type(self.link).__name__}"
            )
        if self.straggler is not None and not isinstance(
            self.straggler, StragglerSpec
        ):
            raise TypeError(
                f"FaultPlan.straggler must be a StragglerSpec, got "
                f"{type(self.straggler).__name__}"
            )
        if self.churn is None and self.link is None and self.straggler is None:
            raise ValueError("FaultPlan needs at least one fault family")


def as_fault_plan(obj) -> FaultPlan | None:
    """Normalize ``comm_options["fault_plan"]`` to a ``FaultPlan`` (or None).

    Accepts the churn-only shapes too: a bare ``ChurnPlan``, a single
    ``ChurnEvent``, or a list/tuple of events all become churn-only
    plans.
    """
    if obj is None or isinstance(obj, FaultPlan):
        return obj
    if isinstance(obj, (ChurnPlan, ChurnEvent, list, tuple)):
        return FaultPlan(churn=obj)
    raise TypeError(
        f"fault_plan must be a FaultPlan / ChurnPlan / ChurnEvent(s), got "
        f"{type(obj).__name__}"
    )


# ---------------------------------------------------------------------------
# Host-side mask resolution (solve() uploads them once a phase)
# ---------------------------------------------------------------------------


def _directed_adjacency(graph: Graph) -> np.ndarray:
    """(N, N) bool: ``adj[u, m]`` — ``u`` receives from neighbor ``m``."""
    adj = np.zeros((graph.n, graph.n), dtype=bool)
    for i, j in graph.edges:
        adj[i, j] = adj[j, i] = True
    return adj


def link_delivered_mask(
    link: LinkFault | None, graph: Graph, steps: int, start: int = 0
) -> np.ndarray:
    """(steps, N, N) bool delivery mask: ``mask[t, u, m]`` = message
    ``m -> u`` at global iteration ``start + t`` arrives.

    Non-edges and the diagonal are always True (they carry no message;
    keeping them True makes the masked-matvec renormalization a no-op
    there). ``start`` offsets both the probabilistic draw (folded into
    the rng seed, so each churn phase re-derives deterministically) and
    the scheduled ``at`` times (which are global iteration numbers).
    """
    n = graph.n
    adj = _directed_adjacency(graph)
    mask = np.ones((steps, n, n), dtype=bool)
    if link is None:
        return mask
    if link.p > 0.0:
        rng = np.random.default_rng([int(link.seed), 0x11F, int(start)])
        drop = rng.random((steps, n, n)) < float(link.p)
        mask &= ~(drop & adj[None])
    if link.at is not None:
        if link.edges is None:
            sched = adj
        else:
            sched = np.zeros((n, n), dtype=bool)
            for src, dst in link.edges:
                if not (0 <= src < n and 0 <= dst < n):
                    raise ValueError(
                        f"scheduled drop edge ({src}, {dst}) outside the "
                        f"current membership 0..{n - 1}"
                    )
                if not adj[dst, src]:
                    raise ValueError(
                        f"scheduled drop edge ({src}, {dst}) is not an edge "
                        "of the communication graph"
                    )
                sched[dst, src] = True
        for t in link.at:
            tt = t - start
            if 0 <= tt < steps:
                mask[tt] &= ~sched
    return mask


def straggler_delivered_mask(
    strag: StragglerSpec | None, n: int, steps: int, start: int = 0
) -> np.ndarray:
    """(steps, N) bool delivery mask with the staleness bound applied.

    ``out[t, m]`` — node ``m`` delivers a FRESH value at global iteration
    ``start + t``. The host replay enforces the bound: after
    ``max_staleness`` consecutive non-deliveries, delivery is forced, so
    the value a receiver uses is never more than ``max_staleness``
    iterations old. Ages start at the bound, so the first iteration of a
    run (or churn phase) always delivers — receivers never read an
    uninitialized buffer.
    """
    out = np.ones((steps, n), dtype=bool)
    if strag is None or strag.p <= 0.0:
        return out
    rng = np.random.default_rng([int(strag.seed), 0x57A, int(start)])
    late = rng.random((steps, n)) < float(strag.p)
    if strag.nodes is not None:
        allowed = np.zeros(n, dtype=bool)
        for x in strag.nodes:
            if not 0 <= x < n:
                raise ValueError(
                    f"straggler node {x} outside the membership 0..{n - 1}"
                )
            allowed[x] = True
        late &= allowed[None]
    bound = int(strag.max_staleness)
    age = np.full(n, bound, dtype=np.int64)
    for t in range(steps):
        deliver = (~late[t]) | (age >= bound)
        out[t] = deliver
        age = np.where(deliver, 0, age + 1)
    return out


def source_sent_mask(
    link: LinkFault | None, graph: Graph, steps: int, start: int = 0
) -> np.ndarray:
    """(steps, N) bool: the sparse relay's per-source broadcast mask.

    The relay forwards one compressed delta per source per iteration
    along broadcast trees; a per-edge drop model does not map onto the
    shared reconstruction ring, so on the sparse backend a link fault
    suppresses the source's WHOLE broadcast for that iteration — the
    conservative root-hop-drop reading. ``p`` becomes the per-broadcast
    suppression probability; a scheduled ``(src, dst)`` drop suppresses
    ``src``'s broadcast at the scheduled iterations. Deterministic in
    ``(seed, start)`` like the dense masks.
    """
    n = graph.n
    sent = np.ones((steps, n), dtype=bool)
    if link is None:
        return sent
    if link.p > 0.0:
        rng = np.random.default_rng([int(link.seed), 0x5B, int(start)])
        sent &= ~(rng.random((steps, n)) < float(link.p))
    if link.at is not None:
        if link.edges is None:
            srcs = list(range(n))
        else:
            srcs = sorted({int(src) for src, _ in link.edges})
            for s in srcs:
                if not 0 <= s < n:
                    raise ValueError(
                        f"scheduled drop source {s} outside the membership "
                        f"0..{n - 1}"
                    )
        for t in link.at:
            tt = t - start
            if 0 <= tt < steps:
                sent[tt, srcs] = False
    return sent


# ---------------------------------------------------------------------------
# Delivered-message accounting (host-side, from the resolved masks)
# ---------------------------------------------------------------------------


def delivered_in_messages(
    graph: Graph,
    link_mask: np.ndarray | None,
    deliver_mask: np.ndarray | None,
    steps: int,
) -> np.ndarray:
    """(steps, N) int: neighbor messages node ``u`` receives per iteration.

    A message ``m -> u`` at iteration ``t`` arrives iff the link is up
    (``link_mask[t, u, m]``) AND the sender delivered fresh that
    iteration (``deliver_mask[t, m]`` — a straggling sender sends
    nothing; its forced catch-up delivery counts as one message). With
    no faults this is ``deg(u)`` every iteration — exactly the dense
    accounting model.
    """
    adj = _directed_adjacency(graph)
    up = np.broadcast_to(adj[None], (steps,) + adj.shape).copy()
    if link_mask is not None:
        up &= link_mask[:steps]
    if deliver_mask is not None:
        up &= deliver_mask[:steps, None, :]
    return up.sum(axis=2).astype(np.int64)


def fault_message_totals(
    graph: Graph,
    link_mask: np.ndarray | None,
    deliver_mask: np.ndarray | None,
    steps: int,
) -> dict:
    """The ``SolveResult.extras["faults"]`` record for one phase.

    ``injected_messages`` counts every neighbor exchange the no-fault
    protocol would have performed over ``steps`` iterations (one message
    per directed edge per round); ``delivered_messages`` counts only the
    ones that arrived under the masks. Per-iteration granularity — the
    caller scales by the method's rounds-per-iteration hook.
    """
    deg = np.asarray(graph.degrees, dtype=np.int64)
    d_in = delivered_in_messages(graph, link_mask, deliver_mask, steps)
    injected = int(steps * deg.sum())
    delivered = int(d_in.sum())
    return {
        "injected_messages": injected,
        "delivered_messages": delivered,
        "drop_rate": (
            0.0 if injected == 0 else 1.0 - delivered / injected
        ),
    }
