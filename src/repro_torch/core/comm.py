"""Communication primitives: how a solver's mixing step executes.

Port of ``repro.core.comm``. Every solver is written against two
primitives instead of a literal matmul:

* ``comm.matvec(M, dtype)`` returns ``mix(X) = M @ X`` for a
  graph-supported matrix ``M`` (off-diagonal nonzeros only on edges of the
  communication graph: W, W~, the Laplacian and I - W all qualify);
* ``comm.local(x)`` returns the caller's node block of a leading-N tensor.

``DenseComm`` is the one-device backend: ``mix`` is the matmul and
``local`` the identity. ``FaultyDenseComm`` injects a fault plan's link
drops and stragglers into the same products. ``ShardedComm`` runs on a
rank of a ``launch.mesh.NodeMesh`` (one graph node a process) and executes
``mix`` as a real neighbour exchange: the graph's edges are greedily
edge-coloured into matchings and each matching is ONE exchange carrying
both directions (the reference's one ``ppermute`` a colour), so a step
moves O(deg) blocks a node, never O(N). ``FaultyShardedComm`` adds a
per-step link delivery mask: every exchange still runs and the receiver
drops a masked message.

A ``solve_many`` batch hands the dense ``mix`` a (B, N, D) stack of runs:
it takes B products of the same (N, N) @ (N, D) shape, one a run, so every
run gets the bits of its own sequential product (a broadcast batched
product or one (N, B*D) product may sum in another order).
"""
from __future__ import annotations

import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.mixing import Graph

NODE_AXIS = "node"
#: the collective the reference's HLO count charges for one colour's exchange
PERMUTE = "collective-permute"


def edge_coloring(edges, n: int) -> list[list[tuple[int, int]]]:
    """Greedy proper edge colouring: partition ``edges`` into matchings.

    Each colour class touches every node at most once, so its edges (both
    directions) fit one exchange. Greedy over the sorted edge list uses at
    most 2*maxdeg - 1 colours and is deterministic: the colours are the
    JAX package's colours.
    """
    colors: list[list[tuple[int, int]]] = []
    busy: list[set[int]] = []
    for i, j in sorted(edges):
        for c, nodes in enumerate(busy):
            if i not in nodes and j not in nodes:
                colors[c].append((i, j))
                nodes.update((i, j))
                break
        else:
            colors.append([(i, j)])
            busy.append({i, j})
    return colors


def _check_support(m: np.ndarray, graph: Graph, atol: float = 0.0) -> None:
    """Reject matrices with off-diagonal mass outside the graph's edges."""
    mask = np.zeros((graph.n, graph.n), dtype=bool)
    for i, j in graph.edges:
        mask[i, j] = mask[j, i] = True
    np.fill_diagonal(mask, True)
    bad = np.abs(np.where(mask, 0.0, m))
    if bad.max(initial=0.0) > atol:
        i, j = np.unravel_index(int(bad.argmax()), bad.shape)
        raise ValueError(
            f"matrix entry ({i}, {j}) = {m[i, j]} is nonzero but ({i}, {j}) "
            "is not an edge of the communication graph; sharded mixing only "
            "moves data along edges"
        )


class DenseComm:
    """Single-device backend: ``mix`` is the matmul, ``local`` the identity."""

    name = "dense"

    def __init__(self, graph: Graph, device: torch.device):
        """Bind the communication graph and the device the matrices live on."""
        self.graph = graph
        self.device = device

    def matvec(self, m: np.ndarray, dtype) -> Callable[[torch.Tensor], torch.Tensor]:
        """``mix(X) = M @ X`` with ``M`` copied to the device once."""
        m_t = torch.as_tensor(np.asarray(m), dtype=dtype, device=self.device)

        def mix(x):
            if x.dim() == 2:
                return m_t @ x
            out = torch.empty_like(x)
            for b in range(x.shape[0]):
                torch.matmul(m_t, x[b], out=out[b])
            return out

        return mix

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """Identity: the whole tensor is this (only) caller's block."""
        return x


class FaultyDenseComm(DenseComm):
    """DenseComm with link-drop masks and straggler delivery buffers.

    Built once per cached fault runner (the fault STRUCTURE is part of its
    key); each run or static phase binds its own masks with ``bind`` (on
    the device): ``link`` a (steps, N, N) bool tensor (``link[t, u, m]``:
    the message m -> u arrives at the phase's iteration t) and ``deliv`` a
    (steps, N) bool tensor (``deliv[t, m]``: m delivers a fresh value),
    either None when its family is off. The loop calls ``begin_step(t)``
    before each step; ``mix`` then reads row t of each.

    Link faults: ``mix`` is a masked matvec with row renormalization.
    Dropped neighbor entries are zeroed and their mass goes to the
    receiver's own (always fresh) value, so a row-stochastic ``W`` stays
    row-stochastic under any drop pattern. The masked matrices and the
    dropped mass of every step are built once per bind, at the first
    ``mix`` call after it.

    Stragglers: each ``mix`` call of a step owns one last-delivered-value
    buffer slot, taken in call order (the same order every step, since the
    step function is fixed). A sender whose ``deliv`` bit is off
    contributes its buffered value instead of the fresh one; the buffer
    then holds what receivers used. The self term always reads the fresh
    value. A slot's buffer is made at its first use after a bind: the mask
    forces delivery on a phase's first iteration, so nothing reads it
    before.
    """

    def __init__(self, graph: Graph, device: torch.device, link=None, deliv=None):
        """Bind the graph and a first set of device masks (None: family off)."""
        super().__init__(graph, device)
        self._gen = 0
        self.bind(link, deliv)

    def bind(self, link, deliv) -> None:
        """Take a run's (or phase's) masks; straggler buffers start empty."""
        self.link = link
        self.deliv = deliv
        self._gen += 1
        self._t = 0
        self._slot = 0
        self._bufs: list[torch.Tensor] = []

    def begin_step(self, t: int) -> None:
        """Select the phase's iteration ``t``: its mask rows and slot 0."""
        self._t = t
        self._slot = 0

    def _use(self, x: torch.Tensor) -> torch.Tensor:
        """The value receivers see from each sender: fresh or buffered."""
        if self.deliv is None:
            return x
        slot = self._slot
        self._slot += 1
        if slot == len(self._bufs):  # first use: delivery is forced
            self._bufs.append(x)
            return x
        d = self.deliv[self._t].reshape((-1,) + (1,) * (x.ndim - 1))
        x_used = torch.where(d, x, self._bufs[slot])
        self._bufs[slot] = x_used
        return x_used

    def matvec(self, m: np.ndarray, dtype) -> Callable[[torch.Tensor], torch.Tensor]:
        """``mix(X) = M_eff(t) @ X_used(t)``: masked rows, buffered senders."""
        m_t = torch.as_tensor(np.asarray(m), dtype=dtype, device=self.device)
        diag = torch.diagonal(m_t).clone()
        zero = torch.zeros((), dtype=dtype, device=self.device)
        masked = {}  # the bound link mask's (kept, dropped), built once a bind

        def link_parts():
            if masked.get("gen") != self._gen:
                kept = torch.where(self.link, m_t, zero)  # (steps, N, N)
                dropped = torch.where(self.link, zero, m_t).sum(dim=2)  # (steps, N)
                masked.update(gen=self._gen, parts=(kept, dropped))
            return masked["parts"]

        def col(v, x):
            return v.reshape((-1,) + (1,) * (x.ndim - 1))

        def mix(x):
            x_used = self._use(x)
            if self.link is not None:
                # dropped neighbor mass goes to self -- always fresh
                kept, dropped = link_parts()
                out = kept[self._t] @ x_used + col(dropped[self._t], x) * x
            else:
                out = m_t @ x_used
            if self.deliv is not None:
                # the self term reads the fresh value, not the buffer
                out = out + col(diag, x) * (x - x_used)
            return out

        return mix


class ShardedComm:
    """One graph node a rank; ``mix`` is one exchange a edge colour.

    ``mesh`` is a ``launch.mesh.NodeMesh`` (the parent: validation and
    the colouring) or the ``NodeRank`` a worker runs as (``matvec`` and
    ``local`` need the rank); its size must be ``graph.n``, the mapping of
    nodes to ranks is positional.

    The exchange goes through gloo, which moves host tensors: a CUDA block
    is copied once into a pinned host buffer, sent to every partner and
    the received blocks copied back to the card. The buffers are made once
    a block shape and dtype. ``bytes``/``count`` accumulate the collective
    traffic by the reference's rule (``launch/hlo_analysis.py``): one
    exchange charges its block's bytes on every rank for every colour,
    whether the rank has a partner in it or not; ``sent_bytes`` is what
    this rank really sent. ``exchange_s`` is the host time spent in the
    exchanges, ``staging_s`` the part of it in the copies between the card
    and the host buffers (the first waits for the kernels that made the
    block); the rest is gloo's transfer.
    """

    name = "sharded"
    axis = NODE_AXIS

    def __init__(self, graph: Graph, mesh):
        """Validate the mesh and precompute the edge-colouring schedule."""
        if mesh.n != graph.n:
            raise ValueError(
                f"sharded comm places one graph node per rank: graph has "
                f"{graph.n} nodes but the {self.axis!r} mesh has {mesh.n} "
                "ranks (make_node_mesh(N))"
            )
        self.graph = graph
        self.rank = getattr(mesh, "rank", None)
        self.device = mesh.device
        self.colors = edge_coloring(graph.edges, graph.n)
        # this node's partner in each matching (None: no edge of that colour)
        self.peers: list[int | None] = []
        for color in self.colors:
            peer = None
            for i, j in color:
                if self.rank in (i, j):
                    peer = j if i == self.rank else i
            self.peers.append(peer)
        self._bufs: dict = {}
        self._calls = 0
        self.reset_counters()

    def reset_counters(self) -> None:
        """Zero the traffic counters and the exchange time."""
        self.bytes = 0
        self.count = 0
        self.sent_bytes = 0
        self.exchange_s = 0.0
        self.staging_s = 0.0

    def _buffers(self, x: torch.Tensor):
        """(send, [recv per colour]) host buffers for x's shape and dtype,
        plus the device tensors the received blocks land in on the card."""
        key = (tuple(x.shape), x.dtype)
        if key not in self._bufs:
            pin = x.is_cuda

            def host():
                return torch.empty(x.shape, dtype=x.dtype, pin_memory=pin)

            recv = [None if p is None else host() for p in self.peers]
            dev = [None if p is None else torch.empty_like(x) for p in self.peers] if pin else recv
            self._bufs[key] = (host() if pin else None, recv, dev)
        return self._bufs[key]

    def _exchange(self, x: torch.Tensor) -> list:
        """Send x to this rank's partner in every colour and receive its
        block: one list entry a colour, None where there is no partner."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        n_col = len(self.colors)
        block = x.numel() * x.element_size()
        self.bytes += n_col * block
        self.count += n_col
        send, recv, dev = self._buffers(x)
        if x.is_cuda:
            send.copy_(x)  # waits for the step's kernels that made x
            t1 = time.perf_counter()
            self.staging_s += t1 - t0
        else:
            send = x.contiguous()
        base = self._calls * n_col
        self._calls += 1
        ops = []
        for c, peer in enumerate(self.peers):
            if peer is None:
                continue
            tag = (base + c) % (1 << 30)
            ops.append(dist.P2POp(dist.isend, send, peer, tag=tag))
            ops.append(dist.P2POp(dist.irecv, recv[c], peer, tag=tag))
            self.sent_bytes += block
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        if x.is_cuda:
            t1 = time.perf_counter()
            for c, peer in enumerate(self.peers):
                if peer is not None:
                    dev[c].copy_(recv[c])
            self.staging_s += time.perf_counter() - t1
        self.exchange_s += time.perf_counter() - t0
        return dev

    def _weights(self, m: np.ndarray, dtype):
        """(diag, [weight per colour]): this rank's ``M[r, r]`` and, per
        colour, ``M[r, peer]`` (0 where there is no partner), as 0-d
        tensors on the device."""
        m = np.asarray(m)
        _check_support(m, self.graph)
        r = self.rank

        def t(v):
            return torch.tensor(float(v), dtype=dtype, device=self.device)

        return t(m[r, r]), [None if p is None else t(m[r, p]) for p in self.peers]

    def matvec(self, m: np.ndarray, dtype) -> Callable[[torch.Tensor], torch.Tensor]:
        """``mix(X) = M @ X`` as diag + one exchange a edge colour.

        The returned closure maps this rank's (1, ...) block: it scales by
        ``M``'s diagonal entry, then adds each partner's block weighted by
        ``M[r, partner]``. A colour in which the rank has no partner adds
        nothing (the reference's ``ppermute`` hands it zeros at weight 0).
        """
        diag, ws = self._weights(m, dtype)

        def mix(x):
            recvs = self._exchange(x)
            out = diag * x
            for w, recv in zip(ws, recvs):
                if recv is not None:
                    out = out + w * recv
            return out

        return mix

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's node block: row ``rank`` of ``x`` (kept as (1, ...))."""
        return x[self.rank:self.rank + 1]


class FaultyShardedComm(ShardedComm):
    """ShardedComm with a per-step link delivery mask (no stragglers).

    Every colour's exchange still runs: a dropped message is discarded at
    the RECEIVER (its weight is zeroed and the mass moves to the
    receiver's own value), so the counted collective traffic equals the
    fault-free run's while the modeled ``doubles_received`` counts only
    delivered messages. ``bind(rows)`` takes this rank's rows of the
    phase's (steps, N, N) delivery mask as a (steps, N) bool array
    (``rows[t, m]``: the message m -> rank arrives at iteration t); the
    loop calls ``begin_step(t)`` before each step and ``mix`` reads, per
    colour, the bit of the peer in that matching.
    """

    def __init__(self, graph: Graph, mesh):
        """Validate the mesh; no mask is bound yet."""
        super().__init__(graph, mesh)
        self._rows = None
        self._t = 0

    def bind(self, rows) -> None:
        """Take a run's (or phase's) rows of the delivery mask."""
        self._rows = np.asarray(rows, dtype=bool)
        self._t = 0

    def begin_step(self, t: int) -> None:
        """Select the phase's iteration ``t``."""
        self._t = t

    def matvec(self, m: np.ndarray, dtype) -> Callable[[torch.Tensor], torch.Tensor]:
        """Masked, renormalized ``mix``: exchange everything, keep delivered."""
        diag, ws = self._weights(m, dtype)

        def mix(x):
            recvs = self._exchange(x)
            row = self._rows[self._t]
            out = diag * x
            dropped = None
            for w, recv, peer in zip(ws, recvs, self.peers):
                if recv is None:
                    continue
                if row[peer]:
                    out = out + w * recv
                else:
                    dropped = w if dropped is None else dropped + w
            # dropped neighbour mass goes to self -- always fresh
            return out if dropped is None else out + dropped * x

        return mix
