"""Communication primitives: how a solver's mixing step executes.

Port of ``repro.core.comm``'s single-device backends: ``comm.matvec(M,
dtype)`` returns ``mix(X) = M @ X`` for a graph-supported matrix ``M``.
``DenseComm`` is the plain matmul; ``FaultyDenseComm`` injects a fault
plan's link drops and stragglers into the same products. The sharded
backend (one node per device, edge-wise exchange, and its link-fault
variant) is not ported yet (ROADMAP Queue 1 item 10); with it comes
``local``, the caller's node block, which on one device is the whole
array.

A ``solve_many`` batch hands ``mix`` a (B, N, D) stack of runs: it takes B
products of the same (N, N) @ (N, D) shape, one a run, so every run gets
the bits of its own sequential product (a broadcast batched product or one
(N, B*D) product may sum in another order).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.core.mixing import Graph


class DenseComm:
    """Single-device backend: ``mix`` is the matmul."""

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
