"""Communication primitives: how a solver's mixing step executes.

Port of ``repro.core.comm``'s single-device backends: ``comm.matvec(M,
dtype)`` returns ``mix(X) = M @ X`` for a graph-supported matrix ``M``.
``DenseComm`` is the plain matmul; ``FaultyDenseComm`` injects a fault
plan's link drops and stragglers into the same products. The sharded
backend (one node per device, edge-wise exchange, and its link-fault
variant) is not ported yet (ROADMAP Queue 1 item 10); with it comes
``local``, the caller's node block, which on one device is the whole
array.
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
        return lambda x: m_t @ x


class FaultyDenseComm(DenseComm):
    """DenseComm with link-drop masks and straggler delivery buffers.

    Built for one static phase of a run with the phase's masks, uploaded
    to the device once: ``link`` a (steps, N, N) bool tensor (``link[t, u,
    m]``: the message m -> u arrives at the phase's iteration t) and
    ``deliv`` a (steps, N) bool tensor (``deliv[t, m]``: m delivers a fresh
    value), either None when its family is off. The loop calls
    ``begin_step(t)`` before each step; ``mix`` then reads row t of each.

    Link faults: ``mix`` is a masked matvec with row renormalization.
    Dropped neighbor entries are zeroed and their mass goes to the
    receiver's own (always fresh) value, so a row-stochastic ``W`` stays
    row-stochastic under any drop pattern. The masked matrices and the
    dropped mass of every step are built once, when ``matvec`` is called.

    Stragglers: each ``mix`` call of a step owns one last-delivered-value
    buffer slot, taken in call order (the same order every step, since the
    step function is fixed). A sender whose ``deliv`` bit is off
    contributes its buffered value instead of the fresh one; the buffer
    then holds what receivers used. The self term always reads the fresh
    value. A slot's buffer is made at its first use: the mask forces
    delivery on a phase's first iteration, so nothing reads it before.
    """

    def __init__(self, graph: Graph, device: torch.device, link=None, deliv=None):
        """Bind the graph and the phase's device masks (None: family off)."""
        super().__init__(graph, device)
        self.link = link
        self.deliv = deliv
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
        if self.link is not None:
            zero = torch.zeros((), dtype=dtype, device=self.device)
            kept = torch.where(self.link, m_t, zero)  # (steps, N, N)
            dropped = torch.where(self.link, zero, m_t).sum(dim=2)  # (steps, N)

        def col(v, x):
            return v.reshape((-1,) + (1,) * (x.ndim - 1))

        def mix(x):
            x_used = self._use(x)
            if self.link is not None:
                # dropped neighbor mass goes to self -- always fresh
                out = kept[self._t] @ x_used + col(dropped[self._t], x) * x
            else:
                out = m_t @ x_used
            if self.deliv is not None:
                # the self term reads the fresh value, not the buffer
                out = out + col(diag, x) * (x - x_used)
            return out

        return mix
