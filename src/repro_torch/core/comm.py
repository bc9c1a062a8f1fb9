"""Communication primitives: how a solver's mixing step executes.

Port of ``repro.core.comm``'s ``DenseComm``: ``comm.matvec(M, dtype)``
returns ``mix(X) = M @ X`` for a graph-supported matrix ``M``. The sharded
backend (one node per device, edge-wise exchange) is not ported yet
(ROADMAP Queue 1 item 10); with it comes ``local``, the caller's node
block, which on one device is the whole array.
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
