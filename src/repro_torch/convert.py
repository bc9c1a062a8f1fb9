"""Carry datasets and solver states between the JAX package and the port.

The port never imports JAX: the caller turns a JAX ``DSBAState`` into
numpy (``{field: np.asarray(leaf)}``) and hands it here, so both packages
can start from one state. ``dataset_to_torch`` moves a ``SparseDataset``
(numpy, from either package's ``data.synthetic``) onto a device once.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from repro_torch.core.dsba import DSBAState
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class TensorDataset:
    """A ``SparseDataset`` on a device: padded-CSR rows split over N nodes."""

    idx: torch.Tensor  # (N, q, k) int32
    val: torch.Tensor  # (N, q, k) float
    y: torch.Tensor  # (N, q) float
    d: int


def dataset_to_torch(data, device=None) -> TensorDataset:
    """Copy a numpy ``SparseDataset`` to `device` (CUDA unless told otherwise)."""
    dev = resolve_device(device)
    return TensorDataset(
        idx=torch.as_tensor(np.asarray(data.idx, np.int32), device=dev),
        val=torch.as_tensor(np.asarray(data.val), device=dev),
        y=torch.as_tensor(np.asarray(data.y), device=dev),
        d=int(data.d),
    )


def state_from_numpy(leaves: Mapping[str, np.ndarray], device=None) -> DSBAState:
    """Build a port ``DSBAState`` from ``{field name: numpy array}``."""
    dev = resolve_device(device)
    names = [f.name for f in dataclasses.fields(DSBAState)]
    missing = sorted(set(names) - set(leaves))
    if missing:
        raise ValueError(f"state leaves are missing {missing}")
    return DSBAState(**{
        n: torch.as_tensor(np.array(leaves[n]), device=dev) for n in names
    })


def state_to_numpy(state: DSBAState) -> dict[str, np.ndarray]:
    """``{field name: numpy array}`` of a port ``DSBAState`` (copied to host)."""
    return {
        f.name: getattr(state, f.name).detach().cpu().numpy()
        for f in dataclasses.fields(state)
    }
