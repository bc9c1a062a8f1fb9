"""Plain PyTorch versions of the CUDA kernels (counterparts of ``repro.kernels.ref``).

They are the CPU path of every kernel wrapper and the oracle the kernels are
held to on the card. Both compute in the input dtype (the JAX oracles do the
same for float64 inputs). The scatter runs column by column in k order with
no atomics, so it is deterministic on the CPU and on the card and folds
duplicate indices in the same order as the JAX oracle's sequential scatter.
"""
from __future__ import annotations

import torch


def sparse_dot_ref(psi: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Per-node sparse dot: out[n] = sum_k val[n,k] * psi[n, idx[n,k]]."""
    return (val * torch.gather(psi, 1, idx.long())).sum(-1)


def sparse_axpy_ref(
    psi: torch.Tensor,
    idx: torch.Tensor,
    val: torch.Tensor,
    coef: torch.Tensor,
    rho: torch.Tensor,
) -> torch.Tensor:
    """Sparse AXPY: out[n] = rho[n] * psi[n] + coef[n] * scatter(val[n] at idx[n])."""
    out = rho[:, None] * psi
    src = coef[:, None] * val
    rows = torch.arange(psi.shape[0], device=psi.device)
    cols = idx.long()
    for j in range(idx.shape[1]):
        # one column: every node writes its own row, so no index repeats
        out[rows, cols[:, j]] = out[rows, cols[:, j]] + src[:, j]
    return out
