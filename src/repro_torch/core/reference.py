"""Centralized reference solutions and objectives (port of ``repro.core.reference``).

Solves the global problem mean_{n,i} B_{n,i}(z*) + lam z* = 0 by Newton's
method on dense features with an explicit Jacobian (``torch.func.jacfwd``).
One step is exact for the affine ridge/AUC operators; logistic runs to
machine precision. Dense features only: small problems.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.operators import OperatorSpec
from repro_torch.device import resolve_device


def mean_operator(spec: OperatorSpec, data, lam: float, device=None):
    """F(z) = mean_{n,i} B_{n,i}(z) + lam z as a function of a torch vector."""
    dev = resolve_device(device)
    feats = torch.as_tensor(data.dense().reshape(-1, data.d), device=dev)
    labels = torch.as_tensor(data.y.reshape(-1), device=dev)
    t = spec.tail_dim

    def F(z):
        head, tail = z[: data.d], z[data.d:]
        u = feats @ head
        tails = tail.expand(feats.shape[0], t)
        g, tail_out = spec.coeff_and_tail(u, labels, tails)
        out_head = feats.T @ g / feats.shape[0]
        out = torch.cat([out_head, tail_out.mean(0)]) if t else out_head
        return out + lam * z

    return F


def solve_root(
    spec: OperatorSpec, data, lam: float, iters: int = 50, tol: float = 1e-14,
    device=None,
) -> np.ndarray:
    """Newton root-finder on the mean operator. Exact for affine operators."""
    dev = resolve_device(device)
    F = mean_operator(spec, data, lam, dev)
    D = data.d + spec.tail_dim
    z = torch.zeros((D,), dtype=torch.as_tensor(data.val).dtype, device=dev)
    jac = torch.func.jacfwd(F)
    for _ in range(iters):
        r = F(z)
        if float(torch.linalg.norm(r)) < tol:
            break
        z = z - torch.linalg.solve(jac(z), r)
    return z.cpu().numpy()


def objective(spec: OperatorSpec, data, lam: float, device=None):
    """Primal objective f(z) (ridge/logistic) or the saddle value (AUC/bilinear)."""
    dev = resolve_device(device)
    feats = torch.as_tensor(data.dense().reshape(-1, data.d), device=dev)
    labels = torch.as_tensor(data.y.reshape(-1), device=dev)
    p = spec.p

    def f(z):
        head = z[: data.d]
        u = feats @ head
        if spec.kind == "ridge":
            loss = 0.5 * torch.mean((u - labels) ** 2)
            return loss + 0.5 * lam * torch.sum(z * z)
        if spec.kind == "logistic":
            loss = torch.mean(torch.log1p(torch.exp(-labels * u)))
            return loss + 0.5 * lam * torch.sum(z * z)
        if spec.kind == "auc":
            a, b, th = z[data.d], z[data.d + 1], z[data.d + 2]
            pos = labels > 0
            val = (
                -p * (1 - p) * th**2
                + torch.mean(
                    torch.where(pos, (1 - p) * (u - a) ** 2, p * (u - b) ** 2)
                )
                + torch.mean(
                    2 * (1 + th) * torch.where(pos, -(1 - p) * u, p * u)
                )
            )
            return val + 0.5 * lam * torch.sum(z * z)
        if spec.kind == "bilinear":
            th = z[data.d]
            val = (
                torch.mean(0.5 * (u - labels) ** 2 + th * labels * u)
                - 0.5 * spec.gamma * th**2
            )
            head_sq = torch.sum(z[: data.d] ** 2)
            return val + 0.5 * lam * head_sq - 0.5 * lam * th**2
        raise ValueError(spec.kind)

    return f


def auc_score(w: np.ndarray, data) -> float:
    """Exact pairwise AUC of linear scorer w on the pooled dataset."""
    feats = data.dense().reshape(-1, data.d)
    labels = data.y.reshape(-1)
    scores = feats @ w
    pos, neg = scores[labels > 0], scores[labels < 0]
    if len(pos) == 0 or len(neg) == 0:
        return float("nan")
    diff = pos[:, None] - neg[None, :]
    return float(((diff > 0).mean() + 0.5 * (diff == 0).mean()))
