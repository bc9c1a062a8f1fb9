"""Monotone operators and their resolvents (port of ``repro.core.operators``).

Component operators with a linear predictor decompose as

    B(z) = g(u, y) * x  (+)  tail(u, z_tail)          u = x^T z_head

with ``x`` the sparse feature row, ``g`` a scalar coefficient and ``tail`` a
small dense block (empty for ridge/logistic, (a, b, theta) for AUC, theta
for the bilinear saddle family). Every function works elementwise on
tensors of per-node scalars: shape (N,) for u, s, y, xsq and (N, t) for
tails. ``a_eff`` is a Python float or an (N,) tensor (per-node lam).

Resolvents (see the JAX module for the derivations):
  ridge     closed form
  logistic  1-D Newton, 20 iterations (a Python loop over (N,) tensors)
  auc       4x4 linear solve, batched over the N nodes
  bilinear  2x2 closed form

The expressions keep the JAX module's operation order, so float64 results
agree to rounding.
"""
from __future__ import annotations

import dataclasses

import torch

NEWTON_ITERS = 20  # paper: "20 newton iteration is sufficient for DSBA"


def ridge_coeff(u, y):
    """B(z) = (x^T z - y) x."""
    return u - y


def logistic_coeff(u, y):
    """B(z) = -y / (1 + exp(y * x^T z)) * x."""
    return -y / (1.0 + torch.exp(y * u))


def logistic_coeff_prime(u, y):
    """d/du of `logistic_coeff` (the Newton denominator of eq. 73)."""
    e = logistic_coeff(u, y)
    return -y * e - e * e


def bilinear_coeff_and_tail(u, y, tail, gamma):
    """Returns (g, tail_out): B(z) = g*x (+) tail_out over (theta,)."""
    theta = tail[..., 0]
    g = (u - y) + theta * y
    tt = gamma * theta - y * u
    return g, tt[..., None]


def bilinear_resolvent(s, psi_tail, y, gamma, a_eff, xsq):
    """Closed-form 2x2 resolvent: solve v + a_eff * B(v) = (s, psi_theta)."""
    psi_th = psi_tail[..., 0]
    a11 = 1.0 + a_eff * xsq
    a12 = a_eff * xsq * y
    a21 = -a_eff * y
    a22 = 1.0 + a_eff * gamma
    r1 = s + a_eff * xsq * y
    r2 = psi_th
    det = a11 * a22 - a12 * a21
    u = (a22 * r1 - a12 * r2) / det
    theta = (a11 * r2 - a21 * r1) / det
    g, _ = bilinear_coeff_and_tail(u, y, theta[..., None], gamma)
    return g, theta[..., None]


def ridge_resolvent_coeff(s, y, a_eff, xsq):
    """Closed-form scalar resolvent of the ridge operator (Section 7.1)."""
    u = (s + a_eff * y * xsq) / (1.0 + a_eff * xsq)
    return ridge_coeff(u, y)


def logistic_resolvent_coeff(s, y, a_eff, xsq):
    """Newton iteration of eq. (73) generalized to ||x||^2 = xsq."""
    u = torch.zeros_like(s)
    for _ in range(NEWTON_ITERS):
        e = logistic_coeff(u, y)
        f = u + a_eff * xsq * e - s
        fp = 1.0 + a_eff * xsq * logistic_coeff_prime(u, y)
        u = u - f / fp
    return logistic_coeff(u, y)


def auc_coeff_and_tail(u, y, tail, p):
    """Returns (g, tail_out): B(z) = g*x (+) tail_out over (a, b, theta)."""
    a, b, theta = tail[..., 0], tail[..., 1], tail[..., 2]
    pos = y > 0
    g_pos = 2.0 * (1.0 - p) * ((u - a) - (1.0 + theta))
    g_neg = 2.0 * p * ((u - b) + (1.0 + theta))
    g = torch.where(pos, g_pos, g_neg)
    ta = torch.where(pos, -2.0 * (1.0 - p) * (u - a), 0.0)
    tb = torch.where(pos, 0.0, -2.0 * p * (u - b))
    tt = 2.0 * p * (1.0 - p) * theta + torch.where(
        pos, 2.0 * (1.0 - p) * u, -2.0 * p * u
    )
    return g, torch.stack([ta, tb, tt], dim=-1)


def auc_resolvent(s, psi_tail, y, p, a_eff, xsq):
    """Solve the 4x4 system (eqs. 77-82) for every node at once.

    Solves v + a_eff * B(v) = rhs in v = (u, a, b, theta) with
    rhs = (s, psi_a, psi_b, psi_th). Returns (g, tail_solution).
    ``torch.linalg.solve_ex`` keeps the solve free of a host sync (the
    systems are diagonally dominant, never singular).
    """
    a_eff = torch.as_tensor(a_eff, dtype=s.dtype, device=s.device).expand(s.shape)
    xsq = torch.as_tensor(xsq, dtype=s.dtype, device=s.device).expand(s.shape)
    beta_p = (1.0 - p) * a_eff
    beta_n = p * a_eff
    pos = y > 0
    zero = torch.zeros_like(s)
    one = torch.ones_like(s)
    corner = 1.0 + 2.0 * p * (1.0 - p) * a_eff
    mat_pos = torch.stack([
        torch.stack([1.0 + 2.0 * beta_p * xsq, -2.0 * beta_p * xsq, zero,
                     -2.0 * beta_p * xsq], -1),
        torch.stack([-2.0 * beta_p, 1.0 + 2.0 * beta_p, zero, zero], -1),
        torch.stack([zero, zero, one, zero], -1),
        torch.stack([2.0 * beta_p, zero, zero, corner], -1),
    ], -2)
    mat_neg = torch.stack([
        torch.stack([1.0 + 2.0 * beta_n * xsq, zero, -2.0 * beta_n * xsq,
                     2.0 * beta_n * xsq], -1),
        torch.stack([zero, one, zero, zero], -1),
        torch.stack([-2.0 * beta_n, zero, 1.0 + 2.0 * beta_n, zero], -1),
        torch.stack([-2.0 * beta_n, zero, zero, corner], -1),
    ], -2)
    mat = torch.where(pos[..., None, None], mat_pos, mat_neg)
    rhs0 = torch.where(pos, s + 2.0 * beta_p * xsq, s - 2.0 * beta_n * xsq)
    rhs = torch.cat([rhs0[..., None], psi_tail.to(s.dtype)], dim=-1)
    sol = torch.linalg.solve_ex(mat, rhs[..., None])[0][..., 0]
    u, tail = sol[..., 0], sol[..., 1:]
    g, _ = auc_coeff_and_tail(u, y, tail, p)
    return g, tail


#: operator families ("problem families" in solver capability records)
FAMILIES = ("ridge", "logistic", "auc", "bilinear")

_TAIL_DIMS = {"ridge": 0, "logistic": 0, "auc": 3, "bilinear": 1}


@dataclasses.dataclass(frozen=True)
class OperatorSpec:
    """A family of component operators B_{n,i} with linear predictors.

    tail_dim: trailing dense coordinates of z (3 for AUC, 1 for bilinear).
    p: positive-class ratio (AUC only).
    gamma: dual strong-concavity modulus (bilinear only).
    """

    kind: str  # 'ridge' | 'logistic' | 'auc' | 'bilinear'
    p: float = 0.5
    gamma: float = 1.0

    @property
    def tail_dim(self) -> int:
        """Trailing dense coordinates of z (the non-predictor block)."""
        return _TAIL_DIMS[self.kind]

    def coeff_and_tail(self, u, y, tail):
        """g and tail-output of B at predictor value u, tail coords `tail`."""
        if self.kind == "ridge":
            return ridge_coeff(u, y), torch.zeros_like(tail)
        if self.kind == "logistic":
            return logistic_coeff(u, y), torch.zeros_like(tail)
        if self.kind == "auc":
            return auc_coeff_and_tail(u, y, tail, self.p)
        if self.kind == "bilinear":
            return bilinear_coeff_and_tail(u, y, tail, self.gamma)
        raise ValueError(self.kind)

    def resolvent_coeff_and_tail(self, s, psi_tail, y, a_eff, xsq):
        """Solve z + a_eff*B(z) = psi in scalar coordinates.

        Returns (g_at_solution, tail_solution). The caller reconstructs
        z_head = psi_head - a_eff * g * x and z_tail = tail_solution.
        """
        if self.kind == "ridge":
            return ridge_resolvent_coeff(s, y, a_eff, xsq), psi_tail
        if self.kind == "logistic":
            return logistic_resolvent_coeff(s, y, a_eff, xsq), psi_tail
        if self.kind == "auc":
            return auc_resolvent(s, psi_tail, y, self.p, a_eff, xsq)
        if self.kind == "bilinear":
            return bilinear_resolvent(s, psi_tail, y, self.gamma, a_eff, xsq)
        raise ValueError(self.kind)
