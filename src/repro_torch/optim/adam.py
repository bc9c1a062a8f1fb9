"""AdamW (+ SGD-momentum) in float32 (counterpart of ``repro.optim.adam``).

State mirrors the parameters: a nested dict per moment. Global-norm
clipping, bias correction and decoupled weight decay are included; the
learning rate warms up linearly over ``warmup_steps``.

The JAX update is functional. This one writes the parameters and the
moments in place (under ``torch.no_grad``): a functional copy at
minitron-8b's width would hold a second set of parameters and moments.
Parameters and moments are float32: the JAX ``state_dtype`` option (bf16
moments for the 405B/1T configs) is not ported, and ``AdamConfig`` refuses
another dtype.
Each leaf is updated in chunks of ``_CHUNK`` elements, so the float32
temporaries of one update stay small whatever the leaf's size. The
arithmetic follows the JAX ``upd`` step by step, in float32:

    g = g * clip_scale;  mu = mu * b1 + (1 - b1) g;  nu = nu * b2 + (1 - b2) g g
    delta = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)   (sgdm: delta = mu)
    p = p - lr (delta + weight_decay p)
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.params import tree_leaves, tree_map

_CHUNK = 1 << 25  # elements per in-place pass (three float32 temporaries)


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    """Optimizer hyperparameters (the JAX ``AdamConfig``'s fields)."""

    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Any = torch.float32  # the only one taken here
    kind: str = "adamw"  # adamw | sgdm
    warmup_steps: int = 100

    def __post_init__(self):
        """Reject an unknown optimizer kind and a state dtype not ported."""
        if self.kind not in ("adamw", "sgdm"):
            raise ValueError(f"kind={self.kind!r} not in ('adamw', 'sgdm')")
        if self.state_dtype != torch.float32:
            raise NotImplementedError(
                f"state_dtype={self.state_dtype}: only float32 optimizer state is ported "
                "(the bf16 moments of the 405B/1T configs are not)"
            )

    def lr_at(self, step) -> float:
        """Learning rate at `step` (0-based): linear warmup to ``lr``."""
        return self.lr * min(1.0, (int(step) + 1) / max(1, self.warmup_steps))


def adam_init(cfg: AdamConfig, params) -> dict:
    """Zero float32 moments shaped like `params`, on their devices."""
    def zeros(_, p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    if cfg.kind == "sgdm":
        return {"mu": tree_map(zeros, params)}
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in float32 (a 0-d tensor)."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32) for g in tree_leaves(tree)]
    return torch.stack(norms).square().sum().sqrt()


def _flat(t: torch.Tensor, what: str) -> torch.Tensor:
    if t.dtype != torch.float32:
        raise ValueError(f"{what} is {t.dtype}; the update is written in place in float32")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous to be updated in place")
    return t.view(-1)


def _update_chunk(cfg, p, g, mu, nu, scale, lr, bc1, bc2):
    """One chunk of one leaf, in place (the JAX ``upd``); p, mu, nu float32."""
    g = g.float() * scale
    mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    if cfg.kind == "sgdm":
        delta = mu.clone()
    else:
        nu.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        del g
        den = torch.div(nu, bc2).sqrt_().add_(cfg.eps)
        delta = torch.div(mu, bc1).div_(den)
        del den
    delta.add_(p, alpha=cfg.weight_decay)
    p.sub_(delta, alpha=lr)


def adam_update(cfg: AdamConfig, params, grads, opt_state, step):
    """One optimizer step, written in place into `params` and `opt_state`.

    `step` is the 0-based step count (an int or a 0-d tensor). Returns
    (params, opt_state, metrics) as the JAX function does; the first two
    are the objects passed in, updated.
    """
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-12), max=1.0)
    lr = cfg.lr_at(step)
    t = int(step) + 1
    bc1, bc2 = 1 - cfg.b1 ** t, 1 - cfg.b2 ** t
    sgdm = cfg.kind == "sgdm"

    def one(path, p, g, mu, nu=None):
        name = "/".join(path)
        if g.shape != p.shape:
            raise ValueError(f"{name}: grad {tuple(g.shape)} != param {tuple(p.shape)}")
        fp, fg = _flat(p, name), g.reshape(-1)
        fmu = _flat(mu, f"mu {name}")
        fnu = None if sgdm else _flat(nu, f"nu {name}")
        for lo in range(0, fp.numel(), _CHUNK):
            sl = slice(lo, lo + _CHUNK)
            _update_chunk(cfg, fp[sl], fg[sl], fmu[sl], None if sgdm else fnu[sl],
                          scale, lr, bc1, bc2)

    with torch.no_grad():
        if sgdm:
            tree_map(one, params, grads, opt_state["mu"])
        else:
            tree_map(one, params, grads, opt_state["mu"], opt_state["nu"])
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
