"""AdamW (+ SGD-momentum) with a configurable state dtype (counterpart of
``repro.optim.adam``).

State mirrors the parameters: a nested dict per moment, each leaf in
``AdamConfig.state_dtype`` (float32, or bf16 for the 405B/1T configs).
Global-norm clipping, bias correction and decoupled weight decay are
included; the learning rate warms up linearly over ``warmup_steps``.

The JAX update is functional. This one writes the parameters and the
moments in place (under ``torch.no_grad``): a functional copy at
minitron-8b's width would hold a second set of parameters and moments.
Each leaf is updated in chunks of ``_CHUNK`` elements, whatever its dtype:
the chunk of p, mu and nu is upcast to float32, updated, and written back
with ``copy_`` (round to nearest even, as JAX's ``astype``), so the float32
temporaries of one update stay small whatever the leaf's size (a
whole-leaf float32 copy of llama3-405b's embedding would be 8.4 GB). The
arithmetic follows the JAX ``upd`` step by step, in float32:

    g = g * clip_scale;  mu32 = mu * b1 + (1 - b1) g;  nu32 = nu * b2 + (1 - b2) g g
    delta = (mu32 / (1 - b1^t)) / (sqrt(nu32 / (1 - b2^t)) + eps)   (sgdm: delta = mu32)
    p = p - lr (delta + weight_decay p);  mu = mu32;  nu = nu32

The new parameter is computed from the unrounded mu32 and nu32; only the
stored moments are rounded to ``state_dtype``.

On a rank of the within-pod sharded step the leaves are the rank's blocks
and the clipping norm is the global one: ``shard_sum_of_squares`` sums the
squares of the leaves this rank counts (a leaf replicated over a mesh axis
is counted by the axis' rank 0 only, so every element counts once), the
step sums that over the mesh and passes ``grad_norm`` in; the update stays
elementwise on the blocks.
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
    state_dtype: Any = torch.float32  # bf16 for the 405B/1T configs
    kind: str = "adamw"  # adamw | sgdm
    warmup_steps: int = 100

    def __post_init__(self):
        """Reject an unknown optimizer kind."""
        if self.kind not in ("adamw", "sgdm"):
            raise ValueError(f"kind={self.kind!r} not in ('adamw', 'sgdm')")

    def lr_at(self, step) -> float:
        """Learning rate at `step` (0-based): linear warmup to ``lr``."""
        return self.lr * min(1.0, (int(step) + 1) / max(1, self.warmup_steps))


def adam_init(cfg: AdamConfig, params) -> dict:
    """Zero moments in ``cfg.state_dtype`` shaped like `params`, on their devices."""
    def zeros(_, p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    if cfg.kind == "sgdm":
        return {"mu": tree_map(zeros, params)}
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}


def sum_of_squares(tree) -> torch.Tensor:
    """The sum of squares over every leaf, in float32 (a 0-d tensor): the
    squared leaf norms summed, ``global_norm`` before its root."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32) for g in tree_leaves(tree)]
    return torch.stack(norms).square().sum()


def shard_sum_of_squares(tree, counted) -> torch.Tensor:
    """The sum of squares, in float32, over the leaves of `tree` whose entry
    in `counted` (a tree of bools) is true: a rank's share of the global
    squared norm. A 0-d zero when it counts none."""
    norms = [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g, c in zip(tree_leaves(tree), tree_leaves(counted)) if c]
    if not norms:
        return torch.zeros((), dtype=torch.float32, device=tree_leaves(tree)[0].device)
    return torch.stack(norms).square().sum()


def global_norm(tree) -> torch.Tensor:
    """sqrt(sum of squares) over every leaf, in float32 (a 0-d tensor)."""
    return sum_of_squares(tree).sqrt()


def _flat(t: torch.Tensor, what: str) -> torch.Tensor:
    if not t.is_floating_point():
        raise ValueError(f"{what} is {t.dtype}; the update needs a floating-point leaf")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous to be updated in place")
    return t.view(-1)


def _f32(t: torch.Tensor) -> torch.Tensor:
    """`t` itself when float32 (updated in place), else a float32 copy."""
    return t if t.dtype == torch.float32 else t.float()


def _store(dst: torch.Tensor, src: torch.Tensor) -> None:
    """Write the float32 result `src` into `dst` (rounded to its dtype)."""
    if src is not dst:
        dst.copy_(src)


def _update_chunk(cfg, p, g, mu, nu, scale, lr, bc1, bc2):
    """One chunk of one leaf, in place (the JAX ``upd``), in float32."""
    g = g.float() * scale
    mu32 = _f32(mu).mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    _store(mu, mu32)
    if cfg.kind == "sgdm":
        delta = mu32.clone()
    else:
        nu32 = _f32(nu).mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
        _store(nu, nu32)
        del g
        den = torch.div(nu32, bc2).sqrt_().add_(cfg.eps)
        del nu32
        delta = torch.div(mu32, bc1).div_(den)
        del den
    del mu32
    p32 = _f32(p)
    delta.add_(p32, alpha=cfg.weight_decay)
    _store(p, p32.sub_(delta, alpha=lr))


def adam_update(cfg: AdamConfig, params, grads, opt_state, step, grad_norm=None):
    """One optimizer step, written in place into `params` and `opt_state`.

    `step` is the 0-based step count (an int or a 0-d tensor). `grad_norm`
    (a 0-d float32 tensor) is the clipping norm when the leaves are blocks
    of a sharded state; by default ``global_norm(grads)``. Returns (params,
    opt_state, metrics) as the JAX function does; the first two are the
    objects passed in, updated.
    """
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
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
