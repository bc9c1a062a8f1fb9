"""Training step: CE loss, microbatch accumulation, AdamW (counterpart of
``repro.train.step``).

The single-replica step on one device: ``local_grads`` runs the model
forward and ``torch.autograd`` backward (attention's gradient through the
``flash_attention`` Function: the CUDA backward kernels on the card, their
plain version on the CPU), ``adam_update`` writes the new parameters and
moments in place. Nothing here changes with the kernel routing; it is all
in ``ModelConfig`` (``attention_kernel``), as in the JAX package.

The mesh tools of the JAX module (``make_train_state_defs``,
``batch_specs``, ``make_jitted_train_step``: FSDP x TP over a device mesh)
raise ``NotImplementedError``: the sharded step is ROADMAP Queue 1 items
10 and 14.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer and microbatches per step. The JAX ``batch_axes`` (the
    batch's mesh axes) has no counterpart: the step shards nothing (ROADMAP
    Queue 1 items 10 and 14)."""

    optimizer: AdamConfig = AdamConfig()
    microbatches: int = 1  # gradient accumulation steps per train_step


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def ce_loss(logits: torch.Tensor, targets: torch.Tensor, mask=None) -> torch.Tensor:
    """Token-mean cross-entropy in float32. logits (B, S, V), targets (B, S)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, targets.long()[..., None], dim=-1)[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def loss_fn(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """CE loss of the model's logits on ``batch`` (tokens, targets[, mask])."""
    logits = T.forward(cfg, params, batch["tokens"])
    return ce_loss(logits, batch["targets"], batch.get("mask"))


def _on_device(batch, device) -> dict:
    """The batch's arrays (numpy or torch) as tensors on `device`."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _value_and_grad(cfg, params, batch):
    """(loss, grads) of one batch; grads in the parameters' dtypes."""
    live = tree_map(lambda _, t: t.detach().requires_grad_(), params)
    loss = loss_fn(cfg, live, batch)
    grads = iter(torch.autograd.grad(loss, tree_leaves(live), materialize_grads=True))
    return loss.detach(), tree_map(lambda _, t: next(grads), live)


def local_grads(cfg: ModelConfig, tc: TrainConfig, params, batch):
    """(loss, grads), accumulating ``tc.microbatches`` slices of the batch.

    As in the JAX package: one microbatch is a plain value-and-grad; more
    split the batch on its first axis and sum loss / mb and grads / mb
    (float32) in a Python loop, where the JAX package scans.
    """
    batch = _on_device(batch, tree_leaves(params)[0].device)
    if tc.microbatches <= 1:
        return _value_and_grad(cfg, params, batch)
    mb = tc.microbatches
    n = next(iter(batch.values())).shape[0]
    if n % mb:
        raise ValueError(f"batch of {n} rows does not split into {mb} microbatches")
    split = {k: v.reshape(mb, n // mb, *v.shape[1:]) for k, v in batch.items()}
    loss = torch.zeros((), dtype=torch.float32, device=split["tokens"].device)
    grads = tree_map(lambda _, p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                     params)
    for i in range(mb):
        l_i, g_i = _value_and_grad(cfg, params, {k: v[i] for k, v in split.items()})
        loss = loss + l_i / mb
        tree_map(lambda _, acc, g: acc.add_(g.div_(mb)), grads, g_i)
    return loss, grads


# ---------------------------------------------------------------------------
# state + step
# ---------------------------------------------------------------------------

def _mesh_tool(name: str):
    def raiser(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is a mesh tool (FSDP x TP sharding of the train state); the "
            "sharded step is not ported (ROADMAP Queue 1 items 10 and 14)"
        )

    raiser.__name__ = name
    raiser.__doc__ = f"Not ported: {name} shards the step over a mesh (Queue 1 items 10, 14)."
    return raiser


make_train_state_defs = _mesh_tool("make_train_state_defs")
batch_specs = _mesh_tool("batch_specs")
make_jitted_train_step = _mesh_tool("make_jitted_train_step")


def init_train_state(cfg: ModelConfig, tc: TrainConfig, seed: int = 0, device=None) -> dict:
    """{'params', 'opt', 'step'}: float32 master parameters drawn from `seed`
    on `device` (the card unless told otherwise), zero moments, and the step
    count as a 0-d int32 tensor on the host."""
    params = T.init_train_params(cfg, seed, device)
    return {
        "params": params,
        "opt": adam_init(tc.optimizer, params),
        "step": torch.zeros((), dtype=torch.int32),
    }


def train_step(cfg: ModelConfig, tc: TrainConfig, state: dict, batch) -> tuple[dict, dict]:
    """One optimizer step. Returns (new_state, metrics); the parameters and
    moments of `state` are updated in place and carried into new_state."""
    loss, grads = local_grads(cfg, tc, state["params"], batch)
    params, opt, metrics = adam_update(
        tc.optimizer, state["params"], grads, state["opt"], state["step"]
    )
    metrics["loss"] = loss
    return {"params": params, "opt": opt, "step": state["step"] + 1}, metrics
