"""Training step: CE loss, microbatch accumulation, AdamW (counterpart of
``repro.train.step``).

The single-replica step on one device: ``local_grads`` runs the model
forward and ``torch.autograd`` backward (attention's gradient through the
``flash_attention`` Function: the CUDA backward kernels on the card, their
plain version on the CPU; or through the blockwise loop under
``cfg.blockwise_attention``), ``adam_update`` writes the new parameters and
moments in place. Nothing here changes with the kernel routing, the remat
policy or the attention route; it is all in ``ModelConfig``
(``attention_kernel``, ``remat``, ``blockwise_attention``), as in the JAX
package.

Dtypes, as in the JAX package: the parameters are held in
``cfg.param_dtype`` (float32 masters, or bf16 for llama3-405b and kimi-k2)
and the moments in ``TrainConfig.optimizer.state_dtype``. With one
microbatch the gradients come back in the parameters' dtype; with more
they are accumulated in float32. The update computes in float32 either way
and rounds each result to its leaf's dtype.

The within-pod sharded step, the JAX ``make_jitted_train_step`` (FSDP over
"data" x TP over "model", the batch over "data"), runs over the ranks of a
``launch.mesh.GridMesh`` (``train.sharded``): ``make_train_state_defs``
and ``batch_specs`` give the layouts as ``models.params.PartitionSpec``s,
``make_jitted_train_step(mesh, cfg, tc)`` the step over a
``RankTrainState``, and ``init_train_state(..., mesh=)`` places a fresh
state on the ranks. Under a rank's grid ``ce_loss`` is vocab-parallel and
returns the rank's share of the global token mean.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import P, TensorSpec, tree_leaves, tree_map, tree_pspecs
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer, microbatches per step and the batch's mesh axes (the
    sharded step splits the batch's rows over them)."""

    optimizer: AdamConfig = AdamConfig()
    microbatches: int = 1  # gradient accumulation steps per train_step
    batch_axes: tuple[str, ...] = ("data",)  # ('pod','data') for sync multipod


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def ce_loss(logits: torch.Tensor, targets: torch.Tensor, mask=None) -> torch.Tensor:
    """Token-mean cross-entropy in float32. logits (B, S, V), targets (B, S).

    Under a grid (``layers.use_constraint_mesh``) `logits` are this rank's
    vocabulary block and its rows the rank's data shard: the max and the
    sum of exponentials are reduced over "model", the target's logit comes
    from the rank whose block holds it, and the result is the rank's share
    of the global mean: its tokens' sum over the global token count (the
    mask's sum all-reduced over "data", never a mean of shard means)."""
    grid = L.current_grid()
    if grid is not None:
        return _grid_ce_loss(grid, logits, targets, mask)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.take_along_dim(logits, targets.long()[..., None], dim=-1)[..., 0]
    nll = lse - ll
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _grid_ce_loss(grid, logits, targets, mask) -> torch.Tensor:
    logits = logits.float()
    v = logits.shape[-1]
    m = grid.model.all_max(logits.detach().amax(-1))
    lse = torch.log(grid.model.reduce_from(torch.exp(logits - m[..., None]).sum(-1))) + m
    local = targets.long() - grid.vocab_offset(v)
    mine = (local >= 0) & (local < v)
    ll = torch.take_along_dim(logits, torch.where(mine, local, 0)[..., None], dim=-1)[..., 0]
    nll = lse - grid.model.reduce_from(ll * mine)
    if mask is None:
        return nll.sum() / (nll.numel() * grid.data.size)
    mask = mask.float()
    count = grid.data.all_reduce(mask.sum().detach())
    return (nll * mask).sum() / torch.clamp(count, min=1.0)


def loss_fn(cfg: ModelConfig, params, batch) -> torch.Tensor:
    """CE loss of the model's logits on ``batch`` (tokens, targets[, mask];
    the encdec family's enc_embeds)."""
    logits = T.forward(cfg, params, batch["tokens"], enc_embeds=batch.get("enc_embeds"))
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

def make_train_state_defs(cfg: ModelConfig, tc: TrainConfig):
    """(TensorSpec tree, PartitionSpec tree) of {'params', 'opt': {'mu'[,
    'nu']}, 'step'}, the JAX function's: parameters in ``cfg.param_dtype``
    laid out by ``LOGICAL_RULES``, moments in the optimizer's state dtype
    laid out as the parameters, the step replicated."""
    defs = T.model_defs(cfg)
    p_sds = tree_map(lambda _, d: TensorSpec(d.shape, cfg.param_dtype), defs)
    p_spec = tree_pspecs(defs)
    st_dt = tc.optimizer.state_dtype
    o_sds = {"mu": tree_map(lambda _, d: TensorSpec(d.shape, st_dt), defs)}
    o_spec = {"mu": p_spec}
    if tc.optimizer.kind != "sgdm":
        o_sds["nu"] = tree_map(lambda _, d: TensorSpec(d.shape, st_dt), defs)
        o_spec["nu"] = p_spec
    sds = {"params": p_sds, "opt": o_sds, "step": TensorSpec((), torch.int32)}
    spec = {"params": p_spec, "opt": o_spec, "step": P()}
    return sds, spec


def batch_specs(cfg: ModelConfig, tc: TrainConfig) -> dict:
    """The batch's layout: rows over ``tc.batch_axes``."""
    b = P(tc.batch_axes)
    spec = {"tokens": b, "targets": b}
    if cfg.family == "encdec":
        spec["enc_embeds"] = P(tc.batch_axes, None, None)
    return spec


def batch_sds(cfg: ModelConfig, batch: int, seq: int) -> dict:
    """TensorSpecs of a (batch, seq) train batch (int32 tokens and targets;
    the encdec family's frames in the compute dtype)."""
    out = {"tokens": TensorSpec((batch, seq), torch.int32),
           "targets": TensorSpec((batch, seq), torch.int32)}
    if cfg.family == "encdec":
        out["enc_embeds"] = TensorSpec((batch, cfg.encoder_len, cfg.d_model), cfg.compute_dtype)
    return out


def make_jitted_train_step(mesh, cfg: ModelConfig, tc: TrainConfig):
    """The sharded step on the ranks of `mesh` (a ``GridMesh`` with "data"
    and "model" axes): ``step(handle, batch, check=False) -> (handle,
    metrics)`` over a ``RankTrainState`` (``train.sharded``)."""
    from repro_torch.train import sharded

    return sharded.make_step(mesh, cfg, tc)


def init_train_state(cfg: ModelConfig, tc: TrainConfig, seed: int = 0, device=None,
                     mesh=None):
    """{'params', 'opt', 'step'}: parameters in ``cfg.param_dtype`` drawn
    from `seed` on `device` (the card unless told otherwise), zero moments in
    ``tc.optimizer.state_dtype``, and the step count as a 0-d int32 tensor
    on the host.

    With a `mesh` (a ``GridMesh``) each rank draws the whole parameters
    from `seed` on its device, keeps its block of every leaf and frees the
    rest; the caller gets a ``train.sharded.RankTrainState``."""
    if mesh is not None:
        from repro_torch.train import sharded

        return sharded.init_state(mesh, cfg, tc, seed, device)
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
