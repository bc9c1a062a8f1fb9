"""Model assembly for the dense and ssm families (counterpart of
``repro.models.transformer``).

Public API, as in the JAX package:
  model_defs(cfg)                      -> ParamDef tree
  init_params(cfg, seed, device)       -> serving parameters drawn on the device
  init_train_params(cfg, seed, device) -> training (float32 master) parameters
  forward(cfg, params, tokens)         -> logits            (train / scoring)
  cache_defs / init_cache              -> contiguous decode cache
  prefill(cfg, params, tok, cache)     -> (cache, logits at valid_len - 1)
  decode_step(cfg, params, tok, cache) -> (cache, logits)
Serving API (the paged twin, driven by ``repro_torch.serve``):
  paged_cache_defs(cfg, max_batch, n_blocks, block_size, n_pages)
  decode_step_paged(cfg, params, tok, pools, table, lengths)
                                       -> (pools, logits)

Families: ``dense`` (attention + MLP blocks; gemma2's local/global
alternation) and ``ssm`` (Mamba2 blocks, ``models.ssm``: the SSD
within-chunk part through the registry's ``ssd_chunk`` under
``cfg.ssm_kernel``). An ssm cache is length-independent: per layer a
recurrent state and a conv history, with no position; the serving pool
holds them per slot, and its decode step is the contiguous recurrent step.

Parameters are a nested dict of tensors laid out as the JAX tree: layers
stacked on axis 0 under ``blocks``; a Python loop over layers takes the
place of ``lax.scan`` (each layer reads views of them, ``_layers``). Every
layer casts a weight to ``cfg.compute_dtype`` where it uses it, as the JAX
package does. ``init_params`` (serving) stores the matrix weights in
``cfg.compute_dtype`` at once, so the cast is free and the bits are the
same; the leaves the JAX package reads in float32 stay in
``cfg.param_dtype`` (see ``storage_dtype``). ``init_train_params`` holds
every leaf in ``cfg.param_dtype``, as the JAX train state does, and the
gradient flows back through the casts to those master weights.

Training runs each layer of ``forward`` under activation checkpointing
(``torch.utils.checkpoint``, non-reentrant) unless ``cfg.remat`` is
``"none"``: ``"full"`` saves each layer's input and recomputes the layer in
the backward pass. The JAX ``"dots"`` policy (also save the matmul
outputs) runs as ``"full"`` here: the gradients are the same, only the
memory/recompute trade differs.

Caches are updated in place: the contiguous cache's K/V (or SSM state and
conv) tensors and the paged pools are allocated once and written by
indexed assignment, where the JAX package returns updated copies. The
dense cache position ``pos`` is a host integer.

The moe, hybrid and encdec families raise ``NotImplementedError`` (ROADMAP
Queue 1 item 12).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, TensorSpec, tree_map, tree_materialize

FAMILIES = ("dense", "ssm")


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported; the {FAMILIES} "
            "families run (ROADMAP Queue 1 item 12)"
        )


# ---------------------------------------------------------------------------
# param defs
# ---------------------------------------------------------------------------

def _stack(defs: dict, n: int) -> dict:
    """Prepend a 'layers' axis of size n to every ParamDef leaf."""
    return tree_map(
        lambda _, d: ParamDef((n, *d.shape), ("layers", *d.axes), d.init, d.scale),
        defs,
    )


def _block_defs(cfg: ModelConfig) -> dict:
    return {
        "ln1": L.rms_norm_def(cfg.d_model),
        "attn": L.attention_defs(cfg),
        "ln2": L.rms_norm_def(cfg.d_model),
        "mlp": L.mlp_defs(cfg),
    }


def _ssm_block_defs(cfg: ModelConfig) -> dict:
    return {"ln": L.rms_norm_def(cfg.d_model), "ssm": S.ssm_defs(cfg)}


def model_defs(cfg: ModelConfig) -> dict:
    """The ParamDef tree of the model (the JAX tree of its family)."""
    _require_ported(cfg)
    d = cfg.d_model
    defs: dict[str, Any] = {
        "embed": ParamDef((cfg.vocab_size, d), ("vocab", "embed"), scale=1.0),
        "final_norm": L.rms_norm_def(d),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, cfg.vocab_size), ("embed", "vocab"))
    blk = _block_defs(cfg) if cfg.family == "dense" else _ssm_block_defs(cfg)
    defs["blocks"] = _stack(blk, cfg.n_layers)
    return defs


def storage_dtype(cfg: ModelConfig):
    """``path -> dtype`` each parameter is held in.

    ``param_dtype`` for the leaves the JAX package reads in float32 or
    gathers: ``embed``, the norm scales (``ln1``, ``ln2``, ``ln``,
    ``final_norm``; ``layers.rms_norm`` casts the scale to float32), the
    SSM gated norm's ``norm`` and the SSM's ``dt_bias``, ``A_log`` and
    ``D`` (``models.ssm`` reads them ``.float()``, never in the compute
    dtype). Every other leaf is a weight read only as
    ``w.astype(compute_dtype)``, so it is held in ``compute_dtype``.
    """
    keep = {"embed", "ln1", "ln2", "ln", "final_norm", "norm", "dt_bias", "A_log", "D"}

    def rule(path: tuple[str, ...]):
        return cfg.param_dtype if path[-1] in keep else cfg.compute_dtype

    return rule


def _generator(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed) if dev.type != "meta" else None


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random serving parameters drawn on `device` (the card unless told
    otherwise), each leaf held in ``storage_dtype(cfg)``."""
    dev = resolve_device(device)
    return tree_materialize(model_defs(cfg), _generator(dev, seed), cfg.param_dtype, dev,
                            storage_dtype(cfg))


def init_train_params(cfg: ModelConfig, seed: int = 0, device=None) -> dict:
    """Random training parameters: every leaf in ``cfg.param_dtype`` (the JAX
    ``tree_materialize(defs, key, cfg.param_dtype)``), the same draws as
    ``init_params`` before its storage cast."""
    dev = resolve_device(device)
    return tree_materialize(model_defs(cfg), _generator(dev, seed), cfg.param_dtype, dev)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _layer_windows(cfg: ModelConfig) -> tuple[int | None, ...]:
    """Window of each layer, repeating with this period (the JAX pair scan).

    gemma2-style alternation (``local_global``) gives layer pairs: a local
    (``sliding_window``) then a global (None) layer.
    """
    if cfg.local_global and cfg.sliding_window:
        if cfg.n_layers % 2:
            raise ValueError("local_global needs an even number of layers")
        return (cfg.sliding_window, None)
    return (cfg.sliding_window,)


def _layers(blocks: dict, n: int) -> list[dict]:
    """Every layer's parameters: views into the stacked tensors, one
    ``unbind`` a leaf. Its backward stacks the n layers' gradients once;
    taking ``t[i]`` per layer instead makes autograd add a full-size,
    zero-padded gradient for every layer: traffic quadratic in the depth."""
    per_leaf = tree_map(lambda _, t: t.unbind(0), blocks)
    return [tree_map(lambda _, u: u[i], per_leaf) for i in range(n)]


def _embed(cfg: ModelConfig, params, tokens):
    x = params["embed"][tokens]  # (B, S, d)
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return (x * scale).to(cfg.compute_dtype)


def _unembed(cfg: ModelConfig, params, x):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head.to(cfg.compute_dtype)).float()
    return L.softcap(logits, cfg.final_softcap)


def _dense_block(cfg: ModelConfig, p, x, positions, window, cache):
    h, new_cache = L.multi_head_attention(
        cfg, p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), positions,
        causal=True, window=window, cache=cache,
    )
    x = x + h
    x = x + L.mlp(cfg, p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps))
    return x, new_cache


def _remat_block(cfg, p, x, positions, window):
    """One cache-free layer under activation checkpointing (``cfg.remat``)."""
    def fn(x_in):
        return _dense_block(cfg, p, x_in, positions, window, None)[0]

    return torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)


def _ssm_layer(cfg: ModelConfig, p, x, cache, valid_len=None):
    h, new_cache = S.ssm_block(cfg, p["ssm"], L.rms_norm(x, p["ln"], cfg.norm_eps),
                               cache=cache, valid_len=valid_len)
    return x + h, new_cache


def _run_ssm_stack(cfg, blocks, x, caches, valid_len=None):
    """The layer loop of ``_scan_ssm_stack``. With a cache (contiguous, or
    the serving pools) each layer's state and conv history are read from
    ``caches[...][i]`` and the new ones written back in place. Without a
    cache and with grad mode on, each layer is checkpointed unless
    ``cfg.remat == "none"``."""
    remat = caches is None and cfg.remat != "none" and torch.is_grad_enabled()
    for i, p in enumerate(_layers(blocks, cfg.n_layers)):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                lambda x_in, p=p: _ssm_layer(cfg, p, x_in, None)[0], x, use_reentrant=False)
            continue
        cache = None if caches is None else {k: caches[k][i] for k in ("state", "conv")}
        x, new = _ssm_layer(cfg, p, x, cache, valid_len)
        if cache is not None:
            for k in ("state", "conv"):
                cache[k].copy_(new[k])
    return x, caches


def _run_stack(cfg, blocks, x, positions, caches):
    """The layer loop (``_scan_stack``), with an optional contiguous cache.
    Without a cache and with grad mode on, each layer is checkpointed
    unless ``cfg.remat == "none"``."""
    windows = _layer_windows(cfg)
    pos = caches["pos"] if caches is not None else None
    remat = caches is None and cfg.remat != "none" and torch.is_grad_enabled()
    for i, p in enumerate(_layers(blocks, cfg.n_layers)):
        window = windows[i % len(windows)]
        if remat:
            x = _remat_block(cfg, p, x, positions, window)
            continue
        cache = None
        if caches is not None:
            cache = {"k": caches["k"][i], "v": caches["v"][i], "pos": pos}
        x, _ = _dense_block(cfg, p, x, positions, window, cache)
    if caches is None:
        return x, None
    return x, {"k": caches["k"], "v": caches["v"], "pos": pos + positions.shape[1]}


# ---------------------------------------------------------------------------
# forward (scoring): full-sequence logits
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Logits (B, S, vocab) float32 of tokens (B, S); attention through
    ``flash_attention`` unless ``cfg.attention_kernel == "jnp"``, the SSD
    through ``ssd_chunk`` unless ``cfg.ssm_kernel == "jnp"``."""
    _require_ported(cfg)
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    if cfg.family == "ssm":
        x, _ = _run_ssm_stack(cfg, params["blocks"], x, None)
    else:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        x, _ = _run_stack(cfg, params["blocks"], x, positions, None)
    return _unembed(cfg, params, x)


# ---------------------------------------------------------------------------
# contiguous decode: cache defs + prefill + single-token step
# ---------------------------------------------------------------------------

def _ssm_stacked_defs(cfg: ModelConfig, batch: int) -> dict:
    """Every layer's ssm cache stacked on axis 0: {'state', 'conv'}."""
    return {k: TensorSpec((cfg.n_layers, *s.shape), s.dtype)
            for k, s in S.ssm_cache_defs(cfg, batch).items()}


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """TensorSpecs of the contiguous decode cache: dense K/V (``pos``, a
    host int, is added by ``init_cache``) or the ssm state and conv
    history, whose size does not depend on `max_len`."""
    _require_ported(cfg)
    if cfg.family == "ssm":
        return _ssm_stacked_defs(cfg, batch)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": TensorSpec(shape, cfg.compute_dtype),
            "v": TensorSpec(shape, cfg.compute_dtype)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """A zeroed contiguous cache on `device` (the card unless told otherwise)."""
    dev = resolve_device(device)
    out = {name: torch.zeros(s.shape, dtype=s.dtype, device=dev)
           for name, s in cache_defs(cfg, batch, max_len).items()}
    if cfg.family == "dense":
        out["pos"] = 0
    return out


def _stack_apply(cfg, params, tokens, cache, valid_len=None):
    _require_ported(cfg)
    x = _embed(cfg, params, tokens)
    if cfg.family == "ssm":  # the state summarises the past: no position
        x, new_cache = _run_ssm_stack(cfg, params["blocks"], x, cache, valid_len)
        return new_cache, x
    B, S = tokens.shape
    positions = cache["pos"] + torch.arange(S, device=tokens.device)[None].expand(B, S)
    x, new_cache = _run_stack(cfg, params["blocks"], x, positions, cache)
    return new_cache, x


def decode_step(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                cache: dict) -> tuple[dict, torch.Tensor]:
    """Process tokens (B, S) at positions ``cache['pos']..+S``; return the
    cache (written in place, ``pos`` advanced) and the last position's logits."""
    new_cache, x = _stack_apply(cfg, params, tokens, cache)
    return new_cache, _unembed(cfg, params, x[:, -1:])[:, 0]


def prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor, cache: dict,
            *, valid_len: torch.Tensor | None = None) -> tuple[dict, torch.Tensor]:
    """Run right-padded prompts (B, S) through the stack once; return the
    cache and the logits at each row's last valid position (``valid_len``,
    (B,); None means S). K/V at pad positions hold garbage; the cache's
    ``pos`` advances by the padded S, as in the JAX package. An ssm cache
    ends exactly as after valid_len tokens (pad steps are identity
    updates, ``models.ssm.ssm_block``)."""
    new_cache, x = _stack_apply(cfg, params, tokens, cache, valid_len)
    if valid_len is None:
        xl = x[:, -1:]
    else:
        idx = torch.clamp(torch.as_tensor(valid_len, device=x.device).long() - 1, min=0)
        xl = torch.take_along_dim(x, idx[:, None, None], dim=1)
    return new_cache, _unembed(cfg, params, xl)[:, 0]


# ---------------------------------------------------------------------------
# paged decode: shared KV page pool + per-slot block tables (serving)
# ---------------------------------------------------------------------------

def paged_cache_defs(cfg: ModelConfig, max_batch: int, n_blocks: int,
                     block_size: int, n_pages: int) -> dict:
    """TensorSpecs of the serving pool: per-layer K/V pages shared by slots
    (dense), or per-slot ssm state and conv history indexed by slot id
    (ssm: length-independent, so nothing is paged)."""
    del n_pages  # the table shape is scheduler state
    _require_ported(cfg)
    if cfg.family == "ssm":
        return _ssm_stacked_defs(cfg, max_batch)
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
    return {"k": TensorSpec(shape, cfg.compute_dtype),
            "v": TensorSpec(shape, cfg.compute_dtype)}


def _paged_block(cfg, p, x, positions, window, pk, pv, table, lengths):
    x = x + L.paged_attention(
        cfg, p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), positions,
        pk, pv, table, lengths, window=window,
    )
    return x + L.mlp(cfg, p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps))


def _paged_stack(cfg, blocks, x, positions, pools, table, lengths):
    """The layer loop of ``_paged_scan_stack``: each layer's pool pages."""
    windows = _layer_windows(cfg)
    for i, p in enumerate(_layers(blocks, cfg.n_layers)):
        x = _paged_block(cfg, p, x, positions,
                         windows[i % len(windows)], pools["k"][i], pools["v"][i],
                         table, lengths)
    return x


def decode_step_paged(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
                      pools: dict, table: torch.Tensor,
                      lengths: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """One serving decode step at a fixed (max_batch, 1) shape.

    tokens (B, 1); table (B, n_pages) int32; lengths (B,) int32, the tokens
    already cached per slot. The new token is appended at position
    ``lengths[b]`` (written into the pools in place) and attention covers
    ``lengths + 1`` tokens. Padding slots carry length 0 and null table rows.
    For the ssm family the pools are the slot-indexed states, stepped with
    the contiguous recurrent step (table and lengths are not read); padding
    slots step their stale state harmlessly. Returns (pools, logits (B,
    vocab) float32).
    """
    _require_ported(cfg)
    x = _embed(cfg, params, tokens)
    if cfg.family == "ssm":
        x, _ = _run_ssm_stack(cfg, params["blocks"], x, pools)
        return pools, _unembed(cfg, params, x[:, -1:])[:, 0]
    positions = lengths[:, None].long()
    x = _paged_stack(cfg, params["blocks"], x, positions, pools, table, lengths)
    return pools, _unembed(cfg, params, x[:, -1:])[:, 0]
