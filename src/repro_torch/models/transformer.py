"""Model assembly for the dense family (counterpart of ``repro.models.transformer``).

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

Parameters are a nested dict of tensors laid out as the JAX tree: layers
stacked on axis 0 under ``blocks``; a Python loop over layers takes the
place of ``lax.scan`` (each layer reads views ``blocks[...][i]``). Every
layer casts a weight to ``cfg.compute_dtype`` where it uses it, as the JAX
package does. ``init_params`` (serving) stores the matrix weights in
``cfg.compute_dtype`` at once, so the cast is free and the bits are the
same; ``embed`` and the norm scales stay in ``cfg.param_dtype`` (see
``storage_dtype``). ``init_train_params`` holds every leaf in
``cfg.param_dtype``, as the JAX train state does, and the gradient flows
back through the casts to those master weights.

Training runs each layer of ``forward`` under activation checkpointing
(``torch.utils.checkpoint``, non-reentrant) unless ``cfg.remat`` is
``"none"``: ``"full"`` saves each layer's input and recomputes the layer in
the backward pass. The JAX ``"dots"`` policy (also save the matmul
outputs) runs as ``"full"`` here: the gradients are the same, only the
memory/recompute trade differs.

Caches are updated in place: the contiguous cache's K/V tensors and the
paged pools are allocated once and written by indexed assignment, where the
JAX package returns updated copies. The cache position ``pos`` is a host
integer.

Only ``family == "dense"`` runs; the moe, ssm, hybrid and encdec families
raise ``NotImplementedError`` (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.utils.checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, tree_map, tree_materialize


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor to allocate (the ShapeDtypeStruct twin)."""

    shape: tuple[int, ...]
    dtype: Any


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported; only the dense "
            "family runs (ROADMAP Queue 1 item 12)"
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


def model_defs(cfg: ModelConfig) -> dict:
    """The ParamDef tree of the model (the JAX tree of the dense family)."""
    _require_dense(cfg)
    d = cfg.d_model
    defs: dict[str, Any] = {
        "embed": ParamDef((cfg.vocab_size, d), ("vocab", "embed"), scale=1.0),
        "final_norm": L.rms_norm_def(d),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, cfg.vocab_size), ("embed", "vocab"))
    defs["blocks"] = _stack(_block_defs(cfg), cfg.n_layers)
    return defs


def storage_dtype(cfg: ModelConfig):
    """``path -> dtype`` each parameter is held in.

    ``embed`` and the norm scales (``ln1``, ``ln2``, ``final_norm``) keep
    ``param_dtype``; every other leaf is a weight that the JAX package reads
    only as ``w.astype(compute_dtype)``, so it is held in ``compute_dtype``.
    """
    keep = {"embed", "ln1", "ln2", "final_norm"}

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


def _layer(blocks: dict, i: int) -> dict:
    """Layer i's parameters: views into the stacked tensors."""
    return tree_map(lambda _, t: t[i], blocks)


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


def _run_stack(cfg, blocks, x, positions, caches):
    """The layer loop (``_scan_stack``), with an optional contiguous cache.
    Without a cache and with grad mode on, each layer is checkpointed
    unless ``cfg.remat == "none"``."""
    windows = _layer_windows(cfg)
    pos = caches["pos"] if caches is not None else None
    remat = caches is None and cfg.remat != "none" and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        window = windows[i % len(windows)]
        if remat:
            x = _remat_block(cfg, _layer(blocks, i), x, positions, window)
            continue
        cache = None
        if caches is not None:
            cache = {"k": caches["k"][i], "v": caches["v"][i], "pos": pos}
        x, _ = _dense_block(cfg, _layer(blocks, i), x, positions, window, cache)
    if caches is None:
        return x, None
    return x, {"k": caches["k"], "v": caches["v"], "pos": pos + positions.shape[1]}


# ---------------------------------------------------------------------------
# forward (scoring): full-sequence logits
# ---------------------------------------------------------------------------

def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Logits (B, S, vocab) float32 of tokens (B, S); attention through
    ``flash_attention`` unless ``cfg.attention_kernel == "jnp"``."""
    _require_dense(cfg)
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x, _ = _run_stack(cfg, params["blocks"], x, positions, None)
    return _unembed(cfg, params, x)


# ---------------------------------------------------------------------------
# contiguous decode: cache defs + prefill + single-token step
# ---------------------------------------------------------------------------

def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """TensorSpecs of the contiguous decode cache (``pos`` is a host int)."""
    _require_dense(cfg)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": TensorSpec(shape, cfg.compute_dtype),
            "v": TensorSpec(shape, cfg.compute_dtype)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """A zeroed contiguous cache on `device` (the card unless told otherwise)."""
    dev = resolve_device(device)
    out = {name: torch.zeros(s.shape, dtype=s.dtype, device=dev)
           for name, s in cache_defs(cfg, batch, max_len).items()}
    out["pos"] = 0
    return out


def _stack_apply(cfg, params, tokens, cache):
    _require_dense(cfg)
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
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
    ``pos`` advances by the padded S, as in the JAX package."""
    new_cache, x = _stack_apply(cfg, params, tokens, cache)
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
    """TensorSpecs of the serving pool: per-layer K/V pages shared by slots."""
    del max_batch, n_pages  # slot and table shapes are scheduler state
    _require_dense(cfg)
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
    for i in range(cfg.n_layers):
        x = _paged_block(cfg, _layer(blocks, i), x, positions,
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
    Returns (pools, logits (B, vocab) float32).
    """
    _require_dense(cfg)
    x = _embed(cfg, params, tokens)
    positions = lengths[:, None].long()
    x = _paged_stack(cfg, params["blocks"], x, positions, pools, table, lengths)
    return pools, _unembed(cfg, params, x[:, -1:])[:, 0]
