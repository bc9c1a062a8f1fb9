"""Model assembly for every family of the JAX package: dense, moe, ssm,
hybrid and encdec (counterpart of ``repro.models.transformer``).

Public API, as in the JAX package:
  model_defs(cfg)                      -> ParamDef tree
  init_params(cfg, seed, device)       -> serving parameters drawn on the device
  init_train_params(cfg, seed, device) -> training (float32 master) parameters
  forward(cfg, params, tokens[, enc_embeds=])   -> logits   (train / scoring)
  cache_defs / init_cache              -> contiguous decode cache
  prefill(cfg, params, tok, cache)     -> (cache, logits at valid_len - 1)
  decode_step(cfg, params, tok, cache) -> (cache, logits)
  encode_cross_cache(cfg, params, enc_embeds, batch) -> the encdec cross K/V
Serving API (the paged twin, driven by ``repro_torch.serve``):
  paged_cache_defs(cfg, max_batch, n_blocks, block_size, n_pages)
  decode_step_paged(cfg, params, tok, pools, table, lengths)
                                       -> (pools, logits)

Families: ``dense`` (attention + MLP blocks; gemma2's local/global
alternation), ``moe`` (the dense blocks with ``layers.moe`` in place of
the MLP: router, capacity dispatch, a shared expert), ``ssm`` (Mamba2 blocks, ``models.ssm``: the SSD
within-chunk part through the registry's ``ssd_chunk`` under
``cfg.ssm_kernel``) and ``hybrid`` (zamba2: the Mamba2 stack with ONE
shared attention + MLP block, ``shared_attn``, applied after every
``cfg.hybrid_period``-th ssm layer, with no window). An ssm cache is
length-independent: per layer a recurrent state and a conv history, with
no position; the serving pool holds them per slot, and its decode step is
the contiguous recurrent step. The hybrid cache nests both kinds:
``{"ssm": {"state", "conv"} on every layer, "attn": {"k", "v"} on the
n_layers // hybrid_period uses of the shared block}``, the contiguous one
with ``attn["pos"]``; its serving pool pages the shared block's K/V and
holds the ssm state per slot. ``encdec`` (whisper): a bidirectional encoder
(``encoder``, self-attention with rope, not causal: the flash kernel's
non-causal mode) over stubbed frame embeddings ``enc_embeds`` (B, S_enc,
d), its ``enc_final_norm``, and a causal decoder (``decoder``) whose
layers add cross attention (``ln_x``, ``xattn``; no rope, the plain path)
over the encoder output. Its caches are ``{"self": {"k", "v"[, "pos"]},
"cross": {"k", "v"}}``: the decoder's own K/V (contiguous, or paged in the
serving pool) and every layer's encoder K/V, which ``encode_cross_cache``
computes once a request (per slot in the pool, never paged: its length is
fixed).

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
(``torch.utils.checkpoint``, non-reentrant; ``_checkpoint``) unless
``cfg.remat`` is ``"none"``, with the JAX package's policies: ``"dots"``
(``dots_with_no_batch_dims_saveable``) saves the outputs of the products
with no batch dimension (the attention projections, the MLP, the router
and the ssm projections: ``aten.mm``) by ``torch.utils.checkpoint``'s
selective checkpointing and recomputes the rest (the batched attention,
expert and SSD products, the kernels, norms and elementwise work); any
other value is ``"full"``: each layer's input is saved and the layer
recomputed in the backward pass. The hybrid family checkpoints each use of
the shared block too, where the JAX package wraps only the ssm layers
(memory and recompute differ, the gradients do not); the encdec family
checkpoints every encoder and decoder layer, as the JAX package's two
scans do.

Under ``layers.use_constraint_mesh(grid)`` (a rank of the within-pod FSDP
x TP train step: the dense, moe, ssm and hybrid families) ``forward``
computes the rank's share: each layer gathers its leaves over ``"data"``
where it uses them (``Grid.gather_layer``; inside the checkpointed layer,
so the recompute gathers again and no layer's whole weights outlive it),
the embedding (and ``lm_head``) once a forward, and so the hybrid's
shared block: its leaves gathered once, outside its uses, so autograd sums
its gradient over every use (and every recompute) before the one
reduce-scatter; the lookup is vocab-parallel (each rank looks up the
tokens of its vocabulary block, zeros elsewhere, summed over ``"model"``)
and the logits are this rank's vocabulary block, the final softcap
applied to it elementwise (``train.step.ce_loss`` reduces them). The
layers' own shares: ``models.layers`` (attention heads, MLP units, the
experts), ``models.ssm`` (the Mamba2 heads). The encdec family has no
layout under a grid.

Caches are updated in place: the contiguous cache's K/V (or SSM state and
conv) tensors and the paged pools are allocated once and written by
indexed assignment, where the JAX package returns updated copies. The
dense (and hybrid ``attn``) cache position ``pos`` is a host integer.
"""
from __future__ import annotations

import functools
from typing import Any

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, TensorSpec, tree_map, tree_materialize

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec")
_ATTN_STACKS = ("dense", "moe")  # homogeneous attention stacks under "blocks"


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(cfg.family)


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
    blk = {
        "ln1": L.rms_norm_def(cfg.d_model),
        "attn": L.attention_defs(cfg),
        "ln2": L.rms_norm_def(cfg.d_model),
    }
    if cfg.family == "moe":
        blk["moe"] = L.moe_defs(cfg)
    else:
        blk["mlp"] = L.mlp_defs(cfg)
    return blk


def _decoder_block_defs(cfg: ModelConfig) -> dict:
    d = cfg.d_model
    return {
        "ln1": L.rms_norm_def(d),
        "attn": L.attention_defs(cfg),
        "ln_x": L.rms_norm_def(d),
        "xattn": L.attention_defs(cfg, cross=True),
        "ln2": L.rms_norm_def(d),
        "mlp": L.mlp_defs(cfg),
    }


def _ssm_block_defs(cfg: ModelConfig) -> dict:
    return {"ln": L.rms_norm_def(cfg.d_model), "ssm": S.ssm_defs(cfg)}


def model_defs(cfg: ModelConfig) -> dict:
    """The ParamDef tree of the model (the JAX tree of its family)."""
    _check_family(cfg)
    d = cfg.d_model
    defs: dict[str, Any] = {
        "embed": ParamDef((cfg.vocab_size, d), ("vocab", "embed"), scale=1.0),
        "final_norm": L.rms_norm_def(d),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, cfg.vocab_size), ("embed", "vocab"))
    if cfg.family == "encdec":
        defs["encoder"] = _stack(_block_defs(cfg), cfg.n_encoder_layers)
        defs["decoder"] = _stack(_decoder_block_defs(cfg), cfg.n_layers)
        defs["enc_final_norm"] = L.rms_norm_def(d)
        return defs
    blk = _block_defs(cfg) if cfg.family in _ATTN_STACKS else _ssm_block_defs(cfg)
    defs["blocks"] = _stack(blk, cfg.n_layers)
    if cfg.family == "hybrid":
        defs["shared_attn"] = _block_defs(cfg)  # one attention + MLP block, reused
    return defs


def storage_dtype(cfg: ModelConfig):
    """``path -> dtype`` each parameter is held in.

    ``param_dtype`` for the leaves the JAX package reads in float32 or
    gathers: ``embed``, the norm scales (``ln1``, ``ln2``, ``ln``, ``ln_x``,
    ``final_norm``, ``enc_final_norm``; ``layers.rms_norm`` casts the
    scale to float32), the
    SSM gated norm's ``norm`` and the SSM's ``dt_bias``, ``A_log`` and
    ``D`` (``models.ssm`` reads them ``.float()``, never in the compute
    dtype). Every other leaf is a weight read only as
    ``w.astype(compute_dtype)``, so it is held in ``compute_dtype``.
    """
    keep = {"embed", "ln1", "ln2", "ln", "ln_x", "final_norm", "enc_final_norm", "norm",
            "dt_bias", "A_log", "D"}

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
    grid = L.current_grid()
    if grid is None:
        x = params["embed"][tokens]  # (B, S, d)
    else:  # this rank's vocabulary block; the other rows are zeros here
        table = params["embed"]
        local = tokens - grid.vocab_offset(table.shape[0])
        mine = (local >= 0) & (local < table.shape[0])
        x = table[torch.where(mine, local, 0)] * mine[..., None].to(table.dtype)
        x = grid.model.reduce_from(x)
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype, device=x.device)
    return (x * scale).to(cfg.compute_dtype)


def _unembed(cfg: ModelConfig, params, x):
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    grid = L.current_grid()
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    if grid is not None:  # the logits of this rank's vocabulary block
        logits = L.col_parallel(grid, x, head.to(cfg.compute_dtype))
    else:
        logits = x @ head.to(cfg.compute_dtype)
    return L.softcap(logits.float(), cfg.final_softcap)


def _ffn(cfg: ModelConfig, p, x):
    """The block's feed-forward half: the experts (moe) or the MLP."""
    inner = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if "moe" in p:
        return x + L.moe(cfg, p["moe"], inner)
    return x + L.mlp(cfg, p["mlp"], inner)


def _dense_block(cfg: ModelConfig, p, x, positions, window, cache, causal=True, gather=True):
    grid = L.current_grid()
    if grid is not None and gather:  # FSDP: this layer's leaves, gathered where used
        p = grid.gather_layer(p, grid.specs["blocks"])
    h, new_cache = L.multi_head_attention(
        cfg, p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), positions,
        causal=causal, window=window, cache=cache,
    )
    return _ffn(cfg, p, x + h), new_cache


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the outputs of the products with no batch dimension, recompute
    everything else. Those products are the ``aten.mm`` calls:
    ``layers.contract`` and ``x @ w`` of a (B, S, d) activation and a 2-D
    weight lower to ``mm``, every batched product (attention, experts, SSD)
    to ``bmm``."""
    del ctx, args, kwargs
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


GRID_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def check_grid_family(cfg: ModelConfig) -> None:
    """Raise unless the within-pod layout covers `cfg`'s family."""
    if cfg.family not in GRID_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family has no within-pod FSDP x TP layout yet (ROADMAP "
            "Queue 1 item 10: the encdec layout under a grid)")


def _checkpoint(cfg: ModelConfig, fn, *args):
    """fn(*args) under activation checkpointing by ``cfg.remat``: "dots"
    saves the no-batch products (``_dots_policy``), any other value
    recomputes the whole of fn (JAX ``_remat``'s rule; "none" never reaches
    here, see ``_remat_on``). Under a grid the recompute runs the whole of
    fn (no early stop), so it re-issues every collective of the forward,
    the same ones on every rank."""
    if L.current_grid() is not None:
        with torch.utils.checkpoint.set_checkpoint_early_stop(False):
            return _checkpoint_call(cfg, fn, *args)
    return _checkpoint_call(cfg, fn, *args)


def _checkpoint_call(cfg: ModelConfig, fn, *args):
    if cfg.remat == "dots":
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts, _dots_policy))
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _remat_block(cfg, p, x, positions, window, gather=True):
    """One cache-free layer under activation checkpointing (``cfg.remat``)."""
    def fn(x_in):
        return _dense_block(cfg, p, x_in, positions, window, None, gather=gather)[0]

    return _checkpoint(cfg, fn, x)


def _ssm_layer(cfg: ModelConfig, p, x, cache, valid_len=None):
    grid = L.current_grid()
    if grid is not None:  # FSDP: this layer's leaves, gathered where used
        p = grid.gather_layer(p, grid.specs["blocks"])
    h, new_cache = S.ssm_block(cfg, p["ssm"], L.rms_norm(x, p["ln"], cfg.norm_eps),
                               cache=cache, valid_len=valid_len)
    return x + h, new_cache


def _remat_on(cfg: ModelConfig, caches) -> bool:
    """Checkpoint the layers: no cache, grad mode on, ``cfg.remat`` not "none"."""
    return caches is None and cfg.remat != "none" and torch.is_grad_enabled()


def _ssm_stack_layer(cfg, p, x, caches, i, valid_len, remat):
    """Layer i of an ssm stack. With a cache (contiguous, or the serving
    pools) its state and conv history are read from ``caches[...][i]`` and
    the new ones written back in place; with `remat` it is checkpointed."""
    if remat:
        return _checkpoint(cfg, lambda x_in: _ssm_layer(cfg, p, x_in, None)[0], x)
    cache = None if caches is None else {k: caches[k][i] for k in ("state", "conv")}
    x, new = _ssm_layer(cfg, p, x, cache, valid_len)
    if cache is not None:
        for k in ("state", "conv"):
            cache[k].copy_(new[k])
    return x


def _run_ssm_stack(cfg, blocks, x, caches, valid_len=None):
    """The layer loop of ``_scan_ssm_stack`` (``_ssm_stack_layer`` per layer).
    Without a cache and with grad mode on, each layer is checkpointed unless
    ``cfg.remat == "none"``."""
    remat = _remat_on(cfg, caches)
    for i, p in enumerate(_layers(blocks, cfg.n_layers)):
        x = _ssm_stack_layer(cfg, p, x, caches, i, valid_len, remat)
    return x, caches


def _run_hybrid(cfg, params, x, ssm_caches, shared, valid_len=None):
    """The loop of ``_hybrid_forward``: the ssm layers in order (as
    ``_run_ssm_stack``; `valid_len` reaches them only), and after layer i,
    when ``(i + 1) % cfg.hybrid_period == 0``, ``shared(ai, x)``: the ai-th
    use of the shared block, which returns the new x. Autograd sums the
    shared block's gradient over its uses."""
    remat = _remat_on(cfg, ssm_caches)
    ai = 0
    for i, p in enumerate(_layers(params["blocks"], cfg.n_layers)):
        x = _ssm_stack_layer(cfg, p, x, ssm_caches, i, valid_len, remat)
        if (i + 1) % cfg.hybrid_period == 0:
            x = shared(ai, x)
            ai += 1
    return x


def _run_stack(cfg, blocks, x, positions, caches):
    """The layer loop (``_scan_stack``), with an optional contiguous cache.
    Without a cache and with grad mode on, each layer is checkpointed
    unless ``cfg.remat == "none"``."""
    windows = _layer_windows(cfg)
    pos = caches["pos"] if caches is not None else None
    remat = _remat_on(cfg, caches)
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

def forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor, *,
            enc_embeds: torch.Tensor | None = None) -> torch.Tensor:
    """Logits (B, S, vocab) float32 of tokens (B, S); attention through
    ``flash_attention`` unless ``cfg.attention_kernel == "jnp"``, the SSD
    through ``ssd_chunk`` unless ``cfg.ssm_kernel == "jnp"``. The encdec
    family needs `enc_embeds` (B, S_enc, d_model), the frames the decoder
    attends to."""
    _check_family(cfg)
    grid = L.current_grid()
    if grid is not None:
        check_grid_family(cfg)
    if cfg.family == "encdec":
        return _forward_encdec(cfg, params, tokens, enc_embeds)
    B, S = tokens.shape
    if grid is not None:
        params = dict(params, **{k: grid.gather(params[k], grid.specs[k])
                                 for k in ("embed", "lm_head") if k in params})
    x = _embed(cfg, params, tokens)
    if cfg.family == "ssm":
        x, _ = _run_ssm_stack(cfg, params["blocks"], x, None)
        return _unembed(cfg, params, x)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    if cfg.family == "hybrid":
        x = _run_hybrid(cfg, params, x, None, _shared_full(cfg, params, positions))
    else:
        x, _ = _run_stack(cfg, params["blocks"], x, positions, None)
    return _unembed(cfg, params, x)


def _arange_rows(b: int, s: int, device) -> torch.Tensor:
    """Positions 0..s-1 for each of b rows, (b, s)."""
    return torch.arange(s, device=device)[None].expand(b, s)


def _checkpointed(cfg, fn, *args):
    """fn(*args), checkpointed when ``_remat_on`` (no cache here)."""
    if _remat_on(cfg, None):
        return _checkpoint(cfg, fn, *args)
    return fn(*args)


def _encode(cfg: ModelConfig, params, enc_embeds):
    """The encoder over frames (B, S_enc, d): bidirectional self-attention
    (rope, not causal) + MLP per layer, then ``enc_final_norm``."""
    if enc_embeds is None:
        raise ValueError("the encdec family needs enc_embeds")
    x = enc_embeds.to(cfg.compute_dtype)
    positions = _arange_rows(x.shape[0], x.shape[1], x.device)
    for p in _layers(params["encoder"], cfg.n_encoder_layers):
        x = _checkpointed(
            cfg, lambda x_in, p=p: _dense_block(cfg, p, x_in, positions, None, None,
                                                 causal=False)[0], x)
    return L.rms_norm(x, params["enc_final_norm"], cfg.norm_eps)


def _decoder_layer(cfg, p, x, positions, self_cache, cross_kv, enc_pos):
    """One decoder layer: causal self-attention (a contiguous cache, or
    none), cross attention over `cross_kv` (the encoder output (B, S_enc,
    d), projected here; or a dict of its cached K/V) without rope, MLP."""
    h, new_cache = L.multi_head_attention(
        cfg, p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), positions,
        causal=True, cache=self_cache,
    )
    x = x + h
    x = x + _cross(cfg, p, x, positions, cross_kv, enc_pos)
    return x + L.mlp(cfg, p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps)), new_cache


def _cross(cfg, p, x, positions, cross_kv, enc_pos):
    """Cross attention of a decoder layer (never causal, no rope)."""
    xn = L.rms_norm(x, p["ln_x"], cfg.norm_eps)
    cached = isinstance(cross_kv, dict)  # the cached encoder K/V: kv_x is not read
    h, _ = L.multi_head_attention(cfg, p["xattn"], xn, positions,
                                  kv_x=xn if cached else cross_kv, kv_positions=enc_pos,
                                  causal=False, use_rope=False,
                                  cache=cross_kv if cached else None)
    return h


def _forward_encdec(cfg, params, tokens, enc_embeds):
    enc = _encode(cfg, params, enc_embeds)
    B, S = tokens.shape
    x = _embed(cfg, params, tokens)
    positions = _arange_rows(B, S, tokens.device)
    enc_pos = _arange_rows(B, enc.shape[1], tokens.device)
    for p in _layers(params["decoder"], cfg.n_layers):
        x = _checkpointed(
            cfg, lambda x_in, e, p=p: _decoder_layer(cfg, p, x_in, positions, None, e,
                                                     enc_pos)[0], x, enc)
    return _unembed(cfg, params, x)


def _shared_full(cfg, params, positions):
    """The shared block over a full sequence (no cache), checkpointed as the
    ssm layers are. Under a grid its leaves are gathered over "data" once,
    here: every use (and its recompute) reads the same gathered tensors, so
    autograd sums the block's gradient over the uses before the one
    reduce-scatter, as the reference's autograd sums it whole."""
    shared = params["shared_attn"]
    grid = L.current_grid()
    if grid is not None:
        shared = grid.gather_layer(shared, grid.specs["shared_attn"], stacked=False)
    remat = _remat_on(cfg, None)

    def apply(ai, x):
        if remat:
            return _remat_block(cfg, shared, x, positions, None, gather=False)
        return _dense_block(cfg, shared, x, positions, None, None, gather=False)[0]

    return apply


# ---------------------------------------------------------------------------
# contiguous decode: cache defs + prefill + single-token step
# ---------------------------------------------------------------------------

def _ssm_stacked_defs(cfg: ModelConfig, batch: int) -> dict:
    """Every layer's ssm cache stacked on axis 0: {'state', 'conv'}."""
    return {k: TensorSpec((cfg.n_layers, *s.shape), s.dtype)
            for k, s in S.ssm_cache_defs(cfg, batch).items()}


def _kv_defs(cfg: ModelConfig, n: int, rows: int, cols: int) -> dict:
    """K and V of `n` attention layers, (n, rows, cols, KV, Dh) each."""
    shape = (n, rows, cols, cfg.n_kv_heads, cfg.head_dim)
    return {"k": TensorSpec(shape, cfg.compute_dtype),
            "v": TensorSpec(shape, cfg.compute_dtype)}


def _n_shared(cfg: ModelConfig) -> int:
    """Uses of the hybrid family's shared block: n_layers // hybrid_period."""
    return cfg.n_layers // cfg.hybrid_period


def _cross_defs(cfg: ModelConfig, rows: int) -> dict:
    """Every decoder layer's encoder K/V, (n_layers, rows, encoder_len, KV, Dh)."""
    return _kv_defs(cfg, cfg.n_layers, rows, cfg.encoder_len)


def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """TensorSpecs of the contiguous decode cache: dense and moe K/V
    (``pos``, a host int, is added by ``init_cache``), the ssm state and
    conv history, whose size does not depend on `max_len`, the hybrid's
    both: ``{"ssm": ..., "attn": K/V of the shared block's uses}``, or the
    encdec's ``{"self": the decoder's K/V, "cross": the encoder K/V}``."""
    _check_family(cfg)
    if cfg.family == "encdec":
        return {"self": _kv_defs(cfg, cfg.n_layers, batch, max_len),
                "cross": _cross_defs(cfg, batch)}
    if cfg.family == "ssm":
        return _ssm_stacked_defs(cfg, batch)
    if cfg.family == "hybrid":
        return {"ssm": _ssm_stacked_defs(cfg, batch),
                "attn": _kv_defs(cfg, _n_shared(cfg), batch, max_len)}
    return _kv_defs(cfg, cfg.n_layers, batch, max_len)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None) -> dict:
    """A zeroed contiguous cache on `device` (the card unless told otherwise)."""
    dev = resolve_device(device)
    out = tree_map(lambda _, s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                   cache_defs(cfg, batch, max_len))
    if cfg.family in _ATTN_STACKS:
        out["pos"] = 0
    elif cfg.family in ("hybrid", "encdec"):
        out["attn" if cfg.family == "hybrid" else "self"]["pos"] = 0
    return out


def _stack_apply(cfg, params, tokens, cache, valid_len=None):
    _check_family(cfg)
    x = _embed(cfg, params, tokens)
    if cfg.family == "encdec":
        return _decode_encdec(cfg, params, x, cache)
    if cfg.family == "ssm":  # the state summarises the past: no position
        x, new_cache = _run_ssm_stack(cfg, params["blocks"], x, cache, valid_len)
        return new_cache, x
    B, S = tokens.shape
    kv = cache["attn"] if cfg.family == "hybrid" else cache
    positions = kv["pos"] + torch.arange(S, device=tokens.device)[None].expand(B, S)
    if cfg.family == "hybrid":
        # the shared block writes K/V at every (padded) position; pos
        # advances by the padded S, as in the JAX package
        def shared(ai, x_in):
            c = {"k": kv["k"][ai], "v": kv["v"][ai], "pos": kv["pos"]}
            return _dense_block(cfg, params["shared_attn"], x_in, positions, None, c)[0]

        x = _run_hybrid(cfg, params, x, cache["ssm"], shared, valid_len)
        return {"ssm": cache["ssm"], "attn": {**kv, "pos": kv["pos"] + S}}, x
    x, new_cache = _run_stack(cfg, params["blocks"], x, positions, cache)
    return new_cache, x


def _decode_encdec(cfg, params, x, cache):
    """The decoder over x (B, S, d) at positions ``cache['self']['pos']``
    + 0..S-1: each layer's self K/V written in place, cross attention over
    the cached encoder K/V (fill ``cache['cross']`` with
    ``encode_cross_cache`` first). ``pos`` advances by S."""
    B, S = x.shape[:2]
    sc, xc = cache["self"], cache["cross"]
    pos0 = sc["pos"]
    positions = pos0 + _arange_rows(B, S, x.device)
    enc_pos = _arange_rows(B, cfg.encoder_len, x.device)
    for i, p in enumerate(_layers(params["decoder"], cfg.n_layers)):
        x, _ = _decoder_layer(cfg, p, x, positions,
                              {"k": sc["k"][i], "v": sc["v"][i], "pos": pos0},
                              {"k": xc["k"][i], "v": xc["v"][i]}, enc_pos)
    return {"self": {**sc, "pos": pos0 + S}, "cross": xc}, x


def encode_cross_cache(cfg: ModelConfig, params: dict, enc_embeds: torch.Tensor,
                       batch: int) -> dict:
    """Run the encoder once over enc_embeds (batch, S_enc, d) and return
    every decoder layer's cross K/V, ``{"k", "v": (n_layers, batch, S_enc,
    KV, Dh)}`` in the compute dtype (projected without bias, as in the JAX
    package)."""
    del batch  # the JAX signature's; the rows come from enc_embeds
    enc = _encode(cfg, params, enc_embeds)
    dt = cfg.compute_dtype
    xa = params["decoder"]["xattn"]
    return {"k": torch.einsum("bsd,ldhq->lbshq", enc, xa["wk"].to(dt)),
            "v": torch.einsum("bsd,ldhq->lbshq", enc, xa["wv"].to(dt))}


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
    (dense, moe), per-slot ssm state and conv history indexed by slot id
    (ssm: length-independent, so nothing is paged), the hybrid's both:
    ``{"ssm": per slot, "attn": the shared block's uses' K/V pages}``, or
    the encdec's ``{"self": the decoder's K/V pages, "cross": per-slot
    encoder K/V}`` (fixed length, fully live: paging buys nothing)."""
    del n_pages  # the table shape is scheduler state
    _check_family(cfg)
    if cfg.family == "encdec":
        return {"self": _kv_defs(cfg, cfg.n_layers, n_blocks, block_size),
                "cross": _cross_defs(cfg, max_batch)}
    if cfg.family == "ssm":
        return _ssm_stacked_defs(cfg, max_batch)
    if cfg.family == "hybrid":
        return {"ssm": _ssm_stacked_defs(cfg, max_batch),
                "attn": _kv_defs(cfg, _n_shared(cfg), n_blocks, block_size)}
    return _kv_defs(cfg, cfg.n_layers, n_blocks, block_size)


def _paged_self(cfg, p, x, positions, window, pk, pv, table, lengths):
    """x + the block's self-attention through ``paged_attention``."""
    return x + L.paged_attention(
        cfg, p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), positions,
        pk, pv, table, lengths, window=window,
    )


def _paged_block(cfg, p, x, positions, window, pk, pv, table, lengths):
    return _ffn(cfg, p, _paged_self(cfg, p, x, positions, window, pk, pv, table, lengths))


def _paged_stack(cfg, blocks, x, positions, pools, table, lengths):
    """The layer loop of ``_paged_scan_stack``: each layer's pool pages."""
    windows = _layer_windows(cfg)
    for i, p in enumerate(_layers(blocks, cfg.n_layers)):
        x = _paged_block(cfg, p, x, positions,
                         windows[i % len(windows)], pools["k"][i], pools["v"][i],
                         table, lengths)
    return x


def _paged_hybrid(cfg, params, x, positions, pools, table, lengths):
    """The hybrid's paged decode: the ssm layers' recurrent step on the
    slot rows, the shared block through ``paged_attention`` on pool ai."""
    pk, pv = pools["attn"]["k"], pools["attn"]["v"]

    def shared(ai, x_in):
        return _paged_block(cfg, params["shared_attn"], x_in, positions, None, pk[ai], pv[ai],
                            table, lengths)

    return _run_hybrid(cfg, params, x, pools["ssm"], shared)


def _paged_encdec(cfg, params, x, positions, pools, table, lengths):
    """The encdec's paged decode: each decoder layer's self-attention over
    its K/V pages, cross attention over the slots' encoder K/V."""
    enc_pos = _arange_rows(x.shape[0], cfg.encoder_len, x.device)
    sk, sv = pools["self"]["k"], pools["self"]["v"]
    xk, xv = pools["cross"]["k"], pools["cross"]["v"]
    for i, p in enumerate(_layers(params["decoder"], cfg.n_layers)):
        x = _paged_self(cfg, p, x, positions, None, sk[i], sv[i], table, lengths)
        x = x + _cross(cfg, p, x, positions, {"k": xk[i], "v": xv[i]}, enc_pos)
        x = x + L.mlp(cfg, p["mlp"], L.rms_norm(x, p["ln2"], cfg.norm_eps))
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
    slots step their stale state harmlessly. The hybrid family does both
    (``_paged_hybrid``): its ssm layers step ``pools["ssm"]``, each use ai
    of the shared block attends over the pages of ``pools["attn"]``'s
    layer ai. The encdec family pages its decoder's K/V in
    ``pools["self"]`` and reads each slot's encoder K/V from
    ``pools["cross"]`` (``_paged_encdec``). Returns (pools, logits (B,
    vocab) float32).
    """
    _check_family(cfg)
    x = _embed(cfg, params, tokens)
    if cfg.family == "ssm":
        x, _ = _run_ssm_stack(cfg, params["blocks"], x, pools)
        return pools, _unembed(cfg, params, x[:, -1:])[:, 0]
    positions = lengths[:, None].long()
    if cfg.family == "hybrid":
        x = _paged_hybrid(cfg, params, x, positions, pools, table, lengths)
    elif cfg.family == "encdec":
        x = _paged_encdec(cfg, params, x, positions, pools, table, lengths)
    else:
        x = _paged_stack(cfg, params["blocks"], x, positions, pools, table, lengths)
    return pools, _unembed(cfg, params, x[:, -1:])[:, 0]
