"""Transformer layers of the dense family (counterpart of ``repro.models.layers``).

Every layer is ``(cfg, params, activations) -> out``, as in the JAX package:
matrix products run in ``cfg.compute_dtype`` (each weight is cast to it at
use, a no-op for serving weights stored in it, see
``transformer.storage_dtype``), norm statistics and softmax in float32.
``shard_act`` has no counterpart: it is the identity on one card.

Attention routes as the JAX package routes it:
  * full-sequence self-attention with no cache and
    ``cfg.attention_kernel != "jnp"``: the registry's ``flash_attention``
    (the CUDA kernel on the card, its plain version on the CPU); when a
    gradient is needed it runs as the ``FlashAttention`` autograd Function,
    whose backward is ``flash_attention_bwd`` (mode ``off`` differentiates
    the plain version densely, as the JAX ``ref`` backend does);
  * with a contiguous cache (``prefill``, ``decode_step``) or under
    ``"jnp"``: the inline einsum/softmax path below, which the JAX package
    computes outside any Pallas kernel;
  * paged serving decode (``paged_attention``): the registry's
    ``decode_attention`` under ``cfg.decode_kernel``.

Caches are updated in place (indexed assignment) where the JAX package
returns updated copies.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as KO
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norm / rope / softcap
# ---------------------------------------------------------------------------

def rms_norm_def(d: int) -> ParamDef:
    """A norm scale of width `d`, initialised to ones."""
    return ParamDef((d,), (None,), init="ones")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm with float32 statistics, returned in x's dtype."""
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate x (..., S, H, Dh) pairwise (half-split) at positions (..., S)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float | None) -> torch.Tensor:
    """cap * tanh(x / cap), or x when cap is None."""
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def attention_defs(cfg: ModelConfig) -> dict:
    """Self-attention projections (and qkv biases where the config has them)."""
    d, hd = cfg.d_model, cfg.head_dim
    defs = {
        "wq": ParamDef((d, cfg.n_heads, hd), ("embed", "heads", None)),
        "wk": ParamDef((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", None)),
        "wv": ParamDef((d, cfg.n_kv_heads, hd), ("embed", "kv_heads", None)),
        "wo": ParamDef((cfg.n_heads, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((cfg.n_heads, hd), ("heads", None), init="zeros")
        defs["bk"] = ParamDef((cfg.n_kv_heads, hd), ("kv_heads", None), init="zeros")
        defs["bv"] = ParamDef((cfg.n_kv_heads, hd), ("kv_heads", None), init="zeros")
    return defs


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """q (B, S, H, Dh), k and v (B, S, KV, Dh) in the compute dtype."""
    dt = cfg.compute_dtype
    xc = x.to(dt)
    q = torch.einsum("bsd,dhq->bshq", xc, p["wq"].to(dt))
    k = torch.einsum("bsd,dhq->bshq", xc, p["wk"].to(dt))
    v = torch.einsum("bsd,dhq->bshq", xc, p["wv"].to(dt))
    if "bq" in p:
        q, k, v = q + p["bq"].to(dt), k + p["bk"].to(dt), v + p["bv"].to(dt)
    return q, k, v


def multi_head_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (B, S)
    *,
    causal: bool = True,
    window: int | None = None,
    cache: dict | None = None,  # {'k', 'v': (B, L, KV, Dh), 'pos': int}
) -> tuple[torch.Tensor, dict | None]:
    """Causal GQA self-attention (the dense, no-cross subset of the JAX layer).

    With a cache, this step's K/V are written in place at ``cache['pos']``
    and attention covers the ``pos + S`` tokens written so far; the returned
    cache is ``{'k', 'v', 'pos': pos + S}`` over the same tensors.
    """
    if cfg.blockwise_attention:
        raise NotImplementedError(
            "blockwise_attention (the JAX package's online-softmax training "
            "option) is not ported (ROADMAP Queue 1 item 12)"
        )
    dt = cfg.compute_dtype
    B, S, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    k = rope(k, positions, cfg.rope_theta)
    q = rope(q, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        pos = int(cache["pos"])
        if pos + S > cache["k"].shape[1]:
            raise ValueError(
                f"cache holds {cache['k'].shape[1]} tokens; cannot write "
                f"{S} at position {pos}"
            )
        cache["k"][:, pos:pos + S] = k.to(cache["k"].dtype)
        cache["v"][:, pos:pos + S] = v.to(cache["v"].dtype)
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + S}
        # positions past pos + S are masked in the JAX package; they are
        # simply not read here
        k, v = cache["k"][:, :pos + S], cache["v"][:, :pos + S]
        q_pos = torch.arange(S, device=x.device) + pos
    else:
        q_pos = positions[0]

    if cache is None and cfg.attention_kernel != "jnp":
        o = KO.dispatch(
            "flash_attention",
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(),
            causal=causal, window=window, softcap=cfg.attn_softcap,
            mode=cfg.attention_kernel,
        )
        out = o.transpose(1, 2).to(dt)  # (B, S, H, Dh)
    else:
        G = cfg.n_heads // cfg.n_kv_heads
        qg = q.reshape(B, S, cfg.n_kv_heads, G, cfg.head_dim)
        k_pos = q_pos if cache is None else torch.arange(k.shape[1], device=x.device)
        scores = torch.einsum("bskgh,btkh->bkgst", qg, k) * cfg.head_dim ** -0.5
        scores = softcap(scores.float(), cfg.attn_softcap)
        mask = torch.ones((S, k.shape[1]), dtype=torch.bool, device=x.device)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("bkgst,btkh->bskgh", probs, v)
        out = out.reshape(B, S, cfg.n_heads, cfg.head_dim)
    y = torch.einsum("bshq,hqd->bsd", out, p["wo"].to(dt))
    return y, new_cache


# ---------------------------------------------------------------------------
# paged attention (serving decode against a shared KV block pool)
# ---------------------------------------------------------------------------

def paged_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (B, 1, d): one new token per slot
    positions: torch.Tensor,  # (B, 1): rope position of the new token
    pool_k: torch.Tensor,  # (n_blocks, block_size, KV, Dh), updated in place
    pool_v: torch.Tensor,
    table: torch.Tensor,  # (B, n_pages) int32
    lengths: torch.Tensor,  # (B,) int32: tokens already cached per slot
    *,
    window: int | None = None,
) -> torch.Tensor:
    """Single-token self-attention against a paged KV pool -> y (B, 1, d).

    The new token's K/V are written in place at page
    ``table[b, len // bs]``, offset ``len % bs``; then ``decode_attention``
    covers ``lengths + 1`` tokens. Inactive slots (length 0, all-null table
    rows) write into the reserved null page 0 and read back zeros.
    """
    dt = cfg.compute_dtype
    B = x.shape[0]
    q, k, v = _qkv(cfg, p, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)

    block_size = pool_k.shape[1]
    lens = lengths.long()
    page = table[torch.arange(B, device=x.device), lens // block_size].long()
    off = lens % block_size
    pool_k[page, off] = k[:, 0].to(pool_k.dtype)
    pool_v[page, off] = v[:, 0].to(pool_v.dtype)

    mode = "off" if cfg.decode_kernel == "jnp" else cfg.decode_kernel
    o = KO.dispatch(
        "decode_attention", q[:, 0].contiguous(), pool_k, pool_v, table,
        lengths + 1, window=window, softcap=cfg.attn_softcap, mode=mode,
    )  # (B, Hq, Dh)
    y = torch.einsum("bhq,hqd->bd", o.to(dt), p["wo"].to(dt))
    return y[:, None]


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU)
# ---------------------------------------------------------------------------

def mlp_defs(cfg: ModelConfig, d_ff: int | None = None) -> dict:
    """Gate, up and down projections."""
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wg": ParamDef((d, f), ("embed", "mlp")),
        "wu": ParamDef((d, f), ("embed", "mlp")),
        "wd": ParamDef((f, d), ("mlp", "embed")),
    }


def mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """silu(x @ wg) * (x @ wu) @ wd in the compute dtype."""
    dt = cfg.compute_dtype
    h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wu"].to(dt))
    return h @ p["wd"].to(dt)
