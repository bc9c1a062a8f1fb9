"""Transformer layers: norm, rope, GQA self- and cross-attention, the gated
MLP and the mixture of experts (counterpart of ``repro.models.layers``).

Every layer is ``(cfg, params, activations) -> out``, as in the JAX package:
matrix products run in ``cfg.compute_dtype`` (each weight is cast to it at
use, a no-op for serving weights stored in it, see
``transformer.storage_dtype``), norm statistics and softmax in float32.

Under ``use_constraint_mesh(grid)`` (a rank of the within-pod FSDP x TP
step, ``train.sharded``; the JAX ``shard_act`` sites) the layers compute
this rank's share: q, k and v project onto the rank's heads and the MLP's
gate and up onto its hidden units (``col_parallel``: the rank's columns),
the attention runs on those heads, and ``wo`` and the MLP's ``wd`` give
partial sums over ``"model"`` (``row_parallel``). A product whose
contraction is whole on the rank runs as the unsharded one does (a
compute-dtype ``mm``); a sum split over ``"model"`` (a row-parallel
output, a column-parallel input's gradient) is formed in float32, added
over the line in rank order and rounded once, as the unsharded product
accumulates in float32 and rounds once. Kv heads that ``shardable_pspecs``
leaves whole (fewer than the model axis) are projected whole on every
rank, and the rank's q heads read kv head ``q // group``; their gradient
is all-reduced over ``"model"``, so every rank holds the whole
``wk``/``wv`` gradient. The mixture of experts runs its experts in
parallel over ``"model"`` (``_grid_moe_scatter``: rank m's block of the
experts, the global capacity and token-major positions, the slot rows
summed over the line), and ``rms_norm(over=)`` sums a split dimension's
statistic over a line (the Mamba2 gated norm, ``models.ssm``). With no
grid set every path below is the single-device one.

Attention routes as the JAX package routes it:
  * full-sequence self-attention (causal, or not: the enc-dec encoder)
    with no cache and ``cfg.attention_kernel != "jnp"``: the registry's
    ``flash_attention``
    (the CUDA kernel on the card, its plain version on the CPU); when a
    gradient is needed it runs as the ``FlashAttention`` autograd Function,
    whose backward is ``flash_attention_bwd`` (mode ``off`` differentiates
    the plain version densely, as the JAX ``ref`` backend does);
  * with a contiguous cache (``prefill``, ``decode_step``), cross
    attention (``kv_x``) or under ``"jnp"``: the inline einsum/softmax path
    below, which the JAX package computes outside any Pallas kernel;
  * with ``cfg.blockwise_attention``, at every one of those call sites
    (training too: it takes precedence over the flash kernel, as in the
    JAX package): ``_blockwise_attention``, the online softmax over key
    blocks of ``cfg.attention_block_k``, which never holds an S x Sk score
    buffer (also plain PyTorch, as the JAX twin is plain jnp);
  * paged serving decode (``paged_attention``): the registry's
    ``decode_attention`` under ``cfg.decode_kernel``.

Caches are updated in place (indexed assignment) where the JAX package
returns updated copies.

The mixture of experts (``moe``) dispatches by capacity as the JAX package
does, with either of its routes: ``_moe_scatter`` (tokens scattered into
(E, C, d) expert buffers) or, with ``cfg.moe_groups``, GShard's grouped
one-hot einsums (``_moe_grouped_einsum``). The top-k takes the lower expert
index first among equal router probabilities, as ``jax.lax.top_k`` does
(``_top_k``); the expert products are batched matrix products, which the
JAX package also computes outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as KO
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# the rank's grid (the JAX use_constraint_mesh / shard_act)
# ---------------------------------------------------------------------------

_GRID = None


class use_constraint_mesh:
    """Context: the layers compute the share of `grid` (a
    ``train.collectives.Grid``) of every product they make; ``None`` (or
    no context) is the single-device model."""

    def __init__(self, grid):
        self.grid = grid
        self.prev = None

    def __enter__(self):
        global _GRID
        self.prev = _GRID
        _GRID = self.grid
        return self.grid

    def __exit__(self, *exc):
        global _GRID
        _GRID = self.prev
        return False


def current_grid():
    """The grid set by ``use_constraint_mesh``, or None."""
    return _GRID


def col_parallel(grid, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``contract(x, w)`` on this rank's columns of w, x held whole by every
    rank of the model line (q, k, v, the MLP's gate and up, the logits).
    The contraction is whole here, so the forward and the weight's
    gradient are the unsharded products (compute-dtype ``mm``); x's
    gradient is a partial sum over the rank's columns, formed in float32,
    summed over the line in rank order and rounded once, as the unsharded
    product's is."""
    if grid.model.size == 1:
        return contract(x, w)
    return _ColParallel.apply(x, w, grid.model)


def row_parallel(grid, x: torch.Tensor, w: torch.Tensor, k: int = 1) -> torch.Tensor:
    """``contract(x, w, k)`` with the contraction split over "model" (``wo``
    and the MLP's ``wd``): this rank's partial product in float32 (of the
    compute-dtype operands), summed over the line in rank order, rounded
    once to x's dtype. The gradients contract whole dimensions: the
    unsharded products' (compute-dtype ``mm``)."""
    if grid.model.size == 1:
        return contract(x, w, k)
    return _RowParallel.apply(x, w, grid.model, k)


def _mm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated and returned in float32: on the card a
    compute-dtype GEMM with a float32 output (the tensor cores' own
    accumulation, as the unsharded product's), elsewhere a float32 ``mm``
    of the upcast operands."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float().mm(b.float())


class _ColParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, comm):
        ctx.save_for_backward(x, w)
        ctx.comm = comm
        return contract(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        kdim = w.shape[0]
        part = _mm32(g.reshape(-1, w.numel() // kdim), w.reshape(kdim, -1).t())
        gx = ctx.comm.all_reduce(part).to(x.dtype).reshape(x.shape)
        gw = x.reshape(-1, kdim).t().mm(g.reshape(-1, w.numel() // kdim)).reshape(w.shape)
        return gx, gw, None


class _RowParallel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, comm, k):
        ctx.save_for_backward(x, w)
        ctx.k = k
        kdim = math.prod(w.shape[:k])
        part = _mm32(x.reshape(-1, kdim), w.reshape(kdim, -1))
        out = comm.all_reduce(part).to(x.dtype)
        return out.reshape(*x.shape[:x.dim() - k], *w.shape[k:])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        kdim = math.prod(w.shape[:ctx.k])
        g2 = g.contiguous().reshape(-1, w.numel() // kdim)
        w2 = w.reshape(kdim, -1)
        gx = g2.mm(w2.t()).reshape(x.shape)
        gw = x.reshape(-1, kdim).t().mm(g2).reshape(w.shape)
        return gx, gw, None, None


# ---------------------------------------------------------------------------
# norm / rope / softcap
# ---------------------------------------------------------------------------

def rms_norm_def(d: int) -> ParamDef:
    """A norm scale of width `d`, initialised to ones."""
    return ParamDef((d,), (None,), init="ones")


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float, over=None) -> torch.Tensor:
    """RMS norm with float32 statistics, returned in x's dtype. With `over`
    (an ``AxisComm`` whose ranks hold the other blocks of x's last
    dimension, `scale` this rank's block) the mean of squares is summed
    over that line in rank order (``psum``) before the ``rsqrt``."""
    xf = x.float()
    if over is None or over.size == 1:
        var = (xf * xf).mean(-1, keepdim=True)
    else:
        var = over.psum((xf * xf).sum(-1, keepdim=True)) / (x.shape[-1] * over.size)
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

def attention_defs(cfg: ModelConfig, cross: bool = False) -> dict:
    """Attention projections (and qkv biases where the config has them);
    cross attention (`cross`) has the same leaves, as in the JAX package."""
    del cross
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


def contract(x: torch.Tensor, w: torch.Tensor, k: int = 1) -> torch.Tensor:
    """x (..., K) times w (K, N...), K being w's first `k` axes: a product
    with no batch dimension (the JAX einsums ``bsd,dhq->bshq`` and
    ``bshq,hqd->bsd``), computed as one 2-D ``mm``. ``torch.einsum`` would
    lower it to a ``bmm`` of batch 1, which the "dots" remat policy
    (``transformer._dots_policy``) could not tell from a batched product."""
    kdim = math.prod(w.shape[:k])
    out = torch.mm(x.reshape(-1, kdim), w.reshape(kdim, -1))
    return out.reshape(*x.shape[:x.dim() - k], *w.shape[k:])


def _proj(cfg: ModelConfig, p: dict, x: torch.Tensor, w: str, grid=None) -> torch.Tensor:
    """x (B, S, d) through projection `w` (and its bias) in the compute dtype
    (column-parallel under a `grid`)."""
    dt = cfg.compute_dtype
    if grid is None:
        out = contract(x.to(dt), p[w].to(dt))  # bsd,dhq->bshq
    else:
        out = col_parallel(grid, x.to(dt), p[w].to(dt))
    bias = "b" + w[1]
    return out + p[bias].to(dt) if bias in p else out


def _qkv(cfg: ModelConfig, p: dict, x: torch.Tensor, kv_x: torch.Tensor | None = None):
    """q (B, S, H, Dh) of x, k and v (B, Sk, KV, Dh) of `kv_x` (default x)."""
    kv_src = x if kv_x is None else kv_x
    return _proj(cfg, p, x, "wq"), _proj(cfg, p, kv_src, "wk"), _proj(cfg, p, kv_src, "wv")


def multi_head_attention(
    cfg: ModelConfig,
    p: dict,
    x: torch.Tensor,  # (B, S, d)
    positions: torch.Tensor,  # (B, S)
    *,
    kv_x: torch.Tensor | None = None,  # cross-attention source (B, Sk, d)
    kv_positions: torch.Tensor | None = None,
    causal: bool = True,
    window: int | None = None,
    use_rope: bool = True,
    cache: dict | None = None,  # {'k', 'v': (B, L, KV, Dh), 'pos': int}
) -> tuple[torch.Tensor, dict | None]:
    """GQA attention, as the JAX layer computes it.

    Self-attention (no `kv_x`) with a cache writes this step's K/V in
    place at ``cache['pos']`` and attends over the ``pos + S`` tokens
    written so far; the returned cache is ``{'k', 'v', 'pos': pos + S}``
    over the same tensors. Cross attention (`kv_x`) is never causal: with
    a cache it reads the cached encoder K/V (``encode_cross_cache``; `kv_x`
    is not read) and returns the cache as it was; without one it projects
    `kv_x` (no rope under ``use_rope=False``).
    """
    dt = cfg.compute_dtype
    B, S, _ = x.shape
    cross = kv_x is not None
    kv_pos = positions if kv_positions is None else kv_positions
    grid = _GRID
    if grid is not None:
        if cross or cache is not None:
            raise NotImplementedError(
                "under a grid only the training path's self-attention is sharded "
                "(ROADMAP Queue 1 item 10)")
        q, k, v = _grid_qkv(cfg, grid, p, x)
        if use_rope:
            k = rope(k, kv_pos, cfg.rope_theta)
    elif cross and cache is not None:
        q, k, v = _proj(cfg, p, x, "wq"), cache["k"], cache["v"]
    else:
        q, k, v = _qkv(cfg, p, x, kv_x)
        if use_rope:
            k = rope(k, kv_pos, cfg.rope_theta)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)

    new_cache = cache
    valid_len = None
    if cache is not None and not cross:
        pos = int(cache["pos"])
        if pos + S > cache["k"].shape[1]:
            raise ValueError(
                f"cache holds {cache['k'].shape[1]} tokens; cannot write "
                f"{S} at position {pos}"
            )
        cache["k"][:, pos:pos + S] = k.to(cache["k"].dtype)
        cache["v"][:, pos:pos + S] = v.to(cache["v"].dtype)
        new_cache = {"k": cache["k"], "v": cache["v"], "pos": pos + S}
        q_pos = torch.arange(S, device=x.device) + pos
        valid_len = pos + S
        if cfg.blockwise_attention:
            # the whole cache, masked past valid_len, as the JAX package
            # reads it (the blocks past it are skipped: see the function)
            k, v = cache["k"], cache["v"]
        else:
            # positions past pos + S are masked in the JAX package; they
            # are simply not read here
            k, v = cache["k"][:, :valid_len], cache["v"][:, :valid_len]
        k_pos = torch.arange(k.shape[1], device=x.device)
    elif cache is not None:
        q_pos = torch.arange(S, device=x.device)
        k_pos = kv_pos[0]
    else:
        q_pos, k_pos = positions[0], kv_pos[0]

    H, KV = q.shape[2], k.shape[2]  # cfg's, or this rank's under a grid
    G = H // KV
    if (cache is None and not cross and cfg.attention_kernel != "jnp"
            and not cfg.blockwise_attention):
        o = KO.dispatch(
            "flash_attention",
            q.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(),
            causal=causal, window=window, softcap=cfg.attn_softcap,
            mode=cfg.attention_kernel,
        )
        out = o.transpose(1, 2).to(dt)  # (B, S, H, Dh)
    elif cfg.blockwise_attention:
        # the queries are scaled in the compute dtype (the JAX weak-typed
        # scalar is rounded to it first), then upcast inside
        scale = torch.tensor(cfg.head_dim ** -0.5, dtype=q.dtype, device=q.device)
        out = _blockwise_attention(
            q.reshape(B, S, KV, G, cfg.head_dim) * scale, k, v, q_pos, k_pos,
            causal=causal and not cross, window=window, softcap_v=cfg.attn_softcap,
            block_k=cfg.attention_block_k, valid_len=valid_len,
        ).to(dt).reshape(B, S, H, cfg.head_dim)
    else:
        qg = q.reshape(B, S, KV, G, cfg.head_dim)
        scores = torch.einsum("bskgh,btkh->bkgst", qg, k) * cfg.head_dim ** -0.5
        scores = softcap(scores.float(), cfg.attn_softcap)
        mask = torch.ones((S, k.shape[1]), dtype=torch.bool, device=x.device)
        if causal and not cross:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window is not None:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        scores = torch.where(mask, scores, NEG_INF)
        probs = torch.softmax(scores, dim=-1).to(dt)
        out = torch.einsum("bkgst,btkh->bskgh", probs, v)
        out = out.reshape(B, S, H, cfg.head_dim)
    if grid is not None:
        return row_parallel(grid, out, p["wo"].to(dt), 2), new_cache
    y = contract(out, p["wo"].to(dt), 2)  # bshq,hqd->bsd
    return y, new_cache


def _grid_qkv(cfg: ModelConfig, grid, p: dict, x: torch.Tensor):
    """q (B, S, H / M, Dh) on this rank's heads; k and v on its kv heads.
    Kv heads left whole (their count does not split over the M model
    ranks) are projected whole from x, their gradient summed over
    ``"model"`` (every rank's q heads use a share of them), and each of the
    rank's q heads reads kv head ``global_q // group``: the kv heads its
    heads use, each repeated for its heads (the flash kernel's grouping)
    when every used kv head serves the same number of the rank's heads,
    else one kv head a q head."""
    q = _proj(cfg, p, x, "wq", grid)
    if p["wk"].shape[1] * grid.model.size == cfg.n_kv_heads or grid.model.size == 1:
        return q, _proj(cfg, p, x, "wk", grid), _proj(cfg, p, x, "wv", grid)
    h_loc = q.shape[2]
    group = cfg.n_heads // cfg.n_kv_heads
    want = [(grid.model.index * h_loc + j) // group for j in range(h_loc)]
    used = sorted(set(want))
    per = h_loc // len(used)
    if want != [u for u in used for _ in range(per)]:
        used = want  # an uneven share: one kv head a q head
    idx = torch.tensor(used, device=x.device)
    # whole kv projections; their gradients (each rank's heads' share)
    # summed over the line in float32, rounded once
    kv = [grid.model.copy_to(_proj(cfg, p, x, w).float()).to(cfg.compute_dtype)
          .index_select(2, idx) for w in ("wk", "wv")]
    return q, kv[0], kv[1]


# ---------------------------------------------------------------------------
# blockwise attention: the online softmax over key blocks (the plain twin of
# kernels/flash_attention.py). No (S x Sk) buffer is ever held: the working
# set is one key block a step. Enabled by ``ModelConfig.blockwise_attention``.
# ---------------------------------------------------------------------------

def _blockwise_attention(
    qg: torch.Tensor,  # (B, Sq, KV, G, Dh), pre-scaled queries
    k: torch.Tensor,  # (B, Sk, KV, Dh)
    v: torch.Tensor,  # (B, Sk, KV, Dh)
    q_pos: torch.Tensor,  # (Sq,)
    k_pos: torch.Tensor,  # (Sk,)
    *,
    causal: bool,
    window: int | None,
    softcap_v: float | None,
    block_k: int,
    valid_len: int | None = None,  # a contiguous cache's fill level
) -> torch.Tensor:
    """Attention out (B, Sq, KV, G, Dh) in float32, the JAX function's
    arithmetic: scores, softcap and softmax in float32, masked scores
    -1e30, the m / l / acc recurrence over key blocks of `block_k`, and
    ``acc / max(l, 1e-30)``. Keys padded to a whole block get position
    -1e9 and are masked by ``p >= 0``. A Python loop takes the place of
    ``lax.scan``; autograd differentiates through it.

    With `valid_len`, keys at positions >= valid_len are masked, and the
    blocks that hold only such keys are not computed: each query's own
    position (< valid_len) lies in an earlier block, so by then every row's
    running max is a real score, and a masked block would leave m, l and
    acc exactly as they were (its alpha is exp(0) = 1, its p exp(-1e30 - m)
    = 0).
    """
    B, Sq, KV, G, Dh = qg.shape
    Sk = k.shape[1]
    block_k = min(block_k, Sk)
    if valid_len is not None:
        used = min(Sk, -(-valid_len // block_k) * block_k)
        k, v, k_pos, Sk = k[:, :used], v[:, :used], k_pos[:used], used
    pad = (-Sk) % block_k
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        k_pos = F.pad(k_pos, (0, pad), value=-10**9)
    nb = k.shape[1] // block_k

    qf = qg.float()
    acc = torch.zeros((B, KV, G, Sq, Dh), dtype=torch.float32, device=qg.device)
    m = torch.full((B, KV, G, Sq), NEG_INF, dtype=torch.float32, device=qg.device)
    l = torch.zeros((B, KV, G, Sq), dtype=torch.float32, device=qg.device)
    for j in range(nb):
        blk = slice(j * block_k, (j + 1) * block_k)
        p_t = k_pos[blk]
        s = torch.einsum("bskgh,btkh->bkgst", qf, k[:, blk].float())
        if softcap_v is not None:
            s = softcap_v * torch.tanh(s / softcap_v)
        mask = (p_t >= 0)[None, :].expand(Sq, block_k)
        if causal:
            mask = mask & (q_pos[:, None] >= p_t[None, :])
        if window is not None:
            mask = mask & (q_pos[:, None] - p_t[None, :] < window)
        if valid_len is not None:
            mask = mask & (p_t < valid_len)[None, :]
        s = torch.where(mask, s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_cur)
        p = torch.exp(s - m_cur[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bkgst,btkh->bkgsh", p, v[:, blk].float())
        m = m_cur
    out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B, KV, G, Sq, Dh)
    return out.permute(0, 3, 1, 2, 4)


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
    """silu(x @ wg) * (x @ wu) @ wd in the compute dtype (under a grid: on
    this rank's block of the hidden units, wd row-parallel)."""
    dt = cfg.compute_dtype
    grid = _GRID
    if grid is not None:
        h = F.silu(col_parallel(grid, x, p["wg"].to(dt))) * col_parallel(grid, x, p["wu"].to(dt))
        return row_parallel(grid, h, p["wd"].to(dt))
    h = F.silu(x @ p["wg"].to(dt)) * (x @ p["wu"].to(dt))
    return h @ p["wd"].to(dt)


# ---------------------------------------------------------------------------
# Mixture of Experts (capacity-based top-k dispatch)
# ---------------------------------------------------------------------------

def moe_defs(cfg: ModelConfig) -> dict:
    """Router, the stacked experts' gate/up/down and the shared expert."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    defs = {
        "router": ParamDef((d, e), ("embed", None), scale=0.02),
        "wg": ParamDef((e, d, f), ("expert", "embed", None)),
        "wu": ParamDef((e, d, f), ("expert", "embed", None)),
        "wd": ParamDef((e, f, d), ("expert", None, "embed")),
    }
    if cfg.shared_expert_d_ff:
        defs["shared"] = mlp_defs(cfg, cfg.shared_expert_d_ff)
    return defs


def moe(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): the grouped route with ``cfg.moe_groups``,
    else the scatter route."""
    if cfg.moe_groups > 0:
        if _GRID is not None:
            raise NotImplementedError(
                "the grouped MoE route (moe_groups > 0) has no layout under a grid "
                "(ROADMAP Queue 1 item 10)")
        return _moe_grouped_einsum(cfg, p, x)
    return _moe_scatter(cfg, p, x)


def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries of x's last axis and their indices, the lower
    index first among equal values (``jax.lax.top_k``'s order; a stable
    descending sort gives it on every device, ``torch.topk`` promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(cfg: ModelConfig, p: dict, xt: torch.Tensor):
    """Router top-k: (renormalised float32 weights, expert ids), (..., K).
    The logits are computed in the compute dtype and read in float32."""
    logits = (xt @ p["router"].to(cfg.compute_dtype)).float()
    top_p, top_i = _top_k(torch.softmax(logits, dim=-1), cfg.experts_per_token)
    return top_p / top_p.sum(-1, keepdim=True), top_i


def _experts(cfg: ModelConfig, p: dict, buf: torch.Tensor) -> torch.Tensor:
    """Every expert's gated MLP on its buffer: buf (..., E, C, d) -> same."""
    dt = cfg.compute_dtype
    h = F.silu(torch.matmul(buf, p["wg"].to(dt))) * torch.matmul(buf, p["wu"].to(dt))
    return torch.matmul(h, p["wd"].to(dt))


def math_gcd_groups(g: int, t: int) -> int:
    """The largest group count <= g that divides t tokens."""
    while t % g:
        g -= 1
    return max(1, g)


def grouped_slots(cfg: ModelConfig, p: dict, x: torch.Tensor):
    """The grouped route's dispatch: (xt (G, Tg, d), top_p, top_i, pos_k,
    keep, C). Tokens split into G groups; a (token, slot)'s position in its
    expert counts token-major within its group, and it is kept below the
    capacity C (8-aligned)."""
    B, S, d = x.shape
    T = B * S
    G = math_gcd_groups(cfg.moe_groups, T)
    Tg = T // G
    E, K = cfg.n_experts, cfg.experts_per_token
    C = max(1, int(Tg * K / E * cfg.capacity_factor))
    C = -(-C // 8) * 8  # small alignment
    xt = x.reshape(G, Tg, d)
    top_p, top_i = _route(cfg, p, xt)  # (G, Tg, K)
    oh_e = F.one_hot(top_i, E)  # (G, Tg, K, E)
    pos = torch.cumsum(oh_e.reshape(G, Tg * K, E), dim=1).reshape(G, Tg, K, E) * oh_e - 1
    pos_k = pos.max(-1).values  # -1 where not routed
    keep = (pos_k >= 0) & (pos_k < C)
    return xt, top_p, top_i, pos_k, keep, C


def _moe_grouped_einsum(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """GShard-style dispatch: per group, one-hot dispatch and combine
    einsums (the JAX route keeps every contraction local to a device pair;
    here it is one card's batched products).

    buf[g,e,c,:] = sum_t dispatch[g,t,e,c] * x[g,t,:]
    y[g,t,:]     = sum_{e,c} combine[g,t,e,c] * out[g,e,c,:]
    """
    dt = cfg.compute_dtype
    B, S, d = x.shape
    xt, top_p, top_i, pos_k, keep, C = grouped_slots(cfg, p, x)
    oh_e = F.one_hot(top_i, cfg.n_experts).to(dt)  # (G, Tg, K, E)
    # one_hot of a dropped slot is all zeros, as jax.nn.one_hot(-1) is
    oh_c = ((pos_k[..., None] == torch.arange(C, device=x.device)) & keep[..., None]).to(dt)
    w_k = torch.where(keep, top_p, 0.0).to(dt)
    dispatch = torch.einsum("gtke,gtkc->gtec", oh_e, oh_c)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", oh_e, oh_c, w_k)
    buf = torch.einsum("gtec,gtd->gecd", dispatch, xt.to(dt))  # (G, E, C, d)
    y = torch.einsum("gtec,gecd->gtd", combine, _experts(cfg, p, buf))
    if cfg.shared_expert_d_ff:
        y = y + mlp(cfg, p["shared"], xt.reshape(B, S, d)).reshape(y.shape)
    return y.reshape(B, S, d)


def scatter_slots(cfg: ModelConfig, p: dict, x: torch.Tensor, grid=None):
    """The scatter route's dispatch over the T*K flattened (token, slot)
    pairs: (xt (T, d), flat_w, flat_e, pos, keep, C). A pair's position in
    its expert counts token-major; it is kept below the capacity C
    (128-aligned above 128).

    Under a `grid` x holds this data rank's rows, a contiguous block of the
    global token order: T and C are the global ones (the data line's rows
    together) and a position is the global cumsum, the rank's own plus the
    pairs the data ranks before it route to the same expert."""
    B, S, d = x.shape
    T = B * S * (1 if grid is None else grid.data.size)
    E, K = cfg.n_experts, cfg.experts_per_token
    C = max(1, int(T * K / E * cfg.capacity_factor))
    C = -(-C // 128) * 128 if C > 128 else C
    xt = x.reshape(-1, d)
    top_p, top_i = _route(cfg, p, xt)  # (T, K)
    flat_e = top_i.reshape(-1)
    onehot = F.one_hot(flat_e, E)  # (T*K, E)
    pos = (torch.cumsum(onehot, dim=0) * onehot).sum(-1) - 1
    if grid is not None and grid.data.size > 1:
        pos = pos + _routed_before(grid, onehot.sum(0))[flat_e]
    return xt, top_p.reshape(-1).to(cfg.compute_dtype), flat_e, pos, pos < C, C


def _routed_before(grid, counts: torch.Tensor) -> torch.Tensor:
    """(E,) the pairs the data ranks before this one route to each expert:
    every rank's `counts` gathered over ``"data"``, the earlier ones summed."""
    return grid.data.all_gather(counts[None], 0)[:grid.data.index].sum(0)


def _moe_scatter(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x (B, S, d) -> (B, S, d): deterministic capacity-based dispatch into
    (E, C, d) expert buffers. A dropped pair adds zeros at its expert's
    position 0 (``index_put_`` accumulating, as the JAX ``.at[].add``), so
    no kept token's bits change and no host sync is needed."""
    if _GRID is not None:
        return _grid_moe_scatter(cfg, _GRID, p, x)
    dt = cfg.compute_dtype
    B, S, d = x.shape
    K = cfg.experts_per_token
    xt, flat_w, flat_e, pos, keep, C = scatter_slots(cfg, p, x)
    safe_pos = torch.where(keep, pos, 0)
    tok_rep = torch.where(keep[:, None], xt.to(dt).repeat_interleave(K, dim=0), 0.0)
    buf = torch.zeros((cfg.n_experts, C, d), dtype=dt, device=x.device)
    buf.index_put_((flat_e, safe_pos), tok_rep, accumulate=True)
    gathered = _experts(cfg, p, buf)[flat_e, safe_pos]  # (T*K, d)
    gathered = torch.where(keep[:, None], gathered, 0.0) * flat_w[:, None]
    y = gathered.reshape(-1, K, d).sum(1)
    if cfg.shared_expert_d_ff:
        y = y + mlp(cfg, p["shared"], xt.reshape(B, S, d)).reshape(-1, d)
    return y.reshape(B, S, d)


def _grid_moe_scatter(cfg: ModelConfig, grid, p: dict, x: torch.Tensor) -> torch.Tensor:
    """``_moe_scatter`` on a rank of the grid (expert parallelism over
    "model"): model rank m holds experts [m E/M, (m + 1) E/M) (`p`'s
    expert leaves are its block). The routing (router gathered whole,
    top-k, renormalisation, global positions) is computed alike on every
    rank of the model line, so they agree on the kept pairs. The rank fills
    (E/M, C, d) buffers with its own kept pairs of its experts, at their
    global positions, runs its experts, writes their outputs into the
    (T*K, d) slot rows and zeros elsewhere, and sums the rows over "model"
    (``reduce_from``): each slot has one contributor, so the sum is exact.
    The weighting and the sum over the K slots then run on every rank as in
    the unsharded layer. x's gradient through the dispatch is each rank's
    share (its experts' pairs), formed in float32 and summed over "model"
    (``copy_to``)."""
    dt = cfg.compute_dtype
    B, S, d = x.shape
    K = cfg.experts_per_token
    xt, flat_w, flat_e, pos, keep, C = scatter_slots(cfg, p, x, grid)
    n_loc = p["wg"].shape[0]
    local = flat_e - grid.model.index * n_loc
    mine = keep & (local >= 0) & (local < n_loc)
    safe_pos, safe_e = torch.where(mine, pos, 0), torch.where(mine, local, 0)
    xk = grid.model.copy_to(xt.float()).repeat_interleave(K, dim=0).to(dt)
    buf = torch.zeros((n_loc, C, d), dtype=dt, device=x.device)
    buf.index_put_((safe_e, safe_pos), torch.where(mine[:, None], xk, 0.0), accumulate=True)
    out = torch.where(mine[:, None], _experts(cfg, p, buf)[safe_e, safe_pos], 0.0)
    gathered = grid.model.reduce_from(out) * flat_w[:, None]  # (T*K, d)
    y = gathered.reshape(-1, K, d).sum(1)
    if cfg.shared_expert_d_ff:
        y = y + mlp(cfg, p["shared"], x).reshape(-1, d)
    return y.reshape(B, S, d)
