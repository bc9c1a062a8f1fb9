"""Plain PyTorch versions of the CUDA kernels (counterparts of ``repro.kernels.ref``).

They are the CPU path of every kernel wrapper and the oracle the kernels are
held to on the card. The sparse pair computes in the input dtype (the JAX
oracles do the same for float64 inputs); the attention pair computes in
float32 from bf16 or float32 inputs and returns the input dtype, as the JAX
oracles do; ``flash_attention_bwd_ref`` is the dense counterpart of the
blocked gradient kernels, computing in float32. The scatter runs column by
column in k order with no atomics, so it is deterministic on the CPU and on
the card and folds duplicate indices in the same order as the JAX oracle's
sequential scatter. ``block_topk_ref`` selects by a stable sort of integer
magnitude keys, so among equal magnitudes the lower index comes first, as
``jax.lax.top_k`` and the Pallas body's first-occurrence argmax take them,
and every NaN ranks equal (above +inf), in index order, on any device.
``ssd_chunk_ref`` is
the within-chunk SSD of Mamba2 and ``ssd_chunk_bwd_ref`` its gradient, the
Pallas backward's formulas written out in tensor ops; both compute in the
input dtype, as the JAX oracle does.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
_TOPK_CHUNK = 1 << 24  # elements per sort in block_topk_ref


def sparse_dot_ref(psi: torch.Tensor, idx: torch.Tensor, val: torch.Tensor) -> torch.Tensor:
    """Per-node sparse dot: out[n] = sum_k val[n,k] * psi[n, idx[n,k]]."""
    return (val * torch.gather(psi, 1, idx.long())).sum(-1)


def sparse_axpy_ref(
    psi: torch.Tensor,
    idx: torch.Tensor,
    val: torch.Tensor,
    coef: torch.Tensor,
    rho: torch.Tensor,
) -> torch.Tensor:
    """Sparse AXPY: out[n] = rho[n] * psi[n] + coef[n] * scatter(val[n] at idx[n])."""
    out = rho[:, None] * psi
    src = coef[:, None] * val
    rows = torch.arange(psi.shape[0], device=psi.device)
    cols = idx.long()
    for j in range(idx.shape[1]):
        # one column: every node writes its own row, so no index repeats
        out[rows, cols[:, j]] = out[rows, cols[:, j]] + src[:, j]
    return out


def attention_scores(q, k, *, causal=True, window=None, softcap=None):
    """Grouped-GQA float32 scores (B, Hkv, g, S, Sk), scaled and softcapped,
    and the (S, Sk) boolean mask (True = attend).

    q (B, Hq, S, D), k (B, Hkv, Sk, D); query head h reads kv head h // g.
    Positions count from 0 on both axes.
    """
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    qg = q.reshape(B, Hkv, g, S, D).float() / math.sqrt(D)
    s = torch.einsum("bkgsd,bktd->bkgst", qg, k.float())
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(S, device=q.device)
    kp = torch.arange(Sk, device=q.device)
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qp[:, None] >= kp[None, :]
    if window is not None:
        mask &= qp[:, None] - kp[None, :] < window
    return s, mask


def attention_ref(q, k, v, causal=True, window=None, softcap=None, return_lse=False):
    """Dense softmax attention: o (B, Hq, S, D) in q.dtype, and with
    `return_lse` also the per-row log-sum-exp (B, Hq, S) float32 of the
    masked scores (masked entries count as -1e30, as in the kernel)."""
    B, Hq, S, D = q.shape
    s, mask = attention_scores(q, k, causal=causal, window=window, softcap=softcap)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    o = o.reshape(B, Hq, S, D).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, Hq, S)
    return o


def flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True, window=None, softcap=None):
    """The attention gradient (dq, dk, dv) from the saved (q, k, v, o, lse)
    and the output cotangent do, densely: the per-tile math of the JAX
    ``_bwd_tile`` over the whole (S, Sk) at once.

    p = exp(s - lse) with masked scores at -1e30 (so p = 0 there),
    ds = p (dp - delta) with dp = do v^T and delta = rowsum(do * o), times
    the softcap's 1 - (s / cap)^2 on masked-in entries. Computes in float32;
    returns each gradient in its input's dtype, dk and dv summed over the
    GQA group.
    """
    B, Hq, S, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    g = Hq // Hkv
    s, mask = attention_scores(q, k, causal=causal, window=window, softcap=softcap)
    qg = q.reshape(B, Hkv, g, S, D).float() / math.sqrt(D)
    dog = do.reshape(B, Hkv, g, S, D).float()
    kf, vf = k.float(), v.float()
    p = torch.exp(torch.where(mask, s, NEG_INF) - lse.reshape(B, Hkv, g, S, 1))
    delta = (do.float() * o.float()).sum(-1).reshape(B, Hkv, g, S, 1)
    dp = torch.einsum("bkgsd,bktd->bkgst", dog, vf)
    ds = p * (dp - delta)
    if softcap is not None:
        ds = ds * torch.where(mask, 1.0 - torch.square(s / softcap), 0.0)
    dq = torch.einsum("bkgst,bktd->bkgsd", ds, kf) / math.sqrt(D)
    dk = torch.einsum("bkgst,bkgsd->bktd", ds, qg)
    dv = torch.einsum("bkgst,bkgsd->bktd", p, dog)
    return dq.reshape(B, Hq, S, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def decode_attention_ref(q, k_pool, v_pool, table, lengths, window=None, softcap=None):
    """Paged single-query attention: gather through the block table, then
    masked GQA softmax attention over the flattened pages.

    q (B, Hq, D); pools (n_blocks, block_size, Hkv, D); table (B, n_pages)
    int32; lengths (B,) int32 counts the valid tokens including the current
    one, which sits at position lengths - 1 (the window is measured from
    it). Rows with length 0 return zeros. -> (B, Hq, D) in q.dtype.
    """
    B, Hq, D = q.shape
    block_size, Hkv = k_pool.shape[1], k_pool.shape[2]
    g = Hq // Hkv
    L = table.shape[1] * block_size
    t = table.long()
    k = k_pool[t].reshape(B, L, Hkv, D).float()
    v = v_pool[t].reshape(B, L, Hkv, D).float()
    qg = q.reshape(B, Hkv, g, D).float() / math.sqrt(D)
    s = torch.einsum("bkgd,btkd->bkgt", qg, k)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(L, device=q.device)
    lens = lengths.long()
    mask = pos[None, :] < lens[:, None]  # (B, L)
    if window is not None:
        mask &= pos[None, :] >= lens[:, None] - window
    m4 = mask[:, None, None, :]
    p = torch.softmax(torch.where(m4, s, NEG_INF), dim=-1)
    p = torch.where(m4, p, 0.0)  # a fully masked row would softmax to uniform
    o = torch.einsum("bkgt,btkd->bkgd", p, v)
    return o.reshape(B, Hq, D).to(q.dtype)


def decode_split_ranges(length: int, n_valid_max: int, window, tile: int, splits: int):
    """The positions [lo, hi) each split of a sequence takes, as
    ``csrc/decode_attention.cu`` cuts them: [start, n_valid) (start =
    max(0, length - window) with a window, n_valid = length clipped to the
    table's n_valid_max positions) is covered by whole tiles from the tile
    holding start; the splits take ceil(tiles / splits) tiles each, in
    order (the last ones may take none); a range is clipped to [start,
    n_valid) and is empty (lo >= hi) for a split with no valid position."""
    n_valid = min(max(length, 0), n_valid_max)
    start = max(0, length - window) if window is not None else 0
    t0 = start // tile * tile
    n_tiles = -(-(n_valid - t0) // tile) if n_valid > start else 0
    per = -(-n_tiles // splits)
    out = []
    for s in range(splits):
        first = min(s * per, n_tiles)
        last = min(first + per, n_tiles)
        out.append((max(start, t0 + first * tile), min(n_valid, t0 + last * tile)))
    return out


def decode_attention_split_ref(q, k_pool, v_pool, table, lengths, window=None, softcap=None,
                               *, splits: int, tile: int):
    """``decode_attention_ref`` computed as the CUDA kernel splits it: each
    split's (m, l, acc) over its range (``decode_split_ranges``; an empty
    split leaves m = NEG_INF, l = 0, acc = 0), then merged in split order,
    acc / max(l, 1e-30). Float32; for the tests (it loops over sequences
    and splits in Python)."""
    B, Hq, D = q.shape
    block_size, Hkv = k_pool.shape[1], k_pool.shape[2]
    g = Hq // Hkv
    n_pages = table.shape[1]
    L = n_pages * block_size
    k = k_pool[table.long()].reshape(B, L, Hkv, D).float()
    v = v_pool[table.long()].reshape(B, L, Hkv, D).float()
    qg = q.reshape(B, Hkv, g, D).float() / math.sqrt(D)
    out = torch.zeros(B, Hkv, g, D, dtype=torch.float32, device=q.device)
    for b in range(B):
        parts = []
        for lo, hi in decode_split_ranges(int(lengths[b]), L, window, tile, splits):
            if lo >= hi:
                parts.append((torch.full((Hkv, g), NEG_INF, device=q.device),
                              torch.zeros(Hkv, g, device=q.device),
                              torch.zeros(Hkv, g, D, device=q.device)))
                continue
            s = torch.einsum("kgd,tkd->kgt", qg[b], k[b, lo:hi])
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            parts.append((m, p.sum(-1), torch.einsum("kgt,tkd->kgd", p, v[b, lo:hi])))
        m_all = torch.stack([m for m, _, _ in parts]).amax(0)
        acc = torch.zeros(Hkv, g, D, device=q.device)
        l_all = torch.zeros(Hkv, g, device=q.device)
        for m, l_s, a in parts:  # in split order
            f = torch.exp(m - m_all)
            acc = acc + a * f[..., None]
            l_all = l_all + l_s * f
        out[b] = acc / torch.clamp(l_all, min=1e-30)[..., None]
    return out.reshape(B, Hq, D).to(q.dtype)


_INT_OF = {torch.float64: torch.int64, torch.float32: torch.int32,
           torch.bfloat16: torch.int16, torch.float16: torch.int16}


def magnitude_key(x: torch.Tensor) -> torch.Tensor:
    """The integer rank key of ``x`` (same width): the bits of ``|x|`` (so
    -0.0 and 0.0 are equal), with every NaN, whatever its sign and payload,
    mapped to one key above +inf's. Orders like ``|x|`` does."""
    it = _INT_OF[x.dtype]
    inf = int(torch.tensor(float("inf"), dtype=x.dtype).view(it))
    key = x.view(it) & torch.iinfo(it).max
    return torch.where(key > inf, inf + 1, key)


def block_topk_ref(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k by |value|: (vals (nb, k) in x.dtype, idx (nb, k) int32).

    Rows are ranked by a stable descending sort of ``magnitude_key(x)``, so
    equal magnitudes keep their order: the lower index first. Every NaN
    ranks equal, above +inf, so NaNs too come in index order (a float sort
    may order NaNs by their bits on some devices). ``torch.topk`` promises
    no order among ties and is not used. Sorted in chunks of rows, so the
    sort's temporaries stay small whatever nb is.
    """
    nb, block = x.shape
    if not 1 <= k <= block:
        raise ValueError(f"k={k} must be in [1, {block}]")
    vals = torch.empty((nb, k), dtype=x.dtype, device=x.device)
    idx = torch.empty((nb, k), dtype=torch.int32, device=x.device)
    step = max(1, _TOPK_CHUNK // block)
    for lo in range(0, nb, step):
        rows = x[lo:lo + step]
        order = torch.sort(magnitude_key(rows), dim=1, descending=True,
                           stable=True).indices[:, :k]
        vals[lo:lo + step] = torch.gather(rows, 1, order)
        idx[lo:lo + step] = order.to(torch.int32)
    return vals, idx


def _ssd_decay(cum: torch.Tensor) -> torch.Tensor:
    """L (B, nc, i, j, nh) = exp(cum_i - cum_j) for i >= j, else 0.

    Masked BEFORE the exp: above the diagonal cum_i - cum_j > 0 can overflow
    exp to inf, and autograd through ``where(tri, exp(diff), 0)`` multiplies
    the masked lanes' zero cotangent by that inf: NaN (the JAX oracle's
    reason, ``repro/kernels/ref.py``)."""
    Q = cum.shape[2]
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=cum.device))[None, None, :, :, None]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    return torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)


def ssd_chunk_ref(xdt, cum, Bc, Cc):
    """Within-chunk SSD: (y_intra (B, nc, Q, nh, hd), chunk states
    (B, nc, nh, ds, hd)) of xdt (B, nc, Q, nh, hd), the inclusive log-decay
    cumsum cum (B, nc, Q, nh) and B, C (B, nc, Q, ds):
    ``y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xdt_j`` and
    ``state = sum_j B_j (x) exp(cum_last - cum_j) xdt_j``."""
    decay = _ssd_decay(cum)
    scores = torch.einsum("bcis,bcjs->bcij", Cc, Bc)
    y = torch.einsum("bcij,bcijh,bcjhd->bcihd", scores, decay, xdt)
    dte = torch.exp(cum[:, :, -1:, :] - cum)
    st = torch.einsum("bcjs,bcjh,bcjhd->bchsd", Bc, dte, xdt)
    return y, st


def ssd_chunk_bwd_ref(xdt, cum, Bc, Cc, dy, dst):
    """The gradient (dxdt, dcum, dB, dC) of ``ssd_chunk_ref`` from the
    cotangents dy (B, nc, Q, nh, hd) of y and dst (B, nc, nh, ds, hd) of the
    states, by the Pallas backward's formulas (``repro/kernels/ssd_scan.py``
    ``_ssd_bwd_kernel``) over every head at once. dcum is the cotangent of
    the cumsum output; dB and dC are summed over the heads."""
    L = _ssd_decay(cum)
    scores = torch.einsum("bcis,bcjs->bcij", Cc, Bc)
    SL = scores[..., None] * L  # (B, nc, i, j, nh)
    dM = torch.einsum("bcihd,bcjhd->bcijh", dy, xdt)
    dX = torch.einsum("bcijh,bcihd->bcjhd", SL, dy)
    dscores = (dM * L).sum(-1)
    dLL = dM * SL  # d cum through L = tri * exp(cum_i - cum_j)
    dcum = dLL.sum(3) - dLL.sum(2)  # row sums (over j) minus column sums (over i)
    dte = torch.exp(cum[:, :, -1:, :] - cum)  # decay to the end of the chunk
    dX = dX + dte[..., None] * torch.einsum("bcjs,bchsd->bcjhd", Bc, dst)
    dBw = torch.einsum("bcjhd,bchsd->bcjhs", xdt, dst)
    dB = torch.einsum("bcjhs,bcjh->bcjs", dBw, dte) + torch.einsum("bcij,bcis->bcjs",
                                                                     dscores, Cc)
    ddte = (dBw * Bc[:, :, :, None, :]).sum(-1) * dte
    dcum = dcum - ddte
    # cum_last appears in every dte: its row collects the whole sum
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + ddte.sum(2, keepdim=True)], dim=2)
    dC = torch.einsum("bcij,bcjs->bcis", dscores, Bc)
    return dX, dcum, dB, dC
