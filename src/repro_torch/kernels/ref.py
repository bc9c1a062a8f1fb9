"""Plain PyTorch versions of the CUDA kernels (counterparts of ``repro.kernels.ref``).

They are the CPU path of every kernel wrapper and the oracle the kernels are
held to on the card. The sparse pair computes in the input dtype (the JAX
oracles do the same for float64 inputs); the attention pair computes in
float32 from bf16 or float32 inputs and returns the input dtype, as the JAX
oracles do; ``flash_attention_bwd_ref`` is the dense counterpart of the
blocked gradient kernels, computing in float32. The scatter runs column by
column in k order with no atomics, so it is deterministic on the CPU and on
the card and folds duplicate indices in the same order as the JAX oracle's
sequential scatter.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


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
