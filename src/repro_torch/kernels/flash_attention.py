"""Flash attention: the wrappers around ``csrc/flash_attention.cu`` (forward)
and ``csrc/flash_attention_bwd.cu`` (backward), and the autograd Function
that joins them.

Replaces the Pallas TPU kernels of ``repro/kernels/flash_attention.py``:
``flash_attention_fwd`` / ``_attn_kernel`` (blocked online-softmax
attention with GQA, causal masking, a sliding window and a softcap) and
``flash_attention_bwd`` / ``_attn_bwd_dq_kernel`` + ``_attn_bwd_dkv_kernel``
(the blocked gradient, probabilities recomputed per tile from the saved
log-sum-exp). ``transformer.forward`` runs them for every layer: the
scoring path the forward, training both. On Hopper the forward runs one
block per (batch, head, 64-row q tile) over 32-row K/V tiles in shared
memory; the backward one dq block per (batch, head, 64-row q tile) and one
dk/dv block per (batch, KV head, 32-row kv tile) that sums the GQA group
itself, without atomics (see the ``.cu`` headers). Ragged lengths are
masked in the kernels, not padded.

Contract (the JAX kernels', heads-major): q (B, Hq, S, D), k and v
(B, Hkv, Sk, D), bfloat16 or float32, D in {16, 32, 64, 128, 256}; query
head h reads kv head h // (Hq // Hkv). The forward returns o (B, Hq, S, D)
in q's dtype, and with ``return_lse`` also lse (B, Hq, S) float32. A row
that no key may attend (only possible without causal masking, with a
window, when S > Sk + window) has no defined output: the plain version
averages every value, the kernel (like the TPU kernel) only the tiles it
visits.

Gradients: when grad mode is on and q, k or v requires a gradient,
``flash_attention`` runs ``FlashAttention`` (the JAX ``custom_vjp``): its
forward is the forward above and saves only (q, k, v, o, lse), nothing
S x S; its backward is the registry's ``flash_attention_bwd`` (so
``ops.held_to_plain("flash_attention_bwd")`` sees every backward call).

Each wrapper takes its plain version (``kernels.ref``) for a tensor on the
CPU, and only then; for a CUDA tensor it launches its kernel or raises.
``flash_attention.launches`` counts forward launches (one per call),
``flash_attention_bwd.launches`` backward ``__global__`` launches (two per
call: dq, then dk/dv).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref, flash_attention_bwd_ref

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
HEAD_DIMS = (16, 32, 64, 128, 256)


def _check_inputs(q, k, v):
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Hq, S, D) and k, v (B, Hkv, Sk, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, S, D = q.shape
    _, Hkv, Sk, _ = k.shape
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not fit")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"shape too large for the kernel's grid: B={B} Hq={Hq}")
    return B, Hq, Hkv, S, Sk, D


def _check_bwd_inputs(q, k, v, o, lse, do):
    """_check_inputs, and o, do shaped like q, lse (B, Hq, S) float32."""
    B, Hq, Hkv, S, Sk, D = _check_inputs(q, k, v)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {tuple(q.shape)} {q.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if lse.shape != (B, Hq, S) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be {(B, Hq, S)} float32, got {tuple(lse.shape)} {lse.dtype}")
    for name, t in (("o", o), ("lse", lse), ("do", do)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, Hq, Hkv, S, Sk, D


def _check_window(window):
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")


def _statics(causal, window, softcap):
    """The mask arguments every entry point takes, as C ints and floats."""
    return (int(causal), int(window is not None), int(window or 0),
            int(softcap is not None), float(softcap or 0.0))


def _forward(q, k, v, causal, window, softcap, return_lse):
    """The forward kernel (or, for CPU tensors, its plain version)."""
    if _build.plain_or_raise(q):
        return attention_ref(q, k, v, causal, window, softcap, return_lse)
    B, Hq, Hkv, S, Sk, D = _check_inputs(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return (o, lse) if return_lse else o
    lib = _build.load_library("flash_attention")
    fn = getattr(lib, f"flash_attention_fwd_{_DTYPES[q.dtype]}")
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
              B, Hq, Hkv, S, Sk, D, *_statics(causal, window, softcap),
              1.0 / math.sqrt(D), q.device.index, _build.stream(q))
    _build.check(lib, code, "flash_attention launch")
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


class FlashAttention(torch.autograd.Function):
    """Differentiable attention: the forward kernel saving (q, k, v, o, lse),
    the backward through the registry's ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        """(o, lse); saves (q, k, v, o, lse) for the backward."""
        o, lse = _forward(q, k, v, causal, window, softcap, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.statics = dict(causal=causal, window=window, softcap=softcap)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        """(dq, dk, dv) through the registry's flash_attention_bwd."""
        from repro_torch.kernels import ops  # ops imports this module

        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ops.dispatch("flash_attention_bwd", q, k, v, o, lse, do.contiguous(),
                                  **ctx.statics)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal=True, window=None, softcap=None, return_lse=False):
    """Attention forward -> o, or (o, lse) with `return_lse`; differentiable
    (through ``FlashAttention``) when a gradient is needed."""
    _check_window(window)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        o, lse = FlashAttention.apply(q, k, v, causal, window, softcap)
        return (o, lse) if return_lse else o
    return _forward(q, k, v, causal, window, softcap, return_lse)


def flash_attention_bwd(q, k, v, o, lse, do, causal=True, window=None, softcap=None):
    """The attention gradient (dq, dk, dv) from the forward's saved
    (q, k, v, o, lse) and the output cotangent do (B, Hq, S, D)."""
    _check_window(window)
    if _build.plain_or_raise(q):
        return flash_attention_bwd_ref(q, k, v, o, lse, do, causal, window, softcap)
    B, Hq, Hkv, S, Sk, D = _check_bwd_inputs(q, k, v, o, lse, do)
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)  # rowsum(do * o)
    lib = _build.load_library("flash_attention_bwd")
    fn = getattr(lib, f"flash_attention_bwd_{_DTYPES[q.dtype]}")
    code = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
              do.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
              B, Hq, Hkv, S, Sk, D, *_statics(causal, window, softcap),
              1.0 / math.sqrt(D), q.device.index, _build.stream(q))
    _build.check(lib, code, "flash_attention_bwd launch")
    flash_attention_bwd.launches += 2
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_bwd.launches = 0
