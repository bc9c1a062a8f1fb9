"""Flash-attention forward: the wrapper around ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel of ``repro/kernels/flash_attention.py``
(``flash_attention_fwd`` / ``_attn_kernel``): blocked online-softmax
attention with GQA, causal masking, a sliding window and a softcap, which
``transformer.forward`` (the scoring path) runs for every layer. On Hopper
one block per (batch, head, 64-row q tile) loops over 32-row K/V tiles in
shared memory with the softmax carry in registers, and masks ragged
lengths itself instead of padding them (see the ``.cu`` header).

Contract (the JAX kernel's, heads-major): q (B, Hq, S, D), k and v
(B, Hkv, Sk, D), bfloat16 or float32, D in {16, 32, 64, 128, 256}; query
head h reads kv head h // (Hq // Hkv). Returns o (B, Hq, S, D) in q's
dtype, and with ``return_lse`` also lse (B, Hq, S) float32. A row that no
key may attend (only possible without causal masking, with a window, when
S > Sk + window) has no defined output: the plain version averages every
value, the kernel (like the TPU kernel) only the tiles it visits.

Forward only. The blocked backward kernels (``flash_attention_bwd``,
ROADMAP Queue 2 row 5) come with training; until then a call that needs a
gradient raises ``NotImplementedError``.

The wrapper takes the plain version (``kernels.ref.attention_ref``) for a
tensor on the CPU, and only then; for a CUDA tensor it launches the kernel
or raises. ``flash_attention.launches`` counts kernel launches (one per
call).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref

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


def flash_attention(q, k, v, causal=True, window=None, softcap=None, return_lse=False):
    """Attention forward -> o, or (o, lse) with `return_lse`."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "flash_attention has no backward yet: the blocked gradient kernels "
            "(flash_attention_bwd) are ROADMAP Queue 2 row 5"
        )
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
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
              B, Hq, Hkv, S, Sk, D, int(causal), int(window is not None), int(window or 0),
              int(softcap is not None), float(softcap or 0.0), 1.0 / math.sqrt(D),
              q.device.index, _build.stream(q))
    _build.check(lib, code, "flash_attention launch")
    flash_attention.launches += 1
    return (o, lse) if return_lse else o


flash_attention.launches = 0
