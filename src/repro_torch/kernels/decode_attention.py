"""Paged single-query decode attention: the wrapper around ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel of ``repro/kernels/decode_attention.py``
(``decode_attention`` / ``_decode_kernel``), the serving decode's hot path:
one query token per sequence attends over K/V pages of a shared pool,
addressed through an int32 block table and per-sequence lengths. On the
TPU, the table and lengths ride in scalar prefetch and a sequential page
grid axis carries the online softmax; on Hopper, one block per
(sequence, kv head) loops over its own positions and reads the table
itself (see the ``.cu`` header for the design and what bounds it).

Contract (the JAX kernel's): q (B, Hq, D); k_pool, v_pool
(n_blocks, block_size, Hkv, D) of q's dtype (bfloat16 or float32), D in
{16, 32, 64, 128, 256}; table
(B, n_pages) int32; lengths (B,) int32 counts the valid tokens including
the one being decoded, which sits at position ``lengths - 1`` (the window
is measured from it). Rows of length 0 come out zero. Returns (B, Hq, D)
in q's dtype. Table entries past a sequence's length are never read.

The wrapper takes the plain version (``kernels.ref.decode_attention_ref``)
for a tensor on the CPU, and only then; for a CUDA tensor it launches the
kernel or raises. ``decode_attention.launches`` counts kernel launches
(one per call). Inference only: the kernel has no gradient.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
HEAD_DIMS = (16, 32, 64, 128, 256)


def _check_inputs(q, k_pool, v_pool, table, lengths):
    if q.dtype not in _DTYPES:
        raise TypeError(f"q must be bfloat16 or float32, got {q.dtype}")
    if q.ndim != 3 or k_pool.ndim != 4:
        raise ValueError(f"q must be (B, Hq, D) and the pools (n_blocks, bs, Hkv, D); "
                         f"got {tuple(q.shape)} and {tuple(k_pool.shape)}")
    B, Hq, D = q.shape
    n_blocks, bs, Hkv, Dk = k_pool.shape
    if v_pool.shape != k_pool.shape or Dk != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"shapes q {tuple(q.shape)}, k_pool {tuple(k_pool.shape)}, "
                         f"v_pool {tuple(v_pool.shape)} do not fit")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("table and lengths must be int32")
    if table.ndim != 2 or table.shape[0] != B or lengths.shape != (B,):
        raise ValueError(f"table must be (B, n_pages) and lengths (B,) with B={B}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} must be {q.dtype}, got {t.dtype}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("table", table),
                    ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if B > 65535 or Hkv > 65535:
        raise ValueError(f"shape too large for the kernel's grid: B={B} Hkv={Hkv}")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("the pools must start on a 16-byte boundary (16-byte loads)")
    return B, Hq, Hkv, D, n_blocks, bs, table.shape[1]


def decode_attention(q, k_pool, v_pool, table, lengths, window=None, softcap=None):
    """Paged single-query attention -> (B, Hq, D) in q's dtype."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if _build.plain_or_raise(q):
        return decode_attention_ref(q, k_pool, v_pool, table, lengths, window, softcap)
    B, Hq, Hkv, D, n_blocks, bs, n_pages = _check_inputs(q, k_pool, v_pool, table, lengths)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _build.load_library("decode_attention")
    fn = getattr(lib, f"decode_attention_{_DTYPES[q.dtype]}")
    code = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
              lengths.data_ptr(), out.data_ptr(), B, Hq, Hkv, D, n_blocks, bs, n_pages,
              int(window is not None), int(window or 0), int(softcap is not None),
              float(softcap or 0.0), 1.0 / math.sqrt(D), q.device.index, _build.stream(q))
    _build.check(lib, code, "decode_attention launch")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
