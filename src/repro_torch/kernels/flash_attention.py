"""Flash attention: the wrappers around the CUDA kernels, and the autograd
Function that joins them.

Replaces the Pallas TPU kernels of ``repro/kernels/flash_attention.py``:
``flash_attention_fwd`` / ``_attn_kernel`` (blocked online-softmax
attention with GQA, causal masking, a sliding window and a softcap) and
``flash_attention_bwd`` / ``_attn_bwd_dq_kernel`` + ``_attn_bwd_dkv_kernel``
(the blocked gradient, probabilities recomputed per tile from the saved
log-sum-exp). ``transformer.forward`` runs them for every layer: the
scoring path the forward, training both.

The kernel is picked by dtype, not as a fallback:
- bfloat16, the dtype of every call on the score, train and gossip paths
  (``ModelConfig.compute_dtype``): ``csrc/flash_attention_sm90.cu``, a
  warp-specialised wgmma forward fed by TMA (one CTA per (q head, 128-row
  q tile, batch)), and ``csrc/flash_attention_bwd_sm90.cu``, a tensor-core
  backward (wgmma at D = 64 and 128, mma.sync at 16, 32 and 256);
- float32: the CUDA-core kernels of ``csrc/flash_attention.cu`` and
  ``csrc/flash_attention_bwd.cu``. A tensor-core product on float32 is
  TF32, which keeps about 3 decimal digits and cannot meet the 2e-5
  (forward) and 2e-4 (gradient) float32 bars.
A bfloat16 call never reaches the CUDA-core kernels; a failed build or
launch raises. ``tile_plan`` gives every kernel's tiles, threads, shared
memory and grid; each bf16 launch passes its shared memory and the C side
refuses a plan that disagrees with the compiled tiles. The backward keeps
two kernels, dq and then dk/dv (which sums the GQA group itself), with no
atomics: it is the same bit for bit from run to run. Ragged lengths are
masked in the kernels, not padded.

Contract (the JAX kernels', heads-major): q (B, Hq, S, D), k and v
(B, Hkv, Sk, D), bfloat16 or float32, D in {16, 32, 64, 128, 256}; query
head h reads kv head h // (Hq // Hkv). The forward returns o (B, Hq, S, D)
in q's dtype, and with ``return_lse`` also lse (B, Hq, S) float32. A row
that no key may attend (only possible without causal masking, with a
window, when S > Sk + window) has no defined output: the plain version
averages every value, the float32 kernel (like the TPU kernel) the tiles it
visits, the bfloat16 kernel returns zeros.

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

import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import attention_ref, flash_attention_bwd_ref

_DTYPES = (torch.bfloat16, torch.float32)
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


def _cdiv(a, b):
    return -(-a // b)


def tile_plan(dtype, D, B=1, Hq=1, Hkv=1, S=1, Sk=1) -> dict[str, dict]:
    """The tiles of every kernel a call of this dtype and head dim launches:
    {kernel name: {block_q, block_k, threads, smem, grid}}, ``smem`` the
    dynamic shared memory in bytes and ``grid`` the CUDA grid (x, y, z) at
    the given shape. The CUDA sources lay their tiles out the same way; a
    bfloat16 launcher refuses a call whose ``smem`` differs from its own.

    bfloat16 (``csrc/flash_attention_sm90.cu``, ``flash_attention_bwd_sm90.cu``):
    the forward takes 128 q rows a CTA (a TMA producer warpgroup and two
    wgmma consumer warpgroups), BK = 64 keys a tile at D = 256 and 128
    below, columns padded to 64 in shared memory, a 2-stage K/V ring. The
    backward's dq kernel runs wgmma on two warpgroups at D >= 64 (128 q rows
    a CTA over 64-key tiles, 32 at D = 256) and mma.sync on 4 warps below
    (64 q rows, 64-key tiles); its dk/dv kernel runs wgmma at D = 64 and 128
    (128 kv rows a CTA over 64-row q steps) and mma.sync on 8 warps at 16,
    32 (128 kv rows, 32-row q steps in a 3-stage ring) and 256 (32 kv rows,
    64-row q steps); every ring but that one double-buffered. float32
    (``flash_attention.cu``, ``flash_attention_bwd.cu``): the CUDA-core
    kernels' 64-row q and 32-row kv tiles, float32 staging padded a column.
    """
    if dtype == torch.bfloat16:
        dp, bk = max(D, 64), (64 if D == 256 else 128)
        plan = {"flash_fwd_wgmma_kernel": dict(
            block_q=128, block_k=bk, threads=384,
            # 1 KB to align the swizzle atoms, Q, 2 stages of K and V, barriers
            smem=1024 + 2 * 128 * dp + 2 * 2 * 2 * bk * dp + 64,
            grid=(Hq, _cdiv(S, 128), B))}
        if D >= 64:  # wgmma on two warpgroups, 128-byte swizzled tiles
            dq_bk = 32 if D == 256 else 64
            plan["flash_bwd_dq_wgmma_kernel"] = dict(
                block_q=128, block_k=dq_bk, threads=256,
                # 1 KB alignment, Q, dO; 2 stages of K and V; lse, delta
                smem=1024 + 2 * 2 * 128 * D + 2 * 2 * 2 * dq_bk * D + 2 * 4 * 128,
                grid=(Hq, _cdiv(S, 128), B))
        else:  # mma.sync, 4 warps
            plan["flash_bwd_dq_mma_kernel"] = dict(
                block_q=64, block_k=64, threads=128,
                # Q, dO; 2 stages of K and V; lse, delta
                smem=2 * 2 * 64 * D + 2 * 2 * 2 * 64 * D + 2 * 4 * 64,
                grid=(Hq, _cdiv(S, 64), B))
        if D in (64, 128):  # wgmma on two warpgroups
            plan["flash_bwd_dkv_wgmma_kernel"] = dict(
                block_q=64, block_k=128, threads=256,
                # 1 KB alignment, K, V; 2 stages of Q, dO, lse, delta
                smem=1024 + 2 * 2 * 128 * D + 2 * (2 * 2 * 64 * D + 2 * 4 * 64),
                grid=(Hkv, _cdiv(Sk, 128), B))
        else:  # mma.sync, 8 warps
            kv_bk, kv_bq, stages = (32, 64, 2) if D == 256 else (128, 32, 3)
            plan["flash_bwd_dkv_mma_kernel"] = dict(
                block_q=kv_bq, block_k=kv_bk, threads=256,
                # K, V; a ring of Q, dO, lse, delta; P, dS
                smem=2 * 2 * kv_bk * D + stages * (2 * 2 * kv_bq * D + 2 * 4 * kv_bq)
                + 2 * 2 * kv_bk * kv_bq,
                grid=(Hkv, _cdiv(Sk, kv_bk), B))
        return plan
    if dtype != torch.float32:
        raise TypeError(f"no flash kernel takes {dtype}")
    bq, bk = 64, 32
    return {
        "flash_fwd_kernel": dict(
            block_q=bq, block_k=bk, threads=256,
            smem=4 * (bq * (D + 1) + bk * (D + 1) + bk * D + bq * (bk + 1)),
            grid=(_cdiv(S, bq), Hq, B)),
        "flash_bwd_dq_kernel": dict(
            block_q=bq, block_k=bk, threads=256,
            smem=4 * (2 * bq * (D + 1) + 2 * bk * (D + 1) + bq * (bk + 1) + 2 * bq),
            grid=(_cdiv(S, bq), Hq, B)),
        "flash_bwd_dkv_kernel": dict(
            block_q=bq, block_k=bk, threads=256,
            smem=4 * (2 * bk * (D + 1) + 2 * bk * (bq + 1) + 2 * bq) + 2 * bq * (D + 1) * 4,
            grid=(_cdiv(Sk, bk), Hkv, B)),
    }


def bwd_kernels(plan: dict) -> dict[str, dict]:
    """The backward's two kernels of a ``tile_plan``, in launch order (dq,
    then dk/dv)."""
    return {name: p for name, p in plan.items() if name.startswith("flash_bwd_")}


@functools.cache
def _bf16_smem(D) -> tuple[int, int, int]:
    """The bf16 kernels' shared memory at head dim D: (forward, dq, dk/dv)."""
    plan = tile_plan(torch.bfloat16, D)
    return (plan["flash_fwd_wgmma_kernel"]["smem"],
            *(p["smem"] for p in bwd_kernels(plan).values()))


def _forward(q, k, v, causal, window, softcap, return_lse):
    """The forward kernel (or, for CPU tensors, its plain version)."""
    if _build.plain_or_raise(q):
        return attention_ref(q, k, v, causal, window, softcap, return_lse)
    B, Hq, Hkv, S, Sk, D = _check_inputs(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return (o, lse) if return_lse else o
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, Hq, Hkv, S, Sk, D, *_statics(causal, window, softcap), 1.0 / math.sqrt(D))
    if q.dtype == torch.bfloat16:  # wgmma + TMA; float32 keeps the CUDA-core kernel
        lib = _build.load_library("flash_attention_sm90")
        code = lib.flash_attention_fwd_bf16(*args, _bf16_smem(D)[0], q.device.index,
                                            _build.stream(q))
    else:
        lib = _build.load_library("flash_attention")
        code = lib.flash_attention_fwd_f32(*args, q.device.index, _build.stream(q))
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
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            do.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            B, Hq, Hkv, S, Sk, D, *_statics(causal, window, softcap), 1.0 / math.sqrt(D))
    if q.dtype == torch.bfloat16:  # tensor cores; float32 keeps the CUDA-core kernels
        lib = _build.load_library("flash_attention_bwd_sm90")
        code = lib.flash_attention_bwd_bf16(*args, *_bf16_smem(D)[1:], q.device.index,
                                            _build.stream(q))
    else:
        lib = _build.load_library("flash_attention_bwd")
        code = lib.flash_attention_bwd_f32(*args, q.device.index, _build.stream(q))
    _build.check(lib, code, "flash_attention_bwd launch")
    flash_attention_bwd.launches += 2
    return dq, dk, dv


flash_attention.launches = 0
flash_attention_bwd.launches = 0
