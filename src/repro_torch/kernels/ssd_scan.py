"""The Mamba2/SSD within-chunk computation: the wrappers around
``csrc/ssd_scan.cu`` (forward and backward) and the autograd Function that
joins them.

Replaces the Pallas TPU kernels of ``repro/kernels/ssd_scan.py``:
``ssd_chunk_fwd`` / ``_ssd_chunk_kernel`` (``y_intra = ((C B^T) o L)(x dt)``
and each chunk's state ``B^T (exp(cum_last - cum) o x dt)``) and
``ssd_chunk_bwd`` / ``_ssd_bwd_kernel`` (their gradient, recomputing the
score and decay tiles from the saved inputs). ``models.ssm._ssd_chunked``
runs them for every SSM layer: prefill and scoring the forward, training
both. On Hopper the forward is one launch that tiles rows and causal columns
by 32 and applies each score tile to a group of heads; the backward is three
launches (rows, cols, finish) that sum dB and dC over the heads without
atomics (see the ``.cu`` header).

Contract (the JAX kernels'): xdt (B, nc, Q, nh, hd), cum (B, nc, Q, nh) the
inclusive cumsum of the log-decays within each chunk, Bc and Cc
(B, nc, Q, ds), all float32 (``models.ssm`` always feeds float32);
``ssd_chunk_fwd`` returns y (B, nc, Q, nh, hd) and the chunk states
(B, nc, nh, ds, hd); ``ssd_chunk_bwd`` takes the cotangents dy and dst of
those and returns (dxdt, dcum, dB, dC) shaped as the inputs, dcum with
respect to the cumsum output. The CUDA kernels take hd <= 64 and
ds <= 128 (mamba2 and zamba2 use 64 and 128 / 64), any Q and nh, and
float32 only: another dtype raises a ValueError (the JAX kernel casts bf16
on load; a bf16 kernel is ROADMAP "Open work on the ported kernels").

Gradients: when grad mode is on and an input requires a gradient,
``ssd_chunk`` runs ``SsdChunk`` (the JAX ``custom_vjp``): its forward saves
only (xdt, cum, Bc, Cc), never a Q x Q tile; its backward is the
registry's ``ssd_chunk_bwd`` (so ``ops.held_to_plain("ssd_chunk_bwd")``
sees every backward call).

Each wrapper takes its plain version (``kernels.ref``) for a tensor on the
CPU, and only then; for a CUDA tensor it launches its kernel or raises.
``ssd_chunk_fwd.launches`` counts forward launches (one per call),
``ssd_chunk_bwd.launches`` backward ``__global__`` launches (three per call).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_chunk_bwd_ref, ssd_chunk_ref

MAX_HEAD_DIM = 64
MAX_STATE = 128


def _check_inputs(xdt, cum, Bc, Cc):
    """Shapes, dtypes, devices and contiguity of the forward's inputs;
    returns (B, nc, Q, nh, hd, ds)."""
    if xdt.ndim != 5:
        raise ValueError(f"xdt must be (B, nc, Q, nh, hd), got {tuple(xdt.shape)}")
    B, nc, Q, nh, hd = xdt.shape
    ds = Bc.shape[-1]
    want = {"cum": (B, nc, Q, nh), "Bc": (B, nc, Q, ds), "Cc": (B, nc, Q, ds)}
    for name, t in (("cum", cum), ("Bc", Bc), ("Cc", Cc)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(t.shape)}")
    for name, t in (("xdt", xdt), ("cum", cum), ("Bc", Bc), ("Cc", Cc)):
        if t.dtype != torch.float32:
            raise ValueError(
                f"{name} is {t.dtype}: the CUDA SSD kernels take float32 only "
                "(models.ssm feeds float32; a bf16 kernel is ROADMAP 'Open work on "
                "the ported kernels', Queue 2 rows 6-7)"
            )
        if t.device != xdt.device:
            raise ValueError(f"{name} is on {t.device}, xdt on {xdt.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if hd > MAX_HEAD_DIM or ds > MAX_STATE:
        raise ValueError(f"head dim {hd} (<= {MAX_HEAD_DIM}) or state {ds} "
                         f"(<= {MAX_STATE}) outside what the kernels take")
    if B * nc > 65535:
        raise ValueError(f"B * nc = {B * nc} chunks exceed the kernels' grid (65535)")
    return B, nc, Q, nh, hd, ds


def ssd_chunk_fwd(xdt, cum, Bc, Cc):
    """(y_intra, chunk states) of one call; the forward kernel (or, for CPU
    tensors, its plain version)."""
    if _build.plain_or_raise(xdt):
        return ssd_chunk_ref(xdt, cum, Bc, Cc)
    B, nc, Q, nh, hd, ds = _check_inputs(xdt, cum, Bc, Cc)
    y = torch.empty_like(xdt)
    st = torch.empty((B, nc, nh, ds, hd), dtype=torch.float32, device=xdt.device)
    if xdt.numel() == 0 or ds == 0:
        return y.zero_(), st.zero_()
    lib = _build.load_library("ssd_scan")
    code = lib.ssd_chunk_fwd_f32(xdt.data_ptr(), cum.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                                 y.data_ptr(), st.data_ptr(), B * nc, Q, nh, hd, ds,
                                 xdt.device.index, _build.stream(xdt))
    _build.check(lib, code, "ssd_chunk_fwd launch")
    ssd_chunk_fwd.launches += 1
    return y, st


def ssd_chunk_bwd(xdt, cum, Bc, Cc, dy, dst):
    """The gradient (dxdt, dcum, dB, dC) from the saved inputs and the
    cotangents dy (as y) and dst (as the states)."""
    if _build.plain_or_raise(xdt):
        return ssd_chunk_bwd_ref(xdt, cum, Bc, Cc, dy, dst)
    B, nc, Q, nh, hd, ds = _check_inputs(xdt, cum, Bc, Cc)
    for name, t, shape in (("dy", dy, xdt.shape), ("dst", dst, (B, nc, nh, ds, hd))):
        if tuple(t.shape) != tuple(shape) or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {tuple(shape)} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != xdt.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {xdt.device}")
    outs = [torch.empty_like(t) for t in (xdt, cum, Bc, Cc)]
    if xdt.numel() == 0 or ds == 0:
        return tuple(o.zero_() for o in outs)
    lib = _build.load_library("ssd_scan")
    n = lib.ssd_chunk_bwd_scratch_f32(B * nc, Q, nh, hd, ds)
    scratch = torch.empty((n,), dtype=torch.float32, device=xdt.device)
    code = lib.ssd_chunk_bwd_f32(
        xdt.data_ptr(), cum.data_ptr(), Bc.data_ptr(), Cc.data_ptr(), dy.data_ptr(),
        dst.data_ptr(), scratch.data_ptr(), *(o.data_ptr() for o in outs),
        B * nc, Q, nh, hd, ds, xdt.device.index, _build.stream(xdt))
    _build.check(lib, code, "ssd_chunk_bwd launch")
    ssd_chunk_bwd.launches += 3
    return tuple(outs)


class SsdChunk(torch.autograd.Function):
    """Differentiable within-chunk SSD: the forward kernel saving only
    (xdt, cum, Bc, Cc), the backward through the registry's ``ssd_chunk_bwd``."""

    @staticmethod
    def forward(ctx, xdt, cum, Bc, Cc):
        """(y_intra, states); saves the inputs alone."""
        ctx.save_for_backward(xdt, cum, Bc, Cc)
        return ssd_chunk_fwd(xdt, cum, Bc, Cc)

    @staticmethod
    def backward(ctx, dy, dst):
        """(dxdt, dcum, dB, dC) through the registry's ssd_chunk_bwd."""
        from repro_torch.kernels import ops  # ops imports this module

        xdt, cum, Bc, Cc = ctx.saved_tensors
        # an output unused downstream arrives as zeros (materialized grads)
        return ops.dispatch("ssd_chunk_bwd", xdt, cum, Bc, Cc, dy.contiguous(),
                            dst.contiguous())


def ssd_chunk(xdt, cum, Bc, Cc):
    """(y_intra, chunk states); differentiable (through ``SsdChunk``) when a
    gradient is needed."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xdt, cum, Bc, Cc)):
        return SsdChunk.apply(xdt, cum, Bc, Cc)
    return ssd_chunk_fwd(xdt, cum, Bc, Cc)


ssd_chunk_fwd.launches = 0
ssd_chunk_bwd.launches = 0
