"""The Mamba2/SSD within-chunk computation: the wrappers around
``csrc/ssd_scan.cu`` (forward and backward) and the autograd Function that
joins them.

Replaces the Pallas TPU kernels of ``repro/kernels/ssd_scan.py``:
``ssd_chunk_fwd`` / ``_ssd_chunk_kernel`` (``y_intra = ((C B^T) o L)(x dt)``
and each chunk's state ``B^T (exp(cum_last - cum) o x dt)``) and
``ssd_chunk_bwd`` / ``_ssd_bwd_kernel`` (their gradient, recomputing the
score and decay tiles from the saved inputs). ``models.ssm._ssd_chunked``
runs them for every SSM layer: prefill and scoring the forward, training
both. On Hopper every product runs on tensor cores (``mma.sync`` TF32) at
float32 accuracy by a three-term split of each operand; the forward is one
launch (row CTAs that apply each score tile to a group of heads, and
chunk-state CTAs), the backward three (rows, cols, finish) that sum dB and
dC over the heads without atomics (see the ``.cu`` header). ``ssd_plan``
gives every kernel's head group, threads, shared memory and grid; each
launch passes them and the C side refuses a plan that disagrees with its
compiled tiles.

Contract (the JAX kernels'): xdt (B, nc, Q, nh, hd), cum (B, nc, Q, nh) the
inclusive cumsum of the log-decays within each chunk, Bc and Cc
(B, nc, Q, ds), all float32 (``models.ssm`` always feeds float32);
``ssd_chunk_fwd`` returns y (B, nc, Q, nh, hd) and the chunk states
(B, nc, nh, ds, hd); ``ssd_chunk_bwd`` takes the cotangents dy and dst of
those and returns (dxdt, dcum, dB, dC) shaped as the inputs, dcum with
respect to the cumsum output. The CUDA kernels take hd <= 64 and
ds <= 128 (mamba2 and zamba2 use 64 and 128 / 64), any nh, a chunk length
Q up to 640 (a 64-row tile's score tiles and a state CTA's B columns stay
in shared memory; models use 256), and float32 only: another dtype raises
a ValueError (the JAX kernel casts bf16 on load; a bf16 kernel is ROADMAP
"Open work on the ported kernels").

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

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_chunk_bwd_ref, ssd_chunk_ref

MAX_HEAD_DIM = 64
MAX_STATE = 128
ROWS = 64  # rows of every i or j tile: 4 warps of 16-row mma tiles
THREADS = 128
SMEM_MAX = 232_448  # bytes of shared memory a block may have on an H100
H100_SMS = 132


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _heads(cap: int, ctas, sms: int) -> int:
    """The largest power-of-two head group <= cap whose grid keeps two CTAs
    on every SM (1 if none does)."""
    g = cap
    while g > 1 and ctas(g) < 2 * sms:
        g //= 2
    return g


def ssd_plan(BC, Q, nh, hd, ds, sms=H100_SMS) -> dict[str, dict]:
    """The tiles of every kernel an SSD call at this shape launches
    (BC = B * nc chunks): {kernel name: {rows, heads, threads, smem, grid}},
    ``rows`` the i (or j) tile height, ``heads`` the head group of a CTA,
    ``smem`` the dynamic shared memory in bytes and ``grid`` the 1-D grid.
    ``csrc/ssd_scan.cu`` lays its tiles out the same way; its launchers
    refuse a head group or shared memory that differs from their own.

    Every tile is 64 rows (4 warps x 16). The head group is the largest
    power of two (up to 8 in the forward, 16 in the backward, where a CTA
    recomputes fewer score tiles the more heads it takes) whose grid still
    puts two CTAs on each of the card's `sms` SMs: 8 at the train and score
    shapes, 1 at a serve prefill (B * nc = 1: 384 CTAs instead of 48).
    Shared memory (floats x 4): the forward's row CTA holds its 64 x Q score
    tiles, a 2-stage ring (C and B ds chunks of 32 | an X tile and cum) and
    the group's cum rows; its state CTA its 64 columns of B for all Q rows
    and a 2-stage ring of X tiles and cum. The backward's rows CTA a ring
    of (C, B chunks | dy, X tiles, cum), cum and row sums; its cols CTAs
    the S^T tiles and a ring (dxdt), or a ring of dscores and C (dB) or
    dscores and B (dC) tiles. Raises ValueError for a shape the kernels do
    not take."""
    if not (BC > 0 and Q > 0 and nh > 0 and 0 < hd <= MAX_HEAD_DIM and 0 < ds <= MAX_STATE):
        raise ValueError(f"ssd shape (BC={BC}, Q={Q}, nh={nh}, hd={hd}, ds={ds}) outside what "
                         f"the kernels take (hd <= {MAX_HEAD_DIM}, ds <= {MAX_STATE})")
    HD = 32 if hd <= 32 else 64
    nIT, nST = _cdiv(Q, ROWS), _cdiv(ds, ROWS)
    scores = ROWS * (nIT * ROWS + 4)  # 64 x Q score tiles, rows padded 4
    chunk = ROWS * 36  # 64 rows of a 32-column chunk, padded 4
    tile_n, tile_k = ROWS * 72, ROWS * 68  # a 64 x 64 tile read N- / K-major

    g = _heads(8, lambda g: BC * _cdiv(nh, g) * (nIT + nST), sms)
    fwd = 4 * max(scores + 2 * max(2 * chunk, ROWS * (HD + 8) + ROWS) + g * ROWS,
                  nIT * tile_n + 2 * (ROWS * (HD + 8) + ROWS))
    gr = _heads(16, lambda g: BC * nIT * _cdiv(nh, g), sms)
    rows = 4 * (2 * max(2 * chunk, 2 * ROWS * (HD + 4) + ROWS) + 2 * gr * ROWS + 4 * ROWS)
    gc = _heads(16, lambda g: BC * nIT * (_cdiv(nh, g) + 2 * nST), sms)
    dx_stage = max(2 * chunk, ROWS * (HD + 8) + ROWS, chunk + 32 * (HD + 8))
    cols = 4 * max(scores + 2 * dx_stage + gc * ROWS, 2 * max(2 * tile_n, 2 * chunk + ROWS),
                   2 * (tile_k + tile_n))
    plan = {
        "ssd_fwd_kernel": dict(rows=ROWS, heads=g, threads=THREADS, smem=fwd,
                               grid=(BC * _cdiv(nh, g) * (nIT + nST),)),
        "ssd_bwd_rows_kernel": dict(rows=ROWS, heads=gr, threads=THREADS, smem=rows,
                                    grid=(BC * nIT * _cdiv(nh, gr),)),
        "ssd_bwd_cols_kernel": dict(rows=ROWS, heads=gc, threads=THREADS, smem=cols,
                                    grid=(BC * nIT * (_cdiv(nh, gc) + 2 * nST),)),
        "ssd_bwd_finish_kernel": dict(rows=ROWS, heads=nh, threads=THREADS, smem=0,
                                      grid=(BC * nIT,)),
    }
    over = {k: v["smem"] for k, v in plan.items() if v["smem"] > SMEM_MAX}
    if over:
        raise ValueError(f"chunk length Q={Q}: shared memory {over} exceeds {SMEM_MAX} bytes "
                         "(the kernels take Q <= 640)")
    return plan


def ssd_work(name, plan, BC, Q, nh, ds) -> list[tuple]:
    """The work of each CTA of kernel `name` under `plan`, in launch order,
    as ``csrc/ssd_scan.cu`` decodes ``blockIdx.x`` (the longest first):
    forward ("rows", bc, i tile, first head, heads) and ("state", bc, first
    ds row, first head, heads); backward rows ("rows", bc, i tile, first
    head, heads); cols ("dx", bc, j tile, first head, heads), ("dB", bc, j
    tile, first ds row), ("dC", bc, i tile, first ds row); finish ("dcum",
    bc, i tile)."""
    nIT, nST = _cdiv(Q, ROWS), _cdiv(ds, ROWS)
    g = plan[name]["heads"]
    ng = _cdiv(nh, g)

    def heads(k):
        return k * g, min(g, nh - k * g)

    out = []
    if name == "ssd_fwd_kernel":
        per_it, n_state = BC * ng, BC * nST * ng
        for cta in range(plan[name]["grid"][0]):
            if per_it <= cta < per_it + n_state:
                i = cta - per_it
                out.append(("state", i // (nST * ng), i // ng % nST * ROWS, *heads(i % ng)))
                continue
            it, i = nIT - 1, cta
            if cta >= per_it:
                i = cta - per_it - n_state
                it, i = nIT - 2 - i // per_it, i % per_it
            out.append(("rows", i // ng, it, *heads(i % ng)))
    elif name == "ssd_bwd_rows_kernel":
        per_it = BC * ng
        for cta in range(plan[name]["grid"][0]):
            out.append(("rows", cta % per_it // ng, nIT - 1 - cta // per_it, *heads(cta % ng)))
    elif name == "ssd_bwd_cols_kernel":
        n_dx, n_b = BC * nIT * ng, BC * nIT * nST
        for cta in range(plan[name]["grid"][0]):
            if cta < n_dx:
                per_jt = BC * ng
                out.append(("dx", cta % per_jt // ng, cta // per_jt, *heads(cta % ng)))
                continue
            i = cta - n_dx
            kind = "dB" if i < n_b else "dC"
            i = i if i < n_b else i - n_b
            out.append((kind, i // (nIT * nST), i // nST % nIT, i % nST * ROWS))
    else:
        out = [("dcum", cta // nIT, cta % nIT) for cta in range(plan[name]["grid"][0])]
    return out


@functools.cache
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


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
    plan = ssd_plan(B * nc, Q, nh, hd, ds, _sms(xdt.device.index))["ssd_fwd_kernel"]
    lib = _build.load_library("ssd_scan")
    code = lib.ssd_chunk_fwd_f32(xdt.data_ptr(), cum.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                                 y.data_ptr(), st.data_ptr(), B * nc, Q, nh, hd, ds,
                                 plan["heads"], plan["smem"], xdt.device.index,
                                 _build.stream(xdt))
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
    plan = ssd_plan(B * nc, Q, nh, hd, ds, _sms(xdt.device.index))
    rows, cols = plan["ssd_bwd_rows_kernel"], plan["ssd_bwd_cols_kernel"]
    lib = _build.load_library("ssd_scan")
    n = lib.ssd_chunk_bwd_scratch_f32(B * nc, Q, nh, hd, ds, rows["heads"])
    scratch = torch.empty((n,), dtype=torch.float32, device=xdt.device)
    code = lib.ssd_chunk_bwd_f32(
        xdt.data_ptr(), cum.data_ptr(), Bc.data_ptr(), Cc.data_ptr(), dy.data_ptr(),
        dst.data_ptr(), scratch.data_ptr(), *(o.data_ptr() for o in outs),
        B * nc, Q, nh, hd, ds, rows["heads"], cols["heads"], rows["smem"], cols["smem"],
        xdt.device.index, _build.stream(xdt))
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
