"""Block-local top-k magnitude selection: the wrapper around ``csrc/topk_compress.cu``.

Replaces the Pallas TPU kernel of ``repro/kernels/topk_compress.py``
(``block_topk`` / ``_topk_kernel``), the selection of the gossip step's
sparse wire format (``core/gossip.py::block_topk_compress``): for every row
of x (nb, block) the k entries of largest |x|, as (vals (nb, k) float32,
row-local idx (nb, k) int32), in descending |x| with the lower index
first among equal magnitudes; every NaN ranks equal, above +inf. The
kernel's output equals the plain version's (``ref.block_topk_ref``) bit
for bit, values and order both.

Bound on an H100: bytes. At the gossip step's embedding leaf (2 pods x
144,000 rows of 4,096, k = 40) a call reads 4.72 GB and writes 92 MB,
1.44 ms at 3.35 TB/s. The kernel is a radix select (see the ``.cu``
header): persistent CTAs of 128 threads stage rows in shared memory with
cp.async ("staged"), or read rows too long to stage from device memory in
every pass ("stream", 256 threads); a row whose first-digit boundary is
the previous row's is split in one pass over shared memory. ``topk_plan``
chooses the variant, stages, candidate capacity, shared memory and grid by
shape; every launch passes them and the C side refuses a plan whose shared
memory differs from its own layout.

The wrapper takes the plain version for a tensor on the CPU, and only
then; for a CUDA tensor it launches the kernel or raises. It takes
float32, contiguous, 2-D input with ``1 <= k <= block`` and
``k <= K_MAX`` (the sort buffer lives in shared memory; every k that a
block of up to 2**20 at a ratio of 0.01 gives), any block.
``block_topk.launches`` counts kernel launches: one per call with nb > 0.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import block_topk_ref

K_MAX = 16384  # the largest k: its 2 x 16,384-int sort buffer fills 128 KB
SMEM_MAX = 232_448  # bytes of shared memory a block may have on an H100
SMEM_SM = 233_472  # bytes of shared memory an SM has for its blocks
SMEM_RESERVED = 1024  # bytes the runtime keeps a block
MAX_CTAS_SM = 32
THREADS_SM = 2048
H100_SMS = 132
BINS = 256
SCALARS = 64  # ints of per-row scalars
# candidate indices a staged CTA keeps, a quarter a warp: the gossip
# step's residual rows put ~25% of a row (~1,000) in the boundary bin
STAGED_CAP = 2048
STREAM_CAP = 8192  # a stream CTA keeps
STAGED_WARPS = 4  # a staged CTA's warps
STREAM_WARPS = 8  # a stream CTA's warps: one CTA takes a whole long row


def sort_len(k: int) -> int:
    """The sort buffer's length: 64 (one warp's registers) or the power of
    two at or above k (the ``.cu``'s ``sort_len``)."""
    return 64 if k <= 64 else 1 << (k - 1).bit_length()


def hist_ints(packed: bool, warps: int) -> int:
    """Ints of the histogram region: 256 bins a warp, two 16-bit counters an
    int when packed (staged rows), at least 256 (the later digits' one
    32-bit histogram)."""
    return max(warps * BINS // 2, BINS) if packed else warps * BINS


def warps_of(stages: int) -> int:
    """A CTA's warps: 4 for a staged row, 8 for a streamed one (stages 0)."""
    return STAGED_WARPS if stages else STREAM_WARPS


def topk_smem(block: int, k: int, stages: int, cap: int) -> int:
    """Dynamic shared memory of one CTA, bytes: `stages` staged rows padded
    to whole float4s (0: the stream variant), the first digit's histograms,
    the second digit's one, `cap` candidate indices (16-bit for staged rows,
    else 32; padded to 16 B), the sort buffer's keys and indices, the
    per-row scalars.

    This is the ``.cu``'s ``make_layout`` (``block_topk_smem_f32``) written
    again, by choice: the plan stays pure Python, so the CPU tests hold it
    without the library. Every launch passes it and the C side refuses one
    that differs; ``tests/test_torch_cuda.py`` holds the two equal on the
    card, and ``tests/test_torch_topk_select.py`` the shared constants."""
    row = -(-block // 4) * 4 * 4
    cand = -(-cap * (2 if stages else 4) // 16) * 16  # staged rows: 16-bit indices
    return (stages * row + hist_ints(stages > 0, warps_of(stages)) * 4 + BINS * 4 + cand
            + 2 * sort_len(k) * 4 + SCALARS * 4)


def _ctas_per_sm(smem: int, threads: int) -> int:
    return min(MAX_CTAS_SM, THREADS_SM // threads, SMEM_SM // (smem + SMEM_RESERVED))


def topk_plan(block: int, k: int, nb: int | None = None, *, sms: int = H100_SMS) -> dict:
    """The launch of one ``block_topk`` call: {variant, warps, threads,
    stages, cap, sort, smem, ctas_per_sm, grid}.

    "staged" (4 warps a row) stages rows in shared memory through a ring of
    1 to 3 stages: the ring that keeps the most CTAs on an SM, and of those
    the most stages. At the gossip shape 1 stage and 9 CTAs an SM beat 2
    stages and 5-6 (PERF.md); small rows take 3. Rows too long to stage
    take "stream" (8 warps a row; every pass reads device memory). The grid
    is the CTAs the card holds at once (persistent; each walks rows with the
    grid's stride), at most nb. Raises ValueError for a shape the kernel
    does not take: k outside [1, block] or above ``K_MAX``."""
    if not 1 <= k <= block:
        raise ValueError(f"k={k} must be in [1, block={block}]")
    if k > K_MAX:
        raise ValueError(f"k={k} exceeds the kernel's K_MAX={K_MAX} (its sort buffer lives "
                         "in shared memory)")
    if block >= 2**31:
        raise ValueError(f"block={block} too large")
    best = None
    for s in (1, 2, 3):
        smem = topk_smem(block, k, s, STAGED_CAP)
        ctas = _ctas_per_sm(smem, 32 * STAGED_WARPS) if smem <= SMEM_MAX else 0
        if ctas and (best is None or ctas >= best[0]):
            best = (ctas, s, smem)
    if best is not None:
        ctas, s, smem = best
        plan = dict(variant="staged", stages=s, cap=STAGED_CAP, smem=smem, ctas_per_sm=ctas)
    else:
        smem = topk_smem(block, k, 0, STREAM_CAP)
        plan = dict(variant="stream", stages=0, cap=STREAM_CAP, smem=smem,
                    ctas_per_sm=_ctas_per_sm(smem, 32 * STREAM_WARPS))
    resident = plan["ctas_per_sm"] * sms
    warps = warps_of(plan["stages"])
    plan.update(warps=warps, threads=32 * warps, sort=sort_len(k),
                grid=resident if nb is None else max(1, min(nb, resident)))
    return plan


def _check_inputs(x: torch.Tensor, k: int) -> tuple[int, int]:
    """Validate what the kernel takes; returns (nb, block)."""
    if x.dtype != torch.float32:
        raise TypeError(f"block_topk takes float32 rows, got {x.dtype}")
    if x.ndim != 2:
        raise ValueError(f"x must be (nb, block), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    nb, block = x.shape
    if not 1 <= k <= block:
        raise ValueError(f"k={k} must be in [1, block={block}]")
    if k > K_MAX:
        raise ValueError(f"k={k} exceeds the kernel's K_MAX={K_MAX}")
    if nb >= 2**31:
        raise ValueError(f"nb={nb} too large")
    return nb, block


def block_topk(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row top-k by |value|: (vals (nb, k) float32, idx (nb, k) int32),
    launched as ``topk_plan(block, k, nb)`` says."""
    if _build.plain_or_raise(x):
        return block_topk_ref(x, k)
    nb, block = _check_inputs(x, k)
    vals = torch.empty((nb, k), dtype=torch.float32, device=x.device)
    idx = torch.empty((nb, k), dtype=torch.int32, device=x.device)
    if nb == 0:
        return vals, idx
    p = topk_plan(block, k, nb, sms=_build.sm_count(x.device))
    lib = _build.load_library("topk_compress")
    code = lib.block_topk_f32(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), nb, block, k,
                              p["stages"], p["cap"], p["smem"], p["grid"], x.get_device(),
                              _build.stream(x))
    _build.check(lib, code, "block_topk launch")
    block_topk.launches += 1
    return vals, idx


block_topk.launches = 0


def block_topk_cost(x, k) -> tuple[int, int]:
    """(operations, bytes): one comparison an element, the least work a
    selection does; x read once, vals and idx written once."""
    nb, block = x.shape
    return nb * block, 4 * nb * block + 8 * nb * k


def block_topk_meta(x, k):
    """``block_topk``'s (vals, idx) as empty tensors."""
    nb, _ = _check_inputs(x, k)
    return (torch.empty((nb, k), dtype=torch.float32, device=x.device),
            torch.empty((nb, k), dtype=torch.int32, device=x.device))
