"""Paged single-query decode attention: the wrapper around ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel of ``repro/kernels/decode_attention.py``
(``decode_attention`` / ``_decode_kernel``), the serving decode's hot path:
one query token per sequence attends over K/V pages of a shared pool,
addressed through an int32 block table and per-sequence lengths. On the
TPU, the table and lengths ride in scalar prefetch and a sequential page
grid axis carries the online softmax; on Hopper the positions of each
(sequence, kv head) are split over ``splits`` blocks (flash-decoding), one
block a split, each streaming its tiles of K/V through a shared-memory ring
and reading the table itself; the last block of a (sequence, head chunk)
to finish merges the splits' partial softmaxes, in split order, in the same
launch (see the ``.cu`` header for the design and what bounds it).

``decode_plan`` is the launch, from shapes only (the wrapper never reads
``lengths`` to the host: a sync a layer would cost a host-bound decode step
more than the kernel). The splits' partials and one counter per (sequence,
head chunk) live in a workspace the wrapper allocates once per device and
stream and grows on demand (counters zeroed when allocated; the kernel
resets each counter it uses), so the kernel allocates nothing.

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

import functools
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}
HEAD_DIMS = (16, 32, 64, 128, 256)
H100_SMS = 132
# the .cu's constants (kRingBytes, kStages, kStageBytes, kMaxSplits, kThreads,
# kMmaHeads, kMmaMaxBlocks, kMinBlocks, kSmemPerSM, kSmemPerBlock,
# kSmemReserved)
RING_BYTES = 65_536
STAGES = 4
STAGE_BYTES = 16_384
MAX_SPLITS = 64
THREADS = 128
MMA_HEADS = 8
MMA_MAX_BLOCKS = 4
MIN_BLOCKS = 3
SMEM_SM = 233_472
SMEM_MAX = 232_448
SMEM_RESERVED = 1024
MMA_TILE = 64


def _f32_tile(D: int) -> int:
    """float32: positions a ring stage holds: STAGE_BYTES of K and V, at
    least 4 of a warp's row passes (rows a warp takes at once: 32 / lanes a
    row), at most 64."""
    rows = 32 // min(32, D // 4)
    return max(4 * rows, min(64, STAGE_BYTES // (8 * D)))


@functools.lru_cache(maxsize=256)
def decode_plan(B, Hkv, group, D, dtype, n_pages, block_size, sms=H100_SMS) -> dict:
    """The launch of a decode call, as ``csrc/decode_attention.cu`` reckons
    it (its launcher refuses a call whose splits or shared memory differ):

    - ``heads``: query heads a block takes (bf16: up to 8, the rows of the
      tensor cores' A operand; float32: 1, 2, or 4 for a group of 3 or
      more); a larger group takes several head chunks;
    - ``tile``: positions a ring stage holds (bf16: 64, 16 a warp; float32:
      ``STAGE_BYTES`` of K and V), ``stages`` in the ring (bf16: as many
      64-position stages as ``RING_BYTES`` holds, 2 to 4), ``threads`` a
      block;
    - ``smem``: dynamic shared memory, the ring (reused for the warps'
      partials after the last tile);
    - ``splits``: how many blocks share a (sequence, head chunk)'s
      positions: as many as fit one resident wave beside the other units
      (blocks an SM: what shared memory allows, at most
      ``MMA_MAX_BLOCKS`` in bf16 and ``MIN_BLOCKS`` in float32), 1 when the
      units (B x Hkv x head chunks) already fill them; at most
      ``MAX_SPLITS``, at most positions / tile (so splits x tile never
      exceeds the table's positions, unless one split already does), and at
      most what shared memory holds of a unit's partials (the last block
      stages them there to merge them);
    - ``grid``: (splits, Hkv x head chunks, B);
    - ``workspace_bytes``: the partials, 4 x units x splits x heads x
      (D + 2) (acc, m, l), and one int32 counter a unit; 0 when splits = 1.

    From shapes only: never from ``lengths``."""
    if D not in HEAD_DIMS or dtype not in _DTYPES or Hkv < 1 or group < 1:
        raise ValueError(f"no decode plan for D={D} {dtype} Hkv={Hkv} group={group}")
    if dtype == torch.bfloat16:
        heads, tile = min(group, MMA_HEADS), MMA_TILE
        stage = 2 * tile * D * 2
        stages = max(2, min(4, RING_BYTES // stage))
        most_blocks = MMA_MAX_BLOCKS
    else:
        heads, tile, stages = (group if group < 3 else 4), _f32_tile(D), STAGES
        stage = 2 * tile * D * 4
        most_blocks = MIN_BLOCKS
    chunks = -(-group // heads)
    smem = max(stages * stage, 4 * (THREADS // 32) * heads * (D + 2))
    resident = min(most_blocks, SMEM_SM // (smem + SMEM_RESERVED)) * sms
    units = B * Hkv * chunks
    most = max(1, min(MAX_SPLITS, n_pages * block_size // tile,
                      smem // (4 * heads * (D + 2))))
    splits = 1 if units >= resident else min(most, resident // units)
    return {"splits": splits, "tile": tile, "stages": stages, "threads": THREADS,
            "heads": heads, "smem": smem, "grid": (splits, Hkv * chunks, B),
            "workspace_bytes": 0 if splits == 1 else
            4 * units * splits * heads * (D + 2) + 4 * units}


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
    if q.data_ptr() % 16 or k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("q and the pools must start on a 16-byte boundary (16-byte loads)")
    return B, Hq, Hkv, D, n_blocks, bs, table.shape[1]


# (device index, stream handle) -> [partials (float32), counters (int32, zeros)]
_WORKSPACES: dict[tuple[int, int], list[torch.Tensor]] = {}


def _workspace(device, stream: int, floats: int, counters: int) -> list[torch.Tensor]:
    """The partials and counters of ``device`` and ``stream``, grown to hold
    at least `floats` and `counters` (counters come zeroed and the kernel
    leaves them at zero)."""
    ws = _WORKSPACES.get((device.index, stream))
    if ws is None or ws[0].numel() < floats or ws[1].numel() < counters:
        have = (0, 0) if ws is None else (ws[0].numel(), ws[1].numel())
        ws = [torch.empty(max(floats, have[0]), dtype=torch.float32, device=device),
              torch.zeros(max(counters, have[1]), dtype=torch.int32, device=device)]
        _WORKSPACES[(device.index, stream)] = ws
    return ws


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
    sms = _build.sm_count(q.device)
    plan = decode_plan(B, Hkv, Hq // Hkv, D, q.dtype, n_pages, bs, sms)
    if B > 65535 or plan["grid"][1] > 65535:
        raise ValueError(f"shape too large for the kernel's grid: B={B} Hq={Hq} Hkv={Hkv}")
    stream = _build.stream(q)
    parts = counts = None
    if plan["splits"] > 1:
        units = plan["grid"][1] * B
        parts, counts = (t.data_ptr() for t in _workspace(
            q.device, stream, units * plan["splits"] * plan["heads"] * (D + 2), units))
    lib = _build.load_library("decode_attention")
    fn = getattr(lib, f"decode_attention_{_DTYPES[q.dtype]}")
    code = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), table.data_ptr(),
              lengths.data_ptr(), out.data_ptr(), parts, counts, B, Hq, Hkv, D, n_blocks, bs,
              n_pages, int(window is not None), int(window or 0), int(softcap is not None),
              float(softcap or 0.0), 1.0 / math.sqrt(D), plan["splits"], plan["smem"], sms,
              q.device.index, stream)
    _build.check(lib, code, "decode_attention launch")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def _live_positions(table, lengths, block_size, window) -> int:
    """Positions a call reads, summed over the batch: each row's length
    (capped by the window); on meta tensors, which hold no lengths, what
    the table can address (``n_pages * block_size`` a row)."""
    if lengths.is_meta:
        per_row = table.shape[1] * block_size
        return lengths.shape[0] * (per_row if window is None else min(per_row, window))
    lens = lengths.long().clamp(min=0)
    if window is not None:
        lens = lens.clamp(max=window)
    return int(lens.sum())


def decode_attention_cost(q, k_pool, v_pool, table, lengths, window=None,
                          softcap=None) -> tuple[int, int]:
    """(operations, bytes) of a call: two products of each query head over
    its row's live positions, 2 operations a multiply-add; q read and out
    written once, each live position's K and V read once, the table and
    lengths read once (bytes)."""
    B, Hq, D = q.shape
    live = _live_positions(table, lengths, k_pool.shape[1], window)
    esize = k_pool.element_size()
    return (4 * Hq * D * live,
            2 * q.numel() * esize + 2 * live * k_pool.shape[2] * D * esize
            + 4 * (table.numel() + B))


def decode_attention_meta(q, k_pool, v_pool, table, lengths, window=None, softcap=None):
    """``decode_attention``'s output as an empty tensor (the dry run's stand-in)."""
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    _check_inputs(q, k_pool, v_pool, table, lengths)
    return torch.empty_like(q)
