"""The split-position decode kernel's host-side plan
(``kernels/decode_attention.decode_plan``) and its split-and-merge rule, on
the CPU (no GPU needed).

- The plan: one split when the (sequence, kv head) units already fill the
  resident CTAs of an H100 (``decode_32k``: B = 128), as many as fit one
  wave at the serve shape; splits x tile never exceeds the table's positions; shared memory
  fits a block at every head dim and dtype; the workspace's size; the
  constants and kernel name it shares with ``csrc/decode_attention.cu``.
- The rule: ``ref.decode_split_ranges`` cuts [start, n_valid) into ordered,
  disjoint ranges of whole tiles, and ``ref.decode_attention_split_ref``
  (each split's softmax, merged in split order, as the kernel merges them)
  equals ``decode_attention_ref`` (float32, 1e-6) and the JAX package's
  Pallas kernel in interpret mode (the registry's bar) for splits in
  {1, 2, 3, 7, 64}: lengths 0 and 1, lengths shorter than splits x tile
  (empty splits), a window that empties whole splits, softcap, MQA and
  GQA 4, the null page past each length.
- chip_smoke.py's relative-norm bar on the long decode shapes: at a
  32,768-position sequence with its inputs, the output rounded to bf16 is
  within ``DECODE_LONG_REL`` and the plain version of a skipped tile or a
  dropped split is not.
"""
from __future__ import annotations

import functools
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import decode_attention as JDA
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (
    decode_attention_ref, decode_attention_split_ref, decode_split_ranges,
)

ROOT = Path(__file__).resolve().parents[1]
CU = ROOT / "src/repro_torch/kernels/csrc/decode_attention.cu"
F32 = ops.get_kernel("decode_attention").tolerance(torch.float32)
SMS = 132
DTYPES = (torch.bfloat16, torch.float32)

# (B, Hq, Hkv, D, n_blocks, block_size, n_pages, lengths, window, softcap)
CASES = {
    "gqa4_lengths": (4, 8, 2, 16, 40, 4, 8, [0, 1, 7, 29], None, None),
    "mqa": (3, 4, 1, 32, 24, 8, 3, [5, 24, 9], None, None),
    "short_empty_splits": (3, 4, 2, 16, 20, 4, 4, [2, 1, 3], None, None),
    "window_empties_splits": (2, 8, 2, 16, 40, 4, 9, [33, 21], 3, None),
    "softcap_window": (2, 4, 2, 32, 24, 4, 5, [19, 6], 4, 25.0),
    "softcap": (2, 2, 2, 16, 12, 4, 4, [16, 9], None, 15.0),
}
SPLITS = (1, 2, 3, 7, 64)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch CPU thread a test (ROADMAP Queue 3: in a process where JAX
    has computed, torch's multi-threaded CPU kernels here now and then
    return one worker's share of a tensor slightly off)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, atol, rtol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.all(np.abs(got - want) <= atol + rtol * np.abs(want)), \
        float(np.max(np.abs(got - want)))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _resident(plan, dtype):
    most = DA.MMA_MAX_BLOCKS if dtype == torch.bfloat16 else DA.MIN_BLOCKS
    return min(most, DA.SMEM_SM // (plan["smem"] + DA.SMEM_RESERVED)) * SMS


def test_plan_takes_one_split_when_units_fill_two_waves():
    """decode_32k with minitron-8b's heads: 128 x 8 units fill two resident
    waves of 132 SMs, so each CTA walks a whole sequence and no workspace
    is needed."""
    plan = DA.decode_plan(128, 8, 4, 128, torch.bfloat16, 2048, 16, SMS)
    assert 128 * 8 >= 2 * _resident(plan, torch.bfloat16)
    assert plan["splits"] == 1 and plan["workspace_bytes"] == 0
    assert plan["grid"] == (1, 8, 128)


@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_splits_the_serve_shape(dtype):
    """The serve pool (8 slots, 64 pages of 16, GQA 32/8, D 128): 64 units
    on 132 SMs take several splits each, as many as fit one resident wave
    (a second, partial wave would end with a few CTAs streaming alone)."""
    plan = DA.decode_plan(8, 8, 4, 128, dtype, 64, 16, SMS)
    resident = _resident(plan, dtype)
    assert plan["splits"] >= 2
    assert plan["splits"] * 64 <= resident < (plan["splits"] + 1) * 64
    assert plan["grid"] == (plan["splits"], 8, 8) and plan["heads"] == 4


@pytest.mark.parametrize("n_pages,block_size", [(0, 16), (1, 1), (1, 16), (3, 8), (64, 16),
                                                (5, 4), (2048, 16), (7, 3)])
@pytest.mark.parametrize("D", DA.HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_splits_stay_within_the_table(n_pages, block_size, D, dtype):
    for B, Hkv, group in [(1, 1, 1), (8, 8, 4), (2, 4, 2), (3, 1, 32), (128, 8, 4)]:
        plan = DA.decode_plan(B, Hkv, group, D, dtype, n_pages, block_size, SMS)
        s, tile = plan["splits"], plan["tile"]
        assert 1 <= s <= DA.MAX_SPLITS
        assert s == 1 or s * tile <= n_pages * block_size


@pytest.mark.parametrize("D", DA.HEAD_DIMS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("group", [1, 2, 3, 4, 8, 32])
def test_plan_shared_memory_fits_a_block(D, dtype, group):
    """The ring (stages x tile x D x 2 values) and, reused after the last
    tile, the 4 warps' (acc, m, l) of the block's heads, within 227 KB; a
    tile splits evenly over the copies and the warps (bf16: 16 positions a
    warp, the tensor cores' k of P V; float32: whole row passes)."""
    plan = DA.decode_plan(8, 8, group, D, dtype, 64, 16, SMS)
    esize = torch.empty((), dtype=dtype).element_size()
    ring = plan["stages"] * 2 * plan["tile"] * D * esize
    merge = 4 * 4 * plan["heads"] * (D + 2)
    assert plan["smem"] == max(ring, merge) <= DA.SMEM_MAX
    assert plan["tile"] * D * esize // 16 % plan["threads"] == 0
    if dtype == torch.bfloat16:
        assert plan["tile"] == 64 and 2 <= plan["stages"] <= 4
        assert plan["heads"] == min(group, 8)
    else:
        assert plan["tile"] % (4 * (32 // min(32, D // 4))) == 0
        assert plan["heads"] == {1: 1, 2: 2}.get(group, 4)


@pytest.mark.parametrize("B,Hkv,group,D,n_pages", [(8, 8, 4, 128, 64), (8, 4, 2, 256, 20),
                                                   (2, 1, 32, 64, 10), (1, 32, 1, 64, 64)])
def test_plan_workspace_bytes(B, Hkv, group, D, n_pages):
    """Partials (acc, m, l: D + 2 floats a head a split a unit) and one int32
    counter a unit; the grid's y axis is kv heads x head chunks."""
    plan = DA.decode_plan(B, Hkv, group, D, torch.bfloat16, n_pages, 16, SMS)
    heads = plan["heads"]
    units = B * Hkv * -(-group // heads)
    assert plan["grid"][1] * B == units
    assert plan["splits"] > 1
    assert plan["workspace_bytes"] == 4 * units * plan["splits"] * heads * (D + 2) + 4 * units


def test_plan_constants_match_the_cuda_source():
    """decode_plan repeats the .cu's reckoning (its launcher refuses a plan
    that differs): the constants must be the same, and the kernel name that
    chip_smoke.py profiles must exist."""
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kRingBytes") == DA.RING_BYTES
    assert const("kStages") == DA.STAGES
    assert const("kStageBytes") == DA.STAGE_BYTES
    assert const("kMaxSplits") == DA.MAX_SPLITS
    assert const("kThreads") == DA.THREADS
    assert const("kMmaHeads") == DA.MMA_HEADS
    assert const("kMmaMaxBlocks") == DA.MMA_MAX_BLOCKS
    assert int(re.search(r"static constexpr int kTile = (\d+);", src).group(1)) == DA.MMA_TILE
    assert const("kMinBlocks") == DA.MIN_BLOCKS
    assert const("kSmemPerSM") == DA.SMEM_SM
    assert const("kSmemPerBlock") == DA.SMEM_MAX
    assert const("kSmemReserved") == DA.SMEM_RESERVED
    assert "__global__ void __launch_bounds__(kThreads) flash_decode_kernel(" in src
    assert "__global__ void __launch_bounds__(kThreads, kMinBlocks) flash_decode_f32_kernel(" in src
    assert '("flash_decode_kernel",)' in (ROOT / "chip_smoke.py").read_text()


def test_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        DA.decode_plan(8, 8, 4, 96, torch.bfloat16, 64, 16, SMS)
    with pytest.raises(ValueError):
        DA.decode_plan(8, 8, 4, 128, torch.float16, 64, 16, SMS)


# ---------------------------------------------------------------------------
# the split-and-merge rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tile", [1, 4, 32])
@pytest.mark.parametrize("splits", SPLITS)
def test_split_ranges_cover_the_valid_positions_once(tile, splits):
    """Ranges are ordered and disjoint, start and end on tile edges (or on
    start / n_valid), and together are exactly [start, n_valid)."""
    for length in [0, 1, 2, 5, 31, 32, 33, 100, 1000]:
        for window in [None, 1, 3, 40]:
            for cap in [length, 64]:
                ranges = decode_split_ranges(length, cap, window, tile, splits)
                assert len(ranges) == splits
                n_valid = min(length, cap)
                start = max(0, length - window) if window else 0
                got = [p for lo, hi in ranges for p in range(lo, hi)]
                assert got == list(range(start, n_valid))
                for lo, hi in ranges:
                    if lo < hi:
                        assert lo == start or lo % tile == 0
                        assert hi == n_valid or hi % tile == 0


def _inputs(case, seed):
    B, Hq, Hkv, D, nb, bs, n_pages, lengths = case[:8]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, Hkv, D)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, Hkv, D)).astype(np.float32)
    # distinct pages per sequence; the null page 0 past each length
    table = np.zeros((B, n_pages), np.int32)
    pages = rng.permutation(np.arange(1, nb))
    used = 0
    for b, n in enumerate(lengths):
        need = -(-n // bs)
        table[b, :need] = pages[used:used + need]
        used += need
    return q, kp, vp, table, np.asarray(lengths, np.int32)


@functools.lru_cache(maxsize=None)
def _pallas(name):
    """The JAX package's Pallas decode kernel in interpret mode."""
    case = CASES[name]
    args = _inputs(case, seed=len(name))
    return np.asarray(JDA.decode_attention(*map(jnp.asarray, args), window=case[8],
                                           softcap=case[9], interpret=True))


@pytest.mark.parametrize("splits", SPLITS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_ref_matches_plain_and_jax(name, splits):
    """At the kernel's own tile for the case's D and at tiles of 4 and 1
    position (so several splits hold positions and the merge is real)."""
    case = CASES[name]
    window, cap = case[8:]
    args = [torch.as_tensor(a) for a in _inputs(case, seed=len(name))]
    B, Hq, Hkv, D = case[:4]
    plan = DA.decode_plan(B, Hkv, Hq // Hkv, D, torch.float32, case[6], case[5], SMS)
    want = decode_attention_ref(*args, window, cap).numpy()
    lengths = case[7]
    for tile in (plan["tile"], 4, 1):
        got = decode_attention_split_ref(*args, window, cap, splits=splits, tile=tile).numpy()
        _close(got, want, 1e-6, 1e-6)
        _close(got, _pallas(name), F32.atol, F32.rtol)
        assert np.all(got[np.asarray(lengths) == 0] == 0.0)  # length 0: a zero row


def test_split_ref_bf16_rounds_like_the_plain_version():
    case = CASES["gqa4_lengths"]
    t = [torch.as_tensor(a) for a in _inputs(case, seed=3)]
    for i in range(3):
        t[i] = t[i].to(torch.bfloat16)
    got = decode_attention_split_ref(*t, splits=3, tile=4)
    assert got.dtype == torch.bfloat16
    want = decode_attention_ref(*t)
    _close(got.float().numpy(), want.float().numpy(), 2 ** -8, 2 ** -8)


def test_split_ref_reads_nothing_past_the_length():
    """Pool rows past each length (and the null page) do not change the
    split result: poison them and compare."""
    case = CASES["gqa4_lengths"]
    q, kp, vp, table, lengths = _inputs(case, seed=5)
    base = decode_attention_split_ref(*map(torch.as_tensor, (q, kp, vp, table, lengths)),
                                      splits=7, tile=4)
    bs = kp.shape[1]
    kp2, vp2 = kp.copy(), vp.copy()
    for b, n in enumerate(lengths):
        if n % bs:
            page = table[b, n // bs]
            kp2[page, n % bs:] = 1e4
            vp2[page, n % bs:] = 1e4
    kp2[0] = vp2[0] = 1e4
    got = decode_attention_split_ref(*map(torch.as_tensor, (q, kp2, vp2, table, lengths)),
                                     splits=7, tile=4)
    _close(got.numpy(), base.numpy(), 0.0, 0.0)


@pytest.mark.parametrize("name", sorted(chip_smoke.DECODE_LONG))
def test_long_decode_bar_catches_a_skipped_tile_or_split(name):
    """One sequence of a long shape (32,768 positions, minitron-8b's heads,
    bf16) with the plan the shape's batch takes: rounding the plain output
    to bf16 stays within DECODE_LONG_REL, a tile or split left out does
    not. (With N(0, 1) inputs the registry's bar alone would pass both.)"""
    b, length = chip_smoke.DECODE_LONG[name]
    q, kp, vp, table, lengths = chip_smoke.decode_long_inputs(1, length, torch.device("cpu"))
    plan = DA.decode_plan(b, 8, 4, 128, torch.bfloat16, table.shape[1], 16, SMS)
    q = q.float()  # a float32 output (the plain version computes in float32)
    want = decode_attention_ref(q, kp, vp, table, lengths)
    limit = chip_smoke.DECODE_LONG_REL
    assert chip_smoke.rel_norm(want.to(torch.bfloat16), want) <= limit / 2
    faults = chip_smoke.decode_long_faults(q, kp, vp, table, lengths, plan["tile"],
                                           plan["splits"])
    assert len(faults) == (2 if plan["splits"] > 1 else 1)
    for fault, out in faults.items():
        assert chip_smoke.rel_norm(out, want) > 2 * limit, fault
        # ... while the registry's bar, alone, lets it through
        tol = ops.get_kernel("decode_attention").tolerance(torch.bfloat16)
        if fault == "last tile skipped":
            assert torch.all((out - want).abs() <= tol.atol + tol.rtol * want.abs())
