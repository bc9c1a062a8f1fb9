"""A CPU rehearsal of the ``block_topk`` kernel's select (no GPU needed), and
its host-side plan (``kernels/topk_compress.topk_plan``).

- ``select_model`` is a numpy model of ``csrc/topk_compress.cu``'s
  ``select_row``, step by step: the 32-bit magnitude key (NaNs one key above
  +inf), the first digit's histogram (one a warp over its contiguous part of
  the row), the boundary digit by a suffix count, the candidate list in
  index order (a warp's offset is the earlier warps' count in the bin), the
  later digits over the candidates (or the row filtered by the prefix when
  the bin exceeds the list's capacity), the stops (a bin taken whole, one
  magnitude left, the last digit), the tie cut by index, and the final
  order by (key descending, index ascending). It is held to
  ``block_topk_ref`` bit for bit over seeded and hypothesis-made rows: ties
  at the boundary, all-equal rows, denormals, NaNs and infinities, k = 1,
  k = block, ragged block lengths, both capacities, and the stream
  variant's 8 warps.
- The plan: every gossip-path shape takes the staged variant, with the
  shared memory the ``.cu``'s layout gives, inside a block's and an SM's
  limits; small rows take 3 or 2 stages; rows too long to stage take the
  stream variant; k above ``K_MAX`` raises by name; the persistent grid
  never exceeds the rows.
- The ``__global__`` names ``chip_smoke.py`` profiles exist in the source.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import topk_compress as TK
from repro_torch.kernels.ref import block_topk_ref, magnitude_key

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LEVELS = ((23, 8), (15, 8), (7, 8), (0, 7))  # (shift, width) of each digit
NAN_KEY = 0x7F800001
SLAB = 128


def keys_of(row: np.ndarray) -> np.ndarray:
    """The kernel's key_of: |x|'s bits, every NaN -> one key above +inf."""
    b = row.view(np.uint32) & np.uint32(0x7FFFFFFF)
    return np.where(b > 0x7F800000, NAN_KEY, b).astype(np.int64)


def warp_parts(n: int, nw: int, unit: int) -> list[tuple[int, int]]:
    """Each warp's contiguous part [lo, hi) of n entries, in whole units."""
    c = -(-n // (nw * unit)) * unit
    return [(min(n, w * c), min(n, w * c + c)) for w in range(nw)]


def find_digit(counts: np.ndarray, need: int) -> tuple[int, int, int]:
    """(d, above, cnt): the digit with above < need <= above + cnt, digits
    scanned from the largest down (the kernel's suffix scan)."""
    run = 0
    for d in range(len(counts) - 1, -1, -1):
        if run < need <= run + counts[d]:
            return d, run, int(counts[d])
        run += int(counts[d])
    raise AssertionError("need exceeds the row")


def select_model(row: np.ndarray, k: int, cap: int, nw: int = 4, guess: int = -1):
    """The kernel's select on one float32 row, given the boundary digit the
    previous row of its CTA found (`guess`, -1 for none): (vals, idx,
    stats, the digit the next row guesses)."""
    block = row.size
    key = keys_of(row)
    parts = warp_parts(block, nw, SLAB)
    capw = cap // nw
    stats = {"levels": 1, "list": False, "ties": 0, "guessed": False}
    sel, lists = [], None
    B = ties = None
    if guess >= 0:
        # the guess pass: larger digits taken, digit `guess` listed a warp
        above = sum(int((key[lo:hi] >> 23 > guess).sum()) for lo, hi in parts)
        counts = [int((key[lo:hi] >> 23 == guess).sum()) for lo, hi in parts]
        if above < k <= above + sum(counts) and max(counts) <= capw:
            stats["guessed"] = True
            d0, need = guess, k - above
            sel = [e for lo, hi in parts for e in range(lo, hi) if key[e] >> 23 > guess]
            lists = [[e for e in range(lo, hi) if key[e] >> 23 == guess] for lo, hi in parts]
            if sum(counts) == need:
                B, ties = (d0 << 23) - 1, 0
    if lists is None:
        # pass 1: a histogram of the first digit a warp
        hist = np.zeros((nw, 256), np.int64)
        for w, (lo, hi) in enumerate(parts):
            np.add.at(hist[w], key[lo:hi] >> 23, 1)
        d0, above, cnt0 = find_digit(hist.sum(0), k)
        need = k - above
        guess = d0
        if cnt0 == need:
            B, ties = (d0 << 23) - 1, 0
        elif hist[:, d0].max() <= capw:
            # pass 2: larger digits taken, bin d0 listed a warp, index order
            sel = [e for lo, hi in parts for e in range(lo, hi) if key[e] >> 23 > d0]
            lists = [[e for e in range(lo, hi) if key[e] >> 23 == d0] for lo, hi in parts]
    stats["list"] = lists is not None
    # the universe: the warps' lists in warp order (index order), or the row
    universe = np.array([e for li in lists for e in li], np.int64) if lists else np.arange(block)
    assert (np.diff(universe) > 0).all()
    prefix, pshift = d0, 23
    L = 1
    while B is None:
        shift, width = LEVELS[L]
        stats["levels"] = L + 1
        uk = key[universe]
        match = (uk >> pshift) == prefix
        if uk[match].min() == uk[match].max():  # one magnitude left
            B, ties = int(uk[match].min()), need
            break
        counts = np.bincount((uk[match] >> shift) & ((1 << width) - 1), minlength=256)
        dl, al, cl = find_digit(counts, need)
        npref = (prefix << width) | dl
        if cl == need - al:
            B, ties = (npref << shift) - 1, 0
        elif L == 3:
            B, ties = npref, need - al
        else:
            prefix, pshift, need = npref, shift, need - al
            L += 1
    stats["ties"] = ties
    # the final sweep: key > B, and the `ties` lowest-index entries == B
    uk = key[universe]
    tie_pos = np.flatnonzero(uk == B)[:ties] if ties else np.array([], np.int64)
    sel = np.array(list(sel) + list(universe[uk > B]) + list(universe[tie_pos]), np.int64)
    assert sel.size == k, (sel.size, k)
    order = sorted(sel.tolist(), key=lambda e: (-key[e], e))
    idx = np.array(order, np.int32)
    return row[idx], idx, stats, guess


def check_rows(x: np.ndarray, k: int, cap: int, nw: int = 4) -> list[dict]:
    """Every row through the model, as one CTA walks them (each row guesses
    the previous row's boundary digit), held to the plain version bit for
    bit."""
    vals, idx = block_topk_ref(torch.as_tensor(x), k)
    out, guess = [], -1
    for r in range(x.shape[0]):
        v, i, stats, guess = select_model(x[r], k, cap, nw, guess)
        np.testing.assert_array_equal(i, idx[r].numpy())
        np.testing.assert_array_equal(v.view(np.uint32), vals[r].numpy().view(np.uint32))
        out.append(stats)
    return out


SPECIALS = np.array([0x7FC00000, 0x7FC00005, 0xFFC00003, 0x7F800001, 0xFF812345, 0x7F800000,
                     0xFF800000, 0x80000000, 0x00000000, 0x00000001, 0x807FFFFF, 0x00400000],
                    np.uint32)


def make_rows(nb, block, kind, seed=0):
    """float32 rows: 'random', 'ties' (halves), 'constant', 'zeros',
    'special' (NaNs of several payloads and signs, +-inf, +-0 and
    denormals, a tenth of the row), 'tiny' (denormals only)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nb, block)).astype(np.float32)
    if kind == "ties":
        x = (np.round(x * 2) / 2).astype(np.float32)
    elif kind == "constant":
        x[:] = 1.0
        x[1::2] = -0.25
    elif kind == "zeros":
        x[:] = 0.0
        x[1::2] = -0.0
    elif kind == "special":
        m = max(1, block // 10)
        for r in range(nb):
            x[r].view(np.uint32)[rng.integers(0, block, m)] = rng.choice(SPECIALS, m)
    elif kind == "tiny":
        bits = rng.integers(0, 6, (nb, block)) | rng.integers(0, 2, (nb, block)) << 31
        x = bits.astype(np.uint32).view(np.float32)
    return x


# (block, k): the gossip step's (4096, 40), (2304, 23), (64, 1), (16, 16),
# k = block, ragged blocks, a block above 8192
SHAPES = [(4096, 40), (2304, 23), (64, 1), (16, 16), (512, 512), (1000, 10), (8193, 81),
          (37, 5)]
KINDS = ["random", "ties", "constant", "zeros", "special", "tiny"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("block,k", SHAPES)
def test_select_model_equals_plain(block, k, kind):
    """Both capacities: the staged CTA's STAGED_CAP candidates and one so small
    (one a warp) that the row itself is refined (the path of a bin above
    capacity); three rows, so the second and third guess the first's
    boundary digit."""
    x = make_rows(3, block, kind, seed=block + k)
    for cap in (TK.STAGED_CAP, 4):
        check_rows(x, k, cap)


def test_select_model_reaches_every_stop():
    """The rows above reach every branch: a first bin taken whole, the
    candidate list, a later bin taken whole, one magnitude left, the last
    digit with a tie cut, and the row refined past the list's capacity."""
    seen = set()
    for block, k in SHAPES:
        for kind in KINDS:
            x = make_rows(3, block, kind, seed=block + k)
            for cap in (TK.STAGED_CAP, 4):
                for s in check_rows(x, k, cap):
                    seen.add(("list" if s["list"] else "row", s["levels"], s["ties"] > 0,
                              s["guessed"]))
    assert {("row", 1, False, False), ("list", 2, False, False), ("list", 2, False, True),
            ("list", 2, True, True), ("row", 2, True, False), ("list", 1, False, True)} <= seen, seen
    assert any(lv == 4 for _, lv, _, _ in seen), seen


def test_select_model_ties_at_the_boundary():
    """The boundary magnitude holds more entries than the cut takes: the
    lowest indices win, wherever they sit among the warps' parts."""
    block, k = 4096, 40
    x = np.zeros((2, block), np.float32)
    x[0, ::7] = 3.0  # 586 equal magnitudes across all four warps' parts
    x[0, 5:20] = 5.0  # 15 above them
    x[1, 3000:] = -2.0  # the ties sit in the last two parts only
    x[1, 10] = np.float32(np.nan)
    check_rows(x, k, TK.STAGED_CAP)
    check_rows(x, k, 4)


def test_select_model_overflows_at_the_plan_capacity():
    """At the plan's own capacities, rows whose boundary bin holds more than
    a warp's list (a constant row; rows of one first digit and many
    magnitudes) refine the row itself, staged (4 warps, STAGED_CAP) and
    streamed (8 warps, STREAM_CAP), and stay equal to the plain version."""
    rng = np.random.default_rng(5)
    for block, k, nw, cap in ((4096, 40, 4, TK.STAGED_CAP),
                              (65_536, 655, TK.STREAM_WARPS, TK.STREAM_CAP)):
        x = np.ones((3, block), np.float32)
        x[1] = 1.0 + 0.5 * rng.random(block, dtype=np.float32)
        x[2] = -x[1]
        stats = check_rows(x, k, cap, nw)
        assert [s["list"] for s in stats] == [False] * 3, stats
        assert stats[0]["ties"] == k and stats[1]["levels"] >= 2
    for kind in ("random", "ties", "special"):  # the stream CTA's 8 warps, lists fitting
        assert any(s["list"] for s in check_rows(make_rows(2, 20_000, kind, seed=9), 200,
                                                 TK.STREAM_CAP, TK.STREAM_WARPS))


@settings(max_examples=60, deadline=None)
@given(block=st.integers(1, 700), data=st.data())
def test_select_model_hypothesis(block, data):
    """Hypothesis rows: values drawn from a small pool (many ties), with
    NaNs, infinities, signed zeros and denormals; any k, both capacities."""
    k = data.draw(st.integers(1, block))
    pool = data.draw(st.lists(st.sampled_from(
        [0.0, -0.0, 1.0, -1.0, 2.5, -2.5, 1e-40, -1e-40, 3e38, float("inf"), float("-inf"),
         float("nan"), 0.5, 7.0]), min_size=1, max_size=6))
    pick = data.draw(st.lists(st.integers(0, len(pool) - 1), min_size=block, max_size=block))
    x = np.array([pool[i] for i in pick], np.float32)[None, :].repeat(2, 0)
    x[1] = x[1, ::-1]  # a second row, guessing the first's boundary digit
    nan_bits = data.draw(st.sampled_from([0x7FC00000, 0xFFC00001, 0x7F800003]))
    x.view(np.uint32)[np.isnan(x)] = nan_bits
    cap = data.draw(st.sampled_from([4, 16, 4 * block]))
    check_rows(x, k, cap)


def test_magnitude_key_orders_like_abs():
    """The plain version's key (``ref.magnitude_key``) equals the kernel's
    key_of, and orders like |x| with NaNs above +inf, all equal."""
    x = make_rows(1, 4096, "special", seed=3)[0]
    got = magnitude_key(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, keys_of(x))
    finite = ~np.isnan(x)
    a = np.abs(x[finite].astype(np.float64))
    kf = got[finite]
    assert (np.greater.outer(kf, kf) == np.greater.outer(a, a)).all()
    assert (np.equal.outer(kf, kf) == np.equal.outer(a, a)).all()
    assert (got[~finite] == NAN_KEY).all() and (got[finite] < NAN_KEY).all()


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

# every shape the gossip path gives the kernel: gemma2-2b's blocks at
# block_size 4096 and ratio 0.01 (k_b 40; final_norm 2304 with 23), the
# reduced configs' (64 and 16 with 1), and block_size 2**20 (k_b 10,485)
GOSSIP = [(288_000, 4096, 40), (2, 2304, 23), (4, 2304, 23), (20_736, 4096, 40),
          (128, 64, 1), (32, 16, 1), (2, 2**20, 10_485)]


@pytest.mark.parametrize("nb,block,k", GOSSIP)
def test_plan_for_gossip_shapes(nb, block, k):
    plan = TK.topk_plan(block, k, nb)
    assert plan["variant"] == ("staged" if block <= 8192 else "stream")
    assert plan["smem"] == TK.topk_smem(block, k, plan["stages"], plan["cap"])
    assert plan["smem"] <= TK.SMEM_MAX
    assert plan["ctas_per_sm"] * (plan["smem"] + TK.SMEM_RESERVED) <= TK.SMEM_SM
    assert plan["ctas_per_sm"] * plan["threads"] <= TK.THREADS_SM
    assert 1 <= plan["grid"] <= min(nb, plan["ctas_per_sm"] * TK.H100_SMS)
    assert plan["sort"] >= k and plan["sort"] & (plan["sort"] - 1) == 0
    assert plan["cap"] >= plan["warps"] and plan["cap"] % plan["warps"] == 0
    if plan["variant"] == "staged":
        assert plan["stages"] in (1, 2, 3) and plan["warps"] == 4
    else:
        assert plan["stages"] == 0 and plan["warps"] == TK.STREAM_WARPS


def test_plan_main_shape():
    """The embedding leaf: 16 KB rows; the plan keeps the most CTAs on an SM
    (one stage, 9 CTAs: measured faster than 2-3 stages at 4-6 CTAs), so
    ~144 KB of rows an SM are loading or being selected, and the grid is
    the card's resident CTAs."""
    plan = TK.topk_plan(4096, 40, 288_000)
    assert (plan["variant"], plan["warps"], plan["threads"]) == ("staged", 4, 128)
    assert (plan["stages"], plan["ctas_per_sm"], plan["cap"]) == (1, 9, TK.STAGED_CAP)
    for s in (2, 3):
        smem = TK.topk_smem(4096, 40, s, TK.STAGED_CAP)
        assert TK._ctas_per_sm(smem, plan["threads"]) < plan["ctas_per_sm"]
    assert plan["ctas_per_sm"] * 4096 * 4 >= 32 * 1024  # >= 32 KB of rows an SM
    assert plan["grid"] == plan["ctas_per_sm"] * TK.H100_SMS


def test_plan_limits():
    """k = block at 8192 is staged and sorted in shared memory; the largest
    staged block; K_MAX at a long row streams; k above K_MAX, k = 0 and
    k > block raise by name; the stages small rows take."""
    assert TK.topk_plan(8192, 8192, 2)["variant"] == "staged"
    big = max(b for b in range(16_000, 80_000, 1000)
              if TK.topk_plan(b, 40)["variant"] == "staged")
    assert TK.topk_plan(big + 1000, 40)["variant"] == "stream"
    plan = TK.topk_plan(1_000_003, TK.K_MAX, 2)
    assert plan["variant"] == "stream" and plan["smem"] <= TK.SMEM_MAX
    assert plan["threads"] == 32 * TK.STREAM_WARPS and plan["grid"] == 2
    assert plan["sort"] == TK.K_MAX
    with pytest.raises(ValueError, match="K_MAX"):
        TK.topk_plan(1_000_003, TK.K_MAX + 1)
    for k in (0, 65):
        with pytest.raises(ValueError, match="k="):
            TK.topk_plan(64, k)
    # every k that block_size <= 2**20 with topk_ratio <= 0.01 gives
    assert int(2**20 * 0.01) <= TK.K_MAX
    # small rows: the ring of the most stages at the most CTAs an SM
    assert [TK.topk_plan(b, 40)["stages"] for b in (64, 464, 480, 704, 720)] == [3, 3, 2, 2, 1]


def test_cu_names_and_constants():
    """The kernel names chip_smoke.py profiles, and the constants the plan
    mirrors, exist in the source."""
    src = (ROOT / "src/repro_torch/kernels/csrc/topk_compress.cu").read_text()
    for name in ("block_topk_staged_kernel", "block_topk_stream_kernel"):
        assert re.search(rf"__global__ void __launch_bounds__\(32 \* NW\) {name}\(", src)
    assert f"kKMax = {TK.K_MAX};" in src
    assert f"kScalars = {TK.SCALARS};" in src
    assert f"kBins = {TK.BINS};" in src
