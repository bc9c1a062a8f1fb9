"""The SSD kernels' host-side plan (``kernels/ssd_scan.ssd_plan``) and a CPU
rehearsal of their arithmetic (no GPU needed).

- The plan: every (chunk, row tile, head) and every state tile is covered
  by exactly one CTA of each kernel, as ``csrc/ssd_scan.cu`` decodes
  ``blockIdx.x`` (``ssd_work``); shared memory fits a block; the grids fill
  an H100's 132 SMs (two waves at the train shape, at least 132 CTAs at a
  serve prefill); shapes the kernels do not take raise.
- The split: the kernels take every float32 product as three TF32 products
  (hi = rna(a), lo = a - hi read by the tensor core as TF32; lo.hi + hi.lo
  + hi.hi). Emulated here with torch on the CPU (TF32 rounding of hi by
  masking the low 13 mantissa bits after adding half of them: round to
  nearest, ties away; lo's low 13 bits dropped), the plain SSD forward and
  backward at
  Q = 256 stay within the registry's float32 bars against float64, where a
  single TF32 product misses them. This rehearses the arithmetic only: the
  tensor cores' own float32 accumulation is measured on the card
  (``chip_smoke.py`` ssd phase).
- The ``__global__`` names that ``chip_smoke.py`` profiles exist in the
  source.
"""
from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import _ssd_decay, ssd_chunk_bwd_ref, ssd_chunk_ref
from repro_torch.kernels.ssd_scan import SMEM_MAX, ssd_plan, ssd_work

ROOT = Path(__file__).resolve().parents[1]
SMS = 132

# (B, nc, Q, nh, hd, ds): the main paths' shapes (train, score, serve
# prefill), ragged Q / nh / hd / ds, zamba2's widths, the longest chunk
SHAPES = {"train": (4, 8, 256, 64, 64, 128), "score": (1, 8, 256, 64, 64, 128),
          "prefill": (1, 1, 256, 64, 64, 128), "q1": (1, 1, 1, 3, 64, 128),
          "q5": (2, 1, 5, 6, 64, 128), "q37": (1, 2, 37, 3, 64, 128),
          "reduced": (1, 3, 37, 6, 16, 16), "odd": (1, 3, 5, 3, 4, 5),
          "hd50": (1, 2, 100, 5, 50, 70), "zamba2": (2, 4, 256, 64, 64, 64),
          "longest": (1, 1, 640, 64, 64, 128)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One torch CPU thread a test (ROADMAP Queue 3: in a process where JAX
    has computed, torch's multi-threaded CPU kernels here now and then
    return one worker's share of a tensor slightly off)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("name", list(SHAPES))
def test_ssd_plan_covers_every_tile_once(name):
    """Each kernel's CTAs, decoded as the .cu decodes them, cover every
    work unit exactly once, and the grid is exactly that many CTAs."""
    B, nc, Q, nh, hd, ds = SHAPES[name]
    BC, nIT, nST = B * nc, _cdiv(Q, 64), _cdiv(ds, 64)
    plan = ssd_plan(BC, Q, nh, hd, ds)
    heads = {(bc, t, h) for bc in range(BC) for t in range(nIT) for h in range(nh)}
    state = {(bc, s, h) for bc in range(BC) for s in range(0, nST * 64, 64) for h in range(nh)}
    s_tiles = {(bc, t, s) for bc in range(BC) for t in range(nIT) for s in range(0, nST * 64, 64)}

    def units(kernel):
        work = ssd_work(kernel, plan, BC, Q, nh, ds)
        assert len(work) == plan[kernel]["grid"][0]
        got = {}
        for kind, *rest in work:
            if kind in ("rows", "state", "dx"):  # (bc, tile, first head, heads)
                bc, tile, h0, ng = rest
                assert 1 <= ng <= plan[kernel]["heads"]
                keys = [(bc, tile, h) for h in range(h0, h0 + ng)]
            else:
                keys = [tuple(rest)]
            for key in keys:
                got.setdefault(kind, []).append(key)
        return got

    fwd = units("ssd_fwd_kernel")
    assert sorted(fwd["rows"]) == sorted(heads) and sorted(fwd["state"]) == sorted(state)
    assert sorted(units("ssd_bwd_rows_kernel")["rows"]) == sorted(heads)
    cols = units("ssd_bwd_cols_kernel")
    assert sorted(cols["dx"]) == sorted(heads)
    assert sorted(cols["dB"]) == sorted(s_tiles) and sorted(cols["dC"]) == sorted(s_tiles)
    assert sorted(units("ssd_bwd_finish_kernel")["dcum"]) == sorted(
        (bc, t) for bc in range(BC) for t in range(nIT))


@pytest.mark.parametrize("name", list(SHAPES))
def test_ssd_plan_fits_a_block_and_orders_longest_first(name):
    """Shared memory within a block's 232,448 bytes (and under half an SM's
    228 KB where two CTAs share it at the model's widths); the forward's and
    the backward rows kernel's first CTAs take the last (longest) i tile."""
    B, nc, Q, nh, hd, ds = SHAPES[name]
    plan = ssd_plan(B * nc, Q, nh, hd, ds)
    for k, v in plan.items():
        assert 0 <= v["smem"] <= SMEM_MAX, k
        assert v["threads"] == 128 and v["rows"] == 64
        if Q <= 256:
            assert v["smem"] + 1024 <= 228 * 1024 // 2, k  # two CTAs an SM
    nIT = _cdiv(Q, 64)
    for k in ("ssd_fwd_kernel", "ssd_bwd_rows_kernel"):
        first = ssd_work(k, plan, B * nc, Q, nh, ds)[0]
        assert first[0] == "rows" and first[2] == nIT - 1


def test_ssd_plan_fills_the_card():
    """Two waves of 132 SMs at the train shape; at least 132 CTAs at a serve
    prefill (one chunk), which is 69% of the forward's launches."""
    train = ssd_plan(32, 256, 64, 64, 128, SMS)
    prefill = ssd_plan(1, 256, 64, 64, 128, SMS)
    for k in ("ssd_fwd_kernel", "ssd_bwd_rows_kernel", "ssd_bwd_cols_kernel"):
        assert train[k]["grid"][0] >= 2 * SMS, k
    assert prefill["ssd_fwd_kernel"]["grid"][0] >= SMS
    assert train["ssd_fwd_kernel"]["heads"] == 8 and prefill["ssd_fwd_kernel"]["heads"] == 1
    assert (train["ssd_fwd_kernel"]["smem"], train["ssd_bwd_rows_kernel"]["smem"],
            train["ssd_bwd_cols_kernel"]["smem"]) == (111_104, 79_360, 108_032)


@pytest.mark.parametrize("shape,match", [((1, 641, 4, 64, 128), "shared memory"),
                                         ((1, 64, 4, 65, 128), "hd <= 64"),
                                         ((1, 64, 4, 64, 129), "ds <= 128"),
                                         ((1, 0, 4, 64, 128), "outside")])
def test_ssd_plan_refuses_what_the_kernels_do_not_take(shape, match):
    """A chunk longer than 640 steps (its score tiles exceed a block's shared
    memory), hd > 64, ds > 128 or an empty shape raise ValueError; the
    wrappers plan every CUDA call, so they raise the same."""
    with pytest.raises(ValueError, match=match):
        ssd_plan(*shape)


# ---------------------------------------------------------------------------
# the split, rehearsed on the CPU
# ---------------------------------------------------------------------------

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits), to nearest, ties away
    from zero (``cvt.rna.tf32.f32``): add half of the dropped 13 bits to the
    magnitude, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_read(x: torch.Tensor) -> torch.Tensor:
    """What a TF32 tensor core reads of a float32 register: its top 19 bits
    (the low 13 mantissa bits dropped, i.e. truncated)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_mm(terms):
    """einsum with each operand split as the kernels split it: hi = rna(a),
    lo = a - hi (exact in float32, read by the tensor core as TF32); the
    product lo.hi + hi.lo + hi.hi, summed in float32."""
    def mm(eq, a, b):
        ah, bh = _tf32(a), _tf32(b)
        if terms == 1:
            return torch.einsum(eq, ah, bh)
        al, bl = _tf32_read(a - ah), _tf32_read(b - bh)
        return torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl) + torch.einsum(eq, ah, bh)
    return mm


def _fwd(xdt, cum, Bc, Cc, mm):
    """ssd_chunk_ref with every product through `mm`, each operand that the
    kernels compute in registers (S o L, B o dte) formed first."""
    S = mm("bcis,bcjs->bcij", Cc, Bc)
    y = mm("bcijh,bcjhd->bcihd", S[..., None] * _ssd_decay(cum), xdt)
    dte = torch.exp(cum[:, :, -1:, :] - cum)
    st = mm("bcjhs,bcjhd->bchsd", Bc[:, :, :, None, :] * dte[..., None], xdt)
    return y, st


def _bwd(xdt, cum, Bc, Cc, dy, dst, mm):
    """ssd_chunk_bwd_ref with every product through `mm`, in the kernels'
    grouping (dB's state term as one product over heads and hd)."""
    L = _ssd_decay(cum)
    SL = mm("bcis,bcjs->bcij", Cc, Bc)[..., None] * L
    dM = mm("bcihd,bcjhd->bcijh", dy, xdt)
    dsc = (dM * L).sum(-1)
    dLL = dM * SL
    dte = torch.exp(cum[:, :, -1:, :] - cum)
    t = dte[..., None] * mm("bcjs,bchsd->bcjhd", Bc, dst)
    dX = mm("bcijh,bcihd->bcjhd", SL, dy) + t
    ddte = (xdt * t).sum(-1)
    dcum = dLL.sum(3) - dLL.sum(2) - ddte
    dcum = torch.cat([dcum[:, :, :-1], dcum[:, :, -1:] + ddte.sum(2, keepdim=True)], dim=2)
    dB = (mm("bcjhd,bchsd->bcjs", xdt * dte[..., None], dst)
          + mm("bcij,bcis->bcjs", dsc, Cc))
    dC = mm("bcij,bcjs->bcis", dsc, Bc)
    return dX, dcum, dB, dC


@pytest.mark.parametrize("decay", [(0.01, 0.2), (6.0, 8.0)])
def test_tf32_split_rehearsal_meets_the_float32_bars(decay, capsys):
    """At Q = 256 with 4 heads of 64 and ds 128 (the model's widths, few
    heads) and inputs at the model's scale (std 0.5), the three-term split
    keeps every output within the registry's bars against float64 (forward
    2e-5, backward 2e-4, elementwise; the backward also in relative norm),
    as the float32 plain version does; one TF32 product a product misses
    the forward bar by orders of magnitude. The errors are printed (a CPU
    rehearsal, not a chip result)."""
    rng = np.random.default_rng(18)
    B, nc, Q, nh, hd, ds = 1, 1, 256, 4, 64, 128

    def rnd(*shape):
        return torch.tensor(rng.standard_normal(shape) * 0.5, dtype=torch.float32)

    xdt, Bc, Cc, dy, dst = (rnd(B, nc, Q, nh, hd), rnd(B, nc, Q, ds), rnd(B, nc, Q, ds),
                            rnd(B, nc, Q, nh, hd), rnd(B, nc, nh, ds, hd))
    cum = torch.tensor(-np.cumsum(rng.uniform(*decay, size=(B, nc, Q, nh)), axis=2),
                       dtype=torch.float32)
    f64 = [t.double() for t in (xdt, cum, Bc, Cc, dy, dst)]
    want = ssd_chunk_ref(*f64[:4]) + ssd_chunk_bwd_ref(*f64)
    bars = [ops.get_kernel("ssd_chunk").tolerance(torch.float32)] * 2 + [
        ops.get_kernel("ssd_chunk_bwd").tolerance(torch.float32)] * 4
    split = _split_mm(3)
    got = _fwd(xdt, cum, Bc, Cc, split) + _bwd(xdt, cum, Bc, Cc, dy, dst, split)
    errs = []
    for i, (g, w, bar) in enumerate(zip(got, want, bars)):
        err = (g.double() - w).abs()
        assert torch.isfinite(g).all()
        assert bool((err <= bar.atol + bar.rtol * w.abs()).all()), (i, err.max().item())
        if i >= 2:
            assert ops.rel_err(g, w) <= bar.rtol, i
        errs.append(err.max().item())
    one = _fwd(xdt, cum, Bc, Cc, _split_mm(1))[0]
    one_err = (one.double() - want[0]).abs().max().item()
    assert one_err > 10 * bars[0].atol
    with capsys.disabled():
        print(f"\n3xTF32 rehearsal, decay {decay}: max abs err (y, states, dxdt, dcum, dB, dC) "
              f"{['%.2e' % e for e in errs]}; one TF32 product: y {one_err:.2e}")


def test_profiled_kernel_names_exist_in_the_source():
    """Every ssd ``__global__`` name that chip_smoke.py profiles (kernel
    device times, the train profile's launch counts) is a kernel of
    csrc/ssd_scan.cu, and the source has no other."""
    smoke = (ROOT / "chip_smoke.py").read_text()
    src = (ROOT / "src/repro_torch/kernels/csrc/ssd_scan.cu").read_text()
    profiled = set(re.findall(r'"(ssd_\w+_kernel)"', smoke))
    defined = set(re.findall(r"__global__ void (?:__launch_bounds__\([^)]*\) )?(\w+)\(", src))
    assert profiled == {"ssd_fwd_kernel", "ssd_bwd_rows_kernel", "ssd_bwd_cols_kernel",
                        "ssd_bwd_finish_kernel"}
    assert profiled == defined
    # no atomic operation (the backward repeats bit for bit)
    assert not re.search(r"\batomic[A-Z]\w*\(|\batom\.|\bred\.", src)
