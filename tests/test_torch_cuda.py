"""Card-only tests: every CUDA kernel against its plain version, with the
registry bars. They import no JAX, so they run on a machine with a card
and without the JAX package:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX.) Without a card they
skip.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, sparse_saga
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _sparse_inputs(n, d, k, dtype, seed, dups=False):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((n, d)).astype(dtype)
    idx = np.stack([rng.choice(d, k, replace=False) for _ in range(n)]).astype(np.int32)
    val = rng.standard_normal((n, k)).astype(dtype)
    if dups:
        idx[:, 1] = idx[:, 0]
        idx[:, k // 2] = idx[:, 0]
    idx[:, -2:] = 0  # padding
    val[:, -2:] = 0.0
    coef = rng.standard_normal(n).astype(dtype)
    rho = rng.uniform(0.5, 1.5, n).astype(dtype)
    return psi, idx, val, coef, rho


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_kernels_match_plain(card, dtype):
    """On a card: kernel vs plain version, ragged D, padding, duplicates."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    for n, d, k in [(10, 47236, 74), (3, 1003, 9), (4, 2000, 1500)]:
        args = [torch.as_tensor(a, device=card)
                for a in _sparse_inputs(n, d, k, np_dtype, seed=6, dups=True)]
        n0 = sparse_saga.sparse_axpy.launches
        ops.parity_check("sparse_axpy", *args, mode="on")
        assert sparse_saga.sparse_axpy.launches == n0 + 2  # scale + scatter
        clean = [torch.as_tensor(a, device=card)
                 for a in _sparse_inputs(n, d, k, np_dtype, seed=6)]
        ops.parity_check("sparse_dot", *clean[:3], mode="on")
        torch.cuda.synchronize()


# (B, Hq, Hkv, S, Sk, D, causal, window, softcap): every head dim, GQA and
# MQA, S < Sk, lengths at the bf16 kernels' tile edges (1, 63, 64, 65, 127,
# 128, 129) and 4608, where gemma2-2b's 4096 window bites
FLASH = [(2, 4, 2, 40, 40, 16, True, None, None), (1, 4, 1, 24, 37, 32, False, None, None),
         (1, 4, 2, 48, 48, 64, True, 7, None), (1, 2, 2, 133, 133, 128, True, None, 20.0),
         (1, 4, 2, 30, 30, 256, False, 5, 10.0),
         (2, 4, 2, 1, 1, 16, True, None, None), (1, 4, 1, 1, 129, 64, False, None, None),
         (1, 4, 1, 63, 64, 32, True, None, None), (1, 2, 2, 64, 65, 128, False, 9, 20.0),
         (1, 4, 2, 65, 127, 256, True, None, 50.0), (1, 2, 1, 127, 128, 128, True, 40, None),
         (1, 4, 4, 128, 128, 64, True, None, None), (2, 4, 1, 129, 129, 256, False, None, None),
         (1, 8, 4, 4608, 4608, 256, True, 4096, 50.0)]
# (lengths, Hq, Hkv, D, n_blocks, block_size, n_pages, window, softcap)
DECODE = [([0, 1, 7, 20], 4, 2, 16, 24, 4, 5, None, None),
          ([5, 24, 9], 4, 1, 32, 16, 8, 3, None, None),
          ([3, 20, 13], 4, 2, 128, 24, 4, 5, 6, None),
          ([16, 9], 8, 2, 64, 12, 4, 4, None, 15.0),
          ([19, 0], 4, 2, 256, 24, 4, 5, 4, 25.0)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_kernels_match_plain(card, dtype):
    """Both attention kernels against their plain versions: every head dim
    the kernels take, GQA and MQA, ragged lengths, window and softcap."""
    g = torch.Generator(device=card).manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=card).to(dtype)

    for b, hq, hkv, s, sk, d, causal, window, cap in FLASH:
        before = flash_attention.launches
        ops.parity_check("flash_attention", rnd(b, hq, s, d), rnd(b, hkv, sk, d),
                         rnd(b, hkv, sk, d), causal=causal, window=window, softcap=cap,
                         return_lse=True)
        assert flash_attention.launches == before + 1
    rng = np.random.default_rng(0)
    for lengths, hq, hkv, d, nb, bs, n_pages, window, cap in DECODE:
        table = np.zeros((len(lengths), n_pages), np.int32)
        pages = rng.permutation(np.arange(1, nb))
        used = 0
        for i, n in enumerate(lengths):
            need = -(-n // bs)
            table[i, :need] = pages[used:used + need]
            used += need
        before = decode_attention.launches
        ops.parity_check("decode_attention", rnd(len(lengths), hq, d), rnd(nb, bs, hkv, d),
                         rnd(nb, bs, hkv, d), torch.as_tensor(table, device=card),
                         torch.as_tensor(lengths, dtype=torch.int32, device=card),
                         window=window, softcap=cap)
        assert decode_attention.launches == before + 1
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_bwd_matches_plain(card, dtype):
    """The backward kernels against their plain version (every head dim, GQA
    and MQA, ragged lengths, window and softcap), two launches a call, and
    the autograd Function's gradients against the dense version's."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd
    from repro_torch.kernels.ref import attention_ref, flash_attention_bwd_ref

    g = torch.Generator(device=card).manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=card).to(dtype)

    for b, hq, hkv, s, sk, d, causal, window, cap in FLASH:
        q, k, v, do = rnd(b, hq, s, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, d), rnd(b, hq, s, d)
        o, lse = flash_attention(q, k, v, causal, window, cap, return_lse=True)
        before = flash_attention_bwd.launches
        if sk == 1:
            # one key: every probability is 1, so dq and dk are exactly 0 and a
            # relative-norm bar would measure rounding noise; held elementwise
            tol = ops.get_kernel("flash_attention_bwd").tolerance(dtype)
            got = flash_attention_bwd(q, k, v, o, lse, do, causal, window, cap)
            want = flash_attention_bwd_ref(q, k, v, o, lse, do, causal, window, cap)
            for x, y in zip(got, want):
                ops.assert_close(x, y, tol)
        else:
            ops.parity_check("flash_attention_bwd", q, k, v, o, lse, do, causal=causal,
                             window=window, softcap=cap)
        assert flash_attention_bwd.launches == before + 2  # dq, then dk/dv
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        got = torch.autograd.grad(flash_attention(*leaves, causal, window, cap), leaves, do)
        dense = [t.clone().requires_grad_() for t in (q, k, v)]
        want = torch.autograd.grad(attention_ref(*dense, causal, window, cap), dense, do)
        tol = ops.get_kernel("flash_attention").grad_tolerance(dtype)
        for x, y in zip(got, want):
            ops.assert_close(x, y, tol)
    torch.cuda.synchronize()


# NaNs of several payloads and both signs, +-inf, +-0 (uint32 bits)
TOPK_SPECIALS = np.array([0x7FC00000, 0x7FC00005, 0xFFC00003, 0x7F800001, 0xFF812345,
                          0x7F800000, 0xFF800000, 0x80000000, 0x00000000], np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ties", "constant", "nan"])
def test_cuda_block_topk_matches_plain_bit_for_bit(card, kind):
    """block_topk against its plain version at the gossip path's block sizes
    (4096 with k 40, 2304 with 23, 64 and 16 with 1, k = block), above
    8192 (8193 staged; 65,536 and 1,000,003 streamed, k up to 10,000) and
    k = block at 8192, bit for bit in values (as bits: NaN payloads too)
    and indices (both take the lower index first among ties, every NaN
    equal), one launch a call; k above K_MAX and float64 are refused."""
    from repro_torch.kernels import topk_compress
    from repro_torch.kernels.ref import block_topk_ref

    g = torch.Generator(device=card).manual_seed(2)
    specials = torch.as_tensor(TOPK_SPECIALS.view(np.int32), device=card)
    for nb, block, k in [(300, 4096, 40), (7, 2304, 23), (5, 64, 1), (3, 16, 16),
                         (2, 4096, 4096), (2, 8192, 3), (2, 8193, 81), (2, 8192, 8192),
                         (3, 65_536, 655), (2, 1_000_003, 10_000)]:
        x = torch.randn(nb, block, generator=g, device=card)
        if kind == "ties":
            x = torch.round(x * 2) / 2
        elif kind == "constant":
            x = torch.full_like(x, 1.0)
        elif kind == "nan":
            m = max(1, block // 100)
            pos = torch.randint(0, block, (nb, m), generator=g, device=card)
            pick = torch.randint(0, len(TOPK_SPECIALS), (nb, m), generator=g, device=card)
            x.view(torch.int32).scatter_(1, pos, specials[pick])
        before = topk_compress.block_topk.launches
        got = ops.topk_blocks(x, k, mode="on")
        assert topk_compress.block_topk.launches == before + 1
        want = block_topk_ref(x, k)
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
        assert torch.equal(got[1], want[1])
        if kind != "nan":  # the registry's comparator cannot compare NaNs
            ops.parity_check("block_topk", x, k, mode="on")
    with pytest.raises(ValueError, match="K_MAX"):
        topk_compress.block_topk(torch.zeros(1, topk_compress.K_MAX + 1, device=card),
                                 topk_compress.K_MAX + 1)
    with pytest.raises(TypeError, match="float32"):
        topk_compress.block_topk(torch.zeros(1, 64, device=card, dtype=torch.float64), 1)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_block_topk_plans_agree(card):
    """The C side's layout and K_MAX equal the plan's, and every kernel the
    plan chooses by shape (3, 2 and 1 stages, the stream variant) gives the
    plain version's output bit for bit: on rows that guess the previous
    row's boundary digit right and wrong (rows of two scales in turn), and
    on rows whose boundary bin overflows the candidate lists at the plan's
    capacity (constant rows, rows of one first digit), which refine the row
    itself."""
    from repro_torch.kernels import _build
    from repro_torch.kernels import topk_compress as TK
    from repro_torch.kernels.ref import block_topk_ref

    lib = _build.load_library("topk_compress")
    assert lib.block_topk_k_max_f32() == TK.K_MAX
    for block, k, nb in [(4096, 40, 288_000), (2304, 23, 2), (8193, 81, 3), (8192, 8192, 2),
                         (65_536, 655, 3), (1_000_003, 10_000, 2), (37, 5, 1), (640, 40, 2),
                         (256, 40, 2)]:
        plan = TK.topk_plan(block, k, nb)
        assert lib.block_topk_smem_f32(block, k, plan["stages"], plan["cap"]) == plan["smem"], \
            (block, k)
    g = torch.Generator(device=card).manual_seed(3)
    for nb, block, k, stages in [(2000, 4096, 40, 1), (600, 640, 40, 2), (600, 256, 40, 3),
                                 (12, 65_536, 655, 0)]:
        assert TK.topk_plan(block, k, nb)["stages"] == stages
        x = torch.randn(nb, block, generator=g, device=card)
        x[1::2] *= 100.0  # every other row's boundary digit differs
        x[2::6] = 1.0  # the whole row in one bin
        x[4::6] = 1.0 + 0.5 * torch.rand(x[4::6].shape, generator=g, device=card)
        got, want = TK.block_topk(x, k), block_topk_ref(x, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), (block, k)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_raw_stream_is_the_current_stream(card):
    """``_build.stream`` reads torch's private ``_cuda_getCurrentRawStream``
    (every wrapper's launch path): it exists in this torch and gives the
    current stream's handle, on a side stream too."""
    from repro_torch.kernels import _build

    assert hasattr(torch._C, "_cuda_getCurrentRawStream")
    x = torch.zeros(1, device=card)
    assert _build.stream(x) == torch.cuda.current_stream(card).cuda_stream
    side = torch.cuda.Stream(card)
    with torch.cuda.stream(side):
        assert _build.stream(x) == side.cuda_stream != 0


# (B, nc, Q, nh, hd, ds, log-decay range): the main paths' shapes (train,
# score, serve prefill: mamba2's widths), ragged Q, nh, hd and ds, the
# reduced models' widths, and fast decay (exp overflows above the diagonal)
SSD = [(4, 8, 256, 64, 64, 128, (0.01, 0.2)), (1, 8, 256, 64, 64, 128, (0.01, 0.2)),
       (1, 1, 256, 64, 64, 128, (0.01, 0.2)), (2, 1, 37, 6, 16, 16, (0.01, 0.5)),
       (1, 3, 5, 3, 4, 5, (0.01, 0.5)), (1, 1, 1, 3, 64, 128, (0.01, 0.5)),
       (1, 2, 100, 5, 50, 70, (0.01, 0.5)), (1, 2, 64, 8, 32, 64, (6.0, 8.0)),
       (1, 2, 256, 64, 64, 128, (6.0, 8.0))]


@pytest.mark.cuda
def test_cuda_ssd_chunk_matches_plain(card):
    """ssd_chunk forward (one launch) and backward (three launches: rows,
    cols, finish) against their plain versions in float64 on the same
    float32 inputs, at the registry bars (2e-5; 2e-4 elementwise and in
    relative norm), at the three main shapes, ragged shapes and fast decay
    (every output finite); two backward calls are the same bit for bit; the
    SsdChunk Function's gradients are the backward kernel's; another dtype
    raises."""
    from repro_torch.kernels import ssd_scan

    g = torch.Generator(device=card).manual_seed(3)
    for b, nc, q, nh, hd, ds, (lo, hi) in SSD:
        def rnd(*shape):
            return torch.randn(*shape, generator=g, device=card) * 0.5

        cum = -torch.cumsum(torch.rand(b, nc, q, nh, generator=g, device=card) * (hi - lo) + lo,
                            dim=2)
        args = (rnd(b, nc, q, nh, hd), cum.contiguous(), rnd(b, nc, q, ds), rnd(b, nc, q, ds))
        dy, dst = rnd(b, nc, q, nh, hd), rnd(b, nc, nh, ds, hd)
        before = ssd_scan.ssd_chunk_fwd.launches, ssd_scan.ssd_chunk_bwd.launches
        ops.parity_check("ssd_chunk", *args, mode="on")
        ops.parity_check("ssd_chunk_bwd", *args, dy, dst, mode="on")
        assert (ssd_scan.ssd_chunk_fwd.launches, ssd_scan.ssd_chunk_bwd.launches) == (
            before[0] + 1, before[1] + 3)
        leaves = [t.clone().requires_grad_() for t in args]
        got = torch.autograd.grad(ops.ssd_chunk(*leaves, mode="on"), leaves, (dy, dst))
        want = ssd_scan.ssd_chunk_bwd(*args, dy, dst)
        again = ssd_scan.ssd_chunk_bwd(*args, dy, dst)
        assert ssd_scan.ssd_chunk_bwd.launches == before[1] + 12
        for x, y, z in zip(got, want, again):
            assert torch.isfinite(x).all()
            assert torch.equal(x, y) and torch.equal(y, z)  # deterministic: no atomics
        assert all(torch.isfinite(t).all() for t in ssd_scan.ssd_chunk_fwd(*args))
    with pytest.raises(ValueError, match="float32 only"):
        ssd_scan.ssd_chunk_fwd(*(t.double() for t in args))
    with pytest.raises(ValueError, match="float32 only"):
        ssd_scan.ssd_chunk_fwd(*(t.to(torch.bfloat16) for t in args))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 32, 8, 2048, 128, True, None, None),
                                   (1, 8, 4, 2048, 256, True, 4096, 50.0),
                                   (1, 4, 1, 129, 64, False, 40, None)])
def test_cuda_flash_bwd_is_bit_for_bit_repeatable(card, shape):
    """Two bf16 backward calls on the same inputs return the same dq, dk, dv
    bit for bit: no atomics, every sum in a fixed order (the launcher's and
    the gossip example's resumes rely on it)."""
    from repro_torch.kernels.flash_attention import flash_attention_bwd

    b, hq, hkv, s, d, causal, window, cap = shape
    g = torch.Generator(device=card).manual_seed(2)

    def rnd(*size):
        return torch.randn(*size, generator=g, device=card).to(torch.bfloat16)

    q, k, v, do = rnd(b, hq, s, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d), rnd(b, hq, s, d)
    o, lse = flash_attention(q, k, v, causal, window, cap, return_lse=True)
    first = flash_attention_bwd(q, k, v, o, lse, do, causal, window, cap)
    second = flash_attention_bwd(q, k, v, o, lse, do, causal, window, cap)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cuda_flash_kernel_by_dtype(card, dtype):
    """By the profiler's kernel names: a bf16 call (D=128) runs the wgmma
    forward and backward, a float32 call the CUDA-core kernels, and neither
    reaches the other's."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention import flash_attention_bwd, tile_plan

    g = torch.Generator(device=card).manual_seed(3)

    def rnd(*size):
        return torch.randn(*size, generator=g, device=card).to(dtype)

    q, k, v = rnd(1, 4, 200, 128), rnd(1, 2, 200, 128), rnd(1, 2, 200, 128)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        o, lse = flash_attention(q, k, v, return_lse=True)
        flash_attention_bwd(q, k, v, o, lse, q)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages()}
    new = tuple(tile_plan(torch.bfloat16, 128))  # the wgmma forward and backward
    old = tuple(tile_plan(torch.float32, 128))  # the CUDA-core kernels
    want, never = (new, old) if dtype == torch.bfloat16 else (old, new)
    for name in want:
        assert any(name in n for n in names), (name, names)
    for name in never:
        assert not any(name in n for n in names), (name, names)
