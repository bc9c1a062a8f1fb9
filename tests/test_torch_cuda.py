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


# (B, Hq, Hkv, S, Sk, D, causal, window, softcap)
FLASH = [(2, 4, 2, 40, 40, 16, True, None, None), (1, 4, 1, 24, 37, 32, False, None, None),
         (1, 4, 2, 48, 48, 64, True, 7, None), (1, 2, 2, 133, 133, 128, True, None, 20.0),
         (1, 4, 2, 30, 30, 256, False, 5, 10.0)]
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
    from repro_torch.kernels.ref import attention_ref

    g = torch.Generator(device=card).manual_seed(1)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=card).to(dtype)

    for b, hq, hkv, s, sk, d, causal, window, cap in FLASH:
        q, k, v, do = rnd(b, hq, s, d), rnd(b, hkv, sk, d), rnd(b, hkv, sk, d), rnd(b, hq, s, d)
        o, lse = flash_attention(q, k, v, causal, window, cap, return_lse=True)
        before = flash_attention_bwd.launches
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


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "ties", "constant"])
def test_cuda_block_topk_matches_plain_bit_for_bit(card, kind):
    """block_topk against its plain version at the gossip path's block sizes
    (4096 with k 40, 2304 with 23, 64 and 16 with 1, k = block), bit for bit
    in values and indices (both take the lower index first among ties), one
    launch a call; a block past the kernel's limit is refused."""
    from repro_torch.kernels import topk_compress
    from repro_torch.kernels.ref import block_topk_ref

    g = torch.Generator(device=card).manual_seed(2)
    for nb, block, k in [(300, 4096, 40), (7, 2304, 23), (5, 64, 1), (3, 16, 16),
                         (2, 4096, 4096), (2, 8192, 3)]:
        x = torch.randn(nb, block, generator=g, device=card)
        if kind == "ties":
            x = torch.round(x * 2) / 2
        elif kind == "constant":
            x = torch.full_like(x, 1.0)
        before = topk_compress.block_topk.launches
        got = ops.topk_blocks(x, k, mode="on")
        assert topk_compress.block_topk.launches == before + 1
        want = block_topk_ref(x, k)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        ops.parity_check("block_topk", x, k, mode="on")
    with pytest.raises(ValueError, match="8192"):
        topk_compress.block_topk(torch.zeros(1, 8193, device=card), 1)
    with pytest.raises(TypeError, match="float32"):
        topk_compress.block_topk(torch.zeros(1, 64, device=card, dtype=torch.float64), 1)
    torch.cuda.synchronize()
