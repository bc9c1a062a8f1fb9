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
