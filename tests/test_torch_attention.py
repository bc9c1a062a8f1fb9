"""The port's attention kernels: plain versions against the JAX package,
registry policy, wrapper checks, and (on a card) the CUDA kernels against
their plain versions.

Inputs come from numpy seeds and go to both packages. The JAX side runs its
pure-jnp oracles (``repro.kernels.ref``) and its Pallas kernels in
interpret mode. Bars are the registry's (``repro.kernels.ops``): 2e-5 in
float32, 2e-2 in bfloat16 (both packages compute in float32 from the
inputs; bf16 rounds the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import decode_attention as JDA
from repro.kernels import flash_attention as JFA
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro_torch.kernels import decode_attention as DA
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref, decode_attention_ref

F32 = ops.get_kernel("flash_attention").tolerance(torch.float32)
BF16 = ops.get_kernel("flash_attention").tolerance(torch.bfloat16)

# (B, Hq, Hkv, S, Sk, D, causal, window, softcap)
FLASH_CASES = {
    "causal_gqa_ragged": (2, 4, 2, 40, 40, 16, True, None, None),
    "noncausal_mqa": (1, 4, 1, 24, 37, 32, False, None, None),
    "window": (1, 4, 2, 48, 48, 16, True, 7, None),
    "softcap": (1, 2, 2, 33, 33, 16, True, None, 20.0),
    "window_softcap_noncausal": (1, 4, 2, 30, 30, 16, False, 5, 10.0),
}


def _flash_inputs(case, dtype=np.float32, seed=0):
    B, Hq, Hkv, S, Sk, D = case[:6]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, S, D)).astype(dtype)
    k = rng.standard_normal((B, Hkv, Sk, D)).astype(dtype)
    v = rng.standard_normal((B, Hkv, Sk, D)).astype(dtype)
    return q, k, v


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64),
        rtol=tol.rtol, atol=tol.atol,
    )


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_plain_matches_jax(name):
    case = FLASH_CASES[name]
    causal, window, cap = case[6:]
    q, k, v = _flash_inputs(case, seed=len(name))
    o, lse = attention_ref(*map(torch.as_tensor, (q, k, v)), causal, window, cap,
                           return_lse=True)
    want = JREF.attention_ref(q, k, v, causal=causal, window=window, softcap=cap)
    _close(o, want, F32)
    # the Pallas kernel with small blocks: several q and k blocks, ragged
    # tails zero-padded by its wrapper
    po, plse = JFA.flash_attention_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window, softcap=cap, block_q=16, block_k=16, interpret=True,
        return_lse=True,
    )
    _close(o, po, F32)
    _close(lse, plse, F32)


def test_flash_plain_bf16_matches_jax():
    case = FLASH_CASES["causal_gqa_ragged"]
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16) for a in _flash_inputs(case))
    o = attention_ref(q, k, v, True, None, None)
    assert o.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(t.float().numpy()).astype(jnp.bfloat16) for t in (q, k, v))
    want = JREF.attention_ref(jq, jk, jv, causal=True)
    _close(o.float(), np.asarray(want.astype(jnp.float32)), BF16)


# (B, Hq, Hkv, D, n_blocks, block_size, n_pages, lengths, window, softcap)
DECODE_CASES = {
    # lengths 0 (padding lane), 1, a partial last page, a full table
    "gqa_lengths": (4, 4, 2, 16, 24, 4, 5, [0, 1, 7, 20], None, None),
    "mqa": (3, 4, 1, 32, 16, 8, 3, [5, 24, 9], None, None),
    "window": (3, 4, 2, 16, 24, 4, 5, [3, 20, 13], 6, None),
    "softcap": (2, 2, 2, 16, 12, 4, 4, [16, 9], None, 15.0),
    "window_softcap": (2, 4, 2, 16, 24, 4, 5, [19, 0], 4, 25.0),
}


def _decode_inputs(case, dtype=np.float32, seed=0):
    B, Hq, Hkv, D, nb, bs, n_pages, lengths = case[:8]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Hq, D)).astype(dtype)
    kp = rng.standard_normal((nb, bs, Hkv, D)).astype(dtype)
    vp = rng.standard_normal((nb, bs, Hkv, D)).astype(dtype)
    # distinct pages per sequence; the null page 0 past each length
    table = np.zeros((B, n_pages), np.int32)
    pages = rng.permutation(np.arange(1, nb))
    used = 0
    for b, n in enumerate(lengths):
        need = -(-n // bs)
        table[b, :need] = pages[used:used + need]
        used += need
    return q, kp, vp, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_decode_plain_matches_jax(name):
    case = DECODE_CASES[name]
    window, cap = case[8:]
    args = _decode_inputs(case, seed=len(name))
    got = decode_attention_ref(*map(torch.as_tensor, args), window, cap)
    want = JREF.decode_attention_ref(*args, window=window, softcap=cap)
    _close(got, want, F32)
    pallas = JDA.decode_attention(*map(jnp.asarray, args), window=window, softcap=cap,
                                  interpret=True)
    _close(got, pallas, F32)
    lengths = args[4]
    assert np.all(got.numpy()[lengths == 0] == 0.0)  # padding lanes read zeros


def test_decode_plain_bf16_matches_jax():
    args = _decode_inputs(DECODE_CASES["gqa_lengths"])
    t = [torch.as_tensor(a) for a in args]
    for i in range(3):
        t[i] = t[i].to(torch.bfloat16)
    got = decode_attention_ref(*t)
    assert got.dtype == torch.bfloat16
    j = [jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in t[:3]]
    want = JREF.decode_attention_ref(*j, jnp.asarray(args[3]), jnp.asarray(args[4]))
    _close(got.float(), np.asarray(want.astype(jnp.float32)), BF16)


def test_decode_reads_nothing_past_the_length():
    """Pool pages past a sequence's length (and unused table entries) do not
    change the result: poison them and compare."""
    case = DECODE_CASES["gqa_lengths"]
    q, kp, vp, table, lengths = _decode_inputs(case)
    base = decode_attention_ref(*map(torch.as_tensor, (q, kp, vp, table, lengths)))
    bs = kp.shape[1]
    kp2, vp2 = kp.copy(), vp.copy()
    for b, n in enumerate(lengths):
        if n % bs:
            page = table[b, n // bs]
            kp2[page, n % bs:] = 1e4
            vp2[page, n % bs:] = 1e4
    kp2[0] = vp2[0] = 1e4  # the null page
    got = decode_attention_ref(*map(torch.as_tensor, (q, kp2, vp2, table, lengths)))
    _close(got, base, F32)


@pytest.mark.parametrize("name", ["flash_attention", "decode_attention"])
def test_registry_tolerances_equal_jax(name):
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        mine = ops.get_kernel(name).tolerance(dt)
        theirs = JOPS.get_kernel(name).tolerance(jdt)
        assert (mine.rtol, mine.atol) == (theirs.rtol, theirs.atol)


def test_attention_registry_modes_on_cpu():
    q, k, v = map(torch.as_tensor, _flash_inputs(FLASH_CASES["softcap"]))
    auto = ops.dispatch("flash_attention", q, k, v, mode="auto", softcap=20.0)
    off = ops.dispatch("flash_attention", q, k, v, mode="off", softcap=20.0)
    assert torch.equal(auto, off)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.dispatch("flash_attention", q, k, v, mode="on")
    args = [torch.as_tensor(a) for a in _decode_inputs(DECODE_CASES["mqa"])]
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.dispatch("decode_attention", *args, mode="on")
    assert ops.parity_check("decode_attention", *args, mode="auto") == 0.0


def test_flash_needs_no_gradient_yet():
    q, k, v = map(torch.as_tensor, _flash_inputs(FLASH_CASES["window"]))
    q.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="Queue 2 row 5"):
        FA.flash_attention(q, k, v)
    with torch.no_grad():
        FA.flash_attention(q, k, v)


def test_wrapper_input_checks():
    q, k, v = map(torch.as_tensor, _flash_inputs(FLASH_CASES["causal_gqa_ragged"]))
    FA._check_inputs(q, k, v)
    with pytest.raises(ValueError, match="head dim"):
        FA._check_inputs(q[..., :12].contiguous(), k[..., :12].contiguous(),
                         v[..., :12].contiguous())
    with pytest.raises(ValueError, match="do not fit"):
        FA._check_inputs(q[:, :3].contiguous(), k, v)
    with pytest.raises(TypeError):
        FA._check_inputs(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="window"):
        FA.flash_attention(q, k, v, window=0)
    args = [torch.as_tensor(a) for a in _decode_inputs(DECODE_CASES["gqa_lengths"])]
    DA._check_inputs(*args)
    with pytest.raises(TypeError, match="int32"):
        DA._check_inputs(*args[:3], args[3].long(), args[4])
    with pytest.raises(ValueError, match="contiguous"):
        DA._check_inputs(args[0].transpose(0, 1), *args[1:])
    with pytest.raises(ValueError, match="device"):
        DA.decode_attention(*[a.to("meta") for a in args])


def test_held_to_plain_checks_each_kernel_call():
    args = [torch.as_tensor(a) for a in _decode_inputs(DECODE_CASES["window"])]
    with ops.held_to_plain("decode_attention") as errs:
        ops.dispatch("decode_attention", *args, mode="auto", window=6)
        ops.dispatch("decode_attention", *args, mode="off", window=6)  # the plain version
        ops.dispatch("flash_attention", *map(torch.as_tensor,
                                             _flash_inputs(FLASH_CASES["softcap"])))
        with pytest.raises(RuntimeError, match="already held"):
            with ops.held_to_plain("decode_attention"):
                pass
    assert errs == [0.0]  # one wrapper call of the held kernel
    with ops.held_to_plain("decode_attention") as again:
        pass
    assert again == []


def test_every_cuda_source_is_bound():
    from repro_torch.kernels import _build

    assert {p.stem for p in _build.CSRC.glob("*.cu")} == set(_build.SIGNATURES)
    for name, fns in _build.SIGNATURES.items():
        assert all(f.endswith(("_bf16", "_f32", "_f64")) for f in fns), name
