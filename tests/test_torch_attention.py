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


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test here runs torch's CPU kernels on one thread: with JAX
    computing in the same process, torch's multi-threaded CPU kernels now
    and then return one worker thread's share of a tensor slightly wrong
    (tests/test_torch_ssm.py's fixture says more), which the float32 bars
    here would report as a port fault."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _FakeLibrary:
    """Stands in for a CUDA library: records the entry point a wrapper call
    reaches and its arguments, and returns success."""

    def __init__(self, name, calls):
        self.name, self.calls = name, calls

    def __getattr__(self, fn):
        def call(*args):
            self.calls.append((self.name, fn, args))
            return 0
        return call


@pytest.fixture
def fake_card(monkeypatch):
    """The wrappers' launch path without a card: CPU tensors take the kernel
    route, and the libraries record their calls (a list of (library, entry
    point, arguments)). The launch counts are restored afterwards: other
    tests hold that no kernel launches on the CPU."""
    from repro_torch.kernels import _build

    calls = []
    for fn in (FA.flash_attention, FA.flash_attention_bwd):  # the fake launches count
        monkeypatch.setattr(fn, "launches", fn.launches)
    monkeypatch.setattr(_build, "plain_or_raise", lambda t: False)
    monkeypatch.setattr(_build, "load_library", lambda name: _FakeLibrary(name, calls))
    monkeypatch.setattr(_build, "stream", lambda t: 0)
    return calls


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
    """A call that needs no gradient (grad mode off, or no input that
    requires one) runs the forward alone: no autograd node."""
    q, k, v = map(torch.as_tensor, _flash_inputs(FLASH_CASES["window"]))
    q.requires_grad_(True)
    with torch.no_grad():
        assert FA.flash_attention(q, k, v).grad_fn is None
    assert FA.flash_attention(q.detach(), k, v).grad_fn is None


def test_flash_gradient_runs_the_function():
    """A call that needs a gradient runs the FlashAttention Function (its
    backward: tests/test_torch_flash_bwd.py); lse carries no gradient."""
    q, k, v = map(torch.as_tensor, _flash_inputs(FLASH_CASES["window"]))
    q.requires_grad_(True)
    o, lse = FA.flash_attention(q, k, v, return_lse=True)
    assert "FlashAttention" in type(o.grad_fn).__name__
    assert not lse.requires_grad


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


H100_SMEM_PER_BLOCK = 232_448  # bytes a block may use (227 KB)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_tile_plan_fits_an_h100(d, dtype):
    """Every kernel a call launches fits a block's shared memory, and its
    grid covers the shape: the q tiles cover S, the kv tiles Sk."""
    B, Hq, Hkv, S, Sk = 2, 32, 8, 1000, 1037
    plan = FA.tile_plan(dtype, d, B, Hq, Hkv, S, Sk)
    assert len(plan) == 3
    for name, p in plan.items():
        assert 0 < p["smem"] <= H100_SMEM_PER_BLOCK, name
        assert p["threads"] % 128 == 0 and p["threads"] <= 1024, name
        assert p["block_q"] % 16 == 0 and p["block_k"] % 16 == 0, name
        assert B in p["grid"] and np.prod(p["grid"]) < 2 ** 31, name
    by_kind = {("fwd" if "fwd" in n else "dkv" if "dkv" in n else "dq"): p
               for n, p in plan.items()}
    for kind in ("fwd", "dq"):
        p = by_kind[kind]
        assert sorted(p["grid"]) == sorted((Hq, -(-S // p["block_q"]), B)), kind
    p = by_kind["dkv"]
    assert sorted(p["grid"]) == sorted((Hkv, -(-Sk // p["block_k"]), B))


def test_tile_plan_bf16_kernels():
    """The bf16 plan is the sm90 kernels': the forward a 128-row q tile on
    three warpgroups (a TMA producer and two wgmma consumers) with its
    swizzle atoms 1 KB-aligned; at gemma2-2b's attention (D=256, 8 heads,
    S=2048) its grid is one wave on the H100's 132 SMs."""
    plan = FA.tile_plan(torch.bfloat16, 128)
    assert set(plan) == {"flash_fwd_wgmma_kernel", "flash_bwd_dq_wgmma_kernel",
                         "flash_bwd_dkv_wgmma_kernel"}
    fwd = plan["flash_fwd_wgmma_kernel"]
    assert (fwd["block_q"], fwd["block_k"], fwd["threads"]) == (128, 128, 384)
    # 1 KB alignment slack + Q (128 x 128) + 2 stages of K and V (128 x 128) + barriers
    assert fwd["smem"] == 1024 + 2 * 128 * 128 + 4 * 2 * 128 * 128 + 64
    assert set(FA.tile_plan(torch.float32, 128)) == {
        "flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel"}
    gemma = FA.tile_plan(torch.bfloat16, 256, B=1, Hq=8, Hkv=4, S=2048, Sk=2048)
    grid = gemma["flash_fwd_wgmma_kernel"]["grid"]
    assert np.prod(grid) == 128 <= 132
    with pytest.raises(TypeError):
        FA.tile_plan(torch.float16, 128)


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_forward_routes_by_dtype(fake_card, d):
    """A bf16 call reaches the wgmma kernel's entry point with the tile
    plan's shared memory, a float32 call the CUDA-core kernel's; each with
    every argument its bound signature declares."""
    from repro_torch.kernels import _build

    q, k = torch.zeros(1, 2, 5, d), torch.zeros(1, 1, 7, d)
    n0 = FA.flash_attention.launches
    FA.flash_attention(q.bfloat16(), k.bfloat16(), k.bfloat16(), causal=False)
    FA.flash_attention(q, k, k, window=3, softcap=5.0)
    assert FA.flash_attention.launches == n0 + 2
    (lib_b, fn_b, args_b), (lib_f, fn_f, args_f) = fake_card
    assert (lib_b, fn_b) == ("flash_attention_sm90", "flash_attention_fwd_bf16")
    assert (lib_f, fn_f) == ("flash_attention", "flash_attention_fwd_f32")
    assert args_b[-3] == FA.tile_plan(torch.bfloat16, d)["flash_fwd_wgmma_kernel"]["smem"]
    assert len(args_b) == len(_build.SIGNATURES[lib_b][fn_b])
    assert len(args_f) == len(_build.SIGNATURES[lib_f][fn_f])
    # (B, Hq, Hkv, S, Sk, D, causal, has_window, window, has_softcap, softcap, scale)
    assert args_b[5:17] == (1, 2, 1, 5, 7, d, 0, 0, 0, 0, 0.0, 1.0 / np.sqrt(d))
    assert args_f[5:16] == (1, 2, 1, 5, 7, d, 1, 1, 3, 1, 5.0)
