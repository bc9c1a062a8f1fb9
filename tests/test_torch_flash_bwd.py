"""The port's flash-attention backward: the plain version against the JAX
package's blocked Pallas gradient (interpret mode) and against ``jax.vjp``
of its dense oracle, the autograd Function on the CPU, and the rule that
nothing S x S is saved for the backward.

Inputs come from numpy seeds (the cases of ``test_torch_attention``) and go
to both packages. Bars are the registry's gradient bars
(``repro.kernels.ops``): 2e-4 in float32, 5e-2 in bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as JFA
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops
from repro_torch.kernels.ref import attention_ref, flash_attention_bwd_ref
from test_torch_attention import FLASH_CASES, _flash_inputs, fake_card  # noqa: F401

GRAD = {torch.float32: ops.get_kernel("flash_attention").grad_tolerance(torch.float32),
        torch.bfloat16: ops.get_kernel("flash_attention").grad_tolerance(torch.bfloat16)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test here runs torch's CPU kernels on one thread: with JAX
    computing in the same process, torch's multi-threaded CPU kernels now
    and then return one worker thread's share of a tensor slightly wrong
    (tests/test_torch_ssm.py's fixture says more), which the float32
    gradient bars here would report as a port fault."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(name, dtype):
    """(q, k, v, do) as torch tensors of `dtype` and as JAX arrays (same values)."""
    case = FLASH_CASES[name]
    q, k, v = _flash_inputs(case, seed=len(name))
    do = np.random.default_rng(len(name) + 100).standard_normal(q.shape).astype(np.float32)
    t = [torch.as_tensor(a).to(dtype) for a in (q, k, v, do)]
    j = [jnp.asarray(a.float().numpy()).astype(JDT[dtype]) for a in t]
    return t, j


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(torch.as_tensor(got).float().numpy() if isinstance(got, torch.Tensor)
                   else np.asarray(jnp.asarray(got).astype(jnp.float32)), np.float64),
        np.asarray(np.asarray(jnp.asarray(want).astype(jnp.float32)), np.float64),
        rtol=tol.rtol, atol=tol.atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_bwd_plain_matches_jax(name, dtype):
    causal, window, cap = FLASH_CASES[name][6:]
    (q, k, v, do), (jq, jk, jv, jdo) = _inputs(name, dtype)
    o, lse = attention_ref(q, k, v, causal, window, cap, return_lse=True)
    got = flash_attention_bwd_ref(q, k, v, o, lse, do, causal, window, cap)
    assert [g.dtype for g in got] == [dtype] * 3
    # the blocked Pallas gradient with blocks smaller than S: several q and
    # kv blocks, ragged tails zero-padded by its wrapper
    jo, jlse = JFA.flash_attention_fwd(jq, jk, jv, causal=causal, window=window, softcap=cap,
                                       interpret=True, return_lse=True)
    pallas = JFA.flash_attention_bwd(jq, jk, jv, jo, jlse, jdo, causal=causal, window=window,
                                     softcap=cap, block_q=16, block_k=32, interpret=True)
    _, vjp = jax.vjp(lambda a, b, c: JREF.attention_ref(a, b, c, causal=causal, window=window,
                                                          softcap=cap), jq, jk, jv)
    dense = vjp(jdo)
    for g, p, d in zip(got, pallas, dense):
        _close(g, p, GRAD[dtype])
        _close(g, d, GRAD[dtype])


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_flash_function_grads_on_cpu(name):
    """The autograd Function (plain forward + plain backward on the CPU),
    reached through the registry, gives the gradient of the dense version."""
    causal, window, cap = FLASH_CASES[name][6:]
    (q, k, v, do), _ = _inputs(name, torch.float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ops.dispatch("flash_attention", *leaves, causal=causal, window=window, softcap=cap)
    assert o.grad_fn is not None and "FlashAttention" in type(o.grad_fn).__name__
    got = torch.autograd.grad(o, leaves, do)
    dense = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*dense, causal, window, cap), dense, do)
    for g, w in zip(got, want):
        _close(g, w.numpy(), GRAD[torch.float32])
    # mode "off" is the plain forward, differentiated densely (the JAX ref backend)
    off = ops.dispatch("flash_attention", *dense, causal=causal, window=window, softcap=cap,
                       mode="off")
    assert "FlashAttention" not in type(off.grad_fn).__name__


def _saved_shapes(fn):
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        fn()
    return shapes


def test_flash_bwd_saves_nothing_s_by_s():
    """The counterpart of test_blocked_bwd_never_materializes_s_by_s: the
    Function saves (q, k, v, o, lse) only; the dense version's autograd
    (the control) saves an (S, Sk) tensor."""
    B, Hq, Hkv, S, Sk, D = FLASH_CASES["causal_gqa_ragged"][:6]
    (q, k, v, _), _ = _inputs("causal_gqa_ragged", torch.float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def s_by_s(shapes):
        return [s for s in shapes if len(s) >= 2 and s[-1] >= S and s[-2] >= S]

    kernel = _saved_shapes(lambda: FA.flash_attention(*leaves))
    assert kernel and not s_by_s(kernel), kernel
    assert sorted(kernel) == sorted([(B, Hq, S, D), (B, Hkv, Sk, D), (B, Hkv, Sk, D),
                                     (B, Hq, S, D), (B, Hq, S)])
    control = _saved_shapes(lambda: attention_ref(*leaves))
    assert s_by_s(control), control


def test_flash_bwd_held_to_plain_and_registry():
    """Every backward call goes through the registry (held_to_plain sees it)
    and the registry's gradient bars are the JAX package's."""
    (q, k, v, do), _ = _inputs("window", torch.float32)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with ops.held_to_plain("flash_attention_bwd") as errs:
        o = FA.flash_attention(*leaves, window=7)
        torch.autograd.grad(o, leaves, do)
        torch.autograd.grad(FA.flash_attention(*leaves, window=7), leaves, do)
    assert errs == [0.0, 0.0]  # on the CPU the wrapper is the plain version
    assert errs.rel == [0.0, 0.0] and len(errs.scale) == 2 and min(errs.scale) > 0
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        mine = ops.get_kernel("flash_attention").grad_tolerance(dt)
        theirs = JOPS.get_kernel("flash_attention").grad_tolerance(jdt)
        assert (mine.rtol, mine.atol) == (theirs.rtol, theirs.atol)
        assert ops.get_kernel("flash_attention_bwd").tolerance(dt) == mine
    # a kernel without a gradient policy falls back to its forward bars
    sd = ops.get_kernel("sparse_dot")
    assert sd.grad_tolerance(torch.float64) == sd.tolerance(torch.float64)


def test_flash_bwd_compare_holds_small_gradients_by_norm():
    """Gradients of a mean loss are small: a zero or halved (dq, dk, dv)
    passes the bf16 elementwise bar (atol 5e-2) but not the relative norm."""
    spec = ops.get_kernel("flash_attention_bwd")
    tol = spec.tolerance(torch.bfloat16)
    (q, k, v, do), _ = _inputs("causal_gqa_ragged", torch.float32)
    o, lse = FA.flash_attention(q, k, v, return_lse=True)
    want = tuple(1e-3 * g for g in flash_attention_bwd_ref(q, k, v, o, lse, do))
    assert spec.compare((q,), want, want, tol) == 0.0
    for wrong in (tuple(torch.zeros_like(g) for g in want), tuple(g / 2 for g in want)):
        for g, w in zip(wrong, want):  # the elementwise bar alone passes it
            ops.assert_close(g, w, tol)
        with pytest.raises(AssertionError, match="relative error"):
            spec.compare((q,), wrong, want, tol)


def test_flash_bwd_wrapper_checks():
    (q, k, v, do), _ = _inputs("causal_gqa_ragged", torch.float32)
    o, lse = attention_ref(q, k, v, return_lse=True)
    FA._check_bwd_inputs(q, k, v, o, lse, do)
    with pytest.raises(ValueError, match="lse"):
        FA._check_bwd_inputs(q, k, v, o, lse.double(), do)
    with pytest.raises(ValueError, match="do must be"):
        FA._check_bwd_inputs(q, k, v, o, lse, do[:, :, :-1])
    with pytest.raises(ValueError, match="contiguous"):
        FA._check_bwd_inputs(q, k, v, o, lse, do.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="window"):
        FA.flash_attention_bwd(q, k, v, o, lse, do, window=0)
    with pytest.raises(ValueError, match="device"):
        FA.flash_attention_bwd(*[t.to("meta") for t in (q, k, v, o, lse, do)])


H100_SMEM_PER_SM = 233_472  # bytes of shared memory an SM has for blocks (228 KB)


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_bwd_tile_plan_per_head_dim(d):
    """The bf16 backward's kernels by head dim. The dq kernel runs wgmma on
    two warpgroups at D >= 64 (128-row q tiles, one CTA an SM) and mma.sync
    on 4 warps below (two CTAs an SM); the dk/dv kernel wgmma at D = 64 and
    128 (128-row kv tiles, one CTA an SM) and mma.sync on 8 warps at 16, 32
    (two CTAs an SM) and 256 (64-row q steps, one CTA an SM, where a
    warpgroup's dk and dv would not fit its registers). Each block also
    costs the 1 KB the card reserves; registers are ptxas' to report
    (``chip_smoke.py``'s build phase)."""
    (dq_name, dq), (kv_name, dkv) = FA.bwd_kernels(FA.tile_plan(torch.bfloat16, d)).items()
    wg_dq, wg_kv = d >= 64, d in (64, 128)
    assert dq_name == f"flash_bwd_dq_{'wgmma' if wg_dq else 'mma'}_kernel"
    assert kv_name == f"flash_bwd_dkv_{'wgmma' if wg_kv else 'mma'}_kernel"
    assert dq["threads"] == (256 if wg_dq else 128) and dkv["threads"] == 256
    assert (dq["block_q"] == 128) == wg_dq and (dkv["block_k"] == 128) == (d != 256)
    for p, ctas in ((dq, 1 if wg_dq else 2), (dkv, 1 if wg_kv or d == 256 else 2)):
        assert ctas * (p["smem"] + 1024) <= H100_SMEM_PER_SM
    if d == 256:
        assert dkv["block_q"] == 64


def test_bwd_tile_plan_gemma2_grids():
    """At gemma2-2b's attention (B=1, 8/4 heads, S=2048, D=256) the dq grid
    is one wave on the H100's 132 SMs (one CTA each); the dk/dv kernel
    takes 32-row kv tiles (256 CTAs, the heaviest, under causal masking the
    first kv tiles, launched first)."""
    plan = FA.tile_plan(torch.bfloat16, 256, B=1, Hq=8, Hkv=4, S=2048, Sk=2048)
    assert np.prod(plan["flash_bwd_dq_wgmma_kernel"]["grid"]) <= 132
    dkv = plan["flash_bwd_dkv_mma_kernel"]
    assert dkv["block_k"] == 32 and dkv["grid"] == (4, 64, 1)


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
def test_bwd_routes_by_dtype(fake_card, d):
    """A bf16 backward reaches the tensor-core kernels' entry point with the
    tile plan's shared memory of both kernels, a float32 one the CUDA-core
    kernels'; two launches a call either way."""
    from repro_torch.kernels import _build

    q, k = torch.zeros(1, 2, 5, d), torch.zeros(1, 1, 7, d)
    lse = torch.zeros(1, 2, 5)
    n0 = FA.flash_attention_bwd.launches
    for dt in (torch.bfloat16, torch.float32):
        qq, kk = q.to(dt), k.to(dt)
        FA.flash_attention_bwd(qq, kk, kk, qq, lse, qq, causal=True)
    assert FA.flash_attention_bwd.launches == n0 + 4
    (lib_b, fn_b, args_b), (lib_f, fn_f, args_f) = fake_card
    assert (lib_b, fn_b) == ("flash_attention_bwd_sm90", "flash_attention_bwd_bf16")
    assert (lib_f, fn_f) == ("flash_attention_bwd", "flash_attention_bwd_f32")
    dq, dkv = FA.bwd_kernels(FA.tile_plan(torch.bfloat16, d)).values()
    assert args_b[-4:-2] == (dq["smem"], dkv["smem"])
    assert len(args_b) == len(_build.SIGNATURES[lib_b][fn_b])
    assert len(args_f) == len(_build.SIGNATURES[lib_f][fn_f])
