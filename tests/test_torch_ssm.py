"""The port's Mamba2/SSD family against the JAX package.

Both packages take the same numpy inputs (and one set of weights, drawn by
the JAX ``tree_materialize`` and carried over with
``convert.model_params_from_numpy``). Sizes: the JAX kernel tests' SSD
shapes, and mamba2-1.3b's ``reduced()`` (2 layers, d_model 64, 8 heads of
16, state 16, vocab 256) with ``ssm_chunk`` set to 8 on both sides so that
a sequence spans several chunks. Nothing at full width runs here (its
parameters are checked on the meta device). Where the JAX function reaches
a Pallas kernel it runs in interpret mode, as the JAX package's own tests
run it on the CPU.

Bars, each with its reason:
  * the SSD within-chunk forward in float32: 2e-5, the registry's float32
    bar (``ops.ssd_chunk``); its gradient 2e-4, the registry's float32
    gradient bar (one recompute deeper);
  * float64 paths (the chunked scan against the sequential recurrence,
    the written-out backward against torch autograd): 1e-8 and 1e-10 (only
    summation order differs);
  * a layer in float32: 2e-5; model logits in float32: 1e-4 (several f32
    matmul chains in another summation order, as in test_torch_models);
    a float32 gradient: 2e-4;
  * bfloat16: the registry's 2e-2 bar, elementwise for the convolutions
    and as a relative error norm for an ssm block and whole-model logits:
    XLA on the CPU fuses a chain of bf16 elementwise ops (the conv's four
    products and sums, silu, the gate) and rounds once at the end, where
    PyTorch rounds after every op, so a block's outputs differ by a few
    bf16 ulps on some elements (test_torch_models says the same of the
    dense logits).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.kernels import ops as JO
from repro.kernels import ref as JR
from repro.kernels.ssd_scan import ssd_chunk_fwd as jax_ssd_chunk_fwd
from repro.models import ssm as JSSM
from repro.models import transformer as JT
from repro.models.params import tree_materialize as jax_tree_materialize
from repro.models.params import tree_num_params as jax_tree_num_params
from repro.train import step as JS
from repro_torch import configs as C
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.ckpt.checkpoint import committed_steps, load_checkpoint
from repro_torch.convert import model_params_from_numpy, model_params_to_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import SsdChunk, ssd_chunk_bwd, ssd_chunk_fwd
from repro_torch.launch import train as launcher
from repro_torch.models import ssm as SSM
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_leaves, tree_num_params
from repro_torch.serve import CachePool, PoolConfig, Request, Scheduler
from repro_torch.train.step import TrainConfig, init_train_state, local_grads
from test_torch_models import port_config

FWD_TOL = 2e-5
GRAD_TOL = 2e-4
LAYER_TOL = 2e-5
MODEL_TOL = 1e-4
BF16_TOL = 2e-2
CHUNK = 8  # reduced models: 8-step chunks, so a 21-token sequence spans 3


def close(got, want, tol):
    g = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(want).astype(np.float64),
                               rtol=tol, atol=tol)


def ssd_inputs(B, nc, Q, nh, hd, ds, seed=0, dtype=np.float32, decay=(0.01, 0.2)):
    """(xdt, cum, Bc, Cc) as numpy: normal xdt, B, C; cum the inclusive
    cumsum of -uniform(decay) log-decays within each chunk."""
    rng = np.random.default_rng(seed)
    xdt = rng.standard_normal((B, nc, Q, nh, hd))
    cum = -np.cumsum(rng.uniform(*decay, (B, nc, Q, nh)), axis=2)
    Bc = rng.standard_normal((B, nc, Q, ds))
    Cc = rng.standard_normal((B, nc, Q, ds))
    return tuple(a.astype(dtype) for a in (xdt, cum, Bc, Cc))


def cotangents(B, nc, Q, nh, hd, ds, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, nc, Q, nh, hd)).astype(np.float32),
            rng.standard_normal((B, nc, nh, ds, hd)).astype(np.float32))


T_ = torch.as_tensor


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test here runs torch's CPU kernels on one thread.

    With JAX computing in the same process, torch's multi-threaded CPU
    kernels on this container now and then return one worker thread's share
    of a tensor off by 1e-5 to 1e-3 relative (an elementwise ``exp`` of the
    decay tile, recomputed right after, is exact); on one thread they do
    not. That is a fault of the runtime, not of the code under test, and the
    float32 bars here would report it as a port fault."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

# the JAX kernel tests' shapes (tests/test_kernels.py): (B, nc, Q, nh, hd, ds, head_block)
JAX_SHAPES = [(1, 2, 64, 4, 32, 16, 4), (2, 3, 128, 8, 64, 32, 4), (1, 1, 64, 2, 32, 64, 2)]
# ragged ones: Q of 1, 5 and 37, nh of 3 and 6 (head blocks of 3 in the JAX adapter)
RAGGED = [(1, 1, 1, 3, 4, 5, None), (2, 1, 5, 6, 8, 3, None), (1, 2, 37, 3, 16, 16, None)]


# ---------------------------------------------------------------------------
# the SSD within-chunk kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", JAX_SHAPES + RAGGED)
def test_ssd_chunk_ref_matches_jax_pallas_and_oracle(shape):
    *dims, hb = shape
    args = ssd_inputs(*dims, seed=sum(dims))
    want_pallas = jax_ssd_chunk_fwd(*map(jnp.asarray, args), head_block=hb or dims[3],
                                    interpret=True)
    want_ref = JR.ssd_chunk_ref(*map(jnp.asarray, args))
    got = ref.ssd_chunk_ref(*map(T_, args))
    wrapped = ops.ssd_chunk(*map(T_, args), head_block=hb)  # the CPU path: the plain version
    for g, w_p, w_r, g2 in zip(got, want_pallas, want_ref, wrapped):
        close(g, w_p, FWD_TOL)
        close(g, w_r, FWD_TOL)
        # the same function; the CPU BLAS may split a product over threads
        # differently from call to call, so not always bit for bit
        close(g2, g.numpy(), 1e-6)


@pytest.mark.parametrize("shape", JAX_SHAPES[:2] + RAGGED)
def test_ssd_chunk_bwd_ref_matches_autograd_and_jax_vjp(shape):
    """The written-out backward: against torch autograd of the plain forward
    (float64), and, with the SsdChunk Function, against the JAX VJP through
    the Pallas backward in interpret mode (float32)."""
    *dims, _ = shape
    args = ssd_inputs(*dims, seed=3)
    dy, dst = cotangents(*dims)
    a64 = [T_(a).double().requires_grad_() for a in args]
    y, st = ref.ssd_chunk_ref(*a64)
    want = torch.autograd.grad((y, st), a64, (T_(dy).double(), T_(dst).double()))
    got = ref.ssd_chunk_bwd_ref(*(T_(a).double() for a in args), T_(dy).double(),
                                T_(dst).double())
    for g, w in zip(got, want):
        close(g, w.numpy(), 1e-10)

    _, vjp = jax.vjp(lambda *a: JO.ssd_chunk(*a, use_pallas="interpret"),
                     *map(jnp.asarray, args))
    jgrads = vjp((jnp.asarray(dy), jnp.asarray(dst)))
    a32 = [T_(a).requires_grad_() for a in args]
    y, st = SsdChunk.apply(*a32)
    fn_grads = torch.autograd.grad((y, st), a32, (T_(dy), T_(dst)))
    plain = ssd_chunk_bwd(*map(T_, args), T_(dy), T_(dst))  # the CPU path of the wrapper
    for g, p, w in zip(fn_grads, plain, jgrads):
        close(g, w, GRAD_TOL)
        close(g, p.numpy(), 1e-6)  # the same function (the CPU BLAS' thread split aside)
    # and the registry's comparator holds the plain version to itself
    assert ops.parity_check("ssd_chunk_bwd", *map(T_, args), T_(dy), T_(dst),
                            mode="auto") < GRAD_TOL


def test_ssd_wrappers_count_no_launch_on_the_cpu_and_check_dtypes():
    args = [T_(a) for a in ssd_inputs(1, 1, 6, 2, 4, 3)]
    n_fwd, n_bwd = ssd_chunk_fwd.launches, ssd_chunk_bwd.launches
    a = [t.clone().requires_grad_() for t in args]
    y, st = ops.ssd_chunk(*a)
    (y.sum() + st.sum()).backward()
    assert (ssd_chunk_fwd.launches, ssd_chunk_bwd.launches) == (n_fwd, n_bwd)
    with ops.held_to_plain("ssd_chunk") as held:
        ops.ssd_chunk(*args)  # the wrapper's CPU path against the float64 plain version
    assert len(held) == 1 and held[0] < FWD_TOL
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd_chunk(*args, mode="on")
    from repro_torch.kernels.ssd_scan import _check_inputs

    with pytest.raises(ValueError, match="float32 only.*ROADMAP"):
        _check_inputs(args[0].bfloat16(), *args[1:])
    with pytest.raises(ValueError, match="cum must be"):
        _check_inputs(args[0], args[1][:, :, :3], *args[2:])


@pytest.mark.parametrize("S", [16, 32, 64])
@pytest.mark.parametrize("route", ["jnp", "off", "auto"])
def test_grads_finite_under_fast_decay(S, route):
    """tests/test_ssm.py's regression: |a_log| ~ 8 makes the above-diagonal
    exp overflow; every route masks before the exp, so the gradients are
    finite, and they match the JAX package's."""
    rng = np.random.default_rng(S)
    B, nh, hd, ds = 1, 2, 4, 3
    xs = [rng.standard_normal((B, S, nh, hd)), rng.uniform(0.5, 1.5, (B, S, nh)),
          -rng.uniform(6.0, 8.0, (B, S, nh)), rng.standard_normal((B, S, ds)),
          rng.standard_normal((B, S, ds))]
    xs = [x.astype(np.float32) for x in xs]

    def jloss(*a):
        y, h = JSSM._ssd_chunked(*a, 16, kernel="off")
        return jnp.sum(y) + jnp.sum(h)

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, xs))
    a = [T_(x).requires_grad_() for x in xs]
    y, h = SSM._ssd_chunked(*a, 16, kernel=route)
    grads = torch.autograd.grad(y.sum() + h.sum(), a)
    for g, w in zip(grads, jg):
        assert torch.isfinite(g).all()
        close(g, w, GRAD_TOL)


# ---------------------------------------------------------------------------
# the chunked scan
# ---------------------------------------------------------------------------

def ssd_sequential(xh, dt, a_log, Bc, Cc, h0=None):
    """The per-step recurrence (tests/test_ssm.py's oracle), numpy float64."""
    B, S, nh, hd = xh.shape
    h = np.zeros((B, nh, Bc.shape[-1], hd)) if h0 is None else np.array(h0, np.float64)
    ys = []
    for t in range(S):
        xdt = xh[:, t] * dt[:, t, :, None]
        h = np.exp(a_log[:, t])[:, :, None, None] * h + np.einsum("bs,bhd->bhsd", Bc[:, t], xdt)
        ys.append(np.einsum("bs,bhsd->bhd", Cc[:, t], h))
    return np.stack(ys, 1), h


def scan_inputs(B, S, nh, hd, ds, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, nh, hd)), rng.uniform(0.1, 1.0, (B, S, nh)),
            -rng.uniform(0.01, 0.5, (B, S, nh)), rng.standard_normal((B, S, ds)),
            rng.standard_normal((B, S, ds)))


@pytest.mark.parametrize("S,chunk", [(16, 4), (16, 16), (12, 5), (7, 8), (32, 8)])
def test_chunked_equals_sequential_and_jax(S, chunk):
    xs = scan_inputs(2, S, 3, 4, 5, seed=0)
    y, h = SSM._ssd_chunked(*map(T_, xs), chunk)
    y_ref, h_ref = ssd_sequential(*xs)
    close(y, y_ref, 1e-8)
    close(h, h_ref, 1e-8)
    jy, jh = JSSM._ssd_chunked(*map(jnp.asarray, xs), chunk)
    close(y, np.asarray(jy, np.float64), 1e-8)
    close(h, np.asarray(jh, np.float64), 1e-8)


def test_chunked_with_initial_state_and_split_prefill():
    xs = scan_inputs(1, 16, 2, 4, 3, seed=1)
    h0 = np.random.default_rng(9).standard_normal((1, 2, 3, 4))
    y, h = SSM._ssd_chunked(*map(T_, xs), 4, h0=T_(h0))
    y_ref, h_ref = ssd_sequential(*xs, h0=h0)
    close(y, y_ref, 1e-8)
    close(h, h_ref, 1e-8)
    # prefill(first half) -> prefill(second half) == the whole scan
    y_full, h_full = SSM._ssd_chunked(*map(T_, xs), 4)
    first = [T_(x[:, :8]) for x in xs]
    second = [T_(x[:, 8:]) for x in xs]
    y1, h1 = SSM._ssd_chunked(*first, 4)
    y2, h2 = SSM._ssd_chunked(*second, 4, h0=h1)
    close(torch.cat([y1, y2], 1), y_full.numpy(), 1e-8)
    close(h2, h_full.numpy(), 1e-8)


@pytest.mark.parametrize("head_block", [0, 2])
def test_kernel_routing_ragged_tail_and_head_blocks_match_jax(head_block):
    """A ragged S (20 over chunks of 8: the zero-padding branch), h0, and
    the head-block loop: the registry route against the JAX kernel route
    (Pallas interpret) and the inline one, forward and gradients."""
    rng = np.random.default_rng(3)
    B, S, nh, hd, ds = 2, 20, 4, 4, 5
    xs = [x.astype(np.float32) for x in scan_inputs(B, S, nh, hd, ds, seed=3)]
    h0 = rng.standard_normal((B, nh, ds, hd)).astype(np.float32)
    jy, jh = JSSM._ssd_chunked(*map(jnp.asarray, xs), 8, h0=jnp.asarray(h0),
                               head_block=head_block, kernel="interpret")
    for route in ("auto", "jnp"):
        y, h = SSM._ssd_chunked(*map(T_, xs), 8, h0=T_(h0), head_block=head_block, kernel=route)
        close(y, jy, FWD_TOL)
        close(h, jh, FWD_TOL)

    def jgrads(x, b):
        y = JSSM._ssd_chunked(x, jnp.asarray(xs[1]), jnp.asarray(xs[2]), b, jnp.asarray(xs[4]),
                              8, head_block=head_block, kernel="interpret")[0]
        return jnp.sum(jnp.sin(y))

    want = jax.grad(jgrads, argnums=(0, 1))(jnp.asarray(xs[0]), jnp.asarray(xs[3]))
    x, b = T_(xs[0]).requires_grad_(), T_(xs[3]).requires_grad_()
    y = SSM._ssd_chunked(x, T_(xs[1]), T_(xs[2]), b, T_(xs[4]), 8, head_block=head_block,
                         kernel="auto")[0]
    got = torch.autograd.grad(torch.sin(y).sum(), (x, b))
    for g, w in zip(got, want):
        close(g, w, GRAD_TOL)


# ---------------------------------------------------------------------------
# the block: convolutions and ssm_block
# ---------------------------------------------------------------------------

def make(compute=jnp.float32, perturb=False, **shared):
    """(jax cfg, jax params, port cfg, port params): reduced mamba2 with one
    set of weights; `perturb` draws dt_bias, A_log, D and the norm scales
    away from their init (0 and 1, exact in bf16)."""
    jcfg = dataclasses.replace(jax_get_reduced("mamba2_1p3b"), compute_dtype=compute,
                               ssm_chunk=CHUNK, ssm_kernel="off", **shared)
    jparams = jax_tree_materialize(JT.model_defs(jcfg), jax.random.PRNGKey(0),
                                   jcfg.param_dtype)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    if perturb:
        rng = np.random.default_rng(11)
        blk = tree["blocks"]
        blk["ssm"]["dt_bias"] = rng.uniform(-1.0, 1.0, blk["ssm"]["dt_bias"].shape)
        blk["ssm"]["A_log"] = rng.uniform(-0.5, 1.5, blk["ssm"]["A_log"].shape)
        blk["ssm"]["D"] = rng.uniform(0.5, 1.5, blk["ssm"]["D"].shape)
        blk["ssm"]["norm"] = rng.uniform(0.8, 1.2, blk["ssm"]["norm"].shape)
        blk["ln"] = rng.uniform(0.8, 1.2, blk["ln"].shape)
        tree["final_norm"] = rng.uniform(0.8, 1.2, tree["final_norm"].shape)
        tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    pcfg = port_config(jcfg)
    return jcfg, jparams, pcfg, model_params_from_numpy(pcfg, tree, "cpu")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convolutions_match_jax(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = (0.5 * rng.standard_normal((4, 12))).astype(np.float32)
    jd, td, tol = ((jnp.float32, torch.float32, LAYER_TOL) if dtype == "float32"
                   else (jnp.bfloat16, torch.bfloat16, BF16_TOL))
    jx, jw, tx, tw = jnp.asarray(x, jd), jnp.asarray(w, jd), T_(x).to(td), T_(w).to(td)
    close(SSM._causal_depthwise_conv(tx, tw).float(),
          JSSM._causal_depthwise_conv(jx, jw).astype(jnp.float32), tol)
    close(SSM._depthwise_conv_valid(tx, tw).float(),
          JSSM._depthwise_conv_valid(jx, jw).astype(jnp.float32), tol)


def _layer0(jparams, params):
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["ssm"])
    return jp, T._layers(params["blocks"], 2)[0]["ssm"]


@pytest.mark.parametrize("route", ["jnp", "auto"])
def test_ssm_block_train_path_matches_jax(route):
    jcfg, jparams, pcfg, params = make(perturb=True)
    pcfg = dataclasses.replace(pcfg, ssm_kernel=route)
    x = np.random.default_rng(5).standard_normal((2, 21, 64)).astype(np.float32)
    jp, tp = _layer0(jparams, params)
    want, _ = JSSM.ssm_block(jcfg, jp, jnp.asarray(x))
    got, cache = SSM.ssm_block(pcfg, tp, T_(x))
    assert cache is None
    close(got, want, LAYER_TOL)


def test_ssm_block_prefill_valid_len_and_decode_step_match_jax():
    """Prefill from a nonzero cached state with right-padded rows, then the
    S = 1 recurrent step: outputs and the new state and conv history."""
    jcfg, jparams, pcfg, params = make(perturb=True)
    rng = np.random.default_rng(6)
    B, S = 3, 12
    jp, tp = _layer0(jparams, params)
    one = JSSM.ssm_cache_defs(jcfg, B)
    cache = {k: rng.standard_normal(s.shape).astype(np.float32) for k, s in one.items()}
    x = rng.standard_normal((B, S, 64)).astype(np.float32)
    valid = np.array([12, 5, 1], np.int32)
    want, jc = JSSM.ssm_block(jcfg, jp, jnp.asarray(x),
                              cache=jax.tree_util.tree_map(jnp.asarray, cache),
                              valid_len=jnp.asarray(valid))
    got, pc = SSM.ssm_block(pcfg, tp, T_(x), cache={k: T_(v) for k, v in cache.items()},
                            valid_len=T_(valid))
    close(got, want, LAYER_TOL)
    for k in ("state", "conv"):
        close(pc[k], jc[k], LAYER_TOL)
    x1 = rng.standard_normal((B, 1, 64)).astype(np.float32)
    want, jc = JSSM.ssm_block(jcfg, jp, jnp.asarray(x1), cache=jc)
    got, pc = SSM.ssm_block(pcfg, tp, T_(x1), cache=pc)
    close(got, want, LAYER_TOL)
    for k in ("state", "conv"):
        close(pc[k], jc[k], LAYER_TOL)


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------

def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s))


# JAX route -> port route: inline, plain version, and Pallas interpret against "auto"
ROUTES = {"jnp": ("jnp", "jnp"), "oracle": ("off", "off"), "kernel": ("interpret", "auto")}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_forward_matches_jax(route):
    jmode, pmode = ROUTES[route]
    jcfg, jparams, pcfg, params = make(perturb=True)
    jcfg = dataclasses.replace(jcfg, ssm_kernel=jmode)
    pcfg = dataclasses.replace(pcfg, ssm_kernel=pmode)
    tok = _tokens(2, 21)
    want = JT.forward(jcfg, jparams, jnp.asarray(tok))
    got = T.forward(pcfg, params, T_(tok))
    assert got.shape == (2, 21, 256) and got.dtype == torch.float32
    close(got, want, MODEL_TOL)


def test_bf16_forward_matches_jax():
    jcfg, jparams, pcfg, params = make(compute=jnp.bfloat16, perturb=True)
    tok = _tokens(2, 21, seed=1)
    got = T.forward(pcfg, params, T_(tok)).numpy().astype(np.float64)
    want = np.asarray(JT.forward(jcfg, jparams, jnp.asarray(tok)), np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= BF16_TOL


def test_converted_parameters_keep_the_f32_leaves():
    """The storage rule: dt_bias, A_log, D and the norm scales are read in
    float32 by the JAX package, so the port keeps them float32 even when
    the matrix weights are bf16. Perturbed (values that bf16 cannot hold),
    they come through bit for bit, and the model matches JAX layer by
    layer at the bf16 bar."""
    jcfg, jparams, pcfg, params = make(compute=jnp.bfloat16, perturb=True)
    ssm = params["blocks"]["ssm"]
    for leaf, want in ((ssm["dt_bias"], jparams["blocks"]["ssm"]["dt_bias"]),
                       (ssm["A_log"], jparams["blocks"]["ssm"]["A_log"]),
                       (ssm["D"], jparams["blocks"]["ssm"]["D"]),
                       (ssm["norm"], jparams["blocks"]["ssm"]["norm"]),
                       (params["blocks"]["ln"], jparams["blocks"]["ln"]),
                       (params["final_norm"], jparams["final_norm"])):
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want))
        # a bf16 copy would not hold these values: the rule matters
        assert not np.array_equal(leaf.bfloat16().float().numpy(), np.asarray(want))
    assert ssm["wx"].dtype == ssm["conv_x"].dtype == torch.bfloat16
    x = np.random.default_rng(7).standard_normal((2, 11, 64)).astype(np.float32)
    jp, tp = _layer0(jparams, params)
    want, _ = JSSM.ssm_block(jcfg, jp, jnp.asarray(x).astype(jnp.bfloat16))
    got, _ = SSM.ssm_block(pcfg, tp, T_(x).bfloat16())
    got = got.double().numpy()
    want = np.asarray(want).astype(np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= BF16_TOL
    back = model_params_to_numpy(params)
    np.testing.assert_array_equal(back["blocks"]["ssm"]["A_log"],
                                  np.asarray(jparams["blocks"]["ssm"]["A_log"]))


def test_local_grads_match_jax():
    jcfg, jparams, pcfg, params = make(perturb=True)
    pcfg = dataclasses.replace(pcfg, ssm_kernel="auto")
    jcfg = dataclasses.replace(jcfg, ssm_kernel="interpret")
    toks = _tokens(2, 17, seed=2)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jl, jg = jax.jit(lambda p, b: JS.local_grads(jcfg, JS.TrainConfig(), p, b))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = local_grads(pcfg, TrainConfig(), params, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    mine = model_params_to_numpy(grads)
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        got = mine
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_gives_the_same_grads():
    cfg = dataclasses.replace(C.get_reduced("mamba2-1.3b"), ssm_chunk=CHUNK)
    params = init_train_state(cfg, TrainConfig(), 0, "cpu")["params"]
    toks = _tokens(2, 13, seed=3)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    l0, g0 = local_grads(cfg, TrainConfig(), params, batch)
    l1, g1 = local_grads(dataclasses.replace(cfg, remat="full"), TrainConfig(), params, batch)
    assert float(l0) == float(l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_prefill_and_contiguous_decode_match_jax():
    jcfg, jparams, pcfg, params = make(perturb=True)
    tok = _tokens(3, 16, seed=4)
    valid = np.array([16, 5, 11], np.int32)
    jc, jl = JT.prefill(jcfg, jparams, jnp.asarray(tok), JT.init_cache(jcfg, 3, 32),
                        valid_len=jnp.asarray(valid))
    pc, pl = T.prefill(pcfg, params, T_(tok), T.init_cache(pcfg, 3, 32, "cpu"),
                       valid_len=T_(valid))
    assert set(pc) == {"state", "conv"} and "pos" not in pc
    for _ in range(4):
        close(pl, jl, MODEL_TOL)
        for k in ("state", "conv"):
            close(pc[k], jc[k], MODEL_TOL)
        nxt = np.array(jnp.argmax(jl, -1))[:, None]
        jc, jl = JT.decode_step(jcfg, jparams, jnp.asarray(nxt), jc)
        pc, pl = T.decode_step(pcfg, params, T_(nxt), pc)
    close(pl, jl, MODEL_TOL)


def test_scheduler_paged_decode_matches_jax_contiguous():
    """The port's Scheduler (slot-indexed states, no pages) against the JAX
    contiguous prefill + decode_step of each request (greedy): the same
    tokens, and the first decode-step logits of one request within the
    model bar (not the JAX paged path: ROADMAP Queue 3)."""
    jcfg, jparams, pcfg, params = make(perturb=True)
    rng = np.random.default_rng(5)
    reqs = [Request(i, rng.integers(0, 256, int(rng.integers(3, 16))), int(rng.integers(2, 7)))
            for i in range(6)]
    want = {}
    first = None
    for r in reqs:
        c, lg = JT.prefill(jcfg, jparams, jnp.asarray(r.tokens)[None],
                           JT.init_cache(jcfg, 1, 32))
        toks = [int(jnp.argmax(lg[0]))]
        for step in range(r.max_new_tokens - 1):
            c, lg = JT.decode_step(jcfg, jparams, jnp.asarray([[toks[-1]]]), c)
            if r.rid == 2 and step == 0:
                first = np.asarray(lg[0])
            toks.append(int(jnp.argmax(lg[0])))
        want[r.rid] = toks
    pool_cfg = PoolConfig(max_batch=4, block_size=4, n_blocks=3, max_len=32, prompt_pad=16)
    sch = Scheduler(pcfg, params, pool_cfg, device="cpu")
    ptrs = sch.pool.data_ptrs()
    seen = {}
    inner = sch.decode_fn

    def decode_fn(*a):
        out = inner(*a)
        for slot, st in sch.active.items():
            if st.req.rid == 2 and len(st.generated) == 1:
                seen["logits"] = out[1][slot].clone()
        return out

    sch.decode_fn = decode_fn
    results, stats = sch.run(reqs)
    for r in reqs:
        assert results[r.rid].tolist() == want[r.rid], r.rid
    close(seen["logits"], first, MODEL_TOL)
    assert sch.pool.data_ptrs() == ptrs
    assert sch.pool.used_page_count == 0 and stats.peak_occupancy == 0.0
    assert set(sch.pool.pools) == {"state", "conv"}


def test_cache_pool_overwrites_slot_state():
    cfg = dataclasses.replace(C.get_reduced("mamba2-1.3b"), ssm_chunk=CHUNK)
    pool = CachePool(cfg, PoolConfig(max_batch=3, block_size=4, n_blocks=2, max_len=16,
                                     prompt_pad=8), "cpu")
    assert not pool.paged and pool.pages_needed(100) == 0
    slot = pool.alloc_slot()
    assert pool.ensure(slot, 16) and pool.used_page_count == 0
    for value in (2.0, -1.0):
        cache = {k: torch.full((s.shape[0], 1, *s.shape[2:]), value, dtype=s.dtype)
                 for k, s in T.cache_defs(cfg, 1, 8).items()}
        pool.write_prefill(slot, cache)
        for k in ("state", "conv"):
            assert torch.all(pool.pools[k][:, slot] == value)  # overwritten, not added
            assert torch.all(pool.pools[k][:, slot + 1] == 0)
    pool.release(slot)
    assert torch.all(pool.pools["state"][:, slot] == -1.0)  # stale until the next prefill
    with pytest.raises(ValueError, match="no K/V pages"):
        pool.gather_kv(slot, 4)


# ---------------------------------------------------------------------------
# full width, the launcher, checkpoints
# ---------------------------------------------------------------------------

def test_full_width_parameters_on_meta():
    """mamba2-1.3b at full width: shapes equal the JAX tree's; the analytic
    count is the JAX formula's 1,446,205,440, which leaves out the norm
    scales and D (48 x (2048 + 4096 + 64) + 2048 = 300,032 more in the
    tree); matrix weights in bf16, the float32-read leaves in float32."""
    cfg = C.get_config("mamba2-1.3b")
    jcfg = jax_get_config("mamba2-1.3b")
    assert cfg == port_config(jcfg)
    assert cfg.param_count() == jcfg.param_count() == 1_446_205_440
    jdefs = JT.model_defs(jcfg)
    assert tree_num_params(T.model_defs(cfg)) == jax_tree_num_params(jdefs) == 1_446_505_472
    params = T.init_params(cfg, 0, "meta")
    shapes = jax.tree_util.tree_map(lambda d: d.shape, jdefs,
                                    is_leaf=lambda x: hasattr(x, "axes"))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == shapes
    f32 = {"embed", "final_norm", "ln", "norm", "dt_bias", "A_log", "D"}
    flat = jax.tree_util.tree_leaves_with_path(params)
    for path, t in flat:
        want = torch.float32 if path[-1].key in f32 else torch.bfloat16
        assert t.dtype == want, jax.tree_util.keystr(path)
    f32_elems = sum(t.numel() for p, t in flat if p[-1].key in f32)
    # embed, final_norm, and per layer ln, norm, dt_bias, A_log and D
    assert f32_elems == 50_280 * 2048 + 2048 + 48 * (2048 + 4096 + 3 * 64)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    assert nbytes == 2 * 1_446_505_472 + 2 * f32_elems
    pool = T.paged_cache_defs(cfg, 8, 513, 16, 64)
    assert pool["state"].shape == (48, 8, 64, 128, 64) and pool["state"].dtype == torch.float32
    assert pool["conv"].shape == (48, 8, 3, 4096 + 256)


def test_launcher_resumes_bit_equal_and_checkpoints_cross(tmp_path):
    """launch/train.py --arch mamba2-1.3b --reduced on the CPU: a run resumed
    from its step-3 checkpoint ends bit-equal to the uninterrupted one, and
    the JAX package reads the port's checkpoint and the port the JAX's."""
    flags = ["--arch", "mamba2-1.3b", "--reduced", "--device", "cpu", "--steps", "6",
             "--ckpt-every", "3", "--batch", "2", "--seq", "16", "--ckpt-dir",
             str(tmp_path / "run")]
    full = launcher.run(launcher.parse_args(flags))
    assert committed_steps(tmp_path / "run") == [3, 6]
    for f in (tmp_path / "run" / "step_6").iterdir():
        f.unlink()
    (tmp_path / "run" / "step_6").rmdir()
    resumed = launcher.run(launcher.parse_args(flags))
    for a, b in zip(tree_leaves(full), tree_leaves(resumed)):
        assert a.dtype == b.dtype and torch.equal(a, b)

    from repro.ckpt import restore_checkpoint as jax_restore
    from repro.ckpt import save_checkpoint as jax_save

    jcfg = jax_get_reduced("mamba2_1p3b")
    jstate = JS.init_train_state(jcfg, JS.TrainConfig(), jax.random.PRNGKey(0))
    back, step = jax_restore(tmp_path / "run", jstate)
    assert step == 6
    _, _, disk = load_checkpoint(tmp_path / "run", 6)
    np.testing.assert_array_equal(np.asarray(back["params"]["blocks"]["ssm"]["A_log"]),
                                  disk["['params']/['blocks']/['ssm']/['A_log']"])
    jstate["step"] = jnp.int32(2)
    jax_save(tmp_path / "jax", 2, jstate)
    cfg = C.get_reduced("mamba2-1.3b")
    mine, step = restore_checkpoint(tmp_path / "jax", init_train_state(cfg, TrainConfig(), 1,
                                                                       "cpu"))
    assert step == 2
    np.testing.assert_array_equal(mine["params"]["blocks"]["ssm"]["wx"].numpy(),
                                  np.asarray(jstate["params"]["blocks"]["ssm"]["wx"]))
    save_checkpoint(tmp_path / "port", 2, mine)
    again, _ = jax_restore(tmp_path / "port", jstate)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                                      np.asarray(b)),
                           again, jstate)
