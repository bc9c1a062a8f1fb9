"""The port's hybrid family (zamba2: a Mamba2 stack with one shared
attention block) against the JAX package.

Both packages take the same numpy inputs and one set of weights, drawn by
the JAX ``tree_materialize`` and carried over with
``convert.model_params_from_numpy``. Sizes: zamba2-1.2b's ``reduced()`` (4
ssm layers at d_model 64, 8 heads of 16, state 16; the shared block MHA 4/4
of head_dim 16, d_ff 128, applied after layers 2 and 4; vocab 256), with
``ssm_chunk`` set to 8 on both sides so that a sequence spans several
chunks. Nothing at full width runs here (its parameters are checked on the
meta device). Where the JAX function reaches a Pallas kernel it runs in
interpret mode, as the JAX package's own tests run it on the CPU.

Bars, each with its reason (those of test_torch_ssm.py):
  * model logits and caches in float32: 1e-4 (several f32 matmul chains
    in another summation order);
  * a float32 gradient: 2e-4. The shared block's gradient is the sum over
    its uses, which autograd adds in another order than JAX; and with x64
    on (tests/conftest.py) the JAX rope runs in float64, so gradients
    through attention differ by ~3e-5 anyway;
  * bfloat16: the registry's 2e-2 bar as a relative error norm, for each
    block on the JAX package's own inputs, and for the whole-model logits
    (XLA fuses bf16 elementwise chains and rounds once, PyTorch rounds
    after every op; test_torch_ssm.py says more). The whole model is held
    on weights whose shared attention is conditioned (``condition``): with
    the reference's init (ParamDef's fan_in is shape[-2], the head count
    of a 3-D attention weight) the scores are large, softmax is near an
    argmax, and the shared block multiplies the bf16 rounding noise of its
    input ~3.5x at each use, so the JAX package's own bf16 logits are 2.3%
    (relative norm) from its float32 ones and the port's 2.2%: no bf16
    implementation could be held to 2e-2 there. Conditioned, both are 0.6%
    from float32 and 0.6% from each other.
"""
import math
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import transformer as JT
from repro.models.params import tree_materialize as jax_tree_materialize
from repro.models.params import tree_num_params as jax_tree_num_params
from repro.train import step as JS
from repro_torch import configs as C
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.ckpt.checkpoint import committed_steps, load_checkpoint
from repro_torch.convert import model_params_from_numpy, model_params_to_numpy
from repro_torch.kernels import ops
from repro_torch.launch import train as launcher
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_leaves, tree_num_params
from repro_torch.serve import CachePool, PoolConfig, Request, Scheduler, generate
from repro_torch.train.step import TrainConfig, init_train_state, local_grads
from test_torch_models import port_config

FWD_TOL = 2e-5
GRAD_TOL = 2e-4
MODEL_TOL = 1e-4
BF16_TOL = 2e-2
CHUNK = 8  # reduced models: 8-step chunks, so a 21-token sequence spans 3
ARCH = "zamba2_1p2b"
T_ = torch.as_tensor


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """torch's CPU kernels on one thread per test: with JAX computing in the
    same process, its multi-threaded kernels here now and then return one
    worker thread's share of a tensor slightly wrong (test_torch_ssm.py
    says more; ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol):
    g = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(want).astype(np.float64),
                               rtol=tol, atol=tol)


def make(compute=jnp.float32, perturb=True, condition=False, jax_over=None, port_over=None,
         **shared):
    """(jax cfg, jax params, port cfg, port params): reduced zamba2 with one
    set of weights; `perturb` draws dt_bias, A_log, D and every norm scale
    (the shared block's ln1 and ln2 too) away from their init (0 and 1,
    exact in bf16); `condition` rescales the shared block's attention
    projections to a 1/sqrt(contracted width) init (``chip_smoke.py``'s
    ``condition_attention``)."""
    jcfg = dataclasses.replace(jax_get_reduced(ARCH), compute_dtype=compute, ssm_chunk=CHUNK,
                               ssm_kernel="off", **shared)
    jparams = jax_tree_materialize(JT.model_defs(jcfg), jax.random.PRNGKey(0),
                                   jcfg.param_dtype)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    if perturb:
        rng = np.random.default_rng(11)
        blk, sh = tree["blocks"], tree["shared_attn"]
        blk["ssm"]["dt_bias"] = rng.uniform(-1.0, 1.0, blk["ssm"]["dt_bias"].shape)
        blk["ssm"]["A_log"] = rng.uniform(-0.5, 1.5, blk["ssm"]["A_log"].shape)
        blk["ssm"]["D"] = rng.uniform(0.5, 1.5, blk["ssm"]["D"].shape)
        for leaf, key in ((blk["ssm"], "norm"), (blk, "ln"), (sh, "ln1"), (sh, "ln2"),
                          (tree, "final_norm")):
            leaf[key] = rng.uniform(0.8, 1.2, leaf[key].shape)
    if condition:
        attn, c = tree["shared_attn"]["attn"], jcfg
        for key, fan_in, width in (("wq", c.n_heads, c.d_model), ("wk", c.n_kv_heads, c.d_model),
                                   ("wv", c.n_kv_heads, c.d_model),
                                   ("wo", c.head_dim, c.n_heads * c.head_dim)):
            attn[key] = attn[key] * math.sqrt(fan_in / width)
    if perturb or condition:
        tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
        jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jcfg = dataclasses.replace(jcfg, **(jax_over or {}))
    pcfg = port_config(jcfg, **(port_over or {}))
    return jcfg, jparams, pcfg, model_params_from_numpy(pcfg, tree, "cpu")


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s))


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_copies_every_jax_field(which):
    jcfg = (jax_get_config if which == "full" else jax_get_reduced)("zamba2-1.2b")
    mine = (C.get_config if which == "full" else C.get_reduced)("zamba2-1.2b")
    assert mine == port_config(jcfg) and mine.family == "hybrid"
    assert mine.param_count() == jcfg.param_count()


def test_full_width_parameters_on_meta():
    """zamba2-1.2b at full width: shapes equal the JAX tree's; the analytic
    count is the JAX formula's 1,170,071,296, which leaves out the norm
    scales and D (38 x (2048 + 4096 + 64) + 2 x 2048 + 2048 = 242,048 more
    in the tree); matrix weights in bf16, the float32-read leaves (the
    shared block's ln1 and ln2 among them) in float32; the serving pool
    nests 38 slot-indexed ssm states and 6 paged K/V layers."""
    cfg = C.get_config("zamba2-1.2b")
    jcfg = jax_get_config("zamba2-1.2b")
    assert cfg.param_count() == jcfg.param_count() == 1_170_071_296
    jdefs = JT.model_defs(jcfg)
    assert tree_num_params(T.model_defs(cfg)) == jax_tree_num_params(jdefs) == 1_170_313_344
    params = T.init_params(cfg, 0, "meta")
    shapes = jax.tree_util.tree_map(lambda d: d.shape, jdefs,
                                    is_leaf=lambda x: hasattr(x, "axes"))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == shapes
    f32 = {"embed", "final_norm", "ln", "ln1", "ln2", "norm", "dt_bias", "A_log", "D"}
    flat = jax.tree_util.tree_leaves_with_path(params)
    for path, t in flat:
        want = torch.float32 if path[-1].key in f32 else torch.bfloat16
        assert t.dtype == want, jax.tree_util.keystr(path)
    assert params["shared_attn"]["attn"]["wq"].shape == (2048, 32, 64)
    pool = T.paged_cache_defs(cfg, 1, 32_769, 16, 32_768)
    assert pool["ssm"]["state"].shape == (38, 1, 64, 64, 64)
    assert pool["attn"]["k"].shape == (6, 32_769, 16, 32, 64)
    # long_500k: 49,152 bytes of K/V a token, 2^31 bytes of K a shared layer
    per_token = 2 * 6 * 32 * 64 * 2
    assert per_token == 49_152 and 524_288 * 32 * 64 * 2 == 2 ** 31


def test_param_conversion_roundtrip_and_f32_leaves():
    """A JAX tree goes into the port and back bit-equal (the unstacked
    shared_attn leaves too); under bf16 the float32-read leaves, perturbed
    to values bf16 cannot hold, keep float32."""
    _, jparams, pcfg, params = make(compute=jnp.bfloat16)
    sh = params["shared_attn"]
    assert sh["ln1"].dtype == sh["ln2"].dtype == torch.float32
    assert sh["attn"]["wq"].dtype == sh["mlp"]["wg"].dtype == torch.bfloat16
    want = np.asarray(jparams["shared_attn"]["ln1"])
    np.testing.assert_array_equal(sh["ln1"].numpy(), want)
    assert not np.array_equal(sh["ln1"].bfloat16().float().numpy(), want)
    _, jparams, _, params = make()
    back = model_params_to_numpy(params)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
                           back, jparams)
    assert set(back) == {"embed", "final_norm", "lm_head", "blocks", "shared_attn"}


# ---------------------------------------------------------------------------
# forward and gradients
# ---------------------------------------------------------------------------

# JAX route -> port route (attention and ssm alike): inline, plain version,
# and the Pallas kernels in interpret mode against "auto"
ROUTES = {"jnp": ("jnp", "jnp"), "oracle": ("off", "off"), "kernel": ("interpret", "auto")}


@pytest.mark.parametrize("route", ["jnp", "auto"])
def test_shared_block_matches_jax(route):
    """One use of the shared block (attention with no window, then the MLP)
    on float32 activations: the layer bar."""
    jcfg, jparams, pcfg, params = make(port_over={"attention_kernel": route})
    x = np.random.default_rng(6).standard_normal((2, 21, 64)).astype(np.float32)
    pos = np.tile(np.arange(21)[None], (2, 1))
    want, _ = JT._dense_block(jcfg, jparams["shared_attn"], jnp.asarray(x), jnp.asarray(pos),
                              None, None)
    got, cache = T._dense_block(pcfg, params["shared_attn"], T_(x), T_(pos), None, None)
    assert cache is None
    close(got, want, FWD_TOL)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_forward_matches_jax(route):
    jmode, pmode = ROUTES[route]
    jcfg, jparams, pcfg, params = make(
        jax_over={"attention_kernel": jmode, "ssm_kernel": jmode},
        port_over={"attention_kernel": pmode, "ssm_kernel": pmode})
    tok = _tokens(2, 21)
    want = JT.forward(jcfg, jparams, jnp.asarray(tok))
    got = T.forward(pcfg, params, T_(tok))
    assert got.shape == (2, 21, 256) and got.dtype == torch.float32
    close(got, want, MODEL_TOL)


def _rel(got, want) -> float:
    got = (got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got))
    got, want = got.astype(np.float64), np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_bf16_blocks_and_forward_match_jax():
    """With the reference's init, every block in turn (each ssm layer, each
    use of the shared block) on the JAX package's own bf16 input; then the
    whole model on conditioned weights (the module docstring says why)."""
    jcfg, jparams, pcfg, params = make(compute=jnp.bfloat16)
    tok = _tokens(2, 21, seed=1)
    x = JT._embed(jcfg, jparams, jnp.asarray(tok))
    pos = np.tile(np.arange(21)[None], (2, 1))
    layers = T._layers(params["blocks"], jcfg.n_layers)
    for i in range(jcfg.n_layers):
        jp = jax.tree_util.tree_map(lambda a, i=i: a[i], jparams["blocks"])
        want, _ = JT._ssm_layer(jcfg, jp, x, None)
        got, _ = T._ssm_layer(pcfg, layers[i], T_(np.array(x.astype(jnp.float32))).bfloat16(),
                              None)
        assert _rel(got, want) <= BF16_TOL, i
        x = want
        if (i + 1) % jcfg.hybrid_period == 0:
            want, _ = JT._dense_block(jcfg, jparams["shared_attn"], x, jnp.asarray(pos), None,
                                      None)
            got, _ = T._dense_block(pcfg, params["shared_attn"],
                                    T_(np.array(x.astype(jnp.float32))).bfloat16(), T_(pos),
                                    None, None)
            assert _rel(got, want) <= BF16_TOL, i
            x = want
    jcfg, jparams, pcfg, params = make(compute=jnp.bfloat16, condition=True)
    got = T.forward(pcfg, params, T_(tok))
    assert _rel(got, JT.forward(jcfg, jparams, jnp.asarray(tok))) <= BF16_TOL


def test_local_grads_match_jax():
    """Loss and every leaf's gradient, shared_attn's (the sum over its two
    uses) included, with the kernels' routes on both sides."""
    jcfg, jparams, pcfg, params = make(
        jax_over={"attention_kernel": "interpret", "ssm_kernel": "interpret"},
        port_over={"attention_kernel": "auto", "ssm_kernel": "auto"})
    toks = _tokens(2, 17, seed=2)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    jl, jg = jax.jit(lambda p, b: JS.local_grads(jcfg, JS.TrainConfig(), p, b))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = local_grads(pcfg, TrainConfig(), params, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    mine = model_params_to_numpy(grads)
    paths = jax.tree_util.tree_leaves_with_path(jg)
    assert any(p[0].key == "shared_attn" for p, _ in paths)
    for path, want in paths:
        assert np.abs(want).max() > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(np.asarray(_leaf(mine, path), np.float64),
                                   np.asarray(want, np.float64), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_gives_the_same_grads_and_kernel_calls():
    """remat "full" checkpoints every ssm layer and every use of the shared
    block: the same loss and gradients as "none", and each forward kernel
    call made twice (forward, recompute), each backward once; every call
    goes through the registry (held_to_plain sees it; on the CPU the
    wrappers take their plain versions and launch nothing)."""
    cfg = dataclasses.replace(C.get_reduced("zamba2-1.2b"), ssm_chunk=CHUNK)
    params = init_train_state(cfg, TrainConfig(), 0, "cpu")["params"]
    toks = _tokens(2, 13, seed=3)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    l0, g0 = local_grads(cfg, TrainConfig(), params, batch)
    n_attn = cfg.n_layers // cfg.hybrid_period
    with ops.held_to_plain("flash_attention") as ffwd, \
            ops.held_to_plain("flash_attention_bwd") as fbwd, \
            ops.held_to_plain("ssd_chunk") as sfwd, ops.held_to_plain("ssd_chunk_bwd") as sbwd:
        l1, g1 = local_grads(dataclasses.replace(cfg, remat="full"), TrainConfig(), params,
                             batch)
    assert (len(ffwd), len(fbwd), len(sfwd), len(sbwd)) == (2 * n_attn, n_attn,
                                                            2 * cfg.n_layers, cfg.n_layers)
    assert float(l0) == float(l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# decode: contiguous cache, the pool, the scheduler
# ---------------------------------------------------------------------------

def _check_cache(pc, jc):
    for k in ("state", "conv"):
        close(pc["ssm"][k], jc["ssm"][k], MODEL_TOL)
    for k in ("k", "v"):
        close(pc["attn"][k], jc["attn"][k], MODEL_TOL)
    assert pc["attn"]["pos"] == int(jc["attn"]["pos"])


@pytest.mark.parametrize("layers", [4, 5])
def test_prefill_and_contiguous_decode_match_jax(layers):
    """Right-padded prefill (valid_len reaches the ssm layers only; the
    shared block writes K/V at every padded position and pos advances by
    the padded S), then 4 decode steps: logits and the whole nested cache.
    5 layers at period 2 leave a last ssm layer with no shared block after
    it (2 uses, not 2.5)."""
    jcfg, jparams, pcfg, params = make(n_layers=layers)
    tok = _tokens(3, 16, seed=4)
    valid = np.array([16, 5, 11], np.int32)
    jc, jl = JT.prefill(jcfg, jparams, jnp.asarray(tok), JT.init_cache(jcfg, 3, 24),
                        valid_len=jnp.asarray(valid))
    pc, pl = T.prefill(pcfg, params, T_(tok), T.init_cache(pcfg, 3, 24, "cpu"),
                       valid_len=T_(valid))
    assert pc["attn"]["k"].shape[0] == layers // 2 and pc["ssm"]["state"].shape[0] == layers
    assert pc["attn"]["pos"] == 16
    for _ in range(4):
        close(pl, jl, MODEL_TOL)
        _check_cache(pc, jc)
        nxt = np.array(jnp.argmax(jl, -1))[:, None]
        jc, jl = JT.decode_step(jcfg, jparams, jnp.asarray(nxt), jc)
        pc, pl = T.decode_step(pcfg, params, T_(nxt), pc)
    close(pl, jl, MODEL_TOL)
    _check_cache(pc, jc)
    if layers == 5:  # and the forward of the odd depth
        tok = _tokens(2, 21, seed=5)
        close(T.forward(pcfg, params, T_(tok)), JT.forward(jcfg, jparams, jnp.asarray(tok)),
              MODEL_TOL)


def test_scheduler_paged_decode_matches_jax_contiguous():
    """The port's Scheduler (slot-indexed ssm states beside the shared
    block's K/V pages) against the JAX contiguous prefill + decode_step of
    each request (greedy): the same tokens, and the first decode-step
    logits of one request within the model bar (not the JAX paged path:
    ROADMAP Queue 3). The pool is small enough to preempt; every decode
    step makes one decode_attention call a use of the shared block."""
    jcfg, jparams, pcfg, params = make()
    rng = np.random.default_rng(5)
    reqs = [Request(i, rng.integers(0, 256, int(rng.integers(3, 16))), int(rng.integers(2, 9)))
            for i in range(6)]
    want, first = {}, None
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
    pool_cfg = PoolConfig(max_batch=4, block_size=4, n_blocks=12, max_len=32, prompt_pad=16)
    sch = Scheduler(pcfg, params, pool_cfg, device="cpu")
    ptrs = sch.pool.data_ptrs()
    assert ptrs.keys() == {"ssm", "attn"} and ptrs["attn"].keys() == {"k", "v"}
    assert sch.pool.paged
    seen, calls = {}, []
    inner = sch.decode_fn

    def decode_fn(*a):
        with ops.held_to_plain("decode_attention") as held:
            out = inner(*a)
        calls.append(len(held))
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
    assert set(calls) == {pcfg.n_layers // pcfg.hybrid_period}
    assert stats.peak_occupancy > 0 and sch.pool.used_page_count == 0
    # the contiguous generate gives the same tokens
    r = reqs[1]
    gen = generate(pcfg, params, T_(r.tokens)[None], max_new_tokens=r.max_new_tokens)
    assert gen.tokens[0].tolist() == want[r.rid]


def test_cache_pool_writes_slot_state_and_pages():
    """write_prefill overwrites the slot's ssm rows (never adds to them) and
    lands the shared block's K/V on the slot's pages (pad blocks in the
    null page); release keeps the stale state; gather_kv raises, as the
    JAX package reads back no hybrid pages."""
    cfg = dataclasses.replace(C.get_reduced("zamba2-1.2b"), ssm_chunk=CHUNK)
    pool = CachePool(cfg, PoolConfig(max_batch=3, block_size=4, n_blocks=6, max_len=16,
                                     prompt_pad=8), "cpu")
    assert pool.paged and pool.pages_needed(5) == 2
    pool.alloc_slot()
    slot = pool.alloc_slot()
    assert pool.ensure(slot, 5) and pool.used_page_count == 2
    pages = list(pool.table[slot, :2])
    for value in (2.0, -1.0):
        cache = T.init_cache(cfg, 1, 8, "cpu")
        for k in ("state", "conv"):
            cache["ssm"][k].fill_(value)
        for k in ("k", "v"):
            cache["attn"][k].copy_(torch.arange(8, dtype=torch.float32)[None, None, :, None,
                                                                        None] + value)
        pool.write_prefill(slot, cache)
        for k in ("state", "conv"):
            assert torch.all(pool.pools["ssm"][k][:, slot] == value)
            assert torch.all(pool.pools["ssm"][k][:, slot - 1] == 0)
        for k in ("k", "v"):
            got = pool.pools["attn"][k][:, pages].reshape(2, 8, 4, 16)
            assert torch.equal(got, cache["attn"][k][:, 0])
    untouched = [p for p in range(1, 6) if p not in pages]
    assert torch.all(pool.pools["attn"]["k"][:, untouched] == 0)
    pool.release(slot)
    assert torch.all(pool.pools["ssm"]["state"][:, slot] == -1.0)
    with pytest.raises(ValueError, match="no K/V pages"):
        pool.gather_kv(slot, 4)


# ---------------------------------------------------------------------------
# the launcher and checkpoints
# ---------------------------------------------------------------------------

def test_launcher_resumes_bit_equal_and_checkpoints_cross(tmp_path):
    """launch/train.py --arch zamba2-1.2b --reduced on the CPU: a run resumed
    from its step-3 checkpoint ends bit-equal to the uninterrupted one, and
    the JAX package reads the port's checkpoint (shared_attn under its own
    leaf paths) and the port the JAX's."""
    flags = ["--arch", "zamba2-1.2b", "--reduced", "--device", "cpu", "--steps", "6",
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

    jcfg = jax_get_reduced(ARCH)
    jstate = JS.init_train_state(jcfg, JS.TrainConfig(), jax.random.PRNGKey(0))
    back, step = jax_restore(tmp_path / "run", jstate)
    assert step == 6
    _, _, disk = load_checkpoint(tmp_path / "run", 6)
    for key in ("['params']/['shared_attn']/['attn']/['wq']",
                "['opt']/['nu']/['shared_attn']/['mlp']/['wd']"):
        assert key in disk
    np.testing.assert_array_equal(np.asarray(back["params"]["shared_attn"]["attn"]["wq"]),
                                  disk["['params']/['shared_attn']/['attn']/['wq']"])
    np.testing.assert_array_equal(np.asarray(back["params"]["shared_attn"]["attn"]["wq"]),
                                  full["params"]["shared_attn"]["attn"]["wq"].numpy())
    jstate["step"] = jnp.int32(2)
    jax_save(tmp_path / "jax", 2, jstate)
    cfg = C.get_reduced("zamba2-1.2b")
    mine, step = restore_checkpoint(tmp_path / "jax", init_train_state(cfg, TrainConfig(), 1,
                                                                       "cpu"))
    assert step == 2
    np.testing.assert_array_equal(mine["params"]["shared_attn"]["mlp"]["wg"].numpy(),
                                  np.asarray(jstate["params"]["shared_attn"]["mlp"]["wg"]))
    save_checkpoint(tmp_path / "port", 2, mine)
    again, _ = jax_restore(tmp_path / "port", jstate)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                                      np.asarray(b)),
                           again, jstate)
