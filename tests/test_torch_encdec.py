"""The port's encdec family (whisper-small) against the JAX package.

Both packages take the same numpy inputs and one set of weights, drawn by
the JAX ``tree_materialize`` and carried over with
``convert.model_params_from_numpy``; the encoder input is a seeded numpy
(B, encoder_len, d_model) array of frame embeddings (the audio frontend is
a stub in both). Sizes: whisper-small's ``reduced()`` (2 encoder and 2
decoder layers at d_model 64, MHA 4/4 of head_dim 16, d_ff 128, 32 frames,
vocab 256). Nothing at full width runs here (its parameters are checked on
the meta device). Where the JAX function reaches a Pallas kernel (the
encoder's non-causal and the decoder's causal self-attention) it runs in
interpret mode, as the JAX package's own tests run it on the CPU; cross
attention takes the inline path in both packages.

Bars (those of test_torch_hybrid.py): a layer in float32 2e-5, model
logits and caches 1e-4, a float32 gradient 2e-4, the loss 1e-5 relative,
bfloat16 2e-2 as a relative error norm. With the reference's init
(ParamDef's fan_in is shape[-2], the head count of a 3-D attention weight)
the attention scores are large and softmax is near an argmax, so four
attention layers amplify one float32 ulp: on these inputs the JAX
package's own logits differ by 0.35-1.15e-4 between its inline and its
kernel routes (3 seeds), and the port's by 1.1-3.2e-4 from the JAX
package's, while each layer on the JAX package's own inputs agrees to
~1e-6 relative (``test_layers_match_jax``). The
whole-model tests therefore run on weights whose attention projections are
conditioned to a 1/sqrt(contracted width) init (``make(condition=True)``,
``chip_smoke.py``'s ``condition_attention``), as test_torch_hybrid.py's
bf16 test does; the layers are held at the reference's init.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.params import tree_materialize as jax_tree_materialize
from repro.models.params import tree_num_params as jax_tree_num_params
from repro.serve import engine as JE
from repro.train import step as JS
from repro_torch import configs as C
from repro_torch.convert import model_params_from_numpy, model_params_to_numpy
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_launcher
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_leaves, tree_num_params
from repro_torch.serve import CachePool, PoolConfig, Request, Scheduler, generate
from repro_torch.train.step import TrainConfig, init_train_state, local_grads, train_step
from test_torch_models import port_config

FWD_TOL = 2e-5
GRAD_TOL = 2e-4
MODEL_TOL = 1e-4
BF16_TOL = 2e-2
ARCH = "whisper_small"
SE = 32  # the reduced encoder_len
T_ = torch.as_tensor


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """torch's CPU kernels on one thread per test, beside JAX in the same
    process (test_torch_hybrid.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, tol):
    g = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(want).astype(np.float64),
                               rtol=tol, atol=tol)


def _rel(got, want) -> float:
    got = got.float().numpy().astype(np.float64)
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def make(compute=jnp.float32, condition=True, jax_over=None, port_over=None, **shared):
    """(jax cfg, jax params, port cfg, port params): reduced whisper with one
    set of weights; every norm scale (ln_x and enc_final_norm among them)
    drawn away from its init (1, exact in bf16); `condition` rescales every
    attention projection (encoder, decoder, cross) to a 1/sqrt(contracted
    width) init (the module docstring says why)."""
    jcfg = dataclasses.replace(jax_get_reduced(ARCH), compute_dtype=compute, **shared)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_tree_materialize(JT.model_defs(jcfg), jax.random.PRNGKey(0),
                                         jcfg.param_dtype))
    rng = np.random.default_rng(11)
    enc, dec = tree["encoder"], tree["decoder"]
    for leaf, key in ((enc, "ln1"), (enc, "ln2"), (dec, "ln1"), (dec, "ln_x"), (dec, "ln2"),
                      (tree, "final_norm"), (tree, "enc_final_norm")):
        leaf[key] = rng.uniform(0.8, 1.2, leaf[key].shape).astype(np.float32)
    if condition:
        c = jcfg
        for attn in (enc["attn"], dec["attn"], dec["xattn"]):
            for key, fan_in, width in (("wq", c.n_heads, c.d_model),
                                       ("wk", c.n_kv_heads, c.d_model),
                                       ("wv", c.n_kv_heads, c.d_model),
                                       ("wo", c.head_dim, c.n_heads * c.head_dim)):
                attn[key] = (attn[key] * math.sqrt(fan_in / width)).astype(np.float32)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jcfg = dataclasses.replace(jcfg, **(jax_over or {}))
    pcfg = port_config(jcfg, **(port_over or {}))
    return jcfg, jparams, pcfg, model_params_from_numpy(pcfg, tree, "cpu")


def _tokens(b, s, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, s))


def _frames(b, seed=0, se=SE):
    return np.random.default_rng(100 + seed).standard_normal((b, se, 64)).astype(np.float32)


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


# ---------------------------------------------------------------------------
# config and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_copies_every_jax_field(which):
    jcfg = (jax_get_config if which == "full" else jax_get_reduced)("whisper-small")
    mine = (C.get_config if which == "full" else C.get_reduced)("whisper-small")
    assert mine == port_config(jcfg) and mine.family == "encdec"
    assert (mine.n_encoder_layers, mine.encoder_len) == (jcfg.n_encoder_layers,
                                                        jcfg.encoder_len)
    assert mine.param_count() == jcfg.param_count()


def test_full_width_parameters_on_meta():
    """whisper-small at full width: shapes equal the JAX tree's (encoder,
    decoder with xattn and ln_x, enc_final_norm); matrix weights in bf16,
    embed and every norm scale in float32: 0.75 GB; the serving pool pages
    the decoder's K/V and holds (1500, 12, 64) cross K/V a slot and layer."""
    cfg = C.get_config("whisper-small")
    jdefs = JT.model_defs(jax_get_config("whisper-small"))
    assert tree_num_params(T.model_defs(cfg)) == jax_tree_num_params(jdefs) == 334_516_224
    params = T.init_params(cfg, 0, "meta")
    shapes = jax.tree_util.tree_map(lambda d: d.shape, jdefs,
                                    is_leaf=lambda x: hasattr(x, "axes"))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == shapes
    f32 = {"embed", "ln1", "ln2", "ln_x", "final_norm", "enc_final_norm"}
    for path, t in jax.tree_util.tree_leaves_with_path(params):
        want = torch.float32 if path[-1].key in f32 else torch.bfloat16
        assert t.dtype == want, jax.tree_util.keystr(path)
    assert sum(t.numel() * t.element_size() for t in tree_leaves(params)) == 748_792_320
    pool = T.paged_cache_defs(cfg, 8, 513, 16, 64)
    assert pool["self"]["k"].shape == (12, 513, 16, 12, 64)
    assert pool["cross"]["v"].shape == (12, 8, 1500, 12, 64)


def test_param_conversion_roundtrip_and_f32_leaves():
    """A JAX tree goes into the port and back bit-equal; under bf16 ln_x and
    enc_final_norm, perturbed to values bf16 cannot hold, keep float32."""
    _, jparams, _, params = make()
    back = model_params_to_numpy(params)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
                           back, jparams)
    assert set(back) == {"embed", "final_norm", "lm_head", "encoder", "decoder",
                         "enc_final_norm"}
    _, jparams, _, params = make(compute=jnp.bfloat16)
    for leaf, want in ((params["decoder"]["ln_x"], jparams["decoder"]["ln_x"]),
                       (params["enc_final_norm"], jparams["enc_final_norm"])):
        assert leaf.dtype == torch.float32
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(want))
    assert params["decoder"]["xattn"]["wk"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# layers: cross attention, the encoder, each layer at the reference's init
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("condition", [True, False])
def test_layers_match_jax(condition):
    """Each encoder layer and each decoder layer (self, cross, MLP) on the
    JAX package's own float32 input, within the layer bar: elementwise on
    conditioned weights; with the reference's init as a relative error
    norm (there a near-argmax softmax turns one ulp of a score into ~1e-3
    of a few output elements, 9 of 4,096 in the first encoder layer)."""
    jcfg, jparams, pcfg, params = make(condition=condition)

    def check(got, want):
        if condition:
            close(got, want, FWD_TOL)
        else:
            assert _rel(got, want) <= FWD_TOL
    enc = jnp.asarray(_frames(2))
    epos = jnp.broadcast_to(jnp.arange(SE)[None], (2, SE))
    x = enc
    for i, p in enumerate(T._layers(params["encoder"], 2)):
        jp = jax.tree_util.tree_map(lambda a, i=i: a[i], jparams["encoder"])
        want = x + JL.multi_head_attention(jcfg, jp["attn"], JL.rms_norm(x, jp["ln1"], 1e-6),
                                           epos, causal=False)[0]
        want = want + JL.mlp(jcfg, jp["mlp"], JL.rms_norm(want, jp["ln2"], 1e-6))
        got = T._dense_block(pcfg, p, T_(np.array(x)), T_(np.array(epos)), None, None,
                             causal=False)[0]
        check(got, want)
        x = want
    mem = JL.rms_norm(x, jparams["enc_final_norm"], 1e-6)
    tok = _tokens(2, 11)
    x = JT._embed(jcfg, jparams, jnp.asarray(tok))
    pos = jnp.broadcast_to(jnp.arange(11)[None], (2, 11))
    for i, p in enumerate(T._layers(params["decoder"], 2)):
        jp = jax.tree_util.tree_map(lambda a, i=i: a[i], jparams["decoder"])
        want = x + JL.multi_head_attention(jcfg, jp["attn"], JL.rms_norm(x, jp["ln1"], 1e-6),
                                           pos, causal=True)[0]
        want = want + JL.multi_head_attention(
            jcfg, jp["xattn"], JL.rms_norm(want, jp["ln_x"], 1e-6), pos, kv_x=mem,
            kv_positions=epos, causal=False, use_rope=False)[0]
        want = want + JL.mlp(jcfg, jp["mlp"], JL.rms_norm(want, jp["ln2"], 1e-6))
        got, _ = T._decoder_layer(pcfg, p, T_(np.array(x)), T_(np.array(pos)), None,
                                  T_(np.array(mem)), T_(np.array(epos)))
        check(got, want)
        x = want


def test_cross_attention_matches_jax():
    """Cross attention (no rope, not causal) over an encoder source, and its
    cached form over precomputed K/V (the source not read), in float32."""
    jcfg, jparams, pcfg, params = make()
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["decoder"]["xattn"])
    pp = T._layers(params["decoder"], 2)[1]["xattn"]
    x = np.random.default_rng(1).standard_normal((2, 7, 64)).astype(np.float32)
    enc = _frames(2, 1)
    pos = np.tile(np.arange(7)[None], (2, 1))
    epos = np.tile(np.arange(SE)[None], (2, 1))
    want, _ = JL.multi_head_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                      kv_x=jnp.asarray(enc), kv_positions=jnp.asarray(epos),
                                      causal=False, use_rope=False)
    got, cache = L.multi_head_attention(pcfg, pp, T_(x), T_(pos), kv_x=T_(enc),
                                        kv_positions=T_(epos), causal=False, use_rope=False)
    assert cache is None
    close(got, want, FWD_TOL)
    k = np.einsum("bsd,dhq->bshq", enc, np.asarray(jp["wk"]))
    v = np.einsum("bsd,dhq->bshq", enc, np.asarray(jp["wv"]))
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v), "pos": jnp.int32(0)}
    want, _ = JL.multi_head_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                      kv_x=jnp.zeros((2, 1, 64)), kv_positions=jnp.asarray(epos),
                                      causal=False, use_rope=False, cache=jc)
    pc = {"k": T_(k), "v": T_(v)}
    got, back = L.multi_head_attention(pcfg, pp, T_(x), T_(pos), kv_x=T_(x),
                                       kv_positions=T_(epos), causal=False, use_rope=False,
                                       cache=pc)
    assert back is pc
    close(got, want, FWD_TOL)


@pytest.mark.parametrize("route", ["jnp", "auto"])
def test_encoder_matches_jax(route):
    """The encoder (rope self-attention, not causal; on the kernel route the
    flash plain version's non-causal mode) and enc_final_norm."""
    jcfg, jparams, pcfg, params = make(port_over={"attention_kernel": route})
    enc = _frames(2)
    close(T._encode(pcfg, params, T_(enc)), JT._encode(jcfg, jparams, jnp.asarray(enc)),
          MODEL_TOL)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

ROUTES = {"jnp": ("jnp", "jnp"), "oracle": ("off", "off"), "kernel": ("interpret", "auto")}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_forward_matches_jax(route):
    jmode, pmode = ROUTES[route]
    jcfg, jparams, pcfg, params = make(jax_over={"attention_kernel": jmode},
                                       port_over={"attention_kernel": pmode})
    tok, enc = _tokens(2, 21), _frames(2)
    got = T.forward(pcfg, params, T_(tok), enc_embeds=T_(enc))
    assert got.shape == (2, 21, 256) and got.dtype == torch.float32
    close(got, JT.forward(jcfg, jparams, jnp.asarray(tok), enc_embeds=jnp.asarray(enc)),
          MODEL_TOL)
    with pytest.raises(ValueError, match="enc_embeds"):
        T.forward(pcfg, params, T_(tok))


def test_forward_calls_flash_per_self_attention():
    """On the kernel route each encoder layer makes one non-causal flash call
    (S = Sk = the frames) and each decoder layer one causal call; cross
    attention makes none."""
    _, _, pcfg, params = make(port_over={"attention_kernel": "auto"})
    seen = []
    real = ops.dispatch

    def spy(name, *args, **kw):
        if name == "flash_attention":
            seen.append((tuple(args[0].shape), tuple(args[1].shape), kw["causal"]))
        return real(name, *args, **kw)

    ops.dispatch = spy
    try:
        T.forward(pcfg, params, T_(_tokens(2, 9)), enc_embeds=T_(_frames(2)))
    finally:
        ops.dispatch = real
    assert seen == [((2, 4, SE, 16), (2, 4, SE, 16), False)] * 2 + \
        [((2, 4, 9, 16), (2, 4, 9, 16), True)] * 2


def test_bf16_forward_matches_jax():
    jcfg, jparams, pcfg, params = make(compute=jnp.bfloat16)
    tok, enc = _tokens(2, 21, seed=1), _frames(2, 1)
    got = T.forward(pcfg, params, T_(tok), enc_embeds=T_(enc))
    want = JT.forward(jcfg, jparams, jnp.asarray(tok), enc_embeds=jnp.asarray(enc))
    assert _rel(got, want) <= BF16_TOL


def test_local_grads_match_jax():
    """Loss and every leaf's gradient (encoder, decoder, xattn, ln_x,
    enc_final_norm) with enc_embeds in the batch and the flash kernel's
    route on both sides."""
    jcfg, jparams, pcfg, params = make(jax_over={"attention_kernel": "interpret"},
                                       port_over={"attention_kernel": "auto"})
    toks = _tokens(2, 17, seed=2)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "enc_embeds": _frames(2, 2)}
    jl, jg = jax.jit(lambda p, b: JS.local_grads(jcfg, JS.TrainConfig(), p, b))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = local_grads(pcfg, TrainConfig(), params, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    mine = model_params_to_numpy(grads)
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        assert np.abs(want).max() > 0, jax.tree_util.keystr(path)
        np.testing.assert_allclose(np.asarray(_leaf(mine, path), np.float64),
                                   np.asarray(want, np.float64), rtol=GRAD_TOL, atol=GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_remat_and_train_step():
    """remat "full" (whisper's default) checkpoints every encoder and decoder
    layer: the same loss and gradients as "none", each self-attention's
    flash forward called twice and its backward once; two microbatches
    split enc_embeds with the tokens; a train_step's loss is that loss."""
    cfg = dataclasses.replace(C.get_reduced(ARCH), compute_dtype=torch.float32)
    state = init_train_state(cfg, TrainConfig(), 0, "cpu")
    toks = _tokens(2, 13, seed=3)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:], "enc_embeds": _frames(2, 3)}
    l0, g0 = local_grads(cfg, TrainConfig(), state["params"], batch)
    full = dataclasses.replace(cfg, remat="full")
    n = cfg.n_layers + cfg.n_encoder_layers
    with ops.held_to_plain("flash_attention") as fwd, \
            ops.held_to_plain("flash_attention_bwd") as bwd:
        l1, g1 = local_grads(full, TrainConfig(), state["params"], batch)
    assert (len(fwd), len(bwd)) == (2 * n, n)
    assert float(l0) == float(l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    l2, g2 = local_grads(cfg, TrainConfig(microbatches=2), state["params"], batch)
    np.testing.assert_allclose(float(l2), float(l0), rtol=1e-5)
    for a, b in zip(tree_leaves(g0), tree_leaves(g2)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)
    before = state["params"]["decoder"]["xattn"]["wk"].clone()
    state, metrics = train_step(full, TrainConfig(), state, batch)
    assert float(metrics["loss"]) == float(l0)
    assert not torch.equal(before, state["params"]["decoder"]["xattn"]["wk"])


# ---------------------------------------------------------------------------
# decode: the cross cache, the contiguous cache, the pool, the scheduler
# ---------------------------------------------------------------------------

def test_encode_cross_cache_matches_jax():
    jcfg, jparams, pcfg, params = make()
    enc = _frames(3, 4)
    want = JT.encode_cross_cache(jcfg, jparams, jnp.asarray(enc), 3)
    got = T.encode_cross_cache(pcfg, params, T_(enc), 3)
    assert got["k"].shape == (2, 3, SE, 4, 16)
    for k in ("k", "v"):
        close(got[k], want[k], MODEL_TOL)


def test_prefill_and_contiguous_decode_match_jax():
    """The cross cache from encode_cross_cache, a right-padded prefill (pos
    advances by the padded S), then 4 decode steps: logits and the self
    and cross caches."""
    jcfg, jparams, pcfg, params = make()
    tok, enc = _tokens(3, 16, seed=4), _frames(3, 4)
    valid = np.array([16, 5, 11], np.int32)
    jc = JT.init_cache(jcfg, 3, 24)
    jc["cross"] = JT.encode_cross_cache(jcfg, jparams, jnp.asarray(enc), 3)
    jc, jl = JT.prefill(jcfg, jparams, jnp.asarray(tok), jc, valid_len=jnp.asarray(valid))
    pc = T.init_cache(pcfg, 3, 24, "cpu")
    assert set(pc) == {"self", "cross"} and pc["self"]["pos"] == 0
    pc["cross"] = T.encode_cross_cache(pcfg, params, T_(enc), 3)
    pc, pl = T.prefill(pcfg, params, T_(tok), pc, valid_len=T_(valid))
    assert pc["self"]["pos"] == 16
    for _ in range(4):
        close(pl, jl, MODEL_TOL)
        for part in ("self", "cross"):
            for k in ("k", "v"):
                close(pc[part][k], jc[part][k], MODEL_TOL)
        nxt = np.array(jnp.argmax(jl, -1))[:, None]
        jc, jl = JT.decode_step(jcfg, jparams, jnp.asarray(nxt), jc)
        pc, pl = T.decode_step(pcfg, params, T_(nxt), pc)
    close(pl, jl, MODEL_TOL)


def test_generate_matches_jax():
    """The contiguous generate with enc_embeds: greedy tokens equal the JAX
    package's generate; without enc_embeds it raises as the JAX one does."""
    jcfg, jparams, pcfg, params = make()
    tok, enc = _tokens(2, 6, seed=5), _frames(2, 5)
    want = JE.generate(jcfg, jparams, jnp.asarray(tok), max_new_tokens=5,
                       enc_embeds=jnp.asarray(enc))
    got = generate(pcfg, params, T_(tok), max_new_tokens=5, enc_embeds=T_(enc))
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))
    with pytest.raises(ValueError, match="enc_embeds"):
        generate(pcfg, params, T_(tok), max_new_tokens=2)


def test_scheduler_paged_decode_matches_jax_contiguous():
    """The port's Scheduler (the decoder's K/V pages, per-slot cross K/V
    written at admission) against the JAX contiguous prefill + decode_step
    of each request (greedy), each with its own frames: the same tokens,
    one request's first decode-step logits within the model bar (not the
    JAX paged path: ROADMAP Queue 3), one decode_attention call a decoder
    layer a step, the pools never reallocated."""
    jcfg, jparams, pcfg, params = make()
    rng = np.random.default_rng(5)
    reqs = [Request(i, rng.integers(0, 256, int(rng.integers(3, 16))), int(rng.integers(2, 9)),
                    enc_embeds=_frames(1, 10 + i)[0]) for i in range(6)]
    want, first = {}, None
    for r in reqs:
        c = JT.init_cache(jcfg, 1, 32)
        c["cross"] = JT.encode_cross_cache(jcfg, jparams, jnp.asarray(r.enc_embeds)[None], 1)
        c, lg = JT.prefill(jcfg, jparams, jnp.asarray(r.tokens)[None], c)
        toks = [int(jnp.argmax(lg[0]))]
        for step in range(r.max_new_tokens - 1):
            c, lg = JT.decode_step(jcfg, jparams, jnp.asarray([[toks[-1]]]), c)
            if r.rid == 2 and step == 0:
                first = np.asarray(lg[0])
            toks.append(int(jnp.argmax(lg[0])))
        want[r.rid] = toks
    sch = Scheduler(pcfg, params, PoolConfig(max_batch=4, block_size=4, n_blocks=12,
                                             max_len=32, prompt_pad=16), device="cpu")
    ptrs = sch.pool.data_ptrs()
    assert ptrs.keys() == {"self", "cross"} and sch.pool.paged
    with pytest.raises(ValueError, match="enc_embeds"):
        sch.submit(Request(99, np.arange(1, 4), 2))
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
    assert sch.pool.data_ptrs() == ptrs and set(calls) == {pcfg.n_layers}
    assert stats.peak_occupancy > 0 and sch.pool.used_page_count == 0


def test_cache_pool_writes_cross_rows_and_pages():
    """write_prefill overwrites the slot's cross K/V rows (never adds to
    them) and lands the decoder's K/V on the slot's pages; release keeps
    the cross rows; gather_kv raises, as the JAX package reads back no
    encdec pages."""
    cfg = C.get_reduced(ARCH)
    pool = CachePool(cfg, PoolConfig(max_batch=3, block_size=4, n_blocks=6, max_len=16,
                                     prompt_pad=8), "cpu")
    assert pool.paged and pool.pages_needed(5) == 2
    pool.alloc_slot()
    slot = pool.alloc_slot()
    assert pool.ensure(slot, 5)
    pages = list(pool.table[slot, :2])
    for value in (2.0, -1.0):
        cache = T.init_cache(cfg, 1, 8, "cpu")
        for k in ("k", "v"):
            cache["cross"][k].fill_(value)
            cache["self"][k].copy_(torch.arange(8, dtype=torch.float32)[None, None, :, None,
                                                                        None] + value)
        pool.write_prefill(slot, cache)
        for k in ("k", "v"):
            assert torch.all(pool.pools["cross"][k][:, slot] == value)
            assert torch.all(pool.pools["cross"][k][:, slot - 1] == 0)
            got = pool.pools["self"][k][:, pages].reshape(2, 8, 4, 16)
            assert torch.equal(got, cache["self"][k][:, 0])
    pool.release(slot)
    assert torch.all(pool.pools["cross"]["k"][:, slot] == -1.0)
    with pytest.raises(ValueError, match="no K/V pages"):
        pool.gather_kv(slot, 4)


def test_serve_launcher_runs_the_encdec_family(capsys):
    """launch/serve.py --arch whisper-small on the CPU (reduced): random
    frames a request, batches served."""
    serve_launcher.main(["--arch", "whisper-small", "--device", "cpu", "--requests", "3",
                         "--batch", "2", "--prompt-len", "5", "--tokens", "3",
                         "--temperature", "0"])
    out = capsys.readouterr().out
    assert "batch 1: 1 reqs" in out and "served 3 requests" in out
