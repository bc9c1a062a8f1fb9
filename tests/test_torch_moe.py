"""The port's moe family (qwen2-moe-a2.7b, kimi-k2) against the JAX package.

Both packages take the same numpy inputs and one set of weights, drawn by
the JAX ``tree_materialize`` and carried over with
``convert.model_params_from_numpy``. Sizes: the configs' ``reduced()`` (2
layers at d_model 64, 8 experts top-2 of d_ff 32, a shared expert;
qwen2-moe MHA 4/4 with qkv biases, kimi-k2 GQA 4/2; vocab 256). Their
``capacity_factor`` is 8.0 (dropless); the routing tests also run at a
capacity small enough that tokens drop. Nothing at full width runs here
(its parameters are checked on the meta device). Where the JAX function
reaches a Pallas kernel it runs in interpret mode, as the JAX package's own
tests run it on the CPU.

The JAX package exposes no routing decision, so ``_jax_scatter_slots`` and
``_jax_grouped_slots`` compute it with the reference's own lines
(``repro/models/layers.py:533-545`` and ``:476-494``) on the JAX side and
the test holds the port's ``scatter_slots``/``grouped_slots`` to them as
integers; the layer and model outputs are then held to the JAX functions
themselves.

Bars (those of test_torch_hybrid.py): a layer in float32 2e-5, model
logits 1e-4, a float32 gradient 2e-4, the loss 1e-5 relative, bfloat16
2e-2 as a relative error norm.
"""
import dataclasses

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
from repro.train import step as JS
from repro_torch import configs as C
from repro_torch.convert import model_params_from_numpy, model_params_to_numpy
from repro_torch.kernels import ops
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
ARCH = "qwen2_moe"
DROPPY = 0.5  # capacity_factor at which the reduced configs drop tokens
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


def make(arch=ARCH, compute=jnp.float32, jax_over=None, port_over=None, **shared):
    """(jax cfg, jax params, port cfg, port params): a reduced moe config
    with one set of weights; qkv biases, norm scales and the router are
    drawn away from their init (0, 1 and a 0.02 scale at which the top-k
    barely depends on the input)."""
    jcfg = dataclasses.replace(jax_get_reduced(arch), compute_dtype=compute, **shared)
    tree = jax.tree_util.tree_map(
        np.asarray, jax_tree_materialize(JT.model_defs(jcfg), jax.random.PRNGKey(0),
                                         jcfg.param_dtype))
    rng = np.random.default_rng(11)
    blk = tree["blocks"]
    for key in ("bq", "bk", "bv"):
        if key in blk["attn"]:
            blk["attn"][key] = rng.standard_normal(blk["attn"][key].shape)
    for leaf, key in ((blk, "ln1"), (blk, "ln2"), (tree, "final_norm")):
        leaf[key] = rng.uniform(0.8, 1.2, leaf[key].shape)
    blk["moe"]["router"] = blk["moe"]["router"] * 25.0
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


def _layer0(jparams, params, n_layers):
    return (jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["moe"]),
            T._layers(params["blocks"], n_layers)[0]["moe"])


# ---------------------------------------------------------------------------
# the reference's routing, on the JAX side (the JAX package returns none)
# ---------------------------------------------------------------------------

def _jax_scatter_slots(cfg, p, x):
    """repro/models/layers.py:524-545: (flat_e, pos, keep) as numpy."""
    dt = cfg.compute_dtype
    B, S, d = x.shape
    T_all = B * S
    E, K = cfg.n_experts, cfg.experts_per_token
    C_ = max(1, int(T_all * K / E * cfg.capacity_factor))
    C_ = -(-C_ // 128) * 128 if C_ > 128 else C_
    logits = (x.reshape(T_all, d) @ p["router"].astype(dt)).astype(jnp.float32)
    _, top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    flat_e = top_i.reshape(-1)
    onehot = jax.nn.one_hot(flat_e, E, dtype=jnp.int32)
    pos = jnp.sum(jnp.cumsum(onehot, axis=0) * onehot, axis=-1) - 1
    return np.asarray(flat_e), np.asarray(pos), np.asarray(pos < C_), C_


def _jax_grouped_slots(cfg, p, x):
    """repro/models/layers.py:471-494: (top_i, pos_k, keep) as numpy."""
    dt = cfg.compute_dtype
    B, S, d = x.shape
    G = JL.math_gcd_groups(cfg.moe_groups, B * S)
    Tg = B * S // G
    E, K = cfg.n_experts, cfg.experts_per_token
    C_ = -(-max(1, int(Tg * K / E * cfg.capacity_factor)) // 8) * 8
    logits = (x.reshape(G, Tg, d) @ p["router"].astype(dt)).astype(jnp.float32)
    _, top_i = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    oh_e = jax.nn.one_hot(top_i, E, dtype=jnp.int32)
    pos = jnp.cumsum(oh_e.reshape(G, Tg * K, E), axis=1).reshape(G, Tg, K, E) * oh_e - 1
    pos_k = pos.max(-1)
    return np.asarray(top_i), np.asarray(pos_k), np.asarray((pos_k >= 0) & (pos_k < C_)), C_


def _kept(e, pos, keep) -> set:
    """{(token, slot, expert, position)} of the kept (token, slot) pairs."""
    e, pos, keep = (np.asarray(a).reshape(-1, np.asarray(a).shape[-1]) for a in (e, pos, keep))
    return {(t, k, int(e[t, k]), int(pos[t, k]))
            for t in range(e.shape[0]) for k in range(e.shape[1]) if keep[t, k]}


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2_moe", "kimi_k2"])
@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_copies_every_jax_field(arch, which):
    jcfg = (jax_get_config if which == "full" else jax_get_reduced)(arch)
    mine = (C.get_config if which == "full" else C.get_reduced)(arch)
    assert mine == port_config(jcfg) and mine.family == "moe"
    assert mine.param_count() == jcfg.param_count()
    assert mine.active_param_count() == jcfg.active_param_count()


def test_full_width_parameters_on_meta():
    """qwen2-moe-a2.7b at full width: shapes equal the JAX tree's; the
    stacked expert leaves hold 24 x 60 x 2048 x 1408 = 4.15e9 elements each
    (past 2^31); matrix weights (router and experts too) in bf16, embed and
    the norm scales in float32: 29.25 GB; the serving pool pages 24 layers
    of MHA 16/16 K/V."""
    cfg = C.get_config("qwen2-moe-a2.7b")
    jdefs = JT.model_defs(jax_get_config("qwen2-moe-a2.7b"))
    assert tree_num_params(T.model_defs(cfg)) == jax_tree_num_params(jdefs) == 14_315_735_040
    params = T.init_params(cfg, 0, "meta")
    shapes = jax.tree_util.tree_map(lambda d: d.shape, jdefs,
                                    is_leaf=lambda x: hasattr(x, "axes"))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == shapes
    moe = params["blocks"]["moe"]
    assert moe["wg"].shape == (24, 60, 2048, 1408) and moe["wg"].numel() > 2 ** 31
    assert moe["shared"]["wd"].shape == (24, 5632, 2048)
    f32 = {"embed", "ln1", "ln2", "final_norm"}
    for path, t in jax.tree_util.tree_leaves_with_path(params):
        want = torch.float32 if path[-1].key in f32 else torch.bfloat16
        assert t.dtype == want, jax.tree_util.keystr(path)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    assert nbytes == 29_254_000_640
    assert T.paged_cache_defs(cfg, 8, 513, 16, 64)["k"].shape == (24, 513, 16, 16, 128)


def test_chunked_draw_matches_one_draw():
    """A stacked expert leaf is drawn in chunks along its first axis (at
    full width one layer, 173 M float32 draws, a chunk: the 4.15e9-element
    leaf never exists in float32), each chunk cast to the storage dtype:
    bit-equal to one float32 draw cast at once, at a small stand-in shape.
    ``chip_smoke.py --moe`` draws the full-width leaves on the card."""
    d = L.moe_defs(dataclasses.replace(C.get_reduced(ARCH), n_experts=3))["wg"]
    gen = torch.Generator().manual_seed(3)
    chunked = d.materialize(gen, torch.float32, "cpu", torch.bfloat16)
    gen = torch.Generator().manual_seed(3)
    whole = (d.stddev * torch.randn(d.shape, generator=gen)).bfloat16()
    assert chunked.dtype == torch.bfloat16 and torch.equal(chunked, whole)


def test_param_conversion_roundtrip():
    _, jparams, pcfg, params = make()
    back = model_params_to_numpy(params)
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(a, np.asarray(b)),
                           back, jparams)
    assert set(back["blocks"]["moe"]) == {"router", "wg", "wu", "wd", "shared"}
    _, _, _, bf = make(compute=jnp.bfloat16)
    assert bf["blocks"]["moe"]["router"].dtype == torch.bfloat16
    assert bf["blocks"]["ln2"].dtype == torch.float32


# ---------------------------------------------------------------------------
# routing and the layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capacity", [8.0, DROPPY])
@pytest.mark.parametrize("route", ["scatter", "grouped"])
def test_routing_sets_equal_jax(route, capacity):
    """The kept (token, slot, expert, position) sets equal the reference's
    as integers: dropless at the reduced configs' 8.0, some pairs dropped
    at 0.5 (the token-major cumsum decides which)."""
    jcfg, jparams, pcfg, params = make(capacity_factor=capacity,
                                       moe_groups=2 if route == "grouped" else 0)
    jp, pp = _layer0(jparams, params, pcfg.n_layers)
    # 40 tokens a group: 80 pairs over 8 experts, past the grouped route's
    # smallest (8-aligned) capacity
    x = np.random.default_rng(2).standard_normal((2, 40, 64)).astype(np.float32)
    if route == "scatter":
        je, jpos, jkeep, jc = _jax_scatter_slots(jcfg, jp, jnp.asarray(x))
        _, _, e, pos, keep, c = L.scatter_slots(pcfg, pp, T_(x))
        shape = (-1, pcfg.experts_per_token)
        e, pos, keep = e.reshape(shape), pos.reshape(shape), keep.reshape(shape)
        je, jpos, jkeep = je.reshape(shape), jpos.reshape(shape), jkeep.reshape(shape)
    else:
        je, jpos, jkeep, jc = _jax_grouped_slots(jcfg, jp, jnp.asarray(x))
        _, _, e, pos, keep, c = L.grouped_slots(pcfg, pp, T_(x))
    assert c == jc
    got, want = _kept(e.numpy(), pos.numpy(), keep.numpy()), _kept(je, jpos, jkeep)
    assert got == want
    n_pairs = 2 * 40 * pcfg.experts_per_token
    assert (len(want) == n_pairs) == (capacity == 8.0)


@pytest.mark.parametrize("capacity", [8.0, DROPPY])
@pytest.mark.parametrize("route", ["scatter", "grouped"])
def test_moe_layer_matches_jax(route, capacity):
    """Both routes of ``layers.moe`` in float32, shared expert included,
    dropless and with drops."""
    jcfg, jparams, pcfg, params = make(capacity_factor=capacity,
                                       moe_groups=2 if route == "grouped" else 0)
    jp, pp = _layer0(jparams, params, pcfg.n_layers)
    x = np.random.default_rng(3).standard_normal((2, 40, 64)).astype(np.float32)
    close(L.moe(pcfg, pp, T_(x)), JL.moe(jcfg, jp, jnp.asarray(x)), FWD_TOL)


def test_router_ties_take_the_lower_index():
    """Router columns tied in pairs give equal probabilities; the port picks
    the lower expert index first, as lax.top_k does, so the routed sets and
    the layer's output equal the JAX package's."""
    jcfg, jparams, pcfg, params = make(capacity_factor=DROPPY)
    tree = model_params_to_numpy(params)
    router = tree["blocks"]["moe"]["router"]
    for a, b in ((1, 6), (2, 3), (0, 7), (4, 5)):
        router[:, :, b] = router[:, :, a]
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    params = model_params_from_numpy(pcfg, tree, "cpu")
    jp, pp = _layer0(jparams, params, pcfg.n_layers)
    x = np.random.default_rng(4).standard_normal((3, 9, 64)).astype(np.float32)
    probs = torch.softmax(T_(x).reshape(-1, 64) @ pp["router"], dim=-1)
    vals, idx = L._top_k(probs, pcfg.experts_per_token)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), pcfg.experts_per_token)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
    # every token's top-2 is a tied pair: the lower index comes first
    assert bool((vals[:, 0] == vals[:, 1]).all()) and bool((idx[:, 0] < idx[:, 1]).all())
    je, jpos, jkeep, _ = _jax_scatter_slots(jcfg, jp, jnp.asarray(x))
    _, _, e, pos, keep, _ = L.scatter_slots(pcfg, pp, T_(x))
    k = pcfg.experts_per_token
    assert (_kept(e.reshape(-1, k).numpy(), pos.reshape(-1, k).numpy(),
                  keep.reshape(-1, k).numpy())
            == _kept(je.reshape(-1, k), jpos.reshape(-1, k), jkeep.reshape(-1, k)))
    close(L.moe(pcfg, pp, T_(x)), JL.moe(jcfg, jp, jnp.asarray(x)), FWD_TOL)


def test_bf16_layer_matches_jax():
    """The scatter route in bf16 on the JAX package's own bf16 input: the
    router logits round to bf16 and tie often, and the tie order keeps the
    routes equal; the output within the bf16 bar."""
    jcfg, jparams, pcfg, params = make(compute=jnp.bfloat16, capacity_factor=DROPPY)
    jp, pp = _layer0(jparams, params, pcfg.n_layers)
    x = jnp.asarray(np.random.default_rng(5).standard_normal((2, 13, 64)), jnp.bfloat16)
    xt = T_(np.array(x.astype(jnp.float32))).bfloat16()
    je, jpos, jkeep, _ = _jax_scatter_slots(jcfg, jp, x)
    _, _, e, pos, keep, _ = L.scatter_slots(pcfg, pp, xt)
    k = pcfg.experts_per_token
    assert (_kept(e.reshape(-1, k).numpy(), pos.reshape(-1, k).numpy(),
                  keep.reshape(-1, k).numpy())
            == _kept(je.reshape(-1, k), jpos.reshape(-1, k), jkeep.reshape(-1, k)))
    assert _rel(L.moe(pcfg, pp, xt), JL.moe(jcfg, jp, x)) <= BF16_TOL


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

ROUTES = {"jnp": ("jnp", "jnp"), "oracle": ("off", "off"), "kernel": ("interpret", "auto")}


@pytest.mark.parametrize("arch", ["qwen2_moe", "kimi_k2"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_forward_matches_jax(arch, route):
    jmode, pmode = ROUTES[route]
    jcfg, jparams, pcfg, params = make(arch, jax_over={"attention_kernel": jmode},
                                       port_over={"attention_kernel": pmode})
    tok = _tokens(2, 21)
    got = T.forward(pcfg, params, T_(tok))
    assert got.shape == (2, 21, 256) and got.dtype == torch.float32
    close(got, JT.forward(jcfg, jparams, jnp.asarray(tok)), MODEL_TOL)


def test_forward_with_drops_matches_jax():
    """At capacity 0.5 a 2 x 21 forward drops pairs in both layers; the
    logits still equal the JAX package's (the same pairs drop)."""
    jcfg, jparams, pcfg, params = make(capacity_factor=DROPPY)
    tok = _tokens(2, 21, seed=6)
    close(T.forward(pcfg, params, T_(tok)), JT.forward(jcfg, jparams, jnp.asarray(tok)),
          MODEL_TOL)


def test_bf16_forward_matches_jax():
    jcfg, jparams, pcfg, params = make(compute=jnp.bfloat16)
    tok = _tokens(2, 21, seed=1)
    assert _rel(T.forward(pcfg, params, T_(tok)),
                JT.forward(jcfg, jparams, jnp.asarray(tok))) <= BF16_TOL


@pytest.mark.parametrize("arch", ["qwen2_moe", "kimi_k2"])
def test_local_grads_match_jax(arch):
    """Loss and every leaf's gradient (router, experts, shared expert, qkv
    biases) with the flash kernel's route on both sides."""
    jcfg, jparams, pcfg, params = make(arch, jax_over={"attention_kernel": "interpret"},
                                       port_over={"attention_kernel": "auto"})
    toks = _tokens(2, 17, seed=2)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
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
    """remat "full" gives the same loss and gradients as "none", each layer's
    flash forward called twice (forward, recompute) and its backward once;
    a train_step's loss is that loss and its update moves the experts."""
    cfg = C.get_reduced(ARCH)
    state = init_train_state(cfg, TrainConfig(), 0, "cpu")
    toks = _tokens(2, 13, seed=3)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    l0, g0 = local_grads(cfg, TrainConfig(), state["params"], batch)
    full = dataclasses.replace(cfg, remat="full")
    with ops.held_to_plain("flash_attention") as fwd, \
            ops.held_to_plain("flash_attention_bwd") as bwd:
        l1, g1 = local_grads(full, TrainConfig(), state["params"], batch)
    assert (len(fwd), len(bwd)) == (2 * cfg.n_layers, cfg.n_layers)
    assert float(l0) == float(l1)
    for a, b in zip(tree_leaves(g0), tree_leaves(g1)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    before = state["params"]["blocks"]["moe"]["wg"].clone()
    state, metrics = train_step(full, TrainConfig(), state, batch)
    assert float(metrics["loss"]) == float(l0)
    assert not torch.equal(before, state["params"]["blocks"]["moe"]["wg"])


# ---------------------------------------------------------------------------
# decode: contiguous cache, the pool, the scheduler
# ---------------------------------------------------------------------------

def test_prefill_and_contiguous_decode_match_jax():
    """Right-padded prefill (pos advances by the padded S), then 4 decode
    steps: logits and K/V."""
    jcfg, jparams, pcfg, params = make()
    tok = _tokens(3, 16, seed=4)
    valid = np.array([16, 5, 11], np.int32)
    jc, jl = JT.prefill(jcfg, jparams, jnp.asarray(tok), JT.init_cache(jcfg, 3, 24),
                        valid_len=jnp.asarray(valid))
    pc, pl = T.prefill(pcfg, params, T_(tok), T.init_cache(pcfg, 3, 24, "cpu"),
                       valid_len=T_(valid))
    assert pc["pos"] == 16
    for _ in range(4):
        close(pl, jl, MODEL_TOL)
        for k in ("k", "v"):
            close(pc[k], jc[k], MODEL_TOL)
        nxt = np.array(jnp.argmax(jl, -1))[:, None]
        jc, jl = JT.decode_step(jcfg, jparams, jnp.asarray(nxt), jc)
        pc, pl = T.decode_step(pcfg, params, T_(nxt), pc)
    close(pl, jl, MODEL_TOL)


def test_scheduler_paged_decode_matches_jax_contiguous():
    """The port's Scheduler (K/V pages, decode_attention a layer a step)
    against the JAX contiguous prefill + decode_step of each request
    (greedy): the same tokens, and one request's first decode-step logits
    within the model bar (not the JAX paged path: ROADMAP Queue 3). The
    pool is small enough to preempt; gather_kv reads the moe pages back."""
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
    sch = Scheduler(pcfg, params, PoolConfig(max_batch=4, block_size=4, n_blocks=12,
                                             max_len=32, prompt_pad=16), device="cpu")
    ptrs = sch.pool.data_ptrs()
    seen, calls = {}, []
    inner = sch.decode_fn

    def decode_fn(*a):
        with ops.held_to_plain("decode_attention") as held:
            out = inner(*a)
        calls.append(len(held))
        for slot, st in sch.active.items():
            if st.req.rid == 2 and len(st.generated) == 1:
                seen["logits"] = out[1][slot].clone()
            if st.req.rid == 1 and len(st.generated) == 2:
                seen["kv"] = sch.pool.gather_kv(slot, len(r.tokens) + 1)
        return out

    r = reqs[1]
    sch.decode_fn = decode_fn
    results, stats = sch.run(reqs)
    for q in reqs:
        assert results[q.rid].tolist() == want[q.rid], q.rid
    close(seen["logits"], first, MODEL_TOL)
    assert sch.pool.data_ptrs() == ptrs and set(calls) == {pcfg.n_layers}
    assert stats.preemptions > 0 and sch.pool.used_page_count == 0
    jc, _ = JT.prefill(jcfg, jparams, jnp.asarray(r.tokens)[None], JT.init_cache(jcfg, 1, 32))
    assert seen["kv"]["k"].shape == (2, len(r.tokens) + 1, 4, 16)
    close(seen["kv"]["k"][:, :len(r.tokens)], np.asarray(jc["k"])[:, 0, :len(r.tokens)],
          MODEL_TOL)
    gen = generate(pcfg, params, T_(r.tokens)[None], max_new_tokens=r.max_new_tokens)
    assert gen.tokens[0].tolist() == want[r.rid]


def test_cache_pool_pages_the_moe_family():
    cfg = C.get_reduced("kimi_k2")
    pool = CachePool(cfg, PoolConfig(max_batch=2, block_size=4, n_blocks=6, max_len=16,
                                     prompt_pad=8), "cpu")
    assert pool.paged and pool.pages_needed(5) == 2
    assert pool.pools["k"].shape == (2, 6, 4, 2, 16)


def test_chip_smoke_route_helpers():
    """chip_smoke's route_log records one (experts, kept) pair a moe call;
    route_summary counts the dropped pairs as scatter_slots keeps them, and
    route_flips counts nothing between two identical passes and the
    changed pairs of a perturbed one."""
    import chip_smoke

    cfg = dataclasses.replace(C.get_reduced(ARCH), capacity_factor=DROPPY,
                              compute_dtype=torch.float32)
    params = T.init_params(cfg, 0, "cpu")
    tok = T_(_tokens(2, 40, seed=7))
    with chip_smoke.route_log() as a:
        T.forward(cfg, params, tok)
    with chip_smoke.route_log() as b:
        T.forward(cfg, params, tok)
    assert L.scatter_slots.__name__ == "scatter_slots" and len(a) == cfg.n_layers
    summary = chip_smoke.route_summary(a)
    assert summary["pairs"] == cfg.n_layers * 80 * cfg.experts_per_token
    assert summary["dropped"] == sum(int((~k).sum()) for _, k in a) > 0
    assert chip_smoke.route_flips(a, b) == {"expert_flips": 0, "kept_flips": 0,
                                            "first_layer_with_a_flip": None}
    e, k = b[1]
    b[1] = (torch.roll(e, 1), k)
    flips = chip_smoke.route_flips(a, b)
    assert flips["first_layer_with_a_flip"] == 1 and flips["expert_flips"] > 0
