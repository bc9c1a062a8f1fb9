"""The port's dense model family against the JAX package.

Both packages run one set of weights: the JAX ``tree_materialize`` draws
them, numpy carries them, ``convert.model_params_from_numpy`` loads them.
Sizes are minitron-8b's ``reduced()`` (2 layers, d_model 64, GQA 4/2,
head_dim 16, vocab 256); nothing at full width runs here (full-width
shapes are checked on the meta device).

Bars, each with its reason:
  * a layer in float32: 2e-5 (the kernel registry's f32 bar; one matmul
    chain summed in another order by XLA and by PyTorch);
  * model logits in float32: 1e-4 (two layers plus the head: several f32
    matmul chains in another summation order; the JAX package's own
    kernel-vs-jnp routing drifts 4.2e-6 on this container, so nothing
    below ~1e-5 holds);
  * bfloat16: the registry's 2e-2 bar. A layer is held to it elementwise.
    Whole-model logits are held to it as a relative error norm: the two
    frameworks round at other places (XLA's bf16 silu differs from
    PyTorch's by one ulp on some elements), and a one-ulp change of the
    bf16 residual stream (0.03 at its magnitude of ~8) moves single logits
    by up to ~0.09, so elementwise agreement is held in float32 only.
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
from repro_torch import configs as C
from repro_torch.convert import model_params_from_numpy, model_params_to_numpy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_leaves, tree_num_params
from repro_torch.serve import CachePool, PoolConfig

LAYER_TOL = 2e-5
MODEL_TOL = 1e-4
BF16_TOL = 2e-2
_DT = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def port_config(jcfg, **over) -> ModelConfig:
    """The port's ModelConfig with every field of a JAX one (dtypes mapped)."""
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for name in ("param_dtype", "compute_dtype"):
        fields[name] = _DT[fields[name]]
    fields.update(over)
    return ModelConfig(**fields)


def make(compute=jnp.float32, jax_over=None, port_over=None, **shared):
    """(jax cfg, jax params, port cfg, port params) with one set of weights."""
    jcfg = dataclasses.replace(jax_get_reduced("minitron_8b"), compute_dtype=compute,
                               **shared, **(jax_over or {}))
    jparams = jax_tree_materialize(JT.model_defs(jcfg), jax.random.PRNGKey(0),
                                   jcfg.param_dtype)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    pcfg = port_config(jcfg, **(port_over or {}))
    return jcfg, jparams, pcfg, model_params_from_numpy(pcfg, tree, "cpu")


def close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(torch.as_tensor(got).float().numpy() if isinstance(got, torch.Tensor)
                   else got, np.float64),
        np.asarray(np.asarray(want, np.float32), np.float64), rtol=tol, atol=tol)


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s))


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "reduced"])
def test_config_copies_every_jax_field(which):
    jcfg = (jax_get_config if which == "full" else jax_get_reduced)("minitron-8b")
    mine = (C.get_config if which == "full" else C.get_reduced)("minitron-8b")
    assert mine == port_config(jcfg)
    assert mine.param_count() == jcfg.param_count()


def test_registry_names_every_arch_and_ports_only_minitron():
    from repro.configs import ALIASES, ARCH_IDS

    assert C.ARCH_IDS == ARCH_IDS and C.ALIASES == ALIASES
    assert C.PORTED == ("minitron_8b", "gemma2_2b", "mamba2_1p3b")
    for arch in ARCH_IDS:
        if arch in C.PORTED:
            continue
        with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
            C.get_config(arch)
        with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
            C.get_reduced(arch)
    with pytest.raises(KeyError):
        C.get_config("no-such-model")


def test_full_width_parameters_on_meta():
    """minitron-8b at full width: shapes equal the JAX tree's, matrix weights
    held in bf16, embed and norms in f32 (~21.9 GB), without allocating."""
    cfg = C.get_config("minitron-8b")
    params = T.init_params(cfg, 0, "meta")
    jdefs = JT.model_defs(jax_get_config("minitron-8b"))
    shapes = jax.tree_util.tree_map(lambda d: d.shape, jdefs,
                                    is_leaf=lambda x: hasattr(x, "axes"))
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), params) == shapes
    # the analytic count leaves out the norm scales (65 vectors of 4096)
    assert tree_num_params(T.model_defs(cfg)) == jax_tree_num_params(jdefs) == 9_882_046_464
    assert cfg.param_count() == 9_881_780_224
    f32 = {"embed", "ln1", "ln2", "final_norm"}
    for path_key, t in _flat(params):
        want = torch.float32 if path_key in f32 else torch.bfloat16
        assert t.dtype == want, path_key
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    assert nbytes == 21_861_777_408
    pool = T.paged_cache_defs(cfg, 8, 513, 16, 64)["k"]
    per_token = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 2
    assert per_token == 128 * 1024 and pool.shape == (32, 513, 16, 8, 128)


def _flat(tree, key=None):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, k)
    else:
        yield key, tree


def test_param_conversion_roundtrip_and_checks():
    _, jparams, pcfg, params = make()
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    back = model_params_to_numpy(params)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back, tree)
    bad = dict(tree, final_norm=np.ones(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        model_params_from_numpy(pcfg, bad, "cpu")
    with pytest.raises(ValueError, match="keys"):
        model_params_from_numpy(pcfg, {k: v for k, v in tree.items() if k != "lm_head"},
                                "cpu")


def test_unported_family_and_interpret_mode_raise():
    cfg = dataclasses.replace(C.get_reduced("minitron-8b"), family="moe")
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        T.model_defs(cfg)
    with pytest.raises(ValueError, match="interpret"):
        dataclasses.replace(cfg, decode_kernel="interpret")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norm_rope_softcap_match_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 1000, (2, 5))
    close(L.rms_norm(torch.as_tensor(x), torch.as_tensor(scale), 1e-6),
          JL.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6), LAYER_TOL)
    close(L.rope(torch.as_tensor(x), torch.as_tensor(pos), 10_000.0),
          JL.rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0), LAYER_TOL)
    close(L.softcap(torch.as_tensor(x) * 40, 30.0),
          JL.softcap(jnp.asarray(x) * 40, 30.0), LAYER_TOL)


def test_mlp_matches_jax():
    jcfg, jparams, pcfg, params = make()
    x = np.random.default_rng(2).standard_normal((2, 7, 64)).astype(np.float32)
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["mlp"])
    got = L.mlp(pcfg, T._layers(params["blocks"], 2)[0]["mlp"], torch.as_tensor(x))
    close(got, JL.mlp(jcfg, jp, jnp.asarray(x)), LAYER_TOL)


@pytest.mark.parametrize("route", ["jnp", "off"])
@pytest.mark.parametrize("window", [None, 5])
def test_attention_layer_matches_jax(route, window):
    jcfg, jparams, pcfg, params = make(attention_kernel=route, attn_softcap=30.0)
    S = 13
    x = np.random.default_rng(3).standard_normal((2, S, 64)).astype(np.float32)
    pos = np.tile(np.arange(S)[None], (2, 1))
    jp = jax.tree_util.tree_map(lambda a: a[1], jparams["blocks"]["attn"])
    want, _ = JL.multi_head_attention(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                      window=window)
    got, _ = L.multi_head_attention(pcfg, T._layers(params["blocks"], 2)[1]["attn"],
                                    torch.as_tensor(x), torch.as_tensor(pos), window=window)
    close(got, want, LAYER_TOL)


# ---------------------------------------------------------------------------
# the model: forward, prefill, decode
# ---------------------------------------------------------------------------

# JAX route -> port route: the inline path, the registry's plain version,
# and the Pallas kernel in interpret mode against the port's "auto"
ROUTES = {"jnp": ("jnp", "jnp"), "oracle": ("off", "off"), "pallas": ("interpret", "auto")}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_forward_matches_jax(route):
    jmode, pmode = ROUTES[route]
    jcfg, jparams, pcfg, params = make(jax_over={"attention_kernel": jmode},
                                       port_over={"attention_kernel": pmode})
    tok = _tokens(2, 21, jcfg.vocab_size)
    want = JT.forward(jcfg, jparams, jnp.asarray(tok))
    got = T.forward(pcfg, params, torch.as_tensor(tok))
    assert got.shape == (2, 21, jcfg.vocab_size) and got.dtype == torch.float32
    close(got, want, MODEL_TOL)


def test_forward_windowed_softcapped_matches_jax():
    """The dense path's window schedule (local/global pairs) and softcaps."""
    jcfg, jparams, pcfg, params = make(sliding_window=6, local_global=True,
                                       attn_softcap=50.0, final_softcap=30.0)
    tok = _tokens(1, 19, jcfg.vocab_size, seed=4)
    close(T.forward(pcfg, params, torch.as_tensor(tok)),
          JT.forward(jcfg, jparams, jnp.asarray(tok)), MODEL_TOL)


def test_bf16_layers_and_forward_match_jax():
    jcfg, jparams, pcfg, params = make(compute=jnp.bfloat16)
    assert params["blocks"]["mlp"]["wg"].dtype == torch.bfloat16
    assert params["embed"].dtype == torch.float32
    x = np.random.default_rng(9).standard_normal((2, 16, 64)).astype(np.float32)
    xb, xt = jnp.asarray(x).astype(jnp.bfloat16), torch.as_tensor(x).to(torch.bfloat16)
    pos = np.tile(np.arange(16)[None], (2, 1))
    jl = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"])
    tl = T._layers(params["blocks"], 2)[0]
    close(L.mlp(pcfg, tl["mlp"], xt), JL.mlp(jcfg, jl["mlp"], xb).astype(jnp.float32),
          BF16_TOL)
    got, _ = L.multi_head_attention(pcfg, tl["attn"], xt, torch.as_tensor(pos))
    want, _ = JL.multi_head_attention(jcfg, jl["attn"], xb, jnp.asarray(pos))
    close(got, want.astype(jnp.float32), BF16_TOL)
    tok = _tokens(2, 16, jcfg.vocab_size, seed=5)
    got = T.forward(pcfg, params, torch.as_tensor(tok)).numpy().astype(np.float64)
    want = np.asarray(JT.forward(jcfg, jparams, jnp.asarray(tok)), np.float64)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= BF16_TOL


def test_prefill_valid_len_matches_jax():
    jcfg, jparams, pcfg, params = make()
    tok = _tokens(3, 16, jcfg.vocab_size, seed=6)
    valid = np.array([16, 5, 11], np.int32)
    jc, jl = JT.prefill(jcfg, jparams, jnp.asarray(tok), JT.init_cache(jcfg, 3, 20),
                        valid_len=jnp.asarray(valid))
    pc, pl = T.prefill(pcfg, params, torch.as_tensor(tok), T.init_cache(pcfg, 3, 20, "cpu"),
                       valid_len=torch.as_tensor(valid))
    close(pl, jl, MODEL_TOL)
    assert pc["pos"] == int(jc["pos"]) == 16
    close(pc["k"], jc["k"], MODEL_TOL)
    close(pc["v"], jc["v"], MODEL_TOL)


def test_contiguous_decode_matches_jax():
    jcfg, jparams, pcfg, params = make()
    tok = _tokens(2, 9, jcfg.vocab_size, seed=7)
    jc, jl = JT.prefill(jcfg, jparams, jnp.asarray(tok), JT.init_cache(jcfg, 2, 14))
    pc, pl = T.prefill(pcfg, params, torch.as_tensor(tok), T.init_cache(pcfg, 2, 14, "cpu"))
    for _ in range(4):
        close(pl, jl, MODEL_TOL)
        nxt = np.asarray(jnp.argmax(jl, -1))[:, None]
        jc, jl = JT.decode_step(jcfg, jparams, jnp.asarray(nxt), jc)
        pc, pl = T.decode_step(pcfg, params, torch.as_tensor(nxt), pc)
    close(pl, jl, MODEL_TOL)


# paged-decode variants: GQA, MQA, and the window schedule with softcaps
PAGED = {
    "gqa": {},
    "mqa": {"n_kv_heads": 1},
    "windowed": {"sliding_window": 6, "local_global": True, "attn_softcap": 50.0,
                 "final_softcap": 30.0},
}


@pytest.mark.parametrize("variant", sorted(PAGED))
def test_paged_decode_matches_jax_contiguous(variant):
    """The port's paged decode (pool + block table, ``decode_attention``)
    against the JAX package's contiguous prefill + decode_step on the same
    prompt (not against the JAX paged path: see ROADMAP Queue 3)."""
    jcfg, jparams, pcfg, params = make(**PAGED[variant])
    plen, n_new = 11, 6  # a prompt that is not a page multiple
    tok = _tokens(1, plen, jcfg.vocab_size, seed=8)
    cache = JT.init_cache(jcfg, 1, plen + n_new)
    cache, lg = JT.prefill(jcfg, jparams, jnp.asarray(tok), cache)
    want, toks = [np.asarray(lg)[0]], [int(np.argmax(lg[0]))]
    for _ in range(n_new - 1):
        cache, lg = JT.decode_step(jcfg, jparams, jnp.asarray([[toks[-1]]]), cache)
        want.append(np.asarray(lg)[0])
        toks.append(int(np.argmax(want[-1])))

    pcfg_ = PoolConfig(max_batch=3, block_size=4, n_blocks=12, max_len=24, prompt_pad=16)
    pool = CachePool(pcfg, pcfg_, "cpu")
    pool.alloc_slot()  # slot 0 stays a padding lane: length 0, null table
    slot = pool.alloc_slot()
    assert pool.ensure(slot, plen)
    padded = np.zeros((1, pcfg_.prompt_pad), np.int64)
    padded[0, :plen] = tok[0]
    pc, lg = T.prefill(pcfg, params, torch.as_tensor(padded),
                       T.init_cache(pcfg, 1, pcfg_.prompt_pad, "cpu"),
                       valid_len=torch.tensor([plen]))
    pool.write_prefill(slot, pc)
    pool.set_length(slot, plen)
    got = [lg[0].numpy()]
    ptrs = pool.data_ptrs()
    for t in toks[:-1]:
        assert pool.ensure(slot, int(pool.lengths[slot]) + 1)
        batch_tok = np.zeros((pcfg_.max_batch, 1), np.int64)
        batch_tok[slot, 0] = t
        _, lg = T.decode_step_paged(pcfg, params, torch.as_tensor(batch_tok), pool.pools,
                                    pool.device_table(), pool.device_lengths())
        pool.bump_lengths([slot])
        got.append(lg[slot].numpy())
    close(np.stack(got), np.stack(want), MODEL_TOL)
    assert pool.data_ptrs() == ptrs  # written in place, never reallocated
    kv = pool.gather_kv(slot, plen + n_new - 1)
    close(kv["k"][:, :, None][:, :, 0], np.asarray(cache["k"])[:, 0, :plen + n_new - 1],
          MODEL_TOL)
