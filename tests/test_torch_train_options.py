"""The port's training options against the JAX package: bf16 training state
(bf16 parameters, float32 or bf16 moments), blockwise attention and the
"dots" remat policy; and checkpoints of bf16 leaves.

Weights come from the JAX ``tree_materialize`` and reach the port as numpy;
tokens and frames from numpy seeds. Sizes are the reduced configs (2
layers, d_model 64), B = 2, S = 20 with ``attention_block_k = 8``, so the
last key block is padded. Bars, each with its reason:
  * blockwise logits, port vs JAX, float32 compute: 1e-4, and gradients
    rtol 2e-4 / atol 2e-5 (the reference's tests/test_blockwise_attention.py
    bars: several float32 product chains summed in another order). whisper's
    attention is conditioned as in test_torch_encdec.py: at the reference's
    init its near-argmax layers amplify a float32 ulp past 1e-4;
  * blockwise against the port's plain path and the flash plain version:
    the same bars (the same function, other summation orders);
  * the key blocks a cache's fill level leaves out: bit-equal (skipping
    them is exact, ``layers._blockwise_attention`` says why);
  * bf16 state after 3 steps, the gradients shared: every parameter and
    moment within one bf16 ulp of the JAX package's (a value at a rounding
    boundary may round the other way; ``_ulps`` says how the remainder of a
    cancellation is measured), the share of bit-equal elements reported
    (the test says why each package's own gradients cannot be held so);
  * "dots" against "none": bit-equal gradients (the same products in the
    same order; only what is saved for the backward differs);
  * checkpoints: bit-equal, and the bf16 files byte-equal to the JAX
    package's.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.ckpt import save_checkpoint as jax_save
from repro.configs import get_reduced as jax_get_reduced
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.params import tree_materialize as jax_tree_materialize
from repro.optim import adam as JA
from repro.train import step as JS
from repro_torch.ckpt import CheckpointManager, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_reduced
from repro_torch.convert import model_params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.step import TrainConfig, init_train_state, local_grads, loss_fn, train_step
from test_torch_encdec import _frames
from test_torch_encdec import make as encdec_make
from test_torch_models import port_config

MODEL_TOL = 1e-4
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5
BLK = {"blockwise_attention": True, "attention_block_k": 8}
ARCHS = ["minitron_8b", "gemma2_2b", "qwen2_72b", "qwen2_moe", "whisper_small", "zamba2_1p2b"]
_DT = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
T_ = torch.as_tensor


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """torch's CPU kernels on one thread per test, beside JAX in the same
    process (test_torch_ssm.py says why)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make(arch, **over):
    """(jax cfg, jax params, port cfg, port params): reduced `arch` in
    float32 with blockwise attention (``over`` replaces fields of both
    configs), one set of weights; qkv biases drawn nonzero."""
    if arch == "whisper_small":
        return encdec_make(condition=True, **{**BLK, **over})
    jcfg = dataclasses.replace(jax_get_reduced(arch), compute_dtype=jnp.float32,
                               **{**BLK, **over})
    tree = jax.tree_util.tree_map(
        np.asarray, jax_tree_materialize(JT.model_defs(jcfg), jax.random.PRNGKey(0),
                                         jcfg.param_dtype))
    rng = np.random.default_rng(7)

    def biases(t):
        for key, val in t.items():
            if isinstance(val, dict):
                biases(val)
            elif key in ("bq", "bk", "bv"):
                t[key] = (0.1 * rng.standard_normal(val.shape)).astype(np.float32)

    biases(tree)
    pcfg = port_config(jcfg)
    return (jcfg, jax.tree_util.tree_map(jnp.asarray, tree), pcfg,
            model_params_from_numpy(pcfg, tree, "cpu"))


def _inputs(cfg, b=2, s=20, seed=0):
    """A batch: tokens, next-token targets, and whisper's frames."""
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s + 1))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["enc_embeds"] = _frames(b, seed)
    return batch


def _forward(cfg, params, batch, jax_side=False):
    if jax_side:
        enc = batch.get("enc_embeds")
        return JT.forward(cfg, params, jnp.asarray(batch["tokens"]),
                          **({} if enc is None else {"enc_embeds": jnp.asarray(enc)}))
    enc = batch.get("enc_embeds")
    return T.forward(cfg, params, T_(batch["tokens"]),
                     **({} if enc is None else {"enc_embeds": T_(enc)}))


def close(got, want, rtol, atol=None):
    g = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=rtol if atol is None else atol)


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _grads_close(mine, theirs):
    """Every gradient leaf of the port within the gradient bars of JAX's."""
    for path, want in jax.tree_util.tree_leaves_with_path(theirs):
        close(_leaf(mine, path), want, GRAD_RTOL, GRAD_ATOL)


# ---------------------------------------------------------------------------
# blockwise attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_blockwise_forward_matches_jax(arch):
    """Logits of the port's blockwise route against the JAX package's, on
    every attention family: causal self-attention (gemma2's window and
    softcaps, qwen2's biases), the moe stack, the hybrid's shared block, the
    encoder's non-causal self-attention and cross attention."""
    jcfg, jparams, pcfg, params = make(arch)
    batch = _inputs(pcfg)
    got = _forward(pcfg, params, batch)
    assert got.shape == (2, 20, pcfg.vocab_size)
    close(got, _forward(jcfg, jparams, batch, jax_side=True), MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_blockwise_gradients_match_jax(arch):
    """local_grads through the block loop (autograd) against jax.grad
    through the reference's scan."""
    jcfg, jparams, pcfg, params = make(arch)
    batch = _inputs(pcfg, seed=1)
    loss, grads = local_grads(pcfg, TrainConfig(), params, batch)
    jloss, jgrads = JS.local_grads(jcfg, JS.TrainConfig(),
                                   jparams, jax.tree_util.tree_map(jnp.asarray, batch))
    close(loss, jloss, MODEL_TOL)
    _grads_close(grads, jgrads)


@pytest.mark.parametrize("arch", ARCHS)
def test_blockwise_prefill_and_decode_match_jax(arch):
    """A prefill of 10 tokens into a 20-position cache (three key blocks of
    8, the last padded; positions past the fill level masked), then 3
    greedy decode steps: logits against the JAX package's at every step."""
    jcfg, jparams, pcfg, params = make(arch)
    b = 2
    batch = _inputs(pcfg, b=b, s=10, seed=2)
    jc, pc = JT.init_cache(jcfg, b, 20), T.init_cache(pcfg, b, 20, "cpu")
    if pcfg.family == "encdec":
        enc = batch["enc_embeds"]
        jc["cross"] = JT.encode_cross_cache(jcfg, jparams, jnp.asarray(enc), b)
        pc["cross"] = T.encode_cross_cache(pcfg, params, T_(enc), b)
    jc, jl = JT.prefill(jcfg, jparams, jnp.asarray(batch["tokens"]), jc)
    pc, pl = T.prefill(pcfg, params, T_(batch["tokens"]), pc)
    for _ in range(3):
        close(pl, jl, MODEL_TOL)
        nxt = np.array(jnp.argmax(jl, -1))[:, None]
        jc, jl = JT.decode_step(jcfg, jparams, jnp.asarray(nxt), jc)
        pc, pl = T.decode_step(pcfg, params, T_(nxt), pc)
    close(pl, jl, MODEL_TOL)


@pytest.mark.parametrize("arch", ["minitron_8b", "gemma2_2b"])
def test_blockwise_matches_the_ports_other_routes(arch):
    """Within the port: blockwise logits and gradients against the plain
    path (attention_kernel "jnp") and the flash kernel's plain version
    ("auto" on the CPU), and a blockwise prefill + decode against the plain
    cached path."""
    _, _, pcfg, params = make(arch)
    batch = _inputs(pcfg, seed=3)
    loss, grads = local_grads(pcfg, TrainConfig(), params, batch)
    logits = _forward(pcfg, params, batch)
    for kernel in ("jnp", "auto"):
        other = dataclasses.replace(pcfg, blockwise_attention=False, attention_kernel=kernel)
        close(logits, _forward(other, params, batch), MODEL_TOL)
        o_loss, o_grads = local_grads(other, TrainConfig(), params, batch)
        close(loss, o_loss, MODEL_TOL)
        for a, b in zip(tree_leaves(grads), tree_leaves(o_grads)):
            close(a, b.double().numpy(), GRAD_RTOL, GRAD_ATOL)
    plain = dataclasses.replace(pcfg, blockwise_attention=False)
    toks = T_(batch["tokens"][:, :9])
    outs = []
    for cfg in (pcfg, plain):
        c, lg = T.prefill(cfg, params, toks, T.init_cache(cfg, 2, 20, "cpu"))
        c, lg2 = T.decode_step(cfg, params, toks[:, :1], c)
        outs.append((lg, lg2))
    for got, want in zip(*outs):
        close(got, want.double().numpy(), MODEL_TOL)


@pytest.mark.parametrize("window,cap", [(None, None), (6, None), (None, 5.0)])
def test_blockwise_function_matches_jax_and_skips_exactly(window, cap):
    """``_blockwise_attention`` itself on one set of inputs against the JAX
    function: a cache of 40 positions (garbage past the fill level 13) in
    blocks of 8, and a fresh sequence of 19 keys (one padded block). The
    blocks past the fill level are not computed; the result is bit-equal to
    computing every block (causality masks them too)."""
    rng = np.random.default_rng(4)
    qg = rng.standard_normal((2, 5, 2, 3, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 40, 2, 16)).astype(np.float32) for _ in range(2))
    q_pos, k_pos = np.arange(5) + 8, np.arange(40)
    kw = dict(causal=True, window=window, softcap_v=cap, block_k=8)
    got = L._blockwise_attention(T_(qg), T_(k), T_(v), T_(q_pos), T_(k_pos), valid_len=13, **kw)
    want = JL._blockwise_attention(*map(jnp.asarray, (qg, k, v, q_pos, k_pos)),
                                   valid_len=jnp.asarray(13), **kw)
    assert got.shape == (2, 5, 2, 3, 16)
    close(got, want, 1e-5)
    every = L._blockwise_attention(T_(qg), T_(k), T_(v), T_(q_pos), T_(k_pos), **kw)
    assert torch.equal(got, every)
    q19 = rng.standard_normal((2, 19, 2, 3, 16)).astype(np.float32)
    pos = np.arange(19)
    args = (q19, k[:, :19], v[:, :19], pos, pos)
    got = L._blockwise_attention(*map(T_, args), **kw)
    close(got, JL._blockwise_attention(*map(jnp.asarray, args), **kw), 1e-5)
    kw["causal"] = False
    got = L._blockwise_attention(*map(T_, args), **kw)
    close(got, JL._blockwise_attention(*map(jnp.asarray, args), **kw), 1e-5)


def test_blockwise_scales_queries_in_the_compute_dtype():
    """bf16 compute: the queries are scaled in bf16 by the scale rounded to
    bf16 (JAX's weak-typed scalar), then upcast; at head_dim 128 the scale
    is not a power of two and another order changes bits. A bf16 layer's
    blockwise output equals the JAX layer's up to the float32 products'
    summation order, which the bf16 output rounds away on all but a few
    elements."""
    jcfg = dataclasses.replace(jax_get_reduced("minitron_8b"), head_dim=128, **BLK)
    pcfg = port_config(jcfg)
    jp = jax.tree_util.tree_map(np.asarray, jax_tree_materialize(
        JL.attention_defs(jcfg), jax.random.PRNGKey(1), jnp.float32))
    x = np.random.default_rng(5).standard_normal((1, 20, jcfg.d_model)).astype(np.float32)
    pos = np.arange(20)[None]
    want, _ = JL.multi_head_attention(jcfg, jax.tree_util.tree_map(jnp.asarray, jp),
                                      jnp.asarray(x), jnp.asarray(pos))
    got, _ = L.multi_head_attention(pcfg, tree_map(lambda _, a: T_(np.array(a)), jp), T_(x),
                                    T_(pos))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    assert np.mean(got.float().numpy() == want) > 0.95
    close(got.float(), want, 2e-2)


# ---------------------------------------------------------------------------
# bf16 training state
# ---------------------------------------------------------------------------

def _to_torch(tree):
    """A JAX tree (nested dicts) as CPU tensors of the same dtypes."""
    def one(a):
        t = torch.from_numpy(np.array(a.astype(jnp.float32)))
        return t.to(_DT[str(a.dtype)][1]) if str(a.dtype) in _DT else T_(np.array(a))

    return jax.tree_util.tree_map(one, tree)


def _ulps(got: torch.Tensor, want) -> np.ndarray:
    """|got - want| in bf16 ulps of the larger magnitude, or of 2^-15 of the
    leaf's largest, whichever is larger. An element far below the leaf's
    largest is what is left of a cancellation of terms as large as that
    (mu b1 + (1 - b1) g, p - lr delta): its error is the float32 rounding of
    those terms (2^-24 of them), which the two frameworks do in other orders
    (torch fuses ``add_(g, alpha=)``, JAX runs parts of the update in float64
    under the suite's x64 mode); one bf16 ulp of the floor is 2^-22 of the
    largest, two float32 ulps of it."""
    a = got.double().numpy()
    b = np.asarray(want.astype(jnp.float32), np.float64)
    floor = 2.0 ** -15 * max(np.abs(a).max(), np.abs(b).max(), 2.0 ** -100)
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), floor)
    return np.abs(a - b) / 2.0 ** (np.floor(np.log2(mag)) - 7)


def _to_jax(tree):
    """Port tensors (nested dicts) as JAX arrays of the same dtypes."""
    dts = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
    return tree_map(lambda _, t: jnp.asarray(t.float().numpy()).astype(dts[t.dtype]), tree)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("state", ["float32", "bfloat16"])
def test_bf16_train_state_matches_jax(state, microbatches, capsys):
    """Reduced llama3-405b with bf16 parameters (its full config's
    param_dtype), float32 compute, float32 or bf16 moments, one or two
    microbatches: 3 ``train_step``s in each package.

    Each package runs its own steps (losses within 1e-5). The state is held
    elementwise with the gradients shared: a chain of JAX ``adam_update``s
    fed the port's gradients ends with every parameter and moment within
    one bf16 ulp of the port's train state (each leaf in its dtype; ``_ulps``
    says how an element left by a cancellation is measured). With
    each package's own gradients that bar cannot hold: an element whose
    gradient is a cancellation (~1e-8, Adam's eps) gets a delta that
    differs by tens of percent between the frameworks (seen: 1-2 elements
    of 16,384 a leaf at 4-88 ulps); the share of bit-equal elements is
    reported for both chains."""
    jcfg = dataclasses.replace(jax_get_reduced("llama3_405b"), param_dtype=jnp.bfloat16,
                               compute_dtype=jnp.float32)
    pcfg = port_config(jcfg)
    kw = dict(lr=1e-3, warmup_steps=1)
    jtc = JS.TrainConfig(optimizer=JA.AdamConfig(state_dtype=_DT[state][0], **kw),
                         microbatches=microbatches)
    tc = TrainConfig(optimizer=AdamConfig(state_dtype=_DT[state][1], **kw),
                     microbatches=microbatches)
    jstate = JS.init_train_state(jcfg, jtc, jax.random.PRNGKey(0))
    shared = {"params": jstate["params"], "opt": jstate["opt"]}
    pstate = {"params": _to_torch(jstate["params"]), "opt": _to_torch(jstate["opt"]),
              "step": torch.zeros((), dtype=torch.int32)}
    jstep = jax.jit(functools.partial(JS.train_step, jcfg, jtc))
    for i in range(3):
        batch = _inputs(pcfg, b=4, s=16, seed=10 + i)
        loss, grads = local_grads(pcfg, tc, pstate["params"], batch)
        shared["params"], shared["opt"], _ = JA.adam_update(
            jtc.optimizer, shared["params"], _to_jax(grads), shared["opt"], jnp.int32(i))
        jstate, jm = jstep(jstate, batch)
        pstate, pm = train_step(pcfg, tc, pstate, batch)
        assert float(pm["loss"]) == float(loss)
        close(pm["loss"], jm["loss"], 1e-5)
        assert np.isfinite(float(pm["grad_norm"]))
    assert int(pstate["step"]) == 3
    shares = {}
    for name, theirs in (("shared gradients", shared), ("own gradients", jstate)):
        equal, total = 0, 0
        for part in ("params", "opt"):
            for path, want in jax.tree_util.tree_leaves_with_path(theirs[part]):
                got = _leaf(pstate[part], path)
                assert got.dtype == _DT[str(want.dtype)][1], jax.tree_util.keystr(path)
                ulps = _ulps(got, want)
                if theirs is shared:
                    assert ulps.max() <= 1.0, (jax.tree_util.keystr(path), ulps.max())
                equal += int((ulps == 0).sum())
                total += ulps.size
        shares[name] = f"{equal}/{total} = {equal / total:.4f}"
    with capsys.disabled():
        print(f"\n[bf16 params, {state} moments, {microbatches} microbatches] bit-equal: "
              f"{shares}")


def _bf16_state(steps, tc):
    cfg = dataclasses.replace(get_reduced("llama3_405b"), param_dtype=torch.bfloat16)
    state = init_train_state(cfg, tc, 0, "cpu")
    for i in range(steps):
        state, _ = train_step(cfg, tc, state, _inputs(cfg, b=2, s=16, seed=20 + i))
    return cfg, state


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


def _tree_bit_equal(a, b, path=""):
    """Nested dicts of tensors, key by key: the same dtypes and bits."""
    if isinstance(a, dict):
        assert sorted(a) == sorted(b), path
        for key in a:
            _tree_bit_equal(a[key], b[key], f"{path}/{key}")
        return
    assert a.dtype == b.dtype and torch.equal(_bits(a), _bits(b)), path


def test_bf16_train_state_checkpoints_and_resumes_bit_equal(tmp_path):
    """A bf16 train state (bf16 parameters and moments, after two steps) is
    saved through CheckpointManager as the JAX package saves bf16 leaves
    ('<V2' files, manifest dtype "bfloat16") and resumed bit for bit; a
    third step from the resumed state equals one from the live state."""
    tc = TrainConfig(optimizer=AdamConfig(lr=1e-3, warmup_steps=1,
                                          state_dtype=torch.bfloat16))
    cfg, state = _bf16_state(2, tc)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(state["opt"]))
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, state)
    mgr.wait()
    manifest = json.loads((tmp_path / "step_2" / "manifest.json").read_text())
    kinds = {e["path"].split("/")[0]: e["dtype"] for e in manifest["leaves"]}
    assert kinds == {"['opt']": "bfloat16", "['params']": "bfloat16", "['step']": "int32"}
    entry = manifest["leaves"][0]
    header = (tmp_path / "step_2" / entry["file"]).read_bytes()[:64]
    assert b"'descr': '<V2'" in header
    resumed, step = mgr.restore(init_train_state(cfg, tc, 1, "cpu"))
    assert step == 2
    _tree_bit_equal(resumed, state)
    batch = _inputs(cfg, b=2, s=16, seed=30)
    live, m_live = train_step(cfg, tc, state, batch)
    back, m_back = train_step(cfg, tc, resumed, batch)
    assert float(m_live["loss"]) == float(m_back["loss"])
    _tree_bit_equal(back, live)


def test_bf16_checkpoints_cross_from_jax(tmp_path):
    """A bf16 JAX train state written by repro.ckpt restores bit for bit as
    torch.bfloat16; the port writes the same bytes. (The JAX package's own
    restore of such a leaf fails on this container: ROADMAP Queue 3.)"""
    jcfg = dataclasses.replace(jax_get_reduced("llama3_405b"), param_dtype=jnp.bfloat16)
    jtc = JS.TrainConfig(optimizer=JA.AdamConfig(state_dtype=jnp.bfloat16))
    jstate = JS.init_train_state(jcfg, jtc, jax.random.PRNGKey(3))
    jstate["params"] = jax.tree_util.tree_map(
        lambda p: (p + 0.25).astype(p.dtype), jstate["params"])
    jstate["opt"]["nu"] = jax.tree_util.tree_map(
        lambda p: (jnp.abs(p) * 1e-3).astype(jnp.bfloat16), jstate["params"])
    jax_save(tmp_path / "jax", 5, jstate)
    cfg = port_config(jcfg)
    like = init_train_state(cfg, TrainConfig(optimizer=AdamConfig(state_dtype=torch.bfloat16)),
                            0, "cpu")
    mine, step = restore_checkpoint(tmp_path / "jax", like)
    assert step == 5
    _tree_bit_equal(mine, _to_torch(jstate))
    save_checkpoint(tmp_path / "port", 5, mine)
    for f in sorted((tmp_path / "jax" / "step_5").iterdir()):
        assert f.read_bytes() == (tmp_path / "port" / "step_5" / f.name).read_bytes(), f.name


# ---------------------------------------------------------------------------
# the "dots" remat policy
# ---------------------------------------------------------------------------

class _Products(TorchDispatchMode):
    """Counts the products run while it is active: ``mm`` (no batch
    dimension) and ``bmm`` (batched)."""

    def __init__(self):
        super().__init__()
        self.n = {"mm": 0, "bmm": 0}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.n:
            self.n[name] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["minitron_8b", "qwen2_moe", "mamba2_1p3b", "zamba2_1p2b",
                                  "whisper_small"])
def test_dots_policy_saves_the_no_batch_products(arch):
    """Per family: "dots" and "full" give "none"'s gradients bit for bit.
    Counted in the backward pass: under "dots" as many no-batch products
    (``mm``) run as under "none" (none is recomputed: their outputs were
    saved), and as many batched ones (``bmm``: attention, experts, SSD) as
    under "full" (all recomputed); "full" recomputes the no-batch ones too."""
    cfg0 = dataclasses.replace(get_reduced(arch), compute_dtype=torch.float32)
    params = T.init_train_params(cfg0, 0, "cpu")
    batch = {k: T_(v) for k, v in _inputs(cfg0, s=16, seed=40).items()}
    out = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(cfg0, remat=remat)
        live = tree_map(lambda _, t: t.detach().requires_grad_(), params)
        loss = loss_fn(cfg, live, batch)
        with _Products() as bwd:
            grads = torch.autograd.grad(loss, tree_leaves(live))
        out[remat] = (grads, bwd.n)
    for remat in ("dots", "full"):
        assert all(torch.equal(a, b) for a, b in zip(out[remat][0], out["none"][0])), remat
    none, dots, full = (out[r][1] for r in ("none", "dots", "full"))
    assert dots["mm"] == none["mm"] < full["mm"]
    assert none["bmm"] < dots["bmm"] == full["bmm"]
