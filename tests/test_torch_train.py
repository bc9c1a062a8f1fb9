"""The port's training path against the JAX package: loader, AdamW, CE loss,
gradients, the train step, checkpoints and the launcher.

Both packages start from one set of weights (the JAX ``tree_materialize``
draws them, numpy carries them) and take batches from the same loader.
Sizes are minitron-8b's ``reduced()`` at 2 layers (d_model 64, GQA 4/2,
head_dim 16, vocab 256), B <= 8, S <= 16. Bars, each with its reason:
  * the loader: byte-identical (both are numpy ``default_rng``);
  * ``adam_update``: 1e-6 (float32 elementwise arithmetic in the same
    order; the bias corrections are computed in double here);
  * ``ce_loss``: 1e-6 (float32 logsumexp, summed in another order);
  * ``local_grads`` at float32 compute: loss rtol 1e-5, gradients 2e-4 (the
    registry's float32 gradient bar: attention's gradient is the blocked
    kernels' plain version here and autodiff of the dense oracle there);
  * a 3-step trajectory: losses rtol 1e-5 at every step; each leaf's
    3-step update (p3 - p0) within 1e-3 in relative Frobenius norm (Adam
    divides each gradient element by its own root mean square, so the few
    elements whose gradient is at the two frameworks' rounding noise move
    differently; they put the worst leaf at ~3e-4), and every parameter
    within steps x lr elementwise (the most such an element can move);
  * checkpoints and resume: bit-equal.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as jax_restore
from repro.ckpt import save_checkpoint as jax_save
from repro.configs import get_reduced as jax_get_reduced
from repro.data.sharded_loader import LoaderConfig as JLoaderConfig
from repro.data.sharded_loader import batch_at as jax_batch_at
from repro.models import transformer as JT
from repro.models.params import tree_materialize as jax_tree_materialize
from repro.optim import adam as JA
from repro.train import step as JS
from repro_torch.ckpt import (
    CheckpointManager, CheckpointSpec, restore_checkpoint, save_checkpoint,
)
from repro_torch.ckpt.checkpoint import committed_steps, load_checkpoint
from repro_torch.configs import get_reduced
from repro_torch.convert import model_params_from_numpy, model_params_to_numpy
from repro_torch.data.sharded_loader import LoaderConfig, ShardedTokenLoader, batch_at
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
from repro_torch.launch import train as launcher
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim.adam import AdamConfig, adam_init, adam_update, global_norm
from repro_torch.train import step as S
from repro_torch.train.step import TrainConfig, ce_loss, init_train_state, local_grads, train_step
from test_torch_models import port_config

GRAD_TOL = 2e-4
UPDATE_TOL = 1e-3  # the 3-step update, relative Frobenius norm per leaf


def _cfg(**kw):
    return dataclasses.replace(get_reduced("minitron_8b"), n_layers=2, **kw)


def _batch(cfg, bsz=4, seq=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (bsz, seq + 1))
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _pair(compute=jnp.float32):
    """(jax cfg, jax params, port cfg, port params): one set of float32 weights."""
    jcfg = dataclasses.replace(jax_get_reduced("minitron_8b"), n_layers=2,
                               compute_dtype=compute)
    jparams = jax_tree_materialize(JT.model_defs(jcfg), jax.random.PRNGKey(0),
                                   jcfg.param_dtype)
    pcfg = port_config(jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, pcfg, model_params_from_numpy(pcfg, tree, "cpu")


def _close_tree(mine, theirs, tol, rtol=None):
    flat = jax.tree_util.tree_leaves_with_path(theirs)
    mine_np = model_params_to_numpy(mine)
    for path, want in flat:
        got = mine_np
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=tol if rtol is None else rtol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shards", [1, 2])
def test_batch_at_is_byte_identical_to_jax(shards):
    for step in (0, 3, 1000):
        mine = batch_at(LoaderConfig(1000, 4, 9, n_shards=shards, seed=5), step)
        theirs = jax_batch_at(JLoaderConfig(1000, 4, 9, n_shards=shards, seed=5), step)
        for key in ("tokens", "targets"):
            assert mine[key].dtype == theirs[key].dtype
            assert mine[key].tobytes() == theirs[key].tobytes()
    ld = ShardedTokenLoader(LoaderConfig(1000, 4, 9, seed=5), start_step=2)
    try:
        assert next(ld)["tokens"].tobytes() == batch_at(ld.cfg, 2)["tokens"].tobytes()
    finally:
        ld.close()


# ---------------------------------------------------------------------------
# optimizer and loss against JAX
# ---------------------------------------------------------------------------

def _opt_trees(seed=0):
    """(params, grads, mu, nu) numpy trees, keys in sorted order (JAX's leaf order)."""
    rng = np.random.default_rng(seed)
    shapes = {"nested": {"b": (11,), "m": (3, 4, 2)}, "w": (5, 7)}

    def draw(scale):
        return tree_map(lambda _, s: (scale * rng.standard_normal(s)).astype(np.float32), shapes)

    return draw(1.0), draw(3.0), draw(0.1), tree_map(lambda _, a: np.abs(a), draw(0.1))


@pytest.mark.parametrize("kind", ["adamw", "sgdm"])
def test_adam_update_matches_jax(kind):
    """Clipping active (global norm ~ 16 > grad_clip 0.5), bias correction at
    step 3, decoupled weight decay; updated in place, within 1e-6."""
    params, grads, mu, nu = _opt_trees()
    kw = dict(lr=1e-2, grad_clip=0.5, warmup_steps=10, kind=kind)
    jcfg, cfg = JA.AdamConfig(**kw), AdamConfig(**kw)
    jopt = {"mu": mu} if kind == "sgdm" else {"mu": mu, "nu": nu}
    jp, jo, jm = JA.adam_update(jcfg, params, grads, jopt, jnp.int32(3))
    t = lambda tree: tree_map(lambda _, a: torch.as_tensor(a.copy()), tree)  # noqa: E731
    p, g, opt = t(params), t(grads), {k: t(v) for k, v in jopt.items()}
    ptrs = [x.data_ptr() for x in tree_leaves(p)]
    new_p, new_opt, m = adam_update(cfg, p, g, opt, torch.tensor(3, dtype=torch.int32))
    assert [x.data_ptr() for x in tree_leaves(new_p)] == ptrs  # in place
    assert float(jm["grad_norm"]) > 10 * kw["grad_clip"]
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-6)
    np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-6)
    for mine, theirs in [(new_p, jp)] + [(new_opt[k], jo[k]) for k in jo]:
        for a, b in zip(tree_leaves(mine), jax.tree_util.tree_leaves(theirs)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    assert set(new_opt) == set(jo)


@pytest.mark.parametrize("masked", [False, True])
def test_ce_loss_matches_jax(masked):
    rng = np.random.default_rng(1)
    logits = (4 * rng.standard_normal((3, 5, 37))).astype(np.float32)
    targets = rng.integers(0, 37, (3, 5)).astype(np.int32)
    mask = (rng.uniform(size=(3, 5)) < 0.6).astype(np.float32) if masked else None
    mine = ce_loss(torch.as_tensor(logits), torch.as_tensor(targets),
                   None if mask is None else torch.as_tensor(mask))
    theirs = JS.ce_loss(jnp.asarray(logits), jnp.asarray(targets),
                        None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(mine), float(theirs), rtol=1e-6)


def test_local_grads_match_jax():
    jcfg, jparams, pcfg, params = _pair()
    batch = _batch(pcfg)
    jl, jg = jax.jit(lambda p, b: JS.local_grads(jcfg, JS.TrainConfig(), p, b))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = local_grads(pcfg, TrainConfig(), params, batch)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    _close_tree(grads, jg, GRAD_TOL)


def test_train_step_trajectory_matches_jax():
    """3 steps of the JAX launcher's wiring (batch_at batches) in both packages."""
    jcfg, jparams, pcfg, params = _pair()
    p0 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), jparams)
    opt = dict(lr=1e-3, warmup_steps=1)
    jtc, tc = JS.TrainConfig(optimizer=JA.AdamConfig(**opt)), TrainConfig(optimizer=AdamConfig(**opt))
    ld = LoaderConfig(pcfg.vocab_size, 4, 16, seed=3)
    jstate = {"params": jparams, "opt": JA.adam_init(jtc.optimizer, jparams),
              "step": jnp.zeros((), jnp.int32)}
    state = {"params": params, "opt": adam_init(tc.optimizer, params),
             "step": torch.zeros((), dtype=torch.int32)}
    jstep = jax.jit(lambda s, b: JS.train_step(jcfg, jtc, s, b))
    for i in range(3):
        batch = batch_at(ld, i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = train_step(pcfg, tc, state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        if i == 0:  # the same parameters: the same gradient, within its bar
            np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                       rtol=GRAD_TOL)
    assert int(state["step"]) == int(jstate["step"]) == 3
    _close_tree(state["params"], jstate["params"], 3 * opt["lr"], rtol=0.0)
    # the update itself, leaf by leaf: a zero, halved or sign-flipped step
    # is off by 0.5 or more in relative norm
    for path, theirs in jax.tree_util.tree_leaves_with_path(jstate["params"]):
        got, start = model_params_to_numpy(state["params"]), p0
        for key in path:
            got, start = got[key.key], start[key.key]
        mine_du = np.asarray(got, np.float64) - start
        their_du = np.asarray(theirs, np.float64) - start
        rel = np.linalg.norm(mine_du - their_du) / np.linalg.norm(their_du)
        assert rel < UPDATE_TOL, (jax.tree_util.keystr(path), rel)


# ---------------------------------------------------------------------------
# the counterparts of tests/test_train_step.py
# ---------------------------------------------------------------------------

def test_loss_decreases_over_steps():
    cfg = _cfg()
    tc = TrainConfig(optimizer=AdamConfig(lr=1e-2, warmup_steps=1))
    state = init_train_state(cfg, tc, 0, "cpu")
    losses = []
    for i in range(25):
        state, m = train_step(cfg, tc, state, _batch(cfg, seed=i % 2))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.8


def test_microbatch_grads_equal_full_batch():
    cfg = _cfg(compute_dtype=torch.float32)
    tc1, tc4 = TrainConfig(microbatches=1), TrainConfig(microbatches=4)
    state = init_train_state(cfg, tc1, 0, "cpu")
    batch = _batch(cfg, bsz=8)
    l1, g1 = local_grads(cfg, tc1, state["params"], batch)
    l4, g4 = local_grads(cfg, tc4, state["params"], batch)
    np.testing.assert_allclose(float(l1), float(l4), rtol=1e-6)
    for a, b in zip(tree_leaves(g1), tree_leaves(g4)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-3, atol=2e-5)
    with pytest.raises(ValueError, match="microbatches"):
        local_grads(cfg, TrainConfig(microbatches=3), state["params"], batch)


def test_remat_policies_same_grads():
    tc = TrainConfig()
    batch = _batch(_cfg())
    grads = {}
    for remat in ("none", "full", "dots"):
        cfg = _cfg(remat=remat)
        state = init_train_state(cfg, tc, 0, "cpu")
        _, grads[remat] = local_grads(cfg, tc, state["params"], batch)
    for other in ("full", "dots"):
        for a, b in zip(tree_leaves(grads["none"]), tree_leaves(grads[other])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-7)


def test_ce_loss_masked():
    logits = torch.zeros((1, 4, 8))
    targets = torch.tensor([[1, 2, 3, 4]])
    mask = torch.tensor([[1.0, 1.0, 0.0, 0.0]])
    np.testing.assert_allclose(float(ce_loss(logits, targets)), np.log(8), rtol=1e-6)
    np.testing.assert_allclose(float(ce_loss(logits, targets, mask)), np.log(8), rtol=1e-6)


def test_grad_clip_bounds_update():
    cfg = AdamConfig(lr=1.0, grad_clip=1e-3, warmup_steps=1, weight_decay=0.0)
    params = {"w": torch.ones(4)}
    opt = adam_init(cfg, params)
    new_p, _, m = adam_update(cfg, params, {"w": torch.full((4,), 100.0)}, opt, 0)
    assert float(m["grad_norm"]) == pytest.approx(200.0)
    assert torch.isfinite(new_p["w"]).all()


def test_sgdm_kind():
    cfg = AdamConfig(kind="sgdm", lr=0.1, warmup_steps=1, weight_decay=0.0, grad_clip=1e9)
    params = {"w": torch.ones(3)}
    opt = adam_init(cfg, params)
    assert "nu" not in opt
    new_p, _, _ = adam_update(cfg, params, {"w": torch.ones(3)}, opt, 0)
    # first step: mu = 0.9*0 + 0.1*g = 0.1g; p -= lr*mu
    np.testing.assert_allclose(new_p["w"].numpy(), 1.0 - 0.1 * 0.1, rtol=1e-6)
    with pytest.raises(ValueError, match="kind"):
        AdamConfig(kind="lion")


def test_adam_takes_float32_state_only():
    """bf16 moments (the JAX state_dtype option) are not ported: refused at
    the config; a non-float32 parameter is refused by the update."""
    with pytest.raises(NotImplementedError, match="float32"):
        AdamConfig(state_dtype=torch.bfloat16)
    cfg = AdamConfig(warmup_steps=1)
    params = {"a": torch.ones(3), "b": torch.ones(2, dtype=torch.bfloat16)}
    opt = adam_init(cfg, {"a": params["a"], "b": torch.ones(2)})
    with pytest.raises(ValueError, match="float32"):
        adam_update(cfg, params, {"a": torch.ones(3), "b": torch.ones(2)}, opt, 0)


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(global_norm(t)) == pytest.approx(5.0)


# ---------------------------------------------------------------------------
# the step's kernel routing and the mesh tools
# ---------------------------------------------------------------------------

def test_step_goes_through_the_flash_function_and_backward():
    """With remat 'full' every layer's forward runs twice (forward and
    recompute) and its backward once; each call goes through the registry,
    so held_to_plain sees it. 'off' runs the plain version only."""
    cfg = _cfg(remat="full")
    state = init_train_state(cfg, TrainConfig(), 0, "cpu")
    batch = _batch(cfg)
    with ops.held_to_plain("flash_attention") as fwd, \
            ops.held_to_plain("flash_attention_bwd") as bwd:
        local_grads(cfg, TrainConfig(), state["params"], batch)
        local_grads(dataclasses.replace(cfg, attention_kernel="off"), TrainConfig(),
                    state["params"], batch)
    assert len(fwd) == 2 * cfg.n_layers and len(bwd) == cfg.n_layers
    assert flash_attention.launches == flash_attention_bwd.launches == 0  # no kernel on the CPU


def test_mesh_tools_raise():
    """What the slice leaves out raises, naming its ROADMAP item."""
    for fn in (S.make_train_state_defs, S.batch_specs, S.make_jitted_train_step):
        with pytest.raises(NotImplementedError, match="Queue 1 items 10 and 14"):
            fn(_cfg(), TrainConfig())
    with pytest.raises(NotImplementedError, match="Queue 1 items 10 and 14"):
        launcher.run(launcher.parse_args(["--reduced", "--device", "cpu", "--mesh", "single"]))
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        CheckpointSpec("/tmp", every=10)
    cfg = _cfg(blockwise_attention=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
        local_grads(cfg, TrainConfig(), init_train_state(cfg, TrainConfig(), 0, "cpu")["params"],
                    _batch(cfg))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 3, generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32), "c": torch.tensor(2.5)}}


def _equal(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 7, t)
    restored, step = restore_checkpoint(tmp_path, t)
    assert step == 7
    _equal(t, restored)
    manifest = json.loads((tmp_path / "step_7" / "manifest.json").read_text())
    assert [e["path"] for e in manifest["leaves"]] == [
        "['a']", "['nested']/['b']", "['nested']/['c']"]


def test_restore_picks_latest_committed_and_ignores_tmp(tmp_path):
    t = _tree()
    save_checkpoint(tmp_path, 1, t)
    save_checkpoint(tmp_path, 5, tree_map(lambda _, x: x + 1, t))
    (tmp_path / "step_9.tmp").mkdir()  # a crash mid-write
    restored, step = restore_checkpoint(tmp_path, t)
    assert step == 5
    assert torch.equal(restored["a"], t["a"] + 1)
    assert load_checkpoint(tmp_path)[0] == 5


def test_keep_last_prunes(tmp_path):
    t = _tree()
    for s in range(6):
        save_checkpoint(tmp_path, s, t, keep_last=2)
    assert committed_steps(tmp_path) == [4, 5]


def test_tree_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path, 0, _tree())
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(tmp_path, {"a": torch.zeros(4, 3), "other": torch.zeros(2)})


def test_async_manager(tmp_path):
    """The host copy is taken at save(): an in-place update right after does
    not reach the file."""
    mgr = CheckpointManager(tmp_path, keep_last=2)
    t = _tree()
    want = t["a"].clone()
    mgr.save(3, t, async_=True)
    t["a"].add_(1.0)
    mgr.wait()
    restored, step = mgr.restore(t)
    assert step == 3 and torch.equal(restored["a"], want)


def test_training_resume_exactness(tmp_path):
    """train 5 steps == train 3 + checkpoint + restore + train 2 (bit-equal)."""
    cfg = dataclasses.replace(get_reduced("minitron_8b"), n_layers=1)
    tc = TrainConfig(optimizer=AdamConfig(lr=1e-2, warmup_steps=1))
    batches = [_batch(cfg, bsz=2, seed=100 + i) for i in range(5)]
    s_a = init_train_state(cfg, tc, 0, "cpu")
    for b in batches:
        s_a, _ = train_step(cfg, tc, s_a, b)
    s_b = init_train_state(cfg, tc, 0, "cpu")
    for b in batches[:3]:
        s_b, _ = train_step(cfg, tc, s_b, b)
    save_checkpoint(tmp_path, 3, s_b)
    s_c, _ = restore_checkpoint(tmp_path, init_train_state(cfg, tc, 1, "cpu"))
    for b in batches[3:]:
        s_c, _ = train_step(cfg, tc, s_c, b)
    _equal(s_a["params"], s_c["params"])
    assert int(s_c["step"]) == 5


def test_checkpoints_cross_between_packages(tmp_path):
    """A JAX train state written by repro.ckpt is read by the port, and a
    port state written by the port is read by repro.ckpt."""
    jcfg = dataclasses.replace(jax_get_reduced("minitron_8b"), n_layers=1)
    jstate = JS.init_train_state(jcfg, JS.TrainConfig(), jax.random.PRNGKey(0))
    jstate["step"] = jnp.int32(4)
    jax_save(tmp_path / "jax", 4, jstate)
    cfg = port_config(jcfg)
    like = init_train_state(cfg, TrainConfig(), 1, "cpu")
    mine, step = restore_checkpoint(tmp_path / "jax", like)
    assert step == 4 and int(mine["step"]) == 4 and mine["step"].dtype == torch.int32
    _close_tree(mine["params"], jstate["params"], 0.0)
    _close_tree(mine["opt"]["nu"], jstate["opt"]["nu"], 0.0)

    save_checkpoint(tmp_path / "port", 4, mine)
    back, step = jax_restore(tmp_path / "port", jstate)
    assert step == 4
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                                      np.asarray(b)),
                           back, jstate)


def test_launcher_resumes_bit_equal(tmp_path):
    """The launcher on the CPU: 6 steps with a checkpoint at step 3; drop the
    final checkpoint (a crash after step 3's), run again: it resumes and
    ends bit-equal to the uninterrupted run."""
    flags = ["--reduced", "--device", "cpu", "--steps", "6", "--ckpt-every", "3",
             "--batch", "2", "--seq", "16", "--ckpt-dir", str(tmp_path)]
    full = launcher.run(launcher.parse_args(flags))
    assert committed_steps(tmp_path) == [3, 6]
    _, _, at_3 = load_checkpoint(tmp_path, 3)
    assert at_3["['step']"] == 4  # the JAX launcher's numbering: saved after step index 3
    for f in (tmp_path / "step_6").iterdir():
        f.unlink()
    (tmp_path / "step_6").rmdir()
    resumed = launcher.run(launcher.parse_args(flags))
    _equal(full["params"], resumed["params"])
    _equal(full["opt"]["nu"], resumed["opt"]["nu"])
