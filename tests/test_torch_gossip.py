"""The port's pod-axis gossip training (core/gossip.py, ft/elastic.py, the
gossip example) and gemma2-2b against the JAX package.

Both packages start from one state: the JAX ``init_gossip_state`` draws it,
numpy carries it, ``convert.gossip_state_from_numpy`` loads it; batches are
numpy arrays handed to both. Sizes: gemma2-2b's ``reduced()`` (2 layers, one
local/global pair, d_model 64, GQA 4/2, head_dim 16, vocab 256, window 8,
softcaps, tied embedding) with 2 pods, and the JAX tests' toy config
(minitron-8b reduced at 1 layer, topk_ratio 0.25, test_gossip.py:29-39)
with 4 pods; B=4, S=16 per pod, float32 compute. Bars, each with its
reason (the registry's and tests/test_torch_train.py's):
  * exchanges (mixing, reconstructions, corrections): 1e-6, float32
    elementwise arithmetic in the same order;
  * gemma2-2b forward logits 1e-4, loss rtol 1e-5, gradients 2e-4, the
    tied embedding's too (tests/test_torch_models.py, test_torch_train.py);
  * a 3-step trajectory: losses rtol 1e-5 at every step. dsba moves a
    parameter by lr (g_t - g_{t-1}) a step, so params, params_prev and the
    reconstructions are held within steps x lr x 2e-4 (the gradient bar
    scaled by the step's lr) and g_prev within the gradient bar. The Adam
    modes move an element by at most lr a step: params and reconstructions
    within steps x lr elementwise, each leaf's update within 1e-3 in
    relative Frobenius norm and the moments within 1e-3 likewise
    (tests/test_torch_train.py's trajectory bars). A flipped top-k
    selection moves a reconstruction entry by a whole residual value and
    fails every one of these bars.
Step sizes. dsba takes the JAX tests' 0.5 on the toy config; on reduced
gemma2-2b, whose tied embedding at the reference's init gives a loss of
~22 and gradients of norm ~20, it takes 1e-2: at 0.5 a step changes the
weights by O(1) and three steps amplify float32 rounding (JAX runs its
rope in float64 under x64) chaotically. The Adam modes take 1e-3, the
trajectory lr of tests/test_torch_train.py, and eps 1e-6. Adam divides
each gradient element by its own magnitude plus eps, so with the default
eps 1e-8 an element whose gradient sits at the two packages' float32
rounding noise (<= 1.4e-7 here; one of the toy wk's 2,048 elements a pod
has |g| = 5e-9, of opposite sign in the two) moves by up to lr either
way; one such element in a 2,048-element leaf is 1-3e-3 of its update
norm. At the JAX tests' lr 1e-2 the same amplification moves reduced
gemma2-2b's next loss by 6e-4 relative and then its top-k selection: the
noise, amplified, not a port fault. With eps above the noise the step
is Lipschitz in the gradient at that scale and every leaf agrees.
"""
import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import restore_checkpoint as jax_restore
from repro.ckpt import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.core import gossip as JG
from repro.ft import ElasticGossip as JElastic
from repro.models import transformer as JT
from repro.models.params import tree_materialize as jax_tree_materialize
from repro.optim.adam import AdamConfig as JAdamConfig
from repro.train import step as JS
from repro_torch import configs as C
from repro_torch import ft
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.ckpt.checkpoint import committed_steps, load_checkpoint
from repro_torch.convert import (
    gossip_state_from_numpy, gossip_state_to_numpy, model_params_from_numpy,
)
from repro_torch.core import gossip as G
from repro_torch.ft import BoundedStalenessBuffer, ElasticGossip, HeartbeatMonitor
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.step import TrainConfig, local_grads, loss_fn
from test_torch_models import port_config

REPO = Path(__file__).resolve().parents[1]
EXCHANGE_TOL = 1e-6
MODEL_TOL = 1e-4
GRAD_TOL = 2e-4
UPDATE_TOL = 1e-3
STEPS = 3
ADAM_LR = 1e-3  # tests/test_torch_train.py's trajectory lr; see the docstring
ADAM_EPS = 1e-6  # above the gradients' float32 rounding noise; see the docstring


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(vocab, n_pods, bsz=4, seq=16, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (n_pods, bsz, seq + 1))
    return {"tokens": toks[..., :-1], "targets": toks[..., 1:]}


def _walk(mine, theirs, fn, path=()):
    """fn(path, port tensor as float64 numpy, JAX leaf as float64 numpy)."""
    if isinstance(theirs, dict):
        assert set(mine) == set(theirs), path
        for key in theirs:
            _walk(mine[key], theirs[key], fn, (*path, key))
        return
    fn("/".join(path), mine.detach().double().numpy(), np.asarray(theirs, np.float64))


# ---------------------------------------------------------------------------
# gemma2-2b
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", ["full", "reduced"])
def test_gemma2_config_copies_every_jax_field(which):
    jcfg = (jax_get_config if which == "full" else jax_get_reduced)("gemma2-2b")
    mine = (C.get_config if which == "full" else C.get_reduced)("gemma2-2b")
    assert mine == port_config(jcfg)
    assert mine.param_count() == jcfg.param_count()


def _gemma2_pair():
    jcfg = dataclasses.replace(jax_get_reduced("gemma2_2b"), compute_dtype=jnp.float32)
    jparams = jax_tree_materialize(JT.model_defs(jcfg), jax.random.PRNGKey(0),
                                   jcfg.param_dtype)
    pcfg = port_config(jcfg)
    return jcfg, jparams, pcfg, model_params_from_numpy(pcfg, _np(jparams), "cpu")


def test_gemma2_forward_loss_and_grads_match_jax():
    """Reduced gemma2-2b in float32: logits, loss and every gradient leaf,
    the tied embedding's (used as lookup and as head) included. S=16 is
    twice the reduced window, so the local layer's window bites."""
    jcfg, jparams, pcfg, params = _gemma2_pair()
    assert "lm_head" not in params and pcfg.tie_embeddings
    b = {k: v[0] for k, v in _batch(pcfg.vocab_size, 1).items()}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    logits = T.forward(pcfg, params, torch.as_tensor(b["tokens"]))
    want = JT.forward(jcfg, jparams, jb["tokens"])
    np.testing.assert_allclose(logits.double().numpy(), np.asarray(want, np.float64),
                               rtol=MODEL_TOL, atol=MODEL_TOL)
    assert float(np.abs(np.asarray(want)).max()) <= jcfg.final_softcap
    tb = {k: torch.as_tensor(v) for k, v in b.items()}
    np.testing.assert_allclose(float(loss_fn(pcfg, params, tb)),
                               float(JS.loss_fn(jcfg, jparams, jb)), rtol=1e-5)
    jl, jg = JS.local_grads(jcfg, JS.TrainConfig(), jparams, jb)
    loss, grads = local_grads(pcfg, TrainConfig(), params, b)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)

    def close(path, got, want):
        np.testing.assert_allclose(got, want, rtol=GRAD_TOL, atol=GRAD_TOL, err_msg=path)

    _walk(grads, jg, close)
    # the embedding's gradient has both uses: the head's part is dense
    assert np.count_nonzero(grads["embed"].numpy()) == grads["embed"].numel()


# ---------------------------------------------------------------------------
# exchanges
# ---------------------------------------------------------------------------

TOPOLOGIES = [(2, "ring"), (4, "ring"), (8, "exponential")]


def _exchange_inputs(n_pods, n_streams, seed=0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (5, 7), "b": {"c": (300,)}}
    src = tree_map(lambda _, s: rng.standard_normal((n_pods, *s)).astype(np.float32), shapes)
    rec = tree_map(lambda _, s: (0.5 * rng.standard_normal((n_pods, n_streams, *s)))
                   .astype(np.float32), shapes)
    return src, rec


def _torch(tree):
    return tree_map(lambda _, a: torch.as_tensor(np.array(a)), tree)


@pytest.mark.parametrize("n_pods,topology", TOPOLOGIES)
def test_dense_mix_matches_jax(n_pods, topology):
    gc = G.GossipConfig(n_pods=n_pods, topology=topology)
    src, _ = _exchange_inputs(n_pods, 1)
    got = G.make_dense_mix(None, gc)(_torch(src))
    want = JG.make_dense_mix(None, JG.GossipConfig(n_pods=n_pods, topology=topology), None)(
        jax.tree_util.tree_map(jnp.asarray, src))
    _walk(got, want, lambda p, g, w: np.testing.assert_allclose(
        g, w, rtol=EXCHANGE_TOL, atol=EXCHANGE_TOL, err_msg=p))


@pytest.mark.parametrize("compression", ["none", "topk", "block_topk"])
@pytest.mark.parametrize("n_pods,topology", TOPOLOGIES)
def test_topk_exchange_matches_jax(n_pods, topology, compression):
    """Corrections and updated reconstructions; block 64 with k_b 6 gives a
    padded tail on the 300-element leaf and a single short block on the
    35-element one."""
    kw = dict(n_pods=n_pods, topology=topology, compression=compression,
              topk_ratio=0.1, block_size=64)
    gc, jgc = G.GossipConfig(**kw), JG.GossipConfig(**kw)
    ns = 1 + 2 * len(gc.shifts_and_weights()[0])
    src, rec = _exchange_inputs(n_pods, ns, seed=1)
    rec_t = _torch(rec)
    corr, new_rec = G.make_topk_exchange(None, gc)(_torch(src), rec_t)
    jcorr, jrec = JG.make_topk_exchange(None, jgc, None)(
        jax.tree_util.tree_map(jnp.asarray, src), jax.tree_util.tree_map(jnp.asarray, rec))
    assert new_rec is rec_t  # updated in place
    for mine, theirs in ((corr, jcorr), (new_rec, jrec)):
        _walk(mine, theirs, lambda p, g, w: np.testing.assert_allclose(
            g, w, rtol=EXCHANGE_TOL, atol=EXCHANGE_TOL, err_msg=p))


def test_exchange_goes_through_the_registry():
    """block_topk runs one selection a leaf for every pod at once, through
    ops.dispatch (so held_to_plain sees it); topk needs no kernel."""
    gc = G.GossipConfig(n_pods=4, compression="block_topk", topk_ratio=0.1, block_size=64)
    src, rec = _exchange_inputs(4, 3, seed=2)
    with ops.held_to_plain("block_topk") as held:
        G.make_topk_exchange(None, gc)(_torch(src), _torch(rec))
    assert len(held) == 2 and all(held.exact)


def test_mesh_and_unported_pieces_raise():
    """The pod mesh runs (tests/test_torch_gossip_ranks.py), and so does the
    within-pod sharded step (tests/test_torch_fsdp.py); the production mesh
    needs 256 devices and raises the JAX package's ValueError on one, from
    the launcher's --mesh too, and the sharded step refuses a mesh that is
    not a ("data", "model") grid. A mesh whose size is not n_pods is refused
    before any rank runs."""
    from repro_torch.launch import mesh as launch_mesh
    from repro_torch.launch import train as launcher
    from repro_torch.train import step as train_step

    with pytest.raises(ValueError, match="needs 256 devices, found 1"):
        launch_mesh.make_production_mesh()
    with pytest.raises(ValueError, match="needs 256 devices, found 1"):
        launcher.run(launcher.parse_args(["--reduced", "--device", "cpu", "--mesh", "single"]))
    with pytest.raises(ValueError, match="needs a GridMesh"):
        train_step.make_jitted_train_step(types.SimpleNamespace(n=2, device=torch.device("cpu")),
                                          C.get_reduced("gemma2-2b"), TrainConfig())
    gc = G.GossipConfig()
    cfg = C.get_reduced("gemma2-2b")
    wrong = types.SimpleNamespace(n=3, device=torch.device("cpu"))
    for make in (G.make_dense_mix, G.make_topk_exchange):
        with pytest.raises(ValueError, match="n_pods is 2 but the 'pod' mesh has 3 ranks"):
            make(wrong, gc)
    with pytest.raises(ValueError, match="n_pods is 2 but the 'pod' mesh has 3 ranks"):
        G.make_gossip_train_step(wrong, cfg, TrainConfig(), gc)
    with pytest.raises(ValueError, match="n_pods is 2 but the 'pod' mesh has 3 ranks"):
        G.init_gossip_state(cfg, TrainConfig(), gc, 0, "cpu", mesh=wrong)
    with pytest.raises(ValueError, match="kernel_mode"):
        G.GossipConfig(kernel_mode="interpret")
    from repro_torch.ft import faults
    for name in ("FaultPlan", "ChurnPlan", "as_fault_plan"):
        assert getattr(ft, name) is getattr(faults, name)
    assert ft.as_fault_plan(None) is None


# ---------------------------------------------------------------------------
# trajectories: every mode x compression against JAX
# ---------------------------------------------------------------------------

def _setup(which, mode, compression):
    """(jax cfg, port cfg, jax tc, port tc, jax gc, port gc, lr, n_pods)."""
    if which == "gemma2":
        jcfg = jax_get_reduced("gemma2_2b")
        n_pods, ratio = 2, 0.25
        lr = 1e-2 if mode == "dsba" else ADAM_LR
    else:  # the JAX tests' toy config
        jcfg = dataclasses.replace(jax_get_reduced("minitron_8b"), n_layers=1)
        n_pods, ratio = 4, 0.25
        lr = 0.5 if mode == "dsba" else ADAM_LR
    jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
    opt = dict(lr=lr, warmup_steps=1, eps=ADAM_EPS)
    kw = dict(n_pods=n_pods, mode=mode, compression=compression, topk_ratio=ratio,
              block_size=64)
    return (jcfg, port_config(jcfg), JS.TrainConfig(optimizer=JAdamConfig(**opt)),
            TrainConfig(optimizer=AdamConfig(**opt)), JG.GossipConfig(**kw),
            G.GossipConfig(**kw), lr, n_pods)


@pytest.mark.parametrize("compression", ["none", "topk", "block_topk"])
@pytest.mark.parametrize("mode", ["dsba", "dsgd", "allreduce"])
@pytest.mark.parametrize("which", ["gemma2", "toy"])
def test_trajectory_matches_jax(which, mode, compression):
    jcfg, pcfg, jtc, tc, jgc, gc, lr, n_pods = _setup(which, mode, compression)
    jstate = JG.init_gossip_state(jcfg, jtc, jgc, jax.random.PRNGKey(0))
    state = gossip_state_from_numpy(pcfg, gc, _np(jstate), "cpu")
    start = _np(jstate["params"])
    jstep = jax.jit(JG.make_gossip_train_step(None, jcfg, jtc, jgc))
    step = G.make_gossip_train_step(None, pcfg, tc, gc)
    for i in range(STEPS):
        batch = _batch(pcfg.vocab_size, n_pods, seed=i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, batch)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        if i == 0:
            np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                       rtol=GRAD_TOL)
    _hold_to_jax(mode, compression, lr, gc, state, jstate, m, start)


def _hold_to_jax(mode, compression, lr, gc, state, jstate, m, start):
    """A port gossip state after STEPS steps against the JAX one, at the
    trajectory bars of the module docstring."""
    assert int(state["step"]) == int(jstate["step"]) == STEPS
    assert set(state) == set(jstate)

    def elementwise(atol, rtol=0.0):
        def check(path, got, want):
            np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=path)
        return check

    if mode == "dsba":
        moved = elementwise(STEPS * lr * GRAD_TOL)
        for key in ("params", "params_prev"):
            _walk(state[key], jstate[key], moved)
        _walk(state["g_prev"], jstate["g_prev"], elementwise(GRAD_TOL, GRAD_TOL))
        _walk(state["opt"], jstate["opt"], elementwise(0.0))  # untouched: zeros
    else:
        moved = elementwise(STEPS * lr)
        _walk(state["params"], jstate["params"], moved)

        def update(path, got, want, p0=_flat(start)):
            du_mine, du_theirs = got - p0[path], want - p0[path]
            rel = np.linalg.norm(du_mine - du_theirs) / np.linalg.norm(du_theirs)
            assert rel < UPDATE_TOL, (path, rel)

        _walk(state["params"], jstate["params"], update)

        def moments(path, got, want):
            rel = np.linalg.norm(got - want) / np.linalg.norm(want)
            assert rel < UPDATE_TOL, (path, rel)

        _walk(state["opt"], jstate["opt"], moments)
    if compression != "none":
        _walk(state["recon"], jstate["recon"], moved)
    if compression != "none" and mode != "allreduce":  # allreduce exchanges nothing
        assert m["wire_bytes_per_pod"] == G.wire_bytes_per_pod(
            [t.shape[1:] for t in tree_leaves(state["params"])], gc)


def _flat(tree, prefix=()):
    out = {}
    for key, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, (*prefix, key)))
        else:
            out["/".join((*prefix, key))] = np.asarray(v, np.float64)
    return out


def test_consensus_distance_matches_jax():
    _, _, _, _, jgc, _, _, _ = _setup("toy", "dsgd", "none")
    rng = np.random.default_rng(7)
    tree = {"a": rng.standard_normal((4, 6, 5)).astype(np.float32),
            "b": {"c": rng.standard_normal((4, 9)).astype(np.float32)}}
    np.testing.assert_allclose(float(G.consensus_distance(_torch(tree))),
                               float(JG.consensus_distance(jax.tree_util.tree_map(
                                   jnp.asarray, tree))), rtol=1e-6)


def test_dsba_step_refuses_aliased_state():
    cfg = C.get_reduced("gemma2-2b")
    tc, gc = TrainConfig(), G.GossipConfig(n_pods=2)
    state = G.init_gossip_state(cfg, tc, gc, 0, "cpu")
    for a, b in zip(tree_leaves(state["params"]), tree_leaves(state["params_prev"])):
        assert a.data_ptr() != b.data_ptr() and torch.equal(a, b)
    state["params_prev"] = state["params"]
    with pytest.raises(ValueError, match="share storage"):
        G.make_gossip_train_step(None, cfg, tc, gc)(state, _batch(cfg.vocab_size, 2))


def test_state_defs_and_conversion():
    """init_gossip_state's leaves have gossip_state_defs' shapes and dtypes;
    the numpy round trip is exact; a wrong shape is refused."""
    cfg = C.get_reduced("gemma2-2b")
    tc = TrainConfig()
    gc = G.GossipConfig(n_pods=2, mode="dsba", compression="block_topk")
    state = G.init_gossip_state(cfg, tc, gc, 0, "cpu")
    defs = G.gossip_state_defs(cfg, tc, gc)
    tree_map(lambda p, s, t: (tuple(t.shape), t.dtype) == (tuple(s.shape), s.dtype)
             or pytest.fail("/".join(p)), defs, state)
    assert state["recon"]["embed"].shape == (2, 3, 256, 64)
    back = gossip_state_from_numpy(cfg, gc, gossip_state_to_numpy(state), "cpu")
    tree_map(lambda p, a, b: torch.equal(a, b) or pytest.fail("/".join(p)), state, back)
    bad = gossip_state_to_numpy(state)
    bad["g_prev"]["final_norm"] = np.zeros((3, 64), np.float32)
    with pytest.raises(ValueError, match="g_prev/final_norm"):
        gossip_state_from_numpy(cfg, gc, bad, "cpu")


# ---------------------------------------------------------------------------
# elastic membership and checkpoints
# ---------------------------------------------------------------------------

def _jax_state_after_a_step(n_pods=4):
    jcfg, pcfg, jtc, _, jgc, gc, _, _ = _setup("toy", "dsba", "topk")
    jgc = dataclasses.replace(jgc, n_pods=n_pods)
    gc = dataclasses.replace(gc, n_pods=n_pods)
    jstate = JG.init_gossip_state(jcfg, jtc, jgc, jax.random.PRNGKey(0))
    jstep = jax.jit(JG.make_gossip_train_step(None, jcfg, jtc, jgc))
    batch = _batch(pcfg.vocab_size, n_pods, seed=3)
    jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    return pcfg, jgc, gc, jstate


def test_elastic_shrink_and_grow_match_jax():
    pcfg, jgc, gc, jstate = _jax_state_after_a_step()
    state = gossip_state_from_numpy(pcfg, gc, _np(jstate), "cpu")
    exact = lambda p, g, w: np.testing.assert_array_equal(g, w, err_msg=p)  # noqa: E731
    for dead in ([2], [0, 3]):
        mine, gc_m = ElasticGossip(gc).shrink(state, dead=dead)
        theirs, gc_t = JElastic(jgc).shrink(jstate, dead=dead)
        assert gc_m.n_pods == gc_t.n_pods == 4 - len(dead)
        _walk(mine, theirs, exact)
    mine, gc_m = ElasticGossip(gc).grow(state, n_new=2, seed_from=1)
    theirs, gc_t = JElastic(jgc).grow(jstate, n_new=2, seed_from=1)
    assert gc_m.n_pods == gc_t.n_pods == 6
    _walk(mine, theirs, exact)
    # training continues on the shrunk state
    shrunk, gc3 = ElasticGossip(gc).shrink(state, dead=[1])
    tc = TrainConfig(optimizer=AdamConfig(lr=0.5, warmup_steps=1))
    shrunk, m = G.make_gossip_train_step(None, pcfg, tc, gc3)(
        shrunk, _batch(pcfg.vocab_size, 3, seed=4))
    assert np.isfinite(float(m["loss"])) and shrunk["params"]["embed"].shape[0] == 3


def test_heartbeat_monitor_as_in_test_ft():
    hb = HeartbeatMonitor(3, timeout=2)

    def tick_with_live(n=1):
        out = []
        for _ in range(n):
            hb.heartbeat(0)
            hb.heartbeat(1)  # pod 2 silent
            out = hb.tick()
        return out

    assert tick_with_live(2) == [2]
    assert tick_with_live() == []  # each death reported once
    hb.heartbeat(2)  # a late heartbeat resurrects
    assert tick_with_live() == []
    assert tick_with_live() == [2]
    with pytest.raises(KeyError, match="not monitored"):
        hb.remove(7)
    with pytest.raises(ValueError, match="already monitored"):
        hb.add(1)
    hb.remove(2)
    with pytest.raises(KeyError, match="not monitored"):
        hb.remove(2)
    hb.add(2)
    assert tick_with_live() == []
    assert tick_with_live() == [2]


def test_bounded_staleness_buffer_as_in_test_ft():
    buf = BoundedStalenessBuffer(max_staleness=2)
    buf.deliver(1, "v0")
    assert buf.get(1) == "v0"
    buf.advance()
    buf.advance()
    assert buf.get(1) == "v0"  # age 2 == max_staleness: still usable
    buf.advance()
    assert buf.get(1) is None
    assert buf.get(9) is None


def test_gossip_checkpoints_cross_between_packages(tmp_path):
    """A JAX gossip state (dsba + topk, after one step) written by
    repro.ckpt is read by the port, and the port's written by the port is
    read by repro.ckpt; both bit-equal."""
    pcfg, _, gc, jstate = _jax_state_after_a_step()
    jax_save(tmp_path / "jax", 1, jstate)
    like = G.init_gossip_state(pcfg, TrainConfig(), gc, 1, "cpu")
    mine, step = restore_checkpoint(tmp_path / "jax", like)
    assert step == 1 and int(mine["step"]) == 1 and mine["step"].dtype == torch.int32
    _walk(mine, jstate, lambda p, g, w: np.testing.assert_array_equal(g, w, err_msg=p))
    save_checkpoint(tmp_path / "port", 1, mine)
    back, step = jax_restore(tmp_path / "port", jstate)
    assert step == 1
    jax.tree_util.tree_map(lambda a, b: np.testing.assert_array_equal(np.asarray(a),
                                                                      np.asarray(b)),
                           back, jstate)


# ---------------------------------------------------------------------------
# behaviour (the port's own runs of test_gossip.py's checks)
# ---------------------------------------------------------------------------

def _toy(mode, compression="none"):
    cfg = dataclasses.replace(C.get_reduced("minitron_8b"), n_layers=1)
    lr = 0.5 if mode == "dsba" else 1e-2
    tc = TrainConfig(optimizer=AdamConfig(lr=lr, warmup_steps=1))
    gc = G.GossipConfig(n_pods=4, mode=mode, compression=compression, topk_ratio=0.25)
    state = G.init_gossip_state(cfg, tc, gc, 0, "cpu")
    return cfg, gc, state, G.make_gossip_train_step(None, cfg, tc, gc)


@pytest.mark.parametrize("mode,compression,steps", [
    ("allreduce", "none", 30), ("dsgd", "none", 30), ("dsba", "none", 80),
    ("dsba", "topk", 80), ("dsgd", "topk", 40), ("dsgd", "block_topk", 40)])
def test_gossip_reduces_loss(mode, compression, steps):
    cfg, gc, state, step = _toy(mode, compression)
    losses, dists = [], []
    for i in range(steps):
        state, m = step(state, _batch(cfg.vocab_size, 4, seed=100 + i % 3))
        losses.append(float(m["loss"]))
        dists.append(float(G.consensus_distance(state["params"])))
    assert losses[-1] < losses[0] * 0.9, losses[::10]
    assert np.isfinite(losses[-1]) and np.isfinite(dists[-1])


def test_allreduce_keeps_exact_consensus():
    cfg, gc, state, step = _toy("allreduce")
    for i in range(5):
        state, _ = step(state, _batch(cfg.vocab_size, 4, seed=i))
    assert float(G.consensus_distance(state["params"])) < 1e-9


@pytest.mark.parametrize("mode", ["dsgd", "dsba"])
def test_gossip_consensus_stays_bounded(mode):
    """Different data on every pod and step: the replicas drift, and the
    mixing keeps them within a bounded neighbourhood."""
    cfg, gc, state, step = _toy(mode)
    dists = []
    for i in range(40):
        state, _ = step(state, _batch(cfg.vocab_size, 4, seed=200 + i))
        dists.append(float(G.consensus_distance(state["params"])))
    assert np.isfinite(dists[-1])
    assert np.mean(dists[-5:]) < 10 * np.mean(dists[10:20]) + 1e-6


def test_example_shrinks_and_resumes_bit_equal(tmp_path):
    """python -m repro_torch.examples.train_lm_gossip on the CPU: 12 steps, a
    pod killed at step 5 (4 -> 3 pods), checkpoints at steps 4 and 8; the
    final checkpoint dropped (a crash after step 8's), a second run resumes
    from step 8 with 3 pods and ends bit-equal."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    cmd = [sys.executable, "-m", "repro_torch.examples.train_lm_gossip", "--device", "cpu",
           "--steps", "12", "--kill-pod-at", "5", "--ckpt-every", "4", "--seq", "32",
           "--compression", "topk", "--ckpt-dir", str(tmp_path)]

    def run():
        r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode == 0, r.stderr[-3000:]
        return r.stdout

    out = run()
    assert "[ft] pod killed at step 5: continuing with 3 pods" in out
    assert committed_steps(tmp_path) == [4, 8, 12]
    _, meta, full = load_checkpoint(tmp_path, 12)
    assert meta == {"n_pods": 3} and full["['params']/['embed']"].shape[0] == 3
    assert load_checkpoint(tmp_path, 4)[1] == {"n_pods": 4}
    for f in (tmp_path / "step_12").iterdir():
        f.unlink()
    (tmp_path / "step_12").rmdir()
    out = run()
    assert "pods=3" in out and "resumed from step 8" in out
    _, _, resumed = load_checkpoint(tmp_path, 12)
    assert set(resumed) == set(full)
    differ = [p for p in full if full[p].tobytes() != resumed[p].tobytes()]
    assert not differ, differ
    losses = [float(line.split()[3]) for line in out.splitlines() if line.startswith("step")]
    assert losses and np.isfinite(losses).all()
