"""The gossip ``ppermute`` backend of ``repro_torch.core.gossip``: one rank a
pod (``launch.mesh.NodeMesh`` workers in one gloo group, on the CPU here).

The JAX package's own pod-axis backend (``shard_map`` + ``ppermute``) does
not run on this container (``shard_map ... check_rep``, ROADMAP Queue 3),
and the reference documents its two backends as identical (tested equal
there, leaves replicated within a pod). So the ranks are held to the JAX
package's ``mesh=None`` functions at tests/test_torch_gossip.py's bars and
to the port's own local backend bit for bit: the dense mix (float64, 1e-12
against JAX), the topk and block_topk exchanges, and a 3-step trajectory
of every mode x compression. Sizes are test_torch_gossip.py's: reduced
gemma2-2b on 2 pods (2 ranks) and the 1-layer toy on 4 pods (4 ranks); the
trajectories against JAX run on gemma2-2b (the toy's local steps are held
to JAX by test_torch_gossip.py, and its ranks to those steps here). Also:
the bytes each rank sends, ``gossip_batch_specs``, a wrong-size mesh, the
state handle, ranks that load no JAX, and chip_smoke's ``--gossip-ranks``
checks at a tiny size.

The meshes are built once for the module and closed at its end.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_gossip as TG
from repro.configs import get_reduced as jax_get_reduced
from repro.core import gossip as JG
from repro_torch import configs as C
from repro_torch.convert import gossip_state_from_numpy
from repro_torch.core import gossip as G
from repro_torch.launch import mesh as TMesh
from repro_torch.models import transformer as T
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.optim.adam import AdamConfig
from repro_torch.train.step import TrainConfig

CPU = torch.device("cpu")
DENSE_TOL = 1e-12  # float64 mixing against JAX: one rounding apart at most
TOPOLOGIES = [(2, "ring"), (4, "ring"), (4, "exponential")]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's CPU threads are unsteady beside JAX (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def meshes():
    """n -> the registry's mesh of n CPU ranks (built once, rebuilt if a
    test closed it); every mesh is closed at the module's end and none of
    their workers may outlive it."""
    yield lambda n: TMesh.make_node_mesh(n, CPU)
    procs = [p for m in TMesh._MESHES.values() for p in m._procs]
    TMesh.close_all()
    assert not TMesh._MESHES
    assert not any(p.is_alive() for p in procs)


def _same_bits(got, want):
    """Two port trees (or a tree and a tuple of trees) bit-equal, leaf by leaf."""
    bad = []
    tree_map(lambda p, a, b: torch.equal(a, b) or bad.append("/".join(p)), got, want)
    assert not bad, bad


def _jnp(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


# ---------------------------------------------------------------------------
# the exchanges
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_pods,topology", TOPOLOGIES)
def test_dense_mix_over_ranks_matches_jax_and_local(meshes, n_pods, topology):
    gc = G.GossipConfig(n_pods=n_pods, topology=topology)
    src, _ = TG._exchange_inputs(n_pods, 1)
    src = tree_map(lambda _, a: a.astype(np.float64), src)
    mix = G.make_dense_mix(meshes(n_pods), gc)
    got = mix(TG._torch(src))
    assert tree_leaves(got)[0].dtype == torch.float64
    want = JG.make_dense_mix(None, JG.GossipConfig(n_pods=n_pods, topology=topology), None)(
        _jnp(src))
    TG._walk(got, want, lambda p, g, w: np.testing.assert_allclose(
        g, w, rtol=DENSE_TOL, atol=DENSE_TOL, err_msg=p))
    _same_bits(got, G.make_dense_mix(None, gc)(TG._torch(src)))
    # each rank sent its whole row once a shift and direction
    n_dir = 2 * len(gc.shifts_and_weights()[0])
    row_bytes = sum(8 * a[0].size for a in tree_leaves(src))
    assert [r["sent_bytes"] for r in mix.ranks] == [n_dir * row_bytes] * n_pods


@pytest.mark.parametrize("compression", ["topk", "block_topk"])
@pytest.mark.parametrize("n_pods,topology", TOPOLOGIES)
def test_topk_exchange_over_ranks_matches_jax_and_local(meshes, n_pods, topology,
                                                        compression):
    """Corrections and reconstructions; only the (values, indices) streams
    cross, so each rank sends 2 x shifts x the closed-form wire bytes."""
    kw = dict(n_pods=n_pods, topology=topology, compression=compression,
              topk_ratio=0.1, block_size=64)
    gc, jgc = G.GossipConfig(**kw), JG.GossipConfig(**kw)
    ns = 1 + 2 * len(gc.shifts_and_weights()[0])
    src, rec = TG._exchange_inputs(n_pods, ns, seed=1)
    exchange = G.make_topk_exchange(meshes(n_pods), gc)
    rec_t = TG._torch(rec)
    corr, new_rec = exchange(TG._torch(src), rec_t)
    assert new_rec is rec_t  # the rows came back into the caller's tree
    jcorr, jrec = JG.make_topk_exchange(None, jgc, None)(_jnp(src), _jnp(rec))
    for mine, theirs in ((corr, jcorr), (new_rec, jrec)):
        TG._walk(mine, theirs, lambda p, g, w: np.testing.assert_allclose(
            g, w, rtol=TG.EXCHANGE_TOL, atol=TG.EXCHANGE_TOL, err_msg=p))
    lcorr, lrec = G.make_topk_exchange(None, gc)(TG._torch(src), TG._torch(rec))
    _same_bits(corr, lcorr)
    _same_bits(new_rec, lrec)
    wire = G.wire_bytes_per_pod([a.shape[1:] for a in tree_leaves(src)], gc)
    n_dir = ns - 1
    assert [r["sent_bytes"] for r in exchange.ranks] == [n_dir * wire] * n_pods


# ---------------------------------------------------------------------------
# trajectories: every mode x compression
# ---------------------------------------------------------------------------

def _rank_trajectory(mesh, pcfg, tc, gc, state0, n_pods):
    """STEPS steps over the ranks from a pod-stacked state; (state, metrics
    of each step)."""
    handle = G.scatter_gossip_state(mesh, gc, state0)
    step = G.make_gossip_train_step(mesh, pcfg, tc, gc)
    ms = []
    for i in range(TG.STEPS):
        handle, m = step(handle, TG._batch(pcfg.vocab_size, n_pods, seed=i), check=i == 0)
        ms.append(m)
    state = G.gather_gossip_state(handle, "cpu")
    handle.close()
    return state, ms


def _hold_ranks_to_local(pcfg, tc, gc, state0, state, ms, n_pods):
    """The ranks' state bit-equal to the local step's from the same start,
    their losses equal, grad norms within float32 summation order, and
    with an exchange the bytes each rank sent 2 x shifts x the wire bytes."""
    local = G.make_gossip_train_step(None, pcfg, tc, gc)
    lstate = state0
    for i in range(TG.STEPS):
        lstate, lm = local(lstate, TG._batch(pcfg.vocab_size, n_pods, seed=i))
        assert float(ms[i]["loss"]) == float(lm["loss"])
        np.testing.assert_allclose(float(ms[i]["grad_norm"]), float(lm["grad_norm"]), rtol=1e-6)
        assert ms[i].get("wire_bytes_per_pod") == lm.get("wire_bytes_per_pod")
    assert set(state) == set(lstate)
    _same_bits(state, lstate)
    n_dir = 2 * len(gc.shifts_and_weights()[0])
    if gc.mode == "allreduce":  # the gradients gathered: (n - 1) rows a leaf
        leaf = 4 * sum(t[0].numel() for t in tree_leaves(lstate["params"]))
        want = (n_pods - 1) * leaf
    elif gc.compression == "none":  # dense mix: a whole row a direction
        want = n_dir * 4 * sum(t[0].numel() for t in tree_leaves(lstate["params"]))
    else:
        want = n_dir * lm["wire_bytes_per_pod"]
    assert all(m["sent_bytes"] == [want] * n_pods for m in ms)
    # step 0 checked every stream a rank received against its peer's
    n_leaves = len(tree_leaves(lstate["params"]))
    shifted = gc.mode != "allreduce"  # allreduce gathers gradients, shifts nothing
    assert ms[0]["streams_checked"] == (n_pods * n_leaves * n_dir if shifted else 0)
    # step 0 held every kernel call to its plain version (on the CPU the
    # wrapper runs the plain version itself: bit-equal); one block_topk a leaf
    selects = gc.compression == "block_topk" and shifted
    for r in ms[0]["ranks"]:
        assert set(r["held"]) == {"block_topk", "flash_attention", "flash_attention_bwd"}
        assert all(all(h["exact"]) for h in r["held"].values())
        assert len(r["held"]["block_topk"]["exact"]) == (n_leaves if selects else 0)
    assert all(r["held"] is None for m in ms[1:] for r in m["ranks"])


@pytest.mark.parametrize("compression", ["none", "topk", "block_topk"])
@pytest.mark.parametrize("mode", ["dsba", "dsgd", "allreduce"])
def test_rank_trajectory_matches_jax_and_local(meshes, mode, compression):
    """Reduced gemma2-2b on 2 ranks, from the JAX package's initial state."""
    jcfg, pcfg, jtc, tc, jgc, gc, lr, n_pods = TG._setup("gemma2", mode, compression)
    jstate = JG.init_gossip_state(jcfg, jtc, jgc, jax.random.PRNGKey(0))
    start = TG._np(jstate["params"])
    state0 = gossip_state_from_numpy(pcfg, gc, TG._np(jstate), "cpu")
    state, ms = _rank_trajectory(meshes(n_pods), pcfg, tc, gc, state0, n_pods)
    jstep = jax.jit(JG.make_gossip_train_step(None, jcfg, jtc, jgc))
    for i in range(TG.STEPS):
        batch = TG._batch(pcfg.vocab_size, n_pods, seed=i)
        jstate, jm = jstep(jstate, _jnp(batch))
        np.testing.assert_allclose(float(ms[i]["loss"]), float(jm["loss"]), rtol=1e-5)
        if i == 0:
            np.testing.assert_allclose(float(ms[i]["grad_norm"]), float(jm["grad_norm"]),
                                       rtol=TG.GRAD_TOL)
    TG._hold_to_jax(mode, compression, lr, gc, state, jstate, ms[-1], start)
    _hold_ranks_to_local(pcfg, tc, gc, state0, state, ms, n_pods)


@pytest.mark.parametrize("compression", ["none", "topk", "block_topk"])
@pytest.mark.parametrize("mode", ["dsba", "dsgd", "allreduce"])
def test_rank_trajectory_on_4_ranks_matches_local(meshes, mode, compression):
    """The toy config on 4 ranks (shifts whose sender and receiver differ),
    from the port's own initial state drawn on each rank."""
    _, pcfg, _, tc, _, gc, _, n_pods = TG._setup("toy", mode, compression)
    state0 = G.init_gossip_state(pcfg, tc, gc, 3, "cpu")
    handle = G.init_gossip_state(pcfg, tc, gc, 3, "cpu", mesh=meshes(n_pods))
    _same_bits(G.gather_gossip_state(handle, "cpu"), state0)
    handle.close()
    state, ms = _rank_trajectory(meshes(n_pods), pcfg, tc, gc, state0, n_pods)
    _hold_ranks_to_local(pcfg, tc, gc, state0, state, ms, n_pods)


# ---------------------------------------------------------------------------
# the rest of the mesh API
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["gemma2_2b", "whisper_small"])
def test_gossip_batch_specs_equal_jax(arch):
    mine = G.gossip_batch_specs(C.get_reduced(arch))
    theirs = JG.gossip_batch_specs(jax_get_reduced(arch))
    assert mine == {k: tuple(v) for k, v in theirs.items()}
    assert ("enc_embeds" in mine) == (arch == "whisper_small")


def test_wrong_size_mesh_raises(meshes):
    cfg = C.get_reduced("gemma2-2b")
    gc = G.GossipConfig(n_pods=4)
    msg = "n_pods is 4 but the 'pod' mesh has 2 ranks"
    for call in (lambda: G.make_dense_mix(meshes(2), gc),
                 lambda: G.make_topk_exchange(meshes(2), gc),
                 lambda: G.make_gossip_train_step(meshes(2), cfg, TrainConfig(), gc),
                 lambda: G.init_gossip_state(cfg, TrainConfig(), gc, 0, "cpu", mesh=meshes(2)),
                 lambda: G.scatter_gossip_state(meshes(2), gc, {})):
        with pytest.raises(ValueError, match=msg):
            call()
    assert not meshes(2).closed


def test_state_handle_lifecycle_and_consensus(meshes):
    """A rank-held state: its consensus distance equals the local one's on 2
    pods; close() frees it on the ranks and a closed handle is refused; a
    state cannot step on another mesh."""
    cfg = dataclasses.replace(C.get_reduced("gemma2-2b"), compute_dtype=torch.float32)
    tc = TrainConfig(optimizer=AdamConfig(lr=1e-2))
    gc = G.GossipConfig(n_pods=2, compression="topk", topk_ratio=0.25)
    state = G.init_gossip_state(cfg, tc, gc, 1, "cpu")
    handle = G.init_gossip_state(cfg, tc, gc, 1, "cpu", mesh=meshes(2))
    step = G.make_gossip_train_step(meshes(2), cfg, tc, gc)
    local = G.make_gossip_train_step(None, cfg, tc, gc)
    batch = TG._batch(cfg.vocab_size, 2, seed=5)
    handle, _ = step(handle, {k: torch.as_tensor(v) for k, v in batch.items()})
    state, _ = local(state, batch)
    assert float(G.consensus_distance(handle)) == float(G.consensus_distance(state["params"]))
    assert G.pod_digests(handle) == G.pod_digests(state)
    assert G.pod_digests(handle, keys=("params", "recon")) == G.pod_digests(
        state, keys=("params", "recon"))
    got = G.gather_gossip_state(handle, "cpu", keys=("params", "step"))
    assert set(got) == {"params", "step"} and int(got["step"]) == 1
    _same_bits(got["params"], state["params"])
    with pytest.raises(ValueError, match="the gossip state lives on another mesh"):
        G.make_gossip_train_step(meshes(4), cfg, tc, dataclasses.replace(gc, n_pods=4))(
            handle, batch)
    handle.close()
    with pytest.raises(ValueError, match="closed"):
        step(handle, batch)
    handle.close()  # idempotent


def test_ranks_load_no_jax(meshes):
    """The workers import only the port: no JAX library is mapped into a
    rank that has run gossip jobs (this process has JAX loaded)."""
    cfg = C.get_reduced("gemma2-2b")
    gc = G.GossipConfig(n_pods=2)
    handle = G.init_gossip_state(cfg, TrainConfig(), gc, 0, "cpu", mesh=meshes(2))
    G.consensus_distance(handle)
    handle.close()
    for pid in meshes(2).pids():
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
        assert "libtorch" in maps and "jaxlib" not in maps, pid


def test_chip_smoke_gossip_ranks_phase_on_cpu(meshes):
    """chip_smoke's --gossip-ranks checks at a tiny size: reduced gemma2-2b,
    2 ranks on the CPU, block_topk, 3 steps (the params gathered through
    the pipes) and 2 uncompressed (the params' digests)."""
    import chip_smoke

    cfg = C.get_reduced("gemma2-2b")
    _, tc, gc = chip_smoke.gossip_setup()
    setup = (cfg, tc, dataclasses.replace(gc, kernel_mode="auto"))
    dense = (cfg, tc, dataclasses.replace(setup[2], compression="none"))
    out = chip_smoke.gossip_ranks_checks(CPU, setup, steps=3, dense_steps=2, s=16)
    ref = chip_smoke.gossip_trajectory(CPU, setup, 3, 3, s=16, host_params=True)
    dense_ref = chip_smoke.gossip_trajectory(CPU, dense, 2, 2, s=16)
    held = chip_smoke.hold_ranks_to_local(out, ref, dense_ref)
    assert held["params"]["bit_equal"] and held["dense_params"]["bit_equal"]
    # a leaf whose bits differ on one rank is caught: in the params gathered
    # through the pipes, and in the dense run's digests
    out["params"]["final_norm"][1, 0] += 1.0
    with pytest.raises(AssertionError, match="not the local run's"):
        chip_smoke.hold_ranks_to_local(out, ref, dense_ref)
    out["params"]["final_norm"][1, 0] -= 1.0
    out["dense_params"][1]["params/final_norm"] = ("0" * 64, 1.0)
    with pytest.raises(AssertionError, match="not the local run's"):
        chip_smoke.hold_ranks_to_local(out, ref, dense_ref)
    n_leaves = len(tree_leaves(T.model_defs(cfg)))
    assert out["rows"][0]["streams_checked"] == 2 * 2 * n_leaves
    assert out["bytes_a_rank"]["dense"] == 2 * 4 * sum(
        int(np.prod(d.shape)) for d in tree_leaves(T.model_defs(cfg)))
    assert (2, "cpu") not in TMesh._MESHES
