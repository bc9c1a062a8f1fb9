"""``comm="sharded"`` in ``repro_torch`` against ``repro``'s dense path.

The reference's own sharded tier (``tests/multidevice/``) pins its sharded
runs to its dense ones at 1e-12; its sharded path does not run on this
container's jax, so the port's sharded runs are held to the JAX
package's DENSE ``solve`` at the same bars, on the same inputs (numpy
seeds, ``tests/multidevice/test_sharded_inner.py``'s problems): every
sharded-capable method on a ring and ER(0.4) at N = 8, DSGDA on the
bilinear saddle, link faults, a schedule and a churn kill. Also: the edge
colouring equals the reference's; the capability matrix agrees with the
JAX record; the collective counts follow the reference's counting rule
(worked out by hand: a ring has 2 colours, DSBA mixes twice a step); the
mesh and runner-cache keys; the reference's error texts; ``solve_many``;
a failing rank; and no worker outlives ``close()``.

The ranks run on the CPU in their own processes (gloo), one torch thread
each; the meshes are built once for the module and closed at its end.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import comm as JC
from repro.core import mixing as JM
from repro.core import solvers as JS
from repro.data.synthetic import make_classification, make_regression
from repro_torch.core import comm as TC
from repro_torch.core import mixing as TM
from repro_torch.core import runner_cache
from repro_torch.core import solvers as TS
from repro_torch.core.operators import FAMILIES
from repro_torch.launch import mesh as TMesh

N = 8
TOL = 1e-12
CPU = torch.device("cpu")
# tests/multidevice/test_sharded_inner.py's METHOD_HP
METHOD_HP = {
    "dsba": {"alpha": 0.05},
    "dsa": {"alpha": 0.05},
    "extra": {"alpha": 0.05},
    "dlm": {"c": 0.5, "beta": 1.0},
    "ssda": {"eta": 0.05},
    "mudag": {"eta": 0.5, "momentum": 0.5, "gossip_rounds": 2},
    "sliding": {"alpha": 0.05, "comm_period": 2},
}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's CPU threads are unsteady beside JAX (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    """The module's mesh of 8 ranks on the CPU; every mesh (those of the
    churn and capability checks too) is closed at the module's end, and
    none of their workers may outlive that."""
    m = TMesh.make_node_mesh(N, CPU)
    yield m
    procs = [p for mm in TMesh._MESHES.values() for p in mm._procs]
    TMesh.close_all()
    assert not TMesh._MESHES
    assert not any(p.is_alive() for p in procs)


@functools.cache
def _problems(topology, n=N, solve_star=True):
    data = make_regression(n, 12, 6, k=4, seed=0)
    if topology == "ring":
        jg, tg = JM.ring_graph(n), TM.ring_graph(n)
    else:
        jg, tg = JM.erdos_renyi_graph(n, 0.4, seed=1), TM.erdos_renyi_graph(n, 0.4, seed=1)
    jp = JS.make_problem("ridge", data, jg, lam=1e-2)
    tp = TS.make_problem("ridge", data, tg, lam=1e-2)
    if solve_star:
        tp.z_star = jp.solve_star()
    return jp, tp


def _assert_close(j, t, z_tol=TOL):
    np.testing.assert_allclose(t.z, np.asarray(j.z), atol=z_tol, rtol=0, err_msg="z")
    np.testing.assert_allclose(t.dist2, np.asarray(j.dist2), atol=z_tol, rtol=1e-9,
                               err_msg="dist2")
    np.testing.assert_array_equal(t.iters, np.asarray(j.iters))
    np.testing.assert_array_equal(t.doubles_received, np.asarray(j.doubles_received))


# ---------------------------------------------------------------------------
# the edge colouring and the partition of a state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("graph", ["ring", "erdos_renyi", "complete", "torus"])
def test_edge_coloring_equals_reference(graph):
    make = {
        "ring": lambda M: M.ring_graph(9),
        "erdos_renyi": lambda M: M.erdos_renyi_graph(12, 0.4, seed=3),
        "complete": lambda M: M.complete_graph(7),
        "torus": lambda M: M.torus_graph(3, 4),
    }[graph]
    jg, tg = make(JM), make(TM)
    assert tg.edges == jg.edges
    colors = TC.edge_coloring(tg.edges, tg.n)
    assert colors == JC.edge_coloring(jg.edges, jg.n)
    for color in colors:  # each colour is a matching
        nodes = [x for e in color for x in e]
        assert len(nodes) == len(set(nodes))


def test_node_partition_rows_scalars_and_refusal():
    state = (torch.arange(12.0).reshape(4, 3), torch.tensor(7), 5,
             {"w": torch.ones(4, 2, 2)})
    part = TS._node_partition(state, 4, 2)
    assert torch.equal(part[0], torch.tensor([[6.0, 7.0, 8.0]]))
    assert part[1] is state[1] and part[2] == 5
    assert part[3]["w"].shape == (1, 2, 2)
    parts = [TS._state_to_numpy(TS._node_partition(state, 4, r)) for r in range(4)]
    whole = TS._join_parts(parts)
    np.testing.assert_array_equal(whole[0], state[0].numpy())
    assert whole[1] == 7 and whole[2] == 5
    with pytest.raises(ValueError, match="no leading node axis"):
        TS._node_partition((torch.ones(3, 4),), 4, 0)


# ---------------------------------------------------------------------------
# every sharded-capable method against the JAX package's dense solve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("topology", ["ring", "erdos_renyi"])
@pytest.mark.parametrize("method", sorted(METHOD_HP))
def test_sharded_matches_jax_dense(mesh, method, topology):
    jp, tp = _problems(topology)
    hp = METHOD_HP[method]
    kw = dict(steps=20, record_every=10, seed=1)
    rj = JS.solve(jp, method, comm="dense", **kw, **hp)
    rs = TS.solve(tp, method, comm="sharded", comm_options={"mesh": mesh}, **kw, **hp)
    _assert_close(rj, rs)
    assert rs.comm == "sharded" and rs.extras["mesh_devices"] == N
    # the gathered final state's iterate is the returned z
    z_state = rs.state.z if dataclasses.is_dataclass(rs.state) else rs.state[0]
    if method != "ssda":  # SSDA's state is its dual; z is read out
        np.testing.assert_array_equal(z_state.numpy(), rs.z)


def test_dsgda_sharded_matches_jax_dense_on_bilinear(mesh):
    data = make_regression(N, 12, 6, k=4, seed=2)
    jp = JS.make_problem("bilinear", data, JM.ring_graph(N), lam=5e-2)
    tp = TS.make_problem("bilinear", data, TM.ring_graph(N), lam=5e-2)
    tp.z_star = jp.solve_star()
    kw = dict(steps=20, record_every=10, seed=1, alpha=0.2, eta=0.2)
    rj = JS.solve(jp, "dsgda", comm="dense", **kw)
    rs = TS.solve(tp, "dsgda", comm="sharded", comm_options={"mesh": mesh}, **kw)
    _assert_close(rj, rs)


@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_capability_matrix_agrees_with_jax_record(family):
    """Every (method, family) on a 4-node ring either solves under
    comm="sharded" (finite iterates) or raises CapabilityError, exactly as
    the JAX package's record says."""
    n, q, d = 4, 4, 6
    hp = {"ssda": dict(eta=1e-3, momentum=0.0), "mudag": dict(eta=0.5, momentum=0.5)}
    if family in ("ridge", "bilinear"):
        data = make_regression(n, q, d, k=3, seed=0)
    else:
        data = make_classification(n, q, d, k=3, positive_ratio=0.5, seed=0)
    problem = TS.make_problem(family, data, TM.ring_graph(n), lam=1e-2)
    record = JS.available_solvers()
    for method in sorted(record):
        try:
            res = TS.solve(problem, method, comm="sharded", steps=2, record_every=2, seed=0,
                           device=CPU, **hp.get(method, {}))
        except TS.CapabilityError as e:
            assert not record[method].supports("sharded", family), (method, family)
            assert (e.method, e.comm, e.family) == (method, "sharded", family)
            continue
        assert record[method].supports("sharded", family), (method, family)
        assert np.isfinite(res.z).all(), (method, family)


# ---------------------------------------------------------------------------
# collective accounting, the mesh and the runner cache, errors
# ---------------------------------------------------------------------------


def test_measured_collective_bytes_accounting(mesh):
    """The reference's counting rule: a ring has 2 colours and DSBA mixes
    twice a step, so 4 exchanges of one (1, D) float64 block a device and
    step; ER's colours are more. Linear in the iterations; dense: None."""
    res = {}
    for topology in ("ring", "erdos_renyi"):
        _, tp = _problems(topology)
        r = TS.solve(tp, "dsba", "sharded", steps=20, record_every=5, seed=1, alpha=0.05,
                     comm_options={"mesh": mesh})
        mb = r.measured_collective_bytes
        assert mb.shape == r.iters.shape and (mb > 0).all()
        np.testing.assert_allclose(mb / r.iters, mb[0] / r.iters[0], rtol=0, atol=0)
        col = r.extras["collectives"]
        n_col = len(TC.edge_coloring(tp.graph.edges, N))
        block = tp.dim * 8
        assert col == {
            "bytes_per_iter": 2.0 * n_col * block, "count_per_iter": 2.0 * n_col,
            "bytes_by_op": {"collective-permute": 2.0 * n_col * block},
            "count_by_op": {"collective-permute": 2.0 * n_col},
        }
        assert r.extras["mesh_devices"] == N
        res[topology] = r
    assert res["ring"].extras["collectives"]["count_per_iter"] == 4
    assert (res["erdos_renyi"].extras["collectives"]["bytes_per_iter"]
            > res["ring"].extras["collectives"]["bytes_per_iter"])
    # the bytes that really crossed: one block a partner a mix, 2 partners
    # a node on the ring
    sent = [rk["sent_bytes"] for rk in res["ring"].extras["ranks"]]
    assert sent == [20 * 2 * 2 * _problems("ring")[1].dim * 8] * N
    rd = TS.solve(_problems("ring")[1], "dsba", steps=4, seed=1, alpha=0.05, device=CPU)
    assert rd.measured_collective_bytes is None


def test_mesh_and_runner_cache_key(mesh):
    """One miss on the first call, then hits for a new alpha on the same
    mesh, with a different z; the key carries (n, device, ranks)."""
    _, tp = _problems("ring")
    kw = dict(steps=8, seed=1, comm_options={"mesh": mesh})
    TS.clear_runner_caches()
    before = runner_cache.SHARDED.stats()
    r1 = TS.solve(tp, "dsba", "sharded", alpha=0.05, **kw)
    mid = runner_cache.SHARDED.stats()
    r2 = TS.solve(tp, "dsba", "sharded", alpha=0.1, **kw)
    after = runner_cache.SHARDED.stats()
    assert mid["misses"] == before["misses"] + 1
    assert after["misses"] == mid["misses"] and after["hits"] == mid["hits"] + 1
    assert after["traces"] == mid["traces"]
    assert not np.array_equal(r1.z, r2.z)
    assert runner_cache.mesh_fingerprint(mesh) == (N, "cpu", mesh.ranks)
    assert TMesh.make_node_mesh(N, "cpu") is mesh  # the registry's


def test_sharded_rejects_wrong_mesh_and_options(mesh):
    _, tp = _problems("ring")
    _, tp4 = _problems("ring", n=4, solve_star=False)
    with pytest.raises(ValueError, match="node"):
        TC.ShardedComm(tp4.graph, mesh)
    with pytest.raises(ValueError, match="node"):
        TS.solve(tp4, "dsba", "sharded", steps=2, comm_options={"mesh": mesh})
    with pytest.raises(ValueError, match="comm_options"):
        TS.solve(tp, "dsba", steps=2, device=CPU, comm_options={"mesh": mesh})
    with pytest.raises(ValueError, match="unknown sharded comm_options"):
        TS.solve(tp, "dsba", "sharded", steps=2, device=CPU,
                 comm_options={"engine": "vectorized"})
    with pytest.raises(ValueError, match="not checkpointable"):
        TS.solve(tp, "dsba", "sharded", steps=2, device=CPU, resume="/nonexistent")
    with pytest.raises(TS.CapabilityError, match="stragglers"):
        TS.solve(tp, "dsba", "sharded", steps=2, device=CPU, comm_options={
            "fault_plan": TS.FaultPlan(straggler=TS.StragglerSpec(p=0.2))})
    with pytest.raises(ValueError, match="runs on cpu"):
        TS.solve(tp, "dsba", "sharded", steps=2, device="cuda", comm_options={"mesh": mesh})
    with pytest.raises(ValueError, match="edge of the communication graph"):
        TC.ShardedComm(tp.graph, TMesh.NodeRank(0, N, CPU)).matvec(np.ones((N, N)),
                                                                    torch.float64)


# ---------------------------------------------------------------------------
# link faults, schedules, churn
# ---------------------------------------------------------------------------


def test_link_faults_match_jax_dense_and_keep_counted_bytes(mesh):
    jp, tp = _problems("ring")
    kw = dict(steps=24, record_every=4, seed=1)
    rj = JS.solve(jp, "dsba", comm="dense", **kw, comm_options={
        "fault_plan": JS.FaultPlan(link=JS.LinkFault(p=0.2, seed=7))})
    rs = TS.solve(tp, "dsba", "sharded", **kw, comm_options={
        "mesh": mesh, "fault_plan": TS.FaultPlan(link=TS.LinkFault(p=0.2, seed=7))})
    _assert_close(rj, rs)
    assert rs.extras["faults"] == rj.extras["faults"]
    f = rs.extras["faults"]
    assert 0 < f["delivered_messages"] < f["injected_messages"]
    # every exchange still runs: the counted bytes equal the fault-free run's
    r0 = TS.solve(tp, "dsba", "sharded", **kw, comm_options={"mesh": mesh})
    np.testing.assert_array_equal(rs.measured_collective_bytes, r0.measured_collective_bytes)


def test_p0_plan_bit_equal_plan_free(mesh):
    _, tp = _problems("ring")
    kw = dict(steps=20, record_every=5, seed=1)
    r0 = TS.solve(tp, "dsba", "sharded", **kw, comm_options={"mesh": mesh})
    r1 = TS.solve(tp, "dsba", "sharded", **kw, comm_options={
        "mesh": mesh, "fault_plan": TS.FaultPlan(link=TS.LinkFault(p=0.0))})
    assert np.array_equal(r0.z, r1.z) and np.array_equal(r0.dist2, r1.dist2)
    np.testing.assert_array_equal(r0.measured_collective_bytes, r1.measured_collective_bytes)
    f = r1.extras["faults"]
    assert f["drop_rate"] == 0.0 and f["injected_messages"] == f["delivered_messages"] > 0


def test_schedule_matches_jax_dense_across_switch(mesh):
    jp, tp = _problems("ring")
    kw = dict(steps=24, record_every=4, seed=1, alpha=0.05)
    jps = dataclasses.replace(jp, schedule=((0, jp.graph), (12, JM.erdos_renyi_graph(N, 0.4,
                                                                                      seed=1))))
    tps = dataclasses.replace(tp, schedule=((0, tp.graph), (12, TM.erdos_renyi_graph(N, 0.4,
                                                                                      seed=1))))
    rj = JS.solve(jps, "dsba", comm="dense", **kw)
    rs = TS.solve(tps, "dsba", "sharded", **kw, comm_options={"mesh": mesh})
    _assert_close(rj, rs)
    assert [s["spectral_gap"] for s in rs.extras["schedule"]] == pytest.approx(
        [s["spectral_gap"] for s in rj.extras["schedule"]], abs=1e-12)
    mb = rs.measured_collective_bytes
    assert mb.shape == rs.iters.shape and (np.diff(mb) > 0).all()
    # a one-segment schedule is the static run, bit for bit
    one = dataclasses.replace(tp, schedule=((0, tp.graph),))
    r0 = TS.solve(tp, "dsba", "sharded", **kw, comm_options={"mesh": mesh})
    r1 = TS.solve(one, "dsba", "sharded", **kw, comm_options={"mesh": mesh})
    assert np.array_equal(r0.z, r1.z)
    np.testing.assert_array_equal(r0.measured_collective_bytes, r1.measured_collective_bytes)


@pytest.mark.parametrize("method", ["dsba", "dsa"])
def test_churn_kill_matches_jax_dense(mesh, method):
    """Kill two nodes mid-run: the sharded run moves to the registry's mesh
    of 6 ranks and stays within 1e-12 of the dense run."""
    jp, tp = _problems("ring")
    kw = dict(steps=24, record_every=4, seed=1, alpha=0.05)
    rj = JS.solve(jp, method, comm="dense", **kw, comm_options={
        "fault_plan": JS.ChurnPlan((JS.ChurnEvent(at=10, kind="kill", nodes=(6, 7)),))})
    rs = TS.solve(tp, method, "sharded", **kw, comm_options={
        "mesh": mesh,
        "fault_plan": TS.ChurnPlan((TS.ChurnEvent(at=10, kind="kill", nodes=(6, 7)),))})
    assert rs.z.shape == (6, tp.dim)
    _assert_close(rj, rs)
    assert rs.extras["mesh_devices"] == N and rs.extras["churn_rows"] == N
    assert TMesh._MESHES[(6, "cpu")].n == 6
    mb = rs.measured_collective_bytes
    assert mb.shape == rs.iters.shape and (np.diff(mb) > 0).all()


# ---------------------------------------------------------------------------
# solve_many, a failing rank, close()
# ---------------------------------------------------------------------------


def test_solve_many_sharded_equals_one_at_a_time(mesh):
    _, tp = _problems("ring")
    grid = [{"alpha": 0.05}, {"alpha": 0.1}]
    kw = dict(steps=10, record_every=5, comm_options={"mesh": mesh})
    many = TS.solve_many(tp, "dsba", "sharded", grid=grid, seeds=[1, 2], **kw)
    assert many.extras["batched"] is False
    for b, (g, s) in enumerate(zip(grid, (1, 2))):
        one = TS.solve(tp, "dsba", "sharded", seed=s, **kw, **g)
        assert np.array_equal(many.z[b], one.z)
        assert np.array_equal(many.dist2[b], one.dist2)


def test_a_failing_rank_raises_with_its_traceback_and_closes_the_mesh():
    small = TMesh.NodeMesh(2, CPU)
    pids = small.pids()
    assert len(pids) == 2
    with pytest.raises(RuntimeError, match=r"rank [01] failed:(.|\n)*KeyError"):
        small.run(TS._rank_job, [{}, {}])
    assert small.closed and not any(p.is_alive() for p in small._procs)
    with pytest.raises(RuntimeError, match="closed"):
        small.run(TS._rank_job, [{}, {}])


def test_ranks_load_no_jax(mesh):
    """The workers import only the port: no JAX library is mapped into a
    rank that has run solver jobs (this process has JAX loaded)."""
    _, tp = _problems("ring")
    TS.solve(tp, "dsba", "sharded", steps=2, seed=1, comm_options={"mesh": mesh})
    for pid in mesh.pids():
        with open(f"/proc/{pid}/maps") as f:
            maps = f.read()
        assert "libtorch" in maps and "jaxlib" not in maps, pid


def test_close_leaves_no_worker_alive():
    with TMesh.NodeMesh(3, CPU) as m:
        procs = list(m._procs)
        assert all(p.is_alive() for p in procs) and m.pids() == list(m.ranks)
    assert m.closed and not any(p.is_alive() for p in procs)
    m.close()  # idempotent


def test_chip_smoke_sharded_phase_on_cpu():
    """chip_smoke's --sharded checks at a tiny size, ranks on the CPU."""
    import chip_smoke

    out = chip_smoke.sharded_checks(CPU, 64, 8, n_nodes=5, q=10, steps=6, link_steps=6,
                                    record_every=3)
    for method in ("dsba", "dsa"):
        assert out[method]["vs_dense"] <= TOL and out[method]["vs_cpu"] <= TOL
        assert len(out[method]["warm"]["exchange_share"]) == 5
    assert out["link"]["vs_dense"] <= TOL
    assert (5, "cpu") not in TMesh._MESHES
