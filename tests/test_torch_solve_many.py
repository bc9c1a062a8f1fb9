"""``repro_torch.core.solvers.solve_many`` against ``repro.core.solvers.solve_many``.

Port counterparts of tests/test_runner_cache.py's sweep claims and of
tests/test_accel_minimax.py's Mudag K grid, at a small size (N=5, q=8,
d=16, k=4, an Erdos-Renyi graph, 20-24 steps):

* every method x family through ``solve_many`` (a grid paired with seeds)
  matches the JAX package's ``solve_many`` within 1e-12 (float64): z,
  dist2, consensus; DOUBLEs, ints, shapes and ``extras["batched"]``
  exactly, on every route (batched dense, batched relay, and the
  sequential route for a static-hp grid, ``engine="reference"``, a
  schedule and a fault plan);
* batched DSBA/DSA runs, dense and relay, are bit-equal to the port's own
  sequential ``solve()`` runs (the reference pins the same); the other
  methods agree with theirs within 1e-12;
* Mudag's K grid is within 1e-12 of sequential runs with equal DOUBLEs;
* the validation errors and the batched state's shapes;
* ``run_sparse_many`` directly against ``run_sparse`` and the JAX
  package's ``run_sparse_many``, and chip_smoke's sweep phase at a tiny
  size on the CPU.
"""
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from repro.core import mixing as JM
from repro.core import solvers as JS
from repro.core import sparse_comm as JSC
from repro.core.dsba import DSBAConfig as JConfig
from repro.data.synthetic import make_classification, make_regression
from repro_torch.core import mixing as TM
from repro_torch.core import solvers as TS
from repro_torch.core import sparse_comm as TSC
from repro_torch.core.dsba import DSBAConfig, draw_indices
from repro_torch.core.operators import FAMILIES
from repro_torch.ft.faults import FaultPlan, LinkFault

TOL = 1e-12
STEPS = 20
REC = 10
SEEDS = [3, 4]
CPU = "cpu"
LAM = 1e-2
# two grid entries a method, paired with SEEDS (SSDA's dual step at lam:
# its default, 0.05, diverges on this problem in both packages)
GRIDS = {
    "dsba": [{"alpha": 0.3}, {"alpha": 0.6}],
    "dsa": [{"alpha": 0.1}, {"alpha": 0.2}],
    "extra": [{"alpha": 0.2}, {"alpha": 0.3}],
    "dlm": [{"c": 0.3, "beta": 1.0}, {"c": 0.5, "beta": 2.0}],
    "ssda": [{"eta": LAM, "momentum": 0.5}, {"eta": 0.5 * LAM, "momentum": 0.3}],
    "mudag": [{"gossip_rounds": 2.0}, {"gossip_rounds": 5.0}],
    "sliding": [{"comm_period": 2}, {"comm_period": 3}],
    "dsgda": [{"alpha": 0.2}, {"alpha": 0.3}],
    "personal": [{"alpha": 0.2, "mu": 1.0}, {"alpha": 0.1, "mu": 2.0}],
}
PAIRS = [(m, f) for m in GRIDS for f in FAMILIES
         if TS.available_solvers()[m].supports("dense", f)]


@pytest.fixture(autouse=True)
def _one_thread():
    """torch on one thread (a parity file: see tests/test_torch_ssm.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _problems(task):
    """(JAX problem, port problem) on one dataset, each with its root."""
    if task in ("ridge", "bilinear"):
        data = make_regression(5, 8, 16, k=4, seed=0)
    else:
        data = make_classification(5, 8, 16, k=4, positive_ratio=0.3, seed=0)
    jp = JS.make_problem(task, data, JM.erdos_renyi_graph(5, 0.5, seed=1), lam=LAM)
    tp = TS.make_problem(task, data, TM.erdos_renyi_graph(5, 0.5, seed=1), lam=LAM)
    jp.solve_star()
    tp.z_star = jp.z_star
    return jp, tp


def _assert_close(t, j):
    """Port result vs JAX result: metrics within TOL, counts exact."""
    assert t.extras["batched"] == j.extras["batched"]
    for name in ("z", "dist2", "consensus"):
        got, want = getattr(t, name), np.asarray(getattr(j, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(t.iters, j.iters)
    np.testing.assert_array_equal(t.doubles_received, j.doubles_received)
    np.testing.assert_array_equal(t.ints_received, j.ints_received)


@pytest.mark.parametrize("method,task", PAIRS)
def test_every_method_matches_jax_solve_many(method, task):
    """Each method's batched sweep (grid paired with seeds) against the JAX
    package's, and against the port's own sequential runs: bit for bit for
    DSBA/DSA (the reference's bar), within 1e-12 for the rest."""
    jp, tp = _problems(task)
    kw = dict(steps=STEPS, record_every=REC, grid=GRIDS[method], seeds=SEEDS)
    j = JS.solve_many(jp, method, **kw)
    t = TS.solve_many(tp, method, device=CPU, **kw)
    assert t.extras["batched"] is True
    _assert_close(t, j)
    for b, (hp, s) in enumerate(zip(GRIDS[method], SEEDS)):
        seq = TS.solve(tp, method, steps=STEPS, record_every=REC, seed=s, device=CPU, **hp)
        if method in ("dsba", "dsa"):
            assert np.array_equal(t.z[b], seq.z) and np.array_equal(t.dist2[b], seq.dist2)
        else:
            np.testing.assert_allclose(t.z[b], seq.z, rtol=0, atol=TOL)
        np.testing.assert_array_equal(t.doubles_received[b], seq.doubles_received)


@pytest.mark.parametrize("method", ["dsba", "dsa"])
@pytest.mark.parametrize("task", FAMILIES)
def test_solve_many_sparse_batched_matches_sequential_bit_equal(task, method):
    """The lockstep relay sweep is bit-identical to sequential solve()s,
    the closed-form message accounting included, and within 1e-12 of the
    JAX package's vmapped relay."""
    jp, tp = _problems(task)
    grid = GRIDS[method]
    kw = dict(steps=STEPS, record_every=5, grid=grid, seeds=SEEDS)
    many = TS.solve_many(tp, method, "sparse", device=CPU, comm_options={"verify": True}, **kw)
    j = JS.solve_many(jp, method, "sparse", comm_options={"verify": True, "use_pallas": "off"},
                      **kw)
    assert many.extras["batched"] is True and many.doubles_received.shape[0] == 2
    _assert_close(many, j)
    for b, hp in enumerate(grid):
        seq = TS.solve(tp, method, "sparse", steps=STEPS, record_every=5, seed=SEEDS[b],
                       device=CPU, comm_options={"verify": True}, **hp)
        assert np.array_equal(many.z[b], seq.z)
        assert np.array_equal(many.doubles_received[b], seq.doubles_received)
        assert np.array_equal(many.ints_received[b], seq.ints_received)
        run = many.extras["per_run_extras"][b]
        assert np.array_equal(run["z_trace"], seq.extras["z_trace"])
        assert run["recon_max_err"] == seq.extras["recon_max_err"] <= TOL


def test_solve_many_grid_matches_sequential_bit_equal():
    """The reference's grid test: snapshots and every record bit-equal."""
    _, tp = _problems("ridge")
    grid = [{"alpha": 0.3}, {"alpha": 0.5}, {"alpha": 0.8}]
    many = TS.solve_many(tp, "dsba", steps=24, record_every=8, grid=grid,
                         keep_snapshots=True, device=CPU)
    assert many.extras["batched"] is True
    assert many.dist2.shape == (3, len(many.iters))
    assert many.zs.shape == (3, len(many.iters), 5, 16)
    # the batched state: every tensor leaf with a leading B axis
    assert many.state.z.shape == (3, 5, 16) and many.state.step.shape == (3,)
    assert many.state.table_g.shape == (3, 5, 8)
    for b, hp in enumerate(grid):
        seq = TS.solve(tp, "dsba", steps=24, record_every=8, keep_snapshots=True,
                       device=CPU, **hp)
        for name in ("z", "zs", "dist2", "consensus", "doubles_received"):
            assert np.array_equal(getattr(many, name)[b], getattr(seq, name)), name


@pytest.mark.parametrize("comm", ["dense", "sparse"])
@pytest.mark.parametrize("method", ["dsba", "dsa"])
def test_float32_grid_bit_equal_to_sequential(method, comm):
    """In float32 too: every product of two hyperparameters is taken on
    the device in the data dtype, in one run as in a batch."""
    data = make_regression(5, 8, 16, k=4, seed=0, dtype=np.float32)
    tp = TS.make_problem("ridge", data, TM.erdos_renyi_graph(5, 0.5, seed=1), lam=LAM)
    grid = [{"alpha": 0.3}, {"alpha": 0.7}]
    many = TS.solve_many(tp, method, comm, steps=STEPS, record_every=REC, grid=grid,
                         seeds=SEEDS, device=CPU)
    assert many.z.dtype == np.float32
    for b, (hp, s) in enumerate(zip(grid, SEEDS)):
        seq = TS.solve(tp, method, comm, steps=STEPS, record_every=REC, seed=s, device=CPU, **hp)
        assert np.array_equal(many.z[b], seq.z)


def test_solve_many_seed_axis_matches_sequential():
    _, tp = _problems("ridge")
    many = TS.solve_many(tp, "dsba", steps=24, record_every=8, seeds=[3, 4, 5],
                         alpha=0.4, device=CPU)
    for b, s in enumerate([3, 4, 5]):
        seq = TS.solve(tp, "dsba", steps=24, record_every=8, seed=s, alpha=0.4, device=CPU)
        assert np.array_equal(many.z[b], seq.z)


def test_mudag_k_grid_through_solve_many_matches_sequential():
    """A K grid runs the largest K and freezes finished runs with a select:
    within 1e-12 of sequential solves, accounting included."""
    _, tp = _problems("ridge")
    grid = [{"gossip_rounds": 2.0}, {"gossip_rounds": 5.0}]
    batched = TS.solve_many(tp, "mudag", steps=30, record_every=15, grid=grid, device=CPU)
    for b, g in enumerate(grid):
        seq = TS.solve(tp, "mudag", steps=30, record_every=15, device=CPU, **g)
        np.testing.assert_allclose(batched.z[b], seq.z, atol=1e-12, rtol=0)
        np.testing.assert_array_equal(batched.doubles_received[b], seq.doubles_received)


@pytest.mark.parametrize("route", ["reference", "static", "schedule", "fault_plan"])
def test_sequential_routes_match_jax(route):
    """The routes the reference runs entry by entry: ``extras["batched"]``
    is False in both packages, and the results agree."""
    jp, tp = _problems("ridge")
    kw = dict(steps=8, record_every=4, seeds=SEEDS)
    if route == "reference":
        args = ("dsba", "sparse")
        kw.update(grid=GRIDS["dsba"])
        j_opts, t_opts = {"engine": "reference"}, {"engine": "reference"}
    elif route == "static":
        args = ("ssda", "dense")
        kw.update(grid=[{"inner_newton": 4, "eta": LAM}, {"inner_newton": 8, "eta": LAM}])
        j_opts = t_opts = None
    elif route == "schedule":
        args = ("dsba", "dense")
        kw.update(grid=GRIDS["dsba"])
        jp = JS.Problem(jp.spec, jp.data, jp.graph, lam=jp.lam, z_star=jp.z_star,
                        schedule=((4, JM.ring_graph(5)),))
        tp = TS.Problem(tp.spec, tp.data, tp.graph, lam=tp.lam, z_star=tp.z_star,
                        schedule=((4, TM.ring_graph(5)),))
        j_opts = t_opts = None
    else:
        args = ("dsba", "dense")
        kw.update(grid=GRIDS["dsba"])
        j_opts = {"fault_plan": JS.FaultPlan(link=JS.LinkFault(p=0.2, seed=7))}
        t_opts = {"fault_plan": FaultPlan(link=LinkFault(p=0.2, seed=7))}
    j = JS.solve_many(jp, *args, comm_options=j_opts, **kw)
    t = TS.solve_many(tp, *args, comm_options=t_opts, device=CPU, **kw)
    assert t.extras["batched"] is False and isinstance(t.state, list)
    assert t.z.shape[0] == 2
    _assert_close(t, j)


def test_solve_many_validation():
    _, tp = _problems("ridge")
    with pytest.raises(ValueError, match="grid, seeds"):
        TS.solve_many(tp, "dsba", steps=4, device=CPU)
    with pytest.raises(ValueError, match="pair up"):
        TS.solve_many(tp, "dsba", steps=4, grid=[{}], seeds=[0, 1], device=CPU)
    with pytest.raises(ValueError, match="at least one"):
        TS.solve_many(tp, "dsba", steps=4, grid=[], device=CPU)
    with pytest.raises(TypeError, match="unknown hyperparameters"):
        TS.solve_many(tp, "dsba", steps=4, grid=[{"learning_rate": 0.1}], device=CPU)
    with pytest.raises(ValueError, match="indices"):
        TS.solve_many(tp, "dsba", steps=40, seeds=[0, 1],
                      indices=np.zeros((2, 10, 5), np.int32), device=CPU)
    with pytest.raises(TS.CapabilityError):
        TS.solve_many(tp, "extra", "sparse", steps=4, seeds=[0, 1], device=CPU)
    # the sharded backend runs the entries one after another (it once
    # raised here as unported)
    from repro_torch.launch.mesh import close_all

    try:
        res = TS.solve_many(tp, "dsba", "sharded", steps=4, seeds=[0, 1], device=CPU)
    finally:
        close_all()
    assert res.extras["batched"] is False and res.z.shape == (2, 5, tp.dim)


def test_run_sparse_many_matches_run_sparse_and_jax():
    """Three relays in lockstep, each bit-equal to its own run_sparse and
    within 1e-12 of the JAX package's run_sparse_many."""
    jp, tp = _problems("auc")
    alphas = [0.2, 0.4, 0.7]
    idx = np.stack([draw_indices(STEPS, 5, 8, s) for s in (1, 2, 3)])
    cfg = DSBAConfig(tp.spec, 0.0, LAM)
    many = TSC.run_sparse_many(cfg, tp.data, tp.graph, tp.w, STEPS, idx, alphas,
                               verify=True, device=CPU)
    j = JSC.run_sparse_many(JConfig(jp.spec, 0.0, LAM), jp.data, jp.graph, jp.w, STEPS, idx,
                            alphas, verify=True, use_pallas="off")
    for b, a in enumerate(alphas):
        one = TSC.run_sparse(DSBAConfig(tp.spec, a, LAM), tp.data, tp.graph, tp.w, STEPS,
                             idx[b], verify=True, device=CPU)
        assert np.array_equal(many[b].z_trace, one.z_trace)
        assert np.array_equal(many[b].doubles_received, one.doubles_received)
        assert many[b].recon_max_err == one.recon_max_err <= TOL
        np.testing.assert_allclose(many[b].z_trace, j[b].z_trace, rtol=0, atol=TOL)
        np.testing.assert_array_equal(many[b].ints_received, j[b].ints_received)
    with pytest.raises(ValueError, match="indices"):
        TSC.run_sparse_many(cfg, tp.data, tp.graph, tp.w, STEPS, idx[:2], alphas, device=CPU)


def test_chip_smoke_sweep_phase_on_cpu():
    """chip_smoke's --sweep checks at a tiny size with the plain kernels."""
    cpu = torch.device("cpu")
    out = chip_smoke.sweep_checks(cpu, 64, 8, n_nodes=5, q=10, steps=6, record_every=3)
    assert out["dsba_grid"]["bit_equal"] and out["dsa_grid"]["bit_equal"]
    assert out["relay"]["bit_equal"]
    assert out["extra"]["max_err"] <= TOL and out["mudag"]["max_err"] <= TOL
    assert out["cache"] == {"new_traces": 0, "new_hits": 1}
