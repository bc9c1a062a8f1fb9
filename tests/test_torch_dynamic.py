"""Dynamic networks in ``repro_torch``'s ``solve()`` against ``repro``'s.

At the JAX tests' size (``tests/test_dynamic_graphs.py``: ridge, N=6, q=12,
d=12, k=4, lam 0.3, a ring; and ``tests/test_faults.py``'s ring of 8),
from numpy seeds: single-segment schedules bit-equal to the static path
(dense and relay, both engines); multi-segment schedules within 1e-12 of
the JAX package with the restart flood charged, ``extras["schedule"]``
exact; kill, join and kill-then-join for dsba, dsa, mudag, sliding and
dsgda, dense and relay where the reference supports them, with
``churn_rows`` and the per-row counts exact; ``engine="reference"``
against the vectorized relay across an edge flip; the elastic remap of a
``DSBAState``, a solver tuple and a dict, as the JAX ``ElasticGossip``
remaps them; and the schedule and churn validation errors.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.core import mixing as JM
from repro.core import solvers as JS
from repro.core.gossip import GossipConfig as JGossipConfig
from repro.data.synthetic import make_classification, make_regression
from repro.ft.elastic import ElasticGossip as JElastic
from repro_torch.core import mixing as TM
from repro_torch.core import solvers as TS
from repro_torch.core.dsba import DSBAState
from repro_torch.core.gossip import GossipConfig as TGossipConfig
from repro_torch.ft.elastic import ElasticGossip as TElastic

TOL = 1e-12


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's CPU threads are unsteady beside JAX (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _ridge(n=6):
    data = make_regression(n_nodes=n, q=12, d=12, k=4, seed=3)
    jp = JS.make_problem("ridge", data, JM.ring_graph(n), lam=0.3)
    jp.solve_star()
    tp = TS.make_problem("ridge", data, TM.ring_graph(n), lam=0.3)
    tp.z_star = jp.z_star
    return jp, tp


@functools.cache
def _auc():
    data = make_classification(6, 10, 5, 3, positive_ratio=0.4, seed=2)
    jp = JS.make_problem("auc", data, JM.ring_graph(6), lam=1e-2)
    jp.solve_star()
    tp = TS.make_problem("auc", data, TM.ring_graph(6), lam=1e-2)
    tp.z_star = jp.z_star
    return jp, tp


def _flip_edge(g, M):
    """Replace ring edge (0,1) with chord (0,3): same nodes, new topology."""
    edges = tuple(e for e in g.edges if e != (0, 1)) + ((0, 3),)
    return M.Graph(g.n, tuple(sorted(edges)))


def _assert_matches(j, t, keys=()):
    for name in ("z", "dist2", "consensus"):
        np.testing.assert_allclose(getattr(t, name), np.asarray(getattr(j, name)),
                                   rtol=0, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(t.iters, j.iters)
    np.testing.assert_array_equal(t.doubles_received, j.doubles_received)
    np.testing.assert_array_equal(t.ints_received, j.ints_received)
    for key in keys:
        assert t.extras[key] == j.extras[key], key


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["dsba", "dsa", "mudag"])
def test_single_segment_schedule_bit_equal_static_dense(method):
    _, tp = _ridge()
    ps = dataclasses.replace(tp, schedule=((0, tp.graph),))
    kw = dict(steps=60, record_every=20, seed=0, device="cpu")
    r0 = TS.solve(tp, method, "dense", **kw)
    r1 = TS.solve(ps, method, "dense", **kw)
    for name in ("z", "dist2", "doubles_received"):
        assert np.array_equal(getattr(r0, name), getattr(r1, name)), name
    assert len(r1.extras["schedule"]) == 1
    assert r1.extras["schedule"][0]["entry"] is None


@pytest.mark.parametrize("engine", ["reference", "vectorized"])
def test_single_segment_schedule_bit_equal_static_sparse(engine):
    _, tp = _ridge()
    ps = dataclasses.replace(tp, schedule=((0, tp.graph),))
    kw = dict(steps=40, record_every=20, seed=0, device="cpu",
              comm_options={"engine": engine})
    r0 = TS.solve(tp, "dsba", "sparse", **kw)
    r1 = TS.solve(ps, "dsba", "sparse", **kw)
    for name in ("z", "doubles_received", "ints_received"):
        assert np.array_equal(getattr(r0, name), getattr(r1, name)), name


def _schedules(jp, tp):
    """Three segments (ring, edge flip, complete graph as a W) in both packages."""
    segs = []
    for p, M in ((jp, JM), (tp, TM)):
        segs.append(dataclasses.replace(p, schedule=(
            (0, p.graph), (25, _flip_edge(p.graph, M)),
            (55, M.laplacian_mixing(M.complete_graph(p.graph.n))))))
    return segs


@pytest.mark.parametrize("method,comm", [
    ("dsba", "dense"), ("dsa", "dense"), ("mudag", "dense"), ("sliding", "dense"),
    ("dsgda", "dense"), ("personal", "dense"), ("dsba", "sparse"), ("dsa", "sparse"),
])
def test_multi_segment_schedule_matches_jax(method, comm):
    jp, tp = _auc() if method == "dsgda" else _ridge()
    js, ts = _schedules(jp, tp)
    kw = dict(steps=80, record_every=10, seed=0)
    j = JS.solve(js, method, comm, **kw)
    t = TS.solve(ts, method, comm, device="cpu", **kw)
    _assert_matches(j, t, keys=("schedule",))
    assert [s["entry"] for s in t.extras["schedule"]] == [None, "switch", "switch"]
    if comm == "sparse":
        np.testing.assert_allclose(t.extras["z_trace"], j.extras["z_trace"], rtol=0, atol=TOL)


def test_sparse_schedule_restart_charges_extra_flood():
    """A segment boundary re-floods dense iterates once, as the reference
    charges it: more doubles than the static run, the same count as JAX."""
    jp, tp = _ridge()
    kw = dict(steps=50, record_every=50, seed=0)
    ts = dataclasses.replace(tp, schedule=((0, tp.graph), (25, _flip_edge(tp.graph, TM))))
    js = dataclasses.replace(jp, schedule=((0, jp.graph), (25, _flip_edge(jp.graph, JM))))
    r0 = TS.solve(tp, "dsba", "sparse", device="cpu", **kw)
    r1 = TS.solve(ts, "dsba", "sparse", device="cpu", **kw)
    assert r1.doubles_received[-1].sum() > r0.doubles_received[-1].sum()
    np.testing.assert_array_equal(r1.doubles_received,
                                  JS.solve(js, "dsba", "sparse", **kw).doubles_received)


def test_schedule_switch_converges_to_root():
    """The state carried across W switches still reaches the W-independent
    root (the mean-drift invariant only needs a doubly stochastic W)."""
    _, tp = _ridge()
    g2 = _flip_edge(tp.graph, TM)
    ps = dataclasses.replace(tp, schedule=((0, tp.graph), (150, g2), (400, tp.graph)))
    r = TS.solve(ps, "dsba", "dense", steps=1500, record_every=250, seed=0, device="cpu")
    assert float(r.dist2[-1]) < 1e-18


def test_reference_vs_vectorized_relay_across_edge_flip():
    """The relay re-derives its waves at the boundary: the vectorized engine
    tracks the per-observer oracle, and both the JAX package's oracle."""
    jp, tp = _ridge()
    js = dataclasses.replace(jp, schedule=((0, jp.graph), (25, _flip_edge(jp.graph, JM))))
    ts = dataclasses.replace(tp, schedule=((0, tp.graph), (25, _flip_edge(tp.graph, TM))))
    kw = dict(steps=60, record_every=20, seed=0)
    rr = TS.solve(ts, "dsba", "sparse", comm_options={"engine": "reference"},
                  device="cpu", **kw)
    rv = TS.solve(ts, "dsba", "sparse", comm_options={"verify": True}, device="cpu", **kw)
    np.testing.assert_allclose(rv.z, rr.z, atol=TOL, rtol=0)
    np.testing.assert_array_equal(rv.doubles_received, rr.doubles_received)
    np.testing.assert_array_equal(rv.ints_received, rr.ints_received)
    assert rv.extras["recon_max_err"] < 1e-10 and rr.extras["recon_max_err"] < 1e-10
    jr = JS.solve(js, "dsba", "sparse", comm_options={"engine": "reference"}, **kw)
    _assert_matches(jr, rr)
    np.testing.assert_allclose(rr.extras["recon_max_err"], jr.extras["recon_max_err"],
                               rtol=0, atol=1e-13)


@pytest.mark.parametrize("method", ["dsba", "dsa"])
def test_reference_engine_matches_jax_static(method):
    jp, tp = _ridge()
    kw = dict(steps=30, record_every=10, seed=2, comm_options={"engine": "reference"})
    _assert_matches(JS.solve(jp, method, "sparse", **kw),
                    TS.solve(tp, method, "sparse", device="cpu", **kw))


SCHEDULE_ERRORS = [
    lambda M, p: ((-1, p.graph),),
    lambda M, p: ((0, p.graph), (0, M.ring_graph(p.graph.n))),
    lambda M, p: ((5, np.eye(p.graph.n + 1)),),
    lambda M, p: ((5, M.ring_graph(p.graph.n + 1)),),
]


@pytest.mark.parametrize("case", range(len(SCHEDULE_ERRORS)))
def test_schedule_errors_match_jax(case):
    jp, tp = _ridge()
    msgs = []
    for p, M in ((jp, JM), (tp, TM)):
        with pytest.raises(ValueError) as ei:
            dataclasses.replace(p, schedule=SCHEDULE_ERRORS[case](M, p))
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_schedule_normalizes_like_jax():
    jp, tp = _ridge()
    w = TM.laplacian_mixing(TM.complete_graph(6))
    js = dataclasses.replace(jp, schedule=((40, w), (10, _flip_edge(jp.graph, JM))))
    ts = dataclasses.replace(tp, schedule=((40, w), (10, _flip_edge(tp.graph, TM))))
    assert [s for s, _, _ in ts.schedule] == [s for s, _, _ in js.schedule] == [0, 10, 40]
    for (_, jg, jw), (_, tg, tw) in zip(js.schedule, ts.schedule):
        assert (jg.n, jg.edges) == (tg.n, tg.edges)
        np.testing.assert_array_equal(tw, jw)


# ---------------------------------------------------------------------------
# churn
# ---------------------------------------------------------------------------


def _churn(F, M, kind, n=6):
    """The same churn plan in both packages."""
    kill = F.ChurnEvent(at=60, kind="kill", nodes=(4,))
    join = F.ChurnEvent(at=60, kind="join", n_new=2, seed_from=0, graph=M.ring_graph(n + 2))
    if kind == "kill":
        return F.ChurnPlan((kill,))
    if kind == "join":
        return F.ChurnPlan((join,))
    return F.ChurnPlan((F.ChurnEvent(at=40, kind="kill", nodes=(n - 1,)),
                        F.ChurnEvent(at=90, kind="join", n_new=1, seed_from=2,
                                     graph=M.ring_graph(n))))


CHURN_CASES = [(m, c, k) for m in ("dsba", "dsa") for c in ("dense", "sparse")
               for k in ("kill", "join", "kill_join")]
CHURN_CASES += [(m, "dense", k) for m in ("mudag", "sliding", "dsgda")
                for k in ("kill", "join", "kill_join")]


@pytest.mark.parametrize("method,comm,kind", CHURN_CASES)
def test_churn_matches_jax(method, comm, kind):
    from repro.ft import faults as JF
    from repro_torch.ft import faults as TF

    jp, tp = _auc() if method == "dsgda" else _ridge()
    hp = dict(eta=0.5, momentum=0.5) if method == "mudag" else {}
    kw = dict(steps=130, record_every=10, seed=1, **hp)
    j = JS.solve(jp, method, comm, comm_options={"fault_plan": _churn(JF, JM, kind)}, **kw)
    t = TS.solve(tp, method, comm, comm_options={"fault_plan": _churn(TF, TM, kind)},
                 device="cpu", **kw)
    _assert_matches(j, t, keys=("schedule", "churn_rows"))
    assert t.z.shape == np.asarray(j.z).shape
    assert [s["entry"] for s in t.extras["schedule"]][1:] == (
        ["kill", "join"] if kind == "kill_join" else [kind])


@pytest.mark.parametrize("method", ["dsba", "dsa"])
def test_kill_reaches_survivor_root(method):
    """After a kill the run reaches the survivor system's own root (solved
    by the port), with the dead row's counts frozen."""
    _, tp = _ridge()
    plan = TS.ChurnPlan((TS.ChurnEvent(at=300, kind="kill", nodes=(4, 5)),))
    r = TS.solve(tp, method, "dense", steps=2000, record_every=100, seed=0,
                 comm_options={"fault_plan": plan}, device="cpu")
    assert r.z.shape[0] == 4
    post = r.dist2[r.iters > 300]
    assert post[-1] < 1e-9 and post[-1] < post[0] * 1e-6
    frozen = r.doubles_received[r.iters > 300][:, 4:]
    assert (np.diff(frozen, axis=0) == 0).all()
    assert (np.diff(r.doubles_received[:, :4], axis=0) > 0).all()


def test_mudag_reanchor_reconverges():
    """With the tracker reanchor the kill run reaches the survivor root;
    without it (the hook nulled) it plateaus, as in the reference."""
    from repro_torch.ft import faults as TF

    data = make_regression(8, 12, 6, k=3, seed=0)
    tp = TS.make_problem("ridge", data, TM.ring_graph(8), lam=1e-2)
    tp.solve_star(device="cpu")
    plan = TF.ChurnPlan((TF.ChurnEvent(at=150, kind="kill", nodes=(5,)),))
    kw = dict(steps=600, record_every=50, seed=1, eta=0.5, momentum=0.5,
              comm_options={"fault_plan": plan}, device="cpu")
    assert TS.solve(tp, "mudag", **kw).dist2[-1] < 1e-12
    spec = TS.get_solver("mudag")
    orig = spec.reanchor
    object.__setattr__(spec, "reanchor", None)
    try:
        res_no = TS.solve(tp, "mudag", **kw)
    finally:
        object.__setattr__(spec, "reanchor", orig)
    assert res_no.dist2[-1] > 1e-6
    assert abs(res_no.dist2[-1] - res_no.dist2[-2]) < 0.1 * res_no.dist2[-1]


# ---------------------------------------------------------------------------
# the elastic remap: dataclasses, tuples, dicts (as JAX's tree_map walks)
# ---------------------------------------------------------------------------


def _dsba_states(n=6, seed=0):
    rng = np.random.default_rng(seed)
    arrs = dict(
        z=rng.standard_normal((n, 5)), z_prev=rng.standard_normal((n, 5)),
        table_g=rng.standard_normal((n, 4)), table_tail=rng.standard_normal((n, 4, 0)),
        phibar=rng.standard_normal((n, 5)), dg_prev=rng.standard_normal((n,)),
        didx_prev=rng.integers(0, 5, (n, 3)).astype(np.int32),
        dval_prev=rng.standard_normal((n, 3)), dtail_prev=rng.standard_normal((n, 0)),
        step=np.int32(7),
    )
    from repro.core.dsba import DSBAState as JState
    import jax.numpy as jnp

    jst = JState(**{k: jnp.asarray(v) for k, v in arrs.items()})
    tst = DSBAState(**{k: torch.as_tensor(v) for k, v in arrs.items()})
    return jst, tst


def _leaves(x):
    if dataclasses.is_dataclass(x):
        return [_leaves(getattr(x, f.name)) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        return [_leaves(v) for v in x]
    if isinstance(x, dict):
        return {k: _leaves(v) for k, v in x.items()}
    return np.asarray(x)


def _assert_same_tree(t, j):
    lt, lj = _leaves(t), _leaves(j)

    def walk(a, b):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                walk(a[k], b[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                walk(x, y)
        else:
            np.testing.assert_array_equal(a, b)

    walk(lt, lj)


@pytest.mark.parametrize("kind", ["dataclass", "tuple", "dict"])
def test_elastic_remap_matches_jax(kind):
    """shrink and grow remap every leading-N leaf of a DSBAState, a solver
    tuple (host int counter passed through) and a dict as the JAX
    ElasticGossip does; other leaves pass through."""
    jst, tst = _dsba_states()
    if kind == "tuple":
        rng = np.random.default_rng(1)
        a, b = rng.standard_normal((6, 5)), rng.standard_normal((6, 2, 3))
        jst = (jst.z, np.asarray(a), np.asarray(b), 0)
        tst = (tst.z, torch.as_tensor(a), torch.as_tensor(b), 0)
    elif kind == "dict":
        jst = {"state": jst, "scalar": np.float64(7.0), "pair": (jst.z, jst.step)}
        tst = {"state": tst, "scalar": np.float64(7.0), "pair": (tst.z, tst.step)}
    je, te = JElastic(JGossipConfig(n_pods=6)), TElastic(TGossipConfig(n_pods=6))
    js, jgc = je.shrink(jst, [1, 4])
    ts, tgc = te.shrink(tst, [1, 4])
    assert tgc.n_pods == jgc.n_pods == 4
    _assert_same_tree(ts, js)
    jg, _ = JElastic(jgc).grow(js, 2, seed_from=3)
    tg, tgc6 = TElastic(tgc).grow(ts, 2, seed_from=3)
    assert tgc6.n_pods == 6
    _assert_same_tree(tg, jg)
    if kind == "dataclass":
        assert isinstance(tg, DSBAState) and int(tg.step) == 7
        assert tg.z.shape == (6, 5) and torch.equal(tg.z[4], tg.z[3])
    if kind == "tuple":
        assert tg[3] == 0
