"""Fault injection in ``repro_torch``'s ``solve()`` against ``repro``'s.

At the JAX tests' size (``tests/test_faults.py``: ring of 8, q=12, d=6,
k=3, lam 1e-2), from numpy seeds: the mask functions bit-equal; every plan
validation and ``solve()`` combination error with the reference's text;
a p = 0 plan bit-equal to a plan-free run (dense and relay); link faults,
stragglers and both composed on the dense backend (dsba, dsa, mudag) and
link faults on the relay, within 1e-12 of the JAX package with DOUBLEs
and ``extras["faults"]`` exact; the staleness bound; the relay's
``sent_mask`` errors; and ``benchmarks/bench_faults.py``'s curve (the
p = 0 iterations to 1e-6 and the p > 0 plateaus) computed from the JAX
package and held in the port.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from repro.core import mixing as JM
from repro.core import solvers as JS
from repro.ft import faults as JF
from repro.data.synthetic import make_regression
from repro_torch.core import mixing as TM
from repro_torch.core import solvers as TS
from repro_torch.core import sparse_comm as TSC
from repro_torch.ft import faults as TF

TOL = 1e-12
N, Q, D, K = 8, 12, 6, 3


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's CPU threads are unsteady beside JAX (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _problems():
    data = make_regression(N, Q, D, k=K, seed=0)
    jp = JS.make_problem("ridge", data, JM.ring_graph(N), lam=1e-2)
    jp.solve_star()
    tp = TS.make_problem("ridge", data, TM.ring_graph(N), lam=1e-2)
    tp.z_star = jp.z_star
    return jp, tp


def _plans(link=None, straggler=None, churn_at=None):
    """The same FaultPlan in both packages (None fields stay None)."""
    out = []
    for F, M in ((JF, JM), (TF, TM)):
        churn = None
        if churn_at is not None:
            churn = F.ChurnPlan((F.ChurnEvent(at=churn_at, kind="kill", nodes=(7,)),))
        out.append(F.FaultPlan(
            churn=churn,
            link=None if link is None else F.LinkFault(**link),
            straggler=None if straggler is None else F.StragglerSpec(**straggler),
        ))
    return out


def _both(method, comm, jplan, tplan, **kw):
    jp, tp = _problems()
    kw.setdefault("steps", 120)
    kw.setdefault("record_every", 30)
    kw.setdefault("seed", 1)
    j = JS.solve(jp, method, comm=comm, comm_options={"fault_plan": jplan}, **kw)
    t = TS.solve(tp, method, comm=comm, comm_options={"fault_plan": tplan},
                 device="cpu", **kw)
    return j, t


def _assert_matches(j, t, keys=("faults",)):
    for name in ("z", "dist2", "consensus"):
        np.testing.assert_allclose(getattr(t, name), np.asarray(getattr(j, name)),
                                   rtol=0, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(t.iters, j.iters)
    np.testing.assert_array_equal(t.doubles_received, j.doubles_received)
    np.testing.assert_array_equal(t.ints_received, j.ints_received)
    for key in keys:
        assert t.extras[key] == j.extras[key], key


# ---------------------------------------------------------------------------
# the mask functions and the plan classes: the reference's, bit for bit
# ---------------------------------------------------------------------------

GRAPHS = {"ring8": lambda M: M.ring_graph(8),
          "er10": lambda M: M.erdos_renyi_graph(10, 0.4, seed=0)}
LINKS = [dict(p=0.1, seed=7), dict(p=0.4, seed=3), dict(p=0.0, edges="graph", at=(3, 9)),
         dict(p=0.2, seed=5, at=(0, 4))]


@pytest.mark.parametrize("start", [0, 60])
@pytest.mark.parametrize("link", LINKS)
@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_link_masks_bit_equal(gname, link, start):
    jg, tg = GRAPHS[gname](JM), GRAPHS[gname](TM)
    if link.get("edges") == "graph":  # two of the graph's directed edges
        (a, b), (c, e) = jg.edges[:2]
        link = dict(link, edges=((a, b), (e, c)))
    jl, tl = JF.LinkFault(**link), TF.LinkFault(**link)
    jm = JF.link_delivered_mask(jl, jg, 40, start=start)
    tm = TF.link_delivered_mask(tl, tg, 40, start=start)
    np.testing.assert_array_equal(tm, jm)
    js = JF.source_sent_mask(jl, jg, 40, start=start)
    np.testing.assert_array_equal(TF.source_sent_mask(tl, tg, 40, start=start), js)
    for deliv in (None, JF.straggler_delivered_mask(JF.StragglerSpec(p=0.3, seed=1), jg.n, 40)):
        np.testing.assert_array_equal(TF.delivered_in_messages(tg, tm, deliv, 40),
                                      JF.delivered_in_messages(jg, jm, deliv, 40))
        assert (TF.fault_message_totals(tg, tm, deliv, 40)
                == JF.fault_message_totals(jg, jm, deliv, 40))


@pytest.mark.parametrize("start", [0, 7])
@pytest.mark.parametrize("strag", [dict(p=0.2, max_staleness=2, seed=3),
                                   dict(p=0.95, max_staleness=1, seed=9),
                                   dict(p=0.5, max_staleness=4, nodes=(0, 3), seed=5)])
def test_straggler_masks_bit_equal(strag, start):
    jm = JF.straggler_delivered_mask(JF.StragglerSpec(**strag), 6, 50, start=start)
    tm = TF.straggler_delivered_mask(TF.StragglerSpec(**strag), 6, 50, start=start)
    np.testing.assert_array_equal(tm, jm)
    assert not tm.all()


def test_staleness_bound_is_enforced():
    """Even at p=0.95 no node goes more than max_staleness iterations
    without a delivery, and the first iteration always delivers."""
    for bound in (1, 2, 4):
        m = TF.straggler_delivered_mask(
            TF.StragglerSpec(p=0.95, max_staleness=bound, seed=9), 6, 300)
        assert m[0].all()
        gaps = np.zeros(6, dtype=int)
        for t in range(1, 300):
            gaps = np.where(m[t], 0, gaps + 1)
            assert (gaps <= bound).all()
        assert not m.all()


PLAN_ERRORS = [
    lambda F, M: F.FaultPlan(),
    lambda F, M: F.LinkFault(p=1.5),
    lambda F, M: F.LinkFault(edges=((0, 1),)),
    lambda F, M: F.LinkFault(p=0.1, at=(-1,)),
    lambda F, M: F.StragglerSpec(p=0.5, max_staleness=0),
    lambda F, M: F.StragglerSpec(p=-0.1),
    lambda F, M: F.ChurnEvent(at=5, kind="leave", nodes=(1,)),
    lambda F, M: F.ChurnEvent(at=5, kind="kill"),
    lambda F, M: F.ChurnEvent(at=5, kind="join", n_new=0, graph=M.ring_graph(3)),
    lambda F, M: F.ChurnEvent(at=5, kind="join", n_new=1),
    lambda F, M: F.ChurnPlan(()),
    lambda F, M: F.ChurnPlan((F.ChurnEvent(at=5, kind="kill", nodes=(1,)),
                              F.ChurnEvent(at=5, kind="kill", nodes=(2,)))),
    lambda F, M: F.FaultPlan(churn=object()),
    lambda F, M: F.FaultPlan(link=F.StragglerSpec()),
    lambda F, M: F.FaultPlan(straggler=F.LinkFault()),
    lambda F, M: F.as_fault_plan(object()),
    lambda F, M: F.link_delivered_mask(F.LinkFault(edges=((0, 2),), at=(1,)), M.ring_graph(5), 4),
    lambda F, M: F.link_delivered_mask(F.LinkFault(edges=((0, 9),), at=(1,)), M.ring_graph(5), 4),
    lambda F, M: F.straggler_delivered_mask(F.StragglerSpec(p=0.5, nodes=(7,)), 5, 4),
    lambda F, M: F.source_sent_mask(F.LinkFault(edges=((9, 1),), at=(1,)), M.ring_graph(5), 4),
]


def _error(call):
    with pytest.raises((ValueError, TypeError)) as ei:
        call()
    return type(ei.value), str(ei.value)


@pytest.mark.parametrize("case", range(len(PLAN_ERRORS)))
def test_plan_errors_match_jax(case):
    want = _error(lambda: PLAN_ERRORS[case](JF, JM))
    got = _error(lambda: PLAN_ERRORS[case](TF, TM))
    assert got[1] == want[1] and got[0].__name__ == want[0].__name__


def test_plan_normalization_matches_jax():
    for F, M in ((JF, JM), (TF, TM)):
        ev = F.ChurnEvent(at=3, kind="kill", nodes=(np.int64(2),))
        assert F.FaultPlan(churn=ev).churn.events == (ev,)
        assert F.as_fault_plan([ev]).churn.events == (ev,)
        assert F.as_fault_plan(None) is None
        assert F.LinkFault(edges=[[0, 1]], at=[2]).edges == ((0, 1),)


# ---------------------------------------------------------------------------
# solve(): validation and combination errors with the reference's text
# ---------------------------------------------------------------------------


def _solve_errors(S, F, M, p):
    """Calls that must raise before any step, in either package."""
    kill = F.ChurnPlan((F.ChurnEvent(at=10, kind="kill", nodes=(7,)),))
    ck = S.CheckpointSpec("/nonexistent-ck", every=30)

    def run(method="dsba", comm="dense", plan=None, problem=p, engine=None, **kw):
        kw.setdefault("steps", 60)
        opts = {"fault_plan": plan} if plan is not None else {}
        if engine is not None:
            opts["engine"] = engine
        return S.solve(problem, method, comm=comm, comm_options=opts or None, **kw)

    sched = dataclasses.replace(p, schedule=((0, p.graph),))
    sched2 = dataclasses.replace(p, schedule=((0, p.graph), (20, M.ring_graph(8))))
    return [
        lambda: run(problem=sched, plan=F.FaultPlan(link=F.LinkFault(p=0.1))),
        lambda: run(plan=F.FaultPlan(churn=kill, link=F.LinkFault(edges=((0, 1),), at=(5,)))),
        lambda: run(plan=F.FaultPlan(churn=kill, straggler=F.StragglerSpec(p=0.5, nodes=(0,)))),
        lambda: run(plan=F.FaultPlan(churn=kill), keep_snapshots=True),
        lambda: run(comm="sharded", checkpoint=ck),
        lambda: run(plan=F.FaultPlan(link=F.LinkFault(p=0.1)), checkpoint=ck),
        lambda: run(problem=sched, checkpoint=ck),
        lambda: run(checkpoint=ck, keep_snapshots=True),
        lambda: run(record_every=25, checkpoint=ck),
        lambda: run(checkpoint="/nonexistent-ck"),
        lambda: run(comm="sparse", plan=F.FaultPlan(straggler=F.StragglerSpec(p=0.1))),
        lambda: run(method="mudag", plan=F.FaultPlan(straggler=F.StragglerSpec(p=0.1))),
        lambda: run(method="sliding", plan=F.FaultPlan(straggler=F.StragglerSpec(p=0.1))),
        lambda: run(method="extra", plan=kill),
        lambda: run(method="extra", problem=sched2),
        lambda: run(plan=F.ChurnPlan((F.ChurnEvent(at=60, kind="kill", nodes=(7,)),))),
        lambda: run(plan=F.ChurnPlan((F.ChurnEvent(at=10, kind="kill", nodes=(1, 4)),))),
        lambda: run(plan=F.ChurnPlan((F.ChurnEvent(at=10, kind="kill", nodes=(9,)),))),
        lambda: run(plan=F.ChurnPlan((F.ChurnEvent(at=10, kind="kill", nodes=tuple(range(8))),))),
        lambda: run(plan=F.ChurnPlan((F.ChurnEvent(at=10, kind="join", n_new=1, seed_from=9,
                                                   graph=M.ring_graph(9)),))),
        lambda: run(plan=F.ChurnPlan((F.ChurnEvent(at=10, kind="join", n_new=2,
                                                   graph=M.ring_graph(9)),))),
        lambda: run(plan=F.ChurnPlan((F.ChurnEvent(
            at=10, kind="kill", nodes=(7,), graph=M.Graph(7, ((0, 1),))),))),
        lambda: run(plan=F.ChurnPlan((F.ChurnEvent(at=10, kind="kill", nodes=(7,),
                                                   graph=M.ring_graph(6)),))),
        lambda: run(plan=object()),
        lambda: run(unknown_hp=1),
        lambda: run(comm="sparse", engine="fast"),
    ]


N_SOLVE_ERRORS = 26


def _solve_error(S, F, M, p, case):
    calls = _solve_errors(S, F, M, p)
    assert len(calls) == N_SOLVE_ERRORS
    return _error(calls[case])


@pytest.mark.parametrize("case", range(N_SOLVE_ERRORS))
def test_solve_errors_match_jax(case):
    jp, tp = _problems()
    want = _solve_error(JS, JF, JM, jp, case)
    got = _solve_error(_CpuSolve, TF, TM, tp, case)
    assert got[0].__name__ == want[0].__name__
    assert got[1] == want[1]


class _CpuSolve:
    """``TS`` with ``device="cpu"`` on every ``solve`` call."""

    CheckpointSpec = TS.CheckpointSpec

    @staticmethod
    def solve(*args, **kw):
        return TS.solve(*args, device="cpu", **kw)


# ---------------------------------------------------------------------------
# p = 0 routing, and the dense and relay fault paths against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("comm", ["dense", "sparse"])
def test_p0_plan_bit_equal_to_plan_free(comm):
    """An all-delivered plan runs the plain step: bit-equal by routing, and
    its record is the reference's."""
    jp, tp = _problems()
    kw = dict(steps=120, record_every=30, seed=1, device="cpu")
    base = TS.solve(tp, "dsba", comm, **kw)
    strag = None if comm == "sparse" else dict(p=0.0)
    jplan, tplan = _plans(link=dict(p=0.0), straggler=strag)
    res = TS.solve(tp, "dsba", comm, comm_options={"fault_plan": tplan}, **kw)
    for name in ("z", "dist2", "consensus", "doubles_received", "ints_received"):
        assert np.array_equal(getattr(base, name), getattr(res, name)), name
    kw.pop("device")
    want = JS.solve(jp, "dsba", comm, comm_options={"fault_plan": jplan}, **kw)
    assert res.extras["faults"] == want.extras["faults"]
    assert res.extras["faults"]["drop_rate"] == 0.0


DENSE_CASES = [
    ("dsba", dict(p=0.2, seed=7), None, {}),
    ("dsba", None, dict(p=0.4, max_staleness=3, seed=5), {}),
    ("dsba", dict(p=0.2, seed=3), dict(p=0.4, max_staleness=3, seed=5), {}),
    ("dsa", dict(p=0.2, seed=7), None, {}),
    ("dsa", dict(p=0.2, seed=3), dict(p=0.4, max_staleness=3, seed=5), {}),
    ("mudag", dict(p=0.2, seed=7), None, dict(eta=0.5, momentum=0.5)),
    ("dsba", dict(p=0.0, edges=((0, 1), (1, 0), (3, 2)), at=(2, 5, 40)), None, {}),
    ("extra", dict(p=0.1, seed=2), dict(p=0.3, max_staleness=2, seed=4), {}),
    ("extra", None, dict(p=0.6, max_staleness=3, seed=8), {}),
    ("dlm", dict(p=0.1, seed=2), dict(p=0.5, max_staleness=2, seed=6), {}),
    ("personal", dict(p=0.3, seed=5), dict(p=0.5, max_staleness=2, seed=6), {}),
    ("sliding", dict(p=0.2, seed=7), None, {}),
    ("dsgda", None, None, {}),
]


@pytest.mark.parametrize("method,link,strag,hp", DENSE_CASES)
def test_dense_faults_match_jax(method, link, strag, hp):
    if method == "dsgda":  # AUC, both families (DSGDA's saddle problem)
        from repro.data.synthetic import make_classification
        data = make_classification(6, 10, 5, 3, positive_ratio=0.4, seed=2)
        jp = JS.make_problem("auc", data, JM.ring_graph(6), lam=1e-2)
        tp = TS.make_problem("auc", data, TM.ring_graph(6), lam=1e-2)
        jplan, tplan = _plans(link=dict(p=0.2, seed=1), straggler=dict(p=0.3, seed=2))
        kw = dict(steps=90, record_every=30, seed=3)
        j = JS.solve(jp, "dsgda", comm_options={"fault_plan": jplan}, **kw)
        t = TS.solve(tp, "dsgda", comm_options={"fault_plan": tplan}, device="cpu", **kw)
    else:
        jplan, tplan = _plans(link=link, straggler=strag)
        j, t = _both(method, "dense", jplan, tplan, **hp)
    _assert_matches(j, t)
    f = t.extras["faults"]
    assert 0 < f["delivered_messages"] < f["injected_messages"]


def test_dense_faults_degrade_gracefully():
    """The reference's claims, in the port: finite, biased-not-divergent,
    delivered-only accounting below the fault-free count; composing the
    families delivers fewer messages than either alone."""
    _, tp = _problems()
    kw = dict(steps=400, record_every=100, seed=1, device="cpu")
    base = TS.solve(tp, "dsba", **kw)
    res = TS.solve(tp, "dsba", comm_options={
        "fault_plan": TF.FaultPlan(link=TF.LinkFault(p=0.2, seed=7))}, **kw)
    assert base.dist2[-1] < 1e-12 and 1e-12 < res.dist2[-1] < 1.0
    assert 0.1 < res.extras["faults"]["drop_rate"] < 0.3
    assert res.doubles_received[-1].sum() < base.doubles_received[-1].sum()
    link, strag = TF.LinkFault(p=0.2, seed=3), TF.StragglerSpec(p=0.4, max_staleness=3, seed=5)
    got = {name: TS.solve(tp, "dsba", comm_options={"fault_plan": plan}, steps=200,
                          record_every=50, seed=1, device="cpu").extras["faults"]
           for name, plan in (("s", TF.FaultPlan(straggler=strag)),
                              ("l", TF.FaultPlan(link=link)),
                              ("b", TF.FaultPlan(link=link, straggler=strag)))}
    assert got["b"]["delivered_messages"] < min(got["s"]["delivered_messages"],
                                                got["l"]["delivered_messages"])


@pytest.mark.parametrize("method", ["dsba", "dsa"])
def test_sparse_link_faults_match_jax(method):
    """A suppressed broadcast: the relay on a zeroed delta, its payload and
    tail uncharged; trajectory, counts and the broadcast record match."""
    jplan, tplan = _plans(link=dict(p=0.1, seed=7))
    j, t = _both(method, "sparse", jplan, tplan, steps=80, record_every=20)
    _assert_matches(j, t)
    np.testing.assert_allclose(t.extras["z_trace"], j.extras["z_trace"], rtol=0, atol=TOL)
    f = t.extras["faults"]
    assert 0 < f["delivered_broadcasts"] < f["injected_broadcasts"]
    _, tp = _problems()
    base = TS.solve(tp, method, "sparse", steps=80, record_every=20, seed=1, device="cpu")
    assert t.doubles_received[-1].sum() < base.doubles_received[-1].sum()


def test_churn_composes_with_link_faults():
    """Churn + link faults in one plan: each membership phase re-derives its
    masks (dense and relay) as the reference does."""
    jplan, tplan = _plans(link=dict(p=0.15, seed=11), churn_at=60)
    for comm in ("dense", "sparse"):
        j, t = _both("dsba", comm, jplan, tplan, steps=160, record_every=40)
        _assert_matches(j, t, keys=("faults", "schedule", "churn_rows"))
        assert t.z.shape[0] == N - 1 and t.extras["churn_rows"] == N


def test_sent_mask_errors():
    _, tp = _problems()
    cfg = TS.DSBAConfig(tp.spec, 0.5, tp.lam)
    sent = np.ones((4, N), dtype=bool)
    args = (cfg, tp.data, tp.graph, tp.w, 4, np.zeros((4, N), dtype=np.int32))
    with pytest.raises(ValueError, match="verify=True is incompatible"):
        TSC.run_sparse(*args, sent_mask=sent, verify=True, device="cpu")
    with pytest.raises(ValueError, match="engine='vectorized'"):
        TSC.run_sparse(*args, sent_mask=sent, engine="reference", device="cpu")
    with pytest.raises(ValueError, match="checkpoint/resume needs"):
        TSC.run_sparse(*args, ckpt_every=2, engine="reference", device="cpu")
    with pytest.raises(ValueError, match="sent_mask must be"):
        TSC.run_sparse(*args, sent_mask=sent[:3], device="cpu")
    with pytest.raises(ValueError, match="either z0"):
        TSC.run_sparse(*args, z0=np.zeros((N, D)), state0=object(), device="cpu")


# ---------------------------------------------------------------------------
# benchmarks/bench_faults.py's curve
# ---------------------------------------------------------------------------


def _curve(S, M, F, device=None):
    """bench_faults' measure(fast=True): {(method, p): (iters to 1e-6, plateau)}."""
    kw = {} if device is None else {"device": device}
    data = make_regression(8, 12, 6, k=3, seed=0)
    problem = S.make_problem("ridge", data, M.ring_graph(8), lam=1e-2)
    problem.solve_star(**kw)
    out = {}
    for method, hp in chip_smoke.FAULTS_HP.items():
        for p in (0.0, *chip_smoke.FAULTS_DROPS):
            opts = {"fault_plan": F.FaultPlan(link=F.LinkFault(p=p, seed=7))} if p else None
            res = S.solve(problem, method, steps=chip_smoke.FAULTS_STEPS, record_every=1,
                          seed=1, comm_options=opts, **kw, **hp)
            dist2 = np.asarray(res.dist2)
            hit = np.flatnonzero(dist2 <= chip_smoke.FAULTS_TOL)
            out[method, p] = (int(hit[0]) + 1 if hit.size else None,
                              float(np.median(dist2[-(chip_smoke.FAULTS_STEPS // 4):])))
    return out


def test_bench_faults_curve_matches_jax():
    """The p = 0 counts are chip_smoke.FAULTS_COUNTS (BENCH_faults.json's 156,
    258, 48) in both packages; the plateaus agree within 1e-10 relative."""
    want = _curve(JS, JM, JF)
    got = _curve(TS, TM, TF, device="cpu")
    for method, count in chip_smoke.FAULTS_COUNTS.items():
        assert want[method, 0.0][0] == got[method, 0.0][0] == count, method
    for (method, p), (count, plateau) in want.items():
        if p:
            assert count is None and got[method, p][0] is None
            assert abs(got[method, p][1] - plateau) <= chip_smoke.PLATEAU_RTOL * plateau


def test_chip_smoke_faults_phase_on_cpu():
    """chip_smoke's --faults checks at a tiny width with the plain kernels:
    every check holds (the CPU against itself) and resume is bit-equal."""
    cpu = torch.device("cpu")
    total = {}
    rows = chip_smoke.fault_checks(cpu, 64, 8, total)
    assert [r["check"] for r in rows] == [
        "p0 dense", "p0 sparse", "link dsba", "link dsa", "straggler dsba",
        "link+straggler dsba", "link mudag", "link sparse", "schedule dense",
        "schedule sparse", "churn dense", "churn sparse", "churn mudag", "churn dsgda"]
    assert total == {} or not any(total.values())  # the plain path launches no kernel
    assert all(r["churn_rows"] == 11 for r in rows if r["check"].startswith("churn"))
    for comm, steps, stop in (("dense", 200, 100), ("sparse", 100, 50)):
        out = chip_smoke.resume_check(cpu, 64, 8, comm, steps, 50, stop, total)
        assert out["bit_equal"] and out["checkpoint_bytes"] > 0
