"""The registry's other methods: ``repro_torch.core.solvers`` against ``repro.core.solvers``.

EXTRA, DLM, SSDA, Mudag, sliding, DSGDA and personalized descent on every
operator family each supports, on an Erdos-Renyi and a ring graph at a small
size (N=5, q=10, d=64, k=8), from one index stream: z, dist2 and consensus
within 1e-12 (SSDA 1e-10: its Cholesky and Newton solves sum in another
order), DOUBLEs and ints exact. Then the places where parity breaks unless
the reference is copied exactly (Mudag and sliding truncate
``gossip_rounds``/``comm_period`` in the step but round them in the
accounting; the ``t == 0`` and round gates), ``personal`` with per-node lam
and ``personalized_root``, the dense operator helpers, the capability
matrix and records, the deprecated shims, and the device rule.
"""
import dataclasses
import functools
import warnings

import numpy as np
import pytest
import torch

from repro.core import mixing as JM
from repro.core import operators as JO
from repro.core import solvers as JS
from repro.data.synthetic import make_classification, make_regression
from repro_torch.core import deprecation
from repro_torch.core import mixing as TM
from repro_torch.core import operators as TO
from repro_torch.core import solvers as TS
from repro_torch.core.baselines import run_dlm, run_extra, run_ssda
from repro_torch.core.dsba import DSBAConfig, draw_indices
from repro_torch.core.dsba import run as legacy_run

TOL = 1e-12
SSDA_TOL = 1e-10
STEPS = 30
NEW_METHODS = ("extra", "dlm", "ssda", "mudag", "sliding", "dsgda", "personal")
GRAPHS = ("erdos_renyi", "ring")
PAIRS = [(m, f) for m in NEW_METHODS for f in JO.FAMILIES
         if JS.available_solvers()[m].supports("dense", f)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's CPU threads are unsteady beside JAX (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(family, n=5, q=10, d=64, k=8, seed=0):
    if family in ("ridge", "bilinear"):
        return make_regression(n, q, d, k, seed=seed)
    return make_classification(n, q, d, k, positive_ratio=0.3, seed=seed)


def _graphs(gname, n=5):
    if gname == "ring":
        return JM.ring_graph(n), TM.ring_graph(n)
    return JM.erdos_renyi_graph(n, 0.4, seed=2), TM.erdos_renyi_graph(n, 0.4, seed=2)


@functools.cache
def _problems(family, gname):
    jg, tg = _graphs(gname)
    data = _data(family)
    jp = JS.make_problem(family, data, jg)
    jp.solve_star()
    tp = TS.make_problem(family, data, tg)
    tp.z_star = jp.z_star
    return jp, tp


def _hp(method, problem):
    # SSDA's dual step must stay below lam / lambda_max(I - W): its default
    # (0.05) diverges in both packages at lam = 1/(10 Q)
    return {"eta": float(problem.lam)} if method == "ssda" else {}


def _assert_matches(j, t, tol=TOL):
    for name in ("z", "dist2", "consensus"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name), rtol=0,
                                   atol=tol, err_msg=name)
    np.testing.assert_array_equal(t.iters, j.iters)
    np.testing.assert_array_equal(t.doubles_received, j.doubles_received)
    np.testing.assert_array_equal(t.ints_received, j.ints_received)
    assert np.isfinite(t.z).all()


@pytest.mark.parametrize("gname", GRAPHS)
@pytest.mark.parametrize("method,family", PAIRS)
def test_dense_matches_jax(method, family, gname):
    jp, tp = _problems(family, gname)
    kw = dict(steps=STEPS, record_every=5, seed=3, **_hp(method, jp))
    j = JS.solve(jp, method, **kw)
    t = TS.solve(tp, method, device="cpu", **kw)
    assert len(t.dist2) == len(t.iters) == STEPS // 5
    _assert_matches(j, t, SSDA_TOL if method == "ssda" else TOL)


@pytest.mark.parametrize("method,key,value,taken,accounted", [
    # the step truncates (JAX: astype(int32)), the accounting rounds
    ("mudag", "gossip_rounds", 2.6, 2, 3),
    ("mudag", "gossip_rounds", 2.5, 2, 2),  # Python's round(2.5) == 2
    ("mudag", "gossip_rounds", 4, 4, 4),
    ("sliding", "comm_period", 2.6, 2, 3),
    ("sliding", "comm_period", 3.5, 3, 4),
    ("sliding", "comm_period", 4, 4, 4),
])
def test_rounds_truncate_in_the_step_and_round_in_the_accounting(
        method, key, value, taken, accounted):
    """Mudag spends 2K rounds an iteration, sliding 2*ceil(iters/period):
    with K and the period rounded, while the step runs them truncated."""
    jp, tp = _problems("ridge", "erdos_renyi")
    kw = dict(steps=22, record_every=4, seed=1)
    j = JS.solve(jp, method, **kw, **{key: value})
    t = TS.solve(tp, method, device="cpu", **kw, **{key: value})
    _assert_matches(j, t)
    same_step = TS.solve(tp, method, device="cpu", **kw, **{key: taken})
    np.testing.assert_array_equal(t.z, same_step.z)
    per_round = tp.graph.degrees * tp.dim
    if method == "mudag":
        rounds = 2 * accounted * t.iters
    else:
        rounds = 2 * np.ceil(t.iters / accounted)
    np.testing.assert_array_equal(t.doubles_received, rounds[:, None] * per_round[None, :])


def test_sliding_mixes_only_on_communication_rounds(monkeypatch):
    """Off-round steps skip the mixing products (their values are the ones
    the JAX package's select keeps): 2 matvecs every comm_period steps."""
    _, tp = _problems("ridge", "ring")
    TS.clear_runner_caches()  # the step binds its products when its runner is built
    calls = []
    real = TS.DenseComm.matvec

    def counting(self, m, dtype):
        mix = real(self, m, dtype)
        return lambda x: calls.append(1) or mix(x)

    monkeypatch.setattr(TS.DenseComm, "matvec", counting)
    TS.solve(tp, "sliding", steps=9, record_every=9, device="cpu", comm_period=4)
    assert len(calls) == 2 * 3  # t = 0, 4, 8


def test_state_counters_are_host_ints():
    """The t == 0 and round gates branch on the host: no step syncs."""
    for method, family in PAIRS:
        _, tp = _problems(family, "ring")
        res = TS.solve(tp, method, steps=3, device="cpu", **_hp(method, tp))
        if method not in ("dlm", "ssda", "personal"):
            assert type(res.state[-1]) is int and res.state[-1] == 3, method


def test_dsgda_state_order_matches_jax():
    """(z, table g, table tail, phibar, tracker, v_prev, t): the order the
    reference's churn reanchor indexes."""
    jp, tp = _problems("auc", "erdos_renyi")
    j = JS.solve(jp, "dsgda", steps=7, record_every=7, seed=5)
    t = TS.solve(tp, "dsgda", steps=7, record_every=7, seed=5, device="cpu")
    assert len(t.state) == len(j.state) == 7
    for a, b in zip(t.state[:-1], j.state[:-1]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)
    assert t.state[-1] == int(j.state[-1]) == 7


def test_ssda_factorizes_once_a_run(monkeypatch):
    """The Cholesky factors are built once a solve() and shared by the step
    and the read-out."""
    _, tp = _problems("ridge", "ring")
    TS.clear_runner_caches()  # the factors are built with the run's runner
    calls = []
    real = torch.linalg.cholesky
    monkeypatch.setattr(torch.linalg, "cholesky", lambda a: calls.append(a.shape) or real(a))
    TS.solve(tp, "ssda", steps=6, record_every=2, device="cpu", eta=float(tp.lam))
    assert calls == [(5, 64, 64)]


# ---------------------------------------------------------------------------
# personalization: per-node lam and the personalized root
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("gname", GRAPHS)
@pytest.mark.parametrize("family", ["ridge", "logistic"])
def test_personal_per_node_lam_and_root_match_jax(family, gname):
    jg, tg = _graphs(gname)
    data = _data(family)
    lam = np.linspace(0.005, 0.02, 5)
    jp = JS.make_problem(family, data, jg, lam=lam)
    tp = TS.make_problem(family, data, tg, lam=lam)
    j_root = JS.personalized_root(jp, mu=0.7)
    t_root = TS.personalized_root(tp, mu=0.7, device="cpu")
    np.testing.assert_allclose(t_root, j_root, rtol=0, atol=TOL)
    jp.z_star, tp.z_star = j_root, t_root
    kw = dict(steps=STEPS, record_every=5, seed=0, mu=0.7, alpha=0.3)
    j = JS.solve(jp, "personal", **kw)
    t = TS.solve(tp, "personal", device="cpu", **kw)
    _assert_matches(j, t)
    assert t.dist2[-1] < t.dist2[0]


# ---------------------------------------------------------------------------
# the dense operator helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", JO.FAMILIES)
def test_operator_helpers_match_jax(family):
    assert TO.MINIMIZATION_FAMILIES == JO.MINIMIZATION_FAMILIES
    data = _data(family)
    jspec = JS.make_problem(family, data, JM.ring_graph(5)).spec
    tspec = TO.OperatorSpec(**dataclasses.asdict(jspec))
    rng = np.random.default_rng(0)
    z = rng.normal(size=data.d + tspec.tail_dim)
    feats, y = data.dense()[1], data.y[1]
    want = JO.full_operator_dense(jspec, z, feats, y, 0.03)
    got = TO.full_operator_dense(tspec, torch.as_tensor(z), torch.as_tensor(feats),
                                 torch.as_tensor(y), 0.03)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    for i in range(data.q):
        want = JO.sample_operator_sparse(jspec, z, data.idx[1, i], data.val[1, i], y[i])
        got = TO.sample_operator_sparse(
            tspec, torch.as_tensor(z), torch.as_tensor(data.idx[1, i]),
            torch.as_tensor(data.val[1, i]), torch.as_tensor(y[i]))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# the capability matrix (tests/test_capabilities.py's, on the port)
# ---------------------------------------------------------------------------

N, Q, D, K = 4, 6, 8, 3
MATRIX_HP = {"ssda": dict(eta=1e-3, momentum=0.0), "mudag": dict(eta=0.5, momentum=0.5)}


@functools.cache
def _matrix_problem(family):
    if family in ("ridge", "bilinear"):
        data = make_regression(N, Q, D, k=K, seed=0)
    elif family == "logistic":
        data = make_classification(N, Q, D, k=K, seed=0)
    else:
        data = make_classification(N, Q, D, k=K, positive_ratio=0.3, seed=0)
    return TS.make_problem(family, data, TM.ring_graph(N), lam=1e-2)


def test_capability_records_equal_jax():
    want = {m: dataclasses.asdict(c) for m, c in JS.available_solvers().items()}
    got = {m: dataclasses.asdict(c) for m, c in TS.available_solvers().items()}
    assert got == want
    assert len(got) == 9
    for m, c in TS.available_solvers().items():
        assert c.comm_backends() == JS.available_solvers()[m].comm_backends()


@pytest.mark.parametrize("comm", ["dense", "sparse"])
@pytest.mark.parametrize("family", TO.FAMILIES)
@pytest.mark.parametrize("method", sorted(JS.available_solvers()))
def test_matrix_solves_or_raises_capability_error(method, family, comm):
    caps = TS.available_solvers()[method]
    problem = _matrix_problem(family)
    try:
        res = TS.solve(problem, method, comm=comm, steps=6, record_every=3,
                       seed=0, device="cpu", **MATRIX_HP.get(method, {}))
    except TS.CapabilityError as e:
        assert not caps.supports(comm, family)
        assert (e.method, e.comm, e.family) == (method, comm, family)
        return
    assert caps.supports(comm, family)
    assert res.method == method and res.comm == comm
    assert res.z.shape == (N, D + problem.spec.tail_dim)
    assert np.isfinite(res.z).all()


def test_matrix_agrees_with_advertised_support_counts():
    avail = TS.available_solvers()
    supported = sum(avail[m].supports(c, f) for m in avail
                    for c in ("dense", "sparse") for f in TO.FAMILIES)
    assert len(avail) * 2 * len(TO.FAMILIES) == 72
    assert supported == 32


@pytest.mark.parametrize("flag", [None, "schedule", "churn", "per_node_lam",
                                  "link_faults", "stragglers"])
def test_check_capability_raises_as_jax_does(flag):
    """Every method, backend and family, with each dynamic-network flag:
    the same outcome and the same reason text as the JAX package."""
    kw = {} if flag is None else {flag: True}

    def outcome(mod, method, comm, family):
        try:
            mod._check_capability(mod.get_solver(method), comm, family, **kw)
        except mod.CapabilityError as e:
            return str(e)
        return None

    for method in JS.available_solvers():
        for comm in ("dense", "sparse", "sharded"):
            for family in JO.FAMILIES:
                assert outcome(TS, method, comm, family) == outcome(JS, method, comm, family)


def test_per_node_lam_on_unsupporting_method_raises():
    problem = dataclasses.replace(_matrix_problem("ridge"), lam=np.full(N, 1e-2))
    for method, caps in TS.available_solvers().items():
        if caps.supports_per_node_lam or not caps.supports("dense", "ridge"):
            continue
        with pytest.raises(TS.CapabilityError) as ei:
            TS.solve(problem, method, steps=6, device="cpu", **MATRIX_HP.get(method, {}))
        assert (ei.value.method, ei.value.comm, ei.value.family) == (method, "dense", "ridge")


def test_personal_under_sharded_is_a_capability_error():
    """The reference's record says personal has no sharded step; another
    method's sharded run matches its dense run."""
    from repro_torch.launch.mesh import close_all

    problem = _matrix_problem("ridge")
    with pytest.raises(TS.CapabilityError, match="sharded backend"):
        TS.solve(problem, "personal", "sharded", steps=2, device="cpu")
    try:
        res = TS.solve(problem, "extra", "sharded", steps=2, device="cpu")
    finally:
        close_all()
    dense = TS.solve(problem, "extra", steps=2, device="cpu")
    np.testing.assert_allclose(res.z, dense.z, rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# the deprecated shims (tests/test_deprecated_shims.py's, on the port)
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_deprecations():
    deprecation.reset()
    yield
    deprecation.reset()


def _shim_problem(task, gname):
    data = make_regression(5, 6, 16, k=4, seed=0) if task == "ridge" else \
        make_classification(5, 6, 16, k=4, positive_ratio=0.3, seed=0)
    graph = TM.ring_graph(5) if gname == "ring" else TM.erdos_renyi_graph(5, 0.4, seed=1)
    problem = TS.make_problem(task, data, graph, lam=1e-2)
    problem.solve_star(device="cpu")
    return problem


@pytest.mark.parametrize("gname", GRAPHS)
@pytest.mark.parametrize("task", ["ridge", "logistic", "auc"])
def test_shims_match_solve(task, gname, fresh_deprecations):
    problem = _shim_problem(task, gname)
    data, w, lam, z_star = problem.data, problem.w, problem.lam, problem.z_star
    indices = draw_indices(24, 5, data.q, seed=5)
    for method in ("dsba", "dsa"):
        cfg = DSBAConfig(problem.spec, 0.3, lam, method=method)
        deprecation.reset()
        with pytest.warns(DeprecationWarning):
            legacy = legacy_run(cfg, data, w, 24, record_every=8, indices=indices,
                                keep_snapshots=True, device="cpu")
        new = TS.solve(problem, method, steps=24, record_every=8, indices=indices,
                       keep_snapshots=True, alpha=0.3, device="cpu")
        assert np.array_equal(legacy.zs, new.zs)
        assert np.array_equal(legacy.state.z.numpy(), new.z)
    runs = [(lambda: run_extra(problem.spec, data, w, alpha=0.2, lam=lam, steps=24,
                               z_star=z_star, record_every=8, device="cpu"),
             "extra", dict(alpha=0.2)),
            (lambda: run_dlm(problem.spec, data, problem.graph, c=0.3, beta=1.0, lam=lam,
                             steps=24, z_star=z_star, record_every=8, device="cpu"),
             "dlm", dict(c=0.3, beta=1.0))]
    if task != "auc":
        runs.append((lambda: run_ssda(problem.spec, data, w, eta=0.005, momentum=0.5,
                                      lam=lam, steps=24, z_star=z_star, record_every=8,
                                      device="cpu"),
                     "ssda", dict(eta=0.005, momentum=0.5)))
    for shim, method, hp in runs:
        deprecation.reset()
        with pytest.warns(DeprecationWarning, match=r"REMOVED in v0\.2"):
            legacy = shim()
        new = TS.solve(problem, method, steps=24, record_every=8, device="cpu", **hp)
        np.testing.assert_array_equal(legacy.dist2, new.dist2)
        np.testing.assert_array_equal(legacy.consensus, new.consensus)
        np.testing.assert_array_equal(legacy.iters, new.iters)
        if method != "ssda":  # SSDA's state is the dual; z is its read-out
            np.testing.assert_array_equal(legacy.state[0].numpy(), new.z)


def test_shims_warn_once_per_process_at_caller(fresh_deprecations):
    problem = _shim_problem("ridge", "ring")
    cfg = DSBAConfig(problem.spec, 0.3, problem.lam, method="dsba")
    for call in (lambda: legacy_run(cfg, problem.data, problem.w, 4, record_every=4,
                                    device="cpu"),
                 lambda: run_extra(problem.spec, problem.data, problem.w, alpha=0.2,
                                   lam=problem.lam, steps=4, device="cpu"),
                 lambda: run_dlm(problem.spec, problem.data, problem.graph, c=0.3, beta=1.0,
                                 lam=problem.lam, steps=4, device="cpu"),
                 lambda: run_ssda(problem.spec, problem.data, problem.w, eta=0.005,
                                  momentum=0.5, lam=problem.lam, steps=4, device="cpu")):
        deprecation.reset()
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            for _ in range(3):
                call()
        dep = [w for w in rec if issubclass(w.category, DeprecationWarning)]
        assert len(dep) == 1
        assert dep[0].filename == __file__
        assert "REMOVED in v0.2" in str(dep[0].message)


# ---------------------------------------------------------------------------
# the device rule
# ---------------------------------------------------------------------------


def test_no_device_means_cuda(monkeypatch):
    """Every new entry point defaults to the card and raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for method, family in PAIRS:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TS.solve(_problems(family, "ring")[1], method, steps=2)
    problem = _shim_problem("ridge", "ring")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.personalized_root(problem)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_extra(problem.spec, problem.data, problem.w, alpha=0.2, lam=problem.lam, steps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        legacy_run(DSBAConfig(problem.spec, 0.3, problem.lam), problem.data, problem.w, 2)
