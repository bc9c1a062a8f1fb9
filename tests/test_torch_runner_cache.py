"""The port's runner cache (``repro_torch.core.runner_cache``) against the
JAX package's compiled-runner cache.

Port counterparts of tests/test_runner_cache.py's cache claims, at a small
size (N=5, q=6, d=16, k=4, 24 steps):

1. Keying: distinct problems (N, d, dtype, family, dataset object, device)
   never collide; a problem rebuilt around the same data and graph (fresh
   equal W, new lam) shares one runner.
2. No rebuild on value sweeps: a second ``solve()`` with new
   hyperparameter values adds a hit and no trace; a static one (SSDA's
   ``inner_newton``) adds a miss.
3. Correctness: warm results are bit-equal to cold ones.

The stats of the same ``solve()`` call sequences equal the JAX package's
(hits, misses, traces, evictions, size), the LRU bound included; the
factory-time guard is the reference's Mapping of statics.
"""
import numpy as np
import pytest
import torch

from repro.core import mixing as JM
from repro.core import runner_cache as JRC
from repro.core import solvers as JS
from repro.data.synthetic import make_classification, make_regression
from repro_torch.core import mixing as TM
from repro_torch.core import runner_cache
from repro_torch.core import solvers as TS
from repro_torch.core.solvers import (
    TracedHPError,
    _FactoryHP,
    _runner_key,
    clear_runner_caches,
    get_solver,
    make_problem,
    runner_cache_stats,
    solve,
)

STEPS = 24
REC = 8
CPU = "cpu"


def _problem(task="ridge", n_nodes=5, q=6, d=16, k=4, lam=1e-2, seed=0,
             dtype=np.float64, pkg=None):
    """The reference test's problem, for the port (or, with ``pkg``, for
    the JAX package on the same data)."""
    if task == "ridge":
        data = make_regression(n_nodes, q, d, k=k, seed=seed, dtype=dtype)
    else:
        data = make_classification(n_nodes, q, d, k=k, seed=seed)
    if pkg is JS:
        return JS.make_problem(task, data, JM.erdos_renyi_graph(n_nodes, 0.5, seed=1), lam=lam)
    return make_problem(task, data, TM.erdos_renyi_graph(n_nodes, 0.5, seed=1), lam=lam)


@pytest.fixture(autouse=True)
def _fresh_caches():
    """Empty caches around every test; torch on one thread (a parity file:
    see tests/test_torch_ssm.py's fixture for why)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    clear_runner_caches()
    yield
    clear_runner_caches()
    torch.set_num_threads(threads)


def _solve(problem, method, **kw):
    return solve(problem, method, steps=kw.pop("steps", STEPS),
                 record_every=kw.pop("record_every", REC), device=CPU, **kw)


# ---------------------------------------------------------------------------
# no rebuild: hp values are call arguments, not key material
# ---------------------------------------------------------------------------


def test_second_solve_with_new_hp_does_not_rebuild():
    problem = _problem()
    _solve(problem, "dsba", alpha=0.3)
    s0 = runner_cache_stats()["dense"]
    assert s0["misses"] == 1 and s0["traces"] >= 1
    _solve(problem, "dsba", alpha=0.9)
    s1 = runner_cache_stats()["dense"]
    assert s1["traces"] == s0["traces"], "a new alpha must not rebuild"
    assert s1["hits"] == s0["hits"] + 1
    assert s1["misses"] == s0["misses"]


def test_new_lam_on_same_data_does_not_rebuild():
    """bench_table1's sweep shape: a fresh Problem per lam, same data/graph."""
    data = make_regression(5, 6, 16, k=4, seed=0)
    graph = TM.ring_graph(5)
    for lam in (1e-1, 1e-2, 1e-3):
        _solve(make_problem("ridge", data, graph, lam=lam), "dsba", alpha=0.5)
    s = runner_cache_stats()["dense"]
    assert s["misses"] == 1 and s["hits"] == 2


def test_sparse_second_call_with_new_hp_does_not_rebuild():
    problem = _problem()
    _solve(problem, "dsba", comm="sparse", alpha=0.3)
    s0 = runner_cache_stats()["sparse"]
    assert s0["misses"] == 1 and s0["traces"] == 1
    _solve(problem, "dsba", comm="sparse", alpha=0.7)
    s1 = runner_cache_stats()["sparse"]
    assert s1["traces"] == s0["traces"], "a new alpha must not rebuild"
    assert s1["hits"] == s0["hits"] + 1


def test_static_hp_change_rebuilds_but_value_sweep_does_not():
    problem = _problem()
    _solve(problem, "ssda", steps=4, record_every=4, eta=0.05)
    s0 = runner_cache_stats()["dense"]
    _solve(problem, "ssda", steps=4, record_every=4, eta=0.01, momentum=0.9)
    s1 = runner_cache_stats()["dense"]
    assert s1["traces"] == s0["traces"]  # eta/momentum are call arguments
    _solve(problem, "ssda", steps=4, record_every=4, inner_newton=4)
    s2 = runner_cache_stats()["dense"]
    assert s2["misses"] == s1["misses"] + 1  # structural: a new runner


# ---------------------------------------------------------------------------
# keying: distinct problems never collide
# ---------------------------------------------------------------------------


def test_distinct_problems_do_not_collide():
    problems = [
        _problem(),                      # base
        _problem(n_nodes=6),             # different N (and graph)
        _problem(d=24),                  # different d
        _problem(dtype=np.float32),      # different dtype
        _problem(task="logistic"),       # different operator family
    ]
    results = [_solve(p, "dsba", alpha=0.3) for p in problems]
    assert runner_cache_stats()["dense"]["misses"] == len(problems)
    # every cached runner keeps answering for ITS problem
    for p, r in zip(problems, results):
        assert np.array_equal(r.z, _solve(p, "dsba", alpha=0.3).z)
    s = runner_cache_stats()["dense"]
    assert s["misses"] == len(problems) and s["hits"] == len(problems)


def test_same_shape_different_data_objects_do_not_collide():
    """Identity keying: equal shapes but different samples must miss."""
    graph = TM.ring_graph(5)
    pa = make_problem("ridge", make_regression(5, 6, 16, k=4, seed=0), graph, lam=1e-2)
    pb = make_problem("ridge", make_regression(5, 6, 16, k=4, seed=7), graph, lam=1e-2)
    ra = _solve(pa, "dsba", alpha=0.3)
    rb = _solve(pb, "dsba", alpha=0.3)
    assert runner_cache_stats()["dense"]["misses"] == 2
    assert not np.array_equal(ra.z, rb.z)


def test_cpu_and_cuda_keys_never_collide():
    """The device is part of every key: a CPU runner and a CUDA runner of
    the same problem are two entries."""
    problem = _problem()
    spec, hp = get_solver("dsba"), {"alpha": 0.5}
    k_cpu, guards = _runner_key(spec, problem, hp, torch.device("cpu"))
    k_cuda, _ = _runner_key(spec, problem, hp, torch.device("cuda", 0))
    assert k_cpu != k_cuda
    fp = [runner_cache.problem_fingerprint(problem.data, problem.spec, problem.graph,
                                           problem.w, dev) for dev in ("cpu", "cuda:0")]
    assert fp[0] != fp[1] and fp[0][:-1] == fp[1][:-1]
    for key in (k_cpu, k_cuda, k_cpu):
        runner_cache.DENSE.get_or_build(key, guards, lambda: object())
    s = runner_cache_stats()["dense"]
    assert (s["misses"], s["hits"], s["size"]) == (2, 1, 2)


# ---------------------------------------------------------------------------
# correctness: cached == cold, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method,hp", [
    ("dsba", {"alpha": 0.4}),
    ("dsa", {"alpha": 0.2}),
    ("extra", {"alpha": 0.2}),
    ("dlm", {"c": 0.3, "beta": 1.0}),
    ("ssda", {"eta": 0.05, "momentum": 0.5}),
])
def test_cached_results_bit_equal_to_cold(method, hp):
    problem = _problem()
    problem.solve_star(device=CPU)
    kw = dict(keep_snapshots=True)
    cold = _solve(problem, method, **kw, **hp)
    # run the runner on other hp values, then replay the originals
    _solve(problem, method, **kw, **{k: 0.5 * v for k, v in hp.items()})
    warm = _solve(problem, method, **kw, **hp)
    assert runner_cache_stats()["dense"]["hits"] >= 2
    for name in ("z", "zs", "dist2", "consensus"):
        assert np.array_equal(getattr(cold, name), getattr(warm, name)), name


def test_sparse_cached_bit_equal_to_cold():
    problem = _problem()
    cold = _solve(problem, "dsba", comm="sparse", alpha=0.3)
    _solve(problem, "dsba", comm="sparse", alpha=0.8)
    warm = _solve(problem, "dsba", comm="sparse", alpha=0.3)
    assert np.array_equal(cold.z, warm.z)
    assert np.array_equal(cold.extras["z_trace"], warm.extras["z_trace"])
    assert np.array_equal(cold.doubles_received, warm.doubles_received)


def test_results_do_not_alias_the_runner():
    """A run's state is its own: writing into it leaves the next warm run
    (and the runner's data) untouched."""
    problem = _problem()
    first = _solve(problem, "dsba", alpha=0.3)
    first.state.z.fill_(7.0)
    first.state.table_g.fill_(7.0)
    first.state.dval_prev.fill_(7.0)
    again = _solve(problem, "dsba", alpha=0.3)
    clear_runner_caches()
    cold = _solve(problem, "dsba", alpha=0.3)
    assert np.array_equal(again.z, cold.z)


# ---------------------------------------------------------------------------
# the factory-time guard, the LRU bound, and stats equal to the JAX package's
# ---------------------------------------------------------------------------


def test_factory_hp_guard_is_a_mapping_of_statics_only():
    """Reading a per-run name at factory time fails loudly; the Mapping
    protocol (in / get / iteration) stays honest for probing."""
    fhp = _FactoryHP({"alpha": 0.3, "inner": 4}, static=("inner",))
    assert fhp["inner"] == 4
    with pytest.raises(TracedHPError, match="runtime-traced"):
        fhp["alpha"]
    with pytest.raises(KeyError):
        fhp["nope"]
    assert "alpha" not in fhp and "inner" in fhp
    assert fhp.get("alpha", None) is None  # probing never explodes
    assert dict(fhp) == {"inner": 4}


def test_cache_is_lru_bounded():
    assert runner_cache.DENSE.capacity == 32
    cap = runner_cache.DENSE.capacity
    runner_cache.DENSE.capacity = 2
    try:
        problems = [_problem(seed=s) for s in range(3)]
        for p in problems:
            _solve(p, "dsba", steps=4, record_every=4, alpha=0.3)
        s = runner_cache_stats()["dense"]
        assert s["size"] == 2 and s["evictions"] == 1
        # the evicted (oldest) problem rebuilds; the newest still hits
        _solve(problems[-1], "dsba", steps=4, record_every=4, alpha=0.5)
        assert runner_cache_stats()["dense"]["hits"] >= 1
        _solve(problems[0], "dsba", steps=4, record_every=4, alpha=0.3)
        assert runner_cache_stats()["dense"]["misses"] == 4
    finally:
        runner_cache.DENSE.capacity = cap


def _sequence(pkg, capacity=None):
    """One call sequence (value sweeps, a lam sweep on fresh problems, the
    relay and relay sweeps (``solve_many`` before and after a sequential
    relay, so the batched entry is built both ways), SSDA's static hp, an
    LRU eviction) and the stats after each call."""
    kw = {} if pkg is JS else {"device": CPU}
    cache = JRC if pkg is JS else runner_cache
    pkg.clear_runner_caches()
    cap = cache.DENSE.capacity
    cache.DENSE.capacity = capacity or cap
    out = []
    try:
        p = _problem(pkg=pkg)
        calls = [
            lambda: pkg.solve(p, "dsba", steps=STEPS, record_every=REC, alpha=0.3, **kw),
            lambda: pkg.solve(p, "dsba", steps=STEPS, record_every=REC, alpha=0.9, **kw),
            lambda: pkg.solve(pkg.make_problem("ridge", p.data, p.graph, lam=1e-3), "dsba",
                              steps=STEPS, record_every=REC, alpha=0.3, **kw),
            lambda: pkg.solve(p, "dsa", steps=STEPS, record_every=REC, **kw),
            lambda: pkg.solve_many(p, "dsba", "sparse", steps=STEPS, record_every=REC,
                                   grid=[{"alpha": 0.3}, {"alpha": 0.5}], **kw),
            lambda: pkg.solve(p, "dsba", "sparse", steps=STEPS, record_every=REC, alpha=0.3, **kw),
            lambda: pkg.solve(p, "dsba", "sparse", steps=STEPS, record_every=REC, alpha=0.7, **kw),
            lambda: pkg.solve_many(p, "dsba", "sparse", steps=STEPS, record_every=REC,
                                   grid=[{"alpha": a} for a in (0.4, 0.6, 0.7)], **kw),
            lambda: pkg.solve(p, "dsa", "sparse", steps=STEPS, record_every=REC, **kw),
            lambda: pkg.solve_many(p, "dsa", "sparse", steps=STEPS, record_every=REC,
                                   grid=[{"alpha": 0.1}, {"alpha": 0.2}], **kw),
            lambda: pkg.solve(p, "ssda", steps=4, record_every=4, eta=0.05, **kw),
            lambda: pkg.solve(p, "ssda", steps=4, record_every=4, eta=0.01, momentum=0.9, **kw),
            lambda: pkg.solve(p, "ssda", steps=4, record_every=4, inner_newton=4, **kw),
            lambda: pkg.solve(p, "dsba", steps=STEPS, record_every=REC, alpha=0.5, **kw),
        ]
        for call in calls:
            call()
            out.append(pkg.runner_cache_stats())
    finally:
        cache.DENSE.capacity = cap
        pkg.clear_runner_caches()
    return out


@pytest.mark.parametrize("capacity", [None, 2])
def test_stats_equal_the_jax_packages(capacity):
    """The same solve()/solve_many() sequence gives the same stats in both
    packages, call by call: hits, misses, traces (two a dense runner, one a
    relay's first sequential call and one its batched entry; none on a
    value sweep), evictions and size. With capacity 2 the third
    runner evicts the first, which then misses again."""
    want = _sequence(JS, capacity)
    got = _sequence(TS, capacity)
    for i, (g, w) in enumerate(zip(got, want)):
        for name in ("dense", "sparse"):
            assert g[name] == w[name], (i, name, g[name], w[name])
    if capacity == 2:
        assert got[-1]["dense"]["evictions"] >= 1
