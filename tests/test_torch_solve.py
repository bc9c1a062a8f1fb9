"""``repro_torch.core.solvers.solve`` against ``repro.core.solvers.solve``.

Dense and sparse-relay runs of dsba/dsa on ridge/logistic/AUC at a small
size (N=5, q=10, d=64, k=8, Erdos-Renyi graph) with one index stream: z,
z_trace, dist2 and consensus within 1e-12; doubles/ints exact. Then the
relay's own claims (sparse == dense, verify, the protocol check, the N=32
ring's steady-state doubles), the device rule, what is not ported yet, and
chip_smoke's phase functions at a tiny size on the CPU.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import chip_smoke
from repro.core import mixing as JM
from repro.core import solvers as JS
from repro.data.synthetic import make_classification, make_regression
from repro_torch.core import mixing as TM
from repro_torch.core import solvers as TS
from repro_torch.core import sparse_comm as TSC
from repro_torch.core.dsba import DSBAConfig, draw_indices
from repro_torch.core.operators import OperatorSpec as TSpec

TOL = 1e-12
STEPS = 30
TASKS = ["ridge", "logistic", "auc"]
METHODS = ["dsba", "dsa"]


@functools.cache
def _problems(task):
    if task == "ridge":
        data = make_regression(5, 10, 64, 8, seed=0)
    else:
        data = make_classification(5, 10, 64, 8, positive_ratio=0.3, seed=0)
    jp = JS.make_problem(task, data, JM.erdos_renyi_graph(5, 0.4, seed=2))
    jp.solve_star()
    tp = TS.make_problem(task, data, TM.erdos_renyi_graph(5, 0.4, seed=2))
    tp.z_star = jp.z_star
    assert TSpec(**dataclasses.asdict(jp.spec)) == tp.spec
    return jp, tp


@functools.cache
def _runs(task, method, comm):
    jp, tp = _problems(task)
    kw = dict(steps=STEPS, record_every=5, seed=3)
    j_opts = {"verify": True, "use_pallas": "off"} if comm == "sparse" else None
    t_opts = {"verify": True} if comm == "sparse" else None
    j = JS.solve(jp, method, comm, comm_options=j_opts, **kw)
    t = TS.solve(tp, method, comm, comm_options=t_opts, device="cpu", **kw)
    return j, t


def _assert_matches(j, t):
    for name in ("z", "dist2", "consensus"):
        np.testing.assert_allclose(getattr(t, name), getattr(j, name), rtol=0,
                                   atol=TOL, err_msg=name)
    np.testing.assert_array_equal(t.iters, j.iters)
    np.testing.assert_array_equal(t.doubles_received, j.doubles_received)
    np.testing.assert_array_equal(t.ints_received, j.ints_received)
    assert len(t.dist2) == len(t.iters)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("task", TASKS)
def test_dense_matches_jax(task, method):
    _assert_matches(*_runs(task, method, "dense"))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("task", TASKS)
def test_sparse_matches_jax(task, method):
    j, t = _runs(task, method, "sparse")
    _assert_matches(j, t)
    np.testing.assert_allclose(t.extras["z_trace"], j.extras["z_trace"], rtol=0, atol=TOL)
    assert t.extras["recon_max_err"] <= TOL


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("task", TASKS)
def test_sparse_equals_dense(task, method):
    _, dense = _runs(task, method, "dense")
    _, sparse = _runs(task, method, "sparse")
    np.testing.assert_allclose(sparse.z, dense.z, rtol=0, atol=TOL)
    assert sparse.state is None and dense.state is not None


def test_protocol_violation_on_broken_schedule(monkeypatch):
    """A ring buffer too shallow for the graph breaks availability."""
    _, tp = _problems("ridge")
    real = TSC._protocol_tables
    monkeypatch.setattr(TSC, "_protocol_tables",
                        lambda g, wt: dataclasses.replace(real(g, wt), depth=2))
    with pytest.raises(TSC.ProtocolViolation):
        TS.solve(tp, "dsba", "sparse", steps=8, alpha=0.3, device="cpu",
                 comm_options={"verify": True})


def test_fast_path_reports_nan_recon_err():
    _, tp = _problems("ridge")
    res = TS.solve(tp, "dsba", "sparse", steps=4, device="cpu")
    assert np.isnan(res.extras["recon_max_err"])


def test_ring32_steady_state_doubles():
    """N=32 ring: (N-1)*k = 248 doubles per node per iteration once every
    source's deltas arrive (diameter 16)."""
    data = make_regression(32, 4, 64, 8, seed=1)
    problem = TS.make_problem("ridge", data, TM.ring_graph(32))
    res = TS.solve(problem, "dsba", "sparse", steps=20, record_every=1,
                   alpha=0.3, device="cpu")
    per_iter = np.diff(res.doubles_received, axis=0)[-1]
    assert TSC.sparse_doubles_per_iter(32, 8, 0) == 248
    assert (per_iter == 248).all(), per_iter
    assert (np.diff(res.ints_received, axis=0)[-1] == 248).all()


def test_no_device_means_cuda(monkeypatch):
    """Entry points default to the card and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tp = _problems("ridge")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.solve(tp, "dsba", steps=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSC.run_sparse(DSBAConfig(tp.spec, 0.5, tp.lam), tp.data, tp.graph,
                       tp.w, 2, draw_indices(2, 5, 10))


@pytest.mark.parametrize("call", [
    lambda p: TS.solve(p, "dsba", "sharded", steps=2, device="cpu"),
    lambda p: TS.solve(p, "dsba", "sparse", steps=2, device="cpu",
                       comm_options={"engine": "reference"}),
    lambda p: TS.solve(p, "dsba", "dense", steps=2, device="cpu",
                       comm_options={"fault_plan": object()}),
    lambda p: TS.solve(p, "dsba", "dense", steps=2, device="cpu",
                       checkpoint=object()),
    lambda p: TS.solve_many(p, "dsba", steps=2),
    lambda p: TS.Problem(p.spec, p.data, p.graph, schedule=[(0, p.graph)]),
])
def test_unported_paths_raise(call):
    _, tp = _problems("ridge")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(tp)


def test_option_and_capability_errors():
    _, tp = _problems("ridge")
    with pytest.raises(ValueError, match="unknown dense comm_options"):
        TS.solve(tp, "dsba", "dense", steps=2, device="cpu",
                 comm_options={"verify": True})
    with pytest.raises(TypeError, match="unknown hyperparameters"):
        TS.solve(tp, "dsba", steps=2, device="cpu", beta=1.0)
    per_node = dataclasses.replace(tp, lam=np.full(5, 0.01))
    with pytest.raises(TS.CapabilityError):
        TS.solve(per_node, "dsba", "sparse", steps=2, device="cpu")
    with pytest.raises(KeyError, match="item 7"):
        TS.solve(tp, "extra", steps=2, device="cpu")


def test_chip_smoke_phases_on_cpu():
    """chip_smoke's phases at a tiny size with the plain kernels."""
    cpu = torch.device("cpu")
    errs = chip_smoke.kernel_parity(cpu, [(4, 70, 8), (3, 103, 9)])
    assert set(errs) == {"sparse_axpy", "sparse_dot"}
    total, rows = chip_smoke.slice_runs(cpu, 64, 8, n_nodes=5, q=10,
                                        dense_steps=20, sparse_steps=10,
                                        record_every=5)
    assert total == {}  # the plain path launches no kernel
    assert len(rows) == 6
    for row in rows:
        assert row["sparse_vs_dense"] <= TOL and row["recon_max_err"] <= TOL
        assert row["doubles_per_iter"] == 4 * (8 + {"auc": 3}.get(row["task"], 0))
    out = chip_smoke.widest_run(cpu, 300, 12, steps=3)
    assert out["steps"] == 3
    # 1 + 4*7 + 7 sparse_axpy calls, one launch each
    assert chip_smoke.expected_launches(7, "sparse") == {"sparse_dot": 7,
                                                         "sparse_axpy": 36}
