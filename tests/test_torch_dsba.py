"""The port's Algorithm-1 step against ``repro.core.dsba``.

Both packages start from one state: the JAX ``init_state`` result is turned
into numpy and loaded into the port with ``convert.state_from_numpy``. Then
both run the same 40-step index stream; every iterate must agree within
1e-12 (float64).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import dsba as JD
from repro.core import mixing as JM
from repro.core.operators import OperatorSpec as JSpec
from repro.data.synthetic import make_classification, make_regression
from repro_torch import convert
from repro_torch.core import dsba as TD
from repro_torch.core import mixing as TM
from repro_torch.core.comm import DenseComm
from repro_torch.core.operators import OperatorSpec as TSpec
from repro_torch.core.solvers import Problem, graph_from_mixing, solve

TOL = 1e-12
STEPS = 40
CPU = torch.device("cpu")


def _setup(task, graph_name, n=5, q=12, d=64, k=8, seed=0):
    if task == "ridge":
        data = make_regression(n, q, d, k, seed=seed)
    else:
        data = make_classification(n, q, d, k, positive_ratio=0.4, seed=seed)
    g = JM.ring_graph(n) if graph_name == "ring" else JM.erdos_renyi_graph(n, 0.4, seed=2)
    spec = {"auc": JSpec("auc", p=data.positive_ratio())}.get(task, JSpec(task))
    return data, JM.laplacian_mixing(g), spec


def _z0(data, spec, seed=11):
    rng = np.random.default_rng(seed)
    return 0.1 * rng.standard_normal((data.n_nodes, data.d + spec.tail_dim))


def _jax_state_leaves(state):
    return {f.name: np.asarray(getattr(state, f.name))
            for f in dataclasses.fields(state)}


@pytest.mark.parametrize("task", ["ridge", "logistic", "auc"])
def test_init_state_matches(task):
    data, _, spec = _setup(task, "ring")
    z0 = _z0(data, spec)
    cfg_j = JD.DSBAConfig(spec, alpha=0.3, lam=0.01)
    cfg_t = TD.DSBAConfig(TSpec(**dataclasses.asdict(spec)), alpha=0.3, lam=0.01)
    want = _jax_state_leaves(JD.init_state(cfg_j, data, jax.numpy.asarray(z0)))
    got = convert.state_to_numpy(TD.init_state(
        cfg_t, convert.dataset_to_torch(data, CPU), torch.as_tensor(z0)))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_allclose(got[name], want[name], rtol=0, atol=TOL, err_msg=name)


@pytest.mark.parametrize("method", ["dsba", "dsa"])
@pytest.mark.parametrize("graph_name", ["ring", "er"])
@pytest.mark.parametrize("task", ["ridge", "logistic", "auc"])
def test_trajectory_matches(task, graph_name, method):
    _trajectory(task, graph_name, method, lam=1.0 / 600)


@pytest.mark.parametrize("method", ["dsba", "dsa"])
def test_trajectory_matches_per_node_lam(method):
    lam = np.linspace(0.01, 0.05, 5)
    _trajectory("ridge", "ring", method, lam=lam)


def _trajectory(task, graph_name, method, lam):
    data, w, spec = _setup(task, graph_name)
    z0 = _z0(data, spec)
    cfg_j = JD.DSBAConfig(spec, alpha=0.4, lam=lam, method=method)
    cfg_t = TD.DSBAConfig(TSpec(**dataclasses.asdict(spec)), alpha=0.4, lam=lam,
                          method=method)
    st_j = JD.init_state(cfg_j, data, jax.numpy.asarray(z0))
    # one starting state for both packages
    st_t = convert.state_from_numpy(_jax_state_leaves(st_j), device=CPU)
    step_j = jax.jit(JD.make_step_fn(cfg_j, data, w))
    step_t = TD.make_step_fn(cfg_t, convert.dataset_to_torch(data, CPU), w,
                             DenseComm(graph_from_mixing(w), CPU))
    idx = JD.draw_indices(STEPS, data.n_nodes, data.q, seed=5)
    worst = 0.0
    for t in range(STEPS):
        st_j = step_j(st_j, jax.numpy.asarray(idx[t]))
        st_t = step_t(st_t, torch.as_tensor(idx[t], dtype=torch.long))
        worst = max(worst, float(np.abs(st_t.z.numpy() - np.asarray(st_j.z)).max()))
    assert worst <= TOL, worst
    final = convert.state_to_numpy(st_t)
    for name, want in _jax_state_leaves(st_j).items():
        np.testing.assert_allclose(final[name], want, rtol=0, atol=TOL, err_msg=name)


def test_single_node_dsba_is_point_saga():
    """N=1: no mixing, and DSBA's difference recursion telescopes to
    Point-SAGA (Defazio 2016) with the l2 term inside the prox:
    z <- prox_{alpha(B_i + lam I)}(z + alpha (phi_i - phibar)).
    A plain numpy Point-SAGA is the oracle (1e-12 over 60 steps)."""
    data = make_regression(n_nodes=1, q=20, d=30, k=5, seed=3)
    alpha, lam = 0.8, 1e-3
    problem = Problem(spec=TSpec("ridge"), data=data, graph=TM.Graph(1, ()),
                      w=np.ones((1, 1)), lam=lam)
    idx = JD.draw_indices(60, 1, data.q, seed=4)
    res = solve(problem, "dsba", steps=60, record_every=1, indices=idx,
                keep_snapshots=True, alpha=alpha, device="cpu")

    X = data.dense()[0]
    y = data.y[0]
    q = data.q
    rho = 1.0 / (1.0 + alpha * lam)
    a = rho * alpha
    z = np.zeros(data.d)
    table = X @ z - y
    phibar = X.T @ table / q
    worst = 0.0
    for t in range(60):
        i = idx[t, 0]
        x = X[i]
        v = z + alpha * (table[i] * x - phibar)
        xsq = x @ x
        u = (rho * (x @ v) + a * y[i] * xsq) / (1.0 + a * xsq)
        g = u - y[i]
        z = rho * v - a * g * x
        phibar = phibar + (g - table[i]) * x / q
        table[i] = g
        worst = max(worst, float(np.abs(res.zs[t, 0] - z).max()))
    assert worst <= TOL, worst
