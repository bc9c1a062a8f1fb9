"""Operator coefficients, tails and resolvents, and the centralized oracle,
against the JAX package: elementwise, float64, within 1e-12."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mixing as JM
from repro.core import reference as JR
from repro.core.operators import OperatorSpec as JSpec
from repro.core.solvers import make_problem as jmake
from repro.data.synthetic import make_classification, make_regression
from repro_torch.core import reference as TR
from repro_torch.core.operators import OperatorSpec as TSpec

TOL = 1e-12
KINDS = [("ridge", {}), ("logistic", {}), ("auc", {"p": 0.3}),
         ("bilinear", {"gamma": 0.7})]


def _inputs(kind, n=16, seed=0):
    rng = np.random.default_rng(seed)
    t = {"ridge": 0, "logistic": 0, "auc": 3, "bilinear": 1}[kind]
    u = rng.standard_normal(n)
    y = np.where(rng.random(n) < 0.4, 1.0, -1.0) if kind != "ridge" else rng.standard_normal(n)
    tail = rng.standard_normal((n, t))
    xsq = rng.uniform(0.5, 1.5, n)
    a_eff = rng.uniform(0.05, 2.0, n)
    return u, y, tail, xsq, a_eff


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("kind,kw", KINDS)
def test_coeff_and_tail_match(kind, kw):
    u, y, tail, _, _ = _inputs(kind)
    g_t, tl_t = TSpec(kind, **kw).coeff_and_tail(*map(torch.as_tensor, (u, y, tail)))
    g_j, tl_j = jax.vmap(JSpec(kind, **kw).coeff_and_tail)(u, y, tail)
    _close(g_t, g_j)
    _close(tl_t, tl_j)


@pytest.mark.parametrize("per_node", [False, True])
@pytest.mark.parametrize("kind,kw", KINDS)
def test_resolvent_matches(kind, kw, per_node):
    """Scalar a_eff (the paper's setting) and per-node a_eff (personal lam)."""
    s, y, tail, xsq, a_vec = _inputs(kind, seed=1)
    spec_t, spec_j = TSpec(kind, **kw), JSpec(kind, **kw)
    a_eff = a_vec if per_node else 0.37
    a_t = torch.as_tensor(a_vec) if per_node else a_eff
    g_t, tl_t = spec_t.resolvent_coeff_and_tail(
        torch.as_tensor(s), torch.as_tensor(tail), torch.as_tensor(y), a_t,
        torch.as_tensor(xsq))
    a_j = jnp.asarray(a_vec) if per_node else jnp.full(s.shape, a_eff)
    g_j, tl_j = jax.vmap(spec_j.resolvent_coeff_and_tail)(s, tail, y, a_j, xsq)
    _close(g_t, g_j)
    _close(tl_t, tl_j)


def test_logistic_newton_solves_its_equation():
    """The 20-step Newton root satisfies u + a*xsq*g(u) = s."""
    s, y, _, xsq, _ = map(torch.as_tensor, _inputs("logistic", seed=2))
    g = TSpec("logistic").resolvent_coeff_and_tail(s, s[:, None][:, :0], y, 0.8, xsq)[0]
    u = s - 0.8 * xsq * g
    torch.testing.assert_close(u + 0.8 * xsq * (-y / (1 + torch.exp(y * u))), s,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("task", ["ridge", "logistic", "auc", "bilinear"])
def test_reference_root_and_objective_match(task):
    if task == "ridge":
        data = make_regression(4, 6, 24, 4, seed=0)
    else:
        data = make_classification(4, 6, 24, 4, positive_ratio=0.4, seed=0)
    jp = jmake(task, data, JM.ring_graph(4))
    spec_t = TSpec(**dataclasses.asdict(jp.spec))
    z_t = TR.solve_root(spec_t, data, jp.lam, device="cpu")
    z_j = JR.solve_root(jp.spec, data, jp.lam)
    np.testing.assert_allclose(z_t, z_j, rtol=0, atol=TOL)
    f_t = TR.objective(spec_t, data, jp.lam, device="cpu")(torch.as_tensor(z_j))
    f_j = JR.objective(jp.spec, data, jp.lam)(jnp.asarray(z_j))
    assert abs(float(f_t) - float(f_j)) <= TOL
    if task == "auc":
        assert TR.auc_score(z_j[: data.d], data) == JR.auc_score(z_j[: data.d], data)
