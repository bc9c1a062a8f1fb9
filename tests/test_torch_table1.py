"""Paper Table 1's iteration counts: the port against the JAX package.

``benchmarks/bench_table1.py``'s setup (N=6, q=30, d=200, k=8, ER(0.4)
seed 1, data seed 0): iterations to dist2 <= 1e-10 for dsba, dsa, extra,
mudag and sliding on ridge at lam = 1e-1, 1e-2, 1e-3, and for dsba, dsa and
dsgda on the bilinear saddle at lam = 1e-2, each at the script's step size
and record period. The JAX package's count is computed here, and must be
``chip_smoke.TABLE1_COUNTS`` (the table the script prints); the port's
count on the CPU must equal it. A run stops one record period past the
expected count, which decides the count either way: a later crossing
reads None and an earlier one a smaller number; an expected None runs
the script's whole length.
"""
import functools

import numpy as np
import pytest
import torch

import chip_smoke as cs
from repro.core import mixing as JM
from repro.core import solvers as JS
from repro.data.synthetic import make_regression

CASES = [(task, lam, method, count)
         for (task, lam), want in cs.TABLE1_COUNTS.items()
         for method, count in want.items()]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """torch's CPU threads are unsteady beside JAX (ROADMAP Queue 3)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _jax_problem(task, lam):
    data = make_regression(**cs.TABLE1_DATA)
    graph = JM.erdos_renyi_graph(**cs.TABLE1_GRAPH)
    problem = JS.make_problem(task, data, graph, lam=lam)
    problem.solve_star()
    return problem


@functools.cache
def _port_problem(task, lam):
    return cs.table1_problem(task, lam)


def _stop(method, count):
    every = cs.TABLE1_RUNS[method][0]
    return cs.TABLE1_MAX_PASSES * every if count is None else count + every


@pytest.mark.parametrize("task,lam,method,count", CASES)
def test_iterations_to_eps_match_jax(task, lam, method, count):
    every, hp = cs.TABLE1_RUNS[method]
    steps = _stop(method, count)
    res = JS.solve(_jax_problem(task, lam), method, steps=steps, record_every=every, **hp)
    assert cs.iters_to_eps(res.dist2, every) == count
    port = _port_problem(task, lam)
    np.testing.assert_allclose(port.z_star, _jax_problem(task, lam).z_star, rtol=0, atol=1e-12)
    got, launches, ran = cs.table1_count(port, method, torch.device("cpu"), steps)
    assert ran == steps
    assert got == count
    assert not any(launches.values())  # the CPU runs the plain versions

