"""The port's numpy-only copies equal the JAX package's, byte for byte.

``repro_torch.data.synthetic``, ``configs.dsba_paper`` and ``core.mixing``
are copies (the port must not import ``repro``); the same seed must give
identical arrays, graphs and mixing matrices.
"""
import dataclasses

import numpy as np
import pytest

from repro.configs import dsba_paper as JC
from repro.core import mixing as JM
from repro.core.solvers import graph_from_mixing as j_graph_from_mixing
from repro.data import synthetic as JS
from repro_torch.configs import dsba_paper as TC
from repro_torch.core import mixing as TM
from repro_torch.core.solvers import graph_from_mixing
from repro_torch.data import synthetic as TS


def _same_dataset(a, b):
    assert a.d == b.d
    for name in ("idx", "val", "y"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.tobytes() == y.tobytes(), name


def test_presets_and_experiments_match():
    assert TS.DATASET_PRESETS == JS.DATASET_PRESETS
    assert TC.EXPERIMENTS.keys() == JC.EXPERIMENTS.keys()
    for key, exp in JC.EXPERIMENTS.items():
        assert dataclasses.asdict(TC.EXPERIMENTS[key]) == dataclasses.asdict(exp)


@pytest.mark.parametrize("maker,kw", [
    ("make_regression", dict(n_nodes=4, q=6, d=64, k=8, seed=3)),
    ("make_classification", dict(n_nodes=5, q=7, d=64, k=8, seed=1)),
    ("make_classification", dict(n_nodes=4, q=9, d=50, k=5, positive_ratio=0.3,
                                 seed=2, dtype=np.float32)),
])
def test_datasets_byte_identical(maker, kw):
    _same_dataset(getattr(TS, maker)(**kw), getattr(JS, maker)(**kw))


def test_noniid_regression_byte_identical():
    (a, wa), (b, wb) = (m.make_noniid_regression(4, 6, 64, 8, seed=5)
                        for m in (TS, JS))
    _same_dataset(a, b)
    assert wa.tobytes() == wb.tobytes()


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_from_preset_byte_identical(task):
    _same_dataset(TS.from_preset("tiny", task, n_nodes=4, q=5, seed=9),
                  JS.from_preset("tiny", task, n_nodes=4, q=5, seed=9))


@pytest.mark.parametrize("name,args", [
    ("ring_graph", (6,)),
    ("erdos_renyi_graph", (10, 0.4, 0)),
    ("torus_graph", (2, 3)),
    ("complete_graph", (5,)),
    ("exponential_graph", (8,)),
])
def test_graphs_and_mixing_identical(name, args):
    gt, gj = getattr(TM, name)(*args), getattr(JM, name)(*args)
    assert gt.n == gj.n and gt.edges == gj.edges
    assert gt.diameter == gj.diameter
    for fn in ("laplacian_mixing", "metropolis_mixing"):
        wt_, wj = getattr(TM, fn)(gt), getattr(JM, fn)(gj)
        assert wt_.tobytes() == wj.tobytes(), fn
    w = JM.laplacian_mixing(gj)
    assert TM.w_tilde(w).tobytes() == JM.w_tilde(w).tobytes()
    assert TM.spectral_gap(w) == JM.spectral_gap(w)
    assert graph_from_mixing(w).edges == j_graph_from_mixing(w).edges
    assert set(graph_from_mixing(w).edges) == set(gj.edges)
