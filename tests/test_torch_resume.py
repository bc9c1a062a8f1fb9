"""Checkpoint/resume in ``repro_torch``'s ``solve()`` against ``repro``'s.

At the JAX tests' size (``tests/test_faults.py``: ring of 8, q=12, d=6,
k=3, lam 1e-2), from numpy seeds: a run stopped at step 40 and resumed to
60 is bit-equal to the uninterrupted run (dsba and dsa, dense and relay;
every other dense method too) and within 1e-12 of the JAX package's;
resume of a finished run; the resume errors with the reference's text;
checkpoint leaf paths named as JAX names them (dataclass fields, tuple
items, the relay's ``{"carry", "zs", "nnzs"}`` layout); and checkpoints
crossing packages both ways: a dense dsba checkpoint written by the JAX
package's ``solve()`` at step 20 resumed by the port holds the
uninterrupted JAX run within 1e-12, and the JAX package resumes the
port's.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as JC
from repro.core import mixing as JM
from repro.core import solvers as JS
from repro.core.dsba import DSBAState as JState
from repro.data.synthetic import make_regression
from repro_torch.ckpt import checkpoint as TC
from repro_torch.core import mixing as TM
from repro_torch.core import solvers as TS
from repro_torch.core.dsba import DSBAState as TState

TOL = 1e-12
N, Q, D, K = 8, 12, 6, 3
KW = dict(record_every=10, seed=3)


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


def _tsolve(method, comm="dense", **kw):
    return TS.solve(_problems()[1], method, comm=comm, device="cpu", **KW, **kw)


def _bit_equal(a, b):
    for name in ("z", "dist2", "consensus", "iters", "doubles_received", "ints_received"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


@pytest.mark.parametrize("method", ["dsba", "dsa"])
@pytest.mark.parametrize("comm", ["dense", "sparse"])
def test_resume_bit_equal(tmp_path, method, comm):
    """Stopped at 40 of 60, resumed from the newest committed checkpoint:
    bit-equal to the uninterrupted run, and within 1e-12 of JAX's."""
    full = _tsolve(method, comm, steps=60)
    ck = tmp_path / "ck"
    _tsolve(method, comm, steps=40, checkpoint=TS.CheckpointSpec(ck, every=20))
    assert TC.committed_steps(ck) == [20, 40]
    res = _tsolve(method, comm, steps=60, resume=str(ck))
    _bit_equal(full, res)
    want = JS.solve(_problems()[0], method, comm=comm, steps=60, **KW)
    for name in ("z", "dist2", "consensus"):
        np.testing.assert_allclose(getattr(res, name), np.asarray(getattr(want, name)),
                                   rtol=0, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(res.doubles_received, want.doubles_received)


@pytest.mark.parametrize("method", ["extra", "dlm", "ssda", "mudag", "sliding", "personal"])
def test_resume_bit_equal_other_methods(tmp_path, method):
    """Every dense method's state (tuples with host step counters) resumes
    bit-equal."""
    hp = {"eta": 1e-2} if method == "ssda" else {}
    full = _tsolve(method, steps=60, **hp)
    _tsolve(method, steps=40, checkpoint=TS.CheckpointSpec(tmp_path, every=20), **hp)
    _bit_equal(full, _tsolve(method, steps=60, resume=str(tmp_path), **hp))


@pytest.mark.parametrize("comm", ["dense", "sparse"])
def test_resume_at_completed_run(tmp_path, comm):
    """A checkpoint at the final step: nothing more runs, the result is whole."""
    full = _tsolve("dsba", comm, steps=40)
    _tsolve("dsba", comm, steps=40, checkpoint=TS.CheckpointSpec(tmp_path, every=20))
    _bit_equal(full, _tsolve("dsba", comm, steps=40, resume=str(tmp_path)))


def test_sparse_checkpoint_every_off_the_record_grid(tmp_path):
    """The relay checkpoints at any period (its log holds every step)."""
    full = _tsolve("dsba", "sparse", steps=45)
    _tsolve("dsba", "sparse", steps=35, checkpoint=TS.CheckpointSpec(tmp_path, every=7,
                                                                       keep_last=2))
    assert TC.committed_steps(tmp_path) == [28, 35]
    _bit_equal(full, _tsolve("dsba", "sparse", steps=45, resume=str(tmp_path)))


def _resume_errors(S, p, d):
    """Resume calls that must raise, against checkpoints written in ``d``."""
    def run(method="dsba", comm="dense", steps=60, where=d / "dense"):
        return S.solve(p, method, comm=comm, steps=steps, resume=str(where), **KW)

    return [
        lambda: run(method="dsa"),
        lambda: run(comm="sparse"),
        lambda: run(steps=30),
        lambda: run(where=d / "empty"),
        lambda: run(comm="sparse", where=d / "sparse", method="dsa"),
        lambda: run(comm="sparse", where=d / "sparse", steps=10),
        lambda: S.solve(p, "dsba", steps=60, record_every=20, seed=3,
                        resume=str(d / "dense")),
    ]


@pytest.mark.parametrize("case", range(7))
def test_resume_errors_match_jax(tmp_path, case):
    jp, tp = _problems()
    for comm in ("dense", "sparse"):
        JS.solve(jp, "dsba", comm=comm, steps=40,
                 checkpoint=JS.CheckpointSpec(tmp_path / comm, every=20), **KW)
    msgs = []
    for S, p in ((JS, jp), (_CpuSolve, tp)):
        with pytest.raises(ValueError) as ei:
            _resume_errors(S, p, tmp_path)[case]()
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


class _CpuSolve:
    """``TS`` with ``device="cpu"`` on every ``solve`` call."""

    @staticmethod
    def solve(*args, **kw):
        return TS.solve(*args, device="cpu", **kw)


def test_checkpoint_spec_validation():
    for C in (JC.CheckpointSpec, TC.CheckpointSpec):
        with pytest.raises(ValueError, match="must be >= 1"):
            C("/tmp", every=0)
    assert dataclasses.astuple(TC.CheckpointSpec("d", 5, 2)) == ("d", 5, 2)


# ---------------------------------------------------------------------------
# leaf paths and checkpoints across packages
# ---------------------------------------------------------------------------


def _trees():
    """The same tree in both packages: dicts, a DSBAState, tuples, a list,
    None and a host int."""
    rng = np.random.default_rng(0)
    arrs = {f.name: rng.standard_normal((2, 3)) for f in dataclasses.fields(TState)}
    import jax.numpy as jnp

    jst = JState(**{k: jnp.asarray(v) for k, v in arrs.items()})
    tst = TState(**{k: torch.as_tensor(v) for k, v in arrs.items()})
    return ({"carry": (jst, jnp.ones(2), (jnp.zeros(1), None, 3)), "zs": np.zeros(3), "b": [1, 2]},
            {"carry": (tst, torch.ones(2), (torch.zeros(1), None, 3)), "zs": np.zeros(3),
             "b": [1, 2]})


def test_paths_named_as_jax_names_them():
    jt, tt = _trees()
    assert TC._flatten_with_paths(tt)[0] == JC._flatten_with_paths(jt)[0]


def test_tree_round_trips_both_ways(tmp_path):
    """A tree saved by either package restores in the other, leaf for leaf."""
    jt, tt = _trees()
    JC.save_checkpoint(tmp_path / "j", 1, jt)
    TC.save_checkpoint(tmp_path / "t", 1, tt)
    got, _ = TC.restore_checkpoint(tmp_path / "j", tt)
    assert isinstance(got["carry"][0], TState) and got["carry"][2][1] is None
    assert got["carry"][2][2] == 3 and isinstance(got["carry"][2][2], int)
    back, _ = JC.restore_checkpoint(tmp_path / "t", jt)
    for p, a, b in zip(TC._flatten_with_paths(got)[0], TC._flatten_with_paths(got)[1],
                       JC._flatten_with_paths(back)[1]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=p)


@pytest.mark.parametrize("comm", ["dense", "sparse"])
def test_checkpoint_layout_matches_jax(tmp_path, comm):
    """A port checkpoint holds the JAX one's leaf paths, shapes and dtypes,
    and the same metadata keys."""
    jp, tp = _problems()
    JS.solve(jp, "dsba", comm=comm, steps=20, checkpoint=JS.CheckpointSpec(tmp_path / "j", 20),
             **KW)
    TS.solve(tp, "dsba", comm=comm, steps=20, checkpoint=TS.CheckpointSpec(tmp_path / "t", 20),
             device="cpu", **KW)
    _, jm, jl = JC.load_checkpoint(tmp_path / "j")
    _, tm, tl = TC.load_checkpoint(tmp_path / "t")
    assert sorted(tl) == sorted(jl)
    assert sorted(tm) == sorted(jm) and tm["method"] == "dsba"
    for p in jl:
        assert tl[p].shape == jl[p].shape, p
        if p.endswith((".didx_prev", ".step")) or p == "['nnzs']":
            continue  # the port keeps index tensors in int64
        assert tl[p].dtype == jl[p].dtype, p


@pytest.mark.parametrize("comm", ["dense", "sparse"])
def test_port_resumes_a_jax_checkpoint(tmp_path, comm):
    """The JAX package's solve() writes a dsba checkpoint at step 20; the
    port resumes it to 60 and holds the uninterrupted JAX run."""
    jp, tp = _problems()
    want = JS.solve(jp, "dsba", comm=comm, steps=60, **KW)
    JS.solve(jp, "dsba", comm=comm, steps=20, checkpoint=JS.CheckpointSpec(tmp_path, every=20),
             **KW)
    got = TS.solve(tp, "dsba", comm=comm, steps=60, resume=str(tmp_path), device="cpu", **KW)
    for name in ("z", "dist2", "consensus"):
        np.testing.assert_allclose(getattr(got, name), np.asarray(getattr(want, name)),
                                   rtol=0, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(got.doubles_received, want.doubles_received)
    np.testing.assert_array_equal(got.ints_received, want.ints_received)


@pytest.mark.parametrize("comm", ["dense", "sparse"])
def test_jax_resumes_a_port_checkpoint(tmp_path, comm):
    jp, tp = _problems()
    want = TS.solve(tp, "dsa", comm=comm, steps=60, device="cpu", **KW)
    TS.solve(tp, "dsa", comm=comm, steps=20, checkpoint=TS.CheckpointSpec(tmp_path, every=20),
             device="cpu", **KW)
    got = JS.solve(jp, "dsa", comm=comm, steps=60, resume=str(tmp_path), **KW)
    for name in ("z", "dist2", "consensus"):
        np.testing.assert_allclose(np.asarray(getattr(got, name)), getattr(want, name),
                                   rtol=0, atol=TOL, err_msg=name)
    np.testing.assert_array_equal(got.doubles_received, want.doubles_received)
