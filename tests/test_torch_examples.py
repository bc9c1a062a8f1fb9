"""The port's examples (``repro_torch.examples``) against the JAX package's
(``examples/*.py``, loaded by file path), at tests/test_examples.py's
sizes, on the CPU.

The solver examples' numbers (dist2, consensus, the AUC scores and the
DOUBLE counts) are held to the JAX example's with the same arguments
within the port's float64 trajectory bar, 1e-12 relative. serve_decode
draws its weights from torch.Generator (other numbers than jax.random), so
each family gets a smoke test of its printed lines.
"""
import importlib.util
import pathlib

import numpy as np
import pytest

from repro.core import reference as JREF
from repro_torch.core import reference, solvers
from repro_torch.examples import auc_maximization, decentralized_ridge, quickstart, serve_decode

ROOT = pathlib.Path(__file__).resolve().parent.parent
REL = 1e-12


def _jax_example(name):
    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want) / np.maximum(np.abs(want), 1e-300)))


def _same_run(got, want):
    np.testing.assert_array_equal(got.iters, want.iters)
    assert _rel(got.dist2, want.dist2) <= REL
    assert _rel(got.consensus, want.consensus) <= REL
    np.testing.assert_array_equal(got.doubles_received, want.doubles_received)


def test_quickstart_matches_jax(capsys):
    want = _jax_example("quickstart").main(steps=300, record_every=100)
    capsys.readouterr()
    got = quickstart.main(steps=300, record_every=100, device="cpu")
    out = capsys.readouterr().out
    assert "consensus" in out and "linear convergence to the centralized optimum" in out
    assert len(got.iters) == 3 and got.dist2[-1] < got.dist2[0]
    _same_run(got, want)


def _communication(out: str) -> list[str]:
    return out[out.index("communication per effective pass"):].splitlines()


def test_decentralized_ridge_matches_jax(capsys):
    argv = ["--passes", "2", "--q", "8", "--d", "64"]
    want = _jax_example("decentralized_ridge").main(argv)
    want_out = capsys.readouterr().out
    got = decentralized_ridge.main(argv, device="cpu")
    out = capsys.readouterr().out
    assert set(got) == {"DSBA", "DSA", "EXTRA", "DLM", "SSDA"}
    for m, (xs, dist2) in got.items():
        assert len(dist2) == 2 and all(d > 0 for d in dist2)
        np.testing.assert_array_equal(xs, want[m][0])
        assert _rel(dist2, want[m][1]) <= REL, m
    # the DOUBLE counts (dense, dense stochastic, relay) line by line
    assert _communication(out) == _communication(want_out)


def test_decentralized_ridge_wide_ssda_matches_jax(capsys, monkeypatch):
    """With the d x d factors over SSDA_DENSE_BYTES (rcv1 on the card),
    SSDA's ridge map takes the q x q Woodbury factor: the same numbers."""
    argv = ["--passes", "3", "--q", "8", "--d", "64"]
    want = _jax_example("decentralized_ridge").main(argv)
    solvers.clear_runner_caches()
    monkeypatch.setattr(solvers, "SSDA_DENSE_BYTES", 0)
    got = decentralized_ridge.main(argv, device="cpu")
    solvers.clear_runner_caches()
    capsys.readouterr()
    assert _rel(got["SSDA"][1], want["SSDA"][1]) <= REL


def test_decentralized_ridge_flag_and_keyword_device(capsys):
    """--device is the flag of the keyword; the keyword wins."""
    argv = ["--passes", "1", "--q", "4", "--d", "16"]
    a = decentralized_ridge.main([*argv, "--device", "cpu"])
    b = decentralized_ridge.main([*argv, "--device", "meta"], device="cpu")
    capsys.readouterr()
    for m in a:
        np.testing.assert_array_equal(a[m][1], b[m][1])


def test_auc_maximization_matches_jax(capsys):
    want = _jax_example("auc_maximization").main(passes=2, record_passes=1)
    want_out = capsys.readouterr().out
    got = auc_maximization.main(passes=2, record_passes=1, device="cpu")
    out = capsys.readouterr().out
    assert "AUC at the exact saddle point" in out
    assert got.zs is not None and len(got.iters) == 2
    _same_run(got, want)
    assert _rel(got.zs, want.zs) <= 1e-10  # iterates: absolute scale ~1
    data = auc_maximization.make_classification(10, 50, 300, k=10, positive_ratio=0.25,
                                                seed=0)
    for zg, zw in zip(got.zs, want.zs):
        auc_g = [reference.auc_score(w[:300], data) for w in zg]
        auc_w = [JREF.auc_score(w[:300], data) for w in zw]
        assert _rel(auc_g, auc_w) <= REL
    assert out.splitlines()[-1] == want_out.splitlines()[-1]


@pytest.mark.parametrize("arch", ["minitron-8b", "qwen2-moe-a2.7b", "mamba2-1.3b",
                                  "zamba2-1.2b", "whisper-small"])
def test_serve_decode_runs_each_family(arch, capsys):
    serve_decode.main(["--arch", arch, "--batch", "2", "--prompt-len", "8", "--tokens", "3"],
                      device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"arch={arch} batch=2 prompt=8 new_tokens=3"
    assert out[1].startswith("prefill: ") and out[2].startswith("decode : ")
    assert [line.split(":")[0] for line in out[3:]] == ["  sample[0] generated ids",
                                                        "  sample[1] generated ids"]
