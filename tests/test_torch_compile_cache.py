"""The port's persistent kernel build cache (``repro_torch.launch.compile_cache``):
placement, environment precedence and idempotence, as
tests/test_compile_cache.py holds the JAX package's. There is no nvcc
here: that a second process builds nothing is checked on the card
(``chip_smoke.py --launch``)."""
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.kernels import _build
from repro_torch.launch import compile_cache as CC

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def fresh(monkeypatch):
    """A cache module with nothing enabled and no cache variable set."""
    monkeypatch.setattr(CC, "_ENABLED", None)
    monkeypatch.setattr(CC, "_FRESH", None)
    monkeypatch.delenv("REPRO_COMPILE_CACHE_DIR", raising=False)
    monkeypatch.delenv("REPRO_NO_COMPILE_CACHE", raising=False)
    return monkeypatch


def test_default_is_the_packages_ignored_build_dir(fresh):
    want = REPO / "src" / "repro_torch" / "kernels" / "build"
    assert CC.default_cache_dir() == want
    assert CC.enabled_dir() is None
    assert CC.enable_persistent_cache() == str(want)
    assert CC.enabled_dir() == str(want) and _build.build_dir() == want
    assert "src/repro_torch/kernels/build/" in (REPO / ".gitignore").read_text().split()


def test_env_dir_overrides_and_libraries_land_there(fresh, tmp_path):
    fresh.setenv("REPRO_COMPILE_CACHE_DIR", str(tmp_path))
    assert CC.enable_persistent_cache() == str(tmp_path)
    assert _build.BUILD_DIR == tmp_path
    lib = _build._library_path("sparse_saga")
    assert lib.parent == tmp_path and lib.name.startswith("libsparse_saga_")


def test_no_cache_wins_and_builds_into_a_fresh_process_dir(fresh, tmp_path):
    fresh.setenv("REPRO_COMPILE_CACHE_DIR", str(tmp_path))
    fresh.setenv("REPRO_NO_COMPILE_CACHE", "1")
    assert CC.enable_persistent_cache() is None and CC.enabled_dir() is None
    d = CC.build_dir()
    assert d.is_dir() and d != tmp_path and d.name.startswith("repro_torch_build_")
    assert CC.build_dir() == d  # one directory for the process


def test_enabling_is_idempotent(fresh, tmp_path):
    first = CC.enable_persistent_cache()
    fresh.setenv("REPRO_COMPILE_CACHE_DIR", str(tmp_path))
    assert CC.enable_persistent_cache() == first == CC.enabled_dir()
    assert _build.build_dir() == pathlib.Path(first)


def test_no_cache_dir_is_removed_at_exit(tmp_path):
    env = dict(os.environ, REPRO_NO_COMPILE_CACHE="1", TMPDIR=str(tmp_path),
               PYTHONPATH=str(REPO / "src"))
    code = ("from repro_torch.launch import compile_cache as C; "
            "d = C.build_dir(); (d / 'x').write_text('1'); print(d)")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True).stdout.strip()
    assert pathlib.Path(out).parent == tmp_path and not pathlib.Path(out).exists()


def test_importing_builds_nothing(tmp_path):
    env = dict(os.environ, REPRO_COMPILE_CACHE_DIR=str(tmp_path / "cache"),
               PYTHONPATH=str(REPO / "src"))
    code = "import repro_torch.kernels.ops, repro_torch.launch.compile_cache as C; print(C.enabled_dir())"
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120, check=True).stdout.strip()
    assert out == "None" and not (tmp_path / "cache").exists()
