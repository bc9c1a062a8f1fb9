"""The port's sparse kernels: plain versions against the JAX package, registry
policy, and (on a card) the CUDA kernels against their plain versions.

Inputs come from numpy seeds and go to both packages. The JAX side runs the
Pallas kernels in interpret mode with ``compute_dtype`` set to the input
dtype, and the pure-jnp oracles of ``repro.kernels.ref``. Shapes have a
ragged D (not a multiple of the Pallas 512 block), padded entries
(idx 0, val 0) and, for sparse_axpy, duplicate indices.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.kernels import sparse_saga as JSS
from repro_torch.kernels import ops, sparse_saga
from repro_torch.kernels.ref import sparse_axpy_ref, sparse_dot_ref

SHAPES = [(4, 1000, 9), (3, 777, 16)]
DTYPES = [np.float32, np.float64]


def _inputs(n, d, k, dtype, seed, dups=False, rho_one=False):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((n, d)).astype(dtype)
    idx = np.stack([rng.choice(d, k, replace=False) for _ in range(n)]).astype(np.int32)
    val = rng.standard_normal((n, k)).astype(dtype)
    if dups:
        idx[:, 1] = idx[:, 0]
        idx[:, k // 2] = idx[:, 0]
    idx[:, -2:] = 0  # padding
    val[:, -2:] = 0.0
    coef = rng.standard_normal(n).astype(dtype)
    rho = np.ones(n, dtype) if rho_one else rng.uniform(0.5, 1.5, n).astype(dtype)
    return psi, idx, val, coef, rho


def _torch(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _tol(name, dtype):
    return ops.get_kernel(name).tolerance(torch.float64 if dtype == np.float64
                                          else torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
def test_sparse_dot_plain_matches_jax(shape, dtype):
    psi, idx, val, _, _ = _inputs(*shape, dtype, seed=1)
    got = sparse_dot_ref(*_torch(psi, idx, val))
    tol = _tol("sparse_dot", dtype)
    for want in (
        JREF.sparse_dot_ref(psi, idx, val),
        JSS.sparse_dot(jnp.asarray(psi), jnp.asarray(idx), jnp.asarray(val),
                       interpret=True, compute_dtype=dtype),
    ):
        ops.assert_close(got, torch.as_tensor(np.array(want)), tol)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dups", [False, True])
def test_sparse_axpy_plain_matches_jax_oracle(shape, dtype, dups):
    """Bit-exact against the sequential-scatter jnp oracle, duplicates too."""
    args = _inputs(*shape, dtype, seed=2, dups=dups)
    got = sparse_axpy_ref(*_torch(*args))
    want = np.array(JREF.sparse_axpy_ref(*args))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("rho_one", [True, False])
def test_sparse_axpy_plain_matches_pallas_interpret(shape, dtype, rho_one):
    """Against the Pallas body (interpret mode, no duplicates: its one-hot
    product sums duplicates before scaling them).

    At the relay's rho = 1 the two are bit-equal. For a general rho the
    Pallas body may fuse rho*psi + coef*scat into one FMA, which the JAX
    registry itself allows as 1 ulp (ops.py:424-425); measured here:
    2.2e-16 in float64 and 4.8e-7 in float32, so that case is held to one
    ulp of the output's magnitude.
    """
    args = _inputs(*shape, dtype, seed=3, rho_one=rho_one)
    got = sparse_axpy_ref(*_torch(*args)).numpy()
    want = np.asarray(JSS.sparse_axpy(*(jnp.asarray(a) for a in args),
                                      interpret=True, compute_dtype=dtype))
    if rho_one:
        np.testing.assert_array_equal(got, want)
    else:
        ulp = np.spacing(np.abs(want).max()).astype(np.float64)
        assert np.abs(got.astype(np.float64) - want).max() <= ulp


@pytest.mark.parametrize("name", ["sparse_dot", "sparse_axpy"])
def test_registry_tolerances_equal_jax(name):
    ours, theirs = ops.get_kernel(name), JOPS.get_kernel(name)
    assert set(ours.tol) == set(theirs.tol)
    for key, tol in theirs.tol.items():
        assert (ours.tol[key].rtol, ours.tol[key].atol) == (tol.rtol, tol.atol)


def test_registry_modes_on_cpu():
    psi, idx, val, coef, rho = _torch(*_inputs(3, 50, 5, np.float64, seed=4))
    before = (sparse_saga.sparse_dot.launches, sparse_saga.sparse_axpy.launches)
    for mode in ("auto", "off"):
        torch.testing.assert_close(
            ops.dispatch("sparse_axpy", psi, idx, val, coef, rho, mode=mode),
            sparse_axpy_ref(psi, idx, val, coef, rho), rtol=0, atol=0)
        torch.testing.assert_close(
            ops.dispatch("sparse_dot", psi, idx, val, mode=mode),
            sparse_dot_ref(psi, idx, val), rtol=0, atol=0)
    # the plain path launches nothing
    assert (sparse_saga.sparse_dot.launches, sparse_saga.sparse_axpy.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.dispatch("sparse_dot", psi, idx, val, mode="on")
    with pytest.raises(ValueError, match="mode"):
        ops.dispatch("sparse_dot", psi, idx, val, mode="interpret")
    assert ops.registered_kernels() == (
        "block_topk", "decode_attention", "flash_attention", "flash_attention_bwd",
        "sparse_axpy", "sparse_dot", "ssd_chunk", "ssd_chunk_bwd")


def test_wrapper_input_checks():
    psi, idx, val, coef, rho = _torch(*_inputs(3, 50, 5, np.float64, seed=5))
    check = sparse_saga._check_inputs
    assert check(psi, idx, val, (("coef", coef), ("rho", rho))) == (3, 50, 5)
    with pytest.raises(TypeError, match="int32"):
        check(psi, idx.long(), val)
    with pytest.raises(TypeError, match="float32 or float64"):
        check(psi.half(), idx, val)
    with pytest.raises(TypeError, match="val"):
        check(psi, idx, val.float())
    with pytest.raises(ValueError, match="contiguous"):
        check(psi.t().contiguous().t(), idx, val)
    with pytest.raises(ValueError, match=r"\(N, k\)"):
        check(psi, idx[:2], val[:2])
    with pytest.raises(ValueError, match="rho"):
        check(psi, idx, val, (("rho", rho[:2]),))
