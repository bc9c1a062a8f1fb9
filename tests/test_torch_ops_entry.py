"""The registry's public entry points and ``resolve_mode`` against the JAX
package's (``repro.kernels.ops``), and the dry run's meta route.

Each entry point runs under ``mode="off"`` (and "auto", the plain version
on the CPU) on seeded numpy inputs, beside the JAX wrapper under
``use_pallas="off"``, within the port registry's own ``Tolerance`` for the
dtype (gradients within its ``grad_tolerance``). Torch runs on one thread
per test (tests/test_torch_ssm.py says why).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro_torch.kernels import ops


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _close(name, got, want, grad=False):
    dtype = got.dtype
    spec = ops.get_kernel(name)
    tol = spec.grad_tolerance(dtype) if grad else spec.tolerance(dtype)
    return ops.assert_close(got, _t(want).to(got.dtype), tol)


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("device", ["cpu", "cuda", "meta"])
def test_resolve_mode_is_the_references_table(mode, device):
    """On the CPU the reference names ``ref`` or ``pallas`` (``cuda`` here);
    auto takes the kernel wherever the device is not the CPU."""
    want = {"pallas": "cuda", "ref": "ref"}[JOPS.resolve_mode(mode)]
    if device != "cpu" and mode == "auto":
        want = "cuda"
    assert ops.resolve_mode(mode, device) == want


def test_resolve_mode_refuses_interpret_and_unknowns():
    assert JOPS.resolve_mode("interpret") == "interpret"
    with pytest.raises(ValueError, match="no interpreter"):
        ops.resolve_mode("interpret", "cpu")
    with pytest.raises(ValueError, match="not in"):
        ops.resolve_mode("pallas", "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.resolve_mode("auto", "mps")


def _attention_inputs(dtype, seed=0, b=2, hq=4, hkv=2, s=37, d=32):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal(shape).astype(np.float32)
                   for shape in ((b, hq, s, d), (b, hkv, s, d), (b, hkv, s, d), (b, hq, s, d)))
    if dtype == "bfloat16":
        q, k, v, do = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                       for a in (q, k, v, do))
    return q, k, v, do


@pytest.mark.parametrize("mode", ["off", "auto"])
@pytest.mark.parametrize("kw", [dict(causal=True), dict(causal=False),
                                dict(causal=True, window=8, softcap=20.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_entry_and_gradients(mode, kw, dtype):
    q, k, v, do = _attention_inputs(dtype)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(a, jd) for a in (q, k, v, do))
    want, vjp = jax.vjp(lambda a, b, c: JOPS.flash_attention(a, b, c, use_pallas="off", **kw),
                        jq, jk, jv)
    want_grads = vjp(jdo)
    leaves = [_t(a).to(td).requires_grad_() for a in (q, k, v)]
    got = ops.flash_attention(*leaves, mode=mode, **kw)
    _close("flash_attention", got.detach(), want.astype(jnp.float32))
    grads = torch.autograd.grad(got, leaves, _t(do).to(td))
    for g, w in zip(grads, want_grads):
        _close("flash_attention", g, w.astype(jnp.float32), grad=True)


def _decode_inputs(seed=0, b=3, hq=4, hkv=2, d=32, bs=8, n_pages=4):
    rng = np.random.default_rng(seed)
    n_blocks = b * n_pages + 1
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp = rng.standard_normal((n_blocks, bs, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((n_blocks, bs, hkv, d)).astype(np.float32)
    table = (1 + rng.permutation(b * n_pages)).reshape(b, n_pages).astype(np.int32)
    lengths = np.array([1, 17, 32], np.int32)
    return q, kp, vp, table, lengths


@pytest.mark.parametrize("mode", ["off", "auto"])
@pytest.mark.parametrize("kw", [dict(), dict(window=5, softcap=10.0)])
def test_decode_attention_entry(mode, kw):
    args = _decode_inputs()
    want = JOPS.decode_attention(*map(jnp.asarray, args), use_pallas="off", **kw)
    got = ops.decode_attention(*map(_t, args), mode=mode, **kw)
    _close("decode_attention", got, want)


def _sparse_inputs(dtype, seed=0, n=4, d=300, k=9):
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((n, d)).astype(dtype)
    idx = np.stack([rng.choice(d, k, replace=False) for _ in range(n)]).astype(np.int32)
    val = rng.standard_normal((n, k)).astype(dtype)
    idx[:, -2:], val[:, -2:] = 0, 0.0  # padding
    coef = rng.standard_normal(n).astype(dtype)
    rho = rng.uniform(0.5, 1.5, n).astype(dtype)
    return psi, idx, val, coef, rho


@pytest.mark.parametrize("mode", ["off", "auto"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_saga_sparse_entries(mode, dtype):
    """saga_sparse_dot and saga_sparse_axpy (rho = 1: the relay's call,
    where the f64 bar is bit-exact); compute_dtype and node_block are
    accepted and change nothing."""
    psi, idx, val, coef, rho = _sparse_inputs(dtype)
    rho = np.ones_like(rho)
    want = JOPS.saga_sparse_dot(*map(jnp.asarray, (psi, idx, val)), use_pallas="off")
    _close("sparse_dot", ops.saga_sparse_dot(*map(_t, (psi, idx, val)), mode=mode), want)
    args = (psi, idx, val, coef, rho)
    want = JOPS.saga_sparse_axpy(*map(jnp.asarray, args), use_pallas="off")
    got = ops.saga_sparse_axpy(*map(_t, args), mode=mode)
    _close("sparse_axpy", got, want)
    same = ops.saga_sparse_axpy(*map(_t, args), mode=mode, compute_dtype=torch.float32,
                                node_block=4)
    assert torch.equal(got, same)


@pytest.mark.parametrize("mode", ["off", "auto"])
def test_ssd_chunk_entry_and_gradients(mode):
    rng = np.random.default_rng(3)
    B, nc, Q, nh, hd, ds = 1, 2, 16, 3, 8, 4
    xdt = rng.standard_normal((B, nc, Q, nh, hd)).astype(np.float32) * 0.5
    cum = np.cumsum(-rng.uniform(0.01, 0.2, (B, nc, Q, nh)), axis=2).astype(np.float32)
    Bc, Cc = (rng.standard_normal((B, nc, Q, ds)).astype(np.float32) * 0.5 for _ in range(2))
    dy = rng.standard_normal((B, nc, Q, nh, hd)).astype(np.float32)
    dst = rng.standard_normal((B, nc, nh, ds, hd)).astype(np.float32)
    args = (xdt, cum, Bc, Cc)
    want, vjp = jax.vjp(lambda *a: JOPS.ssd_chunk(*a, use_pallas="off"),
                        *map(jnp.asarray, args))
    want_grads = vjp((jnp.asarray(dy), jnp.asarray(dst)))
    leaves = [_t(a).requires_grad_() for a in args]
    got = ops.ssd_chunk(*leaves, mode=mode)
    for g, w in zip(got, want):
        _close("ssd_chunk", g.detach(), w)
    grads = torch.autograd.grad(got, leaves, (_t(dy), _t(dst)))
    for g, w in zip(grads, want_grads):
        _close("ssd_chunk", g, w, grad=True)


@pytest.mark.parametrize("mode", ["off", "auto"])
def test_topk_blocks_entry(mode):
    x = np.random.default_rng(4).standard_normal((5, 64)).astype(np.float32)
    want = JOPS.topk_blocks(jnp.asarray(x), 7, use_pallas="off")
    got = ops.topk_blocks(_t(x), 7, mode=mode)
    spec = ops.get_kernel("block_topk")
    spec.compare((_t(x), 7), got, tuple(map(_t, want)), spec.tolerance(torch.float32))


def _meta(*arrays):
    return [torch.empty(a.shape, dtype=_t(a).dtype, device="meta") for a in arrays]


def _meta_cases():
    q, k, v, do = _attention_inputs("float32")
    s = _sparse_inputs(np.float64)
    rng = np.random.default_rng(5)
    x5 = rng.standard_normal((1, 2, 16, 3, 8)).astype(np.float32)
    cum = rng.standard_normal((1, 2, 16, 3)).astype(np.float32)
    bc = rng.standard_normal((1, 2, 16, 4)).astype(np.float32)
    st = rng.standard_normal((1, 2, 3, 4, 8)).astype(np.float32)
    lse = rng.standard_normal(q.shape[:3]).astype(np.float32)
    return {
        "sparse_dot": s[:3], "sparse_axpy": s,
        "flash_attention": (q, k, v), "flash_attention_bwd": (q, k, v, q, lse, do),
        "decode_attention": _decode_inputs(),
        "block_topk": (rng.standard_normal((5, 64)).astype(np.float32),),
        "ssd_chunk": (x5, cum, bc, bc), "ssd_chunk_bwd": (x5, cum, bc, bc, x5, st),
    }


@pytest.mark.parametrize("name", sorted(_meta_cases()))
def test_meta_route_gives_the_plain_shapes_and_reports_the_cost(name):
    """On meta tensors dispatch answers with the spec's meta (the plain
    version's shapes and dtypes) and reports the spec's cost once; "off"
    runs the plain version on them and reports nothing."""
    arrays = _meta_cases()[name]
    extra = (7,) if name == "block_topk" else ()
    want = ops.get_kernel(name).ref(*map(_t, arrays), *extra)
    seen = []
    with ops.kernel_costs(lambda *a: seen.append(a)):
        got = ops.dispatch(name, *_meta(*arrays), *extra)
        ops.dispatch(name, *_meta(*arrays), *extra, mode="off")
    pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
    for g, w in pairs:
        assert g.is_meta and g.shape == w.shape and g.dtype == w.dtype
    cost = ops.get_kernel(name).cost(*map(_t, arrays), *extra)
    assert len(seen) == 1 and seen[0][0] == name
    if name not in ("sparse_dot", "decode_attention"):  # data-dependent: all entries on meta
        assert seen[0][1:] == cost


def test_meta_route_keeps_the_kernels_differentiable():
    """A meta flash forward with grad reaches flash_attention_bwd through
    the registry, as the card's FlashAttention does; a kernel wrapper
    itself still refuses a meta tensor."""
    q, k, v, _ = _attention_inputs("float32")
    leaves = [t.requires_grad_() for t in _meta(q, k, v)]
    seen = []
    with ops.kernel_costs(lambda *a: seen.append(a[0])):
        o = ops.flash_attention(*leaves)
        o.sum().backward()
    assert seen == ["flash_attention", "flash_attention_bwd"]
    assert all(t.grad.is_meta and t.grad.shape == t.shape for t in leaves)
    with pytest.raises(ValueError, match="unsupported device meta"):
        ops.get_kernel("flash_attention").kernel(*_meta(q, k, v))
