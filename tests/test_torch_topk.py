"""The block_topk selection and the gossip compression helpers against the
JAX package.

The plain version (``kernels.ref.block_topk_ref``) must equal the JAX
oracle (``repro.kernels.ref.block_topk_ref``, ``jax.lax.top_k``) and the
Pallas body in interpret mode EXACTLY, values and order: both take the
lower index first among equal magnitudes, and the CUDA kernel is held
bit-equal to the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py). Ties are common on the gossip path (every norm-scale leaf
is 1.0 at step 0), so the inputs include rows with many ties, constant
rows and rows of zeros. Rows of the 'nan' kind hold NaNs of several
payloads and both signs, +-inf and +-0: the plain version ranks every NaN
equal, above +inf, in index order, as the Pallas body's first-occurrence
argmax does; ``jax.lax.top_k`` orders NaNs by their bits, so the oracle is
held exactly everywhere but in the order among the NaNs. The compression helpers (``topk_compress``,
``block_topk_compress``, ``scatter_decompress``, ``leaf_k``) and the
circulant mixing weights equal JAX exactly as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gossip as JG
from repro.kernels import ref as JR
from repro.kernels.topk_compress import block_topk as pallas_block_topk
from repro_torch.core import gossip as G
from repro_torch.kernels import ops, topk_compress
from repro_torch.kernels.ref import block_topk_ref

# (block, k): the gossip step's blocks (4096 with k_b 40; gemma2-2b's
# final_norm 2304 with 23; the reduced configs' 64 and 16 with 1), k = block
SHAPES = [(4096, 40), (2304, 23), (64, 1), (16, 16), (4096, 4096)]
KINDS = ["random", "ties", "constant", "zeros"]
# NaNs of several payloads and both signs, +-inf, +-0 (uint32 bits)
SPECIALS = np.array([0x7FC00000, 0x7FC00005, 0xFFC00003, 0x7F800001, 0xFF812345, 0x7F800000,
                     0xFF800000, 0x80000000, 0x00000000], np.uint32)


def rows(nb, block, kind, seed=0):
    """float32 (nb, block) rows of one kind; 'ties' rounds to a few values;
    'nan' puts block // 100 (at least 2: a NaN and +inf) ``SPECIALS`` into
    normal rows."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((nb, block)).astype(np.float32)
    if kind == "ties":
        x = (np.round(x * 2) / 2).astype(np.float32)  # |x| in {0, 0.5, 1, ...}
    elif kind == "constant":
        x = np.full((nb, block), 1.0, np.float32)
        x[1::2] = -0.25  # odd rows: another constant, negative
    elif kind == "zeros":
        x = np.zeros((nb, block), np.float32)
    elif kind == "nan":
        m = max(2, block // 100)
        for r in range(nb):
            put = rng.choice(SPECIALS, m)
            put[:2] = (0xFFC00003, 0x7F800000)  # every row: a NaN and +inf at least
            x[r].view(np.uint32)[rng.choice(block, m, replace=False)] = put
    return x


def bits(a) -> np.ndarray:
    """float32 values as their uint32 bits (NaN payloads compared too)."""
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("block,k", SHAPES)
def test_plain_equals_jax_oracle_exactly(block, k, kind):
    x = rows(3, block, kind)
    vals, idx = block_topk_ref(torch.as_tensor(x), k)
    jv, ji = JR.block_topk_ref(jnp.asarray(x), k)
    assert vals.dtype == torch.float32 and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("block,k", SHAPES)
def test_plain_nan_kind_against_jax_oracle(block, k):
    """NaNs, +-inf and +-0: the oracle exactly wherever it returns a number;
    where it returns NaNs (first, above +inf), the same NaN entries, which
    the plain version orders by index (``lax.top_k`` by their bits)."""
    x = rows(3, block, "nan", seed=7)
    vals, idx = block_topk_ref(torch.as_tensor(x), k)
    jv, ji = JR.block_topk_ref(jnp.asarray(x), k)
    vals, idx, jv, ji = vals.numpy(), idx.numpy(), np.asarray(jv), np.asarray(ji)
    nan = np.isnan(jv)
    np.testing.assert_array_equal(np.isnan(vals), nan)
    np.testing.assert_array_equal(idx[~nan], ji[~nan])
    np.testing.assert_array_equal(bits(vals[~nan]), bits(jv[~nan]))
    assert nan[:, 0].all()  # every row's top entry is a NaN
    for r in range(x.shape[0]):
        mine = idx[r][nan[r]]
        assert (np.diff(mine) > 0).all()  # NaNs in index order
        np.testing.assert_array_equal(mine, np.sort(ji[r][nan[r]]))
        np.testing.assert_array_equal(bits(vals[r][nan[r]]), bits(x[r][mine]))


@pytest.mark.parametrize("kind", ["random", "ties", "constant", "nan"])
@pytest.mark.parametrize("block,k", [(4096, 40), (2304, 23), (64, 1), (16, 16), (256, 256)])
def test_plain_equals_pallas_body_exactly(block, k, kind):
    """The TPU kernel's body in interpret mode: k rounds of first-occurrence
    argmax; NaNs (which argmax takes first, in index order), infinities and
    signed zeros included, values compared as bits. (k = block at 256
    rather than 4096: interpret mode runs the rounds one by one.)"""
    x = rows(2, block, kind, seed=1)
    vals, idx = block_topk_ref(torch.as_tensor(x), k)
    pv, pi = pallas_block_topk(jnp.asarray(x), k, interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(pi))
    np.testing.assert_array_equal(bits(vals.numpy()), bits(pv))


def test_plain_chunks_rows():
    """More rows than one sort chunk: the same as sorting row by row."""
    x = torch.as_tensor(rows(4500, 4096, "ties", seed=2))
    vals, idx = block_topk_ref(x, 5)
    for r in (0, 4095, 4096, 4499):
        want = torch.sort(x[r].abs(), descending=True, stable=True).indices[:5]
        assert torch.equal(idx[r].long(), want) and torch.equal(vals[r], x[r][want])


def test_topk_compare_accepts_and_rejects():
    """The ported _topk_compare: accepts the plain version against itself
    and a tie-reordered selection; rejects a wrong index."""
    x = torch.as_tensor(rows(4, 64, "random", seed=3))
    vals, idx = block_topk_ref(x, 5)
    spec = ops.get_kernel("block_topk")
    tol = spec.tolerance(torch.float32)
    assert tol == ops.Tolerance(1e-6, 1e-6)
    assert ops._topk_compare((x, 5), (vals, idx), (vals, idx), tol) == 0.0
    ties = torch.ones((2, 16))
    v2, i2 = block_topk_ref(ties, 3)
    flipped = (v2, (15 - i2).to(torch.int32))  # other tied entries, same set of magnitudes
    ops._topk_compare((ties, 3), flipped, (v2, i2), tol)
    wrong = idx.clone()
    wrong[1, 2] = (wrong[1, 2] + 1) % 64
    with pytest.raises(AssertionError, match="value, index"):
        ops._topk_compare((x, 5), (vals, wrong), (vals, idx), tol)
    bad_vals = vals.clone()
    bad_vals[0, 0] = 0.0
    with pytest.raises(AssertionError, match="magnitudes"):
        ops._topk_compare((x, 5), (bad_vals, idx), (vals, idx), tol)
    out = torch.full_like(idx, 64)
    with pytest.raises(AssertionError, match="outside"):
        ops._topk_compare((x, 5), (vals, out), (vals, idx), tol)


def test_wrapper_routes_and_checks():
    """On the CPU the wrapper is the plain version (no launch); mode 'on'
    needs a CUDA tensor; the kernel's input checks name what they refuse."""
    x = torch.as_tensor(rows(3, 64, "random"))
    n0 = topk_compress.block_topk.launches
    got = ops.topk_blocks(x, 4)
    want = block_topk_ref(x, 4)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert topk_compress.block_topk.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        ops.topk_blocks(x, 4, mode="on")
    chk = topk_compress._check_inputs
    assert chk(x, 4) == (3, 64)
    with pytest.raises(TypeError, match="float32"):
        chk(x.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        chk(torch.zeros(64, 3).T, 1)
    # any block: staged rows above 8192, streamed rows; k up to K_MAX
    assert chk(torch.zeros(1, 8193), 1) == (1, 8193)
    assert chk(torch.zeros(2, 65_536), 655) == (2, 65_536)
    assert chk(torch.zeros(1, 8192), 8192) == (1, 8192)
    assert chk(torch.zeros(1, topk_compress.K_MAX), topk_compress.K_MAX)[1] == topk_compress.K_MAX
    with pytest.raises(ValueError, match="K_MAX"):
        chk(torch.zeros(1, topk_compress.K_MAX + 1), topk_compress.K_MAX + 1)
    for k in (0, 65):
        with pytest.raises(ValueError, match="k="):
            chk(x, k)


# ---------------------------------------------------------------------------
# compression helpers and mixing weights against repro.core.gossip
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["random", "ties"])
def test_topk_compress_equals_jax(kind):
    x = rows(1, 3000, kind, seed=4).reshape(30, 100)
    for k in (1, 37, 3000):
        v, i = G.topk_compress(torch.as_tensor(x), k)
        jv, ji = JG.topk_compress(jnp.asarray(x), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))


@pytest.mark.parametrize("n,block,ratio", [(1000, 256, 0.05), (4608, 4096, 0.01),
                                           (2304, 4096, 0.01), (64, 4096, 0.01),
                                           (16, 4096, 0.01), (100, 16, 0.25)])
@pytest.mark.parametrize("kind", ["random", "ties"])
def test_block_topk_compress_equals_jax(n, block, ratio, kind):
    """Padded tails (n not a multiple of the block: value 0 at index 0) and
    leaves smaller than a block (block = n), as test_gossip.py:104."""
    x = rows(1, n, kind, seed=5)[0]
    v, i = G.block_topk_compress(torch.as_tensor(x), ratio, block)
    jv, ji = JG.block_topk_compress(jnp.asarray(x), ratio, block)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    for mode in ("off", "auto"):
        v2, i2 = G.block_topk_compress(torch.as_tensor(x), ratio, block, mode=mode)
        assert torch.equal(v2, v) and torch.equal(i2, i)


def test_scatter_decompress_and_leaf_k_equal_jax():
    rng = np.random.default_rng(6)
    vals = rng.standard_normal(12).astype(np.float32)
    idx = rng.integers(0, 20, 12).astype(np.int32)
    idx[:3] = 0  # duplicates add, as the wire's padded entries do
    got = G.scatter_decompress((4, 5), torch.as_tensor(vals), torch.as_tensor(idx))
    want = JG.scatter_decompress((4, 5), jnp.asarray(vals), jnp.asarray(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for shape, ratio in [((100, 10), 0.01), ((3,), 0.01), ((7, 9), 0.25), ((2, 2304), 0.05)]:
        assert G.leaf_k(shape, ratio) == JG.leaf_k(shape, ratio)


@pytest.mark.parametrize("n_pods,topology", [(1, "ring"), (2, "ring"), (3, "ring"),
                                             (4, "ring"), (8, "ring"), (8, "exponential")])
def test_shifts_and_weights_equal_jax(n_pods, topology):
    mine = G.GossipConfig(n_pods=n_pods, topology=topology).shifts_and_weights()
    theirs = JG.GossipConfig(n_pods=n_pods, topology=topology).shifts_and_weights()
    assert mine == theirs


def test_wire_bytes_closed_form():
    """gemma2-2b at 2 layers, block 4096, ratio 0.01 (k_b 40, 320 bytes a
    block), per pod: embed 144,000 blocks; final_norm one block of 2304
    (k_b 23); ln1 and ln2 (2 x 2304) two padded blocks each; wq and wo
    2,304 blocks each, wk and wv 1,152, wg, wu and wd 10,368."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.params import tree_leaves

    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=2)
    shapes = [d.shape for d in tree_leaves(T.model_defs(cfg))]
    assert sum(int(np.prod(s)) for s in shapes) == 745_549_056
    gc = G.GossipConfig(compression="block_topk", topk_ratio=0.01, block_size=4096)
    blocks = 144_000 + 2 * 2 + 2 * 2304 + 2 * 1152 + 3 * 10_368
    assert G.wire_bytes_per_pod(shapes, gc) == blocks * 320 + 23 * 8 == 58_246_584
    topk = G.GossipConfig(compression="topk", topk_ratio=0.01)
    assert G.wire_bytes_per_pod(shapes, topk) == 8 * sum(G.leaf_k(s, 0.01) for s in shapes)
    assert G.wire_bytes_per_pod(shapes, G.GossipConfig()) == 0
