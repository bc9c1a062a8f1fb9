"""Synthetic sparse datasets for the paper's convex experiments.

The paper uses News20-binary, RCV1 and Sector (LIBSVM). Those files are not
available offline, so we generate synthetic sparse datasets with matched
first-order statistics — dimension d, row sparsity rho, label balance — and
normalize every row to ||a|| = 1 exactly as the paper does. The presets below
carry the real datasets' (d, rho) so communication-cost ratios (O(rho*d) vs
O(d)) reproduce.

Rows are stored in padded-CSR form: idx (n, k) int32 + val (n, k) float,
k = max nnz per row; padding entries have val == 0 (idx 0). This is the
JAX-friendly fixed-shape sparse format used throughout core/.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# (d, nnz_per_row) matched to LIBSVM statistics (approx.)
DATASET_PRESETS = {
    "news20": dict(d=1_355_191, k=450),
    "rcv1": dict(d=47_236, k=74),
    "sector": dict(d=55_197, k=162),
    # small presets for tests/benchmarks
    "tiny": dict(d=64, k=8),
    "small": dict(d=2_000, k=40),
}


@dataclasses.dataclass
class SparseDataset:
    """Row-sparse dataset, split across N nodes with q rows each."""

    idx: np.ndarray  # (N, q, k) int32
    val: np.ndarray  # (N, q, k) float
    y: np.ndarray  # (N, q) float (+-1 for classification, real for regression)
    d: int

    @property
    def n_nodes(self) -> int:
        return self.idx.shape[0]

    @property
    def q(self) -> int:
        return self.idx.shape[1]

    @property
    def k(self) -> int:
        return self.idx.shape[2]

    @property
    def rho(self) -> float:
        """Fraction of nonzero features per row (paper's dataset sparsity)."""
        return float((self.val != 0).sum(-1).mean() / self.d)

    @property
    def total(self) -> int:
        return self.n_nodes * self.q

    def dense(self) -> np.ndarray:
        """(N, q, d) dense features — small problems only."""
        out = np.zeros((self.n_nodes, self.q, self.d), dtype=self.val.dtype)
        n_i = np.arange(self.n_nodes)[:, None, None]
        q_i = np.arange(self.q)[None, :, None]
        out[n_i, q_i, self.idx] += self.val  # pads add 0 at column 0
        return out

    def positive_ratio(self) -> float:
        return float((self.y > 0).mean())


def _sparse_rows(rng, n, d, k, dtype):
    """n normalized sparse rows with exactly k nonzeros each."""
    idx = np.empty((n, k), dtype=np.int32)
    for i in range(n):  # distinct indices per row
        idx[i] = rng.choice(d, size=k, replace=False)
    val = rng.standard_normal((n, k)).astype(dtype)
    val /= np.linalg.norm(val, axis=1, keepdims=True)  # ||a|| = 1 (paper)
    return idx, val


def _split(rng, idx, val, y, n_nodes):
    n = idx.shape[0]
    q = n // n_nodes
    perm = rng.permutation(n)[: q * n_nodes]
    shape = (n_nodes, q)
    return idx[perm].reshape(*shape, -1), val[perm].reshape(*shape, -1), y[
        perm
    ].reshape(shape)


def make_regression(
    n_nodes: int = 10,
    q: int = 50,
    d: int = 64,
    k: int = 8,
    noise: float = 0.1,
    seed: int = 0,
    dtype=np.float64,
) -> SparseDataset:
    """Sparse ridge-regression data: y = a^T w* + noise."""
    rng = np.random.default_rng(seed)
    n = n_nodes * q
    idx, val = _sparse_rows(rng, n, d, k, dtype)
    w_star = rng.standard_normal(d).astype(dtype)
    u = np.einsum("nk,nk->n", val, w_star[idx])
    y = u + noise * rng.standard_normal(n).astype(dtype)
    i, v, yy = _split(rng, idx, val, y, n_nodes)
    return SparseDataset(i, v, yy, d)


def make_classification(
    n_nodes: int = 10,
    q: int = 50,
    d: int = 64,
    k: int = 8,
    positive_ratio: float = 0.5,
    flip: float = 0.02,
    seed: int = 0,
    dtype=np.float64,
) -> SparseDataset:
    """Sparse binary classification (labels +-1), optionally imbalanced.

    For AUC experiments set positive_ratio << 0.5 (class imbalance is where
    AUC matters).
    """
    rng = np.random.default_rng(seed)
    n = n_nodes * q
    idx, val = _sparse_rows(rng, n, d, k, dtype)
    w_star = rng.standard_normal(d).astype(dtype)
    u = np.einsum("nk,nk->n", val, w_star[idx])
    thresh = np.quantile(u, 1.0 - positive_ratio)
    y = np.where(u > thresh, 1.0, -1.0).astype(dtype)
    flips = rng.random(n) < flip
    y[flips] *= -1.0
    i, v, yy = _split(rng, idx, val, y, n_nodes)
    return SparseDataset(i, v, yy, d)


def make_noniid_regression(
    n_nodes: int = 10,
    q: int = 50,
    d: int = 64,
    k: int = 8,
    shift: float = 1.0,
    noise: float = 0.1,
    seed: int = 0,
    dtype=np.float64,
) -> tuple[SparseDataset, np.ndarray]:
    """Deliberately non-iid splits: node n's labels come from its OWN model.

    Per-node ground truth w*_n = w_shared + shift * delta_n with delta_n a
    unit-norm node-specific direction, and each node samples its q rows
    locally (no global shuffle): the node marginals differ in both the
    label model and the draw. ``shift`` interpolates from the iid setting
    (0.0) to fully heterogeneous nodes. This is the personalization
    testbed: a single consensus model underfits every node, while per-node
    regularization (``Problem.lam`` as an (N,) array) trades local fit
    against consensus coupling.

    Returns ``(dataset, w_stars)`` with ``w_stars`` of shape (N, d) so
    tests can measure per-node excess risk against the true local models.
    """
    rng = np.random.default_rng(seed)
    w_shared = rng.standard_normal(d).astype(dtype)
    idx = np.empty((n_nodes, q, k), dtype=np.int32)
    val = np.empty((n_nodes, q, k), dtype=dtype)
    y = np.empty((n_nodes, q), dtype=dtype)
    w_stars = np.empty((n_nodes, d), dtype=dtype)
    for n in range(n_nodes):
        delta = rng.standard_normal(d).astype(dtype)
        delta /= np.linalg.norm(delta)
        w_stars[n] = w_shared + shift * delta
        i_n, v_n = _sparse_rows(rng, q, d, k, dtype)
        u = np.einsum("qk,qk->q", v_n, w_stars[n][i_n])
        idx[n], val[n] = i_n, v_n
        y[n] = u + noise * rng.standard_normal(q).astype(dtype)
    return SparseDataset(idx, val, y, d), w_stars


def from_preset(
    name: str, task: str = "classification", n_nodes: int = 10,
    q: int = 100, seed: int = 0
) -> SparseDataset:
    cfg = DATASET_PRESETS[name]
    if task == "regression":
        return make_regression(n_nodes, q, cfg["d"], cfg["k"], seed=seed)
    return make_classification(n_nodes, q, cfg["d"], cfg["k"], seed=seed)
