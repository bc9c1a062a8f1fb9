"""Graph topologies and mixing matrices for decentralized optimization.

Implements the mixing-matrix requirements of the paper (Section 4):
  (i)   graph sparsity:  w_{m,l} = 0 unless (m,l) in E or m == l
  (ii)  symmetry:        W = W^T
  (iii) null-space:      null(I - W) = span{1_N}
  (iv)  spectral:        0 <= W <= I

The paper uses the Laplacian-based constant edge weight matrix
W = I - L/tau with tau >= lambda_max(L)/2 (Section 7). We also provide
Metropolis-Hastings weights and standard pod topologies (ring, torus,
Erdos-Renyi) for the pod-axis runtime.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected connected graph over nodes 0..n-1."""

    n: int
    edges: tuple[tuple[int, int], ...]  # (i, j) with i < j, no self loops

    def __post_init__(self):
        """Validate edge endpoints against the node range."""
        for i, j in self.edges:
            if not (0 <= i < j < self.n):
                raise ValueError(f"bad edge ({i},{j}) for n={self.n}")

    @property
    def adjacency(self) -> np.ndarray:
        """(n, n) symmetric 0/1 adjacency matrix."""
        a = np.zeros((self.n, self.n), dtype=np.float64)
        for i, j in self.edges:
            a[i, j] = a[j, i] = 1.0
        return a

    @property
    def laplacian(self) -> np.ndarray:
        """Graph Laplacian L = D - A."""
        a = self.adjacency
        return np.diag(a.sum(1)) - a

    @property
    def degrees(self) -> np.ndarray:
        """(n,) per-node degree vector."""
        return self.adjacency.sum(1).astype(np.int64)

    @property
    def max_degree(self) -> int:
        """Delta(G), the paper's dense per-iteration communication factor."""
        return int(self.degrees.max())

    def neighbors(self, n: int) -> list[int]:
        """Nodes adjacent to `n` (unsorted)."""
        return [j for i, j in self.edges if i == n] + [
            i for i, j in self.edges if j == n
        ]

    def is_connected(self) -> bool:
        """BFS reachability of every node from node 0."""
        seen = {0}
        frontier = [0]
        adj = {i: self.neighbors(i) for i in range(self.n)}
        while frontier:
            v = frontier.pop()
            for u in adj[v]:
                if u not in seen:
                    seen.add(u)
                    frontier.append(u)
        return len(seen) == self.n

    def distances_from(self, src: int) -> np.ndarray:
        """BFS topological distances xi_i (eq. 33)."""
        dist = np.full(self.n, -1, dtype=np.int64)
        dist[src] = 0
        frontier = [src]
        adj = {i: self.neighbors(i) for i in range(self.n)}
        while frontier:
            nxt = []
            for v in frontier:
                for u in adj[v]:
                    if dist[u] < 0:
                        dist[u] = dist[v] + 1
                        nxt.append(u)
            frontier = nxt
        return dist

    @property
    def diameter(self) -> int:
        """max_{u,v} xi(u, v) — the relay protocol's warm-up horizon."""
        return int(max(self.distances_from(s).max() for s in range(self.n)))

    def subgraph(self, keep: "list[int] | tuple[int, ...]") -> "Graph":
        """Induced subgraph on `keep` (renumbered 0..len(keep)-1, in order).

        The churn path uses this for survivor graphs; the result may be
        disconnected — callers that need a connected mixing graph should
        check ``is_connected()`` (e.g. before ``laplacian_mixing``).
        """
        keep = list(keep)
        if len(set(keep)) != len(keep):
            raise ValueError("subgraph keep-list has duplicates")
        remap = {old: new for new, old in enumerate(keep)}
        edges = tuple(
            (min(remap[i], remap[j]), max(remap[i], remap[j]))
            for i, j in self.edges
            if i in remap and j in remap
        )
        return Graph(len(keep), edges)


def ring_graph(n: int) -> Graph:
    """Cycle over n nodes (diameter n//2 — the deepest standard relay)."""
    if n < 2:
        raise ValueError("ring needs n >= 2")
    if n == 2:
        return Graph(2, ((0, 1),))
    edges = tuple(sorted((i, (i + 1) % n)) for i in range(n))
    return Graph(n, tuple((min(a, b), max(a, b)) for a, b in edges))


def complete_graph(n: int) -> Graph:
    """All-to-all graph (diameter 1)."""
    return Graph(n, tuple((i, j) for i in range(n) for j in range(i + 1, n)))


def torus_graph(rows: int, cols: int) -> Graph:
    """2-D torus; matches ICI wiring of TPU pod slices."""
    n = rows * cols
    edges = set()

    def nid(r, c):
        return (r % rows) * cols + (c % cols)

    for r in range(rows):
        for c in range(cols):
            for rr, cc in ((r + 1, c), (r, c + 1)):
                a, b = nid(r, c), nid(rr, cc)
                if a != b:
                    edges.add((min(a, b), max(a, b)))
    return Graph(n, tuple(sorted(edges)))


def erdos_renyi_graph(n: int, p: float, seed: int = 0) -> Graph:
    """Random G(n, p); resamples until connected (paper: N=10, p=0.4)."""
    rng = np.random.default_rng(seed)
    for _ in range(1000):
        edges = tuple(
            (i, j)
            for i in range(n)
            for j in range(i + 1, n)
            if rng.random() < p
        )
        g = Graph(n, edges)
        if g.is_connected():
            return g
    raise RuntimeError("failed to sample a connected graph")


def exponential_graph(n: int) -> Graph:
    """Hypercube-like exponential graph: i ~ i +/- 2^k (mod n).

    O(log n) degree with O(log n) diameter -- the standard choice for
    large decentralized deployments (1000+ nodes).
    """
    edges = set()
    k = 1
    while k < n:
        for i in range(n):
            j = (i + k) % n
            if i != j:
                edges.add((min(i, j), max(i, j)))
        k *= 2
    return Graph(n, tuple(sorted(edges)))


def laplacian_mixing(graph: Graph, scale: float | None = None) -> np.ndarray:
    """Paper Section 7: W = I - L/tau, tau >= lambda_max(L)/2.

    Default tau = lambda_max(L)/2 * (1 + 1e-9) -- but note tau must also keep
    W >= 0 spectrally; lambda_max/2 gives eigenvalues in [-1, 1]*... actually
    eig(W) = 1 - eig(L)/tau in [1 - lmax/tau, 1] = [-1, 1] at tau = lmax/2.
    Condition (iv) requires 0 <= W, so we default tau = lambda_max(L) which
    gives eig(W) in [0, 1], and expose `scale` for the paper's tau.
    """
    lap = graph.laplacian
    lmax = float(np.linalg.eigvalsh(lap).max())
    tau = scale if scale is not None else lmax
    if tau < lmax / 2:
        raise ValueError(f"tau={tau} < lambda_max/2={lmax / 2}")
    return np.eye(graph.n) - lap / tau


def metropolis_mixing(graph: Graph) -> np.ndarray:
    """Metropolis-Hastings weights: w_ij = 1/(1+max(d_i,d_j)); doubly stochastic."""
    deg = graph.degrees
    w = np.zeros((graph.n, graph.n))
    for i, j in graph.edges:
        w[i, j] = w[j, i] = 1.0 / (1.0 + max(deg[i], deg[j]))
    np.fill_diagonal(w, 1.0 - w.sum(1))
    return w


def validate_mixing(w: np.ndarray, graph: Graph, atol: float = 1e-10) -> None:
    """Assert conditions (i)-(iv) of Section 4."""
    n = graph.n
    adj = graph.adjacency + np.eye(n)
    if np.any((np.abs(w) > atol) & (adj == 0)):
        raise AssertionError("graph sparsity violated")
    if not np.allclose(w, w.T, atol=atol):
        raise AssertionError("symmetry violated")
    eigvals, eigvecs = np.linalg.eigh(w)
    # null(I - W) = span{1}: exactly one eigenvalue == 1, eigenvector ~ 1/sqrt(n)
    ones = np.isclose(eigvals, 1.0, atol=1e-8)
    if ones.sum() != 1:
        raise AssertionError(f"null-space property violated: {eigvals}")
    v = eigvecs[:, np.argmax(eigvals)]
    if not np.allclose(np.abs(v), 1.0 / np.sqrt(n), atol=1e-6):
        raise AssertionError("leading eigenvector is not the consensus vector")
    if eigvals.min() < -atol or eigvals.max() > 1 + 1e-8:
        raise AssertionError(f"spectral property violated: {eigvals}")


def spectral_gap(w: np.ndarray) -> float:
    """1 - |lambda_2(W)|: positive iff the mixing matrix contracts consensus.

    lambda_2 is the second-largest eigenvalue *in magnitude* (the largest is
    the consensus eigenvalue 1). Per-segment gaps of a graph schedule are
    recorded in ``SolveResult.extras["schedule"]`` — each segment's geometric
    consensus rate is governed by its own gap.
    """
    eigvals = np.sort(np.abs(np.linalg.eigvalsh(np.asarray(w, np.float64))))
    if eigvals.size == 1:
        return 1.0
    return float(1.0 - eigvals[-2])


def graph_gamma(w: np.ndarray) -> float:
    """gamma = smallest *nonzero* singular value of U^2 = W_tilde - W = (I-W)/2.

    The paper's graph condition number is kappa_g = 1/gamma (Theorem 6.1).
    """
    m = (np.eye(w.shape[0]) - w) / 2.0
    s = np.linalg.svd(m, compute_uv=False)
    nz = s[s > 1e-12]
    return float(nz.min())


def graph_condition_number(w: np.ndarray) -> float:
    """kappa_g = 1/gamma (Theorem 6.1's graph condition number)."""
    return 1.0 / graph_gamma(w)


def w_tilde(w: np.ndarray) -> np.ndarray:
    """W_tilde = (W + I)/2 (eq. 24)."""
    return (w + np.eye(w.shape[0])) / 2.0


def make_pod_mixing(
    n_pods: int, topology: str = "ring", seed: int = 0
) -> tuple[Graph, np.ndarray]:
    """Graph + Laplacian mixing matrix for the pod axis of a TPU mesh."""
    if topology == "ring":
        g = ring_graph(n_pods) if n_pods > 1 else Graph(1, ())
    elif topology == "complete":
        g = complete_graph(n_pods)
    elif topology == "exponential":
        g = exponential_graph(n_pods)
    elif topology == "erdos_renyi":
        g = erdos_renyi_graph(n_pods, 0.4, seed)
    else:
        raise ValueError(f"unknown topology {topology!r}")
    if n_pods == 1:
        return g, np.ones((1, 1))
    return g, laplacian_mixing(g)
