"""DSBA-s: the sparse-communication relay of Section 5.1 (port of ``repro.core.sparse_comm``).

The ``comm="sparse"`` backend of ``core.solvers.solve``. Each iteration
every node broadcasts only its sparse update difference delta_n^t (eq. 27);
messages advance one hop per iteration along BFS trees, and every node
reconstructs the delayed network state from the deltas it has received
(eq. 28). Node u can reconstruct z_l^s at iteration t iff
s <= t + 1 - xi(l, u). The t = 0 update (eq. 31) involves the dense,
node-private phibar_n^0, so the dense z^1 is flooded once during warm-up.
See the JAX module's docstring for the full protocol.

This is the JAX package's vectorized engine, run eagerly:

* **Ring buffer.** ``R[s % depth, u, l]`` is node u's copy of z_l^s, with
  depth = diameter + 2; dense per-source deltas live in a matching
  ``(depth, N, D)`` ring ``DD``. Both are updated IN PLACE (the JAX scan
  rebuilds them functionally); nothing else holds a reference to them.
* **Distance waves.** At iteration t every (observer, source) pair at
  distance xi advances one state, s = t + 1 - xi, farthest-first
  (xi = dmax..1), so a pair can use what its distance-(xi+1) neighbor
  produced this iteration. The JAX ``lax.scan`` over t and over the waves
  become Python loops, and ``lax.cond`` a Python ``if``; a wave whose pairs
  are still warming up (t <= xi) is skipped, where the JAX engine computes
  it and masks the write.
* **Kernel.** Each step's delta is densified by ``sparse_axpy`` (psi = the
  tail block, rho = 1), so a relay step launches ``sparse_axpy`` once on
  top of the local step's 4 + 1 launches.
* **Closed-form accounting.** ``doubles_received``/``ints_received`` come
  from the per-iteration nnz log after the loop (``_closed_form_costs``).

``verify=True`` also carries the iterate-tag ring and the truth ring: every
read is checked against the availability invariant (``ProtocolViolation``)
and every reconstruction against the true trajectory (``recon_max_err``).

Not ported yet (ROADMAP Queue 1): the ``engine="reference"`` per-observer
loop (the JAX one stays the tests' oracle), link-fault ``sent_mask``,
restarts from a carried state, checkpointing and ``run_sparse_many``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.convert import dataset_to_torch
from repro_torch.core.dsba import DSBAConfig, device_config, dsba_step, init_state
from repro_torch.core.mixing import Graph, w_tilde
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import dispatch


class ProtocolViolation(AssertionError):
    """A reconstruction consumed a value the relay had not yet delivered."""


@dataclasses.dataclass
class SparseRunResult:
    """What `run_sparse` returns.

    z_trace is the true trajectory (equal to a dense run with the same
    index stream); doubles/ints are the paper's C_max message accounting
    (doubles exclude index ints); recon_max_err is nan unless verified.
    """

    z_trace: np.ndarray  # (T+1, N, D)   true trajectory (z^0 .. z^T)
    doubles_received: np.ndarray  # (T, N) cumulative DOUBLEs per node
    ints_received: np.ndarray  # (T, N) cumulative index ints per node
    recon_max_err: float  # max |reconstruction - truth|; nan unless verified
    state: object | None = None  # final solver state


@dataclasses.dataclass(frozen=True)
class _Tables:
    """Static per-graph tables of the relay."""

    dist: np.ndarray  # (N, N) BFS distances xi
    nbr_pad: np.ndarray  # (N, A) sorted neighbors + self, padded with self
    wt_pad: np.ndarray  # (N, A) matching W~ weights (0 on padding)
    pad_mask: np.ndarray  # (N, A) True on real entries
    pairs: dict[int, tuple[np.ndarray, np.ndarray]]  # xi -> (obs, src)
    dmax: int
    depth: int  # ring-buffer depth = diameter + 2


def _protocol_tables(graph: Graph, wt: np.ndarray) -> _Tables:
    n = graph.n
    dist = np.stack([graph.distances_from(u) for u in range(n)])
    lists = [sorted(graph.neighbors(u)) + [u] for u in range(n)]
    width = max(len(x) for x in lists)
    nbr_pad = np.empty((n, width), dtype=np.int32)
    wt_pad = np.zeros((n, width), dtype=wt.dtype)
    pad_mask = np.zeros((n, width), dtype=bool)
    for u, lst in enumerate(lists):
        nbr_pad[u, : len(lst)] = lst
        nbr_pad[u, len(lst):] = u  # padding reads a live slot, weight 0
        wt_pad[u, : len(lst)] = wt[u, lst]
        pad_mask[u, : len(lst)] = True
    dmax = int(dist.max())
    pairs = {
        xi: tuple(np.nonzero(dist == xi)) for xi in range(1, dmax + 1)
    }
    return _Tables(dist, nbr_pad, wt_pad, pad_mask, pairs, dmax,
                   depth=max(3, dmax + 2))


def _closed_form_costs(
    nnz_log: np.ndarray, dist: np.ndarray, tail: int, d_total: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Cumulative (doubles, ints) per node from the per-iteration nnz log.

    The delta broadcast by source l at iteration tau reaches observer u at
    iteration tau + xi(u, l); the dense z^1 flood (d_total doubles)
    arrives exactly at t == xi.
    """
    steps, n = nnz_log.shape
    ts = np.arange(steps)[:, None, None]  # (T, 1, 1)
    xi = dist[None, :, :]  # (1, obs, src)
    t_src = ts - xi  # broadcast delta emission time
    arrived = (t_src >= 0) & (xi > 0)
    src = np.arange(n)[None, None, :]
    nnz = nnz_log[np.clip(t_src, 0, None), src]  # (T, obs, src)
    ints_inc = np.where(arrived, nnz, 0).sum(axis=2)
    doubles_inc = np.where(arrived, nnz + tail, 0).sum(axis=2)
    doubles_inc += d_total * ((ts == xi) & (xi > 0)).sum(axis=2)
    return np.cumsum(doubles_inc, axis=0), np.cumsum(ints_inc, axis=0)


def _neighborhood_sum(R, j_cur, j_prev, obs, nbr, wts):
    """sum_a wts[:, a] * (2 R[j_cur, obs, nbr[:, a]] - R[j_prev, obs, nbr[:, a]]).

    The JAX engine's add order (one neighbor slot at a time).
    """
    acc = torch.zeros((obs.shape[0], R.shape[-1]), dtype=R.dtype, device=R.device)
    for a in range(nbr.shape[1]):
        m = nbr[:, a]
        acc = acc + wts[:, a, None] * (2.0 * R[j_cur, obs, m] - R[j_prev, obs, m])
    return acc


def run_sparse(
    cfg: DSBAConfig,
    data,
    graph: Graph,
    w: np.ndarray,
    steps: int,
    indices: np.ndarray,
    z0: np.ndarray | None = None,
    *,
    verify: bool = False,
    device=None,
) -> SparseRunResult:
    """Run DSBA-s (or DSA-s) for `steps` iterations on `graph`.

    data: a numpy ``SparseDataset``; indices: the (>= steps, N) sample
    stream; z0: the shared (N, D) starting point (zeros by default).
    verify: check the availability invariant and compare every
    reconstruction with the truth (``recon_max_err``).
    device: CUDA unless the caller passes ``"cpu"``.
    """
    if steps < 1:
        raise ValueError("steps must be >= 1")
    if np.ndim(cfg.lam) > 0:
        raise ValueError("the sparse relay takes a scalar lam")
    dev = resolve_device(device)
    tdata = dataset_to_torch(data, dev)
    n = data.n_nodes
    q = data.q
    tail = cfg.spec.tail_dim
    d = data.d
    D = d + tail
    dt = tdata.val.dtype
    step_cfg = device_config(cfg, dt, dev)
    alpha, lam = step_cfg.alpha, step_cfg.lam
    scale = (q - 1.0) / q

    tb = _protocol_tables(graph, w_tilde(w))
    depth, dmax = tb.depth, tb.dmax

    def on_dev(a, dtype=torch.long):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    iu = torch.arange(n, device=dev)
    nbr = on_dev(tb.nbr_pad)
    wtn = on_dev(tb.wt_pad, dt)
    padm = on_dev(tb.pad_mask, torch.bool)
    waves = [
        (xi, on_dev(tb.pairs[xi][0]), on_dev(tb.pairs[xi][1]))
        for xi in range(dmax, 0, -1)
    ]
    floods = {
        t: tuple(on_dev(a) for a in np.nonzero(tb.dist == t))
        for t in range(1, dmax + 1)
    }

    z0 = np.zeros((n, D), dtype=data.val.dtype) if z0 is None else np.asarray(z0)
    z0_t = on_dev(z0, dt)
    state = init_state(cfg, tdata, z0_t)
    mix0 = on_dev(w, dt) @ z0_t  # t = 0: z^0 is consensus-shared
    ones = torch.ones((n,), dtype=dt, device=dev)
    idx_t = on_dev(np.asarray(indices)[:steps])

    R = torch.zeros((depth, n, n, D), dtype=dt, device=dev)
    R[0] = z0_t.expand(n, n, D)
    DD = torch.zeros((depth, n, D), dtype=dt, device=dev)
    z1 = torch.zeros((n, D), dtype=dt, device=dev)
    if verify:
        SR = torch.full((depth, n, n), -(2**30), dtype=torch.int32, device=dev)
        SR[0] = 0
        Z = torch.zeros((depth, n, D), dtype=dt, device=dev)
        Z[0] = z0_t
        err = torch.zeros((), dtype=dt, device=dev)
        ok = torch.ones((), dtype=torch.bool, device=dev)

    zs, nnzs = [], []
    for t in range(steps):
        jt, jtm1 = t % depth, (t - 1) % depth
        z_t = state.z
        # -- own history: z^t is exact and free (computed locally last step)
        R[jt, iu, iu] = z_t
        if verify:
            SR[jt, iu, iu] = t
            Z[jt] = z_t
        if t == 1:
            z1 = z_t

        # -- one-time dense z^1 warm-up flood arrives at t == xi ------------
        if 1 <= t <= dmax:
            fu, fl = floods[t]
            R[1, fu, fl] = z1[fl]
            if verify:
                SR[1, fu, fl] = 1

        # -- reconstruction waves, farthest-first (paper's V_j ordering) ----
        for xi, up, lp in waves:
            if t < xi + 1:
                continue  # these pairs are still in warm-up
            s = t + 1 - xi
            j1, j2, jn = (s - 1) % depth, (s - 2) % depth, s % depth
            m_idx = nbr[lp]  # (P, A)
            mix = _neighborhood_sum(R, j1, j2, up, m_idx, wtn[lp])
            corr = alpha * (scale * DD[j2, lp] - DD[j1, lp])
            self1 = R[j1, up, lp]
            if cfg.method == "dsba":
                new = (mix + alpha * lam * self1 + corr) / (1.0 + alpha * lam)
            else:  # dsa
                self2 = R[j2, up, lp]
                new = mix + corr - alpha * lam * (self1 - self2)
            R[jn, up, lp] = new
            if verify:
                S1 = SR[j1][up[:, None], m_idx]
                S2 = SR[j2][up[:, None], m_idx]
                reads = (S1 == s - 1) & (S2 == s - 2)
                ok = ok & torch.where(padm[lp], reads, True).all()
                SR[jn, up, lp] = s
                err = torch.maximum(err, (new - Z[jn, lp]).abs().max())

        # -- mixing rows from each node's OWN reconstruction store ----------
        if t == 0:
            mix_rows = mix0
        else:
            mix_rows = _neighborhood_sum(R, jt, jtm1, iu, nbr, wtn)
            if verify:
                s_cur = SR[jt][iu[:, None], nbr]
                s_prev = SR[jtm1][iu[:, None], nbr]
                fresh = (s_cur == t) & (s_prev == t - 1)
                ok = ok & torch.where(padm, fresh, True).all()

        # -- advance all nodes with the shared local update -----------------
        state = dsba_step(step_cfg, tdata.idx, tdata.val, tdata.y, state,
                          idx_t[t], mix_rows, mix_rows)
        base = torch.zeros((n, D), dtype=dt, device=dev)
        if tail:
            base[:, d:] = state.dtail_prev
        DD[jt] = dispatch(
            "sparse_axpy", base, state.didx_prev, state.dval_prev,
            state.dg_prev, ones,
        )
        zs.append(state.z)
        nnzs.append((state.dval_prev != 0).sum(-1))

    if verify and not bool(ok):
        raise ProtocolViolation(
            "relay schedule consumed a value before its arrival"
        )
    z_trace = torch.cat([z0_t[None], torch.stack(zs)]).cpu().numpy()
    nnz_log = torch.stack(nnzs).cpu().numpy().astype(np.int64)
    doubles, ints = _closed_form_costs(nnz_log, tb.dist, tail, D)
    return SparseRunResult(
        z_trace=z_trace,
        doubles_received=doubles,
        ints_received=ints,
        recon_max_err=float(err) if verify else float("nan"),
        state=state,
    )


def sparse_doubles_per_iter(n_nodes: int, k: int, tail_dim: int) -> int:
    """Steady-state DOUBLEs received per node per iteration under DSBA-s."""
    return (n_nodes - 1) * (k + tail_dim)


def dense_doubles_per_iter(graph: Graph, d_total: int) -> np.ndarray:
    """Per-node DOUBLEs received per iteration with dense neighbor exchange."""
    return graph.degrees * d_total
