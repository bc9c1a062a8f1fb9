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

What ``solve()`` drives through it besides a fresh run:

* **Restart** (``state0=``): a schedule segment or a churn segment
  continues from a carried ``DSBAState``; the ring is seeded with its
  iterates, which the accounting charges as a second dense flood.
* **Link faults** (``sent_mask=``): a suppressed broadcast leaves a zeroed
  delta in the ring and a zero in the nnz log, after the ``sparse_axpy``
  call, so a faulty step launches what a plain one does.
* **Checkpointing** (``ckpt_every=``, ``ckpt_save=``, ``resume=``): the
  carry (solver state, z^1, the rings, the verify rings) and the
  ``zs``/``nnzs`` logs are saved in the JAX package's ``{"carry", "zs",
  "nnzs"}`` layout; a resumed run is bit-equal to an uninterrupted one.
* ``engine="reference"``: the per-observer Python loop with an
  (N, N, steps + 2, D) numpy store, the parity oracle (small sizes only).

``run_sparse_many`` (the batched sweep; its only caller is ``solve_many``)
is not ported yet (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import _flatten_with_paths, _unflatten
from repro_torch.convert import dataset_to_torch
from repro_torch.core.dsba import DSBAConfig, DSBAState, device_config, dsba_step, init_state
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
    state: object | None = None  # final solver state (segment chaining)


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
    restart: bool = False, sent: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Cumulative (doubles, ints) per node from the per-iteration nnz log.

    The delta broadcast by source l at iteration tau reaches observer u at
    iteration tau + xi(u, l); the dense z^1 flood (d_total doubles)
    arrives exactly at t == xi. ``restart=True`` (a segment resync)
    charges a second dense flood at t == xi: the segment-entry iterates
    are node-private, so they are flooded alongside z^1. ``sent``: an
    optional (T, N) link-fault mask; a suppressed broadcast arrives
    nowhere, so neither its payload nor its tail is charged (the floods
    are fault-exempt).
    """
    steps, n = nnz_log.shape
    ts = np.arange(steps)[:, None, None]  # (T, 1, 1)
    xi = dist[None, :, :]  # (1, obs, src)
    t_src = ts - xi  # broadcast delta emission time
    arrived = (t_src >= 0) & (xi > 0)
    src = np.arange(n)[None, None, :]
    if sent is not None:
        arrived &= sent[np.clip(t_src, 0, None), src]
    nnz = nnz_log[np.clip(t_src, 0, None), src]  # (T, obs, src)
    ints_inc = np.where(arrived, nnz, 0).sum(axis=2)
    doubles_inc = np.where(arrived, nnz + tail, 0).sum(axis=2)
    floods = 2 if restart else 1
    doubles_inc += floods * d_total * ((ts == xi) & (xi > 0)).sum(axis=2)
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
    state0: DSBAState | None = None,
    engine: str = "vectorized",
    verify: bool = False,
    sent_mask: np.ndarray | None = None,
    ckpt_every: int | None = None,
    ckpt_save=None,
    resume=None,
    device=None,
) -> SparseRunResult:
    """Run DSBA-s (or DSA-s) for `steps` iterations on `graph`.

    data: a numpy ``SparseDataset``; indices: the (>= steps, N) sample
    stream; z0: the shared (N, D) starting point (zeros by default).
    engine: "vectorized" (default) or "reference" (the per-observer loop;
        always verifies).
    verify: vectorized engine only -- check the availability invariant and
        compare every reconstruction with the truth (``recon_max_err``).
    state0: a carried ``DSBAState`` (a schedule or churn segment). The run
        restarts from it on this `graph`/`w`: its t = 0 mixing is
        ``w_tilde(w) @ (2 z - z_prev)``, or ``w @ z`` when its step counter
        was reanchored to 0 (churn), and the segment-entry iterates are
        flooded alongside z^1 (charged). ``z0`` must then be None.
    sent_mask: optional (steps, N) bool link-fault mask; a False entry
        suppresses that node's delta broadcast for that iteration (every
        observer reconstructs on a zeroed delta; the accounting charges
        nothing for it). Vectorized engine only, and not with ``verify``.
    ckpt_every / ckpt_save / resume: checkpointed execution for
        ``solve(checkpoint=, resume=)``. At every ``ckpt_every`` boundary
        ``ckpt_save(t_done, tree)`` receives ``{"carry", "zs", "nnzs"}``;
        ``resume=(t_done, leaves)`` (``ckpt.load_checkpoint`` leaves)
        continues bit-equal to an uninterrupted run.
    device: CUDA unless the caller passes ``"cpu"``.
    """
    if steps < 1:
        raise ValueError("steps must be >= 1")
    if np.ndim(cfg.lam) > 0:
        raise ValueError("the sparse relay takes a scalar lam")
    if state0 is not None and z0 is not None:
        raise ValueError("pass either z0 (fresh start) or state0 (restart)")
    if sent_mask is not None and verify:
        raise ValueError(
            "verify=True is incompatible with a link-fault sent_mask: the "
            "relay invariant check asserts exact reconstruction, which "
            "injected faults violate by design"
        )
    if engine == "reference":
        if sent_mask is not None:
            raise ValueError(
                "link faults need engine='vectorized' (the reference "
                "per-observer oracle assumes lossless broadcasts)"
            )
        if ckpt_every is not None or resume is not None:
            raise ValueError("checkpoint/resume needs engine='vectorized'")
        return _run_reference(cfg, data, graph, w, steps, indices, z0,
                              state0=state0, device=device)
    if engine != "vectorized":
        raise ValueError(f"unknown engine {engine!r}")
    return _run_vectorized(
        cfg, data, graph, w, steps, indices, z0, state0=state0,
        verify=verify, sent_mask=sent_mask, ckpt_every=ckpt_every,
        ckpt_save=ckpt_save, resume=resume, device=device,
    )


def _carry_from_leaves(carry0, leaves):
    """A relay carry shaped like ``carry0`` from ``ckpt.load_checkpoint``
    leaves, matched by path under the ``{"carry": ...}`` wrapper."""
    paths, like = _flatten_with_paths({"carry": carry0})
    new = []
    for p, lk in zip(paths, like):
        if p not in leaves:
            raise ValueError(f"checkpoint is missing carry leaf {p!r}")
        new.append(torch.as_tensor(leaves[p]).to(device=lk.device, dtype=lk.dtype))
    return _unflatten({"carry": carry0}, new)["carry"]


def _run_vectorized(
    cfg, data, graph, w, steps, indices, z0, *, state0, verify, sent_mask,
    ckpt_every, ckpt_save, resume, device,
) -> SparseRunResult:
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
    restart = state0 is not None
    if sent_mask is not None:
        sent_mask = np.asarray(sent_mask, dtype=bool)
        if sent_mask.shape != (steps, n):
            raise ValueError(
                f"sent_mask must be (steps, N) = ({steps}, {n}), "
                f"got {sent_mask.shape}"
            )

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
    sent_t = None if sent_mask is None else on_dev(sent_mask, torch.bool)
    zero = torch.zeros((), dtype=dt, device=dev)

    if restart:
        state = state0
        z0_t = state0.z
        if int(state0.step) == 0:
            # a churn-remapped state, reanchored: the first step re-runs
            # the eq. 31 anchored update, mixing W against its iterates
            mix0 = on_dev(w, dt) @ z0_t
        else:
            # a carried state: the eq. 29 psi path mixes W~ against
            # (2 z - z_prev) of the carried iterates
            mix0 = on_dev(w_tilde(w), dt) @ (2.0 * z0_t - state0.z_prev)
    else:
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
    else:  # zero-size placeholders keep the checkpointed carry's layout
        SR = torch.zeros((0,), dtype=torch.int32, device=dev)
        Z = torch.zeros((0,), dtype=dt, device=dev)
    err = torch.zeros((), dtype=dt, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)

    start = 0
    zs_host, nnz_host = [], []  # numpy chunks of the (zs, nnzs) logs
    zs, nnzs = [], []  # device rows since the last flush
    if resume is not None:
        t_done, leaves = resume
        if not 0 < t_done <= steps:
            raise ValueError(f"resume step {t_done} outside (0, {steps}]")
        state, z1, R, DD, SR, Z, err, ok = _carry_from_leaves(
            (state, z1, R, DD, SR, Z, err, ok), leaves)
        zs_host.append(np.asarray(leaves["['zs']"]))
        nnz_host.append(np.asarray(leaves["['nnzs']"]))
        start = int(t_done)
    every = int(ckpt_every) if ckpt_every is not None else steps
    saves = set() if ckpt_save is None else {
        mk for mk in range(start + every, steps + 1, every) if mk % every == 0}

    def flush():
        if zs:
            zs_host.append(torch.stack(zs).cpu().numpy())
            nnz_host.append(torch.stack(nnzs).cpu().numpy().astype(np.int32))
            zs.clear()
            nnzs.clear()

    for t in range(start, steps):
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
        dd = dispatch(
            "sparse_axpy", base, state.didx_prev, state.dval_prev,
            state.dg_prev, ones,
        )
        nnz_t = (state.dval_prev != 0).sum(-1)
        if sent_t is not None:
            # a suppressed broadcast: observers see a zeroed delta and the
            # nnz log drops the row; the source's own row of R stays exact
            dd = torch.where(sent_t[t][:, None], dd, zero)
            nnz_t = torch.where(sent_t[t], nnz_t, 0)
        DD[jt] = dd
        zs.append(state.z)
        nnzs.append(nnz_t)
        if t + 1 in saves:
            flush()
            ckpt_save(t + 1, {
                "carry": (state, z1, R, DD, SR, Z, err, ok),
                "zs": np.concatenate(zs_host),
                "nnzs": np.concatenate(nnz_host),
            })

    if verify and not bool(ok):
        raise ProtocolViolation(
            "relay schedule consumed a value before its arrival"
        )
    flush()
    z_trace = np.concatenate([z0_t.cpu().numpy()[None], *zs_host])
    nnz_log = np.concatenate(nnz_host).astype(np.int64)
    doubles, ints = _closed_form_costs(
        nnz_log, tb.dist, tail, D, restart=restart, sent=sent_mask)
    return SparseRunResult(
        z_trace=z_trace,
        doubles_received=doubles,
        ints_received=ints,
        recon_max_err=float(err) if verify else float("nan"),
        state=state,
    )


# ---------------------------------------------------------------------------
# Reference engine: the per-observer loop (the parity oracle). Slow:
# O(N^2 T) Python-level reconstructions and an O(N^2 T D) store.
# ---------------------------------------------------------------------------

def _run_reference(
    cfg, data, graph, w, steps, indices, z0=None, state0=None, device=None,
) -> SparseRunResult:
    """The JAX package's reference engine: each observer reconstructs every
    source from its own NaN-initialized numpy store, with availability
    asserted on every read; the local update runs on ``device``."""
    dev = resolve_device(device)
    tdata = dataset_to_torch(data, dev)
    alpha, lam = cfg.alpha, cfg.lam
    n = data.n_nodes
    q, k = data.q, data.k
    tail = cfg.spec.tail_dim
    d = data.d
    D = d + tail
    dt = data.val.dtype
    restart = state0 is not None
    if restart:
        z0 = state0.z.cpu().numpy()
    elif z0 is None:
        z0 = np.zeros((n, D), dtype=dt)
    z0 = np.asarray(z0)

    dist = np.stack([graph.distances_from(u) for u in range(n)])  # (N, N)
    wt = w_tilde(w)
    neighbors = {u: sorted(graph.neighbors(u)) for u in range(n)}

    step_cfg = device_config(cfg, tdata.val.dtype, dev)
    state = state0 if restart else init_state(
        cfg, tdata, torch.as_tensor(z0, dtype=tdata.val.dtype, device=dev))

    def step_fn(st, i_t, mix):
        return dsba_step(step_cfg, tdata.idx, tdata.val, tdata.y, st, i_t, mix, mix)

    # recon[u, l, s] = node u's reconstruction of z_l^s (NaN = not yet known)
    recon = np.full((n, n, steps + 2, D), np.nan, dtype=dt)
    recon[:, :, 0, :] = z0[None, :, :]
    s_next = np.full((n, n), 2, dtype=np.int64)  # next s to reconstruct

    # true trajectory + delta log (the scheduler enforces availability)
    z_hist = np.zeros((steps + 2, n, D), dtype=dt)
    z_hist[0] = z0
    dg_log = np.zeros((steps, n), dtype=dt)
    didx_log = np.zeros((steps, n, k), dtype=np.int64)
    dval_log = np.zeros((steps, n, k), dtype=dt)
    dtail_log = np.zeros((steps, n, tail), dtype=dt)

    doubles = np.zeros((steps, n), dtype=np.int64)
    ints = np.zeros((steps, n), dtype=np.int64)
    recon_err = 0.0

    def delta_vec(t_src, l):
        v = np.zeros(D, dtype=dt)
        np.add.at(v[:d], didx_log[t_src, l], dg_log[t_src, l] * dval_log[t_src, l])
        if tail:
            v[d:] += dtail_log[t_src, l]
        return v

    def reconstruct(u, l, s, t):
        """z_l^s from u's store via the update recursion (eq. 28 + lam)."""
        mix = np.zeros(D, dtype=dt)
        for m in neighbors[l] + [l]:
            zm1 = recon[u, m, s - 1]
            zm2 = recon[u, m, s - 2]
            if np.isnan(zm1).any() or np.isnan(zm2).any():
                raise ProtocolViolation(f"recon of {l} at {u} needs {m}@{s - 1} at {t}")
            mix += wt[l, m] * (2.0 * zm1 - zm2)
        dm1 = delta_vec(s - 1, l)
        dm2 = delta_vec(s - 2, l)
        corr = alpha * ((q - 1.0) / q * dm2 - dm1)
        if cfg.method == "dsba":
            return (mix + alpha * lam * recon[u, l, s - 1] + corr) / (
                1.0 + alpha * lam
            )
        # dsa
        return mix + corr - alpha * lam * (recon[u, l, s - 1] - recon[u, l, s - 2])

    for t in range(steps):
        # ---- message arrivals + reconstruction, per observer --------------
        if t >= 1:
            for u in range(n):
                # own history is exact and free
                recon[u, u, : t + 1, :] = z_hist[: t + 1, u]
                # arrivals first: dense z^1 warm-up flood + today's deltas
                for l in range(n):
                    if l == u:
                        continue
                    xi = dist[u, l]
                    if t == xi:
                        recon[u, l, 1] = z_hist[1, l]
                        doubles[t, u] += D  # one-time dense z^1 flood
                        if restart:
                            doubles[t, u] += D  # z^0 resync flood
                    if t - xi >= 0:
                        nnz = int((dval_log[t - xi, l] != 0).sum())
                        doubles[t, u] += nnz + tail
                        ints[t, u] += nnz
                # reconstruct farthest-first: a node at distance xi+1 must
                # advance before its distance-xi neighbor consumes its s-1
                # value this same iteration
                order = sorted(
                    (l for l in range(n) if l != u),
                    key=lambda l: -dist[u, l],
                )
                for l in order:
                    xi = dist[u, l]
                    while s_next[u, l] <= t + 1 - xi:
                        s = int(s_next[u, l])
                        if (s - 1) + xi > t:
                            raise ProtocolViolation(f"delta of {l}@{s - 1} read at {u} at {t}")
                        recon[u, l, s] = reconstruct(u, l, s, t)
                        s_next[u, l] = s + 1

        # ---- mixing rows from each node's OWN reconstruction store --------
        if t == 0 and restart and int(state0.step) == 0:
            mix = w @ z0  # churn-reanchored: the eq. 31 update mixes W @ z
        elif t == 0 and restart:
            mix = wt @ (2.0 * z0 - state0.z_prev.cpu().numpy())
        elif t == 0:
            mix = w @ z_hist[0]  # z^0 is consensus-shared; local compute
        else:
            mix = np.zeros((n, D), dtype=dt)
            for u in range(n):
                for m in neighbors[u] + [u]:
                    zm_t = recon[u, m, t]
                    zm_tm1 = recon[u, m, t - 1]
                    if np.isnan(zm_t).any() or np.isnan(zm_tm1).any():
                        raise ProtocolViolation(f"mixing at {u} needs {m}@{t}")
                    mix[u] += wt[u, m] * (2.0 * zm_t - zm_tm1)

        # ---- advance all nodes with the shared local update ----------------
        i_t = torch.as_tensor(np.asarray(indices[t]), dtype=torch.long, device=dev)
        state = step_fn(state, i_t, torch.as_tensor(mix, device=dev))
        z_hist[t + 1] = state.z.cpu().numpy()
        dg_log[t] = state.dg_prev.cpu().numpy()
        didx_log[t] = state.didx_prev.cpu().numpy()
        dval_log[t] = state.dval_prev.cpu().numpy()
        if tail:
            dtail_log[t] = state.dtail_prev.cpu().numpy()

        # ---- verify reconstructions against truth --------------------------
        if t >= 1:
            for u in range(n):
                for l in range(n):
                    if l == u:
                        continue
                    hi = int(s_next[u, l])
                    diff = recon[u, l, 1:hi] - z_hist[1:hi, l]
                    diff = diff[~np.isnan(diff)]
                    if diff.size:
                        recon_err = max(recon_err, float(np.abs(diff).max()))

    return SparseRunResult(
        z_trace=z_hist[: steps + 1],
        doubles_received=np.cumsum(doubles, axis=0),
        ints_received=np.cumsum(ints, axis=0),
        recon_max_err=recon_err,
        state=state,
    )


def run_sparse_many(*args, **kwargs):
    """The batched relay sweep (``solve_many``'s sparse path): not ported yet."""
    raise NotImplementedError(
        "run_sparse_many is not ported yet (ROADMAP Queue 1 item 8, with solve_many)"
    )


def sparse_doubles_per_iter(n_nodes: int, k: int, tail_dim: int) -> int:
    """Steady-state DOUBLEs received per node per iteration under DSBA-s."""
    return (n_nodes - 1) * (k + tail_dim)


def dense_doubles_per_iter(graph: Graph, d_total: int) -> np.ndarray:
    """Per-node DOUBLEs received per iteration with dense neighbor exchange."""
    return graph.degrees * d_total
