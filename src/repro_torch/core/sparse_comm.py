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
  top of the local step's 4 + 1 launches, for one run or a batch.
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

The relay's device data, mixing matrices and protocol tables are built
once per (method, problem, graph, W, ``verify``, faulty, device) in the
runner cache (``core.runner_cache.SPARSE``); alpha and lam are call
arguments. ``run_sparse_many`` (the batched sweep behind ``solve_many``)
advances B relays in lockstep on the same runner: every carry tensor gains
a leading B axis, a step's sparse kernels take the B*N rows in one launch,
and each run's bits are its own ``run_sparse``'s.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import _flatten_with_paths, _unflatten
from repro_torch.convert import dataset_to_torch
from repro_torch.core import runner_cache
from repro_torch.core.dsba import (
    DSBAConfig, DSBAState, coeffs_memo, dsba_step, init_state, step_coeffs, step_hp,
)
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
    """sum_a wts[:, a] * (2 R[.., j_cur, obs, nbr[:, a]] - R[.., j_prev, obs, nbr[:, a]]).

    ``R`` may carry a batch shape in front of the ring axis. The JAX
    engine's add order (one neighbor slot at a time).
    """
    acc = R.new_zeros(R.shape[:-4] + (obs.shape[0], R.shape[-1]))
    for a in range(nbr.shape[1]):
        m = nbr[:, a]
        acc = acc + wts[:, a, None] * (2.0 * R[..., j_cur, obs, m, :] - R[..., j_prev, obs, m, :])
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

    The vectorized engine's device data and protocol tables come from the
    relay runner cache (``core.runner_cache.SPARSE``): alpha and lam are
    call arguments, so a sweep over them reuses one runner.
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


@dataclasses.dataclass
class _Relay:
    """One cached relay runner: the dataset, the mixing matrices and the
    protocol tables on the device, and the step's coefficient memo."""

    tdata: object  # convert.TensorDataset
    tb: _Tables
    w_t: torch.Tensor
    wt_t: torch.Tensor
    iu: torch.Tensor
    nbr: torch.Tensor
    wtn: torch.Tensor
    padm: torch.Tensor
    waves: list  # [(xi, observers, sources)] farthest first
    floods: dict  # t -> (observers, sources) at distance t
    coeffs: object  # dsba.coeffs_memo
    traced: bool = False  # the sequential scan's trace has been counted


def _sparse_scan_key(cfg, data, graph, w, verify, faulty, device):
    """(key, guards) for one relay runner (see core.runner_cache).

    alpha/lam are NOT keyed: they are call arguments, so a hyperparameter
    sweep over the same (method, problem shape, graph, device) reuses one
    runner. ``verify`` and ``faulty`` enter the key as the JAX package's
    (they change its carry and its inputs).
    """
    key = (
        "relay",
        cfg.method,
        runner_cache.problem_fingerprint(data, cfg.spec, graph, w, device),
        bool(verify),
        bool(faulty),
    )
    return key, (data,)


def _get_relay(cfg, data, graph, w, verify, faulty, dev, *, batched=False) -> _Relay:
    """Fetch (or build) the relay runner for this problem on ``dev``.

    The cache's entries and traces follow the JAX package's, which compiles
    its sequential scan at the first call and keeps the batched (vmapped)
    scan of ``run_sparse_many`` under a ``("batched", key)`` entry of its
    own, guarded alike, compiled at its first call. Here the first
    sequential use of a runner notes one trace; with `batched` the runner
    is looked up under both keys (the batched entry holds the same runner)
    and building the batched entry notes one.
    """
    key, guards = _sparse_scan_key(cfg, data, graph, w, verify, faulty, dev)

    def build() -> _Relay:
        tdata = dataset_to_torch(data, dev)
        dt = tdata.val.dtype
        tb = _protocol_tables(graph, w_tilde(w))

        def on_dev(a, dtype=torch.long):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        return _Relay(
            tdata=tdata, tb=tb, w_t=on_dev(w, dt), wt_t=on_dev(w_tilde(w), dt),
            iu=torch.arange(data.n_nodes, device=dev), nbr=on_dev(tb.nbr_pad),
            wtn=on_dev(tb.wt_pad, dt), padm=on_dev(tb.pad_mask, torch.bool),
            waves=[(xi, on_dev(tb.pairs[xi][0]), on_dev(tb.pairs[xi][1]))
                   for xi in range(tb.dmax, 0, -1)],
            floods={t: tuple(on_dev(a) for a in np.nonzero(tb.dist == t))
                    for t in range(1, tb.dmax + 1)},
            coeffs=coeffs_memo(data.n_nodes, data.q),
        )

    rl = runner_cache.SPARSE.get_or_build(key, guards, build)
    if batched:
        def build_batched() -> _Relay:
            runner_cache.SPARSE.note_trace()  # build-time only
            return rl

        return runner_cache.SPARSE.get_or_build(("batched", key), guards, build_batched)
    if not rl.traced:
        runner_cache.SPARSE.note_trace()
        rl.traced = True
    return rl


def _relay_hp(alpha, lam: float, dt, dev) -> dict:
    """The step's hp dict: alpha (0-d, or (B,) for a batch) and lam, as
    tensors in the data dtype."""
    return {"alpha": torch.as_tensor(np.asarray(alpha, dtype=np.float64), dtype=dt, device=dev),
            "lam": torch.tensor(float(lam), dtype=dt, device=dev)}


def _relay_carry0(rl: _Relay, state, z0_t, lead, verify):
    """The relay's initial carry for runs of batch shape ``lead``, all at the
    shared starting point ``z0_t`` (N, D): ``state`` is the solver state
    (batched already), R's slot 0 every observer's copy of z^0."""
    n, D = z0_t.shape
    depth = rl.tb.depth
    dt, dev = z0_t.dtype, z0_t.device
    R = torch.zeros(lead + (depth, n, n, D), dtype=dt, device=dev)
    R[..., 0, :, :, :] = z0_t
    DD = torch.zeros(lead + (depth, n, D), dtype=dt, device=dev)
    z1 = torch.zeros(lead + (n, D), dtype=dt, device=dev)
    if verify:
        SR = torch.full(lead + (depth, n, n), -(2**30), dtype=torch.int32, device=dev)
        SR[..., 0, :, :] = 0
        Z = torch.zeros(lead + (depth, n, D), dtype=dt, device=dev)
        Z[..., 0, :, :] = z0_t
    else:  # zero-size placeholders keep the checkpointed carry's layout
        SR = torch.zeros((0,), dtype=torch.int32, device=dev)
        Z = torch.zeros((0,), dtype=dt, device=dev)
    err = torch.zeros(lead, dtype=dt, device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    return state, z1, R, DD, SR, Z, err, ok


def _relay_step(cfg, rl: _Relay, carry, t, i_t, mix0, hp, verify, sent_t=None):
    """Iteration ``t`` of the relay for every run of the carry's batch:
    returns (carry, z^{t+1}, the nnz log row)."""
    state, z1, R, DD, SR, Z, err, ok = carry
    tb = rl.tb
    depth, dmax = tb.depth, tb.dmax
    iu, nbr, wtn, padm = rl.iu, rl.nbr, rl.wtn, rl.padm
    c = rl.coeffs(hp)
    scale = (rl.tdata.val.shape[1] - 1.0) / rl.tdata.val.shape[1]
    a3, al3, opal3 = c.alpha[..., None], c.al[..., None], c.opal[..., None]
    jt, jtm1 = t % depth, (t - 1) % depth
    z_t = state.z
    # -- own history: z^t is exact and free (computed locally last step)
    R[..., jt, iu, iu, :] = z_t
    if verify:
        SR[..., jt, iu, iu] = t
        Z[..., jt, :, :] = z_t
    if t == 1:
        z1 = z_t

    # -- one-time dense z^1 warm-up flood arrives at t == xi ----------------
    if 1 <= t <= dmax:
        fu, fl = rl.floods[t]
        R[..., 1, fu, fl, :] = z1[..., fl, :]
        if verify:
            SR[..., 1, fu, fl] = 1

    # -- reconstruction waves, farthest-first (paper's V_j ordering) --------
    for xi, up, lp in rl.waves:
        if t < xi + 1:
            continue  # these pairs are still in warm-up
        s = t + 1 - xi
        j1, j2, jn = (s - 1) % depth, (s - 2) % depth, s % depth
        m_idx = nbr[lp]  # (P, A)
        mix = _neighborhood_sum(R, j1, j2, up, m_idx, wtn[lp])
        corr = a3 * (scale * DD[..., j2, lp, :] - DD[..., j1, lp, :])
        self1 = R[..., j1, up, lp, :]
        if cfg.method == "dsba":
            new = (mix + al3 * self1 + corr) / opal3
        else:  # dsa
            self2 = R[..., j2, up, lp, :]
            new = mix + corr - al3 * (self1 - self2)
        R[..., jn, up, lp, :] = new
        if verify:
            S1 = SR[..., j1, up[:, None], m_idx]
            S2 = SR[..., j2, up[:, None], m_idx]
            reads = (S1 == s - 1) & (S2 == s - 2)
            ok = ok & torch.where(padm[lp], reads, True).all()
            SR[..., jn, up, lp] = s
            err = torch.maximum(err, (new - Z[..., jn, lp, :]).abs().amax(dim=(-2, -1)))

    # -- mixing rows from each node's OWN reconstruction store --------------
    if t == 0:
        mix_rows = mix0
    else:
        mix_rows = _neighborhood_sum(R, jt, jtm1, iu, nbr, wtn)
        if verify:
            s_cur = SR[..., jt, iu[:, None], nbr]
            s_prev = SR[..., jtm1, iu[:, None], nbr]
            fresh = (s_cur == t) & (s_prev == t - 1)
            ok = ok & torch.where(padm, fresh, True).all()

    # -- advance all nodes with the shared local update ---------------------
    state = dsba_step(cfg, rl.tdata, state, i_t, mix_rows, mix_rows, c)
    base = torch.zeros_like(state.z)
    d = rl.tdata.d
    if base.shape[-1] > d:
        base[..., d:] = state.dtail_prev
    dd = dispatch(
        "sparse_axpy", base.reshape(-1, base.shape[-1]),
        state.didx_prev.reshape(-1, state.didx_prev.shape[-1]),
        state.dval_prev.reshape(-1, state.dval_prev.shape[-1]),
        state.dg_prev.reshape(-1), c.ones,
    ).reshape(base.shape)
    nnz_t = (state.dval_prev != 0).sum(-1)
    if sent_t is not None:
        # a suppressed broadcast: observers see a zeroed delta and the nnz
        # log drops the row; the source's own row of R stays exact
        dd = torch.where(sent_t[:, None], dd, 0.0)
        nnz_t = torch.where(sent_t, nnz_t, 0)
    DD[..., jt, :, :] = dd
    return (state, z1, R, DD, SR, Z, err, ok), state.z, nnz_t


def _run_vectorized(
    cfg, data, graph, w, steps, indices, z0, *, state0, verify, sent_mask,
    ckpt_every, ckpt_save, resume, device,
) -> SparseRunResult:
    dev = resolve_device(device)
    n = data.n_nodes
    tail = cfg.spec.tail_dim
    D = data.d + tail
    restart = state0 is not None
    if sent_mask is not None:
        sent_mask = np.asarray(sent_mask, dtype=bool)
        if sent_mask.shape != (steps, n):
            raise ValueError(
                f"sent_mask must be (steps, N) = ({steps}, {n}), "
                f"got {sent_mask.shape}"
            )
    rl = _get_relay(cfg, data, graph, w, verify, sent_mask is not None, dev)
    tdata = rl.tdata
    dt = tdata.val.dtype
    hp = _relay_hp(cfg.alpha, cfg.lam, dt, dev)

    if restart:
        state = state0
        z0_t = state0.z
        if int(state0.step) == 0:
            # a churn-remapped state, reanchored: the first step re-runs
            # the eq. 31 anchored update, mixing W against its iterates
            mix0 = rl.w_t @ z0_t
        else:
            # a carried state: the eq. 29 psi path mixes W~ against
            # (2 z - z_prev) of the carried iterates
            mix0 = rl.wt_t @ (2.0 * z0_t - state0.z_prev)
    else:
        z0 = np.zeros((n, D), dtype=data.val.dtype) if z0 is None else np.asarray(z0)
        z0_t = torch.as_tensor(z0, dtype=dt, device=dev)
        state = init_state(cfg, tdata, z0_t)
        mix0 = rl.w_t @ z0_t  # t = 0: z^0 is consensus-shared
    idx_t = torch.as_tensor(np.asarray(indices)[:steps], dtype=torch.long, device=dev)
    sent_t = None if sent_mask is None else torch.as_tensor(sent_mask, device=dev)
    carry = _relay_carry0(rl, state, z0_t, (), verify)

    start = 0
    zs_host, nnz_host = [], []  # numpy chunks of the (zs, nnzs) logs
    zs, nnzs = [], []  # device rows since the last flush
    if resume is not None:
        t_done, leaves = resume
        if not 0 < t_done <= steps:
            raise ValueError(f"resume step {t_done} outside (0, {steps}]")
        carry = _carry_from_leaves(carry, leaves)
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
        carry, z_next, nnz_t = _relay_step(
            cfg, rl, carry, t, idx_t[t], mix0, hp, verify,
            None if sent_t is None else sent_t[t])
        zs.append(z_next)
        nnzs.append(nnz_t)
        if t + 1 in saves:
            flush()
            ckpt_save(t + 1, {
                "carry": carry,
                "zs": np.concatenate(zs_host),
                "nnzs": np.concatenate(nnz_host),
            })

    state, err, ok = carry[0], carry[-2], carry[-1]
    if verify and not bool(ok):
        raise ProtocolViolation(
            "relay schedule consumed a value before its arrival"
        )
    flush()
    z_trace = np.concatenate([z0_t.cpu().numpy()[None], *zs_host])
    nnz_log = np.concatenate(nnz_host).astype(np.int64)
    doubles, ints = _closed_form_costs(
        nnz_log, rl.tb.dist, tail, D, restart=restart, sent=sent_mask)
    return SparseRunResult(
        z_trace=z_trace,
        doubles_received=doubles,
        ints_received=ints,
        recon_max_err=float(err) if verify else float("nan"),
        state=state,
    )


def batch_tree(tree, b: int):
    """Every tensor leaf of a state (a dataclass or a tuple) repeated ``b``
    times along a new leading axis, each its own contiguous copy; host
    numbers (step counters) stay as they are."""
    def one(x):
        if isinstance(x, torch.Tensor):
            return x.expand(b, *x.shape).contiguous()
        return x

    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: one(getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    return tuple(one(x) for x in tree)


def run_sparse_many(
    cfg: DSBAConfig,
    data,
    graph: Graph,
    w: np.ndarray,
    steps: int,
    indices: np.ndarray,
    alphas,
    z0: np.ndarray | None = None,
    *,
    verify: bool = False,
    device=None,
) -> list[SparseRunResult]:
    """Run B relays in lockstep: per-run sample streams and alphas.

    ``indices`` is (B, >= steps, N), one sample stream per run, and
    ``alphas`` a length-B sequence of step sizes (``cfg.alpha`` is not
    read; ``cfg.lam`` and ``cfg.method`` are shared). The runs share the
    relay runner ``run_sparse`` uses (looked up under its key and under
    ``("batched", key)``, as the JAX package does), and every carry
    tensor (the solver state, R, DD and with ``verify`` SR and Z) gains a
    leading B axis: the waves, floods and neighbourhood sums index it the
    same way, and each step's two sparse kernels take the B*N rows in one
    launch. Each run's bits are those of its own ``run_sparse`` (the
    mixing sums and kernels work row by row), and the per-run message
    accounting is the closed form over its nnz log after the loop.

    The starting point ``z0`` is shared across runs (it is consensus
    state, not a sweep axis). Returns one SparseRunResult per run.
    """
    if steps < 1:
        raise ValueError("steps must be >= 1")
    if np.ndim(cfg.lam) > 0:
        raise ValueError("the sparse relay takes a scalar lam")
    dev = resolve_device(device)
    n = data.n_nodes
    tail = cfg.spec.tail_dim
    D = data.d + tail
    B = len(alphas)
    indices = np.asarray(indices)
    if indices.ndim != 3 or indices.shape[0] != B or indices.shape[1] < steps:
        raise ValueError(
            f"indices must be (B, >= steps, N) = ({B}, >={steps}, {n}), "
            f"got {indices.shape}"
        )
    z0 = np.zeros((n, D), dtype=data.val.dtype) if z0 is None else np.asarray(z0)
    rl = _get_relay(cfg, data, graph, w, verify, False, dev, batched=True)
    dt = rl.tdata.val.dtype
    hp = _relay_hp(list(alphas), cfg.lam, dt, dev)
    z0_t = torch.as_tensor(z0, dtype=dt, device=dev)
    state = batch_tree(init_state(cfg, rl.tdata, z0_t), B)
    mix0 = (rl.w_t @ z0_t).expand(B, n, D)  # t = 0: z^0 is consensus-shared
    # (steps, B, N): row t is every run's draw of iteration t
    idx_t = torch.as_tensor(
        np.ascontiguousarray(indices[:, :steps].transpose(1, 0, 2)),
        dtype=torch.long, device=dev)
    carry = _relay_carry0(rl, state, z0_t, (B,), verify)
    zs, nnzs = [], []
    for t in range(steps):
        carry, z_next, nnz_t = _relay_step(cfg, rl, carry, t, idx_t[t], mix0, hp, verify)
        zs.append(z_next)
        nnzs.append(nnz_t)
    err, ok = carry[-2], carry[-1]
    if verify and not bool(ok):
        raise ProtocolViolation(
            "relay schedule consumed a value before its arrival"
        )
    zs_h = torch.stack(zs).cpu().numpy()  # (T, B, N, D)
    nnz_h = torch.stack(nnzs).cpu().numpy().astype(np.int64)  # (T, B, N)
    err_h = err.cpu().numpy()
    out = []
    for b in range(B):
        doubles, ints = _closed_form_costs(nnz_h[:, b], rl.tb.dist, tail, D)
        out.append(SparseRunResult(
            z_trace=np.concatenate([z0[None], zs_h[:, b]]),
            doubles_received=doubles,
            ints_received=ints,
            recon_max_err=float(err_h[b]) if verify else float("nan"),
        ))
    return out


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

    hp = step_hp(cfg, tdata.val.dtype, dev)
    coeffs = step_coeffs(hp["alpha"], hp["lam"], n, q)
    state = state0 if restart else init_state(
        cfg, tdata, torch.as_tensor(z0, dtype=tdata.val.dtype, device=dev))

    def step_fn(st, i_t, mix):
        return dsba_step(cfg, tdata, st, i_t, mix, mix, coeffs)

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


def sparse_doubles_per_iter(n_nodes: int, k: int, tail_dim: int) -> int:
    """Steady-state DOUBLEs received per node per iteration under DSBA-s."""
    return (n_nodes - 1) * (k + tail_dim)


def dense_doubles_per_iter(graph: Graph, d_total: int) -> np.ndarray:
    """Per-node DOUBLEs received per iteration with dense neighbor exchange."""
    return graph.degrees * d_total
