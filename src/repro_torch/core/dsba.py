"""DSBA — Decentralized Stochastic Backward Aggregation (port of ``repro.core.dsba``).

The node-local recursion of Algorithm 1 (eqs. 27-31), vectorized over all
N nodes, with the SAGA scalar table and sparse per-sample updates in
padded-CSR form. See the JAX module for the derivation of the exact l2
handling (rho = 1/(1 + alpha*lam)) and of DSA as the forward variant.

On CUDA tensors every per-node sparse operation of the step runs through
the hand-written kernels (``kernels.ops``): the gather-dot that feeds the
resolvent is ``sparse_dot``, and the head part of every sparse update is
``sparse_axpy`` (rho = 1 for psi and phibar, rho = 1/(1 + alpha*lam) with
coef = -a_eff*g for the DSBA iterate). A step calls ``sparse_axpy`` 4
times and ``sparse_dot`` once, for both methods. The tail coordinates stay
plain torch. The step keeps its step counter on the device and selects the
t = 0 branch with ``torch.where``, so it never waits on the device.

alpha and lam reach the step as tensors in the data dtype (``step_hp``, or
a (B,) batch of alphas from ``solve_many``), and every state tensor may
carry a leading batch axis: the kernels then take the B*N rows in one
launch, so a grid step launches what one run's step launches.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.mixing import w_tilde
from repro_torch.core.operators import OperatorSpec
from repro_torch.kernels.ops import dispatch


@dataclasses.dataclass
class DSBAState:
    """State of Algorithm 1 across all N nodes (tensors on one device)."""

    z: torch.Tensor  # (N, D)  current iterates, D = d + tail_dim
    z_prev: torch.Tensor  # (N, D)
    table_g: torch.Tensor  # (N, q)    SAGA scalar coefficients c_{n,i}
    table_tail: torch.Tensor  # (N, q, t) SAGA tail outputs (t = 0 or 3)
    phibar: torch.Tensor  # (N, D)    mean of table operator outputs
    dg_prev: torch.Tensor  # (N,)      delta^{t-1} coefficient
    didx_prev: torch.Tensor  # (N, k) int32  delta^{t-1} sparse pattern
    dval_prev: torch.Tensor  # (N, k)
    dtail_prev: torch.Tensor  # (N, t)
    step: torch.Tensor  # () int32


@dataclasses.dataclass(frozen=True)
class DSBAConfig:
    """Algorithm-1 step configuration (operator family, step size, reg)."""

    spec: OperatorSpec
    alpha: float  # step size
    lam: float | np.ndarray = 0.0  # l2 reg; (N,) = per-node personalization
    method: str = "dsba"  # 'dsba' (backward) | 'dsa' (forward, Remark 5.1)


def _axpy(vec, idx, val, coef, rho):
    """``sparse_axpy`` on the flattened rows of (*lead, N, ...) operands."""
    out = dispatch(
        "sparse_axpy", vec.reshape(-1, vec.shape[-1]), idx.reshape(-1, idx.shape[-1]),
        val.reshape(-1, val.shape[-1]), coef.reshape(-1), rho,
    )
    return out.reshape(vec.shape)


def init_state(cfg: DSBAConfig, data, z0: torch.Tensor) -> DSBAState:
    """phi^0_{n,i} = B_{n,i}(z^0) (Algorithm 1 line 1), delta^0 = 0.

    ``data`` is a ``convert.TensorDataset`` on z0's device. The phibar
    scatter of all q*k table entries is one ``sparse_axpy`` launch (on
    zeros, coef = rho = 1), which adds them in the JAX scatter's order.
    """
    spec = cfg.spec
    idx, val, y = data.idx, data.val, data.y
    n, q, k = idx.shape
    t = spec.tail_dim
    d = data.d
    if tuple(z0.shape) != (n, d + t):
        raise ValueError(f"z0 shape {tuple(z0.shape)} != {(n, d + t)}")
    dt, dev = z0.dtype, z0.device

    zg = torch.gather(z0[:, :d], 1, idx.reshape(n, q * k).long()).reshape(n, q, k)
    u = torch.einsum("nqk,nqk->nq", val, zg)
    tails = z0[:, None, d:].expand(n, q, t)
    g, tail_out = spec.coeff_and_tail(u, y, tails)

    ones = torch.ones((n,), dtype=dt, device=dev)
    phibar = _axpy(
        torch.zeros((n, d + t), dtype=dt, device=dev),
        idx.reshape(n, q * k),
        ((g[:, :, None] * val).reshape(n, q * k) / q).contiguous(),
        ones,
        ones,
    )
    if t:
        phibar[:, d:] = tail_out.mean(1)
    return DSBAState(
        z=z0,
        z_prev=z0,
        table_g=g,
        table_tail=tail_out,
        phibar=phibar,
        dg_prev=torch.zeros((n,), dtype=dt, device=dev),
        didx_prev=torch.zeros((n, k), dtype=idx.dtype, device=dev),
        dval_prev=torch.zeros((n, k), dtype=dt, device=dev),
        dtail_prev=torch.zeros((n, t), dtype=dt, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )


@dataclasses.dataclass(frozen=True)
class StepCoeffs:
    """The step's scalars from one run's (alpha, lam), on the device.

    ``alpha`` is a tensor of the batch shape ``lead`` (() for one run,
    (B,) for a ``solve_many`` grid) and ``lam`` a 0-d or, per node, an (N,)
    tensor, both in the data dtype: every product of two hyperparameters
    is taken on the device in that dtype, so one run alone and the same run
    inside a batch compute the same bits. The per-node fields have shape
    ``lead + (1,)`` (or ``lead + (N,)`` with per-node lam): they broadcast
    against (*lead, N) per-node vectors, and with one more trailing axis
    against (*lead, N, D) rows.
    """

    alpha: torch.Tensor
    neg_alpha: torch.Tensor
    alpha_scale: torch.Tensor  # alpha * (q - 1) / q
    al: torch.Tensor  # alpha * lam
    opal: torch.Tensor  # 1 + alpha * lam
    rho: torch.Tensor  # 1 / (1 + alpha * lam)
    neg_a_eff: torch.Tensor  # -(rho * alpha)
    a_eff: torch.Tensor
    rho_rows: torch.Tensor  # (R,) rho per kernel row, R = prod(lead) * M
    ones: torch.Tensor  # (R,)
    node: torch.Tensor  # (M,) global ids of the nodes this caller steps


def step_coeffs(alpha: torch.Tensor, lam: torch.Tensor, n: int, q: int,
                node: torch.Tensor | None = None) -> StepCoeffs:
    """``StepCoeffs`` for ``n`` nodes of ``q`` samples (see the class).

    ``node`` holds the global ids of the nodes the caller steps: all ``n``
    by default, one (its rank's) on a rank of the sharded backend, where
    the data stays the graph's N nodes and the step reads its rows.
    """
    lead = tuple(alpha.shape)
    if node is None:
        node = torch.arange(n, device=alpha.device)
    m = node.numel()
    a = alpha[..., None]
    al = a * lam
    opal = 1.0 + al
    rho = 1.0 / opal
    a_eff = rho * a
    rows = int(np.prod(lead, dtype=np.int64)) * m
    return StepCoeffs(
        alpha=a,
        neg_alpha=-a,
        alpha_scale=a * ((q - 1.0) / q),
        al=al,
        opal=opal,
        rho=rho,
        neg_a_eff=-a_eff,
        a_eff=a_eff,
        rho_rows=rho.expand(*lead, m).reshape(rows).contiguous(),
        ones=torch.ones((rows,), dtype=alpha.dtype, device=alpha.device),
        node=node,
    )


def xsq_table(data) -> torch.Tensor:
    """(N, q) squared norms of the sample rows, built once a dataset and
    kept in ``data.derived``: the step gathers its (N,) ``xsq`` from it, so
    a run's values do not depend on how many runs share the launch."""
    if "xsq" not in data.derived:
        data.derived["xsq"] = torch.sum(data.val * data.val, dim=-1)
    return data.derived["xsq"]


def dsba_step(
    cfg: DSBAConfig,
    data,
    state: DSBAState,
    i_t: torch.Tensor,
    mix_0: torch.Tensor,
    mix_t: torch.Tensor,
    c: StepCoeffs,
) -> DSBAState:
    """One iteration of Algorithm 1 on every node (of every run) at once.

    ``cfg`` gives the operator family and the method; the step sizes come
    from ``c`` (``step_coeffs``). ``data`` is a ``convert.TensorDataset``.
    The state's tensors carry a batch shape ``lead`` in front of the node
    axis (``lead = ()`` for one run): z is (*lead, N, D), the tables
    (*lead, N, q[, t]), the step counter ``lead``. i_t: (*lead, N) int64
    sample indices of this step. mix_0 and mix_t are the (*lead, N, D)
    neighbor-mixing terms: ``W @ Z`` for the t = 0 step (eq. 31) and
    ``W~ @ (2Z - Z_prev)`` for t >= 1 (eq. 29). ``make_hp_step_fn`` takes
    them through a comm backend; the sparse relay passes its reconstructed
    rows as both. The sparse kernels see the prod(lead) * N rows as one
    launch; every other operation is elementwise or a per-row gather, so a
    run's bits do not depend on the batch it rides in.
    """
    spec = cfg.spec
    q = data.idx.shape[1]
    t = spec.tail_dim
    d = state.z.shape[-1] - t
    idx_s = data.idx[c.node, i_t]  # (*lead, N, k)
    val_s = data.val[c.node, i_t]  # (*lead, N, k)
    y_s = data.y[c.node, i_t]  # (*lead, N)
    xsq = xsq_table(data)[c.node, i_t]  # (*lead, N); == 1 for normalized rows
    c_s = state.table_g.gather(-1, i_t[..., None])[..., 0]  # (*lead, N)
    t_idx = i_t[..., None, None].expand(*i_t.shape, 1, t)
    ct_s = state.table_tail.gather(-2, t_idx)[..., 0, :]  # (*lead, N, t)

    is0 = (state.step == 0)[..., None, None]

    def add_sparse(vec, idxs, vals, coef, tail, rho_rows=c.ones):
        """rho*vec + coef * x (+) tail, one launch over every row."""
        out = _axpy(vec, idxs, vals, coef, rho_rows)
        if t:
            out[..., d:] = out[..., d:] + tail
        return out

    # ---- psi (eq. 29 generalized; eq. 31 at t = 0) -------------------------
    psi_t = mix_t + c.al[..., None] * state.z
    psi_t = add_sparse(
        psi_t,
        state.didx_prev,
        state.dval_prev,
        c.alpha_scale * state.dg_prev,
        c.alpha_scale[..., None] * state.dtail_prev,
    )
    psi_0 = mix_0 - c.alpha[..., None] * state.phibar
    psi = torch.where(is0, psi_0, psi_t)
    psi = add_sparse(psi, idx_s, val_s, c.alpha * c_s, c.alpha[..., None] * ct_s)

    if cfg.method == "dsba":
        # backward step: z^{t+1} = J_{alpha B^lam_{n,i}}(psi)  (eq. 30);
        # the gather reads head columns only (idx < d), so psi needs no slice
        s = dispatch(
            "sparse_dot", psi.reshape(-1, psi.shape[-1]), idx_s.reshape(-1, idx_s.shape[-1]),
            val_s.reshape(-1, val_s.shape[-1]),
        ).reshape(y_s.shape)
        g_new, tail_z = spec.resolvent_coeff_and_tail(
            c.rho * s, c.rho[..., None] * psi[..., d:], y_s, c.a_eff, xsq
        )
        z_new = _axpy(psi, idx_s, val_s, c.neg_a_eff * g_new, c.rho_rows)
        if t:
            z_new[..., d:] = tail_z
        # operator outputs at the NEW point (for delta + table, Alg.1 l.7-8)
        u_new = c.rho * s - c.a_eff * g_new * xsq
        g_upd, tail_upd = spec.coeff_and_tail(u_new, y_s, tail_z)
    elif cfg.method == "dsa":
        # forward step: delta at z^t (eq. 32); no resolvent
        z = state.z
        u_cur = dispatch(
            "sparse_dot", z.reshape(-1, z.shape[-1]), idx_s.reshape(-1, idx_s.shape[-1]),
            val_s.reshape(-1, val_s.shape[-1]),
        ).reshape(y_s.shape)
        g_upd, tail_upd = spec.coeff_and_tail(u_cur, y_s, z[..., d:])
        lam_pt = torch.where(is0, z, 2.0 * z - state.z_prev)
        z_new = psi - c.al[..., None] * lam_pt
        z_new = add_sparse(z_new, idx_s, val_s, c.neg_alpha * g_upd,
                           c.neg_alpha[..., None] * tail_upd)
    else:
        raise ValueError(cfg.method)

    # ---- delta, table, phibar updates --------------------------------------
    dg = g_upd - c_s
    dtail = tail_upd - ct_s
    table_g = state.table_g.scatter(-1, i_t[..., None], g_upd[..., None])
    table_tail = state.table_tail.scatter(-2, t_idx, tail_upd[..., None, :])
    phibar = add_sparse(state.phibar, idx_s, val_s, dg / q, dtail / q)

    return DSBAState(
        z=z_new,
        z_prev=state.z,
        table_g=table_g,
        table_tail=table_tail,
        phibar=phibar,
        dg_prev=dg,
        didx_prev=idx_s,
        dval_prev=val_s,
        dtail_prev=dtail,
        step=state.step + 1,
    )


def step_hp(cfg: DSBAConfig, dtype, device) -> dict:
    """``cfg``'s (alpha, lam) as a step takes them: tensors in ``dtype`` on
    ``device`` (alpha 0-d; lam 0-d or, per node, (N,))."""
    return {
        "alpha": torch.tensor(float(cfg.alpha), dtype=dtype, device=device),
        "lam": torch.as_tensor(np.asarray(cfg.lam, dtype=np.float64), dtype=dtype,
                               device=device),
    }


def coeffs_memo(n: int, q: int, node: torch.Tensor | None = None):
    """``coeffs(hp) -> StepCoeffs`` that rebuilds only when handed another
    hp dict: a run passes one dict every step, so its coefficients are
    computed on the device once a run. ``node``: see ``step_coeffs``."""
    memo = {}

    def coeffs(hp) -> StepCoeffs:
        if memo.get("hp") is not hp:
            memo["hp"], memo["c"] = hp, step_coeffs(hp["alpha"], hp["lam"], n, q, node)
        return memo["c"]

    return coeffs


def make_hp_step_fn(cfg: DSBAConfig, data, w: np.ndarray, comm):
    """The local-update closure ``step(state, i_t, hp) -> state``.

    ``data`` is a ``convert.TensorDataset``; ``comm`` a ``core.comm``
    backend, through whose ``matvec`` both neighbor-mixing products run
    (the mixing matrices go to the device once). ``hp`` holds ``alpha``
    and ``lam`` as tensors (``step_hp``, or a batch of alphas from
    ``solve_many``); ``cfg``'s own values are not read. The step reads its
    nodes' data rows through ``comm.local``: every node on one device, the
    rank's own node under the sharded backend (the graph's N still sets
    the coefficients).
    """
    dt = data.val.dtype
    w_mix = comm.matvec(w, dt)
    wt_mix = comm.matvec(w_tilde(np.asarray(w)), dt)
    n = data.val.shape[0]
    node = comm.local(torch.arange(n, device=data.val.device))
    coeffs = coeffs_memo(n, data.val.shape[1], node)

    def step(state: DSBAState, i_t: torch.Tensor, hp) -> DSBAState:
        return dsba_step(
            cfg, data, state, i_t,
            w_mix(state.z), wt_mix(2.0 * state.z - state.z_prev), coeffs(hp),
        )

    return step


def make_step_fn(cfg: DSBAConfig, data, w: np.ndarray, comm):
    """``step(state, i_t) -> state`` with ``cfg``'s alpha and lam (see
    ``make_hp_step_fn``)."""
    step = make_hp_step_fn(cfg, data, w, comm)
    hp = step_hp(cfg, data.val.dtype, data.val.device)
    return lambda state, i_t: step(state, i_t, hp)


def draw_indices(steps: int, n_nodes: int, q: int, seed: int = 0) -> np.ndarray:
    """(steps, N) uniform sample indices — shared by dense and sparse runs."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, q, size=(steps, n_nodes)).astype(np.int32)


@dataclasses.dataclass
class RunResult:
    """Legacy result shape of `run` and the `core.baselines.run_*` shims."""

    state: DSBAState
    iters: np.ndarray  # iteration counts at record points
    dist2: np.ndarray  # mean_n ||z_n - z*||^2 (if z_star given)
    consensus: np.ndarray  # mean_n ||z_n - zbar||^2
    zs: np.ndarray | None  # optional snapshots (chunks, N, D)


def run(
    cfg: DSBAConfig,
    data,
    w: np.ndarray,
    steps: int,
    z0: np.ndarray | None = None,
    z_star: np.ndarray | None = None,
    record_every: int = 50,
    seed: int = 0,
    keep_snapshots: bool = False,
    indices: np.ndarray | None = None,
    device=None,
) -> RunResult:
    """Deprecated: ``core.solvers.solve(problem, method=cfg.method)``.

    Thin shim over the registry entrypoint, kept for legacy callers. The
    communication graph is recovered from the support of ``w`` (Section
    4's sparsity condition makes the two equivalent). Runs on CUDA unless
    the caller passes ``device="cpu"``.

    indices: optional (steps, N) pre-drawn sample indices (replayable runs).
    """
    from repro_torch.core import solvers
    from repro_torch.core.deprecation import warn_once

    warn_once(
        "dsba.run",
        "core.dsba.run is deprecated and will be REMOVED in v0.2 (final "
        "warning); use core.solvers.solve("
        f"problem, method={cfg.method!r}) instead",
        stacklevel=2,
    )
    problem = solvers.Problem(
        spec=cfg.spec,
        data=data,
        graph=solvers.graph_from_mixing(w),
        w=w,
        lam=cfg.lam,
        z_star=z_star,
    )
    res = solvers.solve(
        problem,
        method=cfg.method,
        comm="dense",
        steps=steps,
        record_every=record_every,
        seed=seed,
        z0=z0,
        indices=indices,
        keep_snapshots=keep_snapshots,
        device=device,
        alpha=cfg.alpha,
    )
    return RunResult(res.state, res.iters, res.dist2, res.consensus, res.zs)
