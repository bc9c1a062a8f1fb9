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
    return dispatch("sparse_axpy", vec, idx, val, coef, rho)


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


def dsba_step(
    cfg: DSBAConfig,
    data_idx: torch.Tensor,
    data_val: torch.Tensor,
    data_y: torch.Tensor,
    state: DSBAState,
    i_t: torch.Tensor,
    mix_0: torch.Tensor,
    mix_t: torch.Tensor,
) -> DSBAState:
    """One iteration of Algorithm 1 on every node simultaneously.

    i_t: (N,) int64 sample indices of this step. mix_0 and mix_t are the
    (N, D) neighbor-mixing terms: ``W @ Z`` for the t = 0 step (eq. 31) and
    ``W~ @ (2Z - Z_prev)`` for t >= 1 (eq. 29). ``make_step_fn`` takes them
    through a comm backend; the sparse relay passes its reconstructed rows
    as both. ``cfg`` comes from ``device_config``.
    """
    spec, alpha, lam = cfg.spec, cfg.alpha, cfg.lam
    n, q, k = data_idx.shape
    t = spec.tail_dim
    d = state.z.shape[1] - t
    dt, dev = state.z.dtype, state.z.device
    per_node = isinstance(lam, torch.Tensor)
    lam_col = lam[:, None] if per_node else lam
    rho = 1.0 / (1.0 + alpha * lam)
    a_eff = rho * alpha
    ones = torch.ones((n,), dtype=dt, device=dev)
    rows = torch.arange(n, device=dev)
    idx_s = data_idx[rows, i_t]  # (N, k)
    val_s = data_val[rows, i_t]  # (N, k)
    y_s = data_y[rows, i_t]  # (N,)
    c_s = state.table_g[rows, i_t]  # (N,)
    ct_s = state.table_tail[rows, i_t]  # (N, t)

    is0 = state.step == 0

    def add_sparse(vec, idxs, vals, coef, tail, rho_vec=ones):
        """rho*vec + coef * x (+) tail, batched over nodes."""
        out = _axpy(vec, idxs, vals, coef, rho_vec)
        if t:
            out[:, d:] = out[:, d:] + tail
        return out

    # ---- psi (eq. 29 generalized; eq. 31 at t = 0) -------------------------
    scale = (q - 1.0) / q
    psi_t = mix_t + alpha * lam_col * state.z
    psi_t = add_sparse(
        psi_t,
        state.didx_prev,
        state.dval_prev,
        alpha * scale * state.dg_prev,
        alpha * scale * state.dtail_prev,
    )
    psi_0 = mix_0 - alpha * state.phibar
    psi = torch.where(is0, psi_0, psi_t)
    psi = add_sparse(psi, idx_s, val_s, alpha * c_s, alpha * ct_s)

    xsq = torch.sum(val_s * val_s, dim=-1)  # == 1 for normalized rows

    if cfg.method == "dsba":
        # backward step: z^{t+1} = J_{alpha B^lam_{n,i}}(psi)  (eq. 30);
        # the gather reads head columns only (idx < d), so psi needs no slice
        s = dispatch("sparse_dot", psi, idx_s, val_s)
        rho_col = rho[:, None] if per_node else rho
        g_new, tail_z = spec.resolvent_coeff_and_tail(
            rho * s, rho_col * psi[:, d:], y_s, a_eff, xsq
        )
        rho_vec = rho if per_node else torch.full((n,), rho, dtype=dt, device=dev)
        z_new = _axpy(psi, idx_s, val_s, -a_eff * g_new, rho_vec)
        if t:
            z_new[:, d:] = tail_z
        # operator outputs at the NEW point (for delta + table, Alg.1 l.7-8)
        u_new = rho * s - a_eff * g_new * xsq
        g_upd, tail_upd = spec.coeff_and_tail(u_new, y_s, tail_z)
    elif cfg.method == "dsa":
        # forward step: delta at z^t (eq. 32); no resolvent
        u_cur = dispatch("sparse_dot", state.z, idx_s, val_s)
        g_upd, tail_upd = spec.coeff_and_tail(u_cur, y_s, state.z[:, d:])
        lam_pt = torch.where(is0, state.z, 2.0 * state.z - state.z_prev)
        z_new = psi - alpha * lam_col * lam_pt
        z_new = add_sparse(z_new, idx_s, val_s, -alpha * g_upd, -alpha * tail_upd)
    else:
        raise ValueError(cfg.method)

    # ---- delta, table, phibar updates --------------------------------------
    dg = g_upd - c_s
    dtail = tail_upd - ct_s
    table_g = state.table_g.clone()
    table_g[rows, i_t] = g_upd
    table_tail = state.table_tail.clone()
    table_tail[rows, i_t] = tail_upd
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


def device_config(cfg: DSBAConfig, dtype, device) -> DSBAConfig:
    """``cfg`` as ``dsba_step`` takes it: a float ``alpha``, and ``lam`` a
    float or, per node, an (N,) tensor on ``device``."""
    if np.ndim(cfg.lam) > 0:
        lam = torch.as_tensor(np.asarray(cfg.lam), dtype=dtype, device=device)
    else:
        lam = float(cfg.lam)
    return dataclasses.replace(cfg, alpha=float(cfg.alpha), lam=lam)


def make_step_fn(cfg: DSBAConfig, data, w: np.ndarray, comm):
    """The local-update closure ``step(state, i_t) -> state``.

    ``data`` is a ``convert.TensorDataset``; ``comm`` a ``core.comm``
    backend, through whose ``matvec`` both neighbor-mixing products run
    (the mixing matrices go to the device once).
    """
    dt, dev = data.val.dtype, data.val.device
    cfg = device_config(cfg, dt, dev)
    w_mix = comm.matvec(w, dt)
    wt_mix = comm.matvec(w_tilde(np.asarray(w)), dt)

    def step(state: DSBAState, i_t: torch.Tensor) -> DSBAState:
        return dsba_step(
            cfg, data.idx, data.val, data.y, state, i_t,
            w_mix(state.z), wt_mix(2.0 * state.z - state.z_prev),
        )

    return step


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
