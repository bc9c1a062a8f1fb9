"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) blocks (counterpart
of ``repro.models.ssm``).

Training, scoring and prefill use the chunked SSD algorithm: the
within-chunk part is a masked attention-like product, the registry's
``ssd_chunk`` (the CUDA kernels on the card, their plain version on the
CPU; under ``cfg.ssm_kernel == "jnp"`` the inline einsums of the plain
version); the across-chunk state is a short recurrence, a Python loop over
chunks here where the JAX package scans. Decode is the O(1) recurrent
update of a (B, nh, dstate, headdim) state.

ngroups = 1 (B and C shared across heads) and a scalar decay A per head,
the standard Mamba2 configuration.

As in the JAX package: the convolutions run in the compute dtype with the
same term order; the SSD runs in float32 (float64 for float64 callers,
which take the inline path: the kernels are float32 only, exactly the JAX
package's routing); ``dt_bias``, ``A_log``, ``D`` and the norm scale are
read as float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as KO
from repro_torch.kernels.ref import ssd_chunk_ref
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import rms_norm, rms_norm_def
from repro_torch.models.params import ParamDef, TensorSpec


def ssm_defs(cfg: ModelConfig) -> dict:
    """One Mamba2 block's projections, convolution, decay and gated norm."""
    d, din, ds = cfg.d_model, cfg.ssm_d_inner, cfg.ssm_state
    nh, w = cfg.ssm_heads, cfg.ssm_conv_width
    return {
        "wz": ParamDef((d, din), ("embed", "ssm_inner")),
        "wx": ParamDef((d, din), ("embed", "ssm_inner")),
        "wB": ParamDef((d, ds), ("embed", None)),
        "wC": ParamDef((d, ds), ("embed", None)),
        "wdt": ParamDef((d, nh), ("embed", None)),
        "dt_bias": ParamDef((nh,), (None,), init="zeros"),
        "A_log": ParamDef((nh,), (None,), init="ones"),
        "D": ParamDef((nh,), (None,), init="ones"),
        "conv_x": ParamDef((w, din), (None, "ssm_inner"), scale=0.5),
        "conv_B": ParamDef((w, ds), (None, None), scale=0.5),
        "conv_C": ParamDef((w, ds), (None, None), scale=0.5),
        "norm": rms_norm_def(din),
        "wo": ParamDef((din, d), ("ssm_inner", "embed")),
    }


def _conv_sum(x: torch.Tensor, w: torch.Tensor, s_out: int) -> torch.Tensor:
    """sum_k x[:, k:k + s_out] * w[k], added in k order from 0 (Python's
    ``sum``, as the JAX package adds them)."""
    out = 0
    for k in range(w.shape[0]):
        out = out + x[:, k:k + s_out, :] * w[k]
    return out


def _causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, S, C), w (W, C) -> causal depthwise conv, silu activation."""
    xp = F.pad(x, (0, 0, w.shape[0] - 1, 0))
    return F.silu(_conv_sum(xp, w, x.shape[1]))


def _depthwise_conv_valid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """No-padding depthwise conv: (B, S, C), (W, C) -> (B, S - W + 1, C), silu."""
    return F.silu(_conv_sum(x, w, x.shape[1] - w.shape[0] + 1))


def _ssd_chunked(xh, dt, a_log, Bc, Cc, chunk, h0=None, head_block=0, kernel="jnp"):
    """Chunked SSD scan.

    xh (B, S, nh, hd) inputs per head; dt (B, S, nh) step sizes (after
    softplus); a_log (B, S, nh) per-step log-decay (dt * A, A < 0); Bc, Cc
    (B, S, ds) shared across heads; h0 an optional initial state
    (B, nh, ds, hd). ``head_block`` > 0 runs the heads in blocks of that
    size (the JAX memory lever: the (i, j) decay tile shrinks by
    nh / head_block). ``kernel`` is ``cfg.ssm_kernel``: ``jnp`` keeps the
    inline einsums, any registry mode dispatches the within-chunk part
    through ``ops.ssd_chunk`` (differentiable: the CUDA backward on the
    card). Returns y (B, S, nh, hd) and the final state (B, nh, ds, hd).
    """
    nh = xh.shape[2]
    if head_block and head_block < nh:
        if nh % head_block:
            raise ValueError(f"ssm_head_block {head_block} does not divide {nh} heads")
        ys, hs = [], []
        for lo in range(0, nh, head_block):
            hb = slice(lo, lo + head_block)
            y_b, h_b = _ssd_chunked(xh[:, :, hb], dt[:, :, hb], a_log[:, :, hb], Bc, Cc, chunk,
                                    h0=None if h0 is None else h0[:, hb], kernel=kernel)
            ys.append(y_b)
            hs.append(h_b)
        return torch.cat(ys, dim=2), torch.cat(hs, dim=1)
    Bsz, S_in, nh, hd = xh.shape
    ds = Bc.shape[-1]
    Q = min(chunk, S_in)
    pad = (-S_in) % Q
    if pad:
        # zero padding: dt = 0 gives decay 1 and contribution 0, so the state is exact
        def zp(t):
            return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))

        xh, dt, a_log, Bc, Cc = map(zp, (xh, dt, a_log, Bc, Cc))
    S = S_in + pad
    nc = S // Q

    # at least float32 internally; float64 callers keep float64
    f32 = torch.promote_types(xh.dtype, torch.float32)
    xdt = (xh * dt[..., None]).to(f32).reshape(Bsz, nc, Q, nh, hd)
    al = a_log.to(f32).reshape(Bsz, nc, Q, nh)
    Bc_ = Bc.to(f32).reshape(Bsz, nc, Q, ds)
    Cc_ = Cc.to(f32).reshape(Bsz, nc, Q, ds)

    cum = torch.cumsum(al, dim=2)  # (B, nc, Q, nh), inclusive
    if kernel != "jnp" and f32 == torch.float32:
        y_intra, states = KO.ssd_chunk(xdt.contiguous(), cum.contiguous(), Bc_.contiguous(),
                                       Cc_.contiguous(), mode=kernel)
    else:
        y_intra, states = ssd_chunk_ref(xdt, cum, Bc_, Cc_)

    # across chunks: h_c = exp(cum_last) h_{c-1} + state_c; each chunk reads
    # the state before it
    total = torch.exp(cum[:, :, -1, :])  # (B, nc, nh)
    h = torch.zeros((Bsz, nh, ds, hd), dtype=f32, device=xh.device) if h0 is None else h0.to(f32)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = total[:, c, :, None, None] * h + states[:, c]
    h_prev = torch.stack(h_prevs, dim=1)  # (B, nc, nh, ds, hd)
    y_inter = torch.einsum("bcis,bchsd->bcihd", Cc_, h_prev) * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, S, nh, hd)[:, :S_in]
    return y, h


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it (``logaddexp(x, 0)``)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssm_block(cfg: ModelConfig, p: dict, x: torch.Tensor, *, cache: dict | None = None,
              valid_len: torch.Tensor | None = None) -> tuple[torch.Tensor, dict | None]:
    """One Mamba2 mixer on x (B, S, d_model) -> (out (B, S, d_model), new cache).

    Without a cache: the chunked scan from a zero state (train, scoring).
    With a cache {'state': (B, nh, ds, hd) float32, 'conv': (B, W - 1, C)}:
    S > 1 is a prefill from the cached state (``valid_len`` (B,) marks
    right-padded rows: pad steps get dt = 0, exact identity updates, and
    each row's conv history is taken at its own valid_len), S = 1 the
    recurrent step. The new cache is returned as new tensors; the caller
    writes them where it keeps the cache.
    """
    dt_c = cfg.compute_dtype
    B, S, _ = x.shape
    din, ds, nh, hd = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    W = cfg.ssm_conv_width
    xc = x.to(dt_c)

    z = xc @ p["wz"].to(dt_c)  # gate
    xi = xc @ p["wx"].to(dt_c)
    Bc = xc @ p["wB"].to(dt_c)
    Cc = xc @ p["wC"].to(dt_c)
    dt_raw = xc @ p["wdt"].to(dt_c)

    conv_in = torch.cat([xi, Bc, Cc], dim=-1)  # (B, S, din + 2 ds)
    conv_w = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1).to(dt_c)

    new_cache = None
    if cache is None:
        conv_out = _causal_depthwise_conv(conv_in, conv_w)
    else:
        # prepend the conv history (prefill S > 1 and decode S = 1 alike)
        conv_full = torch.cat([cache["conv"].to(dt_c), conv_in], dim=1)
        conv_out = _depthwise_conv_valid(conv_full, conv_w)  # (B, S, C)
        if valid_len is None:
            new_conv = conv_full[:, -(W - 1):]
        else:
            # right-padded prefill: token t sits at conv_full row W - 1 + t,
            # so a row's history window is rows [valid_len, valid_len + W - 1)
            rows = torch.as_tensor(valid_len, device=x.device).long()[:, None] + torch.arange(
                W - 1, device=x.device)
            new_conv = torch.take_along_dim(conv_full, rows[:, :, None], dim=1)

    xi, Bc, Cc = conv_out[..., :din], conv_out[..., din:din + ds], conv_out[..., din + ds:]
    xh = xi.reshape(B, S, nh, hd)
    dt = _softplus(dt_raw.float() + p["dt_bias"].float())
    if valid_len is not None and cache is not None and S > 1:
        # pad steps become exact identity updates (decay exp(0) = 1,
        # contribution 0): the state equals processing valid_len tokens
        keep = torch.arange(S, device=x.device)[None, :] < torch.as_tensor(
            valid_len, device=x.device)[:, None]
        dt = torch.where(keep[..., None], dt, 0.0)
    A = -torch.exp(p["A_log"].float())  # (nh,), negative
    a_log = dt * A[None, None, :]

    if cache is None:
        y, _ = _ssd_chunked(xh, dt, a_log, Bc, Cc, cfg.ssm_chunk,
                            head_block=cfg.ssm_head_block, kernel=cfg.ssm_kernel)
    elif S == 1:
        # recurrent step: h = exp(dt A) h + B (x) (dt x);  y = C . h
        h = cache["state"].float()
        xdt = xh[:, 0].float() * dt[:, 0, :, None]
        h = torch.exp(a_log[:, 0])[:, :, None, None] * h + torch.einsum(
            "bs,bhd->bhsd", Bc[:, 0].float(), xdt)
        y = torch.einsum("bs,bhsd->bhd", Cc[:, 0].float(), h)[:, None]
        new_cache = {"state": h, "conv": new_conv}
    else:
        # prefill with a cache: the chunked scan from the cached state
        y, h_final = _ssd_chunked(xh, dt, a_log, Bc, Cc, cfg.ssm_chunk, h0=cache["state"],
                                  head_block=cfg.ssm_head_block, kernel=cfg.ssm_kernel)
        new_cache = {"state": h_final.float(), "conv": new_conv}

    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(B, S, din).to(dt_c)
    y = rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)  # gated norm
    return y @ p["wo"].to(dt_c), new_cache


def ssm_cache_defs(cfg: ModelConfig, batch: int) -> dict:
    """TensorSpecs of ONE ssm block's decode cache: the recurrent state
    (float32) and the conv history (the compute dtype)."""
    C = cfg.ssm_d_inner + 2 * cfg.ssm_state
    return {
        "state": TensorSpec((batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
                            torch.float32),
        "conv": TensorSpec((batch, cfg.ssm_conv_width - 1, C), cfg.compute_dtype),
    }


def init_ssm_cache(cfg: ModelConfig, batch: int, device) -> dict:
    """A zeroed decode cache of one ssm block on `device`."""
    return {name: torch.zeros(s.shape, dtype=s.dtype, device=device)
            for name, s in ssm_cache_defs(cfg, batch).items()}
