"""Pod-axis decentralized training: DSBA gossip between model replicas
(counterpart of ``repro.core.gossip``).

Each pod is a graph node with its own model replica and data shard; pods
exchange parameter information with graph neighbours only, optionally as a
sparse (values, int32 indices) difference stream. Modes, as in the JAX
package:

  allreduce  synchronous data parallelism: the pods' gradients averaged
  dsgd       theta <- Adam(W~ theta, g): Adam-preconditioned gossip SGD
  dsba       the paper's update, eq. (28):
               theta^{t+1} = W~ (2 theta^t - theta^{t-1}) - lr (g_t - g_{t-1})
             at a constant lr (a warmup schedule breaks the g_t - g_{t-1}
             telescoping)

Compression (``topk`` exact global top-k, ``block_topk`` top-k_b per
``block_size`` chunk through the ``block_topk`` kernel): CHOCO
reconstruction gossip. Each pod keeps a reconstruction theta_hat of every
stream it hears (its own and one per neighbour direction), sends only the
top-k of |theta - theta_hat| and applies
theta <- theta + gamma sum_m w~_pm (theta_hat_m - theta_hat_p). The wire
holds nb * k_b * (4 + 4) bytes a leaf per pod (``wire_bytes_per_pod``):
the paper's O(rho d) communication.

The pods live on one device: every per-pod leaf carries a leading pod
dimension, and a neighbour's stream is ``torch.roll`` over it, the JAX
package's ``mesh=None`` backend (``roll(x, s)[j] = x[j - s]``). The
``ppermute`` backend across devices (a ``mesh``) and ``gossip_batch_specs``
raise ``NotImplementedError`` (ROADMAP Queue 1 items 10 and 14).

Where the JAX step is functional, this one updates in place, leaf by leaf
under ``no_grad``, so that the temporaries of one step stay about two
per-pod copies of the largest leaf (gemma2-2b's embedding: 2.36 GB each):
  * ``extrap = 2 theta - theta_prev`` is written into theta_prev's storage,
    the correction and ``- lr (g - g_prev)`` are added there, and it
    becomes the new theta; the old theta becomes theta_prev and the new
    gradients g_prev (rebound, not copied); g_prev's old storage holds
    ``lr (g - g_prev)`` and is dropped;
  * each reconstruction stream is updated by ``index_add_`` of the
    received (values, indices), bit-equal to JAX's
    ``rec + scatter(zeros, idx, vals)`` (``0 + v == v``; the padded tail's
    zero values at index 0 add nothing);
  * the correction is accumulated per pod in float32 in JAX's order (for
    each shift, ``+s`` before ``-s``);
  * each pod's gradients are computed on ``detach()``ed views of the
    stacked leaves (no replica is copied) into one stacked buffer.
So the step consumes its input state: keep only the returned one. The
Adam modes run ``optim.adam.adam_update`` per pod on views, in place.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import mixing as MX
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import MODES, topk_blocks
from repro_torch.kernels.ref import block_topk_ref
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.transformer import TensorSpec
from repro_torch.optim.adam import adam_init, adam_update, global_norm
from repro_torch.train.step import TrainConfig, local_grads

_NOT_PORTED = ("the ppermute backend over a device mesh is not ported; pods run on one "
               "device (mesh=None) (ROADMAP Queue 1 items 10 and 14)")


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    """Pod-axis decentralized-training setup: topology, mode, compression."""

    n_pods: int = 2
    topology: str = "ring"  # ring | exponential | allreduce
    mode: str = "dsba"  # dsba | dsgd | allreduce
    # none | topk (exact global top-k) | block_topk (top-k_b per block:
    # the wire format of kernels/topk_compress.py)
    compression: str = "none"
    topk_ratio: float = 0.01
    block_size: int = 4096  # block_topk selection granularity
    # kernels/ops.py mode for the block_topk selection: auto | on | off
    kernel_mode: str = "auto"
    consensus_lr: float = 0.9  # CHOCO gamma
    seed: int = 0

    def __post_init__(self):
        """Reject what the step cannot run (Pallas' interpret mode has no
        counterpart)."""
        if self.mode not in ("dsba", "dsgd", "allreduce"):
            raise ValueError(f"mode={self.mode!r} not in ('dsba', 'dsgd', 'allreduce')")
        if self.compression not in ("none", "topk", "block_topk"):
            raise ValueError(f"compression={self.compression!r} not in "
                             "('none', 'topk', 'block_topk')")
        if self.kernel_mode not in MODES:
            raise ValueError(f"kernel_mode={self.kernel_mode!r} not in {MODES}")

    def graph_and_weights(self) -> tuple[MX.Graph, np.ndarray]:
        """Pod graph + Laplacian mixing matrix for this topology."""
        return MX.make_pod_mixing(
            self.n_pods, self.topology if self.topology != "allreduce" else "ring", self.seed
        )

    def shifts_and_weights(self) -> tuple[list[int], list[float], float]:
        """Ring/exponential graphs are circulant: mixing = self-weight +
        symmetric shifts. Returns (shifts, per-shift weight, self-weight)."""
        _, w = self.graph_and_weights()
        wt = MX.w_tilde(w)
        if self.n_pods == 1:
            return [], [], 1.0
        row = wt[0]
        shifts, weights = [], []
        for s in range(1, self.n_pods // 2 + 1):
            if abs(row[s]) > 1e-12:
                shifts.append(s)
                weights.append(float(row[s]))
        return shifts, weights, float(row[0])


def _shift_scales(gc: GossipConfig) -> tuple[list[tuple[int, float]], float]:
    """[(shift, weight applied to each direction)] and the self-weight:
    on an even ring the antipodal shift appears once in the row, so its
    weight is halved over its two directions."""
    shifts, weights, w_self = gc.shifts_and_weights()
    n = gc.n_pods
    return [(s, w if (2 * s) % n else w / 2.0) for s, w in zip(shifts, weights)], w_self


# ---------------------------------------------------------------------------
# top-k difference compression + reconstruction scatter
# ---------------------------------------------------------------------------

def topk_compress(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Flattened top-k by |value|: (values (k,), indices (k,) int32), in
    descending |value| with the lower index first among equal ones (the
    order of ``jax.lax.top_k``): the plain block selection over one row."""
    vals, idx = block_topk_ref(x.reshape(1, -1), k)
    return vals[0], idx[0]


def _block_rows(resid: torch.Tensor, ratio: float, block: int, mode: str):
    """Block top-k of each pod's flattened float32 residual (P, n,
    contiguous) in one kernel call: (values (P, nb k_b), global indices
    (P, nb k_b) int32), padded tail entries (index >= n) as value 0 at
    index 0."""
    P, n = resid.shape
    block = min(block, n)
    pad = (-n) % block
    nb = (n + pad) // block
    rows = resid
    if pad:
        rows = torch.zeros((P, n + pad), dtype=torch.float32, device=resid.device)
        rows[:, :n] = resid
    k_b = max(1, int(block * ratio))
    vals, li = topk_blocks(rows.view(P * nb, block), k_b, mode=mode)
    base = torch.arange(nb, device=resid.device, dtype=torch.int64) * block
    gi = li.view(P, nb, k_b).long() + base[None, :, None]
    valid = gi < n
    vals = torch.where(valid, vals.view(P, nb, k_b), 0.0)
    gi = torch.where(valid, gi, 0)
    return vals.reshape(P, -1), gi.to(torch.int32).reshape(P, -1)


def block_topk_compress(x: torch.Tensor, ratio: float, block: int, *,
                        mode: str = "auto") -> tuple[torch.Tensor, torch.Tensor]:
    """Block-local top-k: k_b = ratio * block entries per `block`-sized
    chunk of x flattened (the last chunk zero-padded). Returns the fixed-size
    (values, GLOBAL int32 indices) wire format of ``topk_compress``; padded
    entries are value 0 at index 0. The selection dispatches through the
    kernel registry (``block_topk``) under `mode`."""
    vals, gi = _block_rows(x.reshape(1, -1).float(), ratio, block, mode)
    return vals[0].to(x.dtype), gi[0]


def scatter_decompress(shape, vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Inverse of the top-k wire format: scatter-add (vals, idx) into zeros of `shape`."""
    out = torch.zeros((math.prod(shape),), dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx.long(), vals).reshape(shape)


def leaf_k(leaf_shape, ratio: float) -> int:
    """Per-leaf top-k count for a compression ratio (at least 1)."""
    return max(1, int(math.prod(leaf_shape) * ratio))


def wire_bytes_per_pod(leaf_shapes, gc: GossipConfig) -> int:
    """Bytes one pod sends a step, per direction: (value f32, index int32)
    pairs, sum over leaves of nb * k_b * 8 (block_topk) or leaf_k * 8
    (topk); the closed form from the per-pod leaf shapes. 0 without
    compression (the dense exchange is not a wire format)."""
    total = 0
    for shape in leaf_shapes:
        n = math.prod(shape)
        if gc.compression == "block_topk":
            block = min(gc.block_size, n)
            total += -(-n // block) * max(1, int(block * gc.topk_ratio)) * 8
        elif gc.compression == "topk":
            total += leaf_k(shape, gc.topk_ratio) * 8
    return total


# ---------------------------------------------------------------------------
# gossip state
# ---------------------------------------------------------------------------

def _n_streams(gc: GossipConfig) -> int:
    return 1 + 2 * len(gc.shifts_and_weights()[0])  # own + each neighbour direction


def gossip_state_defs(cfg: ModelConfig, tc: TrainConfig, gc: GossipConfig) -> dict:
    """The gossip train state's TensorSpec tree: a leading pod dimension on
    every per-pod leaf, (pods, streams, ...) for the reconstructions. (The
    JAX function also returns PartitionSpecs; one device shards nothing.)"""
    shapes = tree_map(lambda _, d: d.shape, T.model_defs(cfg))
    per_pod = lambda dtype: tree_map(  # noqa: E731
        lambda _, s: TensorSpec((gc.n_pods, *s), dtype), shapes)
    st_dt = tc.optimizer.state_dtype
    sds = {"params": per_pod(cfg.param_dtype), "step": TensorSpec((), torch.int32),
           "opt": {"mu": per_pod(st_dt)}}
    if tc.optimizer.kind != "sgdm":
        sds["opt"]["nu"] = per_pod(st_dt)
    if gc.mode == "dsba":
        sds["params_prev"] = per_pod(cfg.param_dtype)
        sds["g_prev"] = per_pod(cfg.param_dtype)
    if gc.compression != "none":
        ns = _n_streams(gc)
        sds["recon"] = tree_map(
            lambda _, s: TensorSpec((gc.n_pods, ns, *s), cfg.param_dtype), shapes)
    return sds


def init_gossip_state(cfg: ModelConfig, tc: TrainConfig, gc: GossipConfig, seed: int = 0,
                      device=None) -> dict:
    """All pods at consensus: float32 master weights drawn from `seed` by
    ``T.init_train_params`` on `device` (the card unless told otherwise),
    tiled over pods; zero moments, gradients and reconstructions. Every
    leaf is its own tensor (params_prev is a copy, not an alias: the step
    writes in place)."""
    dev = resolve_device(device)
    params0 = T.init_train_params(cfg, seed, dev)
    P = gc.n_pods

    def tile(_, x):
        return x.unsqueeze(0).expand(P, *x.shape).contiguous()

    params = tree_map(tile, params0)
    del params0
    state = {"params": params, "opt": adam_init(tc.optimizer, params),
             "step": torch.zeros((), dtype=torch.int32)}
    if gc.mode == "dsba":
        state["params_prev"] = tree_map(lambda _, p: p.clone(), params)
        state["g_prev"] = tree_map(lambda _, p: torch.zeros_like(p), params)
    if gc.compression != "none":
        ns = _n_streams(gc)
        state["recon"] = tree_map(
            lambda _, p: torch.zeros((P, ns, *p.shape[1:]), dtype=p.dtype, device=p.device),
            params)
    return state


# ---------------------------------------------------------------------------
# exchange primitives (mesh=None: torch.roll over the leading pod dim)
# ---------------------------------------------------------------------------

def _require_local(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(_NOT_PORTED)


def _mix_leaf(x: torch.Tensor, scales, w_self: float) -> torch.Tensor:
    out = w_self * x
    for s, scale in scales:
        out = out + scale * (torch.roll(x, s, 0) + torch.roll(x, -s, 0))
    return out


def make_dense_mix(mesh, gc: GossipConfig, leaf_specs=None):
    """tree -> tree: x_p <- w_self x_p + sum_shift w_s (x_{p-s} + x_{p+s}).
    `leaf_specs` (the JAX PartitionSpecs) is accepted and unused."""
    _require_local(mesh)
    scales, w_self = _shift_scales(gc)

    def body(tree):
        return tree_map(lambda _, x: _mix_leaf(x, scales, w_self), tree)

    return body


def _exchange_leaf(gc: GossipConfig, scales, src: torch.Tensor, rec: torch.Tensor,
                   on_corr) -> int:
    """The compressed CHOCO exchange of one leaf (src (P, ...), rec
    (P, streams, ...)), updating `rec` in place. Calls on_corr(p, c_p) with
    each pod's correction gamma * sum_m w~ (rec_m - rec_0), float32, in
    pod order. Returns the wire bytes each pod sent."""
    P = src.shape[0]
    shape = src.shape[1:]
    resid = (src - rec[:, 0]).float().reshape(P, -1)
    if gc.compression == "block_topk":
        vals, idx = _block_rows(resid, gc.topk_ratio, gc.block_size, gc.kernel_mode)
    else:  # topk_compress of each pod's row
        vals, idx = block_topk_ref(resid, leaf_k(shape, gc.topk_ratio))
    del resid
    vals = vals.to(rec.dtype)
    lidx = idx.long()
    # stream 0 is the pod's own; stream si >= 1 is what pod p hears from
    # pod p - shift (roll(x, shift)[p]), for each shift +s then -s
    shifts = [sign * s for s, _ in scales for sign in (+1, -1)]
    weights = [scale for _, scale in scales for _ in (+1, -1)]
    for p in range(P):
        for si, shift in enumerate([0, *shifts]):
            q = (p - shift) % P
            rec[p, si].view(-1).index_add_(0, lidx[q], vals[q])
        corr = None
        for si, scale in enumerate(weights, start=1):
            d = torch.sub(rec[p, si], rec[p, 0]).float().mul_(scale)
            corr = d if corr is None else corr.add_(d)
            del d
        if corr is None:
            corr = torch.zeros(shape, dtype=torch.float32, device=src.device)
        on_corr(p, corr.mul_(gc.consensus_lr))
        del corr
    return (vals.numel() + idx.numel()) * 4 // P


def make_topk_exchange(mesh, gc: GossipConfig, leaf_specs=None):
    """Compressed CHOCO exchange: fn(source_tree, recon_tree) ->
    (correction_tree, new_recon_tree), correction = gamma * sum_m
    w~_pm (theta_hat_m - theta_hat_p). Only the fixed-size top-k (values,
    int32 indices) streams move between pods. recon layout per leaf:
    (pods, streams, *shape): stream 0 = own broadcast reconstruction, then
    one per (shift, direction). The reconstructions are updated in place
    and returned. `compression="none"` selects as ``topk`` does, as in the
    JAX package."""
    _require_local(mesh)
    scales, _ = _shift_scales(gc)

    def body(source, recon):
        def one(_, src, rec):
            out = torch.empty(src.shape, dtype=src.dtype, device=src.device)
            _exchange_leaf(gc, scales, src, rec, lambda p, c: out[p].copy_(c))
            return out

        with torch.no_grad():
            corr = tree_map(one, source, recon)
        return corr, recon

    return body


# ---------------------------------------------------------------------------
# the decentralized train step
# ---------------------------------------------------------------------------

def _pod_grads(cfg, tc, params, batch, n_pods):
    """(losses (P,), stacked gradients): local_grads per pod on views."""
    grads = tree_map(lambda _, t: torch.empty_like(t), params)
    losses = []
    for p in range(n_pods):
        view = tree_map(lambda _, t: t[p].detach(), params)
        loss, g = local_grads(cfg, tc, view, {k: v[p] for k, v in batch.items()})
        with torch.no_grad():
            tree_map(lambda _, buf, gp: buf[p].copy_(gp), grads, g)
        del g, view
        losses.append(loss)
    return torch.stack(losses), grads


def _check_no_alias(a, b, what):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        if x.untyped_storage().data_ptr() == y.untyped_storage().data_ptr():
            raise ValueError(f"params and {what} share storage; the dsba step writes in "
                             "place and needs separate tensors (init_gossip_state makes them)")


def make_gossip_train_step(mesh, cfg: ModelConfig, tc: TrainConfig, gc: GossipConfig):
    """Returns step(state, batch) -> (new_state, metrics) for `gc.n_pods`
    pods on one device. Batch arrays (numpy or torch) carry a leading
    (n_pods,) dim. Metrics: the pods' mean loss, grad_norm (dsba: one norm
    over every pod's gradients; the Adam modes: the mean of the per-pod
    norms) and, with compression, wire_bytes_per_pod (what the exchange
    sent, per pod and direction)."""
    _require_local(mesh)
    scales, w_self = _shift_scales(gc)
    P = gc.n_pods

    def exchange(src_tree, recon) -> int:
        """The compressed exchange leaf by leaf, each pod's correction added
        to `src_tree` in place; returns the wire bytes a pod sent."""
        sent = 0

        def one(_, src, rec):
            nonlocal sent
            sent += _exchange_leaf(gc, scales, src, rec, lambda p, c: src[p].add_(c))

        tree_map(one, src_tree, recon)
        return sent

    def step(state, batch):
        params = state["params"]
        # the two ranges name each half of the step in a torch.profiler trace
        with torch.profiler.record_function("gossip_grads"):
            losses, grads = _pod_grads(cfg, tc, params, batch, P)
        new_state = dict(state)
        metrics = {"loss": losses.mean()}

        with torch.no_grad(), torch.profiler.record_function("gossip_update"):
            if gc.mode == "dsba":
                _check_no_alias(params, state["params_prev"], "params_prev")
                lr = tc.optimizer.lr  # constant: see the module docstring
                metrics["grad_norm"] = global_norm(grads)
                # extrap = 2 theta - theta_prev, in theta_prev's storage
                extrap = tree_map(lambda _, p, pp: pp.neg_().add_(p, alpha=2.0),
                                  params, state["params_prev"])
                if gc.compression == "none":
                    mixed = make_dense_mix(None, gc)(extrap)
                    del extrap
                else:
                    metrics["wire_bytes_per_pod"] = exchange(extrap, state["recon"])
                    mixed = extrap

                def descend(_, m, g, gp):
                    # m - lr (g - g_prev), the difference in g_prev's storage
                    m.sub_(gp.neg_().add_(g).mul_(lr))
                    return m

                new_state["params"] = tree_map(descend, mixed, grads, state["g_prev"])
                new_state["params_prev"] = params
                new_state["g_prev"] = grads
                new_state["step"] = state["step"] + 1
                return new_state, metrics

            if gc.mode == "allreduce":
                tree_map(lambda _, g: g.copy_(g.mean(0, keepdim=True).expand_as(g)), grads)
                mix_src = params
            else:  # dsgd
                mix_src = make_dense_mix(None, gc)(params) if gc.compression == "none" \
                    else params

            norms = []
            for p in range(P):
                at = lambda tree: tree_map(lambda _, t: t[p], tree)  # noqa: E731
                _, _, m = adam_update(tc.optimizer, at(mix_src), at(grads), at(state["opt"]),
                                      state["step"])
                norms.append(m["grad_norm"])
            del grads
            if gc.compression != "none" and gc.mode == "dsgd":
                metrics["wire_bytes_per_pod"] = exchange(mix_src, state["recon"])
            new_state["params"] = mix_src
            new_state["step"] = state["step"] + 1
            metrics["grad_norm"] = torch.stack(norms).mean()
            return new_state, metrics

    return step


def gossip_batch_specs(cfg: ModelConfig) -> dict:
    """PartitionSpecs of the per-pod batch: a mesh tool, not ported."""
    raise NotImplementedError(f"gossip_batch_specs: {_NOT_PORTED}")


def consensus_distance(params) -> torch.Tensor:
    """sum over leaves of sum_p ||theta_p - theta_bar||^2 in float32 over the
    pod axis (diagnostics), one pod at a time."""
    total = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
    with torch.no_grad():
        for p in tree_leaves(params):
            pb = p.mean(0)
            for i in range(p.shape[0]):
                total += torch.sub(p[i], pb).float().square_().sum()
    return total
