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

Two interchangeable backends with the same semantics, as in the JAX
package:
  * ``mesh=None``: every pod on one device. Each per-pod leaf carries a
    leading pod dimension and a neighbour's stream is ``torch.roll`` over
    it (``roll(x, s)[j] = x[j - s]``).
  * a ``launch.mesh.NodeMesh`` of ``n_pods`` ranks: the ``ppermute``
    backend. Rank p is pod p and holds that pod's replica and state (leaves
    with a leading pod dimension of 1, what the JAX ``shard_map`` body
    sees); ``PodExchange.shift(x, s)`` sends x to rank p + s and receives
    from p - s (``ppermute``'s i -> i + s) by ``torch.distributed``
    send/recv, through pinned host buffers on the card (gloo moves host
    memory). With compression only the fixed-size (values, indices)
    streams cross between ranks. ``init_gossip_state(..., mesh=)`` and
    ``scatter_gossip_state`` leave the state in the ranks and hand the
    caller a ``RankGossipState``; ``gather_gossip_state`` brings it back.
The rank step runs the local step's own body on its one pod, so a rank's
leaves are bit-equal to its pod's row of the local backend's.

Where the JAX step is functional, this one updates in place, leaf by leaf
under ``no_grad``, so that the temporaries of one step stay about two
per-pod copies of the largest leaf (gemma2-2b's embedding: 2.36 GB each):
  * ``extrap = 2 theta - theta_prev`` is written into theta_prev's storage,
    the correction (or the dense mix) and ``- lr (g - g_prev)`` are added
    there, and it becomes the new theta; the old theta becomes theta_prev
    and the new gradients g_prev (rebound, not copied); g_prev's old
    storage holds ``lr (g - g_prev)`` and is dropped;
  * each reconstruction stream is updated by ``index_add_`` of the
    received (values, indices), bit-equal to JAX's
    ``rec + scatter(zeros, idx, vals)`` (``0 + v == v``; the padded tail's
    zero values at index 0 add nothing);
  * the correction is accumulated per pod in float32 in JAX's order (for
    each shift, ``+s`` before ``-s``);
  * each pod's gradients are computed on ``detach()``ed views of the
    stacked leaves (no replica is copied) into one stacked buffer (a
    rank's one pod keeps them as they come);
  * on the card a rank hands its cached device blocks back after each
    job: the ranks share the card, and two ranks' activation peaks sit
    beside two 23.9 GB gemma2-2b pod states.
So the step consumes its input state: keep only the returned one. The
Adam modes run ``optim.adam.adam_update`` per pod on views, in place.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
import time
import zlib

import numpy as np
import torch

from repro_torch.core import mixing as MX
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ops import MODES, topk_blocks
from repro_torch.kernels.ref import block_topk_ref
from repro_torch.launch import mesh as _mesh
from repro_torch.launch.mesh import from_host as _from_host
from repro_torch.launch.mesh import to_host as _to_host
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.transformer import TensorSpec
from repro_torch.optim.adam import adam_init, adam_update, sum_of_squares
from repro_torch.train.step import TrainConfig, local_grads


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
# exchange backends: torch.roll over the leading pod dim, or a rank's
# send/recv (the JAX package's _shift_fns)
# ---------------------------------------------------------------------------

class _LocalPods:
    """The ``mesh=None`` backend: every pod's row of a leading pod dim on one
    device; a shift is ``torch.roll`` (``roll(x, s)[j] = x[j - s]``)."""

    def shift(self, xs, s: int) -> list[torch.Tensor]:
        return [torch.roll(x, s, 0) for x in xs]

    def pod_mean(self, g: torch.Tensor) -> torch.Tensor:
        return g.mean(0, keepdim=True)


_LOCAL = _LocalPods()


class PodExchange:
    """The ``ppermute`` backend on a rank of a ``launch.mesh.NodeMesh``
    (built from the ``NodeRank`` a worker runs as): rank r is pod r.

    ``shift(xs, s)`` sends every tensor of ``xs`` to rank (r + s) % n and
    returns what rank (r - s) % n sent, in one ``batch_isend_irecv``;
    ``pod_mean`` and ``all_reduce_sum`` are the allreduce mode's and the
    consensus diagnostic's collectives. Every rank must make the same calls
    in the same order, with the same shapes (a tag a message and call).

    On the card the tensors are staged through two pinned host buffers
    (gloo moves host memory), grown to the largest message a call has
    carried, so bounded by the largest leaf's stream: the copy to the host
    also waits for the kernels that made the tensor. Counters, zeroed by
    ``reset_counters``: ``sent_bytes`` (payload bytes this rank sent),
    ``exchange_s`` (host time in the exchanges) and ``staging_s`` (the part
    of it in the copies between the card and the host buffers). While
    ``digests`` is a list, each shift appends {"shift", "sent", "recv"}
    with a CRC-32 of the bytes it sent and received.
    """

    def __init__(self, me):
        """Bind the rank (its index, the mesh size and its device)."""
        self.rank, self.n, self.device = me.rank, me.n, me.device
        self._host = {"send": None, "recv": None}
        self._tag = 0
        self.digests: list | None = None
        self.reset_counters()

    def reset_counters(self) -> None:
        """Zero the bytes sent and the exchange and staging times."""
        self.sent_bytes = 0
        self.exchange_s = 0.0
        self.staging_s = 0.0

    def _buffer(self, which: str, nbytes: int) -> torch.Tensor:
        """The pinned host byte buffer `which`, grown to at least `nbytes`."""
        buf = self._host[which]
        if buf is None or buf.numel() < nbytes:
            self._host[which] = None
            buf = self._host[which] = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return buf

    def _views(self, which: str, xs) -> list[torch.Tensor]:
        """Host views shaped like each of `xs`, at 16-byte aligned offsets of
        one buffer."""
        offs, end = [], 0
        for x in xs:
            offs.append(end)
            end += -(-x.numel() * x.element_size() // 16) * 16
        buf = self._buffer(which, end)
        return [buf[o:o + x.numel() * x.element_size()].view(x.dtype).view(x.shape)
                for o, x in zip(offs, xs)]

    def _stage_in(self, xs) -> list[torch.Tensor]:
        """The tensors to send: host copies on the card, else `xs`."""
        if self.device.type != "cuda":
            return [x.contiguous() for x in xs]
        t0 = time.perf_counter()
        host = self._views("send", xs)
        for h, x in zip(host, xs):
            h.copy_(x)  # blocking: waits for the kernels that made x
        self.staging_s += time.perf_counter() - t0
        return host

    def _stage_out(self, host, outs) -> None:
        """Copy received host tensors into their device tensors."""
        t0 = time.perf_counter()
        for h, o in zip(host, outs):
            o.copy_(h)
        self.staging_s += time.perf_counter() - t0

    def _next_tag(self) -> int:
        self._tag = (self._tag + 1) % (1 << 30)
        return self._tag

    def shift(self, xs, s: int) -> list[torch.Tensor]:
        """``ppermute`` i -> i + s of each tensor of `xs` (this rank's
        blocks): the blocks rank (r - s) % n sent, on this rank's device."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        dst, src = (self.rank + s) % self.n, (self.rank - s) % self.n
        outs = [torch.empty(x.shape, dtype=x.dtype, device=self.device) for x in xs]
        sends = self._stage_in(xs)
        cuda = self.device.type == "cuda"
        recvs = self._views("recv", xs) if cuda else outs
        ops_, piece = [], _mesh.PIPE_PIECE_BYTES
        for a, b in zip(sends, recvs):
            a8, b8 = a.reshape(-1).view(torch.uint8), b.view(-1).view(torch.uint8)
            for lo in range(0, a8.numel(), piece):
                tag = self._next_tag()
                ops_.append(dist.P2POp(dist.isend, a8[lo:lo + piece], dst, tag=tag))
                ops_.append(dist.P2POp(dist.irecv, b8[lo:lo + piece], src, tag=tag))
            self.sent_bytes += a8.numel()
        for work in dist.batch_isend_irecv(ops_):
            work.wait()
        if self.digests is not None:
            self.digests.append({"shift": s, "sent": _crc(sends), "recv": _crc(recvs)})
        if cuda:
            self._stage_out(recvs, outs)
        self.exchange_s += time.perf_counter() - t0
        return outs

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's `x` (a (1, ...) block), stacked in rank order:
        (n, ...) on this rank's device."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        out = torch.empty((self.n, *x.shape[1:]), dtype=x.dtype, device=self.device)
        (send,) = self._stage_in([x])
        recv = self._views("recv", [out])[0] if self.device.type == "cuda" else out
        dist.all_gather(list(recv.unbind(0)), send[0])
        self.sent_bytes += (self.n - 1) * send.numel() * send.element_size()
        if self.device.type == "cuda":
            self._stage_out([recv], [out])
        self.exchange_s += time.perf_counter() - t0
        return out

    def pod_mean(self, g: torch.Tensor) -> torch.Tensor:
        """The mean over pods of `g` (1, ...), as the local backend reduces
        the stacked pods (gathered in pod order, then ``mean(0)``): a gloo
        ``all_reduce`` sums in its own order, which for more than two ranks
        is not the local mean's."""
        return self.all_gather(g).mean(0, keepdim=True)

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of `x` (gloo ``all_reduce``), a new tensor on
        this rank's device."""
        import torch.distributed as dist

        t0 = time.perf_counter()
        (host,) = self._stage_in([x])
        if self.device.type != "cuda":
            host = host.clone()  # all_reduce works in place
        flat = host.view(-1)
        step = max(1, _mesh.PIPE_PIECE_BYTES // x.element_size())
        for lo in range(0, flat.numel(), step):
            dist.all_reduce(flat[lo:lo + step])
        self.sent_bytes += host.numel() * host.element_size()
        if self.device.type != "cuda":
            out = host
        else:
            out = torch.empty(x.shape, dtype=x.dtype, device=self.device)
            self._stage_out([host], [out])
        self.exchange_s += time.perf_counter() - t0
        return out


def _crc(ts) -> int:
    """CRC-32 of the bytes of host tensors, in order."""
    c = 0
    for t in ts:
        c = zlib.crc32(t.reshape(-1).view(torch.uint8).numpy(), c)
    return c


def _check_mesh(mesh, gc: GossipConfig) -> None:
    """Raise unless `mesh` has one rank a pod."""
    if mesh.n != gc.n_pods:
        raise ValueError(
            f"the pod exchange places one pod per rank: gc.n_pods is {gc.n_pods} but "
            f"the 'pod' mesh has {mesh.n} ranks (make_node_mesh({gc.n_pods}))"
        )


def _build_kernels(mesh) -> None:
    """On the card the parent builds the kernel libraries once, so the
    ranks load them and never run nvcc side by side."""
    if mesh.device.type == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()


# ---------------------------------------------------------------------------
# crossing processes: host rows of a pod-stacked tree
# ---------------------------------------------------------------------------

def _rows(tree, r: int):
    """Pod r's host rows of a pod-stacked tree (leading dim kept, as 1);
    0-d leaves (the step count) whole."""
    return tree_map(lambda _, t: _to_host(t if t.dim() == 0 else t[r:r + 1]), tree)


def _join(parts: list, device):
    """The pod-stacked tree from the ranks' host rows, in rank order; 0-d
    leaves from rank 0."""
    def one(_, *hs):
        ts = [_from_host(h, "cpu") for h in hs]
        return (ts[0] if ts[0].dim() == 0 else torch.cat(ts)).to(device)

    return tree_map(one, *parts)


# ---------------------------------------------------------------------------
# gossip state
# ---------------------------------------------------------------------------

def _n_streams(gc: GossipConfig) -> int:
    return 1 + 2 * len(gc.shifts_and_weights()[0])  # own + each neighbour direction


def gossip_state_defs(cfg: ModelConfig, tc: TrainConfig, gc: GossipConfig) -> dict:
    """The gossip train state's TensorSpec tree: a leading pod dimension on
    every per-pod leaf, (pods, streams, ...) for the reconstructions. (The
    JAX function also returns PartitionSpecs; the port's meshes place whole
    pods, a rank each.)"""
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


def _fresh_state(cfg, tc, gc, seed, dev, pods: int) -> dict:
    """The consensus start for `pods` pods (all of them, or a rank's 1)."""
    params0 = T.init_train_params(cfg, seed, dev)

    def tile(_, x):
        return x.unsqueeze(0).expand(pods, *x.shape).contiguous()

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
            lambda _, p: torch.zeros((pods, ns, *p.shape[1:]), dtype=p.dtype, device=p.device),
            params)
    return state


_TOKENS = itertools.count(1)


class RankGossipState:
    """A gossip state held by the ranks of a ``NodeMesh``: rank p keeps pod
    p's leaves (a leading pod dim of 1) in its process, under this handle's
    token, across ``NodeMesh.run`` calls. The parent holds only the handle.
    ``close()`` frees the ranks' leaves (so does closing the mesh, which
    ends the ranks); ``gather_gossip_state`` copies them back."""

    def __init__(self, mesh, n_pods: int):
        self.mesh = mesh
        self.n_pods = n_pods
        self.token = next(_TOKENS)
        self.closed = False

    def close(self) -> None:
        """Free the ranks' leaves (and their cached device memory)."""
        if not self.closed and not self.mesh.closed:
            self.mesh.run(_rank_free, [self.token] * self.mesh.n)
        self.closed = True

    def _check(self, mesh) -> None:
        if self.closed or self.mesh.closed:
            raise ValueError("the gossip state is closed (or its mesh is)")
        if mesh is not None and mesh is not self.mesh:
            raise ValueError("the gossip state lives on another mesh than the step's")

    def __repr__(self) -> str:
        return f"RankGossipState(pods={self.n_pods}, token={self.token}, closed={self.closed})"


def init_gossip_state(cfg: ModelConfig, tc: TrainConfig, gc: GossipConfig, seed: int = 0,
                      device=None, mesh=None):
    """All pods at consensus: float32 master weights drawn from `seed` by
    ``T.init_train_params`` on `device` (the card unless told otherwise),
    tiled over pods; zero moments, gradients and reconstructions. Every
    leaf is its own tensor (params_prev is a copy, not an alias: the step
    writes in place).

    With a `mesh` of ``gc.n_pods`` ranks each rank draws the parameters
    from `seed` on its own device and keeps only its pod's leaves; the
    caller gets a ``RankGossipState``. `device`, if given, must be of the
    mesh's device type."""
    if mesh is None:
        return _fresh_state(cfg, tc, gc, seed, resolve_device(device), gc.n_pods)
    _check_mesh(mesh, gc)
    if device is not None and torch.device(device).type != mesh.device.type:
        raise ValueError(f"the mesh runs on {mesh.device.type}, but device={device!r}")
    handle = RankGossipState(mesh, gc.n_pods)
    job = {"token": handle.token, "cfg": cfg, "tc": tc, "gc": gc, "seed": seed}
    mesh.run(_rank_init, [job] * mesh.n)
    return handle


def scatter_gossip_state(mesh, gc: GossipConfig, state: dict) -> RankGossipState:
    """Place a pod-stacked gossip state (any device) on the ranks of `mesh`:
    rank p gets pod p's rows (copies). The inverse of
    ``gather_gossip_state``."""
    _check_mesh(mesh, gc)
    handle = RankGossipState(mesh, gc.n_pods)
    mesh.run(_rank_put, [{"token": handle.token, "state": _rows(dict(state), r)}
                         for r in range(mesh.n)])
    return handle


def gather_gossip_state(handle: RankGossipState, device=None, keys=None) -> dict:
    """The pod-stacked state of a rank-held one on `device` (the mesh's
    device type unless told otherwise): rank p's leaves become row p.
    `keys` picks top-level entries (all by default). The leaves travel
    whole through the mesh's pipes, as a checkpoint of a small state
    would; to hold full-width replicas to each other, compare
    ``pod_digests`` instead."""
    handle._check(None)
    dev = resolve_device(handle.mesh.device.type if device is None else device)
    job = {"token": handle.token, "keys": None if keys is None else tuple(keys)}
    return _join(handle.mesh.run(_rank_gather, [job] * handle.mesh.n), dev)


def _digests(tree, p: int) -> dict:
    """{leaf path: (SHA-256 of pod p's bytes, its float64 norm)}."""
    import hashlib

    def one(path, t):
        row = t[p].detach()
        raw = row.to("cpu", copy=True).contiguous().reshape(-1).view(torch.uint8).numpy()
        return hashlib.sha256(raw).hexdigest(), float(
            torch.linalg.vector_norm(row, dtype=torch.float64))

    out = {}
    tree_map(lambda path, t: out.__setitem__("/".join(path), one(path, t)), tree)
    return out


def pod_digests(state, keys=("params",)) -> list[dict]:
    """Each pod's leaves under `keys` as {path: (SHA-256 of the leaf's
    bytes, its float64 norm)}, in pod order: two states' pods hold the
    same bits exactly when their digests are equal. `state` is a
    pod-stacked dict or a ``RankGossipState`` (each rank hashes its own
    leaves; only the digests cross)."""
    if isinstance(state, RankGossipState):
        state._check(None)
        job = {"token": state.token, "keys": tuple(keys)}
        return state.mesh.run(_rank_digests, [job] * state.mesh.n)
    pods = tree_leaves(state[keys[0]])[0].shape[0]
    return [_digests({k: state[k] for k in keys}, p) for p in range(pods)]


# ---------------------------------------------------------------------------
# the exchanges
# ---------------------------------------------------------------------------

def _mix_leaf(x: torch.Tensor, scales, w_self: float, ex) -> torch.Tensor:
    """w_self x + sum_shift w_s (x_{p-s} + x_{p+s}) of one leaf, each
    product and sum rounded as ``out + w * (a + b)`` rounds them."""
    out = w_self * x
    for s, scale in scales:
        (a,), (b,) = ex.shift([x], s), ex.shift([x], -s)
        out.add_(a.add_(b).mul_(scale))
        del a, b
    return out


def make_dense_mix(mesh, gc: GossipConfig, leaf_specs=None):
    """tree -> tree: x_p <- w_self x_p + sum_shift w_s (x_{p-s} + x_{p+s}).
    `leaf_specs` (the JAX PartitionSpecs) is accepted and unused.

    With a `mesh` (``gc.n_pods`` ranks) the function takes and returns a
    pod-stacked tree on the parent, as the JAX ``shard_map`` function does:
    rank p gets row p and mixes it with the per-rank body (what the gossip
    step runs on a rank), and the rows come back. The ranks' costs of the
    last call are in the function's ``ranks`` attribute."""
    scales, w_self = _shift_scales(gc)
    if mesh is None:
        return lambda tree: tree_map(lambda _, x: _mix_leaf(x, scales, w_self, _LOCAL), tree)
    _check_mesh(mesh, gc)

    def mix(tree):
        res = mesh.run(_rank_dense_mix, [{"gc": gc, "tree": _rows(tree, r)}
                                         for r in range(mesh.n)])
        mix.ranks = [r["costs"] for r in res]
        return _join([r["out"] for r in res], tree_leaves(tree)[0].device)

    mix.ranks = []
    return mix


def _exchange_leaf(gc: GossipConfig, scales, src: torch.Tensor, rec: torch.Tensor,
                   on_corr, ex=_LOCAL) -> int:
    """The compressed CHOCO exchange of one leaf (src (P, ...), rec
    (P, streams, ...); P is every pod, or a rank's 1), updating `rec` in
    place. Calls on_corr(p, c_p) with each pod's correction gamma * sum_m
    w~ (rec_m - rec_0), float32, in pod order. Only (values, int32
    indices) go through `ex`. Returns the wire bytes each pod sent."""
    P = src.shape[0]
    shape = src.shape[1:]
    resid = (src - rec[:, 0]).float().reshape(P, -1)
    if gc.compression == "block_topk":
        vals, idx = _block_rows(resid, gc.topk_ratio, gc.block_size, gc.kernel_mode)
    else:  # topk_compress of each pod's row
        vals, idx = block_topk_ref(resid, leaf_k(shape, gc.topk_ratio))
    del resid
    vals = vals.to(rec.dtype)
    # stream 0 is the pod's own; stream si >= 1 is what pod p hears from
    # pod p - shift (roll(x, shift)[p]), for each shift +s then -s
    shifts = [sign * s for s, _ in scales for sign in (+1, -1)]
    weights = [scale for _, scale in scales for _ in (+1, -1)]
    streams = [(vals, idx)] + [tuple(ex.shift([vals, idx], sh)) for sh in shifts]
    for p in range(P):
        for si, (v, i) in enumerate(streams):
            rec[p, si].view(-1).index_add_(0, i[p].long(), v[p])
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


def _topk_body(gc: GossipConfig, scales, ex, source, recon):
    """(correction tree, recon updated in place) of the compressed exchange."""
    def one(_, src, rec):
        out = torch.empty(src.shape, dtype=src.dtype, device=src.device)
        _exchange_leaf(gc, scales, src, rec, lambda p, c: out[p].copy_(c), ex)
        return out

    with torch.no_grad():
        return tree_map(one, source, recon), recon


def make_topk_exchange(mesh, gc: GossipConfig, leaf_specs=None):
    """Compressed CHOCO exchange: fn(source_tree, recon_tree) ->
    (correction_tree, new_recon_tree), correction = gamma * sum_m
    w~_pm (theta_hat_m - theta_hat_p). Only the fixed-size top-k (values,
    int32 indices) streams move between pods. recon layout per leaf:
    (pods, streams, *shape): stream 0 = own broadcast reconstruction, then
    one per (shift, direction). The reconstructions are updated in place
    and returned. `compression="none"` selects as ``topk`` does, as in the
    JAX package.

    With a `mesh` the trees are pod-stacked on the parent: rank p selects
    on its own rows (the ``block_topk`` kernel on the card, under
    ``gc.kernel_mode``) and sends only its (values, indices) to each
    neighbour direction; the updated rows are copied back into
    `recon_tree`. The ranks' costs of the last call (``sent_bytes``,
    ``exchange_s``, ``staging_s``) are in the function's ``ranks``."""
    scales, _ = _shift_scales(gc)
    if mesh is None:
        return lambda source, recon: _topk_body(gc, scales, _LOCAL, source, recon)
    _check_mesh(mesh, gc)
    _build_kernels(mesh)

    def exchange(source, recon):
        jobs = [{"gc": gc, "source": _rows(source, r), "recon": _rows(recon, r)}
                for r in range(mesh.n)]
        res = mesh.run(_rank_topk_exchange, jobs)
        exchange.ranks = [r["costs"] for r in res]
        dev = tree_leaves(source)[0].device
        corr = _join([r["corr"] for r in res], dev)
        new = _join([r["recon"] for r in res], dev)
        with torch.no_grad():
            tree_map(lambda _, dst, got: dst.copy_(got), recon, new)
        return corr, recon

    exchange.ranks = []
    return exchange


# ---------------------------------------------------------------------------
# the decentralized train step
# ---------------------------------------------------------------------------

def _pod_grads(cfg, tc, params, batch, n_pods):
    """(losses (P,), stacked gradients): local_grads per pod on views. One
    pod (a rank's) keeps its gradients as they come, rounded to the
    params' dtype as a copy into the stacked buffer would round them: no
    buffer is live beside its activations."""
    if n_pods == 1:
        loss, g = local_grads(cfg, tc, tree_map(lambda _, t: t[0].detach(), params),
                              {k: v[0] for k, v in batch.items()})
        return loss.unsqueeze(0), tree_map(lambda _, t, gp: gp.to(t.dtype).unsqueeze(0),
                                           params, g)
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


def _step_body(cfg, tc, gc: GossipConfig, ex, state, batch):
    """One step on the pods `state` holds (every pod, or a rank's one; `ex`
    the matching backend). Returns (new state, parts): the pods' losses
    (P,), ``sq`` (dsba: the sum of squares of the held pods' gradients),
    ``norms`` (the Adam modes: each pod's gradient norm (P,)) and ``wire``
    (the wire bytes a pod sent a direction, None without an exchange)."""
    scales, w_self = _shift_scales(gc)
    params = state["params"]
    P = tree_leaves(params)[0].shape[0]
    # the two ranges name each half of the step in a torch.profiler trace
    with torch.profiler.record_function("gossip_grads"):
        losses, grads = _pod_grads(cfg, tc, params, batch, P)
    new_state = dict(state)
    parts = {"losses": losses, "sq": None, "norms": None, "wire": None}

    def exchange(src_tree, recon) -> int:
        """The compressed exchange leaf by leaf, each pod's correction added
        to `src_tree` in place; returns the wire bytes a pod sent."""
        sent = 0

        def one(_, src, rec):
            nonlocal sent
            sent += _exchange_leaf(gc, scales, src, rec, lambda p, c: src[p].add_(c), ex)

        tree_map(one, src_tree, recon)
        return sent

    def mix_in_place(tree):
        tree_map(lambda _, x: x.copy_(_mix_leaf(x, scales, w_self, ex)), tree)
        return tree

    with torch.no_grad(), torch.profiler.record_function("gossip_update"):
        if gc.mode == "dsba":
            _check_no_alias(params, state["params_prev"], "params_prev")
            lr = tc.optimizer.lr  # constant: see the module docstring
            parts["sq"] = sum_of_squares(grads)
            # extrap = 2 theta - theta_prev, in theta_prev's storage
            extrap = tree_map(lambda _, p, pp: pp.neg_().add_(p, alpha=2.0),
                              params, state["params_prev"])
            if gc.compression == "none":
                mix_in_place(extrap)
            else:
                parts["wire"] = exchange(extrap, state["recon"])

            def descend(_, m, g, gp):
                # m - lr (g - g_prev), the difference in g_prev's storage
                m.sub_(gp.neg_().add_(g).mul_(lr))
                return m

            new_state["params"] = tree_map(descend, extrap, grads, state["g_prev"])
            new_state["params_prev"] = params
            new_state["g_prev"] = grads
            new_state["step"] = state["step"] + 1
            return new_state, parts

        if gc.mode == "allreduce":
            tree_map(lambda _, g: g.copy_(ex.pod_mean(g).expand_as(g)), grads)
            mix_src = params
        else:  # dsgd
            mix_src = mix_in_place(params) if gc.compression == "none" else params

        norms = []
        for p in range(P):
            at = lambda tree: tree_map(lambda _, t: t[p], tree)  # noqa: E731
            _, _, m = adam_update(tc.optimizer, at(mix_src), at(grads), at(state["opt"]),
                                  state["step"])
            norms.append(m["grad_norm"])
        del grads
        if gc.compression != "none" and gc.mode == "dsgd":
            parts["wire"] = exchange(mix_src, state["recon"])
        new_state["params"] = mix_src
        new_state["step"] = state["step"] + 1
        parts["norms"] = torch.stack(norms)
        return new_state, parts


def make_gossip_train_step(mesh, cfg: ModelConfig, tc: TrainConfig, gc: GossipConfig):
    """Returns step(state, batch) -> (new_state, metrics).

    Batch arrays (numpy or torch) carry a leading (n_pods,) dim. Metrics:
    the pods' mean loss, grad_norm (dsba: one norm over every pod's
    gradients; the Adam modes: the mean of the per-pod norms) and, with
    compression, wire_bytes_per_pod (what the exchange sent, per pod and
    direction).

    ``mesh=None``: every pod on one device; `state` is the pod-stacked
    dict of ``init_gossip_state``. With a `mesh` of ``gc.n_pods`` ranks,
    `state` is a ``RankGossipState``: the parent splits the batch over the
    ranks by ``gossip_batch_specs``' "pod" dims, each rank runs the same
    step body on its pod (exchanging with ``PodExchange``) and the parent
    combines the metrics as the local step computes them; it launches no
    kernel and holds no replica. The mesh metrics add ``sent_bytes`` (the
    bytes each rank measurably sent) and ``ranks`` (each rank's
    ``wall_s``, ``exchange_s``, ``staging_s``, ``peak_bytes`` on the card
    and kernel ``launches``). ``step(handle, batch, check=True)`` also holds
    each rank's kernel calls to their plain versions (``ranks[p]["held"]``)
    and checks that every stream a rank received is, bit for bit, what its
    peer sent (CRC-32; ``metrics["streams_checked"]``)."""
    if mesh is None:
        def step(state, batch):
            new_state, parts = _step_body(cfg, tc, gc, _LOCAL, state, batch)
            metrics = {"loss": parts["losses"].mean(),
                       "grad_norm": parts["sq"].sqrt() if gc.mode == "dsba"
                       else parts["norms"].mean()}
            if parts["wire"] is not None:
                metrics["wire_bytes_per_pod"] = parts["wire"]
            return new_state, metrics

        return step

    _check_mesh(mesh, gc)
    _build_kernels(mesh)
    pod_dims = {k: spec.index("pod") for k, spec in gossip_batch_specs(cfg).items()}

    def step(handle: RankGossipState, batch, *, check: bool = False):
        handle._check(mesh)
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        jobs = [{"token": handle.token, "cfg": cfg, "tc": tc, "gc": gc, "check": check,
                 "batch": {k: _to_host(v.narrow(pod_dims[k], r, 1)) for k, v in batch.items()}}
                for r in range(mesh.n)]
        res = mesh.run(_rank_step, jobs)
        f32 = lambda key: torch.tensor([r[key] for r in res], dtype=torch.float32)  # noqa: E731
        metrics = {"loss": f32("loss").mean(),
                   "grad_norm": f32("sq").sum().sqrt() if gc.mode == "dsba"
                   else f32("norm").mean()}
        if res[0]["wire"] is not None:
            metrics["wire_bytes_per_pod"] = res[0]["wire"]
        metrics["sent_bytes"] = [r["costs"]["sent_bytes"] for r in res]
        metrics["ranks"] = [dict(r["costs"], held=r["held"]) for r in res]
        if check:
            metrics["streams_checked"] = _check_streams([r["digests"] for r in res])
        return handle, metrics

    return step


def _check_streams(digests: list[list[dict]]) -> int:
    """Raise unless every stream rank r received in its k-th shift is the
    one rank r - shift sent in its k-th; returns the streams checked."""
    n = len(digests)
    for r, mine in enumerate(digests):
        for k, d in enumerate(mine):
            peer = digests[(r - d["shift"]) % n][k]
            if peer["shift"] != d["shift"] or peer["sent"] != d["recv"]:
                raise RuntimeError(f"rank {r}, shift {k} ({d['shift']:+d}): received "
                                   f"crc {d['recv']:#x}, its peer sent {peer['sent']:#x}")
    return sum(len(d) for d in digests)


def gossip_batch_specs(cfg: ModelConfig) -> dict:
    """The per-pod batch's layout, the JAX PartitionSpecs as tuples of axis
    names, one a dimension (None: not split): the pod axis leads."""
    spec = {"tokens": ("pod", "data"), "targets": ("pod", "data")}
    if cfg.family == "encdec":
        spec["enc_embeds"] = ("pod", "data", None, None)
    return spec


def consensus_distance(params) -> torch.Tensor:
    """sum over leaves of sum_p ||theta_p - theta_bar||^2 in float32 over the
    pod axis (diagnostics), one pod at a time.

    `params` is a pod-stacked tree, or a ``RankGossipState``: each rank then
    gets theta_bar from an ``all_reduce`` and computes its own terms, and
    the parent sums them leaf by leaf in pod order (a 0-d host tensor)."""
    if isinstance(params, RankGossipState):
        params._check(None)
        res = params.mesh.run(_rank_consensus, [params.token] * params.mesh.n)
        total = torch.zeros((), dtype=torch.float32)
        for terms in zip(*res):
            for t in terms:
                total += torch.tensor(t, dtype=torch.float32)
        return total
    total = torch.zeros((), dtype=torch.float32, device=tree_leaves(params)[0].device)
    with torch.no_grad():
        for p in tree_leaves(params):
            pb = p.mean(0)
            for i in range(p.shape[0]):
                total += torch.sub(p[i], pb).float().square_().sum()
    return total


# ---------------------------------------------------------------------------
# what a rank runs (NodeMesh jobs; the stores are only ever filled in a rank)
# ---------------------------------------------------------------------------

_RANK_STATES: dict[int, dict] = {}  # the parent's token -> this rank's pod state
_RANK_EXCHANGE: list[PodExchange] = []  # this process's one PodExchange


def _exchange_for(me) -> PodExchange:
    if not _RANK_EXCHANGE:
        _RANK_EXCHANGE.append(PodExchange(me))
    ex = _RANK_EXCHANGE[0]
    ex.reset_counters()
    ex.digests = None
    return ex




def _costs(ex: PodExchange) -> dict:
    return {"sent_bytes": ex.sent_bytes, "exchange_s": ex.exchange_s,
            "staging_s": ex.staging_s}


def _rank_init(me, job) -> None:
    _RANK_STATES[job["token"]] = _fresh_state(job["cfg"], job["tc"], job["gc"], job["seed"],
                                              me.device, 1)


def _rank_put(me, job) -> None:
    _RANK_STATES[job["token"]] = tree_map(lambda _, h: _from_host(h, me.device),
                                          job["state"])


def _rank_gather(me, job):
    state = _RANK_STATES[job["token"]]
    keys = job["keys"] or tuple(state)
    return {k: tree_map(lambda _, t: _to_host(t), state[k]) for k in keys}


def _rank_digests(me, job) -> dict:
    state = _RANK_STATES[job["token"]]
    return _digests({k: state[k] for k in job["keys"]}, 0)


def _rank_free(me, token) -> None:
    _RANK_STATES.pop(token, None)


def _rank_dense_mix(me, job) -> dict:
    ex = _exchange_for(me)
    scales, w_self = _shift_scales(job["gc"])
    tree = tree_map(lambda _, h: _from_host(h, me.device), job["tree"])
    with torch.no_grad():
        out = tree_map(lambda _, x: _to_host(_mix_leaf(x, scales, w_self, ex)), tree)
    return {"out": out, "costs": _costs(ex)}


def _rank_topk_exchange(me, job) -> dict:
    ex = _exchange_for(me)
    gc = job["gc"]
    src = tree_map(lambda _, h: _from_host(h, me.device), job["source"])
    rec = tree_map(lambda _, h: _from_host(h, me.device), job["recon"])
    corr, rec = _topk_body(gc, _shift_scales(gc)[0], ex, src, rec)
    host = lambda tree: tree_map(lambda _, t: _to_host(t), tree)  # noqa: E731
    out = {"corr": host(corr), "recon": host(rec), "costs": _costs(ex)}
    return out


# the kernels of the gossip step; check=True holds each call to its plain version
_STEP_KERNELS = ("block_topk", "flash_attention", "flash_attention_bwd")


def _launches() -> dict[str, int]:
    """The launch counts of the step's kernel wrappers in this process."""
    from repro_torch.kernels import flash_attention as FA, topk_compress as TK

    return {"block_topk": TK.block_topk.launches, "flash_attention": FA.flash_attention.launches,
            "flash_attention_bwd": FA.flash_attention_bwd.launches}


def _rank_step(me, job) -> dict:
    ex = _exchange_for(me)
    dev = me.device
    cuda = dev.type == "cuda"
    token = job["token"]
    batch = {k: _from_host(h, dev) for k, h in job["batch"].items()}
    before = _launches()
    if job["check"]:
        ex.digests = []
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        held = {n: stack.enter_context(ops.held_to_plain(n))
                for n in (_STEP_KERNELS if job["check"] else ())}
        state, parts = _step_body(job["cfg"], job["tc"], job["gc"], ex,
                                  _RANK_STATES.pop(token), batch)
    _RANK_STATES[token] = state
    if cuda:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    costs = dict(_costs(ex), wall_s=wall,
                 peak_bytes=torch.cuda.max_memory_allocated(dev) if cuda else None,
                 launches={n: c - before[n] for n, c in _launches().items()})
    return {
        "loss": float(parts["losses"][0]),
        "sq": None if parts["sq"] is None else float(parts["sq"]),
        "norm": None if parts["norms"] is None else float(parts["norms"][0]),
        "wire": parts["wire"],
        "costs": costs,
        "held": {n: {"max_abs": list(h), "exact": h.exact, "rel": h.rel}
                 for n, h in held.items()} or None,
        "digests": ex.digests,
    }


def _rank_consensus(me, token) -> list[float]:
    """This rank's term of every leaf: ||theta_p - theta_bar||^2 in float32."""
    ex = _exchange_for(me)
    terms = []
    with torch.no_grad():
        for p in tree_leaves(_RANK_STATES[token]["params"]):
            pb = ex.all_reduce_sum(p).div_(me.n)[0]
            terms.append(float(torch.sub(p[0], pb).float().square_().sum()))
    return terms
