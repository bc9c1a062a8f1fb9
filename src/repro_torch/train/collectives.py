"""Collectives over one axis of a ``launch.mesh.GridMesh`` rank, for the
within-pod FSDP x TP train step (``train.sharded``).

``AxisComm(me, axis)`` is one line of the grid: the ranks that share every
coordinate of ``me`` but the one along `axis`, in axis order, joined by the
gloo sub-group the worker built for that line. Its collectives:

  * ``all_gather(x, dim)``: every rank's `x`, concatenated along `dim` in
    axis order;
  * ``all_reduce(x)``: the sum over the line, added in axis order on every
    rank (gathered first, then ``acc = x_0; acc += x_1; ...``), so every
    rank holds the same bits and two runs give the same bits; gloo's own
    ``all_reduce`` adds in an order of its own;
  * ``all_max(x)``: the elementwise max over the line;
  * ``reduce_scatter(x, dim)``: this rank's block along `dim` of the sum
    over the line (each block sent to its owner by ``all_to_all_single``,
    then added in axis order).

gloo moves host memory only: on the card each collective copies its
operand into a pinned host buffer (the copy waits for the kernels that made
it) and the result back. Messages go in pieces of at most
``launch.mesh.PIPE_PIECE_BYTES`` bytes (gloo counts elements in 32 bits). A
line of one rank (an axis of size 1) makes every collective the identity
and sends nothing.

The autograd pairs (``Function``s):

  * ``copy_to(x)`` (Megatron's f): forward the identity, backward the
    all-reduce of the gradient. It stands before a column-parallel product
    whose input every rank of the line holds: each rank's gradient of that
    input is a partial sum over its columns.
  * ``reduce_from(x)`` (Megatron's g): forward the all-reduce, backward the
    identity: after a row-parallel product, whose outputs are partial sums.
  * ``gather_from(x, dim)`` (FSDP): forward ``all_gather``, backward
    ``reduce_scatter`` of the gradient: a weight stored in blocks over the
    line is gathered where it is used, and each rank keeps the summed
    gradient of its own block.
  * ``psum(x)`` (``jax.lax.psum``): the all-reduce both ways. It sums a
    statistic of a dimension split over the line (the Mamba2 gated norm's
    mean of squares): every rank uses the whole sum on its own block, so
    each rank's gradient of it is a partial sum too.

Counters (``reset``): ``sent_bytes`` (payload bytes this rank sent to its
peers: (n - 1) x the operand for a gather or an all-reduce, (n - 1) / n of
it for a reduce-scatter), ``seconds`` (host time in the collectives,
staging included) and the same per kind in ``by_kind`` ("gather",
"reduce_scatter", "all_reduce").
"""
from __future__ import annotations

import time

import torch

from repro_torch.launch import mesh as _mesh
from repro_torch.models.params import tree_map

KINDS = ("gather", "reduce_scatter", "all_reduce")


class AxisComm:
    """The collectives of rank `me` (a ``GridRank``) along mesh axis `axis`."""

    def __init__(self, me, axis: str):
        self.axis = axis
        self.device = me.device
        group = me.groups.get(axis)
        if group is None:  # an axis of one rank (or not on the mesh)
            self.group, self.ranks, self.size, self.index = None, (me.rank,), 1, 0
        else:
            self.group, self.ranks = group
            self.size, self.index = len(self.ranks), self.ranks.index(me.rank)
        self.reset()

    def reset(self) -> None:
        """Zero the counters."""
        self.sent_bytes = 0
        self.seconds = 0.0
        self.by_kind = {k: {"sent_bytes": 0, "seconds": 0.0, "calls": 0} for k in KINDS}

    def _count(self, kind: str, nbytes: int, t0: float) -> None:
        dt = time.perf_counter() - t0
        self.sent_bytes += nbytes
        self.seconds += dt
        rec = self.by_kind[kind]
        rec["sent_bytes"] += nbytes
        rec["seconds"] += dt
        rec["calls"] += 1

    # -- staging --------------------------------------------------------------

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """A contiguous host tensor holding `x` (pinned on the card)."""
        if x.device.type == "cpu":
            return x.contiguous()
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)  # blocking: waits for the kernels that made x
        return h

    def _back(self, h: torch.Tensor) -> torch.Tensor:
        return h if self.device.type == "cpu" else h.to(self.device)

    def _gathered(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's `x` (host tensors), in axis order."""
        import torch.distributed as dist

        h = self._host(x)
        outs = [torch.empty_like(h) for _ in range(self.size)]
        flat = h.reshape(-1).view(torch.uint8)
        flats = [o.reshape(-1).view(torch.uint8) for o in outs]
        piece = _mesh.PIPE_PIECE_BYTES
        for lo in range(0, flat.numel(), piece):
            dist.all_gather([f[lo:lo + piece] for f in flats], flat[lo:lo + piece],
                            group=self.group)
        return outs

    # -- the collectives ------------------------------------------------------

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' `x` concatenated along `dim`, in axis order."""
        if self.size == 1:
            return x
        t0 = time.perf_counter()
        out = self._back(torch.cat(self._gathered(x), dim))
        self._count("gather", (self.size - 1) * x.numel() * x.element_size(), t0)
        return out

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        t0 = time.perf_counter()
        parts = self._gathered(x)
        acc = parts[0].clone()
        for p in parts[1:]:
            op(acc, p)
        out = self._back(acc)
        self._count("all_reduce", (self.size - 1) * x.numel() * x.element_size(), t0)
        return out

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the line, added in axis order (the same bits on
        every rank)."""
        if self.size == 1:
            return x
        return self._reduce(x, lambda a, b: a.add_(b))

    def all_max(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise max over the line."""
        if self.size == 1:
            return x
        return self._reduce(x, lambda a, b: torch.maximum(a, b, out=a))

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Block `index` of n along `dim` of the sum over the line, the
        blocks of the other ranks added in axis order."""
        import torch.distributed as dist

        if self.size == 1:
            return x
        t0 = time.perf_counter()
        n = self.size
        if x.shape[dim] % n:
            raise ValueError(f"dimension {x.shape[dim]} does not split over {n} ranks")
        # rank j's block first, so block j goes to rank j
        send = self._host(torch.stack(torch.chunk(x, n, dim)))
        recv = torch.empty_like(send)
        sf, rf = send.view(n, -1).view(torch.uint8), recv.view(n, -1).view(torch.uint8)
        per, step = sf.shape[1], _mesh.PIPE_PIECE_BYTES // n
        if per <= step:
            dist.all_to_all_single(rf, sf, group=self.group)
        for lo in range(0, per if per > step else 0, step):
            s_piece = sf[:, lo:lo + step].contiguous()
            r_piece = torch.empty_like(s_piece)
            dist.all_to_all_single(r_piece, s_piece, group=self.group)
            rf[:, lo:lo + step] = r_piece
        acc = recv[0].clone()
        for j in range(1, n):
            acc.add_(recv[j])
        out = self._back(acc)
        self._count("reduce_scatter", (n - 1) * (x.numel() // n) * x.element_size(), t0)
        return out

    # -- the autograd pairs ---------------------------------------------------

    def copy_to(self, x: torch.Tensor) -> torch.Tensor:
        """f: the identity forward, the gradient's all-reduce backward."""
        return x if self.size == 1 else _CopyTo.apply(x, self)

    def reduce_from(self, x: torch.Tensor) -> torch.Tensor:
        """g: the all-reduce forward, the identity backward."""
        return x if self.size == 1 else _ReduceFrom.apply(x, self)

    def gather_from(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """FSDP: ``all_gather`` forward, ``reduce_scatter`` of the gradient
        backward."""
        return x if self.size == 1 else _GatherFrom.apply(x, self, dim)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """The all-reduce forward and backward."""
        return x if self.size == 1 else _PSum.apply(x, self)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        return comm.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm):
        ctx.comm = comm
        return comm.all_reduce(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.all_reduce(g.contiguous()), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, comm, dim):
        ctx.comm, ctx.dim = comm, dim
        return comm.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.comm.reduce_scatter(g.contiguous(), ctx.dim), None, None


class Grid:
    """What a rank of the within-pod step knows of its mesh: the ``"data"``
    and ``"model"`` lines (``AxisComm``) and the parameters' layout
    (`specs`, a PartitionSpec tree of the model's parameters).
    ``models.layers.use_constraint_mesh(grid)`` makes the model code compute
    this rank's share."""

    def __init__(self, me, specs):
        self.specs = specs
        self.data = AxisComm(me, "data")
        self.model = AxisComm(me, "model")

    @property
    def comms(self) -> tuple[AxisComm, AxisComm]:
        """The ``"data"`` and ``"model"`` lines."""
        return self.data, self.model

    def reset(self) -> None:
        """Zero both lines' counters."""
        for c in self.comms:
            c.reset()

    def gather(self, t: torch.Tensor, spec) -> torch.Tensor:
        """`t` (this rank's block of a leaf laid out by `spec`) gathered over
        ``"data"`` along the dimension split over it (FSDP), else `t`."""
        for dim, ax in enumerate(spec):
            if ax == "data":
                return self.data.gather_from(t, dim)
        return t

    def gather_layer(self, p: dict, specs: dict, stacked: bool = True) -> dict:
        """A layer's leaves gathered over ``"data"``: views of the stacked
        blocks, whose `specs` have the layer axis first, or (not `stacked`)
        an unstacked block's (the hybrid's ``shared_attn``)."""
        cut = 1 if stacked else 0
        return tree_map(lambda _, t, spec: self.gather(t, spec[cut:]), p, specs)

    def vocab_offset(self, local_vocab: int) -> int:
        """The first vocabulary row of this rank's block over ``"model"``."""
        return self.model.index * local_vocab
