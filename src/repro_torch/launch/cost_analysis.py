"""Cost accounting of one eager step, counted by dispatch (the counterpart of
``repro.launch.hlo_analysis``).

The JAX package compiles a step and reads its costs from the optimized HLO
text. Eager PyTorch has no HLO: the step is the sequence of ops it
dispatches, so ``count_step`` runs it once (on meta tensors, which hold
shapes and no data, for the dry run; or on real tensors) and counts what
each executed op does:

  flops             the torch ops' FLOPs by ``torch.utils.flop_counter``
                    (matrix products, convolutions, attention); a hand
                    kernel's operations from its ``KernelSpec.cost``
  bytes             each executed op's input and output bytes; views and
                    other aliases (``_NO_BYTES``, and every op whose schema
                    makes it a view) cost nothing, as in ``hlo_analysis``;
                    a hand kernel's bytes from its ``KernelSpec.cost``
  peak live bytes   the argument storages plus the most storage born in
                    the step and not yet freed at any point of it
  collective bytes  0: no collective runs until ``ShardedComm`` (ROADMAP
                    Queue 1 item 10) counts them at its call site

Eager torch does not fuse, so these bytes are the traffic the eager step
really has (no fusion discount); a kernel's inner traffic (its own
temporaries) is not seen, nor are a library's workspaces. Every op is
counted once per execution: a Python loop over layers (the JAX ``scan``)
or a recomputed checkpoint is counted as many times as it runs, so there
is no trip count to recover.

HLO-text parsing (``program_costs``, ``collective_stats``,
``compiled_collective_costs``, ``xla_cost_analysis``) has no counterpart:
there is no text to parse. ``Roofline``, ``roofline_terms`` and
``model_flops`` are the reference's, with the H100's published peaks in
place of the TPU's.
"""
from __future__ import annotations

import collections
import dataclasses
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops

# Published peaks of the card the roofline assumes (NVIDIA data sheet,
# dense rates without sparsity): NVIDIA H100 SXM5 80GB HBM3 at a power
# limit of 700 W. A card set below 700 W runs slower under load.
CARD = "NVIDIA H100 SXM5 80GB HBM3, 700 W"
PEAK_FLOPS = 989e12  # bf16 tensor-core FLOP/s
HBM_BW = 3.35e12  # HBM3 bytes/s
HBM_BYTES = 80e9  # device memory, bytes
NVLINK_BW = 450e9  # bytes/s one way: NVLink 4's 900 GB/s a card, both ways

# aliases and plumbing: no memory traffic (beside every op whose schema
# makes its output a view, ``OpOverload.is_view``)
_NO_BYTES = {
    "aten._unsafe_view", "aten.lift_fresh", "aten.empty", "aten.empty_like",
    "aten.empty_strided", "aten.new_empty", "aten.new_empty_strided", "aten.alias",
}


def _tensors(tree) -> list[torch.Tensor]:
    """The tensors under nested dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    elif not isinstance(tree, (list, tuple)):
        return []
    return [t for sub in tree for t in _tensors(sub)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    """The identity of t's storage: torch keeps one Python storage object a
    storage for as long as the storage lives."""
    return id(t.untyped_storage())


@dataclasses.dataclass
class OpCount:
    """One op's (or hand kernel's) executions, FLOPs and bytes in a step."""

    calls: int = 0
    flops: float = 0.0
    bytes: float = 0.0


class _ByteCounter(TorchDispatchMode):
    """Counts each executed op's calls and input + output bytes, and the
    bytes of the storages born and freed while it is open (``live``, and
    its most, ``peak``)."""

    def __init__(self, table: dict[str, OpCount]):
        super().__init__()
        self.table = table
        self.live = 0  # bytes of the storages born here and still alive
        self.peak = 0
        self._refs: dict[int, weakref.ref] = {}

    def _free(self, key: int, nbytes: int) -> None:
        self._refs.pop(key, None)
        self.live -= nbytes

    def note(self, tensors) -> None:
        """Count `tensors`' storages as known (not born in the step)."""
        for t in tensors:
            self._refs.setdefault(_storage_key(t), None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = str(func.overloadpacket)
        rec = self.table[name]
        rec.calls += 1
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if not (func.is_view or name in _NO_BYTES):
            rec.bytes += sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        seen = {_storage_key(t) for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = id(st)
            if key in seen or key in self._refs:
                continue
            nbytes = st.nbytes()
            self._refs[key] = weakref.ref(st, lambda _, k=key, n=nbytes: self._free(k, n))
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        return out


@dataclasses.dataclass
class StepCosts:
    """What ``count_step`` counted: totals, the per-op table (op -> calls,
    FLOPs, bytes; hand kernels under ``kernel:<name>``) and memory."""

    flops: float
    bytes: float
    table: dict[str, OpCount]
    argument_bytes: int
    output_bytes: int
    peak_bytes: int


def unique_storage_bytes(tree) -> int:
    """Bytes of the distinct storages under `tree`'s tensors."""
    seen = {}
    for t in _tensors(tree):
        seen[_storage_key(t)] = t.untyped_storage().nbytes()
    return sum(seen.values())


def count_step(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` once under the counting modes; returns
    (its result, ``StepCosts``). The arguments' storages are the step's
    argument bytes; the peak is those plus the most storage born in the
    step and alive at once."""
    table: dict[str, OpCount] = collections.defaultdict(OpCount)

    def kernel(name: str, operations: int, nbytes: int) -> None:
        rec = table[f"kernel:{name}"]
        rec.calls += 1
        rec.flops += operations
        rec.bytes += nbytes

    counter = _ByteCounter(table)
    counter.note(_tensors((args, kwargs)))
    flops = FlopCounterMode(display=False)
    with ops.kernel_costs(kernel), flops, counter:
        out = fn(*args, **kwargs)
    for op, n in flops.get_flop_counts().get("Global", {}).items():
        table[str(op)].flops += n
    argument_bytes = unique_storage_bytes((args, kwargs))
    costs = StepCosts(
        flops=float(sum(r.flops for r in table.values())),
        bytes=float(sum(r.bytes for r in table.values())),
        table=dict(table),
        argument_bytes=argument_bytes,
        output_bytes=unique_storage_bytes(out),
        peak_bytes=argument_bytes + counter.peak,
    )
    return out, costs


def table_totals(table: dict) -> tuple[float, float]:
    """(FLOPs, bytes) summed over a saved op table ({op: {calls, flops, bytes}})."""
    return (float(sum(r["flops"] for r in table.values())),
            float(sum(r["bytes"] for r in table.values())))


@dataclasses.dataclass
class CollectiveStats:
    """Collective bytes and counts by op (empty until item 10)."""

    bytes_by_op: dict[str, float]
    count_by_op: dict[str, float]

    @property
    def total_bytes(self) -> float:
        """Bytes over every collective op."""
        return float(sum(self.bytes_by_op.values()))


@dataclasses.dataclass
class Roofline:
    """All terms are SECONDS for one step; ``hlo_flops`` and ``hlo_bytes``
    keep the reference's names for the counted totals (there is no HLO)."""

    compute_s: float
    memory_s: float
    collective_s: float
    hlo_flops: float  # per device
    hlo_bytes: float  # per device
    collective_bytes: float  # per device
    model_flops: float  # global useful flops (6ND / 2ND)
    chips: int

    @property
    def dominant(self) -> str:
        """The largest of the three terms."""
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flop_ratio(self) -> float:
        """model_flops over the counted FLOPs of every chip."""
        tot = self.hlo_flops * self.chips
        return self.model_flops / tot if tot else float("nan")

    @property
    def bound_s(self) -> float:
        """The largest term: the least time the step could take."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / bound time — the MFU analogue derivable
        without wall clocks: (model_flops/chips/peak) / max(terms)."""
        ideal = self.model_flops / self.chips / PEAK_FLOPS
        return ideal / self.bound_s if self.bound_s else float("nan")


def roofline_terms(
    cost: dict, colls: CollectiveStats, chips: int, model_flops: float,
    links_per_chip: float = 1.0,
) -> Roofline:
    """The roofline of counted costs ({"flops", "bytes accessed"}) at the
    H100's published peaks."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    cb = float(colls.total_bytes)
    return Roofline(
        compute_s=flops / PEAK_FLOPS,
        memory_s=byts / HBM_BW,
        collective_s=cb / (NVLINK_BW * links_per_chip),
        hlo_flops=flops,
        hlo_bytes=byts,
        collective_bytes=cb,
        model_flops=model_flops,
        chips=chips,
    )


def model_flops(cfg, kind: str, batch: int, seq: int) -> float:
    """Useful FLOPs: 6*N*D train, 2*N*D inference (+ attention terms)."""
    n_active = cfg.active_param_count()
    L = cfg.n_layers
    H, hd = cfg.n_heads, cfg.head_dim
    if kind == "train":
        tokens = batch * seq
        # causal attn fwd ~ 2 * S^2/2 * H*hd * 2(qk+av); x3 with backward
        attn = 2.0 * 3.0 * L * batch * seq * seq * H * hd
        return 6.0 * n_active * tokens + attn
    if kind == "prefill":
        tokens = batch * seq
        attn = 2.0 * L * batch * seq * seq * H * hd
        return 2.0 * n_active * tokens + attn
    # decode: one token, attends over `seq` cache entries
    attn = 4.0 * L * batch * seq * H * hd
    return 2.0 * n_active * batch + attn
