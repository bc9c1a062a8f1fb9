"""Kernel registry, mirroring ``repro.kernels.ops``.

Every kernel is registered once as a :class:`KernelSpec`: its name, the
kernel wrapper, the plain PyTorch version, a per-dtype tolerance policy and
an optional comparator. ``dispatch`` resolves a mode to one of the two and
calls it; ``parity_check`` runs a kernel and its plain version on the same
inputs and asserts agreement within the declared tolerance.

Modes (``resolve_mode`` names what each runs on a device):
  auto  the kernel for a CUDA tensor, the plain version for a CPU tensor
  on    the kernel; a CPU tensor raises (there is no interpreter on a GPU,
        so Pallas' ``interpret`` mode has no counterpart)
  off   the plain version

The dry run (``launch.dryrun``): on meta tensors, which hold shapes and no
data, ``auto`` and ``on`` return the spec's ``meta`` (empty outputs of the
kernel's shapes and dtypes; differentiable where the kernel is, so a
backward kernel is reached through the registry as on the card) and report
the spec's ``cost`` (operations, bytes) to every open ``kernel_costs``
sink; ``off`` runs the plain version on them as torch ops. The costs are
the counts behind ``chip_smoke.py``'s bounds.

Public entry points, the counterparts of the JAX package's jitted
wrappers: ``flash_attention``, ``decode_attention``, ``ssd_chunk``,
``saga_sparse_dot``, ``saga_sparse_axpy`` and ``topk_blocks``.

dtype policy: the kernels compute in the input dtype. The JAX package's
compiled TPU kernels accumulate in float32 (``ops._resolve_compute_dtype``);
the card has native float64, so the port does not.

Tolerances are those of ``repro.kernels.ops``: ``sparse_dot`` 1e-5 (f32) and
1e-12 (f64); ``sparse_axpy`` 1e-5 (f32) and bit-exact (f64);
``flash_attention`` and ``decode_attention`` 2e-5 (f32) and 2e-2 (bf16);
gradients (``grad_tol``, and the ``flash_attention_bwd`` kernel's ``tol``)
2e-4 (f32) and 5e-2 (bf16), one recompute deeper than the forward. A
gradient's scale is the loss's, so an elementwise bar alone can pass a
wrong gradient that is small: ``flash_attention_bwd`` is held to the same
numbers in relative Frobenius norm as well, output by output.
The attention kernels take bf16 or f32 inputs and accumulate in float32,
as the JAX kernels do. ``block_topk`` (float32 only) is held as the JAX
registry holds it, 1e-6, by ``_topk_compare``: the selected magnitudes
match as sets and every returned (value, index) pair is the input's entry
at that index. The CUDA kernel also breaks ties as its plain version does
(lower index first), so on the card its output is bit-equal to the plain
version's; ``HeldCalls.exact`` records that per held call. ``ssd_chunk``
(float32 only on the card) is held to 2e-5 with gradients at 2e-4, the JAX
registry's bars; its backward ``ssd_chunk_bwd`` to 2e-4 elementwise and in
relative norm, output by output (dxdt, dcum, dB, dC). Both are checked
against their plain version computed in float64 from the same float32
inputs (``KernelSpec.plain_dtype``), so the plain version's own float32
summation order cannot decide a check.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch

from repro_torch.kernels import decode_attention as _DA
from repro_torch.kernels import flash_attention as _FA
from repro_torch.kernels import ref as R
from repro_torch.kernels import sparse_saga as _SS
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.kernels import topk_compress as _TK

MODES = ("auto", "on", "off")
_DEVICES = ("cpu", "cuda", "meta")


def resolve_mode(mode: str, device) -> str:
    """What `mode` runs on `device`: ``"cuda"`` (the hand kernel; on the
    meta device, the dry run's stand-in for it) or ``"ref"`` (the plain
    version). The counterpart of ``repro.kernels.ops.resolve_mode``, whose
    ``pallas`` is ``cuda`` here; its ``interpret`` raises: the card has no
    interpreter for a CUDA kernel. ``on`` names the kernel on any device
    (``dispatch`` then refuses a CPU tensor)."""
    if mode == "interpret":
        raise ValueError("mode='interpret' has no counterpart: the card has no interpreter "
                         "for a CUDA kernel; use 'off' for the plain version")
    if mode not in MODES:
        raise ValueError(f"mode={mode!r} not in {MODES}")
    dev = torch.device(device).type
    if dev not in _DEVICES:
        raise ValueError(f"unsupported device {device}: one of {_DEVICES}")
    if mode == "off" or (mode == "auto" and dev == "cpu"):
        return "ref"
    return "cuda"


@dataclasses.dataclass(frozen=True)
class Tolerance:
    """An (rtol, atol) parity bound; (0, 0) means bit-exact."""

    rtol: float
    atol: float


_F32_TOL = Tolerance(2e-5, 2e-5)
_BF16_TOL = Tolerance(2e-2, 2e-2)
_F32_GRAD_TOL = Tolerance(2e-4, 2e-4)
_BF16_GRAD_TOL = Tolerance(5e-2, 5e-2)


def dtype_name(dtype) -> str:
    """'float32' for torch.float32 (the key format of the tolerance maps)."""
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One kernel: its wrapper, plain version and parity policy.

    kernel: the wrapper (launches the CUDA kernel on CUDA tensors).
    ref: the plain PyTorch version with the same positional surface.
    tol: {dtype name: Tolerance}; a missing dtype falls back to float32's.
    meta: the same surface; empty outputs of the kernel's shapes and dtypes
        (the dry run's stand-in on meta tensors).
    cost: the same surface -> (operations, bytes) of the call: each input
        read once, each output written once (``chip_smoke.py``'s bounds).
    compare: optional (args, got, want, tol) -> max_err comparator for
        outputs that match by another rule than elementwise.
    grad_tol: {dtype name: Tolerance} for gradients through the kernel;
        None falls back to `tol`.
    plain_dtype: the dtype ``held_to_plain`` and ``parity_check`` run the
        plain version in (its floating inputs cast to it); None: the inputs'.
    """

    name: str
    kernel: Callable
    ref: Callable
    tol: dict[str, Tolerance]
    meta: Callable
    cost: Callable
    compare: Callable | None = None
    grad_tol: dict[str, Tolerance] | None = None
    plain_dtype: torch.dtype | None = None

    def tolerance(self, dtype) -> Tolerance:
        """Parity tolerance for `dtype` (float32's entry as fallback)."""
        return self.tol.get(dtype_name(dtype), self.tol.get("float32", _F32_TOL))

    def grad_tolerance(self, dtype) -> Tolerance:
        """Gradient tolerance for `dtype` (falls back to `tol`)."""
        if self.grad_tol is None:
            return self.tolerance(dtype)
        return self.grad_tol.get(dtype_name(dtype), self.grad_tol.get("float32", _F32_GRAD_TOL))


_REGISTRY: dict[str, KernelSpec] = {}


def register_kernel(spec: KernelSpec) -> KernelSpec:
    """Add `spec` to the registry; duplicate names are an error."""
    if spec.name in _REGISTRY:
        raise ValueError(f"kernel {spec.name!r} already registered")
    _REGISTRY[spec.name] = spec
    return spec


def get_kernel(name: str) -> KernelSpec:
    """Look up a registered KernelSpec by name (KeyError if unknown)."""
    return _REGISTRY[name]


def registered_kernels() -> tuple[str, ...]:
    """Sorted names of every registered kernel."""
    return tuple(sorted(_REGISTRY))


def _first_tensor(args) -> torch.Tensor:
    return next(a for a in args if isinstance(a, torch.Tensor))


def _resolve(name: str, mode: str, *args) -> Callable:
    """The callable `mode` selects for these arguments."""
    if mode not in MODES:
        raise ValueError(f"mode={mode!r} not in {MODES}")
    spec = get_kernel(name)
    if mode == "off":
        return spec.ref
    if mode == "on" and _first_tensor(args).device.type != "cuda":
        raise ValueError(
            f"mode='on' runs the CUDA kernel {name!r}, which needs CUDA "
            f"tensors; got {_first_tensor(args).device}"
        )
    return spec.kernel  # the wrapper itself takes the plain version on CPU


class HeldCalls(list):
    """The max abs error of each held call (the list itself), beside the
    largest magnitude of the plain version's output (``scale``), the
    relative Frobenius error (``rel``) of the same call and whether every
    output equals the plain version's bit for bit (``exact``); a tuple
    output reports its worst member."""

    def __init__(self):
        super().__init__()
        self.scale: list[float] = []
        self.rel: list[float] = []
        self.exact: list[bool] = []


# kernel name -> the record of an open held_to_plain context
_HELD: dict[str, HeldCalls] = {}


@contextlib.contextmanager
def held_to_plain(name: str):
    """Hold every kernel call of `name` made through ``dispatch`` to its
    plain version while the context is open.

    Each call that runs the wrapper (modes ``auto`` and ``on``) also runs
    the plain version on the same inputs (without autograd), and the two
    must agree within the registry tolerance (``AssertionError``
    otherwise). Yields a :class:`HeldCalls` list of each call's max abs
    error, with each call's output scale and relative error beside it.
    It costs one plain call per kernel call: a check of a real path's own
    inputs, not for timed runs.
    """
    get_kernel(name)
    if name in _HELD:
        raise RuntimeError(f"{name!r} is already held to its plain version")
    errs = HeldCalls()
    _HELD[name] = errs
    try:
        yield errs
    finally:
        del _HELD[name]


# the open kernel_costs sinks: each takes (name, operations, bytes)
_COST_SINKS: list[Callable[[str, int, int], None]] = []


@contextlib.contextmanager
def kernel_costs(sink: Callable[[str, int, int], None]):
    """While open, every kernel call that ``dispatch`` answers with the
    spec's ``meta`` (meta tensors, modes auto and on) reports
    ``sink(name, operations, bytes)`` from the spec's ``cost``."""
    _COST_SINKS.append(sink)
    try:
        yield
    finally:
        _COST_SINKS.remove(sink)


def _meta_call(spec: KernelSpec, mode: str, args, kwargs):
    """The dry run's kernel call: costs to the open sinks, empty outputs."""
    if mode not in MODES:
        raise ValueError(f"mode={mode!r} not in {MODES}")
    if _COST_SINKS:
        ops_, bytes_ = spec.cost(*args, **kwargs)
        for sink in _COST_SINKS:
            sink(spec.name, ops_, bytes_)
    return spec.meta(*args, **kwargs)


def dispatch(name: str, *args, mode: str = "auto", **kwargs):
    """Run kernel `name` on `args` (and keyword options) under `mode`."""
    if args[0].is_meta and mode != "off":  # the dry run; every first argument is a tensor
        return _meta_call(_REGISTRY[name], mode, args, kwargs)
    if mode == "auto" and not _HELD:  # the wrapper, which picks plain or kernel itself
        return _REGISTRY[name].kernel(*args, **kwargs)
    fn = _resolve(name, mode, *args)
    out = fn(*args, **kwargs)
    held = _HELD.get(name)
    spec = get_kernel(name)
    if held is not None and fn is not spec.ref:
        with torch.no_grad():
            want = _plain(spec, args, kwargs)
            held.append(_compare(spec, args, out, want))
            pairs = list(zip(out, want)) if isinstance(out, tuple) else [(out, want)]
            held.scale.append(max(_max_abs(w) for _, w in pairs))
            held.rel.append(max(rel_err(g, w) for g, w in pairs))
            held.exact.append(all(torch.equal(g.detach(), w) for g, w in pairs))
    return out


def _plain(spec: KernelSpec, args, kwargs):
    """The plain version on `args`, in ``spec.plain_dtype`` if it has one."""
    if spec.plain_dtype is not None:
        args = tuple(a.to(spec.plain_dtype)
                     if isinstance(a, torch.Tensor) and a.is_floating_point() else a
                     for a in args)
    return spec.ref(*args, **kwargs)


def _max_abs(t: torch.Tensor) -> float:
    return float(t.detach().abs().max()) if t.numel() else 0.0


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| (Frobenius, in float64); the absolute
    norm of the difference where `want` is all zero."""
    w = want.detach().double()
    diff = float((got.detach().double() - w).norm())
    norm = float(w.norm())
    return diff / norm if norm > 0 else diff


def assert_close(got: torch.Tensor, want: torch.Tensor, tol: Tolerance) -> float:
    """Assert elementwise agreement within `tol` ((0, 0): bit-exact): every
    element within ``atol + rtol |want|``, equal, or NaN in both (the rule
    of ``numpy.testing.assert_allclose``). Checked where `got` lies, with no
    host copy (a held call of a train step compares ~10^8 elements); max
    abs error, NaN positions aside."""
    g, w = got.detach(), want.detach().to(got.device)
    if g.shape != w.shape:
        raise AssertionError(f"shapes differ: {tuple(g.shape)} and {tuple(w.shape)}")
    if g.numel() == 0:
        return 0.0
    g, w = g.double(), w.double()
    diff = (g - w).abs()
    ok = (g == w) | (g.isnan() & w.isnan())
    if tol.rtol != 0.0 or tol.atol != 0.0:
        ok |= diff <= tol.atol + tol.rtol * w.abs()
    if not bool(ok.all()):
        bad = ~ok
        raise AssertionError(f"{int(bad.sum())} of {ok.numel()} elements outside {tol}: max "
                             f"abs error {float(diff[bad].max())!r}")
    return float(torch.nan_to_num(diff, nan=0.0).max())


def parity_check(name: str, *args, mode: str = "on", **kwargs) -> float:
    """Assert kernel-vs-plain agreement within the declared tolerance.

    Runs `name` under `mode` and under 'off' on the same inputs (and
    keyword options) and returns the max abs error. The tolerance is the
    one for the dtype of the first floating-point argument; a kernel that
    returns a tuple (flash attention's o and lse) is held to it output by
    output. The plain version runs in the spec's ``plain_dtype``, if any.
    """
    spec = get_kernel(name)
    got = dispatch(name, *args, mode=mode, **kwargs)
    with torch.no_grad():
        want = _plain(spec, args, kwargs)
    return _compare(spec, args, got, want)


def _grad_compare(names: tuple[str, ...]) -> Callable:
    """A comparator holding each gradient output (named `names`) within
    `tol` elementwise and within ``tol.rtol`` in relative Frobenius norm
    (scale-free, so a small wrong gradient fails too); max abs error."""
    def compare(args, got, want, tol: Tolerance) -> float:
        if len(got) != len(names) or len(want) != len(names):
            raise AssertionError(f"want {names}, got {len(got)} and {len(want)} outputs")
        for what, g, w in zip(names, got, want):
            rel = rel_err(g, w)
            if not rel <= tol.rtol:
                raise AssertionError(f"{what}: relative error {rel!r} > {tol.rtol}")
        return max(assert_close(g.detach(), w.detach(), tol) for g, w in zip(got, want))

    return compare


def _close_on_device(got: torch.Tensor, want: torch.Tensor, tol: Tolerance, what: str) -> float:
    """Assert |got - want| <= atol + rtol |want| elementwise where the
    tensors lie (no host copy); max abs error."""
    g, w = got.detach().double(), want.detach().double()
    diff = (g - w).abs()
    if not bool((diff <= tol.atol + tol.rtol * w.abs()).all()):
        raise AssertionError(f"{what}: max abs error {diff.max().item()!r} outside {tol}")
    return float(diff.max()) if diff.numel() else 0.0


def _topk_compare(args, got, want, tol: Tolerance) -> float:
    """block_topk parity (the JAX ``_topk_compare``): the selected
    magnitudes match as sets (tie order may differ), and every returned
    (value, index) pair is the input's entry at that index: gossip builds
    its global wire indices from these, so a value that does not live at
    its claimed index must fail. Max abs error of the sorted magnitudes."""
    x = args[0]
    (vals, idx), (vals_r, idx_r) = got, want
    for what, i in (("kernel", idx), ("plain", idx_r)):
        if i.numel() and not bool(((i >= 0) & (i < x.shape[1])).all()):
            raise AssertionError(f"block_topk {what} index outside [0, {x.shape[1]})")
    gm = torch.sort(vals.detach().double().abs(), dim=1).values
    wm = torch.sort(vals_r.detach().double().abs(), dim=1).values
    err = _close_on_device(gm, wm, tol, "block_topk magnitudes")
    _close_on_device(torch.gather(x, 1, idx.long()), vals, tol, "block_topk kernel (value, index)")
    _close_on_device(torch.gather(x, 1, idx_r.long()), vals_r, tol,
                     "block_topk plain (value, index)")
    return err


def _compare(spec: KernelSpec, args, got, want) -> float:
    """Hold `got` to `want` within spec's tolerance for the dtype of the
    first floating-point argument; max abs error."""
    dtype = next(
        a.dtype for a in args if isinstance(a, torch.Tensor) and a.is_floating_point()
    )
    tol = spec.tolerance(dtype)
    if spec.compare is not None:
        return spec.compare(args, got, want, tol)
    if isinstance(got, tuple):
        return max(assert_close(g.detach(), w.detach(), tol) for g, w in zip(got, want))
    return assert_close(got.detach(), want.detach(), tol)


register_kernel(KernelSpec(
    name="sparse_dot",
    kernel=_SS.sparse_dot,
    ref=R.sparse_dot_ref,
    meta=_SS.sparse_dot_meta,
    cost=_SS.sparse_dot_cost,
    tol={"float32": Tolerance(1e-5, 1e-5), "float64": Tolerance(1e-12, 1e-12)},
))

register_kernel(KernelSpec(
    name="sparse_axpy",
    kernel=_SS.sparse_axpy,
    ref=R.sparse_axpy_ref,
    meta=_SS.sparse_axpy_meta,
    cost=_SS.sparse_axpy_cost,
    # the CUDA kernel rounds every product and sum explicitly (no FMA) and
    # folds duplicates in k order, so f64 is bit-exact for any rho
    tol={"float32": Tolerance(1e-5, 1e-5), "float64": Tolerance(0.0, 0.0)},
))

register_kernel(KernelSpec(
    name="flash_attention",
    kernel=_FA.flash_attention,
    ref=R.attention_ref,
    meta=_FA.flash_attention_meta,
    cost=_FA.flash_attention_cost,
    tol={"float32": _F32_TOL, "bfloat16": _BF16_TOL},
    grad_tol={"float32": _F32_GRAD_TOL, "bfloat16": _BF16_GRAD_TOL},
))

register_kernel(KernelSpec(
    name="flash_attention_bwd",
    kernel=_FA.flash_attention_bwd,
    ref=R.flash_attention_bwd_ref,
    meta=_FA.flash_attention_bwd_meta,
    cost=_FA.flash_attention_bwd_cost,
    # its outputs are gradients: the grad bars, elementwise and by norm
    tol={"float32": _F32_GRAD_TOL, "bfloat16": _BF16_GRAD_TOL},
    compare=_grad_compare(("dq", "dk", "dv")),
))

register_kernel(KernelSpec(
    name="decode_attention",
    kernel=_DA.decode_attention,
    ref=R.decode_attention_ref,
    meta=_DA.decode_attention_meta,
    cost=_DA.decode_attention_cost,
    tol={"float32": _F32_TOL, "bfloat16": _BF16_TOL},
))

register_kernel(KernelSpec(
    name="block_topk",
    kernel=_TK.block_topk,
    ref=R.block_topk_ref,
    meta=_TK.block_topk_meta,
    cost=_TK.block_topk_cost,
    tol={"float32": Tolerance(1e-6, 1e-6)},
    compare=_topk_compare,
))


register_kernel(KernelSpec(
    name="ssd_chunk",
    kernel=SSD.ssd_chunk,
    ref=R.ssd_chunk_ref,
    meta=SSD.ssd_chunk_meta,
    cost=SSD.ssd_chunk_cost,
    tol={"float32": _F32_TOL, "bfloat16": _BF16_TOL},
    # models/ssm.py always feeds float32: no bf16 gradient bar (as in JAX)
    grad_tol={"float32": _F32_GRAD_TOL},
    plain_dtype=torch.float64,
))

register_kernel(KernelSpec(
    name="ssd_chunk_bwd",
    kernel=SSD.ssd_chunk_bwd,
    ref=R.ssd_chunk_bwd_ref,
    meta=SSD.ssd_chunk_bwd_meta,
    cost=SSD.ssd_chunk_bwd_cost,
    # its outputs are gradients: the grad bar, elementwise and by norm
    tol={"float32": _F32_GRAD_TOL},
    compare=_grad_compare(("dxdt", "dcum", "dB", "dC")),
    plain_dtype=torch.float64,
))


# ---------------------------------------------------------------------------
# public entry points (the JAX package's jitted wrappers; `mode` is its
# `use_pallas`, without 'interpret')
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal=True, window=None, softcap=None, mode: str = "auto"):
    """Registry-dispatched attention, o (B, Hq, S, D) of q (B, Hq, S, D) and
    k, v (B, Hkv, Sk, D); differentiable in every mode (the
    ``FlashAttention`` Function, its backward through the registry's
    ``flash_attention_bwd``, or autograd through the plain version under
    'off')."""
    return dispatch("flash_attention", q, k, v, causal=causal, window=window, softcap=softcap,
                    mode=mode)


def decode_attention(q, k_pool, v_pool, table, lengths, *, window=None, softcap=None,
                     mode: str = "auto"):
    """Registry-dispatched paged single-query decode attention (the serving
    hot path; ``ModelConfig.decode_kernel`` picks the mode): (B, Hq, D)."""
    return dispatch("decode_attention", q, k_pool, v_pool, table, lengths, window=window,
                    softcap=softcap, mode=mode)


def saga_sparse_dot(psi, idx, val, *, mode: str = "auto"):
    """Registry-dispatched per-node sparse dot (DSBA step, eq. 30 input): (N,)."""
    return dispatch("sparse_dot", psi, idx, val, mode=mode)


def saga_sparse_axpy(psi, idx, val, coef, rho, *, mode: str = "auto", compute_dtype=None,
                     node_block: int = 1):
    """Registry-dispatched sparse AXPY row update (the DSBA-s relay's
    densification hot path): (N, D). `compute_dtype` and `node_block` are
    the JAX adapter's (its TPU kernel accumulates in float32 and blocks
    nodes on its grid); the CUDA kernel computes in psi's dtype (the card
    has native float64) and takes one node a grid row, so they have no
    effect."""
    del compute_dtype, node_block
    return dispatch("sparse_axpy", psi, idx, val, coef, rho, mode=mode)


def ssd_chunk(xdt, cum, Bc, Cc, *, mode: str = "auto", head_block=None):
    """Registry-dispatched within-chunk SSD: (y_intra (B, nc, Q, nh, hd),
    chunk states (B, nc, nh, ds, hd)); differentiable in every mode (the
    ``SsdChunk`` Function, or autograd through the plain version under
    'off'). `head_block` is the JAX adapter's; the CUDA kernels group heads
    themselves (any nh), so it has no effect."""
    del head_block
    return dispatch("ssd_chunk", xdt, cum, Bc, Cc, mode=mode)


def topk_blocks(x: torch.Tensor, k: int, *, mode: str = "auto"):
    """Registry-dispatched block-local top-|value| selection (gossip):
    (vals (nb, k), row-local idx (nb, k) int32) of x (nb, block)."""
    return dispatch("block_topk", x, k, mode=mode)
