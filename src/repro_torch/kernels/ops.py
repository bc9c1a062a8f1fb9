"""Kernel registry, mirroring ``repro.kernels.ops``.

Every kernel is registered once as a :class:`KernelSpec`: its name, the
kernel wrapper, the plain PyTorch version, a per-dtype tolerance policy and
an optional comparator. ``dispatch`` resolves a mode to one of the two and
calls it; ``parity_check`` runs a kernel and its plain version on the same
inputs and asserts agreement within the declared tolerance.

Modes:
  auto  the kernel for a CUDA tensor, the plain version for a CPU tensor
  on    the kernel; a CPU tensor raises (there is no interpreter on a GPU,
        so Pallas' ``interpret`` mode has no counterpart)
  off   the plain version

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

from repro_torch.kernels import ref as R
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
from repro_torch.kernels.sparse_saga import sparse_axpy, sparse_dot
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.kernels.topk_compress import block_topk

MODES = ("auto", "on", "off")


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


def dispatch(name: str, *args, mode: str = "auto", **kwargs):
    """Run kernel `name` on `args` (and keyword options) under `mode`."""
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
    kernel=sparse_dot,
    ref=R.sparse_dot_ref,
    tol={"float32": Tolerance(1e-5, 1e-5), "float64": Tolerance(1e-12, 1e-12)},
))

register_kernel(KernelSpec(
    name="sparse_axpy",
    kernel=sparse_axpy,
    ref=R.sparse_axpy_ref,
    # the CUDA kernel rounds every product and sum explicitly (no FMA) and
    # folds duplicates in k order, so f64 is bit-exact for any rho
    tol={"float32": Tolerance(1e-5, 1e-5), "float64": Tolerance(0.0, 0.0)},
))

register_kernel(KernelSpec(
    name="flash_attention",
    kernel=flash_attention,
    ref=R.attention_ref,
    tol={"float32": _F32_TOL, "bfloat16": _BF16_TOL},
    grad_tol={"float32": _F32_GRAD_TOL, "bfloat16": _BF16_GRAD_TOL},
))

register_kernel(KernelSpec(
    name="flash_attention_bwd",
    kernel=flash_attention_bwd,
    ref=R.flash_attention_bwd_ref,
    # its outputs are gradients: the grad bars, elementwise and by norm
    tol={"float32": _F32_GRAD_TOL, "bfloat16": _BF16_GRAD_TOL},
    compare=_grad_compare(("dq", "dk", "dv")),
))

register_kernel(KernelSpec(
    name="decode_attention",
    kernel=decode_attention,
    ref=R.decode_attention_ref,
    tol={"float32": _F32_TOL, "bfloat16": _BF16_TOL},
))

register_kernel(KernelSpec(
    name="block_topk",
    kernel=block_topk,
    ref=R.block_topk_ref,
    tol={"float32": Tolerance(1e-6, 1e-6)},
    compare=_topk_compare,
))


register_kernel(KernelSpec(
    name="ssd_chunk",
    kernel=SSD.ssd_chunk,
    ref=R.ssd_chunk_ref,
    tol={"float32": _F32_TOL, "bfloat16": _BF16_TOL},
    # models/ssm.py always feeds float32: no bf16 gradient bar (as in JAX)
    grad_tol={"float32": _F32_GRAD_TOL},
    plain_dtype=torch.float64,
))

register_kernel(KernelSpec(
    name="ssd_chunk_bwd",
    kernel=SSD.ssd_chunk_bwd,
    ref=R.ssd_chunk_bwd_ref,
    # its outputs are gradients: the grad bar, elementwise and by norm
    tol={"float32": _F32_GRAD_TOL},
    compare=_grad_compare(("dxdt", "dcum", "dB", "dC")),
    plain_dtype=torch.float64,
))


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
