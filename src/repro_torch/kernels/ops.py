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
1e-12 (f64); ``sparse_axpy`` 1e-5 (f32) and bit-exact (f64).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from repro_torch.kernels import ref as R
from repro_torch.kernels.sparse_saga import sparse_axpy, sparse_dot

MODES = ("auto", "on", "off")


@dataclasses.dataclass(frozen=True)
class Tolerance:
    """An (rtol, atol) parity bound; (0, 0) means bit-exact."""

    rtol: float
    atol: float


_F32_TOL = Tolerance(2e-5, 2e-5)


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
    """

    name: str
    kernel: Callable
    ref: Callable
    tol: dict[str, Tolerance]
    compare: Callable | None = None

    def tolerance(self, dtype) -> Tolerance:
        """Parity tolerance for `dtype` (float32's entry as fallback)."""
        return self.tol.get(dtype_name(dtype), self.tol.get("float32", _F32_TOL))


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


def dispatch(name: str, *args, mode: str = "auto"):
    """Run kernel `name` on `args` under `mode`."""
    return _resolve(name, mode, *args)(*args)


def _max_err(got, want) -> float:
    g = got.detach().double().cpu().numpy()
    w = want.detach().double().cpu().numpy()
    return float(np.max(np.abs(g - w))) if g.size else 0.0


def assert_close(got: torch.Tensor, want: torch.Tensor, tol: Tolerance) -> float:
    """Assert elementwise agreement within `tol` ((0, 0): bit-exact); max abs err."""
    if tol.rtol == 0.0 and tol.atol == 0.0:
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    else:
        np.testing.assert_allclose(
            got.double().cpu().numpy(), want.double().cpu().numpy(),
            rtol=tol.rtol, atol=tol.atol,
        )
    return _max_err(got, want)


def parity_check(name: str, *args, mode: str = "on") -> float:
    """Assert kernel-vs-plain agreement within the declared tolerance.

    Runs `name` under `mode` and under 'off' on the same inputs and
    returns the max abs error. The tolerance is the one for the dtype of
    the first floating-point argument.
    """
    spec = get_kernel(name)
    dtype = next(
        a.dtype for a in args if isinstance(a, torch.Tensor) and a.is_floating_point()
    )
    tol = spec.tolerance(dtype)
    got = dispatch(name, *args, mode=mode)
    want = dispatch(name, *args, mode="off")
    if spec.compare is not None:
        return spec.compare(args, got, want, tol)
    return assert_close(got, want, tol)


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
