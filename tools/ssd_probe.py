#!/usr/bin/env python3
"""Probe the CUDA SSD kernels (``src/repro_torch/kernels/csrc/ssd_scan.cu``)
on the card: accuracy against float64 and time, beside a baseline source.

    python3 tools/ssd_probe.py [--baseline OLD.cu] [--mma-ceiling]

- The port's ``ssd_chunk_fwd`` / ``ssd_chunk_bwd`` at the main paths' shapes
  (train, score, serve prefill), fast decay, a ragged shape and unit-scale
  inputs: for each output (y, states, dxdt, dcum, dB, dC) the worst
  |err| / (atol + rtol |want|) against the float64 plain version (1.0 is
  the registry's bar: 2e-5 forward, 2e-4 backward), and the float32 plain
  version's for comparison.
- ``--baseline OLD.cu``: another ``ssd_scan.cu`` with the entry points of the
  CUDA-core kernels it replaced (``ssd_chunk_fwd_f32(xdt, cum, B, C, y, st,
  BC, Q, nh, hd, ds, device, stream)`` and the backward's three launches
  with its scratch) is built beside the port's and held and timed the same
  way, in the same process, in turns (baseline, port, port, baseline).
- ``--mma-ceiling``: the rate of ``mma.sync`` m16n8k8 TF32 in the kernels'
  inner-loop pattern (fragments loaded from shared memory, split hi + lo,
  three products into a fresh tile, added on the CUDA cores), with and
  without the loads and split, at 4 and 8 warps a CTA and two CTAs an SM.

Prints one JSON object a line, with the card's name and power limit first.
Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch

from in_turns import build, cuda_ms, device_ms, emit, emit_device, in_turns  # puts src/ on the path
from repro_torch.kernels import _build
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.kernels.ref import ssd_chunk_bwd_ref, ssd_chunk_ref

SHAPES = {"train": (4, 8, 256, 64, 64, 128), "score": (1, 8, 256, 64, 64, 128),
          "prefill": (1, 1, 256, 64, 64, 128)}
# (name, shape, input scale, log-decay range): what is held to float64
CASES = [(k, v, 0.5, (0.01, 0.2)) for k, v in SHAPES.items()] + [
    ("fast decay", (1, 2, 256, 64, 64, 128), 0.5, (6.0, 8.0)),
    ("ragged", (1, 2, 100, 5, 50, 70), 0.5, (0.01, 0.5)),
    ("unit scale", SHAPES["train"], 1.0, (0.01, 0.2))]
_P, _I = ctypes.c_void_p, ctypes.c_int

MMA_CEILING_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ void mma(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7},"
               " {%8,%9}, {%0,%1,%2,%3};\n" : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}
// LOAD 0: register operands; 1: each k-step's A and B fragments loaded from
// shared memory and split, as in the SSD kernels
template <int LOAD>
__global__ void __launch_bounds__(256) ceiling(float* out, int iters) {
  __shared__ float sm[64 * 72];
  for (int i = threadIdx.x; i < 64 * 72; i += blockDim.x) sm[i] = i * 1e-3f;
  __syncthreads();
  float acc[8][4] = {};
  uint32_t ah[4], al[4], bh[8][2], bl[8][2];
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int r = 0; r < 4; ++r) split(lane * 0.1f + r, ah[r], al[r]);
  for (int n = 0; n < 8; ++n) {
    split(n * 0.3f, bh[n][0], bl[n][0]);
    split(n * 0.7f, bh[n][1], bl[n][1]);
  }
  for (int it = 0; it < iters; ++it) {
    if (LOAD) {
      const int k0 = (it & 7) * 8;
      const float* A = sm + (g + (threadIdx.x >> 5 & 3) * 16) * 68 + k0 + t;
      const float a[4] = {A[0], A[8 * 68], A[4], A[8 * 68 + 4]};
      for (int r = 0; r < 4; ++r) split(a[r], ah[r], al[r]);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float* B = sm + (k0 + t) * 72 + n * 8 + g;
        split(B[0], bh[n][0], bl[n][0]);
        split(B[4 * 72], bh[n][1], bl[n][1]);
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4] = {0.f, 0.f, 0.f, 0.f};
      mma(p, al, bh[n]);
      mma(p, ah, bl[n]);
      mma(p, ah, bh[n]);
      for (int r = 0; r < 4; ++r) acc[n][r] += p[r];
    }
  }
  float s = 0.f;
  for (int n = 0; n < 8; ++n) for (int r = 0; r < 4; ++r) s += acc[n][r];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int run(int load, int blocks, int threads, int iters, float* out, float* ms) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  auto go = [&] {
    if (load) ceiling<1><<<blocks, threads>>>(out, iters);
    else ceiling<0><<<blocks, threads>>>(out, iters);
  };
  go();
  cudaEventRecord(a);
  go();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  cudaEventElapsedTime(ms, a, b);
  return (int)cudaGetLastError();
}
"""


def inputs(shape, scale, decay, seed=40):
    B, nc, Q, nh, hd, ds = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*size):
        return torch.randn(*size, generator=g, device="cuda") * scale

    lo, hi = decay
    cum = -torch.cumsum(torch.rand(B, nc, Q, nh, generator=g, device="cuda") * (hi - lo) + lo,
                        dim=2)
    return ((rnd(B, nc, Q, nh, hd), cum.contiguous(), rnd(B, nc, Q, ds), rnd(B, nc, Q, ds)),
            (rnd(B, nc, Q, nh, hd), rnd(B, nc, nh, ds, hd)))


def baseline_calls(lib):
    """(fwd, bwd) of a baseline library with the CUDA-core kernels' entry points."""
    lib.ssd_chunk_fwd_f32.argtypes = [_P] * 6 + [_I] * 6 + [_P]
    lib.ssd_chunk_bwd_f32.argtypes = [_P] * 11 + [_I] * 6 + [_P]
    lib.ssd_chunk_bwd_scratch_f32.argtypes = [_I] * 5
    lib.ssd_chunk_bwd_scratch_f32.restype = ctypes.c_int64

    def fwd(xdt, cum, Bc, Cc):
        B, nc, Q, nh, hd = xdt.shape
        ds = Bc.shape[-1]
        y, st = torch.empty_like(xdt), torch.empty((B, nc, nh, ds, hd), device="cuda")
        code = lib.ssd_chunk_fwd_f32(*(t.data_ptr() for t in (xdt, cum, Bc, Cc, y, st)),
                                     B * nc, Q, nh, hd, ds, 0, _build.stream(xdt))
        _build.check(lib, code, "baseline ssd forward")
        return y, st

    def bwd(xdt, cum, Bc, Cc, dy, dst):
        B, nc, Q, nh, hd = xdt.shape
        ds = Bc.shape[-1]
        outs = [torch.empty_like(t) for t in (xdt, cum, Bc, Cc)]
        scratch = torch.empty(lib.ssd_chunk_bwd_scratch_f32(B * nc, Q, nh, hd, ds), device="cuda")
        code = lib.ssd_chunk_bwd_f32(*(t.data_ptr() for t in (xdt, cum, Bc, Cc, dy, dst, scratch)),
                                     *(o.data_ptr() for o in outs), B * nc, Q, nh, hd, ds, 0,
                                     _build.stream(xdt))
        _build.check(lib, code, "baseline ssd backward")
        return tuple(outs)

    return fwd, bwd


def bar_ratios(got, want):
    """Per output, the worst |err| / (atol + rtol |want|) at the registry's bars."""
    out = []
    for k, (g, w) in enumerate(zip(got, want)):
        tol = 2e-5 if k < 2 else 2e-4
        w = w.double()
        out.append(float(((g.double() - w).abs() / (tol + tol * w.abs())).max()))
    return out


def mma_ceiling() -> None:
    src = _build.BUILD_DIR / "mma_ceiling.cu"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src.write_text(MMA_CEILING_CU)
    lib = build(src, "mma_ceiling")
    lib.run.argtypes = [_I] * 4 + [_P, _P]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(2 * sms * 256, device="cuda")
    for load in (0, 1):
        for threads in (128, 256):
            ms, iters = ctypes.c_float(), 4000
            code = lib.run(load, 2 * sms, threads, iters, ctypes.c_void_p(out.data_ptr()),
                           ctypes.byref(ms))
            if code or ms.value <= 0:
                raise RuntimeError(f"mma ceiling run failed: CUDA error {code}")
            mmas = 2 * sms * threads // 32 * iters * 8 * 3
            emit("mma_ceiling", {"loads_and_split": bool(load), "warps_a_cta": threads // 32,
                                 "ctas_a_sm": 2, "tf32_tflops": mmas * 2048 / ms.value / 1e9})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--baseline", type=Path, help="another ssd_scan.cu (CUDA-core entry points)")
    ap.add_argument("--mma-ceiling", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    emit_device()
    _build.load_library("ssd_scan")
    base = baseline_calls(build(args.baseline, "ssd_baseline")) if args.baseline else None
    for name, shape, scale, decay in CASES:
        a, c = inputs(shape, scale, decay)
        with torch.no_grad():
            want = ssd_chunk_ref(*(t.double() for t in a)) + ssd_chunk_bwd_ref(
                *(t.double() for t in a + c))
            rec = {"case": name, "shape": list(shape),
                   "port": bar_ratios(SSD.ssd_chunk_fwd(*a) + SSD.ssd_chunk_bwd(*a, *c), want),
                   "plain_f32": bar_ratios(ssd_chunk_ref(*a) + ssd_chunk_bwd_ref(*a, *c), want)}
            if base:
                rec["baseline"] = bar_ratios(base[0](*a) + base[1](*a, *c), want)
        del want
        emit("bar_ratio (y, states, dxdt, dcum, dB, dC)", rec)
    for name, shape in SHAPES.items():
        a, c = inputs(shape, 0.5, (0.01, 0.2))
        it = 50 if name == "prefill" else 20
        runs = {"port": (lambda: SSD.ssd_chunk_fwd(*a), lambda: SSD.ssd_chunk_bwd(*a, *c))}
        if base:
            runs["baseline"] = (lambda: base[0](*a), lambda: base[1](*a, *c))
        order = ["baseline", "port"] if base else ["port"]

        def measure(who):
            f, b = runs[who]
            return {"fwd_ms": cuda_ms(f, it, warmup=3), "bwd_ms": cuda_ms(b, it // 2, warmup=3),
                    "fwd_device_ms": device_ms(f, ("ssd_",), 5),
                    "bwd_device_ms": device_ms(b, ("ssd_",), 5)}
        emit("times", {"shape": name, **in_turns(order, measure, rounds=1)})
    if args.mma_ceiling:
        mma_ceiling()
    return 0


if __name__ == "__main__":
    sys.exit(main())
