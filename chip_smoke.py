#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (``src/repro_torch``) runs on a GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; exits non-zero without a card, and prints
no result then. Imports nothing of JAX or of the JAX package. Phases, each
printed with its seconds:

1. device  -- ``nvidia-smi`` name and power limit, torch's device name/count.
2. build   -- compiles ``src/repro_torch/kernels/csrc/*.cu`` (first use);
   logs ptxas' registers and spills of the flash kernels at head_dim 128
   and 256 (bf16: the wgmma forward and the tensor-core backward; float32:
   the CUDA-core kernels), of block_topk and of the ssd kernels at hd 64,
   the flash kernels' dynamic shared memory at 128 and 256 (the wrapper's
   tile plan) and the ssd plan (head groups, shared memory, grids) at the
   three ssd shapes below.
3. kernels -- every kernel of the main path against its plain PyTorch
   version on the card, at the main path's shapes (rcv1 preset: N=10,
   D=47,236, k=74 for a step; D=47,239, k=7,400 for init_state's phibar
   scatter) and at ragged small shapes, float64 and float32, with
   padded entries and (for sparse_axpy) duplicate indices. float64
   sparse_axpy must be bit-exact, sparse_dot within 1e-12 (float32: 1e-5).
   Times per call from CUDA events after warm-up, beside the plain
   version's time and the least time the card could take (bound);
   sparse_dot in turns with the CSR call, and both calls' host
   microseconds (time.perf_counter over 10,000 calls, no synchronisation).
   block_topk against its plain version, bit for bit (values as bits) and
   by the registry's comparator, one launch a call, at (nb, block, k) =
   (288000, 4096, 40) (the gossip step's embedding leaf: 2 pods x 144,000
   blocks), (7, 2304, 23), (5, 64, 1), (3, 16, 16), (4, 4096, 4096),
   (3, 8193, 81), (2, 8192, 8192), (3, 65536, 655) and (2, 1000003, 10000)
   (the last two streamed), on random rows, rows with many ties, constant
   rows and rows with NaNs of several payloads and signs, +-inf and +-0;
   timed at the first and the last beside the bound, the plain version
   and torch.topk + gather, and at the first under other plans (a warp a
   row, 1-3 stages, 256 candidates). ``chip_smoke.py --topk-profile`` runs
   the block_topk and sparse work of this phase alone (a fresh process).
4. slice   -- the main path: ``solve()`` on the paper's Section-7 setup
   (rcv1 preset, N=10, q=100, Erdos-Renyi(0.4) seed 0, Laplacian W,
   lam = 1/(10 Q)) for dsba and dsa on ridge, logistic and AUC:
   dense for 200 steps on the card, held to the same port run on the CPU
   with the plain kernels (<= 1e-10: cuBLAS sums the 10x10 mixing product
   in another order than the CPU); sparse relay (verify=True) for 100
   steps on the card, held to the dense run (<= 1e-12) and to the
   closed-form steady-state doubles per iteration. The kernel launch
   counts of every run are set to 0 before it and must equal what the
   code predicts after it.
5. profile -- wall and device-busy time per step, the device's idle share
   and the kernels with the most device time (torch.profiler), for dense
   dsba on ridge and logistic and for the ridge relay.
6. widest  -- logistic_news20 (d=1,355,191, k=450) dense dsba, 20 steps.
7. serve   -- minitron-8b at full width (random bf16 weights from a seeded
   torch.Generator on the card) behind ``serve.Scheduler``:
   PoolConfig(max_batch=8, block_size=16, max_len=1024, prompt_pad=256,
   n_blocks=513), 24 requests with prompts of 16-256 tokens and 16-64 new
   tokens (numpy seed 0). Checks: every request finishes with its token
   count; decode_attention launches = decode steps x 32 layers; the pool
   is never reallocated (data_ptr); in the first 4 decode steps every
   layer's decode_attention call is held to the plain version on its own
   inputs (``ops.held_to_plain``, bf16 bar). Reports decode ms per step,
   tokens/s, wall vs device-busy time of a replayed decode step, its idle
   share and its weight-read bound, and (not gated, see 10) the on vs off
   and paged vs contiguous logit differences.
8. attention -- flash_attention and decode_attention against their plain
   versions on the card, bf16 and f32, within the registry bars (2e-2,
   2e-5): flash at S=2048 with minitron-8b's heads (32 q, 8 kv, D=128),
   a ragged S, causal and not, window, softcap, lse included; decode at
   the serve phase's shape (a snapshot of its table and lengths over the
   pool of layer 0, in bf16: its K/V reach ~100, far from the unit scale
   the f32 bar is set for), lengths 0, 1, a partial page and a full table, null
   pages past each length, GQA group 4 and MQA, window and softcap at
   small sizes; at long contexts (minitron-8b's heads, every length
   32,768) the whole batch at B = 8 and 8 of the 128 sequences at the
   reference's decode_32k; two calls bit-equal (the split merge is
   deterministic), with no host sync in a call. Then, in a fresh process
   (``chip_smoke.py --decode-profile LENGTHS``), decode is timed at a
   snapshot of the serve shape (the busiest step's lengths) and at both
   long shapes by CUDA events and by profiler device time, beside the
   bound, the plain version, SDPA over the gathered pages (which only the
   timing table uses) and the plan's splits. gemma2-2b's attention is held
   too (8/4 heads, D=256, causal, window 4096, softcap 50, at S=2048 and at
   S=4608, where the window bites), forward and backward, bf16 and f32.
   Then, in a fresh process (``chip_smoke.py --attention-profile``; late
   in this one torch.profiler has dropped kernel events), the bf16 flash
   forward and backward are timed at D=128 (the score and train shapes)
   and at D=256 (the gossip shape, S=2048): CUDA events, profiler device
   time under the kernels' names (``flash_fwd_wgmma_kernel``; backward
   ``flash_bwd_{dq,dkv}_wgmma_kernel`` at D=128, ``..._mma_kernel`` at
   D=256), the plain
   version, the bound and, at D=128, SDPA forward and backward (at D=256
   SDPA without the softcap is logged only: not the same function).
9. score   -- ``transformer.forward`` at full width, B=1, S=2048: 32
   flash_attention launches, each held to the plain version on its own
   inputs; finite logits of the expected shape.
10. conditioned -- the same weights with the attention projections
   rescaled to 1/sqrt(contracted width) (``condition_attention`` says why:
   with the reference's init the whole-model logits are a chaotic function
   of the attention outputs). Gated end to end: the first 4 serve decode
   steps, decode_kernel "on" vs "off" logits within the bf16 bar on the
   same pool state; request 0's first decode-step logits, paged vs the
   contiguous ``generate``, within the bf16 bar times the layer count
   (the reference's own paged-vs-contiguous rule, tests/test_serve.py);
   forward at S=2048, attention_kernel "on" vs "off" within the bf16 bar.
11. train -- the serve weights are freed; minitron-8b at full width
   (d 4096, 32/8 heads, head_dim 128, d_ff 16384, vocab 256,000) cut to 4
   layers (its float32 train state at 32 layers, 158 GB, fits no card)
   trains 5 steps at B=2, S=2048 through ``batch_at``,
   ``TrainConfig``/``AdamConfig`` and ``train_step``, wired as
   ``launch/train.py`` wires them (remat "full"). Step 0 holds every
   flash_attention forward and flash_attention_bwd call to its plain
   version on its own inputs (bf16 bars 2e-2 and 5e-2; the backward's
   gradients are small, a mean loss over 4,096 tokens, so each of dq, dk,
   dv is also held to 5e-2 in relative norm, and their size is logged);
   steps 1-4 report
   wall time, device-busy time (profiler, step 4), idle share, launches
   per step by kernel (2 forward launches a layer: forward and recompute;
   2 backward launches a layer: dq and dk/dv) and peak memory. Then, on the
   same parameters rescaled by ``condition_attention``, one ``local_grads``
   with attention_kernel "on" against "off": loss within 1e-3 relative,
   every gradient leaf within the bf16 gradient bar (5e-2) in relative
   Frobenius norm, reported layer by layer.
12. gossip -- the train state is freed; gemma2-2b at full width (d 2304,
   8/4 heads, head_dim 256, d_ff 9216, vocab 256,000, tied embedding,
   softcaps 50/30, window 4096 on the local layer) cut 26 -> 2 layers (the
   gossip state is 8 float32 copies a pod: 2 pods x 8 x 2.98 GB = 47.7 GB
   at 2 layers, 167 GB at 26) trains 6 DSBA steps (``core/gossip.py``,
   ``mode="dsba"``, ``compression="block_topk"``, ring of 2 pods, B=1 and
   S=2048 a pod from ``batch_at``, lr 1e-3 constant, bf16 compute, remat
   "full"). Step 0 holds every block_topk call bit for bit and every flash
   forward and backward call within its bar to the plain version; steps
   1-4 are timed (wall, peak memory), step 5 profiled (device busy, idle
   share, top kernels, the update half's elementwise share). Every step:
   launches (11 block_topk, 8 flash forward, 8 flash backward), finite
   loss, grad norm and consensus distance, wire bytes per pod equal to the
   closed form sum of nb * k_b * 8 (58.2 MB against 2.98 GB dense).
   ``chip_smoke.py --gossip-profile`` runs this phase alone and then
   block_topk on the embedding leaf's rows of the next exchange: bit for
   bit, its time, and the shares of rows split in one pass and of rows
   whose boundary bin overflows the candidate lists.
13. launcher -- ``python -m repro_torch.launch.train --reduced`` on the
   card in a subprocess: 6 steps with --ckpt-every 3; the final checkpoint
   is dropped (a crash after step 3's) and a second run resumes from it; its
   final train state must be bit-equal to the uninterrupted run's.
14. gossip example -- ``python -m repro_torch.examples.train_lm_gossip``
   (tiny, 4 pods, topk, a pod killed at step 5, 12 steps, checkpoints every
   4) on the card: the pods shrink to 3, the loss is finite, and a run
   resumed from step 8's checkpoint ends bit-equal.
   The gossip phase also runs the same 6 steps with compression "none"
   and logs their consensus distance (reported, not gated).
15. ssd -- ssd_chunk forward and backward against their plain versions in
   float64 on the same float32 inputs (registry bars 2e-5; 2e-4 elementwise
   and in relative norm), at the score (1, 8, 256, 64, 64, 128), train
   (4, 8, ...) and prefill (1, 1, ...) shapes (B, nc, Q, nh, hd, ds), ragged
   Q (1, 5, 37) and nh (3, 6), and fast decay (a_log in [-8, -6]: every
   output and gradient finite); relative Frobenius errors logged; at unit
   scale the kernel's and the float32 plain version's misses are reported.
16. ssm serve -- mamba2-1.3b at full width and depth (48 layers, d 2048,
   d_inner 4096, 64 heads of 64, state 128, vocab 50,280; random bf16
   weights from seed 0) behind ``serve.Scheduler`` with the serve phase's
   pool and 24 requests. Checks: token counts; no page ever allocated; the
   state pool never reallocated; ssd_chunk launches = prefills x 48 and none
   in decode; every ssd call of the first step's prefills held to the plain
   version; a padded prefill's state equals a prefill of exactly valid_len
   tokens (float32 compute, every layer, the f32 bar); request 0's first
   decode-step logits paged vs the contiguous ``generate`` within the bf16
   bar in relative norm. Reports decode ms, tokens/s, a replayed decode
   step's wall vs device busy, idle share and launches.
17. ssm score -- ``forward`` at B=1, S=2048: 48 ssd_chunk launches, each
   held to the plain version; finite logits; ssm_kernel "on" vs "off"
   within 2e-2 in relative norm.
18. ssm train -- mamba2-1.3b at full width and depth, B=4, S=2048 from
   ``batch_at``, AdamW at the launcher's defaults, remat "full", 5 steps:
   step 0 holds every ssd forward (96) and backward (48) call to the plain
   version; steps 1-4 timed, peak memory; launches asserted every step (96
   forward, 3 x 48 backward); one ``local_grads`` "on" vs "off" (loss within
   1e-3 relative, every gradient leaf within 5e-2 in relative norm). Then,
   in a fresh process (``chip_smoke.py --ssm-profile``; late in this one
   torch.profiler has dropped kernel events), the SSD kernels are timed at
   the train, score and prefill shapes (events and profiler, beside both
   bounds and the plain version) and a train step is profiled (device
   busy, idle share).
Before phase 9, flash_attention_bwd is held to its plain version at the
train shape and at ragged small shapes (every head dim, GQA, MQA, window,
softcap), bf16 and f32 (bars 5e-2, 2e-4); its times come from the
attention-profile process.

Then one ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Any failure raises: no phase catches its
own failure.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.dsba_paper import EXPERIMENTS  # noqa: E402
from repro_torch.core import mixing  # noqa: E402
from repro_torch.core.solvers import get_solver, make_problem, solve  # noqa: E402
from repro_torch.core.sparse_comm import sparse_doubles_per_iter  # noqa: E402
from repro_torch.data.synthetic import (  # noqa: E402
    DATASET_PRESETS, make_classification, make_regression,
)
from repro_torch.ckpt.checkpoint import committed_steps, load_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.sharded_loader import LoaderConfig, batch_at  # noqa: E402
from repro_torch.core.gossip import (  # noqa: E402
    GossipConfig, consensus_distance, init_gossip_state, make_gossip_train_step,
    wire_bytes_per_pod,
)
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention, decode_plan  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    bwd_kernels, flash_attention, flash_attention_bwd, tile_plan,
)
from repro_torch.kernels.ref import (  # noqa: E402
    attention_ref, block_topk_ref, decode_attention_ref, decode_split_ranges,
    flash_attention_bwd_ref, magnitude_key, sparse_axpy_ref, sparse_dot_ref, ssd_chunk_bwd_ref,
    ssd_chunk_ref,
)
from repro_torch.kernels.sparse_saga import sparse_axpy, sparse_dot  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_chunk_bwd, ssd_chunk_fwd, ssd_plan  # noqa: E402
from repro_torch.kernels.topk_compress import block_topk, topk_plan  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map, tree_num_params  # noqa: E402
from repro_torch.optim.adam import AdamConfig  # noqa: E402
from repro_torch.serve import PoolConfig, Request, Scheduler, generate  # noqa: E402
from repro_torch.train.step import TrainConfig, init_train_state, local_grads, train_step  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 rate; float32 and float64
# (non-tensor-core) arithmetic rates and the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.float64: 34e12, torch.bfloat16: 989e12}
# the dense TF32 tensor-core rate: the SSD kernels' products (3 TF32 a float32 product)
TF32 = "tf32"
PEAK_OPS_PER_S[TF32] = 495e12

SOURCES = {
    "sparse_dot": "src/repro_torch/kernels/csrc/sparse_saga.cu",
    "sparse_axpy": "src/repro_torch/kernels/csrc/sparse_saga.cu",
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
    "decode_attention": "src/repro_torch/kernels/csrc/decode_attention.cu",
    "flash_attention_bwd": "src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu",
    "block_topk": "src/repro_torch/kernels/csrc/topk_compress.cu",
    "ssd_chunk": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "ssd_chunk_bwd": "src/repro_torch/kernels/csrc/ssd_scan.cu",
}
REPLACES = {
    "sparse_dot": "src/repro/kernels/sparse_saga.py:56",
    "sparse_axpy": "src/repro/kernels/sparse_saga.py:122",
    "flash_attention": "src/repro/kernels/flash_attention.py:123",
    "decode_attention": "src/repro/kernels/decode_attention.py:116",
    "flash_attention_bwd": "src/repro/kernels/flash_attention.py:314",
    "block_topk": "src/repro/kernels/topk_compress.py:37",
    "ssd_chunk": "src/repro/kernels/ssd_scan.py:72",
    "ssd_chunk_bwd": "src/repro/kernels/ssd_scan.py:177",
}
WRAPPERS = {"sparse_dot": sparse_dot, "sparse_axpy": sparse_axpy,
            "flash_attention": flash_attention, "decode_attention": decode_attention,
            "flash_attention_bwd": flash_attention_bwd, "block_topk": block_topk,
            "ssd_chunk": ssd_chunk_fwd, "ssd_chunk_bwd": ssd_chunk_bwd}
DENSE_TOL_CPU = 1e-10  # card vs CPU: cuBLAS mixing-product summation order
SPARSE_TOL = 1e-12  # relay vs dense (tests/test_sparse_comm.py's bar)


def log(phase: str, msg: str) -> None:
    """One progress line on stdout."""
    print(f"[{phase}] {msg}", flush=True)


def reset_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    for fn in WRAPPERS.values():
        fn.launches = 0


def launches() -> dict[str, int]:
    """Current launch count of every kernel wrapper."""
    return {name: fn.launches for name, fn in WRAPPERS.items()}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_inputs(n, d, k, dtype, device, seed=0, dups=True):
    """Seeded (psi, idx, val, coef, rho) on `device`.

    The last 3 entries of every row are padding (idx 0, val 0). With
    `dups`, indices are drawn with replacement (at k ~ D/6, as in
    init_state's phibar scatter, hundreds of columns repeat, in chunks far
    apart) and entries 1 and k//2 repeat entry 0's index; without, a row's
    indices are distinct.
    """
    pads = 3
    rng = np.random.default_rng(seed)
    psi = rng.standard_normal((n, d))
    if dups:
        idx = rng.integers(0, d, size=(n, k))
    else:
        idx = np.stack([rng.choice(d, size=k, replace=False) for _ in range(n)])
    val = rng.standard_normal((n, k))
    if dups and k > 2:
        idx[:, 1] = idx[:, 0]
        idx[:, k // 2] = idx[:, 0]
    idx[:, k - pads:] = 0
    val[:, k - pads:] = 0.0
    coef = rng.standard_normal(n)
    rho = rng.uniform(0.5, 1.5, n)

    def t(a, dt=dtype):
        return torch.as_tensor(a, dtype=dt, device=device)

    return t(psi), t(idx, torch.int32), t(val), t(coef), t(rho)


def kernel_parity(device, shapes) -> dict[str, float]:
    """Every kernel vs its plain version at each (n, d, k) in `shapes`.

    float64 and float32, with padding; duplicates for sparse_axpy only
    (sparse_dot's data has distinct indices per row). Raises on a miss;
    returns the largest float64 error per kernel at the first shape.
    """
    worst = {}
    for i, (n, d, k) in enumerate(shapes):
        for dtype in (torch.float64, torch.float32):
            args = kernel_inputs(n, d, k, dtype, device, seed=i)
            e_axpy = ops.parity_check("sparse_axpy", *args, mode="auto")
            clean = kernel_inputs(n, d, k, dtype, device, seed=i, dups=False)
            e_dot = ops.parity_check("sparse_dot", *clean[:3], mode="auto")
            if device.type == "cuda":
                torch.cuda.synchronize()
            log("kernels", f"{str(dtype):14s} N={n} D={d} k={k}: "
                f"sparse_axpy max_abs_err={e_axpy!r} "
                f"sparse_dot max_abs_err={e_dot!r}")
            if i == 0 and dtype == torch.float64:
                worst = {"sparse_axpy": e_axpy, "sparse_dot": e_dot}
    return worst


def cuda_ms(fn, iters=200, warmup=20) -> float:
    """Milliseconds per call from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters):
    """Run ``fn`` `iters` times under torch.profiler.

    Returns (device busy microseconds, {kernel name: (device us, count)})
    summed over the CUDA kernel events of the window.
    """
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kern = {e.key: (e.device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}
    return sum(t for t, _ in kern.values()), kern


def kernel_device_ms(fn, names, iters=50, windows=3):
    """Device milliseconds per call of ``fn``: for each CUDA kernel whose
    name contains one of `names`, its mean time per launch in a profiled
    window of `iters` calls, summed over those kernels (each is launched
    once per call). None when no window records every one of them.

    Late in a long process the profiler has come back with fewer kernel
    events than calls, or none: the mean is over the launches it recorded,
    and a window that misses one of the kernels is profiled again, up to
    `windows` times (each shortfall is logged)."""
    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        _, kern = device_profile(fn, iters)
        hits = [(t, c) for key, (t, c) in kern.items() if any(n in key for n in names)]
        if any(c != iters for _, c in hits) or len(hits) != len(names):
            log("profile", f"{names}: {[c for _, c in hits]} kernel events for "
                f"{iters} calls ({len(kern)} kernel names in the window)")
        if len(hits) == len(names):
            return sum(t / c for t, c in hits) / 1e3
    return None


def call_device_ms(fn, iters=50) -> float:
    """Device milliseconds per call of ``fn``, summed over every CUDA kernel
    it launches (profiler), after one warm call."""
    fn()
    torch.cuda.synchronize()
    _, kern = device_profile(fn, iters)
    return sum(t for t, _ in kern.values()) / iters / 1e3


def host_us(fn, calls=10_000) -> float:
    """Host microseconds a call of ``fn``: time.perf_counter over `calls`
    back-to-back calls with no synchronisation (the launch path alone while
    the device keeps up), after one synchronised warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / calls * 1e6


def bound(nbytes: float, nops: float, dtype) -> tuple[float, str]:
    """(least milliseconds, 'bytes' | 'operations') for this much work."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(device, n, d, k, dtype=torch.float64) -> dict[str, dict]:
    """Kernel, plain version and library times at the main path's shape."""
    psi, idx, val, coef, rho = kernel_inputs(n, d, k, dtype, device, dups=False)
    esize = psi.element_size()
    distinct = len({(r, c) for r, row in enumerate(idx.cpu().tolist()) for c in row})
    out = {}

    b_axpy = bound(2 * n * d * esize + n * k * (4 + esize) + 2 * n * esize,
                   n * d + 2 * n * k, dtype)
    out["sparse_axpy"] = {
        "ms": cuda_ms(lambda: sparse_axpy(psi, idx, val, coef, rho)),
        # the kernels' own device time (ms above includes the host's launch
        # path whenever that is slower than the device)
        "device_ms": kernel_device_ms(lambda: sparse_axpy(psi, idx, val, coef, rho),
                                      ("sparse_axpy_kernel",)),
        "plain_ms": cuda_ms(lambda: sparse_axpy_ref(psi, idx, val, coef, rho), iters=50),
        "bound_ms": b_axpy[0], "bound_by": b_axpy[1],
        "library_ms": None,  # no single PyTorch call computes rho*psi + coef*scatter
    }

    b_dot = bound(distinct * esize + n * k * (4 + esize) + n * esize, 2 * n * k, dtype)
    crow = torch.arange(0, n * k + 1, k, device=device)
    cols = (torch.arange(n, device=device)[:, None] * d + idx.long()).reshape(-1)
    csr = torch.sparse_csr_tensor(crow, cols, val.reshape(-1), size=(n, n * d))
    flat = psi.reshape(-1)
    lib_err = (csr @ flat - sparse_dot_ref(psi, idx, val)).abs().max().item()
    if lib_err > 1e-9:
        raise AssertionError(f"CSR library yardstick disagrees: {lib_err}")
    dot = lambda: sparse_dot(psi, idx, val)  # noqa: E731
    csr_dot = lambda: csr @ flat  # noqa: E731
    # events over back-to-back calls, in turns with the CSR call (the two
    # numbers the launch path is held to are taken in this one call)
    ms, lib_ms = [], []
    for _ in range(3):
        ms.append(cuda_ms(dot))
        lib_ms.append(cuda_ms(csr_dot))
    out["sparse_dot"] = {
        "ms": float(np.median(ms)),
        "device_ms": kernel_device_ms(dot, ("sparse_dot_kernel",)),
        "plain_ms": cuda_ms(lambda: sparse_dot_ref(psi, idx, val)),
        "bound_ms": b_dot[0], "bound_by": b_dot[1],
        "library_ms": float(np.median(lib_ms)),  # CSR sparse matrix x vector
        # the CSR call's own device time, every kernel it launches (profiler)
        "library_device_ms": call_device_ms(csr_dot),
        "ms_runs": ms, "library_ms_runs": lib_ms,
        # the host's cost a call: time.perf_counter over 10,000 calls, no sync
        "host_us": host_us(dot), "library_host_us": host_us(csr_dot),
    }
    for name, r in out.items():
        log("kernels", f"{name} N={n} D={d} k={k} {dtype}: {r}")
    return out


# the gossip step's largest selection: gemma2-2b's embedding leaf, 2 pods x
# 144,000 blocks of 4,096, k_b = 40 (1% of a block)
TOPK_MAIN = (2 * 144_000, 4096, 40)
# one long row a pod (a block_size of 1,000,003 at ratio 0.01): the "stream"
# variant, every pass from device memory
TOPK_LONG = (2, 1_000_003, 10_000)
# + final_norm (one block of 2304, k_b 23), the reduced configs' leaves
# (blocks of 64 and 16, k_b 1), k = block (staged and sorted in shared
# memory), blocks above 8,192 (staged at 8,193; stream at 65,536 and at
# TOPK_LONG)
TOPK_CASES = [TOPK_MAIN, (7, 2304, 23), (5, 64, 1), (3, 16, 16), (4, 4096, 4096),
              (3, 8193, 81), (2, 8192, 8192), (3, 65_536, 655), TOPK_LONG]
TOPK_KINDS = ("random", "ties", "constant", "nan")
# NaNs of several payloads and both signs, +-inf, +-0 (as uint32 bits)
TOPK_SPECIALS = (0x7FC00000, 0x7FC00005, 0xFFC00003, 0x7F800001, 0xFF812345, 0x7F800000,
                 0xFF800000, 0x80000000, 0x00000000)


def topk_rows(nb, block, kind, device, seed=0):
    """Seeded float32 rows: normal ('random'), rounded to halves ('ties':
    |x| in {0, 0.5, 1, ...}), constant ('constant': 1.0, odd rows -0.25) or
    normal with block // 100 (at least 1) entries a row replaced by
    ``TOPK_SPECIALS`` ('nan')."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(nb, block, generator=g, device=device)
    if kind == "ties":
        x = torch.round(x * 2) / 2
    elif kind == "constant":
        x = torch.full_like(x, 1.0)
        x[1::2] = -0.25
    elif kind == "nan":
        m = max(1, block // 100)
        bits = torch.tensor(np.array(TOPK_SPECIALS, np.uint32).view(np.int32), device=device)
        pos = torch.randint(0, block, (nb, m), generator=g, device=device)
        pick = torch.randint(0, len(TOPK_SPECIALS), (nb, m), generator=g, device=device)
        x.view(torch.int32).scatter_(1, pos, bits[pick])
    return x


def topk_parity(device) -> float:
    """block_topk against its plain version at every case and kind, one
    launch a call: within the registry's comparator (1e-6; not on 'nan',
    whose NaNs it cannot compare) and bit-equal in values (as bits) and
    indices. Returns the error at the main shape on random rows."""
    spec = ops.get_kernel("block_topk")
    worst = None
    for i, (nb, block, k) in enumerate(TOPK_CASES):
        for kind in TOPK_KINDS:
            x = topk_rows(nb, block, kind, device, seed=i)
            before = block_topk.launches
            got = ops.dispatch("block_topk", x, k, mode="on")
            launched = block_topk.launches - before
            want = ops.dispatch("block_topk", x, k, mode="off")
            torch.cuda.synchronize()
            err = (spec.compare((x, k), got, want, spec.tolerance(x.dtype))
                   if kind != "nan" else None)
            exact = (torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))
                     and torch.equal(got[1], want[1]))
            log("kernels", f"block_topk nb={nb} block={block} k={k} {kind} "
                f"({topk_plan(block, k, nb)['variant']}): max_abs_err={err!r} "
                f"bit_equal={exact} launches={launched}")
            if not exact or launched != 1:
                raise AssertionError(f"block_topk ({nb}, {block}, {k}) {kind}: bit_equal={exact}, "
                                     f"{launched} launches")
            if i == 0 and kind == "random":
                worst = err
            del x, got, want
    return worst


def time_topk_shape(device, shape, iters) -> dict:
    """block_topk at one shape (random rows): kernel by events and by
    profiler device time, plain version, bound and torch.topk + gather (the
    same selection; its tie order may differ, so it is held by the
    registry's comparator, not bit for bit)."""
    nb, block, k = shape
    x = topk_rows(nb, block, "random", device)
    # each input read once, each output written once; one comparison an
    # element is the least work a selection does
    b = bound(4 * nb * block + 8 * nb * k, nb * block, torch.float32)
    kern = lambda: block_topk(x, k)  # noqa: E731

    def lib():
        i = torch.topk(x.abs(), k, dim=1).indices
        return torch.gather(x, 1, i), i.int()

    spec = ops.get_kernel("block_topk")
    spec.compare((x, k), lib(), kern(), spec.tolerance(x.dtype))
    out = {
        "ms": cuda_ms(kern, iters=iters, warmup=3),
        "device_ms": kernel_device_ms(kern, ("block_topk_",), iters=5),
        "plain_ms": cuda_ms(lambda: block_topk_ref(x, k), iters=3, warmup=1),
        "bound_ms": b[0], "bound_by": b[1],
        "library_ms": cuda_ms(lib, iters=max(3, iters // 2), warmup=2),
        "plan": topk_plan(block, k, nb),
    }
    log("kernels", f"block_topk nb={nb} block={block} k={k} float32: {json.dumps(out)}")
    return out


def time_topk(device) -> dict:
    """block_topk at the gossip step's embedding leaf (the kernels line's
    numbers), with the long row's numbers under ``long_row``."""
    out = time_topk_shape(device, TOPK_MAIN, iters=20)
    out["long_row"] = time_topk_shape(device, TOPK_LONG, iters=5)
    return out


# ---------------------------------------------------------------------------
# phases 4-5: the main path through solve()
# ---------------------------------------------------------------------------


def paper_problem(task, d, k, n_nodes=10, q=100, seed=0):
    """The Section-7 problem at preset widths (d, k): the data from_preset makes."""
    if task == "ridge":
        data = make_regression(n_nodes, q, d, k, seed=seed)
    else:
        data = make_classification(n_nodes, q, d, k, seed=seed)
    graph = mixing.erdos_renyi_graph(n_nodes, 0.4, seed=seed)
    return make_problem(task, data, graph)


def expected_launches(steps: int, comm: str) -> dict[str, int]:
    """The kernel launches of one solve(): 1 sparse_axpy call for init,
    4 sparse_axpy + 1 sparse_dot calls a step and 1 more sparse_axpy call a
    relay step; each call of either launches one kernel."""
    axpy_calls = 1 + 4 * steps + (steps if comm == "sparse" else 0)
    return {"sparse_dot": steps, "sparse_axpy": axpy_calls}


def counted_solve(problem, method, comm, device, steps, total, **kw):
    """solve() with the launch counts set to 0 before and checked after."""
    reset_launches()
    res = solve(problem, method, comm, steps=steps, device=device, **kw)
    got = launches()
    if device.type == "cuda":
        want = expected_launches(steps, comm)  # and no other kernel
        if got != {**dict.fromkeys(got, 0), **want} or min(want.values()) == 0:
            raise AssertionError(f"{method}/{comm}: launches {got} != {want}")
        for name, c in got.items():
            total[name] = total.get(name, 0) + c
    if not np.all(np.isfinite(res.z)):
        raise AssertionError(f"{method}/{comm}: non-finite iterates")
    return res


def slice_runs(device, d, k, n_nodes=10, q=100, dense_steps=200,
               sparse_steps=100, record_every=50) -> tuple[dict, list]:
    """The main path: dense and sparse solve() for dsba/dsa x 3 families.

    Returns (launch totals over every run, one summary dict per run pair).
    """
    cpu = torch.device("cpu")
    total, rows = {}, []
    alphas = {t: EXPERIMENTS[f"{t}_rcv1"].alpha for t in ("ridge", "logistic", "auc")}
    for task in ("ridge", "logistic", "auc"):
        problem = paper_problem(task, d, k, n_nodes, q)
        g = problem.graph
        depth = max(3, g.diameter + 2)
        ring_mb = depth * n_nodes * n_nodes * problem.dim * 8 / 1e6
        log("slice", f"{task}: d={d} k={k} N={n_nodes} q={q} "
            f"diameter={g.diameter} ring depth={depth} ring={ring_mb:.1f} MB")
        for method in ("dsba", "dsa"):
            # dsba takes the paper's step size; dsa its solver default
            hp = {"alpha": alphas[task]} if method == "dsba" else {}
            t0 = time.perf_counter()
            dense = counted_solve(problem, method, "dense", device, dense_steps,
                                  total, record_every=record_every,
                                  keep_snapshots=True, **hp)
            t_dense = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref = solve(problem, method, "dense", steps=dense_steps,
                        record_every=record_every, device=cpu, **hp)
            t_cpu = time.perf_counter() - t0
            err_cpu = float(np.max(np.abs(dense.z - ref.z)))
            if err_cpu > DENSE_TOL_CPU:
                raise AssertionError(f"{task}/{method}: card vs CPU {err_cpu}")
            t0 = time.perf_counter()
            sparse = counted_solve(problem, method, "sparse", device, sparse_steps,
                                   total, record_every=record_every,
                                   comm_options={"verify": True}, **hp)
            t_sparse = time.perf_counter() - t0
            at = list(dense.iters).index(sparse_steps)
            err_sparse = float(np.max(np.abs(sparse.z - dense.zs[at])))
            if err_sparse > SPARSE_TOL:
                raise AssertionError(f"{task}/{method}: sparse vs dense {err_sparse}")
            per_iter = np.diff(sparse.doubles_received, axis=0) / np.diff(sparse.iters)[:, None]
            want = sparse_doubles_per_iter(n_nodes, k, problem.spec.tail_dim)
            if not np.all(per_iter[-1] == want):
                raise AssertionError(f"{task}/{method}: doubles/iter {per_iter[-1]} != {want}")
            row = {
                "task": task, "method": method, "alpha": hp.get("alpha", get_solver(method).defaults["alpha"]),
                "dense_card_vs_cpu": err_cpu, "sparse_vs_dense": err_sparse,
                "recon_max_err": sparse.extras["recon_max_err"],
                "doubles_per_iter": int(per_iter[-1][0]), "consensus": float(dense.consensus[-1]),
                "s_dense": t_dense, "s_dense_cpu": t_cpu, "s_sparse": t_sparse,
            }
            rows.append(row)
            log("slice", json.dumps(row))
    return total, rows


def profile_steps(device, d, k, steps=30) -> list[dict]:
    """Where a step's time goes at the paper's rcv1 setup (CUDA only).

    For `steps` dense dsba steps (ridge, logistic) and a `steps`-step ridge
    relay solve: wall ms per step without the profiler (host clock around a
    synchronized run), device busy ms per step from the profiler's kernel
    events, the idle share 1 - busy/wall, kernel launches per step, and the
    five kernels with the most device time.
    """
    from repro_torch.convert import dataset_to_torch
    from repro_torch.core.comm import DenseComm

    i_t = torch.as_tensor(np.random.default_rng(0).integers(0, 100, (steps, 10)),
                          device=device)
    rows = []
    for task in ("ridge", "logistic"):
        problem = paper_problem(task, d, k)
        spec = get_solver("dsba")
        hp = {"alpha": EXPERIMENTS[f"{task}_rcv1"].alpha}
        data = dataset_to_torch(problem.data, device)
        z0 = torch.zeros((10, problem.dim), dtype=torch.float64, device=device)
        state0 = spec.init(problem, hp, data, z0)
        step = spec.step(problem, hp, data, DenseComm(problem.graph, device))

        def run(state=state0, step=step):
            for t in range(steps):
                state = step(state, i_t[t])

        rows.append(_profile_row(f"dense dsba {task}", run, steps))
    problem = paper_problem("ridge", d, k)
    rows.append(_profile_row(
        "relay dsba ridge (whole solve incl. setup)",
        lambda: solve(problem, "dsba", "sparse", steps=steps, device=device),
        steps))
    return rows


def _profile_row(name, run, steps):
    run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / steps
    busy_us, kern = device_profile(run, 1)
    busy_ms = busy_us / 1e3 / steps
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:5]
    row = {"what": name, "wall_ms_per_step": wall_ms,
           "device_busy_ms_per_step": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
           "kernel_launches_per_step": sum(c for _, c in kern.values()) / steps,
           "top_kernels_us_per_step": {key[:70]: t / steps for key, (t, _) in top}}
    log("profile", json.dumps(row))
    return row


def widest_run(device, d, k, steps=20) -> dict:
    """logistic_news20: dense dsba at the widest preset."""
    e = EXPERIMENTS["logistic_news20"]
    problem = paper_problem("logistic", d, k, e.n_nodes, e.q, e.seed)
    t0 = time.perf_counter()
    res = counted_solve(problem, "dsba", "dense", device, steps, {},
                        record_every=steps, alpha=e.alpha)
    out = {"d": d, "k": k, "steps": steps, "seconds": time.perf_counter() - t0,
           "consensus": float(res.consensus[-1]),
           "z_mb": res.z.size * res.z.itemsize / 1e6}
    log("widest", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phases 7-9: the dense model family (attention kernels, serve, score)
# ---------------------------------------------------------------------------

BF16_BAR = ops.get_kernel("decode_attention").tolerance(torch.bfloat16).atol  # 2e-2
SERVE_POOL = PoolConfig(max_batch=8, block_size=16, max_len=1024, prompt_pad=256,
                        n_blocks=8 * 64 + 1)


def within_bf16_bar(got, want) -> bool:
    """|got - want| <= bar + bar * |want| elementwise (the registry's bf16
    Tolerance, rtol = atol = 2e-2), computed on the card."""
    return bool(((got - want).abs() <= BF16_BAR + BF16_BAR * want.abs()).all())


def same_function(got, want) -> bool:
    """A library yardstick computes the same function: relative error norm
    within the bf16 bar (elementwise it rounds at other places, e.g. SDPA
    rounds the probabilities to bf16 before the value product)."""
    return (got - want).float().norm().item() <= BF16_BAR * want.float().norm().item()


def flash_inputs(b, hq, hkv, s, sk, d, dtype, device, seed=0):
    """Seeded (q, k, v) on `device`, heads-major."""
    g = torch.Generator(device=device).manual_seed(seed)

    def t(*shape):
        return torch.randn(*shape, generator=g, device=device).to(dtype)

    return t(b, hq, s, d), t(b, hkv, sk, d), t(b, hkv, sk, d)


def decode_inputs(lengths, hq, hkv, d, n_blocks, bs, n_pages, dtype, device, seed=0):
    """Seeded (q, k_pool, v_pool, table, lengths): distinct pages per
    sequence, the null page 0 past each length."""
    g = torch.Generator(device=device).manual_seed(seed)
    b = len(lengths)
    q = torch.randn(b, hq, d, generator=g, device=device).to(dtype)
    kp = torch.randn(n_blocks, bs, hkv, d, generator=g, device=device).to(dtype)
    vp = torch.randn(n_blocks, bs, hkv, d, generator=g, device=device).to(dtype)
    rng = np.random.default_rng(seed)
    pages = rng.permutation(np.arange(1, n_blocks))
    table = np.zeros((b, n_pages), np.int32)
    used = 0
    for i, n in enumerate(lengths):
        need = -(-n // bs)
        table[i, :need] = pages[used:used + need]
        used += need
    return (q, kp, vp, torch.as_tensor(table, device=device),
            torch.as_tensor(np.asarray(lengths, np.int32), device=device))


# gemma2-2b's attention (8/4 heads, head_dim 256, causal, window 4096,
# softcap 50): the gossip step's shape, and one where the window bites
GEMMA2_ATTENTION = [(1, 8, 4, 2048, 2048, 256, True, 4096, 50.0),
                    (1, 8, 4, 4608, 4608, 256, True, 4096, 50.0)]


def attention_parity(device, decode_main) -> dict[str, float]:
    """Both attention kernels against their plain versions (raises on a
    miss); returns the bf16 error at the main path's shape per kernel."""
    flash_cases = [  # (B, Hq, Hkv, S, Sk, D, causal, window, softcap)
        (1, 32, 8, 2048, 2048, 128, True, None, None),  # the score phase's shape
        (2, 32, 8, 1000, 1000, 128, True, None, None),  # S not a tile multiple
        (1, 8, 2, 333, 333, 128, False, None, None),
        (1, 4, 4, 300, 300, 64, True, 100, None),
        (1, 4, 2, 257, 257, 128, True, None, 50.0),
        (2, 4, 1, 77, 129, 64, False, 40, 30.0),  # S < Sk, window without causal
        *GEMMA2_ATTENTION,
    ]
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for i, (b, hq, hkv, s, sk, d, causal, window, cap) in enumerate(flash_cases):
            q, k, v = flash_inputs(b, hq, hkv, s, sk, d, dtype, device, seed=i)
            err = ops.parity_check("flash_attention", q, k, v, causal=causal,
                                   window=window, softcap=cap, return_lse=True)
            torch.cuda.synchronize()
            log("attention", f"flash {dtype} B={b} Hq={hq} Hkv={hkv} S={s} Sk={sk} D={d} "
                f"causal={causal} window={window} softcap={cap}: max_abs_err={err!r}")
            if i == 0 and dtype == torch.bfloat16:
                worst["flash_attention"] = err
        decode_cases = [  # (lengths, Hq, Hkv, D, n_blocks, bs, n_pages, window, softcap)
            ([0, 1, 17, 1024, 16, 31, 300, 5], 32, 8, 128, 513, 16, 64, None, None),
            ([0, 1, 7, 48], 32, 1, 128, 40, 16, 3, None, None),  # MQA
            ([3, 20, 13, 0], 4, 2, 64, 24, 4, 5, 6, None),
            ([16, 9, 1], 8, 2, 128, 12, 4, 4, None, 15.0),
            ([19, 40, 0], 4, 1, 64, 30, 8, 5, 4, 25.0),
        ]
        for i, (lens, hq, hkv, d, nb, bs, npg, window, cap) in enumerate(decode_cases):
            args = decode_inputs(lens, hq, hkv, d, nb, bs, npg, dtype, device, seed=i)
            err = ops.parity_check("decode_attention", *args, window=window, softcap=cap)
            torch.cuda.synchronize()
            log("attention", f"decode {dtype} lengths={lens} Hq={hq} Hkv={hkv} D={d} "
                f"bs={bs} window={window} softcap={cap}: max_abs_err={err!r}")
    # the serve snapshot in the path's own dtype (its K/V reach ~100, far
    # from the unit scale the float32 bar is set for)
    err = ops.parity_check("decode_attention", *decode_main)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # the wrapper never reads lengths to the host
    try:
        first, second = decode_attention(*decode_main), decode_attention(*decode_main)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    same = torch.equal(first, second)
    torch.cuda.synchronize()
    log("attention", f"decode {decode_main[0].dtype} at the serve snapshot "
        f"lengths={decode_main[4].tolist()}: max_abs_err={err!r} repeat_bit_equal={same}")
    if not same:
        raise AssertionError("decode_attention: two calls on the serve snapshot differ")
    worst["decode_attention"] = err
    decode_long_parity(device)
    return worst


# decode at long contexts with minitron-8b's heads (bf16, 32/8, D=128, pages
# of 16), every length 32,768: B = 8 (1.07 GB of K/V) and the reference's
# decode_32k shape, B = 128 (src/repro/launch/shapes.py; 17.2 GB)
DECODE_LONG = {"b8_32k": (8, 32_768), "decode_32k": (128, 32_768)}


def decode_long_inputs(b, length, device, seed=0):
    """Seeded bf16 (q, k_pool, v_pool, table, lengths), every length
    `length`: minitron-8b's heads, pages of 16 drawn as a random permutation
    of the pool (page 0 stays the null page)."""
    hq, hkv, d, bs = 32, 8, 128, 16
    n_pages = -(-length // bs)
    nb = b * n_pages + 1
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn(b, hq, d, generator=g, device=device).to(torch.bfloat16)
    kp = torch.empty(nb, bs, hkv, d, dtype=torch.bfloat16, device=device).normal_(generator=g)
    vp = torch.empty_like(kp).normal_(generator=g)
    table = (torch.randperm(nb - 1, generator=g, device=device) + 1).int().reshape(b, n_pages)
    lengths = torch.full((b,), length, dtype=torch.int32, device=device)
    return q, kp, vp, table, lengths


def decode_rows(b):
    """The sequences a long shape's plain version is computed for: all of
    them up to 8, else 8 spread over the batch (the plain version's float32
    gather of all 128 of decode_32k would take 34 GB)."""
    return list(range(b)) if b <= 8 else list(range(0, b, b // 8))[:8]


# The long shapes are also held to a relative Frobenius error,
# ||got - want|| / ||want||. With N(0, 1) inputs the softmax over 32,768
# positions is nearly flat, each output element is ~0.009, and the registry's
# bar (0.02 + 0.02 |want|) would pass a kernel that skipped a tile or a whole
# split. Leaving out m of n positions moves the output by ~sqrt(m / n) of its
# norm (0.044 for one 64-position tile of 32,768); rounding the output to
# bf16 moves it by ~0.002.
DECODE_LONG_REL = 0.01


def rel_norm(got, want) -> float:
    """||got - want|| / ||want||, in float32."""
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def decode_long_faults(q, kp, vp, table, lengths, tile, splits) -> dict:
    """The plain version of what a split kernel would give if it left out
    part of each sequence's positions (every length equal): its last tile,
    and, with splits > 1, its first split (a window that starts where the
    second split does). Each must miss DECODE_LONG_REL, which shows that the
    bar catches such a fault at these inputs."""
    length = int(lengths[0])
    faults = {"last tile skipped": decode_attention_ref(q, kp, vp, table, lengths - tile)}
    if splits > 1:
        second = decode_split_ranges(length, table.shape[1] * kp.shape[1], None, tile, splits)[1]
        faults["first split dropped"] = decode_attention_ref(q, kp, vp, table, lengths,
                                                             window=length - second[0])
    return faults


def decode_long_parity(device) -> None:
    """decode_attention at DECODE_LONG against its plain version: the bf16
    bar and DECODE_LONG_REL, over the whole batch at B = 8 and 8 of the 128
    sequences at decode_32k; the plain version of a skipped tile and of a
    dropped split must each miss DECODE_LONG_REL; two calls bit-equal (the
    deterministic merge of the splits)."""
    tol = ops.get_kernel("decode_attention").tolerance(torch.bfloat16)
    for name, (b, length) in DECODE_LONG.items():
        q, kp, vp, table, lengths = decode_long_inputs(b, length, device)
        plan = decode_plan(b, kp.shape[2], q.shape[1] // kp.shape[2], q.shape[2], q.dtype,
                           table.shape[1], kp.shape[1], _build.sm_count(q.device))
        before = decode_attention.launches
        got = decode_attention(q, kp, vp, table, lengths)
        again = decode_attention(q, kp, vp, table, lengths)
        launched = decode_attention.launches - before
        rows = torch.tensor(decode_rows(b), device=device)
        sub = (q[rows], kp, vp, table[rows], lengths[rows])
        want = decode_attention_ref(*sub)
        err = ops.assert_close(got[rows], want, tol)
        rel = rel_norm(got[rows], want)
        faults = {k: rel_norm(v, want) for k, v in
                  decode_long_faults(*sub, plan["tile"], plan["splits"]).items()}
        same = torch.equal(got, again)
        torch.cuda.synchronize()
        log("attention", f"decode bf16 {name} B={b} lengths={length}: max_abs_err={err!r} "
            f"rel_norm={rel!r} (limit {DECODE_LONG_REL}; plain version with a fault: "
            f"{json.dumps(faults)}) over {len(rows)} sequences, repeat_bit_equal={same}, "
            f"launches={launched}, splits={plan['splits']}")
        if not same or launched != 2:
            raise AssertionError(f"decode {name}: repeat_bit_equal={same}, {launched} launches")
        if not rel <= DECODE_LONG_REL:
            raise AssertionError(f"decode {name}: relative error {rel} > {DECODE_LONG_REL}")
        if not min(faults.values()) > DECODE_LONG_REL:
            raise AssertionError(f"decode {name}: a fault's plain version is within "
                                 f"{DECODE_LONG_REL}: {faults}")
        del q, kp, vp, table, lengths, got, again, want, sub
        torch.cuda.empty_cache()


def decode_split_count(q, kp, table) -> int:
    """The splits decode_attention's plan takes for these inputs."""
    b, hq, d = q.shape
    hkv = kp.shape[2]
    return decode_plan(b, hkv, hq // hkv, d, q.dtype, table.shape[1], kp.shape[1],
                       _build.sm_count(q.device))["splits"]


# the bf16 kernels' names in the profiler (the main paths' dtype): the
# forward's, and the backward's two at a head dim (wgmma at 64 and 128,
# mma.sync at 16, 32 and 256)
FLASH_FWD_KERNELS = ("flash_fwd_wgmma_kernel",)


def flash_bwd_kernels(d: int) -> tuple[str, ...]:
    """The bf16 backward's kernel names at head dim `d` (dq, then dk/dv)."""
    return tuple(bwd_kernels(tile_plan(torch.bfloat16, d)))


def time_attention(device) -> dict:
    """The flash forward at the score phase's shape (bf16, B=1, 32/8 heads,
    S=2048, D=128, causal): kernel, plain version and SDPA, beside the bound."""
    b, hq, hkv, s, d = 1, 32, 8, 2048, 128
    q, k, v = flash_inputs(b, hq, hkv, s, s, d, torch.bfloat16, device)
    pairs = b * hq * s * (s + 1) // 2  # causal: what this run's mask keeps
    bound_f = bound(2 * (q.numel() + k.numel() + v.numel() + q.numel()) + 4 * b * hq * s,
                    4 * pairs * d, torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_out, plain_out = sdpa(q, k, v, is_causal=True, enable_gqa=True), attention_ref(q, k, v)
    if not same_function(lib_out, plain_out):
        raise AssertionError("SDPA yardstick disagrees with the plain version: "
                             f"{(lib_out.float() - plain_out.float()).abs().max().item()}")
    out = {
        "ms": cuda_ms(lambda: flash_attention(q, k, v), iters=50, warmup=5),
        "device_ms": kernel_device_ms(lambda: flash_attention(q, k, v), FLASH_FWD_KERNELS,
                                      iters=10),
        "plain_ms": cuda_ms(lambda: attention_ref(q, k, v), iters=5, warmup=1),
        "bound_ms": bound_f[0], "bound_by": bound_f[1],
        "library_ms": cuda_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True),
                              iters=50, warmup=5),
    }
    log("attention-profile", f"flash_attention D=128: {json.dumps(out)}")
    return out


DECODE_KERNELS = ("flash_decode_kernel",)


def time_decode_shape(device, args, label, iters) -> dict:
    """decode_attention (bf16) on `args`: CUDA events, profiler device time,
    the bound, the plain version (on ``decode_rows`` of the batch: the
    share it covers is logged) and SDPA over the pages gathered beforehand
    (the gather is not timed; skipped when the card lacks the memory)."""
    qd, kp, vp, table, lengths = args
    B, Hq, D = qd.shape
    hkv = kp.shape[2]
    live = int(lengths.clamp(min=0).sum())
    esize = kp.element_size()
    bound_d = bound(2 * qd.numel() * esize + 2 * live * hkv * D * esize
                    + 4 * (table.numel() + B), 4 * Hq * D * live, torch.bfloat16)
    rows = torch.tensor(decode_rows(B), device=device)
    sub = (qd[rows], kp, vp, table[rows], lengths[rows])
    kern = lambda: decode_attention(*args)  # noqa: E731
    out = {
        "ms": cuda_ms(kern, iters=iters, warmup=max(3, iters // 10)),
        "device_ms": kernel_device_ms(kern, DECODE_KERNELS, iters=min(50, iters)),
        "plain_ms": cuda_ms(lambda: decode_attention_ref(*sub), iters=max(3, iters // 10),
                            warmup=1),
        "plain_rows": f"{len(rows)} of {B}",
        "bound_ms": bound_d[0], "bound_by": bound_d[1],
        "library_ms": None,
        "splits": decode_split_count(qd, kp, table),
        "live_positions": live,
    }
    L = table.shape[1] * kp.shape[1]
    gathered = 2 * B * L * hkv * D * esize
    if torch.cuda.mem_get_info(device)[0] > 1.5 * gathered + (2 << 30):
        kg = kp[table.long()].reshape(B, L, hkv, D).transpose(1, 2)
        vg = vp[table.long()].reshape(B, L, hkv, D).transpose(1, 2)
        mask = (torch.arange(L, device=device)[None] < lengths[:, None].long())[:, None, None]
        sdpa = torch.nn.functional.scaled_dot_product_attention
        lib = lambda: sdpa(qd[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True)  # noqa: E731
        lib_out = lib()[rows, :, 0].float()
        plain_out = decode_attention_ref(*sub).float()
        if not same_function(lib_out, plain_out):
            raise AssertionError(f"SDPA decode yardstick disagrees at {label}: "
                                 f"{(lib_out - plain_out).abs().max().item()}")
        out["library_ms"] = cuda_ms(lib, iters=iters, warmup=max(3, iters // 10))
        del kg, vg, mask, lib_out, plain_out
        torch.cuda.empty_cache()
    log("decode-profile", f"decode_attention {label}: {json.dumps(out)}")
    return out


# the busiest decode step's lengths (+1: the token being decoded) of the
# serve phase (1,862 live positions), for a --decode-profile run on its
# own; the full run passes the ones its serve phase logged
SERVE_BUSIEST_LENGTHS = [170, 251, 253, 238, 285, 194, 247, 224]


def decode_profile(device, lengths=None) -> dict:
    """``chip_smoke.py --decode-profile [LENGTHS_JSON]`` (a fresh process;
    late in the main process torch.profiler drops kernel events):
    decode_attention at a serve snapshot (minitron-8b's heads over the serve
    pool's shape, the busiest step's `lengths`), at B = 8 and at decode_32k
    (every length 32,768): events, device time, bound, plain version, SDPA
    where memory allows, splits."""
    log("decode-profile", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    built = _build.build_all()
    log("decode-profile", "ptxas: " + json.dumps(
        {k: v for k, v in ptxas_report(built).items() if k.startswith("flash_decode")}))
    lengths = lengths or SERVE_BUSIEST_LENGTHS
    snap = decode_inputs(lengths, 32, 8, 128, SERVE_POOL.n_blocks, SERVE_POOL.block_size,
                         SERVE_POOL.max_len // SERVE_POOL.block_size, torch.bfloat16, device)
    out = time_decode_shape(device, snap, "serve snapshot", iters=200)
    out["lengths"] = list(lengths)
    del snap
    out["long"] = {}
    for name, (b, length) in DECODE_LONG.items():
        args = decode_long_inputs(b, length, device)
        out["long"][name] = time_decode_shape(device, args, name,
                                              iters=50 if b <= 8 else 10)
        del args
        torch.cuda.empty_cache()
    return out


def serve_requests(cfg, n=24, seed=0) -> list[Request]:
    """`n` requests: prompts of 16-256 tokens, 16-64 new tokens."""
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size, int(rng.integers(16, 257))),
                    int(rng.integers(16, 65))) for i in range(n)]


def on_vs_off_decode(sch, cfg, checked_steps, errs, first_step):
    """A decode_fn for `sch` that, for the first `checked_steps` decode
    steps, runs the step with decode_kernel "off" first and records the max
    abs logit difference of the live slots to the "on" step that follows
    ("on" rewrites the same pool entries, so both read one pool state);
    it keeps request 0's first decode-step logits in `first_step`."""
    cfg_off = dataclasses.replace(cfg, decode_kernel="off")
    inner = sch.decode_fn

    def decode_fn(params, tokens, pools, table, lengths):
        check = len(errs) < checked_steps
        if check:
            _, want = T.decode_step_paged(cfg_off, params, tokens, pools, table, lengths)
        out = inner(params, tokens, pools, table, lengths)
        live = list(sch._admit_order)
        if check:
            errs.append(((out[1][live] - want[live]).abs().max().item(),
                         within_bf16_bar(out[1][live], want[live])))
        for slot in live:
            st = sch.active[slot]
            if st.req.rid == 0 and len(st.generated) == 1:
                first_step["logits"] = out[1][slot].float().clone()
        return out

    return decode_fn


def serve_phase(device, cfg, params) -> tuple[dict, tuple, dict]:
    """The Scheduler at full width with the port's own random init.

    Hard checks: tokens, launches, an unmoved pool, and each layer's
    decode_attention call of the first 4 decode steps held to the plain
    version on its own inputs. The end-to-end logit differences (on vs off,
    paged vs contiguous) are reported: with this init they are chaotic (see
    ``conditioned_phase``). Returns (summary, decode snapshot (q, k_pool,
    v_pool, table, lengths) of layer 0 at the busiest step, launches).
    """
    sch = Scheduler(cfg, params, SERVE_POOL, device=device)
    ptrs = sch.pool.data_ptrs()
    reqs = serve_requests(cfg)
    mode_errs, first_step, busiest, layer_errs = [], {}, {}, []
    compare = on_vs_off_decode(sch, cfg, 4, mode_errs, first_step)

    def decode_fn(params_, tokens, pools, table, lengths):
        if len(layer_errs) < 4:
            with ops.held_to_plain("decode_attention") as errs:
                out = compare(params_, tokens, pools, table, lengths)
            layer_errs.append(max(errs))
        else:
            out = compare(params_, tokens, pools, table, lengths)
        live_tokens = int(lengths.sum())
        if live_tokens > busiest.get("live", -1):
            busiest.update(live=live_tokens, table=table.clone(), lengths=lengths.clone(),
                           tokens=tokens.clone())
        return out

    sch.decode_fn = decode_fn
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, stats = sch.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = launches()
    want = stats.decode_steps * cfg.n_layers
    if got["decode_attention"] != want or want == 0:
        raise AssertionError(f"decode_attention launches {got} != {want}")
    if got["flash_attention"] != 0:  # prefill passes a cache: the inline path
        raise AssertionError(f"flash_attention launched in the serve phase: {got}")
    for r in reqs:
        toks = results[r.rid]
        if toks.shape != (r.max_new_tokens,) or not np.all((0 <= toks) & (toks < cfg.vocab_size)):
            raise AssertionError(f"request {r.rid}: tokens {toks.shape}")
    if sch.pool.data_ptrs() != ptrs:
        raise AssertionError("the pool was reallocated")
    r0 = reqs[0]
    gen = generate(cfg, params, torch.as_tensor(r0.tokens, device=device)[None],
                   max_new_tokens=1)
    paged_err = (first_step["logits"] - gen.logits[1][0]).abs().max().item()

    # a decode step at the busiest state, replayed: wall without the
    # profiler, device busy with it (the pages are free again, so the
    # replay's writes land in unused pages)
    args = (params, busiest["tokens"], sch.pool.pools, busiest["table"], busiest["lengths"])
    step = lambda: T.decode_step_paged(cfg, *args)  # noqa: E731
    step()
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    step_wall = (time.perf_counter() - t0) * 1e3 / n
    busy_us, kern = device_profile(step, n)
    step_busy = busy_us / 1e3 / n
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params)
                       if t.dtype == cfg.compute_dtype)
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:6]
    n_tokens = int(sum(len(v) for v in results.values()))
    summary = {
        "requests": len(reqs), "tokens": n_tokens,
        "decode_steps": stats.decode_steps, "preemptions": stats.preemptions,
        "peak_active": stats.peak_active, "peak_occupancy": stats.peak_occupancy,
        "wall_s": wall, "tokens_per_s": n_tokens / wall,
        "decode_ms_per_step_incl_admission": wall * 1e3 / stats.decode_steps,
        "kernel_vs_plain_per_layer_max_abs": layer_errs,
        "reported_on_vs_off_logits_max_abs": [e for e, _ in mode_errs],
        "reported_on_vs_off_within_bar": [ok for _, ok in mode_errs],
        "reported_paged_vs_contiguous_max_abs": paged_err,
        "reported_paged_vs_contiguous_same_first_token": int(gen.tokens[0, 0]) == int(results[0][0]),
        "busiest_live_tokens": busiest["live"],
        "decode_step_wall_ms": step_wall, "decode_step_device_ms": step_busy,
        "decode_step_idle_share": 1.0 - step_busy / step_wall,
        "decode_step_launches": sum(c for _, c in kern.values()) / n,
        "weight_bytes_read_per_step": weight_bytes,
        "decode_step_bound_ms": weight_bytes / HBM_BYTES_PER_S * 1e3,
        "top_kernels_us_per_step": {key[:60]: t / n for key, (t, _) in top},
    }
    log("serve", json.dumps(summary))
    gen_q = torch.Generator(device=device).manual_seed(1)
    snap = (torch.randn(SERVE_POOL.max_batch, cfg.n_heads, cfg.head_dim, device=device,
                        generator=gen_q).to(cfg.compute_dtype),
            sch.pool.pools["k"][0], sch.pool.pools["v"][0],
            busiest["table"], busiest["lengths"] + 1)
    return summary, snap, got


def score_tokens(cfg, device, s):
    """One seeded (1, s) token batch."""
    return torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (1, s)),
                           device=device)


def score_phase(device, cfg, params, s=2048) -> tuple[dict, dict]:
    """forward() at full width, B=1, with the port's own random init: 32
    flash_attention launches, each held to the plain version on its own
    inputs; finite logits. The on vs off logit difference is reported."""
    tokens = score_tokens(cfg, device, s)
    cfg_on = dataclasses.replace(cfg, attention_kernel="on")
    cfg_off = dataclasses.replace(cfg, attention_kernel="off")
    T.forward(cfg_on, params, tokens[:, :128])  # warm-up (cuBLAS plans)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on = T.forward(cfg_on, params, tokens)
    torch.cuda.synchronize()
    t_on = time.perf_counter() - t0
    got = launches()
    if got["flash_attention"] != cfg.n_layers or got["decode_attention"] != 0:
        raise AssertionError(f"score launches {got}: want {cfg.n_layers} flash_attention")
    if on.shape != (1, s, cfg.vocab_size) or not torch.isfinite(on).all():
        raise AssertionError(f"score logits {tuple(on.shape)} not finite")
    with ops.held_to_plain("flash_attention") as layer_errs:
        T.forward(cfg_on, params, tokens)
    if len(layer_errs) != cfg.n_layers:
        raise AssertionError(f"{len(layer_errs)} flash calls held to the plain version")
    t0 = time.perf_counter()
    off = T.forward(cfg_off, params, tokens)
    torch.cuda.synchronize()
    t_off = time.perf_counter() - t0
    out = {"B": 1, "S": s, "seconds_on": t_on, "seconds_off": t_off,
           "tokens_per_s_on": s / t_on,
           "kernel_vs_plain_per_layer_max_abs": max(layer_errs),
           "reported_on_vs_off_logits_max_abs": (on - off).abs().max().item(),
           "reported_on_vs_off_within_bar": within_bf16_bar(on, off),
           "logits_abs_max": off.abs().max().item()}
    log("score", json.dumps(out))
    return out, got


def condition_attention(cfg, params) -> None:
    """Rescale the attention projections in place to a 1/sqrt(fan_in) init
    over the contracted width (d_model for wq, wk, wv; q_dim for wo).

    The reference's ParamDef takes shape[-2] as fan_in, which for the 3-D
    attention weights is the head count (32, 8) or head_dim (128): at
    minitron-8b's width the scores then have a standard deviation of about
    256, softmax is nearly an argmax, and a one-ulp bf16 change of one
    layer's attention output flips later layers' argmax: whole-model logits
    are a chaotic function of the attention outputs. With this scale the
    scores are O(1) and logits are a smooth function of them."""
    attn = params["blocks"]["attn"]
    d, q_dim = cfg.d_model, cfg.q_dim
    with torch.no_grad():
        attn["wq"].mul_(math.sqrt(cfg.n_heads / d))
        attn["wk"].mul_(math.sqrt(cfg.n_kv_heads / d))
        attn["wv"].mul_(math.sqrt(cfg.n_kv_heads / d))
        attn["wo"].mul_(math.sqrt(cfg.head_dim / q_dim))


def conditioned_phase(device, cfg, params, s=2048) -> dict:
    """End-to-end logit checks on the conditioned weights (hard checks):
    the first 4 serve decode steps on vs off within the bf16 bar; request
    0's first decode step, paged vs the contiguous generate(), within the
    bf16 bar times the layer count (test_serve.py's rule for logits that see
    one attention tolerance through every layer); forward at S=2048 on vs
    off within the bf16 bar."""
    condition_attention(cfg, params)
    sch = Scheduler(cfg, params, SERVE_POOL, device=device)
    reqs = serve_requests(cfg)
    for r in reqs:
        sch.submit(r)
    mode_errs, first_step = [], {}
    sch.decode_fn = on_vs_off_decode(sch, cfg, 4, mode_errs, first_step)
    for _ in range(4):
        sch.step()
    if not all(ok for _, ok in mode_errs) or len(mode_errs) != 4:
        raise AssertionError(f"decode on vs off logits outside the bf16 bar: {mode_errs}")
    gen = generate(cfg, params, torch.as_tensor(reqs[0].tokens, device=device)[None],
                   max_new_tokens=1)
    slot0 = next(sl for sl, st in sch.active.items() if st.req.rid == 0)
    if int(gen.tokens[0, 0]) != int(sch.active[slot0].generated[0]):
        raise AssertionError("request 0: paged and contiguous prefill pick other tokens")
    paged_err = (first_step["logits"] - gen.logits[1][0]).abs().max().item()
    paged_bar = BF16_BAR * cfg.n_layers
    if paged_err > paged_bar:
        raise AssertionError(f"request 0: paged vs contiguous {paged_err} > {paged_bar}")
    tokens = score_tokens(cfg, device, s)
    on = T.forward(dataclasses.replace(cfg, attention_kernel="on"), params, tokens)
    off = T.forward(dataclasses.replace(cfg, attention_kernel="off"), params, tokens)
    if not within_bf16_bar(on, off):
        raise AssertionError(f"score on vs off {(on - off).abs().max().item()}")
    out = {"decode_on_vs_off_logits_max_abs": [e for e, _ in mode_errs],
           "paged_vs_contiguous_max_abs": paged_err, "paged_vs_contiguous_bar": paged_bar,
           "score_on_vs_off_max_abs": (on - off).abs().max().item(),
           "score_on_vs_off_rel_norm": ((on - off).norm() / off.norm()).item(),
           "score_logits_abs_max": off.abs().max().item()}
    log("conditioned", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phases 11-12: training (flash_attention_bwd, the train step, the launcher)
# ---------------------------------------------------------------------------

TRAIN_LAYERS, TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 2, 2048, 5
GRAD_BAR = ops.get_kernel("flash_attention").grad_tolerance(torch.bfloat16).atol  # 5e-2


def flash_bwd_parity(device) -> float:
    """flash_attention_bwd against its plain version (raises on a miss);
    returns the bf16 error at the train step's shape."""
    cases = [  # (B, Hq, Hkv, S, Sk, D, causal, window, softcap)
        (TRAIN_B, 32, 8, TRAIN_S, TRAIN_S, 128, True, None, None),  # the train step's shape
        (2, 32, 8, 1000, 1000, 128, True, None, None),  # S not a tile multiple
        (1, 8, 2, 333, 333, 128, False, None, None),
        (1, 4, 4, 300, 300, 64, True, 100, None),
        (1, 4, 2, 257, 257, 128, True, None, 50.0),
        (2, 4, 1, 77, 129, 64, False, 40, 30.0),  # S < Sk, window without causal
        (1, 4, 2, 130, 130, 256, True, None, None),
        (2, 4, 2, 64, 64, 16, True, 7, None),  # the launcher's reduced head_dim
        *GEMMA2_ATTENTION,
    ]
    worst = None
    for dtype in (torch.bfloat16, torch.float32):
        for i, (b, hq, hkv, s, sk, d, causal, window, cap) in enumerate(cases):
            q, k, v = flash_inputs(b, hq, hkv, s, sk, d, dtype, device, seed=10 + i)
            do = flash_inputs(b, hq, hq, s, s, d, dtype, device, seed=30 + i)[0]
            o, lse = flash_attention(q, k, v, causal, window, cap, return_lse=True)
            err = ops.parity_check("flash_attention_bwd", q, k, v, o, lse, do, causal=causal,
                                   window=window, softcap=cap)
            torch.cuda.synchronize()
            log("attention", f"flash_bwd {dtype} B={b} Hq={hq} Hkv={hkv} S={s} Sk={sk} D={d} "
                f"causal={causal} window={window} softcap={cap}: max_abs_err={err!r}")
            if i == 0 and dtype == torch.bfloat16:
                worst = err
    return worst


def time_flash_bwd(device) -> dict:
    """flash_attention_bwd at the train step's shape (bf16): kernel, plain
    version and SDPA's backward, beside the bound."""
    b, hq, hkv, s, d = TRAIN_B, 32, 8, TRAIN_S, 128
    q, k, v = flash_inputs(b, hq, hkv, s, s, d, torch.bfloat16, device)
    do = flash_inputs(b, hq, hq, s, s, d, torch.bfloat16, device, seed=1)[0]
    o, lse = flash_attention(q, k, v, return_lse=True)
    pairs = b * hq * s * (s + 1) // 2  # causal: what this run's mask keeps
    # five products of the causal band (s, dp, dq, dk, dv), 2 ops a multiply-add;
    # reads q, k, v, o, do, lse once, writes dq, dk, dv once
    nbytes = 2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + o.numel() + do.numel()) \
        + 4 * lse.numel()
    bound_b = bound(nbytes, 10 * pairs * d, torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    out = sdpa(*leaves, is_causal=True, enable_gqa=True)
    lib = lambda: torch.autograd.grad(out, leaves, do, retain_graph=True)  # noqa: E731
    plain = flash_attention_bwd_ref(q, k, v, o, lse, do)
    for got, want in zip(lib(), plain):
        if not same_function(got, want):
            raise AssertionError("SDPA backward yardstick disagrees with the plain version: "
                                 f"{(got.float() - want.float()).abs().max().item()}")
    del plain
    kern = lambda: flash_attention_bwd(q, k, v, o, lse, do)  # noqa: E731
    out_t = {
        "ms": cuda_ms(kern, iters=20, warmup=3),
        "device_ms": kernel_device_ms(kern, flash_bwd_kernels(d), iters=5),
        "plain_ms": cuda_ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do), iters=3,
                            warmup=1),
        "bound_ms": bound_b[0], "bound_by": bound_b[1],
        "library_ms": cuda_ms(lib, iters=20, warmup=3),
    }
    split = {n: kernel_device_ms(kern, (n,), iters=5) for n in flash_bwd_kernels(d)}
    log("attention-profile", f"flash_attention_bwd D=128: {json.dumps(out_t)}; device ms by "
        f"kernel {json.dumps(split)}")
    return out_t


def train_config():
    """minitron-8b at full width, cut to TRAIN_LAYERS layers."""
    return dataclasses.replace(get_config("minitron-8b"), n_layers=TRAIN_LAYERS)


def expected_train_launches(cfg) -> dict[str, int]:
    """Kernel launches of one train step with remat 'full': the forward
    kernel twice a layer (forward, recompute), the backward's two kernels
    once a layer, and no other kernel."""
    want = dict.fromkeys(WRAPPERS, 0)
    want.update(flash_attention=2 * cfg.n_layers, flash_attention_bwd=2 * cfg.n_layers)
    return want


def train_phase(device) -> tuple[dict, dict, dict]:
    """TRAIN_STEPS steps of the launcher's wiring at full width.

    Returns (summary, launches over every step, the train state)."""
    cfg = train_config()
    tc = TrainConfig(optimizer=AdamConfig())  # launch/train.py's defaults
    ld = LoaderConfig(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, tc, 0, device)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    state_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves({"p": state["params"], "o": state["opt"]})) / 1e9
    log("train", f"{cfg.name} x{cfg.n_layers} layers, {cfg.param_count()} params, "
        f"train state (params, mu, nu) {state_gb:.2f} GB, drawn in {t_init:.1f} s")
    want = expected_train_launches(cfg)
    total = dict.fromkeys(WRAPPERS, 0)
    losses, gnorms, walls, per_step = [], [], [], []

    def one_step(i):
        nonlocal state
        before = launches()
        state, m = train_step(cfg, tc, state, batch_at(ld, i))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        got = {n: c - before[n] for n, c in launches().items()}
        if got != want:
            raise AssertionError(f"train step {i}: launches {got} != {want}")
        for n, c in got.items():
            total[n] += c
        per_step.append({n: c for n, c in got.items() if c})

    reset_launches()
    t0 = time.perf_counter()
    with ops.held_to_plain("flash_attention") as fwd_errs, \
            ops.held_to_plain("flash_attention_bwd") as bwd_errs:
        one_step(0)
    torch.cuda.synchronize()
    t_held = time.perf_counter() - t0
    if len(fwd_errs) != 2 * cfg.n_layers or len(bwd_errs) != cfg.n_layers:
        raise AssertionError(f"step 0 held {len(fwd_errs)} forward and {len(bwd_errs)} "
                             "backward calls to the plain version")
    peak_step0 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(1, TRAIN_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step(i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    busy_us, kern = device_profile(lambda: one_step(TRAIN_STEPS - 1), 1)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"train losses {losses} grad norms {gnorms}")
    wall_ms = float(np.median(walls)) * 1e3
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:8]
    summary = {
        "layers": cfg.n_layers, "B": TRAIN_B, "S": TRAIN_S, "tokens_per_step": TRAIN_B * TRAIN_S,
        "train_state_gb": state_gb, "losses": losses, "grad_norms": gnorms,
        "step0_s_held_to_plain": t_held,
        "step0_flash_fwd_vs_plain_max_abs": fwd_errs, "step0_flash_bwd_vs_plain_max_abs": bwd_errs,
        # the gradients' own size beside their errors (a mean loss over
        # 4,096 tokens makes them small), and the scale-free error held to
        # the same bar
        "step0_flash_bwd_plain_max_abs_grad": bwd_errs.scale,
        "step0_flash_bwd_vs_plain_rel_norm": bwd_errs.rel,
        "step0_flash_fwd_vs_plain_rel_norm": fwd_errs.rel,
        "step_wall_ms": [w * 1e3 for w in walls], "step_wall_ms_median": wall_ms,
        "tokens_per_s": TRAIN_B * TRAIN_S / (wall_ms / 1e3),
        "step_device_busy_ms": busy_us / 1e3, "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
        "kernel_launches_per_step_profiled": sum(c for _, c in kern.values()),
        # the profiler has dropped kernel events late in long runs: these
        # counts, against port_kernel_launches_per_step, say whether it did
        "profiled_port_kernels": {key[:40]: c for key, (_, c) in kern.items()
                                  if "flash_" in key and "_kernel" in key},
        "port_kernel_launches_per_step": per_step[-1],
        "peak_gb_steps_1_4": peak / 1e9, "peak_gb_step0_held": peak_step0 / 1e9,
        "top_kernels_us_per_step": {key[:60]: t for key, (t, _) in top},
    }
    log("train", json.dumps(summary))
    return summary, total, state


def train_on_off(state) -> dict:
    """One local_grads with attention_kernel "on" against "off" on the train
    parameters after ``condition_attention`` (hard checks: loss within 1e-3
    relative, every gradient leaf within the bf16 gradient bar in relative
    Frobenius norm; per-layer norms reported)."""
    cfg = train_config()
    del state["opt"]  # the moments are not needed here: room for two gradients
    gc.collect()
    torch.cuda.empty_cache()
    params = state["params"]
    condition_attention(cfg, params)
    tc = TrainConfig(optimizer=AdamConfig())
    batch = batch_at(LoaderConfig(cfg.vocab_size, TRAIN_B, TRAIN_S, seed=0), 0)
    l_on, g_on = local_grads(dataclasses.replace(cfg, attention_kernel="on"), tc, params, batch)
    l_off, g_off = local_grads(dataclasses.replace(cfg, attention_kernel="off"), tc, params,
                               batch)
    loss_rel = abs(float(l_on) - float(l_off)) / abs(float(l_off))
    rel, per_layer = {}, {}

    def walk(a, b, path=()):
        if isinstance(a, dict):
            for key in a:
                walk(a[key], b[key], (*path, key))
            return
        name = "/".join(path)
        rel[name] = ((a - b).norm() / b.norm()).item()
        if path[0] == "blocks":
            per_layer[name] = [((a[i] - b[i]).norm() / b[i].norm()).item()
                               for i in range(a.shape[0])]

    walk(g_on, g_off)
    out = {"loss_on": float(l_on), "loss_off": float(l_off), "loss_rel": loss_rel,
           "grad_rel_norm": rel, "grad_rel_norm_per_layer": per_layer}
    log("train", f"on vs off: {json.dumps(out)}")
    if loss_rel > 1e-3 or max(rel.values()) > GRAD_BAR:
        raise AssertionError(f"train on vs off: loss {loss_rel}, worst leaf "
                             f"{max(rel, key=rel.get)} {max(rel.values())}")
    return out


def run_module(phase, tag, cmd) -> str:
    """Run `cmd` (a ``python -m`` of the port) from the repo root with the
    port on the path; raise on a non-zero exit; returns its stdout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    log(phase, f"{tag}: rc={r.returncode} in {time.perf_counter() - t0:.1f} s\n"
        f"{r.stdout.strip()}")
    if r.returncode != 0:
        raise AssertionError(f"{phase} {tag} failed:\n{r.stderr[-4000:]}")
    return r.stdout


def bit_equal_checkpoints(d, step, full) -> None:
    """The committed checkpoint `step` in `d` has `full`'s leaves, bit for bit."""
    _, _, resumed = load_checkpoint(d, step)
    if set(full) != set(resumed):
        raise AssertionError("resumed checkpoint has other leaves")
    differ = [p for p in full if full[p].tobytes() != resumed[p].tobytes()]
    if differ:
        raise AssertionError(f"resume is not bit-equal at {differ[:5]}")


def launcher_phase() -> dict:
    """``launch/train.py --reduced`` on the card in subprocesses: an
    uninterrupted 6-step run, then a run resumed from its step-3 checkpoint
    (the final one dropped) must end bit-equal."""
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.launch.train", "--reduced", "--steps", "6",
               "--ckpt-every", "3", "--batch", "2", "--seq", "64", "--ckpt-dir", d]
        run = lambda tag: run_module("launcher", tag, cmd)  # noqa: E731
        run("uninterrupted")
        if committed_steps(d) != [3, 6]:
            raise AssertionError(f"checkpoints {committed_steps(d)}")
        _, _, full = load_checkpoint(d, 6)
        shutil.rmtree(Path(d) / "step_6")  # a crash after the step-3 checkpoint
        stdout = run("resumed")
        if "resumed from step 3" not in stdout:
            raise AssertionError("the second run did not resume from step 3")
        bit_equal_checkpoints(d, 6, full)
        out = {"leaves": len(full), "bit_equal": True, "final_step": int(full["['step']"])}
    log("launcher", json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phases 13-14: DSBA gossip training (block_topk, flash at head_dim 256)
# ---------------------------------------------------------------------------

GOSSIP_LAYERS, GOSSIP_S, GOSSIP_STEPS = 2, 2048, 6
# dsba's constant step size here (the gossip example's 0.5 is for its tiny
# model): at 1e-3, 6 steps of gemma2-2b at full width stay finite
GOSSIP_LR = 1e-3


def gossip_setup():
    """(model config, TrainConfig, GossipConfig) of the gossip phase:
    gemma2-2b at full width cut to one local/global layer pair, 2 pods on a
    ring, dsba with block_topk compression through the kernel."""
    cfg = dataclasses.replace(get_config("gemma2-2b"), n_layers=GOSSIP_LAYERS,
                              attention_kernel="on")
    gcfg = GossipConfig(n_pods=2, topology="ring", mode="dsba", compression="block_topk",
                        topk_ratio=0.01, block_size=4096, kernel_mode="on")
    return cfg, TrainConfig(optimizer=AdamConfig(lr=GOSSIP_LR)), gcfg


def expected_gossip_launches(cfg, gcfg) -> dict[str, int]:
    """Kernel launches of one gossip step: one block_topk a leaf (both pods
    in one call), per pod the flash forward twice a layer (forward and remat
    recompute) and the backward's two kernels once a layer."""
    want = dict.fromkeys(WRAPPERS, 0)
    per_pods = 2 * cfg.n_layers * gcfg.n_pods
    want.update(block_topk=len(tree_leaves(T.model_defs(cfg))), flash_attention=per_pods,
                flash_attention_bwd=per_pods)
    return want


GOSSIP_RANGES = ("gossip_grads", "gossip_update")


def top_by_prefix(times: dict[str, float], n: int, width: int = 90) -> dict[str, float]:
    """The `n` largest of {kernel name: us}, names cut to `width` characters
    and the times of names that then coincide summed."""
    out: dict[str, float] = {}
    for name, t in times.items():
        out[name[:width]] = out.get(name[:width], 0.0) + t
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:n])


def profile_ranges(fn):
    """One call of ``fn`` under torch.profiler: (device busy us, {kernel:
    (us, count)}, {range: (span us, busy us)}, {range: {kernel: us}}). The
    ranges are the gossip step's record_function halves; a range's span is
    its extent on the device timeline, its busy time the summed durations
    of the kernels that start inside it."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kern = {e.key: (e.device_time_total, e.count) for e in prof.key_averages()
            if e.device_type == cuda and e.key not in GOSSIP_RANGES}
    events = [e for e in prof.events() if e.device_type == cuda]
    kernels = [e for e in events if e.name not in GOSSIP_RANGES]
    ranges, by_range = {}, {}
    for r in (e for e in events if e.name in GOSSIP_RANGES):
        lo, hi = r.time_range.start, r.time_range.end
        inside = [e for e in kernels if lo <= e.time_range.start < hi]
        ranges[r.name] = (hi - lo, sum(e.time_range.elapsed_us() for e in inside))
        per = by_range.setdefault(r.name, {})
        for e in inside:
            per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us()
    return sum(t for t, _ in kern.values()), kern, ranges, by_range


def gossip_phase(device, topk_rows: bool = False) -> tuple[dict, dict]:
    """GOSSIP_STEPS dsba steps of gemma2-2b at full width on 2 pods.

    Step 0 holds every block_topk (bit for bit), flash forward and flash
    backward call to its plain version; steps 1-4 are timed; step 5 is
    profiled. Every step: launches per kernel as predicted, finite loss,
    grad norm and consensus distance, wire bytes equal to the closed form.
    `topk_rows` (``--gossip-profile``) adds ``gossip_topk_rows``.
    Returns (summary, launches over every step)."""
    cfg, tc, gcfg = gossip_setup()
    full = get_config("gemma2-2b")
    n = tree_num_params(T.model_defs(cfg))
    n_full = tree_num_params(T.model_defs(full))
    copies = 2 * gcfg.n_pods + 6 * gcfg.n_pods  # params, mu, nu, prev, g_prev, 3 streams
    log("gossip", f"{cfg.name} cut {full.n_layers} -> {cfg.n_layers} layers: {n} params, "
        f"{4 * n / 1e9:.2f} GB a float32 copy ({4 * n_full / 1e9:.2f} GB at {full.n_layers}); "
        f"the state of {gcfg.n_pods} pods is {copies} copies, {copies * 4 * n / 1e9:.1f} GB "
        f"({copies * 4 * n_full / 1e9:.1f} GB at {full.n_layers} layers)")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_gossip_state(cfg, tc, gcfg, 0, device)
    torch.cuda.synchronize()
    state_gb = sum(t.numel() * t.element_size() for t in tree_leaves(state)) / 1e9
    log("gossip", f"state {state_gb:.2f} GB drawn in {time.perf_counter() - t0:.2f} s")
    step_fn = make_gossip_train_step(None, cfg, tc, gcfg)
    ld = LoaderConfig(cfg.vocab_size, gcfg.n_pods * 1, GOSSIP_S, n_shards=gcfg.n_pods)
    shapes = [d.shape for d in tree_leaves(T.model_defs(cfg))]
    wire = wire_bytes_per_pod(shapes, gcfg)
    want = expected_gossip_launches(cfg, gcfg)
    total = dict.fromkeys(WRAPPERS, 0)
    rows, walls, per_step = [], [], []

    def one_step(i):
        nonlocal state
        before = launches()
        b = {k: np.asarray(v).reshape(gcfg.n_pods, 1, GOSSIP_S)
             for k, v in batch_at(ld, i).items()}
        state, m = step_fn(state, b)
        got = {k: c - before[k] for k, c in launches().items()}
        if got != want:
            raise AssertionError(f"gossip step {i}: launches {got} != {want}")
        for k, c in got.items():
            total[k] += c
        per_step.append(m)

    def record(i):
        m = per_step[i]
        row = {"step": i, "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "consensus_distance": float(consensus_distance(state["params"])),
               "wire_bytes_per_pod": int(m["wire_bytes_per_pod"])}
        log("gossip", json.dumps(row))
        if not all(math.isfinite(row[k]) for k in ("loss", "grad_norm", "consensus_distance")):
            raise AssertionError(f"gossip step {i}: not finite {row}")
        if row["wire_bytes_per_pod"] != wire:
            raise AssertionError(f"gossip step {i}: wire bytes {row['wire_bytes_per_pod']} "
                                 f"!= the closed form {wire}")
        rows.append(row)

    reset_launches()
    t0 = time.perf_counter()
    with ops.held_to_plain("block_topk") as tk, ops.held_to_plain("flash_attention") as fwd, \
            ops.held_to_plain("flash_attention_bwd") as bwd:
        one_step(0)
    torch.cuda.synchronize()
    t_held = time.perf_counter() - t0
    record(0)
    held = (len(tk), len(fwd), len(bwd))
    if held != (want["block_topk"], want["flash_attention"], want["flash_attention_bwd"] // 2):
        raise AssertionError(f"step 0 held {held} block_topk, flash, flash_bwd calls")
    if not all(tk.exact):
        raise AssertionError(f"block_topk calls not bit-equal to the plain version: {tk.exact}")
    peak_step0 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(1, GOSSIP_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step(i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        record(i)
    peak = torch.cuda.max_memory_allocated()
    busy_us, kern, ranges, by_range = profile_ranges(lambda: one_step(GOSSIP_STEPS - 1))
    record(GOSSIP_STEPS - 1)
    wall_ms = float(np.median(walls)) * 1e3
    busy_ms = busy_us / 1e3
    topk_us = sum(t for k, (t, _) in kern.items() if "block_topk_" in k)
    update_us = ranges["gossip_update"][1] if "gossip_update" in ranges else None
    top = top_by_prefix({k: t for k, (t, _) in kern.items()}, 10)
    top_update = top_by_prefix(by_range.get("gossip_update", {}), 8)
    summary = {
        "layers": cfg.n_layers, "pods": gcfg.n_pods, "B_per_pod": 1, "S": GOSSIP_S,
        "tokens_per_step": gcfg.n_pods * GOSSIP_S, "lr": GOSSIP_LR, "state_gb": state_gb,
        "steps": rows, "step0_s_held_to_plain": t_held,
        "step0_block_topk_vs_plain_max_abs": list(tk), "step0_block_topk_bit_equal": tk.exact,
        "step0_flash_fwd_vs_plain_max_abs": list(fwd), "step0_flash_fwd_rel_norm": fwd.rel,
        "step0_flash_bwd_vs_plain_max_abs": list(bwd), "step0_flash_bwd_rel_norm": bwd.rel,
        "step0_flash_bwd_plain_max_abs_grad": bwd.scale,
        "wire_bytes_per_pod_closed_form": wire,
        "dense_bytes_per_pod": 4 * n, "wire_share_of_dense": wire / (4 * n),
        "step_wall_ms": [w * 1e3 for w in walls], "step_wall_ms_median": wall_ms,
        "step_device_busy_ms": busy_ms, "idle_share": 1.0 - busy_ms / wall_ms,
        "tokens_per_s": gcfg.n_pods * GOSSIP_S / (wall_ms / 1e3),
        "port_kernel_launches_per_step": {k: c for k, c in want.items() if c},
        "kernel_launches_per_step_profiled": sum(c for _, c in kern.values()),
        "range_span_and_busy_ms": {k: [v / 1e3 for v in t] for k, t in ranges.items()},
        "block_topk_device_ms": topk_us / 1e3,
        # the update half's kernels without the selection: the exchange's
        # and the update's elementwise passes, index_add_ included
        "update_elementwise_device_ms": (update_us - topk_us) / 1e3 if update_us else None,
        "update_elementwise_share": (update_us - topk_us) / busy_us if update_us else None,
        "top_update_kernels_us": top_update,
        "peak_gb_steps_1_4": peak / 1e9, "peak_gb_step0_held": peak_step0 / 1e9,
        "top_kernels_us_per_step": top,
    }
    if topk_rows:
        summary["block_topk_rows"] = gossip_topk_rows(state, gcfg)
    log("gossip", json.dumps(summary))
    del state
    gc.collect()
    torch.cuda.empty_cache()
    summary["reported_consensus_without_compression"] = uncompressed_consensus(device, ld)
    return summary, total


def gossip_topk_rows(state, gcfg) -> dict:
    """The rows the next gossip step's largest selection takes: the
    embedding leaf's residual 2 theta - theta_prev - theta_hat of both pods,
    in blocks. block_topk's time on them (held bit for bit to the plain
    version) beside the random rows' at the same shape, and what sets it:
    the share of rows whose first-digit boundary equals that of the row
    their CTA took before (those are split in one pass), and the share
    whose boundary bin overflows a warp's candidate list (those refine the
    whole row). A diagnosis (``--gossip-profile`` only): it mirrors the
    kernel's partition (4 warps' contiguous quarters, STAGED_CAP / 4
    candidates a warp, the first digit as key >> 23)."""
    p, pp, rec = max(zip(tree_leaves(state["params"]), tree_leaves(state["params_prev"]),
                         tree_leaves(state["recon"])), key=lambda t: t[0].numel())
    block = gcfg.block_size
    k = max(1, int(block * gcfg.topk_ratio))
    x = (2 * p - pp - rec[:, 0]).float().reshape(-1, block)
    nb = x.shape[0]
    plan = topk_plan(block, k, nb)
    w = plan["warps"]
    d0 = torch.empty(nb, dtype=torch.int32, device=x.device)
    over = 0
    for lo in range(0, nb, 16_384):
        key = magnitude_key(x[lo:lo + 16_384])
        d0[lo:lo + 16_384] = torch.topk(key, k, dim=1).values[:, -1] >> 23
        part = ((key >> 23) == d0[lo:lo + 16_384, None]).view(-1, w, block // w).sum(-1)
        over += int((part.max(1).values > plan["cap"] // w).sum())
        del key, part
    got, want = block_topk(x, k), block_topk_ref(x, k)
    if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
        raise AssertionError("block_topk on the gossip rows: not bit-equal")
    del got, want
    g = plan["grid"]
    out = {"shape": [nb, block, k], "ms": cuda_ms(lambda: block_topk(x, k), iters=10, warmup=2),
           "guess_hit_share": float((d0[g:] == d0[:-g]).float().mean()),
           "list_overflow_share": over / nb,
           "boundary_digits": torch.unique(d0, return_counts=True)[0].tolist()[:16]}
    log("gossip", f"block_topk on the embedding leaf's residual rows: {json.dumps(out)}")
    return out


def uncompressed_consensus(device, ld) -> list[float]:
    """The consensus distance of the same GOSSIP_STEPS steps with
    compression "none" (reported, not gated): the compressed run's growth
    comes from its cold CHOCO reconstructions, which start at zero while
    the params sit at a nonzero consensus (the reference's init, kept for
    parity), not from replicas drifting on their own data."""
    cfg, tc, gcfg = gossip_setup()
    gcfg = dataclasses.replace(gcfg, compression="none")
    state = init_gossip_state(cfg, tc, gcfg, 0, device)
    step_fn = make_gossip_train_step(None, cfg, tc, gcfg)
    dist = []
    for i in range(GOSSIP_STEPS):
        b = {k: np.asarray(v).reshape(gcfg.n_pods, 1, GOSSIP_S)
             for k, v in batch_at(ld, i).items()}
        state, _ = step_fn(state, b)
        dist.append(float(consensus_distance(state["params"])))
    log("gossip", f"compression none, reported: consensus distance {dist}")
    del state
    gc.collect()
    torch.cuda.empty_cache()
    return dist


def gossip_launcher_phase() -> dict:
    """The gossip example on the card (tiny model, 4 pods, topk, a pod
    killed at step 5, checkpoints every 4 steps): the pods shrink to 3; a
    second run, from step 8's checkpoint after the final one is dropped,
    ends bit-equal."""
    with tempfile.TemporaryDirectory() as d:
        cmd = [sys.executable, "-m", "repro_torch.examples.train_lm_gossip", "--model", "tiny",
               "--pods", "4", "--compression", "topk", "--kill-pod-at", "5", "--steps", "12",
               "--ckpt-every", "4", "--ckpt-dir", d]
        out = run_module("gossip-example", "uninterrupted", cmd)
        if "[ft] pod killed at step 5: continuing with 3 pods" not in out:
            raise AssertionError("the example did not shrink to 3 pods")
        if committed_steps(d) != [4, 8, 12]:
            raise AssertionError(f"checkpoints {committed_steps(d)}")
        _, meta, full = load_checkpoint(d, 12)
        if meta != {"n_pods": 3} or full["['params']/['embed']"].shape[0] != 3:
            raise AssertionError(f"final checkpoint: {meta}")
        losses = [float(line.split()[3]) for line in out.splitlines()
                  if line.startswith("step")]
        if not losses or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"example losses {losses}")
        shutil.rmtree(Path(d) / "step_12")  # a crash after the step-8 checkpoint
        out = run_module("gossip-example", "resumed", cmd)
        if "resumed from step 8" not in out or "pods=3" not in out:
            raise AssertionError("the second run did not resume from step 8 with 3 pods")
        bit_equal_checkpoints(d, 12, full)
        summary = {"leaves": len(full), "bit_equal": True, "pods_after_kill": 3,
                   "losses": losses}
    log("gossip-example", json.dumps(summary))
    return summary

# ---------------------------------------------------------------------------
# phases 15-18: the ssm family (mamba2-1.3b; ssd_chunk forward and backward)
# ---------------------------------------------------------------------------

# (B, nc, Q, nh, hd, ds) of the ssd calls on the main paths: the score phase
# (B=1, S=2048), the train step (B=4, S=2048) and a serve prefill (S=256)
SSD_MAIN = {"score": (1, 8, 256, 64, 64, 128), "train": (4, 8, 256, 64, 64, 128),
            "prefill": (1, 1, 256, 64, 64, 128)}
# ragged: Q of 1, 5 and 37, nh of 3 and 6; the reduced models' widths
SSD_RAGGED = [(1, 1, 1, 3, 64, 128), (2, 1, 5, 6, 64, 128), (1, 2, 37, 3, 64, 128),
              (1, 3, 37, 6, 16, 16)]
# inputs at the model's scale: xdt, B and C are conv + silu outputs (std ~0.5
# at init); at unit scale and Q = 256 even the float32 plain version misses
# the 2e-5 bar against float64 on some elements (reported, not gated)
SSD_SCALE = 0.5
SSD_BAR = ops.get_kernel("ssd_chunk").tolerance(torch.float32)
SSD_GRAD_BAR = ops.get_kernel("ssd_chunk_bwd").tolerance(torch.float32)
SSM_TRAIN_B, SSM_TRAIN_S, SSM_TRAIN_STEPS = 4, 2048, 5


def ssd_inputs(shape, device, seed=0, scale=SSD_SCALE, decay=(0.01, 0.2)):
    """Seeded ((xdt, cum, Bc, Cc), (dy, dst)) float32 on `device`; cum is
    the inclusive cumsum of -uniform(decay) log-decays within each chunk."""
    B, nc, Q, nh, hd, ds = shape
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*size):
        return torch.randn(*size, generator=g, device=device) * scale

    lo, hi = decay
    cum = -torch.cumsum(torch.rand(B, nc, Q, nh, generator=g, device=device) * (hi - lo) + lo,
                        dim=2)
    return ((rnd(B, nc, Q, nh, hd), cum.contiguous(), rnd(B, nc, Q, ds), rnd(B, nc, Q, ds)),
            (rnd(B, nc, Q, nh, hd), rnd(B, nc, nh, ds, hd)))


def _bar_ratio(got, want, tol) -> float:
    """The largest |got - want| / (atol + rtol |want|): 1.0 is the bar."""
    w = want.double()
    return float(((got.double() - w).abs() / (tol.atol + tol.rtol * w.abs())).max())


def _outside_bar(got, want, tol) -> int:
    """Elements of got farther from want than atol + rtol |want|."""
    w = want.double()
    return int(((got.double() - w).abs() > tol.atol + tol.rtol * w.abs()).sum())


def ssd_parity(device) -> dict[str, float]:
    """ssd_chunk forward and backward against their plain versions in
    float64 on the same float32 inputs (the registry does the upcast), at
    the main paths' shapes, ragged shapes and under fast decay (a_log in
    [-8, -6]: every output and gradient finite); the relative Frobenius
    errors are logged. Returns the train shape's max abs errors."""
    worst = {}
    cases = [(name, shape, (0.01, 0.2)) for name, shape in SSD_MAIN.items()]
    cases += [(f"ragged {shape}", shape, (0.01, 0.5)) for shape in SSD_RAGGED]
    cases.append(("fast decay", (1, 2, 256, 64, 64, 128), (6.0, 8.0)))
    for i, (name, shape, decay) in enumerate(cases):
        args, cts = ssd_inputs(shape, device, seed=40 + i, decay=decay)
        e_f = ops.parity_check("ssd_chunk", *args, mode="on")
        e_b = ops.parity_check("ssd_chunk_bwd", *args, *cts, mode="on")
        out = ssd_chunk_fwd(*args) + ssd_chunk_bwd(*args, *cts)
        torch.cuda.synchronize()
        if not all(bool(torch.isfinite(t).all()) for t in out):
            raise AssertionError(f"ssd {name}: non-finite outputs or gradients")
        with torch.no_grad():
            want = (ssd_chunk_ref(*(a.double() for a in args))
                    + ssd_chunk_bwd_ref(*(a.double() for a in args + cts)))
        rel = [ops.rel_err(g, w) for g, w in zip(out, want)]
        ratio = [_bar_ratio(g, w, SSD_BAR if k < 2 else SSD_GRAD_BAR)
                 for k, (g, w) in enumerate(zip(out, want))]
        del want
        log("ssd", f"{name} {shape}: forward max_abs_err={e_f!r} backward max_abs_err={e_b!r} "
            f"rel_norm (y, states, dxdt, dcum, dB, dC)={rel} worst |err| / (atol + rtol |want|) "
            f"{ratio}")
        if name == "train":
            worst = {"ssd_chunk": e_f, "ssd_chunk_bwd": e_b}
    # unit-scale inputs at the train shape (reported): the kernel and the
    # float32 plain version against float64, elements outside the bars
    args, cts = ssd_inputs(SSD_MAIN["train"], device, seed=7, scale=1.0)
    with torch.no_grad():
        want = ssd_chunk_ref(*(a.double() for a in args))
        got, plain32 = ssd_chunk_fwd(*args), ssd_chunk_ref(*args)
        unit = {"kernel_outside_bar": [_outside_bar(g, w, SSD_BAR) for g, w in zip(got, want)],
                "plain_f32_outside_bar": [_outside_bar(g, w, SSD_BAR)
                                          for g, w in zip(plain32, want)],
                "kernel_max_abs_err": [(g.double() - w).abs().max().item()
                                       for g, w in zip(got, want)],
                "plain_f32_max_abs_err": [(g.double() - w).abs().max().item()
                                          for g, w in zip(plain32, want)],
                "kernel_equals_plain_f32_bitwise": [torch.equal(g, p)
                                                    for g, p in zip(got, plain32)],
                "elements": [w.numel() for w in want]}
    del want, got, plain32
    log("ssd", f"unit-scale inputs at the train shape, forward (reported): {json.dumps(unit)}")
    return worst


def ssd_bounds(shape) -> dict[str, dict]:
    """The least time (ms) the card could take for one forward and one
    backward call at `shape`. Operations counted for the causal pairs
    i >= j that the function needs: the scores (2 ds a pair), per head
    2 hd a pair for y (forward) and for dM and dxdt (backward), 2 Q ds hd
    for the chunk state (forward) and for each of its two gradient terms
    (backward), and dscores -> dB, dC (4 ds a pair). Bytes: each input read
    once, each output written once. Two rates for these float32 products:
    the CUDA cores' float32 peak (``bound_fp32_ms``), and three TF32
    tensor-core products a product at the TF32 peak, the split the kernels
    use (``bound_ms``, the lesser: the least time for float32-accurate
    products on this card)."""
    B, nc, Q, nh, hd, ds = shape
    bc, pairs = B * nc, Q * (Q + 1) // 2
    fwd_ops = bc * (pairs * 2 * ds + nh * (pairs * 2 * hd + 2 * Q * ds * hd))
    bwd_ops = bc * (3 * pairs * 2 * ds + nh * (2 * pairs * 2 * hd + 2 * 2 * Q * ds * hd))
    x, c, bcd, st = bc * Q * nh * hd, bc * Q * nh, bc * Q * ds, bc * nh * ds * hd
    fwd_bytes = 4 * (x + c + 2 * bcd + x + st)
    bwd_bytes = 4 * (x + c + 2 * bcd + x + st + x + c + 2 * bcd)
    out = {}
    for name, nbytes, nops in (("ssd_chunk", fwd_bytes, fwd_ops),
                               ("ssd_chunk_bwd", bwd_bytes, bwd_ops)):
        fp32, tf32 = bound(nbytes, nops, torch.float32), bound(nbytes, 3 * nops, TF32)
        out[name] = {"bound_ms": tf32[0], "bound_by": tf32[1], "bound_fp32_ms": fp32[0],
                     "gflop": nops / 1e9, "bound_counts": "3 TF32 products a float32 product"}
    return out


def time_ssd(device) -> dict[str, dict]:
    """Both SSD kernels at each main-path shape (train, score, serve
    prefill): CUDA events, profiler device time, the plain version (float32,
    on the card) and the bounds. The kernels line carries the train shape's
    numbers, and every shape's under ``shapes``. No single PyTorch call
    computes them: library "none"."""
    fwd_names = ("ssd_fwd_kernel",)
    bwd_names = ("ssd_bwd_rows_kernel", "ssd_bwd_cols_kernel", "ssd_bwd_finish_kernel")
    out = {"ssd_chunk": {"shapes": {}}, "ssd_chunk_bwd": {"shapes": {}}}
    for label in ("train", "score", "prefill"):
        shape = SSD_MAIN[label]
        args, cts = ssd_inputs(shape, device)
        bounds = ssd_bounds(shape)
        fwd = lambda: ssd_chunk_fwd(*args)  # noqa: E731
        bwd = lambda: ssd_chunk_bwd(*args, *cts)  # noqa: E731
        few = 1 if label == "train" else 3
        got = {
            "ssd_chunk": {
                "ms": cuda_ms(fwd, iters=20 if label == "train" else 100, warmup=3),
                "device_ms": kernel_device_ms(fwd, fwd_names, iters=5),
                "plain_ms": cuda_ms(lambda: ssd_chunk_ref(*args), iters=5 * few, warmup=1),
                **bounds["ssd_chunk"], "library_ms": None},
            "ssd_chunk_bwd": {
                "ms": cuda_ms(bwd, iters=10 if label == "train" else 50, warmup=2),
                "device_ms": kernel_device_ms(bwd, bwd_names, iters=5),
                "device_ms_by_kernel": {n: kernel_device_ms(bwd, (n,), iters=5)
                                        for n in bwd_names},
                "plain_ms": cuda_ms(lambda: ssd_chunk_bwd_ref(*args, *cts), iters=3 * few,
                                    warmup=1),
                **bounds["ssd_chunk_bwd"], "library_ms": None},
        }
        for name, r in got.items():
            out[name]["shapes"][label] = {"shape": list(shape), **r}
            if label == "train":
                out[name].update(r)
        log("ssd", f"{label} shape {shape}: {json.dumps(got)}")
        del args, cts
    return out


def ssm_config():
    """mamba2-1.3b at full width and depth (48 layers, d 2048, d_inner 4096,
    64 heads of 64, state 128, vocab 50,280), kernels on."""
    return dataclasses.replace(get_config("mamba2-1.3b"), ssm_kernel="on")


def ssm_serve_phase(device, cfg, params) -> tuple[dict, dict]:
    """The Scheduler at full width and depth with mamba2-1.3b's random init.

    Hard checks: every request ends with its token count; no page is ever
    allocated; the state pool is never reallocated; ssd_chunk launches =
    prefills x 48 and none in decode; every ssd call of the first step's
    prefills held to the plain version; the slot state of a padded prefill
    equals a prefill of exactly valid_len tokens (float32 compute: the f32
    bar, every layer); request 0's first decode-step logits, paged against
    the contiguous ``generate``, within the bf16 bar in relative norm.
    Returns (summary, launches)."""
    sch = Scheduler(cfg, params, SERVE_POOL, device=device)
    ptrs = sch.pool.data_ptrs()
    reqs = serve_requests(cfg)
    for r in reqs:
        sch.submit(r)
    inner = sch.decode_fn
    decode_ssd, pages, first, busiest = [], [], {}, {}

    def decode_fn(params_, tokens, pools, table, lengths):
        if not decode_ssd:  # request 0's slot state right after its padded prefill
            slot = next(sl for sl, st in sch.active.items() if st.req.rid == 0)
            first["state"] = pools["state"][:, slot].clone()
        before = ssd_chunk_fwd.launches
        out = inner(params_, tokens, pools, table, lengths)
        decode_ssd.append(ssd_chunk_fwd.launches - before)
        pages.append(sch.pool.used_page_count)
        live = len(sch.active)
        if live > busiest.get("live", -1):
            busiest.update(live=live, tokens=tokens.clone(), table=table.clone(),
                           lengths=lengths.clone())
        for slot, st in sch.active.items():
            if st.req.rid == 0 and len(st.generated) == 1:
                first["logits"] = out[1][slot].float().clone()
        return out

    sch.decode_fn = decode_fn
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ops.held_to_plain("ssd_chunk") as held:
        sch.step()  # admits the first max_batch requests
    held_prefills = sch.stats.steps[0].admitted
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    results, stats = sch.run()
    torch.cuda.synchronize()
    wall, wall_unheld = time.perf_counter() - t0, time.perf_counter() - t1
    got = launches()
    prefills = sum(st.admitted for st in stats.steps)
    want = {**dict.fromkeys(WRAPPERS, 0), "ssd_chunk": prefills * cfg.n_layers}
    if got != want or any(decode_ssd):
        raise AssertionError(f"ssm serve launches {got} != {want} (decode {set(decode_ssd)})")
    if len(held) != held_prefills * cfg.n_layers or held_prefills == 0:
        raise AssertionError(f"{len(held)} ssd calls held for {held_prefills} prefills")
    for r in reqs:
        toks = results[r.rid]
        if toks.shape != (r.max_new_tokens,) or not np.all((0 <= toks) & (toks < cfg.vocab_size)):
            raise AssertionError(f"ssm request {r.rid}: tokens {toks.shape}")
    if max(pages) != 0 or stats.peak_occupancy != 0.0 or sch.pool.used_page_count != 0:
        raise AssertionError(f"ssm serve allocated pages: {max(pages)}")
    if sch.pool.data_ptrs() != ptrs:
        raise AssertionError("the ssm state pool was reallocated")

    r0 = reqs[0]
    plen = len(r0.tokens)
    prompt = torch.as_tensor(r0.tokens, device=device)[None]
    padded = torch.zeros((1, SERVE_POOL.prompt_pad), dtype=torch.long, device=device)
    padded[0, :plen] = prompt[0]
    # the padded prefill's state against a prefill of exactly plen tokens:
    # float32 compute (the f32 bar, every layer), and the served bf16 one
    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    vl = torch.tensor([plen], dtype=torch.int32, device=device)
    c_pad, _ = T.prefill(cfg32, params, padded, T.init_cache(cfg32, 1, 256, device),
                         valid_len=vl)
    c_ex, _ = T.prefill(cfg32, params, prompt, T.init_cache(cfg32, 1, plen, device))
    state_f32 = {k: [ops.assert_close(c_pad[k][i], c_ex[k][i], SSD_BAR)
                     for i in range(cfg.n_layers)] for k in ("state", "conv")}
    del c_pad
    c_bf, _ = T.prefill(cfg, params, prompt, T.init_cache(cfg, 1, plen, device))
    pooled_rel = [ops.rel_err(first["state"][i], c_bf["state"][i, 0])
                  for i in range(cfg.n_layers)]
    del c_bf, c_ex
    gen = generate(cfg, params, prompt, max_new_tokens=1)
    paged_rel = ops.rel_err(first["logits"], gen.logits[1][0])
    if paged_rel > BF16_BAR:  # whole-model bf16 logits: the bar in relative norm
        raise AssertionError(f"request 0: paged vs contiguous logits, relative {paged_rel}")

    # a decode step at the busiest state, replayed (the run is over: its
    # state writes land in finished slots)
    args = (params, busiest["tokens"], sch.pool.pools, busiest["table"], busiest["lengths"])
    step = lambda: T.decode_step_paged(cfg, *args)  # noqa: E731
    step()
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        step()
    torch.cuda.synchronize()
    step_wall = (time.perf_counter() - t0) * 1e3 / n
    busy_us, kern = device_profile(step, n)
    step_busy = busy_us / 1e3 / n
    weight_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(params)
                       if t.dtype == cfg.compute_dtype)
    state_bytes = sum(t.numel() * t.element_size() for t in sch.pool.pools.values())
    n_tokens = int(sum(len(v) for v in results.values()))
    summary = {
        "requests": len(reqs), "tokens": n_tokens, "prefills": prefills,
        "decode_steps": stats.decode_steps, "preemptions": stats.preemptions,
        "peak_active": stats.peak_active, "pages_allocated_max": max(pages),
        "state_pool_gb": state_bytes / 1e9,
        "wall_s": wall, "tokens_per_s": n_tokens / wall,
        "decode_ms_per_step_incl_admission": wall * 1e3 / stats.decode_steps,
        # after the held first step (its plain float64 checks are not serving)
        "wall_s_after_step0": wall_unheld,
        "tokens_per_s_after_step0": (n_tokens - stats.steps[0].tokens_generated
                                     - held_prefills) / wall_unheld,
        "held_prefills": held_prefills, "ssd_vs_plain_max_abs": max(held),
        "ssd_vs_plain_rel_norm_max": max(held.rel),
        "padded_vs_exact_f32_state_max_abs": max(state_f32["state"]),
        "padded_vs_exact_f32_conv_max_abs": max(state_f32["conv"]),
        "reported_pooled_vs_exact_bf16_state_rel_per_layer": pooled_rel,
        "paged_vs_contiguous_logits_rel": paged_rel,
        "paged_vs_contiguous_logits_max_abs": (first["logits"] - gen.logits[1][0]).abs().max().item(),
        "reported_paged_vs_contiguous_same_first_token": int(gen.tokens[0, 0]) == int(results[0][0]),
        "busiest_live_slots": busiest["live"],
        "decode_step_wall_ms": step_wall, "decode_step_device_ms": step_busy,
        "decode_step_idle_share": 1.0 - step_busy / step_wall,
        "decode_step_launches": sum(c for _, c in kern.values()) / n,
        "weight_bytes_read_per_step": weight_bytes,
        "decode_step_bound_ms": (weight_bytes + 2 * state_bytes) / HBM_BYTES_PER_S * 1e3,
        "top_kernels_us_per_step": top_by_prefix({k: t / n for k, (t, _) in kern.items()}, 6),
    }
    log("ssm-serve", json.dumps(summary))
    return summary, got


def ssm_score_phase(device, cfg, params, s=2048) -> tuple[dict, dict]:
    """forward() at full width and depth, B=1, S=2048: 48 ssd_chunk
    launches, each held to the plain version on its own inputs; finite
    logits; ssm_kernel "on" vs "off" logits within 2e-2 in relative norm."""
    tokens = score_tokens(cfg, device, s)
    cfg_off = dataclasses.replace(cfg, ssm_kernel="off")
    T.forward(cfg, params, tokens[:, :256])  # warm-up (cuBLAS plans)
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on = T.forward(cfg, params, tokens)
    torch.cuda.synchronize()
    t_on = time.perf_counter() - t0
    got = launches()
    if got != {**dict.fromkeys(WRAPPERS, 0), "ssd_chunk": cfg.n_layers}:
        raise AssertionError(f"ssm score launches {got}: want {cfg.n_layers} ssd_chunk")
    if on.shape != (1, s, cfg.vocab_size) or not torch.isfinite(on).all():
        raise AssertionError(f"ssm score logits {tuple(on.shape)} not finite")
    with ops.held_to_plain("ssd_chunk") as held:
        T.forward(cfg, params, tokens)
    if len(held) != cfg.n_layers:
        raise AssertionError(f"{len(held)} ssd calls held to the plain version")
    t0 = time.perf_counter()
    off = T.forward(cfg_off, params, tokens)
    torch.cuda.synchronize()
    t_off = time.perf_counter() - t0
    rel = ops.rel_err(on, off)
    out = {"B": 1, "S": s, "seconds_on": t_on, "seconds_off": t_off,
           "tokens_per_s_on": s / t_on, "ssd_vs_plain_per_layer_max_abs": list(held),
           "ssd_vs_plain_per_layer_rel_norm": held.rel,
           "on_vs_off_logits_rel_norm": rel,
           "on_vs_off_logits_max_abs": (on - off).abs().max().item(),
           "on_vs_off_logits_bitwise_equal": torch.equal(on, off),
           "logits_abs_max": off.abs().max().item()}
    log("ssm-score", json.dumps(out))
    if rel > BF16_BAR:
        raise AssertionError(f"ssm score on vs off: relative {rel}")
    return out, got


def ssm_train_setup():
    """(cfg, TrainConfig, LoaderConfig) of the ssm train phase: mamba2-1.3b
    at full width and depth, remat "full", AdamW at the launcher's defaults,
    B=4 and S=2048 from batch_at."""
    cfg = ssm_config()
    return (cfg, TrainConfig(optimizer=AdamConfig()),
            LoaderConfig(cfg.vocab_size, SSM_TRAIN_B, SSM_TRAIN_S, seed=0))


def expected_ssm_train_launches(cfg) -> dict[str, int]:
    """One ssm train step with remat 'full': the forward kernel twice a
    layer (forward, recompute), the backward's three kernels once a layer."""
    return {**dict.fromkeys(WRAPPERS, 0), "ssd_chunk": 2 * cfg.n_layers,
            "ssd_chunk_bwd": 3 * cfg.n_layers}


def ssm_train_phase(device) -> tuple[dict, dict]:
    """SSM_TRAIN_STEPS steps of mamba2-1.3b at full width and depth.

    Step 0 holds every ssd forward and backward call to the plain version
    (float32 bars; gradients also in relative norm, their size logged);
    steps 1-4 are timed (wall, peak memory) with launches asserted each
    step; the device time is profiled in a fresh process (``ssm_profile``).
    Then one local_grads "on" against "off". Returns (summary, launches
    over every step)."""
    cfg, tc, ld = ssm_train_setup()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(cfg, tc, 0, device)
    torch.cuda.synchronize()
    state_gb = sum(t.numel() * t.element_size()
                   for t in tree_leaves({"p": state["params"], "o": state["opt"]})) / 1e9
    log("ssm-train", f"{cfg.name} x{cfg.n_layers} layers, {cfg.param_count()} params "
        f"({tree_num_params(T.model_defs(cfg))} in the tree), train state (params, mu, nu) "
        f"{state_gb:.2f} GB, drawn in {time.perf_counter() - t0:.1f} s")
    want = expected_ssm_train_launches(cfg)
    total = dict.fromkeys(WRAPPERS, 0)
    losses, gnorms, walls = [], [], []

    def one_step(i):
        nonlocal state
        before = launches()
        state, m = train_step(cfg, tc, state, batch_at(ld, i))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        got = {n: c - before[n] for n, c in launches().items()}
        if got != want:
            raise AssertionError(f"ssm train step {i}: launches {got} != {want}")
        for n, c in got.items():
            total[n] += c

    reset_launches()
    t0 = time.perf_counter()
    with ops.held_to_plain("ssd_chunk") as fwd, ops.held_to_plain("ssd_chunk_bwd") as bwd:
        one_step(0)
    torch.cuda.synchronize()
    t_held = time.perf_counter() - t0
    if len(fwd) != 2 * cfg.n_layers or len(bwd) != cfg.n_layers:
        raise AssertionError(f"step 0 held {len(fwd)} forward and {len(bwd)} backward calls")
    peak_step0 = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for i in range(1, SSM_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step(i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses + gnorms):
        raise AssertionError(f"ssm train losses {losses} grad norms {gnorms}")
    wall_ms = float(np.median(walls)) * 1e3
    summary = {
        "layers": cfg.n_layers, "B": SSM_TRAIN_B, "S": SSM_TRAIN_S,
        "tokens_per_step": SSM_TRAIN_B * SSM_TRAIN_S, "train_state_gb": state_gb,
        "losses": losses, "grad_norms": gnorms, "step0_s_held_to_plain": t_held,
        "step0_ssd_fwd_vs_plain_max_abs": max(fwd), "step0_ssd_fwd_rel_norm_max": max(fwd.rel),
        "step0_ssd_bwd_vs_plain_max_abs": list(bwd), "step0_ssd_bwd_rel_norm": bwd.rel,
        "step0_ssd_bwd_plain_max_abs_grad": bwd.scale,
        "step_wall_ms": [w * 1e3 for w in walls], "step_wall_ms_median": wall_ms,
        "tokens_per_s": SSM_TRAIN_B * SSM_TRAIN_S / (wall_ms / 1e3),
        "port_kernel_launches_per_step": {k: c for k, c in want.items() if c},
        "peak_gb_steps_1_4": peak / 1e9, "peak_gb_step0_held": peak_step0 / 1e9,
    }
    log("ssm-train", json.dumps(summary))

    # one local_grads, ssm_kernel "on" against "off", on the trained params
    del state["opt"]
    gc.collect()
    torch.cuda.empty_cache()
    batch = batch_at(ld, 0)
    l_on, g_on = local_grads(cfg, tc, state["params"], batch)
    l_off, g_off = local_grads(dataclasses.replace(cfg, ssm_kernel="off"), tc, state["params"],
                               batch)
    loss_rel = abs(float(l_on) - float(l_off)) / abs(float(l_off))
    rel = tree_map(lambda _, a, b: ops.rel_err(a, b), g_on, g_off)  # laid out as the params
    worst = max(tree_leaves(rel))
    on_off = {"loss_on": float(l_on), "loss_off": float(l_off), "loss_rel": loss_rel,
              "grad_rel_norm_max": worst, "grad_rel_norm": rel}
    log("ssm-train", f"on vs off: {json.dumps(on_off)}")
    if loss_rel > 1e-3 or worst > GRAD_BAR:
        raise AssertionError(f"ssm train on vs off: loss {loss_rel}, gradients {rel}")
    summary["on_vs_off"] = {k: v for k, v in on_off.items() if k != "grad_rel_norm"}
    del state, g_on, g_off
    gc.collect()
    torch.cuda.empty_cache()
    return summary, total


def ssm_profile(device) -> dict:
    """Run in a fresh process (``chip_smoke.py --ssm-profile``; late in the
    main process torch.profiler has dropped kernel events): the SSD kernels'
    times at the train shape, then the ssm train step: 2 steps warm, 2 timed
    without the profiler, 1 profiled (device busy, idle share, launches,
    top kernels)."""
    times = time_ssd(device)
    cfg, tc, ld = ssm_train_setup()
    state = init_train_state(cfg, tc, 0, device)

    def one(i):
        nonlocal state
        state, _ = train_step(cfg, tc, state, batch_at(ld, i))

    for i in range(2):
        one(i)
    walls = []
    for i in range(2, 4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one(i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    busy_us, kern = device_profile(lambda: one(4), 1)
    wall_ms = float(np.median(walls)) * 1e3
    names = ("ssd_fwd_kernel", "ssd_bwd_rows_kernel", "ssd_bwd_cols_kernel",
             "ssd_bwd_finish_kernel")
    ssd_us = {n: sum(t for k, (t, _) in kern.items() if n in k) for n in names}
    ssd_n = {n: sum(c for k, (_, c) in kern.items() if n in k) for n in names}
    train = {"step_wall_ms": [w * 1e3 for w in walls], "step_wall_ms_median": wall_ms,
             "step_device_busy_ms": busy_us / 1e3, "idle_share": 1.0 - busy_us / 1e3 / wall_ms,
             "kernel_launches_per_step_profiled": sum(c for _, c in kern.values()),
             "profiled_ssd_launches": ssd_n,
             "ssd_device_ms": {k: v / 1e3 for k, v in ssd_us.items()},
             "top_kernels_us_per_step": top_by_prefix({k: t for k, (t, _) in kern.items()}, 10)}
    return {"ssd": times, "train": train}


def ssm_profile_subprocess() -> dict:
    """``ssm_profile`` in a fresh process on the same card; its JSON result."""
    res = profile_subprocess("--ssm-profile")
    n = ssm_config().n_layers
    want = {"ssd_fwd_kernel": 2 * n, "ssd_bwd_rows_kernel": n, "ssd_bwd_cols_kernel": n,
            "ssd_bwd_finish_kernel": n}
    if res["train"]["profiled_ssd_launches"] != want:  # the device times would be short
        log("ssm-profile", f"the profile recorded {res['train']['profiled_ssd_launches']} ssd "
            f"kernel events, the step launched {want}")
    return res


def ptxas_report(outputs) -> dict:
    """{kernel<dtype,template ints>: registers, spills, static smem} from
    the nvcc -Xptxas -v output of each library (``_build.build_all``)."""
    rep, name = {}, None
    for text in outputs.values():
        for line in text.splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                mangled = m.group(1)
                base = re.search(r"([a-z_]+_kernel)I", mangled)
                dt = ("bf16" if "nv_bfloat16" in mangled else "f32" if "_kernelIf" in mangled
                      else "f64" if "_kernelId" in mangled else "")
                ints = ",".join(re.findall(r"Li(\d+)E", mangled))
                name = f"{base.group(1) if base else mangled}<{','.join(filter(None, (dt, ints)))}>"
                rep[name] = {}
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and name:
                rep[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                smem = re.search(r"(\d+) bytes smem", line)
                rep[name].update(registers=int(m.group(1)),
                                 static_smem=int(smem.group(1)) if smem else 0)
    return rep


def flash_smem_bytes(d: int) -> dict[str, int]:
    """Dynamic shared memory a block of each flash kernel asks for at head
    dim `d`, bf16 and float32 (the wrapper's ``tile_plan``, which every bf16
    launch checks against the compiled tiles)."""
    return {f"{name}<{dt}>": plan["smem"]
            for dtype, dt in ((torch.bfloat16, "bf16"), (torch.float32, "f32"))
            for name, plan in tile_plan(dtype, d).items()}


def time_flash_d256(device) -> dict:
    """The flash forward and backward at the gossip step's attention shape
    (bf16, B=1, 8/4 heads, S=2048, D=256, causal, window 4096, softcap 50):
    kernel, plain version and bound. No single PyTorch call computes a
    softcapped attention (SDPA has no softcap): no library time. SDPA
    without the softcap on the same tensors is logged beside it as a
    yardstick of the card's rate only: not the same function."""
    b, hq, hkv, s, _, d, causal, window, cap = GEMMA2_ATTENTION[0]
    q, k, v = flash_inputs(b, hq, hkv, s, s, d, torch.bfloat16, device)
    do = flash_inputs(b, hq, hq, s, s, d, torch.bfloat16, device, seed=1)[0]
    o, lse = flash_attention(q, k, v, causal, window, cap, return_lse=True)
    pairs = b * hq * s * (s + 1) // 2  # causal; the window (4096 > S) keeps every pair
    kw = dict(causal=causal, window=window, softcap=cap)
    b_f = bound(2 * (2 * q.numel() + k.numel() + v.numel()) + 4 * lse.numel(),
                4 * pairs * d, torch.bfloat16)
    b_b = bound(2 * (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + o.numel() + do.numel())
                + 4 * lse.numel(), 10 * pairs * d, torch.bfloat16)
    fwd = lambda: flash_attention(q, k, v, causal, window, cap)  # noqa: E731
    bwd = lambda: flash_attention_bwd(q, k, v, o, lse, do, **kw)  # noqa: E731
    out = {
        "flash_attention": {
            "ms": cuda_ms(fwd, iters=50, warmup=5),
            "device_ms": kernel_device_ms(fwd, FLASH_FWD_KERNELS, iters=10),
            "plain_ms": cuda_ms(lambda: attention_ref(q, k, v, **kw), iters=5, warmup=1),
            "bound_ms": b_f[0], "bound_by": b_f[1], "library_ms": None},
        "flash_attention_bwd": {
            "ms": cuda_ms(bwd, iters=20, warmup=3),
            "device_ms": kernel_device_ms(bwd, flash_bwd_kernels(d), iters=5),
            "plain_ms": cuda_ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do, **kw),
                                iters=3, warmup=1),
            "bound_ms": b_b[0], "bound_by": b_b[1], "library_ms": None},
    }
    split = {n: kernel_device_ms(bwd, (n,), iters=5) for n in flash_bwd_kernels(d)}
    log("attention-profile", f"D=256 (gemma2-2b gossip shape): {json.dumps(out)}; backward "
        f"device ms by kernel {json.dumps(split)}")
    # SDPA has no softcap: the same tensors without it (not the same function)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    sd_out = sdpa(*leaves, is_causal=True, enable_gqa=True)
    log("attention-profile", "D=256 SDPA without softcap, not the same function: forward "
        f"{cuda_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True), iters=50, warmup=5)}"
        " ms, backward "
        f"{cuda_ms(lambda: torch.autograd.grad(sd_out, leaves, do, retain_graph=True), iters=20, warmup=3)}"
        " ms")
    return out


def topk_profile(device) -> dict:
    """``chip_smoke.py --topk-profile`` (a fresh process): block_topk's
    parity at every case and kind, its times (TOPK_MAIN, TOPK_LONG) and the
    sparse kernels' times at the solver's shape, the
    kernels phase's block_topk and sparse work alone."""
    rcv1 = DATASET_PRESETS["rcv1"]
    log("topk-profile", subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    built = _build.build_all()
    log("topk-profile", "ptxas: " + json.dumps(
        {k: v for k, v in ptxas_report(built).items() if k.startswith("block_topk")}))
    return {"parity": topk_parity(device), "block_topk": time_topk(device),
            "sparse": time_kernels(device, 10, rcv1["d"], rcv1["k"])}


def attention_profile(device) -> dict:
    """Run in a fresh process (``chip_smoke.py --attention-profile``; late in
    the main process torch.profiler has dropped kernel events): the bf16
    flash forward and backward at D=128 (the score and train shapes) and at
    D=256 (the gossip shape), by CUDA events and profiler device time, beside
    the plain version, the bound and SDPA (D=128)."""
    return {"flash_attention": time_attention(device),
            "flash_attention_bwd": time_flash_bwd(device), "d256": time_flash_d256(device)}


def profile_subprocess(flag: str, *args: str, timeout: float = 900) -> dict:
    """``chip_smoke.py <flag> [args]`` in a fresh process on the same card;
    its JSON result (the last line of its output)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), flag, *args], cwd=ROOT,
                       env=env, capture_output=True, text=True, timeout=timeout)
    tag = flag.removeprefix("--")
    log(tag, f"rc={r.returncode} in {time.perf_counter() - t0:.1f} s\n{r.stdout.strip()}")
    if r.returncode != 0:
        raise AssertionError(f"{tag} failed:\n{r.stderr[-4000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def main() -> int:
    """Run every phase; the last stdout line is the result object."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    log("device", f"{smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{kind} x{count}")

    t0 = time.perf_counter()
    built = _build.build_all()  # one nvcc per source, all started together
    for name in _build.SIGNATURES:
        _build.load_library(name)
    log("build", f"{sorted(built)} built, {len(_build.SIGNATURES)} loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_report(built)
    log("build", "ptxas (the flash and decode kernels at head_dim 128 and 256, block_topk, "
        "sparse_axpy, the ssd kernels at mamba2's hd 64): " + json.dumps(
            {k: v for k, v in ptxas.items()
             if (k.startswith("flash_") and (k.endswith((",128>", ",256>"))
                                             or ",128," in k or ",256," in k))
             or k.startswith(("block_topk", "sparse_axpy"))
             or (k.startswith("ssd_") and k.endswith("<64>")) or "ssd_bwd_finish_kernel" in k}))
    for d in (128, 256):
        log("build", f"dynamic shared memory a block at head_dim {d}, bytes: "
            f"{json.dumps(flash_smem_bytes(d))}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (b, nc, *rest) in SSD_MAIN.items():
        log("build", f"ssd plan at the {label} shape: {json.dumps(ssd_plan(b * nc, *rest, sms))}")

    t0 = time.perf_counter()
    rcv1, news20 = DATASET_PRESETS["rcv1"], DATASET_PRESETS["news20"]
    main_shape = (10, rcv1["d"], rcv1["k"])
    # + init_state's phibar scatter: all q*k = 7,400 entries of a node at
    # once, into D = d + 3 (AUC)
    init_shape = (10, rcv1["d"] + 3, 100 * rcv1["k"])
    errs = kernel_parity(dev, [main_shape, init_shape, (3, 1003, 9), (10, 2000, 1200)])
    times = time_kernels(dev, *main_shape)
    errs["block_topk"] = topk_parity(dev)
    times["block_topk"] = time_topk(dev)
    log("kernels", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    total, _ = slice_runs(dev, rcv1["d"], rcv1["k"])
    log("slice", f"launches {total}; done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    profile_steps(dev, rcv1["d"], rcv1["k"])
    log("profile", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    widest_run(dev, news20["d"], news20["k"])
    log("widest", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cfg = get_config("minitron-8b")
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    log("model", f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.param_count()} params, {nbytes / 1e9:.2f} GB on the card, "
        f"drawn in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    _, decode_main, serve_launches = serve_phase(dev, cfg, params)
    log("serve", f"launches {serve_launches}; done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    errs.update(attention_parity(dev, decode_main))
    errs["flash_attention_bwd"] = flash_bwd_parity(dev)
    busiest = decode_main[4].tolist()
    del decode_main  # holds views of the serve pool
    log("attention", f"done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    times["decode_attention"] = profile_subprocess("--decode-profile", json.dumps(busiest))
    log("decode-profile", f"done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    aprof = profile_subprocess("--attention-profile")
    times["flash_attention"] = aprof["flash_attention"]
    times["flash_attention_bwd"] = aprof["flash_attention_bwd"]
    log("attention-profile", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    _, score_launches = score_phase(dev, cfg, params)
    log("score", f"launches {score_launches}; done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    conditioned_phase(dev, cfg, params)
    log("conditioned", f"done in {time.perf_counter() - t0:.1f} s")

    # the 22 GB of serve weights and the serve phases' pools: the Schedulers
    # and their decode_fn closures form reference cycles, so collect them
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log("train", f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before the train state")
    t0 = time.perf_counter()
    _, train_launches, state = train_phase(dev)
    log("train", f"launches {train_launches}; steps done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    train_on_off(state)
    del state
    gc.collect()
    torch.cuda.empty_cache()
    log("train", f"on vs off done in {time.perf_counter() - t0:.1f} s")

    log("gossip", f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated before the gossip "
        "state")
    t0 = time.perf_counter()
    _, gossip_launches = gossip_phase(dev)
    gc.collect()
    torch.cuda.empty_cache()
    log("gossip", f"launches {gossip_launches}; done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launcher_phase()
    log("launcher", f"done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    gossip_launcher_phase()
    log("gossip-example", f"done in {time.perf_counter() - t0:.1f} s")

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    errs.update(ssd_parity(dev))
    log("ssd", f"done in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    scfg = ssm_config()
    sparams = T.init_params(scfg, seed=0, device=dev)
    torch.cuda.synchronize()
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(sparams))
    log("ssm-model", f"{scfg.name}: {scfg.n_layers} layers, d_model {scfg.d_model}, "
        f"{scfg.ssm_heads} heads of {scfg.ssm_head_dim}, state {scfg.ssm_state}, "
        f"{tree_num_params(T.model_defs(scfg))} params, {nbytes / 1e9:.2f} GB on the card, "
        f"drawn in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, ssm_serve_launches = ssm_serve_phase(dev, scfg, sparams)
    log("ssm-serve", f"launches {ssm_serve_launches}; done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, ssm_score_launches = ssm_score_phase(dev, scfg, sparams)
    log("ssm-score", f"launches {ssm_score_launches}; done in {time.perf_counter() - t0:.1f} s")
    del sparams
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _, ssm_train_launches = ssm_train_phase(dev)
    log("ssm-train", f"launches {ssm_train_launches}; done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    prof = ssm_profile_subprocess()
    times.update(prof["ssd"])
    log("ssm-profile", f"done in {time.perf_counter() - t0:.1f} s")

    total["decode_attention"] = serve_launches["decode_attention"]
    # flash_attention runs on three main paths: the score phase, the train
    # steps and the gossip steps; its backward on the last two
    total["flash_attention"] = (score_launches["flash_attention"]
                                + train_launches["flash_attention"]
                                + gossip_launches["flash_attention"])
    total["flash_attention_bwd"] = (train_launches["flash_attention_bwd"]
                                    + gossip_launches["flash_attention_bwd"])
    total["block_topk"] = gossip_launches["block_topk"]
    # ssd_chunk runs on three main paths: the ssm serve prefills, the ssm
    # score phase and the ssm train steps; its backward on the last
    total["ssd_chunk"] = (ssm_serve_launches["ssd_chunk"] + ssm_score_launches["ssd_chunk"]
                          + ssm_train_launches["ssd_chunk"])
    total["ssd_chunk_bwd"] = ssm_train_launches["ssd_chunk_bwd"]
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCES[name],
         "replaces": REPLACES[name], "launches": total[name],
         "max_abs_err": errs[name], **times[name]}
        for name in ("sparse_dot", "sparse_axpy", "flash_attention", "decode_attention",
                     "flash_attention_bwd", "block_topk", "ssd_chunk", "ssd_chunk_bwd")
    ]
    log("all", f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    PROFILES = {"--ssm-profile": ssm_profile, "--attention-profile": attention_profile,
                "--topk-profile": topk_profile,
                "--gossip-profile": lambda dev: gossip_phase(dev, topk_rows=True)[0],
                "--decode-profile": lambda dev, *a: decode_profile(dev, *map(json.loads, a))}
    if len(sys.argv) >= 2 and sys.argv[1] in PROFILES:
        if not torch.cuda.is_available():
            sys.exit(1)
        print(json.dumps(PROFILES[sys.argv[1]](torch.device("cuda"), *sys.argv[2:])))
        sys.exit(0)
    sys.exit(main())
