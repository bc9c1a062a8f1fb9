// Hand-written Hopper kernels for the bfloat16 flash-attention backward pass,
// on tensor cores and deterministic.
//
// Replace the Pallas TPU kernels of src/repro/kernels/flash_attention.py
// (flash_attention_bwd -> _attn_bwd_dq_kernel :220 and _attn_bwd_dkv_kernel
// :265) for bfloat16 inputs, the dtype of every backward call on the train
// and gossip paths. float32 inputs keep the CUDA-core kernels of
// flash_attention_bwd.cu: a tensor-core product on float32 is TF32, which
// keeps about 3 decimal digits and cannot meet the 2e-4 float32 gradient
// bar. The wrapper (kernels/flash_attention.py) picks the kernels by dtype; a
// bfloat16 call never reaches the CUDA-core kernels.
//
// Contract (the same as flash_attention_bwd.cu): q, o, do (B, Hq, S, D);
// k, v (B, Hkv, Sk, D), bf16; lse (B, Hq, S) float32; query head h reads kv
// head h / (Hq / Hkv). Per (query i, key j), with scale = 1/sqrt(D):
//   x = softcap(scale q_i . k_j), mask(i, j) = i < S, j < Sk [, i >= j] [, i - j < window]
//   p = mask ? exp(x - lse_i) : 0,   dp = do_i . v_j,   delta_i = do_i . o_i
//   ds = p (dp - delta_i) [* (1 - (x / softcap)^2)]
//   dq_i = scale * sum_j ds k_j,  dk_j = scale * sum_i ds q_i,
//   dv_j = sum_i p do_i,  dk and dv summed over the GQA group's q heads.
//
// Design. Two launches in one stream, as in flash_attention_bwd.cu, each
// recomputing s and dp (seven products where five would do, so that neither
// kernel needs the other's tiles or an atomic). The dq kernel also computes
// delta for its rows (16-byte loads of o and do, two lanes a row) and writes
// it out for the dk/dv kernel, so the two launch in that order. No
// floating-point atomics and no partial buffers: every sum runs in a fixed
// order, so the gradient is the same bit for bit from run to run (the
// launcher's and the gossip example's resumes are held bit-equal on the
// card). P and dS enter their products as bf16 (as in FA2/FA3); the
// gradient bars are relative (5e-2, also in norm), which that meets with
// room (~3e-3 in norm on the card).
//
// wgmma (dq at D = 64, 128 and 256; dk/dv at D = 64 and 128, the dense
// models' head dims): two warpgroups (256 threads) load the next tile with
// cp.async into the 128-byte swizzle wgmma reads (fence.proxy.async before
// the products) and then compute, one CTA an SM:
//   dq kernel    one CTA per (q head, 128-row q tile, batch), the q tiles
//                heaviest first under causal masking, over K/V tiles of the
//                causal/window band (64 keys, 32 at D = 256 where Q and dO
//                take 128 KB; double-buffered). Warpgroup g owns 64 q rows:
//                S = Q K^T and dP = dO V^T by wgmma from shared memory, dS in
//                registers (its lse and delta are the thread's two rows'),
//                then dQ += dS K with dS as the bf16 A operand from registers
//                (the accumulator layout is the A layout) and K read N-major.
//   dk/dv kernel one CTA per (KV head, 128-row kv tile, batch) that walks
//                the group's q heads and the 64-row q tiles of the band
//                (double-buffered Q, dO, lse, delta), accumulating dk and dv
//                in registers and writing them once: the GQA group sum never
//                leaves the CTA. Warpgroup g owns 64 kv rows: S^T = K Q^T and
//                dP^T = V dO^T, P^T and dS^T in registers, then dV += P^T dO
//                and dK += dS^T Q with dO and Q read N-major.
// mma.sync m16n8k16 bf16 -> f32 (dq at D = 16 and 32; dk/dv at 16, 32 and
// 256), operands loaded by ldmatrix (.trans for K in dQ, Q and dO in dK and
// dV) from bf16 tiles whose 16-byte chunks are XOR-swizzled by row. At
// D = 256 a warpgroup's 64 x 256 f32 dk and dv (2 x 128 registers a thread,
// beside S^T and dP^T) are past the 255-register limit, so wgmma's 64-row
// tiles do not fit the dk/dv kernel there:
//   dq kernel    one CTA of 4 warps per (q head, 64-row q tile, batch) over
//                64-key tiles, two CTAs an SM; warp w owns 16 q rows, dS
//                stays in registers as the A operand of dQ += dS K.
//   dk/dv kernel one CTA of 8 warps per (KV head, kv tile, batch); warp w
//                owns 16 kv rows (row group w % RG) and a slice of the
//                columns (w / RG): S^T and dP^T on its slice of the q step,
//                P^T and dS^T to shared memory in bf16, then dV and dK on its
//                slice of D. RG = 2 (BK = 32 kv rows, 64-row q steps, one CTA
//                an SM) at D = 256, 8 (BK = 128, 32-row q steps in a 3-stage
//                ring, two CTAs an SM) at 16 and 32.
// Shared memory and grids: the plan in kernels/flash_attention.py
// (tile_plan), which every launch checks against the compiled tiles.
//
// What bounds it on an H100: operations. At the train shape (B=2,
// minitron-8b's 32/8 heads, S=2048, D=128, causal) the gradient needs five
// products of the causal band (s, dp, dq, dk, dv), ~172 GFLOP against
// ~84 MB of inputs and outputs: 0.174 ms at the 989 TFLOP/s bf16 peak; at
// gemma2-2b's D = 256 (B=1, 8/4 heads) 0.0434 ms.
//
// Plain C entry point (bound with ctypes by kernels/_build.py). It launches
// on the given stream, allocates nothing, does not synchronise, and returns
// the first launch error.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDqBQ = 64;  // q rows a dq CTA
constexpr int kDqThreads = 128;
constexpr int kKvThreads = 256;

template <int D>
struct DqTiles {
  static constexpr int BK = 64;
  static constexpr int SMEM = 2 * 2 * kDqBQ * D + 2 * 2 * 2 * BK * D + 2 * 4 * kDqBQ;
};

template <int D>
struct KvTiles {
  static constexpr int RG = D == 256 ? 2 : 8;  // 16-row groups of kv rows
  static constexpr int CG = 8 / RG;                               // column slices
  static constexpr int BK = 16 * RG;
  static constexpr int BQ = D == 256 ? 64 : 32;  // q rows a step
  static constexpr int NQS = D == 256 ? 2 : 3;   // stages of the Q, dO, lse, delta ring
  // K, V; the ring; P^T, dS^T
  static constexpr int SMEM = 2 * 2 * BK * D + NQS * (2 * 2 * BQ * D + 2 * 4 * BQ) +
                              2 * 2 * BK * BQ;
};

struct Mask {
  int S, Sk, causal, has_window, window, has_softcap;
  float softcap, inv_softcap;
  // softcapped score and whether (qi, ki) attends
  __device__ __forceinline__ bool apply(int qi, int ki, float& x) const {
    if (has_softcap) x = softcap * fast_tanh(x * inv_softcap);
    bool ok = qi < S && ki < Sk;
    if (causal) ok = ok && qi >= ki;
    if (has_window) ok = ok && qi - ki < window;
    return ok;
  }
  // ds from p, dp and the row's delta (x is the softcapped score)
  __device__ __forceinline__ float ds(float p, float dp, float delta, float x) const {
    float g = p * (dp - delta);
    if (has_softcap) {
      const float t = x * inv_softcap;
      g *= 1.f - t * t;
    }
    return g;
  }
};

// ---- PTX: cp.async, ldmatrix, mma.sync ---------------------------------------

// 16 bytes global -> shared; zeros where !valid (nothing is read then)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread's copies are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x (the hardware approximation, ~2 ulp; 0 far below -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// byte offset of 16-byte chunk c of row r in a tile of CH chunks a row, the
// chunk index XOR-swizzled by row so that the 8 rows an ldmatrix reads at
// one column hit 8 different bank groups
template <int CH>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  if constexpr (CH >= 8) {
    return (uint32_t)(r * CH + (c ^ (r & 7))) * 16;
  } else {
    return (uint32_t)(r * CH + (c ^ ((r / (8 / CH)) & (CH - 1)))) * 16;
  }
}

// rows [0, R) of a row-major bf16 (rows, CH * 8) tile into swizzled shared
// memory; rows >= valid are zeros
template <int R, int CH, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int valid, int tid) {
#pragma unroll 4
  for (int i = tid; i < R * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < valid;
    cp_async16(dst + swz<CH>(r, c), ok ? src + ((int64_t)r * CH + c) * 8 : src, ok);
  }
}

// delta = rowsum(do * o) of row r = tid / 2 of a q tile from global memory,
// two neighbouring lanes a row, 16-byte loads started in batches of 8 before
// they are used: into dl_s[r], and delta if the row is inside S; lse of the
// row into lse_s[r] in log2 units
template <int D>
__device__ __forceinline__ void row_delta(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                          const float* __restrict__ lse, float* __restrict__ delta,
                                          int64_t qoff, int q0, int S, int tid, float* dl_s,
                                          float* lse_s) {
  constexpr int CPT = D / 16;  // 16-byte chunks a lane
  constexpr int NB = CPT < 8 ? CPT : 8;
  const int r = tid >> 1, part = tid & 1;
  const int qi = q0 + r;
  float acc = 0.f;
  if (qi < S) {
    const uint4* op = reinterpret_cast<const uint4*>(o + (qoff + qi) * D) + part * CPT;
    const uint4* gp = reinterpret_cast<const uint4*>(dout + (qoff + qi) * D) + part * CPT;
#pragma unroll
    for (int c0 = 0; c0 < CPT; c0 += NB) {
      uint4 ov[NB], gv[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        ov[c] = op[c0 + c];
        gv[c] = gp[c0 + c];
      }
#pragma unroll
      for (int c = 0; c < NB; ++c) {
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&ov[c]);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gv[c]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fa = __bfloat1622float2(a2[e]), fg = __bfloat1622float2(g2[e]);
          acc = fmaf(fa.x, fg.x, acc);
          acc = fmaf(fa.y, fg.y, acc);
        }
      }
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  if (part == 0) {
    dl_s[r] = acc;
    lse_s[r] = qi < S ? lse[qoff + qi] * kLog2e : 0.f;
    if (qi < S) delta[qoff + qi] = acc;
  }
}

// ---- dq kernel ----------------------------------------------------------------

// grid (Hq, ceil(S / kDqBQ), B), kDqThreads threads, DqTiles<D>::SMEM bytes
template <int D>
__global__ void __launch_bounds__(kDqThreads, 2) flash_bwd_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const float* __restrict__ lse, const bf16* __restrict__ dout,
    float* __restrict__ delta, bf16* __restrict__ dq, int Hq, int Hkv, Mask mk, float scale) {
  constexpr int BK = DqTiles<D>::BK;
  constexpr int CH = D / 8;  // 16-byte chunks a row
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t q_s = smem_u32(smem);
  const uint32_t do_s = q_s + kDqBQ * D * 2;
  const uint32_t kv_s = do_s + kDqBQ * D * 2;  // stage st: K at kv_s + st * 2 BK D * 2, V after it
  float* lse_s = reinterpret_cast<float*>(smem + 2 * kDqBQ * D * 2 + 4 * BK * D * 2);
  float* dl_s = lse_s + kDqBQ;

  const int S = mk.S, Sk = mk.Sk;
  const int h = blockIdx.x, b = blockIdx.z;
  const int n_qt = (S + kDqBQ - 1) / kDqBQ;
  const int qt = mk.causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * kDqBQ;
  const int q_hi = min(q0 + kDqBQ, S) - 1;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int64_t qoff = ((int64_t)b * Hq + h) * S;
  const bf16* kb = k + ((int64_t)b * Hkv + hk) * Sk * D;
  const bf16* vb = v + ((int64_t)b * Hkv + hk) * Sk * D;

  const int n_kt = (Sk + BK - 1) / BK;
  const int hi = mk.causal ? min(n_kt, q_hi / BK + 1) : n_kt;
  const int lo = mk.has_window ? max(0, q0 - mk.window + 1) / BK : 0;

  load_tile<kDqBQ, CH, kDqThreads>(q_s, q + (qoff + q0) * D, S - q0, tid);
  load_tile<kDqBQ, CH, kDqThreads>(do_s, dout + (qoff + q0) * D, S - q0, tid);
  if (lo < hi) {
    load_tile<BK, CH, kDqThreads>(kv_s, kb + (int64_t)lo * BK * D, Sk - lo * BK, tid);
    load_tile<BK, CH, kDqThreads>(kv_s + BK * D * 2, vb + (int64_t)lo * BK * D, Sk - lo * BK, tid);
  }
  cp_async_commit();

  // warp w computes its own rows 16 w ..: no block barrier needed
  row_delta<D>(o, dout, lse, delta, qoff, q0, S, tid, dl_s, lse_s);
  __syncwarp();

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int rw = 16 * w;  // this warp's first row
  for (int kt = lo; kt < hi; ++kt) {
    const int it = kt - lo;
    const int k0 = kt * BK;
    cp_async_wait<0>();
    __syncthreads();  // tile kt is in; every warp is done with the other stage
    if (kt + 1 < hi) {
      const uint32_t nxt = kv_s + ((it + 1) & 1) * 2 * BK * D * 2;
      load_tile<BK, CH, kDqThreads>(nxt, kb + (int64_t)(k0 + BK) * D, Sk - k0 - BK, tid);
      load_tile<BK, CH, kDqThreads>(nxt + BK * D * 2, vb + (int64_t)(k0 + BK) * D,
                                    Sk - k0 - BK, tid);
      cp_async_commit();
    }
    const uint32_t k_st = kv_s + (it & 1) * 2 * BK * D * 2;
    const uint32_t v_st = k_st + BK * D * 2;

    // S = Q K^T and dP = dO V^T, 16 rows x BK keys a warp
    float s[BK / 8][4], dp[BK / 8][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      ldsm_x4(q_s + swz<CH>(rw + (lane & 15), 2 * kk + (lane >> 4)), aq);
      ldsm_x4(do_s + swz<CH>(rw + (lane & 15), 2 * kk + (lane >> 4)), ado);
#pragma unroll
      for (int n2 = 0; n2 < BK / 16; ++n2) {
        const int row = 16 * n2 + (lane & 7) + 8 * (lane >> 4);
        const int ch = 2 * kk + ((lane >> 3) & 1);
        uint32_t bk_[4], bv[4];
        ldsm_x4(k_st + swz<CH>(row, ch), bk_);
        ldsm_x4(v_st + swz<CH>(row, ch), bv);
        mma16816(s[2 * n2], aq, bk_[0], bk_[1]);
        mma16816(s[2 * n2 + 1], aq, bk_[2], bk_[3]);
        mma16816(dp[2 * n2], ado, bv[0], bv[1]);
        mma16816(dp[2 * n2 + 1], ado, bv[2], bv[3]);
      }
    }

    // dS in place of S
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rw + (lane >> 2) + 8 * (e >> 1);
        float x = s[n][e] * scale;
        const bool ok = mk.apply(q0 + r, k0 + 8 * n + 2 * (lane & 3) + (e & 1), x);
        const float p = ok ? ex2(fmaf(x, kLog2e, -lse_s[r])) : 0.f;
        s[n][e] = ok ? mk.ds(p, dp[n][e], dl_s[r], x) : 0.f;
      }

    // dQ += dS K: dS (bf16) is the A operand from registers, K read transposed
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int row = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t bk_[4];
        ldsm_x4_t(k_st + swz<CH>(row, 2 * n2 + (lane >> 4)), bk_);
        mma16816(acc[2 * n2], a, bk_[0], bk_[1]);
        mma16816(acc[2 * n2 + 1], a, bk_[2], bk_[3]);
      }
    }
  }

  bf16* dqb = dq + qoff * D;
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int qi = q0 + rw + (lane >> 2) + 8 * e2;
    if (qi >= S) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (int64_t)qi * D + 8 * n + 2 * (lane & 3)) =
          __floats2bfloat162_rn(acc[n][2 * e2] * scale, acc[n][2 * e2 + 1] * scale);
  }
}

// ---- dk/dv kernel -------------------------------------------------------------

// grid (Hkv, ceil(Sk / BK), B), kKvThreads threads, KvTiles<D>::SMEM bytes
template <int D>
__global__ void __launch_bounds__(kKvThreads, 2) flash_bwd_dkv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ lse, const bf16* __restrict__ dout,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int Hq,
    int Hkv, Mask mk, float scale) {
  using T = KvTiles<D>;
  constexpr int BK = T::BK, RG = T::RG, CG = T::CG, BQ = T::BQ, NQS = T::NQS;
  constexpr int CH = D / 8;
  constexpr int PCH = BQ / 8;       // chunks a row of the P / dS tiles
  constexpr int NQ8 = BQ / CG / 8;  // 8-column blocks of a warp's S^T slice
  constexpr int ND8 = D / CG / 8;      // 8-column blocks of a warp's dk/dv slice
  constexpr int QT_BYTES = BQ * D * 2;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t k_s = smem_u32(smem);
  const uint32_t v_s = k_s + BK * D * 2;
  const uint32_t qd_s = v_s + BK * D * 2;  // stage st: Q at qd_s + 2 st QT_BYTES, dO after it
  const uint32_t p_s = qd_s + NQS * 2 * QT_BYTES;
  const uint32_t ds_s = p_s + BK * BQ * 2;
  // stage st: lse at ld_s + 2 st BQ, delta after it
  float* ld_s =
      reinterpret_cast<float*>(smem + 2 * BK * D * 2 + NQS * 2 * QT_BYTES + 2 * BK * BQ * 2);

  const int S = mk.S, Sk = mk.Sk;
  const int hk = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * BK;  // under causal masking the low tiles (heaviest) go first
  const int group = Hq / Hkv;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
  const int rw = 16 * (w % RG);         // this warp's first kv row
  const int iw = (w / RG) * (BQ / CG);  // first q row of its S^T slice
  const int dw = (w / RG) * (D / CG);      // first column of its dk/dv slice
  const int64_t koff = ((int64_t)b * Hkv + hk) * Sk * D;

  // only q tiles that intersect the causal/window band see this kv tile
  const int n_qt = (S + BQ - 1) / BQ;
  const int lo = mk.causal ? k0 / BQ : 0;
  const int hi = mk.has_window ? min(n_qt, (k0 + BK - 1 + mk.window) / BQ + 1) : n_qt;
  const int nq = max(0, hi - lo);
  const int n_it = group * nq;

  // step it: q head hk * group + it / nq, q tile lo + it % nq, into stage st
  auto load_q = [&](int it, int st) {
    const int q0 = (lo + it % nq) * BQ;
    const int64_t qoff = ((int64_t)b * Hq + hk * group + it / nq) * S;
    const uint32_t dst = qd_s + st * 2 * QT_BYTES;
    load_tile<BQ, CH, kKvThreads>(dst, q + (qoff + q0) * D, S - q0, tid);
    load_tile<BQ, CH, kKvThreads>(dst + QT_BYTES, dout + (qoff + q0) * D, S - q0, tid);
    if (tid < 2 * BQ) {
      const int i = tid % BQ;
      const bool ok = q0 + i < S;
      const float* src = (tid < BQ ? lse : delta) + qoff + (ok ? q0 + i : 0);
      cp_async4(smem_u32(ld_s + st * 2 * BQ + tid), src, ok);
    }
  };

  // one commit group per step (empty past the last) so that waiting for
  // all but the newest NQS - 2 groups means the step is in
  load_tile<BK, CH, kKvThreads>(k_s, k + koff + (int64_t)k0 * D, Sk - k0, tid);
  load_tile<BK, CH, kKvThreads>(v_s, v + koff + (int64_t)k0 * D, Sk - k0, tid);
#pragma unroll
  for (int p = 0; p < NQS - 1; ++p) {
    if (p < n_it) load_q(p, p);
    cp_async_commit();
  }

  float adk[ND8][4], adv[ND8][4];
#pragma unroll
  for (int n = 0; n < ND8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[n][e] = adv[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % NQS;
    const int q0 = (lo + it % nq) * BQ;
    cp_async_wait<NQS - 2>();
    __syncthreads();  // step it is in; every warp is done with step it - 1 and P, dS
    if (it + NQS - 1 < n_it) load_q(it + NQS - 1, (it + NQS - 1) % NQS);
    cp_async_commit();
    const uint32_t q_st = qd_s + st * 2 * QT_BYTES;
    const uint32_t do_st = q_st + QT_BYTES;
    const float* lse_s = ld_s + st * 2 * BQ;
    const float* dl_s = lse_s + BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 kv rows x this warp's BQ / CG q rows
    float s[NQ8][4], dp[NQ8][4];
#pragma unroll
    for (int n = 0; n < NQ8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ak[4], av[4];
      ldsm_x4(k_s + swz<CH>(rw + (lane & 15), 2 * kk + (lane >> 4)), ak);
      ldsm_x4(v_s + swz<CH>(rw + (lane & 15), 2 * kk + (lane >> 4)), av);
      if constexpr (NQ8 == 1) {
        const int row = iw + (lane & 7), ch = 2 * kk + ((lane >> 3) & 1);
        uint32_t bq[2], bd[2];
        ldsm_x2(q_st + swz<CH>(row, ch), bq);
        ldsm_x2(do_st + swz<CH>(row, ch), bd);
        mma16816(s[0], ak, bq[0], bq[1]);
        mma16816(dp[0], av, bd[0], bd[1]);
      } else {
#pragma unroll
        for (int n2 = 0; n2 < NQ8 / 2; ++n2) {
          const int row = iw + 16 * n2 + (lane & 7) + 8 * (lane >> 4);
          const int ch = 2 * kk + ((lane >> 3) & 1);
          uint32_t bq[4], bd[4];
          ldsm_x4(q_st + swz<CH>(row, ch), bq);
          ldsm_x4(do_st + swz<CH>(row, ch), bd);
          mma16816(s[2 * n2], ak, bq[0], bq[1]);
          mma16816(s[2 * n2 + 1], ak, bq[2], bq[3]);
          mma16816(dp[2 * n2], av, bd[0], bd[1]);
          mma16816(dp[2 * n2 + 1], av, bd[2], bd[3]);
        }
      }
    }

    // P^T and dS^T (element (kv row j, q row i)) to shared memory in bf16
#pragma unroll
    for (int n = 0; n < NQ8; ++n)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int j = rw + (lane >> 2) + 8 * e2;
        const int i = iw + 8 * n + 2 * (lane & 3);
        float p2[2], g2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = s[n][2 * e2 + c] * scale;
          const bool ok = mk.apply(q0 + i + c, k0 + j, x);
          p2[c] = ok ? ex2(fmaf(x, kLog2e, -lse_s[i + c] * kLog2e)) : 0.f;
          g2[c] = ok ? mk.ds(p2[c], dp[n][2 * e2 + c], dl_s[i + c], x) : 0.f;
        }
        const uint32_t at = swz<PCH>(j, i >> 3) + (i & 7) * 2;
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(p_s + at), "r"(pack_bf16(p2[0], p2[1])));
        asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(ds_s + at), "r"(pack_bf16(g2[0], g2[1])));
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the BQ q rows, on this warp's
    // slice of D (dO and Q read transposed)
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      uint32_t ap[4], ag[4];
      ldsm_x4(p_s + swz<PCH>(rw + (lane & 15), 2 * kk + (lane >> 4)), ap);
      ldsm_x4(ds_s + swz<PCH>(rw + (lane & 15), 2 * kk + (lane >> 4)), ag);
      const int row = 16 * kk + (lane & 7) + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int n2 = 0; n2 < ND8 / 2; ++n2) {
        const int ch = dw / 8 + 2 * n2 + (lane >> 4);
        uint32_t bd[4], bq[4];
        ldsm_x4_t(do_st + swz<CH>(row, ch), bd);
        ldsm_x4_t(q_st + swz<CH>(row, ch), bq);
        mma16816(adv[2 * n2], ap, bd[0], bd[1]);
        mma16816(adv[2 * n2 + 1], ap, bd[2], bd[3]);
        mma16816(adk[2 * n2], ag, bq[0], bq[1]);
        mma16816(adk[2 * n2 + 1], ag, bq[2], bq[3]);
      }
    }
  }

  // dk = scale * sum_i ds q_i (the products used unscaled q)
#pragma unroll
  for (int e2 = 0; e2 < 2; ++e2) {
    const int ki = k0 + rw + (lane >> 2) + 8 * e2;
    if (ki >= Sk) continue;
#pragma unroll
    for (int n = 0; n < ND8; ++n) {
      const int64_t at = koff + (int64_t)ki * D + dw + 8 * n + 2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(adk[n][2 * e2] * scale, adk[n][2 * e2 + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(adv[n][2 * e2], adv[n][2 * e2 + 1]);
    }
  }
}

// ---- wgmma kernels (dq at D = 64, 128, 256; dk/dv at D = 64, 128) ------------

constexpr int kWgThreads = 256;  // two warpgroups, every thread loads and computes
constexpr int kWgDqBQ = 128;     // q rows a dq CTA (64 a warpgroup)
constexpr int kWgKvBK = 128;     // kv rows a dk/dv CTA (64 a warpgroup)
constexpr int kWgKvBQ = 64;      // q rows a dk/dv step

template <int D>
struct WgTiles {
  static constexpr int DQ_BK = D == 256 ? 32 : 64;  // kv rows a dq step
  // Q, dO; 2 stages of K, V; lse, delta (+ 1 KB to align the swizzle atoms)
  static constexpr int DQ_SMEM = 1024 + 2 * kWgDqBQ * D * 2 + 2 * 2 * DQ_BK * D * 2 + 2 * 4 * kWgDqBQ;
  // K, V; 2 stages of Q, dO, lse, delta
  static constexpr int KV_SMEM = 1024 + 2 * kWgKvBK * D * 2 + 2 * (2 * kWgKvBQ * D * 2 + 2 * 4 * kWgKvBQ);
};

// rows [0, R) of a row-major bf16 (rows, D) tile into the 128-byte swizzle
// wgmma reads: D / 64 column blocks of R rows x 128 bytes, each row's 16-byte
// chunks XORed with the row mod 8 (dst 1024-byte aligned); rows >= valid zeros
template <int R, int D>
__device__ __forceinline__ void load_tile_sw128(uint32_t dst, const bf16* src, int valid, int tid) {
  constexpr int CH = D / 8;
#pragma unroll 4
  for (int i = tid; i < R * CH; i += kWgThreads) {
    const int r = i / CH, c = i % CH;
    const bool ok = r < valid;
    cp_async16(dst + (c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4),
               ok ? src + ((int64_t)r * CH + c) * 8 : src, ok);
  }
}

// make this thread's completed cp.async writes visible to wgmma (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// grid (Hq, ceil(S / kWgDqBQ), B), kWgThreads threads, WgTiles<D>::DQ_SMEM bytes;
// at D = 256 the K/V tiles are 32 keys (Q and dO take 128 KB)
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dq_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const bf16* __restrict__ o, const float* __restrict__ lse, const bf16* __restrict__ dout,
    float* __restrict__ delta, bf16* __restrict__ dq, int Hq, int Hkv, Mask mk, float scale) {
  constexpr int BQ = kWgDqBQ, BK = WgTiles<D>::DQ_BK;
  constexpr int KT_BYTES = BK * D * 2;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = q_s + BQ * D * 2;
  const uint32_t kv_s = do_s + BQ * D * 2;  // stage st: K at kv_s + 2 st KT_BYTES, V after it
  float* lse_s = reinterpret_cast<float*>(smem + (base - smem_u32(smem)) + 2 * BQ * D * 2 +
                                          4 * KT_BYTES);
  float* dl_s = lse_s + BQ;

  const int S = mk.S, Sk = mk.Sk;
  const int h = blockIdx.x, b = blockIdx.z;
  const int n_qt = (S + BQ - 1) / BQ;
  const int qt = mk.causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y;
  const int q0 = qt * BQ;
  const int q_hi = min(q0 + BQ, S) - 1;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x, g = tid >> 7, t = tid & 127, lane = tid & 31;
  const int64_t qoff = ((int64_t)b * Hq + h) * S;
  const bf16* kb = k + ((int64_t)b * Hkv + hk) * Sk * D;
  const bf16* vb = v + ((int64_t)b * Hkv + hk) * Sk * D;

  const int n_kt = (Sk + BK - 1) / BK;
  const int hi = mk.causal ? min(n_kt, q_hi / BK + 1) : n_kt;
  const int lo = mk.has_window ? max(0, q0 - mk.window + 1) / BK : 0;

  load_tile_sw128<BQ, D>(q_s, q + (qoff + q0) * D, S - q0, tid);
  load_tile_sw128<BQ, D>(do_s, dout + (qoff + q0) * D, S - q0, tid);
  if (lo < hi) {
    load_tile_sw128<BK, D>(kv_s, kb + (int64_t)lo * BK * D, Sk - lo * BK, tid);
    load_tile_sw128<BK, D>(kv_s + KT_BYTES, vb + (int64_t)lo * BK * D, Sk - lo * BK, tid);
  }
  cp_async_commit();

  row_delta<D>(o, dout, lse, delta, qoff, q0, S, tid, dl_s, lse_s);
  __syncthreads();
  // this thread's two rows of the warpgroup's accumulator fragments
  const int row0 = 64 * g + 16 * (t >> 5) + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const float lse2[2] = {lse_s[row0], lse_s[row0 + 8]};
  const float dl[2] = {dl_s[row0], dl_s[row0 + 8]};

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sa[BK / 2], pa[BK / 2];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) sa[i] = pa[i] = 0.f;

  for (int kt = lo; kt < hi; ++kt) {
    const int it = kt - lo, k0 = kt * BK;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // tile kt is in; every warp is done with the other stage
    if (kt + 1 < hi) {
      const uint32_t nxt = kv_s + ((it + 1) & 1) * 2 * KT_BYTES;
      load_tile_sw128<BK, D>(nxt, kb + (int64_t)(k0 + BK) * D, Sk - k0 - BK, tid);
      load_tile_sw128<BK, D>(nxt + KT_BYTES, vb + (int64_t)(k0 + BK) * D, Sk - k0 - BK, tid);
      cp_async_commit();
    }
    const uint32_t k_st = kv_s + (it & 1) * 2 * KT_BYTES, v_st = k_st + KT_BYTES;

    // S = Q K^T and dP = dO V^T (64 q rows of this warpgroup x BK keys)
    fence_regs<BK / 2>(sa);
    fence_regs<BK / 2>(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * BQ * 128 + g * 64 * 128 + (kk & 3) * 32;
      const uint32_t offk = (kk >> 2) * BK * 128 + (kk & 3) * 32;
      wgmma_ss<BK>(sa, desc_sw128(q_s + off, 16, 1024), desc_sw128(k_st + offk, 16, 1024), kk > 0);
      wgmma_ss<BK>(pa, desc_sw128(do_s + off, 16, 1024), desc_sw128(v_st + offk, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs<BK / 2>(sa);
    fence_regs<BK / 2>(pa);

    // dS (bf16 A fragments: the accumulator layout of two 8-column blocks is
    // the A layout of one 16-deep k-step)
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int n = 0; n < BK / 8; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float g2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float x = sa[4 * n + 2 * hh + c] * scale;
          const bool ok = mk.apply(q0 + row0 + 8 * hh, k0 + 8 * n + cq + c, x);
          const float p = ok ? ex2(fmaf(x, kLog2e, -lse2[hh])) : 0.f;
          g2[c] = ok ? mk.ds(p, pa[4 * n + 2 * hh + c], dl[hh], x) : 0.f;
        }
        da[n >> 1][(n & 1) * 2 + hh] = pack_bf16(g2[0], g2[1]);
      }

    // dQ += dS K: K read N-major (16 keys a k-step are 2048 bytes; the
    // 128-byte column blocks are BK * 128 bytes apart)
    fence_regs<D / 2>(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs<D>(acc, da[kk], desc_sw128(k_st + kk * 16 * 128, BK * 128, 1024));
    wg_commit();
    wg_wait<0>();
    fence_regs<D / 2>(acc);
  }

  bf16* dqb = dq + qoff * D;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qi = q0 + row0 + 8 * hh;
    if (qi >= S) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dqb + (int64_t)qi * D + 8 * n + cq) =
          __floats2bfloat162_rn(acc[4 * n + 2 * hh] * scale, acc[4 * n + 2 * hh + 1] * scale);
  }
}

// grid (Hkv, ceil(Sk / kWgKvBK), B), kWgThreads threads, WgTiles<D>::KV_SMEM bytes
template <int D>
__global__ void __launch_bounds__(kWgThreads, 1) flash_bwd_dkv_wgmma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ lse, const bf16* __restrict__ dout,
    const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv, int Hq,
    int Hkv, Mask mk, float scale) {
  constexpr int BK = kWgKvBK, BQ = kWgKvBQ;
  constexpr int QT_BYTES = BQ * D * 2;
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = (smem_u32(smem) + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = k_s + BK * D * 2;
  const uint32_t qd_s = v_s + BK * D * 2;  // stage st: Q at qd_s + 2 st QT_BYTES, dO after it
  // stage st: lse at ld_s + 2 st BQ, delta after it
  float* ld_s = reinterpret_cast<float*>(smem + (base - smem_u32(smem)) + 2 * BK * D * 2 +
                                         4 * QT_BYTES);

  const int S = mk.S, Sk = mk.Sk;
  const int hk = blockIdx.x, b = blockIdx.z;
  const int k0 = blockIdx.y * BK;  // under causal masking the low tiles (heaviest) go first
  const int group = Hq / Hkv;
  const int tid = threadIdx.x, g = tid >> 7, t = tid & 127, lane = tid & 31;
  const int64_t koff = ((int64_t)b * Hkv + hk) * Sk * D;
  const int row0 = 64 * g + 16 * (t >> 5) + (lane >> 2);  // kv rows row0, row0 + 8 of the tile
  const int cq = 2 * (lane & 3);

  const int n_qt = (S + BQ - 1) / BQ;
  const int lo = mk.causal ? k0 / BQ : 0;
  const int hi = mk.has_window ? min(n_qt, (k0 + BK - 1 + mk.window) / BQ + 1) : n_qt;
  const int nq = max(0, hi - lo);
  const int n_it = group * nq;

  auto load_q = [&](int it, int st) {
    const int q0 = (lo + it % nq) * BQ;
    const int64_t qoff = ((int64_t)b * Hq + hk * group + it / nq) * S;
    const uint32_t dst = qd_s + st * 2 * QT_BYTES;
    load_tile_sw128<BQ, D>(dst, q + (qoff + q0) * D, S - q0, tid);
    load_tile_sw128<BQ, D>(dst + QT_BYTES, dout + (qoff + q0) * D, S - q0, tid);
    if (tid < 2 * BQ) {
      const int i = tid % BQ;
      const bool ok = q0 + i < S;
      const float* src = (tid < BQ ? lse : delta) + qoff + (ok ? q0 + i : 0);
      cp_async4(smem_u32(ld_s + st * 2 * BQ + tid), src, ok);
    }
  };

  load_tile_sw128<BK, D>(k_s, k + koff + (int64_t)k0 * D, Sk - k0, tid);
  load_tile_sw128<BK, D>(v_s, v + koff + (int64_t)k0 * D, Sk - k0, tid);
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();

  float adk[D / 2], adv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;
  float sa[BQ / 2], pa[BQ / 2];
#pragma unroll
  for (int i = 0; i < BQ / 2; ++i) sa[i] = pa[i] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const int q0 = (lo + it % nq) * BQ;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // step it is in; every warp is done with step it - 1
    if (it + 1 < n_it) {
      load_q(it + 1, st ^ 1);
      cp_async_commit();
    }
    const uint32_t q_st = qd_s + st * 2 * QT_BYTES, do_st = q_st + QT_BYTES;
    const float* lse_s = ld_s + st * 2 * BQ;
    const float* dl_s = lse_s + BQ;

    // S^T = K Q^T and dP^T = V dO^T (64 kv rows of this warpgroup x BQ q rows)
    fence_regs<BQ / 2>(sa);
    fence_regs<BQ / 2>(pa);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk >> 2) * BK * 128 + g * 64 * 128 + (kk & 3) * 32;
      const uint32_t offq = (kk >> 2) * BQ * 128 + (kk & 3) * 32;
      wgmma_ss<BQ>(sa, desc_sw128(k_s + off, 16, 1024), desc_sw128(q_st + offq, 16, 1024), kk > 0);
      wgmma_ss<BQ>(pa, desc_sw128(v_s + off, 16, 1024), desc_sw128(do_st + offq, 16, 1024), kk > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs<BQ / 2>(sa);
    fence_regs<BQ / 2>(pa);

    // P^T and dS^T (element (kv row j, q row i)) as bf16 A fragments
    uint32_t pf[BQ / 16][4], gf[BQ / 16][4];
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float p2[2], g2[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int i = 8 * n + cq + c;
          float x = sa[4 * n + 2 * hh + c] * scale;
          const bool ok = mk.apply(q0 + i, k0 + row0 + 8 * hh, x);
          p2[c] = ok ? ex2(fmaf(x, kLog2e, -lse_s[i] * kLog2e)) : 0.f;
          g2[c] = ok ? mk.ds(p2[c], pa[4 * n + 2 * hh + c], dl_s[i], x) : 0.f;
        }
        pf[n >> 1][(n & 1) * 2 + hh] = pack_bf16(p2[0], p2[1]);
        gf[n >> 1][(n & 1) * 2 + hh] = pack_bf16(g2[0], g2[1]);
      }

    // dV += P^T dO and dK += dS^T Q: dO and Q read N-major
    fence_regs<D / 2>(adv);
    fence_regs<D / 2>(adk);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      wgmma_rs<D>(adv, pf[kk], desc_sw128(do_st + kk * 16 * 128, BQ * 128, 1024));
      wgmma_rs<D>(adk, gf[kk], desc_sw128(q_st + kk * 16 * 128, BQ * 128, 1024));
    }
    wg_commit();
    wg_wait<0>();
    fence_regs<D / 2>(adv);
    fence_regs<D / 2>(adk);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int ki = k0 + row0 + 8 * hh;
    if (ki >= Sk) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int64_t at = koff + (int64_t)ki * D + 8 * n + cq;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(adk[4 * n + 2 * hh] * scale, adk[4 * n + 2 * hh + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(adv[4 * n + 2 * hh], adv[4 * n + 2 * hh + 1]);
    }
  }
}

// set both kernels' shared memory, then launch dq and dk/dv in order
template <auto DqKernel, auto KvKernel>
int launch_pair(int dq_smem, int kv_smem, int dq_threads, int kv_threads, int dq_rows,
                int kv_rows, const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                const float* lse, const bf16* dout, float* delta, bf16* dq, bf16* dk, bf16* dv,
                int B, int Hq, int Hkv, Mask mk, float scale, int device, cudaStream_t stream) {
  cudaError_t err = set_smem_once<DqKernel>(dq_smem, device);
  if (err != cudaSuccess) return (int)err;
  err = set_smem_once<KvKernel>(kv_smem, device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q(Hq, (mk.S + dq_rows - 1) / dq_rows, B);
  DqKernel<<<grid_q, dq_threads, dq_smem, stream>>>(q, k, v, o, lse, dout, delta, dq, Hq, Hkv,
                                                    mk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k(Hkv, (mk.Sk + kv_rows - 1) / kv_rows, B);
  KvKernel<<<grid_k, kv_threads, kv_smem, stream>>>(q, k, v, lse, dout, delta, dk, dv, Hq, Hkv,
                                                    mk, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_d(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const float* lse,
             const bf16* dout, float* delta, bf16* dq, bf16* dk, bf16* dv, int B, int Hq,
             int Hkv, Mask mk, float scale, int smem_dq, int smem_dkv, int device,
             cudaStream_t stream) {
  // the wrapper's tile plan must agree with the compiled tiles
  if constexpr (D == 64 || D == 128) {  // wgmma
    if (smem_dq != WgTiles<D>::DQ_SMEM || smem_dkv != WgTiles<D>::KV_SMEM)
      return (int)cudaErrorInvalidValue;
    return launch_pair<flash_bwd_dq_wgmma_kernel<D>, flash_bwd_dkv_wgmma_kernel<D>>(
        WgTiles<D>::DQ_SMEM, WgTiles<D>::KV_SMEM, kWgThreads, kWgThreads, kWgDqBQ, kWgKvBK, q, k,
        v, o, lse, dout, delta, dq, dk, dv, B, Hq, Hkv, mk, scale, device, stream);
  } else if constexpr (D == 256) {  // wgmma dq, mma.sync dk/dv
    if (smem_dq != WgTiles<D>::DQ_SMEM || smem_dkv != KvTiles<D>::SMEM)
      return (int)cudaErrorInvalidValue;
    return launch_pair<flash_bwd_dq_wgmma_kernel<D>, flash_bwd_dkv_mma_kernel<D>>(
        WgTiles<D>::DQ_SMEM, KvTiles<D>::SMEM, kWgThreads, kKvThreads, kWgDqBQ, KvTiles<D>::BK, q,
        k, v, o, lse, dout, delta, dq, dk, dv, B, Hq, Hkv, mk, scale, device, stream);
  } else {  // mma.sync
    if (smem_dq != DqTiles<D>::SMEM || smem_dkv != KvTiles<D>::SMEM)
      return (int)cudaErrorInvalidValue;
    return launch_pair<flash_bwd_dq_mma_kernel<D>, flash_bwd_dkv_mma_kernel<D>>(
        DqTiles<D>::SMEM, KvTiles<D>::SMEM, kDqThreads, kKvThreads, kDqBQ, KvTiles<D>::BK, q, k,
        v, o, lse, dout, delta, dq, dk, dv, B, Hq, Hkv, mk, scale, device, stream);
  }
}

}  // namespace

extern "C" {

// smem_dq, smem_dkv: the dynamic shared memory the wrapper's tile plan gives
// the two kernels
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v, const void* o,
                             const float* lse, const void* dout, float* delta, void* dq,
                             void* dk, void* dv, int B, int Hq, int Hkv, int S, int Sk, int D,
                             int causal, int has_window, int window, int has_softcap,
                             float softcap, float scale, int smem_dq, int smem_dkv, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || Sk <= 0 || (S + kDqBQ - 1) / kDqBQ > 65535 ||
      (Sk + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  const void* ptrs[] = {q, k, v, o, dout, dq, dk, dv};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const Mask mk{S, Sk, causal, has_window, window, has_softcap, softcap,
                has_softcap ? 1.f / softcap : 0.f};
  cudaStream_t s = (cudaStream_t)stream;
#define BWD_CASE(DD)                                                                        \
  case DD:                                                                                  \
    return launch_d<DD>((const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o, lse, \
                        (const bf16*)dout, delta, (bf16*)dq, (bf16*)dk, (bf16*)dv, B, Hq,   \
                        Hkv, mk, scale, smem_dq, smem_dkv, device, s);
  switch (D) {
    BWD_CASE(16)
    BWD_CASE(32)
    BWD_CASE(64)
    BWD_CASE(128)
    BWD_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef BWD_CASE
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
