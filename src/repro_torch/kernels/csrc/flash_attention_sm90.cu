// Hand-written Hopper kernel for the bfloat16 flash-attention forward pass:
// wgmma fed by TMA, warp-specialised.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py
// (flash_attention_fwd / _attn_kernel, :50) for bfloat16 inputs, the dtype of
// every attention call on the score, train and gossip paths. float32 inputs
// keep the CUDA-core kernel of flash_attention.cu: wgmma on float32 is TF32,
// which keeps about 3 decimal digits and cannot meet the 2e-5 float32 bar.
// The wrapper (kernels/flash_attention.py) picks the kernel by dtype; a
// bfloat16 call never reaches the CUDA-core kernel.
//
// Contract (the same as flash_attention.cu): q (B, Hq, S, D), k and v
// (B, Hkv, Sk, D) bf16, heads-major; query head h reads kv head
// h / (Hq / Hkv); positions count from 0 on both axes:
//   mask(i, j) = j < Sk  [and i >= j if causal]  [and i - j < window]
//   s = softcap(q_i . k_j / sqrt(D)), masked entries -1e30 (selected)
//   o_i = sum_j softmax(s)_ij v_j,  lse_i = m_i + log(max(l_i, 1e-30)) (float32)
// D in {16, 32, 64, 128, 256}. Ragged S and Sk are masked in the kernel.
//
// Design. One CTA of 384 threads per (q head, 128-row q tile, batch):
//   producer   warpgroup 0 gives its registers away (setmaxnreg 24); one
//              thread starts the TMA loads: the Q tile once, then K and V tiles
//              through a 2-stage ring with a full barrier per tile and an
//              empty barrier per stage (mbarrier). TMA zero-fills rows past
//              S and Sk (the mask decides what attends) and writes every
//              tile in the 128-byte swizzle wgmma reads. The descriptors are
//              encoded on the host per call (cuTensorMapEncodeTiled, reached
//              through cudaGetDriverEntryPoint: no -lcuda) and passed as
//              __grid_constant__ parameters.
//   consumers  warpgroups 1 and 2 (setmaxnreg 240) own 64 q rows each:
//              S = Q K^T by wgmma m64nBKk16 (Q and K from shared memory),
//              softcap, mask and the online softmax on the f32 accumulator
//              fragment (row max and sum over the 4 lanes of a quad), then
//              O += P V by wgmma m64nDPk16 with P in registers as the A
//              operand (P never touches shared memory) and V read N-major
//              through the descriptor. Tiles inside the band without a
//              softcap take a short path (the row max of the raw scores,
//              then one FMA into exp2 an element), and O is rescaled only
//              when a row maximum moved: the softmax, not the products, had
//              been the larger share of the time.
// Precision: P enters the product as hi + lo, two bf16 values (hi the
// truncation, lo the rounded remainder), two wgmmas a k-step. P as one bf16
// (as FA2/FA3 do) is off by up to 2^-9 relative, and at a full-width random
// init (scores ~1000, |v| up to ~30) that put 143 of 8.4 M outputs of a
// scoring layer outside the 2e-2 bf16 bar on the card; hi + lo is exact to
// ~2^-16 and keeps them inside. It costs a third more tensor work.
// Tiles: a 64-column (128-byte) block is the swizzle atom's width, so D < 64
// is zero-filled to DP = 64 columns by TMA; BK = 128 keys at D <= 128 and 64
// at D = 256 (Q 64 KB + 2 stages x (K + V) 64 KB + 1 KB alignment = 193 KB),
// where the O accumulator is 128 f32 registers a consumer thread. Only K/V
// tiles inside the causal/window band are loaded; only tiles that cross the
// diagonal, the window edge or Sk apply the per-element mask. Under causal
// masking the q tiles run heaviest first (the grid's y index reversed, heads
// innermost), and at gemma2-2b's D = 256 (8 heads, S = 2048) the grid is 128
// CTAs on 132 SMs: one wave.
//
// What bounds it on an H100: operations. At the scoring shape (B=1,
// minitron-8b's 32 heads, S=2048, D=128, causal) a call does 4 S (S+1)/2 D Hq
// = 34.4 GFLOP against 42 MB of inputs and outputs: 0.0348 ms at the
// 989 TFLOP/s bf16 tensor-core peak; at gemma2-2b's D = 256 (8 heads) 0.0174.
//
// Plain C entry point (bound with ctypes by kernels/_build.py). It launches
// on the given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() right after its launch (or the error that stopped it).

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kBQ = 128;       // q rows a CTA (two consumer warpgroups of 64)
constexpr int kThreads = 384;  // producer warpgroup + 2 consumer warpgroups

template <int D>
struct Tiles {
  static constexpr int DP = D < 64 ? 64 : D;  // columns in shared memory
  static constexpr int NCB = DP / 64;         // 128-byte column blocks
  static constexpr int BK = D == 256 ? 64 : 128;
  static constexpr int Q_BYTES = NCB * kBQ * 128;
  static constexpr int KV_BYTES = NCB * BK * 128;  // one K or V tile
  // + 1024 to align the base to the swizzle atom, + 64 for the barriers
  static constexpr int SMEM = 1024 + Q_BYTES + 4 * KV_BYTES + 64;
};

// ---- the kernel --------------------------------------------------------------

// grid (Hq, ceil(S / kBQ), B), kThreads threads, Tiles<D>::SMEM bytes
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int Hq, int Hkv, int S, int Sk, int causal, int has_window,
    int window, int has_softcap, float softcap, float scale) {
  using T = Tiles<D>;
  constexpr int BK = T::BK, DP = T::DP, NCB = T::NCB;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + T::Q_BYTES;          // 2 stages
  const uint32_t v_s = k_s + 2 * T::KV_BYTES;     // 2 stages
  const uint32_t bar = v_s + 2 * T::KV_BYTES;
  const uint32_t q_full = bar;
  // k_full[st] = bar + 8 (1 + st), v_full[st] = bar + 8 (3 + st), kv_empty[st] = bar + 8 (5 + st)

  const int h = blockIdx.x;
  const int b = blockIdx.z;
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int qt = causal ? n_qt - 1 - (int)blockIdx.y : (int)blockIdx.y;  // heaviest first
  const int q0 = qt * kBQ;
  const int q_hi = min(q0 + kBQ, S) - 1;  // last row of the tile inside S
  const int hk = h / (Hq / Hkv);
  const int n_kt = (Sk + BK - 1) / BK;
  int hi = n_kt;
  if (causal) hi = min(n_kt, q_hi / BK + 1);
  const int lo = has_window ? max(0, q0 - window + 1) / BK : 0;
  const int n_tiles = max(0, hi - lo);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      mbar_init(bar + 8 * (1 + st), 1);
      mbar_init(bar + 8 * (3 + st), 1);
      mbar_init(bar + 8 * (5 + st), 2 * 128);  // every consumer thread arrives
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      const int plane_q = b * Hq + h, plane_k = b * Hkv + hk;
      mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb)
        tma_load_3d(q_s + cb * kBQ * 128, &tm_q, q_full, 64 * cb, q0, plane_q);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it & 1;
        const int k0 = (lo + it) * BK;
        mbar_wait(bar + 8 * (5 + st), ((it >> 1) & 1) ^ 1);  // the stage is free
        const uint32_t kf = bar + 8 * (1 + st), vf = bar + 8 * (3 + st);
        mbar_expect_tx(kf, T::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          tma_load_3d(k_s + st * T::KV_BYTES + cb * BK * 128, &tm_k, kf, 64 * cb, k0, plane_k);
        mbar_expect_tx(vf, T::KV_BYTES);
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb)
          tma_load_3d(v_s + st * T::KV_BYTES + cb * BK * 128, &tm_v, vf, 64 * cb, k0, plane_k);
      }
    }
  } else {
    // ---- consumers: warpgroup g owns q rows 64 g .. 64 g + 63 of the tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int g = wg - 1;
    const int t = threadIdx.x & 127;
    const int lane = t & 31;
    // this thread's rows (fragment row halves i = 0, 1) and first column of
    // each 8-column block of a wgmma accumulator
    const int row0 = 64 * g + 16 * (t >> 5) + (lane >> 2);
    const int cq = 2 * (lane & 3);
    float s[BK / 2], acc[DP / 2];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // m in log2 units
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    const float sl = scale * kLog2e;
    const float cap_in = has_softcap ? scale / softcap : 0.f, cap_out = softcap * kLog2e;

    mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it & 1;
      const int ph = (it >> 1) & 1;
      const int k0 = (lo + it) * BK;
      mbar_wait(bar + 8 * (1 + st), ph);

      // S = Q K^T over D (k-steps of 16 columns: 32 bytes inside a 128-byte row)
      fence_regs<BK / 2>(s);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;
        const uint64_t da = desc_sw128(q_s + (kk >> 2) * kBQ * 128 + g * 64 * 128 + off, 16, 1024);
        const uint64_t db =
            desc_sw128(k_s + st * T::KV_BYTES + (kk >> 2) * BK * 128 + off, 16, 1024);
        wgmma_ss<BK>(s, da, db, kk > 0);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs<BK / 2>(s);

      // online softmax in log2 units; a row's 4 owners are the lanes of one
      // quad. Tiles inside the band without a softcap take the short path:
      // the row max of the raw scores, then p = 2^(s sl - m) in one FMA. The
      // rest apply the softcap and, where the tile crosses Sk, the diagonal
      // or the window edge, the per-element mask (masked entries selected).
      const bool need_mask = k0 + BK > Sk || (causal && k0 + BK - 1 > q0) ||
                             (has_window && q_hi - k0 >= window);
      const bool plain = !need_mask && !has_softcap;
      if (!plain) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
              float x = s[4 * j + 2 * i + c];
              x = has_softcap ? fast_tanh(x * cap_in) * cap_out : x * sl;
              if (need_mask) {
                const int qi = q0 + row0 + 8 * i, ki = k0 + 8 * j + cq + c;
                bool ok = ki < Sk;
                if (causal) ok = ok && qi >= ki;
                if (has_window) ok = ok && qi - ki < window;
                x = ok ? x : kNegInf * kLog2e;
              }
              s[4 * j + 2 * i + c] = x;
            }
      }
      const float f = plain ? sl : 1.f;  // what the scores still need multiplied by
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = s[2 * i];
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx * f);
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float p = exp2f(fmaf(s[4 * j + 2 * i + c], f, -m_new));
            s[4 * j + 2 * i + c] = p;
            sum += p;
          }
        l[i] = l[i] * alpha[i] + sum;  // this thread's columns; the quad sums at the end
      }
      if (alpha[0] != 1.f || alpha[1] != 1.f) {  // once the row maxima settle, rarely
#pragma unroll
        for (int j = 0; j < DP / 8; ++j)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            acc[4 * j + 2 * i] *= alpha[i];
            acc[4 * j + 2 * i + 1] *= alpha[i];
          }
      }

      // P as wgmma A fragments: the accumulator layout of two 8-column
      // blocks is the A layout of one 16-deep k-step; P = hi + lo, both bf16
      uint32_t pa[BK / 16][4], pl[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) split_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], pa[kk][r], pl[kk][r]);

      // O += P V: V is [key][column], read N-major (16 keys a k-step are
      // 2048 bytes; the 128-byte column blocks are BK * 128 bytes apart)
      mbar_wait(bar + 8 * (3 + st), ph);
      fence_regs<DP / 2>(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = desc_sw128(v_s + st * T::KV_BYTES + kk * 16 * 128, BK * 128, 1024);
        wgmma_rs<DP>(acc, pa[kk], db);
        wgmma_rs<DP>(acc, pl[kk], db);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs<DP / 2>(acc);
      mbar_arrive(bar + 8 * (5 + st));  // this thread no longer reads the stage
    }

    // epilogue: o = acc / l in bf16, lse in natural log
    __nv_bfloat16* ob = o + ((int64_t)b * Hq + h) * S * D;
    float* lb = lse + ((int64_t)b * Hq + h) * S;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      const int qi = q0 + row0 + 8 * i;
      if (qi >= S) continue;
      const float ls = fmaxf(l[i], 1e-30f);
      const float inv = 1.f / ls;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + cq;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)qi * D + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv, acc[4 * j + 2 * i + 1] * inv);
      }
      if ((lane & 3) == 0) lb[qi] = m[i] * kLn2 + logf(ls);
    }
  }
}

// ---- host side -----------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, or null
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (D, rows, planes) bf16 tensor read in boxes of 64 columns x box_rows rows,
// 128-byte swizzle, zeros past every edge
int make_map(CUtensorMap* map, const void* ptr, int D, int rows, int planes, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)planes};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int D>
int launch_d(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Hq,
             int Hkv, int S, int Sk, int causal, int has_window, int window, int has_softcap,
             float softcap, float scale, int smem, int device, cudaStream_t stream) {
  using T = Tiles<D>;
  if (smem != T::SMEM) return (int)cudaErrorInvalidValue;  // the wrapper's tile plan disagrees
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, D, S, B * Hq, kBQ);
  if (err == 0) err = make_map(&tk, k, D, Sk, B * Hkv, T::BK);
  if (err == 0) err = make_map(&tv, v, D, Sk, B * Hkv, T::BK);
  if (err != 0) return err;
  const cudaError_t e = set_smem_once<flash_fwd_wgmma_kernel<D>>(T::SMEM, device);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Hq, (S + kBQ - 1) / kBQ, B);
  flash_fwd_wgmma_kernel<D><<<grid, kThreads, T::SMEM, stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, lse, Hq, Hkv, S, Sk, causal, has_window, window,
      has_softcap, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// smem: the dynamic shared memory the wrapper's tile plan gives the kernel
int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                             int B, int Hq, int Hkv, int S, int Sk, int D, int causal,
                             int has_window, int window, int has_softcap, float softcap,
                             float scale, int smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || Sk <= 0 || (S + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FWD_CASE(DD)                                                                        \
  case DD:                                                                                  \
    return launch_d<DD>(q, k, v, o, lse, B, Hq, Hkv, S, Sk, causal, has_window, window,    \
                        has_softcap, softcap, scale, smem, device, s);
  switch (D) {
    FWD_CASE(16)
    FWD_CASE(32)
    FWD_CASE(64)
    FWD_CASE(128)
    FWD_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FWD_CASE
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
