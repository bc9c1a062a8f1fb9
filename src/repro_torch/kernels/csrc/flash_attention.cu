// Hand-written Hopper kernel for the flash-attention forward pass.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/flash_attention.py
// (flash_attention_fwd / _attn_kernel): blocked online-softmax attention
// with GQA, causal masking, a sliding window and a softcap, emitting the
// output o and the per-row log-sum-exp lse (float32). Layout is heads-major
// as in the JAX package: q (B, Hq, S, D), k and v (B, Hkv, Sk, D); query
// head h reads kv head h / (Hq / Hkv). Positions count from 0 on both axes:
//   mask(i, j) = j < Sk  [and i >= j if causal]  [and i - j < window]
//   s = softcap(q_i . k_j / sqrt(D)), masked entries -1e30 (as the TPU kernel)
//   o_i = sum_j softmax(s)_ij v_j,  lse_i = m_i + log(max(l_i, 1e-30)).
//
// Translation. The TPU kernel's program instance is one (batch, q head,
// q block) with a fori_loop over K/V blocks and the whole K/V row in VMEM;
// ragged lengths are zero-padded by the wrapper. Here one block of 256
// threads handles one (b, h, 64-row q tile), loops over 32-row K/V tiles
// staged in shared memory, and keeps the online-softmax carry (m, l and a
// 64 x D accumulator) in registers: each thread owns 4 rows and D/16
// columns. Ragged S and Sk are masked in the kernel (rows past S are never
// written, keys past Sk never read). Causal and window bounds skip K/V
// tiles that no row of the q tile can see.
//
// What bounds it on an H100: operations. At the scoring shape (B=1,
// minitron-8b's 32 heads, S=2048, D=128, causal) a call does about
// 4*S*S*D*Hq/2 = 34 GFLOP against 42 MB of inputs and outputs, far above
// the card's ridge point. This first version uses float32 FMAs (CUDA cores, 67 TFLOP/s
// peak) with bf16 or float32 inputs converted when staged; tensor cores
// (mma.sync, then wgmma with TMA-fed shared-memory rings) are the later
// step that reaches the 989 TFLOP/s bf16 rate.
//
// Plain C entry points (bound with ctypes by kernels/_build.py). Each
// launches on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 32;        // k rows per tile
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows, tx owns 2 k columns / D/16 o columns

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
constexpr size_t smem_floats() {
  return (size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) + (size_t)kBK * D +
         (size_t)kBQ * (kBK + 1);
}

// grid (ceil(S / kBQ), Hq, B), kThreads threads
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int Hq, int Hkv, int S, int Sk, int causal,
    int has_window, int window, int has_softcap, float softcap, float scale) {
  constexpr int NC = D / 16;  // o columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                  // kBQ x (D + 1), pre-scaled
  float* k_s = q_s + kBQ * (D + 1);   // kBK x (D + 1)
  float* v_s = k_s + kBK * (D + 1);   // kBK x D
  float* p_s = v_s + kBK * D;         // kBQ x (kBK + 1)

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const T* qb = q + ((int64_t)b * Hq + h) * S * D;
  const T* kb = k + ((int64_t)b * Hkv + hk) * Sk * D;
  const T* vb = v + ((int64_t)b * Hkv + hk) * Sk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    q_s[r * (D + 1) + d] = qi < S ? to_f(qb[(int64_t)qi * D + d]) * scale : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = (Sk + kBK - 1) / kBK;
  int hi = n_kt;
  if (causal) hi = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  int lo = 0;
  if (has_window) lo = max(0, q0 - window + 1) / kBK;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is no longer read (and q_s is staged)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int ki = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (ki < Sk) {
        kv = to_f(kb[(int64_t)ki * D + d]);
        vv = to_f(vb[(int64_t)ki * D + d]);
      }
      k_s[r * (D + 1) + d] = kv;
      v_s[r * D + d] = vv;
    }
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * (D + 1) + d];
      const float k0v = k_s[tx * (D + 1) + d];
      const float k1v = k_s[(tx + 16) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][0] = fmaf(qv[i], k0v, s[i][0]);
        s[i][1] = fmaf(qv[i], k1v, s[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ki = k0 + tx + 16 * j;
        float x = s[i][j];
        if (has_softcap) x = softcap * tanhf(x / softcap);
        bool ok = ki < Sk;
        if (causal) ok = ok && qi >= ki;
        if (has_window) ok = ok && qi - ki < window;
        s[i][j] = ok ? x : kNegInf;
      }
      // row statistics over the 16 lanes that share this row (xor < 16
      // stays inside the half-warp of one ty)
      float mx = fmaxf(s[i][0], s[i][1]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      const float p0 = expf(s[i][0] - m_new);
      const float p1 = expf(s[i][1] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
      p_s[(ty * 4 + i) * (kBK + 1) + tx] = p0;
      p_s[(ty * 4 + i) * (kBK + 1) + tx + 16] = p1;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty * 4 + i) * (kBK + 1) + t];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = v_s[t * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  T* ob = o + ((int64_t)b * Hq + h) * S * D;
  float* lb = lse + ((int64_t)b * Hq + h) * S;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= S) continue;
    const float ls = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) ob[(int64_t)qi * D + tx + 16 * c] = from_f<T>(acc[i][c] / ls);
    if (tx == 0) lb[qi] = m[i] + logf(ls);
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, T* o, float* lse, int B, int Hq, int Hkv,
             int S, int Sk, int causal, int has_window, int window, int has_softcap,
             float softcap, float scale, cudaStream_t stream) {
  const size_t bytes = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      q, k, v, o, lse, Hq, Hkv, S, Sk, causal, has_window, window, has_softcap, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, float* lse, int B, int Hq, int Hkv, int S,
           int Sk, int D, int causal, int has_window, int window, int has_softcap,
           float softcap, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FLASH_CASE(DD) \
  case DD:             \
    return launch_d<T, DD>(q, k, v, o, lse, B, Hq, Hkv, S, Sk, causal, has_window, window, \
                           has_softcap, softcap, scale, s);
  switch (D) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}

}  // namespace

extern "C" {

int flash_attention_fwd_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                             int B, int Hq, int Hkv, int S, int Sk, int D, int causal,
                             int has_window, int window, int has_softcap, float softcap,
                             float scale, int device, void* stream) {
  return launch<__nv_bfloat16>((const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
                               (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, B, Hq, Hkv, S,
                               Sk, D, causal, has_window, window, has_softcap, softcap, scale,
                               device, stream);
}

int flash_attention_fwd_f32(const void* q, const void* k, const void* v, void* o, float* lse,
                            int B, int Hq, int Hkv, int S, int Sk, int D, int causal,
                            int has_window, int window, int has_softcap, float softcap,
                            float scale, int device, void* stream) {
  return launch<float>((const float*)q, (const float*)k, (const float*)v, (float*)o, lse, B, Hq,
                       Hkv, S, Sk, D, causal, has_window, window, has_softcap, softcap, scale,
                       device, stream);
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
