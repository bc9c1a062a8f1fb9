// Hand-written Hopper kernel for paged single-query decode attention.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/decode_attention.py
// (decode_attention / _decode_kernel): one query token per sequence attends
// over K/V pages of a shared pool (n_blocks, block_size, Hkv, D), addressed
// through an int32 block table (B, n_pages) and per-sequence lengths (B,).
//
//   out[b, h, :] = softmax_t(q[b, h] . k[b, t] / sqrt(D)) @ v[b, t]
//   over the positions t < lengths[b] (and t >= lengths[b] - window when a
//   window is given: the query sits at position lengths[b] - 1), with an
//   optional softcap cap * tanh(s / cap) on the scores. Length 0 gives a
//   zero row (the max(l, 1e-30) guard of the TPU kernel).
//
// Translation. The TPU kernel runs a grid (B, Hkv, n_pages) whose page axis
// is sequential and carries the online softmax (m, l, acc) in VMEM scratch,
// with the table and lengths in scalar prefetch. Here one block handles one
// (sequence, kv head) pair and loops over that sequence's positions itself,
// 32 at a time, reading table[b] and lengths[b] on its own; the carry lives
// in shared memory. The kv head's whole query group (Hq / Hkv heads; 4 for
// minitron-8b) shares every K/V tile, as in the TPU kernel, so K/V are read
// once per kv head. Positions at or past the length are never read; table
// entries outside [0, n_blocks) are not read either (zeros instead), so a
// bad table cannot fault. D needs no lane padding (the TPU's _pad_last).
//
// What bounds it on an H100: bytes. A call reads the live K/V once,
// sum_b lengths[b] * Hkv * D * 2 values (2 bytes each in bf16), and does
// about 4 * Hq * D flops per position: far below the card's 295 flops per
// byte, so HBM bandwidth is the limit. This first version is simple and
// right: each tile's K/V arrive as independent 16-byte loads issued
// together (a first version with one scalar load after another was bound
// by their latency), float32 accumulation, one block per (sequence, kv
// head), so at the serving batch (8 sequences x 8 kv heads = 64 blocks) it
// fills half of the 132 SMs. Splitting each sequence's positions over
// several blocks with a second reduction pass (flash-decoding) and TMA
// loads into a ring of tiles are later work. D is a template parameter
// (16, 32, 64, 128 or 256).
//
// Plain C entry points (bound with ctypes by kernels/_build.py). Each
// launches on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError() right after its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's finite mask value
constexpr int kThreads = 128;
constexpr int kChunk = 32;  // positions per shared-memory tile (one warp's width)

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// grid (Hkv, B), kThreads threads; dynamic shared memory laid out below.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k_pool, const T* __restrict__ v_pool,
    const int* __restrict__ table, const int* __restrict__ lengths, T* __restrict__ out,
    int Hq, int Hkv, int n_blocks, int block_size, int n_pages, int has_window, int window,
    int has_softcap, float softcap, float scale) {
  constexpr int VEC = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int VPR = D / VEC;            // 16-byte vectors per K/V row
  constexpr int NV = kChunk * VPR;        // vectors per tile (K or V)
  constexpr int ITERS = (NV + kThreads - 1) / kThreads;
  extern __shared__ float smem[];
  const int group = Hq / Hkv;
  float* q_s = smem;                      // group x D, pre-scaled
  float* acc_s = q_s + group * D;         // group x D
  float* k_s = acc_s + group * D;         // kChunk x (D + 1): padded rows
  float* v_s = k_s + kChunk * (D + 1);    // kChunk x D
  float* p_s = v_s + kChunk * D;          // group x kChunk
  float* m_s = p_s + group * kChunk;      // group
  float* l_s = m_s + group;               // group
  float* a_s = l_s + group;               // group: this tile's rescale factor

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t q_row = ((int64_t)b * Hq + (int64_t)h * group) * D;

  const int length = lengths[b];
  const int n_valid = min(max(length, 0), n_pages * block_size);
  const int start = has_window ? max(0, length - window) : 0;
  const int* table_b = table + (int64_t)b * n_pages;

  for (int i = tid; i < group * D; i += kThreads) {
    q_s[i] = to_f(q[q_row + i]) * scale;
    acc_s[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }

  for (int t0 = (start / kChunk) * kChunk; t0 < n_valid; t0 += kChunk) {
    // issue every 16-byte load of the tile into registers first (they are
    // independent, so their latencies overlap each other and the other
    // warps' work on the previous tile), then stage them as float32
    uint4 kr[ITERS], vr[ITERS];
#pragma unroll
    for (int j = 0; j < ITERS; ++j) {
      const int v = tid + j * kThreads;
      kr[j] = vr[j] = make_uint4(0u, 0u, 0u, 0u);
      const int pos = t0 + v / VPR;
      if (v < NV && pos < n_valid) {
        const int page = table_b[pos / block_size];
        if ((unsigned)page < (unsigned)n_blocks) {
          const int64_t off =
              (((int64_t)page * block_size + pos % block_size) * Hkv + h) * D + (v % VPR) * VEC;
          kr[j] = *reinterpret_cast<const uint4*>(k_pool + off);
          vr[j] = *reinterpret_cast<const uint4*>(v_pool + off);
        }
      }
    }
    __syncthreads();  // the previous tile is no longer read
#pragma unroll
    for (int j = 0; j < ITERS; ++j) {
      const int v = tid + j * kThreads;
      if (v < NV) {
        const int t = v / VPR, c = (v % VPR) * VEC;
        const T* ke = reinterpret_cast<const T*>(&kr[j]);
        const T* ve = reinterpret_cast<const T*>(&vr[j]);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          k_s[t * (D + 1) + c + e] = to_f(ke[e]);
          v_s[t * D + c + e] = to_f(ve[e]);
        }
      }
    }
    __syncthreads();

    // scores: one thread per (query head of the group, position)
    for (int i = tid; i < group * kChunk; i += kThreads) {
      const int g = i / kChunk, t = i % kChunk;
      const int pos = t0 + t;
      const float* qg = q_s + g * D;
      const float* kt = k_s + t * (D + 1);
      float s = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) s = fmaf(qg[d], kt[d], s);
      if (has_softcap) s = softcap * tanhf(s / softcap);
      bool ok = pos < n_valid;
      if (has_window) ok = ok && pos >= length - window;
      p_s[i] = ok ? s : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per query head, one lane per position
    for (int g = warp; g < group; g += kThreads / 32) {
      const float s = p_s[g * kChunk + lane];
      float mx = s;
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_cur = fmaxf(m_prev, mx);
      const float p = expf(s - m_cur);
      p_s[g * kChunk + lane] = p;
      float sum = p;
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        a_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_cur;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p @ v: one thread per (query head, column)
    for (int i = tid; i < group * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* pg = p_s + g * kChunk;
      float a = acc_s[i] * a_s[g];
#pragma unroll 8
      for (int t = 0; t < kChunk; ++t) a = fmaf(pg[t], v_s[t * D + d], a);
      acc_s[i] = a;
    }
  }
  __syncthreads();
  for (int i = tid; i < group * D; i += kThreads) {
    const float l = fmaxf(l_s[i / D], 1e-30f);
    out[q_row + i] = from_f<T>(acc_s[i] / l);
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* k_pool, const T* v_pool, const int* table, const int* lengths,
             T* out, int B, int Hq, int Hkv, int n_blocks, int block_size, int n_pages,
             int has_window, int window, int has_softcap, float softcap, float scale,
             cudaStream_t stream) {
  const int group = Hq / Hkv;
  const size_t floats = (size_t)2 * group * D + (size_t)kChunk * (D + 1) + (size_t)kChunk * D +
                        (size_t)group * kChunk + 3 * (size_t)group;
  const size_t bytes = floats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  decode_attention_kernel<T, D><<<dim3(Hkv, B), kThreads, bytes, stream>>>(
      q, k_pool, v_pool, table, lengths, out, Hq, Hkv, n_blocks, block_size, n_pages,
      has_window, window, has_softcap, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k_pool, const T* v_pool, const int* table, const int* lengths,
           T* out, int B, int Hq, int Hkv, int D, int n_blocks, int block_size, int n_pages,
           int has_window, int window, int has_softcap, float softcap, float scale,
           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Hkv <= 0 || Hq % Hkv != 0 || block_size <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define DECODE_CASE(DD)                                                                       \
  case DD:                                                                                    \
    return launch_d<T, DD>(q, k_pool, v_pool, table, lengths, out, B, Hq, Hkv, n_blocks,     \
                           block_size, n_pages, has_window, window, has_softcap, softcap,    \
                           scale, s);
  switch (D) {
    DECODE_CASE(16)
    DECODE_CASE(32)
    DECODE_CASE(64)
    DECODE_CASE(128)
    DECODE_CASE(256)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DECODE_CASE
}

}  // namespace

extern "C" {

int decode_attention_bf16(const void* q, const void* k_pool, const void* v_pool,
                          const int* table, const int* lengths, void* out, int B, int Hq,
                          int Hkv, int D, int n_blocks, int block_size, int n_pages,
                          int has_window, int window, int has_softcap, float softcap,
                          float scale, int device, void* stream) {
  return launch<__nv_bfloat16>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool, (const __nv_bfloat16*)v_pool,
      table, lengths, (__nv_bfloat16*)out, B, Hq, Hkv, D, n_blocks, block_size, n_pages,
      has_window, window, has_softcap, softcap, scale, device, stream);
}

int decode_attention_f32(const void* q, const void* k_pool, const void* v_pool,
                         const int* table, const int* lengths, void* out, int B, int Hq,
                         int Hkv, int D, int n_blocks, int block_size, int n_pages,
                         int has_window, int window, int has_softcap, float softcap,
                         float scale, int device, void* stream) {
  return launch<float>((const float*)q, (const float*)k_pool, (const float*)v_pool, table,
                       lengths, (float*)out, B, Hq, Hkv, D, n_blocks, block_size, n_pages,
                       has_window, window, has_softcap, softcap, scale, device, stream);
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
