// Hand-written Hopper kernels for the DSBA per-node sparse row update.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/sparse_saga.py:
//   sparse_dot   (_dot_kernel,  launcher sparse_dot)   out[n] = sum_k val[n,k] * psi[n, idx[n,k]]
//   sparse_axpy  (_axpy_kernel, launcher sparse_axpy)  out[n] = rho[n]*psi[n] + coef[n]*scatter(val[n] at idx[n])
//
// The Pallas bodies express the gather and the scatter as one-hot matrix
// products because the TPU has no fast VMEM gather. Hopper gathers and
// scatters natively, so these kernels read and write psi[n, idx] directly.
//
// What bounds them on an H100 at the main path's shapes (N = 10 nodes,
// D = 47,236, k = 74, float64):
//   sparse_axpy moves 2*N*D*8 B (read psi once, write out once), about 7.6 MB:
//     memory bound (~2.3 us at 3.35 TB/s), and called 4-5 times in a
//     host-bound solver step, so it is one launch (a scale pass and a
//     scatter pass would read and write the output twice and cost two
//     launches of host time): grid (column
//     chunks of 16 KB, N); a CTA reads its chunk of psi[n] (coalesced),
//     scales it into shared memory, stages node n's (idx, val) entries
//     (1,024 at a time) beside it, applies those whose column falls in its
//     chunk, and writes the chunk once (coalesced). No two CTAs share a
//     column, so there are no atomics. Each CTA scans all k indices of its
//     node: 74 at the step shape, 450 at news20 (D = 1,355,191), 7,400 in
//     init_state's phibar scatter (the one call a solve where the scan, not
//     the bytes, sets the time).
//   sparse_dot moves about N*k*20 B (~15 KB): launch-latency bound. One warp
//     per node gathers psi[n, idx] from global memory and reduces with
//     shuffles.
//
// Arithmetic policy. Every sum and product is taken in the input type.
// sparse_axpy uses the explicitly rounded intrinsics (__dmul_rn/__dadd_rn,
// __fmul_rn/__fadd_rn) so nvcc cannot contract rho*psi + coef*val into an
// FMA: the float64 result is then bit-equal to the plain version
// ((rho*psi) then sequential += coef*val in k order), duplicates included.
// Warp w of a CTA owns the columns u with u % 8 == w; it walks the staged
// entries in k order, 32 at a time, and its lanes that hold an owned column
// apply their entries one after another in lane order (__syncwarp between),
// so every column sees its entries in k order, as one serial loop over k
// would, bit for bit, from run to run.
// sparse_dot sums in another order than the plain version (1e-12 in f64).
//
// Index contract: idx lies in [0, D); padded entries are idx = 0, val = 0.
// An index outside [0, D) is skipped (never read or written) so a bad index
// cannot corrupt memory; the result for such an entry is unspecified.
//
// Plain C entry points (bound with ctypes by kernels/_build.py). Each
// launches on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError() right after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ T mul_rn(T a, T b);
template <> __device__ __forceinline__ double mul_rn<double>(double a, double b) { return __dmul_rn(a, b); }
template <> __device__ __forceinline__ float mul_rn<float>(float a, float b) { return __fmul_rn(a, b); }

template <typename T> __device__ __forceinline__ T add_rn(T a, T b);
template <> __device__ __forceinline__ double add_rn<double>(double a, double b) { return __dadd_rn(a, b); }
template <> __device__ __forceinline__ float add_rn<float>(float a, float b) { return __fadd_rn(a, b); }

constexpr int kAxpyChunkBytes = 16384;  // bytes of a row a sparse_axpy CTA owns
constexpr int kAxpyThreads = 256;
constexpr int kAxpyWarps = kAxpyThreads / 32;
constexpr int kAxpyEntries = 1024;  // (idx, val) entries staged at a time
constexpr int kDotWarps = 4;  // nodes per sparse_dot block

// out[n, c0:c0+len] = rho[n] * psi[n, c0:c0+len], then += coef[n] * val[n, i]
// at idx[n, i] for the entries in the chunk, in k order; grid (chunks, N).
template <typename T>
__global__ void __launch_bounds__(kAxpyThreads) sparse_axpy_kernel(
    const T* __restrict__ psi, const int* __restrict__ idx, const T* __restrict__ val,
    const T* __restrict__ coef, const T* __restrict__ rho, T* __restrict__ out, int D, int K) {
  constexpr int kChunk = kAxpyChunkBytes / (int)sizeof(T);
  constexpr int kPer = kChunk / kAxpyThreads;
  static_assert(kPer * kAxpyThreads == kChunk, "chunk");
  __shared__ T s_out[kChunk];
  __shared__ int s_idx[kAxpyEntries];
  __shared__ T s_val[kAxpyEntries];
  const int n = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t c0 = (int64_t)blockIdx.x * kChunk;
  const int len = (int)min((int64_t)kChunk, (int64_t)D - c0);
  const T* psi_c = psi + (int64_t)n * D + c0;
  const int* idx_n = idx + (int64_t)n * K;
  const T* val_n = val + (int64_t)n * K;

  T x[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * kAxpyThreads;
    x[j] = i < len ? psi_c[i] : T(0);
  }
  const int staged = K < kAxpyEntries ? K : kAxpyEntries;
  for (int e = tid; e < staged; e += kAxpyThreads) {
    s_idx[e] = idx_n[e];
    s_val[e] = val_n[e];
  }
  const T r = rho[n];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * kAxpyThreads;
    if (i < len) s_out[i] = mul_rn(r, x[j]);
  }
  const T c = coef[n];
  __syncthreads();
  for (int base = 0; base < K; base += kAxpyEntries) {
    const int count = min(K - base, kAxpyEntries);
    if (base > 0) {
      __syncthreads();  // every warp is done with the previous entries
      for (int e = tid; e < count; e += kAxpyThreads) {
        s_idx[e] = idx_n[base + e];
        s_val[e] = val_n[base + e];
      }
      __syncthreads();
    }
    for (int j0 = 0; j0 < count; j0 += 32) {
      const int j = j0 + lane;
      const int64_t rel = (j < count ? (int64_t)s_idx[j] : (int64_t)-1) - c0;
      const bool owned = rel >= 0 && rel < len && ((rel + c0) & (kAxpyWarps - 1)) == warp;
      for (unsigned mask = __ballot_sync(0xffffffffu, owned); mask; mask &= mask - 1) {
        if (lane == __ffs(mask) - 1) s_out[rel] = add_rn(s_out[rel], mul_rn(c, s_val[j]));
        __syncwarp();  // the next lane may add to the same column
      }
    }
  }
  __syncthreads();
  T* out_c = out + (int64_t)n * D + c0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * kAxpyThreads;
    if (i < len) out_c[i] = s_out[i];
  }
}

// out[n] = sum_k val[n,k] * psi[n, idx[n,k]]; one warp per node.
template <typename T>
__global__ void sparse_dot_kernel(const T* __restrict__ psi, const int* __restrict__ idx,
                                  const T* __restrict__ val, T* __restrict__ out,
                                  int N, int D, int K) {
  const int node = blockIdx.x * kDotWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (node >= N) return;  // warp-uniform
  const int64_t row = (int64_t)node * D;
  const int* idx_n = idx + (int64_t)node * K;
  const T* val_n = val + (int64_t)node * K;
  T acc = T(0);
  for (int j = lane; j < K; j += 32) {
    const int u = idx_n[j];
    if ((unsigned)u < (unsigned)D) acc += val_n[j] * psi[row + u];
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) out[node] = acc;
}

// Makes `device` current; a call on the current device (every call of a
// one-card run) reads the current device and sets nothing.
inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

template <typename T>
int launch_axpy(const T* psi, const int* idx, const T* val, const T* coef, const T* rho,
                T* out, int N, int D, int K, int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int kChunk = kAxpyChunkBytes / (int)sizeof(T);
  const int chunks = (int)(((int64_t)D + kChunk - 1) / kChunk);
  sparse_axpy_kernel<T><<<dim3(chunks, N), kAxpyThreads, 0, (cudaStream_t)stream>>>(
      psi, idx, val, coef, rho, out, D, K);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dot(const T* psi, const int* idx, const T* val, T* out, int N, int D, int K,
               int device, void* stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (N + kDotWarps - 1) / kDotWarps;
  sparse_dot_kernel<T><<<blocks, 32 * kDotWarps, 0, (cudaStream_t)stream>>>(
      psi, idx, val, out, N, D, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int sparse_axpy_f64(const double* psi, const int* idx, const double* val, const double* coef,
                    const double* rho, double* out, int N, int D, int K, int device,
                    void* stream) {
  return launch_axpy<double>(psi, idx, val, coef, rho, out, N, D, K, device, stream);
}

int sparse_axpy_f32(const float* psi, const int* idx, const float* val, const float* coef,
                    const float* rho, float* out, int N, int D, int K, int device,
                    void* stream) {
  return launch_axpy<float>(psi, idx, val, coef, rho, out, N, D, K, device, stream);
}

int sparse_dot_f64(const double* psi, const int* idx, const double* val, double* out, int N,
                   int D, int K, int device, void* stream) {
  return launch_dot<double>(psi, idx, val, out, N, D, K, device, stream);
}

int sparse_dot_f32(const float* psi, const int* idx, const float* val, float* out, int N,
                   int D, int K, int device, void* stream) {
  return launch_dot<float>(psi, idx, val, out, N, D, K, device, stream);
}

const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
