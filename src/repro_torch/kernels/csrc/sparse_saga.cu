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
//   sparse_axpy moves 2*N*D*8 B (read psi, write out), about 7.6 MB: memory
//     bound in principle (~2.3 us at 3.35 TB/s), launch-latency bound in
//     practice. Pass 1 is a coalesced elementwise rho*psi over an (D-blocks,
//     N) grid; pass 2 scatters the k entries of each node, one warp per
//     node walking k in chunks of 32.
//   sparse_dot moves about N*k*20 B (~15 KB): launch-latency bound. One warp
//     per node gathers psi[n, idx] from global memory and reduces with
//     shuffles.
//
// Arithmetic policy. Every sum and product is taken in the input type.
// sparse_axpy uses the explicitly rounded intrinsics (__dmul_rn/__dadd_rn,
// __fmul_rn/__fadd_rn) so nvcc cannot contract rho*psi + coef*val into an
// FMA: the float64 result is then bit-equal to the plain version
// ((rho*psi) then sequential += coef*val in k order), duplicates included.
// Pass 2 takes no atomics. Within a chunk of 32 entries, __match_any_sync
// groups the lanes that hold the same column; the group's lowest lane (its
// first occurrence in k order) adds the group's products in lane order.
// Chunks follow one another in k order, ordered by __syncwarp. Distinct
// columns touch distinct memory, so this equals one serial loop over k per
// node, bit for bit, and is the same from run to run.
// sparse_dot sums in another order than the plain version (1e-12 in f64).
//
// Index contract: idx lies in [0, D); padded entries are idx = 0, val = 0.
// An index outside [0, D) is skipped (never read or written) so a bad index
// cannot corrupt memory; the result for such an entry is unspecified.
//
// Plain C entry points (bound with ctypes by kernels/_build.py). Each
// launches on the given stream, allocates nothing, does not synchronise,
// and returns cudaGetLastError() right after its launches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ T mul_rn(T a, T b);
template <> __device__ __forceinline__ double mul_rn<double>(double a, double b) { return __dmul_rn(a, b); }
template <> __device__ __forceinline__ float mul_rn<float>(float a, float b) { return __fmul_rn(a, b); }

template <typename T> __device__ __forceinline__ T add_rn(T a, T b);
template <> __device__ __forceinline__ double add_rn<double>(double a, double b) { return __dadd_rn(a, b); }
template <> __device__ __forceinline__ float add_rn<float>(float a, float b) { return __fadd_rn(a, b); }

constexpr int kScaleThreads = 256;
constexpr int kScatterWarps = 4;  // nodes per pass-2 block
constexpr int kDotWarps = 4;  // nodes per sparse_dot block

// Pass 1: out[n, j] = rho[n] * psi[n, j]; grid (D-blocks, N).
template <typename T>
__global__ void axpy_scale_kernel(const T* __restrict__ psi, const T* __restrict__ rho,
                                  T* __restrict__ out, int D) {
  const int64_t row = (int64_t)blockIdx.y * D;
  const T r = rho[blockIdx.y];
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < D; j += gridDim.x * blockDim.x) {
    out[row + j] = mul_rn(r, psi[row + j]);
  }
}

// Pass 2: out[n, idx[n, i]] += coef[n] * val[n, i] for i in k order; one warp per node.
template <typename T>
__global__ void axpy_scatter_kernel(const int* __restrict__ idx, const T* __restrict__ val,
                                    const T* __restrict__ coef, T* __restrict__ out,
                                    int N, int D, int K) {
  __shared__ T s_prod[kScatterWarps][32];
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * kScatterWarps + w;
  if (n >= N) return;  // warp-uniform
  const int64_t row = (int64_t)n * D;
  const int* idx_n = idx + (int64_t)n * K;
  const T* val_n = val + (int64_t)n * K;
  const T c = coef[n];
  for (int base = 0; base < K; base += 32) {
    const int j = base + lane;
    const int u = j < K ? idx_n[j] : -1;  // -1: past the end, never in [0, D)
    s_prod[w][lane] = j < K ? mul_rn(c, val_n[j]) : T(0);
    const unsigned group = __match_any_sync(0xffffffffu, u);
    __syncwarp();
    if ((unsigned)u < (unsigned)D && __ffs(group) - 1 == lane) {
      T acc = out[row + u];
      for (unsigned m = group; m; m &= m - 1) acc = add_rn(acc, s_prod[w][__ffs(m) - 1]);
      out[row + u] = acc;
    }
    // the next chunk may revisit a column written here, and reuses s_prod
    __syncwarp();
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
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks_d = min((D + kScaleThreads - 1) / kScaleThreads, 4096);
  axpy_scale_kernel<T><<<dim3(blocks_d, N), kScaleThreads, 0, s>>>(psi, rho, out, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (K > 0) {
    const int blocks_n = (N + kScatterWarps - 1) / kScatterWarps;
    axpy_scatter_kernel<T><<<blocks_n, 32 * kScatterWarps, 0, s>>>(idx, val, coef, out, N, D, K);
  }
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
