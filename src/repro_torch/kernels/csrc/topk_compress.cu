// Hand-written Hopper kernel for block-local top-k magnitude selection.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/topk_compress.py
// (block_topk / _topk_kernel): for every row of x (nb, block) float32, the
// k entries of largest |x|, as vals (nb, k) float32 and row-local indices
// idx (nb, k) int32, in the order the TPU kernel emits them: descending
// |x|, and among equal magnitudes the lower index first (the Pallas body's
// first-occurrence argmax, and jax.lax.top_k). NaN ranks above every
// number, as in the plain version's torch.sort.
//
// Translation. The TPU kernel runs one program per row and takes k rounds
// of (argmax over the row, mask the winner) on the VPU. Here one block of
// 256 threads takes one row, which is read from device memory once into
// registers: thread t holds elements t + 256 j, j < EPT (EPT = 1..32, a
// template parameter: rows of at most 8,192 elements). Each element is
// ranked by one 64-bit key, (|x| bits << 32) | (0xffffffff - index), so a
// plain unsigned max picks the larger magnitude and, among equal ones, the
// lower index. Each round is a block-wide max of the threads' keys: warp
// shuffles, then one step across the 8 warps in shared memory (double
// buffered, so a round needs one barrier). The owner of the winner writes
// it out, marks it used and rescans its own EPT registers; every other
// thread keeps its best key from the round before. So a round costs a
// reduction plus one thread's scan, not a pass over the row.
//
// What bounds it on an H100: bytes. A call must read nb * block * 4 bytes
// and write nb * k * 8; at the gossip step's embedding leaf (2 pods x
// 144,000 rows of 4,096, k = 40) that is 4.81 GB, 1.44 ms at 3.35 TB/s.
// The k rounds of reductions and barriers are latency the design hides
// only by keeping 8 rows in flight on each SM; a radix or threshold select
// (one pass over the row, then a compaction) is the later design.
//
// Plain C entry point (bound with ctypes by kernels/_build.py). It launches
// on the given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() right after its launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxEpt = 32;  // elements a thread holds: rows of <= 8,192

typedef unsigned long long Key;

__device__ __forceinline__ Key make_key(float x, int e) {
  return ((Key)(__float_as_uint(x) & 0x7fffffffu) << 32) | (Key)(0xffffffffu - (uint32_t)e);
}

// this thread's best key among its live elements; 0 when it has none
// (every real key is above 0: its low word is 0xffffffff - e > 0)
template <int EPT>
__device__ __forceinline__ Key local_best(const float (&v)[EPT], uint32_t live) {
  Key best = 0;
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    if (live >> j & 1u) {
      const Key key = make_key(v[j], (int)threadIdx.x + j * kThreads);
      best = key > best ? key : best;
    }
  }
  return best;
}

// grid (nb), kThreads threads; 1 <= k <= block <= EPT * kThreads
template <int EPT>
__global__ void __launch_bounds__(kThreads) block_topk_kernel(
    const float* __restrict__ x, float* __restrict__ vals, int* __restrict__ idx, int block,
    int k) {
  __shared__ Key part[2][kWarps];
  const size_t row = blockIdx.x;
  const float* xr = x + row * (size_t)block;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  float v[EPT];
  uint32_t live = 0;
#pragma unroll
  for (int j = 0; j < EPT; ++j) {
    const int e = t + j * kThreads;
    v[j] = e < block ? xr[e] : 0.f;
    if (e < block) live |= 1u << j;
  }
  Key mine = local_best<EPT>(v, live);

  for (int r = 0; r < k; ++r) {
    Key best = mine;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const Key other = __shfl_xor_sync(0xffffffffu, best, off);
      best = other > best ? other : best;
    }
    if (lane == 0) part[r & 1][warp] = best;
    __syncthreads();
    best = part[r & 1][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const Key other = part[r & 1][w];
      best = other > best ? other : best;
    }
    const int e = (int)(0xffffffffu - (uint32_t)(best & 0xffffffffu));
    if ((e & (kThreads - 1)) == t) {  // this thread holds the winner
      const int jw = e / kThreads;
      float val = 0.f;
#pragma unroll
      for (int j = 0; j < EPT; ++j) {
        if (j == jw) {
          val = v[j];
          live &= ~(1u << j);
        }
      }
      vals[row * (size_t)k + r] = val;
      idx[row * (size_t)k + r] = e;
      mine = local_best<EPT>(v, live);
    }
  }
}

template <int EPT>
int launch_ept(const float* x, float* vals, int* idx, int nb, int block, int k,
               cudaStream_t stream) {
  block_topk_kernel<EPT><<<nb, kThreads, 0, stream>>>(x, vals, idx, block, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// the largest row (block) the kernel takes
int block_topk_max_block() { return kMaxEpt * kThreads; }

int block_topk_f32(const void* x, void* vals, void* idx, int nb, int block, int k, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nb < 0 || block < 1 || k < 1 || k > block || block > kMaxEpt * kThreads)
    return (int)cudaErrorInvalidValue;
  if (nb == 0) return 0;
  const float* xf = (const float*)x;
  float* vf = (float*)vals;
  int* ix = (int*)idx;
  cudaStream_t s = (cudaStream_t)stream;
  const int ept = (block + kThreads - 1) / kThreads;
  if (ept <= 1) return launch_ept<1>(xf, vf, ix, nb, block, k, s);
  if (ept <= 2) return launch_ept<2>(xf, vf, ix, nb, block, k, s);
  if (ept <= 4) return launch_ept<4>(xf, vf, ix, nb, block, k, s);
  if (ept <= 8) return launch_ept<8>(xf, vf, ix, nb, block, k, s);
  if (ept <= 16) return launch_ept<16>(xf, vf, ix, nb, block, k, s);
  return launch_ept<32>(xf, vf, ix, nb, block, k, s);
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
