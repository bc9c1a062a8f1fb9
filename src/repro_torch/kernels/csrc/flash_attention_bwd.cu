// Hand-written Hopper kernels for the float32 flash-attention backward pass.
//
// Replace the Pallas TPU kernels of src/repro/kernels/flash_attention.py
// (flash_attention_bwd -> _attn_bwd_dq_kernel and _attn_bwd_dkv_kernel):
// the blocked gradient of GQA attention with causal masking, a sliding
// window and a softcap, recomputing every probability tile from the saved
// log-sum-exp so that no S x S matrix is ever stored. Layout is heads-major
// as in the forward (flash_attention.cu): q, o, do (B, Hq, S, D); k, v
// (B, Hkv, Sk, D); lse (B, Hq, S) float32; query head h reads kv head
// h / (Hq / Hkv). Per (query i, key j), with scale = 1/sqrt(D):
//   x = softcap(scale q_i . k_j), mask(i, j) = i < S, j < Sk [, i >= j] [, i - j < window]
//   p = mask ? exp(x - lse_i) : 0,   dp = do_i . v_j,   delta_i = do_i . o_i
//   ds = p (dp - delta_i) [* (1 - (x / softcap)^2)]
//   dq_i = scale * sum_j ds k_j,  dk_j = scale * sum_i ds q_i,
//   dv_j = sum_i p do_i,  dk and dv summed over the GQA group's q heads.
//
// Translation. The TPU grid runs in order and its dk/dv kernel works per q
// head, leaving the GQA group-sum to the wrapper in (B, Hq, Sk, D) float32
// partials. Here:
//   dq kernel   one block of 256 threads per (b, q head, 64-row q tile):
//               computes delta for its rows (written out for the dkv
//               kernel), loops over 32-row K/V tiles in padded shared
//               memory within the causal/window band, accumulates dq in
//               float32 registers (4 rows x D/16 columns a thread).
//   dkv kernel  one block per (b, KV head, 32-row kv tile): loops over the
//               group's q heads and over the 64-row q tiles of the band,
//               accumulates dk and dv in float32 registers (2 rows x D/16
//               columns each a thread) and writes them once. The group
//               sum happens in registers: no partials, no atomics, so a
//               step is bit-for-bit the same from run to run. The
//               1/sqrt(D) is applied to the dot products and to dk rather
//               than to the staged q.
// The dkv kernel reads the delta the dq kernel wrote, so the two launch in
// that order on one stream. Ragged S and Sk are masked in the kernels
// (rows past S and keys past Sk are never read or written), not padded.
//
// What bounds it on an H100: operations. At the train shape (B=2,
// minitron-8b's 32/8 heads, S=2048, D=128, causal) the gradient needs five
// products of the causal S x S x D band (s, dp, dq, dk, dv), ~172 GFLOP
// against ~84 MB of inputs and outputs. Like the forward, these kernels use
// float32 FMAs on CUDA cores (67 TFLOP/s peak), recompute s and dp in both
// kernels (seven products), and serve float32 inputs only: a tensor-core
// product on float32 is TF32 (about 3 decimal digits), short of the 2e-4
// float32 gradient bar. bfloat16 inputs go to the tensor-core kernels of
// flash_attention_bwd_sm90.cu; the wrapper picks by dtype.
//
// Plain C entry points (bound with ctypes by kernels/_build.py). Each
// launches on the given stream, allocates nothing, does not synchronise,
// and returns the first launch error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // q rows per dq block and per q tile of the dkv loop
constexpr int kBK = 32;        // kv rows per tile
constexpr int kThreads = 256;  // 16 x 16 (ty, tx)

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

struct Mask {
  int S, Sk, causal, has_window, window, has_softcap;
  float softcap;
  // softcapped score and whether (qi, ki) attends
  __device__ __forceinline__ bool apply(int qi, int ki, float& x) const {
    if (has_softcap) x = softcap * tanhf(x / softcap);
    bool ok = qi < S && ki < Sk;
    if (causal) ok = ok && qi >= ki;
    if (has_window) ok = ok && qi - ki < window;
    return ok;
  }
  // ds from p, dp and the row's delta (x is the softcapped score)
  __device__ __forceinline__ float ds(float p, float dp, float delta, float x) const {
    float g = p * (dp - delta);
    if (has_softcap) {
      const float t = x / softcap;
      g *= 1.f - t * t;
    }
    return g;
  }
};

template <int D>
constexpr size_t dq_smem_floats() {
  return 2 * (size_t)kBQ * (D + 1) + 2 * (size_t)kBK * (D + 1) + (size_t)kBQ * (kBK + 1) +
         2 * (size_t)kBQ;
}

// row stride of a q / do tile of the dkv kernel: one 4-byte bank past D
template <typename T, int D>
__host__ __device__ constexpr int dkv_q_stride() {
  return D + 1;
}

template <typename T, int D>
__host__ __device__ constexpr size_t dkv_smem_bytes() {
  return (2 * (size_t)kBK * (D + 1) + 2 * (size_t)kBK * (kBQ + 1) + 2 * (size_t)kBQ) *
             sizeof(float) +
         2 * (size_t)kBQ * dkv_q_stride<T, D>() * sizeof(T);
}

// blocks an SM can hold by shared memory (227 KB): the register budget asked for
template <typename T, int D>
__host__ __device__ constexpr int dkv_min_blocks() {
  return 2 * dkv_smem_bytes<T, D>() <= 227 * 1024 ? 2 : 1;
}

// grid (ceil(S / kBQ), Hq, B), kThreads threads
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ o, const float* __restrict__ lse, const T* __restrict__ dout,
    float* __restrict__ delta, T* __restrict__ dq, int Hq, int Hkv, Mask mk, float scale) {
  constexpr int NC = D / 16;  // dq columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                  // kBQ x (D + 1), pre-scaled
  float* do_s = q_s + kBQ * (D + 1);  // kBQ x (D + 1)
  float* k_s = do_s + kBQ * (D + 1);  // kBK x (D + 1)
  float* v_s = k_s + kBK * (D + 1);   // kBK x (D + 1)
  float* ds_s = v_s + kBK * (D + 1);  // kBQ x (kBK + 1)
  float* lse_s = ds_s + kBQ * (kBK + 1);
  float* dl_s = lse_s + kBQ;

  const int S = mk.S, Sk = mk.Sk;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t qoff = ((int64_t)b * Hq + h) * S;
  const T* qb = q + qoff * D;
  const T* ob = o + qoff * D;
  const T* dob = dout + qoff * D;
  const T* kb = k + ((int64_t)b * Hkv + hk) * Sk * D;
  const T* vb = v + ((int64_t)b * Hkv + hk) * Sk * D;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int qi = q0 + r;
    const bool in = qi < S;
    q_s[r * (D + 1) + d] = in ? to_f(qb[(int64_t)qi * D + d]) * scale : 0.f;
    do_s[r * (D + 1) + d] = in ? to_f(dob[(int64_t)qi * D + d]) : 0.f;
  }
  __syncthreads();
  // delta = rowsum(do * o): warp w takes rows w, w + 8, ...
  {
    const int w = tid >> 5, lane = tid & 31;
    for (int r = w; r < kBQ; r += kThreads / 32) {
      const int qi = q0 + r;
      float acc = 0.f;
      if (qi < S)
        for (int d = lane; d < D; d += 32) acc += do_s[r * (D + 1) + d] * to_f(ob[(int64_t)qi * D + d]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        dl_s[r] = acc;
        lse_s[r] = qi < S ? lse[qoff + qi] : 0.f;
        if (qi < S) delta[qoff + qi] = acc;
      }
    }
  }

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  const int n_kt = (Sk + kBK - 1) / kBK;
  int hi = n_kt;
  if (mk.causal) hi = min(n_kt, (q0 + kBQ - 1) / kBK + 1);
  int lo = 0;
  if (mk.has_window) lo = max(0, q0 - mk.window + 1) / kBK;

  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile is no longer read (and the rows are staged)
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int ki = k0 + r;
      float kv = 0.f, vv = 0.f;
      if (ki < Sk) {
        kv = to_f(kb[(int64_t)ki * D + d]);
        vv = to_f(vb[(int64_t)ki * D + d]);
      }
      k_s[r * (D + 1) + d] = kv;
      v_s[r * (D + 1) + d] = vv;
    }
    __syncthreads();

    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = dp[i][0] = dp[i][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float k0v = k_s[tx * (D + 1) + d];
      const float k1v = k_s[(tx + 16) * (D + 1) + d];
      const float v0v = v_s[tx * (D + 1) + d];
      const float v1v = v_s[(tx + 16) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = q_s[(ty * 4 + i) * (D + 1) + d];
        const float dv = do_s[(ty * 4 + i) * (D + 1) + d];
        s[i][0] = fmaf(qv, k0v, s[i][0]);
        s[i][1] = fmaf(qv, k1v, s[i][1]);
        dp[i][0] = fmaf(dv, v0v, dp[i][0]);
        dp[i][1] = fmaf(dv, v1v, dp[i][1]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = s[i][j];
        const bool ok = mk.apply(q0 + r, k0 + tx + 16 * j, x);
        const float p = ok ? expf(x - lse_s[r]) : 0.f;
        ds_s[r * (kBK + 1) + tx + 16 * j] = ok ? mk.ds(p, dp[i][j], dl_s[r], x) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = ds_s[(ty * 4 + i) * (kBK + 1) + t];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = k_s[t * (D + 1) + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

  T* dqb = dq + qoff * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) dqb[(int64_t)qi * D + tx + 16 * c] = from_f<T>(acc[i][c] * scale);
  }
}

// grid (ceil(Sk / kBK), Hkv, B), kThreads threads
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, dkv_min_blocks<T, D>()) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ lse, const T* __restrict__ dout, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Hq, int Hkv, Mask mk, float scale) {
  constexpr int NC = D / 16;  // dk / dv columns per thread
  constexpr int QS = dkv_q_stride<T, D>();
  extern __shared__ float smem[];
  float* k_s = smem;                   // kBK x (D + 1)
  float* v_s = k_s + kBK * (D + 1);    // kBK x (D + 1)
  float* p_s = v_s + kBK * (D + 1);    // kBK x (kBQ + 1)
  float* ds_s = p_s + kBK * (kBQ + 1);
  float* lse_s = ds_s + kBK * (kBQ + 1);
  float* dl_s = lse_s + kBQ;
  T* q_s = reinterpret_cast<T*>(dl_s + kBQ);  // kBQ x QS, unscaled
  T* do_s = q_s + kBQ * QS;                   // kBQ x QS

  const int S = mk.S, Sk = mk.Sk;
  const int k0 = blockIdx.x * kBK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int group = Hq / Hkv;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int64_t koff = ((int64_t)b * Hkv + hk) * Sk * D;

  for (int i = tid; i < kBK * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int ki = k0 + r;
    const bool in = ki < Sk;
    k_s[r * (D + 1) + d] = in ? to_f(k[koff + (int64_t)ki * D + d]) : 0.f;
    v_s[r * (D + 1) + d] = in ? to_f(v[koff + (int64_t)ki * D + d]) : 0.f;
  }

  float adk[2][NC], adv[2][NC];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) adk[r][c] = adv[r][c] = 0.f;

  // only q tiles that intersect the causal/window band see this kv tile
  const int n_qt = (S + kBQ - 1) / kBQ;
  const int lo = mk.causal ? k0 / kBQ : 0;
  int hi = n_qt;
  if (mk.has_window) hi = min(n_qt, (k0 + kBK - 1 + mk.window) / kBQ + 1);

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const int64_t qoff = ((int64_t)b * Hq + h) * S;
    for (int qt = lo; qt < hi; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous q tile is no longer read (and k, v are staged)
      for (int i = tid; i < kBQ * D; i += kThreads) {
        const int r = i / D, d = i % D;
        const int qi = q0 + r;
        const bool in = qi < S;
        q_s[r * QS + d] = in ? q[(qoff + qi) * D + d] : from_f<T>(0.f);
        do_s[r * QS + d] = in ? dout[(qoff + qi) * D + d] : from_f<T>(0.f);
      }
      if (tid < kBQ) {
        const int qi = q0 + tid;
        lse_s[tid] = qi < S ? lse[qoff + qi] : 0.f;
        dl_s[tid] = qi < S ? delta[qoff + qi] : 0.f;
      }
      __syncthreads();

      float s[2][4], dp[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int m = 0; m < 4; ++m) s[r][m] = dp[r][m] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kv0 = k_s[(ty * 2) * (D + 1) + d];
        const float kv1 = k_s[(ty * 2 + 1) * (D + 1) + d];
        const float vv0 = v_s[(ty * 2) * (D + 1) + d];
        const float vv1 = v_s[(ty * 2 + 1) * (D + 1) + d];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float qv = to_f(q_s[(tx + 16 * m) * QS + d]);
          const float dov = to_f(do_s[(tx + 16 * m) * QS + d]);
          s[0][m] = fmaf(qv, kv0, s[0][m]);
          s[1][m] = fmaf(qv, kv1, s[1][m]);
          dp[0][m] = fmaf(dov, vv0, dp[0][m]);
          dp[1][m] = fmaf(dov, vv1, dp[1][m]);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kr = ty * 2 + r;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int qr = tx + 16 * m;
          float x = s[r][m] * scale;
          const bool ok = mk.apply(q0 + qr, k0 + kr, x);
          const float p = ok ? expf(x - lse_s[qr]) : 0.f;
          p_s[kr * (kBQ + 1) + qr] = p;
          ds_s[kr * (kBQ + 1) + qr] = ok ? mk.ds(p, dp[r][m], dl_s[qr], x) : 0.f;
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int t = 0; t < kBQ; ++t) {
        const float p0 = p_s[(ty * 2) * (kBQ + 1) + t];
        const float p1 = p_s[(ty * 2 + 1) * (kBQ + 1) + t];
        const float g0 = ds_s[(ty * 2) * (kBQ + 1) + t];
        const float g1 = ds_s[(ty * 2 + 1) * (kBQ + 1) + t];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float dov = to_f(do_s[t * QS + tx + 16 * c]);
          const float qv = to_f(q_s[t * QS + tx + 16 * c]);
          adv[0][c] = fmaf(p0, dov, adv[0][c]);
          adv[1][c] = fmaf(p1, dov, adv[1][c]);
          adk[0][c] = fmaf(g0, qv, adk[0][c]);
          adk[1][c] = fmaf(g1, qv, adk[1][c]);
        }
      }
    }
  }

  // q_s is unscaled: dk = scale * sum_i ds q_i
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ki = k0 + ty * 2 + r;
    if (ki >= Sk) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int64_t at = koff + (int64_t)ki * D + tx + 16 * c;
      dk[at] = from_f<T>(adk[r][c] * scale);
      dv[at] = from_f<T>(adv[r][c]);
    }
  }
}

template <typename T, int D>
int launch_d(const T* q, const T* k, const T* v, const T* o, const float* lse, const T* dout,
             float* delta, T* dq, T* dk, T* dv, int B, int Hq, int Hkv, Mask mk, float scale,
             cudaStream_t stream) {
  const size_t dq_bytes = dq_smem_floats<D>() * sizeof(float);
  const size_t dkv_bytes = dkv_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)dq_bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((mk.S + kBQ - 1) / kBQ, Hq, B);
  flash_bwd_dq_kernel<T, D><<<grid_q, kThreads, dq_bytes, stream>>>(
      q, k, v, o, lse, dout, delta, dq, Hq, Hkv, mk, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((mk.Sk + kBK - 1) / kBK, Hkv, B);
  flash_bwd_dkv_kernel<T, D><<<grid_k, kThreads, dkv_bytes, stream>>>(
      q, k, v, lse, dout, delta, dk, dv, Hq, Hkv, mk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const float* lse,
           const void* dout, float* delta, void* dq, void* dk, void* dv, int B, int Hq,
           int Hkv, int S, int Sk, int D, int causal, int has_window, int window,
           int has_softcap, float softcap, float scale, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || Sk <= 0) return (int)cudaErrorInvalidValue;
  const Mask mk{S, Sk, causal, has_window, window, has_softcap, softcap};
  cudaStream_t s = (cudaStream_t)stream;
#define BWD_CASE(DD)                                                                         \
  case DD:                                                                                   \
    return launch_d<T, DD>((const T*)q, (const T*)k, (const T*)v, (const T*)o, lse,         \
                           (const T*)dout, delta, (T*)dq, (T*)dk, (T*)dv, B, Hq, Hkv, mk,   \
                           scale, s);
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

}  // namespace

extern "C" {

int flash_attention_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                            const float* lse, const void* dout, float* delta, void* dq,
                            void* dk, void* dv, int B, int Hq, int Hkv, int S, int Sk, int D,
                            int causal, int has_window, int window, int has_softcap,
                            float softcap, float scale, int device, void* stream) {
  return launch<float>(q, k, v, o, lse, dout, delta, dq, dk, dv, B, Hq, Hkv, S, Sk, D, causal,
                       has_window, window, has_softcap, softcap, scale, device, stream);
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
