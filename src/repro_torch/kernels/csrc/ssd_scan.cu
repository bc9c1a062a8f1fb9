// Hand-written Hopper kernels for the Mamba2/SSD within-chunk computation,
// forward and backward.
//
// Replace the Pallas TPU kernels of src/repro/kernels/ssd_scan.py
// (ssd_chunk_fwd -> _ssd_chunk_kernel and ssd_chunk_bwd -> _ssd_bwd_kernel).
// Per chunk (b, c) of Q steps, with xdt (B, nc, Q, nh, hd), the inclusive
// log-decay cumsum cum (B, nc, Q, nh) and B, C (B, nc, Q, ds), all float32:
//   S[i, j]  = C_i . B_j                        (shared by every head)
//   L[i, j]  = exp(cum_i - cum_j) for i >= j, else 0   (per head)
//   y_i      = sum_j S[i, j] L[i, j] xdt_j      (B, nc, Q, nh, hd)
//   state    = sum_j B_j (x) exp(cum_{Q-1} - cum_j) xdt_j   (B, nc, nh, ds, hd)
// and, from the cotangents dy and dst, the gradient (dxdt, dcum, dB, dC),
// dcum with respect to the cumsum output, dB and dC summed over the heads.
//
// The decay overflows: at mamba2-1.3b's init cum falls by ~1.9 a step, so
// above the diagonal exp(cum_i - cum_j) is inf in float32. Every masked
// entry is SELECTED to 0 (its exp argument is selected to 0 first), never
// multiplied by a 0/1 mask, so no inf * 0 = NaN reaches an output.
//
// Translation. The TPU grid walks (batch, chunk, head block) in order and
// keeps a whole Q x Q score tile and one chunk's B and C in VMEM; at
// mamba2's Q = 256 and ds = 128 those alone are 384 KB, more than the
// 227 KB of shared memory a block may have. Here every kernel tiles the
// rows i and the columns j <= i by 32 (kT), as a causal attention kernel
// does; a block has 256 threads (8 warps); in a 32 x 32 tile warp w owns
// rows 4w..4w+3 and lane l column l. Ragged Q, nh, hd and ds are masked in
// the kernels (hd and ds are padded with zeros to the template widths HD in
// {32, 64} and DS in {32, 64, 128}).
//
//   forward     one launch, two kinds of block. A row block (i tile, group
//               of G = 512 / HD heads) computes each score tile once and
//               applies it to its G heads, y accumulated in registers
//               (4 rows x HD/32 columns x G heads = 64 floats a thread); the
//               tile of probabilities goes from lane to lane by shuffles.
//               A state block (32 rows of ds, G heads) sums its rows of the
//               chunk state over all Q steps.
//   backward    three launches, no atomics, so the gradient is the same bit
//               for bit from run to run:
//     rows      one block per (i tile, 16 heads): for j tiles <= i, the
//               score tile (written once to a scratch S for the cols
//               kernel), dM = dy_i . xdt_j per head, the head group's
//               partial of dscores = sum_h dM L (scratch), the row sums of
//               dLL = dM S L (complete: the block owns the rows; stored in
//               dcum) and, per (i tile, column, head), the column sums
//               (scratch, finished by the finish kernel in a fixed order).
//     cols      one block per (j tile, G heads): dxdt = sum_{i >= j} (S L)^T
//               dy + exp(cum_{Q-1} - cum_j) (B_j dst_h), its decay-to-end
//               term's dcum share ddte = xdt . that term (scratch), and the
//               head group's partial of dB's state term (scratch).
//     finish    one block per 32 rows: dC = dscores B and dB = dscores^T C +
//               the state-term partials, summing the head groups' partials
//               in order, and dcum = row sums - column sums - ddte, with the
//               last row also collecting sum_j ddte (cum_{Q-1} is in every
//               decay-to-end factor).
//
// What bounds it on an H100: operations. At the train shape (B=4, 8 chunks
// of 256, 64 heads of 64, ds 128) the forward needs ~17.7 GFLOP (the causal
// half of the intra-chunk product, the chunk states, the scores) against
// ~346 MB of inputs and outputs, the backward ~45 GFLOP. This first version
// uses float32 FMAs on CUDA cores (67 TFLOP/s peak): TF32 tensor cores
// keep ~3 decimal digits and could not meet the float32 bar of 2e-5 at
// Q = 256; a faster version needs 3xTF32 or FP32 emulation on tensor cores.
//
// Plain C entry points (bound with ctypes by kernels/_build.py). Each
// launches on the given stream, allocates nothing (the backward's scratch
// comes from the caller, sized by ssd_chunk_bwd_scratch_f32), does not
// synchronise, and returns the first launch error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kT = 32;                // rows of an i or j tile, columns of a score tile
constexpr int kThreads = 256;         // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRW = kT / kWarps;      // tile rows a warp owns
constexpr int kRowHeads = 16;         // heads of a backward rows block
constexpr unsigned kFull = 0xffffffffu;

// heads of a forward or backward cols block: G * HD = 512 keeps the
// accumulators at 4 rows x HD/32 columns x G heads = 64 floats a thread
template <int HD>
__host__ __device__ constexpr int heads_per_block() {
  return 512 / HD;
}

struct Shape {
  int BC, Q, nh, hd, ds;  // BC = batch x chunks
  __device__ __forceinline__ int64_t x(int bc, int q, int h) const {  // xdt, y, dy
    return (((int64_t)bc * Q + q) * nh + h) * hd;
  }
  __device__ __forceinline__ int64_t c(int bc, int q, int h) const {  // cum, dcum
    return ((int64_t)bc * Q + q) * nh + h;
  }
  __device__ __forceinline__ int64_t b(int bc, int q) const {  // B, C
    return ((int64_t)bc * Q + q) * ds;
  }
  __device__ __forceinline__ int64_t st(int bc, int h, int s) const {  // states, dst
    return (((int64_t)bc * nh + h) * ds + s) * hd;
  }
};

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// rows [q0, q0 + kT) of B or C into smem rows of stride DS + 1, zero padded
template <int DS>
__device__ __forceinline__ void stage_bc(float* dst, const float* src, const Shape& sh, int bc,
                                         int q0) {
  for (int e = threadIdx.x; e < kT * DS; e += kThreads) {
    const int r = e / DS, s = e % DS, q = q0 + r;
    dst[r * (DS + 1) + s] = (q < sh.Q && s < sh.ds) ? src[sh.b(bc, q) + s] : 0.f;
  }
}

// rows [q0, q0 + kT) of heads h0 .. h0 + G - 1 of xdt or dy into smem laid
// out [row][head][HD + 1], zero padded past Q, nh and hd
template <int HD, int G>
__device__ __forceinline__ void stage_heads(float* dst, const float* src, const Shape& sh, int bc,
                                            int q0, int h0) {
  for (int e = threadIdx.x; e < kT * G * HD; e += kThreads) {
    const int r = e / (G * HD), g = (e / HD) % G, d = e % HD;
    const int q = q0 + r, h = h0 + g;
    dst[(r * G + g) * (HD + 1) + d] =
        (q < sh.Q && h < sh.nh && d < sh.hd) ? src[sh.x(bc, q, h) + d] : 0.f;
  }
}

// cum of rows [q0, q0 + kT) for heads h0 .. h0 + G - 1 into smem [head][row]
template <int G>
__device__ __forceinline__ void stage_cum(float* dst, const float* cum, const Shape& sh, int bc,
                                          int q0, int h0) {
  for (int e = threadIdx.x; e < G * kT; e += kThreads) {
    const int g = e / kT, q = q0 + e % kT, h = h0 + g;
    dst[e] = (q < sh.Q && h < sh.nh) ? cum[sh.c(bc, q, h)] : 0.f;
  }
}

// the score tile S[i0 + 4w + k, j0 + lane] from staged C rows and B rows
template <int DS>
__device__ __forceinline__ void score_tile(float (&s)[kRW], const float* Ci, const float* Bj) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kRW; ++k) s[k] = 0.f;
#pragma unroll 8
  for (int q = 0; q < DS; ++q) {
    const float bv = Bj[lane * (DS + 1) + q];
#pragma unroll
    for (int k = 0; k < kRW; ++k) s[k] = fmaf(Ci[(warp * kRW + k) * (DS + 1) + q], bv, s[k]);
  }
}

// decay L[i, j] with the mask selected, never multiplied: exp of a selected
// argument, then the selected value
__device__ __forceinline__ float decay(bool ok, float cum_i, float cum_j) {
  const float e = expf(ok ? cum_i - cum_j : 0.f);
  return ok ? e : 0.f;
}

template <int HD, int DS>
__host__ __device__ constexpr size_t fwd_smem_floats() {
  constexpr int G = heads_per_block<HD>();
  constexpr size_t rows = 2 * (size_t)kT * (DS + 1) + (size_t)kT * G * (HD + 1) + 2 * (size_t)G * kT;
  constexpr size_t states = (size_t)kT * (kT + 1) + (size_t)kT * G * (HD + 1) + (size_t)G * kT;
  return rows > states ? rows : states;
}

// forward: grid (nIT * nHG row blocks + nST * nHG state blocks, BC)
template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 2) ssd_fwd_kernel(
    const float* __restrict__ xdt, const float* __restrict__ cum, const float* __restrict__ Bm,
    const float* __restrict__ Cm, float* __restrict__ y, float* __restrict__ st, Shape sh) {
  constexpr int G = heads_per_block<HD>();
  constexpr int NM = HD / 32;  // hd columns a lane owns: lane + 32 m
  constexpr int XS = HD + 1;
  extern __shared__ float smem[];
  const int Q = sh.Q;
  const int nIT = cdiv(Q, kT), nHG = cdiv(sh.nh, G);
  const int bc = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int bx = blockIdx.x;

  float acc[G][kRW][NM];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int k = 0; k < kRW; ++k)
#pragma unroll
      for (int m = 0; m < NM; ++m) acc[g][k][m] = 0.f;

  if (bx < nIT * nHG) {
    // ---- row block: y for rows i0 .. i0 + 31 of heads h0 .. h0 + G - 1
    const int it = nIT - 1 - bx / nHG;  // the longest row blocks first
    const int h0 = (bx % nHG) * G;
    const int ng = min(G, sh.nh - h0);
    const int i0 = it * kT;
    float* Ci = smem;                  // kT x (DS + 1)
    float* Bj = Ci + kT * (DS + 1);    // kT x (DS + 1)
    float* Xs = Bj + kT * (DS + 1);    // kT x G x XS
    float* ci = Xs + kT * G * XS;      // G x kT
    float* cj = ci + G * kT;           // G x kT
    stage_bc<DS>(Ci, Cm, sh, bc, i0);
    stage_cum<G>(ci, cum, sh, bc, i0, h0);
    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kT;
      __syncthreads();  // the previous j tile is no longer read
      stage_bc<DS>(Bj, Bm, sh, bc, j0);
      stage_heads<HD, G>(Xs, xdt, sh, bc, j0, h0);
      stage_cum<G>(cj, cum, sh, bc, j0, h0);
      __syncthreads();
      float s[kRW];
      score_tile<DS>(s, Ci, Bj);
      const int j = j0 + lane;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= ng) break;  // uniform over the block
        float p[kRW];
#pragma unroll
        for (int k = 0; k < kRW; ++k) {
          const int r = warp * kRW + k, i = i0 + r;
          const bool ok = j <= i && i < Q && j < Q;
          p[k] = s[k] * decay(ok, ci[g * kT + r], cj[g * kT + lane]);
        }
#pragma unroll 4
        for (int c = 0; c < kT; ++c) {
          float xv[NM];
#pragma unroll
          for (int m = 0; m < NM; ++m) xv[m] = Xs[(c * G + g) * XS + lane + 32 * m];
#pragma unroll
          for (int k = 0; k < kRW; ++k) {
            const float pk = __shfl_sync(kFull, p[k], c);
#pragma unroll
            for (int m = 0; m < NM; ++m) acc[g][k][m] = fmaf(pk, xv[m], acc[g][k][m]);
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= ng) break;
#pragma unroll
      for (int k = 0; k < kRW; ++k) {
        const int i = i0 + warp * kRW + k;
        if (i >= Q) continue;
#pragma unroll
        for (int m = 0; m < NM; ++m) {
          const int d = lane + 32 * m;
          if (d < sh.hd) y[sh.x(bc, i, h0 + g) + d] = acc[g][k][m];
        }
      }
    }
    return;
  }

  // ---- state block: state rows s0 .. s0 + 31 of heads h0 .. h0 + G - 1
  bx -= nIT * nHG;
  const int s0 = (bx / nHG) * kT;
  const int h0 = (bx % nHG) * G;
  const int ng = min(G, sh.nh - h0);
  float* Bs = smem;                  // kT (j) x (kT + 1) (s)
  float* Xs = Bs + kT * (kT + 1);    // kT x G x XS
  float* w = Xs + kT * G * XS;       // G x kT: exp(cum_{Q-1} - cum_j)
  for (int jt = 0; jt < nIT; ++jt) {
    const int j0 = jt * kT;
    __syncthreads();
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
      const int r = e / kT, q = e % kT, j = j0 + r, s = s0 + q;
      Bs[r * (kT + 1) + q] = (j < Q && s < sh.ds) ? Bm[sh.b(bc, j) + s] : 0.f;
    }
    stage_heads<HD, G>(Xs, xdt, sh, bc, j0, h0);
    for (int e = threadIdx.x; e < G * kT; e += kThreads) {
      const int g = e / kT, j = j0 + e % kT, h = h0 + g;
      w[e] = (j < Q && h < sh.nh) ? expf(cum[sh.c(bc, Q - 1, h)] - cum[sh.c(bc, j, h)]) : 0.f;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < kT; ++c) {
      float bv[kRW];
#pragma unroll
      for (int k = 0; k < kRW; ++k) bv[k] = Bs[c * (kT + 1) + warp * kRW + k];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (g >= ng) break;
        const float wv = w[g * kT + c];
        float xv[NM];
#pragma unroll
        for (int m = 0; m < NM; ++m) xv[m] = Xs[(c * G + g) * XS + lane + 32 * m];
#pragma unroll
        for (int k = 0; k < kRW; ++k) {
          const float bw = bv[k] * wv;
#pragma unroll
          for (int m = 0; m < NM; ++m) acc[g][k][m] = fmaf(bw, xv[m], acc[g][k][m]);
        }
      }
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= ng) break;
#pragma unroll
    for (int k = 0; k < kRW; ++k) {
      const int s = s0 + warp * kRW + k;
      if (s >= sh.ds) continue;
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int d = lane + 32 * m;
        if (d < sh.hd) st[sh.st(bc, h0 + g, s) + d] = acc[g][k][m];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// scratch of one backward call, in floats, carved in this order
struct Scratch {
  float *S, *dscp, *colpart, *ddte, *dBpart;
};

template <int HD>
__host__ __device__ int cols_groups(int nh) {
  return cdiv(nh, heads_per_block<HD>());
}

template <int HD>
__host__ int64_t scratch_floats(const Shape& sh) {
  const int64_t Q = sh.Q, BC = sh.BC, nIT = cdiv(sh.Q, kT);
  return BC * Q * Q                                  // S
         + BC * cdiv(sh.nh, kRowHeads) * Q * Q       // dscores partials
         + BC * nIT * Q * sh.nh                      // column-sum partials
         + BC * Q * sh.nh                            // ddte
         + BC * (int64_t)cols_groups<HD>(sh.nh) * Q * sh.ds;  // dB state-term partials
}

template <int HD>
__host__ Scratch carve(float* base, const Shape& sh) {
  const int64_t Q = sh.Q, BC = sh.BC, nIT = cdiv(sh.Q, kT);
  Scratch sc;
  sc.S = base;
  sc.dscp = sc.S + BC * Q * Q;
  sc.colpart = sc.dscp + BC * cdiv(sh.nh, kRowHeads) * Q * Q;
  sc.ddte = sc.colpart + BC * nIT * Q * sh.nh;
  sc.dBpart = sc.ddte + BC * Q * sh.nh;
  return sc;
}

template <int HD, int DS>
__host__ __device__ constexpr size_t rows_smem_floats() {
  return 2 * (size_t)kT * (DS + 1) + 2 * (size_t)kT * (HD + 1) + 2 * (size_t)kT +
         (size_t)kWarps * kT + (size_t)kRowHeads * kT;
}

// rows: grid (nIT * nRG, BC)
template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_rows_kernel(
    const float* __restrict__ xdt, const float* __restrict__ cum, const float* __restrict__ Bm,
    const float* __restrict__ Cm, const float* __restrict__ dy, Scratch sc,
    float* __restrict__ dcum, Shape sh) {
  constexpr int XS = HD + 1;
  extern __shared__ float smem[];
  const int Q = sh.Q, nh = sh.nh;
  const int nIT = cdiv(Q, kT), nRG = cdiv(nh, kRowHeads);
  const int bc = blockIdx.y;
  const int it = nIT - 1 - (int)blockIdx.x / nRG;
  const int rg = blockIdx.x % nRG;
  const int h0 = rg * kRowHeads, ng = min(kRowHeads, nh - h0);
  const int i0 = it * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Ci = smem;                   // kT x (DS + 1)
  float* Bj = Ci + kT * (DS + 1);     // kT x (DS + 1)
  float* DYs = Bj + kT * (DS + 1);    // kT x XS (one head)
  float* Xs = DYs + kT * XS;          // kT x XS (one head)
  float* ci = Xs + kT * XS;           // kT
  float* cj = ci + kT;                // kT
  float* red = cj + kT;               // kWarps x kT
  float* rowacc = red + kWarps * kT;  // kRowHeads x kT

  stage_bc<DS>(Ci, Cm, sh, bc, i0);
  for (int e = threadIdx.x; e < kRowHeads * kT; e += kThreads) rowacc[e] = 0.f;
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kT, j = j0 + lane;
    __syncthreads();
    stage_bc<DS>(Bj, Bm, sh, bc, j0);
    __syncthreads();
    float s[kRW], dsc[kRW];
    score_tile<DS>(s, Ci, Bj);
#pragma unroll
    for (int k = 0; k < kRW; ++k) {
      dsc[k] = 0.f;
      const int i = i0 + warp * kRW + k;
      if (rg == 0 && i < Q && j < Q) sc.S[((int64_t)bc * Q + i) * Q + j] = s[k];
    }
    for (int g = 0; g < ng; ++g) {
      const int h = h0 + g;
      __syncthreads();  // the previous head's tiles and column sums are read
      stage_heads<HD, 1>(DYs, dy, sh, bc, i0, h);
      stage_heads<HD, 1>(Xs, xdt, sh, bc, j0, h);
      stage_cum<1>(ci, cum, sh, bc, i0, h);
      stage_cum<1>(cj, cum, sh, bc, j0, h);
      __syncthreads();
      float dm[kRW];
#pragma unroll
      for (int k = 0; k < kRW; ++k) dm[k] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        const float xv = Xs[lane * XS + d];
#pragma unroll
        for (int k = 0; k < kRW; ++k) dm[k] = fmaf(DYs[(warp * kRW + k) * XS + d], xv, dm[k]);
      }
      float colv = 0.f;
#pragma unroll
      for (int k = 0; k < kRW; ++k) {
        const int r = warp * kRW + k, i = i0 + r;
        const bool ok = j <= i && i < Q && j < Q;
        const float L = decay(ok, ci[r], cj[lane]);
        dsc[k] = fmaf(dm[k], L, dsc[k]);
        const float dll = ok ? dm[k] * s[k] * L : 0.f;
        colv += dll;
        const float rsum = warp_sum(dll);
        if (lane == 0) rowacc[g * kT + r] += rsum;
      }
      red[warp * kT + lane] = colv;
      __syncthreads();
      if (warp == 0 && j < Q) {
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) t += red[w * kT + lane];
        sc.colpart[(((int64_t)bc * nIT + it) * Q + j) * nh + h] = t;
      }
    }
#pragma unroll
    for (int k = 0; k < kRW; ++k) {
      const int i = i0 + warp * kRW + k;
      if (i < Q && j < Q) sc.dscp[(((int64_t)bc * nRG + rg) * Q + i) * Q + j] = dsc[k];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kT * ng; e += kThreads) {
    const int r = e / ng, g = e % ng, i = i0 + r;
    if (i < Q) dcum[sh.c(bc, i, h0 + g)] = rowacc[g * kT + r];
  }
}

template <int HD, int DS>
__host__ __device__ constexpr size_t cols_smem_floats() {
  constexpr int G = heads_per_block<HD>();
  constexpr size_t a = (size_t)kT * G * (HD + 1) + (size_t)kT * (kT + 1) + (size_t)G * kT;
  constexpr size_t b = (size_t)DS * (HD + 1) + (size_t)kT * (HD + 1);
  return (size_t)kT * (DS + 1) + (size_t)G * kT + (a > b ? a : b);
}

// cols: grid (nIT * nHG, BC)
template <int HD, int DS>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_cols_kernel(
    const float* __restrict__ xdt, const float* __restrict__ cum, const float* __restrict__ Bm,
    const float* __restrict__ dy, const float* __restrict__ dst, Scratch sc,
    float* __restrict__ dxdt, Shape sh) {
  constexpr int G = heads_per_block<HD>();
  constexpr int NM = HD / 32;
  constexpr int NS = DS / 32;  // ds columns a lane owns in dB: lane + 32 n
  constexpr int XS = HD + 1;
  extern __shared__ float smem[];
  const int Q = sh.Q, nh = sh.nh;
  const int nIT = cdiv(Q, kT), nHG = cdiv(nh, G);
  const int bc = blockIdx.y;
  const int jt = blockIdx.x / nHG;  // the longest (j tile 0) first
  const int hg = blockIdx.x % nHG;
  const int h0 = hg * G, ng = min(G, nh - h0);
  const int j0 = jt * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* Bj = smem;                 // kT x (DS + 1)
  float* cj = Bj + kT * (DS + 1);   // G x kT
  float* ph = cj + G * kT;          // phase A and phase B share the rest
  float* DYs = ph;                  // A: kT x G x XS
  float* Ss = DYs + kT * G * XS;    // A: kT x (kT + 1)
  float* ci = Ss + kT * (kT + 1);   // A: G x kT
  float* DST = ph;                  // B: DS x XS
  float* Xh = DST + DS * XS;        // B: kT x XS

  stage_bc<DS>(Bj, Bm, sh, bc, j0);
  stage_cum<G>(cj, cum, sh, bc, j0, h0);

  // phase A: dxdt_j = sum_{i >= j} (S L)[i, j] dy_i
  float acc[G][kRW][NM];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int k = 0; k < kRW; ++k)
#pragma unroll
      for (int m = 0; m < NM; ++m) acc[g][k][m] = 0.f;
  for (int it = jt; it < nIT; ++it) {
    const int i0 = it * kT, i = i0 + lane;
    __syncthreads();
    stage_heads<HD, G>(DYs, dy, sh, bc, i0, h0);
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
      const int r = e / kT, c = e % kT;
      const bool in = i0 + r < Q && j0 + c < Q;
      Ss[r * (kT + 1) + c] = in ? sc.S[((int64_t)bc * Q + i0 + r) * Q + j0 + c] : 0.f;
    }
    stage_cum<G>(ci, cum, sh, bc, i0, h0);
    __syncthreads();
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (g >= ng) break;
      float pt[kRW];  // (S L)[i0 + lane, j0 + 4 warp + k]
#pragma unroll
      for (int k = 0; k < kRW; ++k) {
        const int c = warp * kRW + k, jj = j0 + c;
        const bool ok = jj <= i && i < Q && jj < Q;
        pt[k] = Ss[lane * (kT + 1) + c] * decay(ok, ci[g * kT + lane], cj[g * kT + c]);
      }
#pragma unroll 4
      for (int r = 0; r < kT; ++r) {
        float dv[NM];
#pragma unroll
        for (int m = 0; m < NM; ++m) dv[m] = DYs[(r * G + g) * XS + lane + 32 * m];
#pragma unroll
        for (int k = 0; k < kRW; ++k) {
          const float p = __shfl_sync(kFull, pt[k], r);
#pragma unroll
          for (int m = 0; m < NM; ++m) acc[g][k][m] = fmaf(p, dv[m], acc[g][k][m]);
        }
      }
    }
  }

  // phase B, head by head: the state cotangent's terms
  float dB[kRW][NS];
#pragma unroll
  for (int k = 0; k < kRW; ++k)
#pragma unroll
    for (int n = 0; n < NS; ++n) dB[k][n] = 0.f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (g >= ng) break;
    const int h = h0 + g;
    __syncthreads();  // phase A's (or the previous head's) tiles are read
    for (int e = threadIdx.x; e < DS * HD; e += kThreads) {
      const int s = e / HD, d = e % HD;
      DST[s * XS + d] = (s < sh.ds && d < sh.hd) ? dst[sh.st(bc, h, s) + d] : 0.f;
    }
    stage_heads<HD, 1>(Xh, xdt, sh, bc, j0, h);
    __syncthreads();
    const float clast = cum[sh.c(bc, Q - 1, h)];
    float w[kRW], t[kRW][NM];
#pragma unroll
    for (int k = 0; k < kRW; ++k) {
      w[k] = j0 + warp * kRW + k < Q ? expf(clast - cj[g * kT + warp * kRW + k]) : 0.f;
#pragma unroll
      for (int m = 0; m < NM; ++m) t[k][m] = 0.f;
    }
    // t = B_j dst_h, then times the decay to the chunk's end
#pragma unroll 4
    for (int q = 0; q < DS; ++q) {
      float dv[NM];
#pragma unroll
      for (int m = 0; m < NM; ++m) dv[m] = DST[q * XS + lane + 32 * m];
#pragma unroll
      for (int k = 0; k < kRW; ++k) {
        const float bv = Bj[(warp * kRW + k) * (DS + 1) + q];
#pragma unroll
        for (int m = 0; m < NM; ++m) t[k][m] = fmaf(bv, dv[m], t[k][m]);
      }
    }
#pragma unroll
    for (int k = 0; k < kRW; ++k) {
      const int c = warp * kRW + k, jj = j0 + c;
      float part = 0.f;
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const int d = lane + 32 * m;
        t[k][m] *= w[k];
        if (jj < Q && d < sh.hd) dxdt[sh.x(bc, jj, h) + d] = acc[g][k][m] + t[k][m];
        part = fmaf(Xh[c * XS + d], t[k][m], part);
      }
      const float dd = warp_sum(part);  // ddte = xdt_j . t
      if (lane == 0 && jj < Q) sc.ddte[sh.c(bc, jj, h)] = dd;
    }
    // dB's state term: sum_h exp(cum_{Q-1} - cum_j) xdt_j dst_h^T
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float dv[NS];
#pragma unroll
      for (int n = 0; n < NS; ++n) dv[n] = DST[(lane + 32 * n) * XS + d];
#pragma unroll
      for (int k = 0; k < kRW; ++k) {
        const float xw = Xh[(warp * kRW + k) * XS + d] * w[k];
#pragma unroll
        for (int n = 0; n < NS; ++n) dB[k][n] = fmaf(xw, dv[n], dB[k][n]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRW; ++k) {
    const int jj = j0 + warp * kRW + k;
    if (jj >= Q) continue;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int s = lane + 32 * n;
      if (s < sh.ds) sc.dBpart[(((int64_t)bc * nHG + hg) * Q + jj) * sh.ds + s] = dB[k][n];
    }
  }
}

template <int DS>
__host__ __device__ constexpr size_t finish_smem_floats() {
  return (size_t)kT * (kT + 1) + (size_t)kT * (DS + 1);
}

// finish: grid (nIT, BC)
template <int HD, int DS>
__global__ void __launch_bounds__(kThreads) ssd_bwd_finish_kernel(
    const float* __restrict__ Bm, const float* __restrict__ Cm, Scratch sc,
    float* __restrict__ dcum, float* __restrict__ dBo, float* __restrict__ dCo, Shape sh) {
  constexpr int NS = DS / 32;
  extern __shared__ float smem[];
  const int Q = sh.Q, nh = sh.nh;
  const int nIT = cdiv(Q, kT), nRG = cdiv(nh, kRowHeads), nHG = cols_groups<HD>(nh);
  const int bc = blockIdx.y;
  const int t = blockIdx.x, r0 = t * kT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* D = smem;                // kT x (kT + 1): summed dscores tile
  float* Ms = D + kT * (kT + 1);  // kT x (DS + 1): B or C rows
  // the dscores tile (rows i0.., columns j0..), head-group partials summed in order
  auto stage_d = [&](int i0, int j0) {
    for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
      const int r = e / kT, c = e % kT, i = i0 + r, j = j0 + c;
      float v = 0.f;
      if (i < Q && j < Q)
        for (int g = 0; g < nRG; ++g) v += sc.dscp[(((int64_t)bc * nRG + g) * Q + i) * Q + j];
      D[r * (kT + 1) + c] = v;
    }
  };
  float acc[kRW][NS];

  // dC rows r0..: sum_{j <= i} dscores[i, j] B_j
#pragma unroll
  for (int k = 0; k < kRW; ++k)
#pragma unroll
    for (int n = 0; n < NS; ++n) acc[k][n] = 0.f;
  for (int jt = 0; jt <= t; ++jt) {
    __syncthreads();
    stage_d(r0, jt * kT);
    stage_bc<DS>(Ms, Bm, sh, bc, jt * kT);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kT; ++c) {
#pragma unroll
      for (int k = 0; k < kRW; ++k) {
        const float dv = D[(warp * kRW + k) * (kT + 1) + c];
#pragma unroll
        for (int n = 0; n < NS; ++n)
          acc[k][n] = fmaf(dv, Ms[c * (DS + 1) + lane + 32 * n], acc[k][n]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRW; ++k) {
    const int i = r0 + warp * kRW + k;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int s = lane + 32 * n;
      if (i < Q && s < sh.ds) dCo[sh.b(bc, i) + s] = acc[k][n];
    }
  }

  // dB rows r0..: sum_{i >= j} dscores[i, j] C_i + the state-term partials
#pragma unroll
  for (int k = 0; k < kRW; ++k)
#pragma unroll
    for (int n = 0; n < NS; ++n) acc[k][n] = 0.f;
  for (int it = t; it < nIT; ++it) {
    __syncthreads();
    stage_d(it * kT, r0);
    stage_bc<DS>(Ms, Cm, sh, bc, it * kT);
    __syncthreads();
#pragma unroll 4
    for (int r = 0; r < kT; ++r) {
#pragma unroll
      for (int k = 0; k < kRW; ++k) {
        const float dv = D[r * (kT + 1) + warp * kRW + k];
#pragma unroll
        for (int n = 0; n < NS; ++n)
          acc[k][n] = fmaf(dv, Ms[r * (DS + 1) + lane + 32 * n], acc[k][n]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRW; ++k) {
    const int j = r0 + warp * kRW + k;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int s = lane + 32 * n;
      if (j >= Q || s >= sh.ds) continue;
      float v = acc[k][n];
      for (int g = 0; g < nHG; ++g) v += sc.dBpart[(((int64_t)bc * nHG + g) * Q + j) * sh.ds + s];
      dBo[sh.b(bc, j) + s] = v;
    }
  }

  // dcum rows r0..: row sums (already in dcum) - column sums - ddte, and the
  // last row also + sum_j ddte
  for (int e = threadIdx.x; e < kT * nh; e += kThreads) {
    const int i = r0 + e / nh, h = e % nh;
    if (i >= Q) continue;
    float v = dcum[sh.c(bc, i, h)];
    for (int it = t; it < nIT; ++it) v -= sc.colpart[(((int64_t)bc * nIT + it) * Q + i) * nh + h];
    v -= sc.ddte[sh.c(bc, i, h)];
    if (i == Q - 1) {
      float tot = 0.f;
      for (int j = 0; j < Q; ++j) tot += sc.ddte[sh.c(bc, j, h)];
      v += tot;
    }
    dcum[sh.c(bc, i, h)] = v;
  }
}

template <int HD, int DS>
int fwd_launch(const float* xdt, const float* cum, const float* B, const float* C, float* y,
               float* st, const Shape& sh, cudaStream_t stream) {
  constexpr int G = heads_per_block<HD>();
  const size_t bytes = fwd_smem_floats<HD, DS>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd_kernel<HD, DS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const int nHG = cdiv(sh.nh, G);
  const dim3 grid(cdiv(sh.Q, kT) * nHG + cdiv(sh.ds, kT) * nHG, sh.BC);
  ssd_fwd_kernel<HD, DS><<<grid, kThreads, bytes, stream>>>(xdt, cum, B, C, y, st, sh);
  return (int)cudaGetLastError();
}

template <int HD, int DS>
int bwd_launch(const float* xdt, const float* cum, const float* B, const float* C,
               const float* dy, const float* dst, float* scratch, float* dxdt, float* dcum,
               float* dB, float* dC, const Shape& sh, cudaStream_t stream) {
  const Scratch sc = carve<HD>(scratch, sh);
  const int nIT = cdiv(sh.Q, kT);
  const size_t rows_b = rows_smem_floats<HD, DS>() * sizeof(float);
  const size_t cols_b = cols_smem_floats<HD, DS>() * sizeof(float);
  const size_t fin_b = finish_smem_floats<DS>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(ssd_bwd_rows_kernel<HD, DS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rows_b);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_bwd_cols_kernel<HD, DS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)cols_b);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_bwd_finish_kernel<HD, DS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)fin_b);
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_rows_kernel<HD, DS><<<dim3(nIT * cdiv(sh.nh, kRowHeads), sh.BC), kThreads, rows_b,
                                stream>>>(xdt, cum, B, C, dy, sc, dcum, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_cols_kernel<HD, DS><<<dim3(nIT * cols_groups<HD>(sh.nh), sh.BC), kThreads, cols_b,
                                stream>>>(xdt, cum, B, dy, dst, sc, dxdt, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_finish_kernel<HD, DS><<<dim3(nIT, sh.BC), kThreads, fin_b, stream>>>(B, C, sc, dcum,
                                                                             dB, dC, sh);
  return (int)cudaGetLastError();
}

bool valid(const Shape& sh) {
  return sh.BC > 0 && sh.BC <= 65535 && sh.Q > 0 && sh.nh > 0 && sh.hd > 0 && sh.hd <= 64 &&
         sh.ds > 0 && sh.ds <= 128;
}

// HD in {32, 64} by hd, DS in {32, 64, 128} by ds
#define SSD_DISPATCH(CALL)                                              \
  if (sh.hd <= 32) {                                                    \
    if (sh.ds <= 32) return CALL(32, 32);                               \
    if (sh.ds <= 64) return CALL(32, 64);                               \
    return CALL(32, 128);                                               \
  }                                                                     \
  if (sh.ds <= 32) return CALL(64, 32);                                 \
  if (sh.ds <= 64) return CALL(64, 64);                                 \
  return CALL(64, 128);

}  // namespace

extern "C" {

// y (B, nc, Q, nh, hd) and st (B, nc, nh, ds, hd) of float32 inputs, all
// contiguous; BC = B * nc
int ssd_chunk_fwd_f32(const float* xdt, const float* cum, const float* B, const float* C,
                      float* y, float* st, int BC, int Q, int nh, int hd, int ds, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape sh{BC, Q, nh, hd, ds};
  if (!valid(sh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define FWD_CALL(HD, DS) fwd_launch<HD, DS>(xdt, cum, B, C, y, st, sh, s)
  SSD_DISPATCH(FWD_CALL)
#undef FWD_CALL
}

// floats of scratch ssd_chunk_bwd_f32 needs at this shape (-1 if invalid)
int64_t ssd_chunk_bwd_scratch_f32(int BC, int Q, int nh, int hd, int ds) {
  const Shape sh{BC, Q, nh, hd, ds};
  if (!valid(sh)) return -1;
  return hd <= 32 ? scratch_floats<32>(sh) : scratch_floats<64>(sh);
}

// (dxdt, dcum, dB, dC) from the inputs and the cotangents dy (as y) and dst
// (as st); three launches on one stream (rows, cols, finish)
int ssd_chunk_bwd_f32(const float* xdt, const float* cum, const float* B, const float* C,
                      const float* dy, const float* dst, float* scratch, float* dxdt,
                      float* dcum, float* dB, float* dC, int BC, int Q, int nh, int hd, int ds,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape sh{BC, Q, nh, hd, ds};
  if (!valid(sh)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define BWD_CALL(HD, DS) \
  bwd_launch<HD, DS>(xdt, cum, B, C, dy, dst, scratch, dxdt, dcum, dB, dC, sh, s)
  SSD_DISPATCH(BWD_CALL)
#undef BWD_CALL
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
