// Hand-written Hopper kernels for the Mamba2/SSD within-chunk computation,
// forward and backward, on tensor cores at float32 accuracy.
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
// Arithmetic: float32 products on tensor cores by a split ("3xTF32"). Each
// float32 operand a is split as hi = rna_tf32(a) and lo = a - hi, and a
// product is taken as lo.hi + hi.lo + hi.hi, the two small terms first. A
// single TF32 product keeps ~3 decimal digits and misses the 2e-5 bar at
// Q = 256 by ~1000x. The three products of a k-step (k = 8) go into a fresh
// register tile that is added to the accumulator on the CUDA cores: the
// tensor cores' float32 accumulation truncates, and accumulated there over
// dB's K = nh hd = 4096 the bias put dB outside its 2e-4 bar (lo.lo did not
// help); added in float32 the error is at or below the CUDA-core float32
// kernels'. Operands computed in registers (the decayed scores S o L and the
// decay-weighted B and x) are split where they are computed.
//
// Instruction: every product is mma.sync.m16n8k8.tf32 (warp-level, 16 x 8
// outputs, k 8), its fragments loaded from padded shared memory. wgmma
// takes .tf32 operands only K-major (its transpose bits are for 16-bit
// types), but half of these products contract over a dimension that lies
// N- or M-major in memory (P.X reads X (Q x hd) over its rows, the state
// (B o dte)^T X and dxdt's (S o L)^T dy contract over rows), and one operand
// of most products is computed elementwise in registers first. mma.sync
// reads a fragment from any orientation: a tile read K-major is padded to
// a row stride of 4 mod 32 floats, a tile read N- or M-major to 8 mod 32,
// which makes every fragment load free of bank conflicts.
//
// Tiles and copies: a CTA is 4 warps; a warp owns 16 rows of a 64-row tile
// and every column of it. Tiles come into shared memory through a
// two-stage ring of cp.async copies (16 bytes a copy when hd and ds are
// multiples of 4 and the tensors 16-byte aligned, else 4; zero-filled past
// Q, nh, hd and ds, so ragged shapes are masked here and not padded by the
// caller): the next stage loads while this one multiplies. The scores use
// ds in chunks of 32. At Q = 256 a CTA's dynamic shared memory stays under
// ~113 KB, so two CTAs share an SM. The host-side plan (kernels/ssd_scan.py
// ``ssd_plan``) picks the head group of each kind of CTA so that the grid
// fills the card (two CTAs an SM); every launcher here checks the plan's
// shared memory against its own.
//
//   forward     one launch, two kinds of CTA, the longest first:
//     rows      (chunk, 64-row i tile, G heads): the score tiles S_ij for
//               j <= i once, into shared memory (64 x Q), then for each head
//               y_i = sum_j (S o L_h)_ij X_jh, P = S o L formed and split in
//               registers as the A fragment.
//     state     (chunk, 64 rows of ds, G heads): st_h = (B o dte_h)^T X_h, K = Q;
//               B's 64 columns staged once for the chunk, X streamed per head.
//   backward    three launches, no atomics: every partial sum is written to
//               scratch and summed in a fixed order, so the gradient is the
//               same bit for bit from run to run:
//     rows      (chunk, i tile, GR heads): for j tiles <= i the score tile
//               (registers), then per head dM = dy_i X_j^T, dscores += dM o L
//               (the head group's partial, scratch), the row sums of
//               dLL = dM o S o L (complete: stored in dcum) and its column
//               sums over the tile's rows (scratch).
//     cols      three kinds of CTA: dxdt (chunk, j tile, GC heads) =
//               sum_{i >= j} (S o L)^T dy_i (S^T tiles into shared memory
//               once) + dte (B_j dst_h), and ddte = xdt . that term
//               (scratch); dB (chunk, j tile, 64 of ds) = dscores^T C +
//               sum_h (dte x_h) dst_h^T, one product over K = nh hd; dC
//               (chunk, i tile, 64 of ds) = dscores B. dscores is the
//               head-group partials summed in order.
//     finish    dcum = row sums - column sums - ddte, the last row also
//               + sum_j ddte (cum_{Q-1} is in every decay-to-end factor).
//   dB and dC are whole products of the cols launch (dB's state term over
//   K = nh hd at once, not summed from head-group partials), which fills
//   the card better than finishing them in the last launch; the finish
//   launch is elementwise.
//
// What bounds it on an H100: operations. At the train shape (B=4, 8 chunks
// of 256, 64 heads of 64, ds 128) the forward needs 17.5 GFLOP (the causal
// pairs of the scores and of y, the chunk states) and the backward 35.3
// GFLOP (chip_smoke.py ``ssd_bounds`` counts them): 0.261 and 0.526 ms at
// the 67 TFLOP/s float32 CUDA-core peak; as three TF32 products each at
// the 495 TFLOP/s tensor-core peak, 0.106 and 0.214 ms. What holds these
// kernels above that is instruction issue in the inner loop (fragment
// loads, the split and the adds beside the products) at 8 warps an SM.
//
// Plain C entry points (bound with ctypes by kernels/_build.py). Each
// launches on the given stream, allocates nothing (the backward's scratch
// comes from the caller, sized by ssd_chunk_bwd_scratch_f32), does not
// synchronise, and returns the first launch error.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;      // 4 warps
constexpr int kBM = 64;            // rows of an i or j tile; 16 a warp
constexpr int kKC = 32;            // ds (or hd) columns of a staged chunk
constexpr int kLdC = kKC + 4;      // a chunk read K-major
constexpr int kLdT = kBM + 8;      // a 64-wide tile read N- or M-major
constexpr int kLdK = kBM + 4;      // a 64-wide tile read K-major
constexpr int kSmemMax = 232448;   // bytes of shared memory a block may have

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
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

// ---- PTX: cp.async, the TF32 split, mma.sync --------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// n = 16 or 4 bytes global -> shared; zeros where !valid (nothing is read)
template <int N>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
                 "l"(src), "r"(valid ? 4 : 0)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one committed group of this thread's copies is pending
__device__ __forceinline__ void cp_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// a = hi + lo: hi = cvt.rna.tf32(a) (round to nearest, ties away), lo =
// a - hi exactly in float32, handed to the tensor core, which reads its TF32
// bits (lo's error 2^-21 |a|, against 2^-22 when lo is rounded too; the
// measured errors are the same). cvt.rna is computed with two integer ops:
// conversions were the split's slowest part.
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(a - __uint_as_float(hi));
}

// d (16 x 8) += a (16 x 8) b (8 x 8), TF32 in, float32 accumulate
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b (16 x 8), TF32 in, float32 out, from a zero accumulator
__device__ __forceinline__ void mma_tf32_first(float* d, const uint32_t* a, const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f), "f"(0.f),
        "f"(0.f), "f"(0.f));
}

// one k-step of a warp's 16 x 8NT tile: acc += a (split here) times the
// B fragments bload(n, b) gives for n-tiles 0 .. NT - 1, each split here.
// The three products lo.hi + hi.lo, then hi.hi go into a fresh tile, which
// is added to acc on the CUDA cores: the tensor cores' float32 accumulation
// truncates, and over a long K (dB's nh hd = 4096) its bias broke the 2e-4
// bar; a float32 add rounds to nearest.
template <int NT, typename BLoad>
__device__ __forceinline__ void mma_row(float (&acc)[8][4], const float (&a)[4], BLoad bload) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) split_tf32(a[r], ah[r], al[r]);
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float b[2];
    bload(n, b);
    uint32_t bh[2], bl[2];
    split_tf32(b[0], bh[0], bl[0]);
    split_tf32(b[1], bh[1], bl[1]);
    float p[4];
    mma_tf32_first(p, al, bh);
    mma_tf32(p, ah, bl);
    mma_tf32(p, ah, bh);
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] += p[r];
  }
}

// ---- fragments from shared memory (g = lane / 4, t = lane % 4) --------------
// A (16 x 8): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// B (8 x 8): b0 (k t, n g), b1 (k t + 4, n g); C: (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).

// A[m][k] stored at s[m * ld + k] (K-major)
__device__ __forceinline__ void frag_a_k(float (&a)[4], const float* s, int ld, int m0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = s + (m0 + g) * ld + k0 + t;
  a[0] = p[0];
  a[1] = p[8 * ld];
  a[2] = p[4];
  a[3] = p[8 * ld + 4];
}

// A[m][k] stored at s[k * ld + m] (M-major)
__device__ __forceinline__ void frag_a_m(float (&a)[4], const float* s, int ld, int m0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = s + (k0 + t) * ld + m0 + g;
  a[0] = p[0];
  a[1] = p[8];
  a[2] = p[4 * ld];
  a[3] = p[4 * ld + 8];
}

// B[k][n] stored at s[n * ld + k] (K-major)
__device__ __forceinline__ void frag_b_k(float* b, const float* s, int ld, int n0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = s + (n0 + g) * ld + k0 + t;
  b[0] = p[0];
  b[1] = p[4];
}

// B[k][n] stored at s[k * ld + n] (N-major)
__device__ __forceinline__ void frag_b_n(float* b, const float* s, int ld, int n0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const float* p = s + (k0 + t) * ld + n0 + g;
  b[0] = p[0];
  b[1] = p[4 * ld];
}

__device__ __forceinline__ void zero(float (&acc)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[n][r] = 0.f;
}

// decay L[i, j] with the mask selected, never multiplied: exp of a selected
// argument, then the selected value
__device__ __forceinline__ float decay(bool ok, float cum_i, float cum_j) {
  const float e = expf(ok ? cum_i - cum_j : 0.f);
  return ok ? e : 0.f;
}

// ---- staging ----------------------------------------------------------------

// rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major matrix (row stride
// `stride` floats; rows < nrows and columns < ncols exist) into shared
// memory rows of `ld` floats, zero outside; 16-byte copies when `vec`
template <int R, int C>
__device__ __forceinline__ void stage_tile(float* dst, int ld, const float* src, int64_t stride,
                                           int r0, int nrows, int c0, int ncols, bool vec) {
  if (vec) {
    for (int e = threadIdx.x; e < R * C / 4; e += kThreads) {
      const int r = e / (C / 4), c = (e % (C / 4)) * 4;
      const bool ok = r0 + r < nrows && c0 + c < ncols;
      cp_async<16>(dst + r * ld + c, ok ? src + (r0 + r) * stride + c0 + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < R * C; e += kThreads) {
      const int r = e / C, c = e % C;
      const bool ok = r0 + r < nrows && c0 + c < ncols;
      cp_async<4>(dst + r * ld + c, ok ? src + (r0 + r) * stride + c0 + c : src, ok);
    }
  }
}

// kBM values src[(r0 + r) * stride], r < n - r0, zero past
__device__ __forceinline__ void stage_col(float* dst, const float* src, int64_t stride, int r0,
                                          int n) {
  if (threadIdx.x < kBM) {
    const int r = threadIdx.x;
    const bool ok = r0 + r < n;
    cp_async<4>(dst + r, ok ? src + (r0 + r) * stride : src, ok);
  }
}

// ---- shared memory of each kernel, in floats (the plan's, times 4 bytes) ----

template <int HD>
__host__ __device__ constexpr int fwd_rows_stage() {
  return cmax(2 * kBM * kLdC, kBM * (HD + 8) + kBM);  // C, B chunks | X tile, cum
}
template <int HD>
__host__ __device__ constexpr int fwd_state_stage() {
  return kBM * (HD + 8) + kBM;  // X tile, cum
}
template <int HD>
__host__ __device__ int fwd_smem_floats(int Q, int G) {
  const int Qp = cdiv(Q, kBM) * kBM;
  const int rows = kBM * (Qp + 4) + 2 * fwd_rows_stage<HD>() + G * kBM;
  return cmax(rows, Qp * kLdT + 2 * fwd_state_stage<HD>());  // state: B's 64 columns, a ring
}

template <int HD>
__host__ __device__ constexpr int rows_stage() {
  return cmax(2 * kBM * kLdC, 2 * kBM * (HD + 4) + kBM);  // C, B chunks | dy, X tiles, cum
}
template <int HD>
__host__ __device__ int rows_smem_floats(int GR) {
  return 2 * rows_stage<HD>() + 2 * GR * kBM + 4 * kBM;  // ring, cum and row sums, red
}

template <int HD>
__host__ __device__ constexpr int dx_stage() {
  // B, C chunks | dy tile, cum | B chunk, dst chunk
  return cmax(cmax(2 * kBM * kLdC, kBM * (HD + 8) + kBM), kBM * kLdC + kKC * (HD + 8));
}
// D, C | x, dst, cum
__host__ __device__ constexpr int db_stage() { return cmax(2 * kBM * kLdT, 2 * kBM * kLdC + kBM); }
__host__ __device__ constexpr int dc_stage() { return kBM * kLdK + kBM * kLdT; }  // D, B
template <int HD>
__host__ __device__ int cols_smem_floats(int Q, int GC) {
  const int dx = kBM * (cdiv(Q, kBM) * kBM + 4) + 2 * dx_stage<HD>() + GC * kBM;
  return cmax(dx, cmax(2 * db_stage(), 2 * dc_stage()));
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdArgs {
  const float *xdt, *cum, *B, *C;
  float *y, *st;
  Shape sh;
  int G;     // heads of a CTA
  bool vec;  // 16-byte copies
};

template <int HD>
__device__ void fwd_rows(const FwdArgs& a, int bc, int it, int h0, float* smem) {
  constexpr int NT = HD / 8;
  constexpr int stage = fwd_rows_stage<HD>();
  const Shape& sh = a.sh;
  const int Q = sh.Q, nkc = cdiv(sh.ds, kKC), ldS = cdiv(Q, kBM) * kBM + 4;
  const int ng = min(a.G, sh.nh - h0), i0 = it * kBM;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, wm = (threadIdx.x >> 5) * 16;
  float* S = smem;                   // kBM x ldS: S[i0 + r, j]
  float* ring = S + kBM * ldS;       // 2 stages
  float* cumI = ring + 2 * stage;    // G x kBM: cum of the tile's rows
  for (int e = threadIdx.x; e < ng * kBM; e += kThreads) {
    const int r = e % kBM, q = i0 + r;
    cumI[e] = q < Q ? a.cum[sh.c(bc, q, h0 + e / kBM)] : 0.f;
  }
  const int n1 = (it + 1) * nkc, total = n1 + ng * (it + 1);
  auto issue = [&](int s) {
    float* buf = ring + (s & 1) * stage;
    if (s < n1) {  // a ds chunk of C_i and B_j
      const int jt = s / nkc, k0 = (s % nkc) * kKC;
      stage_tile<kBM, kKC>(buf, kLdC, a.C + sh.b(bc, 0), sh.ds, i0, Q, k0, sh.ds, a.vec);
      stage_tile<kBM, kKC>(buf + kBM * kLdC, kLdC, a.B + sh.b(bc, 0), sh.ds, jt * kBM, Q, k0,
                           sh.ds, a.vec);
    } else {  // X_j and cum_j of one head
      const int s2 = s - n1, h = h0 + s2 / (it + 1), jt = s2 % (it + 1);
      stage_tile<kBM, HD>(buf, HD + 8, a.xdt + sh.x(bc, 0, h), (int64_t)sh.nh * sh.hd, jt * kBM,
                          Q, 0, sh.hd, a.vec);
      stage_col(buf + kBM * (HD + 8), a.cum + sh.c(bc, 0, h), sh.nh, jt * kBM, Q);
    }
  };

  float acc[8][4];
  zero(acc);
  float ci0 = 0.f, ci1 = 0.f;
  issue(0);
  cp_commit();
  for (int s = 0; s < total; ++s) {
    if (s + 1 < total) issue(s + 1);
    cp_commit();
    cp_wait1();
    __syncthreads();
    const float* buf = ring + (s & 1) * stage;
    if (s < n1) {
      // S tile (rows i0.., columns jt * 64..) over one ds chunk
      const int jt = s / nkc;
      const float* Cs = buf;
      const float* Bs = buf + kBM * kLdC;
#pragma unroll
      for (int k0 = 0; k0 < kKC; k0 += 8) {
        float f[4];
        frag_a_k(f, Cs, kLdC, wm, k0);
        mma_row<8>(acc, f, [&](int n, float* b) { frag_b_k(b, Bs, kLdC, n * 8, k0); });
      }
      if (s % nkc == nkc - 1) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float* p = S + (wm + g) * ldS + jt * kBM + n * 8 + 2 * t;
          p[0] = acc[n][0];
          p[1] = acc[n][1];
          p[8 * ldS] = acc[n][2];
          p[8 * ldS + 1] = acc[n][3];
        }
        zero(acc);
      }
    } else {
      // y_i += (S o L_h) X_jh
      const int s2 = s - n1, gi = s2 / (it + 1), jt = s2 % (it + 1);
      const float* Xs = buf;
      const float* cj = buf + kBM * (HD + 8);
      if (jt == 0) {
        ci0 = cumI[gi * kBM + wm + g];
        ci1 = cumI[gi * kBM + wm + g + 8];
      }
      const int r0 = i0 + wm + g, r1 = r0 + 8;
      // on the diagonal tile, columns past this warp's last row are all masked
      const int kend = jt == it ? wm + 16 : kBM;
      for (int k0 = 0; k0 < kend; k0 += 8) {
        const int c0 = k0 + t, c1 = c0 + 4, j0 = jt * kBM + c0, j1 = j0 + 4;
        const float cj0 = cj[c0], cj1 = cj[c1];
        const float* Sp = S + (wm + g) * ldS + jt * kBM;
        const bool ok00 = j0 <= r0 && r0 < Q && j0 < Q, ok10 = j0 <= r1 && r1 < Q && j0 < Q;
        const bool ok01 = j1 <= r0 && r0 < Q && j1 < Q, ok11 = j1 <= r1 && r1 < Q && j1 < Q;
        float f[4];
        f[0] = ok00 ? Sp[c0] * decay(ok00, ci0, cj0) : 0.f;
        f[1] = ok10 ? Sp[8 * ldS + c0] * decay(ok10, ci1, cj0) : 0.f;
        f[2] = ok01 ? Sp[c1] * decay(ok01, ci0, cj1) : 0.f;
        f[3] = ok11 ? Sp[8 * ldS + c1] * decay(ok11, ci1, cj1) : 0.f;
        mma_row<NT>(acc, f, [&](int n, float* b) { frag_b_n(b, Xs, HD + 8, n * 8, k0); });
      }
      if (jt == it) {  // this head's rows are complete
        const int h = h0 + gi;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int d = n * 8 + 2 * t;
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = r < 2 ? r0 : r1, dd = d + (r & 1);
            if (i < Q && dd < sh.hd) a.y[sh.x(bc, i, h) + dd] = acc[n][r];
          }
        }
        zero(acc);
      }
    }
    __syncthreads();  // the stage's buffer is refilled by the next issue
  }
}

template <int HD>
__device__ void fwd_state(const FwdArgs& a, int bc, int s0, int h0, float* smem) {
  constexpr int NT = HD / 8;
  constexpr int stage = fwd_state_stage<HD>();
  const Shape& sh = a.sh;
  const int Q = sh.Q, nJT = cdiv(Q, kBM), ng = min(a.G, sh.nh - h0);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, wm = (threadIdx.x >> 5) * 16;
  float* Bt = smem;                   // nJT * 64 x kLdT: B[j][s0 + c], A[m = s][k = j] M-major
  float* ring = Bt + nJT * kBM * kLdT;
  const int total = ng * nJT;
  auto issue = [&](int s) {
    float* buf = ring + (s & 1) * stage;
    const int h = h0 + s / nJT, j0 = (s % nJT) * kBM;
    stage_tile<kBM, HD>(buf, HD + 8, a.xdt + sh.x(bc, 0, h), (int64_t)sh.nh * sh.hd, j0, Q, 0,
                        sh.hd, a.vec);
    stage_col(buf + kBM * (HD + 8), a.cum + sh.c(bc, 0, h), sh.nh, j0, Q);
  };
  float acc[8][4];
  zero(acc);
  float clast = 0.f;
  // B's 64 columns for the whole chunk, once (every head reads them)
  for (int jt = 0; jt < nJT; ++jt)
    stage_tile<kBM, kBM>(Bt + jt * kBM * kLdT, kLdT, a.B + sh.b(bc, 0), sh.ds, jt * kBM, Q, s0,
                         sh.ds, a.vec);
  issue(0);
  cp_commit();
  for (int s = 0; s < total; ++s) {
    if (s + 1 < total) issue(s + 1);
    cp_commit();
    cp_wait1();
    __syncthreads();
    const int gi = s / nJT, jt = s % nJT, h = h0 + gi;
    const float* Bj = Bt + jt * kBM * kLdT;
    const float* Xs = ring + (s & 1) * stage;
    const float* cj = Xs + kBM * (HD + 8);
    if (jt == 0) clast = a.cum[sh.c(bc, Q - 1, h)];
#pragma unroll 2
    for (int k0 = 0; k0 < kBM; k0 += 8) {
      const int j0 = jt * kBM + k0 + t;
      // decay to the chunk's end of steps j0 and j0 + 4
      const float w0 = j0 < Q ? expf(clast - cj[k0 + t]) : 0.f;
      const float w1 = j0 + 4 < Q ? expf(clast - cj[k0 + t + 4]) : 0.f;
      float f[4];
      frag_a_m(f, Bj, kLdT, wm, k0);
      f[0] *= w0;
      f[1] *= w0;
      f[2] *= w1;
      f[3] *= w1;
      mma_row<NT>(acc, f, [&](int n, float* b) { frag_b_n(b, Xs, HD + 8, n * 8, k0); });
    }
    if (jt == nJT - 1) {  // this head's state rows are complete
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int sr = s0 + wm + g + (r < 2 ? 0 : 8), d = n * 8 + 2 * t + (r & 1);
          if (sr < sh.ds && d < sh.hd) a.st[sh.st(bc, h, sr) + d] = acc[n][r];
        }
      }
      zero(acc);
    }
    __syncthreads();  // the stage's buffer is refilled by the next issue
  }
}

// grid: BC x nHG row CTAs of the last i tile, then BC x nST x nHG state CTAs,
// then the other row CTAs by decreasing i tile (the longest first)
template <int HD>
__global__ void __launch_bounds__(kThreads, 2) ssd_fwd_kernel(FwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const Shape& sh = a.sh;
  const int nIT = cdiv(sh.Q, kBM), nHG = cdiv(sh.nh, a.G), nST = cdiv(sh.ds, kBM);
  const int per_it = sh.BC * nHG, n_state = sh.BC * nST * nHG;
  int id = blockIdx.x;
  if (id >= per_it && id < per_it + n_state) {
    id -= per_it;
    fwd_state<HD>(a, id / (nST * nHG), (id / nHG % nST) * kBM, (id % nHG) * a.G, smem);
    return;
  }
  int it = nIT - 1;
  if (id >= per_it) {
    id -= per_it + n_state;
    it = nIT - 2 - id / per_it;
    id %= per_it;
  }
  fwd_rows<HD>(a, id / nHG, it, (id % nHG) * a.G, smem);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// scratch of one backward call, in floats, carved in this order
struct Scratch {
  float *dscp, *colpart, *ddte;
};

__host__ int64_t scratch_floats(const Shape& sh, int GR) {
  const int64_t Q = sh.Q, BC = sh.BC, nIT = cdiv(sh.Q, kBM);
  return BC * cdiv(sh.nh, GR) * Q * Q  // dscores partials of the head groups
         + BC * nIT * Q * sh.nh         // column-sum partials of the i tiles
         + BC * Q * sh.nh;              // ddte
}

__host__ Scratch carve(float* base, const Shape& sh, int GR) {
  const int64_t Q = sh.Q, BC = sh.BC, nIT = cdiv(sh.Q, kBM);
  Scratch sc;
  sc.dscp = base;
  sc.colpart = sc.dscp + BC * cdiv(sh.nh, GR) * Q * Q;
  sc.ddte = sc.colpart + BC * nIT * Q * sh.nh;
  return sc;
}

struct BwdArgs {
  const float *xdt, *cum, *B, *C, *dy, *dst;
  float *dxdt, *dcum, *dB, *dC;
  Scratch sc;
  Shape sh;
  int GR, GC;  // heads of a rows CTA and of a dxdt CTA
  bool vec;
};

// rows: grid BC x nIT x nRG, the longest (last i tile) first
template <int HD>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_rows_kernel(BwdArgs a) {
  constexpr int stage = rows_stage<HD>();
  extern __shared__ __align__(16) float smem[];
  const Shape& sh = a.sh;
  const int Q = sh.Q, nh = sh.nh, nIT = cdiv(Q, kBM), nRG = cdiv(nh, a.GR);
  const int nkc = cdiv(sh.ds, kKC);
  const int per_it = sh.BC * nRG;
  const int it = nIT - 1 - (int)blockIdx.x / per_it;
  const int bc = (int)blockIdx.x % per_it / nRG, rg = (int)blockIdx.x % nRG;
  const int h0 = rg * a.GR, ng = min(a.GR, nh - h0), i0 = it * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp * 16;
  float* ring = smem;
  float* cumI = ring + 2 * stage;      // GR x kBM
  float* rowacc = cumI + a.GR * kBM;   // GR x kBM: row sums of dLL
  float* red = rowacc + a.GR * kBM;    // 4 x kBM: the warps' column sums
  for (int e = threadIdx.x; e < ng * kBM; e += kThreads) {
    const int q = i0 + e % kBM;
    cumI[e] = q < Q ? a.cum[sh.c(bc, q, h0 + e / kBM)] : 0.f;
    rowacc[e] = 0.f;
  }
  const int per_jt = nkc + ng, total = (it + 1) * per_jt;
  auto issue = [&](int s) {
    float* buf = ring + (s & 1) * stage;
    const int jt = s / per_jt, r = s % per_jt;
    if (r < nkc) {  // a ds chunk of C_i and B_j
      stage_tile<kBM, kKC>(buf, kLdC, a.C + sh.b(bc, 0), sh.ds, i0, Q, r * kKC, sh.ds, a.vec);
      stage_tile<kBM, kKC>(buf + kBM * kLdC, kLdC, a.B + sh.b(bc, 0), sh.ds, jt * kBM, Q,
                           r * kKC, sh.ds, a.vec);
    } else {  // dy_i, X_j and cum_j of one head
      const int h = h0 + r - nkc;
      const int64_t rs = (int64_t)nh * sh.hd;
      stage_tile<kBM, HD>(buf, HD + 4, a.dy + sh.x(bc, 0, h), rs, i0, Q, 0, sh.hd, a.vec);
      stage_tile<kBM, HD>(buf + kBM * (HD + 4), HD + 4, a.xdt + sh.x(bc, 0, h), rs, jt * kBM, Q,
                          0, sh.hd, a.vec);
      stage_col(buf + 2 * kBM * (HD + 4), a.cum + sh.c(bc, 0, h), nh, jt * kBM, Q);
    }
  };

  float sacc[8][4], dsc[8][4], dm[8][4];
  zero(sacc);
  zero(dsc);
  const int r0 = i0 + wm + g, r1 = r0 + 8;
  issue(0);
  cp_commit();
  for (int s = 0; s < total; ++s) {
    if (s + 1 < total) issue(s + 1);
    cp_commit();
    cp_wait1();
    __syncthreads();
    const float* buf = ring + (s & 1) * stage;
    const int jt = s / per_jt, r = s % per_jt;
    if (r < nkc) {
      if (r == 0) {
        zero(sacc);
        zero(dsc);
      }
      const float* Cs = buf;
      const float* Bs = buf + kBM * kLdC;
#pragma unroll
      for (int k0 = 0; k0 < kKC; k0 += 8) {
        float f[4];
        frag_a_k(f, Cs, kLdC, wm, k0);
        mma_row<8>(sacc, f, [&](int n, float* b) { frag_b_k(b, Bs, kLdC, n * 8, k0); });
      }
    } else {
      const int gi = r - nkc, h = h0 + gi;
      const float* DYs = buf;
      const float* Xs = buf + kBM * (HD + 4);
      const float* cj = buf + 2 * kBM * (HD + 4);
      // dM = dy_i X_j^T (K = hd)
      zero(dm);
#pragma unroll
      for (int k0 = 0; k0 < HD; k0 += 8) {
        float f[4];
        frag_a_k(f, DYs, HD + 4, wm, k0);
        mma_row<8>(dm, f, [&](int n, float* b) { frag_b_k(b, Xs, HD + 4, n * 8, k0); });
      }
      const float ci0 = cumI[gi * kBM + wm + g], ci1 = cumI[gi * kBM + wm + g + 8];
      float row0 = 0.f, row1 = 0.f, col[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = n * 8 + 2 * t + e, j = jt * kBM + c;
          const float cjv = cj[c];
          const bool ok0 = j <= r0 && r0 < Q && j < Q, ok1 = j <= r1 && r1 < Q && j < Q;
          const float L0 = decay(ok0, ci0, cjv), L1 = decay(ok1, ci1, cjv);
          dsc[n][e] = fmaf(dm[n][e], L0, dsc[n][e]);
          dsc[n][2 + e] = fmaf(dm[n][2 + e], L1, dsc[n][2 + e]);
          const float d0 = ok0 ? dm[n][e] * sacc[n][e] * L0 : 0.f;
          const float d1 = ok1 ? dm[n][2 + e] * sacc[n][2 + e] * L1 : 0.f;
          row0 += d0;
          row1 += d1;
          col[n][e] = d0 + d1;
        }
      }
      // row sums: over the quad (the warp owns its rows)
      row0 += __shfl_xor_sync(0xffffffffu, row0, 1);
      row0 += __shfl_xor_sync(0xffffffffu, row0, 2);
      row1 += __shfl_xor_sync(0xffffffffu, row1, 1);
      row1 += __shfl_xor_sync(0xffffffffu, row1, 2);
      if (t == 0) {
        rowacc[gi * kBM + wm + g] += row0;
        rowacc[gi * kBM + wm + g + 8] += row1;
      }
      // column sums: over the warp's 16 rows, then over the warps in order
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = col[n][e];
          v += __shfl_xor_sync(0xffffffffu, v, 4);
          v += __shfl_xor_sync(0xffffffffu, v, 8);
          v += __shfl_xor_sync(0xffffffffu, v, 16);
          if (g == 0) red[warp * kBM + n * 8 + 2 * t + e] = v;
        }
      __syncthreads();
      if (threadIdx.x < kBM) {
        const int j = jt * kBM + threadIdx.x;
        const float v = red[threadIdx.x] + red[kBM + threadIdx.x] + red[2 * kBM + threadIdx.x] +
                        red[3 * kBM + threadIdx.x];
        if (j < Q) a.sc.colpart[(((int64_t)bc * nIT + it) * Q + j) * nh + h] = v;
      }
      if (gi == ng - 1) {  // the head group's dscores tile is complete
        float* out = a.sc.dscp + ((int64_t)bc * nRG + rg) * Q * Q;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? r0 : r1, j = jt * kBM + n * 8 + 2 * t + (e & 1);
            if (i < Q && j < Q) out[(int64_t)i * Q + j] = dsc[n][e];
          }
      }
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < ng * kBM; e += kThreads) {
    const int q = i0 + e % kBM;
    if (q < Q) a.dcum[sh.c(bc, q, h0 + e / kBM)] = rowacc[e];
  }
}

// the dscores tile rows [i0, +64) x columns [j0, +64), the head groups'
// partials summed in order, into shared memory rows of ld; zero past Q
__device__ __forceinline__ void stage_dscores(float* dst, int ld, const BwdArgs& a, int bc,
                                              int i0, int j0) {
  const int Q = a.sh.Q, nRG = cdiv(a.sh.nh, a.GR);
  for (int e = threadIdx.x; e < kBM * kBM; e += kThreads) {
    const int r = e / kBM, c = e % kBM, i = i0 + r, j = j0 + c;
    float v = 0.f;
    if (i < Q && j < Q)
      for (int p = 0; p < nRG; ++p) v += a.sc.dscp[(((int64_t)bc * nRG + p) * Q + i) * Q + j];
    dst[r * ld + c] = v;
  }
}

// cols, dxdt CTA: dxdt_j = sum_{i >= j} (S o L)^T dy_i + dte (B_j dst_h), ddte
template <int HD>
__device__ void cols_dx(const BwdArgs& a, int bc, int jt, int h0, float* smem) {
  constexpr int NT = HD / 8;
  constexpr int stage = dx_stage<HD>();
  const Shape& sh = a.sh;
  const int Q = sh.Q, nh = sh.nh, nIT = cdiv(Q, kBM), nkc = cdiv(sh.ds, kKC);
  const int ldS = nIT * kBM + 4, ng = min(a.GC, nh - h0), j0 = jt * kBM;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, wm = (threadIdx.x >> 5) * 16;
  float* ST = smem;                 // kBM x ldS: S^T[j0 + r, j0 + c]
  float* ring = ST + kBM * ldS;
  float* cumJ = ring + 2 * stage;   // GC x kBM
  for (int e = threadIdx.x; e < ng * kBM; e += kThreads) {
    const int q = j0 + e % kBM;
    cumJ[e] = q < Q ? a.cum[sh.c(bc, q, h0 + e / kBM)] : 0.f;
  }
  const int nA = nIT - jt, n1 = nA * nkc, per_h = nA + nkc, total = n1 + ng * per_h;
  const int64_t rs = (int64_t)nh * sh.hd;
  auto issue = [&](int s) {
    float* buf = ring + (s & 1) * stage;
    if (s < n1) {  // a ds chunk of B_j and C_i
      const int it = jt + s / nkc, k0 = (s % nkc) * kKC;
      stage_tile<kBM, kKC>(buf, kLdC, a.B + sh.b(bc, 0), sh.ds, j0, Q, k0, sh.ds, a.vec);
      stage_tile<kBM, kKC>(buf + kBM * kLdC, kLdC, a.C + sh.b(bc, 0), sh.ds, it * kBM, Q, k0,
                           sh.ds, a.vec);
      return;
    }
    const int s2 = s - n1, h = h0 + s2 / per_h, r = s2 % per_h;
    if (r < nA) {  // dy_i and cum_i of one head
      stage_tile<kBM, HD>(buf, HD + 8, a.dy + sh.x(bc, 0, h), rs, (jt + r) * kBM, Q, 0, sh.hd,
                          a.vec);
      stage_col(buf + kBM * (HD + 8), a.cum + sh.c(bc, 0, h), nh, (jt + r) * kBM, Q);
    } else {  // a ds chunk of B_j and of dst_h
      const int k0 = (r - nA) * kKC;
      stage_tile<kBM, kKC>(buf, kLdC, a.B + sh.b(bc, 0), sh.ds, j0, Q, k0, sh.ds, a.vec);
      stage_tile<kKC, HD>(buf + kBM * kLdC, HD + 8, a.dst + sh.st(bc, h, 0), sh.hd, k0, sh.ds, 0,
                          sh.hd, a.vec);
    }
  };

  float acc[8][4], xacc[8][4];
  zero(acc);
  zero(xacc);
  const int q0 = j0 + wm + g, q1 = q0 + 8;  // this lane's rows j
  issue(0);
  cp_commit();
  for (int s = 0; s < total; ++s) {
    if (s + 1 < total) issue(s + 1);
    cp_commit();
    cp_wait1();
    __syncthreads();
    const float* buf = ring + (s & 1) * stage;
    if (s < n1) {  // S^T tile (rows j, columns i) over one ds chunk
      const int it = jt + s / nkc;
      const float* Bs = buf;
      const float* Cs = buf + kBM * kLdC;
#pragma unroll
      for (int k0 = 0; k0 < kKC; k0 += 8) {
        float f[4];
        frag_a_k(f, Bs, kLdC, wm, k0);
        mma_row<8>(acc, f, [&](int n, float* b) { frag_b_k(b, Cs, kLdC, n * 8, k0); });
      }
      if (s % nkc == nkc - 1) {
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float* p = ST + (wm + g) * ldS + (it - jt) * kBM + n * 8 + 2 * t;
          p[0] = acc[n][0];
          p[1] = acc[n][1];
          p[8 * ldS] = acc[n][2];
          p[8 * ldS + 1] = acc[n][3];
        }
        zero(acc);
      }
    } else {
      const int s2 = s - n1, gi = s2 / per_h, r = s2 % per_h, h = h0 + gi;
      const float cj0 = cumJ[gi * kBM + wm + g], cj1 = cumJ[gi * kBM + wm + g + 8];
      if (r < nA) {  // xacc += (S o L)^T_{j, i} dy_i
        const int it = jt + r;
        const float* DYs = buf;
        const float* ci = buf + kBM * (HD + 8);
        const float* Sp = ST + (wm + g) * ldS + r * kBM;
        // on the diagonal tile, columns i before this warp's first row are masked
        for (int k0 = it == jt ? wm : 0; k0 < kBM; k0 += 8) {
          const int c0 = k0 + t, c1 = c0 + 4, i0 = it * kBM + c0, i1 = i0 + 4;
          const float ci0 = ci[c0], ci1 = ci[c1];
          const bool ok00 = i0 >= q0 && i0 < Q && q0 < Q, ok10 = i0 >= q1 && i0 < Q && q1 < Q;
          const bool ok01 = i1 >= q0 && i1 < Q && q0 < Q, ok11 = i1 >= q1 && i1 < Q && q1 < Q;
          float f[4];
          f[0] = ok00 ? Sp[c0] * decay(ok00, ci0, cj0) : 0.f;
          f[1] = ok10 ? Sp[8 * ldS + c0] * decay(ok10, ci0, cj1) : 0.f;
          f[2] = ok01 ? Sp[c1] * decay(ok01, ci1, cj0) : 0.f;
          f[3] = ok11 ? Sp[8 * ldS + c1] * decay(ok11, ci1, cj1) : 0.f;
          mma_row<NT>(xacc, f, [&](int n, float* b) { frag_b_n(b, DYs, HD + 8, n * 8, k0); });
        }
      } else {  // acc += B_j dst_h over one ds chunk
        const int kc = r - nA;
        const float* Bs = buf;
        const float* Ds = buf + kBM * kLdC;
#pragma unroll
        for (int k0 = 0; k0 < kKC; k0 += 8) {
          float f[4];
          frag_a_k(f, Bs, kLdC, wm, k0);
          mma_row<NT>(acc, f, [&](int n, float* b) { frag_b_n(b, Ds, HD + 8, n * 8, k0); });
        }
        if (kc == nkc - 1) {  // dxdt_j = xacc + dte acc; ddte = x_j . dte acc
          const float clast = a.cum[sh.c(bc, Q - 1, h)];
          const float w0 = q0 < Q ? expf(clast - cj0) : 0.f, w1 = q1 < Q ? expf(clast - cj1) : 0.f;
          float p0 = 0.f, p1 = 0.f;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = e < 2 ? q0 : q1, d = n * 8 + 2 * t + (e & 1);
              const float tv = (e < 2 ? w0 : w1) * acc[n][e];
              if (q < Q && d < sh.hd) {
                a.dxdt[sh.x(bc, q, h) + d] = xacc[n][e] + tv;
                const float xv = a.xdt[sh.x(bc, q, h) + d];
                if (e < 2) p0 = fmaf(xv, tv, p0);
                else p1 = fmaf(xv, tv, p1);
              }
            }
          p0 += __shfl_xor_sync(0xffffffffu, p0, 1);
          p0 += __shfl_xor_sync(0xffffffffu, p0, 2);
          p1 += __shfl_xor_sync(0xffffffffu, p1, 1);
          p1 += __shfl_xor_sync(0xffffffffu, p1, 2);
          if (t == 0 && q0 < Q) a.sc.ddte[sh.c(bc, q0, h)] = p0;
          if (t == 0 && q1 < Q) a.sc.ddte[sh.c(bc, q1, h)] = p1;
          zero(acc);
          zero(xacc);
        }
      }
    }
    __syncthreads();  // the stage's buffer is refilled by the next issue
  }
}

// cols, dB CTA: dB_j = sum_{i >= j} dscores[i, j] C_i + sum_h (dte_h x_jh) dst_h^T
__device__ void cols_db(const BwdArgs& a, int bc, int jt, int s0, float* smem) {
  constexpr int stage = db_stage();
  const Shape& sh = a.sh;
  const int Q = sh.Q, nh = sh.nh, nIT = cdiv(Q, kBM), ndc = cdiv(sh.hd, kKC), j0 = jt * kBM;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, wm = (threadIdx.x >> 5) * 16;
  const int nA = nIT - jt, total = nA + nh * ndc;
  auto issue = [&](int s) {
    float* buf = smem + (s & 1) * stage;
    if (s < nA) {  // dscores[i tile, j tile] and C_i's 64 columns of ds
      const int i0 = (jt + s) * kBM;
      stage_tile<kBM, kBM>(buf + kBM * kLdT, kLdT, a.C + sh.b(bc, 0), sh.ds, i0, Q, s0, sh.ds,
                           a.vec);
      stage_dscores(buf, kLdT, a, bc, i0, j0);
    } else {  // a hd chunk of x_jh and of dst_h's 64 rows of ds, cum_jh
      const int h = (s - nA) / ndc, k0 = (s - nA) % ndc * kKC;
      stage_tile<kBM, kKC>(buf, kLdC, a.xdt + sh.x(bc, 0, h), (int64_t)nh * sh.hd, j0, Q, k0,
                           sh.hd, a.vec);
      stage_tile<kBM, kKC>(buf + kBM * kLdC, kLdC, a.dst + sh.st(bc, h, 0), sh.hd, s0, sh.ds, k0,
                           sh.hd, a.vec);
      stage_col(buf + 2 * kBM * kLdC, a.cum + sh.c(bc, 0, h), nh, j0, Q);
    }
  };
  float acc[8][4];
  zero(acc);
  const int q0 = j0 + wm + g, q1 = q0 + 8;
  float w0 = 0.f, w1 = 0.f;
  issue(0);
  cp_commit();
  for (int s = 0; s < total; ++s) {
    if (s + 1 < total) issue(s + 1);
    cp_commit();
    cp_wait1();
    __syncthreads();
    const float* buf = smem + (s & 1) * stage;
    if (s < nA) {  // A[m = j][k = i] = dscores[i][j] (M-major), B = C_i (N-major)
      const float* Ds = buf;
      const float* Cs = buf + kBM * kLdT;
      // on the diagonal tile, rows i before this warp's first column j are 0
      for (int k0 = s == 0 ? wm : 0; k0 < kBM; k0 += 8) {
        float f[4];
        frag_a_m(f, Ds, kLdT, wm, k0);
        mma_row<8>(acc, f, [&](int n, float* b) { frag_b_n(b, Cs, kLdT, n * 8, k0); });
      }
    } else {  // A = dte_h x_jh (K-major), B[k = d][n = s] = dst_h[s][d] (K-major)
      const int h = (s - nA) / ndc;
      const float* Xs = buf;
      const float* Ds = buf + kBM * kLdC;
      if ((s - nA) % ndc == 0) {
        const float clast = a.cum[sh.c(bc, Q - 1, h)];
        const float* cj = buf + 2 * kBM * kLdC;
        w0 = q0 < Q ? expf(clast - cj[wm + g]) : 0.f;
        w1 = q1 < Q ? expf(clast - cj[wm + g + 8]) : 0.f;
      }
#pragma unroll
      for (int k0 = 0; k0 < kKC; k0 += 8) {
        float f[4];
        frag_a_k(f, Xs, kLdC, wm, k0);
        f[0] *= w0;
        f[1] *= w1;
        f[2] *= w0;
        f[3] *= w1;
        mma_row<8>(acc, f, [&](int n, float* b) { frag_b_k(b, Ds, kLdC, n * 8, k0); });
      }
    }
    __syncthreads();  // the stage's buffer is refilled by the next issue
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = e < 2 ? q0 : q1, sc = s0 + n * 8 + 2 * t + (e & 1);
      if (q < Q && sc < sh.ds) a.dB[sh.b(bc, q) + sc] = acc[n][e];
    }
}

// cols, dC CTA: dC_i = sum_{j <= i} dscores[i, j] B_j
__device__ void cols_dc(const BwdArgs& a, int bc, int it, int s0, float* smem) {
  constexpr int stage = dc_stage();
  const Shape& sh = a.sh;
  const int Q = sh.Q, i0 = it * kBM;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, wm = (threadIdx.x >> 5) * 16;
  const int total = it + 1;
  auto issue = [&](int s) {
    float* buf = smem + (s & 1) * stage;
    stage_tile<kBM, kBM>(buf + kBM * kLdK, kLdT, a.B + sh.b(bc, 0), sh.ds, s * kBM, Q, s0, sh.ds,
                         a.vec);
    stage_dscores(buf, kLdK, a, bc, i0, s * kBM);
  };
  float acc[8][4];
  zero(acc);
  issue(0);
  cp_commit();
  for (int s = 0; s < total; ++s) {
    if (s + 1 < total) issue(s + 1);
    cp_commit();
    cp_wait1();
    __syncthreads();
    const float* Ds = smem + (s & 1) * stage;  // A[m = i][k = j] (K-major)
    const float* Bs = Ds + kBM * kLdK;         // B[k = j][n = s] (N-major)
    // on the diagonal tile, columns j past this warp's last row are 0
    const int kend = s == it ? wm + 16 : kBM;
    for (int k0 = 0; k0 < kend; k0 += 8) {
      float f[4];
      frag_a_k(f, Ds, kLdK, wm, k0);
      mma_row<8>(acc, f, [&](int n, float* b) { frag_b_n(b, Bs, kLdT, n * 8, k0); });
    }
    __syncthreads();  // the stage's buffer is refilled by the next issue
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = i0 + wm + g + (e < 2 ? 0 : 8), sc = s0 + n * 8 + 2 * t + (e & 1);
      if (q < Q && sc < sh.ds) a.dC[sh.b(bc, q) + sc] = acc[n][e];
    }
}

// cols: grid BC x nIT x nCG dxdt CTAs (by increasing j tile: the longest
// first), then BC x nIT x nST dB CTAs, then BC x nIT x nST dC CTAs
template <int HD>
__global__ void __launch_bounds__(kThreads, 2) ssd_bwd_cols_kernel(BwdArgs a) {
  extern __shared__ __align__(16) float smem[];
  const Shape& sh = a.sh;
  const int nIT = cdiv(sh.Q, kBM), nCG = cdiv(sh.nh, a.GC), nST = cdiv(sh.ds, kBM);
  int id = blockIdx.x;
  const int n_dx = sh.BC * nIT * nCG, n_b = sh.BC * nIT * nST;
  if (id < n_dx) {
    const int per_jt = sh.BC * nCG;
    cols_dx<HD>(a, id % per_jt / nCG, id / per_jt, (id % nCG) * a.GC, smem);
    return;
  }
  id -= n_dx;
  const bool db = id < n_b;
  if (!db) id -= n_b;
  const int bc = id / (nIT * nST), tile = id / nST % nIT, s0 = (id % nST) * kBM;
  if (db) cols_db(a, bc, tile, s0, smem);
  else cols_dc(a, bc, tile, s0, smem);
}

// finish: grid BC x nIT; dcum = row sums (already in dcum) - column sums -
// ddte, and the last row also + sum_j ddte
__global__ void __launch_bounds__(kThreads) ssd_bwd_finish_kernel(BwdArgs a) {
  const Shape& sh = a.sh;
  const int Q = sh.Q, nh = sh.nh, nIT = cdiv(Q, kBM);
  const int bc = (int)blockIdx.x / nIT, t = (int)blockIdx.x % nIT, r0 = t * kBM;
  for (int e = threadIdx.x; e < kBM * nh; e += kThreads) {
    const int i = r0 + e / nh, h = e % nh;
    if (i >= Q) continue;
    float v = a.dcum[sh.c(bc, i, h)];
    for (int it = t; it < nIT; ++it) v -= a.sc.colpart[(((int64_t)bc * nIT + it) * Q + i) * nh + h];
    v -= a.sc.ddte[sh.c(bc, i, h)];
    if (i == Q - 1) {
      float tot = 0.f;
      for (int j = 0; j < Q; ++j) tot += a.sc.ddte[sh.c(bc, j, h)];
      v += tot;
    }
    a.dcum[sh.c(bc, i, h)] = v;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

bool valid(const Shape& sh) {
  return sh.BC > 0 && sh.Q > 0 && sh.nh > 0 && sh.hd > 0 && sh.hd <= 64 && sh.ds > 0 &&
         sh.ds <= 128;
}

bool heads_ok(int G, int cap) { return G >= 1 && G <= cap && (G & (G - 1)) == 0; }

bool aligned(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <typename K>
int launch_prep(K kernel, int smem) {
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int HD>
int fwd_launch(const FwdArgs& a, int smem, cudaStream_t stream) {
  const Shape& sh = a.sh;
  if (!heads_ok(a.G, 8) || smem != 4 * fwd_smem_floats<HD>(sh.Q, a.G))
    return (int)cudaErrorInvalidValue;  // the plan disagrees with the compiled tiles
  int err = launch_prep(ssd_fwd_kernel<HD>, smem);
  if (err) return err;
  const int64_t ctas =
      (int64_t)sh.BC * cdiv(sh.nh, a.G) * (cdiv(sh.Q, kBM) + cdiv(sh.ds, kBM));
  if (ctas > 0x7fffffff) return (int)cudaErrorInvalidValue;
  ssd_fwd_kernel<HD><<<(unsigned)ctas, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int HD>
int bwd_launch(const BwdArgs& a, int smem_rows, int smem_cols, cudaStream_t stream) {
  const Shape& sh = a.sh;
  if (!heads_ok(a.GR, 16) || !heads_ok(a.GC, 16) || smem_rows != 4 * rows_smem_floats<HD>(a.GR) ||
      smem_cols != 4 * cols_smem_floats<HD>(sh.Q, a.GC))
    return (int)cudaErrorInvalidValue;
  int err = launch_prep(ssd_bwd_rows_kernel<HD>, smem_rows);
  if (err) return err;
  err = launch_prep(ssd_bwd_cols_kernel<HD>, smem_cols);
  if (err) return err;
  const int64_t nIT = cdiv(sh.Q, kBM), nST = cdiv(sh.ds, kBM);
  const int64_t rows = sh.BC * nIT * cdiv(sh.nh, a.GR);
  const int64_t cols = sh.BC * nIT * (cdiv(sh.nh, a.GC) + 2 * nST);
  if (rows > 0x7fffffff || cols > 0x7fffffff) return (int)cudaErrorInvalidValue;
  ssd_bwd_rows_kernel<HD><<<(unsigned)rows, kThreads, smem_rows, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  ssd_bwd_cols_kernel<HD><<<(unsigned)cols, kThreads, smem_cols, stream>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  ssd_bwd_finish_kernel<<<(unsigned)(sh.BC * nIT), kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y (B, nc, Q, nh, hd) and st (B, nc, nh, ds, hd) of float32 inputs, all
// contiguous; BC = B * nc; G and smem from the plan (kernels/ssd_scan.py)
int ssd_chunk_fwd_f32(const float* xdt, const float* cum, const float* B, const float* C,
                      float* y, float* st, int BC, int Q, int nh, int hd, int ds, int G, int smem,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape sh{BC, Q, nh, hd, ds};
  if (!valid(sh)) return (int)cudaErrorInvalidValue;
  const bool vec = hd % 4 == 0 && ds % 4 == 0 && aligned(xdt) && aligned(B) && aligned(C);
  const FwdArgs a{xdt, cum, B, C, y, st, sh, G, vec};
  cudaStream_t s = (cudaStream_t)stream;
  return hd <= 32 ? fwd_launch<32>(a, smem, s) : fwd_launch<64>(a, smem, s);
}

// floats of scratch ssd_chunk_bwd_f32 needs at this shape and rows head
// group GR (-1 if invalid)
int64_t ssd_chunk_bwd_scratch_f32(int BC, int Q, int nh, int hd, int ds, int GR) {
  const Shape sh{BC, Q, nh, hd, ds};
  if (!valid(sh) || !heads_ok(GR, 16)) return -1;
  return scratch_floats(sh, GR);
}

// (dxdt, dcum, dB, dC) from the inputs and the cotangents dy (as y) and dst
// (as st); three launches on one stream (rows, cols, finish); GR, GC and
// the shared memory from the plan
int ssd_chunk_bwd_f32(const float* xdt, const float* cum, const float* B, const float* C,
                      const float* dy, const float* dst, float* scratch, float* dxdt,
                      float* dcum, float* dB, float* dC, int BC, int Q, int nh, int hd, int ds,
                      int GR, int GC, int smem_rows, int smem_cols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Shape sh{BC, Q, nh, hd, ds};
  if (!valid(sh) || !heads_ok(GR, 16)) return (int)cudaErrorInvalidValue;
  const bool vec = hd % 4 == 0 && ds % 4 == 0 && aligned(xdt) && aligned(B) && aligned(C) &&
                   aligned(dy) && aligned(dst);
  const BwdArgs a{xdt, cum, B, C, dy, dst, dxdt, dcum, dB, dC, carve(scratch, sh, GR), sh,
                  GR, GC, vec};
  cudaStream_t s = (cudaStream_t)stream;
  return hd <= 32 ? bwd_launch<32>(a, smem_rows, smem_cols, s)
                  : bwd_launch<64>(a, smem_rows, smem_cols, s);
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
