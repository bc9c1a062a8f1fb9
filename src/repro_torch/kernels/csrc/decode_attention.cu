// Hand-written Hopper kernels for paged single-query decode attention.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/decode_attention.py
// (decode_attention / _decode_kernel): one query token per sequence attends
// over K/V pages of a shared pool (n_blocks, block_size, Hkv, D), addressed
// through an int32 block table (B, n_pages) and per-sequence lengths (B,).
//
//   out[b, h, :] = softmax_t(q[b, h] . k[b, t] / sqrt(D) [softcap]) @ v[b, t]
//   over max(0, lengths[b] - window) <= t < lengths[b] (the query sits at
//   position lengths[b] - 1), with an optional softcap cap * tanh(s / cap) on
//   the scores. Length 0 gives a zero row (the max(l, 1e-30) guard of the TPU
//   kernel). Table entries past a length are never read, nor pool pages
//   outside [0, n_blocks) (zeros instead).
//
// Translation. The TPU kernel runs a grid (B, Hkv, n_pages) whose page axis
// is sequential and carries the online softmax (m, l, acc) in VMEM scratch.
// Blocks on Hopper carry nothing from one to the next, so the positions of a
// (sequence, kv head) are split over several CTAs (flash-decoding): grid
// (splits, Hkv x head chunks, B). Each CTA reads lengths[b] on the device and
// takes one of `splits` equal ranges of whole tiles of [start, n_valid) (the
// rule of kernels/ref.py decode_split_ranges); a split with no valid
// position reads nothing and leaves (m = -1e30, l = 0, acc = 0). The query
// heads of a kv head that a CTA takes (up to 8 in bf16, 4 in float32; the
// whole group of 4 for minitron-8b) share every K/V tile, so K/V are read
// once per kv head.
//
// What bounds it on an H100: bytes. A call reads the live K/V once,
// sum_b n_b * Hkv * D * 2 values, and does 4 * group flops a value read: 8
// flops a byte in bf16 for minitron-8b, far below the 295 flops a byte at
// which the bf16 tensor cores' rate would matter. So the design is about
// bytes in flight and about issuing few instructions a byte:
//   * One CTA to each (sequence, kv head) would put 64 CTAs on 132 SMs at
//     the serving batch, each walking its sequence alone. Instead `splits`
//     (kernels/decode_attention.py decode_plan, from shapes only: the
//     wrapper never reads lengths to the host) fills one resident wave of
//     CTAs at most, and is 1 when the (sequence, head chunk) units already
//     fill it (decode_32k: B = 128). A partial second wave would
//     leave a few CTAs streaming alone at the end, each held to the bytes
//     one CTA keeps in flight.
//   * K/V tiles stay in their storage type in a ring of cp.async 16-byte
//     copies, the page looked up per position: each warp reads a tile's
//     table entries once (one request, not one a row: the CTAs of one
//     sequence would queue on the same L2 lines) and shuffles them to its
//     rows, one tile ahead, so a table read never stalls a copy. One
//     __syncthreads a tile, which the ring needs.
//   * bf16 (every model path): the scores and p @ v run on the tensor cores
//     (mma.sync m16n8k16, float32 accumulators), each warp taking 16
//     positions of a 64-position tile: S = Q K^T with the CTA's query heads
//     as the rows of A (rows 8-15 zero; the cores have rate to spare), K
//     read by ldmatrix from an XOR-swizzled tile; the score fragments become
//     the A operand of P V in registers (as in FlashAttention-2), with P as
//     hi + lo bf16 (a single bf16 P rounds by 2^-9, as the flash forward
//     found), V read by ldmatrix.trans. Float32 FMAs with a shuffle
//     reduction a score issue too many instructions a byte: on the CUDA
//     cores this design reached about half the card's byte rate at long
//     contexts.
//   * float32 (the tests' dtype; no model path): the CUDA cores, each warp
//     taking a quarter of every tile and each group of lanes (lanes a row)
//     its own rows with its own online softmax; scores need only shuffles
//     within a row's lanes and p @ v none. The float32 bars (2e-5) rule out
//     the bf16 and TF32 tensor-core products.
//   * Merging. Lane groups merge by shuffles, warps through shared memory,
//     both in a fixed order. With splits > 1 each CTA writes its (m, l, acc)
//     to a workspace; the last CTA of a (sequence, head chunk) to finish (an
//     acq_rel atomic add on its counter) stages the splits' partials in
//     shared memory, merges them in split order, in one pass, and resets
//     the counter. So a call is one launch and
//     bit-for-bit repeatable, whichever CTA is last.
// D (16, 32, 64, 128 or 256) is a template parameter, and in float32 the
// heads a CTA takes (1, 2 or 4). Scores are kept in log2 units (exp2f).
//
// Plain C entry points (bound with ctypes by kernels/_build.py). Each
// launches on the given stream, allocates nothing (the caller passes the
// workspace), does not synchronise, and returns cudaGetLastError() right
// after its launch. The launcher recomputes the plan and refuses a call whose
// splits or shared memory differ from its own (edit decode_plan with it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the TPU kernel's finite mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRingBytes = 65536;     // bf16: the ring's bytes (whole 64-position stages, 2 to 4)
constexpr int kStages = 4;            // float32: tiles in the ring
constexpr int kStageBytes = 16384;    // float32: K + V bytes a stage
constexpr int kMaxSplits = 64;
constexpr int kMmaHeads = 8;          // bf16: query heads a CTA takes at most (rows of A)
constexpr int kMmaMaxBlocks = 4;      // bf16: CTAs an SM the plan counts on at most
constexpr int kMinBlocks = 3;         // float32: CTAs an SM the registers are held to
constexpr int kSmemPerSM = 233472;    // 228 KB
constexpr int kSmemPerBlock = 232448; // 227 KB
constexpr int kSmemReserved = 1024;   // the runtime's share of each CTA

// bf16: how a D instance lays out its work (64 positions a stage, 16 a warp)
template <int D>
struct MmaGeo {
  static constexpr int kTile = 64;
  static constexpr int kStageBytes = 2 * kTile * D * 2;  // K and V
  static constexpr int kRaw = kRingBytes / kStageBytes;
  static constexpr int kStages = kRaw < 2 ? 2 : (kRaw > 4 ? 4 : kRaw);
  static constexpr int kCpr = D / 8;                      // 16-byte chunks a row
  static constexpr int kRowStep = kThreads / kCpr;        // rows one pass of copies covers
  static constexpr int kCopies = kTile / kRowStep;        // copies a thread makes a tile (K; V too)
  // chunk c of row r lives at chunk c ^ ((r >> kShift) & kMask): the 8 rows an
  // ldmatrix reads land in 8 different 16-byte bank groups
  static constexpr int kShift = kCpr >= 8 ? 0 : (kCpr == 4 ? 1 : 2);
  static constexpr int kMask = (kCpr >= 8 ? 8 : kCpr) - 1;
  static constexpr int kKSteps = D / 16;                  // k steps of Q K^T
  static constexpr int kDTiles = D / 8;                   // n tiles of P V
  static_assert(kTile % kRowStep == 0 && kCopies >= 1, "tile");
};

// float32: how a D instance lays out its work
template <int D>
struct F32Geo {
  static constexpr int kVec = 4;                                // floats a 16-byte copy
  static constexpr int kLpr = D / kVec < 32 ? D / kVec : 32;    // lanes a row
  static constexpr int kRows = 32 / kLpr;                       // rows a warp takes at once
  static constexpr int kEpl = D / kLpr;                         // elements of a row a lane holds
  static constexpr int kNv = kEpl / kVec;                       // its 16-byte vectors
  static constexpr int kRaw = kStageBytes / (2 * D * 4);
  static constexpr int kTile = kRaw < 4 * kRows ? 4 * kRows : (kRaw > 64 ? 64 : kRaw);
  static constexpr int kWarpRows = kTile / kWarps;              // a warp's rows of a tile
  static constexpr int kIters = kWarpRows / kRows;
  static constexpr int kCpr = D / kVec;                         // 16-byte chunks a row
  static constexpr int kRowStep = kThreads / kCpr;
  static constexpr int kCopies = kTile / kRowStep;
  static_assert(kWarpRows % kRows == 0 && kTile % kRowStep == 0 && kCopies >= 1, "tile");
  static_assert(kEpl % kVec == 0 && kIters <= 32, "lanes");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// c += a b: m16n8k16, bf16 operands, float32 accumulators; rows 8-15 of a are 0
__device__ __forceinline__ void mma(float* c, uint32_t a0, uint32_t a2, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}
// (lo, hi) as bf16 (round to nearest) in one register; `rest` gets what they left out
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi, float* rest) {
  const __nv_bfloat16 a = __float2bfloat16_rn(lo), b = __float2bfloat16_rn(hi);
  rest[0] = lo - __bfloat162float(a);
  rest[1] = hi - __bfloat162float(b);
  return (uint32_t)__bfloat16_as_ushort(a) | ((uint32_t)__bfloat16_as_ushort(b) << 16);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// A split's share of a sequence: the tiles [0, tiles) from position `first`,
// and the valid positions [lo, hi) among them (decode_split_ranges).
struct Split {
  int first, tiles, lo, hi;
};
__device__ __forceinline__ Split split_range(int length, int n_max, int has_window, int window,
                                             int tile, int split, int splits) {
  const int n_valid = min(max(length, 0), n_max);
  const int start = has_window ? max(0, length - window) : 0;
  const int t0 = (start / tile) * tile;
  const int n_tiles = n_valid > start ? (n_valid - t0 + tile - 1) / tile : 0;
  const int per = (n_tiles + splits - 1) / splits;
  const int tile_lo = min(split * per, n_tiles);
  Split r;
  r.tiles = min(tile_lo + per, n_tiles) - tile_lo;
  r.first = t0 + tile_lo * tile;
  r.lo = max(start, r.first);
  r.hi = min(n_valid, r.first + r.tiles * tile);
  return r;
}

// Position -> (table entry, offset in the page): shifts for a power-of-two
// block size (16 at the serve pool), a division otherwise.
struct PageSize {
  int size, shift;  // shift -1: not a power of two
  __device__ int entry(int pos) const { return shift >= 0 ? pos >> shift : pos / size; }
  __device__ int offset(int pos) const { return shift >= 0 ? pos & (size - 1) : pos % size; }
};
__device__ __forceinline__ PageSize page_size(int bs) {
  int shift = 0;
  while ((1 << shift) < bs) ++shift;
  return PageSize{bs, (1 << shift) == bs ? shift : -1};
}

// The pages of a thread's rows c_row + j * kRowStep of tile k (-1: no row to
// read). With pages of 4 or more positions a tile spans at most 17 table
// entries: lane e of each warp reads entry e of the tile's span (one request
// a warp, not one a row: the CTAs of one sequence would otherwise queue on
// the same few L2 lines) and the rows take theirs by shuffle. Only entries
// of pages that hold a position of [lo, hi) are read.
template <int kTile, int kRowStep, int kCopies>
__device__ __forceinline__ void tile_pages(const int* table_b, const Split& sp, int k, int c_row,
                                           const PageSize& ps, int* pages) {
  const int base = sp.first + k * kTile;
  const bool live = k < sp.tiles;
  if (ps.size >= 4) {
    const int e0 = ps.entry(base), e = e0 + (threadIdx.x & 31);
    const bool need = live && (e + 1) * ps.size > sp.lo && e * ps.size < sp.hi;
    const int mine = need ? table_b[e] : -1;
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int pos = base + c_row + j * kRowStep;
      const int v = __shfl_sync(0xffffffffu, mine, (ps.entry(pos) - e0) & 31);
      pages[j] = live && pos >= sp.lo && pos < sp.hi ? v : -1;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kCopies; ++j) {
      const int pos = base + c_row + j * kRowStep;
      pages[j] = live && pos >= sp.lo && pos < sp.hi ? table_b[ps.entry(pos)] : -1;
    }
  }
}

// The CTA's end: the warps' (m, l, acc) of `heads` query heads are in shared
// memory (wm, wl: [kWarps][heads]; wacc: [kWarps][heads][D]); merge them in
// warp order, then write the output rows of the `real` heads (out_rows: the
// first one's row), or, with splits > 1, the split's partial, and let the
// unit's last CTA merge the splits in split order.
template <typename T, int D>
__device__ __forceinline__ void finish(const float* wm, const float* wl, const float* wacc,
                                       int heads, int real, T* out_rows, float* partials,
                                       int* counters, int64_t unit, int split, int splits,
                                       int* s_last, float* stage) {
  const int tid = threadIdx.x;
  const int64_t part_stride = (int64_t)heads * (D + 2);  // floats a split of a unit
  float* mine = partials + (unit * splits + split) * part_stride;
  for (int i = tid; i < real * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * heads + g]);
    float A = 0.f, L = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(wm[w * heads + g] - M);
      A += wacc[(w * heads + g) * D + d] * f;
      L += wl[w * heads + g] * f;
    }
    if (splits == 1) {
      out_rows[g * D + d] = from_f<T>(A / fmaxf(L, 1e-30f));
    } else {
      float* p = mine + g * (D + 2);
      p[d] = A;
      if (d == 0) {
        p[D] = M;
        p[D + 1] = L;
      }
    }
  }
  if (splits == 1) return;
  // count the split with release semantics (the CTA's partials, ordered
  // before it by the barrier, are visible first); the last CTA's acquire
  // makes every split's partials visible to it
  __syncthreads();
  if (tid == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
                 : "=r"(old)
                 : "l"(counters + unit)
                 : "memory");
    *s_last = old == (unsigned)splits - 1;
  }
  __syncthreads();
  if (!*s_last) return;
  // the unit's partials (splits x heads x (D + 2) floats, contiguous) into
  // shared memory, 32 loads a thread in flight (the plan caps splits so they
  // fit; the warps' partials there are no longer read), then merged in
  // split order, in one pass
  const float* base = partials + unit * splits * part_stride;
  const int n = splits * (int)part_stride;
  for (int i0 = tid; i0 < n; i0 += 32 * kThreads) {
    float v[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) v[u] = i0 + u * kThreads < n ? __ldcg(base + i0 + u * kThreads) : 0.f;
#pragma unroll
    for (int u = 0; u < 32; ++u)
      if (i0 + u * kThreads < n) stage[i0 + u * kThreads] = v[u];
  }
  __syncthreads();
  for (int i = tid; i < real * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const float* p = stage + g * (D + 2);
    float M = kNegInf, A = 0.f, L = 0.f;
    for (int s = 0; s < splits; ++s) {
      const float* ps = p + s * part_stride;
      const float mn = fmaxf(M, ps[D]);
      const float f = exp2f(M - mn), fs = exp2f(ps[D] - mn);
      A = A * f + ps[d] * fs;
      L = L * f + ps[D + 1] * fs;
      M = mn;
    }
    out_rows[g * D + d] = from_f<T>(A / fmaxf(L, 1e-30f));
  }
  if (tid == 0) counters[unit] = 0;  // every other CTA of the unit has counted
}

// ---------------------------------------------------------------------------
// bf16: tensor cores. grid (splits, Hkv * ceil(group / heads), B), heads =
// min(group, kMmaHeads), kThreads threads, the plan's shared memory.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pool,
    const __nv_bfloat16* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ lengths, __nv_bfloat16* __restrict__ out,
    float* __restrict__ partials, int* __restrict__ counters, int Hq, int Hkv, int n_blocks,
    int block_size, int n_pages, int has_window, int window, int has_softcap, float softcap,
    float scale) {
  using G = MmaGeo<D>;
  constexpr int kTileElems = G::kTile * D;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int s_last;
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);

  const int split = blockIdx.x, splits = gridDim.x;
  const int group = Hq / Hkv;
  const int heads = min(group, kMmaHeads);
  const int chunks = (group + heads - 1) / heads;
  const int h = blockIdx.y / chunks, g0 = (blockIdx.y % chunks) * heads;
  const int real = min(heads, group - g0);
  const int b = blockIdx.z;
  const int64_t unit = ((int64_t)b * Hkv + h) * chunks + blockIdx.y % chunks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, t4 = lane & 3;  // the fragments' row (query head) and column pair

  const Split sp = split_range(lengths[b], n_pages * block_size, has_window, window, G::kTile,
                               split, splits);

  // copies: every thread fetches 16-byte chunk c_col of rows c_row + j * kRowStep
  const int* table_b = table + (int64_t)b * n_pages;
  const PageSize ps = page_size(block_size);
  const int c_col = tid % G::kCpr, c_row = tid / G::kCpr;
  const int64_t head_off = (int64_t)h * D + c_col * 8;
  const int64_t pos_stride = (int64_t)Hkv * D;
  auto pages_of = [&](int k, int* pages) {
    tile_pages<G::kTile, G::kRowStep, G::kCopies>(table_b, sp, k, c_row, ps, pages);
  };
  auto issue = [&](int k, const int* pages) {
    if (k < sp.tiles) {
      __nv_bfloat16* ks = ring + (k % G::kStages) * 2 * kTileElems;
#pragma unroll
      for (int j = 0; j < G::kCopies; ++j) {
        const int r = c_row + j * G::kRowStep;
        const int pos = sp.first + k * G::kTile + r;
        const bool ok = (unsigned)pages[j] < (unsigned)n_blocks;
        const int64_t off =
            ok ? ((int64_t)pages[j] * block_size + ps.offset(pos)) * pos_stride + head_off : 0;
        __nv_bfloat16* dst = ks + (r * G::kCpr + (c_col ^ ((r >> G::kShift) & G::kMask))) * 8;
        cp_async16(dst, k_pool + off, ok ? 16 : 0);
        cp_async16(dst + kTileElems, v_pool + off, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  {
    int pre[G::kStages - 1][G::kCopies];
#pragma unroll
    for (int s = 0; s < G::kStages - 1; ++s) pages_of(s, pre[s]);
#pragma unroll
    for (int s = 0; s < G::kStages - 1; ++s) issue(s, pre[s]);
  }
  int pages[G::kCopies];
  pages_of(G::kStages - 1, pages);

  // A fragments of Q (row gr: query head g0 + gr; zero past the CTA's heads)
  uint32_t qa[G::kKSteps][2];
  {
    const bool mine = sp.tiles > 0 && gr < real;
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        q + ((int64_t)b * Hq + (int64_t)h * group + g0 + (mine ? gr : 0)) * D);
#pragma unroll
    for (int kk = 0; kk < G::kKSteps; ++kk) {
      qa[kk][0] = mine ? qr[8 * kk + t4] : 0u;
      qa[kk][1] = mine ? qr[8 * kk + 4 + t4] : 0u;
    }
  }
  float acc[G::kDTiles][4];
#pragma unroll
  for (int j = 0; j < G::kDTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m = kNegInf, l = 0.f;

  // ldmatrix rows: K (x4 = b0, b1 of position tiles 0 and 1), V (x4.trans =
  // b0, b1 of d tiles j and j + 1)
  const int k_row = warp * 16 + ((lane >> 4) << 3) + (lane & 7), k_chunk = (lane >> 3) & 1;
  const int v_row = warp * 16 + (((lane >> 3) & 1) << 3) + (lane & 7), v_chunk = lane >> 4;

  for (int k = 0; k < sp.tiles; ++k) {
    cp_async_wait<G::kStages - 2>();
    __syncthreads();  // tile k has landed; every warp is done with tile k - 1's stage
    issue(k + G::kStages - 1, pages);
    pages_of(k + G::kStages, pages);

    const uint32_t kb = smem_addr(ring + (k % G::kStages) * 2 * kTileElems);
    const uint32_t vb = kb + kTileElems * 2;
    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < G::kKSteps; ++kk) {
      const int c = 2 * kk + k_chunk;
      uint32_t bk[4];
      ldsm_x4(bk, kb + (k_row * G::kCpr + (c ^ ((k_row >> G::kShift) & G::kMask))) * 16);
      mma(s[0], qa[kk][0], qa[kk][1], bk[0], bk[1]);
      mma(s[1], qa[kk][0], qa[kk][1], bk[2], bk[3]);
    }
    // scores of head gr at positions 8n + 2 t4 + e of the warp's 16
    const int pos0 = sp.first + k * G::kTile + warp * 16 + 2 * t4;
    float sv[2][2];
    float mt = kNegInf;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = pos0 + 8 * n + e;
        float x = s[n][e] * scale;
        if (has_softcap) x = softcap * tanhf(x / softcap);
        sv[n][e] = (pos >= sp.lo && pos < sp.hi) ? x * kLog2e : kNegInf;
        mt = fmaxf(mt, sv[n][e]);
      }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float mn = fmaxf(m, mt);
    const float alpha = exp2f(m - mn);
    m = mn;
    l *= alpha;
#pragma unroll
    for (int j = 0; j < G::kDTiles; ++j) {
      acc[j][0] *= alpha;
      acc[j][1] *= alpha;
    }
    float p[2][2], rest[2][2];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[n][e] = sv[n][e] > kNegInf ? exp2f(sv[n][e] - mn) : 0.f;
        l += p[n][e];
      }
    // P as hi + lo bf16: the A operand of P V straight from the score fragments
    const uint32_t hi0 = pack_bf16(p[0][0], p[0][1], rest[0]);
    const uint32_t hi1 = pack_bf16(p[1][0], p[1][1], rest[1]);
    float unused[2];
    const uint32_t lo0 = pack_bf16(rest[0][0], rest[0][1], unused);
    const uint32_t lo1 = pack_bf16(rest[1][0], rest[1][1], unused);
#pragma unroll
    for (int j = 0; j < G::kDTiles; j += 2) {
      const int c = j + v_chunk;
      uint32_t bv[4];
      ldsm_x4_t(bv, vb + (v_row * G::kCpr + (c ^ ((v_row >> G::kShift) & G::kMask))) * 16);
      mma(acc[j], hi0, hi1, bv[0], bv[1]);
      mma(acc[j], lo0, lo1, bv[0], bv[1]);
      mma(acc[j + 1], hi0, hi1, bv[2], bv[3]);
      mma(acc[j + 1], lo0, lo1, bv[2], bv[3]);
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' partials go there
  float* wm = reinterpret_cast<float*>(smem);  // [kWarps][heads]
  float* wl = wm + kWarps * heads;              // [kWarps][heads]
  float* wacc = wl + kWarps * heads;            // [kWarps][heads][D]
  if (gr < heads) {
    if (t4 == 0) {
      wm[warp * heads + gr] = m;
      wl[warp * heads + gr] = l;
    }
#pragma unroll
    for (int j = 0; j < G::kDTiles; ++j) {
      float* dst = wacc + (warp * heads + gr) * D + 8 * j + 2 * t4;
      dst[0] = acc[j][0];
      dst[1] = acc[j][1];
    }
  }
  __syncthreads();
  finish<__nv_bfloat16, D>(wm, wl, wacc, heads, real,
                           out + ((int64_t)b * Hq + (int64_t)h * group + g0) * D, partials,
                           counters, unit, split, splits, &s_last, wm);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores. grid (splits, Hkv * ceil(group / GB), B), kThreads
// threads, the plan's shared memory.
// ---------------------------------------------------------------------------
template <int D, int GB>
__global__ void __launch_bounds__(kThreads, kMinBlocks) flash_decode_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pool,
    const float* __restrict__ v_pool, const int* __restrict__ table,
    const int* __restrict__ lengths, float* __restrict__ out, float* __restrict__ partials,
    int* __restrict__ counters, int Hq, int Hkv, int n_blocks, int block_size, int n_pages,
    int has_window, int window, int has_softcap, float softcap, float scale) {
  using G = F32Geo<D>;
  constexpr int kTileElems = G::kTile * D;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_last;
  float* ring = reinterpret_cast<float*>(smem);

  const int split = blockIdx.x, splits = gridDim.x;
  const int group = Hq / Hkv;
  const int chunks = (group + GB - 1) / GB;
  const int h = blockIdx.y / chunks, g0 = (blockIdx.y % chunks) * GB;
  const int real = min(GB, group - g0);
  const int b = blockIdx.z;
  const int64_t unit = ((int64_t)b * Hkv + h) * chunks + blockIdx.y % chunks;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = lane / G::kLpr, li = lane % G::kLpr;

  const Split sp = split_range(lengths[b], n_pages * block_size, has_window, window, G::kTile,
                               split, splits);

  const int* table_b = table + (int64_t)b * n_pages;
  const PageSize ps = page_size(block_size);
  const int c_col = tid % G::kCpr, c_row = tid / G::kCpr;
  const int64_t head_off = (int64_t)h * D + c_col * G::kVec;
  const int64_t pos_stride = (int64_t)Hkv * D;
  auto pages_of = [&](int k, int* pages) {
    tile_pages<G::kTile, G::kRowStep, G::kCopies>(table_b, sp, k, c_row, ps, pages);
  };
  auto issue = [&](int k, const int* pages) {
    if (k < sp.tiles) {
      float* ks = ring + (k % kStages) * 2 * kTileElems;
#pragma unroll
      for (int j = 0; j < G::kCopies; ++j) {
        const int r = c_row + j * G::kRowStep;
        const int pos = sp.first + k * G::kTile + r;
        const bool ok = (unsigned)pages[j] < (unsigned)n_blocks;
        const int64_t off =
            ok ? ((int64_t)pages[j] * block_size + ps.offset(pos)) * pos_stride + head_off : 0;
        float* dst = ks + r * D + c_col * G::kVec;
        cp_async16(dst, k_pool + off, ok ? 16 : 0);
        cp_async16(dst + kTileElems, v_pool + off, ok ? 16 : 0);
      }
    }
    cp_async_commit();
  };
  {
    int pre[kStages - 1][G::kCopies];
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) pages_of(s, pre[s]);
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) issue(s, pre[s]);
  }
  int pages[G::kCopies];
  pages_of(kStages - 1, pages);

  // the lane's slice of the heads' query rows, pre-scaled (zeros past them)
  float qr[GB][G::kEpl], acc[GB][G::kEpl], m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
    const bool mine = sp.tiles > 0 && g < real;
    const float* qg = q + ((int64_t)b * Hq + (int64_t)h * group + g0 + (mine ? g : 0)) * D;
#pragma unroll
    for (int jv = 0; jv < G::kNv; ++jv) {
      const float4 v = mine ? *reinterpret_cast<const float4*>(qg + (li + G::kLpr * jv) * 4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
      const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qr[g][jv * 4 + e] = x[e] * scale;
        acc[g][jv * 4 + e] = 0.f;
      }
    }
  }

  for (int k = 0; k < sp.tiles; ++k) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(k + kStages - 1, pages);
    pages_of(k + kStages, pages);

    const float* ks = ring + (k % kStages) * 2 * kTileElems;
    const float* vs = ks + kTileElems;
    const int row0 = warp * G::kWarpRows + rg;
    const int pos0 = sp.first + k * G::kTile + row0;
    float sv[G::kIters][GB];
    unsigned valid = 0;
#pragma unroll
    for (int it = 0; it < G::kIters; ++it) {
      const float* kr = ks + (row0 + it * G::kRows) * D;
      float part[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) part[g] = 0.f;
#pragma unroll
      for (int jv = 0; jv < G::kNv; ++jv) {
        const float4 v = *reinterpret_cast<const float4*>(kr + (li + G::kLpr * jv) * 4);
        const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[g] = fmaf(qr[g][jv * 4 + e], x[e], part[g]);
      }
#pragma unroll
      for (int off = G::kLpr / 2; off > 0; off >>= 1)
#pragma unroll
        for (int g = 0; g < GB; ++g) part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      const int pos = pos0 + it * G::kRows;
      const bool ok = pos >= sp.lo && pos < sp.hi;
      valid |= (unsigned)ok << it;
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float x = part[g];
        if (has_softcap) x = softcap * tanhf(x / softcap);
        sv[it][g] = ok ? x * kLog2e : kNegInf;
      }
    }
    // online softmax over the lane group's rows
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mt = kNegInf;
#pragma unroll
      for (int it = 0; it < G::kIters; ++it) mt = fmaxf(mt, sv[it][g]);
      const float mn = fmaxf(m[g], mt);
      const float a = exp2f(m[g] - mn);
      m[g] = mn;
      l[g] *= a;
#pragma unroll
      for (int e = 0; e < G::kEpl; ++e) acc[g][e] *= a;
    }
#pragma unroll
    for (int it = 0; it < G::kIters; ++it) {
      if (!((valid >> it) & 1u)) continue;
      const float* vr = vs + (row0 + it * G::kRows) * D;
      float p[GB];
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        p[g] = exp2f(sv[it][g] - m[g]);
        l[g] += p[g];
      }
#pragma unroll
      for (int jv = 0; jv < G::kNv; ++jv) {
        const float4 v = *reinterpret_cast<const float4*>(vr + (li + G::kLpr * jv) * 4);
        const float x[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int g = 0; g < GB; ++g)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][jv * 4 + e] = fmaf(p[g], x[e], acc[g][jv * 4 + e]);
      }
    }
  }

  // merge the warp's lane groups (lanes kLpr apart, then 2 kLpr, ...)
#pragma unroll
  for (int off = G::kLpr; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mn = fmaxf(m[g], mo);
      const float a = exp2f(m[g] - mn), c = exp2f(mo - mn);
      l[g] = l[g] * a + lo * c;
#pragma unroll
      for (int e = 0; e < G::kEpl; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * a + ao * c;
      }
      m[g] = mn;
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the warps' partials go there
  float* wm = reinterpret_cast<float*>(smem);  // [kWarps][GB]
  float* wl = wm + kWarps * GB;                 // [kWarps][GB]
  float* wacc = wl + kWarps * GB;               // [kWarps][GB][D]
  if (rg == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      if (li == 0) {
        wm[warp * GB + g] = m[g];
        wl[warp * GB + g] = l[g];
      }
#pragma unroll
      for (int jv = 0; jv < G::kNv; ++jv)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          wacc[(warp * GB + g) * D + (li + G::kLpr * jv) * 4 + e] = acc[g][jv * 4 + e];
    }
  }
  __syncthreads();
  finish<float, D>(wm, wl, wacc, GB, real, out + ((int64_t)b * Hq + (int64_t)h * group + g0) * D,
                   partials, counters, unit, split, splits, &s_last, wm);
}

// ---------------------------------------------------------------------------
// host: the plan (kernels/decode_attention.py decode_plan computes the same)
// and the launchers
// ---------------------------------------------------------------------------

// Makes `device` current; a call on the current device sets nothing.
inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

struct Plan {
  int heads, tile, smem, per_sm;
};

inline int merge_bytes(int heads, int D) { return kWarps * heads * (D + 2) * (int)sizeof(float); }

template <int D>
Plan mma_plan(int group) {
  using G = MmaGeo<D>;
  Plan p;
  p.heads = group < kMmaHeads ? group : kMmaHeads;
  p.tile = G::kTile;
  const int ring = G::kStages * G::kStageBytes;
  p.smem = ring > merge_bytes(p.heads, D) ? ring : merge_bytes(p.heads, D);
  p.per_sm = kSmemPerSM / (p.smem + kSmemReserved);
  p.per_sm = p.per_sm < kMmaMaxBlocks ? p.per_sm : kMmaMaxBlocks;
  return p;
}

template <int D>
Plan f32_plan(int group) {
  using G = F32Geo<D>;
  Plan p;
  p.heads = group >= 3 ? 4 : group;
  p.tile = G::kTile;
  const int ring = kStages * 2 * G::kTile * D * (int)sizeof(float);
  p.smem = ring > merge_bytes(p.heads, D) ? ring : merge_bytes(p.heads, D);
  p.per_sm = kSmemPerSM / (p.smem + kSmemReserved);
  p.per_sm = p.per_sm < kMinBlocks ? p.per_sm : kMinBlocks;
  return p;
}

// splits: fill at most one resident wave; 1 when the units already do
inline int plan_splits(const Plan& p, int D, int B, int Hkv, int group, int n_pages,
                       int block_size, int sms) {
  const int64_t resident = (int64_t)p.per_sm * sms;
  const int64_t units = (int64_t)B * Hkv * ((group + p.heads - 1) / p.heads);
  int64_t most = (int64_t)n_pages * block_size / p.tile;
  most = most < kMaxSplits ? most : kMaxSplits;
  const int64_t held = p.smem / (p.heads * (D + 2) * (int)sizeof(float));  // splits the merge stages
  most = most < held ? most : held;
  most = most > 1 ? most : 1;
  if (units >= resident) return 1;
  const int64_t fit = resident / units;
  return (int)(fit < most ? fit : most);
}

template <typename K>
cudaError_t allow_smem(K kernel, int device, int smem, int* set) {
  if (device < 0 || device >= 16) return cudaErrorInvalidDevice;
  if (set[device] >= smem) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) set[device] = smem;
  return err;
}

struct Args {
  const int* table;
  const int* lengths;
  float* partials;
  int* counters;
  int B, Hq, Hkv, n_blocks, block_size, n_pages, has_window, window, has_softcap;
  float softcap, scale;
  int splits, smem, sms, device;
  cudaStream_t stream;
};

inline bool plan_refused(const Plan& p, int D, const Args& a) {
  const int group = a.Hq / a.Hkv;
  return a.smem != p.smem || a.smem > kSmemPerBlock ||
         a.splits != plan_splits(p, D, a.B, a.Hkv, group, a.n_pages, a.block_size, a.sms) ||
         (a.splits > 1 && (a.partials == nullptr || a.counters == nullptr)) ||
         (int64_t)a.Hkv * ((group + p.heads - 1) / p.heads) > 65535;
}

template <int D>
int launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k_pool,
                const __nv_bfloat16* v_pool, __nv_bfloat16* out, const Args& a) {
  const Plan p = mma_plan<D>(a.Hq / a.Hkv);
  if (plan_refused(p, D, a)) return (int)cudaErrorInvalidValue;
  static int set[16] = {};
  cudaError_t err = allow_smem(flash_decode_kernel<D>, a.device, a.smem, set);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (a.Hq / a.Hkv + p.heads - 1) / p.heads;
  flash_decode_kernel<D><<<dim3(a.splits, a.Hkv * chunks, a.B), kThreads, a.smem, a.stream>>>(
      q, k_pool, v_pool, a.table, a.lengths, out, a.partials, a.counters, a.Hq, a.Hkv,
      a.n_blocks, a.block_size, a.n_pages, a.has_window, a.window, a.has_softcap, a.softcap,
      a.scale);
  return (int)cudaGetLastError();
}

template <int D, int GB>
int launch_f32_g(const float* q, const float* k_pool, const float* v_pool, float* out,
                 const Args& a) {
  static int set[16] = {};
  cudaError_t err = allow_smem(flash_decode_f32_kernel<D, GB>, a.device, a.smem, set);
  if (err != cudaSuccess) return (int)err;
  const int chunks = (a.Hq / a.Hkv + GB - 1) / GB;
  flash_decode_f32_kernel<D, GB><<<dim3(a.splits, a.Hkv * chunks, a.B), kThreads, a.smem,
                                    a.stream>>>(
      q, k_pool, v_pool, a.table, a.lengths, out, a.partials, a.counters, a.Hq, a.Hkv,
      a.n_blocks, a.block_size, a.n_pages, a.has_window, a.window, a.has_softcap, a.softcap,
      a.scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const float* q, const float* k_pool, const float* v_pool, float* out,
               const Args& a) {
  const Plan p = f32_plan<D>(a.Hq / a.Hkv);
  if (plan_refused(p, D, a)) return (int)cudaErrorInvalidValue;
  switch (p.heads) {
    case 1: return launch_f32_g<D, 1>(q, k_pool, v_pool, out, a);
    case 2: return launch_f32_g<D, 2>(q, k_pool, v_pool, out, a);
    case 4: return launch_f32_g<D, 4>(q, k_pool, v_pool, out, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch(const void* q, const void* k_pool, const void* v_pool, void* out, int D,
           const Args& a) {
  cudaError_t err = use_device(a.device);
  if (err != cudaSuccess) return (int)err;
  if (a.B <= 0 || a.B > 65535 || a.Hkv <= 0 || a.Hq % a.Hkv != 0 || a.block_size <= 0 ||
      a.n_pages < 0)
    return (int)cudaErrorInvalidValue;
#define DECODE_CASE(DD)                                                                   \
  case DD:                                                                                \
    if constexpr (sizeof(T) == 2)                                                         \
      return launch_bf16<DD>((const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,       \
                             (const __nv_bfloat16*)v_pool, (__nv_bfloat16*)out, a);       \
    else                                                                                  \
      return launch_f32<DD>((const float*)q, (const float*)k_pool, (const float*)v_pool, \
                            (float*)out, a);
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

#define DECODE_ENTRY(NAME, T)                                                             \
  int NAME(const void* q, const void* k_pool, const void* v_pool, const int* table,       \
           const int* lengths, void* out, void* partials, void* counters, int B, int Hq,  \
           int Hkv, int D, int n_blocks, int block_size, int n_pages, int has_window,     \
           int window, int has_softcap, float softcap, float scale, int splits, int smem, \
           int sms, int device, void* stream) {                                           \
    const Args a{table,      lengths,    (float*)partials, (int*)counters,               \
                 B,          Hq,         Hkv,              n_blocks,                     \
                 block_size, n_pages,    has_window,       window,                       \
                 has_softcap, softcap,   scale,            splits,                       \
                 smem,       sms,        device,           (cudaStream_t)stream};        \
    return launch<T>(q, k_pool, v_pool, out, D, a);                                       \
  }

DECODE_ENTRY(decode_attention_bf16, __nv_bfloat16)
DECODE_ENTRY(decode_attention_f32, float)
#undef DECODE_ENTRY

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
