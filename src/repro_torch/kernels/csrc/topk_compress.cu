// Hand-written Hopper kernel for block-local top-k magnitude selection.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/topk_compress.py
// (block_topk / _topk_kernel): for every row of x (nb, block) float32, the
// k entries of largest |x|, as vals (nb, k) float32 and row-local indices
// idx (nb, k) int32, in descending |x| and, among equal magnitudes, the
// lower index first (the Pallas body's first-occurrence argmax). Every NaN
// ranks equal, above +inf, so NaNs too come in index order; -0.0 equals
// 0.0. The output equals the plain version's (kernels/ref.block_topk_ref)
// bit for bit, for any 1 <= k <= min(block, K_MAX).
//
// What bounds it on an H100: bytes. A call reads nb * block * 4 bytes and
// writes nb * k * 8; at the gossip step's embedding leaf (2 pods x 144,000
// rows of 4,096, k = 40) that is 4.81 GB, 1.44 ms at 3.35 TB/s. The TPU
// kernel's k rounds of argmax are k passes over the row; here a row costs
// one read of device memory and a few passes over shared memory.
//
// Design. One CTA of 128 threads (4 warps) selects one row at a time;
// the CTAs are persistent and walk the rows with a stride of the grid.
//  * Key. Each element is ranked by a 32-bit key: |x|'s bits (x & 0x7fffffff),
//    every NaN mapped to kNanKey, one above +inf. The index breaks ties only
//    at the boundary; no 64-bit key is compared on the row.
//  * Staging ("staged" variant). Each row is copied into shared memory with
//    cp.async (16 B a copy when rows are 16-byte aligned, else 4 B) through a
//    ring of 1-3 stages. Device memory is read once; every later pass reads
//    shared memory. At the gossip shape one stage and 9 CTAs an SM beat
//    2 stages and 5-6 CTAs (the other CTAs' loads cover a CTA's wait; the
//    plan takes the most CTAs an SM). Rows too long to stage ("stream"
//    variant, 8 warps a CTA) are read from device memory in every pass.
//  * Select: radix select over the key's digits, most significant first:
//    bits 30..23 (the exponent), 22..15, 14..7, 6..0. Each warp owns a
//    contiguous quarter of the row. The split pass takes one digit g for the
//    first digit's boundary: entries of larger digits go to the selection
//    buffer, entries of digit g to the warp's candidate list in index order
//    (a lane's counts in one int, ranked by one warp scan), their second
//    digit into a histogram. g is the previous row's boundary digit; the
//    pass's counts tell whether it was right (above < k <= above +
//    count(g), every list within its capacity). If not (and for a CTA's
//    first row), pass 1 builds the first digit's histogram (one packed
//    sub-histogram a warp, shared atomic adds), a suffix scan finds the
//    boundary digit, and the split pass runs with it. So a row whose
//    boundary digit is its predecessor's, as nearly every row of the
//    gossip step's, costs one pass over shared memory. Later digits
//    histogram only the candidates (or, if a list would overflow, the row
//    again, filtered by the digits found so far). The select stops at a
//    digit whose bin is taken whole, once the bin's entries all have one
//    magnitude, or after the last digit; the boundary is then one key B with
//    m of its entries still to take.
//  * Tie cut. The entries above B are taken, and of the entries equal to B
//    the m of lowest index: each warp counts its entries equal to B, and
//    its ballots rank them in index order after the earlier warps' counts.
//    Membership is decided by keys and ranks alone. An atomic counter only
//    hands out slots in the selection buffer, whose order the sort below
//    fixes (it sorts by the unique (key, index)), so the output is
//    repeatable bit for bit.
//  * Order. The k selected entries are sorted by (key descending, index
//    ascending): for k <= 64 by a bitonic sort in one warp's registers, above
//    that by a CTA-wide bitonic sort in shared memory (up to K_MAX entries).
//    vals take x's own bits (NaN payloads and signs kept).
//
// The host-side plan (kernels/topk_compress.topk_plan) picks the stages
// (0: the stream variant), candidate capacity, shared memory and grid;
// make_layout below is the same arithmetic, and the launcher refuses a plan
// whose shared memory differs from it.
//
// Plain C entry point (bound with ctypes by kernels/_build.py). It launches
// on the given stream, allocates nothing, does not synchronise, and returns
// cudaGetLastError() right after its launch.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kNanKey = 0x7f800001;  // every NaN: one key above +inf (0x7f800000)
constexpr int kBins = 256;
constexpr int kScalars = 64;         // ints of per-row scalars in shared memory
constexpr int kKMax = 16384;         // the largest k (sorted in shared memory)
constexpr int kSlab = 128;           // elements a warp reads a step: 32 lanes x float4

// per-row scalars (indices into sc[])
constexpr int S_D = 0, S_ABOVE = 1, S_CNT = 2, S_NSEL = 3, S_KMIN = 4, S_KMAX = 5;
constexpr int S_LCNT = 8, S_WCNT = 16, S_WSUM = 24;

// digit levels, most significant first: bits 30..23, 22..15, 14..7, 6..0
__host__ __device__ constexpr int level_shift(int L) {
  return L == 0 ? 23 : L == 1 ? 15 : L == 2 ? 7 : 0;
}
__host__ __device__ constexpr int level_width(int L) { return L == 3 ? 7 : 8; }

// the sort buffer's length for k: 64 (one warp's registers) or a power of two
__host__ __device__ inline int sort_len(int k) {
  int p = 64;
  while (p < k) p <<= 1;
  return p;
}

// a CTA's warps: 4 for a staged row (stages 1-3), 8 for a streamed one (0)
__host__ __device__ constexpr int warps_of(int stages) { return stages > 0 ? 4 : 8; }

// ints of the histogram region: NW sub-histograms of 256 bins, two 16-bit
// counters an int when packed (staged rows: a warp's part of a row holds
// fewer than 65,536 entries), and at least 256 ints (the later digits'
// one 32-bit histogram)
__host__ __device__ inline int hist_ints(bool pack, int warps) {
  return pack ? (warps * kBins / 2 > kBins ? warps * kBins / 2 : kBins) : warps * kBins;
}

struct Layout {
  size_t stage, hist, hist1, cand, selk, seli, scal, total;
  int row_floats;  // a staged row, padded to whole float4s
};

// byte offsets of the dynamic shared memory (kernels/topk_compress.topk_smem)
__host__ __device__ inline Layout make_layout(int block, int stages, int warps, int cap,
                                              int P) {
  Layout l;
  l.row_floats = (block + 3) & ~3;
  size_t o = 0;
  l.stage = o;
  o += (size_t)stages * l.row_floats * 4;
  l.hist = o;
  o += (size_t)hist_ints(stages > 0, warps) * 4;
  l.hist1 = o;
  o += kBins * 4;
  l.cand = o;
  o += ((size_t)cap * (stages > 0 ? 2 : 4) + 15) & ~(size_t)15;
  l.selk = o;
  o += (size_t)P * 4;
  l.seli = o;
  o += (size_t)P * 4;
  l.scal = o;
  o += kScalars * 4;
  l.total = o;
  return l;
}

__device__ __forceinline__ int key_of(float v) {
  const unsigned b = __float_as_uint(v) & 0x7fffffffu;
  return b > 0x7f800000u ? kNanKey : (int)b;
}

// Warp w's first-digit counter of digit d: packed, digits d and d + 128
// share an int (16 bits each; the two are rarely both populated, so the
// busiest digits keep their own words).
template <bool PACK>
__device__ __forceinline__ void hist_add(int* hist, int w, int d, unsigned n) {
  if (PACK)
    atomicAdd(reinterpret_cast<unsigned*>(hist) + w * (kBins / 2) + (d & 127),
              n << ((d >> 7) << 4));
  else
    atomicAdd(&hist[w * kBins + d], (int)n);
}

template <bool PACK>
__device__ __forceinline__ int hist_get(const int* hist, int w, int d) {
  if (PACK)
    return (int)((reinterpret_cast<const unsigned*>(hist)[w * (kBins / 2) + (d & 127)] >>
                  ((d >> 7) << 4)) & 0xffffu);
  return hist[w * kBins + d];
}

// a before b in the output: larger key, then lower index
__device__ __forceinline__ bool better(int ka, int ia, int kb, int ib) {
  return ka > kb || (ka == kb && ia < ib);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a row staged in shared memory (16-byte aligned, padded to whole float4s)
struct SmemRow {
  const float* s;
  __device__ __forceinline__ float4 load4(int p) const {
    return *reinterpret_cast<const float4*>(s + p);
  }
  __device__ __forceinline__ float at(int i) const { return s[i]; }
};

// a row read from device memory; vec: 16-byte aligned and block % 4 == 0
struct GlobalRow {
  const float* g;
  int n;
  bool vec;
  __device__ __forceinline__ float4 load4(int p) const {
    if (vec) return __ldg(reinterpret_cast<const float4*>(g + p));
    float4 r;
    r.x = __ldg(g + p);
    r.y = p + 1 < n ? __ldg(g + p + 1) : 0.f;
    r.z = p + 2 < n ? __ldg(g + p + 2) : 0.f;
    r.w = p + 3 < n ? __ldg(g + p + 3) : 0.f;
    return r;
  }
  __device__ __forceinline__ float at(int i) const { return __ldg(g + i); }
};

// the keys of the 4 elements at p..p+3; -1 past the row's end
template <class Row>
__device__ __forceinline__ void keys4(const Row& row, int p, int block, int (&key)[4]) {
  const float4 f = row.load4(p);
  const float e[4] = {f.x, f.y, f.z, f.w};
  if (p + 4 <= block) {
#pragma unroll
    for (int j = 0; j < 4; ++j) key[j] = key_of(e[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) key[j] = p + j < block ? key_of(e[j]) : -1;
  }
}

// The first digits of the 4 elements at p..p+3 (-1 past the row's end), and
// the elements: the first digit of key_of(v) is (bits(v) >> 23) & 0xff, NaN
// or not (every NaN's |x| bits lie above +inf's, whose digit is 255 too).
template <class Row>
__device__ __forceinline__ void digits4(const Row& row, int p, int block, int (&dg)[4],
                                        float (&e)[4]) {
  const float4 f = row.load4(p);
  e[0] = f.x;
  e[1] = f.y;
  e[2] = f.z;
  e[3] = f.w;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    dg[j] = (int)((__float_as_uint(e[j]) >> 23) & 0xffu);
    if (p + 4 > block && p + j >= block) dg[j] = -1;
  }
}

__device__ __forceinline__ float pick4(const float (&e)[4], int j) {
  return j == 0 ? e[0] : j == 1 ? e[1] : j == 2 ? e[2] : e[3];
}

// lanes below this one
__device__ __forceinline__ unsigned lanes_below(int lane) { return (1u << lane) - 1u; }

// For flags f[j] of the 4 elements of each lane's float4 (element 4 lane + j
// of the warp's slab), b[j] = ballot(f[j]): the set flags before this
// lane's in (lane, j) order, and the slab's total.
__device__ __forceinline__ int slab_before(const unsigned (&b)[4], int lane, int* total) {
  const unsigned lt = lanes_below(lane);
  int before = 0, tot = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    before += __popc(b[j] & lt);
    tot += __popc(b[j]);
  }
  *total = tot;
  return before;
}

// n slots of the selection buffer for this warp (lane 0 takes them)
__device__ __forceinline__ int warp_slots(int n, int* counter, int lane) {
  int base = 0;
  if (lane == 0 && n) base = atomicAdd(counter, n);
  return __shfl_sync(0xffffffffu, base, 0);
}

// Finds the digit d of the histogram(s) with above < need <= above + cnt,
// above the count of the digits above d (cnt(d) summed over nh histograms
// of kBins). Writes d, above and cnt to sc, and each histogram's cnt(d)
// (a warp's candidates in bin d) to sc[S_LCNT + h]. Ends with a barrier.
template <int NW, bool PACK>
__device__ void find_digit(const int* hist, int nh, int need, int* sc) {
  constexpr int T = 32 * NW;
  constexpr int PER = kBins / T;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int c[PER];
  int sum = 0;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int d = kBins - 1 - (t * PER + j);
    int s = 0;
    for (int h = 0; h < nh; ++h) s += hist_get<PACK>(hist, h, d);
    c[j] = s;
    sum += s;
  }
  int inc = sum;  // inclusive scan in thread order (digits descending)
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += o;
  }
  if (NW > 1) {
    if (lane == 31) sc[S_WSUM + warp] = inc;
    __syncthreads();
    for (int w = 0; w < warp; ++w) inc += sc[S_WSUM + w];
  }
  int run = inc - sum;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    if (run < need && run + c[j] >= need) {
      const int d = kBins - 1 - (t * PER + j);
      sc[S_D] = d;
      sc[S_ABOVE] = run;
      sc[S_CNT] = c[j];
      for (int h = 0; h < nh; ++h) sc[S_LCNT + h] = hist_get<PACK>(hist, h, d);
    }
    run += c[j];
  }
  __syncthreads();
}

// Bitonic sort of one warp's 32 R entries (position r * 32 + lane) into
// descending (key, -index) order.
template <int R>
__device__ __forceinline__ void warp_bitonic(int (&key)[R], int (&id)[R], int lane) {
  constexpr int N = 32 * R;
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      if (j >= 32) {
        const int rj = j >> 5;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r & rj) continue;
          const int q = r | rj;  // the partner, at the higher position
          const bool desc = ((r * 32 + lane) & size) == 0;
          const bool sw = desc ? better(key[q], id[q], key[r], id[r])
                               : better(key[r], id[r], key[q], id[q]);
          if (sw) {
            const int tk = key[r], ti = id[r];
            key[r] = key[q];
            id[r] = id[q];
            key[q] = tk;
            id[q] = ti;
          }
        }
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int ok = __shfl_xor_sync(0xffffffffu, key[r], j);
          const int oi = __shfl_xor_sync(0xffffffffu, id[r], j);
          const bool lower = (lane & j) == 0;
          const bool desc = ((r * 32 + lane) & size) == 0;
          const bool keep_better = lower == desc;
          if (keep_better != better(key[r], id[r], ok, oi)) {
            key[r] = ok;
            id[r] = oi;
          }
        }
      }
    }
  }
}

// CTA-wide bitonic sort of P (a power of two) entries in shared memory into
// descending (key, -index) order. Ends with a barrier.
template <int NW>
__device__ void cta_bitonic(int* key, int* id, int P) {
  constexpr int T = 32 * NW;
  for (int size = 2; size <= P; size <<= 1) {
    for (int j = size >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < P / 2; i += T) {
        const int lo = 2 * i - (i & (j - 1));  // i with a 0 inserted at j's bit
        const int hi = lo + j;
        const bool desc = (lo & size) == 0;
        const int kl = key[lo], il = id[lo], kh = key[hi], ih = id[hi];
        const bool sw = desc ? better(kh, ih, kl, il) : better(kl, il, kh, ih);
        if (sw) {
          key[lo] = kh;
          id[lo] = ih;
          key[hi] = kl;
          id[hi] = il;
        }
      }
      __syncthreads();
    }
  }
}

struct Smem {
  int* hist;   // NW sub-histograms of kBins (the first digit), or one (later digits)
  int* hist1;  // the second digit of the first digit's boundary bin
  void* cand;  // candidate indices, in index order: uint16 (staged rows) or int
  int* selk;  // selection buffer: keys
  int* seli;  //                   indices
  int* sc;    // per-row scalars
};

// The split by first digit g, one pass over this warp's part of the row:
// entries of larger digits go to the selection buffer; entries of digit g
// to this warp's candidate list (cand[warp capw ...], index order), counted
// in sc[S_LCNT + warp] even past the list's capacity, and their second
// digit into hist1, their smallest and largest key into sc[S_KMIN],
// sc[S_KMAX]. A lane's flags are counted in one int (candidates in the low
// half, larger digits in the high half), and one warp scan ranks both.
// Ends with a barrier.
template <int NW, class Idx, class Row>
__device__ void split_pass(const Row& row, int block, int g, int capw, int P, const Smem& m,
                           int w_lo, int w_hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* const sc = m.sc;
  Idx* const list = static_cast<Idx*>(m.cand) + warp * capw;
  int run = 0, lo = INT_MAX, hi = -1;
  for (int p0 = w_lo; p0 < w_hi; p0 += kSlab) {
    const int p = p0 + 4 * lane;
    int dg[4] = {-1, -1, -1, -1};
    float e[4];
    if (p < block) digits4(row, p, block, dg, e);
    unsigned cm = 0, sm = 0;  // this lane's candidates and larger digits, bit j
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      cm |= (unsigned)(dg[j] == g) << j;
      sm |= (unsigned)(dg[j] > g) << j;
    }
    const int mine = __popc(cm) | __popc(sm) << 16;
    int inc = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(0xffffffffu, inc, off);
      if (lane >= off) inc += o;
    }
    const int tot = __shfl_sync(0xffffffffu, inc, 31);
    const int before = inc - mine;
    int at_c = run + (before & 0xffff);
    int at_s = before >> 16;
    if (tot >> 16) at_s += warp_slots(tot >> 16, &sc[S_NSEL], lane);
    for (unsigned b = cm; b; b &= b - 1) {
      const int j = __ffs(b) - 1;
      const int key = key_of(pick4(e, j));
      if (at_c < capw) list[at_c] = (Idx)(p + j);
      ++at_c;
      atomicAdd(&m.hist1[(key >> 15) & 0xff], 1);
      lo = min(lo, key);
      hi = max(hi, key);
    }
    for (unsigned b = sm; b; b &= b - 1) {
      const int j = __ffs(b) - 1;
      if (at_s < P) {
        m.selk[at_s] = key_of(pick4(e, j));
        m.seli[at_s] = p + j;
      }
      ++at_s;
    }
    run += tot & 0xffff;
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    sc[S_LCNT + warp] = run;
    atomicMin(&sc[S_KMIN], lo);
    atomicMax(&sc[S_KMAX], hi);
  }
  __syncthreads();
}

// Selects, orders and writes the top k of one row. Every thread of the
// CTA calls it; it begins after and ends with a barrier, with sc[S_NSEL]
// 0. `guess` carries the boundary digit from row to row.
template <int NW, bool PACK, class Row>
__device__ void select_row(const Row& row, int block, int k, int cap, int P, const Smem& m,
                           float* vals_r, int* idx_r, int& guess) {
  constexpr int T = 32 * NW;
  // staged rows (PACK) hold fewer than 65,536 entries: 16-bit candidate indices
  typedef typename std::conditional<PACK, unsigned short, int>::type Idx;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int* const hist = m.hist;
  int* const sc = m.sc;
  // each warp owns [warp C, warp C + C) of the row, C whole slabs, and a
  // candidate list of capw indices
  const int C = (block + NW * kSlab - 1) / (NW * kSlab) * kSlab;
  const int w_lo = warp * C, w_hi = min(block, w_lo + C);
  const int capw = cap / NW;

  int need;
  int B = -1, ties = 0;  // take key > B, and the `ties` lowest-index entries == B
  bool resolved = false, list = false, have1 = false;
  if (guess >= 0) {
    // one pass, if the boundary digit is the previous row's
    split_pass<NW, Idx>(row, block, guess, capw, P, m, w_lo, w_hi);
    int eq = 0;
    bool fits = true;
    for (int w = 0; w < NW; ++w) {
      eq += sc[S_LCNT + w];
      fits &= sc[S_LCNT + w] <= capw;
    }
    const int above = sc[S_NSEL];
    list = have1 = fits && above < k && k <= above + eq;
    need = k - above;
    if (list && eq == need) {  // the bin is taken whole
      B = (guess << 23) - 1;
      resolved = true;
    }
  }
  if (!list) {
    // pass 1: each warp's histogram of the first digit
    for (int i = t; i < hist_ints(PACK, NW); i += T) hist[i] = 0;
    for (int i = t; i < kBins; i += T) m.hist1[i] = 0;
    __syncthreads();  // (after a wrong guess: every thread has read the counts)
    if (t == 0) {
      sc[S_NSEL] = 0;
      sc[S_KMIN] = INT_MAX;
      sc[S_KMAX] = -1;
    }
    for (int p0 = w_lo; p0 < w_hi; p0 += kSlab) {
      const int p = p0 + 4 * lane;
      if (p < block) {
        int dg[4];
        float e[4];
        digits4(row, p, block, dg, e);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (dg[j] >= 0) hist_add<PACK>(hist, warp, dg[j], 1u);
      }
    }
    __syncthreads();
    find_digit<NW, PACK>(hist, NW, k, sc);
    const int d0 = sc[S_D], cnt0 = sc[S_CNT];
    need = k - sc[S_ABOVE];
    guess = d0;
    bool fits = true;
    for (int w = 0; w < NW; ++w) fits &= sc[S_LCNT + w] <= capw;
    if (cnt0 == need) {  // bin d0 is taken whole: one sweep of the row
      B = (d0 << 23) - 1;
      resolved = true;
    } else if (fits) {
      // pass 2: the split by d0, which fits the lists
      split_pass<NW, Idx>(row, block, d0, capw, P, m, w_lo, w_hi);
      list = have1 = true;
    }
  }
  // this warp's candidates: wl[0, n)
  const Idx* const wl = static_cast<const Idx*>(m.cand) + warp * capw;
  const int n = list ? sc[S_LCNT + warp] : 0;

  // later digits, over the candidates (or the row, filtered by the prefix);
  // the split pass has built the second digit's histogram (hist1)
  int prefix = guess, pshift = 23;
  for (int L = 1; !resolved; ++L) {
    const int shift = level_shift(L), mask = (1 << level_width(L)) - 1;
    int* const h = have1 ? m.hist1 : hist;
    if (!have1) {
      for (int i = t; i < kBins; i += T) hist[i] = 0;
      if (t == 0) {
        sc[S_KMIN] = INT_MAX;
        sc[S_KMAX] = -1;
      }
      __syncthreads();
      int lo = INT_MAX, hi = -1;
      if (list) {
        for (int i = lane; i < n; i += 32) {
          const int key = key_of(row.at(wl[i]));
          if ((key >> pshift) == prefix) {
            atomicAdd(&hist[(key >> shift) & mask], 1);
            lo = min(lo, key);
            hi = max(hi, key);
          }
        }
      } else {
        for (int p0 = w_lo; p0 < w_hi; p0 += kSlab) {
          const int p = p0 + 4 * lane;
          if (p < block) {
            int key[4];
            keys4(row, p, block, key);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              if (key[j] >= 0 && (key[j] >> pshift) == prefix) {
                atomicAdd(&hist[(key[j] >> shift) & mask], 1);
                lo = min(lo, key[j]);
                hi = max(hi, key[j]);
              }
            }
          }
        }
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0) {
        atomicMin(&sc[S_KMIN], lo);
        atomicMax(&sc[S_KMAX], hi);
      }
      __syncthreads();
    }
    have1 = false;
    if (sc[S_KMIN] == sc[S_KMAX]) {  // the bin is one magnitude
      B = sc[S_KMIN];
      ties = need;
      break;
    }
    find_digit<NW, false>(h, 1, need, sc);
    const int dl = sc[S_D], al = sc[S_ABOVE], cl = sc[S_CNT];
    const int np = (prefix << level_width(L)) | dl;
    if (cl == need - al) {  // the bin is taken whole
      B = (np << shift) - 1;
      resolved = true;
    } else if (L == 3) {  // the last digit: B is one key
      B = np;
      ties = need - al;
      resolved = true;
    } else {
      prefix = np;
      pshift = shift;
      need -= al;
    }
  }

  // the tie cut: each warp's count of entries equal to B, in index order
  int tie_base = 0;
  if (ties > 0) {
    int c = 0;
    if (list) {
      for (int i = lane; i < n; i += 32) c += key_of(row.at(wl[i])) == B;
    } else {
      for (int p0 = w_lo; p0 < w_hi; p0 += kSlab) {
        const int p = p0 + 4 * lane;
        if (p < block) {
          int key[4];
          keys4(row, p, block, key);
#pragma unroll
          for (int j = 0; j < 4; ++j) c += key[j] == B;
        }
      }
    }
    c = __reduce_add_sync(0xffffffffu, c);
    if (lane == 0) sc[S_WCNT + warp] = c;
    __syncthreads();
    for (int w = 0; w < warp; ++w) tie_base += sc[S_WCNT + w];
  }

  // the final sweep: take key > B and the first `ties` entries equal to B
  if (list) {
    int run = tie_base;
    for (int i0 = 0; i0 < n; i0 += 32) {
      const int i = i0 + lane;
      const int e = i < n ? (int)wl[i] : 0;
      const int key = i < n ? key_of(row.at(e)) : -1;
      const unsigned bt = __ballot_sync(0xffffffffu, key == B && key >= 0);
      const int rank = run + __popc(bt & lanes_below(lane));
      run += __popc(bt);
      const bool take = key > B || (key == B && key >= 0 && rank < ties);
      const unsigned bs = __ballot_sync(0xffffffffu, take);
      if (bs) {
        const int at = warp_slots(__popc(bs), &sc[S_NSEL], lane) + __popc(bs & lanes_below(lane));
        if (take) {
          m.selk[at] = key;
          m.seli[at] = e;
        }
      }
    }
  } else {
    int run = tie_base;
    for (int p0 = w_lo; p0 < w_hi; p0 += kSlab) {
      const int p = p0 + 4 * lane;
      int key[4] = {-1, -1, -1, -1};
      if (p < block) keys4(row, p, block, key);
      unsigned bt[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bt[j] = __ballot_sync(0xffffffffu, key[j] == B && key[j] >= 0);
      int tot_t;
      int rank = run + slab_before(bt, lane, &tot_t);
      run += tot_t;
      bool take[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        take[j] = key[j] > B;
        if (bt[j] >> lane & 1u) take[j] = rank++ < ties;
      }
      unsigned bs[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bs[j] = __ballot_sync(0xffffffffu, take[j]);
      int tot_s;
      int at = slab_before(bs, lane, &tot_s);
      if (tot_s) at += warp_slots(tot_s, &sc[S_NSEL], lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (take[j]) {
          m.selk[at] = key[j];
          m.seli[at++] = p + j;
        }
      }
    }
  }
  __syncthreads();
  // for the next row (published by the last barrier): its split pass counts
  // into these
  for (int i = t; i < kBins; i += T) m.hist1[i] = 0;
  if (t == 0) {
    sc[S_NSEL] = 0;
    sc[S_KMIN] = INT_MAX;
    sc[S_KMAX] = -1;
  }

  // order the k selected entries and write them out
  if (k <= 64) {
    if (warp == 0) {
      if (k <= 32) {
        int key[1] = {lane < k ? m.selk[lane] : -1};
        int id[1] = {lane < k ? m.seli[lane] : INT_MAX};
        warp_bitonic<1>(key, id, lane);
        if (lane < k) {
          idx_r[lane] = id[0];
          vals_r[lane] = row.at(id[0]);
        }
      } else {
        int key[2], id[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = r * 32 + lane;
          key[r] = i < k ? m.selk[i] : -1;
          id[r] = i < k ? m.seli[i] : INT_MAX;
        }
        warp_bitonic<2>(key, id, lane);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = r * 32 + lane;
          if (i < k) {
            idx_r[i] = id[r];
            vals_r[i] = row.at(id[r]);
          }
        }
      }
    }
  } else {
    for (int i = k + t; i < P; i += T) {
      m.selk[i] = -1;
      m.seli[i] = INT_MAX;
    }
    __syncthreads();
    cta_bitonic<NW>(m.selk, m.seli, P);
    for (int i = t; i < k; i += T) {
      const int e = m.seli[i];
      idx_r[i] = e;
      vals_r[i] = row.at(e);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ Smem carve(unsigned char* base, const Layout& l) {
  return Smem{reinterpret_cast<int*>(base + l.hist), reinterpret_cast<int*>(base + l.hist1),
              base + l.cand,
              reinterpret_cast<int*>(base + l.selk), reinterpret_cast<int*>(base + l.seli),
              reinterpret_cast<int*>(base + l.scal)};
}

// one row's copy into a stage: 16 B a copy when vec, else 4 B
template <int NW>
__device__ __forceinline__ void stage_row(float* dst, const float* src, int block, bool vec) {
  constexpr int T = 32 * NW;
  if (vec) {
    for (int i = threadIdx.x; i < block / 4; i += T) cp_async16(dst + 4 * i, src + 4 * i);
  } else {
    for (int i = threadIdx.x; i < block; i += T) cp_async4(dst + i, src + i);
  }
}

// grid: persistent CTAs; CTA c takes rows c, c + grid, ...; 32 NW threads
template <int NW, int STAGES>
__global__ void __launch_bounds__(32 * NW) block_topk_staged_kernel(
    const float* __restrict__ x, float* __restrict__ vals, int* __restrict__ idx, int nb,
    int block, int k, int cap, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = sort_len(k);
  const Layout l = make_layout(block, STAGES, NW, cap, P);
  const Smem m = carve(smem, l);
  float* const stage = reinterpret_cast<float*>(smem + l.stage);
  const int first = blockIdx.x, step = gridDim.x;
  int guess = -1;  // the first row takes the histogram pass
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    const size_t r = (size_t)first + (size_t)s * step;
    if (r < (size_t)nb) stage_row<NW>(stage + s * l.row_floats, x + r * block, block, vec);
    cp_async_commit();
  }
  int i = 0;
  for (size_t r = first; r < (size_t)nb; r += step, ++i) {
    const size_t rn = r + (size_t)(STAGES - 1) * step;
    if (rn < (size_t)nb)
      stage_row<NW>(stage + ((i + STAGES - 1) % STAGES) * l.row_floats, x + rn * block, block,
                    vec);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    select_row<NW, true>(SmemRow{stage + (i % STAGES) * l.row_floats}, block, k, cap, P, m,
                         vals + r * k, idx + r * k, guess);
  }
  cp_async_wait<0>();
}

template <int NW>
__global__ void __launch_bounds__(32 * NW) block_topk_stream_kernel(
    const float* __restrict__ x, float* __restrict__ vals, int* __restrict__ idx, int nb,
    int block, int k, int cap, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int P = sort_len(k);
  const Smem m = carve(smem, make_layout(block, 0, NW, cap, P));
  int guess = -1;  // the first row takes the histogram pass
  for (size_t r = blockIdx.x; r < (size_t)nb; r += gridDim.x) {
    select_row<NW, false>(GlobalRow{x + r * block, block, vec != 0}, block, k, cap, P, m,
                          vals + r * k, idx + r * k, guess);
  }
}

typedef void (*KernelFn)(const float*, float*, int*, int, int, int, int, int);

// every kernel instance, by stages: stream <8>, then staged <4, 1-3>
const KernelFn kKernels[4] = {block_topk_stream_kernel<warps_of(0)>,
                              block_topk_staged_kernel<warps_of(1), 1>,
                              block_topk_staged_kernel<warps_of(2), 2>,
                              block_topk_staged_kernel<warps_of(3), 3>};
// the dynamic shared memory each instance was allowed, per device
int g_allowed[4][64];

}  // namespace

extern "C" {

// the largest k a call takes
int block_topk_k_max_f32() { return kKMax; }

// the dynamic shared memory of a plan: stages 1-3 staged, 0 stream; the
// same arithmetic as topk_compress.topk_smem
long long block_topk_smem_f32(int block, int k, int stages, int cap) {
  return (long long)make_layout(block, stages, warps_of(stages), cap, sort_len(k)).total;
}

int block_topk_f32(const void* x, void* vals, void* idx, int nb, int block, int k, int stages,
                   int cap, int smem, int grid, int device, void* stream) {
  const int warps = warps_of(stages);
  if (nb < 0 || block < 1 || k < 1 || k > block || k > kKMax || stages < 0 || stages > 3 ||
      cap < warps || grid < 1)
    return (int)cudaErrorInvalidValue;
  if ((long long)make_layout(block, stages, warps, cap, sort_len(k)).total != smem)
    return (int)cudaErrorInvalidValue;
  if (nb == 0) return 0;
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
  }
  const KernelFn fn = kKernels[stages];
  if (device >= 0 && device < 64 && smem > g_allowed[stages][device]) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    g_allowed[stages][device] = smem;
  }
  const int vec = block % 4 == 0 && (uintptr_t)x % 16 == 0;
  fn<<<grid, 32 * warps, smem, (cudaStream_t)stream>>>((const float*)x, (float*)vals,
                                                       (int*)idx, nb, block, k, cap, vec);
  return (int)cudaGetLastError();
}

const char* error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
