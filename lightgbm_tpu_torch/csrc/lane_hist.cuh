// Lane-per-feature histogram of contiguous windows of the feature-major seg
// rows, in two passes: the (g, h, count) histogram of K windows [start,
// start + cnt), in f32 or on the int8 2-digit grid, written as f32
// [K, F, B, 3] (the int8 digit sums recombined in the second pass).  The
// windows are the host's (the segment histogram), or each the smaller child
// of a partitioned window, found from the partition's left counts on the
// device (the fused grow step), so that no host read sits between the
// partition and its histogram.
//
// Layout (the port's seg rows): bins u8 feature-major [f, n]; g, h, m f32
// [n].  Pass 1 (lane_hist_accumulate): a grid of (row chunk, 32-feature
// group) blocks, the chunks of every window in one run (each window takes
// chunks in proportion to its rows, as many as fill the card once, so that
// a large window does not wait on a small one's share).  Lane j of every
// warp owns feature f0 + j.  A warp takes 32 rows at a time: lane u loads
// row u's g, h, m (consecutive lanes, consecutive rows) and turns them into
// what the row adds (hist_block.cuh row_stat: g*m, h*m, m != 0, or the int8
// digits), while lane j loads the 32 bytes of those rows in its own
// feature's plane as nine aligned 4-byte words and shifts them into place
// (any alignment of the window); then for each of the 32 rows the warp
// takes the row's values by shuffles and lane j adds them to its feature's
// cell of the row's bin.  The block's histogram is [plane][bin][32] words
// in shared memory (f32: 96 KB, int8: 160 KB at B = 256), so lane j's
// cells all lie in bank j: the 32 adds of a warp never share a bank or an
// address, whatever the bins.  How a block adds (Acc; kSeg: the segment
// histogram's build, else the fused step's, which differ only in the int8
// warps):
//   * int8: warps on interleaved rows, meeting on a cell only through shared
//     integer atomics, whose sums do not depend on the order: 32 warps
//     (1,024 threads) in the segment histogram, whose int8 calls are roots
//     (12% faster there than 16), 16 in the fused step, whose windows are
//     mostly a few thousand rows (2-3% faster there than 32);
//   * f32, in both: one warp, the block's only thread of each cell, adding
//     every row of the chunk in row order with plain loads and stores (four
//     rows at a time, a row whose cell an earlier row of the four holds
//     adding to that row's new value), so that a block's f32 sums are those
//     of one add after another and the same on every run (shared f32
//     atomics from several warps add in the order the warps reach a cell,
//     which changes from run to run; sm_90 has no shared f32 atomic add
//     either, only compare-and-swap loops).  It issues the loads of the
//     next three batches of 32 rows before adding one; a row costs five
//     shared-memory operations: its (g*m, h*m) pair from a stage (a
//     broadcast load), its cell's (g, h) pair (one 8-byte load and store)
//     and count; a trash bin (kOrderBins) spares the rows any test.  In the
//     fused step this took 5% longer than sixteen atomic warps on the root's
//     children, 2% at K=4, 10% at F = 242, and 0-4% less on small windows.
// The block then copies its whole histogram to its slot of a scratch.
// Pass 2 (lane_hist_reduce) sums each cell over the window's chunks in a
// fixed order (kSlices threads a cell, each over every kSlices-th chunk in
// order, then the slices in order), recombines the int8 digit sums as
// combine_int8 does ((f32(S_hi) * 128 + f32(S_lo)) * scale, bit-equal under
// -fmad=false), and writes every cell through a shared-memory transpose, so
// that each feature's bins go out as one run: no global atomics, no zeroed
// output, and the same sums on every run.
//
// What bounds it: in principle memory, one pass over cnt * (F + 12) bytes
// plus the output; in practice the shared memory pipe: in int8 mode five
// atomics a row and feature, as for the ordered histogram (ordered_hist.cu);
// in-order f32 likewise, at five shared-memory operations a row and
// feature, and one warp's issue, two warps a multiprocessor.
//
// Used by csrc/seg_hist.cu (host windows: no left counts, no dec) and
// csrc/grow_step.cu (the elected children).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_block.cuh"

// Everything here has internal linkage (an unnamed namespace): each source
// that includes it, and each build of a source loaded into one process,
// keeps its own once-per-process state (fill_blocks, sm_count), which a
// template's or inline function's static would otherwise share between
// libraries (the loader unifies such statics across shared objects).
namespace lhist {
namespace {

constexpr int kLanes = 32;  // features of a group
constexpr long long kMinRowsPerBlock = 256;  // rows of a chunk, where a window has them
constexpr int kMaxWindows = 16;
constexpr int kReduceThreads = 1024;
constexpr int kReduceCells = 128;  // cells of one reduce block: 4 bins of 32 lanes
constexpr int kSlices = kReduceThreads / kReduceCells;  // threads a cell
constexpr int kNlBytes = 64;  // the scratch's head: the partition's left counts

// How an accumulate block adds (see the top), in the segment histogram
// (kSeg) or the fused grow step: int8 with shared atomics, 32 or 16 warps;
// f32 in row order, one warp, in both.  The second template argument names
// the caller only (a profile tells the two histograms apart by it).
template <bool kInt8, bool kSeg>
struct Acc {
  static constexpr bool kInOrder = !kInt8;
  static constexpr int kWarps = kInt8 ? (kSeg ? 32 : 16) : 1;
  static constexpr int kThreads = kWarps * 32;
};

// The in-order table: (g, h) pairs of f32 [kOrderBins][32], then the counts
// i32 [kOrderBins][32] (kOrderPlane words a plane whatever nbins), then
// the warp's stage of a batch's (g*m, h*m) pairs; each plane holds every
// bin of the group's features and then a trash bin, where the rows that
// add nothing (a bin >= nbins) go, so that no row needs a test before its
// loads and stores.
constexpr int kOrderBins = 257;
constexpr int kOrderPlane = kOrderBins * kLanes;  // words of a plane
constexpr int kOrderWords = 3 * kOrderPlane + 2 * kLanes;  // of the table and stage

template <bool kInt8>
struct Table {
  static constexpr int kWords = kInt8 ? 5 : 3;  // 32-bit planes of a cell
  // bytes of a block's image in the scratch: [plane][bin][lane] words
  static size_t bytes(int nbins) { return (size_t)kWords * nbins * kLanes * 4; }
  // bytes of a block's table in shared memory
  static size_t smem_bytes(int nbins) {
    return Acc<kInt8, false>::kInOrder ? (size_t)kOrderWords * 4 : bytes(nbins);
  }
};

// k windows and their chunks: window i takes chunks [chunk0[i],
// chunk0[i + 1]) of the launch (plan_chunks)
struct Windows {
  int k;
  long long start[kMaxWindows];
  long long cnt[kMaxWindows];
  long long chunk0[kMaxWindows + 1];
};

// The window block row k takes: [start, start + cnt), or, with the left
// counts nl of a partition of those windows, the smaller child (the left
// one when nl <= nr), as the fused grow step elects it.
__device__ __forceinline__ void hist_window(const Windows& w, const int* nl, int k,
                                            long long& s, long long& c) {
  s = w.start[k];
  c = w.cnt[k];
  if (nl != nullptr) {
    const long long l = nl[k];
    const bool left = l <= c - l;
    s += left ? 0 : l;
    c = left ? l : c - l;
  }
}

// chunks of a window of c rows that may take `cap` chunks (>= 1: an empty
// window still writes its zero histogram)
__device__ __host__ __forceinline__ long long window_chunks(long long c, long long cap) {
  long long n = (c + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  if (n > cap) n = cap;
  return n < 1 ? 1 : n;
}

// The chunks each window may take: as many as its rows need (a smaller
// child, `children`, holds at most half its window), at most its share, by
// rows, of the `fill` blocks that fill the card once, and at least one.
inline void plan_chunks(Windows& w, bool children, int groups, long long fill) {
  long long total = 0;
  for (int i = 0; i < w.k; ++i) total += w.cnt[i];
  const long long share = fill / groups;
  w.chunk0[0] = 0;
  for (int i = 0; i < w.k; ++i) {
    long long cap = window_chunks(children ? w.cnt[i] / 2 : w.cnt[i], share);
    const long long fair = total > 0 ? share * w.cnt[i] / total : 0;
    if (cap > fair) cap = fair > 0 ? fair : 1;
    w.chunk0[i + 1] = w.chunk0[i] + cap;
  }
}

// What one row adds: f32 (g*m, h*m, m != 0), or the int8 digits packed a
// byte each (g_hi, g_lo, h_hi, h_lo; |hi| <= 127, |lo| <= 64) and the count.
struct Vals {
  uint32_t a, b;  // f32: the bits of g*m and h*m; int8: a the packed digits
  int c;
};

template <bool kInt8>
__device__ __forceinline__ Vals row_vals(float g, float h, float m, float inv_g, float inv_h) {
  Vals v;
  const auto s = lgbt::row_stat<kInt8>(g, h, m, inv_g, inv_h);
  if constexpr (kInt8) {
    v.a = (uint32_t)(s.ghi & 0xff) | ((uint32_t)(s.glo & 0xff) << 8) |
          ((uint32_t)(s.hhi & 0xff) << 16) | ((uint32_t)(s.hlo & 0xff) << 24);
    v.b = 0;
  } else {
    v.a = __float_as_uint(s.g);
    v.b = __float_as_uint(s.h);
  }
  v.c = s.c;
  return v;
}

__device__ __forceinline__ int digit(uint32_t w, int k) {
  return (int)(w << (24 - 8 * k)) >> 24;  // signed byte k
}

// One row's int8 digits and count added to a cell with shared integer
// atomics (a block of several warps): integer sums, the same in any order.
__device__ __forceinline__ void add_digits(int* s, int cell, int pw, const Vals& v) {
#pragma unroll
  for (int p = 0; p < 4; ++p) atomicAdd(&s[p * pw + cell], digit(v.a, p));
  atomicAdd(&s[4 * pw + cell], v.c);
}

// Bytes p[0 .. nv) (nv <= 32) as eight words, byte q in w[q / 4] at bits
// 8 (q % 4): the aligned words that hold them (never a word past the one
// that holds byte nv - 1), shifted into place.
__device__ __forceinline__ void load_run32(const uint8_t* p, int nv, uint32_t (&w)[8]) {
  const int a = (int)((uintptr_t)p & 3);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(p - a);
  const int nw = (a + nv + 3) >> 2;
  uint32_t aw[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) aw[i] = i < nw ? __ldg(src + i) : 0u;
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = __funnelshift_r(aw[i], aw[i + 1], 8 * a);
}

// The raw loads of a batch of 32 rows: lane u's row u (g, h, m) and the
// nine aligned words of the lane's plane that cover the batch, kept as
// loaded (nothing reads them until the batch is added, so the loads of
// later batches stay in flight meanwhile).
struct Raw {
  float g, h, m;
  uint32_t aw[9];
  int nv, a;  // rows of the batch (0: none), alignment of its first byte
};

__device__ __forceinline__ void load_raw(Raw& r, const uint8_t* plane, bool has,
                                         const float* g, const float* h, const float* m,
                                         long long s, long long base, long long i1, int lane) {
  r.nv = base < i1 ? (int)min(32LL, i1 - base) : 0;
  r.g = r.h = r.m = 0.0f;
  if (lane < r.nv) {
    r.g = g[s + base + lane];
    r.h = h[s + base + lane];
    r.m = m[s + base + lane];
  }
  const uint8_t* p = plane + base;
  r.a = (int)((uintptr_t)p & 3);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(p - r.a);
  const int nw = has && r.nv > 0 ? (r.a + r.nv + 3) >> 2 : 0;
#pragma unroll
  for (int i = 0; i < 9; ++i) r.aw[i] = i < nw ? __ldg(src + i) : 0u;
}

// Rows the in-order warp adds at a time (see add_in_order).
constexpr int kGroup = 4;

// One batch added in row order by the block's only warp (Acc<false, *>)
// to the in-order table, lane j to its feature's cells, which no other
// thread touches (gh, cnt: the lane's columns of the (g, h) pairs and the
// counts).  The batch's (g*m, h*m) pairs go to the stage, whence each row's
// pair reaches every lane as one broadcast load; its counts come from a
// ballot.  kGroup rows at a time: their cells read (a pair and a count a
// row), then each row's sums taken from the latest earlier row of the group
// with the same cell, or else from the cell, then written back in row
// order, so that the last write of a cell holds all its rows: the sums of
// one add after another.  Rows past the batch add zeros (and +0.0 leaves an
// f32 sum as it is: a sum that starts at +0.0 never becomes -0.0).
__device__ __forceinline__ void add_in_order(float2* gh, int* cnt, float2* stage, const Raw& raw,
                                             int nbins, int lane) {
  const Vals v = row_vals<false>(raw.g, raw.h, raw.m, 1.0f, 1.0f);  // 0s past the batch
  const uint32_t live = __ballot_sync(0xffffffffu, v.c != 0);
  __syncwarp();  // every lane has read the stage's last batch
  stage[lane] = make_float2(__uint_as_float(v.a), __uint_as_float(v.b));
  __syncwarp();
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = __funnelshift_r(raw.aw[i], raw.aw[i + 1], 8 * raw.a);
#pragma unroll
  for (int q0 = 0; q0 < 32; q0 += kGroup) {
    if (q0 >= raw.nv) break;  // nv is the same on every lane
    int cell[kGroup], oc[kGroup];
    float2 x[kGroup], o[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int q = q0 + k;
      const int b = (int)((w[q >> 2] >> (8 * (q & 3))) & 0xffu);
      cell[k] = (b < nbins ? b : kOrderBins - 1) * kLanes;
      x[k] = stage[q];
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      o[k] = gh[cell[k]];
      oc[k] = cnt[cell[k]];
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
#pragma unroll
      for (int j = 0; j < k; ++j) {
        if (cell[k] == cell[j]) {  // row j's sums, written below
          o[k] = o[j];
          oc[k] = oc[j];
        }
      }
      o[k].x += x[k].x;
      o[k].y += x[k].y;
      oc[k] += (int)((live >> (q0 + k)) & 1u);
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      gh[cell[k]] = o[k];
      cnt[cell[k]] = oc[k];
    }
  }
}

// -DHIST_TRACE: each accumulate block's thread 0 notes the global timer (ns)
// at its start and at the ends of its phases, and the multiprocessor's
// clock at the first and the last (a diagnostic build of the bench)
#ifdef HIST_TRACE
constexpr int kTraceBlocks = 4096;
constexpr int kTraceMarks = 4;
__device__ unsigned long long g_hist_trace[kTraceBlocks][kTraceMarks + 2];
__device__ __forceinline__ void hist_mark(long long blk, int k) {
  __syncthreads();
  if (threadIdx.x == 0 && blk < kTraceBlocks) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    g_hist_trace[blk][k] = ns;
    if (k == 0 || k == kTraceMarks - 1) g_hist_trace[blk][kTraceMarks + (k > 0)] = clock64();
  }
}
#define HIST_MARK(b, k) hist_mark(b, k)
#else
#define HIST_MARK(b, k)
#endif

// Pass 1: the (row chunk, feature group) block's histogram in shared
// memory, copied out whole into its slot of the scratch (slot: group *
// chunks of the launch + chunk).
template <bool kInt8, bool kSeg>
__global__ void __launch_bounds__((Acc<kInt8, kSeg>::kThreads))
    lane_hist_accumulate(const uint8_t* __restrict__ bins, long long n,
                         const float* __restrict__ g, const float* __restrict__ h,
                         const float* __restrict__ m, Windows win, const int* __restrict__ nl,
                         int f, int nbins, const float* __restrict__ scales,
                         int* __restrict__ scratch) {
  constexpr int kThreads = Acc<kInt8, kSeg>::kThreads;
  constexpr int kWarps = Acc<kInt8, kSeg>::kWarps;
  extern __shared__ __align__(16) int lh_smem[];
  const long long x = blockIdx.x;
  int k = 0;
  while (k + 1 < win.k && x >= win.chunk0[k + 1]) ++k;
  long long s, c;
  hist_window(win, nl, k, s, c);
  const long long chunks = window_chunks(c, win.chunk0[k + 1] - win.chunk0[k]);
  const long long xi = x - win.chunk0[k];
  if (xi >= chunks) return;  // whole block: no barrier yet
  const long long slot = (long long)blockIdx.y * gridDim.x + x;
  HIST_MARK(slot, 0);

  const int lane = threadIdx.x & 31;
  const int pw = nbins * kLanes;  // words of a plane of the image
  const int words = Table<kInt8>::kWords * pw;  // of the image
  constexpr bool kInOrder = Acc<kInt8, kSeg>::kInOrder;
  const int table = kInOrder ? 3 * kOrderPlane : words;
  int4* zero = reinterpret_cast<int4*>(lh_smem);
  for (int i = threadIdx.x; i < table / 4; i += kThreads) zero[i] = make_int4(0, 0, 0, 0);
  __syncthreads();
  HIST_MARK(slot, 1);

  const int feat = blockIdx.y * kLanes + lane;
  const bool has = feat < f;
  const float inv_g = lgbt::inv_scale(scales, 0);
  const float inv_h = lgbt::inv_scale(scales, 1);
  const long long per = (c + chunks - 1) / chunks;
  const long long i0 = xi * per;
  const long long i1 = min(i0 + per, c);
  const uint8_t* plane = bins + (long long)(has ? feat : 0) * n + s;

  if constexpr (kInOrder) {  // the block's only warp, in row order
    float2* gh = reinterpret_cast<float2*>(lh_smem) + lane;
    int* cnt = lh_smem + 2 * kOrderPlane + lane;
    float2* stage = reinterpret_cast<float2*>(lh_smem + 3 * kOrderPlane);
    Raw r0, r1, r2;
    load_raw(r0, plane, has, g, h, m, s, i0, i1, lane);
    load_raw(r1, plane, has, g, h, m, s, i0 + 32, i1, lane);
    load_raw(r2, plane, has, g, h, m, s, i0 + 64, i1, lane);
    for (long long base = i0; base < i1; base += 32) {
      Raw r3;
      load_raw(r3, plane, has, g, h, m, s, base + 96, i1, lane);
      add_in_order(gh, cnt, stage, r0, nbins, lane);
      r0 = r1;
      r1 = r2;
      r2 = r3;
    }
  } else {  // int8: interleaved rows, shared integer atomics
    const int warp = threadIdx.x >> 5;
    for (long long base = i0 + (long long)warp * 32; base < i1; base += (long long)kWarps * 32) {
      const int nv = (int)min(32LL, i1 - base);
      Vals v{0u, 0u, 0};
      if (lane < nv) v = row_vals<kInt8>(g[s + base + lane], h[s + base + lane],
                                         m[s + base + lane], inv_g, inv_h);
      uint32_t w[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      if (has) load_run32(plane + base, nv, w);
#pragma unroll
      for (int q = 0; q < 32; ++q) {
        if (q >= nv) break;  // nv is the same on every lane
        Vals r;
        r.a = __shfl_sync(0xffffffffu, v.a, q);
        r.b = 0u;
        r.c = __shfl_sync(0xffffffffu, v.c, q);
        const int b = (int)((w[q >> 2] >> (8 * (q & 3))) & 0xffu);
        if (has && b < nbins) add_digits(lh_smem, b * kLanes + lane, pw, r);
      }
    }
  }
  __syncthreads();
  HIST_MARK(slot, 2);

  // the image, [plane][bin][lane], 16 bytes a thread (a plane's pw words
  // are a multiple of 32)
  int4* dst = reinterpret_cast<int4*>(scratch + slot * words);
  const int4* src = reinterpret_cast<const int4*>(lh_smem);
  if constexpr (kInOrder) {  // the pairs split into the g and h planes
    const float4* pairs = reinterpret_cast<const float4*>(lh_smem);
    for (int i = threadIdx.x; i < pw / 4; i += kThreads) {
      const float4 a = pairs[2 * i], b = pairs[2 * i + 1];
      dst[i] = make_int4(__float_as_int(a.x), __float_as_int(a.z), __float_as_int(b.x),
                         __float_as_int(b.z));
      dst[pw / 4 + i] = make_int4(__float_as_int(a.y), __float_as_int(a.w), __float_as_int(b.y),
                                  __float_as_int(b.w));
      dst[pw / 2 + i] = src[2 * kOrderPlane / 4 + i];
    }
  } else {
    for (int i = threadIdx.x; i < words / 4; i += kThreads) dst[i] = src[i];
  }
  HIST_MARK(slot, 3);
}

// Pass 2: each (kReduceCells cells, feature group, window) tile of the
// output summed over the window's chunks in a fixed order (thread slice t
// over chunks t, t + kSlices, ... in order, then the slices in order),
// recombined (int8), and written out through a transpose; with nl and dec,
// block (0, 0, k) also writes dec[k] = (nl, nr, child start, child cnt).
template <bool kInt8>
__global__ void __launch_bounds__(kReduceThreads)
    lane_hist_reduce(const int* __restrict__ scratch, Windows win, const int* __restrict__ nl,
                     int f, int nbins, const float* __restrict__ scales, int* __restrict__ dec,
                     float* __restrict__ out) {
  constexpr int P = Table<kInt8>::kWords;
  constexpr int kBins = kReduceCells / kLanes;  // bins of the tile
  constexpr int kRow = kBins * 3 + 1;           // words a feature, odd: no conflicts
  __shared__ int partial[kSlices][P][kReduceCells];
  __shared__ float tile[kLanes * kRow];
  const int k = blockIdx.z;
  long long s, c;
  hist_window(win, nl, k, s, c);
  if (dec != nullptr && blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) {
    const long long l = nl[k];
    dec[4 * k] = (int)l;
    dec[4 * k + 1] = (int)(win.cnt[k] - l);
    dec[4 * k + 2] = (int)s;
    dec[4 * k + 3] = (int)c;
  }
  const int pw = nbins * kLanes;
  const long long words = (long long)P * pw;
  const long long chunks = window_chunks(c, win.chunk0[k + 1] - win.chunk0[k]);
  const int* part = scratch + ((long long)blockIdx.y * win.chunk0[win.k] + win.chunk0[k]) * words;
  const int e = threadIdx.x % kReduceCells;
  const int slice = threadIdx.x / kReduceCells;
  const int cell = blockIdx.x * kReduceCells + e;

  int acc[P];
  float fa = 0.0f, fb = 0.0f;
#pragma unroll
  for (int p = 0; p < P; ++p) acc[p] = 0;
  if (cell < pw) {
    for (long long q = slice; q < chunks; q += kSlices) {
      const int* im = part + q * words + cell;
      if constexpr (kInt8) {
#pragma unroll
        for (int p = 0; p < P; ++p) acc[p] += im[p * pw];
      } else {
        fa += __int_as_float(im[0]);
        fb += __int_as_float(im[pw]);
        acc[2] += im[2 * pw];
      }
    }
  }
  if constexpr (!kInt8) {
    acc[0] = __float_as_int(fa);
    acc[1] = __float_as_int(fb);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) partial[slice][p][e] = acc[p];
  __syncthreads();

  if (slice == 0) {  // the slices in order
    float* row = tile + (e % kLanes) * kRow + (e / kLanes) * 3;
    if constexpr (kInt8) {
      int o[P];
#pragma unroll
      for (int p = 0; p < P; ++p) {
        o[p] = 0;
        for (int t = 0; t < kSlices; ++t) o[p] += partial[t][p][e];
      }
      const float sg = scales[0], sh = scales[1];
      row[0] = ((float)o[0] * 128.0f + (float)o[1]) * sg;
      row[1] = ((float)o[2] * 128.0f + (float)o[3]) * sh;
      row[2] = (float)o[4];
    } else {
      float a = __int_as_float(partial[0][0][e]), b = __int_as_float(partial[0][1][e]);
      int cnt = partial[0][2][e];
      for (int t = 1; t < kSlices; ++t) {
        a += __int_as_float(partial[t][0][e]);
        b += __int_as_float(partial[t][1][e]);
        cnt += partial[t][2][e];
      }
      row[0] = a;
      row[1] = b;
      row[2] = (float)cnt;
    }
  }
  __syncthreads();

  // each feature's nb * 3 words are one run of the output
  const int f0 = blockIdx.y * kLanes;
  const int bin0 = blockIdx.x * kBins;
  const int nb = min(kBins, nbins - bin0);
  for (int x = threadIdx.x; x < kLanes * nb * 3; x += kReduceThreads) {
    const int j = x / (nb * 3);
    const int y = x - j * (nb * 3);
    if (f0 + j >= f) continue;
    out[(((long long)k * f + f0 + j) * nbins + bin0) * 3 + y] = tile[j * kRow + y];
  }
}

inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

// accumulate blocks the card holds at once at 256 bins, found once (0 on
// error, with the error in *err)
template <bool kInt8, bool kSeg>
long long fill_blocks(cudaError_t* err) {
  static long long fill = 0;
  if (fill == 0) {
    const int bytes = (int)Table<kInt8>::smem_bytes(256);
    *err = cudaFuncSetAttribute(lane_hist_accumulate<kInt8, kSeg>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (*err != cudaSuccess) return 0;
    int r = 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &r, lane_hist_accumulate<kInt8, kSeg>, Acc<kInt8, kSeg>::kThreads, bytes);
    if (*err != cudaSuccess) return 0;
    if (r < 1) {
      *err = cudaErrorInvalidConfiguration;
      return 0;
    }
    fill = (long long)r * sm_count();
  }
  return fill;
}

// Bytes of scratch a launch over any k <= kMaxWindows windows may need: the
// head for the left counts, then one image a block (plan_chunks gives a
// group at most fill / groups chunks plus one a window); negative: minus a
// CUDA error.  kSeg: the segment histogram's blocks (Acc).
template <bool kInt8, bool kSeg = false>
long long scratch_bytes(int f, int nbins) {
  cudaError_t e = cudaSuccess;
  const long long fill = fill_blocks<kInt8, kSeg>(&e);
  if (e != cudaSuccess) return -(long long)e;
  const long long groups = (f + kLanes - 1) / kLanes;
  const long long blocks = groups * (fill / groups + kMaxWindows);
  return kNlBytes + blocks * (long long)Table<kInt8>::bytes(nbins);
}

// The two launches over the windows of `win` (its chunks planned here);
// with nl (device), each window's smaller child, and dec (device) written.
// scratch: the images, of scratch_bytes<kInt8, kSeg> less the head.
template <bool kInt8, bool kSeg = false>
int launch(const uint8_t* bins, long long n, const float* g, const float* h, const float* m,
           Windows win, const int* nl, int f, int nbins, const float* scales, int* scratch,
           long long scratch_size, int* dec, float* out, cudaStream_t st) {
  cudaError_t e = cudaSuccess;
  const long long fill = fill_blocks<kInt8, kSeg>(&e);
  if (e != cudaSuccess) return (int)e;
  const int groups = (f + kLanes - 1) / kLanes;
  plan_chunks(win, nl != nullptr, groups, fill);
  const long long chunks = win.chunk0[win.k];
  const long long words = (long long)Table<kInt8>::kWords * nbins * kLanes;
  if (scratch_size < groups * chunks * words * 4) return (int)cudaErrorInvalidValue;
  lane_hist_accumulate<kInt8, kSeg>
      <<<dim3((unsigned)chunks, (unsigned)groups), Acc<kInt8, kSeg>::kThreads,
         Table<kInt8>::smem_bytes(nbins), st>>>(bins, n, g, h, m, win, nl, f, nbins,
                                                      scales, scratch);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int bins_a_block = kReduceCells / kLanes;
  lane_hist_reduce<kInt8><<<dim3((unsigned)((nbins + bins_a_block - 1) / bins_a_block),
                                 (unsigned)groups, (unsigned)win.k),
                            kReduceThreads, 0, st>>>(scratch, win, nl, f, nbins, scales, dec, out);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lhist
