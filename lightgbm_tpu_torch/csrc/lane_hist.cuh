// Lane-per-feature histogram of contiguous windows of the feature-major seg
// rows, in two passes: the (g, h, count) histogram of K windows [start,
// start + cnt), in f32 or on the int8 2-digit grid, written as f32
// [K, F, B, 3] (the int8 digit sums recombined in the second pass).  A
// window may be given as the smaller child of a partitioned window, from
// the partition's left counts on the device (the fused grow step), so no
// host read sits between the partition and its histogram.
//
// Layout (the port's seg rows): bins u8 feature-major [f, n]; g, h, m f32
// [n].  Pass 1 (lane_hist_accumulate): a grid of (row chunk, 32-feature
// group) blocks of kThreads threads, the chunks of every window in one run
// (each window takes chunks in proportion to its rows, as many as fill the
// card once, so that a large window does not wait on a small one's
// share).  Lane j of every warp owns feature f0 + j.  A warp takes 32 rows
// at a time: lane u loads row u's g, h, m (consecutive lanes, consecutive
// rows) and turns them into what the row adds (hist_block.cuh row_stat:
// g*m, h*m, m != 0, or the int8 digits), while lane j loads the 32 bytes of those rows in its own feature's plane
// as nine aligned 4-byte words and shifts them into place (any alignment of
// the window); then for each of the 32 rows the warp takes the row's values
// by shuffles and lane j adds them to its feature's cell of the row's bin.
// The block's histogram is [plane][bin][32] words in shared memory (f32:
// 96 KB, int8: 160 KB at B = 256), so lane j's cells all lie in bank j: the
// 32 adds of a warp never share a bank or an address, whatever the bins;
// only warps that hit one cell at the same moment meet, and shared atomics
// resolve that.  The block then copies its whole histogram to its slot of a
// scratch.  Pass 2 (lane_hist_reduce) sums each cell over the window's
// chunks in a fixed order (kSlices threads a cell, each over every
// kSlices-th chunk in order, then the slices in order), recombines the int8
// digit sums as combine_int8 does ((f32(S_hi) * 128 + f32(S_lo)) * scale,
// bit-equal under -fmad=false), and writes every cell through a
// shared-memory transpose, so that each feature's bins go out as one run:
// no global atomics, no zeroed output, and the f32 sums are the same on
// every run.
//
// What bounds it: in principle memory, one pass over cnt * (F + 12) bytes
// plus the output; in practice the shared atomics (5 a row and feature in
// int8 mode; in f32 two compare-and-swap loops and an add, since sm_90 has
// no shared f32 atomic add), as for the ordered histogram (ordered_hist.cu).
//
// Used by csrc/grow_step.cu.

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

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = 32;  // features of a group
constexpr long long kMinRowsPerBlock = 256;  // rows of a chunk, where a window has them
constexpr int kMaxWindows = 16;
constexpr int kReduceThreads = 1024;
constexpr int kReduceCells = 128;  // cells of one reduce block: 4 bins of 32 lanes
constexpr int kSlices = kReduceThreads / kReduceCells;  // threads a cell
constexpr int kNlBytes = 64;  // the scratch's head: the partition's left counts

template <bool kInt8>
struct Table {
  static constexpr int kWords = kInt8 ? 5 : 3;  // 32-bit planes of a cell
  static size_t bytes(int nbins) { return (size_t)kWords * nbins * kLanes * 4; }
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

template <bool kInt8>
__device__ __forceinline__ void add(int* s, int cell, int pw, const Vals& v) {
  if constexpr (kInt8) {
#pragma unroll
    for (int p = 0; p < 4; ++p) atomicAdd(&s[p * pw + cell], digit(v.a, p));
    atomicAdd(&s[4 * pw + cell], v.c);
  } else {
    float* sf = reinterpret_cast<float*>(s);
    atomicAdd(&sf[cell], __uint_as_float(v.a));
    atomicAdd(&sf[pw + cell], __uint_as_float(v.b));
    atomicAdd(&s[2 * pw + cell], v.c);
  }
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
template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
    lane_hist_accumulate(const uint8_t* __restrict__ bins, long long n,
                         const float* __restrict__ g, const float* __restrict__ h,
                         const float* __restrict__ m, Windows win, const int* __restrict__ nl,
                         int f, int nbins, const float* __restrict__ scales,
                         int* __restrict__ scratch) {
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
  const int warp = threadIdx.x >> 5;
  const int pw = nbins * kLanes;  // words of a plane
  const int words = Table<kInt8>::kWords * pw;
  int4* zero = reinterpret_cast<int4*>(lh_smem);
  for (int i = threadIdx.x; i < words / 4; i += kThreads) zero[i] = make_int4(0, 0, 0, 0);
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
      r.b = kInt8 ? 0u : __shfl_sync(0xffffffffu, v.b, q);
      r.c = __shfl_sync(0xffffffffu, v.c, q);
      const int b = (int)((w[q >> 2] >> (8 * (q & 3))) & 0xffu);
      if (has && b < nbins) add<kInt8>(lh_smem, b * kLanes + lane, pw, r);
    }
  }
  __syncthreads();
  HIST_MARK(slot, 2);

  // the image, 16 bytes a thread (words is a multiple of 32)
  int4* dst = reinterpret_cast<int4*>(scratch + slot * words);
  const int4* src = reinterpret_cast<const int4*>(lh_smem);
  for (int i = threadIdx.x; i < words / 4; i += kThreads) dst[i] = src[i];
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
template <bool kInt8>
long long fill_blocks(cudaError_t* err) {
  static long long fill = 0;
  if (fill == 0) {
    const int bytes = (int)Table<kInt8>::bytes(256);
    *err = cudaFuncSetAttribute(lane_hist_accumulate<kInt8>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (*err != cudaSuccess) return 0;
    int r = 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&r, lane_hist_accumulate<kInt8>,
                                                         kThreads, bytes);
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
// CUDA error.
template <bool kInt8>
long long scratch_bytes(int f, int nbins) {
  cudaError_t e = cudaSuccess;
  const long long fill = fill_blocks<kInt8>(&e);
  if (e != cudaSuccess) return -(long long)e;
  const long long groups = (f + kLanes - 1) / kLanes;
  const long long blocks = groups * (fill / groups + kMaxWindows);
  return kNlBytes + blocks * (long long)Table<kInt8>::bytes(nbins);
}

// The two launches over the windows of `win` (its chunks planned here);
// with nl (device), each window's smaller child, and dec (device) written.
// scratch: the images, of scratch_bytes<kInt8> less the head.
template <bool kInt8>
int launch(const uint8_t* bins, long long n, const float* g, const float* h, const float* m,
           Windows win, const int* nl, int f, int nbins, const float* scales, int* scratch,
           long long scratch_size, int* dec, float* out, cudaStream_t st) {
  cudaError_t e = cudaSuccess;
  const long long fill = fill_blocks<kInt8>(&e);
  if (e != cudaSuccess) return (int)e;
  const int groups = (f + kLanes - 1) / kLanes;
  plan_chunks(win, nl != nullptr, groups, fill);
  const long long chunks = win.chunk0[win.k];
  const long long words = (long long)Table<kInt8>::kWords * nbins * kLanes;
  if (scratch_size < groups * chunks * words * 4) return (int)cudaErrorInvalidValue;
  lane_hist_accumulate<kInt8><<<dim3((unsigned)chunks, (unsigned)groups), kThreads,
                                Table<kInt8>::bytes(nbins), st>>>(bins, n, g, h, m, win, nl, f,
                                                                  nbins, scales, scratch);
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
