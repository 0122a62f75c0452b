// Ordered-layout histogram: the (g, h, count) histograms of K windows of an
// index array over the row-major bins, in f32 or on the int8 2-digit grid.
//
// Replaces two TPU kernels that run through one pl.pallas_call:
//   * _hist_kernel (lightgbm_tpu/ops/pallas/histogram.py:65), launched by
//     tile_pallas_histogram (histogram.py:140) from histogram_pallas (:161):
//     the masked [F, B, 3] (sum g*m, sum h*m, sum m) of [N, F] row-major
//     bins, as a bf16 3-term one-hot matmul on the MXU;
//   * _hist_kernel_int8 (ops/pallas/histogram_int8.py:43), through the same
//     tile_pallas_histogram from histogram_pallas_int8 (:109, :128): the
//     same histogram of quantized gradients on the 2-digit int8 grid of
//     int8_digit_rows (:86), q = clip(round(x / scale), +-QMAX) * (m > 0),
//     q = hi*128 + lo, int8 x int8 -> exact i32 planes.
// The JAX package gathers the window's rows (bins_pad[cidx], ops/
// grower.py:1274-1325) in XLA before the kernel; here each warp reads its
// rows' indices from the window itself, so the gather is part of the load.
// A window with no index (order == nullptr) runs over rows start..start+cnt
// (the root).  Output: f32 [K, F, B, 3], or raw i32 [K, F, B, 5] digit sums
// (S_g_hi, S_g_lo, S_h_hi, S_h_lo, count) that ops/seg.py combine_int8
// recombines outside the kernel, as combine_hist_raw does on the TPU.
//
// The TPU needs the one-hot matmul because it has no fast scatter-add; the
// card scatters into shared memory, in two passes (two launches):
//   1. the accumulate, a grid of (row chunk, 32-feature group, window)
//      blocks.  Lane j of every warp owns feature f0 + j, and a block's
//      histogram is [plane][bin][32] words in shared memory, so lane j's
//      cell is always in bank j: the 32 adds of a warp never share a bank
//      or an address, whatever the bins (a skewed feature included).  The
//      chunks of a window are as many as fill the card once, each of at
//      least kMinRows rows.  How a block adds (Acc):
//        * int8 (ordered_hist_accumulate): 32 warps, one row at a time a
//          warp, its 32 lanes reading 32 consecutive bin bytes of the row
//          (one 32-byte sector) and adding the row's digits with shared
//          integer atomics, whose sums do not depend on the order; the
//          digits of 32 rows are made once, one row a lane, and passed to
//          the warp by shuffles, the bins of 8 rows loaded before their
//          adds;
//        * f32 (ordered_hist_in_order): one warp, the block's only thread
//          of each cell, adding the chunk's rows in row order with plain
//          loads and stores, so that a block's sums are those of one add
//          after another and the same on every run (shared f32 atomics from
//          several warps add in the order the warps reach a cell, which
//          changes from run to run; sm_90 has no shared f32 atomic add
//          either: atomicAdd(float*) there is a compare-and-swap loop).
//          Lane u stages row u of a batch of 32 (its g, h, m and its
//          group's 32 bin bytes) in a ring of eight batches in shared
//          memory by cp.async, seven batches ahead of the adds (the row
//          indices of a window, by cp.async into a ring of their own, eight
//          batches before that), so that a gathered window's loads (a
//          random row each) are in flight while earlier batches add; lane
//          j takes each row's (g, h, m) (a
//          broadcast) and its own feature's byte from the ring; four rows
//          at a time, a row whose cell an earlier row of the four holds
//          adding to that row's new value; a trash bin takes the rows that
//          add nothing (a bin >= nbins, a lane past the features), so no
//          row needs a test;
//      the block then copies its whole histogram to its own slot of a
//      scratch buffer;
//   2. ordered_hist_reduce sums each output cell over the window's chunks,
//      in chunk order, and writes every cell (zeros included) through a
//      shared-memory transpose, so that each feature's bins go out as one
//      run.  No global atomics, the output needs no zeroing, and the sums
//      are the same on every run in both modes.
// A warp step of the int8 atomics (one row of 32 features, 5 atomics)
// costs about 16 cycles of a multiprocessor (PERF.md); the f32 warp does
// six shared-memory operations a row, at two warps a multiprocessor (its
// 98 KB table).
//
// What bounds it on an H100 in principle: memory, one pass over cnt *
// (F + 16) bytes (the bins, three f32 statistics and the row index) plus
// the output; the kernel reads each bin byte once (whole sectors) and the
// statistics once per feature group (from L2 after the first).  In
// practice the shared-memory pipe bounds it (above).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnroll = 8;  // int8: rows whose bins are loaded before their adds
constexpr int kMaxWindows = 16;
constexpr int kQmax = 127 * 128;
constexpr int kReduceThreads = 256;
constexpr int kOrderBins = 257;  // the in-order table's bins: 256 and a trash bin
constexpr int kOrderPlane = kOrderBins * 32;  // words of a plane of that table

struct Windows {
  long long start[kMaxWindows];
  long long cnt[kMaxWindows];
};

// How an accumulate block adds (see the top): int8, 32 warps with shared
// integer atomics; f32, one warp in row order.  A cell is kWords 32-bit
// words in the image a block leaves in the scratch, one per plane (f32: g,
// h, count; int8: g_hi, g_lo, h_hi, h_lo, count), each plane a [bin][32]
// table, so lane j's cells are all in column j (bank j).
template <bool kInt8>
struct Acc {
  static constexpr int kWords = kInt8 ? 5 : 3;
  static constexpr int kThreads = kInt8 ? 1024 : 32;
  static constexpr long long kMinRows = kInt8 ? 1024 : 256;  // rows of a chunk, where a window has them
  // bins of one reduce block: f32 windows have more chunks a window
  // (kMinRows), so their tiles are smaller, one cell a thread
  static constexpr int kReduceBins = kInt8 ? 32 : 8;
  // bytes of a block's image in the scratch
  static size_t image_bytes(int nbins) { return (size_t)kWords * nbins * 32 * 4; }
  // bytes of a block's shared memory: the image itself (int8), or the
  // in-order table, (g, h) pairs f32 [kOrderBins][32] and counts i32
  // [kOrderBins][32], then the ring of staged batches (f32)
  static size_t shared_bytes(int nbins);
};

// q = clip(round_half_even(x / scale), +-QMAX) * mi as two digits, with
// IEEE division as int8_digit_rows divides (nvcc divides exactly by default)
__device__ __forceinline__ void quant_digits(float x, float scale, int mi,
                                             int& hi, int& lo) {
  float q = rintf(x / scale);
  q = fminf(fmaxf(q, -(float)kQmax), (float)kQmax);
  const int qi = (int)q * mi;
  hi = (qi + 64) >> 7;
  lo = qi - hi * 128;
}

// The int8 digits one row adds, packed a byte each (g_hi, g_lo, h_hi,
// h_lo; |hi| <= 127, |lo| <= 64), and its count.
__device__ __forceinline__ void digit_vals(float g, float h, float m, float sg, float sh,
                                           unsigned& w, int& c) {
  const int mi = m > 0.0f ? 1 : 0;
  int ghi, glo, hhi, hlo;
  quant_digits(g, sg, mi, ghi, glo);
  quant_digits(h, sh, mi, hhi, hlo);
  w = (unsigned)(ghi & 0xff) | ((unsigned)(glo & 0xff) << 8) | ((unsigned)(hhi & 0xff) << 16) |
      ((unsigned)(hlo & 0xff) << 24);
  c = mi;
}

__device__ __forceinline__ int digit(unsigned w, int k) {
  return (int)(w << (24 - 8 * k)) >> 24;  // signed byte k
}

// row chunks of a window of cnt rows in a launch of `grid_chunks` (>= 1:
// an empty window still writes its zero histogram)
template <bool kInt8>
__device__ __host__ __forceinline__ long long window_chunks(long long cnt,
                                                            long long grid_chunks) {
  long long c = (cnt + Acc<kInt8>::kMinRows - 1) / Acc<kInt8>::kMinRows;
  if (c > grid_chunks) c = grid_chunks;
  return c < 1 ? 1 : c;
}

// Pass 1, int8: the (row chunk, feature group, window) block's digit sums
// in shared memory, copied out whole into its slot of the scratch.
__global__ void __launch_bounds__(Acc<true>::kThreads)
    ordered_hist_accumulate(const uint8_t* __restrict__ bins, long long stride,
                            const int* __restrict__ order, const float* __restrict__ g,
                            const float* __restrict__ h, const float* __restrict__ m,
                            Windows win, int f, int nbins, const float* __restrict__ scales,
                            int* __restrict__ scratch) {
  using A = Acc<true>;
  constexpr int kWarps = A::kThreads / 32;
  extern __shared__ __align__(16) int smem[];

  const int k = blockIdx.z;
  const long long start = win.start[k];
  const long long cnt = win.cnt[k];
  const long long chunks = window_chunks<true>(cnt, gridDim.x);
  if ((long long)blockIdx.x >= chunks) return;  // whole block: no barrier yet

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f0 = blockIdx.y * 32;
  const int pw = nbins * 32;  // words of a 32-bit plane
  const int words = A::kWords * pw;
  for (int i = threadIdx.x; i < words; i += A::kThreads) smem[i] = 0;
  __syncthreads();

  const bool has = f0 + lane < f;  // whether the lane's feature exists
  const float sg = scales[0], sh = scales[1];
  const long long rows_per_block = (cnt + chunks - 1) / chunks;
  const long long i0 = (long long)blockIdx.x * rows_per_block;
  const long long i1 = min(i0 + rows_per_block, cnt);
  const uint8_t* col = bins + f0 + lane;

  for (long long base = i0 + (long long)warp * 32; base < i1; base += (long long)kWarps * 32) {
    // lane u holds row base + u: its index and the digits it adds
    const int nvalid = (int)min(32LL, i1 - base);
    long long r = 0;
    unsigned dw = 0;
    int dc = 0;
    if (lane < nvalid) {
      r = order != nullptr ? (long long)order[start + base + lane] : start + base + lane;
      digit_vals(g[r], h[r], m[r], sg, sh, dw, dc);
    }
    for (int u0 = 0; u0 < nvalid; u0 += kUnroll) {
      int b[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const long long rq = __shfl_sync(0xffffffffu, r, u0 + q);
        b[q] = (u0 + q < nvalid && has) ? (int)col[rq * stride] : nbins;
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const unsigned w = __shfl_sync(0xffffffffu, dw, u0 + q);
        const int c = __shfl_sync(0xffffffffu, dc, u0 + q);
        if (b[q] < nbins) {
          const int cell = b[q] * 32 + lane;
#pragma unroll
          for (int p = 0; p < 4; ++p) atomicAdd(&smem[p * pw + cell], digit(w, p));
          atomicAdd(&smem[4 * pw + cell], c);
        }
      }
    }
  }
  __syncthreads();

  // the image, 16 bytes a thread (words is a multiple of 32)
  const long long slot = ((long long)k * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  int4* dst = reinterpret_cast<int4*>(scratch + slot * words);
  const int4* src = reinterpret_cast<const int4*>(smem);
  for (int i = threadIdx.x; i < words / 4; i += A::kThreads) dst[i] = src[i];
}

// The f32 block's ring of staged batches: kRing batches of 32 rows, each
// row's (g, h, m) and its group's 32 bin bytes, copied from global memory
// by cp.async kRing - 1 batches ahead of the adds, so that the loads of a
// gathered window (a random row each) are in flight while earlier batches
// add, without registers held for them.
constexpr int kRing = 8;
constexpr int kIndexSlots = 16;  // the index ring: batches of 32 row indices
struct Slot {
  float4 row[32];  // (g, h, m, 0) of row q
  uint4 bins[64];  // row q's bytes f0 .. f0 + 31 at bytes 32 q .. 32 q + 31
};
constexpr int kOrderWords = 3 * kOrderPlane;  // of the table, before the ring

__device__ __forceinline__ void cp_async(void* smem, const void* gmem, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
  }
}

// lane's row of the batch at `base` of the chunk ending at i1, or -1
__device__ __forceinline__ long long row_of(const int* order, long long start, long long base,
                                            long long i1, int lane) {
  if (base + lane >= i1) return -1;
  return order != nullptr ? (long long)__ldg(order + start + base + lane) : start + base + lane;
}

// Lane u's copy of its row index of the batch at `base` into the index
// ring (-1 for no row); committed with the next staged batch.
__device__ __forceinline__ void stage_index(int* slot, const int* order, long long start,
                                            long long base, long long i1, int lane) {
  if (base + lane < i1) cp_async(slot + lane, order + start + base + lane, 4);
  else slot[lane] = -1;
}

// Lane u's copies of row r into the slot (zeros for no row), then the
// batch's commit: one cp.async group a batch, empty ones included, so
// that the group count tells which batches have landed.
__device__ __forceinline__ void stage_row(Slot* slot, long long r, const uint8_t* grp,
                                          long long stride, bool two, const float* g,
                                          const float* h, const float* m, int lane) {
  if (r >= 0) {
    float* row = reinterpret_cast<float*>(&slot->row[lane]);
    cp_async(row, g + r, 4);
    cp_async(row + 1, h + r, 4);
    cp_async(row + 2, m + r, 4);
    const uint4* p = reinterpret_cast<const uint4*>(grp + r * stride);
    cp_async(&slot->bins[2 * lane], p, 16);
    if (two) cp_async(&slot->bins[2 * lane + 1], p + 1, 16);
    else slot->bins[2 * lane + 1] = make_uint4(0u, 0u, 0u, 0u);
  } else {
    slot->row[lane] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    slot->bins[2 * lane] = slot->bins[2 * lane + 1] = make_uint4(0u, 0u, 0u, 0u);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One staged batch of nv rows added in row order by the block's only warp:
// lane j to its feature's cells (gh, counts: the lane's columns of the
// pairs and counts), kGroup rows at a time: their cells read, then each row's
// sums taken from the latest earlier row of the group with the same cell,
// or else from the cell, then written back in row order, so that the last
// write of a cell holds all its rows.  Rows past nv add +0.0 and no count.
constexpr int kGroup = 4;

__device__ __forceinline__ void add_in_order(float2* gh, int* counts, const Slot* slot, int nv,
                                             int nbins, bool has, int lane) {
  const uint8_t* bb = reinterpret_cast<const uint8_t*>(slot->bins) + lane;
#pragma unroll
  for (int q0 = 0; q0 < 32; q0 += kGroup) {
    if (q0 >= nv) break;  // nv is the same on every lane
    int cell[kGroup], oc[kGroup], c[kGroup];
    float2 x[kGroup], o[kGroup];
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const float4 v = slot->row[q0 + k];  // a broadcast
      x[k] = make_float2(v.x * v.z, v.y * v.z);
      c[k] = v.z != 0.0f ? 1 : 0;
      const int b = bb[(q0 + k) * 32];
      cell[k] = (has && b < nbins ? b : kOrderBins - 1) * 32;
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      o[k] = gh[cell[k]];
      oc[k] = counts[cell[k]];
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
      oc[k] += c[k];
    }
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      gh[cell[k]] = o[k];
      counts[cell[k]] = oc[k];
    }
  }
}

// Pass 1, f32: the (row chunk, feature group, window) block's sums, one
// warp adding the chunk's rows in row order from the ring, copied out as
// the image [plane][bin][32] into its slot of the scratch.
__global__ void __launch_bounds__(Acc<false>::kThreads)
    ordered_hist_in_order(const uint8_t* __restrict__ bins, long long stride,
                          const int* __restrict__ order, const float* __restrict__ g,
                          const float* __restrict__ h, const float* __restrict__ m,
                          Windows win, int f, int nbins, int* __restrict__ scratch) {
  using A = Acc<false>;
  extern __shared__ __align__(16) int smem[];

  const int k = blockIdx.z;
  const long long start = win.start[k];
  const long long cnt = win.cnt[k];
  const long long chunks = window_chunks<false>(cnt, gridDim.x);
  if ((long long)blockIdx.x >= chunks) return;

  const int lane = threadIdx.x;
  const int f0 = blockIdx.y * 32;
  int4* zero = reinterpret_cast<int4*>(smem);
  for (int i = lane; i < kOrderWords / 4; i += 32) zero[i] = make_int4(0, 0, 0, 0);

  float2* gh = reinterpret_cast<float2*>(smem) + lane;
  int* cnts = smem + 2 * kOrderPlane + lane;
  Slot* ring = reinterpret_cast<Slot*>(smem + kOrderWords);
  int* idx = reinterpret_cast<int*>(ring + kRing);  // [kIndexSlots][32]
  const bool has = f0 + lane < f;
  const bool two = f0 + 16 < f;  // then f0 + 32 <= stride: the second 16 bytes are the row's
  const uint8_t* grp = bins + f0;
  const long long rows_per_block = (cnt + chunks - 1) / chunks;
  const long long i0 = (long long)blockIdx.x * rows_per_block;
  const long long i1 = min(i0 + rows_per_block, cnt);

  // batches 0 .. kRing - 2 in flight, and (with an index) the indices of
  // the next kRing batches in the index ring: an index is copied kRing
  // batches before its batch is staged, since an index load is a round
  // trip that one batch's adds do not cover
#pragma unroll 1
  for (long long j = 0; j < 2 * kRing - 1; ++j) {
    const long long b0 = i0 + 32 * j;
    if (j < kRing - 1) {
      stage_row(&ring[j], row_of(order, start, b0, i1, lane), grp, stride, two, g, h, m, lane);
    } else if (order != nullptr) {
      stage_index(idx + (j % kIndexSlots) * 32, order, start, b0, i1, lane);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  long long batch = 0;
  for (long long base = i0; base < i1; base += 32, ++batch) {
    const long long j = batch + kRing - 1;  // the batch staged now
    const long long r = order == nullptr ? row_of(nullptr, start, i0 + 32 * j, i1, lane)
                                         : idx[(j % kIndexSlots) * 32 + lane];
    if (order != nullptr) stage_index(idx + ((j + kRing) % kIndexSlots) * 32, order, start,
                                      i0 + 32 * (j + kRing), i1, lane);
    stage_row(&ring[j % kRing], r, grp, stride, two, g, h, m, lane);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kRing - 1) : "memory");
    __syncwarp();  // every lane's copies of this batch have landed
    add_in_order(gh, cnts, &ring[batch % kRing], (int)min(32LL, i1 - base), nbins, has, lane);
    __syncwarp();  // the slot is free for the batch kRing - 1 ahead
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncwarp();

  // the image: the pairs split into the g and h planes, then the counts
  const int pw = nbins * 32;
  int4* dst = reinterpret_cast<int4*>(scratch + ((long long)k * gridDim.y + blockIdx.y) *
                                                    gridDim.x * A::kWords * pw +
                                      (long long)blockIdx.x * A::kWords * pw);
  const float4* pr = reinterpret_cast<const float4*>(smem);
  const int4* src = reinterpret_cast<const int4*>(smem);
  for (int i = lane; i < pw / 4; i += 32) {
    const float4 a = pr[2 * i], b = pr[2 * i + 1];
    dst[i] = make_int4(__float_as_int(a.x), __float_as_int(a.z), __float_as_int(b.x),
                       __float_as_int(b.z));
    dst[pw / 4 + i] = make_int4(__float_as_int(a.y), __float_as_int(a.w), __float_as_int(b.y),
                                __float_as_int(b.w));
    dst[pw / 2 + i] = src[2 * kOrderPlane / 4 + i];
  }
}

template <bool kInt8>
size_t Acc<kInt8>::shared_bytes(int nbins) {
  return kInt8 ? image_bytes(nbins)
               : (size_t)kOrderWords * 4 + kRing * sizeof(Slot) + kIndexSlots * 32 * 4;
}

// One cell of an image in the scratch as the output planes: f32 (g, h,
// count) or i32 digit sums.
template <bool kInt8>
__device__ __forceinline__ void read_cell(const int* s, int cell, int pw, int (&o)[5],
                                          float (&of)[3]) {
  if constexpr (kInt8) {
#pragma unroll
    for (int p = 0; p < 5; ++p) o[p] = s[p * pw + cell];
  } else {
    const float* sf = reinterpret_cast<const float*>(s);
    of[0] = sf[cell];
    of[1] = sf[pw + cell];
    of[2] = (float)s[2 * pw + cell];
  }
}

// Pass 2: each (32 features, kReduceBins bins, window) tile of the output
// summed over the window's chunks, in chunk order, transposed in shared
// memory and written out whole (every cell, zeros included).
template <bool kInt8>
__global__ void __launch_bounds__(kReduceThreads)
    ordered_hist_reduce(const int* __restrict__ scratch, Windows win, int f, int nbins,
                        int grid_chunks, void* __restrict__ out) {
  using A = Acc<kInt8>;
  constexpr int P = A::kWords;
  constexpr int kBins = A::kReduceBins;
  constexpr int kRow = kBins * P + 1;  // words a feature, odd: no conflicts
  __shared__ int tile[32 * kRow];

  const int k = blockIdx.z;
  const int grp = blockIdx.y;
  const int bin0 = blockIdx.x * kBins;
  const int nb = min(kBins, nbins - bin0);
  const int pw = nbins * 32;
  const int words = P * pw;
  const long long chunks = window_chunks<kInt8>(win.cnt[k], grid_chunks);
  const int* part = scratch + ((long long)k * gridDim.y + grp) * grid_chunks * (long long)words;

  for (int e = threadIdx.x; e < nb * 32; e += kReduceThreads) {
    const int j = e & 31;
    const int cell = (bin0 + (e >> 5)) * 32 + j;
    int o[5] = {0, 0, 0, 0, 0};
    float of[3] = {0.0f, 0.0f, 0.0f};
    // f32: kLoads chunks' cells loaded before they are added (in chunk
    // order, the same sums); int8 one at a time
    constexpr int kLoads = kInt8 ? 1 : 4;
    for (long long c0 = 0; c0 < chunks; c0 += kLoads) {
      int oc[kLoads][5];
      float ofc[kLoads][3];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (c0 + u < chunks) read_cell<kInt8>(part + (c0 + u) * words, cell, pw, oc[u], ofc[u]);
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (c0 + u >= chunks) break;
#pragma unroll
        for (int p = 0; p < 5; ++p) o[p] += oc[u][p];
#pragma unroll
        for (int p = 0; p < 3; ++p) of[p] += ofc[u][p];
      }
    }
    int* row = tile + j * kRow + (e >> 5) * P;
    if constexpr (kInt8) {
#pragma unroll
      for (int p = 0; p < 5; ++p) row[p] = o[p];
    } else {
#pragma unroll
      for (int p = 0; p < 3; ++p) row[p] = __float_as_int(of[p]);
    }
  }
  __syncthreads();

  // each feature's nb * P words are one run of the output
  const int f0 = grp * 32;
  for (int x = threadIdx.x; x < 32 * nb * P; x += kReduceThreads) {
    const int j = x / (nb * P);
    const int y = x % (nb * P);
    if (f0 + j >= f) continue;
    const long long o = (((long long)k * f + f0 + j) * nbins + bin0) * P + y;
    reinterpret_cast<int*>(out)[o] = tile[j * kRow + y];
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 1;
  }
  return sms;
}

template <bool kInt8>
const void* accumulate_fn() {
  return kInt8 ? (const void*)ordered_hist_accumulate : (const void*)ordered_hist_in_order;
}

// blocks of the accumulate pass a multiprocessor holds at 256 bins (0 on
// error, with the error in *err)
template <bool kInt8>
int resident_blocks(cudaError_t* err) {
  static int resident = 0;
  if (resident == 0) {
    const int bytes = (int)Acc<kInt8>::shared_bytes(256);
    *err = cudaFuncSetAttribute(accumulate_fn<kInt8>(),
                                cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (*err != cudaSuccess) return 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, accumulate_fn<kInt8>(),
                                                         Acc<kInt8>::kThreads, bytes);
    if (*err != cudaSuccess) return 0;
    if (resident < 1) *err = cudaErrorInvalidConfiguration;
  }
  return resident;
}

// row chunks of the launch: enough blocks to fill the card once, each with
// at least kMinRows rows
template <bool kInt8>
long long grid_chunks(int k, long long max_cnt, int groups, int resident) {
  long long chunks = (max_cnt + Acc<kInt8>::kMinRows - 1) / Acc<kInt8>::kMinRows;
  long long cap = (long long)resident * sm_count() / ((long long)groups * k);
  if (cap < 1) cap = 1;
  if (chunks > cap) chunks = cap;
  return chunks < 1 ? 1 : chunks;
}

template <bool kInt8>
long long scratch_bytes(int k, long long max_cnt, int f, int nbins, int* groups_out,
                        long long* chunks_out) {
  cudaError_t e = cudaSuccess;
  const int resident = resident_blocks<kInt8>(&e);
  if (e != cudaSuccess) return -(long long)e;
  const int groups = (f + 31) / 32;
  const long long chunks = grid_chunks<kInt8>(k, max_cnt, groups, resident);
  if (groups_out) *groups_out = groups;
  if (chunks_out) *chunks_out = chunks;
  return (long long)k * groups * chunks * (long long)Acc<kInt8>::image_bytes(nbins);
}

template <bool kInt8>
int launch(const void* bins, long long stride, const void* order, const void* g, const void* h,
           const void* m, const Windows& win, int k, long long max_cnt, int f, int nbins,
           const void* scales, void* scratch, long long scratch_size, void* out,
           cudaStream_t stream) {
  int groups = 0;
  long long chunks = 0;
  const long long need = scratch_bytes<kInt8>(k, max_cnt, f, nbins, &groups, &chunks);
  if (need < 0) return (int)(-need);
  if (scratch_size < need || scratch == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)chunks, (unsigned)groups, (unsigned)k);
  const size_t smem = Acc<kInt8>::shared_bytes(nbins);
  if constexpr (kInt8) {
    ordered_hist_accumulate<<<grid, Acc<true>::kThreads, smem, stream>>>(
        (const uint8_t*)bins, stride, (const int*)order, (const float*)g, (const float*)h,
        (const float*)m, win, f, nbins, (const float*)scales, (int*)scratch);
  } else {
    ordered_hist_in_order<<<grid, Acc<false>::kThreads, smem, stream>>>(
        (const uint8_t*)bins, stride, (const int*)order, (const float*)g, (const float*)h,
        (const float*)m, win, f, nbins, (int*)scratch);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr int kBins = Acc<kInt8>::kReduceBins;
  dim3 rgrid((unsigned)((nbins + kBins - 1) / kBins), (unsigned)groups, (unsigned)k);
  ordered_hist_reduce<kInt8><<<rgrid, kReduceThreads, 0, stream>>>(
      (const int*)scratch, win, f, nbins, (int)chunks, out);
  return (int)cudaGetLastError();
}

bool read_windows(const long long* windows, int k, Windows* win,
                  long long* max_cnt) {
  if (k < 1 || k > kMaxWindows) return false;
  *max_cnt = 0;
  for (int i = 0; i < k; ++i) {
    win->start[i] = windows[2 * i];
    win->cnt[i] = windows[2 * i + 1] > 0 ? windows[2 * i + 1] : 0;
    if (win->cnt[i] > *max_cnt) *max_cnt = win->cnt[i];
  }
  return true;
}

}  // namespace

// Bytes of scratch that lgbt_ordered_hist needs for these windows (HOST
// [k, 2] i64 (start, cnt)), f features, nbins bins, int8 != 0 for the int8
// mode; a negative value is minus a CUDA error code.
extern "C" long long lgbt_ordered_hist_scratch(const long long* windows, int k,
                                               int f, int nbins, int int8) {
  Windows win;
  long long max_cnt = 0;
  if (!read_windows(windows, k, &win, &max_cnt) || f <= 0 || nbins <= 0 ||
      nbins > 256)
    return -(long long)cudaErrorInvalidValue;
  return int8 ? scratch_bytes<true>(k, max_cnt, f, nbins, nullptr, nullptr)
              : scratch_bytes<false>(k, max_cnt, f, nbins, nullptr, nullptr);
}

// bins: [n, stride] u8 row-major, stride a multiple of 16 and >= f, 16-byte
// aligned; order: [*] i32 row indices, or null (windows index rows
// directly); g, h, m: [n] f32; windows: HOST [k, 2] i64 (start, cnt) into
// order (or the rows); scales: device [2] f32 (g_scale, h_scale) for the
// int8 mode, null for f32; scratch: device, 16-byte aligned, of at least
// lgbt_ordered_hist_scratch(...) bytes.  out (every cell is written): f32
// [k, f, nbins, 3], or (int8) i32 [k, f, nbins, 5] raw planes.  nbins <=
// 256.  Two launches (accumulate, reduce).  Returns cudaGetLastError()
// after them (0 on success).
extern "C" int lgbt_ordered_hist(const void* bins, long long stride,
                                 const void* order, const void* g,
                                 const void* h, const void* m,
                                 const long long* windows, int k, int f,
                                 int nbins, const void* scales, void* scratch,
                                 long long scratch_size, void* out,
                                 void* stream) {
  Windows win;
  long long max_cnt = 0;
  if (!read_windows(windows, k, &win, &max_cnt) || f <= 0 || nbins <= 0 ||
      nbins > 256 || stride % 16 || stride < f)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (scales != nullptr)
    return launch<true>(bins, stride, order, g, h, m, win, k, max_cnt, f,
                        nbins, scales, scratch, scratch_size, out, st);
  return launch<false>(bins, stride, order, g, h, m, win, k, max_cnt, f,
                       nbins, nullptr, scratch, scratch_size, out, st);
}
