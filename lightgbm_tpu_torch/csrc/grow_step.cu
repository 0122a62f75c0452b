// Fused grow step: for K disjoint leaf windows of the segment-resident rows,
// in ONE launch, the stable partition of each window, the smaller-child
// election and the smaller child's (g, h, count) histogram.
//
// Replaces the TPU kernel _fused_grow_kernel
// (lightgbm_tpu/ops/pallas/grow_step.py:90, launched through pl.pallas_call
// at grow_step.py:260 by fused_grow_step_pallas; dispatch fused_grow_step
// :318).  Same contract as its XLA oracle (grow_step.py:388-411): each
// window [start, start + cnt) is partitioned stably in place (left rows, in
// their order, to [start, start + nl), the rest after them), the smaller
// child is the left one when nl <= nr, and dec[k] = (nl, nr, child_start,
// child_cnt); the histogram is the smaller child's, in f32 or on the int8
// 2-digit grid (hist_block.cuh).  Numeric splits only (as partition.cu).
//
// The TPU kernel relies on grid programs running in order: program (i, 0)
// partitions and writes dec, programs (i, pt > 0) read it back.  CUDA blocks
// run in no order, so this kernel is ONE cooperative launch (every block
// resident at once, cudaLaunchCooperativeKernel) whose phases are separated
// by grid-wide barriers (cooperative_groups grid.sync()), with grid-stride
// loops over (window, 1024-row tile) pairs:
//   1. count:   each tile counts its rows that go left;
//   2. scan:    one block per window turns its tile counts into exclusive
//               offsets, giving nl and the election;
//   3. scatter: each tile ranks its flags with a block scan (stable) and
//               writes every column of every row to its final place in a
//               scratch window; in the same pass every row bound for the
//               smaller child is added to the block's shared-memory
//               histogram (first feature group), so the histogram reads no
//               extra bytes;  the block flushes it with global atomics
//               whenever its next tile lies in another window, and at the
//               end;
//   4. copy:    the scratch windows are copied back over the rows; feature
//               groups beyond the first (when F * B does not fit shared
//               memory at once) are histogrammed from the scratch child rows.
//
// What bounds it on an H100: memory.  The least traffic is reading each
// window's rows once and writing them once, 2 * cnt * (F + 16) bytes, plus
// the F * B output cells; the histogram rides the scatter.  The design moves
// the rows twice (through the scratch) and reads the split feature's bytes
// twice more, the price of a stable partition without ordered blocks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_block.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kRowsPerThread = 2;
constexpr int kTile = kThreads * kRowsPerThread;  // 1024 rows per tile
constexpr int kMaxWindows = 16;
constexpr int kSharedBudget = 200 * 1024;

struct Windows {
  int k;
  long long start[kMaxWindows];
  long long cnt[kMaxWindows];
  long long row0[kMaxWindows + 1];   // prefix of cnt: scratch offsets
  long long tile0[kMaxWindows + 1];  // prefix of tile counts
  int feat[kMaxWindows];
  int tbin[kMaxWindows];
  int dl[kMaxWindows];
  int nanb[kMaxWindows];
};

struct Rows {
  uint8_t* bins;  // [f, n_pad]
  float* g;
  float* h;
  float* m;
  int* ridx;
  long long n_pad;
  int f;
};

struct Scratch {
  uint8_t* bins;  // [f, total]
  float* g;
  float* h;
  float* m;
  int* ridx;
  long long total;
  int* tile_counts;  // [tiles]
  int* dec;          // [k, 4]
};

__device__ __forceinline__ int go_left(int v, int tbin, int dl, int nanb) {
  return (v <= tbin) || (dl && nanb >= 0 && v == nanb);
}

__device__ __forceinline__ int window_of(const Windows& w, long long tile) {
  int i = 0;
  while (i + 1 < w.k && tile >= w.tile0[i + 1]) ++i;
  return i;
}

// exclusive scan of one int per thread over the block; returns this
// thread's prefix and writes the block total to *total
__device__ int block_exclusive_scan(int x, int* total) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int v = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, v, d);
    if (lane >= d) v += y;
  }
  if (lane == 31) warp_sums[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < kThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, s, d);
      if (lane >= d) s += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = s;  // inclusive
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();
  return before + v - x;
}

template <bool kInt8>
__device__ void flush_window(lgbt::BlockHist<kInt8>& acc, int cells,
                             void* out, int win, int f, int f0, int nbins) {
  constexpr int planes = lgbt::BlockHist<kInt8>::kPlanes;
  const long long cell0 = ((long long)win * f + f0) * nbins;
  __syncthreads();
  if constexpr (kInt8) {
    acc.flush(cells, reinterpret_cast<int*>(out) + cell0 * planes);
  } else {
    acc.flush(cells, reinterpret_cast<float*>(out) + cell0 * planes);
  }
  __syncthreads();
  acc.zero(cells);
  __syncthreads();
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
    fused_grow_kernel(Rows rows, Scratch sc, Windows w, int nbins, int group,
                      const float* scales, void* out) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const int f = rows.f;
  const long long n_pad = rows.n_pad;
  const long long tiles = w.tile0[w.k];

  // ---- 1. count the left rows of every tile
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int wi = window_of(w, t);
    const long long base = (t - w.tile0[wi]) * kTile;
    const uint8_t* col = rows.bins + (long long)w.feat[wi] * n_pad + w.start[wi];
    int c = 0;
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const long long r = base + i;
      if (r < w.cnt[wi]) c += go_left(col[r], w.tbin[wi], w.dl[wi], w.nanb[wi]);
    }
    int total;
    block_exclusive_scan(c, &total);
    if (threadIdx.x == 0) sc.tile_counts[t] = total;
  }
  grid.sync();

  // ---- 2. per window: exclusive offsets of its tiles, nl, the election
  for (int wi = blockIdx.x; wi < w.k; wi += gridDim.x) {
    const long long t0 = w.tile0[wi];
    const long long nt = w.tile0[wi + 1] - t0;
    int carry = 0;
    for (long long b0 = 0; b0 < nt; b0 += kThreads) {
      const long long i = b0 + threadIdx.x;
      const int x = i < nt ? sc.tile_counts[t0 + i] : 0;
      int total;
      const int ex = block_exclusive_scan(x, &total);
      if (i < nt) sc.tile_counts[t0 + i] = carry + ex;
      carry += total;
    }
    if (threadIdx.x == 0) {
      const int nl = carry;
      const int nr = (int)w.cnt[wi] - nl;
      const bool left_smaller = nl <= nr;
      sc.dec[4 * wi] = nl;
      sc.dec[4 * wi + 1] = nr;
      sc.dec[4 * wi + 2] = (int)w.start[wi] + (left_smaller ? 0 : nl);
      sc.dec[4 * wi + 3] = left_smaller ? nl : nr;
    }
  }
  grid.sync();

  // ---- 3. stable scatter into the scratch windows, smaller child's rows
  // into the block histogram (features [0, group))
  const int nf0 = min(group, f);
  const int cells0 = nf0 * nbins;
  lgbt::BlockHist<kInt8> acc(smem, group * nbins);
  acc.zero(cells0);
  __syncthreads();
  const float inv_g = lgbt::inv_scale(scales, 0);
  const float inv_h = lgbt::inv_scale(scales, 1);
  int cur = -1;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int wi = window_of(w, t);
    if (wi != cur) {
      if (cur >= 0) flush_window<kInt8>(acc, cells0, out, cur, f, 0, nbins);
      cur = wi;
    }
    const long long start = w.start[wi];
    const long long cnt = w.cnt[wi];
    const long long base = (t - w.tile0[wi]) * kTile;
    const long long r0 = base + (long long)threadIdx.x * kRowsPerThread;
    const uint8_t* col = rows.bins + (long long)w.feat[wi] * n_pad + start;
    int flags[kRowsPerThread];
    int mine = 0;
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const long long r = r0 + q;
      flags[q] = r < cnt ? go_left(col[r], w.tbin[wi], w.dl[wi], w.nanb[wi]) : 0;
      mine += flags[q];
    }
    int total;
    const int left_before = block_exclusive_scan(mine, &total);
    const long long lbase = sc.tile_counts[t];
    const long long nl = sc.dec[4 * wi];
    const int child_left = nl <= cnt - nl;
    const long long rows_before = (long long)threadIdx.x * kRowsPerThread;
    long long lpos = lbase + left_before;
    long long rpos = nl + (base - lbase) + (rows_before - left_before);
    const long long s0 = w.row0[wi];
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const long long r = r0 + q;
      if (r >= cnt) break;
      const long long dst = s0 + (flags[q] ? lpos++ : rpos++);
      const long long src = start + r;
      const float gv = rows.g[src];
      const float hv = rows.h[src];
      const float mv = rows.m[src];
      sc.g[dst] = gv;
      sc.h[dst] = hv;
      sc.m[dst] = mv;
      sc.ridx[dst] = rows.ridx[src];
      if (flags[q] == child_left) {
        const auto s = lgbt::row_stat<kInt8>(gv, hv, mv, inv_g, inv_h);
        for (int j = 0; j < nf0; ++j) {
          const int b = rows.bins[(long long)j * n_pad + src];
          sc.bins[(long long)j * sc.total + dst] = (uint8_t)b;
          if (b < nbins) acc.add(j * nbins + b, s);
        }
        for (int j = nf0; j < f; ++j) {
          sc.bins[(long long)j * sc.total + dst] =
              rows.bins[(long long)j * n_pad + src];
        }
      } else {
        for (int j = 0; j < f; ++j) {
          sc.bins[(long long)j * sc.total + dst] =
              rows.bins[(long long)j * n_pad + src];
        }
      }
    }
  }
  if (cur >= 0) flush_window<kInt8>(acc, cells0, out, cur, f, 0, nbins);
  grid.sync();

  // ---- 4. copy the scratch windows back over the rows
  const long long stride = (long long)gridDim.x * kThreads;
  for (int wi = 0; wi < w.k; ++wi) {
    const long long start = w.start[wi];
    const long long s0 = w.row0[wi];
    for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
         r < w.cnt[wi]; r += stride) {
      for (int j = 0; j < f; ++j) {
        rows.bins[(long long)j * n_pad + start + r] =
            sc.bins[(long long)j * sc.total + s0 + r];
      }
      rows.g[start + r] = sc.g[s0 + r];
      rows.h[start + r] = sc.h[s0 + r];
      rows.m[start + r] = sc.m[s0 + r];
      rows.ridx[start + r] = sc.ridx[s0 + r];
    }
  }
  // feature groups beyond the first: the child rows again, from the scratch
  for (int f0 = group; f0 < f; f0 += group) {
    const int nf = min(group, f - f0);
    const int cells = nf * nbins;
    for (int wi = 0; wi < w.k; ++wi) {
      const long long nl = sc.dec[4 * wi];
      const long long cc = sc.dec[4 * wi + 3];
      const long long c0 = w.row0[wi] + (nl <= w.cnt[wi] - nl ? 0 : nl);
      for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
           r < cc; r += stride) {
        const long long src = c0 + r;
        const auto s = lgbt::row_stat<kInt8>(sc.g[src], sc.h[src], sc.m[src],
                                             inv_g, inv_h);
        for (int j = 0; j < nf; ++j) {
          const int b = sc.bins[(long long)(f0 + j) * sc.total + src];
          if (b < nbins) acc.add(j * nbins + b, s);
        }
      }
      flush_window<kInt8>(acc, cells, out, wi, f, f0, nbins);
    }
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
int launch(Rows rows, Scratch sc, Windows w, int nbins, const void* scales,
           void* out, cudaStream_t stream) {
  constexpr int bpc = lgbt::BlockHist<kInt8>::kBytesPerCell;
  int group = kSharedBudget / (bpc * nbins);
  if (group < 1) return (int)cudaErrorInvalidValue;
  if (group > rows.f) group = rows.f;
  const int shared = bpc * group * nbins;
  auto kernel = fused_grow_kernel<kInt8>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                    shared);
  if (e != cudaSuccess) return (int)e;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  long long blocks = (long long)per_sm * sm_count();
  const long long tiles = w.tile0[w.k];
  if (blocks > tiles) blocks = tiles;
  if (blocks < w.k) blocks = w.k;
  const float* sp = (const float*)scales;
  void* args[] = {&rows, &sc, &w, (void*)&nbins, (void*)&group, (void*)&sp,
                  &out};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3((unsigned)blocks),
                                  dim3(kThreads), args, (size_t)shared,
                                  stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// One fused grow step over k disjoint windows.  Host arrays: windows [k, 6]
// i64 rows (start, cnt, feat, tbin, dl, nanb).  Device: bins [f, n_pad] u8,
// g/h/m f32 and ridx i32 [n_pad] (partitioned in place); scratch s_bins
// [f, total] u8, s_g/s_h/s_m f32 and s_ridx i32 [total] with total = sum of
// cnt; tile_counts i32 [sum of ceil(cnt / 1024)]; dec i32 [k, 4] receives
// (nl, nr, child_start, child_cnt); scales device [2] f32 for the int8 mode,
// null for f32; out, zeroed by the caller: f32 [k, f, nbins, 3] or (int8)
// i32 [k, f, nbins, 5].  Returns the CUDA error of the launch (0 on
// success); a grid that cannot be resident at once is refused, not retried.
extern "C" int lgbt_grow_step(void* bins, void* g, void* h, void* m,
                              void* ridx, long long n_pad, int f,
                              const long long* windows, int k, int nbins,
                              void* s_bins, void* s_g, void* s_h, void* s_m,
                              void* s_ridx, void* tile_counts, void* dec,
                              const void* scales, void* out, void* stream) {
  if (k < 1 || k > kMaxWindows || f <= 0 || nbins <= 0)
    return (int)cudaErrorInvalidValue;
  Windows w;
  w.k = k;
  w.row0[0] = 0;
  w.tile0[0] = 0;
  for (int i = 0; i < k; ++i) {
    const long long* r = windows + 6 * i;
    w.start[i] = r[0];
    w.cnt[i] = r[1] > 0 ? r[1] : 0;
    w.feat[i] = (int)r[2];
    w.tbin[i] = (int)r[3];
    w.dl[i] = (int)r[4];
    w.nanb[i] = (int)r[5];
    w.row0[i + 1] = w.row0[i] + w.cnt[i];
    w.tile0[i + 1] = w.tile0[i] + (w.cnt[i] + kTile - 1) / kTile;
  }
  // every window empty: the wrapper answers without a launch
  if (w.tile0[k] == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  Rows rows{(uint8_t*)bins, (float*)g, (float*)h, (float*)m, (int*)ridx,
            n_pad, f};
  Scratch sc{(uint8_t*)s_bins, (float*)s_g, (float*)s_h, (float*)s_m,
             (int*)s_ridx, w.row0[k], (int*)tile_counts, (int*)dec};
  if (scales != nullptr) return launch<true>(rows, sc, w, nbins, scales, out, st);
  return launch<false>(rows, sc, w, nbins, nullptr, out, st);
}
