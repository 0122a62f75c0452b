// Stable partition of K disjoint leaf windows of the segment-resident rows.
//
// Replaces two TPU kernels:
//   * _seg_partition_kernel (lightgbm_tpu/ops/pallas/partition.py:334, body
//     _partition_window :104), launched through pl.pallas_call at
//     partition.py:446 by seg_partition_pallas: one window;
//   * the same kernel over a K-program grid, launched at partition.py:525
//     by seg_partition_pallas_batch: K disjoint windows in one call, for
//     frontier-batched growth with grow_fused='off'.
// One C entry, lgbt_partition, takes K windows; one window is K = 1.
// Same contract as the XLA oracles sort_partition_xla
// (lightgbm_tpu/ops/segpart.py:65) and sort_partition_batch (:228): the
// rows of each window [start, start + cnt) that go left move, in their
// order, to [start, start + nl), the rest, in their order, to
// [start + nl, start + cnt); rows outside the windows are not touched; a
// window with cnt = 0 is a no-op; nl is returned per window.  Numeric
// splits only: a row goes left when its bin is <= the threshold bin, or when
// it sits in the feature's NaN bin and missing values go left
// (ops/segpart.py:52 _go_left).
//
// Layout (the port's, not the TPU's i16 planes): bins u8 feature-major
// [f, n_pad]; g, h, m f32 and ridx i32 columns [n_pad].
//
// The TPU's K-window kernel is correct only because its K grid programs run
// one after another on the core, each finishing its in-place rewrite before
// the next begins.  CUDA blocks run in no order, so here every phase covers
// all K windows at once over a grid of (window, 1024-row tile) pairs, with
// the per-window tile offsets from a scan:
//   1. count:   one block per tile counts its left rows;
//   2. scan:    one block per window turns its tile counts into exclusive
//               offsets and writes the window's nl;
//   3. scatter: each tile recomputes its flags, ranks them with a block
//               scan (stable), and writes every column of every row to its
//               final place in the window's part of a scratch buffer;
//   4. copy:    the scratch windows are copied back over the rows.
// All four are plain loads and stores: the result is exact and the same on
// every run, and K windows in one call equal K calls of one window.
//
// What bounds it on an H100: memory.  The least traffic is reading the
// windows' rows once and writing them once, 2 * rows * (f + 16) bytes.  The
// design moves them four times (each row's split-feature byte is read twice
// more for the flags) because blocks run in no fixed order and a stable
// scatter needs every tile's left count first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kTile = kThreads * kRowsPerThread;  // 1024 rows per block
constexpr int kMaxWindows = 16;

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
    int w = lane < kThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = w;  // inclusive
  }
  __syncthreads();
  const int before = warp > 0 ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();
  return before + v - x;
}

__global__ void count_kernel(const uint8_t* __restrict__ bins, long long n_pad,
                             Windows w, int* __restrict__ tile_counts) {
  const long long t = blockIdx.x;
  const int wi = window_of(w, t);
  const long long base = (t - w.tile0[wi]) * kTile;
  const uint8_t* col = bins + (long long)w.feat[wi] * n_pad + w.start[wi];
  int c = 0;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long r = base + i;
    if (r < w.cnt[wi]) c += go_left(col[r], w.tbin[wi], w.dl[wi], w.nanb[wi]);
  }
  int total;
  block_exclusive_scan(c, &total);
  if (threadIdx.x == 0) tile_counts[t] = total;
}

// one block per window: exclusive offsets of its tiles (in place) and nl
__global__ void scan_kernel(Windows w, int* __restrict__ tile_counts,
                            int* __restrict__ nl_out) {
  const int wi = blockIdx.x;
  int* counts = tile_counts + w.tile0[wi];
  const long long nt = w.tile0[wi + 1] - w.tile0[wi];
  int carry = 0;
  for (long long b0 = 0; b0 < nt; b0 += kThreads) {
    const long long i = b0 + threadIdx.x;
    const int x = i < nt ? counts[i] : 0;
    int total;
    const int ex = block_exclusive_scan(x, &total);
    if (i < nt) counts[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) nl_out[wi] = carry;
}

__global__ void scatter_kernel(const uint8_t* __restrict__ bins,
                               const float* __restrict__ g,
                               const float* __restrict__ h,
                               const float* __restrict__ m,
                               const int* __restrict__ ridx, long long n_pad,
                               int f, Windows w,
                               const int* __restrict__ tile_offsets,
                               const int* __restrict__ nl_out,
                               uint8_t* __restrict__ s_bins,
                               float* __restrict__ s_g, float* __restrict__ s_h,
                               float* __restrict__ s_m,
                               int* __restrict__ s_ridx) {
  const long long t = blockIdx.x;
  const int wi = window_of(w, t);
  const long long start = w.start[wi];
  const long long cnt = w.cnt[wi];
  const long long total_rows = w.row0[w.k];
  const long long base = (t - w.tile0[wi]) * kTile;
  const long long r0 = base + (long long)threadIdx.x * kRowsPerThread;
  const uint8_t* col = bins + (long long)w.feat[wi] * n_pad + start;
  int flags[kRowsPerThread];
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const long long r = r0 + k;
    flags[k] = r < cnt ? go_left(col[r], w.tbin[wi], w.dl[wi], w.nanb[wi]) : 0;
    mine += flags[k];
  }
  int total;
  const int left_before = block_exclusive_scan(mine, &total);
  const long long lbase = tile_offsets[t];
  const long long nl = nl_out[wi];
  // rows of this tile before this thread's first row, left and right
  const long long rows_before = (long long)threadIdx.x * kRowsPerThread;
  long long lpos = lbase + left_before;
  long long rpos = nl + (base - lbase) + (rows_before - left_before);
  const long long s0 = w.row0[wi];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const long long r = r0 + k;
    if (r >= cnt) break;
    const long long dst = s0 + (flags[k] ? lpos++ : rpos++);
    const long long src = start + r;
    for (int j = 0; j < f; ++j) {
      s_bins[(long long)j * total_rows + dst] = bins[(long long)j * n_pad + src];
    }
    s_g[dst] = g[src];
    s_h[dst] = h[src];
    s_m[dst] = m[src];
    s_ridx[dst] = ridx[src];
  }
}

// blockIdx.y: the window; grid-stride over its rows
__global__ void copy_back_kernel(uint8_t* __restrict__ bins,
                                 float* __restrict__ g, float* __restrict__ h,
                                 float* __restrict__ m, int* __restrict__ ridx,
                                 long long n_pad, int f, Windows w,
                                 const uint8_t* __restrict__ s_bins,
                                 const float* __restrict__ s_g,
                                 const float* __restrict__ s_h,
                                 const float* __restrict__ s_m,
                                 const int* __restrict__ s_ridx) {
  const int wi = blockIdx.y;
  const long long start = w.start[wi];
  const long long s0 = w.row0[wi];
  const long long total_rows = w.row0[w.k];
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r < w.cnt[wi]; r += stride) {
    for (int j = 0; j < f; ++j) {
      bins[(long long)j * n_pad + start + r] =
          s_bins[(long long)j * total_rows + s0 + r];
    }
    g[start + r] = s_g[s0 + r];
    h[start + r] = s_h[s0 + r];
    m[start + r] = s_m[s0 + r];
    ridx[start + r] = s_ridx[s0 + r];
  }
}

int partition_windows(const Windows& w, void* bins, void* g, void* h, void* m,
                      void* ridx, long long n_pad, int f, void* s_bins,
                      void* s_g, void* s_h, void* s_m, void* s_ridx,
                      void* tile_counts, void* nl_out, cudaStream_t st) {
  const long long tiles = w.tile0[w.k];
  if (tiles == 0) {  // every window empty: nothing moves
    cudaMemsetAsync(nl_out, 0, sizeof(int) * w.k, st);
    return (int)cudaGetLastError();
  }
  count_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
      (const uint8_t*)bins, n_pad, w, (int*)tile_counts);
  scan_kernel<<<w.k, kThreads, 0, st>>>(w, (int*)tile_counts, (int*)nl_out);
  scatter_kernel<<<(unsigned)tiles, kThreads, 0, st>>>(
      (const uint8_t*)bins, (const float*)g, (const float*)h, (const float*)m,
      (const int*)ridx, n_pad, f, w, (const int*)tile_counts,
      (const int*)nl_out, (uint8_t*)s_bins, (float*)s_g, (float*)s_h,
      (float*)s_m, (int*)s_ridx);
  long long most = 0;
  for (int i = 0; i < w.k; ++i) most = w.cnt[i] > most ? w.cnt[i] : most;
  long long cblocks = (most + kThreads - 1) / kThreads;
  if (cblocks > 4096) cblocks = 4096;
  copy_back_kernel<<<dim3((unsigned)cblocks, w.k), kThreads, 0, st>>>(
      (uint8_t*)bins, (float*)g, (float*)h, (float*)m, (int*)ridx, n_pad, f,
      w, (const uint8_t*)s_bins, (const float*)s_g, (const float*)s_h,
      (const float*)s_m, (const int*)s_ridx);
  return (int)cudaGetLastError();
}

void add_window(Windows& w, long long start, long long cnt, int feat,
                int tbin, int dl, int nanb) {
  const int i = w.k++;
  w.start[i] = start;
  w.cnt[i] = cnt > 0 ? cnt : 0;
  w.feat[i] = feat;
  w.tbin[i] = tbin;
  w.dl[i] = dl;
  w.nanb[i] = nanb;
  w.row0[i + 1] = w.row0[i] + w.cnt[i];
  w.tile0[i + 1] = w.tile0[i] + (w.cnt[i] + kTile - 1) / kTile;
}

}  // namespace

// K stable partitions of disjoint windows in one call (K = 1: one window).
// Host array windows [k, 6] i64 rows (start, cnt, feat, tbin, dl, nanb).
// Scratch: s_bins [f, total] u8, s_g/s_h/s_m [total] f32, s_ridx [total]
// i32 with total the sum of cnt, tile_counts [max(1, sum of ceil(cnt /
// 1024))] i32; nl_out [k] i32 receives the left counts.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int lgbt_partition(void* bins, void* g, void* h, void* m,
                              void* ridx, long long n_pad, int f,
                              const long long* windows, int k, void* s_bins,
                              void* s_g, void* s_h, void* s_m, void* s_ridx,
                              void* tile_counts, void* nl_out, void* stream) {
  if (k < 1 || k > kMaxWindows || f <= 0) return (int)cudaErrorInvalidValue;
  Windows w;
  w.k = 0;
  w.row0[0] = 0;
  w.tile0[0] = 0;
  for (int i = 0; i < k; ++i) {
    const long long* r = windows + 6 * i;
    add_window(w, r[0], r[1], (int)r[2], (int)r[3], (int)r[4], (int)r[5]);
  }
  return partition_windows(w, bins, g, h, m, ridx, n_pad, f, s_bins, s_g,
                           s_h, s_m, s_ridx, tile_counts, nl_out,
                           (cudaStream_t)stream);
}
