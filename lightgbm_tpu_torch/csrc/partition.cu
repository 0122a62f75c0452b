// Stable partition of one leaf window of the segment-resident rows.
//
// Replaces the TPU kernel _seg_partition_kernel
// (lightgbm_tpu/ops/pallas/partition.py:334, body _partition_window :104,
// launched through pl.pallas_call at partition.py:446 by
// seg_partition_pallas).  Same contract as its XLA oracle sort_partition_xla
// (lightgbm_tpu/ops/segpart.py:65): the rows of [start, start + cnt) that go
// left move, in their order, to [start, start + nl), the rest, in their
// order, to [start + nl, start + cnt); rows outside the window are not
// touched; nl is returned.  Numeric splits only: a row goes left when its
// bin is <= the threshold bin, or when it sits in the feature's NaN bin and
// missing values go left (ops/segpart.py:52 _go_left).
//
// Layout (the port's, not the TPU's i16 planes): bins u8 feature-major
// [f, n_pad]; g, h, m f32 and ridx i32 columns [n_pad].
//
// What bounds it on an H100: memory.  The least traffic is reading the
// window's rows once and writing them once, 2 * cnt * (f + 16) bytes.  The
// design moves them four times (each row's split-feature byte is read twice
// more for the flags) because blocks run in no fixed order and a stable
// scatter needs every block's left count first:
//   1. count:   one block per 1024-row tile counts its left rows;
//   2. scan:    one block turns the tile counts into exclusive offsets and
//               writes nl (any tile count, in chunks of 1024);
//   3. scatter: each tile recomputes its flags, ranks them with a block
//               scan (stable), and writes every column of every row to its
//               final place in a scratch window;
//   4. copy:    the scratch window is copied back over [start, start+cnt).
// All four are plain loads and stores: the result is exact and the same on
// every run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;
constexpr int kTile = kThreads * kRowsPerThread;  // 1024 rows per block

__device__ __forceinline__ int go_left(int v, int tbin, int dl, int nanb) {
  return (v <= tbin) || (dl && nanb >= 0 && v == nanb);
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

__global__ void count_kernel(const uint8_t* __restrict__ col, long long start,
                             long long cnt, int tbin, int dl, int nanb,
                             int* __restrict__ block_counts) {
  const long long base = (long long)blockIdx.x * kTile;
  int c = 0;
  for (int i = threadIdx.x; i < kTile; i += kThreads) {
    const long long r = base + i;
    if (r < cnt) c += go_left(col[start + r], tbin, dl, nanb);
  }
  int total;
  block_exclusive_scan(c, &total);
  if (threadIdx.x == 0) block_counts[blockIdx.x] = total;
}

__global__ void scan_kernel(int* __restrict__ block_counts, int nblocks,
                            int* __restrict__ nl_out) {
  int carry = 0;
  for (int b0 = 0; b0 < nblocks; b0 += kThreads) {
    const int i = b0 + threadIdx.x;
    const int x = i < nblocks ? block_counts[i] : 0;
    int total;
    const int ex = block_exclusive_scan(x, &total);
    if (i < nblocks) block_counts[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) *nl_out = carry;
}

__global__ void scatter_kernel(const uint8_t* __restrict__ bins,
                               const float* __restrict__ g,
                               const float* __restrict__ h,
                               const float* __restrict__ m,
                               const int* __restrict__ ridx, long long n_pad,
                               long long start, long long cnt, int f, int feat,
                               int tbin, int dl, int nanb,
                               const int* __restrict__ block_offsets,
                               const int* __restrict__ nl_ptr,
                               uint8_t* __restrict__ s_bins,
                               float* __restrict__ s_g, float* __restrict__ s_h,
                               float* __restrict__ s_m,
                               int* __restrict__ s_ridx) {
  const long long base = (long long)blockIdx.x * kTile;
  const long long r0 = base + (long long)threadIdx.x * kRowsPerThread;
  const uint8_t* col = bins + (long long)feat * n_pad + start;
  int flags[kRowsPerThread];
  int mine = 0;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const long long r = r0 + k;
    flags[k] = r < cnt ? go_left(col[r], tbin, dl, nanb) : 0;
    mine += flags[k];
  }
  int total;
  const int left_before = block_exclusive_scan(mine, &total);
  const long long lbase = block_offsets[blockIdx.x];
  const long long nl = *nl_ptr;
  // rows of this tile before this thread's first row, left and right
  const long long rows_before = (long long)threadIdx.x * kRowsPerThread;
  long long lpos = lbase + left_before;
  long long rpos = nl + (base - lbase) + (rows_before - left_before);
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const long long r = r0 + k;
    if (r >= cnt) break;
    const long long dst = flags[k] ? lpos++ : rpos++;
    const long long src = start + r;
    for (int j = 0; j < f; ++j) {
      s_bins[(long long)j * cnt + dst] = bins[(long long)j * n_pad + src];
    }
    s_g[dst] = g[src];
    s_h[dst] = h[src];
    s_m[dst] = m[src];
    s_ridx[dst] = ridx[src];
  }
}

__global__ void copy_back_kernel(uint8_t* __restrict__ bins,
                                 float* __restrict__ g, float* __restrict__ h,
                                 float* __restrict__ m, int* __restrict__ ridx,
                                 long long n_pad, long long start,
                                 long long cnt, int f,
                                 const uint8_t* __restrict__ s_bins,
                                 const float* __restrict__ s_g,
                                 const float* __restrict__ s_h,
                                 const float* __restrict__ s_m,
                                 const int* __restrict__ s_ridx) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < cnt;
       r += stride) {
    for (int j = 0; j < f; ++j) {
      bins[(long long)j * n_pad + start + r] = s_bins[(long long)j * cnt + r];
    }
    g[start + r] = s_g[r];
    h[start + r] = s_h[r];
    m[start + r] = s_m[r];
    ridx[start + r] = s_ridx[r];
  }
}

}  // namespace

// One stable partition of [start, start + cnt).  Scratch: s_bins [f, cnt]
// u8, s_g/s_h/s_m [cnt] f32, s_ridx [cnt] i32, block_counts
// [ceil(cnt / 1024)] i32; nl_out [1] i32 receives the left count.  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int lgbt_partition(void* bins, void* g, void* h, void* m,
                              void* ridx, long long n_pad, long long start,
                              long long cnt, int f, int feat, int tbin, int dl,
                              int nanb, void* s_bins, void* s_g, void* s_h,
                              void* s_m, void* s_ridx, void* block_counts,
                              void* nl_out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (cnt <= 0) {
    cudaMemsetAsync(nl_out, 0, sizeof(int), st);
    return (int)cudaGetLastError();
  }
  const long long nblocks = (cnt + kTile - 1) / kTile;
  const uint8_t* col = (const uint8_t*)bins + (long long)feat * n_pad;
  count_kernel<<<(unsigned)nblocks, kThreads, 0, st>>>(
      col, start, cnt, tbin, dl, nanb, (int*)block_counts);
  scan_kernel<<<1, kThreads, 0, st>>>((int*)block_counts, (int)nblocks,
                                      (int*)nl_out);
  scatter_kernel<<<(unsigned)nblocks, kThreads, 0, st>>>(
      (const uint8_t*)bins, (const float*)g, (const float*)h, (const float*)m,
      (const int*)ridx, n_pad, start, cnt, f, feat, tbin, dl, nanb,
      (const int*)block_counts, (const int*)nl_out, (uint8_t*)s_bins,
      (float*)s_g, (float*)s_h, (float*)s_m, (int*)s_ridx);
  long long cblocks = (cnt + kThreads - 1) / kThreads;
  if (cblocks > 4096) cblocks = 4096;
  copy_back_kernel<<<(unsigned)cblocks, kThreads, 0, st>>>(
      (uint8_t*)bins, (float*)g, (float*)h, (float*)m, (int*)ridx, n_pad,
      start, cnt, f, (const uint8_t*)s_bins, (const float*)s_g,
      (const float*)s_h, (const float*)s_m, (const int*)s_ridx);
  return (int)cudaGetLastError();
}
