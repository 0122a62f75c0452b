// Segment histogram: the (g, h, count) histograms of K disjoint contiguous
// windows [start, start + cnt) of the leaf-ordered training rows.
//
// Replaces the TPU kernel _seg_hist_kernel (lightgbm_tpu/ops/pallas/seg.py:469,
// launched through pl.pallas_call at seg.py:587 by seg_hist_pallas_batch; K=1
// entry seg_hist_pallas at seg.py:521).  Same contract: per window, the
// [F, B, 3] histogram that combine_hist_raw returns (seg.py:436), g and h
// summed as g*mask and h*mask, the count as the sum of the 0/1 mask; a
// window with cnt = 0 gives a zero histogram.  Two modes (hist_block.cuh):
// f32 sums, or the int8 2-digit grid whose exact i32 digit sums come out as
// raw [K, F, B, 5] planes for the recombine outside the kernel.
//
// Layout (the port's own, not the TPU's i16 planes): bins are u8 and
// feature-major [F, n] so one feature of consecutive rows is one contiguous
// run; g, h and mask are separate f32 columns [n].
//
// What bounds it on an H100: memory.  The least traffic is one pass over
// cnt * (F + 12) bytes (F bin bytes and three f32 stats per row) plus the
// output.  Design:
//   * a 3-D grid of (row chunk, feature group, window) blocks; a group is as
//     many features as fit the shared-memory budget (16 at B = 256 in f32
//     mode, 48 KB; 19 in int8 mode, 96 KB), so a row's stats are read once
//     per group, its bins once;
//   * each block accumulates its [group, B] sub-histogram in shared memory
//     with native shared atomics, then flushes its non-empty bins with
//     global atomics into the zero-initialised output;
//   * the number of row chunks is capped at about two blocks per SM for the
//     largest window, which keeps the flush small against the row pass at
//     the root, and gives small windows one chunk (the other blocks of a
//     small window's z-slice exit at once).

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_block.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMinRowsPerBlock = 2048;
constexpr int kMaxWindows = 16;

struct Windows {
  long long start[kMaxWindows];
  long long cnt[kMaxWindows];
};

template <bool kInt8>
constexpr int shared_budget() {
  return kInt8 ? 96 * 1024 : 48 * 1024;
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
    seg_hist_kernel(const uint8_t* __restrict__ bins,
                    const float* __restrict__ g, const float* __restrict__ h,
                    const float* __restrict__ m, long long n, Windows win,
                    int f, int nbins, int group,
                    const float* __restrict__ scales, void* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int k = blockIdx.z;
  const long long start = win.start[k];
  const long long cnt = win.cnt[k];
  long long chunks = (cnt + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  if (chunks > gridDim.x) chunks = gridDim.x;
  if ((long long)blockIdx.x >= chunks) return;  // whole block: no barrier yet

  const int f0 = blockIdx.y * group;
  const int nf = min(group, f - f0);
  const int cells = nf * nbins;
  lgbt::BlockHist<kInt8> acc(smem, group * nbins);
  acc.zero(cells);
  __syncthreads();

  const float inv_g = lgbt::inv_scale(scales, 0);
  const float inv_h = lgbt::inv_scale(scales, 1);
  const long long rows_per_block = (cnt + chunks - 1) / chunks;
  const long long r0 = start + (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, start + cnt);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const auto s = lgbt::row_stat<kInt8>(g[r], h[r], m[r], inv_g, inv_h);
    const uint8_t* col = bins + (long long)f0 * n + r;
    for (int j = 0; j < nf; ++j) {
      const int b = col[(long long)j * n];
      if (b < nbins) acc.add(j * nbins + b, s);
    }
  }
  __syncthreads();

  constexpr int planes = lgbt::BlockHist<kInt8>::kPlanes;
  const long long cell0 = ((long long)k * f + f0) * nbins;
  if constexpr (kInt8) {
    acc.flush(cells, reinterpret_cast<int*>(out) + cell0 * planes);
  } else {
    acc.flush(cells, reinterpret_cast<float*>(out) + cell0 * planes);
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
int launch(const void* bins, const void* g, const void* h, const void* m,
           long long n, const Windows& win, int k, long long max_cnt, int f,
           int nbins, const void* scales, void* out, cudaStream_t stream) {
  constexpr int bpc = lgbt::BlockHist<kInt8>::kBytesPerCell;
  int group = shared_budget<kInt8>() / (bpc * nbins);
  if (group < 1) return (int)cudaErrorInvalidValue;
  if (group > f) group = f;
  const int ngroups = (f + group - 1) / group;
  const size_t shared = (size_t)bpc * group * nbins;
  static bool attr_set = false;
  if (!attr_set && shared > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        seg_hist_kernel<kInt8>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        shared_budget<kInt8>());
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  long long chunks = (max_cnt + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  long long cap = (2LL * sm_count()) / ngroups;
  if (cap < 1) cap = 1;
  if (chunks > cap) chunks = cap;
  if (chunks < 1) chunks = 1;
  dim3 grid((unsigned)chunks, (unsigned)ngroups, (unsigned)k);
  seg_hist_kernel<kInt8><<<grid, kThreads, shared, stream>>>(
      (const uint8_t*)bins, (const float*)g, (const float*)h, (const float*)m,
      n, win, f, nbins, group, (const float*)scales, out);
  return (int)cudaGetLastError();
}

}  // namespace

// bins: [f, n] u8; g, h, m: [n] f32; windows: HOST [k, 2] i64 (start, cnt);
// scales: device [2] f32 (g_scale, h_scale) for the int8 mode, null for f32.
// out, zeroed by the caller: f32 [k, f, nbins, 3], or (int8) i32
// [k, f, nbins, 5] raw planes (S_g_hi, S_g_lo, S_h_hi, S_h_lo, count).
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lgbt_seg_hist(const void* bins, const void* g, const void* h,
                             const void* m, long long n,
                             const long long* windows, int k, int f,
                             int nbins, const void* scales, void* out,
                             void* stream) {
  if (k < 1 || k > kMaxWindows || f <= 0 || nbins <= 0)
    return (int)cudaErrorInvalidValue;
  Windows win;
  long long max_cnt = 0;
  for (int i = 0; i < k; ++i) {
    win.start[i] = windows[2 * i];
    win.cnt[i] = windows[2 * i + 1] > 0 ? windows[2 * i + 1] : 0;
    if (win.cnt[i] > max_cnt) max_cnt = win.cnt[i];
  }
  if (max_cnt == 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  if (scales != nullptr)
    return launch<true>(bins, g, h, m, n, win, k, max_cnt, f, nbins, scales,
                        out, st);
  return launch<false>(bins, g, h, m, n, win, k, max_cnt, f, nbins, nullptr,
                       out, st);
}
