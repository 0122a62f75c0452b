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
// grower.py:1274-1325) in XLA before the kernel; here each thread reads
// its row index from the window itself, so the gather is part of the load.
// A window with no index (order == nullptr) runs over rows start..start+cnt
// (the root).  Output as the seg histogram's (hist_block.cuh): f32
// [K, F, B, 3], or raw i32 [K, F, B, 5] digit sums (S_g_hi, S_g_lo,
// S_h_hi, S_h_lo, count) that ops/seg.py combine_int8 recombines outside
// the kernel, as combine_hist_raw does on the TPU.
//
// The TPU needed the one-hot matmul because it has no fast scatter-add;
// the card has one, so the design is a scatter into shared memory:
//   * a 3-D grid of (row chunk, feature group, window) blocks.  A group is
//     a multiple of 16 features, as many as fit the shared-memory budget
//     (16 at B = 256: 48 KB in f32, 80 KB in int8);
//   * each thread takes rows of its block's chunk: the row index once, g,
//     h and the mask once, then the group's bins as 16-byte vector loads
//     (the row stride is a multiple of 16 bytes);
//   * the block's [group, B] histogram accumulates in shared memory with
//     native shared atomics (hist_block.cuh) and is flushed, non-empty bins
//     only, with global atomics into the zeroed output.
// The int8 sums are integers, so exact and the same on every run; the f32
// g and h sums move in the last bits with the order of the atomics, the
// counts are exact.
//
// What bounds it on an H100: memory.  The least traffic is one pass over
// cnt * (F + 16) bytes (the bins, three f32 stats and the row index) plus
// the output.  The row-major layout reads each row's group as 16 of the 32
// bytes of a sector, and the stats once per group (from L2 after the
// first); faster designs would stage row tiles with async copies, privatize
// histograms per warp, or reduce in registers before the atomics.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hist_block.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMinRowsPerBlock = 2048;
constexpr int kMaxWindows = 16;
constexpr int kVec = 16;  // features per vector load
constexpr int kBlocksPerSm = 4;

struct Windows {
  long long start[kMaxWindows];
  long long cnt[kMaxWindows];
};

template <bool kInt8>
constexpr int shared_budget() {
  return kInt8 ? 80 * 1024 : 48 * 1024;
}

// digits of q = clip(round_half_even(x / scale), +-QMAX) * mi, with IEEE
// division as int8_digit_rows divides (nvcc divides exactly by default)
__device__ __forceinline__ void quant_digits(float x, float scale, int mi,
                                             int& hi, int& lo) {
  float q = rintf(x / scale);
  q = fminf(fmaxf(q, -(float)lgbt::kQmax), (float)lgbt::kQmax);
  const int qi = (int)q * mi;
  hi = (qi + 64) >> 7;
  lo = qi - hi * 128;
}

template <bool kInt8>
__device__ __forceinline__ lgbt::RowStat<kInt8> stat_of(float g, float h,
                                                        float m, float sg,
                                                        float sh);

template <>
__device__ __forceinline__ lgbt::RowStat<false> stat_of<false>(
    float g, float h, float m, float, float) {
  return lgbt::row_stat<false>(g, h, m, 1.0f, 1.0f);
}

template <>
__device__ __forceinline__ lgbt::RowStat<true> stat_of<true>(
    float g, float h, float m, float sg, float sh) {
  lgbt::RowStat<true> s;
  const int mi = m > 0.0f ? 1 : 0;
  quant_digits(g, sg, mi, s.ghi, s.glo);
  quant_digits(h, sh, mi, s.hhi, s.hlo);
  s.c = mi;
  return s;
}

template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
    ordered_hist_kernel(const uint8_t* __restrict__ bins, long long stride,
                        const int* __restrict__ order,
                        const float* __restrict__ g,
                        const float* __restrict__ h,
                        const float* __restrict__ m, Windows win, int f,
                        int nbins, int group, const float* __restrict__ scales,
                        void* __restrict__ out) {
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

  const float sg = scales != nullptr ? scales[0] : 1.0f;
  const float sh = scales != nullptr ? scales[1] : 1.0f;
  const long long rows_per_block = (cnt + chunks - 1) / chunks;
  const long long i0 = (long long)blockIdx.x * rows_per_block;
  const long long i1 = min(i0 + rows_per_block, cnt);
  for (long long i = i0 + threadIdx.x; i < i1; i += blockDim.x) {
    const long long r =
        order != nullptr ? (long long)order[start + i] : start + i;
    const auto s = stat_of<kInt8>(g[r], h[r], m[r], sg, sh);
    const uint4* src = reinterpret_cast<const uint4*>(bins + r * stride + f0);
    for (int v = 0; v < nf; v += kVec) {
      const uint4 word = src[v / kVec];
      const uint8_t* b16 = reinterpret_cast<const uint8_t*>(&word);
      const int nv = min(kVec, nf - v);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (j < nv) {
          const int b = b16[j];
          if (b < nbins) acc.add((v + j) * nbins + b, s);
        }
      }
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
int launch(const void* bins, long long stride, const void* order,
           const void* g, const void* h, const void* m, const Windows& win,
           int k, long long max_cnt, int f, int nbins, const void* scales,
           void* out, cudaStream_t stream) {
  constexpr int bpc = lgbt::BlockHist<kInt8>::kBytesPerCell;
  int group = shared_budget<kInt8>() / (bpc * nbins) / kVec * kVec;
  if (group < kVec) return (int)cudaErrorInvalidValue;
  const int fpad = (f + kVec - 1) / kVec * kVec;
  if (group > fpad) group = fpad;
  const int ngroups = (f + group - 1) / group;
  const size_t shared = (size_t)bpc * group * nbins;
  static bool attr_set = false;
  if (!attr_set && shared > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        ordered_hist_kernel<kInt8>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, shared_budget<kInt8>());
    if (e != cudaSuccess) return (int)e;
    attr_set = true;
  }
  long long chunks = (max_cnt + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  long long cap = ((long long)kBlocksPerSm * sm_count()) / ngroups;
  if (cap < 1) cap = 1;
  if (chunks > cap) chunks = cap;
  if (chunks < 1) chunks = 1;
  dim3 grid((unsigned)chunks, (unsigned)ngroups, (unsigned)k);
  ordered_hist_kernel<kInt8><<<grid, kThreads, shared, stream>>>(
      (const uint8_t*)bins, stride, (const int*)order, (const float*)g,
      (const float*)h, (const float*)m, win, f, nbins, group,
      (const float*)scales, out);
  return (int)cudaGetLastError();
}

}  // namespace

// bins: [n, stride] u8 row-major, stride a multiple of 16 and >= f, 16-byte
// aligned; order: [*] i32 row indices, or null (windows index rows
// directly); g, h, m: [n] f32; windows: HOST [k, 2] i64 (start, cnt) into
// order (or the rows); scales: device [2] f32 (g_scale, h_scale) for the
// int8 mode, null for f32.  out, zeroed by the caller: f32 [k, f, nbins, 3],
// or (int8) i32 [k, f, nbins, 5] raw planes.  Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int lgbt_ordered_hist(const void* bins, long long stride,
                                 const void* order, const void* g,
                                 const void* h, const void* m,
                                 const long long* windows, int k, int f,
                                 int nbins, const void* scales, void* out,
                                 void* stream) {
  if (k < 1 || k > kMaxWindows || f <= 0 || nbins <= 0 || stride % kVec ||
      stride < f)
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
    return launch<true>(bins, stride, order, g, h, m, win, k, max_cnt, f,
                        nbins, scales, out, st);
  return launch<false>(bins, stride, order, g, h, m, win, k, max_cnt, f,
                       nbins, nullptr, out, st);
}
