// Segment histogram: the (g, h, count) histogram of one contiguous window
// [start, start + cnt) of the leaf-ordered training rows.
//
// Replaces the TPU kernel _seg_hist_kernel (lightgbm_tpu/ops/pallas/seg.py:469,
// launched through pl.pallas_call at seg.py:587 by seg_hist_pallas_batch; K=1
// entry seg_hist_pallas at seg.py:521).  Same contract: the [F, B, 3]
// histogram that combine_hist_raw returns (seg.py:436), g and h summed as
// g*mask and h*mask, the count as the sum of the 0/1 mask.
//
// Layout (the port's own, not the TPU's i16 planes): bins are u8 and
// feature-major [F, n] so one feature of consecutive rows is one contiguous
// run; g, h and mask are separate f32 columns [n].
//
// What bounds it on an H100: memory.  The least traffic is one pass over
// cnt * (F + 12) bytes (F bin bytes and three f32 stats per row) plus the
// F * B * 12-byte output.  Design:
//   * a 2-D grid of (row chunk, feature group) blocks; a group is as many
//     features as fit a 48 KB shared-memory histogram (16 at B = 256), so a
//     row's stats are read once per group (twice at F = 28), its bins once;
//   * each block accumulates its [group, B] sub-histogram in shared memory
//     with native shared atomics: g and h as f32, the count as i32 (exact);
//   * the block then flushes its non-empty bins with global f32 atomics into
//     the zero-initialised output.  Counts stay exact: every partial sum is
//     an integer below 2^24.  g and h are summed in an order that depends on
//     the schedule, so they match a sequential sum only within f32 rounding;
//   * the number of row chunks is capped at about two blocks per SM, which
//     keeps the flush (group * B * 3 global atomics per block) small against
//     the row pass at the root, and gives small windows one chunk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedBytes = 48 * 1024;
constexpr long long kMinRowsPerBlock = 2048;

__global__ void seg_hist_kernel(const uint8_t* __restrict__ bins,
                                const float* __restrict__ g,
                                const float* __restrict__ h,
                                const float* __restrict__ m, long long n,
                                long long start, long long cnt, int f,
                                int nbins, int group, long long rows_per_block,
                                float* __restrict__ out) {
  extern __shared__ float smem[];
  float* sg = smem;
  float* sh = sg + group * nbins;
  int* sc = reinterpret_cast<int*>(sh + group * nbins);
  const int f0 = blockIdx.y * group;
  const int nf = min(group, f - f0);
  const int cells = nf * nbins;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    sg[i] = 0.0f;
    sh[i] = 0.0f;
    sc[i] = 0;
  }
  __syncthreads();

  const long long r0 = start + (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(r0 + rows_per_block, start + cnt);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const float mm = m[r];
    const float gv = g[r] * mm;
    const float hv = h[r] * mm;
    const int cv = mm != 0.0f ? 1 : 0;
    const uint8_t* col = bins + (long long)f0 * n + r;
    for (int j = 0; j < nf; ++j) {
      const int b = col[(long long)j * n];
      if (b < nbins) {
        const int cell = j * nbins + b;
        atomicAdd(&sg[cell], gv);
        atomicAdd(&sh[cell], hv);
        atomicAdd(&sc[cell], cv);
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const int c = sc[i];
    if (c != 0) {
      float* o = out + ((long long)f0 * nbins + i) * 3;
      atomicAdd(o, sg[i]);
      atomicAdd(o + 1, sh[i]);
      atomicAdd(o + 2, (float)c);
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

}  // namespace

// bins: [f, n] u8; g, h, m: [n] f32; out: [f, nbins, 3] f32, zeroed by the
// caller.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int lgbt_seg_hist(const void* bins, const void* g, const void* h,
                             const void* m, long long n, long long start,
                             long long cnt, int f, int nbins, void* out,
                             void* stream) {
  if (cnt <= 0 || f <= 0 || nbins <= 0) return (int)cudaGetLastError();
  int group = kSharedBytes / (3 * 4 * nbins);
  if (group < 1) return (int)cudaErrorInvalidValue;
  if (group > f) group = f;
  const int ngroups = (f + group - 1) / group;
  long long chunks = (cnt + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  long long cap = (2LL * sm_count()) / ngroups;
  if (cap < 1) cap = 1;
  if (chunks > cap) chunks = cap;
  const long long rows_per_block = (cnt + chunks - 1) / chunks;
  dim3 grid((unsigned)chunks, (unsigned)ngroups);
  const size_t shared = (size_t)3 * 4 * group * nbins;
  seg_hist_kernel<<<grid, kThreads, shared, (cudaStream_t)stream>>>(
      (const uint8_t*)bins, (const float*)g, (const float*)h, (const float*)m,
      n, start, cnt, f, nbins, group, rows_per_block, (float*)out);
  return (int)cudaGetLastError();
}
