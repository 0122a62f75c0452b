// Per-feature best numeric split of one leaf histogram, or of M leaf
// histograms in one launch.
//
// Replaces the TPU kernel _split_scan_kernel
// (lightgbm_tpu/ops/pallas/split_scan.py:60, launched through pl.pallas_call
// at split_scan.py:218 by split_scan_pallas; entry fused_best_split :243),
// and, in its batched mode (M leaves per launch), the same kernel under
// jax.vmap over the 2K child candidates of a frontier-batched step
// (lightgbm_tpu/ops/grower.py:2670-2712).
// Same [F, 8] result row per feature: (best gain, threshold bin,
// default_left, left g, left h, left count, runner-up gain, 0), with the
// NaN bin taken out of the ordered scan and tried on both sides, L1/L2,
// min_data_in_leaf, min_sum_hessian_in_leaf and the feature mask, exactly
// as the basic numeric path of best_split (lightgbm_tpu/ops/split.py:108).
// Ties: missing-right wins over missing-left unless left is strictly
// greater, and the lowest bin wins within a direction (the first maximum).
//
// What bounds it on an H100: neither memory nor arithmetic at this size
// (F * B * 12 bytes in, F * 32 out, a few hundred flops per bin); one launch
// of F small blocks is latency bound, so the batched mode puts all M
// members in one launch, a grid of (feature, member) blocks.  Every block
// runs the same code on its own member's histogram, parent and feature
// mask, so a member's rows are bit-equal to a launch of that member alone.
// The design keeps a feature's whole histogram in shared memory, one bin
// per thread:
//   * the prefix sum over bins runs in blocks of 16 bins: sequential inside
//     each block, then the block totals are carried in order.  That is the
//     exact f32 association the plain PyTorch version uses (and XLA's CPU
//     cumsum), so kernel and plain version give identical rows for the same
//     histogram;
//   * gains for both missing directions in registers, then two block-wide
//     argmax reductions (value, then lowest bin on ties).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // one bin per thread: B <= 256
constexpr int kBlk = 16;       // prefix-sum block (see header)

__device__ __forceinline__ float threshold_l1(float g, float l1) {
  const float a = fabsf(g) - l1;
  const float s = g > 0.0f ? 1.0f : (g < 0.0f ? -1.0f : 0.0f);
  return s * (a > 0.0f ? a : 0.0f);
}

__device__ __forceinline__ float leaf_gain(float g, float h, float l1,
                                           float l2) {
  const float t = threshold_l1(g, l1);
  return (t * t) / ((h + l2) + 1e-15f);
}

// block argmax: larger value wins, equal values keep the lower index
__device__ void block_argmax(float v, int i, float* out_v, int* out_i) {
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, d);
    const int oi = __shfl_down_sync(0xffffffffu, i, d);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
  if (lane == 0) {
    sv[warp] = v;
    si[warp] = i;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float bv = sv[0];
    int bi = si[0];
    for (int w = 1; w < kThreads / 32; ++w) {
      if (sv[w] > bv || (sv[w] == bv && si[w] < bi)) {
        bv = sv[w];
        bi = si[w];
      }
    }
    sv[0] = bv;
    si[0] = bi;
  }
  __syncthreads();
  *out_v = sv[0];
  *out_i = si[0];
  __syncthreads();
}

__global__ void split_scan_kernel(const float* __restrict__ hist,
                                  const float* __restrict__ parent,
                                  const int* __restrict__ num_bins,
                                  const int* __restrict__ nan_bins,
                                  const float* __restrict__ mask,
                                  int mask_stride, int nb_pad, float l1,
                                  float l2, float min_data, float min_hess,
                                  float* __restrict__ out) {
  __shared__ float xs[3][kThreads];
  __shared__ float bsum[3][kThreads / kBlk];
  const int f = blockIdx.x;
  const int nf = gridDim.x;
  const long long member = blockIdx.y;
  const int b = threadIdx.x;
  const int nanb = nan_bins[f];
  const int has_nan = nanb >= 0 ? 1 : 0;
  const float* hf = hist + (member * nf + f) * nb_pad * 3;
  parent += member * 3;
  mask += member * mask_stride;
  out += member * nf * 8;
  const bool live = b < nb_pad;

  float x[3], nan_s[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    x[c] = (live && b != nanb) ? hf[b * 3 + c] : 0.0f;
    nan_s[c] = has_nan ? hf[nanb * 3 + c] : 0.0f;
    xs[c][b] = x[c];
  }
  __syncthreads();

  // in-block sequential prefix, then the carried block totals in order
  const int b0 = (b / kBlk) * kBlk;
  float cum[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float s = 0.0f;
    for (int i = b0; i <= b; ++i) s = s + xs[c][i];
    cum[c] = s;
  }
  if ((b % kBlk) == kBlk - 1) {
#pragma unroll
    for (int c = 0; c < 3; ++c) bsum[c][b / kBlk] = cum[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float carry = 0.0f;
    for (int k = 0; k < b / kBlk; ++k) carry = carry + bsum[c][k];
    cum[c] = cum[c] + carry;
  }

  const float pg = parent[0], ph = parent[1], pc = parent[2];
  const int num_ordered = num_bins[f] - has_nan;
  const bool base_ok = live && b < num_ordered - 1 && mask[f] != 0.0f;
  const float ninf = -INFINITY;

  // missing -> right
  float lg = cum[0], lh = cum[1], lc = cum[2];
  float rg = pg - lg, rh = ph - lh, rc = pc - lc;
  bool ok = base_ok && lc >= min_data && rc >= min_data && lh >= min_hess &&
            rh >= min_hess;
  const float gain_r =
      ok ? leaf_gain(lg, lh, l1, l2) + leaf_gain(rg, rh, l1, l2) : ninf;
  // missing -> left (only distinct when a NaN bin exists)
  const float llg = cum[0] + nan_s[0], llh = cum[1] + nan_s[1],
              llc = cum[2] + nan_s[2];
  rg = pg - llg;
  rh = ph - llh;
  rc = pc - llc;
  ok = base_ok && has_nan && llc >= min_data && rc >= min_data &&
       llh >= min_hess && rh >= min_hess;
  const float gain_l =
      ok ? leaf_gain(llg, llh, l1, l2) + leaf_gain(rg, rh, l1, l2) : ninf;

  float m_r, m_l;
  int i_r, i_l;
  block_argmax(gain_r, b, &m_r, &i_r);
  block_argmax(gain_l, b, &m_l, &i_l);
  const bool go_left = m_l > m_r;
  const float best = go_left ? m_l : m_r;
  const int bin = go_left ? i_l : i_r;

  // runner-up over both directions with the winner's (direction, bin) out
  const float gwin = go_left ? gain_l : gain_r;
  const float glose = go_left ? gain_r : gain_l;
  const float other = b == bin ? ninf : gwin;
  float sec;
  int unused;
  block_argmax(other > glose ? other : glose, b, &sec, &unused);

  if (b == bin) {
    float* o = out + (long long)f * 8;
    o[0] = best;
    o[1] = (float)bin;
    o[2] = go_left ? 1.0f : 0.0f;
    o[3] = go_left ? llg : lg;
    o[4] = go_left ? llh : lh;
    o[5] = go_left ? llc : lc;
    o[6] = sec;
    o[7] = 0.0f;
  }
}

}  // namespace

// M leaves in one launch (M = 1: one leaf): hist [m, f, nb_pad, 3] f32,
// parent [m, 3] f32, num_bins/nan_bins [f] i32 shared, mask f32 [f]
// (mask_stride 0: one mask for all members) or [m, f] (mask_stride f) ->
// out [m, f, 8] f32.  Returns cudaGetLastError() after the launch.
extern "C" int lgbt_split_scan(const void* hist, const void* parent,
                               const void* num_bins, const void* nan_bins,
                               const void* mask, int m, int f, int nb_pad,
                               int mask_stride, float l1, float l2,
                               float min_data, float min_hess, void* out,
                               void* stream) {
  if (f <= 0 || m <= 0) return (int)cudaGetLastError();
  if (nb_pad > kThreads || m > 65535) return (int)cudaErrorInvalidValue;
  split_scan_kernel<<<dim3(f, m), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)hist, (const float*)parent, (const int*)num_bins,
      (const int*)nan_bins, (const float*)mask, mask_stride, nb_pad, l1, l2,
      min_data, min_hess, (float*)out);
  return (int)cudaGetLastError();
}
