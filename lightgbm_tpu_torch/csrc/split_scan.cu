// Per-feature best numeric split of M leaf histograms in one launch, and,
// in the same launch, each leaf's candidate: the best feature's split with
// its improvement over the parent and its near-tie margin.
//
// Replaces the TPU kernel _split_scan_kernel
// (lightgbm_tpu/ops/pallas/split_scan.py:60, launched through pl.pallas_call
// at split_scan.py:218 by split_scan_pallas) with the candidate that its
// entry fused_best_split (:243) computes from the kernel's rows (:286-334),
// and, with M > 1, the same under jax.vmap over the 2K child candidates of a
// frontier-batched step (lightgbm_tpu/ops/grower.py:2670-2712).
// Each feature's [8] row: (best gain, threshold bin, default_left, left g,
// left h, left count, runner-up gain, 0), with the NaN bin taken out of the
// ordered scan and tried on both sides, L1/L2, min_data_in_leaf,
// min_sum_hessian_in_leaf and the feature mask, exactly as the basic
// numeric path of best_split (lightgbm_tpu/ops/split.py:108).  Ties:
// missing-right wins over missing-left unless left is strictly greater, and
// the lowest bin wins within a direction (the first maximum).
// Each leaf's candidate, a packed [12] f32 row: (improvement, feature, bin,
// default_left, left g, h, count, right g, h, count, margin, 0), where
//   * feature: the first feature with the largest row gain, or with
//     case_major (best_split's argmax over [case, F, B]) the first
//     missing-right feature at the largest gain, else the first; 0 when
//     every gain is -inf (torch.argmax's answer);
//   * improvement = gain - leaf_gain(parent) - min_gain_to_split, -inf
//     where the gain is not finite; right = parent - left;
//   * margin = (gain - runner_up) / max(|gain|, 1e-15), the runner-up the
//     best gain of the other features or the feature's own runner-up, +inf
//     where either is not finite.
//
// What bounds it on an H100: neither memory nor arithmetic at this size
// (F * B * 12 bytes in, M * 48 out, a few hundred flops per bin): a launch
// and a copy to the host.  So one launch does the whole of a call: a grid
// of (feature, member) blocks, each the scan of one feature of one member,
// its row written to a scratch; the last block of a member to finish (a
// ticket counter, which that block resets for the next launch) reduces the
// member's F rows to its candidate, and the entry copies the M candidates
// to the host in one copy.  Histogram pointers, parents and scalars go in
// by value: no copy to the card.  The reduction over features is an argmax
// with the lowest index winning ties, whose result does not depend on the
// order blocks finish or threads combine, so a member's rows and candidate
// are the same on every run and bit-equal to a launch of that member
// alone; with -fmad=false every f32 operation rounds as in the plain
// PyTorch version.  Within a feature the design keeps the histogram in
// shared memory, one bin per thread:
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

// the members of a launch, by value: each one's histogram [F, nb_pad, 3]
// (device) and parent (g, h, count); a __grid_constant__ parameter, so that
// indexing it by the block's member reads the parameter where it lies,
// with no copy of it to local memory
constexpr int kMaxMembers = 32;
constexpr int kCandCols = 12;

struct Members {
  const float* hist[kMaxMembers];
  float parent[kMaxMembers][3];
};

__device__ float block_max(float v) {
  __shared__ float sv[kThreads / 32];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, d));
  if ((threadIdx.x & 31) == 0) sv[threadIdx.x >> 5] = v;
  __syncthreads();
  float out = sv[0];
  for (int w = 1; w < kThreads / 32; ++w) out = fmaxf(out, sv[w]);
  __syncthreads();
  return out;
}

__device__ int block_min(int v) {
  __shared__ int si[kThreads / 32];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = min(v, __shfl_down_sync(0xffffffffu, v, d));
  if ((threadIdx.x & 31) == 0) si[threadIdx.x >> 5] = v;
  __syncthreads();
  int out = si[0];
  for (int w = 1; w < kThreads / 32; ++w) out = min(out, si[w]);
  __syncthreads();
  return out;
}

// The member's candidate from its F rows (rm, written by the member's
// blocks), by one block: see the top.
__device__ void reduce_member(const float* rm, int nf, const float* parent, float l1, float l2,
                              float min_gain, bool case_major, float* cand) {
  float best = -INFINITY;
  for (int i = threadIdx.x; i < nf; i += kThreads) best = fmaxf(best, __ldcg(rm + i * 8));
  best = block_max(best);
  int first = nf, first_r = nf;
  for (int i = threadIdx.x; i < nf; i += kThreads) {
    if (__ldcg(rm + i * 8) == best) {
      first = min(first, i);
      if (__ldcg(rm + i * 8 + 2) <= 0.5f) first_r = min(first_r, i);
    }
  }
  first = block_min(first);
  first_r = block_min(first_r);
  int feat = first;
  if (case_major && first_r < nf) feat = best == -INFINITY ? 0 : first_r;
  if (feat >= nf) feat = 0;
  float other = -INFINITY;
  for (int i = threadIdx.x; i < nf; i += kThreads)
    if (i != feat) other = fmaxf(other, __ldcg(rm + i * 8));
  other = block_max(other);
  if (threadIdx.x == 0) {
    float r[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) r[c] = __ldcg(rm + feat * 8 + c);
    const float gain = r[0];
    const float pgain = leaf_gain(parent[0], parent[1], l1, l2);
    const float sec = fmaxf(other, r[6]);
    cand[0] = isfinite(gain) ? (gain - pgain) - min_gain : -INFINITY;
    cand[1] = (float)feat;
    cand[2] = r[1];
    cand[3] = r[2];
    cand[4] = r[3];
    cand[5] = r[4];
    cand[6] = r[5];
    cand[7] = parent[0] - r[3];
    cand[8] = parent[1] - r[4];
    cand[9] = parent[2] - r[5];
    cand[10] = isfinite(gain) && isfinite(sec) ? (gain - sec) / fmaxf(fabsf(gain), 1e-15f)
                                               : INFINITY;
    cand[11] = 0.0f;
  }
}

__global__ void __launch_bounds__(kThreads)
    split_scan_kernel(const __grid_constant__ Members mem, const int* __restrict__ num_bins,
                      const int* __restrict__ nan_bins, const float* __restrict__ mask,
                      int mask_stride, int nb_pad, float l1, float l2, float min_data,
                      float min_hess, float* __restrict__ rows, float min_gain, int case_major,
                      int* __restrict__ tickets, float* __restrict__ cand) {
  __shared__ float xs[3][kThreads];
  __shared__ float bsum[3][kThreads / kBlk];
  __shared__ bool last;
  const int f = blockIdx.x;
  const int nf = gridDim.x;
  const int member = blockIdx.y;
  const int b = threadIdx.x;
  const int nanb = nan_bins[f];
  const int has_nan = nanb >= 0 ? 1 : 0;
  const float* hf = mem.hist[member] + (long long)f * nb_pad * 3;
  const float* parent = mem.parent[member];
  mask += (long long)member * mask_stride;
  float* rm = rows + (long long)member * nf * 8;
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
    float* o = rm + (long long)f * 8;
    o[0] = best;
    o[1] = (float)bin;
    o[2] = go_left ? 1.0f : 0.0f;
    o[3] = go_left ? llg : lg;
    o[4] = go_left ? llh : lh;
    o[5] = go_left ? llc : lc;
    o[6] = sec;
    o[7] = 0.0f;
  }
  if (tickets == nullptr) return;

  // the member's last block to finish reduces its rows to the candidate
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(&tickets[member], 1) == nf - 1;
    if (last) tickets[member] = 0;  // ready for the next launch
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  reduce_member(rm, nf, parent, l1, l2, min_gain, case_major != 0, cand + member * kCandCols);
}

}  // namespace

// M <= 32 leaves in one launch.  hists: HOST [m] i64, the device address of
// each member's f32 [f, nb_pad, 3] histogram (contiguous); parents: HOST
// [m, 3] f32; num_bins / nan_bins: device [f] i32 shared; mask: device f32
// [f] (mask_stride 0: one mask for all members) or [m, f] (mask_stride f);
// rows: device [m, f, 8] f32, every row written.  tickets null: the rows
// only.  Else the candidates too: tickets device i32 [32], zero (and left
// zero); cand device f32 [m, 12]; cand_host: host f32 [m, 12] (pinned),
// filled by one copy after the launch, the stream synchronized before the
// return.  Returns the CUDA error of the launch (and copy), 0 on success.
extern "C" int lgbt_split_scan(const long long* hists, const float* parents,
                               const void* num_bins, const void* nan_bins, const void* mask,
                               int m, int f, int nb_pad, int mask_stride, float l1, float l2,
                               float min_data, float min_hess, void* rows, float min_gain,
                               int case_major, void* tickets, void* cand, void* cand_host,
                               void* stream) {
  if (f <= 0 || m <= 0) return (int)cudaGetLastError();
  if (nb_pad > kThreads || m > kMaxMembers || f > 65535) return (int)cudaErrorInvalidValue;
  if (tickets != nullptr && (cand == nullptr || cand_host == nullptr))
    return (int)cudaErrorInvalidValue;
  Members mem;
  for (int i = 0; i < m; ++i) {
    mem.hist[i] = (const float*)hists[i];
    for (int c = 0; c < 3; ++c) mem.parent[i][c] = parents[3 * i + c];
  }
  cudaStream_t st = (cudaStream_t)stream;
  split_scan_kernel<<<dim3(f, m), kThreads, 0, st>>>(
      mem, (const int*)num_bins, (const int*)nan_bins, (const float*)mask, mask_stride, nb_pad,
      l1, l2, min_data, min_hess, (float*)rows, min_gain, case_major, (int*)tickets,
      (float*)cand);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || tickets == nullptr) return (int)e;
  e = cudaMemcpyAsync(cand_host, cand, (size_t)m * kCandCols * sizeof(float),
                      cudaMemcpyDeviceToHost, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamSynchronize(st);
}
