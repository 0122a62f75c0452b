// What one row adds to a (g, h, count) histogram, shared by the lane
// histogram (lane_hist.cuh) of the segment histogram (seg_hist.cu) and the
// fused grow step (grow_step.cu).
//
// Two modes, chosen at compile time:
//   * f32  (kInt8 = false): g*m and h*m as f32, and the count m != 0.
//   * int8 (kInt8 = true): the 2-digit grid of the TPU kernel's _hist_window
//     (lightgbm_tpu/ops/pallas/seg.py:336-367).  q = clip(rint(g*m / scale),
//     +-QMAX) splits as q = hi*128 + lo with hi = (q + 64) >> 7; the digit
//     sums S_g_hi, S_g_lo, S_h_hi, S_h_lo and the count are kept apart as
//     i32.  Integer sums do not depend on the order, so they are exact and
//     the same on every run; the f32 recombine (S_hi*128 + S_lo)*scale
//     follows, as combine_hist_raw does (lane_hist.cuh's reduce).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lgbt {

constexpr int kQmax = 127 * 128;

template <bool kInt8>
struct RowStat;

template <>
struct RowStat<false> {
  float g, h;
  int c;
};

template <>
struct RowStat<true> {
  int ghi, glo, hhi, hlo, c;
};

// q = clip(round_half_even(x * inv), +-QMAX) as two int8-range digits
__device__ __forceinline__ void digits(float x, float inv, int& hi, int& lo) {
  float q = rintf(x * inv);
  q = fminf(fmaxf(q, -(float)kQmax), (float)kQmax);
  const int qi = (int)q;
  hi = (qi + 64) >> 7;
  lo = qi - hi * 128;
}

template <bool kInt8>
__device__ __forceinline__ RowStat<kInt8> row_stat(float g, float h, float m,
                                                   float inv_g, float inv_h);

template <>
__device__ __forceinline__ RowStat<false> row_stat<false>(float g, float h,
                                                          float m, float,
                                                          float) {
  return {g * m, h * m, m != 0.0f ? 1 : 0};
}

template <>
__device__ __forceinline__ RowStat<true> row_stat<true>(float g, float h,
                                                        float m, float inv_g,
                                                        float inv_h) {
  RowStat<true> s;
  digits(g * m, inv_g, s.ghi, s.glo);
  digits(h * m, inv_h, s.hhi, s.hlo);
  s.c = m != 0.0f ? 1 : 0;
  return s;
}

// 1/scale, once per block (IEEE division: nvcc divides exactly unless told
// otherwise); unused in f32 mode
__device__ __forceinline__ float inv_scale(const float* scales, int i) {
  return scales != nullptr ? 1.0f / scales[i] : 1.0f;
}

}  // namespace lgbt
