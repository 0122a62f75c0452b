// Block-private (g, h, count) histogram in shared memory, shared by the
// segment histogram (seg_hist.cu) and the fused grow step (grow_step.cu).
//
// Two accumulation modes, chosen at compile time:
//   * f32  (kInt8 = false): g*m and h*m summed as f32 with native shared
//     atomics, the count as i32.  Flushed with global f32 atomics into the
//     [.., 3] (g, h, count) histogram, so g and h depend on the atomic order.
//   * int8 (kInt8 = true): the 2-digit grid of the TPU kernel's _hist_window
//     (lightgbm_tpu/ops/pallas/seg.py:336-367).  q = clip(rint(g*m / scale),
//     +-QMAX) splits as q = hi*128 + lo with hi = (q + 64) >> 7; the digit
//     sums S_g_hi, S_g_lo, S_h_hi, S_h_lo and the count are kept apart as
//     i32 and flushed with global integer atomics into raw [.., 5] planes.
//     Integer sums do not depend on the order, so the result is exact and
//     the same on every run; the f32 recombine (S_hi*128 + S_lo)*scale runs
//     outside the kernel (ops/seg.py combine_int8), like combine_hist_raw.

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

template <bool kInt8>
struct BlockHist {
  // bytes of shared memory per (feature, bin) cell
  static constexpr int kBytesPerCell = kInt8 ? 20 : 12;
  // planes of the flushed output per cell
  static constexpr int kPlanes = kInt8 ? 5 : 3;

  float* sg;
  float* sh;
  int* si;  // int8: 5 planes [ghi, glo, hhi, hlo, count]; f32: count

  // smem holds `capacity` cells: int8 five i32 planes; f32 g, h, count
  __device__ BlockHist(void* smem, int capacity) : cap(capacity) {
    if constexpr (kInt8) {
      si = reinterpret_cast<int*>(smem);
      sg = sh = nullptr;
    } else {
      sg = reinterpret_cast<float*>(smem);
      sh = sg + capacity;
      si = reinterpret_cast<int*>(sh + capacity);
    }
  }

  __device__ void zero(int cells) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      if constexpr (kInt8) {
#pragma unroll
        for (int p = 0; p < 5; ++p) si[p * cap + i] = 0;
      } else {
        sg[i] = 0.0f;
        sh[i] = 0.0f;
        si[i] = 0;
      }
    }
  }

  __device__ __forceinline__ void add(int cell, const RowStat<kInt8>& s) {
    if constexpr (kInt8) {
      atomicAdd(&si[cell], s.ghi);
      atomicAdd(&si[cap + cell], s.glo);
      atomicAdd(&si[2 * cap + cell], s.hhi);
      atomicAdd(&si[3 * cap + cell], s.hlo);
      atomicAdd(&si[4 * cap + cell], s.c);
    } else {
      atomicAdd(&sg[cell], s.g);
      atomicAdd(&sh[cell], s.h);
      atomicAdd(&si[cell], s.c);
    }
  }

  // add the block's non-empty cells [0, cells) into out, whose first cell
  // is the block's cell 0 (f32 [.., 3] or i32 [.., 5])
  __device__ void flush(int cells, void* out) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      if constexpr (kInt8) {
        if (si[4 * cap + i] != 0) {
          int* o = reinterpret_cast<int*>(out) + (long long)i * 5;
#pragma unroll
          for (int p = 0; p < 5; ++p) atomicAdd(o + p, si[p * cap + i]);
        }
      } else {
        const int c = si[i];
        if (c != 0) {
          float* o = reinterpret_cast<float*>(out) + (long long)i * 3;
          atomicAdd(o, sg[i]);
          atomicAdd(o + 1, sh[i]);
          atomicAdd(o + 2, (float)c);
        }
      }
    }
  }

 private:
  int cap;
};

}  // namespace lgbt
