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
// grower.py:1274-1325) in XLA before the kernel; here each warp reads its
// rows' indices from the window itself, so the gather is part of the load.
// A window with no index (order == nullptr) runs over rows start..start+cnt
// (the root).  Output: f32 [K, F, B, 3], or raw i32 [K, F, B, 5] digit sums
// (S_g_hi, S_g_lo, S_h_hi, S_h_lo, count) that ops/seg.py combine_int8
// recombines outside the kernel, as combine_hist_raw does on the TPU.
//
// The TPU needs the one-hot matmul because it has no fast scatter-add; the
// card scatters into shared memory, in two passes (two launches):
//   1. ordered_hist_accumulate, a grid of (row chunk, feature group,
//      window) blocks of 32 warps.  A group is 32 features (int8) or 64
//      (f32: two a lane); lane j of every warp owns feature f0 + j (and
//      f0 + 32 + j).  A warp takes one row at a time: its 32 lanes read 32
//      consecutive bin bytes of the row (one whole 32-byte sector) and add
//      the row's values into 32 different features' histograms.  The
//      block's histogram is [plane][set][bin][32] words in shared memory
//      (96 KB-192 KB), so lane j's cell is always in bank j: the 32 adds of
//      a warp never share a bank or an address, whatever the bins (a skewed
//      feature included); only warps that hit one cell at the same moment
//      meet, and shared atomics resolve that.  The statistics of 32 rows
//      are loaded and turned into what they add (g*m, h*m, m != 0, or the
//      int8 digits) once, one row a lane (contiguous at the root), and
//      passed to the warp by shuffles; the bins of 8 rows are loaded
//      before their adds.  The chunks of a window are as many as fill the
//      card once, each of at least kMinRowsPerBlock rows.  The block then
//      copies its whole histogram to its own slot of a scratch buffer;
//   2. ordered_hist_reduce sums each output cell over the window's chunks,
//      in chunk order, and writes every cell (zeros included) through a
//      shared-memory transpose, so that each feature's bins go out as one
//      run.  No global atomics, and the output needs no zeroing.
// Measured on the H100 (PERF.md): sm_90 has no shared-memory f32 atomic
// add, so atomicAdd(float*) there is a compare-and-swap loop
// (ATOMS.CAST.SPIN); the integer adds are native ATOMS.ADD.  Either way a
// warp step (one row of 32 features) costs about 16 cycles of a
// multiprocessor in shared atomics (5 of them: 3 f32 planes as 2 loops and
// an add, or 5 i32 adds), which bounds the kernel.  64-bit shared atomics
// (two planes a word) are compare-and-swap loops too, and were slower.
// The int8 sums are integers, so exact and the same on every run; the f32
// g and h sums move in the last bits with the order of the atomics; the
// counts are exact.
//
// What bounds it on an H100 in principle: memory, one pass over cnt *
// (F + 16) bytes (the bins, three f32 statistics and the row index) plus
// the output; the kernel reads each bin byte once (whole sectors) and the
// statistics once per feature group (from L2 after the first).  In
// practice the shared-memory atomics bound it (above), at ~7x that.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;  // rows whose bins are loaded before their adds
constexpr long long kMinRowsPerBlock = 1024;  // where a window has them
constexpr int kMaxWindows = 16;
constexpr int kQmax = 127 * 128;
constexpr int kReduceThreads = 256;
constexpr int kReduceBins = 32;  // bins of one reduce block

struct Windows {
  long long start[kMaxWindows];
  long long cnt[kMaxWindows];
};

// The accumulator: a cell is kWords 32-bit words, one per plane (f32: g,
// h, count; int8: g_hi, g_lo, h_hi, h_lo, count), each plane a
// [kFpl][bin][32] table, so lane j's cells are all in column j (bank j).
template <bool kInt8>
struct Acc {
  static constexpr int kWords = kInt8 ? 5 : 3;
  static constexpr int kFpl = kInt8 ? 1 : 2;  // features a lane
  static constexpr int kGroup = 32 * kFpl;     // features a block
  static constexpr int kOutPlanes = kInt8 ? 5 : 3;
  static size_t shared_bytes(int nbins) {
    return (size_t)kWords * kFpl * nbins * 32 * 4;
  }
};

// q = clip(round_half_even(x / scale), +-QMAX) * mi as two digits, with
// IEEE division as int8_digit_rows divides (nvcc divides exactly by default)
__device__ __forceinline__ void quant_digits(float x, float scale, int mi,
                                             int& hi, int& lo) {
  float q = rintf(x / scale);
  q = fminf(fmaxf(q, -(float)kQmax), (float)kQmax);
  const int qi = (int)q * mi;
  hi = (qi + 64) >> 7;
  lo = qi - hi * 128;
}

// The values one row adds: f32 (g*m, h*m, m != 0), or the int8 digits
// packed a byte each (g_hi, g_lo, h_hi, h_lo; |hi| <= 127, |lo| <= 64) and
// the count.
struct RowVals {
  float a, b;  // f32: g*m, h*m; int8: a holds the packed digits' bits
  int c;
};

template <bool kInt8>
__device__ __forceinline__ RowVals row_vals(float g, float h, float m,
                                            float sg, float sh) {
  RowVals v;
  if constexpr (kInt8) {
    const int mi = m > 0.0f ? 1 : 0;
    int ghi, glo, hhi, hlo;
    quant_digits(g, sg, mi, ghi, glo);
    quant_digits(h, sh, mi, hhi, hlo);
    const unsigned w = (unsigned)(ghi & 0xff) | ((unsigned)(glo & 0xff) << 8) |
                       ((unsigned)(hhi & 0xff) << 16) |
                       ((unsigned)(hlo & 0xff) << 24);
    v.a = __uint_as_float(w);
    v.b = 0.0f;
    v.c = mi;
  } else {
    v.a = g * m;
    v.b = h * m;
    v.c = m != 0.0f ? 1 : 0;
  }
  return v;
}

__device__ __forceinline__ int digit(unsigned w, int k) {
  return (int)(w << (24 - 8 * k)) >> 24;  // signed byte k
}

template <bool kInt8>
__device__ __forceinline__ void add_row(int* s, int cell, int pw,
                                        const RowVals& v) {
  if constexpr (kInt8) {
    const unsigned w = __float_as_uint(v.a);
#pragma unroll
    for (int p = 0; p < 4; ++p) atomicAdd(&s[p * pw + cell], digit(w, p));
    atomicAdd(&s[4 * pw + cell], v.c);
  } else {
    // sm_90 has no shared f32 atomic add: nvcc emits a compare-and-swap
    // loop (ATOMS.CAST.SPIN) for each of these two
    float* sf = reinterpret_cast<float*>(s);
    atomicAdd(&sf[cell], v.a);
    atomicAdd(&sf[pw + cell], v.b);
    atomicAdd(&s[2 * pw + cell], v.c);
  }
}

// One cell of an accumulator image (shared memory, or its copy in the
// scratch) as the output planes: f32 (g, h, count) or i32 digit sums.
template <bool kInt8>
__device__ __forceinline__ void read_cell(const int* s, int cell, int pw,
                                          int (&o)[5], float (&of)[3]) {
  if constexpr (kInt8) {
#pragma unroll
    for (int p = 0; p < 5; ++p) o[p] = s[p * pw + cell];
  } else {
    const float* sf = reinterpret_cast<const float*>(s);
    of[0] = sf[cell];
    of[1] = sf[pw + cell];
    of[2] = (float)s[2 * pw + cell];
  }
}

// row chunks of window k in a launch of `grid_chunks` (>= 1: an empty
// window still writes its zero histogram)
__device__ __forceinline__ long long window_chunks(long long cnt,
                                                   long long grid_chunks) {
  long long c = (cnt + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  if (c > grid_chunks) c = grid_chunks;
  return c < 1 ? 1 : c;
}

// Pass 1: the (row chunk, feature group, window) block's histogram in
// shared memory, copied out whole into its slot of the scratch.
template <bool kInt8>
__global__ void __launch_bounds__(kThreads)
    ordered_hist_accumulate(const uint8_t* __restrict__ bins, long long stride,
                      const int* __restrict__ order,
                      const float* __restrict__ g, const float* __restrict__ h,
                      const float* __restrict__ m, Windows win, int f,
                      int nbins, const float* __restrict__ scales,
                      int* __restrict__ scratch) {
  using A = Acc<kInt8>;
  constexpr int kFpl = A::kFpl;
  extern __shared__ __align__(16) int smem[];

  const int k = blockIdx.z;
  const long long start = win.start[k];
  const long long cnt = win.cnt[k];
  const long long chunks = window_chunks(cnt, gridDim.x);
  if ((long long)blockIdx.x >= chunks) return;  // whole block: no barrier yet

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int f0 = blockIdx.y * A::kGroup;
  const int pw = kFpl * nbins * 32;  // words of a 32-bit plane
  const int words = A::kWords * pw;
  for (int i = threadIdx.x; i < words; i += kThreads) smem[i] = 0;
  __syncthreads();

  bool has[kFpl];  // whether the lane's features exist
#pragma unroll
  for (int t = 0; t < kFpl; ++t) has[t] = f0 + t * 32 + lane < f;

  const float sg = scales != nullptr ? scales[0] : 1.0f;
  const float sh = scales != nullptr ? scales[1] : 1.0f;
  const long long rows_per_block = (cnt + chunks - 1) / chunks;
  const long long i0 = (long long)blockIdx.x * rows_per_block;
  const long long i1 = min(i0 + rows_per_block, cnt);
  const uint8_t* col = bins + f0 + lane;

  for (long long base = i0 + (long long)warp * 32; base < i1;
       base += (long long)kWarps * 32) {
    // lane u holds row base + u: its index and the values it adds
    const int nvalid = (int)min(32LL, i1 - base);
    long long r = 0;
    RowVals v{0.0f, 0.0f, 0};
    if (lane < nvalid) {
      r = order != nullptr ? (long long)order[start + base + lane]
                           : start + base + lane;
      v = row_vals<kInt8>(g[r], h[r], m[r], sg, sh);
    }
    for (int u0 = 0; u0 < nvalid; u0 += kUnroll) {
      int b[kUnroll][kFpl];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const long long rq = __shfl_sync(0xffffffffu, r, u0 + q);
#pragma unroll
        for (int t = 0; t < kFpl; ++t)
          b[q][t] = (u0 + q < nvalid && has[t]) ? (int)col[rq * stride + t * 32]
                                                : nbins;
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        RowVals w;
        w.a = __shfl_sync(0xffffffffu, v.a, u0 + q);
        w.b = kInt8 ? 0.0f : __shfl_sync(0xffffffffu, v.b, u0 + q);
        w.c = __shfl_sync(0xffffffffu, v.c, u0 + q);
#pragma unroll
        for (int t = 0; t < kFpl; ++t)
          if (b[q][t] < nbins)
            add_row<kInt8>(smem, (t * nbins + b[q][t]) * 32 + lane, pw, w);
      }
    }
  }
  __syncthreads();

  // the image, 16 bytes a thread (words is a multiple of 32)
  const long long slot =
      ((long long)k * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  int4* dst = reinterpret_cast<int4*>(scratch + slot * words);
  const int4* src = reinterpret_cast<const int4*>(smem);
  for (int i = threadIdx.x; i < words / 4; i += kThreads) dst[i] = src[i];
}

// Pass 2: each (32 features, kReduceBins bins, window) tile of the output
// summed over the window's chunks, in chunk order, transposed in shared
// memory and written out whole (every cell, zeros included).
template <bool kInt8>
__global__ void __launch_bounds__(kReduceThreads)
    ordered_hist_reduce(const int* __restrict__ scratch, Windows win, int f,
                  int nbins, int groups, int grid_chunks,
                  void* __restrict__ out) {
  using A = Acc<kInt8>;
  constexpr int P = A::kOutPlanes;
  constexpr int kRow = kReduceBins * P + 1;  // words a feature, odd: no conflicts
  __shared__ int tile[32 * kRow];

  const int k = blockIdx.z;
  const int set = blockIdx.y;  // 32 features: group set / kFpl, its t
  const int grp = set / A::kFpl;
  const int t = set % A::kFpl;
  const int bin0 = blockIdx.x * kReduceBins;
  const int nb = min(kReduceBins, nbins - bin0);
  const int pw = A::kFpl * nbins * 32;
  const int words = A::kWords * pw;
  const long long chunks = window_chunks(win.cnt[k], grid_chunks);
  const int* part =
      scratch + ((long long)k * groups + grp) * grid_chunks * (long long)words;

  for (int e = threadIdx.x; e < nb * 32; e += kReduceThreads) {
    const int j = e & 31;
    const int bin = bin0 + (e >> 5);
    const int cell = (t * nbins + bin) * 32 + j;
    int o[5] = {0, 0, 0, 0, 0};
    float of[3] = {0.0f, 0.0f, 0.0f};
    for (long long c = 0; c < chunks; ++c) {
      int oc[5];
      float ofc[3];
      read_cell<kInt8>(part + c * words, cell, pw, oc, ofc);
#pragma unroll
      for (int p = 0; p < 5; ++p) o[p] += oc[p];
#pragma unroll
      for (int p = 0; p < 3; ++p) of[p] += ofc[p];
    }
    int* row = tile + j * kRow + (e >> 5) * P;
    if constexpr (kInt8) {
#pragma unroll
      for (int p = 0; p < 5; ++p) row[p] = o[p];
    } else {
#pragma unroll
      for (int p = 0; p < 3; ++p) row[p] = __float_as_int(of[p]);
    }
  }
  __syncthreads();

  // each feature's nb * P words are one run of the output
  const int f0 = grp * A::kGroup + t * 32;
  for (int x = threadIdx.x; x < 32 * nb * P; x += kReduceThreads) {
    const int j = x / (nb * P);
    const int y = x % (nb * P);
    if (f0 + j >= f) continue;
    const long long o = (((long long)k * f + f0 + j) * nbins + bin0) * P + y;
    reinterpret_cast<int*>(out)[o] = tile[j * kRow + y];
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

// blocks of the accumulate pass a multiprocessor holds at 256 bins (0 on
// error, with the error in *err)
template <bool kInt8>
int resident_blocks(cudaError_t* err) {
  static int resident = 0;
  if (resident == 0) {
    const int bytes = (int)Acc<kInt8>::shared_bytes(256);
    *err = cudaFuncSetAttribute(ordered_hist_accumulate<kInt8>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (*err != cudaSuccess) return 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, ordered_hist_accumulate<kInt8>, kThreads, bytes);
    if (*err != cudaSuccess) return 0;
    if (resident < 1) *err = cudaErrorInvalidConfiguration;
  }
  return resident;
}

// row chunks of the launch: enough blocks to fill the card once, each with
// at least kMinRowsPerBlock rows
long long grid_chunks(int k, long long max_cnt, int groups, int resident) {
  long long chunks = (max_cnt + kMinRowsPerBlock - 1) / kMinRowsPerBlock;
  long long cap = (long long)resident * sm_count() / ((long long)groups * k);
  if (cap < 1) cap = 1;
  if (chunks > cap) chunks = cap;
  return chunks < 1 ? 1 : chunks;
}

template <bool kInt8>
long long scratch_bytes(int k, long long max_cnt, int f, int nbins,
                        int* groups_out, long long* chunks_out) {
  cudaError_t e = cudaSuccess;
  const int resident = resident_blocks<kInt8>(&e);
  if (e != cudaSuccess) return -(long long)e;
  const int groups = (f + Acc<kInt8>::kGroup - 1) / Acc<kInt8>::kGroup;
  const long long chunks = grid_chunks(k, max_cnt, groups, resident);
  if (groups_out) *groups_out = groups;
  if (chunks_out) *chunks_out = chunks;
  return (long long)k * groups * chunks * (long long)Acc<kInt8>::shared_bytes(nbins);
}

template <bool kInt8>
int launch(const void* bins, long long stride, const void* order,
           const void* g, const void* h, const void* m, const Windows& win,
           int k, long long max_cnt, int f, int nbins, const void* scales,
           void* scratch, long long scratch_size, void* out,
           cudaStream_t stream) {
  int groups = 0;
  long long chunks = 0;
  const long long need = scratch_bytes<kInt8>(k, max_cnt, f, nbins, &groups, &chunks);
  if (need < 0) return (int)(-need);
  if (scratch_size < need || scratch == nullptr) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)chunks, (unsigned)groups, (unsigned)k);
  ordered_hist_accumulate<kInt8><<<grid, kThreads, Acc<kInt8>::shared_bytes(nbins), stream>>>(
      (const uint8_t*)bins, stride, (const int*)order, (const float*)g,
      (const float*)h, (const float*)m, win, f, nbins, (const float*)scales,
      (int*)scratch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 rgrid((unsigned)((nbins + kReduceBins - 1) / kReduceBins),
             (unsigned)(groups * Acc<kInt8>::kFpl), (unsigned)k);
  ordered_hist_reduce<kInt8><<<rgrid, kReduceThreads, 0, stream>>>(
      (const int*)scratch, win, f, nbins, groups, (int)chunks, out);
  return (int)cudaGetLastError();
}

bool read_windows(const long long* windows, int k, Windows* win,
                  long long* max_cnt) {
  if (k < 1 || k > kMaxWindows) return false;
  *max_cnt = 0;
  for (int i = 0; i < k; ++i) {
    win->start[i] = windows[2 * i];
    win->cnt[i] = windows[2 * i + 1] > 0 ? windows[2 * i + 1] : 0;
    if (win->cnt[i] > *max_cnt) *max_cnt = win->cnt[i];
  }
  return true;
}

}  // namespace

// Bytes of scratch that lgbt_ordered_hist needs for these windows (HOST
// [k, 2] i64 (start, cnt)), f features, nbins bins, int8 != 0 for the int8
// mode; a negative value is minus a CUDA error code.
extern "C" long long lgbt_ordered_hist_scratch(const long long* windows, int k,
                                               int f, int nbins, int int8) {
  Windows win;
  long long max_cnt = 0;
  if (!read_windows(windows, k, &win, &max_cnt) || f <= 0 || nbins <= 0 ||
      nbins > 256)
    return -(long long)cudaErrorInvalidValue;
  return int8 ? scratch_bytes<true>(k, max_cnt, f, nbins, nullptr, nullptr)
              : scratch_bytes<false>(k, max_cnt, f, nbins, nullptr, nullptr);
}

// bins: [n, stride] u8 row-major, stride a multiple of 16 and >= f, 16-byte
// aligned; order: [*] i32 row indices, or null (windows index rows
// directly); g, h, m: [n] f32; windows: HOST [k, 2] i64 (start, cnt) into
// order (or the rows); scales: device [2] f32 (g_scale, h_scale) for the
// int8 mode, null for f32; scratch: device, 16-byte aligned, of at least
// lgbt_ordered_hist_scratch(...) bytes.  out (every cell is written): f32
// [k, f, nbins, 3], or (int8) i32 [k, f, nbins, 5] raw planes.  nbins <=
// 256.  Two launches (accumulate, reduce).  Returns cudaGetLastError()
// after them (0 on success).
extern "C" int lgbt_ordered_hist(const void* bins, long long stride,
                                 const void* order, const void* g,
                                 const void* h, const void* m,
                                 const long long* windows, int k, int f,
                                 int nbins, const void* scales, void* scratch,
                                 long long scratch_size, void* out,
                                 void* stream) {
  Windows win;
  long long max_cnt = 0;
  if (!read_windows(windows, k, &win, &max_cnt) || f <= 0 || nbins <= 0 ||
      nbins > 256 || stride % 16 || stride < f)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (scales != nullptr)
    return launch<true>(bins, stride, order, g, h, m, win, k, max_cnt, f,
                        nbins, scales, scratch, scratch_size, out, st);
  return launch<false>(bins, stride, order, g, h, m, win, k, max_cnt, f,
                       nbins, nullptr, scratch, scratch_size, out, st);
}
