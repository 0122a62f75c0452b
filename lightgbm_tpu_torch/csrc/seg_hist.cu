// Segment histogram: the (g, h, count) histograms of K disjoint contiguous
// windows [start, start + cnt) of the leaf-ordered training rows.
//
// Replaces the TPU kernel _seg_hist_kernel (lightgbm_tpu/ops/pallas/seg.py:469,
// launched through pl.pallas_call at seg.py:587 by seg_hist_pallas_batch; K=1
// entry seg_hist_pallas at seg.py:521).  Same contract: per window, the
// [F, B, 3] histogram that combine_hist_raw returns (seg.py:436), g and h
// summed as g*mask and h*mask, the count as the sum of the 0/1 mask; a
// window with cnt = 0 gives a zero histogram.  Two modes (hist_block.cuh):
// f32 sums, or the int8 2-digit grid, whose exact i32 digit sums are
// recombined to f32 as combine_hist_raw does; the output is f32 [K, F, B, 3]
// in both.
//
// Layout (the port's own, not the TPU's i16 planes): bins are u8 and
// feature-major [F, n] so one feature of consecutive rows is one contiguous
// run; g, h and mask are separate f32 columns [n].
//
// What bounds it on an H100: in principle memory, one pass over
// cnt * (F + 12) bytes (F bin bytes and three f32 stats a row) plus the
// output; in practice the accumulate's shared memory pipe.  Design: the
// lane histogram of lane_hist.cuh (as the fused grow step runs it, but on
// the host's windows: no left counts, so each window is taken as it is), in
// two launches.  The accumulate is a grid of (row chunk, 32-feature group)
// blocks in which lane j of a warp owns feature j, so a warp's 32 adds hit
// 32 banks: in int8 mode 32 warps adding with shared integer atomics, in
// f32 mode one warp adding its chunk's rows in row order with plain loads
// and stores (as in the fused step), so that the f32 sums do not depend on
// the order in which warps reach a cell; each block copies its table to its slot of a
// scratch.  The reduce sums each window's slots in a fixed order,
// recombines the int8 digit sums (bit-equal to combine_int8 under
// -fmad=false) and writes every output cell.  No zeroed output, no global
// atomics, and the sums are the same on every run in both modes.

#include "lane_hist.cuh"

// Bytes of the scratch lgbt_seg_hist needs for any k <= 16 at f features
// and nbins bins (int8 != 0: the int8 mode): those of
// lgbt_grow_step_scratch (its 64-byte head, unused here, then one table
// image a block), so that both kernels can share one scratch.  Negative:
// minus a CUDA error.
extern "C" long long lgbt_seg_hist_scratch(int f, int nbins, int int8) {
  if (f <= 0 || nbins <= 0 || nbins > 256) return -(long long)cudaErrorInvalidValue;
  return int8 ? lhist::scratch_bytes<true, true>(f, nbins)
              : lhist::scratch_bytes<false, true>(f, nbins);
}

// bins: [f, n] u8; g, h, m: [n] f32; windows: HOST [k, 2] i64 (start, cnt;
// a negative cnt counts as 0); scales: device [2] f32 (g_scale, h_scale)
// for the int8 mode, null for f32; scratch: device, 16-byte aligned, of
// lgbt_seg_hist_scratch bytes (scratch_bytes); out: f32 [k, f, nbins, 3],
// every cell written.  Returns the CUDA error of the launches (0 on
// success).
extern "C" int lgbt_seg_hist(const void* bins, const void* g, const void* h, const void* m,
                             long long n, const long long* windows, int k, int f, int nbins,
                             const void* scales, void* scratch, long long scratch_bytes,
                             void* out, void* stream) {
  if (k < 1 || k > lhist::kMaxWindows || f <= 0 || nbins <= 0 || nbins > 256 ||
      scratch_bytes < lhist::kNlBytes) {
    return (int)cudaErrorInvalidValue;
  }
  lhist::Windows win;
  win.k = k;
  for (int i = 0; i < k; ++i) {
    win.start[i] = windows[2 * i];
    win.cnt[i] = windows[2 * i + 1] > 0 ? windows[2 * i + 1] : 0;
  }
  int* images = (int*)((char*)scratch + lhist::kNlBytes);
  const long long room = scratch_bytes - lhist::kNlBytes;
  cudaStream_t st = (cudaStream_t)stream;
  if (scales != nullptr) {
    return lhist::launch<true, true>((const uint8_t*)bins, n, (const float*)g,
                                     (const float*)h, (const float*)m, win, nullptr, f, nbins,
                                     (const float*)scales, images, room, nullptr, (float*)out,
                                     st);
  }
  return lhist::launch<false, true>((const uint8_t*)bins, n, (const float*)g, (const float*)h,
                                    (const float*)m, win, nullptr, f, nbins, nullptr, images,
                                    room, nullptr, (float*)out, st);
}

#ifdef HIST_TRACE
// the accumulate blocks' marks since the last read: u64 [kTraceBlocks,
// kTraceMarks + 2] into host memory (the two clocks last; a block that
// exited at once left zeros), then cleared
extern "C" int lgbt_seg_hist_trace(void* host_out) {
  cudaError_t e = cudaMemcpyFromSymbol(host_out, lhist::g_hist_trace, sizeof(lhist::g_hist_trace));
  void* marks = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&marks, lhist::g_hist_trace);
  if (e == cudaSuccess) e = cudaMemset(marks, 0, sizeof(lhist::g_hist_trace));
  return (int)e;
}
#endif
