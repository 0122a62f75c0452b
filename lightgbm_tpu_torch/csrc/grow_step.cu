// Fused grow step: for K disjoint leaf windows of the segment-resident rows,
// the stable partition of each window, the smaller-child election and the
// smaller child's (g, h, count) histogram, in one call and with no host read
// between its launches.
//
// Replaces the TPU kernel _fused_grow_kernel
// (lightgbm_tpu/ops/pallas/grow_step.py:90, launched through pl.pallas_call
// at grow_step.py:260 by fused_grow_step_pallas; dispatch fused_grow_step
// :318).  Same contract as its XLA oracle (grow_step.py:388-411): each
// window [start, start + cnt) is partitioned stably in place (left rows, in
// their order, to [start, start + nl), the rest after them), the smaller
// child is the left one when nl <= nr, and dec[k] = (nl, nr, child_start,
// child_cnt); the histogram is the smaller child's, f32 [K, F, B, 3], summed
// in f32 or on the int8 2-digit grid and recombined.  Numeric splits only.
//
// The TPU kernel relies on grid programs running in order: program (i, 0)
// partitions and writes dec, programs (i, pt > 0) read it back.  CUDA blocks
// run in no order, so the step is four launches on one stream, each reading
// what the one before it wrote:
//   1-2. the stable partition of csrc/partition.cu (included below, its C
//        entry lgbt_partition called as it stands): tiles staged by 16-byte
//        cp.async copies, ranked by ballots, placed by a look-back, left runs
//        written in place and right runs to a scratch, then the copy of the
//        right runs; it leaves each window's left count nl on the card;
//   3-4. the histogram of csrc/lane_hist.cuh over each window's smaller
//        child, located from nl on the card (lane = feature, a block's table
//        in shared memory: in f32 one warp adding its chunk's rows in row
//        order, in int8 sixteen warps with integer atomics; then a
//        fixed-order reduce that recombines the int8 digit sums and writes
//        dec), so that the sums are the same on every run in both modes.
// The histogram reads the child's rows once more (child * (F + 12) bytes)
// after the partition has written them; in exchange the partition is the
// tuned one of partition.cu, and the histogram one the segment histogram
// can adopt.
//
// What bounds it on an H100: memory.  The least traffic is reading each
// window's rows once and writing them once, 2 * cnt * (F + 16) bytes, plus
// the K * F * B * 12 output bytes.

#include "partition.cu"
#include "lane_hist.cuh"

// Bytes of the histogram scratch lgbt_grow_step needs for any k <= 16 at f
// features and nbins bins (int8 != 0: the int8 mode): a 64-byte head for the
// left counts, then one histogram image a block, as many blocks as the
// mode's accumulate (lhist::Acc<int8, false>) plans.  Negative: minus a CUDA
// error.
extern "C" long long lgbt_grow_step_scratch(int f, int nbins, int int8) {
  if (f <= 0 || nbins <= 0 || nbins > 256) return -(long long)cudaErrorInvalidValue;
  return int8 ? lhist::scratch_bytes<true>(f, nbins) : lhist::scratch_bytes<false>(f, nbins);
}

// One fused grow step over k disjoint windows.  The arguments up to epoch are
// lgbt_partition's (members: host i64 [k, 6] rows (start, cnt, feat, tbin, dl,
// nanb); the partition's scratch, status and staged words, counter, epoch).
// scales: device [2] f32 for the int8 mode, null for f32; hscratch: device,
// 16-byte aligned, of lgbt_grow_step_scratch bytes (hscratch_bytes); dec: i32
// [k, 4] receives (nl, nr, child_start, child_cnt); out: f32 [k, f, nbins, 3],
// every cell written.  Returns the CUDA error of the launches (0 on success).
extern "C" int lgbt_grow_step(void* bins, void* g, void* h, void* m, void* ridx, long long n,
                              int f, const long long* members, int k, int tile, void* s_planes,
                              void* s_cols, long long s_stride, void* status, void* staged,
                              void* counter, unsigned epoch, int nbins, const void* scales,
                              void* hscratch, long long hscratch_bytes, void* dec, void* out,
                              void* stream) {
  if (k < 1 || k > lhist::kMaxWindows || nbins <= 0 || nbins > 256 ||
      hscratch_bytes < lhist::kNlBytes) {
    return (int)cudaErrorInvalidValue;
  }
  int* nl = (int*)hscratch;
  const int rc = lgbt_partition(bins, g, h, m, ridx, n, f, members, k, tile, s_planes, s_cols,
                                s_stride, status, staged, counter, epoch, nl, stream);
  if (rc != 0) return rc;
  lhist::Windows win;
  win.k = k;
  for (int i = 0; i < k; ++i) {
    win.start[i] = members[kMemberCols * i];
    win.cnt[i] = members[kMemberCols * i + 1] > 0 ? members[kMemberCols * i + 1] : 0;
  }
  int* images = (int*)((char*)hscratch + lhist::kNlBytes);
  const long long room = hscratch_bytes - lhist::kNlBytes;
  cudaStream_t st = (cudaStream_t)stream;
  if (scales != nullptr) {
    return lhist::launch<true>((const uint8_t*)bins, n, (const float*)g, (const float*)h,
                               (const float*)m, win, nl, f, nbins, (const float*)scales, images,
                               room, (int*)dec, (float*)out, st);
  }
  return lhist::launch<false>((const uint8_t*)bins, n, (const float*)g, (const float*)h,
                              (const float*)m, win, nl, f, nbins, nullptr, images, room,
                              (int*)dec, (float*)out, st);
}

#ifdef HIST_TRACE
// the accumulate blocks' marks since the last read: u64 [kTraceBlocks,
// kTraceMarks + 2] into host memory (the two clocks last; a block that
// exited at once left zeros), then cleared
extern "C" int lgbt_grow_step_trace(void* host_out) {
  cudaError_t e = cudaMemcpyFromSymbol(host_out, lhist::g_hist_trace, sizeof(lhist::g_hist_trace));
  void* marks = nullptr;
  if (e == cudaSuccess) e = cudaGetSymbolAddress(&marks, lhist::g_hist_trace);
  if (e == cudaSuccess) e = cudaMemset(marks, 0, sizeof(lhist::g_hist_trace));
  return (int)e;
}
#endif
