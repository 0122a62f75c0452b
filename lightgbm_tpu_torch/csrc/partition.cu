// Stable partition of K disjoint leaf windows of the segment-resident rows.
//
// Replaces two TPU kernels:
//   * _seg_partition_kernel (lightgbm_tpu/ops/pallas/partition.py:334, body
//     _partition_window :104), launched through pl.pallas_call at
//     partition.py:446 by seg_partition_pallas: one window;
//   * the same kernel over a K-program grid, launched at partition.py:525
//     by seg_partition_pallas_batch: K disjoint windows in one call, for
//     frontier-batched growth with grow_fused='off'.
// One C entry, lgbt_partition, takes K windows; one window is K = 1.
// Same contract as the XLA oracles sort_partition_xla
// (lightgbm_tpu/ops/segpart.py:65) and sort_partition_batch (:228): the
// rows of each window [start, start + cnt) that go left move, in their
// order, to [start, start + nl), the rest, in their order, to
// [start + nl, start + cnt); rows outside the windows are not touched; a
// window with cnt = 0 is a no-op; nl is returned per window.  A row goes
// left by the window's rule: the threshold (its bin is <= the threshold bin,
// or it sits in the feature's NaN bin and missing values go left,
// ops/segpart.py:52 _go_left), or, for a table member (iscat), the bit of
// its bin in the window's goes-left table, the cat_ref operand of the TPU
// kernel (partition.py:115, :271-285, [1, bmt] with bmt = max(256, bins
// rounded up to 128)): an EFB bundle-plane split, whose left rows are every
// plane bin outside the member's [t, end], or a categorical split, whose
// left rows are its categories' bins.
//
// Layout (the port's, not the TPU's i16 planes): bins u8 feature-major
// [f, n]; g, h, m f32 and ridx i32 columns [n], moved as 32-bit words.
// The u16 mode (wide; the TPU kernel's one u16 plane a feature past 256
// bins, partition.py:244-262): a feature's bin is two byte planes, lo at
// plane 2 feat and hi at 2 feat + 1, so the moves stay the u8 mode's (every
// plane a run of bytes) and only the decision reads lo | hi << 8, against
// a 16-bit tbin and nanb; a table member goes left by its table's bit of
// the bin, and a bin past the table's 256 goes right.
//
// What bounds it on an H100: memory.  The least traffic is reading the
// windows' rows once and writing them once, 2 * rows * (f + 16) bytes.
//
// Design: two launches per call, both over all K windows at once.
//   1. tiles (partition_tile_kernel): one block per tile of T rows of a
//      window, numbered by a global counter in launch order.  The block
//      starts 16-byte cp.async copies of its rows (every plane and column)
//      into shared memory; meanwhile it reads the split feature's bytes
//      directly, ranks the rows by ballots (rank_tile), publishes its left
//      count, and looks back over the window's earlier tiles' counts, 256
//      at a time, for its left offset L0.  Its left rows then go IN PLACE
//      to [start + L0, start + L0 + left), once every earlier tile whose
//      rows lie there has published that it has staged them (publish_staged,
//      wait_staged); its right rows go, in order, to the window's
//      part of a scratch at the window's right rank R0 = (rows before the
//      tile) - L0.  Both runs are written by consecutive lanes as aligned
//      4-byte words.  The window's last tile writes nl.
//   2. copy (partition_copy_kernel): the scratch's right runs are copied
//      to [start + nl, start + cnt) by one warp a run of kCopyRows rows,
//      aligned 4-byte stores built from two aligned loads whatever the two
//      runs' alignments, each lane's loads all in flight before its
//      stores; it also resets the tile counter for the next call.
// Traffic: each row read and written once in pass 1, each right row read
// and written once more in pass 2: about (2 + 2 * right share) * (f + 16)
// bytes a row, against the earlier design's four passes.  The scratch, the
// status and staged words and the counter belong to the caller and live
// across calls (the words carry an epoch, so nothing is cleared).  The
// tile size T is the host's (ops/seg.py partition_tile_rows): at most what
// keeps three blocks' stages on a multiprocessor, smaller for a call on few
// rows, so that they still make a few hundred tiles.
//
// The table travels in the launch's parameters (8 words a window, beside
// tbin, dl and nanb): no copy to the card and no launch more; a tile reads
// its window's words into shared memory, and the rule is uniform per tile.
// Wide tables (a call whose tables send a bin at or past 256 left: a
// categorical split past 256 bins; up to 8,192 bins, 256 words, a window):
// unrolled parameter words would not scale, so the call's table members
// read their whole tables from a [k, W] u32 array on the card instead, the
// tile's threads copying its window's W words into shared memory behind
// the column stages with one coalesced load, and a row goes left by bit
// v & 31 of word v >> 5 for v < 32 W (a bin past the table goes right).
// The narrow tables keep the parameter path (W = 0), so a call of the EFB
// table mode runs the same instructions as before.
//
// All moves are plain loads and stores: the result is exact and the same
// on every run, and K windows in one call equal K calls of one window.

#include "partition_tile.cuh"

namespace {

using namespace ptile;

constexpr int kMaxWindows = 16;
constexpr int kCopyRows = 1024;  // right rows a block of the copy pass moves
// loads a lane of the copy pass keeps in flight: a plane's run of kCopyRows
// bytes is at most 257 aligned words, a column's quarter 256 words
constexpr int kCopyPlaneUnroll = (kCopyRows / 4 + 1 + 31) / 32;
constexpr int kCopyColUnroll = kCopyRows / 4 / 32;
constexpr int kTableWords = 8;   // the goes-left table: a bit a bin, 256 bins
// start, cnt, feat, tbin, dl, nanb, iscat, then the table's words
constexpr int kMemberCols = 7 + kTableWords;
constexpr int kWriteUnroll = 2;  // rows of the columns a thread of a tile moves at a time
constexpr int kMaxPlanes = 512;  // the stage offsets' room; the host's tile rule allows fewer
constexpr int kMaxWideWords = 2048;  // a wide table's words, at most: 65,536 bins

struct Plan {
  int k;
  long long start[kMaxWindows];
  long long cnt[kMaxWindows];
  long long tile0[kMaxWindows + 1];  // the window's first tile; [k]: all tiles
  long long s0[kMaxWindows];         // the window's offset in the scratch
  int feat[kMaxWindows];
  int tbin[kMaxWindows];
  int dl[kMaxWindows];
  int nanb[kMaxWindows];
  int iscat[kMaxWindows];
  unsigned table[kMaxWindows][kTableWords];
};

// Window w's table words into shared memory, by thread 0, at constant
// offsets into the parameters (a runtime index into a parameter array
// would copy the array to local memory); the caller synchronises.
__device__ __forceinline__ void load_table(const Plan& P, int w, unsigned* dst) {
  if (threadIdx.x != 0) return;
#pragma unroll
  for (int i = 0; i < kMaxWindows; ++i) {
    if (i == w) {
#pragma unroll
      for (int j = 0; j < kTableWords; ++j) dst[j] = P.table[i][j];
    }
  }
}

struct Cols {
  uint32_t* c[4];  // g, h, m, ridx
  // column i by selects (a runtime index into a parameter array would copy
  // the array to local memory)
  __device__ __forceinline__ uint32_t* at(int i) const {
    return i == 0 ? c[0] : i == 1 ? c[1] : i == 2 ? c[2] : c[3];
  }
};

// the rows, the caller's scratch and the call's epoch
struct Args {
  uint8_t* bins;
  Cols cols;
  long long n;
  int f;     // planes
  int wide;  // the u16 mode: feature j's bins are planes 2j (lo) and 2j + 1 (hi)
  uint8_t* s_planes;  // [f, s_stride]
  uint32_t* s_cols;   // [4, s_stride]
  long long s_stride;
  unsigned long long* status;
  unsigned* staged;
  int* counter;
  unsigned epoch;
  int* nl_out;
  const unsigned* wtable;  // [k, wwords] u32 goes-left tables, or null
  int wwords;              // 0: the tables are the members' parameter words
};

// the wide table of a window into shared memory, one coalesced load of its
// words by the block's threads; the caller synchronises
__device__ __forceinline__ void load_wide_table(const unsigned* src, int words, unsigned* dst) {
  for (int i = threadIdx.x; i < words; i += kThreads) dst[i] = src[i];
}

// bytes of a tile's stage: a plane of T rows, a 4-byte column of T rows
template <int T>
struct Stage {
  static constexpr int kPlane = T + 32;
  static constexpr int kCol = 4 * T + 32;
};

// -DPART_TRACE: each tile's thread 0 notes the global timer (ns) at the
// ends of its phases, and the multiprocessor's clock at the first and the
// last, read back by lgbt_partition_trace (a diagnostic build of the
// bench; the kernel's own builds leave it out)
#ifdef PART_TRACE
constexpr int kTraceTiles = 4096;
constexpr int kTraceMarks = 7;
__device__ unsigned long long g_trace[kTraceTiles][kTraceMarks + 2];
__device__ __forceinline__ void mark(long long t, int k) {
  __syncthreads();
  if (threadIdx.x == 0 && t < kTraceTiles) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    g_trace[t][k] = ns;
    if (k == 0 || k == kTraceMarks - 1) g_trace[t][kTraceMarks + (k > 0)] = clock64();
  }
}
#define PART_MARK(t, k) mark(t, k)
#else
#define PART_MARK(t, k)
#endif

template <int T>
__global__ void __launch_bounds__(kThreads) partition_tile_kernel(Args a, Plan P) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ uint16_t src_of[T];
  __shared__ uint32_t mask[T / 32];
  __shared__ int pre[T / 32];
  __shared__ unsigned red[kWarps];
  __shared__ uint8_t soff[kMaxPlanes];  // plane j's first row at stage byte soff[j]
  __shared__ unsigned s_table[kTableWords];
  __shared__ long long s_tile;
  __shared__ int s_left;
  const long long n = a.n;
  const int f = a.f;

  if (threadIdx.x == 0) s_tile = atomicAdd(a.counter, 1);
  __syncthreads();
  const long long t = s_tile;
  int w = 0;
  while (w + 1 < P.k && t >= P.tile0[w + 1]) ++w;
  const long long base = (t - P.tile0[w]) * T;  // window rows before the tile
  const int tt = (int)min((long long)T, P.cnt[w] - base);
  const long long row0 = P.start[w] + base;
  PART_MARK(t, 0);

  // 1. read the split feature's bytes of the tile's rows, then start
  // staging every plane and column of them
  int key[Chunks<T>::kPerWarp];
  const uint8_t* col = a.bins + (long long)P.feat[w] * (a.wide ? 2 : 1) * n + row0;
  load_keys<T>(tt, col, a.wide ? col + n : nullptr, key);
  for (int j = threadIdx.x; j < f; j += kThreads) {
    soff[j] = (uint8_t)align16_offset(a.bins + (long long)j * n + row0);
  }
  uint8_t* planes = smem;
  uint8_t* cstage = smem + (size_t)f * Stage<T>::kPlane;
  stage_runs(planes, Stage<T>::kPlane, a.bins + row0, n, f, tt, Stage<T>::kPlane / 16);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    stage_runs(cstage + c * Stage<T>::kCol, 0,
               reinterpret_cast<const uint8_t*>(a.cols.c[c] + row0), 0, 1, 4 * tt,
               Stage<T>::kCol / 16);
  }
  PART_MARK(t, 1);

  // 2. meanwhile rank the rows and publish the tile's left count
  const int tbin = P.tbin[w], dl = P.dl[w], nanb = P.nanb[w];
  const bool by_table = P.iscat[w] != 0;
  // a wide call's table members: the window's words, behind the stages
  const bool wide_table = by_table && a.wwords > 0;
  unsigned* s_wide = reinterpret_cast<unsigned*>(cstage + 4 * Stage<T>::kCol);
  if (wide_table) {
    load_wide_table(a.wtable + (long long)w * a.wwords, a.wwords, s_wide);
    __syncthreads();
  } else if (by_table) {
    load_table(P, w, s_table);
    __syncthreads();
  }
  const int wbits = 32 * a.wwords;
  const int tl =
      wide_table
          ? rank_tile<T>(
                tt, key,
                [&](int v) { return v < wbits && ((s_wide[v >> 5] >> (v & 31)) & 1u); },
                src_of, mask, pre, &s_left)
          : rank_tile<T>(
                tt, key,
                [&](int v) {
                  return by_table ? (v < 32 * kTableWords && ((s_table[v >> 5] >> (v & 31)) & 1u))
                                  : go_left(v, tbin, dl, nanb);
                },
                src_of, mask, pre, &s_left);
  publish_count(a.status, t, P.tile0[w], (unsigned)tl, a.epoch);
  PART_MARK(t, 2);

  // 3. once the copies have landed, publish that the tile is staged
  cp_async_wait_all();
  __syncthreads();
  publish_staged(a.staged, t, a.epoch);
  PART_MARK(t, 3);

  // 4. the tile's left offset; then wait for the earlier tiles whose rows
  // the left run overwrites to have staged theirs
  const unsigned excl = lookback(a.status, t, P.tile0[w], (unsigned)tl, a.epoch, red);
  if (threadIdx.x == 0 && t + 1 == P.tile0[w + 1]) a.nl_out[w] = (int)(excl + tl);
  PART_MARK(t, 4);
  wait_staged(a.staged, t, P.tile0[w] + excl / T, a.epoch);
  PART_MARK(t, 5);

  // 5. the left run in place, the right run to the scratch
  const long long lbase = P.start[w] + excl;
  const long long rbase = P.s0[w] + base - excl;
  const int tr = tt - tl;
  write_planes(a.bins + lbase, n, f, tl, planes, Stage<T>::kPlane, soff, src_of);
  write_planes(a.s_planes + rbase, a.s_stride, f, tr, planes, Stage<T>::kPlane, soff,
               src_of + tl);
  auto col_stage = [&](int c) {
    return reinterpret_cast<const uint32_t*>(cstage + c * Stage<T>::kCol +
                                             align16_offset(a.cols.at(c) + row0));
  };
  write_cols<kWriteUnroll>([&](int c) { return a.cols.at(c) + lbase; }, col_stage, tl, src_of);
  write_cols<kWriteUnroll>([&](int c) { return a.s_cols + c * a.s_stride + rbase; }, col_stage,
                           tr, src_of + tl);
  PART_MARK(t, 6);
}

// blockIdx.z: the window; blockIdx.x: kCopyRows of its right rows;
// blockIdx.y: a group of kWarps runs, one a warp (the f planes, then the
// four columns in quarters)
__global__ void __launch_bounds__(kThreads) partition_copy_kernel(Args a, Plan P) {
  const int w = blockIdx.z;
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.y * kWarps + (threadIdx.x >> 5);
  const bool lead = blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0;
  if (lead && w == 0) *a.counter = 0;
  if (P.cnt[w] == 0) {
    if (lead) a.nl_out[w] = 0;
    return;
  }
  const long long nl = a.nl_out[w];
  const long long r0 = (long long)blockIdx.x * kCopyRows;
  if (r0 >= P.cnt[w] - nl || item >= a.f + 16) return;
  const int len = (int)min((long long)kCopyRows, P.cnt[w] - nl - r0);
  const long long dst0 = P.start[w] + nl + r0;
  const long long src0 = P.s0[w] + r0;
  if (item < a.f) {
    copy_run_u8<kCopyPlaneUnroll>(a.bins + (long long)item * a.n + dst0,
                                  a.s_planes + (long long)item * a.s_stride + src0, len, lane);
  } else {
    const int c = (item - a.f) >> 2, q = (item - a.f) & 3;
    const int lo = q * (len >> 2), hi = q == 3 ? len : lo + (len >> 2);
    copy_run_u32<kCopyColUnroll>(a.cols.at(c) + dst0 + lo, a.s_cols + c * a.s_stride + src0 + lo,
                                 hi - lo, lane);
  }
}

template <int T>
int launch_tiles(long long tiles, const Args& a, const Plan& P, cudaStream_t st) {
  const int dyn = a.f * Stage<T>::kPlane + 4 * Stage<T>::kCol + 4 * a.wwords;
  static int allowed = 48 * 1024;  // dynamic shared memory this kernel may take
  if (dyn > allowed) {
    const cudaError_t e = cudaFuncSetAttribute(
        partition_tile_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e != cudaSuccess) return (int)e;
    allowed = dyn;
  }
  partition_tile_kernel<T><<<(unsigned)tiles, kThreads, dyn, st>>>(a, P);
  return (int)cudaGetLastError();
}

}  // namespace

// K stable partitions of disjoint windows in one call (K = 1: one window).
// f: the planes; wide != 0: the u16 mode, f = 2 x features (feat is a
// feature, its bins planes 2 feat and 2 feat + 1).
// members: host i64 [k, kMemberCols] rows (start, cnt, feat, tbin, dl, nanb,
// iscat, then the goes-left table's 8 words, bit v & 31 of word v >> 5 for
// bin v, read when iscat != 0 and wwords = 0); the
// windows are cut into tiles of `tile` rows (the host's choice, one of the
// instantiated sizes), counted over the windows in member order, and
// window i's right run goes to the scratch at 16 plus the earlier
// windows' cnt, each rounded up to 16 rows (ops/seg.py sizes the scratch
// for that).  Scratch: s_planes u8 [f, s_stride], s_cols 4-byte
// [4, s_stride], status u64 and staged u32 [>= all tiles], counter i32 (0
// between calls; the call leaves it 0), epoch in [1, 2^30) and new for
// every call that shares the status and staged words.  nl_out [k] i32
// receives the left counts.  wtable, wwords: wwords > 0 gives every table
// member's whole table as row i of a device u32 [k, wwords] array (bit
// v & 31 of word v >> 5 for bin v, up to kMaxWideWords words), read in
// place of its parameter words; wwords = 0 (wtable null) the parameter
// path.  Every pointer 16-byte aligned (wtable 4-byte).  Returns
// cudaGetLastError() after the launches (0 on success).
extern "C" int lgbt_partition(void* bins, void* g, void* h, void* m, void* ridx, long long n,
                              int f, int wide, const long long* members, int k, int tile,
                              void* s_planes, void* s_cols, long long s_stride, void* status,
                              void* staged, void* counter, unsigned epoch, void* nl_out,
                              void* stream, const void* wtable, int wwords) {
  if (k < 1 || k > kMaxWindows || f <= 0 || f > kMaxPlanes || tile <= 0 || epoch == 0 ||
      epoch >= (1u << 30) || (wide && f % 2) || wwords < 0 || wwords > kMaxWideWords ||
      (wwords > 0 && wtable == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const int features = wide ? f / 2 : f;
  Plan P;
  P.k = k;
  P.tile0[0] = 0;
  long long most = 0, s0 = 16;
  for (int i = 0; i < k; ++i) {
    const long long* r = members + kMemberCols * i;
    P.start[i] = r[0];
    P.cnt[i] = r[1] > 0 ? r[1] : 0;
    P.feat[i] = (int)r[2];
    if (P.cnt[i] > 0 && (r[2] < 0 || r[2] >= features)) return (int)cudaErrorInvalidValue;
    P.tbin[i] = (int)r[3];
    P.dl[i] = (int)r[4];
    P.nanb[i] = (int)r[5];
    P.iscat[i] = r[6] != 0;
    for (int j = 0; j < kTableWords; ++j) P.table[i][j] = (unsigned)r[7 + j];
    P.tile0[i + 1] = P.tile0[i] + (P.cnt[i] + tile - 1) / tile;
    P.s0[i] = s0;
    s0 += (P.cnt[i] + 15) / 16 * 16;
    most = P.cnt[i] > most ? P.cnt[i] : most;
  }
  const Args a{(uint8_t*)bins,
               Cols{{(uint32_t*)g, (uint32_t*)h, (uint32_t*)m, (uint32_t*)ridx}},
               n,
               f,
               wide != 0,
               (uint8_t*)s_planes,
               (uint32_t*)s_cols,
               s_stride,
               (unsigned long long*)status,
               (unsigned*)staged,
               (int*)counter,
               epoch,
               (int*)nl_out,
               (const unsigned*)wtable,
               wwords};
  cudaStream_t st = (cudaStream_t)stream;
  const long long tiles = P.tile0[k];
  if (tiles > 0) {
    int rc;
    switch (tile) {
      case 2048: rc = launch_tiles<2048>(tiles, a, P, st); break;
      case 1024: rc = launch_tiles<1024>(tiles, a, P, st); break;
      case 512: rc = launch_tiles<512>(tiles, a, P, st); break;
      case 256: rc = launch_tiles<256>(tiles, a, P, st); break;
      case 128: rc = launch_tiles<128>(tiles, a, P, st); break;
      default: return (int)cudaErrorInvalidValue;
    }
    if (rc != 0) return rc;
  }
  const long long xblocks = most > 0 ? (most + kCopyRows - 1) / kCopyRows : 1;
  const unsigned groups = (unsigned)((f + 16 + kWarps - 1) / kWarps);
  partition_copy_kernel<<<dim3((unsigned)xblocks, groups, (unsigned)k), kThreads, 0, st>>>(a, P);
  return (int)cudaGetLastError();
}

#ifdef PART_TRACE
// the marks of the last call: u64 [kTraceTiles, kTraceMarks + 2] into host
// memory (the two clocks last)
extern "C" int lgbt_partition_trace(void* host_out) {
  return (int)cudaMemcpyFromSymbol(host_out, g_trace, sizeof(g_trace));
}
#endif
