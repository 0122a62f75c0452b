// Block-level pieces of a one-pass stable partition on Hopper: a tile of
// rows staged in shared memory by 16-byte asynchronous copies, its rows
// ranked with warp ballots, its left-row offset found by a look-back over
// the tiles before it, and its two runs (left rows, right rows) written
// out as contiguous runs by consecutive lanes.
//
// Layout (the port's seg rows): bins u8 feature-major [f, n] (past 256
// bins, a feature's u16 bin as two byte planes, lo then hi); four 4-byte
// columns (g, h, m f32 and ridx i32, moved as raw 32-bit words).  A tile
// is T consecutive rows of one window; it stages f planes of T + 32 bytes
// and four columns of 4T + 32 bytes, each run of global memory copied as
// the 16-byte aligned chunks that cover it, so row r of a run sits at
// byte (address & 15) + r of its stage.
//
// Two kinds of words, one per tile, tell the other tiles how far a tile
// has come:
//  * a status word, 64 bits: the high word is (epoch << 2) | flag (flag 1:
//    the tile's own left count; 2: the left count of the window's tiles up
//    to and including it), the low word the count.  A tile publishes its
//    own count as soon as it has ranked its rows (from the split feature's
//    bytes alone), so the look-back never waits on another tile's copies;
//    the whole block looks back, kThreads tiles a step.
//  * a staged word, 32 bits: the epoch, once the tile has read every byte
//    it will move.  A tile writes its left rows over rows of earlier tiles
//    only after those tiles' staged words say so.
// Words from an earlier call carry an older epoch and read as "not yet",
// so they need no clearing between calls.  Tiles take their numbers from a
// global counter in launch order, and nothing a tile waits for waits on a
// later tile, so every wait ends.
//
// Used by csrc/partition.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ptile {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAggregate = 1;
constexpr unsigned kInclusive = 2;

__device__ __forceinline__ int go_left(int v, int tbin, int dl, int nanb) {
  return (v <= tbin) || (dl && nanb >= 0 && v == nanb);
}

// ------------------------------------------------------------ staging
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ int align16_offset(const void* p) {
  return (int)((uintptr_t)p & 15);
}

// Issue the copies of `runs` byte runs, run j of `len` bytes at
// src + j * stride, into stage + j * sstride (the 16-byte chunks that
// cover it, `per` chunks at most).  Every thread of the block takes part.
__device__ __forceinline__ void stage_runs(uint8_t* stage, int sstride, const uint8_t* src,
                                           long long stride, int runs, int len, int per) {
  for (int idx = threadIdx.x; idx < runs * per; idx += kThreads) {
    const int j = idx / per;
    const int c = idx - j * per;
    const uint8_t* s = src + (long long)j * stride;
    const int o = align16_offset(s);
    if (c < ((o + len + 15) >> 4)) cp_async16(stage + j * sstride + 16 * c, s - o + 16 * c);
  }
}

// --------------------------------------------------------------- rank
// A tile's rows a warp takes: chunks of 32 rows, chunk c to warp c % kWarps.
template <int T>
struct Chunks {
  static constexpr int kCount = T / 32;
  static constexpr int kPerWarp = (kCount + kWarps - 1) / kWarps;
};

// The split feature's bins of this thread's rows (-1 past the tile's
// `tt` rows): its bytes, or with a hi plane (the u16 mode) lo | hi << 8;
// the loads issued and not waited for: the caller can issue more work
// before rank_tile uses them.
template <int T>
__device__ __forceinline__ void load_keys(int tt, const uint8_t* col, const uint8_t* hi,
                                          int (&key)[Chunks<T>::kPerWarp]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < Chunks<T>::kPerWarp; ++i) {
    const int r = 32 * (warp + i * kWarps) + lane;
    key[i] = -1;  // a predicated load, no select waiting on it
    if (r < tt) key[i] = hi != nullptr ? (int)col[r] | (int)hi[r] << 8 : (int)col[r];
  }
}

// Stable ranks of a tile's `tt` rows by their keys (load_keys; a row goes
// left when left(key) holds).  Writes src_of[p] = r, p the row's place in
// the tile's output: left rows first (p = its rank among the left rows),
// then the right rows (p = left count + its rank among the right rows).
// Returns the left count.  mask and pre hold T / 32 words; every thread of
// the block calls it.
template <int T, class Left>
__device__ __forceinline__ int rank_tile(int tt, const int (&key)[Chunks<T>::kPerWarp],
                                         Left left_of, uint16_t* src_of, uint32_t* mask, int* pre,
                                         int* left) {
  constexpr int kChunks = Chunks<T>::kCount;
  static_assert(kChunks <= 64, "two chunks a lane in the scan");
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < Chunks<T>::kPerWarp; ++i) {
    const int c = warp + i * kWarps;
    if (c < kChunks) {
      const unsigned bits = __ballot_sync(0xffffffffu, key[i] >= 0 && left_of(key[i]));
      if (lane == 0) mask[c] = bits;
    }
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the chunks' left counts
    const int c0 = 2 * lane, c1 = c0 + 1;
    const int a = c0 < kChunks ? __popc(mask[c0]) : 0;
    const int b = c1 < kChunks ? __popc(mask[c1]) : 0;
    int incl = a + b;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += y;
    }
    if (c0 < kChunks) pre[c0] = incl - a - b;
    if (c1 < kChunks) pre[c1] = incl - b;
    if (lane == 31) *left = incl;
  }
  __syncthreads();
  const int tl = *left;
  for (int c = warp; c < kChunks; c += kWarps) {
    const int r = 32 * c + lane;
    if (r < tt) {
      const unsigned bits = mask[c];
      const int li = pre[c] + __popc(bits & ((1u << lane) - 1u));
      src_of[((bits >> lane) & 1u) ? li : tl + r - li] = (uint16_t)r;
    }
  }
  return tl;
}

// ---------------------------------------------------------- look-back
__device__ __forceinline__ unsigned long long status_word(unsigned epoch, unsigned flag,
                                                          unsigned count) {
  return ((unsigned long long)((epoch << 2) | flag) << 32) | count;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release_u32(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned load_acquire_u32(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// min (kind 0) or sum (kind 1) of one value a thread over the block, on
// every thread; red holds kWarps words
template <int kind>
__device__ __forceinline__ unsigned block_reduce(unsigned v, unsigned* red) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned y = __shfl_xor_sync(0xffffffffu, v, d);
    v = kind == 0 ? min(v, y) : v + y;
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) v = kind == 0 ? min(v, red[w]) : v + red[w];
  __syncthreads();
  return v;
}

// Publish tile t's own left count (the window's first tile: its inclusive
// count); thread 0 of the block.
__device__ __forceinline__ void publish_count(unsigned long long* status, long long t,
                                              long long first, unsigned agg, unsigned epoch) {
  if (threadIdx.x == 0) {
    store_release(status + t, status_word(epoch, t == first ? kInclusive : kAggregate, agg));
  }
}

// Left rows of the window's tiles before tile `t` (`first`: the window's
// first tile), whose own left count `agg` it has published; publishes its
// inclusive count.  Every thread of the block calls it and gets the prefix:
// each step, thread i reads the word of tile t - 1 - i (waiting until that
// tile has published), and the nearest inclusive word ends the walk.
__device__ __forceinline__ unsigned lookback(unsigned long long* status, long long t,
                                             long long first, unsigned agg, unsigned epoch,
                                             unsigned* red) {
  unsigned excl = 0;
  for (long long hi = t - 1; hi >= first; hi -= kThreads) {
    const long long j = hi - threadIdx.x;
    unsigned long long s = 0;
    unsigned flag = 0;
    if (j >= first) {
      do {
        s = load_acquire(status + j);
        flag = (unsigned)(s >> 32) >> 2 == epoch ? (unsigned)(s >> 32) & 3u : 0u;
      } while (flag == 0);
    }
    const unsigned near =
        block_reduce<0>(flag == kInclusive ? threadIdx.x : (unsigned)kThreads, red);
    excl += block_reduce<1>(j >= first && threadIdx.x <= near ? (unsigned)s : 0u, red);
    if (near < (unsigned)kThreads) break;
  }
  if (t > first && threadIdx.x == 0) {
    store_release(status + t, status_word(epoch, kInclusive, excl + agg));
  }
  return excl;
}

// Publish that tile t has read every byte it will move (the caller has
// waited for its copies and synchronised the block); thread 0.
__device__ __forceinline__ void publish_staged(unsigned* staged, long long t, unsigned epoch) {
  if (threadIdx.x == 0) {
    __threadfence();
    store_release_u32(staged + t, epoch);
  }
}

// Wait until the tiles [lo, t) have published that they are staged.
// Every thread of the block calls it.
__device__ __forceinline__ void wait_staged(const unsigned* staged, long long t, long long lo,
                                            unsigned epoch) {
  for (long long j = lo + threadIdx.x; j < t; j += kThreads) {
    while (load_acquire_u32(staged + j) != epoch) {
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------- writes
// q = idx / d for 0 <= idx < 2^22, with inv = 1 / d (a float product and
// one correction instead of an integer division)
__device__ __forceinline__ int div_small(int idx, int d, float inv) {
  int q = (int)((float)idx * inv);
  if (q * d > idx) {
    --q;
  } else if ((q + 1) * d <= idx) {
    ++q;
  }
  return q;
}

// The f byte runs of one side of a tile, by the whole block: run j is
// dst0 + j * dstride, `len` bytes, byte p of it
// planes[j * pstride + soff[j] + src_of[p]].  The runs are cut into their
// aligned 4-byte words (a word that a run covers only in part is written
// byte by byte: its other bytes belong to other runs).  Planes j = r,
// r + g, r + 2g, ... lie at one alignment for g a multiple of 4, so a
// thread takes one word of one such class of planes: it reads that word's
// four ranks once and then moves the word of every plane of the class,
// with three shared loads and one store a byte at most.
__device__ __forceinline__ void write_planes(uint8_t* dst0, long long dstride, int f, int len,
                                             const uint8_t* planes, int pstride,
                                             const uint8_t* soff, const uint16_t* src_of) {
  if (len <= 0) return;
  const int nw = (len + 6) >> 2;  // words a run covers, whatever its alignment
  // a class is every g-th plane, g a multiple of 4 and large enough to give
  // every thread a job
  const int g = 4 * ((kThreads + 4 * nw - 1) / (4 * nw));
  const int classes = f < g ? f : g;
  const float inv = 1.0f / (float)nw;
  for (int job = threadIdx.x; job < classes * nw; job += kThreads) {
    const int r = div_small(job, nw, inv);
    const int i = job - r * nw;
    uint8_t* d = dst0 + (long long)r * dstride;
    const int a = (int)((uintptr_t)d & 3);
    const int p0 = 4 * i - a;
    const int lo = max(0, -p0), hi = min(4, len - p0);
    if (lo >= hi) continue;
    int s[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) s[b] = b >= lo && b < hi ? src_of[p0 + b] : 0;
    uint8_t* w = d - a + 4 * i;
    const long long wstep = g * dstride;
    if (lo == 0 && hi == 4) {
#pragma unroll 4
      for (int j = r; j < f; j += g, w += wstep) {
        const uint8_t* st = planes + j * pstride + soff[j];
        *reinterpret_cast<uint32_t*>(w) = (uint32_t)st[s[0]] | ((uint32_t)st[s[1]] << 8) |
                                          ((uint32_t)st[s[2]] << 16) |
                                          ((uint32_t)st[s[3]] << 24);
      }
    } else {
      for (int j = r; j < f; j += g, w += wstep) {
        const uint8_t* st = planes + j * pstride + soff[j];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (b >= lo && b < hi) w[b] = st[s[b]];
        }
      }
    }
  }
}

// The four 4-byte column runs of one side of a tile, by the whole block:
// dst_of(c)[p] = stage_of(c)[src_of[p]] for p < len, U rows a thread at a
// time, every load of the U before the first store.
template <int U, class DstOf, class StageOf>
__device__ __forceinline__ void write_cols(DstOf dst_of, StageOf stage_of, int len,
                                           const uint16_t* src_of) {
  for (int p0 = threadIdx.x; p0 < len; p0 += kThreads * U) {
    uint32_t v[U][4];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * kThreads;
      if (p < len) {
        const int s = src_of[p];
#pragma unroll
        for (int c = 0; c < 4; ++c) v[u][c] = stage_of(c)[s];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + u * kThreads;
      if (p < len) {
#pragma unroll
        for (int c = 0; c < 4; ++c) dst_of(c)[p] = v[u][c];
      }
    }
  }
}

// dst[p] = src[p] for p < len, bytes, any two alignments, by one warp:
// aligned 4-byte stores, each word built from the two aligned source
// words that hold its bytes.  Each lane loads U words (and their
// neighbours) before it stores any, so that a warp keeps U * 32 loads in
// flight.  `src` must not change during the kernel (read-only loads).
// Reads up to 7 bytes before src and 7 after src + len.
template <int U>
__device__ __forceinline__ void copy_run_u8(uint8_t* dst, const uint8_t* src, int len, int lane) {
  if (len <= 0) return;
  const int a = (int)((uintptr_t)dst & 3);
  uint8_t* wb = dst - a;
  const uint8_t* sa = src - a;  // source of byte b of word i: sa + 4 i + b
  const int c = (int)((uintptr_t)sa & 3);
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(sa - c);
  const int nw = (a + len + 3) >> 2;
  for (int i0 = 0; i0 < nw; i0 += 32 * U) {
    uint32_t lo[U], hi[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 32 * u + lane;
      if (i < nw) {
        lo[u] = __ldg(sw + i);
        hi[u] = __ldg(sw + i + 1);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + 32 * u + lane;
      if (i >= nw) break;
      const uint32_t v = __funnelshift_r(lo[u], hi[u], 8 * c);
      const int p0 = 4 * i - a;
      if (p0 >= 0 && p0 + 4 <= len) {
        *reinterpret_cast<uint32_t*>(wb + 4 * i) = v;
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int p = p0 + b;
          if (p >= 0 && p < len) wb[4 * i + b] = (uint8_t)(v >> (8 * b));
        }
      }
    }
  }
}

// dst[p] = src[p] for p < len, 4-byte words, by one warp, U loads a lane
// in flight; `src` read-only during the kernel
template <int U>
__device__ __forceinline__ void copy_run_u32(uint32_t* dst, const uint32_t* src, int len,
                                             int lane) {
  for (int p0 = 0; p0 < len; p0 += 32 * U) {
    uint32_t v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + 32 * u + lane;
      if (p < len) v[u] = __ldg(src + p);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p = p0 + 32 * u + lane;
      if (p < len) dst[p] = v[u];
    }
  }
}

}  // namespace ptile
