// Batch inference: every row walks every tree of the forest in bin space.
//
// Replaces the TPU kernel _walk_kernel
// (lightgbm_tpu/ops/pallas/forest_walk.py:261, launched through
// pl.pallas_call at forest_walk.py:418 by _forest_walk_jit; entry
// forest_walk :367).  Same function: numeric splits in bin space, a row goes
// left when its bin is <= the node's threshold bin, or when it sits in the
// feature's NaN bin and the node sends missing values left; the leaf values
// of tree t are added in f32 into class t % k, trees in order.  A
// categorical node (the TPU kernel's cat_gl mode, forest_walk.py:318-346)
// sends a row left when the bit of its bin is set in the node's 256-bit
// bitset.
//
// The rows' bins, as a block stages them in shared memory for a tile: W =
// ceil(f / 4) words a row (word q holds bins 4q .. 4q + 3), then W_A more
// (the "NaN-left" words: word W + a is word q_a with every byte that sits
// in its feature's NaN bin set to 0, for the words that hold a feature with
// a NaN bin, listed by build_tables in nan_words as (q_a, the four NaN bins,
// a 0xFF mask of the bytes that have one)).  A node that sends missing
// values left reads the NaN-left word, where a NaN row's 0 is <= any
// threshold; every other node reads the row's own bins.  So a node's whole
// rule is v <= thr.
//
// Tables (the port's own encoding, built by ops/forest_walk.build_tables):
// one block of tree_bytes = 8 * M + 4 * Lm bytes a tree (M even, Lm a
// multiple of 4, so every tree starts 16-byte aligned):
//   node record i (8 bytes at 8 * i, one load):
//     x = 0x54 | (0x06 | (feat & 3) << 4) << 8 | w << 16 | thr << 24
//         w the staged word the node reads; the low 16 bits are the byte
//         permute selector that puts byte (feat & 3) of that word in place
//         of x's top byte, thr: the permuted word is <= x (unsigned) iff
//         v <= thr.  Byte 0 is 0x54 in every numeric node.
//     a categorical node: x = kCatMarker | ((feat & 3) | (o & 0x3F) << 2) << 8
//         | w << 16 | (o >> 6) << 24, o its bitset's byte offset in the
//         tree's block over 4 (w the row's own word: a category mask never
//         holds the NaN bin, so a NaN row goes right with no extra test)
//     y = left | right << 16, each the u16 byte offset of the child in the
//         tree's block: 8 * i for node i, 8 * M + 4 * j for leaf j (so a
//         child at or past 8 * M is a leaf, and its offset is where its
//         value sits)
//   leaf value j (f32) at byte 8 * M + 4 * j
//   then the bitsets of the tree's categorical nodes, 32 bytes each (bit
//   v & 31 of word v >> 5 for bin v), staged with the rest of the block
//
// Categorical nodes (on the TPU every tree with one gathers all 8 bitset
// words of each node and picks one by v >> 5): a level loads the row's
// word as at a numeric node, then, where byte 0 of the record is the
// marker, picks the feature's byte v, loads word v >> 5 of the node's
// bitset (one 4-byte shared load) and tests bit v & 31.  The marker test
// is compiled in only for forests that have a categorical node (kCat, a
// flag of the launch, not of each tree), so a numeric forest runs the
// instructions it ran before.
//
// What bounds it on an H100: on paper the bytes of the bins (n * f, read
// once) and of the scores; in practice the levels walked, each a dependent
// table lookup, a byte pick and a compare: 8.6 levels a (row, tree) on the
// Higgs model, and the instructions a level issues (about 16 here) before
// shared-memory bank conflicts or HBM.  The earlier design (a thread a row,
// all rows of a warp stepping one tree in lockstep, two 4-byte shared loads
// and a scattered global byte load a level, every block staging the tables
// for its 256 rows) ran at 47x the bytes bound.
// This design:
//   * a level is one 8-byte shared load of the node, one 4-byte shared load
//     of the staged word (laid out [word][row slot], so the 32 lanes of a
//     warp read 32 consecutive words whatever word each wants: no bank
//     conflict), one byte permute and one compare; the chosen child's
//     offset is the next node, or past the nodes its leaf's value;
//   * each row keeps its own cursor (tree, node) through a chunk of trees:
//     a row that reaches a leaf adds its value and starts its next tree at
//     once, so a warp runs about the largest per-row sum of depths, not the
//     sum over trees of the deepest row; a row done with the chunk parks on
//     a sink record that routes to itself and adds nothing;
//   * two rows a thread, walked side by side, so one row's dependent loads
//     overlap the other's;
//   * where the rows are too few to give every multiprocessor its warps (a
//     4,096-row batch), the block's threads form groups on the same tile of
//     rows: group g walks the chunk's trees g, g + groups, ... and keeps each
//     leaf value in a stash [tree][row], then group 0 adds every row's
//     stashed values in tree order;
//   * a persistent grid (about one wave of blocks, each looping over row
//     tiles): a block stages a chunk of trees once by 16-byte cp.async and
//     walks all its tiles through it before the next chunk, so the tables
//     are read once a block, not once a 256 rows; a chunk holds as many
//     trees as the block's shared memory (above 48 KB where needed) allows.
// Each row's sums live in registers within a chunk and in `out` between
// chunks, and one thread adds a row's values one by one in tree order in
// f32: the same bits as the plain walker.  No float is added atomically,
// and no partial sums of a row's trees are ever added.
//
// The class mode (k > 1 trees an iteration, tree t of class t % k; the TPU
// kernel pads k to a multiple of 8 and adds every tree into a [kpad] row,
// forest_walk.py:406): a row keeps one register accumulator a class.  Past
// 8 classes the classes split into blocks of at most 8, a grid dimension
// (blockIdx.y): block y walks only the trees of its classes c0 = 8y ..
// c0 + kb - 1, its local tree j being tree (j / kb) * k + c0 + j % kb, and
// writes only their columns of `out`.  So no tree is walked twice, the
// accumulators stay 8 wide, and each class still adds its trees in tree
// order.  At k <= 8 there is one block of classes and local tree j is tree j.
//
// The launch plan (threads a block, trees a chunk, groups) is
// ops/forest_walk.walk_plan, a function of the shapes; the grid is the
// blocks the card holds at once (shared among the class blocks), at most
// one a tile.

#include <cuda_runtime.h>
#include <stdint.h>

// rows a thread walks side by side, and steps between two checks of the
// loop (builds with -DFW_ROWS=... / -DFW_UNROLL=... measure other counts)
#ifndef FW_ROWS
#define FW_ROWS 2
#endif
#ifndef FW_UNROLL
#define FW_UNROLL 2
#endif

namespace {

constexpr int kMaxClass = 8;
constexpr int kRows = FW_ROWS;
constexpr int kMaxThreads = 512;  // threads a block, at most
constexpr int kSinkBytes = 16;    // the sink record after a chunk's tables
constexpr int kMaxF = 512;        // staged words, with the NaN-left ones, fit a byte
constexpr uint32_t kCatMarker = 0x01u;  // byte 0 of a categorical node's record

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// the PTX byte permute: byte n of the result is byte (s >> 4n) & 7 of
// {b, a} (a's bytes 0-3, b's 4-7)
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(s));
  return d;
}

// the aligned word at addr, 0 past the last byte of the bins (a word that
// holds no byte of the bins is never read)
__device__ __forceinline__ uint32_t word_at(uintptr_t addr, uintptr_t last) {
  return addr <= last ? __ldg(reinterpret_cast<const uint32_t*>(addr)) : 0u;
}

// word q (bytes 4q .. 4q + 3) of a row's bins, from the aligned words
// around it; bytes past the row's f are never picked by the walk
struct RowReader {
  uintptr_t a;     // aligned address of the row's first byte
  uint32_t s;      // the row's misalignment, in bits
  uintptr_t last;  // address of the last byte of the bins
  __device__ __forceinline__ uint32_t word(int q) const {
    const uintptr_t p = a + 4 * (uintptr_t)q;
    return __funnelshift_r(word_at(p, last), s ? word_at(p + 4, last) : 0u, s);
  }
};

// two blocks of kMaxThreads a multiprocessor: at most 64 registers a thread.
// kSplit: the block's threads form `groups` groups of the same tile's rows;
// group g walks trees g, g + groups, ... of the chunk and keeps each leaf
// value in a stash [tree][row slot], and group 0 then adds a row's stashed
// values in tree order (a tile of few rows still fills the block).
template <bool kOneClass, bool kSplit, bool kCat>
__global__ void __launch_bounds__(kMaxThreads, 2)
forest_walk_kernel(const uint8_t* __restrict__ bins, const unsigned char* __restrict__ tables,
                   const int3* __restrict__ nan_words, long long n, int f, int n_nan_words,
                   int n_trees, int tree_bytes, int leaf_off, int k, int chunk_trees, int groups,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int group_threads = kSplit ? blockDim.x / groups : blockDim.x;
  const int group = kSplit ? threadIdx.x / group_threads : 0;
  const int lane = kSplit ? threadIdx.x % group_threads : threadIdx.x;
  const int tile_rows = group_threads * kRows;
  const int words = (f + 3) >> 2;
  const int bins_off = chunk_trees * tree_bytes + kSinkBytes;  // the staged words
  uint32_t* s_bins = reinterpret_cast<uint32_t*>(smem + bins_off);
  float* s_stash = reinterpret_cast<float*>(s_bins + (words + n_nan_words) * tile_rows);
  const int word_stride = tile_rows * 4;  // bytes from one staged word of a row to its next
  const long long tiles = (n + tile_rows - 1) / tile_rows;
  const uintptr_t last = (uintptr_t)bins + (uintptr_t)(n * f) - 1;
  constexpr int kAcc = kOneClass ? 1 : kMaxClass;
  // this block's classes c0 .. c0 + kb - 1 and its trees (the class mode)
  const int c0 = (int)blockIdx.y * kMaxClass;
  const int kb = min(kMaxClass, k - c0);
  const int rem = n_trees % k;
  const int local_trees = n_trees / k * kb + min(max(rem - c0, 0), kb);

  for (int t0 = 0; t0 < local_trees; t0 += chunk_trees) {
    const int tc = min(chunk_trees, local_trees - t0);
    const int end = tc * tree_bytes;  // the sink record's offset
    __syncthreads();                  // every row is done with the last chunk
    if (kb == k) {                    // one block of classes: trees t0 .. t0 + tc - 1
      const unsigned char* src = tables + (long long)t0 * tree_bytes;
      for (int i = threadIdx.x * 16; i < end; i += blockDim.x * 16) cp_async16(smem + i, src + i);
    } else {  // local tree j is tree (j / kb) * k + c0 + j % kb
      for (int i = threadIdx.x * 16; i < end; i += blockDim.x * 16) {
        const int j = t0 + i / tree_bytes;
        const long long t = (long long)(j / kb) * k + c0 + j % kb;
        cp_async16(smem + i, tables + t * tree_bytes + i % tree_bytes);
      }
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (threadIdx.x == 0) *reinterpret_cast<uint2*>(smem + end) = make_uint2(0u, 0u);
    __syncthreads();

    for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      // byte offsets in shared memory of each row's node record, tree and
      // staged word 0 (word w at w * word_stride past it)
      int node[kRows], base[kRows], words0[kRows], cls[kRows], tt[kRows];
      long long row[kRows];
      float acc[kRows][kAcc];
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        const int slot = lane + j * group_threads;
        row[j] = tile * tile_rows + slot;
        const bool live = row[j] < n && group < tc;
        tt[j] = group;  // the row's tree in the chunk
        base[j] = live ? group * tree_bytes : end;
        node[j] = base[j];
        cls[j] = t0 % kb;
        words0[j] = bins_off + 4 * slot;
#pragma unroll
        for (int c = 0; c < kAcc; ++c) {
          acc[j][c] = (row[j] < n && t0 > 0 && c < kb) ? out[row[j] * k + c0 + c] : 0.0f;
        }
        if (group == 0) {  // the rows' words, once a tile
          const uintptr_t p = (uintptr_t)bins + (uintptr_t)((row[j] < n ? row[j] : 0) * f);
          const RowReader rd{p & ~(uintptr_t)3, (uint32_t)(p & 3) * 8, last};
          for (int q = 0; q < words; ++q) s_bins[q * tile_rows + slot] = rd.word(q);
          for (int a = 0; a < n_nan_words; ++a) {
            const int3 nw = nan_words[a];  // (word, its features' NaN bins, mask)
            const uint32_t wv = s_bins[nw.x * tile_rows + slot];
            s_bins[(words + a) * tile_rows + slot] = wv & ~(__vcmpeq4(wv, nw.y) & nw.z);
          }
        }
      }
      if (kSplit) __syncthreads();  // the other groups read group 0's words

      // a valid chunk parks every row within tc * (nodes + 1) steps; the
      // bound keeps a malformed table from spinning.  FW_UNROLL steps a
      // check: a parked row's extra steps stay on the sink.
      const int limit = tc * (tree_bytes / 8 + 1);
      for (int step = 0; step < limit; step += FW_UNROLL) {
        bool more = false;
#pragma unroll
        for (int j = 0; j < kRows; ++j) more |= base[j] < end;
        if (!more) break;
#pragma unroll
        for (int u = 0; u < FW_UNROLL; ++u) {
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const uint2 nd = *reinterpret_cast<const uint2*>(smem + node[j]);
            const uint32_t wv = *reinterpret_cast<const uint32_t*>(
                smem + words0[j] + (int)prmt(nd.x, 0u, 0x4442u) * word_stride);
            bool gl;
            if (kCat && (nd.x & 0xFFu) == kCatMarker) {
              // the feature's byte of the word, and its bit in the bitset
              const uint32_t v = prmt(wv, 0u, 0x4440u | ((nd.x >> 8) & 3u));
              const uint32_t o = ((nd.x >> 10) & 0x3Fu) | ((nd.x >> 24) << 6);
              const uint32_t bits = *reinterpret_cast<const uint32_t*>(
                  smem + base[j] + 4 * (int)o + 4 * (int)(v >> 5));
              gl = (bits >> (v & 31u)) & 1u;
            } else {
              gl = prmt(wv, nd.x, nd.x) <= nd.x;
            }
            // the chosen child's byte offset in the tree (the u16, zero-extended)
            const int c = (int)prmt(nd.y, 0u, gl ? 0x4410u : 0x4432u);
            if (c >= leaf_off) {  // a leaf: add its value, start the next tree
              const float val = *reinterpret_cast<const float*>(smem + base[j] + c);
              if (kSplit) {  // keep it for group 0's sum; the group's next tree
                s_stash[tt[j] * tile_rows + lane + j * group_threads] = val;
                tt[j] += groups;
                base[j] = min(base[j] + groups * tree_bytes, end);
                node[j] = base[j];
                continue;
              }
              if (kOneClass) {
                acc[j][0] = acc[j][0] + val;
              } else {
#pragma unroll
                for (int cc = 0; cc < kAcc; ++cc) {
                  if (cc == cls[j]) acc[j][cc] = acc[j][cc] + val;
                }
                cls[j] = cls[j] + 1 == kb ? 0 : cls[j] + 1;
              }
              base[j] += tree_bytes;
              node[j] = base[j];
            } else {
              node[j] = base[j] + c;
            }
          }
        }
      }

      if (kSplit) {  // group 0 adds each row's stashed values in tree order
        __syncthreads();
        if (group == 0) {
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            for (int u = 0; u < tc; ++u) {
              const float val = s_stash[u * tile_rows + lane + j * group_threads];
              if (kOneClass) {
                acc[j][0] = acc[j][0] + val;
              } else {
#pragma unroll
                for (int cc = 0; cc < kAcc; ++cc) {
                  if (cc == cls[j]) acc[j][cc] = acc[j][cc] + val;
                }
                cls[j] = cls[j] + 1 == kb ? 0 : cls[j] + 1;
              }
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kRows; ++j) {
        if (row[j] >= n || group != 0) continue;
#pragma unroll
        for (int c = 0; c < kAcc; ++c) {
          if (c < kb) out[row[j] * k + c0 + c] = acc[j][c];
        }
      }
      if (kSplit) __syncthreads();  // the tile's words and stash are read
    }
  }
}

// the kernel of a mode, allowed `shared` bytes of dynamic shared memory
// (0 and the error in *err on failure).  The attribute is set on every
// launch that needs more than 48 KB: it holds for the current device only,
// and the call is cheap beside a launch.
template <bool kOneClass, bool kSplit, bool kCat>
const void* kernel_for(size_t shared, cudaError_t* err) {
  const void* kernel = (const void*)forest_walk_kernel<kOneClass, kSplit, kCat>;
  if (shared > 48 * 1024) {
    *err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (*err == cudaSuccess) {
      *err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                  (int)cudaSharedmemCarveoutMaxShared);
    }
    if (*err != cudaSuccess) return nullptr;
  }
  return kernel;
}

// blocks of the launch a class block: one a tile, at most the blocks the
// card holds at once shared among the `class_blocks`
long long grid_blocks(const void* kernel, long long n, int tile_rows, size_t shared,
                      int threads, int class_blocks, cudaError_t* err) {
  int resident = 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, threads, shared);
  if (*err != cudaSuccess) return 0;
  if (resident < 1) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  int dev = 0, sms = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess) *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err != cudaSuccess) return 0;
  const long long tiles = (n + tile_rows - 1) / tile_rows;
  const long long wave = ((long long)resident * (sms > 0 ? sms : 1) + class_blocks - 1) /
                        class_blocks;
  return tiles < wave ? tiles : wave;
}

struct Walk {
  long long n;
  int f, n_nan_words, n_trees, m_nodes, m_leaves, k, threads, chunk_trees, groups, cat;

  int tree_bytes() const { return 8 * m_nodes + 4 * m_leaves; }
  int class_blocks() const { return (k + kMaxClass - 1) / kMaxClass; }
  int tile_rows() const { return threads / groups * kRows; }
  size_t shared() const {
    return (size_t)chunk_trees * tree_bytes() + kSinkBytes +
           (size_t)tile_rows() * ((f + 3) / 4 + n_nan_words) * 4 +
           (groups > 1 ? (size_t)chunk_trees * tile_rows() * 4 : 0);
  }
  bool valid() const {
    return k >= 1 && class_blocks() <= 65535 && n_trees >= 1 && f >= 1 && f <= kMaxF &&
           n_nan_words >= 0 && n_nan_words <= (f + 3) / 4 && m_nodes >= 1 && m_nodes % 2 == 0 &&
           m_leaves >= 1 && m_leaves % 4 == 0 && threads >= 32 && threads <= kMaxThreads &&
           threads % 32 == 0 && chunk_trees >= 1 && groups >= 1 && threads % groups == 0;
  }
  template <bool kCat>
  const void* mode(cudaError_t* err) const {
    const size_t s = shared();
    if (groups > 1) {
      return k == 1 ? kernel_for<true, true, kCat>(s, err) : kernel_for<false, true, kCat>(s, err);
    }
    return k == 1 ? kernel_for<true, false, kCat>(s, err) : kernel_for<false, false, kCat>(s, err);
  }
  const void* kernel(cudaError_t* err) const {
    return cat ? mode<true>(err) : mode<false>(err);
  }
};

}  // namespace

// bins [n, f] u8 row-major; tables [n_trees, 8 * m_nodes + 4 * m_leaves]
// bytes and nan_words [n_nan_words] int3 (build_tables) -> out [n, k] f32;
// m_leaves counts the words after the node records, the leaf values and
// the categorical nodes' bitsets.  threads, chunk_trees and groups are the
// launch plan (walk_plan); cat != 0: the tables hold categorical nodes.
// Returns cudaGetLastError().
extern "C" int lgbt_forest_walk(const void* bins, const void* tables, const void* nan_words,
                                long long n, int f, int n_nan_words, int n_trees, int m_nodes,
                                int m_leaves, int k, int threads, int chunk_trees, int groups,
                                void* out, void* stream, int cat) {
  const Walk w{n, f, n_nan_words, n_trees, m_nodes, m_leaves, k, threads, chunk_trees, groups,
               cat != 0};
  if (n <= 0) return (int)cudaGetLastError();
  if (!w.valid()) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  const void* kernel = w.kernel(&e);
  if (e != cudaSuccess) return (int)e;
  const long long grid =
      grid_blocks(kernel, n, w.tile_rows(), w.shared(), threads, w.class_blocks(), &e);
  if (e != cudaSuccess) return (int)e;
  int tree_bytes = w.tree_bytes(), leaf_off = 8 * m_nodes;
  void* args[] = {(void*)&bins,         (void*)&tables,      (void*)&nan_words,
                  (void*)&n,            (void*)&f,           (void*)&n_nan_words,
                  (void*)&n_trees,      (void*)&tree_bytes,  (void*)&leaf_off,
                  (void*)&k,            (void*)&chunk_trees, (void*)&groups,
                  (void*)&out};
  e = cudaLaunchKernel(kernel, dim3((unsigned)grid, (unsigned)w.class_blocks()), dim3(threads),
                       args, w.shared(),
                       (cudaStream_t)stream);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}
