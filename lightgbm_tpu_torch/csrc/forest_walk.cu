// Batch inference: every row walks every tree of the forest in bin space.
//
// Replaces the TPU kernel _walk_kernel
// (lightgbm_tpu/ops/pallas/forest_walk.py:261, launched through
// pl.pallas_call at forest_walk.py:418 by _forest_walk_jit; entry
// forest_walk :367).  Same function: numeric splits in bin space, a row goes
// left when its bin is <= the node's threshold bin, or when it sits in the
// feature's NaN bin and the node sends missing values left; the leaf values
// of tree t are summed into class t % k, trees in order.  (Categorical nodes
// are not part of this port yet.)
//
// Node encoding (the port's own, built by ops/forest_walk.build_tables):
//   node[t, i]  i32 = thr | feat << 9 | default_left << 18 | (nan_bin+1) << 19
//   child[t, i] i32 = left & 0xFFFF | right << 16, each an i16 that is a
//                     node index when >= 0 and ~leaf when < 0
//   leaf[t, j]  f32 leaf value
//
// What bounds it on an H100: the bytes of the bin matrix (n * f, read once)
// against the scores (n * k * 4, written once) make it memory bound on
// paper; in practice each level of each tree is a dependent table lookup
// plus a bin load, so it is latency bound.  Design: one row per thread, all
// of a chunk of trees' tables (8 bytes per node, 4 per leaf) staged in shared
// memory by the block, so a level costs two shared loads and one cached byte
// load of the row's own bins (a row's f bytes share one or two 32-byte
// sectors).  Per-class sums stay in registers and are written once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxClass = 8;
constexpr int kSharedBytes = 48 * 1024;

__global__ void forest_walk_kernel(const uint8_t* __restrict__ bins,
                                   const int* __restrict__ node,
                                   const int* __restrict__ child,
                                   const float* __restrict__ leaf,
                                   long long n, int f, int n_trees,
                                   int m_nodes, int m_leaves, int k,
                                   int trees_per_chunk,
                                   float* __restrict__ out) {
  extern __shared__ int smem[];
  int* s_node = smem;
  int* s_child = s_node + trees_per_chunk * m_nodes;
  float* s_leaf = reinterpret_cast<float*>(s_child + trees_per_chunk * m_nodes);

  const long long row = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = row < n;
  const uint8_t* rb = bins + (live ? row : 0) * f;
  float acc[kMaxClass];
#pragma unroll
  for (int c = 0; c < kMaxClass; ++c) acc[c] = 0.0f;

  for (int t0 = 0; t0 < n_trees; t0 += trees_per_chunk) {
    const int tc = min(trees_per_chunk, n_trees - t0);
    __syncthreads();
    for (int i = threadIdx.x; i < tc * m_nodes; i += blockDim.x) {
      s_node[i] = node[(long long)t0 * m_nodes + i];
      s_child[i] = child[(long long)t0 * m_nodes + i];
    }
    for (int i = threadIdx.x; i < tc * m_leaves; i += blockDim.x) {
      s_leaf[i] = leaf[(long long)t0 * m_leaves + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < tc; ++tt) {
      const int* nd = s_node + tt * m_nodes;
      const int* ch = s_child + tt * m_nodes;
      int cur = 0;
      // a valid tree reaches a leaf in at most m_nodes steps; the bound
      // keeps a malformed table from spinning
      for (int step = 0; cur >= 0 && step <= m_nodes; ++step) {
        const int p = nd[cur];
        const int thr = p & 0x1FF;
        const int feat = (p >> 9) & 0x1FF;
        const int dl = (p >> 18) & 1;
        const int nb = ((p >> 19) & 0x1FF) - 1;
        const int v = rb[feat];
        const bool gl = (v <= thr) || (dl && nb >= 0 && v == nb);
        const int c = ch[cur];
        cur = gl ? (int)(int16_t)(c & 0xFFFF) : (int)(int16_t)(c >> 16);
      }
      const int t = t0 + tt;
      const float val = cur < 0 ? s_leaf[tt * m_leaves + ~cur] : 0.0f;
      // class t % k; a loop instead of a dynamic index keeps acc in registers
#pragma unroll
      for (int c = 0; c < kMaxClass; ++c) {
        if (c == t % k) acc[c] = acc[c] + val;
      }
    }
  }
  if (live) {
    for (int c = 0; c < k; ++c) out[row * k + c] = acc[c];
  }
}

}  // namespace

// bins [n, f] u8 row-major; node/child [n_trees, m_nodes] i32; leaf
// [n_trees, m_leaves] f32 -> out [n, k] f32.  Returns cudaGetLastError().
extern "C" int lgbt_forest_walk(const void* bins, const void* node,
                                const void* child, const void* leaf,
                                long long n, int f, int n_trees, int m_nodes,
                                int m_leaves, int k, void* out, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (k < 1 || k > kMaxClass || n_trees < 1) return (int)cudaErrorInvalidValue;
  const int per_tree = m_nodes * 8 + m_leaves * 4;
  int tpc = kSharedBytes / per_tree;
  if (tpc < 1) return (int)cudaErrorInvalidValue;
  if (tpc > n_trees) tpc = n_trees;
  const size_t shared = (size_t)tpc * per_tree;
  const long long blocks = (n + kThreads - 1) / kThreads;
  forest_walk_kernel<<<(unsigned)blocks, kThreads, shared,
                       (cudaStream_t)stream>>>(
      (const uint8_t*)bins, (const int*)node, (const int*)child,
      (const float*)leaf, n, f, n_trees, m_nodes, m_leaves, k, tpc,
      (float*)out);
  return (int)cudaGetLastError();
}
