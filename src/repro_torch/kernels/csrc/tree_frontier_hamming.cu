// One level of the batched cover-tree traversal under Hamming distance:
// XOR + popcount distances, the integer emit / expand decisions and their
// packed bitmasks.
//
// Replaces: tree_frontier_hamming_pallas (src/repro/kernels/
// tree_frontier.py), the TPU kernel that device.tree_traverse runs on every
// level of every traversal for metric="hamming".
//
// Computes, for queries q (nq, w), level nodes c (n, w) packed 32-bit
// words, radii rad (n,) fp32, leaf flags leaf (n,) int32 and the packed
// active mask act (nq, nw) uint32, nw = ceil(n / 32):
//   d     = Hamming distance (hamming_tile.cuh, exact)
//   r     = (int) rad_j                    (truncated, as the reference)
//   leaf node:     emit   = active && d <= eps,        expand = 0
//   internal node: emit   = active && d + r <= eps
//                  expand = active && !emit && d <= r + eps
// with eps = int(eps). Integer distances need no slack: every decision is
// exact at every level.
//
// What bounds it on an H100: the function needs the distances of its active
// pairs only (w popcounts a pair) and must read q, c and the active words
// and write two words per 32 pairs; on the traversal's sparse masks the
// bytes outweigh the active pairs' popcounts, so the bound is bytes. The
// kernel computes every pair of a 128 x 128 block that has one active pair.
//
// What the simple design does about it: tile_io.cuh's prologue stages the
// block's active words and a block with none writes zero words and leaves
// (__syncthreads_or); otherwise the Hamming tile of nng_tile_hamming.cu
// (hamming_tile.cuh), so a leaf's test is the tile's own, and tile_io.cuh's
// __ballot_sync epilogue. Ragged nq and n are masked: out-of-range nodes are
// never active.
#include "hamming_tile.cuh"

namespace {

using namespace hamtile;

__global__ void __launch_bounds__(THREADS, 2)
tree_frontier_hamming_kernel(const uint32_t* __restrict__ q,
                             const uint32_t* __restrict__ c,
                             const float* __restrict__ rad,
                             const int32_t* __restrict__ leaf,
                             const uint32_t* __restrict__ act,
                             uint32_t* __restrict__ emit,
                             uint32_t* __restrict__ expand, int nq, int n,
                             int w, int nw, int eps) {
  __shared__ Smem s;
  __shared__ uint32_t sact[BM][WPB];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int w0 = n0 >> 5;

  if (!stage_active(act, nq, nw, m0, w0, sact)) {
    zero_masks(nq, nw, m0, w0, emit, expand);
    return;
  }
  int acc[TM][TN];
  distances(q, c, nq, n, w, m0, n0, s, acc);

  int r[TN];
  bool ok[TN];
  bool lf[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = n0 + lane + 32 * j;
    ok[j] = col < n;
    r[j] = ok[j] ? static_cast<int>(rad[col]) : 0;
    lf[j] = ok[j] && leaf[col] != 0;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    bool e_bit[TN];
    bool x_bit[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const bool a = ok[j] && active_bit(sact, warp * TM + i, j);
      const int dist = acc[i][j];
      x_bit[j] = false;
      if (lf[j]) {
        e_bit[j] = a && dist <= eps;
      } else {
        e_bit[j] = a && dist + r[j] <= eps;
        x_bit[j] = a && !e_bit[j] && dist <= r[j] + eps;
      }
    }
    store_masks(e_bit, x_bit, m0 + warp * TM + i, nq, w0, nw, emit, expand);
  }
}

}  // namespace

// emit and expand are (nq, nw) with nw = ceil(n / 32); every word is
// written. Launches on `stream` and returns cudaGetLastError().
extern "C" int tree_frontier_hamming_launch(const void* q, const void* c,
                                            const void* rad,
                                            const void* leaf,
                                            const void* act, void* emit,
                                            void* expand, int nq, int n,
                                            int w, int eps, void* stream) {
  const int nw = (n + 31) / 32;
  const dim3 grid((n + BN - 1) / BN, (nq + BM - 1) / BM);
  tree_frontier_hamming_kernel<<<grid, THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(q), static_cast<const uint32_t*>(c),
      static_cast<const float*>(rad), static_cast<const int32_t*>(leaf),
      static_cast<const uint32_t*>(act), static_cast<uint32_t*>(emit),
      static_cast<uint32_t*>(expand), nq, n, w, nw, eps);
  return static_cast<int>(cudaGetLastError());
}
