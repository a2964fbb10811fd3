// One level of the batched cover-tree traversal under L1 (Manhattan)
// distance: fp32 distances, the emit / expand decisions and their packed
// bitmasks.
//
// Replaces: tree_frontier_l1_pallas (src/repro/kernels/tree_frontier.py),
// the TPU kernel that device.tree_traverse runs on every level of every
// traversal for metric="manhattan".
//
// Computes, for queries q (nq, d), level nodes c (n, d) fp32, radii rad (n,)
// fp32, leaf flags leaf (n,) int32 and the packed active mask act
// (nq, nw) uint32, nw = ceil(n / 32):
//   d     = L1 distance in l1_tile.cuh's order (chunks of 8)
//   slack = ((d + rad_j) + eps) * 1e-5 + 1e-6
//   leaf node:     emit   = active && d <= eps,       expand = 0
//   internal node: emit   = active && d + rad_j <= eps - slack
//                  expand = active && !emit && d <= (rad_j + eps) + slack
// Each operation rounds to fp32 in the order written, as the plain version
// does (no contraction into FMAs: __fadd_rn / __fmul_rn).
//
// What bounds it on an H100: the function needs the distances of its active
// pairs only (2 fp32 instructions per feature and pair) and must read q, c
// and the active words and write two words per 32 pairs; on the
// traversal's sparse masks those bytes outweigh the active pairs'
// instructions, so the bound is bytes. What a launch costs beyond that is
// the pairs of the tiles it computes.
//
// What the design does about it: tree_frontier.cu's design
// (frontier_pipe.cuh: queries in their forest's DFS order, a plan pass that
// lists the live 64 x 256 tiles on the card and zeroes the dead ones' words,
// a persistent walk over the live tiles, the same epilogue with the leaf
// test d <= eps) on l1_pipe.cuh's core: l2_pipe.cuh's walk and staging with
// an L1 body in l1_tile.cuh's summation order, so a leaf's d is
// nng_tile_l1's bit for bit.
#include "frontier_pipe.cuh"

// emit and expand are (nq, nw) with nw = ceil(n / 32); every word is
// written. tiles and ntiles are as tree_frontier_launch's; sms is the
// device's SM count. Launches on `stream` and returns a CUDA error code:
// the memset's, the tensor maps', shared-memory opt-in's or occupancy
// query's, else cudaGetLastError() of the launches (0 on success).
extern "C" int tree_frontier_l1_launch(const void* q, const void* c,
                                       const void* rad, const void* leaf,
                                       const void* act, void* tiles,
                                       void* ntiles, void* emit,
                                       void* expand, int nq, int n, int d,
                                       float eps, int sms, void* stream) {
  return fpipe::frontier_launch<false>(q, c, rad, leaf, act, tiles, ntiles,
                                       emit, expand, nullptr, nullptr, nq, n,
                                       d, eps, 0.f, sms,
                                       static_cast<cudaStream_t>(stream));
}
