// One level of the batched cover-tree traversal: fp32 L2 distances, the
// emit / expand decisions and their packed bitmasks.
//
// Replaces: tree_frontier_pallas (src/repro/kernels/tree_frontier.py), the
// TPU kernel that device.tree_traverse runs on every level of every
// traversal.
//
// Computes, for queries q (nq, d), level nodes c (n, d) fp32, radii rad (n,)
// fp32, leaf flags leaf (n,) int32 and the packed active mask act
// (nq, nw) uint32, nw = ceil(n / 32) (node j is word j / 32, bit j % 32):
//   d2    = (|q_i|^2 + |c_j|^2) - 2 <q_i, c_j>      (l2_tile.cuh's d2)
//   d     = sqrt(max(d2, 0))
//   slack = ((d + rad_j) + eps) * 1e-5 + 1e-6
//   leaf node:     emit   = active && d2 <= eps2,     expand = 0
//   internal node: emit   = active && d + rad_j <= eps - slack
//                  expand = active && !emit && d <= (rad_j + eps) + slack
// Each operation rounds to fp32 in the order written, as the plain version
// does (no contraction into FMAs, correctly rounded sqrt: no fast math).
//
// What bounds it on an H100: the function needs the distances of its active
// pairs only (2 flops per feature and pair) and must read q, c and the
// active words and write two words per 32 pairs; on the traversal's sparse
// masks those bytes outweigh the active pairs' flops, so the bound is bytes.
// What a launch costs beyond that is the pairs of the tiles it computes: a
// tile with one active pair computes all of its distances.
//
// What the design does about it. The engine hands each block's queries in
// its own forest's DFS order (device.dfs_row_order), so the rows of a tile
// share subtrees and reach few of a level's node tiles. frontier_pipe.cuh:
// a plan pass over the active words lists the 64 x 256 tiles with a
// nonzero word on the card (no host sync) and writes zero words for the
// others; l2_pipe.cuh's core (persistent grid, TMA-fed two-stage ring,
// 16 x 8 register tiles, row norms summed once by a pre-pass) walks the
// live tiles only, and the epilogue applies the rules above on the core's
// fragments. A pair's d2 is the core's, so a leaf's test is nng_tile.cu's
// own, bit for bit.
#include "frontier_pipe.cuh"

// emit and expand are (nq, nw) with nw = ceil(n / 32); every word is
// written (dead tiles' by the plan). tiles is int32 scratch for the list of
// 64 x 256 tile indices (room for ceil(nq / 64) * ceil(n / 256)) and ntiles
// for its count (one int32); qsq (nq,) and csq (n,) are 16-byte aligned fp32
// scratch for the rows' norms. sms is the device's SM count. Launches on
// `stream` and returns a CUDA error code: the memset's, the tensor maps',
// shared-memory opt-in's or occupancy query's, else cudaGetLastError() of
// the launches (0 on success).
extern "C" int tree_frontier_launch(const void* q, const void* c,
                                    const void* rad, const void* leaf,
                                    const void* act, void* tiles,
                                    void* ntiles, void* emit, void* expand,
                                    void* qsq, void* csq, int nq, int n,
                                    int d, float eps, float eps2, int sms,
                                    void* stream) {
  return fpipe::frontier_launch<fpipe::Metric::L2>(
      q, c, rad, leaf, act, tiles, ntiles, emit, expand, qsq, csq, nq, n, d,
      fpipe::Thr{eps, eps2, 0}, sms, static_cast<cudaStream_t>(stream));
}
