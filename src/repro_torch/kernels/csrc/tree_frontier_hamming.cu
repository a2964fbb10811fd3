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
//   d     = Hamming distance (exact)
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
// bytes outweigh the active pairs' popcounts, so the bound is bytes. What a
// launch costs beyond that is the dead tiles' reads and writes and the
// pairs of the live tiles it computes.
//
// What the design does about it: tree_frontier_l1.cu's design with a
// Hamming body. frontier_pipe.cuh's plan pass reads the active words in
// whole rows, lists the live 64 x 256 tiles on the card (no host sync) and
// writes the dead tiles' zero words; the persistent walk of l2_pipe.cuh
// (queries in their forest's DFS order, so about 1% of a level's tiles are
// live) sums each live pair's popcounts with hamming_pipe.cuh's body, whose
// int32 count is exact at any w; the shared epilogue applies the integer
// rules above. At the word2bits shape (w = 25, 100-byte rows) the copies
// are 4-byte cp.async ones, not TMA: the walk is a small part of a launch.
#include "frontier_pipe.cuh"

// emit and expand are (nq, nw) with nw = ceil(n / 32); every word is
// written (dead tiles' by the plan). tiles and ntiles are as
// tree_frontier_launch's; w is the words a row and eps the integer
// threshold; sms is the device's SM count. Launches on `stream` and
// returns a CUDA error code: the memset's, the tensor maps', shared-memory
// opt-in's or occupancy query's, else cudaGetLastError() of the launches
// (0 on success).
extern "C" int tree_frontier_hamming_launch(const void* q, const void* c,
                                            const void* rad,
                                            const void* leaf,
                                            const void* act, void* tiles,
                                            void* ntiles, void* emit,
                                            void* expand, int nq, int n,
                                            int w, int eps, int sms,
                                            void* stream) {
  return fpipe::frontier_launch<fpipe::Metric::Hamming>(
      q, c, rad, leaf, act, tiles, ntiles, emit, expand, nullptr, nullptr, nq,
      n, w, fpipe::Thr{0.f, 0.f, eps}, sms,
      static_cast<cudaStream_t>(stream));
}
