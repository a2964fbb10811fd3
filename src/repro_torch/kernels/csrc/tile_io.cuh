// Block geometry and the packed-bitmask epilogues shared by the distance
// tiles (hamming_tile.cuh, l1_tile.cuh), the fused ε-tile kernels on them
// and their grouped and ghost variants; the pipelined cores (l2_pipe.cuh)
// keep its warp layout and its constants.
//
// One 256-thread block owns a 128 x 128 (query row x candidate column)
// tile. Warp w owns rows [16w, 16w + 16) and lane l owns columns l, l + 32,
// l + 64, l + 96, so in an epilogue the 32 lanes of a warp hold 32
// consecutive columns of one row and __ballot_sync packs a bitmask word
// directly (column j is word j / 32, bit j % 32). Rows past q and columns
// past p still vote (every lane of the warp must), but their words are
// never stored.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile {

constexpr int BM = 128;            // query rows per block
constexpr int BN = 128;            // candidate columns per block
constexpr int THREADS = 256;       // 8 warps
constexpr int TM = BM / (THREADS / 32);   // 16 rows per warp
constexpr int TN = BN / 32;        // 4 columns per lane
constexpr int WPB = BN / 32;       // mask words per tile row
constexpr int LDT = BM + 4;        // padded row of a transposed staging tile
constexpr unsigned FULL = 0xffffffffu;

// The ε-tile epilogue of one row: lane l's hit flags for its TN columns
// become the row's WPB words (lane j stores word j), and lane 0 adds the
// row's hits to cnt[row]. Blocks run in no order, hence the atomicAdd (cnt
// starts at zero).
__device__ __forceinline__ void store_hits(const bool (&hit)[TN], int row,
                                           int q, int w0, int nw,
                                           uint32_t* __restrict__ bits,
                                           int32_t* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  int rc = 0;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const unsigned word = __ballot_sync(FULL, hit[j]);
    if (lane == j && row < q && w0 + j < nw)
      bits[(size_t)row * nw + w0 + j] = word;
    rc += __popc(word);
  }
  if (lane == 0 && row < q && rc != 0) atomicAdd(&cnt[row], rc);
}

// Zero the block's BM x WPB words of a (nq, nw) mask (rows past nq and
// words past nw are not stored).
__device__ __forceinline__ void zero_words(int nq, int nw, int m0, int w0,
                                           uint32_t* __restrict__ words) {
  for (int e = threadIdx.x; e < BM * WPB; e += THREADS) {
    const int row = m0 + e / WPB;
    const int w = w0 + e % WPB;
    if (row < nq && w < nw) words[(size_t)row * nw + w] = 0u;
  }
}

// The grouped tiles' block prologue (the landmark engine's cell-scoped
// tiles). Rows carry a group (a Voronoi cell; < 0 marks padding) and a
// global id. The block's BM x-row and BN y-row groups and ids go to shared
// memory (group -1 past q and p), and the valid groups of each side are
// reduced to a [min, max] range.
constexpr int GBIG = 1 << 30;      // the empty range's min

struct Groups {
  int32_t xg[BM];
  int32_t xid[BM];
  int32_t yg[BN];
  int32_t yid[BN];
  int32_t range[4];                // x min, x max, y min, y max
};

// Returns, to every thread, whether the two valid-group ranges intersect.
// Callers sort rows by group, so a block whose ranges are disjoint (cross
// cell, or all padding on a side) holds no same-group pair and skips its
// distances.
__device__ __forceinline__ bool stage_groups(const int32_t* __restrict__ xg,
                                             const int32_t* __restrict__ yg,
                                             const int32_t* __restrict__ xid,
                                             const int32_t* __restrict__ yid,
                                             int q, int p, int m0, int n0,
                                             Groups& g) {
  static_assert(BM + BN == THREADS, "one thread stages each row's group");
  const int t = threadIdx.x;
  if (t < 4) g.range[t] = (t & 1) ? -1 : GBIG;
  __syncthreads();
  const bool is_x = t < BM;
  const int r = is_x ? t : t - BM;
  const int row = (is_x ? m0 : n0) + r;
  const bool in = row < (is_x ? q : p);
  const int32_t grp = in ? (is_x ? xg : yg)[row] : -1;
  const int32_t id = in ? (is_x ? xid : yid)[row] : -1;
  if (is_x) {
    g.xg[r] = grp;
    g.xid[r] = id;
  } else {
    g.yg[r] = grp;
    g.yid[r] = id;
  }
  if (grp >= 0) {
    atomicMin(&g.range[is_x ? 0 : 2], grp);
    atomicMax(&g.range[is_x ? 1 : 3], grp);
  }
  __syncthreads();
  return g.range[0] <= g.range[3] && g.range[2] <= g.range[1];
}

// Whether x row r and y column c of a staged block may pair: the same
// valid group and different ids (a point is never its own neighbour, even
// where fp32 rounds d(x, x) past eps).
__device__ __forceinline__ bool same_group(const Groups& g, int r, int c) {
  return g.yg[c] >= 0 && g.xg[r] == g.yg[c] && g.xid[r] != g.yid[c];
}

// The ghost tiles' block prologue (the landmark engine's ghost ring). A
// visiting x row carries its Lemma-1 ghost cells as mw packed words (bit c
// of word c / 32 set: the row may pair with a y row of cell c); y rows
// carry their cell (< 0 marks padding). The block's BN y cells go to
// shared memory (-1 past p) and are reduced to a [min, max] range. The x
// rows' words stay in device memory: the skip test reads only the words
// that hold [min, max], and the epilogue one word a live pair.
struct Ghost {
  int32_t yg[BN];
  int32_t range[2];                // y min, y max
};

// Whether the block is live: some row of it has a ghost bit inside the
// y cells' [min, max] range (returned to every thread). Callers sort y by
// cell, so the range is tight; an all-padding side is dead.
__device__ __forceinline__ bool stage_ghost(const uint32_t* __restrict__ gb,
                                            const int32_t* __restrict__ yg,
                                            int q, int p, int mw, int m0,
                                            int n0, Ghost& g) {
  const int t = threadIdx.x;
  if (t < 2) g.range[t] = t ? -1 : GBIG;
  __syncthreads();
  if (t < BN) {
    const int col = n0 + t;
    const int32_t c = col < p ? yg[col] : -1;
    g.yg[t] = c;
    if (c >= 0) {
      atomicMin(&g.range[0], c);
      atomicMax(&g.range[1], c);
    }
  }
  __syncthreads();
  const int ymin = g.range[0];
  const int ymax = g.range[1];
  const int wlo = ymin >> 5;
  const int nwr = ymin > ymax ? 0 : (ymax >> 5) - wlo + 1;
  int any = 0;
  for (int e = t; e < BM * nwr; e += THREADS) {
    const int r = e / nwr;
    const int w = wlo + e % nwr;
    const uint32_t v = m0 + r < q ? gb[(size_t)(m0 + r) * mw + w] : 0u;
    const int lo = w == wlo ? (ymin & 31) : 0;
    const int hi = w == (ymax >> 5) ? (ymax & 31) : 31;
    any |= (v & (FULL << lo) & (FULL >> (31 - hi))) != 0u;
  }
  return __syncthreads_or(any);
}

// Whether a row with ghost words xw may pair with y column c of a staged
// block: c's cell is valid and its bit is set in xw.
__device__ __forceinline__ bool ghost_bit(const Ghost& g,
                                          const uint32_t* xw, int c) {
  const int32_t cell = g.yg[c];
  return cell >= 0 && ((xw[cell >> 5] >> (cell & 31)) & 1u);
}

}  // namespace tile
