// The Hamming distance tile shared by nng_tile_hamming.cu,
// nng_tile_grouped_hamming.cu, nng_tile_ghost_hamming.cu and
// pairwise_hamming.cu.
//
// Points are rows of w packed 32-bit words. One 256-thread block owns a
// 128 x 128 tile (tile_io.cuh). The x and y word rows are staged through
// shared memory in chunks of 8 words, transposed (padded rows against bank
// conflicts); each thread keeps a 16 x 4 register tile of int32 distances
// and adds __popc(x ^ y) for each staged word, reading its 16 x words as
// broadcast uint4 loads.
//
// The distances are exact integers, so the kernels' tests are exact (and
// hamming_pipe.cuh's body under the tree frontier gives the same integers,
// so a leaf's `d <= eps` there is the tile's own hit test). Ragged
// q, p and w are masked: out-of-range words load as 0 in both operands, and
// popcount(0 ^ 0) adds 0; the loop over a chunk's words stops at w.
#pragma once

#include "tile_io.cuh"

namespace hamtile {

using namespace tile;

constexpr int BK = 8;              // words staged per chunk

static_assert(BM * BK % THREADS == 0, "staging loop covers the chunk");

struct Smem {
  __align__(16) uint32_t xt[BK][LDT];
  __align__(16) uint32_t yt[BK][LDT];
};

// acc[i][j] = Hamming distance of x row m0 + 16 warp + i and y row
// n0 + lane + 32 j (0 for rows out of range).
__device__ __forceinline__ void distances(const uint32_t* __restrict__ x,
                                          const uint32_t* __restrict__ y,
                                          int q, int p, int w, int m0, int n0,
                                          Smem& s, int (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < w; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int e = tid + THREADS * i;
      const int r = e / BK;
      const int kk = e % BK;
      const int gk = k0 + kk;
      const int gm = m0 + r;
      const int gn = n0 + r;
      s.xt[kk][r] = (gm < q && gk < w) ? x[(size_t)gm * w + gk] : 0u;
      s.yt[kk][r] = (gn < p && gk < w) ? y[(size_t)gn * w + gk] : 0u;
    }
    __syncthreads();

    const int kn = min(BK, w - k0);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      if (kk < kn) {
        uint32_t a[TM];
        uint32_t b[TN];
#pragma unroll
        for (int i = 0; i < TM; i += 4) {
          const uint4 v =
              *reinterpret_cast<const uint4*>(&s.xt[kk][warp * TM + i]);
          a[i] = v.x;
          a[i + 1] = v.y;
          a[i + 2] = v.z;
          a[i + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = s.yt[kk][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] += __popc(a[i] ^ b[j]);
      }
    }
    __syncthreads();
  }
}

}  // namespace hamtile
