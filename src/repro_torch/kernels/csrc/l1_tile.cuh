// The fp32 L1 (Manhattan) distance tile shared by nng_tile_l1.cu and
// nng_tile_grouped_l1.cu.
//
// One 256-thread block owns a 128 x 128 tile (tile_io.cuh). x and y are
// staged through shared memory in chunks of 16 features, transposed (padded
// rows against bank conflicts); each thread keeps a 16 x 4 register tile of
// fp32 distances.
//
// The summation order is the reference's (_l1_tile_d, cchunk = 8) and the
// plain version's (nng_tile.l1_dist): within each chunk of 8 features a
// partial sum |x - y| left to right, then d += partial. The adds are spelled
// __fadd_rn / __fsub_rn so that order is stated, not left to the compiler
// (|.| folds into the add as an operand modifier). A thread sums the
// partials of 4 rows x 4 columns at a time, so the partials and the
// distances fit in registers together.
//
// The kernels get d from distances(), and l1_pipe.cuh's core (under
// tree_frontier_l1.cu and nng_tile_ghost_l1.cu) sums in the same order, so
// a pair's d is bit-identical in all of them, and a leaf's `d <= eps` in
// the tree frontier is the tile's own hit test. Ragged q, p and d are masked:
// out-of-range features load as 0 in both operands, and |0 - 0| adds
// exactly 0 to a partial.
#pragma once

#include "tile_io.cuh"

namespace l1tile {

using namespace tile;

constexpr int CHUNK = 8;           // features per partial sum (cchunk)
constexpr int BK = 2 * CHUNK;      // features staged per chunk
constexpr int TG = 4;              // rows per group of partial sums

static_assert(BM * BK % THREADS == 0, "staging loop covers the chunk");
static_assert(TM % TG == 0, "row groups cover the warp's rows");

struct Smem {
  __align__(16) float xt[BK][LDT];
  __align__(16) float yt[BK][LDT];
};

// acc[i][j] = L1 distance of x row m0 + 16 warp + i and y row
// n0 + lane + 32 j.
__device__ __forceinline__ void distances(const float* __restrict__ x,
                                          const float* __restrict__ y, int q,
                                          int p, int d, int m0, int n0,
                                          Smem& s, float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int e = tid + THREADS * i;
      const int r = e / BK;
      const int kk = e % BK;
      const int gk = k0 + kk;
      const int gm = m0 + r;
      const int gn = n0 + r;
      s.xt[kk][r] = (gm < q && gk < d) ? x[(size_t)gm * d + gk] : 0.f;
      s.yt[kk][r] = (gn < p && gk < d) ? y[(size_t)gn * d + gk] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int c0 = 0; c0 < BK; c0 += CHUNK) {
#pragma unroll
      for (int g = 0; g < TM; g += TG) {
        float part[TG][TN];
#pragma unroll
        for (int kk = 0; kk < CHUNK; ++kk) {
          float a[TG];
          float b[TN];
#pragma unroll
          for (int i = 0; i < TG; i += 4) {
            const float4 v = *reinterpret_cast<const float4*>(
                &s.xt[c0 + kk][warp * TM + g + i]);
            a[i] = v.x;
            a[i + 1] = v.y;
            a[i + 2] = v.z;
            a[i + 3] = v.w;
          }
#pragma unroll
          for (int j = 0; j < TN; ++j) b[j] = s.yt[c0 + kk][lane + 32 * j];
#pragma unroll
          for (int i = 0; i < TG; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j) {
              const float v = fabsf(__fsub_rn(a[i], b[j]));
              part[i][j] = kk == 0 ? v : __fadd_rn(part[i][j], v);
            }
        }
#pragma unroll
        for (int i = 0; i < TG; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j)
            acc[g + i][j] = __fadd_rn(acc[g + i][j], part[i][j]);
      }
    }
    __syncthreads();
  }
}

}  // namespace l1tile
