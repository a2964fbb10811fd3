// The fp32 L2 tile shared by nng_tile.cu and tree_frontier.cu.
//
// The block geometry and epilogues are tile_io.cuh's: one 256-thread block
// owns a 128 x 128 (query row x candidate column) tile. x and y are staged
// through shared memory in chunks of 16 features (transposed, padded rows
// against bank conflicts). Warp w owns rows [16w, 16w + 16) and lane l owns
// columns l, l + 32, l + 64, l + 96, so each thread keeps a 16 x 4 register
// tile of fp32 FMAs and reads its 16 x values as broadcast float4 loads.
// The row norms are summed in the same pass over the staged chunks.
//
// Both kernels get d2 from l2tile::d2 over the same products and norms, so
// a pair's d2 is bit-identical in the two, and a leaf's `d2 <= eps2` test in
// the tree frontier is the tile's own hit test. The arithmetic is IEEE fp32
// on the CUDA cores (no TF32, no tensor cores). Ragged q, p and d are masked:
// out-of-range features load as 0, which adds exactly 0 to every sum.
#pragma once

#include "tile_io.cuh"

namespace l2tile {

using namespace tile;

constexpr int BK = 16;             // features staged per chunk

static_assert(BM + BN == THREADS, "one thread sums each staged row's norm");
static_assert(BM * BK % THREADS == 0, "staging loop covers the chunk");

struct Smem {
  __align__(16) float xt[BK][LDT];
  __align__(16) float yt[BK][LDT];
  float xnorm[BM];
  float ynorm[BN];
};

// acc[i][j] = <x_row, y_col> for row m0 + 16 warp + i and column
// n0 + lane + 32 j; on return s.xnorm / s.ynorm hold the tile's squared row
// norms and every thread of the block has passed a barrier after writing
// them.
__device__ __forceinline__ void products(const float* __restrict__ x,
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
  // threads [0, BM) sum x row m0 + tid, threads [BM, 2 BM) y row n0 + tid - BM
  float norm = 0.f;

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

    {
      const float* col = tid < BM ? &s.xt[0][tid] : &s.yt[0][tid - BM];
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float v = col[kk * LDT];
        norm = fmaf(v, v, norm);
      }
    }

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(&s.xt[kk][warp * TM + i]);
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
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < BM) {
    s.xnorm[tid] = norm;
  } else {
    s.ynorm[tid - BM] = norm;
  }
  __syncthreads();
}

// the fp32 expansion (|x|^2 + |y|^2) - 2 <x, y>; 2 <x, y> is exact, so a
// contracted FMA gives the same value as the two separate operations
__device__ __forceinline__ float d2(float xn, float yn, float dot) {
  return (xn + yn) - 2.0f * dot;
}

}  // namespace l2tile
