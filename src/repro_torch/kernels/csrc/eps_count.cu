// Fused fp32 L2 ε-counts: distances and threshold, counts only.
//
// Replaces: eps_count_pallas (src/repro/kernels/eps_count.py), the TPU
// kernel behind the public kernel API's eps_count.
//
// Computes, for x (q, d) and y (p, d) fp32:
//   d2[i][j] = (|x_i|^2 + |y_j|^2) - 2 * <x_i, y_j>
//   cnt[i]   = |{ j < p : d2[i][j] <= eps2 }|                      (q,) int32
// The (q, p) tile never reaches device memory.
//
// What bounds it on an H100: operations. The product is 2·q·p·d fp32 flops
// against (q + p)·d·4 bytes in and q·4 bytes out; the arithmetic must be
// IEEE fp32, so the ceiling is the CUDA cores' fp32 FMA rate.
//
// What the simple design does about it: nng_tile.cu's tile with no words
// stored: l2_tile.cuh's products and d2, so each count equals nng_tile's
// cnt (all rows valid) bit for bit, and tile_io.cuh's count_hits: one
// __ballot_sync popcount a warp, row and column slot, and one integer
// atomicAdd a row and block. The TPU kernel's sequential grid axis, which
// carried the counts from one y tile to the next, becomes the atomics.
// Ragged edges are masked here: columns past p never hit, so the reference
// wrapper's y_mask operand has no counterpart.
#include "l2_tile.cuh"

namespace {

using namespace l2tile;

__global__ void __launch_bounds__(THREADS, 2)
eps_count_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 int32_t* __restrict__ cnt, int q, int p, int d,
                 float eps2) {
  __shared__ Smem s;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
  products(x, y, q, p, d, m0, n0, s, acc);

  float yn[TN];
  bool yok[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    yn[j] = s.ynorm[lane + 32 * j];
    yok[j] = n0 + lane + 32 * j < p;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float xn = s.xnorm[warp * TM + i];
    bool hit[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      hit[j] = yok[j] && l2tile::d2(xn, yn[j], acc[i][j]) <= eps2;
    count_hits(hit, m0 + warp * TM + i, q, cnt);
  }
}

}  // namespace

// cnt (q,) must be zero on entry. q <= 65535 * 128 (the grid's y limit:
// the wrapper launches taller inputs in row chunks). Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int eps_count_launch(const void* x, const void* y, void* cnt,
                                int q, int p, int d, float eps2,
                                void* stream) {
  const dim3 grid((p + BN - 1) / BN, (q + BM - 1) / BM);
  eps_count_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<int32_t*>(cnt), q, p, d, eps2);
  return static_cast<int>(cudaGetLastError());
}
