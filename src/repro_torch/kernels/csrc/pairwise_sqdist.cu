// Dense pairwise squared L2 distances, fp32.
//
// Replaces: pairwise_sqdist_pallas (src/repro/kernels/pairwise_l2.py), the
// TPU kernel behind the public kernel API's pairwise_sqdist.
//
// Computes, for x (q, d) and y (p, d) fp32:
//   out[i][j] = max((|x_i|^2 + |y_j|^2) - 2 * <x_i, y_j>, 0)       (q, p) fp32
//
// What bounds it on an H100: operations. The product is 2·q·p·d fp32 flops
// against (q + p)·d·4 bytes in and q·p·4 bytes out, so at d = 128 the flops
// take about three times as long as the output's bytes at the card's rates.
// The arithmetic must be IEEE fp32 (no TF32, no tensor cores), so the
// ceiling is the CUDA cores' fp32 FMA rate.
//
// What the simple design does about it: the 128 x 128 fp32 tile of
// l2_tile.cuh (shared-memory staging, a 16 x 4 register tile per thread,
// the row norms summed in the same pass), so a pair's d2 is the one that
// nng_tile.cu tests against eps2. The epilogue stores each of a warp's 16
// rows as four 128-byte runs: lane l writes columns n0 + l + 32 j, so the 32
// lanes of a store cover 32 consecutive floats. The TPU kernel's 512-feature
// grid steps are not carried over: the features run in staged chunks of 16
// inside the block. Output offsets are 64-bit (q·p may pass 2^31).
#include "l2_tile.cuh"

namespace {

using namespace l2tile;

__global__ void __launch_bounds__(THREADS, 2)
pairwise_sqdist_kernel(const float* __restrict__ x,
                       const float* __restrict__ y, float* __restrict__ out,
                       int q, int p, int d) {
  __shared__ Smem s;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
  products(x, y, q, p, d, m0, n0, s, acc);

  float yn[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) yn[j] = s.ynorm[lane + 32 * j];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + warp * TM + i;
    if (row >= q) break;
    const float xn = s.xnorm[warp * TM + i];
    float* orow = out + (size_t)row * p;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + lane + 32 * j;
      if (col < p) orow[col] = fmaxf(l2tile::d2(xn, yn[j], acc[i][j]), 0.f);
    }
  }
}

}  // namespace

// out is (q, p) fp32; every element is stored. q <= 65535 * 128 (the grid's
// y limit: the wrapper launches taller inputs in row chunks). Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int pairwise_sqdist_launch(const void* x, const void* y,
                                      void* out, int q, int p, int d,
                                      void* stream) {
  const dim3 grid((p + BN - 1) / BN, (q + BM - 1) / BM);
  pairwise_sqdist_kernel<<<grid, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), q, p, d);
  return static_cast<int>(cudaGetLastError());
}
