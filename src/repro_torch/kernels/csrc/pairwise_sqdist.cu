// Dense pairwise squared L2 distances, fp32.
//
// Replaces: pairwise_sqdist_pallas (src/repro/kernels/pairwise_l2.py, its
// pallas_call at :69), the TPU kernel behind the public kernel API's
// pairwise_sqdist.
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
// What the design does about it: l2_pipe.cuh's core, as nng_tile.cu's (a
// persistent grid of two 128-thread blocks an SM over 64 x 256 tiles, 16 x 8
// register tiles, TMA copies into a two-stage ring, the row norms summed
// once by row_norms_kernel), so each element is l2tile::d2 over the same
// product and norm chains as l2_chain.cu's anchor, bit for bit, and the
// one that nng_tile.cu tests against eps2. The epilogue stores straight from the
// registers: lane l writes columns n0 + l + 32 j, so each store of a warp
// is one coalesced 128-byte run of a row; a 64 x 256 staging tile (64 KiB)
// would not fit beside two blocks' rings on an SM. The stores of one
// block's epilogue overlap the other block's products. Output offsets are
// 64-bit (q·p may pass 2^31), and the 1-D grid takes any q in one launch.
#include "l2_pipe.cuh"

namespace {

using namespace l2pipe;

template <bool TMA>
__global__ void __launch_bounds__(PTHREADS, 2)
pairwise_sqdist_kernel(const __grid_constant__ Maps maps,
                       const float* __restrict__ x,
                       const float* __restrict__ y, float* __restrict__ out,
                       const float* __restrict__ xsq,
                       const float* __restrict__ ysq, int q, int p, int d) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  run<TMA>(maps, x, y, xsq, ysq, q, p, d,
           [&](int m0, int n0, const float (&acc)[TM][PTN],
               const float* xnorm, const float* ynorm) {
             float yn[PTN];
#pragma unroll
             for (int j = 0; j < PTN; ++j) yn[j] = ynorm[lane + 32 * j];
#pragma unroll
             for (int i = 0; i < TM; ++i) {
               const int row = m0 + warp * TM + i;
               if (row >= q) break;
               const float xn = xnorm[warp * TM + i];
               float* orow = out + (size_t)row * p;
#pragma unroll
               for (int j = 0; j < PTN; ++j) {
                 const int col = n0 + lane + 32 * j;
                 if (col < p)
                   orow[col] = fmaxf(l2tile::d2(xn, yn[j], acc[i][j]), 0.f);
               }
             }
           });
}

}  // namespace

// out is (q, p) fp32; every element is stored. xsq (q,) and ysq (p,) are
// 16-byte aligned fp32 scratch for the rows' norms (written here first);
// sms is the device's SM count (the persistent grid is the blocks resident
// on them at once). Launches on `stream` and returns a CUDA error code: the
// tensor maps', shared-memory opt-in's or occupancy query's, else
// cudaGetLastError() of the launches (0 on success).
extern "C" int pairwise_sqdist_launch(const void* x, const void* y,
                                      void* out, void* xsq, void* ysq, int q,
                                      int p, int d, int sms, void* stream) {
  const bool tma = tma_ok(x, y, d);
  const auto kernel =
      tma ? pairwise_sqdist_kernel<true> : pairwise_sqdist_kernel<false>;
  const auto st = static_cast<cudaStream_t>(stream);
  Maps maps{};
  int blocks = 0;
  const int e = prepare(kernel, tma, x, y, nullptr, xsq, ysq, q, p, d, sms,
                        st, maps, blocks);
  if (e != 0) return e;
  kernel<<<blocks, PTHREADS, SMEM_BYTES, st>>>(
      maps, static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<float*>(out), static_cast<const float*>(xsq),
      static_cast<const float*>(ysq), q, p, d);
  return static_cast<int>(cudaGetLastError());
}
