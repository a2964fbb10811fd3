// Fused fp32 L2 ε-counts: distances and threshold, counts only.
//
// Replaces: eps_count_pallas (src/repro/kernels/eps_count.py:43, its
// pallas_call at :62), the TPU kernel behind the public kernel API's
// eps_count.
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
// What the design does about it: nng_tile.cu's kernel with no words
// stored, on the same l2_pipe.cuh core (persistent grid of 64 x 256 tiles,
// 16 x 8 register tiles, TMA-fed two-stage ring, row norms summed once),
// so each count equals nng_tile's cnt (all rows valid) bit for bit: per row
// of a tile, the popcounts of the warp's eight __ballot_sync words and one
// integer atomicAdd. The TPU kernel's sequential grid axis, which carried
// the counts from one y tile to the next, becomes the atomics. Ragged edges
// are masked here: columns past p never hit, so the reference wrapper's
// y_mask operand has no counterpart. The grid is 1-D and the tile index
// 64-bit, so any q takes one launch.
#include "l2_pipe.cuh"

namespace {

using namespace l2pipe;

template <bool TMA>
__global__ void __launch_bounds__(PTHREADS, 2)
eps_count_kernel(const __grid_constant__ Maps maps,
                 const float* __restrict__ x, const float* __restrict__ y,
                 int32_t* __restrict__ cnt, const float* __restrict__ xsq,
                 const float* __restrict__ ysq, int q, int p, int d,
                 float eps2) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  run<TMA>(maps, x, y, xsq, ysq, q, p, d,
           [&](int m0, int n0, const float (&acc)[TM][PTN],
               const float* xnorm, const float* ynorm) {
             float yn[PTN];
             bool yok[PTN];
#pragma unroll
             for (int j = 0; j < PTN; ++j) {
               yn[j] = ynorm[lane + 32 * j];
               yok[j] = n0 + lane + 32 * j < p;
             }
#pragma unroll
             for (int i = 0; i < TM; ++i) {
               const int row = m0 + warp * TM + i;
               const float xn = xnorm[warp * TM + i];
               int rc = 0;
#pragma unroll
               for (int j = 0; j < PTN; ++j)
                 rc += __popc(__ballot_sync(
                     FULL, yok[j] && l2tile::d2(xn, yn[j], acc[i][j]) <= eps2));
               if (lane == 0 && row < q && rc != 0) atomicAdd(&cnt[row], rc);
             }
           });
}

}  // namespace

// cnt (q,) must be zero on entry; xsq (q,) and ysq (p,) are 16-byte
// aligned fp32 scratch for the rows' norms (written here first). sms is
// the device's SM count (the persistent grid is the blocks resident on
// them at once). Launches on `stream` and returns a CUDA error code: the
// tensor maps', shared-memory opt-in's or occupancy query's, else
// cudaGetLastError() of the launches (0 on success).
extern "C" int eps_count_launch(const void* x, const void* y, void* cnt,
                                void* xsq, void* ysq, int q, int p, int d,
                                float eps2, int sms, void* stream) {
  const bool tma = tma_ok(x, y, d);
  const auto kernel = tma ? eps_count_kernel<true> : eps_count_kernel<false>;
  const auto st = static_cast<cudaStream_t>(stream);
  Maps maps{};
  int blocks = 0;
  const int e = prepare(kernel, tma, x, y, nullptr, xsq, ysq, q, p, d, sms,
                        st, maps, blocks);
  if (e != 0) return e;
  kernel<<<blocks, PTHREADS, SMEM_BYTES, st>>>(
      maps, static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<int32_t*>(cnt), static_cast<const float*>(xsq),
      static_cast<const float*>(ysq), q, p, d, eps2);
  return static_cast<int>(cudaGetLastError());
}
