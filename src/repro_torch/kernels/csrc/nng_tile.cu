// Fused fp32 L2 ε-tile: distances, threshold and bit-packed adjacency.
//
// Replaces: nng_tile_pallas (src/repro/kernels/nng_tile.py:126, its
// pallas_call at :139), the TPU kernel that the systolic ring runs twice
// per evaluated round.
//
// Computes, for x (q, d), y (p, d) fp32 and y_valid (p,) int32:
//   d2[i][j] = (|x_i|^2 + |y_j|^2) - 2 * <x_i, y_j>
//   hit      = d2 <= eps2 && y_valid[j] != 0 && j < p
//   bits[i][j / 32] bit (j % 32) = hit,   cnt[i] += popcount of row i's words.
//
// What bounds it on an H100: operations. A (q, p, d) tile does 2·q·p·d fp32
// flops but moves only (q + p)·d·4 bytes in and q·p/8 bytes of bits out, so
// at d = 128 it sits far above the card's flop/byte line. The arithmetic
// must be IEEE fp32 (no TF32, no tensor cores), so the ceiling is the CUDA
// cores' fp32 FMA rate, and what keeps a kernel from it is every issue
// slot and stall that is not an FMA: shared-memory loads (a broadcast
// load costs the SM's shared-memory pipe one cycle, a per-lane 16-byte
// load four), copies, barriers and the per-tile epilogue.
//
// What the design does about it: l2_pipe.cuh's core. A persistent grid of
// two 128-thread blocks an SM walks 64 x 256 tiles; a thread's 16 x 8
// register tile reads 16 broadcast and 8 per-lane float4s a 512 FMAs;
// TMA box copies (cp.async for misaligned rows) stream x and y through a
// two-stage ring, the next tile's first chunk loading during this tile's
// epilogue; the row norms are summed once before the tiles and arrive
// with each tile's first chunk, y_valid folded into them (NaN: never a
// hit). The per-pair arithmetic is l2_tile.cuh's, bit for bit. The
// epilogue keeps tile_io.cuh's layout: each warp's __ballot_sync packs a
// row's word, lane j keeps word j, and a row's eight words go out in one
// store with one atomicAdd of their popcounts to cnt. Out-of-range columns
// never hit.
#include "l2_pipe.cuh"

namespace {

using namespace l2pipe;

template <bool TMA>
__global__ void __launch_bounds__(PTHREADS, 2)
nng_tile_kernel(const __grid_constant__ Maps maps,
                const float* __restrict__ x, const float* __restrict__ y,
                int32_t* __restrict__ cnt, uint32_t* __restrict__ bits,
                const float* __restrict__ xsq, const float* __restrict__ ysq,
                int q, int p, int d, int nw, float eps2) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  run<TMA>(maps, x, y, xsq, ysq, q, p, d,
           [&](int m0, int n0, const float (&acc)[TM][PTN],
               const float* xnorm, const float* ynorm) {
             // a column with y_valid 0 has a NaN norm: it never hits
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
               // the row's PTN words, n0 / 32 onwards: lane j keeps word j
               uint32_t mine = 0u;
               int rc = 0;
#pragma unroll
               for (int j = 0; j < PTN; ++j) {
                 const unsigned word = __ballot_sync(
                     FULL, yok[j] && l2tile::d2(xn, yn[j], acc[i][j]) <= eps2);
                 if (lane == j) mine = word;
                 rc += __popc(word);
               }
               const int w = (n0 >> 5) + lane;
               if (lane < PTN && row < q && w < nw)
                 bits[(size_t)row * nw + w] = mine;
               if (lane == 0 && row < q && rc != 0) atomicAdd(&cnt[row], rc);
             }
           });
}

}  // namespace

// cnt (q,) must be zero on entry; bits is (q, nw) with nw = ceil(p / 32);
// xsq (q,) and ysq (p,) are 16-byte aligned fp32 scratch for the rows'
// norms (written here first). sms is the device's SM count (the persistent
// grid is the blocks resident on them at once). Launches on `stream` and
// returns a CUDA error code: the tensor maps', shared-memory opt-in's or
// occupancy query's, else cudaGetLastError() of the launches (0 on
// success).
extern "C" int nng_tile_launch(const void* x, const void* y,
                               const void* y_valid, void* cnt, void* bits,
                               void* xsq, void* ysq, int q, int p, int d,
                               float eps2, int sms, void* stream) {
  const bool tma = tma_ok(x, y, d);
  const auto kernel = tma ? nng_tile_kernel<true> : nng_tile_kernel<false>;
  const auto st = static_cast<cudaStream_t>(stream);
  Maps maps{};
  int blocks = 0;
  const int e = prepare(kernel, tma, x, y, y_valid, xsq, ysq, q, p, d, sms,
                        st, maps, blocks);
  if (e != 0) return e;
  kernel<<<blocks, PTHREADS, SMEM_BYTES, st>>>(
      maps, static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<int32_t*>(cnt),
      static_cast<uint32_t*>(bits), static_cast<const float*>(xsq),
      static_cast<const float*>(ysq), q, p, d, (p + 31) / 32, eps2);
  return static_cast<int>(cudaGetLastError());
}
