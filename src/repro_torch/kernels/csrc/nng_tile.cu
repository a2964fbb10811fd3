// Fused fp32 L2 ε-tile: distances, threshold and bit-packed adjacency.
//
// Replaces: nng_tile_pallas (src/repro/kernels/nng_tile.py), the TPU kernel
// that the systolic ring runs twice per evaluated round.
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
// cores' fp32 FMA rate.
//
// What the simple design does about it: the shared 128 x 128 fp32 tile of
// l2_tile.cuh (shared-memory staging, a 16 x 4 register tile per thread,
// row norms summed in the same pass), and tile_io.cuh's epilogue: each
// warp's __ballot_sync packs a word, and one atomicAdd a row adds the
// block's hits to cnt. Out-of-range columns never hit.
#include "l2_tile.cuh"

namespace {

using namespace l2tile;

__global__ void __launch_bounds__(THREADS, 2)
nng_tile_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const int32_t* __restrict__ y_valid,
                int32_t* __restrict__ cnt, uint32_t* __restrict__ bits,
                int q, int p, int d, int nw, float eps2) {
  __shared__ Smem s;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
  products(x, y, q, p, d, m0, n0, s, acc);

  float yn[TN];
  bool yok[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = n0 + lane + 32 * j;
    yn[j] = s.ynorm[lane + 32 * j];
    yok[j] = col < p && y_valid[col] != 0;
  }
  const int w0 = n0 >> 5;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float xn = s.xnorm[warp * TM + i];
    bool hit[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      hit[j] = yok[j] && l2tile::d2(xn, yn[j], acc[i][j]) <= eps2;
    store_hits(hit, m0 + warp * TM + i, q, w0, nw, bits, cnt);
  }
}

}  // namespace

// cnt (q,) must be zero on entry; bits is (q, nw) with nw = ceil(p / 32).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int nng_tile_launch(const void* x, const void* y,
                               const void* y_valid, void* cnt, void* bits,
                               int q, int p, int d, float eps2,
                               void* stream) {
  const int nw = (p + 31) / 32;
  const dim3 grid((p + BN - 1) / BN, (q + BM - 1) / BM);
  nng_tile_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const int32_t*>(y_valid), static_cast<int32_t*>(cnt),
      static_cast<uint32_t*>(bits), q, p, d, nw, eps2);
  return static_cast<int>(cudaGetLastError());
}
