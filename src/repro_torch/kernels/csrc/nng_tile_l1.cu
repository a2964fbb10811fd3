// Fused fp32 L1 (Manhattan) ε-tile: distances, threshold and bit-packed
// adjacency.
//
// Replaces: nng_tile_l1_pallas (src/repro/kernels/nng_tile.py), the TPU
// kernel that the systolic ring runs for metric="manhattan".
//
// Computes, for x (q, d), y (p, d) fp32 and y_valid (p,) int32:
//   d[i][j] = sum of |x_i - y_j| in l1_tile.cuh's order (chunks of 8)
//   hit     = d <= eps && y_valid[j] != 0 && j < p      (eps rounded to fp32)
//   bits[i][j / 32] bit (j % 32) = hit,   cnt[i] += popcount of row i's words.
//
// What bounds it on an H100: operations. A (q, p, d) tile does 2·q·p·d fp32
// instructions (a subtract, and an add that takes |.| as an operand
// modifier) but moves only (q + p)·d·4 bytes in and q·p/8 bytes of bits
// out. L1 has no product form for the tensor cores, and neither
// instruction is an FMA, so the ceiling is the CUDA cores' fp32 issue rate:
// half the data sheet's 67 TFLOP/s, which counts an FMA as two.
//
// What the simple design does about it: the 128 x 128 fp32 tile of
// l1_tile.cuh (shared-memory staging of 16 features a chunk, a 16 x 4
// register tile per thread, partial sums 8 rows at a time) and
// tile_io.cuh's epilogue (__ballot_sync words, one atomicAdd a row).
#include "l1_tile.cuh"

namespace {

using namespace l1tile;

__global__ void __launch_bounds__(THREADS, 2)
nng_tile_l1_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const int32_t* __restrict__ y_valid,
                   int32_t* __restrict__ cnt, uint32_t* __restrict__ bits,
                   int q, int p, int d, int nw, float eps) {
  __shared__ Smem s;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
  distances(x, y, q, p, d, m0, n0, s, acc);

  bool yok[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = n0 + lane + 32 * j;
    yok[j] = col < p && y_valid[col] != 0;
  }
  const int w0 = n0 >> 5;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    bool hit[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) hit[j] = yok[j] && acc[i][j] <= eps;
    store_hits(hit, m0 + warp * TM + i, q, w0, nw, bits, cnt);
  }
}

}  // namespace

// cnt (q,) must be zero on entry; bits is (q, nw) with nw = ceil(p / 32).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int nng_tile_l1_launch(const void* x, const void* y,
                                  const void* y_valid, void* cnt, void* bits,
                                  int q, int p, int d, float eps,
                                  void* stream) {
  const int nw = (p + 31) / 32;
  const dim3 grid((p + BN - 1) / BN, (q + BM - 1) / BM);
  nng_tile_l1_kernel<<<grid, THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const int32_t*>(y_valid), static_cast<int32_t*>(cnt),
      static_cast<uint32_t*>(bits), q, p, d, nw, eps);
  return static_cast<int>(cudaGetLastError());
}
