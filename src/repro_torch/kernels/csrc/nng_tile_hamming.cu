// Fused Hamming ε-tile: XOR + popcount distances, integer threshold and
// bit-packed adjacency.
//
// Replaces: nng_tile_hamming_pallas (src/repro/kernels/nng_tile.py), the
// TPU kernel that the systolic ring runs for metric="hamming".
//
// Computes, for x (q, w), y (p, w) packed 32-bit words and y_valid (p,)
// int32:
//   d[i][j] = sum over words k of popcount(x_i[k] ^ y_j[k])      (exact)
//   hit     = d <= eps && y_valid[j] != 0 && j < p      (eps = int(eps))
//   bits[i][j / 32] bit (j % 32) = hit,   cnt[i] += popcount of row i's words.
//
// What bounds it on an H100: operations. A (q, p, w) tile does q·p·w
// population counts and moves only (q + p)·w·4 bytes in and q·p/8 bytes
// of bits out. The CUDA C++ Programming Guide's throughput table gives
// compute capability 9.0 16 32-bit population counts a clock per SM, a
// quarter of its integer add and logic rate, so the popcounts are the
// ceiling.
//
// What the simple design does about it: the 128 x 128 tile of
// hamming_tile.cuh (shared-memory staging of 8 words a chunk, a 16 x 4
// register tile per thread, one XOR, one popcount and one add per pair and
// word) and tile_io.cuh's epilogue (__ballot_sync words, one atomicAdd a
// row for the counts).
#include "hamming_tile.cuh"

namespace {

using namespace hamtile;

__global__ void __launch_bounds__(THREADS, 2)
nng_tile_hamming_kernel(const uint32_t* __restrict__ x,
                        const uint32_t* __restrict__ y,
                        const int32_t* __restrict__ y_valid,
                        int32_t* __restrict__ cnt,
                        uint32_t* __restrict__ bits, int q, int p, int w,
                        int nw, int eps) {
  __shared__ Smem s;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int acc[TM][TN];
  distances(x, y, q, p, w, m0, n0, s, acc);

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
extern "C" int nng_tile_hamming_launch(const void* x, const void* y,
                                       const void* y_valid, void* cnt,
                                       void* bits, int q, int p, int w,
                                       int eps, void* stream) {
  const int nw = (p + 31) / 32;
  const dim3 grid((p + BN - 1) / BN, (q + BM - 1) / BM);
  nng_tile_hamming_kernel<<<grid, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<const int32_t*>(y_valid), static_cast<int32_t*>(cnt),
      static_cast<uint32_t*>(bits), q, p, w, nw, eps);
  return static_cast<int>(cudaGetLastError());
}
