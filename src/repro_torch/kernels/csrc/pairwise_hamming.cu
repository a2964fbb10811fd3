// Dense pairwise Hamming distances over packed 32-bit words.
//
// Replaces: pairwise_hamming_pallas (src/repro/kernels/pairwise_hamming.py),
// the TPU kernel behind the public kernel API's pairwise_hamming.
//
// Computes, for x (q, w) and y (p, w) packed words:
//   out[i][j] = sum over words k of popcount(x_i[k] ^ y_j[k])   (q, p) int32
// exactly, on every input.
//
// What bounds it on an H100: operations. A (q, p, w) call does q·p·w
// population counts against (q + p)·w·4 bytes in and q·p·4 bytes out; the
// CUDA C++ Programming Guide's throughput table gives compute capability
// 9.0 16 32-bit population counts a clock per SM, so at w = 25 the
// popcounts take about five times as long as the output's bytes.
//
// What the simple design does about it: the 128 x 128 tile of
// hamming_tile.cuh (shared-memory staging of 8 words a chunk, a 16 x 4
// register tile per thread, one XOR, one popcount and one add per pair and
// word), the same distances nng_tile_hamming.cu thresholds. The epilogue
// stores each of a warp's rows as four 128-byte runs (lane l writes columns
// n0 + l + 32 j). The TPU kernel's (TQ, TP, TW) XOR cube in VMEM has no
// counterpart: each thread keeps its sums in registers. Output offsets are
// 64-bit: q·p passes 2^31 at full-width shapes.
#include "hamming_tile.cuh"

namespace {

using namespace hamtile;

__global__ void __launch_bounds__(THREADS, 2)
pairwise_hamming_kernel(const uint32_t* __restrict__ x,
                        const uint32_t* __restrict__ y,
                        int32_t* __restrict__ out, int q, int p, int w) {
  __shared__ Smem s;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  int acc[TM][TN];
  distances(x, y, q, p, w, m0, n0, s, acc);

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + warp * TM + i;
    if (row >= q) break;
    int32_t* orow = out + (size_t)row * p;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + lane + 32 * j;
      if (col < p) orow[col] = acc[i][j];
    }
  }
}

}  // namespace

// out is (q, p) int32; every element is stored. q <= 65535 * 128 (the
// grid's y limit: the wrapper launches taller inputs in row chunks).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int pairwise_hamming_launch(const void* x, const void* y,
                                       void* out, int q, int p, int w,
                                       void* stream) {
  const dim3 grid((p + BN - 1) / BN, (q + BM - 1) / BM);
  pairwise_hamming_kernel<<<grid, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<int32_t*>(out), q, p, w);
  return static_cast<int>(cudaGetLastError());
}
