// Ghost Hamming ε-tile: the landmark engine's ghost-ring tile over packed
// 32-bit words.
//
// Replaces: nng_tile_ghost_hamming_pallas (src/repro/kernels/nng_tile.py),
// the TPU kernel that the landmark engine's ghost ring runs for
// metric="hamming".
//
// Computes, for x (q, w), y (p, w) packed 32-bit words, x ghost words gb
// (q, mw) and y cells yg (p,) int32:
//   d[i][j] = sum over words k of popcount(x_i[k] ^ y_j[k])      (exact)
//   hit     = d <= eps && yg[j] >= 0 && bit yg[j] of gb[i] is set
//                                                        (eps = int(eps))
//   bits[i][j / 32] bit (j % 32) = hit,   cnt[i] += popcount of row i's words.
//
// What bounds it on an H100: operations, w population counts for each pair
// the function needs (a row against a column of one of its ghost cells),
// as for nng_tile_hamming.cu. A live block counts all its pairs.
//
// What the simple design does about it: nng_tile_hamming.cu's block
// (hamming_tile.cuh's distances, tile_io.cuh's epilogue) behind tile_io.cuh's
// ghost prologue, which writes zero words for a block whose rows have no
// ghost bit in its y cell range and skips its distances; a live pair tests
// one bit of its row's words, read from device memory.
#include "hamming_tile.cuh"

namespace {

using namespace hamtile;

__global__ void __launch_bounds__(THREADS, 2)
nng_tile_ghost_hamming_kernel(const uint32_t* __restrict__ x,
                              const uint32_t* __restrict__ y,
                              const uint32_t* __restrict__ gb,
                              const int32_t* __restrict__ yg,
                              int32_t* __restrict__ cnt,
                              uint32_t* __restrict__ bits, int q, int p,
                              int w, int mw, int nw, int eps) {
  __shared__ Smem s;
  __shared__ Ghost g;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int w0 = n0 >> 5;

  if (!stage_ghost(gb, yg, q, p, mw, m0, n0, g)) {
    zero_words(q, nw, m0, w0, bits);
    return;
  }

  int acc[TM][TN];
  distances(x, y, q, p, w, m0, n0, s, acc);

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = warp * TM + i;
    const bool in = m0 + r < q;
    const uint32_t* xw = gb + (size_t)(m0 + r) * mw;
    bool hit[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      hit[j] = in && ghost_bit(g, xw, lane + 32 * j) && acc[i][j] <= eps;
    store_hits(hit, m0 + r, q, w0, nw, bits, cnt);
  }
}

}  // namespace

// cnt (q,) must be zero on entry; bits is (q, nw) with nw = ceil(p / 32),
// every word of which is stored. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int nng_tile_ghost_hamming_launch(const void* x, const void* y,
                                             const void* gb, const void* yg,
                                             void* cnt, void* bits, int q,
                                             int p, int w, int mw, int eps,
                                             void* stream) {
  const int nw = (p + 31) / 32;
  const dim3 grid((p + BN - 1) / BN, (q + BM - 1) / BM);
  nng_tile_ghost_hamming_kernel<<<grid, THREADS, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(y),
      static_cast<const uint32_t*>(gb), static_cast<const int32_t*>(yg),
      static_cast<int32_t*>(cnt), static_cast<uint32_t*>(bits), q, p, w, mw,
      nw, eps);
  return static_cast<int>(cudaGetLastError());
}
