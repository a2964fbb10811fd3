// Ghost fp32 L2 ε-tile: the landmark engine's ghost-ring tile.
//
// Replaces: nng_tile_ghost_pallas (src/repro/kernels/nng_tile.py), the TPU
// kernel that the landmark engine's ghost ring (ghost_mode="ring",
// Algorithms 5+6) runs for each visiting block against the local cells.
//
// Computes, for x (q, d), y (p, d) fp32, x ghost words gb (q, mw) (bit c of
// word c / 32: row i is a Lemma-1 ghost of cell c) and y cells yg (p,)
// int32:
//   d2[i][j] = (|x_i|^2 + |y_j|^2) - 2 * <x_i, y_j>
//   hit      = d2 <= eps2 && yg[j] >= 0 && bit yg[j] of gb[i] is set
//   bits[i][j / 32] bit (j % 32) = hit,   cnt[i] += popcount of row i's words.
// A row's own cell bit is never set, so no id test is needed.
//
// What bounds it on an H100: operations. A live 128 x 128 block does
// 2·128·128·d fp32 flops and moves (128 + 128)·d·4 bytes in; the masks out
// are q·p/8 bytes for the whole tile. The arithmetic is IEEE fp32 on the
// CUDA cores, so the ceiling is their fp32 FMA rate over the pairs the
// function needs: a row against a column of one of its ghost cells. A live
// block computes all its pairs, which may be many more than that; a skipped
// block costs its prologue and its zero words.
//
// What the simple design does about it: nng_tile.cu's block (l2_tile.cuh's
// products, tile_io.cuh's __ballot_sync epilogue) behind tile_io.cuh's
// ghost prologue. The TPU folds the bit lookup into a one-hot MXU product;
// here each live pair tests one bit of its row's words, read from device
// memory. Callers sort y by cell, so a block whose rows have no ghost bit
// in its y cell range writes zero words and skips the distance loop. The
// engine's tiles_scheduled / tiles_skipped counters come from
// ops.ghost_block_active at the reference's own tile geometry.
#include "l2_tile.cuh"

namespace {

using namespace l2tile;

__global__ void __launch_bounds__(THREADS, 2)
nng_tile_ghost_kernel(const float* __restrict__ x,
                      const float* __restrict__ y,
                      const uint32_t* __restrict__ gb,
                      const int32_t* __restrict__ yg,
                      int32_t* __restrict__ cnt,
                      uint32_t* __restrict__ bits, int q, int p, int d,
                      int mw, int nw, float eps2) {
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

  float acc[TM][TN];
  products(x, y, q, p, d, m0, n0, s, acc);

  float yn[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) yn[j] = s.ynorm[lane + 32 * j];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = warp * TM + i;
    const bool in = m0 + r < q;
    const uint32_t* xw = gb + (size_t)(m0 + r) * mw;
    const float xn = s.xnorm[r];
    bool hit[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      hit[j] = in && ghost_bit(g, xw, lane + 32 * j) &&
               l2tile::d2(xn, yn[j], acc[i][j]) <= eps2;
    store_hits(hit, m0 + r, q, w0, nw, bits, cnt);
  }
}

}  // namespace

// cnt (q,) must be zero on entry; bits is (q, nw) with nw = ceil(p / 32),
// every word of which is stored. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int nng_tile_ghost_launch(const void* x, const void* y,
                                     const void* gb, const void* yg,
                                     void* cnt, void* bits, int q, int p,
                                     int d, int mw, float eps2,
                                     void* stream) {
  const int nw = (p + 31) / 32;
  const dim3 grid((p + BN - 1) / BN, (q + BM - 1) / BM);
  nng_tile_ghost_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const uint32_t*>(gb), static_cast<const int32_t*>(yg),
      static_cast<int32_t*>(cnt), static_cast<uint32_t*>(bits), q, p, d, mw,
      nw, eps2);
  return static_cast<int>(cudaGetLastError());
}
