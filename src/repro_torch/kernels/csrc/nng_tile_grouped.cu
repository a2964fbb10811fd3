// Grouped fp32 L2 ε-tile: the landmark engine's cell-scoped tile.
//
// Replaces: nng_tile_grouped_pallas (src/repro/kernels/nng_tile.py), the
// TPU kernel that the landmark engine (Algorithms 5+6) runs for the
// intra-cell W x W and ghost G x W queries.
//
// Computes, for x (q, d), y (p, d) fp32, groups xg (q,), yg (p,) and global
// ids xid (q,), yid (p,), all int32:
//   d2[i][j] = (|x_i|^2 + |y_j|^2) - 2 * <x_i, y_j>
//   hit      = d2 <= eps2 && xg[i] == yg[j] >= 0 && xid[i] != yid[j]
//   bits[i][j / 32] bit (j % 32) = hit,   cnt[i] += popcount of row i's words.
//
// What bounds it on an H100: operations. A live 128 x 128 block does
// 2·128·128·d fp32 flops and moves (128 + 128)·d·4 bytes in; the masks out
// are q·p/8 bytes for the whole tile. The arithmetic must be IEEE fp32 (no
// TF32, no tensor cores), so the ceiling is the CUDA cores' fp32 FMA rate
// over the live blocks' pairs. A skipped block costs its prologue and its
// zero words.
//
// What the simple design does about it: nng_tile.cu's block (l2_tile.cuh's
// products, tile_io.cuh's __ballot_sync epilogue) behind tile_io.cuh's
// grouped prologue. Callers sort rows by cell, so most blocks are cross
// cell or padding: their group ranges are disjoint, and they write zero
// words and skip the distance loop. Which blocks run is an internal matter:
// the engine's tiles_scheduled / tiles_skipped counters come from
// ops.grouped_block_active at the reference's own tile geometry.
#include "l2_tile.cuh"

namespace {

using namespace l2tile;

__global__ void __launch_bounds__(THREADS, 2)
nng_tile_grouped_kernel(const float* __restrict__ x,
                        const float* __restrict__ y,
                        const int32_t* __restrict__ xg,
                        const int32_t* __restrict__ yg,
                        const int32_t* __restrict__ xid,
                        const int32_t* __restrict__ yid,
                        int32_t* __restrict__ cnt,
                        uint32_t* __restrict__ bits, int q, int p, int d,
                        int nw, float eps2) {
  __shared__ Smem s;
  __shared__ Groups g;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int w0 = n0 >> 5;

  if (!stage_groups(xg, yg, xid, yid, q, p, m0, n0, g)) {
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
    const float xn = s.xnorm[r];
    bool hit[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      hit[j] = same_group(g, r, lane + 32 * j) &&
               l2tile::d2(xn, yn[j], acc[i][j]) <= eps2;
    store_hits(hit, m0 + r, q, w0, nw, bits, cnt);
  }
}

}  // namespace

// cnt (q,) must be zero on entry; bits is (q, nw) with nw = ceil(p / 32),
// every word of which is stored. Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int nng_tile_grouped_launch(const void* x, const void* y,
                                       const void* xg, const void* yg,
                                       const void* xid, const void* yid,
                                       void* cnt, void* bits, int q, int p,
                                       int d, float eps2, void* stream) {
  const int nw = (p + 31) / 32;
  const dim3 grid((p + BN - 1) / BN, (q + BM - 1) / BM);
  nng_tile_grouped_kernel<<<grid, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const int32_t*>(xg), static_cast<const int32_t*>(yg),
      static_cast<const int32_t*>(xid), static_cast<const int32_t*>(yid),
      static_cast<int32_t*>(cnt), static_cast<uint32_t*>(bits), q, p, d, nw,
      eps2);
  return static_cast<int>(cudaGetLastError());
}
