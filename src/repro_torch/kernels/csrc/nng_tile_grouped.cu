// Grouped fp32 L2 ε-tile: the landmark engine's cell-scoped tile.
//
// Replaces: nng_tile_grouped_pallas (src/repro/kernels/nng_tile.py, its
// pallas_call at :376), the TPU kernel that the landmark engine
// (Algorithms 5+6) runs for the intra-cell W x W and ghost G x W queries.
//
// Computes, for x (q, d), y (p, d) fp32, groups xg (q,), yg (p,) and global
// ids xid (q,), yid (p,), all int32:
//   d2[i][j] = (|x_i|^2 + |y_j|^2) - 2 * <x_i, y_j>
//   hit      = d2 <= eps2 && xg[i] == yg[j] >= 0 && xid[i] != yid[j]
//   bits[i][j / 32] bit (j % 32) = hit,   cnt[i] += popcount of row i's words.
//
// What bounds it on an H100: operations, over the pairs the function needs
// (a row against the columns of its own cell: on rank 0's W x W launch
// about half of all pairs); what a launch costs is the pairs of the
// tiles it computes. The arithmetic is IEEE fp32 on the CUDA cores (no
// TF32, no tensor cores), so the ceiling is their fp32 FMA rate.
//
// What the design does about it. Callers sort x and y by cell, so the
// tiles where a row and a column can share a cell lie along the cells'
// diagonal. The wrapper (kernels/nng_tile.py, nng_tile_grouped_cuda), on
// the card with no host sync, lists the 64 x 256 tiles whose valid-group
// [min, max] ranges intersect (grouped_tile_plan), the live ones first,
// their count a device scalar, and zeroes cnt and bits. Here: l2_pipe.cuh's
// persistent walk (TMA-fed ring, 16 x 8 register tiles, row norms summed
// once by the pre-pass) takes the listed live tiles with its Dot body,
// and this epilogue tests each pair's groups and ids before tile_io.cuh's
// __ballot_sync packing: lane l reads the groups and ids of its 8 columns
// once a tile and those of one of its warp's 16 rows, which the rows take
// by shuffle; where the rows and columns all hold one valid group (a tile
// inside a cell: most live tiles), a warp-uniform branch leaves only the
// id test. Dead tiles store nothing: their words stay zero. The per-pair d2 is the core's, so a hit is
// nng_tile.cu's under the group test, bit for bit. The engine's
// tiles_scheduled / tiles_skipped counters come from
// ops.grouped_block_active at the reference's own tile geometry, not from
// this launch.
#include "l2_pipe.cuh"

namespace {

using namespace l2pipe;

// One row's PTN words of a tile under hit test `test(j)` (lane j keeps
// word j), stored at row r with the row's count, as tile_io.cuh's layout.
template <class Test>
__device__ __forceinline__ void store_row(int r, int q, int n0, int nw,
                                          int lane, Test&& test,
                                          uint32_t* __restrict__ bits,
                                          int32_t* __restrict__ cnt) {
  uint32_t mine = 0u;
  int rc = 0;
#pragma unroll
  for (int j = 0; j < PTN; ++j) {
    const unsigned word = __ballot_sync(FULL, test(j));
    if (lane == j) mine = word;
    rc += __popc(word);
  }
  if (r < q) {
    const int w = (n0 >> 5) + lane;
    if (lane < PTN && w < nw) bits[(size_t)r * nw + w] = mine;
    if (lane == 0 && rc != 0) atomicAdd(&cnt[r], rc);
  }
}

template <bool TMA>
__global__ void __launch_bounds__(PTHREADS, 2)
grouped_kernel(const __grid_constant__ Maps maps,
               const float* __restrict__ x, const float* __restrict__ y,
               const int32_t* __restrict__ xg,
               const int32_t* __restrict__ yg,
               const int32_t* __restrict__ xid,
               const int32_t* __restrict__ yid,
               const int32_t* __restrict__ tiles,
               const int32_t* __restrict__ ntiles, int32_t* __restrict__ cnt,
               uint32_t* __restrict__ bits, const float* __restrict__ xsq,
               const float* __restrict__ ysq, int q, int p, int d, int nw,
               float eps2) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  run<TMA, true, Dot>(
      maps, x, y, xsq, ysq, q, p, d,
      [&](int m0, int n0, const float (&acc)[TM][PTN], const float* xnorm,
          const float* ynorm) {
        // column j's group (-1: padding or past p, never a hit) and id
        float yn[PTN];
        int32_t cg[PTN], cid[PTN];
        int32_t cmin = GBIG, cmax = -1;
#pragma unroll
        for (int j = 0; j < PTN; ++j) {
          const int col = n0 + lane + 32 * j;
          const int32_t g = col < p ? yg[col] : -1;
          yn[j] = ynorm[lane + 32 * j];
          cg[j] = g >= 0 ? g : -1;
          cid[j] = col < p ? yid[col] : 0;
          cmin = min(cmin, cg[j]);
          cmax = max(cmax, cg[j]);
        }
        // lane l holds the group (-2: padding or past q, never a hit) and
        // id of the warp's row l % TM; the rows take them by shuffle
        const int rl = m0 + warp * TM + (lane & (TM - 1));
        const int32_t lg = rl < q && xg[rl] >= 0 ? xg[rl] : -2;
        const int32_t lid = rl < q ? xid[rl] : 0;
        // one valid group on the warp's 16 rows and all 256 columns (a
        // tile inside a cell: most live tiles) leaves only the id test;
        // every lane reduces before any branch
        const int32_t c_lo = __reduce_min_sync(FULL, cmin);
        const int32_t c_hi = __reduce_max_sync(FULL, cmax);
        const int32_t r_lo = __reduce_min_sync(FULL, lg);
        const int32_t r_hi = __reduce_max_sync(FULL, lg);
        const bool uniform = c_lo == c_hi && r_lo == r_hi && r_lo == c_lo;
        if (uniform) {
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float xn = xnorm[warp * TM + i];
            const int32_t rid = __shfl_sync(FULL, lid, i);
            store_row(m0 + warp * TM + i, q, n0, nw, lane, [&](int j) {
              return cid[j] != rid &&
                     l2tile::d2(xn, yn[j], acc[i][j]) <= eps2;
            }, bits, cnt);
          }
        } else {
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const float xn = xnorm[warp * TM + i];
            const int32_t rg = __shfl_sync(FULL, lg, i);
            const int32_t rid = __shfl_sync(FULL, lid, i);
            store_row(m0 + warp * TM + i, q, n0, nw, lane, [&](int j) {
              return cg[j] == rg && cid[j] != rid &&
                     l2tile::d2(xn, yn[j], acc[i][j]) <= eps2;
            }, bits, cnt);
          }
        }
      },
      tiles, ntiles);
}

template <bool TMA>
int launch(const void* x, const void* y, const void* xg, const void* yg,
           const void* xid, const void* yid, const void* tiles,
           const void* ntiles, void* cnt, void* bits, void* xsq, void* ysq,
           int q, int p, int d, float eps2, int sms, cudaStream_t st) {
  const auto kernel = grouped_kernel<TMA>;
  Maps maps{};
  int blocks = 0;
  const int e = prepare(kernel, TMA, x, y, nullptr, xsq, ysq, q, p, d, sms,
                        st, maps, blocks);
  if (e != 0) return e;
  kernel<<<blocks, PTHREADS, SMEM_BYTES, st>>>(
      maps, static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const int32_t*>(xg), static_cast<const int32_t*>(yg),
      static_cast<const int32_t*>(xid), static_cast<const int32_t*>(yid),
      static_cast<const int32_t*>(tiles),
      static_cast<const int32_t*>(ntiles), static_cast<int32_t*>(cnt),
      static_cast<uint32_t*>(bits), static_cast<const float*>(xsq),
      static_cast<const float*>(ysq), q, p, d, (p + 31) / 32, eps2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cnt (q,) and bits (q, nw), nw = ceil(p / 32), must be zero on entry.
// tiles is the list of 64 x 256 tile indices (row after row over the
// (q, p) output), the live ones first, and ntiles a one-element int32
// device count of them. xsq (q,) and ysq (p,) are 16-byte aligned fp32
// scratch for the rows' norms (written here first); sms is the device's SM
// count. Launches on `stream` and returns a CUDA error code: the tensor
// maps', shared-memory opt-in's or occupancy query's, else
// cudaGetLastError() of the launches (0 on success).
extern "C" int nng_tile_grouped_launch(const void* x, const void* y,
                                       const void* xg, const void* yg,
                                       const void* xid, const void* yid,
                                       const void* tiles, const void* ntiles,
                                       void* cnt, void* bits, void* xsq,
                                       void* ysq, int q, int p, int d,
                                       float eps2, int sms, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  return tma_ok(x, y, d)
             ? launch<true>(x, y, xg, yg, xid, yid, tiles, ntiles, cnt, bits,
                            xsq, ysq, q, p, d, eps2, sms, st)
             : launch<false>(x, y, xg, yg, xid, yid, tiles, ntiles, cnt,
                             bits, xsq, ysq, q, p, d, eps2, sms, st);
}
