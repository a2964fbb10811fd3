// The pipelined tree frontier shared by tree_frontier.cu (L2, on
// l2_pipe.cuh's core), tree_frontier_l1.cu (L1, on l1_pipe.cuh's) and
// tree_frontier_hamming.cu (Hamming, on hamming_pipe.cuh's): one level of
// the batched cover-tree traversal over the live tiles only.
//
// A launch (frontier_launch) is three kernels on one stream, with no host
// sync:
//   1. the plan (frontier_plan_kernel), one pass over the (nq, nw) packed
//      active words in coalesced row reads: a 64 x 256 tile with a nonzero
//      word is live and appended to the tile list (an atomicAdd on the
//      count, zeroed first: the list's order is the atomics', and no
//      result depends on it); a dead tile gets zero emit and expand
//      words. This is the rule of
//      kernels/tree_frontier.py's frontier_tile_plan (the plain version,
//      which the tests hold to it), in one pass over the active words;
//   2. for L2, the rows' squared norms (l2_pipe.cuh's row_norms_kernel);
//   3. the core's persistent walk over the listed tiles, and this epilogue
//      on its fragments (warp w owns rows [16w, 16w + 16) of the tile, lane
//      l columns l + 32 j): a row whose eight active words in the tile are
//      zero gets zero words; otherwise lane j < 8 loads word j of the row,
//      every lane takes each pair's bit from it by __shfl_sync, applies the
//      decisions below, and __ballot_sync packs the emit and expand words
//      (tile_io.cuh's layout), which lanes 0..7 store.
//
// The decisions of the float metrics, each operation rounded to fp32 in
// the order written, as the plain versions do (no contraction into FMAs,
// correctly rounded sqrt):
//   L2: d2 = l2tile::d2 of the core, d = sqrt(max(d2, 0)); leaf: d2 <= eps2
//   L1: d = the core's sum;                                leaf: d <= eps
//   slack = ((d + rad_j) + eps) * 1e-5 + 1e-6
//   leaf node:     emit   = active && (leaf test),        expand = 0
//   internal node: emit   = active && d + rad_j <= eps - slack
//                  expand = active && !emit && d <= (rad_j + eps) + slack
// A pair's d2 (d) is the core's, so a leaf's test is nng_tile.cu's
// (nng_tile_l1.cu's) own, bit for bit. Hamming's are integer comparisons
// with zero slack (kernels/tree_frontier.py's _frontier_masks_hamming):
//   d = the core's popcount sum, r = (int) rad_j (truncated), eps an int
//   leaf node:     emit   = active && d <= eps,           expand = 0
//   internal node: emit   = active && d + r <= eps
//                  expand = active && !emit && d <= r + eps
// Columns past n are never active.
#pragma once

#include "hamming_pipe.cuh"
#include "l1_pipe.cuh"

namespace fpipe {

using namespace l2pipe;

constexpr int TW = PN / 32;        // active words a tile row: 8

enum class Metric { L2, L1, Hamming };

// The core's per-chunk body of each metric.
template <Metric M>
struct BodyOf {
  using type = Dot;
};
template <>
struct BodyOf<Metric::L1> {
  using type = l1pipe::L1;
};
template <>
struct BodyOf<Metric::Hamming> {
  using type = hampipe::Hamming;
};

// A launch's thresholds: fp32 eps and eps2 (L2) for the float metrics, the
// integer eps for Hamming.
struct Thr {
  float eps, eps2;
  int ieps;
};

// The plan (step 1 above). A block owns PLAN_WORDS word columns of one
// 64-row band of the (nq, nw) active words (PLAN_WORDS / TW tiles of that
// tile row): thread t ORs word column w0 + t over the band's rows, one
// coalesced 1 KB row read a step, and each group of TW lanes (one tile)
// combines its ORs with a ballot. A live tile's first lane appends it to
// the list; a dead tile's threads write its zero words. *ntiles must be
// zero on entry.
constexpr int PLAN_WORDS = 256;    // threads, and word columns, a block

__global__ void __launch_bounds__(PLAN_WORDS)
frontier_plan_kernel(const uint32_t* __restrict__ act,
                     uint32_t* __restrict__ emit,
                     uint32_t* __restrict__ expand,
                     int32_t* __restrict__ tiles,
                     int32_t* __restrict__ ntiles, int nq, int nw, int nt) {
  const int lane = threadIdx.x & 31;
  const int wb = (nw + PLAN_WORDS - 1) / PLAN_WORDS;    // blocks a band
  const int band = blockIdx.x / wb;
  const int m0 = band * PM;
  const int w = (blockIdx.x % wb) * PLAN_WORDS + threadIdx.x;
  const bool in = w < nw;
  const int rows = nq - m0 < PM ? nq - m0 : PM;
  uint32_t any = 0u;
#pragma unroll 8
  for (int r = 0; r < rows; ++r)
    if (in) any |= act[(size_t)(m0 + r) * nw + w];
  // bits 8k .. 8k + 7 of the ballot: tile (lane / TW)'s word columns
  const unsigned group =
      (__ballot_sync(FULL, any != 0u) >> (lane & ~(TW - 1))) &
      ((1u << TW) - 1u);
  if (group != 0u) {
    // a group's first column is w = TW * tile column: in range iff the
    // tile is
    if (lane % TW == 0 && in)
      tiles[atomicAdd(ntiles, 1)] = band * nt + w / TW;
    return;
  }
  if (!in) return;
#pragma unroll 8
  for (int r = 0; r < rows; ++r) {
    emit[(size_t)(m0 + r) * nw + w] = 0u;
    expand[(size_t)(m0 + r) * nw + w] = 0u;
  }
}

// The epilogue (step 3 above) of the tile at (m0, n0).
template <Metric M>
__device__ __forceinline__ void frontier_tile(
    int m0, int n0, const float (&acc)[TM][PTN], const float* xnorm,
    const float* ynorm, const float* __restrict__ rad,
    const int32_t* __restrict__ leaf, const uint32_t* __restrict__ act,
    uint32_t* __restrict__ emit, uint32_t* __restrict__ expand, int nq,
    int n, int nw, Thr thr) {
  constexpr bool L2 = M == Metric::L2;
  const float eps = thr.eps, eps2 = thr.eps2;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // column j: its norm (L2), radius, and bit j of the valid and leaf masks
  float yn[PTN];
  float r[PTN];
  uint32_t ok = 0u, lf = 0u;
#pragma unroll
  for (int j = 0; j < PTN; ++j) {
    const int col = n0 + lane + 32 * j;
    const bool in = col < n;
    yn[j] = L2 ? ynorm[lane + 32 * j] : 0.f;
    r[j] = in ? rad[col] : 0.f;
    ok |= in ? 1u << j : 0u;
    lf |= in && leaf[col] != 0 ? 1u << j : 0u;
  }
  const int w = (n0 >> 5) + lane;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + warp * TM + i;
    const bool mine = lane < TW && row < nq && w < nw;
    // lane j < TW holds the row's word n0 / 32 + j
    const uint32_t aw = mine ? act[(size_t)row * nw + w] : 0u;
    uint32_t we = 0u, wx = 0u;
    if (__any_sync(FULL, aw != 0u)) {
      const float xn = L2 ? xnorm[warp * TM + i] : 0.f;
#pragma unroll
      for (int j = 0; j < PTN; ++j) {
        // every lane takes part in the shuffle and the ballots
        const uint32_t word = __shfl_sync(FULL, aw, j);
        const bool a = ((ok >> j) & 1u) && ((word >> lane) & 1u);
        bool e_bit, x_bit = false;
        if constexpr (M == Metric::Hamming) {
          const int dist = __float_as_int(acc[i][j]);
          const int ri = static_cast<int>(r[j]);
          if ((lf >> j) & 1u) {
            e_bit = a && dist <= thr.ieps;
          } else {
            e_bit = a && dist + ri <= thr.ieps;
            x_bit = a && !e_bit && dist <= ri + thr.ieps;
          }
        } else {
          float dist, v = 0.f;
          if (L2) {
            v = l2tile::d2(xn, yn[j], acc[i][j]);
            dist = sqrtf(fmaxf(v, 0.f));
          } else {
            dist = acc[i][j];
          }
          const float slack = __fadd_rn(
              __fmul_rn(__fadd_rn(__fadd_rn(dist, r[j]), eps), 1e-5f),
              1e-6f);
          if ((lf >> j) & 1u) {
            e_bit = a && (L2 ? v <= eps2 : dist <= eps);
          } else {
            e_bit = a && __fadd_rn(dist, r[j]) <= __fsub_rn(eps, slack);
            x_bit = a && !e_bit &&
                    dist <= __fadd_rn(__fadd_rn(r[j], eps), slack);
          }
        }
        const unsigned be = __ballot_sync(FULL, e_bit);
        const unsigned bx = __ballot_sync(FULL, x_bit);
        if (lane == j) {
          we = be;
          wx = bx;
        }
      }
    }
    if (mine) {
      emit[(size_t)row * nw + w] = we;
      expand[(size_t)row * nw + w] = wx;
    }
  }
}

template <Metric M, bool TMA>
__global__ void __launch_bounds__(PTHREADS, 2)
frontier_kernel(const __grid_constant__ Maps maps,
                const float* __restrict__ q, const float* __restrict__ c,
                const float* __restrict__ rad,
                const int32_t* __restrict__ leaf,
                const uint32_t* __restrict__ act,
                const int32_t* __restrict__ tiles,
                const int32_t* __restrict__ ntiles,
                uint32_t* __restrict__ emit, uint32_t* __restrict__ expand,
                const float* __restrict__ qsq, const float* __restrict__ csq,
                int nq, int n, int d, int nw, Thr thr) {
  run<TMA, true, typename BodyOf<M>::type>(
      maps, q, c, qsq, csq, nq, n, d,
      [&](int m0, int n0, const float (&acc)[TM][PTN], const float* xnorm,
          const float* ynorm) {
        frontier_tile<M>(m0, n0, acc, xnorm, ynorm, rad, leaf, act, emit,
                         expand, nq, n, nw, thr);
      },
      tiles, ntiles);
}

template <Metric M, bool TMA>
int launch_walk(const void* q, const void* c, const void* rad,
                const void* leaf, const void* act, const void* tiles,
                const void* ntiles, void* emit, void* expand, void* qsq,
                void* csq, int nq, int n, int d, Thr thr, int sms,
                cudaStream_t st) {
  const auto kernel = frontier_kernel<M, TMA>;
  Maps maps{};
  int blocks = 0;
  const int e = prepare(kernel, TMA, q, c, nullptr, qsq, csq, nq, n, d, sms,
                        st, maps, blocks);
  if (e != 0) return e;
  kernel<<<blocks, PTHREADS, SMEM_BYTES, st>>>(
      maps, static_cast<const float*>(q), static_cast<const float*>(c),
      static_cast<const float*>(rad), static_cast<const int32_t*>(leaf),
      static_cast<const uint32_t*>(act), static_cast<const int32_t*>(tiles),
      static_cast<const int32_t*>(ntiles), static_cast<uint32_t*>(emit),
      static_cast<uint32_t*>(expand), static_cast<const float*>(qsq),
      static_cast<const float*>(csq), nq, n, d, (n + 31) / 32, thr);
  return static_cast<int>(cudaGetLastError());
}

// One frontier launch: the plan, then (for L2, the norms into qsq and csq
// and) the walk. tiles has room for every tile's index and ntiles for one
// int32; qsq and csq are null for L1 and Hamming (whose q and c are int32
// words, d their count). Returns a CUDA error code.
template <Metric M>
int frontier_launch(const void* q, const void* c, const void* rad,
                    const void* leaf, const void* act, void* tiles,
                    void* ntiles, void* emit, void* expand, void* qsq,
                    void* csq, int nq, int n, int d, Thr thr, int sms,
                    cudaStream_t st) {
  const int nw = (n + 31) / 32;
  const int mt = (nq + PM - 1) / PM;
  const int nt = (nw + TW - 1) / TW;
  cudaError_t ce = cudaMemsetAsync(ntiles, 0, sizeof(int32_t), st);
  if (ce != cudaSuccess) return static_cast<int>(ce);
  frontier_plan_kernel<<<mt * ((nw + PLAN_WORDS - 1) / PLAN_WORDS),
                         PLAN_WORDS, 0, st>>>(
      static_cast<const uint32_t*>(act), static_cast<uint32_t*>(emit),
      static_cast<uint32_t*>(expand), static_cast<int32_t*>(tiles),
      static_cast<int32_t*>(ntiles), nq, nw, nt);
  ce = cudaGetLastError();
  if (ce != cudaSuccess) return static_cast<int>(ce);
  return tma_ok(q, c, d)
             ? launch_walk<M, true>(q, c, rad, leaf, act, tiles, ntiles,
                                    emit, expand, qsq, csq, nq, n, d, thr,
                                    sms, st)
             : launch_walk<M, false>(q, c, rad, leaf, act, tiles, ntiles,
                                     emit, expand, qsq, csq, nq, n, d, thr,
                                     sms, st);
}

}  // namespace fpipe
