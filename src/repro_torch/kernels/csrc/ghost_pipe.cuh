// The ghost ε-tile on the pipelined cores, shared by nng_tile_ghost.cu (L2,
// l2_pipe.cuh's Dot body) and nng_tile_ghost_l1.cu (L1, l1_pipe.cuh's L1
// body): the landmark engine's ghost-ring tile over the live tiles only.
//
// Computes, for x (q, d), y (p, d) fp32, x's ghost keys (q, mw) (bit c of
// word c / 32: row i is a Lemma-1 ghost of cell c) and y cells yg (p,)
// int32:
//   hit      = (the body's test) && yg[j] >= 0 && bit yg[j] of key[i] is set
//     Dot:  l2tile::d2 of the core's product and the rows' norms <= eps2
//     L1:   the core's sum in l1_tile.cuh's order                <= eps
//   bits[i][j / 32] bit (j % 32) = hit,   cnt[i] += popcount of row i's words.
// A row's own cell bit is never set, so no id test is needed.
//
// The wrapper (kernels/nng_tile.py, ghost_launch) hands x gathered in
// ghost_row_order (x[rows], contiguous and 16-byte aligned, so the TMA path
// applies where d % 4 == 0), the ordered keys, the row map rows and
// ghost_tile_plan's list of 64 x 256 tiles with its live count on the card
// (no host sync); cnt and bits are zero on entry. The core's persistent
// walk (l2_pipe.cuh's run) takes the listed live tiles, and this epilogue
// tests each pair's cell bit against its row's key (one register when
// mw == 1) before tile_io.cuh's __ballot_sync packing, and stores each
// word and count at the row's place in the caller's order (rows[i]). Dead
// tiles store nothing: their words stay zero.
#pragma once

#include "l1_pipe.cuh"

namespace gpipe {

using namespace l2pipe;

// The hit test of a walk body on a pair's accumulated value.
template <class Body>
struct Test;
template <>
struct Test<Dot> {        // d2 from the product and the rows' norms
  __device__ __forceinline__ static bool pass(float acc, float xn, float yn,
                                              float thr) {
    return l2tile::d2(xn, yn, acc) <= thr;
  }
};
template <>
struct Test<l1pipe::L1> { // the L1 sum itself
  __device__ __forceinline__ static bool pass(float acc, float, float,
                                              float thr) {
    return acc <= thr;
  }
};

template <class Body, bool TMA, bool ONE_WORD>
__global__ void __launch_bounds__(PTHREADS, 2)
ghost_kernel(const __grid_constant__ Maps maps, const float* __restrict__ x,
             const float* __restrict__ y, const uint32_t* __restrict__ keys,
             const int32_t* __restrict__ yg,
             const int32_t* __restrict__ rows,
             const int32_t* __restrict__ tiles,
             const int32_t* __restrict__ ntiles, int32_t* __restrict__ cnt,
             uint32_t* __restrict__ bits, const float* __restrict__ xsq,
             const float* __restrict__ ysq, int q, int p, int d, int mw,
             int nw, float thr) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  run<TMA, true, Body>(
      maps, x, y, xsq, ysq, q, p, d,
      [&](int m0, int n0, const float (&acc)[TM][PTN], const float* xnorm,
          const float* ynorm) {
        // column j's cell as a bit of its key word (0: padding or past p,
        // never a hit) and, for mw > 1, that word's index
        float yn[PTN];
        uint32_t cb[PTN];
        int cw[PTN];
#pragma unroll
        for (int j = 0; j < PTN; ++j) {
          const int col = n0 + lane + 32 * j;
          const int32_t c = col < p ? yg[col] : -1;
          yn[j] = Body::NORMS ? ynorm[lane + 32 * j] : 0.f;
          cb[j] = c >= 0 ? 1u << (c & 31) : 0u;
          cw[j] = c >= 0 ? c >> 5 : 0;
        }
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int r = m0 + warp * TM + i;
          const bool in = r < q;
          const float xn = Body::NORMS ? xnorm[warp * TM + i] : 0.f;
          const uint32_t* kr = keys + (size_t)r * mw;
          const uint32_t key = ONE_WORD && in ? kr[0] : 0u;
          // the row's PTN words, n0 / 32 onwards: lane j keeps word j
          uint32_t mine = 0u;
          int rc = 0;
#pragma unroll
          for (int j = 0; j < PTN; ++j) {
            const uint32_t k = ONE_WORD ? key : (in ? kr[cw[j]] : 0u);
            const unsigned word = __ballot_sync(
                FULL, (k & cb[j]) != 0u &&
                          Test<Body>::pass(acc[i][j], xn, yn[j], thr));
            if (lane == j) mine = word;
            rc += __popc(word);
          }
          if (in) {
            const int orow = rows[r];
            const int w = (n0 >> 5) + lane;
            if (lane < PTN && w < nw) bits[(size_t)orow * nw + w] = mine;
            if (lane == 0 && rc != 0) atomicAdd(&cnt[orow], rc);
          }
        }
      },
      tiles, ntiles);
}

template <class Body, bool TMA>
int launch(bool one_word, const void* x, const void* y, const void* keys,
           const void* yg, const void* rows, const void* tiles,
           const void* ntiles, void* cnt, void* bits, void* xsq, void* ysq,
           int q, int p, int d, int mw, float thr, int sms,
           cudaStream_t st) {
  const auto kernel = one_word ? ghost_kernel<Body, TMA, true>
                               : ghost_kernel<Body, TMA, false>;
  Maps maps{};
  int blocks = 0;
  const int e = prepare(kernel, TMA, x, y, nullptr, xsq, ysq, q, p, d, sms,
                        st, maps, blocks);
  if (e != 0) return e;
  kernel<<<blocks, PTHREADS, SMEM_BYTES, st>>>(
      maps, static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const uint32_t*>(keys), static_cast<const int32_t*>(yg),
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(tiles),
      static_cast<const int32_t*>(ntiles), static_cast<int32_t*>(cnt),
      static_cast<uint32_t*>(bits), static_cast<const float*>(xsq),
      static_cast<const float*>(ysq), q, p, d, mw, (p + 31) / 32, thr);
  return static_cast<int>(cudaGetLastError());
}

// One ghost launch with body Body and threshold thr (Dot: eps2, L1: eps).
// xsq (q,) and ysq (p,) are the row norms' scratch for Dot (summed here
// first) and null for L1. Returns a CUDA error code (0 on success).
template <class Body>
int ghost_launch(const void* x, const void* y, const void* keys,
                 const void* yg, const void* rows, const void* tiles,
                 const void* ntiles, void* cnt, void* bits, void* xsq,
                 void* ysq, int q, int p, int d, int mw, float thr, int sms,
                 cudaStream_t st) {
  return tma_ok(x, y, d)
             ? launch<Body, true>(mw == 1, x, y, keys, yg, rows, tiles,
                                  ntiles, cnt, bits, xsq, ysq, q, p, d, mw,
                                  thr, sms, st)
             : launch<Body, false>(mw == 1, x, y, keys, yg, rows, tiles,
                                   ntiles, cnt, bits, xsq, ysq, q, p, d, mw,
                                   thr, sms, st);
}

}  // namespace gpipe
