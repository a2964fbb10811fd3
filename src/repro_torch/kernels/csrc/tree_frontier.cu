// One level of the batched cover-tree traversal: fp32 L2 distances, the
// emit / expand decisions and their packed bitmasks.
//
// Replaces: tree_frontier_pallas (src/repro/kernels/tree_frontier.py), the
// TPU kernel that device.tree_traverse runs on every level of every
// traversal.
//
// Computes, for queries q (nq, d), level nodes c (n, d) fp32, radii rad (n,)
// fp32, leaf flags leaf (n,) int32 and the packed active mask act
// (nq, nw) uint32, nw = ceil(n / 32) (node j is word j / 32, bit j % 32):
//   d2    = (|q_i|^2 + |c_j|^2) - 2 <q_i, c_j>      (l2_tile.cuh)
//   d     = sqrt(max(d2, 0))
//   slack = ((d + rad_j) + eps) * 1e-5 + 1e-6
//   leaf node:     emit   = active && d2 <= eps2,     expand = 0
//   internal node: emit   = active && d + rad_j <= eps - slack
//                  expand = active && !emit && d <= (rad_j + eps) + slack
// Each operation rounds to fp32 in the order written, as the plain version
// does (no contraction into FMAs, correctly rounded sqrt: no fast math).
//
// What bounds it on an H100: the function needs the distances of its active
// pairs only (2 flops per feature and pair) and must read q, c and the
// active words and write two words per 32 pairs; on the traversal's sparse
// masks those bytes outweigh the active pairs' flops, so the bound is bytes.
// The kernel computes the full 128 x 128 x d fp32 product (IEEE fp32: no
// TF32, no tensor cores) of every block that has one active pair, so where
// the active pairs are scattered it does far more work than the bound. A
// block with no active pair only reads its active words and writes zeros.
//
// What the simple design does about it: each 256-thread block owns a
// 128 x 128 tile. It first reads the tile's 128 x 4 active words into shared
// memory; if all of them are zero (__syncthreads_or), it writes zero emit
// and expand words and leaves without touching the points. Otherwise it
// runs the same fp32 tile as nng_tile.cu (l2_tile.cuh), so a leaf's d2 is
// bit-identical to the tile kernel's. The prologue and the epilogue that
// packs each emit and expand word with __ballot_sync are tile_io.cuh's, as
// in the Hamming and L1 frontiers. Ragged nq and n are masked in the
// kernel: out-of-range nodes are never active.
#include "l2_tile.cuh"

namespace {

using namespace l2tile;

__global__ void __launch_bounds__(THREADS, 2)
tree_frontier_kernel(const float* __restrict__ q, const float* __restrict__ c,
                     const float* __restrict__ rad,
                     const int32_t* __restrict__ leaf,
                     const uint32_t* __restrict__ act,
                     uint32_t* __restrict__ emit,
                     uint32_t* __restrict__ expand, int nq, int n, int d,
                     int nw, float eps, float eps2) {
  __shared__ Smem s;
  __shared__ uint32_t sact[BM][WPB];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int w0 = n0 >> 5;

  if (!stage_active(act, nq, nw, m0, w0, sact)) {
    zero_masks(nq, nw, m0, w0, emit, expand);
    return;
  }
  float acc[TM][TN];
  products(q, c, nq, n, d, m0, n0, s, acc);

  float yn[TN];
  float r[TN];
  bool ok[TN];
  bool lf[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = n0 + lane + 32 * j;
    ok[j] = col < n;
    yn[j] = s.ynorm[lane + 32 * j];
    r[j] = ok[j] ? rad[col] : 0.f;
    lf[j] = ok[j] && leaf[col] != 0;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float xn = s.xnorm[warp * TM + i];
    bool e_bit[TN];
    bool x_bit[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const bool a = ok[j] && active_bit(sact, warp * TM + i, j);
      const float v = l2tile::d2(xn, yn[j], acc[i][j]);
      const float dist = sqrtf(fmaxf(v, 0.f));
      const float slack =
          __fadd_rn(__fmul_rn(__fadd_rn(__fadd_rn(dist, r[j]), eps), 1e-5f),
                    1e-6f);
      x_bit[j] = false;
      if (lf[j]) {
        e_bit[j] = a && v <= eps2;
      } else {
        e_bit[j] = a && __fadd_rn(dist, r[j]) <= __fsub_rn(eps, slack);
        x_bit[j] = a && !e_bit[j] &&
                   dist <= __fadd_rn(__fadd_rn(r[j], eps), slack);
      }
    }
    store_masks(e_bit, x_bit, m0 + warp * TM + i, nq, w0, nw, emit, expand);
  }
}

}  // namespace

// emit and expand are (nq, nw) with nw = ceil(n / 32); every word is
// written. Launches on `stream` and returns cudaGetLastError().
extern "C" int tree_frontier_launch(const void* q, const void* c,
                                    const void* rad, const void* leaf,
                                    const void* act, void* emit, void* expand,
                                    int nq, int n, int d, float eps,
                                    float eps2, void* stream) {
  const int nw = (n + 31) / 32;
  const dim3 grid((n + BN - 1) / BN, (nq + BM - 1) / BM);
  tree_frontier_kernel<<<grid, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(c),
      static_cast<const float*>(rad), static_cast<const int32_t*>(leaf),
      static_cast<const uint32_t*>(act), static_cast<uint32_t*>(emit),
      static_cast<uint32_t*>(expand), nq, n, d, nw, eps, eps2);
  return static_cast<int>(cudaGetLastError());
}
