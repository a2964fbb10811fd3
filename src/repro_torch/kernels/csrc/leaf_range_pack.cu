// Tree-traversal leaf epilogue: running sum of the +-1 leaf-range deltas,
// the cover tests, and the packed cover mask with its row counts.
//
// Replaces: leaf_range_pack_pallas (src/repro/kernels/bits_epilogue.py),
// the TPU kernel that device.tree_traverse runs once per traversal (here:
// once per query chunk).
//
// Computes, for delta (nq, nl) int32 rows with row stride ld >= nl (the
// traversal's trailing overflow column lies past nl and is never read),
// leaf_ids (nl,) int32 and qids (nq,) int32:
//   run[i][j]   = delta[i][0] + ... + delta[i][j]              (exact int32)
//   cover[i][j] = run[i][j] > 0 && leaf_ids[j] != SENTINEL && qids[i] != leaf_ids[j]
//   bits[i][j / 32] bit (j % 32) = cover[i][j],  cnt[i] = popcount of row i.
//
// What bounds it on an H100: bytes. It reads nq·nl·4 bytes of deltas and
// writes nq·nl/8 bytes of bits with a handful of integer operations per
// delta, so device memory bandwidth is the ceiling.
//
// What the simple design does about it: one warp per row walks the row's
// deltas 32 columns at a time, lane l reading column c0 + l, so each load
// is one coalesced 128-byte transaction; four such loads are issued before
// they are used, so a warp keeps several in flight. An inclusive warp scan
// with __shfl_up_sync plus the carry of the columns already walked gives
// each lane its running sum, lane 31's sum is the next carry, and
// __ballot_sync of the lanes' cover tests is the packed word. The scan is
// exact integer arithmetic (the TPU kernel's triangular fp32 product is
// not needed), so the kernel is bit-identical to the plain version on
// every input.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;           // 8 rows per block
constexpr int UNROLL = 4;              // 32-column steps loaded ahead
constexpr int32_t SENTINEL = 0x7fffffff;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
leaf_range_pack_kernel(const int32_t* __restrict__ delta, long long ld,
                       const int32_t* __restrict__ leaf_ids,
                       const int32_t* __restrict__ qids,
                       int32_t* __restrict__ cnt, uint32_t* __restrict__ bits,
                       int nq, int nl) {
  const int row = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= nq) return;               // whole warps leave together
  const int nw = (nl + 31) / 32;
  const int32_t* drow = delta + (size_t)row * ld;
  uint32_t* brow = bits + (size_t)row * nw;
  const int32_t qid = qids[row];

  int carry = 0;
  int count = 0;
  for (int c0 = 0; c0 < nl; c0 += 32 * UNROLL) {
    int v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int col = c0 + 32 * u + lane;
      v[u] = col < nl ? drow[col] : 0;
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int col = c0 + 32 * u + lane;
      int run = v[u];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(FULL, run, off);
        if (lane >= off) run += t;
      }
      run += carry;
      carry = __shfl_sync(FULL, run, 31);
      const int32_t lid = col < nl ? leaf_ids[col] : SENTINEL;
      const bool cover = run > 0 && lid != SENTINEL && lid != qid;
      const unsigned word = __ballot_sync(FULL, cover);
      const int w = (c0 >> 5) + u;
      if (lane == 0 && w < nw) brow[w] = word;
      count += __popc(word);
    }
  }
  if (lane == 0) cnt[row] = count;
}

}  // namespace

// delta rows start ld int32 apart; cnt is (nq,), bits (nq, ceil(nl / 32)).
// Launches on `stream` and returns cudaGetLastError().
extern "C" int leaf_range_pack_launch(const void* delta, long long ld,
                                      const void* leaf_ids, const void* qids,
                                      void* cnt, void* bits, int nq, int nl,
                                      void* stream) {
  const int blocks = (nq + THREADS / 32 - 1) / (THREADS / 32);
  leaf_range_pack_kernel<<<blocks, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(delta), ld,
      static_cast<const int32_t*>(leaf_ids),
      static_cast<const int32_t*>(qids), static_cast<int32_t*>(cnt),
      static_cast<uint32_t*>(bits), nq, nl);
  return static_cast<int>(cudaGetLastError());
}
