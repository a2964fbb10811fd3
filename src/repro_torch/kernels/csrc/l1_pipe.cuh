// The pipelined fp32 L1 (Manhattan) distance core of tree_frontier_l1.cu.
//
// l2_pipe.cuh's walk and staging with an L1 body: the persistent grid of
// two 128-thread blocks an SM over 64 x 256 tiles (all of them, or a tile
// list whose count is read on the card), the two-stage ring of TMA box
// copies (4-byte cp.async copies where d % 4 != 0 or a base is not 16-byte
// aligned) with the 128-byte swizzle, and the 16 x 8 register tile a thread
// (warp w: rows [16w, 16w + 16); lane l: columns l + 32 j). No row norms
// are staged.
//
// The summation order is l1_tile.cuh's, bit for bit (the reference's
// _l1_tile_d with cchunk = 8, and the plain version nng_tile.l1_dist):
// within each chunk of CHUNK = 8 features a partial sum |x - y| left to
// right, then d += partial, chunks in ascending order from d = 0. A stage
// of 32 features holds four such chunks, so chunks stay aligned to feature
// 0. Features past d load as 0 in both operands: |0 - 0| adds exactly 0 to
// a partial, and a chunk wholly past d adds +0 to d. The adds are spelled
// __fadd_rn / __fsub_rn so the order is stated, not left to the compiler
// (|.| folds into the add as an operand modifier). A thread sums the
// partials of TG = 4 rows x 8 columns at a time, so the partials, the
// distances and a chunk half's y values fit in registers together.
#pragma once

#include "l2_pipe.cuh"

namespace l1pipe {

using namespace l2pipe;

constexpr int CHUNK = 8;           // features a partial sum (cchunk)
constexpr int TG = 4;              // rows a group of partial sums

static_assert(BK % CHUNK == 0 && CHUNK == 8, "a chunk is two float4s");
static_assert(TM % TG == 0, "row groups cover the warp's rows");

// The walk's L1 body: acc[i][j] += the stage's partial sums for x row
// (16 warp + i) and y row (lane + 32 j), chunk by chunk.
struct L1 {
  static constexpr bool NORMS = false;
  __device__ __forceinline__ static void chunk(const Stage& s,
                                               float (&acc)[TM][PTN]) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const auto* xs = reinterpret_cast<const unsigned char*>(s.x);
    const auto* ys = reinterpret_cast<const unsigned char*>(s.y);
    // rows 16 warp + i and lane + 32 j keep (r & 7) = i & 7 and lane & 7
    const unsigned char* xw = xs + warp * TM * 128;
    const unsigned char* yl = ys + lane * 128;
#pragma unroll 1
    for (int c8 = 0; c8 < BK / CHUNK; ++c8) {
#pragma unroll
      for (int g = 0; g < TM; g += TG) {
        float part[TG][PTN];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // float4 chunk c: features 4c .. 4c + 3 of the stage
          const int c = 2 * c8 + h;
          const int yc = (c ^ (lane & 7)) << 4;
          float4 b[PTN];
#pragma unroll
          for (int j = 0; j < PTN; ++j)
            b[j] = *reinterpret_cast<const float4*>(yl + 32 * 128 * j + yc);
#pragma unroll
          for (int i = 0; i < TG; ++i) {
            const int r = g + i;
            const float4 a = *reinterpret_cast<const float4*>(
                xw + r * 128 + ((c ^ (r & 7)) << 4));
#pragma unroll
            for (int j = 0; j < PTN; ++j) {
              const float v = fabsf(__fsub_rn(a.x, b[j].x));
              float t = h == 0 ? v : __fadd_rn(part[i][j], v);
              t = __fadd_rn(t, fabsf(__fsub_rn(a.y, b[j].y)));
              t = __fadd_rn(t, fabsf(__fsub_rn(a.z, b[j].z)));
              part[i][j] = __fadd_rn(t, fabsf(__fsub_rn(a.w, b[j].w)));
            }
          }
        }
#pragma unroll
        for (int i = 0; i < TG; ++i)
#pragma unroll
          for (int j = 0; j < PTN; ++j)
            acc[g + i][j] = __fadd_rn(acc[g + i][j], part[i][j]);
      }
    }
  }
};

}  // namespace l1pipe
