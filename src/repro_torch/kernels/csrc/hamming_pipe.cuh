// The pipelined Hamming (XOR + popcount) distance body of
// tree_frontier_hamming.cu.
//
// l2_pipe.cuh's walk and staging with a Hamming body, as l1_pipe.cuh is
// with an L1 one: the persistent grid of two 128-thread blocks an SM over
// 64 x 256 tiles (here a tile list whose count is read on the card), the
// two-stage ring of TMA box copies (4-byte cp.async copies where
// w % 4 != 0 or a base is not 16-byte aligned) with the 128-byte swizzle,
// and the 16 x 8 register tile a thread (warp w: rows [16w, 16w + 16);
// lane l: columns l + 32 j). No row norms are staged.
//
// Points are rows of w packed 32-bit words. The copies move 4-byte
// elements without converting them (TMA's fp32 maps and cp.async alike), so
// a stage's fp32 slots hold the words unchanged, and the body reads them as
// uint4 along the same swizzled rows as l1pipe::L1. For each staged word,
// acc += popc(x ^ y). Words past w load as 0 in both operands and add
// popc(0) = 0, as in hamming_tile.cuh.
//
// The accumulator: the walk keeps fp32 registers, and an fp32 sum of
// popcounts is exact only while 32·w < 2^24. This body instead keeps an
// int32 count in each register's bit pattern (__float_as_int /
// __int_as_float are moves, no arithmetic touches the float value; the
// walk's 0.f start is int 0), so a distance is exact at any w the int32
// tensors allow, with no bound for the wrapper to check, and the walk is
// l2_pipe.cuh's unchanged. Callers read a distance as
// __float_as_int(acc[i][j]).
#pragma once

#include "l2_pipe.cuh"

namespace hampipe {

using namespace l2pipe;

// The walk's Hamming body: acc[i][j] (an int32 count in fp32 registers)
// += popc(x row (16 warp + i) ^ y row (lane + 32 j)) over the stage's words.
struct Hamming {
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
    for (int c = 0; c < BK / 4; ++c) {
      uint4 b[PTN];
      const int yc = (c ^ (lane & 7)) << 4;
#pragma unroll
      for (int j = 0; j < PTN; ++j)
        b[j] = *reinterpret_cast<const uint4*>(yl + 32 * 128 * j + yc);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const uint4 a = *reinterpret_cast<const uint4*>(
            xw + i * 128 + ((c ^ (i & 7)) << 4));
#pragma unroll
        for (int j = 0; j < PTN; ++j) {
          const int v = __popc(a.x ^ b[j].x) + __popc(a.y ^ b[j].y) +
                        __popc(a.z ^ b[j].z) + __popc(a.w ^ b[j].w);
          acc[i][j] = __int_as_float(__float_as_int(acc[i][j]) + v);
        }
      }
    }
  }
};

}  // namespace hampipe
