// The fp32 L2 distance of a pair from its product and its rows' squared
// norms: the one expression that every L2 kernel of the port applies
// (l2_pipe.cuh's core under nng_tile.cu, nng_tile_grouped.cu,
// nng_tile_ghost.cu, pairwise_sqdist.cu, eps_count.cu and
// tree_frontier.cu; l2_chain.cu, the plain anchor they are held to), so
// that a pair's d2 from the same product and norm chains is the same bit
// pattern in all of them. IEEE fp32 on the CUDA cores (no TF32, no tensor
// cores).
#pragma once

#include <cuda_runtime.h>

namespace l2tile {

// the fp32 expansion (|x|^2 + |y|^2) - 2 <x, y>; 2 <x, y> is exact, so a
// contracted FMA gives the same value as the two separate operations
__device__ __forceinline__ float d2(float xn, float yn, float dot) {
  return (xn + yn) - 2.0f * dot;
}

}  // namespace l2tile
