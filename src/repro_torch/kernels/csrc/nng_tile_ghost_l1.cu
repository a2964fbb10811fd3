// Ghost fp32 L1 (Manhattan) ε-tile: the landmark engine's ghost-ring tile.
//
// Replaces: nng_tile_ghost_l1_pallas (src/repro/kernels/nng_tile.py), the
// TPU kernel that the landmark engine's ghost ring runs for
// metric="manhattan".
//
// Computes, for x (q, d), y (p, d) fp32, x ghost words gb (q, mw) and y
// cells yg (p,) int32:
//   d[i][j] = sum of |x_i - y_j| in l1_tile.cuh's order (chunks of 8)
//   hit     = d <= eps && yg[j] >= 0 && bit yg[j] of gb[i] is set
//                                                 (eps rounded to fp32)
//   bits[i][j / 32] bit (j % 32) = hit,   cnt[i] += popcount of row i's words.
//
// What bounds it on an H100: operations, 2 fp32 instructions a feature for
// each pair the function needs (a row against a column of one of its ghost
// cells: on the ring's launches a small share of all pairs) against the
// CUDA cores' issue rate. What a launch costs is the pairs of the tiles it
// computes: in the caller's row order a 128 x 128 block holds rows of many
// ghost cells, so the live blocks held about 9.5x the needed pairs.
//
// What the design does about it: nng_tile_ghost.cu's, with l1_pipe.cuh's
// body. The wrapper (kernels/nng_tile.py, ghost_launch) orders the rows by
// their ghost cells among y's (ghost_row_order), gathers x in that order
// and lists the live 64 x 256 tiles on the card (ghost_tile_plan, no host
// sync); ghost_pipe.cuh's kernel walks the listed live tiles on
// l2_pipe.cuh's persistent grid and TMA-fed ring (4-byte copies where
// d % 4 != 0), sums each pair's d in l1_tile.cuh's order bit for bit
// (l1pipe::L1: no norms), and stores in the caller's row order. So the
// kernel equals the plain version on every input, and nng_tile_l1's d on
// every pair.
#include "ghost_pipe.cuh"

// x (q, d) is the visiting rows in key order (x[rows]); keys, yg, rows,
// tiles, ntiles, cnt and bits are as nng_tile_ghost_launch's (cnt and bits
// zero on entry, indexed in the caller's order); there is no norm
// scratch. sms is the device's SM count. Launches on `stream` and returns
// a CUDA error code: the tensor maps', shared-memory opt-in's or occupancy
// query's, else cudaGetLastError() of the launch (0 on success).
extern "C" int nng_tile_ghost_l1_launch(const void* x, const void* y,
                                        const void* keys, const void* yg,
                                        const void* rows, const void* tiles,
                                        const void* ntiles, void* cnt,
                                        void* bits, int q, int p, int d,
                                        int mw, float eps, int sms,
                                        void* stream) {
  return gpipe::ghost_launch<l1pipe::L1>(
      x, y, keys, yg, rows, tiles, ntiles, cnt, bits, nullptr, nullptr, q, p,
      d, mw, eps, sms, static_cast<cudaStream_t>(stream));
}
