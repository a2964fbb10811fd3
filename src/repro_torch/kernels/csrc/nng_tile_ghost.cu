// Ghost fp32 L2 ε-tile: the landmark engine's ghost-ring tile.
//
// Replaces: nng_tile_ghost_pallas (src/repro/kernels/nng_tile.py, its
// pallas_call at :647), the TPU kernel that the landmark engine's ghost
// ring (ghost_mode="ring", Algorithms 5+6) runs for each visiting block
// against the local cells.
//
// Computes, for x (q, d), y (p, d) fp32, x ghost words gb (q, mw) (bit c of
// word c / 32: row i is a Lemma-1 ghost of cell c) and y cells yg (p,)
// int32:
//   d2[i][j] = (|x_i|^2 + |y_j|^2) - 2 * <x_i, y_j>
//   hit      = d2 <= eps2 && yg[j] >= 0 && bit yg[j] of gb[i] is set
//   bits[i][j / 32] bit (j % 32) = hit,   cnt[i] += popcount of row i's words.
// A row's own cell bit is never set, so no id test is needed.
//
// What bounds it on an H100: operations, over the pairs the function needs
// (a row against a column of one of its ghost cells: on the ring's launches
// about a tenth of all pairs); what a launch costs is the pairs of the
// tiles it computes. The arithmetic is IEEE fp32 on the CUDA cores, so the
// ceiling is their fp32 FMA rate.
//
// What the design does about it. The wrapper (kernels/nng_tile.py,
// nng_tile_ghost_cuda), on the card with no host sync: each row's key is
// its ghost words restricted to the cells of y (this launch's local
// cells); the rows are ordered by key (equal keys together, zero keys
// last) and x gathered in that order; the 64 x 256 tiles where some
// row's key has a bit in the tile's [min, max] y-cell range are listed,
// the live ones first, their count a device scalar; cnt and bits are
// zeroed. Callers sort y by cell, so a live tile's rows mostly want its
// columns. Here: ghost_pipe.cuh's kernel with l2_pipe.cuh's Dot body
// (persistent grid, TMA-fed ring, 16 x 8 register tiles, row norms summed
// once) walks the live tiles only, and its epilogue tests each pair's cell
// bit against its row's key (one register when mw == 1) before
// tile_io.cuh's __ballot_sync packing, and stores each word and count at
// the row's place in the caller's order (rows[i]). Dead tiles store
// nothing: their words stay zero. The per-pair arithmetic is l2_chain.cu's,
// bit for bit. The engine's tiles_scheduled /
// tiles_skipped counters come from ops.ghost_block_active at the
// reference's own tile geometry and row order, not from this launch.
#include "ghost_pipe.cuh"

// x (q, d) is the visiting rows in key order (x[rows]); keys (q, mw) their
// keys in the same order; rows (q,) int32 each one's row in the caller's
// order, where cnt (q,) and bits (q, nw), nw = ceil(p / 32), are indexed
// and must be zero on entry. tiles is the list of 64 x 256 tile indices
// (row after row over the (q, p) output), the live ones first, and
// ntiles a one-element int32 device count of them. xsq (q,) and ysq (p,)
// are 16-byte aligned fp32 scratch for the rows' norms (written here
// first); sms is the device's SM count. Launches on `stream` and returns
// a CUDA error code: the tensor maps', shared-memory opt-in's or occupancy
// query's, else cudaGetLastError() of the launches (0 on success).
extern "C" int nng_tile_ghost_launch(const void* x, const void* y,
                                     const void* keys, const void* yg,
                                     const void* rows, const void* tiles,
                                     const void* ntiles, void* cnt,
                                     void* bits, void* xsq, void* ysq, int q,
                                     int p, int d, int mw, float eps2,
                                     int sms, void* stream) {
  return gpipe::ghost_launch<l2pipe::Dot>(
      x, y, keys, yg, rows, tiles, ntiles, cnt, bits, xsq, ysq, q, p, d, mw,
      eps2, sms, static_cast<cudaStream_t>(stream));
}
