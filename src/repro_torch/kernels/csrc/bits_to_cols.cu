// Bitmask epilogue: each row's k lowest set columns, ascending.
//
// Replaces: bits_to_cols_pallas (src/repro/kernels/bits_epilogue.py), the
// TPU kernel that turns every ring tile's packed hit words into neighbour
// column ids (through ops.bits_to_ids).
//
// Computes, for bits (m, w) uint32 words (column c is word c / 32, bit
// c % 32): out[i][s] = the s-th lowest set column of row i for s below the
// row's popcount, else NOCOL (2^30), for s in [0, k).
//
// What bounds it on an H100: bytes. It reads up to m·w·4 bytes of words and
// writes m·k·4 bytes of ids and does a handful of integer operations per
// word, so device memory bandwidth is the ceiling.
//
// What the simple design does about it: one warp per row walks the row's
// words 32 at a time, lane l reading word c0 + l, so each step is one
// coalesced 128-byte load. A lane's output slot is the count of set bits
// before its word: __popc of each word, then an inclusive warp scan with
// __shfl_up_sync plus the running base of earlier steps. Each lane then
// writes its word's set columns in ascending order while the slot is below
// k. The walk stops as soon as k slots are filled (the only reads a row
// needs), and the remaining slots are padded with NOCOL. The result is a
// deterministic function of the words: no sort and no atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;           // 8 rows per block
constexpr int32_t NOCOL = 1 << 30;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(THREADS)
bits_to_cols_kernel(const uint32_t* __restrict__ bits,
                    int32_t* __restrict__ out, int m, int w, int k) {
  const int row = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= m) return;                // whole warps leave together
  const uint32_t* words = bits + (size_t)row * w;
  int32_t* slots = out + (size_t)row * k;

  int base = 0;                        // set bits in the words already walked
  for (int c0 = 0; c0 < w && base < k; c0 += 32) {
    const int wi = c0 + lane;
    uint32_t word = wi < w ? words[wi] : 0u;
    const int pc = __popc(word);
    int inc = pc;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, inc, off);
      if (lane >= off) inc += v;
    }
    int slot = base + inc - pc;
    while (word != 0u && slot < k) {
      slots[slot++] = wi * 32 + (__ffs(word) - 1);
      word &= word - 1u;
    }
    base += __shfl_sync(FULL, inc, 31);
  }
  for (int s = min(base, k) + lane; s < k; s += 32) slots[s] = NOCOL;
}

}  // namespace

// out is (m, k). Launches on `stream` and returns cudaGetLastError().
extern "C" int bits_to_cols_launch(const void* bits, void* out, int m, int w,
                                   int k, void* stream) {
  const int blocks = (m + THREADS / 32 - 1) / (THREADS / 32);
  bits_to_cols_kernel<<<blocks, THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(bits), static_cast<int32_t*>(out), m, w,
      k);
  return static_cast<int>(cudaGetLastError());
}
