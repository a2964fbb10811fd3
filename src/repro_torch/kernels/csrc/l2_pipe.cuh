// The pipelined fp32 L2 product core of nng_tile.cu, eps_count.cu,
// pairwise_sqdist.cu, nng_tile_grouped.cu, nng_tile_ghost.cu and
// tree_frontier.cu, and the walk
// and staging that l1_pipe.cuh's L1 body (tree_frontier_l1.cu,
// nng_tile_ghost_l1.cu) and hamming_pipe.cuh's Hamming body
// (tree_frontier_hamming.cu) share.
//
// The per-pair arithmetic is a contract, which l2_chain.cu (a plain fp32
// kernel, a thread a pair) also keeps, so a pair's d2 here is
// bit-identical to that anchor's, and the tests and chip_smoke.py hold
// every kernel on this core to it:
//   - each pair's product is one fmaf chain over k = 0, 1, ..., d - 1 in
//     ascending order from 0.f (no split-K, no second accumulator);
//   - each row norm is one fmaf(v, v, .) chain in the same order;
//   - d2 is l2tile::d2 (l2_tile.cuh), (xn + yn) - 2 dot;
//   - IEEE fp32 on the CUDA cores: no TF32, no tensor cores.
// Features past d load as 0 and add exactly 0 to every chain (a chain from
// +0.f never holds -0, and fmaf(0, 0, acc) leaves any other acc as it is).
//
// What is redesigned is the staging, the pipelining, the register tile and
// the grid (each measured on an H100; PERF.md has the numbers):
//   - a 64 x 256 tile a 128-thread block, two blocks an SM: a thread keeps
//     16 rows x 8 columns (lane l: columns l + 32 j), so a shared x value
//     (a broadcast load, one shared-memory cycle) feeds 8 FMAs and a y
//     value (a per-lane load, four cycles a warp) 16; the two blocks of an
//     SM run out of step, so one's epilogue overlaps the other's FMAs;
//   - a persistent grid: as many blocks as fit on the card at once (the
//     occupancy times the SM count), each walking tiles t = blockIdx.x,
//     + gridDim.x, ... of the output row after row, or of a list of tile
//     indices in the same numbering whose length the block reads from
//     device memory (a launch whose live tiles are found on the card, with
//     no host sync: the grouped tiles (nng_tile_grouped.cu), the ghost
//     tiles (ghost_pipe.cuh) and the tree frontiers (frontier_pipe.cuh);
//     blocks past the count exit);
//   - the block's (tile, 32-feature chunk) pairs form one stream, loaded
//     STAGES - 1 chunks ahead into a ring of stages in dynamic shared
//     memory, so the next tile's first chunk loads while this tile ends
//     and runs its epilogue; one barrier a chunk;
//   - the loads are TMA box copies (one thread, an mbarrier a stage) where
//     d % 4 == 0 and x and y are 16-byte aligned, else 4-byte cp.async
//     copies (a row slice of an odd-width matrix); both zero-fill past q, p
//     and d, and both write the same layout: 128-byte stage rows [row][32]
//     with the 128-byte swizzle (16-byte chunk c of row r at c ^ (r & 7)),
//     so a warp's float4 reads along k hit 32 banks once;
//   - the row norms are summed once, by row_norms_kernel before the tiles
//     (the same chain), and each tile's arrive with its first chunk; a y
//     row that is not valid gets a NaN norm, so its d2 never passes.
// The epilogue's layout is tile_io.cuh's: warp w owns rows [16w, 16w + 16)
// of the tile and lane l columns l + 32 j, so a __ballot_sync over the warp
// packs 32 consecutive columns of one row into a word. The epilogue stores
// where it likes: a kernel whose x is a gathered copy x[rows] (contiguous
// and 16-byte aligned, so the TMA path applies) stores tile row i's
// results at row rows[i] of its output.
#pragma once

#include <cuda.h>

#include "l2_tile.cuh"
#include "tile_io.cuh"

namespace l2pipe {

using namespace tile;

constexpr int PTHREADS = 128;      // 4 warps a block, 2 blocks an SM
constexpr int PM = PTHREADS / 32 * TM;   // 64 query rows a tile
constexpr int PN = 2 * BN;         // 256 candidate columns a tile: two of
constexpr int PTN = 2 * TN;        // tile_io's column blocks, 8 a lane
constexpr int BK = 32;             // features a stage: one 128-byte row
constexpr int STAGES = 2;          // stages in the ring (1 chunk ahead)

struct Stage {
  float x[PM][BK];
  float y[PN][BK];
};
constexpr int STAGE_BYTES = sizeof(Stage);

// A tile's squared row norms, loaded with its first chunk.
struct Norms {
  float x[PM];
  float y[PN];
};

// the ring (1024-byte aligned for the swizzle), two tiles' norms (this
// tile's and the next's), one mbarrier a stage, and room to align the base
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * sizeof(Norms) +
                           STAGES * 8 + 1024;

static_assert(BK * 4 == 128, "a stage row is one 128-byte swizzle row");
static_assert(sizeof(Stage) % 1024 == 0 && PM * BK * 4 % 1024 == 0,
              "stages and their y halves stay 1024-byte aligned");

// Byte offset of float4 chunk c (features 4c..4c+3) of stage row r.
__device__ __forceinline__ int swz(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A TMA copy of the box at element c0 of 1-d tensor map `map` into shared
// memory at dst, completing on mbarrier bar.
__device__ __forceinline__ void tma_load1(unsigned dst, const CUtensorMap* map,
                                          int c0, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2}], [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(bar)
      : "memory");
}

// A TMA copy of the box at (feature k0, row r0) of tensor map `map` into
// shared memory at dst, completing on mbarrier bar.
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map,
                                         int k0, int r0, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(r0), "r"(bar)
      : "memory");
}

// The first row and column of tile t of an output nt tiles (of PM x PN)
// wide, row after row: the blocks running at once walk along a row of
// tiles, sharing its x panel, and the y tiles they read come from L2.
__device__ __forceinline__ void tile_origin(long long t, int nt, int& m0,
                                            int& n0) {
  m0 = static_cast<int>(t / nt) * PM;
  n0 = static_cast<int>(t % nt) * PN;
}

// 4-byte copies of features [k0, k0 + BK) of rows [r0, r0 + ROWS) of an
// (n, d) matrix into swizzled stage rows at dst (zeros past n and d). Rows
// are 64-bit offsets: n·d may pass 2^31.
template <int ROWS>
__device__ __forceinline__ void copy_rows4(unsigned dst,
                                           const float* __restrict__ src,
                                           int n, int d, int r0, int k0) {
  constexpr int STEP = PTHREADS / BK;           // rows a pass
  static_assert(ROWS % STEP == 0, "the copy loop covers the rows");
  const int k = threadIdx.x % BK;
  const bool kin = k0 + k < d;
#pragma unroll 4
  for (int i = 0; i < ROWS / STEP; ++i) {
    const int r = threadIdx.x / BK + STEP * i;
    const bool in = kin && r0 + r < n;
    cp_async4(dst + swz(r, k >> 2) + (k & 3) * 4,
              in ? src + (size_t)(r0 + r) * d + k0 + k : src, in);
  }
}

// 4-byte copies of elements [r0, r0 + N) of an n-vector into shared
// memory at dst (zeros past n).
template <int N>
__device__ __forceinline__ void copy_vec4(unsigned dst,
                                          const float* __restrict__ src,
                                          int n, int r0) {
  for (int r = threadIdx.x; r < N; r += PTHREADS) {
    const bool in = r0 + r < n;
    cp_async4(dst + 4 * r, in ? src + r0 + r : src, in);
  }
}

// The squared norm of each row of a (n, d) matrix: one fmaf(v, v, .) chain
// over k = 0, 1, ..., d - 1 from 0.f, a thread a row (4-byte loads: any
// alignment). The norms of x and y are computed once here, not in every
// tile that stages their rows. A row whose `valid` flag is 0 (valid may be
// null: all rows valid) gets a NaN norm instead: every d2 with it is NaN,
// and NaN <= eps2 never holds, so the tiles need not read the flags.
__global__ void __launch_bounds__(256)
row_norms_kernel(const float* __restrict__ a, int n, int d,
                 const int32_t* __restrict__ valid, float* __restrict__ out) {
  for (long long r = blockIdx.x * 256LL + threadIdx.x; r < n;
       r += 256LL * gridDim.x) {
    const float* row = a + r * d;
    float norm = 0.f;
    for (int k = 0; k < d; ++k) norm = fmaf(row[k], row[k], norm);
    out[r] = valid != nullptr && valid[r] == 0 ? __int_as_float(0x7fc00000)
                                               : norm;
  }
}

// One staged chunk: acc[i][j] += x row (16 warp + i) . y row (lane + 32 j),
// feature by feature in ascending order.
__device__ __forceinline__ void chunk_products(const Stage& s,
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
    float4 b[PTN];
    const int yc = (c ^ (lane & 7)) << 4;
#pragma unroll
    for (int j = 0; j < PTN; ++j)
      b[j] = *reinterpret_cast<const float4*>(yl + 32 * 128 * j + yc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(
          xw + i * 128 + ((c ^ (i & 7)) << 4));
#pragma unroll
      for (int j = 0; j < PTN; ++j) {
        acc[i][j] = fmaf(a.x, b[j].x, acc[i][j]);
        acc[i][j] = fmaf(a.y, b[j].y, acc[i][j]);
        acc[i][j] = fmaf(a.z, b[j].z, acc[i][j]);
        acc[i][j] = fmaf(a.w, b[j].w, acc[i][j]);
      }
    }
  }
}

// The walk's per-chunk body (a template parameter of run): the L2 core's
// products, with the rows' squared norms staged beside each tile's first
// chunk. l1_pipe.cuh's body sums L1 distances and stages no norms.
struct Dot {
  static constexpr bool NORMS = true;
  __device__ __forceinline__ static void chunk(const Stage& s,
                                               float (&acc)[TM][PTN]) {
    chunk_products(s, acc);
  }
};

// The four tensor maps of a TMA launch: x and y in BK x PM and BK x PN
// boxes, their norms in PM and PN boxes.
struct Maps {
  CUtensorMap x, y, xn, yn;
};

// The block's walk. For every PM x PN tile it owns, in order, calls
// epi(m0, n0, acc, xnorm, ynorm) with acc[i][j] = <x row m0 + 16 warp + i,
// y row n0 + lane + 32 j> (j < PTN) and the tile's rows' squared norms
// (row_norms_kernel's xn and yn) in shared memory. TMA copies through the
// tensor maps if TMA, else 4-byte copies from x, y, xn and yn. Must be
// launched with PTHREADS threads and SMEM_BYTES of dynamic shared memory;
// every thread of the block calls it. Body::chunk sums each staged chunk
// into acc (Dot: the products above); without Body::NORMS no norms are
// staged (xn, yn and their maps are not read, and epi's xnorm and ynorm
// hold nothing).
//
// The tiles: without LIST, every tile of the (q, p) output, numbered row
// after row (t = (m0 / PM) * nt + n0 / PN); with LIST, entries
// 0 .. *count - 1 of the int32 tile list `list` in that numbering (the
// walk then skips the tiles the list leaves out; both pointers are read on
// the device). The implicit walk compiles to the same code as before the
// list existed: LIST is a template parameter.
template <bool TMA, bool LIST = false, class Body = Dot, class Epi>
__device__ __forceinline__ void run(const Maps& maps,
                                    const float* __restrict__ x,
                                    const float* __restrict__ y,
                                    const float* __restrict__ xn,
                                    const float* __restrict__ yn, int q,
                                    int p, int d, Epi&& epi,
                                    const int32_t* __restrict__ list =
                                        nullptr,
                                    const int32_t* __restrict__ count =
                                        nullptr) {
  extern __shared__ unsigned char smem_raw[];
  // offset from the array itself, so that the compiler keeps these
  // pointers in shared memory (LDS, not generic loads)
  unsigned char* base =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  Stage* ring = reinterpret_cast<Stage*>(base);
  Norms* norms = reinterpret_cast<Norms*>(base + STAGES * STAGE_BYTES);
  const unsigned bar0 = smem_addr(norms + 2);         // 8 bytes a stage
  const int tid = threadIdx.x;
  const int mt = (q + PM - 1) / PM;
  const int nt = (p + PN - 1) / PN;
  const int nk = (d + BK - 1) / BK;
  const long long tiles =
      LIST ? static_cast<long long>(*count) : static_cast<long long>(mt) * nt;
  const long long step = gridDim.x;
  // walk entry t -> its tile's first row and column
  auto origin = [&](long long t, int& m0, int& n0) {
    tile_origin(LIST ? static_cast<long long>(list[t]) : t, nt, m0, n0);
  };

  if (TMA) {
    if (tid == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(bar0 + 8 * s);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
  }

  // the copy side of the stream: the next (tile, chunk) to load; a
  // tile's first chunk also brings its norms, into norms[tile parity]
  long long pt = blockIdx.x;
  int pk = 0, pm0 = 0, pn0 = 0, ptile = 0;
  if (pt < tiles) origin(pt, pm0, pn0);
  auto issue = [&](int slot) {
    if (pt < tiles) {
      const unsigned dst = smem_addr(&ring[slot]);
      const unsigned ndst = smem_addr(&norms[ptile & 1]);
      if (TMA) {
        if (tid == 0) {
          const unsigned bar = bar0 + 8 * slot;
          // the block's generic reads of the slot before the async writes
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          if (Body::NORMS)
            mbar_expect(bar, STAGE_BYTES + (pk == 0 ? sizeof(Norms) : 0));
          else
            mbar_expect(bar, STAGE_BYTES);
          tma_load(dst, &maps.x, pk * BK, pm0, bar);
          tma_load(dst + PM * BK * 4, &maps.y, pk * BK, pn0, bar);
          if (Body::NORMS && pk == 0) {
            tma_load1(ndst, &maps.xn, pm0, bar);
            tma_load1(ndst + PM * 4, &maps.yn, pn0, bar);
          }
        }
      } else {
        copy_rows4<PM>(dst, x, q, d, pm0, pk * BK);
        copy_rows4<PN>(dst + PM * BK * 4, y, p, d, pn0, pk * BK);
        if (Body::NORMS && pk == 0) {
          copy_vec4<PM>(ndst, xn, q, pm0);
          copy_vec4<PN>(ndst + PM * 4, yn, p, pn0);
        }
      }
      if (++pk == nk) {
        pk = 0;
        ++ptile;
        pt += step;
        if (pt < tiles) origin(pt, pm0, pn0);
      }
    }
    if (!TMA) cp_async_commit();   // an empty group past the end
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);

  // the math side: the (tile, chunk) being summed
  long long ct = blockIdx.x;
  int ck = 0, cm0 = 0, cn0 = 0;
  if (ct < tiles) origin(ct, cm0, cn0);
  float acc[TM][PTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < PTN; ++j) acc[i][j] = 0.f;
  int slot = 0, ctile = 0;
  unsigned phase = 0;              // parity of the ring's current lap
  while (ct < tiles) {
    // chunk `slot` has landed, and every thread is done with the slot the
    // next copy overwrites (the previous chunk's)
    if (TMA) {
      mbar_wait(bar0 + 8 * slot, phase);
    } else {
      cp_async_wait<STAGES - 2>();
    }
    __syncthreads();
    issue(slot == 0 ? STAGES - 1 : slot - 1);
    Body::chunk(ring[slot], acc);
    if (++slot == STAGES) {
      slot = 0;
      phase ^= 1u;
    }
    if (++ck == nk) {
      // the norms came with the tile's first chunk, which every thread
      // has seen land
      const Norms& tn = norms[ctile++ & 1];
      epi(cm0, cn0, acc, tn.x, tn.y);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < PTN; ++j) acc[i][j] = 0.f;
      ck = 0;
      ct += step;
      if (ct < tiles) origin(ct, cm0, cn0);
    }
  }
  if (!TMA) cp_async_wait<0>();
}

// Whether the TMA copies apply: a 16-byte aligned base and row pitch.
inline bool tma_ok(const void* x, const void* y, int d) {
  return d % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(y) % 16 == 0;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled for a rank-`rank` fp32 map (dims and box
// innermost first), zero-filled out of bounds. Returns a CUDA error code
// (0 on success).
inline int encode_map(CUtensorMap* map, const void* ptr, int rank,
                      const cuuint64_t* dims, const cuuint64_t* pitch,
                      const cuuint32_t* box, CUtensorMapSwizzle swizzle) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    void* fn = nullptr;
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      cudaGetLastError();
      return static_cast<int>(e != cudaSuccess ? e
                                               : cudaErrorSymbolNotFound);
    }
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(ptr),
      dims, pitch, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The map of an (n, d) matrix in boxes of BK features x `rows` rows,
// 128-byte swizzled (the stage layout).
inline int matrix_map(CUtensorMap* map, const void* ptr, int n, int d,
                      int rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(d) * 4};
  const cuuint32_t box[2] = {BK, static_cast<cuuint32_t>(rows)};
  return encode_map(map, ptr, 2, dims, pitch, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// The map of an n-vector in boxes of `len` elements.
inline int vector_map(CUtensorMap* map, const void* ptr, int n, int len) {
  const cuuint64_t dims[1] = {static_cast<cuuint64_t>(n)};
  const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(n) * 4};  // unread
  const cuuint32_t box[1] = {static_cast<cuuint32_t>(len)};
  return encode_map(map, ptr, 1, dims, pitch, box,
                    CU_TENSOR_MAP_SWIZZLE_NONE);
}

// Opt `kernel` in to SMEM_BYTES of dynamic shared memory and size its
// persistent grid: the blocks resident at once on `sms` SMs, at most one a
// tile. Returns a CUDA error code (0 on success; the error is also cleared
// so that the next launch's cudaGetLastError() does not report it).
template <class Kernel>
inline int persistent_grid(Kernel kernel, int q, int p, int sms,
                           int& blocks) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      PTHREADS, SMEM_BYTES);
  if (e == cudaSuccess && (per_sm < 1 || sms < 1))
    e = cudaErrorInvalidConfiguration;
  if (e != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(e);
  }
  const long long tiles = static_cast<long long>((q + PM - 1) / PM) *
                          ((p + PN - 1) / PN);
  const long long resident = static_cast<long long>(per_sm) * sms;
  blocks = static_cast<int>(tiles < resident ? tiles : resident);
  return 0;
}

// Everything a launch of `kernel` needs, on `stream`: the rows' norms
// into xn (q,) and yn (p,) (row_norms_kernel; NaN for a y row whose
// y_valid flag is 0, if y_valid is not null; none if xn is null: a body
// without NORMS), the tensor maps if the TMA path applies (tma), the grid
// size and the kernel's shared-memory opt-in. Returns a CUDA error code
// (0 on success).
template <class Kernel>
inline int prepare(Kernel kernel, bool tma, const void* x, const void* y,
                   const void* y_valid, void* xn, void* yn, int q, int p,
                   int d, int sms, cudaStream_t stream, Maps& maps,
                   int& blocks) {
  int e = 0;
  if (tma) {
    e = matrix_map(&maps.x, x, q, d, PM);
    if (e == 0) e = matrix_map(&maps.y, y, p, d, PN);
    if (e == 0 && xn != nullptr) e = vector_map(&maps.xn, xn, q, PM);
    if (e == 0 && xn != nullptr) e = vector_map(&maps.yn, yn, p, PN);
    if (e != 0) return e;
  }
  e = persistent_grid(kernel, q, p, sms, blocks);
  if (e != 0 || xn == nullptr) return e;
  const int grid = (q > p ? q : p) / 256 + 1;
  row_norms_kernel<<<grid < 4 * sms ? grid : 4 * sms, 256, 0, stream>>>(
      static_cast<const float*>(x), q, d, nullptr, static_cast<float*>(xn));
  row_norms_kernel<<<grid < 4 * sms ? grid : 4 * sms, 256, 0, stream>>>(
      static_cast<const float*>(y), p, d,
      static_cast<const int32_t*>(y_valid), static_cast<float*>(yn));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace l2pipe
