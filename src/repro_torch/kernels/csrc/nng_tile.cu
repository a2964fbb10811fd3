// Fused fp32 L2 ε-tile: distances, threshold and bit-packed adjacency.
//
// Replaces: nng_tile_pallas (src/repro/kernels/nng_tile.py), the TPU kernel
// that the systolic ring runs twice per evaluated round.
//
// Computes, for x (q, d), y (p, d) fp32 and y_valid (p,) int32:
//   d2[i][j] = (|x_i|^2 + |y_j|^2) - 2 * <x_i, y_j>
//   hit      = d2 <= eps2 && y_valid[j] != 0 && j < p
//   bits[i][j / 32] bit (j % 32) = hit,   cnt[i] += popcount of row i's words.
//
// What bounds it on an H100: operations. A (q, p, d) tile does 2·q·p·d fp32
// flops but moves only (q + p)·d·4 bytes in and q·p/8 bytes of bits out, so
// at d = 128 it sits far above the card's flop/byte line. The arithmetic
// must be IEEE fp32 (no TF32, no tensor cores), so the ceiling is the CUDA
// cores' fp32 FMA rate.
//
// What the simple design does about it: each 256-thread block owns a
// 128 x 128 output tile and stages x and y through shared memory in chunks
// of 16 features (transposed, padded rows against bank conflicts). Warp w
// owns rows [16w, 16w + 16) and lane l owns columns l, l + 32, l + 64,
// l + 96, so each thread keeps a 16 x 4 register tile of fp32 FMAs and
// reads its 16 x values as broadcast float4 loads. The row norms are summed
// in the same pass over the staged chunks. In the epilogue the 32 lanes of
// a warp hold 32 consecutive columns of one row, so __ballot_sync packs the
// word directly. Blocks run in no order, so each block adds its rows'
// popcounts to cnt with one atomicAdd per row (cnt starts at zero). Ragged
// q, p and d are masked in the kernel: out-of-range features load as 0,
// which adds exactly 0 to every sum, and out-of-range columns never hit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;            // query rows per block
constexpr int BN = 128;            // candidate columns per block (4 words)
constexpr int BK = 16;             // features staged per chunk
constexpr int THREADS = 256;       // 8 warps
constexpr int TM = BM / (THREADS / 32);   // 16 rows per warp
constexpr int TN = BN / 32;        // 4 columns per lane
constexpr int LDT = BM + 4;        // padded row of the transposed tiles

static_assert(BM + BN == THREADS, "one thread sums each staged row's norm");
static_assert(BM * BK % THREADS == 0, "staging loop covers the chunk");

__global__ void __launch_bounds__(THREADS, 2)
nng_tile_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const int32_t* __restrict__ y_valid,
                int32_t* __restrict__ cnt, uint32_t* __restrict__ bits,
                int q, int p, int d, int nw, float eps2) {
  __shared__ __align__(16) float xt[BK][LDT];
  __shared__ __align__(16) float yt[BK][LDT];
  __shared__ float xnorm[BM];
  __shared__ float ynorm[BN];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  // threads [0, BM) sum x row m0 + tid, threads [BM, 2 BM) y row n0 + tid - BM
  float norm = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int i = 0; i < BM * BK / THREADS; ++i) {
      const int e = tid + THREADS * i;
      const int r = e / BK;
      const int kk = e % BK;
      const int gk = k0 + kk;
      const int gm = m0 + r;
      const int gn = n0 + r;
      xt[kk][r] = (gm < q && gk < d) ? x[(size_t)gm * d + gk] : 0.f;
      yt[kk][r] = (gn < p && gk < d) ? y[(size_t)gn * d + gk] : 0.f;
    }
    __syncthreads();

    {
      const float* col = tid < BM ? &xt[0][tid] : &yt[0][tid - BM];
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float v = col[kk * LDT];
        norm = fmaf(v, v, norm);
      }
    }

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
      float b[TN];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v =
            *reinterpret_cast<const float4*>(&xt[kk][warp * TM + i]);
        a[i] = v.x;
        a[i + 1] = v.y;
        a[i + 2] = v.z;
        a[i + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = yt[kk][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (tid < BM) {
    xnorm[tid] = norm;
  } else {
    ynorm[tid - BM] = norm;
  }
  __syncthreads();

  float yn[TN];
  bool yok[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = n0 + lane + 32 * j;
    yn[j] = ynorm[lane + 32 * j];
    yok[j] = col < p && y_valid[col] != 0;
  }
  const int w0 = n0 >> 5;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + warp * TM + i;
    const float xn = xnorm[warp * TM + i];
    int rc = 0;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const float d2 = (xn + yn[j]) - 2.0f * acc[i][j];
      const unsigned word = __ballot_sync(0xffffffffu, yok[j] && d2 <= eps2);
      if (lane == j && row < q && w0 + j < nw)
        bits[(size_t)row * nw + w0 + j] = word;
      rc += __popc(word);
    }
    if (lane == 0 && row < q && rc != 0) atomicAdd(&cnt[row], rc);
  }
}

}  // namespace

// cnt (q,) must be zero on entry; bits is (q, nw) with nw = ceil(p / 32).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int nng_tile_launch(const void* x, const void* y,
                               const void* y_valid, void* cnt, void* bits,
                               int q, int p, int d, float eps2,
                               void* stream) {
  const int nw = (p + 31) / 32;
  const dim3 grid((p + BN - 1) / BN, (q + BM - 1) / BM);
  nng_tile_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const int32_t*>(y_valid), static_cast<int32_t*>(cnt),
      static_cast<uint32_t*>(bits), q, p, d, nw, eps2);
  return static_cast<int>(cudaGetLastError());
}
