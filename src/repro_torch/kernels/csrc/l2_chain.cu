// The plain fp32 chain anchor of the L2 cores: every pair's d2, computed
// as plainly as possible under the per-pair contract that l2_pipe.cuh's
// core keeps.
//
// A test and smoke anchor, not a port: it replaces no TPU kernel, and no
// engine or public call runs it. The tests and chip_smoke.py hold the
// kernels on l2_pipe.cuh (nng_tile, nng_tile_grouped, pairwise_sqdist,
// eps_count) to its d2, bit for bit, at an eps on a pair's fp32 d2. It
// shares no staging, walk or epilogue code with them: only l2tile::d2.
//
// Computes, for x (q, d) and y (p, d) fp32:
//   xn[i]    = one fmaf(v, v, .) chain over x_i's features k = 0 .. d - 1,
//              ascending, from 0.f (yn[j] the same over y_j);
//   dot      = one fmaf chain over k = 0 .. d - 1, ascending, from 0.f;
//   out[i][j] = l2tile::d2(xn[i], yn[j], dot) = (xn + yn) - 2 dot   (q, p)
// in IEEE fp32 on the CUDA cores (no TF32, no tensor cores, no clamp).
//
// The design is the textbook one: a 16 x 16 block of threads, one pair a
// thread; 16 features of the block's 16 x rows and 16 y rows staged in
// shared memory a chunk, each thread's chain running on through the
// chunks in ascending k and stopping at d (no padded features). A
// separate kernel sums each row's norm, a thread a row.
#include "l2_tile.cuh"

namespace {

constexpr int T = 16;                    // pairs a block side, features a chunk
constexpr int ROWS_PER_LAUNCH = 65535 * T;   // the grid's y limit

__global__ void __launch_bounds__(256)
chain_norms_kernel(const float* __restrict__ a, int n, int d,
                   float* __restrict__ out) {
  const long long r = blockIdx.x * 256LL + threadIdx.x;
  if (r >= n) return;
  const float* row = a + r * d;
  float s = 0.f;
  for (int k = 0; k < d; ++k) s = fmaf(row[k], row[k], s);
  out[r] = s;
}

__global__ void __launch_bounds__(T * T)
chain_d2_kernel(const float* __restrict__ x, const float* __restrict__ y,
                const float* __restrict__ xn, const float* __restrict__ yn,
                float* __restrict__ out, int q, int p, int d) {
  __shared__ float xs[T][T + 1];         // [row][feature]; padded against
  __shared__ float ys[T][T + 1];         // bank conflicts on ys[tx][kk]
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int i = blockIdx.y * T + ty;     // this thread's x row
  const int j = blockIdx.x * T + tx;     // and y row
  const int yr = blockIdx.x * T + ty;    // the y row this thread stages
  float dot = 0.f;
  for (int k0 = 0; k0 < d; k0 += T) {
    const int k = k0 + tx;
    xs[ty][tx] = i < q && k < d ? x[(size_t)i * d + k] : 0.f;
    ys[ty][tx] = yr < p && k < d ? y[(size_t)yr * d + k] : 0.f;
    __syncthreads();
    const int kn = d - k0 < T ? d - k0 : T;
    for (int kk = 0; kk < kn; ++kk) dot = fmaf(xs[ty][kk], ys[tx][kk], dot);
    __syncthreads();
  }
  if (i < q && j < p) out[(size_t)i * p + j] = l2tile::d2(xn[i], yn[j], dot);
}

}  // namespace

// out is (q, p) fp32, every element stored; xn (q,) and yn (p,) are fp32
// scratch for the rows' norms (written here first). Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int l2_chain_launch(const void* x, const void* y, void* out,
                               void* xn, void* yn, int q, int p, int d,
                               void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* xf = static_cast<const float*>(x);
  const auto* yf = static_cast<const float*>(y);
  auto* xnf = static_cast<float*>(xn);
  auto* ynf = static_cast<float*>(yn);
  chain_norms_kernel<<<(q + 255) / 256, 256, 0, st>>>(xf, q, d, xnf);
  chain_norms_kernel<<<(p + 255) / 256, 256, 0, st>>>(yf, p, d, ynf);
  for (int r0 = 0; r0 < q; r0 += ROWS_PER_LAUNCH) {
    const int rows = q - r0 < ROWS_PER_LAUNCH ? q - r0 : ROWS_PER_LAUNCH;
    chain_d2_kernel<<<dim3((p + T - 1) / T, (rows + T - 1) / T),
                      dim3(T, T), 0, st>>>(
        xf + (size_t)r0 * d, yf, xnf + r0, ynf,
        static_cast<float*>(out) + (size_t)r0 * p, rows, p, d);
  }
  return static_cast<int>(cudaGetLastError());
}
