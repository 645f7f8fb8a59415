// K3: whiten + GLS F scan over pre-rotated SNP rows (Hopper).
//
// Replaces: mixmogam_tpu/ops/pallas_scan.py _scan_kernel / _scan_padded
// (pallas_scan_stats), and the exact tier's epilogue that the JAX main path
// runs in XLA (ops/scan.py scan_epilogue after the fp32 G @ W GEMM).
//
// Input Xr (m, n) f32 = rows of G @ U from a full-fp32 torch GEMM. Per
// row: Xs = Xr * sd, ss = sum Xs^2, xy = Xs . y_res, cc = Xs @ Q0 (q <= 16),
// then the epilogue of ops/scan.py scan_epilogue in f32: mask =
// xx > 100*eps*max(ss, tiny), expl clamped to rss0, rss1 floored at tiny,
// outputs zeroed off-mask. Output (4, m) = [f, beta, var_perc, mask].
//
// Bound on the H100: device-memory bandwidth — every element of Xr is read
// once and used for 2 + q multiply-adds. Design: a block of 256 threads
// owns ROWS = 4 rows; its threads stride across the n columns with
// coalesced loads, read sd / y_res / Q0 once per column for all four rows,
// keep the per-row partial sums in registers (Q0 zero-padded to a
// compile-time width QP), and reduce them with warp shuffles and one
// shared-memory pass. No tensor cores: q is tiny, so no matrix tiling
// decides the speed.

#include <cstdint>
#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int ROWS = 4;

template <int QP>
__global__ void __launch_bounds__(THREADS)
scan_stats_kernel(const float* __restrict__ xr, long long m, int n,
                  const float* __restrict__ sd,
                  const float* __restrict__ y_res,
                  const float* __restrict__ q0 /* (n, QP) */, float rss0,
                  float dof, float* __restrict__ out) {
  constexpr int NV = ROWS * (2 + QP);  // partial sums per thread
  __shared__ float red[WARPS][NV];
  const long long r0 = (long long)blockIdx.x * ROWS;
  float acc[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) acc[v] = 0.f;

  for (int j = threadIdx.x; j < n; j += THREADS) {
    const float s = sd[j];
    const float y = y_res[j];
    float qv[QP];
#pragma unroll
    for (int c = 0; c < QP; ++c) qv[c] = q0[(long long)j * QP + c];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const long long row = r0 + r;
      const float x = row < m ? xr[row * n + j] * s : 0.f;
      acc[r * (2 + QP)] += x * x;
      acc[r * (2 + QP) + 1] += x * y;
#pragma unroll
      for (int c = 0; c < QP; ++c) acc[r * (2 + QP) + 2 + c] += x * qv[c];
    }
  }
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    float a = acc[v];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      a += __shfl_xor_sync(0xffffffffu, a, off);
    if (lane == 0) red[warp][v] = a;
  }
  __syncthreads();
  if (threadIdx.x < ROWS && r0 + threadIdx.x < m) {
    const int r = threadIdx.x;
    float tot[2 + QP];
#pragma unroll
    for (int v = 0; v < 2 + QP; ++v) {
      float a = 0.f;
      for (int w = 0; w < WARPS; ++w) a += red[w][r * (2 + QP) + v];
      tot[v] = a;
    }
    const float ss = tot[0];
    const float xy = tot[1];
    float c2 = 0.f;
#pragma unroll
    for (int c = 0; c < QP; ++c) c2 += tot[2 + c] * tot[2 + c];
    const float eps = 100.f * FLT_EPSILON;
    const float tiny = FLT_MIN;
    const float xx = ss - c2;
    const bool mask = xx > eps * fmaxf(ss, tiny);
    const float xx_safe = mask ? xx : 1.f;
    const float expl = mask ? fminf(xy * xy / xx_safe, rss0) : 0.f;
    const float rss1 = fmaxf(rss0 - expl, tiny);
    const long long row = r0 + r;
    out[row] = mask ? expl * dof / rss1 : 0.f;
    out[m + row] = mask ? xy / xx_safe : 0.f;
    out[2 * m + row] = mask ? expl / rss0 : 0.f;
    out[3 * m + row] = mask ? 1.f : 0.f;
  }
}

template <int QP>
int launch(const void* xr, long long m, int n, const void* sd,
           const void* y_res, const void* q0, float rss0, float dof,
           void* out, void* stream) {
  const long long blocks = (m + ROWS - 1) / ROWS;
  scan_stats_kernel<QP><<<(unsigned)blocks, THREADS, 0,
                          (cudaStream_t)stream>>>(
      (const float*)xr, m, n, (const float*)sd, (const float*)y_res,
      (const float*)q0, rss0, dof, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// q0 is (n, qp) row-major with qp in {1, 2, 4, 8, 16} (zero-padded columns)
extern "C" int scan_stats(const void* xr, long long m, int n, const void* sd,
                          const void* y_res, const void* q0, int qp,
                          float rss0, float dof, void* out, void* stream) {
  switch (qp) {
    case 1: return launch<1>(xr, m, n, sd, y_res, q0, rss0, dof, out, stream);
    case 2: return launch<2>(xr, m, n, sd, y_res, q0, rss0, dof, out, stream);
    case 4: return launch<4>(xr, m, n, sd, y_res, q0, rss0, dof, out, stream);
    case 8: return launch<8>(xr, m, n, sd, y_res, q0, rss0, dof, out, stream);
    case 16:
      return launch<16>(xr, m, n, sd, y_res, q0, rss0, dof, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
