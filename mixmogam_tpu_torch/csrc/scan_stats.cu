// K3: whiten + GLS F scan over pre-rotated SNP rows (Hopper).
//
// Replaces: mixmogam_tpu/ops/pallas_scan.py _scan_kernel / _scan_padded
// (pallas_scan_stats), and the exact tier's epilogue that the JAX main path
// runs in XLA (ops/scan.py scan_epilogue after the fp32 G @ W GEMM).
//
// Input Xr (m, n) f32 = rows of G @ U from a full-fp32 torch GEMM. Per
// row: Xs = Xr * sd, ss = sum Xs^2, xy = Xs . y_res, cc = Xs @ Q0 (q <= 128,
// the TPU kernel's QPAD), then the epilogue of ops/scan.py scan_epilogue in
// f32: mask = xx > 100*eps*max(ss, tiny), expl clamped to rss0, rss1
// floored at tiny, outputs zeroed off-mask. Output (4, m) = [f, beta,
// var_perc, mask].
//
// Bound on the H100: device-memory bandwidth at the q of a null design
// (every element of Xr is read once and used for 2 + q multiply-adds); at
// q near 128 the fp32 operations. Two designs:
// - q <= 16 (scan_stats_kernel): a block of 256 threads owns ROWS = 4 rows;
//   its threads stride across the n columns with coalesced loads, read sd /
//   y_res / Q0 once per column for all four rows, keep the per-row partial
//   sums in registers (Q0 zero-padded to a compile-time width QP), and
//   reduce them with warp shuffles and one shared-memory pass.
// - 16 < q <= 128 (scan_stats_wide_kernel; stepwise designs grow by one
//   column a step): a block owns WROWS = 32 rows and walks n in chunks of
//   32 columns, staging the whitened chunk and Q0's chunk (32 x QW) in
//   shared memory; each warp owns 4 rows and its lanes split Q0's columns
//   (lane + 32 i), so Xs @ Q0 is a small register-tiled product and each
//   row's sums close in one warp with shuffles. Q0 is read once per 32 rows.
// No tensor cores: the products are too thin for a matrix unit to decide
// the speed, and the exact tier keeps fp32.

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

constexpr int WROWS = 32;  // rows a block, wide path
constexpr int JC = 32;     // columns a chunk, wide path

// The wide path: 8 warps x 4 rows; lane l of a warp owns Q0 columns
// l, l + 32, ... (QW / 32 of them) for its warp's 4 rows, and column l of
// each chunk for the row sums ss and xy.
template <int QW>
__global__ void __launch_bounds__(THREADS)
scan_stats_wide_kernel(const float* __restrict__ xr, long long m, int n,
                       const float* __restrict__ sd,
                       const float* __restrict__ y_res,
                       const float* __restrict__ q0 /* (n, QW) */,
                       float rss0, float dof, float* __restrict__ out) {
  constexpr int KT = QW / 32;
  __shared__ float xs[WROWS][JC + 1];
  __shared__ float qs[JC][QW];
  __shared__ float ys[JC];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long r0 = (long long)blockIdx.x * WROWS;
  float acc[4][KT];
  float ss[4], xy[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    ss[r] = 0.f;
    xy[r] = 0.f;
#pragma unroll
    for (int i = 0; i < KT; ++i) acc[r][i] = 0.f;
  }
  for (int j0 = 0; j0 < n; j0 += JC) {
    for (int e = threadIdx.x; e < WROWS * JC; e += THREADS) {
      const int r = e / JC, jj = e % JC;
      const long long row = r0 + r;
      const int j = j0 + jj;
      xs[r][jj] = (row < m && j < n) ? xr[row * n + j] * sd[j] : 0.f;
    }
    for (int e = threadIdx.x; e < JC * QW; e += THREADS) {
      const int jj = e / QW;
      qs[jj][e % QW] = j0 + jj < n ? q0[(long long)j0 * QW + e] : 0.f;
    }
    if (threadIdx.x < JC)
      ys[threadIdx.x] = j0 + threadIdx.x < n ? y_res[j0 + threadIdx.x] : 0.f;
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = xs[warp * 4 + r][lane];
      ss[r] += x * x;
      xy[r] += x * ys[lane];
    }
#pragma unroll 4
    for (int jj = 0; jj < JC; ++jj) {
      float qv[KT];
#pragma unroll
      for (int i = 0; i < KT; ++i) qv[i] = qs[jj][lane + 32 * i];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float x = xs[warp * 4 + r][jj];
#pragma unroll
        for (int i = 0; i < KT; ++i) acc[r][i] += x * qv[i];
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float c2 = 0.f;
#pragma unroll
    for (int i = 0; i < KT; ++i) c2 += acc[r][i] * acc[r][i];
    float a = ss[r], b = xy[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
      c2 += __shfl_xor_sync(0xffffffffu, c2, off);
    }
    const long long row = r0 + warp * 4 + r;
    if (lane == 0 && row < m) {
      const float eps = 100.f * FLT_EPSILON;
      const float tiny = FLT_MIN;
      const float xx = a - c2;
      const bool mask = xx > eps * fmaxf(a, tiny);
      const float xx_safe = mask ? xx : 1.f;
      const float expl = mask ? fminf(b * b / xx_safe, rss0) : 0.f;
      const float rss1 = fmaxf(rss0 - expl, tiny);
      out[row] = mask ? expl * dof / rss1 : 0.f;
      out[m + row] = mask ? b / xx_safe : 0.f;
      out[2 * m + row] = mask ? expl / rss0 : 0.f;
      out[3 * m + row] = mask ? 1.f : 0.f;
    }
  }
}

template <int QW>
int launch_wide(const void* xr, long long m, int n, const void* sd,
                const void* y_res, const void* q0, float rss0, float dof,
                void* out, void* stream) {
  const long long blocks = (m + WROWS - 1) / WROWS;
  scan_stats_wide_kernel<QW><<<(unsigned)blocks, THREADS, 0,
                               (cudaStream_t)stream>>>(
      (const float*)xr, m, n, (const float*)sd, (const float*)y_res,
      (const float*)q0, rss0, dof, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// q0 is (n, qp) row-major, zero-padded columns: qp in {1, 2, 4, 8, 16} takes
// the register path, {32, 64, 128} the wide one
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
    case 32:
      return launch_wide<32>(xr, m, n, sd, y_res, q0, rss0, dof, out, stream);
    case 64:
      return launch_wide<64>(xr, m, n, sd, y_res, q0, rss0, dof, out, stream);
    case 128:
      return launch_wide<128>(xr, m, n, sd, y_res, q0, rss0, dof, out,
                              stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
