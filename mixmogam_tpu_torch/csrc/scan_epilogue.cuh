// The GLS F-scan epilogue shared by the fused rotate + scan kernels K2
// (rotate_scan_int8.cu) and K5 (rotate_scan_bf16.cu).
//
// Both kernels run 8 warps over a block of TM = 128 SNP rows; warp
// (wm, wn) owns a 32-row x 32-column tile of each 64-column output step,
// held as 2 x 4 mma accumulator tiles (m16 x n8): element i of tile
// (mt, nt) sits at row g + 8 * (i / 2), column 2 * t4 + i % 2 (g the mma
// groupID, t4 the thread in its group). Once a column step's Xs values are
// complete, scan_step_sums adds that step's ss = sum Xs^2, xy = Xs . y_res
// and cc = Xs @ Q0 into per-warp-column shared slots (quad shuffles, no
// atomics: results repeat bit for bit). scan_write_stats then applies
// ops/scan.py scan_epilogue in f32: mask = xx > 100*eps*max(ss, tiny),
// expl clamped to rss0, rss1 floored at tiny, outputs zeroed off-mask,
// into out (4, rows) = [f, beta, var_perc, mask].

#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace scan_epi {

constexpr int TM = 128;      // SNP rows per block
constexpr int THREADS = 256;
constexpr int WN = 2;        // warps along the output columns
constexpr int QMAX = 16;

struct Sums {
  float ss[WN][TM];
  float xy[WN][TM];
  float cc[WN][TM * QMAX];
};

__device__ __forceinline__ void zero_sums(Sums& s) {
  for (int t = threadIdx.x; t < WN * TM; t += THREADS) {
    (&s.ss[0][0])[t] = 0.f;
    (&s.xy[0][0])[t] = 0.f;
  }
  for (int t = threadIdx.x; t < WN * TM * QMAX; t += THREADS)
    (&s.cc[0][0])[t] = 0.f;
}

// xs: this warp's completed Xs values of the column step starting at j0
__device__ __forceinline__ void scan_step_sums(
    const float (&xs)[2][4][4], int j0, int wm, int wn, int g, int t4,
    const float* __restrict__ y_res, const float* __restrict__ q0, int q,
    Sums& s) {
  float yr[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      yr[nt][e] = y_res[j0 + wn * 32 + nt * 8 + 2 * t4 + e];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lr = wm * 32 + mt * 16 + h * 8 + g;
      float ss = 0.f, xy = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = xs[mt][nt][2 * h + e];
          ss += x * x;
          xy += x * yr[nt][e];
        }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        ss += __shfl_xor_sync(0xffffffffu, ss, off);
        xy += __shfl_xor_sync(0xffffffffu, xy, off);
      }
      if (t4 == 0) {
        s.ss[wn][lr] += ss;
        s.xy[wn][lr] += xy;
      }
    }
  for (int qq = 0; qq < q; ++qq) {
    float qv[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        qv[nt][e] =
            q0[(long long)(j0 + wn * 32 + nt * 8 + 2 * t4 + e) * q + qq];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float cc = 0.f;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) cc += xs[mt][nt][2 * h + e] * qv[nt][e];
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          cc += __shfl_xor_sync(0xffffffffu, cc, off);
        if (t4 == 0)
          s.cc[wn][(wm * 32 + mt * 16 + h * 8 + g) * QMAX + qq] += cc;
      }
  }
}

// after a __syncthreads(): threads 0..TM-1 finish one row each
__device__ __forceinline__ void scan_write_stats(const Sums& s, long long r0,
                                                 long long rows, int q,
                                                 float rss0, float dof,
                                                 float* __restrict__ out) {
  const int tid = threadIdx.x;
  if (tid >= TM || r0 + tid >= rows) return;
  const float eps = 100.f * FLT_EPSILON;
  const float tiny = FLT_MIN;
  const float ss = s.ss[0][tid] + s.ss[1][tid];
  const float xy = s.xy[0][tid] + s.xy[1][tid];
  float c2 = 0.f;
  for (int qq = 0; qq < q; ++qq) {
    const float c = s.cc[0][tid * QMAX + qq] + s.cc[1][tid * QMAX + qq];
    c2 += c * c;
  }
  const float xx = ss - c2;
  const bool mask = xx > eps * fmaxf(ss, tiny);
  const float xx_safe = mask ? xx : 1.f;
  const float expl = mask ? fminf(xy * xy / xx_safe, rss0) : 0.f;
  const float rss1 = fmaxf(rss0 - expl, tiny);
  const long long row = r0 + tid;
  out[row] = mask ? expl * dof / rss1 : 0.f;
  out[rows + row] = mask ? xy / xx_safe : 0.f;
  out[2 * rows + row] = mask ? expl / rss0 : 0.f;
  out[3 * rows + row] = mask ? 1.f : 0.f;
}

}  // namespace scan_epi
