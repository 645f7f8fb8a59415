// K2: fused int8 digit-plane rotate + GLS F scan over 2-bit packed rows
// (Hopper).
//
// Replaces: mixmogam_tpu/ops/pallas_scan.py _make_int8_rotate_scan_kernel /
// _int8_rotate_scan_padded (pallas_rotate_scan_int8), and the int8xK tier
// the JAX main path runs in XLA (ops/scan.py apply_rotation +
// scan_epilogue via models/resident.py emmax_scan_packed).
//
// For a block of TM SNP rows: Xs = (sum_p 256^p * (G @ P_p)) * w_scale,
// with G the unpacked int8 dosages and P_p the K int8 digit planes of
// W = U * sd; every plane product accumulates EXACTLY in int32 over all n
// inputs before the f32 recombine (the XLA tier's numerics). From each
// finished Xs column block it accumulates ss = sum Xs^2, xy = Xs . y_res
// and cc = Xs @ Q0; Xs never reaches device memory. The epilogue matches
// ops/scan.py scan_epilogue in f32: mask = xx > 100*eps*max(ss, tiny),
// expl clamped to rss0, rss1 floored at tiny, outputs zeroed off-mask.
// Output (4, rows) = [f, beta, var_perc, mask].
//
// Bound on the H100: int8 tensor-core throughput (K * rows * n^2
// multiply-adds). Device-memory traffic is the K planes (K * n^2 bytes),
// re-read once per block of TM = 128 rows, i.e. 128 int8 MACs per byte;
// the blocks in flight walk the planes in step, so most of it hits L2.
// The row sums and the epilogue are scan_epilogue.cuh, shared with K5.
// Design: 8 warps; each warp owns a 32-row x 32-column tile of one
// 128 x 64 output step and issues mma.sync m16n8k32 s8 x s8 -> s32 per
// plane (int32 sums are exact, so the result does not depend on the
// summation order). The contraction runs in chunks of 64 samples: the
// packed G bytes go to shared memory as they are, and each thread builds
// its A fragments straight from them (one packed byte = 4 consecutive
// samples = one 32-bit fragment register); the planes arrive
// pre-transposed (K, n_pad, n_pad)[p][j][k], so 4 consecutive k are one
// B fragment register too. The next chunk's global loads are issued into
// registers before the current chunk's products. Row sums reduce across
// the 4 lanes of a quad with shuffles into per-warp shared slots
// (deterministic, no atomics). Simple first: no ldmatrix, cp.async, TMA
// or wgmma yet.

#include <cstdint>
#include <cuda_runtime.h>

#include "scan_epilogue.cuh"

namespace {

using scan_epi::QMAX;
using scan_epi::THREADS;
using scan_epi::TM;
using scan_epi::WN;
constexpr int TN = 64;       // output columns per step
constexpr int TK = 64;       // input samples per chunk
constexpr int GW = TK / 16;  // 32-bit words of packed G per row per chunk
constexpr int WST = TK + 16; // bytes per plane column in shared memory:
                             // 80 keeps the B fragment reads conflict-free

// one packed byte (4 samples, 2 bits each) -> 4 int8 lanes; code 3
// (missing, or column padding beyond n) becomes 0
__device__ __forceinline__ uint32_t unpack4(uint32_t b) {
  uint32_t w = (b & 0x3u) | ((b & 0xCu) << 6) | ((b & 0x30u) << 12) |
               ((b & 0xC0u) << 18);
  const uint32_t m3 = w & (w >> 1) & 0x01010101u;
  return w & ~(m3 * 3u);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
rotate_scan_int8_kernel(const uint8_t* __restrict__ packed, long long rows,
                        int rb, int n_pad, const int8_t* __restrict__ wt,
                        const float* __restrict__ w_scale,
                        const float* __restrict__ y_res,
                        const float* __restrict__ q0, int q, float rss0,
                        float dof, float* __restrict__ out) {
  __shared__ uint32_t sG[TM * GW];                   // [row][word]
  __shared__ __align__(16) uint8_t sW[NP * TN * WST];  // [p][col][k]
  __shared__ scan_epi::Sums sums;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % (THREADS / 32 / WN);  // 32-row slab of the block
  const int wn = warp / (THREADS / 32 / WN);  // 32-column half of a step
  const int g = lane / 4;                     // mma groupID
  const int t4 = lane % 4;                    // mma threadID_in_group
  const long long r0 = (long long)blockIdx.x * TM;

  scan_epi::zero_sums(sums);

  // this thread's share of one chunk: 2 words of packed G, NP x 16 bytes
  // of planes (TN * TK / 16 == THREADS)
  uint32_t pg[2];
  uint4 pw[NP];
  auto load_chunk = [&](int j0, int k0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int w = tid + h * THREADS;
      const long long grow = r0 + w / GW;
      const int bc = k0 / 4 + (w % GW) * 4;
      uint32_t word = 0;
      if (grow < rows) {
        const uint8_t* src = packed + grow * rb;
#pragma unroll
        for (int s = 0; s < 4; ++s)
          if (bc + s < rb) word |= (uint32_t)src[bc + s] << (8 * s);
      }
      pg[h] = word;
    }
    const int col = tid / (TK / 16);
    const int v = tid % (TK / 16);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      pw[p] = *reinterpret_cast<const uint4*>(
          wt + ((long long)p * n_pad + j0 + col) * n_pad + k0 + 16 * v);
  };
  auto store_chunk = [&]() {
    sG[tid] = pg[0];
    sG[tid + THREADS] = pg[1];
    const int col = tid / (TK / 16);
    const int v = tid % (TK / 16);
#pragma unroll
    for (int p = 0; p < NP; ++p)
      *reinterpret_cast<uint4*>(sW + (p * TN + col) * WST + 16 * v) = pw[p];
  };

  const uint8_t* gb = reinterpret_cast<const uint8_t*>(sG);
  for (int j0 = 0; j0 < n_pad; j0 += TN) {
    int acc[NP][2][4][4];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[p][mt][nt][i] = 0;

    load_chunk(j0, 0);
    for (int k0 = 0; k0 < n_pad; k0 += TK) {
      __syncthreads();  // the previous chunk's products are done
      store_chunk();
      __syncthreads();
      if (k0 + TK < n_pad) load_chunk(j0, k0 + TK);  // in flight meanwhile
#pragma unroll
      for (int ks = 0; ks < TK / 32; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int ra = (wm * 32 + mt * 16 + g) * (TK / 4) + ks * 8 + t4;
          const int rb8 = ra + 8 * (TK / 4);
          a[mt][0] = unpack4(gb[ra]);
          a[mt][1] = unpack4(gb[rb8]);
          a[mt][2] = unpack4(gb[ra + 4]);
          a[mt][3] = unpack4(gb[rb8 + 4]);
        }
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint32_t* wp = reinterpret_cast<const uint32_t*>(
                sW + (p * TN + wn * 32 + nt * 8 + g) * WST + ks * 32);
            const uint32_t b0 = wp[t4];
            const uint32_t b1 = wp[4 + t4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma_s8(acc[p][mt][nt], a[mt], b0, b1);
          }
      }
    }

    // recombine the planes in f32 (low digit first, as XLA does), then
    // this column step's row partial sums
    float xs[2][4][4];
    float ws[4][2];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        ws[nt][e] = w_scale[j0 + wn * 32 + nt * 8 + 2 * t4 + e];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float x = (float)acc[0][mt][nt][i];
          float scale = 1.f;
#pragma unroll
          for (int p = 1; p < NP; ++p) {
            scale *= 256.f;
            x = x + (float)acc[p][mt][nt][i] * scale;
          }
          xs[mt][nt][i] = x * ws[nt][i % 2];
        }
    scan_epi::scan_step_sums(xs, j0, wm, wn, g, t4, y_res, q0, q, sums);
  }
  __syncthreads();
  scan_epi::scan_write_stats(sums, r0, rows, q, rss0, dof, out);
}

template <int NP>
int launch(const void* packed, long long rows, int rb, int n_pad,
           const void* wt, const void* w_scale, const void* y_res,
           const void* q0, int q, float rss0, float dof, void* out,
           void* stream) {
  const long long blocks = (rows + TM - 1) / TM;
  rotate_scan_int8_kernel<NP><<<(unsigned)blocks, THREADS, 0,
                                (cudaStream_t)stream>>>(
      (const uint8_t*)packed, rows, rb, n_pad, (const int8_t*)wt,
      (const float*)w_scale, (const float*)y_res, (const float*)q0, q, rss0,
      dof, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// wt: (num_planes, n_pad, n_pad) int8, the planes transposed to [p][out][in]
// and zero-padded; w_scale / y_res: (n_pad,) f32; q0: (n_pad, q) f32
extern "C" int rotate_scan_int8_packed(const void* packed, long long rows,
                                       int rb, int n_pad, int num_planes,
                                       const void* wt, const void* w_scale,
                                       const void* y_res, const void* q0,
                                       int q, float rss0, float dof,
                                       void* out, void* stream) {
  if (n_pad % TK != 0 || n_pad % TN != 0 || q < 0 || q > QMAX)
    return (int)cudaErrorInvalidValue;
  switch (num_planes) {
    case 2: return launch<2>(packed, rows, rb, n_pad, wt, w_scale, y_res, q0,
                             q, rss0, dof, out, stream);
    case 3: return launch<3>(packed, rows, rb, n_pad, wt, w_scale, y_res, q0,
                             q, rss0, dof, out, stream);
    case 4: return launch<4>(packed, rows, rb, n_pad, wt, w_scale, y_res, q0,
                             q, rss0, dof, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
