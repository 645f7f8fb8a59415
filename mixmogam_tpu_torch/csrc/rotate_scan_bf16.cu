// K5: fused split-W bf16 rotate + GLS F scan over 2-bit packed rows
// (Hopper).
//
// Replaces: mixmogam_tpu/ops/pallas_scan.py _make_rotate_scan_kernel /
// _rotate_scan_padded (pallas_rotate_scan), and the bf16 / bf16x2 / bf16x3
// tiers the JAX main path runs in XLA (ops/scan.py apply_rotation +
// scan_epilogue via models/resident.py emmax_scan_packed).
//
// For a block of TM SNP rows: Xs = G @ (P_0 + ... + P_{K-1}), with G the
// unpacked dosages as bf16 (missing codes replaced by the row's mean
// rounded to bf16 when row means are given, else 0) and P_p the K bf16
// split-W parts of W = U * sd. Every bf16 x bf16 product is exact and
// accumulates in f32 on the tensor cores, each part in its own
// accumulator and over one 64-sample chunk only; after each chunk the
// parts' sums (smallest part first) are added into a running f32 sum in
// registers, with IEEE round-to-nearest. The tensor cores' f32
// accumulation drops the low bits of addends much smaller than its
// running sum (truncating alignment), so a sum over all n inputs in one
// accumulator, and even more one shared by the parts, drifted from the
// float64 plain version: measured on the card at n = 10,240, bf16x3 max
// |d beta| 2.3e-5 with one shared accumulator, 1.2e-5 with one per part.
// Summation order differs from XLA's per-part dots, which the tolerance
// covers.
// From each finished Xs column block the shared epilogue
// (scan_epilogue.cuh, as in K2) accumulates ss, xy and cc = Xs @ Q0; Xs
// never reaches device memory. Output (4, rows) = [f, beta, var_perc,
// mask].
//
// Bound on the H100: bf16 tensor-core throughput (K * rows * n^2
// multiply-adds). Device-memory traffic is the K parts (2 * K * n^2 bytes),
// re-read once per block of TM = 128 rows, i.e. 64 MACs per byte; the
// blocks in flight walk the parts in step, so most of it hits L2.
// Design: 8 warps; each warp owns a 32-row x 32-column tile of one
// 128 x 64 output step and issues mma.sync m16n8k16 bf16 -> f32. The
// contraction runs in chunks of 64 samples. The k order inside each
// 16-sample step is permuted (the sum does not care): logical inputs
// {2t, 2t+1, 2t+8, 2t+9} of mma thread t are the physical samples
// 4t..4t+3, i.e. ONE packed byte. So the packed G bytes go to shared
// memory as they are and each thread decodes its own A fragment registers
// from one byte per row; the parts arrive pre-transposed (K, n_pad,
// n_pad)[p][out][in], so the matching B fragment (2 registers) is one
// 8-byte load of 4 consecutive inputs. Their shared-memory rows are XOR
// swizzled in 8-byte slots so those loads are bank-conflict-free. The
// next chunk's global loads are issued into registers before the current
// chunk's products. Simple first: no ldmatrix, cp.async, TMA or wgmma.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "scan_epilogue.cuh"

namespace {

using scan_epi::THREADS;
using scan_epi::TM;
using scan_epi::WN;
constexpr int TN = 64;       // output columns per step
constexpr int TK = 64;       // input samples per chunk
constexpr int GW = TK / 16;  // 32-bit words of packed G per row per chunk
constexpr int WROW = TK * 2; // bytes per part column per chunk (16 slots)

// bf16 bits of a 2-bit code: 0 -> 0.0, 1 -> 1.0, 2 -> 2.0, 3 (missing, or
// column padding beyond n) -> the row's mean (0 without row means)
__device__ __forceinline__ uint32_t code_bf16(uint32_t c, uint32_t mb) {
  return c == 3u ? mb : (c == 0u ? 0u : 0x3F00u + (c << 7));
}

// byte offset of 8-byte slot `slot` (0..15) of part column `col`
__device__ __forceinline__ int w_off(int col, int slot) {
  return col * WROW + ((slot ^ ((col & 3) << 2)) << 3);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NP>
__global__ void __launch_bounds__(THREADS, 1)
rotate_scan_bf16_kernel(const uint8_t* __restrict__ packed, long long rows,
                        int rb, int n_pad, const uint16_t* __restrict__ wt,
                        const float* __restrict__ y_res,
                        const float* __restrict__ q0, int q,
                        const float* __restrict__ row_mean, float rss0,
                        float dof, float* __restrict__ out) {
  __shared__ uint32_t sG[TM * GW];                    // [row][word]
  __shared__ __align__(16) uint8_t sW[NP * TN * WROW];  // [p][col][slots]
  __shared__ uint32_t sMean[TM];                      // bf16 bits
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
  if (tid < TM) {
    uint32_t mb = 0u;
    if (row_mean != nullptr && r0 + tid < rows)
      mb = __bfloat16_as_ushort(__float2bfloat16_rn(row_mean[r0 + tid]));
    sMean[tid] = mb;
  }

  // this thread's share of one chunk: 2 words of packed G, NP x 2 x 16
  // bytes of parts (NP * TN * WROW / 16 == NP * 2 * THREADS)
  uint32_t pg[2];
  uint4 pw[NP][2];
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
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = tid + h * THREADS;
        const int col = idx / 8;
        const int v = idx % 8;
        pw[p][h] = *reinterpret_cast<const uint4*>(
            wt + ((long long)p * n_pad + j0 + col) * n_pad + k0 + 8 * v);
      }
  };
  auto store_chunk = [&]() {
    sG[tid] = pg[0];
    sG[tid + THREADS] = pg[1];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int idx = tid + h * THREADS;
        const int col = idx / 8;
        const int v = idx % 8;
        *reinterpret_cast<uint4*>(sW + p * TN * WROW + w_off(col, 2 * v)) =
            pw[p][h];
      }
  };

  const uint8_t* gb = reinterpret_cast<const uint8_t*>(sG);
  for (int j0 = 0; j0 < n_pad; j0 += TN) {
    float xs[2][4][4];  // this column step's Xs, summed over the chunks
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) xs[mt][nt][i] = 0.f;

    load_chunk(j0, 0);
    for (int k0 = 0; k0 < n_pad; k0 += TK) {
      __syncthreads();  // the previous chunk's products are done
      store_chunk();
      __syncthreads();
      if (k0 + TK < n_pad) load_chunk(j0, k0 + TK);  // in flight meanwhile
      float acc[NP][2][4][4];
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[p][mt][nt][i] = 0.f;
#pragma unroll
      for (int ks = 0; ks < TK / 16; ++ks) {
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = wm * 32 + mt * 16 + h * 8 + g;
            const uint32_t b = gb[row * (TK / 4) + ks * 4 + t4];
            const uint32_t mb = sMean[row];
            a[mt][h] = code_bf16(b & 3u, mb) |
                       (code_bf16((b >> 2) & 3u, mb) << 16);
            a[mt][2 + h] = code_bf16((b >> 4) & 3u, mb) |
                           (code_bf16((b >> 6) & 3u, mb) << 16);
          }
        }
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            const uint2 bw = *reinterpret_cast<const uint2*>(
                sW + p * TN * WROW +
                w_off(wn * 32 + nt * 8 + g, ks * 4 + t4));
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              mma_bf16(acc[p][mt][nt], a[mt], bw.x, bw.y);
          }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float t = acc[NP - 1][mt][nt][i];
#pragma unroll
            for (int p = NP - 2; p >= 0; --p) t = t + acc[p][mt][nt][i];
            xs[mt][nt][i] += t;
          }
    }
    scan_epi::scan_step_sums(xs, j0, wm, wn, g, t4, y_res, q0, q, sums);
  }
  __syncthreads();
  scan_epi::scan_write_stats(sums, r0, rows, q, rss0, dof, out);
}

template <int NP>
int launch(const void* packed, long long rows, int rb, int n_pad,
           const void* wt, const void* y_res, const void* q0, int q,
           const void* row_mean, float rss0, float dof, void* out,
           void* stream) {
  const long long blocks = (rows + TM - 1) / TM;
  rotate_scan_bf16_kernel<NP><<<(unsigned)blocks, THREADS, 0,
                                (cudaStream_t)stream>>>(
      (const uint8_t*)packed, rows, rb, n_pad, (const uint16_t*)wt,
      (const float*)y_res, (const float*)q0, q, (const float*)row_mean, rss0,
      dof, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// wt: (num_parts, n_pad, n_pad) bf16, the parts transposed to [p][out][in]
// and zero-padded; y_res: (n_pad,) f32; q0: (n_pad, q) f32; row_mean:
// (rows,) f32 or null (fully observed: missing codes count as 0)
extern "C" int rotate_scan_bf16_packed(const void* packed, long long rows,
                                       int rb, int n_pad, int num_parts,
                                       const void* wt, const void* y_res,
                                       const void* q0, int q,
                                       const void* row_mean, float rss0,
                                       float dof, void* out, void* stream) {
  if (n_pad % TK != 0 || n_pad % TN != 0 || q < 0 || q > scan_epi::QMAX)
    return (int)cudaErrorInvalidValue;
  switch (num_parts) {
    case 1: return launch<1>(packed, rows, rb, n_pad, wt, y_res, q0, q,
                             row_mean, rss0, dof, out, stream);
    case 2: return launch<2>(packed, rows, rb, n_pad, wt, y_res, q0, q,
                             row_mean, rss0, dof, out, stream);
    case 3: return launch<3>(packed, rows, rb, n_pad, wt, y_res, q0, q,
                             row_mean, rss0, dof, out, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
