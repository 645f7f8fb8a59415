// K3: whiten + GLS F scan over pre-rotated SNP rows (Hopper).
//
// Replaces: mixmogam_tpu/ops/pallas_scan.py _scan_kernel / _scan_padded
// (pallas_scan_stats), and the exact tier's epilogue that the JAX main path
// runs in XLA (ops/scan.py scan_epilogue after the fp32 G @ W GEMM).
//
// Input Xr (m, n) f32 = rows of G @ U from a full-fp32 torch GEMM, at a row
// pitch ld >= n. Per row: Xs = Xr * sd, ss = sum Xs^2, xy = Xs . y_res,
// cc = Xs @ Q0 (q <= 128, the TPU kernel's QPAD), then the epilogue of
// ops/scan.py scan_epilogue in f32: mask = xx > 100*eps*max(ss, tiny), expl
// clamped to rss0, rss1 floored at tiny, outputs zeroed off-mask. Output
// (4, m) = [f, beta, var_perc, mask].
//
// What bounds it on an H100: every element of Xr is read once and used for
// 2 + q multiply-adds. Up to q of about 30 the rows' bytes over device
// memory bound it (671 MB a 16,384 x 10,240 tile: 0.2 ms); above, the fp32
// multiply-adds (no tensor cores: this is the exact tier).
//
// The design: one kernel for every q, templated on the width class of Q0
// (QW = 8, 16, 32, 64, 96 or 128 columns; the wrapper pads Q0 to it). Each
// class takes the shape that its bound asks for (Cfg below).
//  * A block of 8 warps owns TM rows and all n columns, so Q0 is read once
//    per TM rows (from L2). A row's sums close inside its block in a fixed
//    order: results repeat bit for bit, no atomics.
//  * A ring of STAGES stages in dynamic shared memory, KC columns each: the
//    rows' TM x KC slice, and the KC-row slices of Q0, sd and y_res (the
//    wrapper pads them to a multiple of 256 rows). Every thread copies its
//    share of the rows with 16-byte cp.async and thread 0 the three slices
//    with cp.async.bulk, onto the stage's "full" mbarrier (the helpers of
//    rotate_scan_tile.cuh), STAGES - 1 stages ahead of the one consumed;
//    one __syncthreads a stage frees the slot of the stage before. A row
//    pitch, base or length that is no multiple of 16 bytes (n = 2,042: an
//    8,168-byte pitch) takes 8- or 4-byte copies: callers pass their GEMM's
//    rows as they are, or a view of wider rows, with no padded copy. (A
//    producer warp with "empty" barriers measured no faster.)
//  * Up to QW = 16 the rows' bytes bound it: 32 rows a block, two blocks an
//    SM, 256 columns (a row's 1 KB, which the card's memory serves far
//    better than 128-256 bytes) a stage. Lane l of a warp takes columns
//    l, l + 32, ... of its 4 rows and keeps the partial sums of all 2 + QW
//    products (ss, xy, cc) in registers, with Q0's slice laid out column by
//    column so that its loads are conflict-free; warp shuffles close them.
//  * From QW = 32 the fp32 products bound it: 128 rows a block, 64 or 32
//    columns a stage. Whiten: lane l takes columns l, l + 32 of its 16
//    rows, keeps ss and xy as partial sums, and writes x = Xr * sd
//    transposed into one of two buffers, xsT[k][r ^ (k % 32)]:
//    conflict-free stores, and RM rows of a column read as one vector (the
//    XOR moves a row only inside its aligned group; the inner loop's static
//    k % 4 undoes the order). Product: a register-tiled fp32 FMA outer
//    product of xsT and the Q0 slice; a thread owns RM = 4 rows x RN =
//    QW / 8 columns, so a warp's loads of a k are one shared wavefront for
//    the rows and RN / 4 for Q0. |cc|^2 of a row closes over its 8 column
//    groups through shared memory in a fixed order.
//  * The epilogue, one thread a row.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

#include "rotate_scan_tile.cuh"

namespace {

using rscan::bulk_load;
using rscan::mbar_expect_tx;
using rscan::mbar_init;
using rscan::mbar_wait;
using rscan::smem_u32;

constexpr int THREADS = 256;            // 8 warps
constexpr int NPAD = 256;               // n is padded to a multiple

// The shape of a launch for Q0's width class QW.
//  * QW <= 16 (DIRECT): TM = 32 rows a block, two blocks an SM, KC = 256
//    columns a stage (a row's 1 KB), two stages; a lane keeps its columns'
//    partial sums of all 2 + QW products of its warp's 4 rows.
//  * QW >= 32: TM = 128 rows a block, one block an SM, KC = 64 columns a
//    stage up to QW = 64 (three stages), 32 above (four); a thread owns
//    RM rows x RN columns of the outer product, CG column groups,
//    (TM / RM) * CG = 256.
template <int QW_>
struct Cfg {
  static constexpr int QW = QW_;
  static constexpr bool DIRECT = QW <= 16;
  static constexpr int TM = DIRECT ? 32 : 128;
  static constexpr int KC = DIRECT ? 256 : QW <= 64 ? 64 : 32;
  static constexpr int STAGES = DIRECT ? 2 : QW <= 64 ? 3 : 4;
  static constexpr int BLOCKS = DIRECT ? 2 : 1;    // an SM
  static constexpr int WR = TM / 8;                // rows a warp
  static constexpr int CG = 8;
  static constexpr int RM = TM * CG / THREADS;
  static constexpr int RN = QW / CG;
  static constexpr int V = RN < 4 ? RN : 4;      // floats a Q0 load
  static constexpr int NCH = RN / V;
  // shared memory: the ring, two transposed buffers, the row sums
  static constexpr int A = TM * KC * 4;            // the rows' slice
  static constexpr int B = KC * QW * 4;            // Q0's slice
  static constexpr int STAGE = A + B + 2 * KC * 4; // + sd, y_res
  static constexpr int XST = STAGES * STAGE;
  static constexpr int SSXY = XST + (DIRECT ? 0 : 2 * KC * TM * 4);
  static constexpr int RED = SSXY + 2 * TM * 4;
  static constexpr int BAR = RED + TM * CG * 4;
  static constexpr int BYTES = BAR + STAGES * 8;
  static_assert((TM / RM) * CG == THREADS && RN % V == 0, "thread tile");
  static_assert(NPAD % KC == 0 && KC % 32 == 0, "stage width");
  static_assert(STAGE % 128 == 0 && (BYTES + 1024) * BLOCKS <= 233472,
                "shared memory");
};

// one stage into ring slot `st`, issued by every thread of the block: the
// rows' TM x KC slice from column k0 on, ALIGN bytes a cp.async, zero-filled
// outside (m, n), and (thread 0, cp.async.bulk) the stage's slices of Q0, sd
// and y_res; all of it completes on the slot's "full" mbarrier (THREADS
// arrivals and the bulk bytes)
template <class C, int ALIGN>
__device__ __forceinline__ void load_stage(const float* xr, long long m,
                                           int n, long long ld, long long r0,
                                           int s, const float* q0,
                                           const float* sd, const float* y_res,
                                           uint8_t* st, uint32_t full,
                                           int tid) {
  constexpr int KC = C::KC;
  constexpr int E = ALIGN / 4;           // floats a copy
  constexpr int CPR = KC / E;            // copies a row
  constexpr int PER = C::TM * CPR / THREADS;
  const int k0 = s * KC;
  if (tid == 0) {
    mbar_expect_tx(full, C::B + 2 * KC * 4);
    bulk_load(smem_u32(st + C::A), q0 + (long long)k0 * C::QW, C::B, full);
    bulk_load(smem_u32(st + C::A + C::B), sd + k0, KC * 4, full);
    bulk_load(smem_u32(st + C::A + C::B + KC * 4), y_res + k0, KC * 4, full);
  }
  float* sA = reinterpret_cast<float*>(st);
#pragma unroll 8
  for (int i = 0; i < PER; ++i) {
    const int u = tid + THREADS * i;
    const int r = u / CPR, c = (u % CPR) * E;
    const long long row = r0 + r;
    const bool in = row < m && k0 + c < n;
    const float* src = in ? xr + row * ld + k0 + c : xr;
    const uint32_t dst = smem_u32(sA + r * KC + c);
    if (ALIGN == 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                       "r"(dst), "l"(src), "r"(in ? 16 : 0)
                   : "memory");
    else
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::
                       "r"(dst), "l"(src), "n"(ALIGN), "r"(in ? ALIGN : 0)
                   : "memory");
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(full)
               : "memory");
}

template <int N>
__device__ __forceinline__ void lds(float (&v)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = *p;
  }
}

// ops/scan.py scan_epilogue for one row from its sums ss, xy and |cc|^2
__device__ __forceinline__ void epilogue(float* out, long long m,
                                         long long row, float ss, float xy,
                                         float c2, float rss0, float dof) {
  const float eps = 100.f * FLT_EPSILON;
  const float tiny = FLT_MIN;
  const float xx = ss - c2;
  const bool mask = xx > eps * fmaxf(ss, tiny);
  const float xx_safe = mask ? xx : 1.f;
  const float expl = mask ? fminf(xy * xy / xx_safe, rss0) : 0.f;
  const float rss1 = fmaxf(rss0 - expl, tiny);
  out[row] = mask ? expl * dof / rss1 : 0.f;
  out[m + row] = mask ? xy / xx_safe : 0.f;
  out[2 * m + row] = mask ? expl / rss0 : 0.f;
  out[3 * m + row] = mask ? 1.f : 0.f;
}

template <class C, int ALIGN>
__global__ void __launch_bounds__(THREADS, C::BLOCKS)
scan_stats_kernel(const float* __restrict__ xr, long long m, int n,
                  long long ld, int n_stages,
                  const float* __restrict__ q0 /* (n_stages*KC, QW) */,
                  const float* __restrict__ sd /* (n_stages*KC,) */,
                  const float* __restrict__ y_res, float rss0, float dof,
                  float* __restrict__ out) {
  constexpr int QW = C::QW, KC = C::KC, CG = C::CG, RM = C::RM, RN = C::RN;
  constexpr int V = C::V, NCH = C::NCH, TM = C::TM, WR = C::WR;
  constexpr int STAGES = C::STAGES;
  using L = C;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint32_t full0 = smem_u32(smem + L::BAR);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full0 + 8 * s, THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * TM;
  // the ring's first STAGES - 1 stages
  for (int s = 0; s < STAGES - 1 && s < n_stages; ++s)
    load_stage<C, ALIGN>(xr, m, n, ld, r0, s, q0, sd, y_res,
                         smem + s * L::STAGE, full0 + 8 * s, tid);

  float ssp[WR], xyp[WR];
#pragma unroll
  for (int i = 0; i < WR; ++i) ssp[i] = xyp[i] = 0.f;
  uint32_t parity = 0;

  if constexpr (C::DIRECT) {
    // a lane's partial sums of x . Q0[:, j] for its warp's rows
    float cp[WR][QW];
#pragma unroll
    for (int i = 0; i < WR; ++i)
#pragma unroll
      for (int j = 0; j < QW; ++j) cp[i][j] = 0.f;
    for (int s = 0; s < n_stages; ++s) {
      const int slot = s % STAGES;
      if (s > 0 && slot == 0) parity ^= 1u;
      // every thread is done with stage s - 1: its slot takes the next copy
      __syncthreads();
      if (s + STAGES - 1 < n_stages) {
        const int nx = (s + STAGES - 1) % STAGES;
        load_stage<C, ALIGN>(xr, m, n, ld, r0, s + STAGES - 1, q0, sd, y_res,
                             smem + nx * L::STAGE, full0 + 8 * nx, tid);
      }
      const uint8_t* st = smem + slot * L::STAGE;
      const float* sA = reinterpret_cast<const float*>(st);
      const float* sB = reinterpret_cast<const float*>(st + L::A);  // [j][k]
      const float* sS = reinterpret_cast<const float*>(st + L::A + L::B);
      mbar_wait(full0 + 8 * slot, parity);
      constexpr int HU = QW <= 8 ? 2 : 1;      // registers: cp, qk
#pragma unroll HU
      for (int h = 0; h < KC / 32; ++h) {
        const int k = lane + 32 * h;
        const float sdk = sS[k], yk = sS[KC + k];
        float qk[QW];
#pragma unroll
        for (int j = 0; j < QW; ++j) qk[j] = sB[j * KC + k];
#pragma unroll
        for (int i = 0; i < WR; ++i) {
          const float x = sA[(warp * WR + i) * KC + k] * sdk;
          ssp[i] += x * x;
          xyp[i] += x * yk;
#pragma unroll
          for (int j = 0; j < QW; ++j) cp[i][j] += x * qk[j];
        }
      }
    }
    // the sums over the lanes; lane i finishes row i of the warp
#pragma unroll
    for (int i = 0; i < WR; ++i) {
      float a = ssp[i], b = xyp[i], c2 = 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        b += __shfl_xor_sync(0xffffffffu, b, off);
      }
#pragma unroll
      for (int j = 0; j < QW; ++j) {
        float c = cp[i][j];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          c += __shfl_xor_sync(0xffffffffu, c, off);
        c2 += c * c;
      }
      const long long row = r0 + warp * WR + i;
      if (lane == i && row < m) epilogue(out, m, row, a, b, c2, rss0, dof);
    }
  } else {
  float* xsT = reinterpret_cast<float*>(smem + L::XST);
  float* ssS = reinterpret_cast<float*>(smem + L::SSXY);
  float* xyS = ssS + TM;
  float* red = reinterpret_cast<float*>(smem + L::RED);
  const int cg = tid % CG, rg = tid / CG;
  const int rbase = rg * RM;           // this thread's rows of the product
  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < n_stages; ++s) {
    const int slot = s % STAGES;
    if (s > 0 && slot == 0) parity ^= 1u;
    const uint8_t* st = smem + slot * L::STAGE;
    const float* sA = reinterpret_cast<const float*>(st);
    const float* sB = reinterpret_cast<const float*>(st + L::A);
    const float* sS = reinterpret_cast<const float*>(st + L::A + L::B);
    float* xb = xsT + (s & 1) * KC * TM;
    mbar_wait(full0 + 8 * slot, parity);
    // whiten: lane takes the columns k = lane + 32 h of its warp's rows
#pragma unroll
    for (int h = 0; h < KC / 32; ++h) {
      const int k = lane + 32 * h;
      const float sdk = sS[k], yk = sS[KC + k];
#pragma unroll
      for (int i = 0; i < WR; ++i) {
        const int r = warp * WR + i;
        const float x = sA[r * KC + k] * sdk;
        ssp[i] += x * x;
        xyp[i] += x * yk;
        xb[k * TM + (r ^ lane)] = x;
      }
    }
    // every thread is done with stage s - 1 (its product) and with this
    // stage's transposed buffer: its slot takes stage s + STAGES - 1
    __syncthreads();
    if (s + STAGES - 1 < n_stages) {
      const int nx = (s + STAGES - 1) % STAGES;
      load_stage<C, ALIGN>(xr, m, n, ld, r0, s + STAGES - 1, q0, sd, y_res,
                           smem + nx * L::STAGE, full0 + 8 * nx, tid);
    }
    // product: acc += xs[rows] (x) Q0[k, cols]
#pragma unroll 2
    for (int kb = 0; kb < KC; kb += 4) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int k = kb + kk;
        float a[RM];
        lds<RM>(a, xb + k * TM + (rbase ^ (k & 31 & ~(RM - 1))));
        float b[RN];
#pragma unroll
        for (int c = 0; c < NCH; ++c) {
          float t[V];
          lds<V>(t, sB + k * QW + V * cg + V * CG * c);
#pragma unroll
          for (int e = 0; e < V; ++e) b[V * c + e] = t[e];
        }
#pragma unroll
        for (int e = 0; e < RM; ++e)
#pragma unroll
          for (int j = 0; j < RN; ++j)
            acc[e ^ (kk & (RM - 1))][j] += a[e] * b[j];
      }
    }
  }

  // ss and xy of the warp's rows: sums over the lanes
#pragma unroll
  for (int i = 0; i < WR; ++i) {
    float a = ssp[i], b = xyp[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      b += __shfl_xor_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      ssS[warp * WR + i] = a;
      xyS[warp * WR + i] = b;
    }
  }
  // |cc|^2 of each of this thread's rows over its columns
#pragma unroll
  for (int e = 0; e < RM; ++e) {
    float c2 = 0.f;
#pragma unroll
    for (int j = 0; j < RN; ++j) c2 += acc[e][j] * acc[e][j];
    red[(rbase + e) * CG + cg] = c2;
  }
  __syncthreads();
  if (tid < TM && r0 + tid < m) {
    const long long row = r0 + tid;
    float c2 = 0.f;
#pragma unroll
    for (int g = 0; g < CG; ++g) c2 += red[tid * CG + g];
    epilogue(out, m, row, ssS[tid], xyS[tid], c2, rss0, dof);
  }
  }
}

template <int QW, int ALIGN>
int launch_t(const float* xr, long long m, int n, long long ld, int n_pad,
             const float* q0, const float* sd, const float* y_res, float rss0,
             float dof, float* out, cudaStream_t stream) {
  using C = Cfg<QW>;
  auto kern = scan_stats_kernel<C, ALIGN>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)((m + C::TM - 1) / C::TM), THREADS, C::BYTES, stream>>>(
      xr, m, n, ld, n_pad / C::KC, q0, sd, y_res, rss0, dof, out);
  return (int)cudaGetLastError();
}

template <int QW>
int launch_a(int align, const float* xr, long long m, int n, long long ld,
             int n_pad, const float* q0, const float* sd, const float* y_res,
             float rss0, float dof, float* out, cudaStream_t stream) {
  switch (align) {
    case 16:
      return launch_t<QW, 16>(xr, m, n, ld, n_pad, q0, sd, y_res, rss0, dof,
                              out, stream);
    case 8:
      return launch_t<QW, 8>(xr, m, n, ld, n_pad, q0, sd, y_res, rss0, dof,
                             out, stream);
    default:
      return launch_t<QW, 4>(xr, m, n, ld, n_pad, q0, sd, y_res, rss0, dof,
                             out, stream);
  }
}

}  // namespace

// xr: (m, n) f32 at row pitch ld (floats); q0: (n_pad, qw) f32 row-major,
// sd and y_res: (n_pad,) f32, all zero-padded to n_pad = a multiple of 64
// rows; qw in {8, 16, 32, 64, 96, 128}: Q0's width class
extern "C" int scan_stats(const void* xr, long long m, int n, long long ld,
                          const void* sd, const void* y_res, const void* q0,
                          int qw, int n_pad, float rss0, float dof, void* out,
                          void* stream) {
  if (m <= 0 || n <= 0 || ld < n || n_pad % NPAD || n_pad < n)
    return (int)cudaErrorInvalidValue;
  // the widest copy that no row start, pitch or row end splits
  const uintptr_t a = reinterpret_cast<uintptr_t>(xr) | (uintptr_t)(ld * 4) |
                      (uintptr_t)(n * 4);
  const int al = a % 16 == 0 ? 16 : a % 8 == 0 ? 8 : 4;
  const float* x = (const float*)xr;
  const float* q = (const float*)q0;
  const float* s = (const float*)sd;
  const float* y = (const float*)y_res;
  float* o = (float*)out;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (qw) {
#define K3_CASE(W)                                                         \
  case W:                                                                  \
    return launch_a<W>(al, x, m, n, ld, n_pad, q, s, y, rss0, dof, o, st);
    K3_CASE(8) K3_CASE(16) K3_CASE(32) K3_CASE(64) K3_CASE(96) K3_CASE(128)
#undef K3_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
