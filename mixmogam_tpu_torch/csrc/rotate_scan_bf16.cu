// K5: fused split-W bf16 rotate + GLS F scan over 2-bit packed rows
// (Hopper).
//
// Replaces: mixmogam_tpu/ops/pallas_scan.py _make_rotate_scan_kernel /
// _rotate_scan_padded (pallas_rotate_scan), and the bf16 / bf16x2 / bf16x3
// tiers the JAX main path runs in XLA (ops/scan.py apply_rotation +
// scan_epilogue via models/resident.py emmax_scan_packed).
//
// Xs = G @ (P_0 + ... + P_{K-1}), with G the unpacked dosages as bf16
// (missing codes replaced by the row's mean rounded to bf16 when row means
// are given, else 0) and P_p the K bf16 split-W parts of W = U * sd. Every
// bf16 x bf16 product is exact and accumulates in f32 on the tensor cores.
// Their f32 accumulation drops the low bits of addends much smaller than the
// running sum (truncating alignment), so a sum over all n samples in one
// accumulator drifts from the float64 plain version. Hence the sums are kept
// short: one accumulator takes one 64-sample chunk of every part, smallest
// part first (the parts stacked along K), and is then added into a running
// f32 sum in registers with IEEE round-to-nearest. Row sums and the GLS
// epilogue: rotate_scan_tile.cuh, shared with K2. Output (4, rows) = [f,
// beta, var_perc, mask].
//
// Bound on the H100: bf16 tensor-core throughput (K * rows * n^2
// multiply-adds); device memory sees the parts and the packed rows once,
// everything else is L2 traffic (the header says how it is held down).
// Design (the kernel's own part; ring, barriers and row sums are the
// header's): a stage is one 64-sample chunk of a 64-column step for all K
// parts; a consumer warpgroup issues wgmma.mma_async m64n64k16 bf16 x bf16
// -> f32 for its two 64-row tiles, 4 k-steps a part. The sample order inside
// a chunk is permuted so that the 16 samples a thread feeds into the 4
// k-steps are ONE 32-bit word of the packed row, and byte s of it is the two
// A registers of k-step s. The decode is a table look-up in registers: the
// bf16 low and high bytes of the four codes {0, 1, 2, missing -> the row's
// mean} are two 4-byte pools a row, and one byte permute (prmt) with two
// codes in its selector nibbles gives two bf16 values; the selectors come
// from the whole word at once (27 operations for its 8 registers). The A
// registers of a chunk are decoded once and serve every part; two sets
// alternate, so the next chunk is decoded while this one's wgmma run.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rotate_scan_tile.cuh"

namespace {

#define K5_D8(i)                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64, f32) = A (64 x 16 bf16, registers) * B (16 x 64 bf16, shared,
// K-major) + (acc ? d : 0)
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32],
                                                     const uint32_t (&a)[4],
                                                     uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : K5_D8(0), K5_D8(8), K5_D8(16), K5_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc));
}

#undef K5_D8

template <int NP, bool AL>
struct Bf16Policy {
  static constexpr bool ALIGNED = AL;
  static constexpr int CN = 64;             // output columns a step
  static constexpr int KS = 64;             // samples a stage (one chunk)
  static constexpr int GB = KS / 4;         // packed bytes a row a stage
  static constexpr int GBW = GB + (AL ? 0 : 16);    // a row's window
  static constexpr int W_PART = CN * KS * 2;   // bytes of one part's image
  static constexpr int W_STAGE = NP * W_PART;
  static constexpr int LBO = 8 * 128;       // between 16-byte K chunks
  static constexpr int STAGES = NP == 3 ? 6 : 8;

  struct State {
    float run[2][32];      // the running IEEE f32 sums of this column step
    uint32_t lo[4], hi[4]; // the code -> bf16 byte pools of rows (mt, hh)
    int shift[4];          // where the row's bytes start in its window
  };

  __device__ static __forceinline__ void init(State& s, const rscan::Args& a,
                                              long long row0, int warp,
                                              int g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long row = row0 + (i >> 1) * 64 + 16 * warp + 8 * (i & 1) + g;
      uint32_t mb = 0u;
      if (a.row_mean != nullptr && row < a.rows)
        mb = __bfloat16_as_ushort(__float2bfloat16_rn(a.row_mean[row]));
      // bytes by code: 0 -> 0x0000, 1 -> 0x3F80, 2 -> 0x4000, 3 -> mb
      s.shift[i] = AL ? 0 : rscan::row_shift(a, row);
      s.lo[i] = 0x00008000u | ((mb & 0xFFu) << 24);
      s.hi[i] = 0x00403F00u | ((mb >> 8) << 24);
    }
  }

  // the A registers of one chunk from the warpgroup's packed bytes
  __device__ static __forceinline__ void decode(const State& s,
                                                uint32_t (&a)[4][2][4],
                                                const uint8_t* sG, int warp,
                                                int g, int t4) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const uint32_t w = rscan::lds_word<AL>(
            sG + (mt * 64 + 16 * warp + 8 * hh + g) * GBW +
            s.shift[2 * mt + hh] + 4 * t4);
        const uint32_t lo = s.lo[2 * mt + hh], hi = s.hi[2 * mt + hh];
        // code i of every byte, masked out for the whole word at once,
        // then as the selector byte (c, 4 + c) = 0x40 + 0x11 c: low byte
        // of the code's bf16 from `lo`, high byte from `hi`
        const uint32_t s0 = (w & 0x03030303u) * 0x11u + 0x40404040u;
        const uint32_t s1 = ((w >> 2) & 0x03030303u) * 0x11u + 0x40404040u;
        const uint32_t s2 = ((w >> 4) & 0x03030303u) * 0x11u + 0x40404040u;
        const uint32_t s3 = ((w >> 6) & 0x03030303u) * 0x11u + 0x40404040u;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {     // byte ks of the word
          const uint32_t sel01 = __byte_perm(s0, s1, 0x40 + 0x11 * ks);
          const uint32_t sel23 = __byte_perm(s2, s3, 0x40 + 0x11 * ks);
          a[ks][mt][hh] = __byte_perm(lo, hi, sel01);      // k 2t, 2t+1
          a[ks][mt][2 + hh] = __byte_perm(lo, hi, sel23);  // k 2t+8, 2t+9
        }
      }
  }

  __device__ static __forceinline__ void add(State& s,
                                             const float (&acc)[2][32]) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) s.run[mt][i] += acc[mt][i];
  }

  // One chunk: its wgmma from the decoded registers `a`; while they run,
  // the next chunk (if any) is decoded into `an`; then the chunk's sums go
  // into the running sums and its stage is released.
  __device__ static __forceinline__ void chunk(State& s, rscan::Ring& ring,
                                               const uint32_t (&a)[4][2][4],
                                               uint32_t (&an)[4][2][4],
                                               bool has_next, int warp, int g,
                                               int t4) {
    const uint32_t sW = ring.sW();
    const int cur = ring.slot;
    float acc[2][32];
    rscan::wgmma_fence();
#pragma unroll
    for (int p = NP - 1; p >= 0; --p) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t db =
            rscan::b_desc(sW + p * W_PART + ks * 2 * LBO, LBO);
        const int first = ks == 0 && p == NP - 1;
        wgmma_m64n64k16_bf16(acc[0], a[ks][0], db, !first);
        wgmma_m64n64k16_bf16(acc[1], a[ks][1], db, !first);
      }
    }
    rscan::wgmma_commit();
    ring.advance();
    if (has_next) {
      ring.wait_full();
      decode(s, an, ring.sG(), warp, g, t4);
    }
    rscan::wgmma_wait<0>();
    add(s, acc);
    ring.release(cur);
  }

  __device__ static __forceinline__ void step(State& s, rscan::Ring& ring,
                                              int n_stages, int warp, int g,
                                              int t4) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) s.run[mt][i] = 0.f;
    uint32_t a0[4][2][4], a1[4][2][4];   // [k-step][tile][register], in turn
    ring.wait_full();
    decode(s, a0, ring.sG(), warp, g, t4);
    for (int st = 0; st < n_stages; st += 2) {
      chunk(s, ring, a0, a1, st + 1 < n_stages, warp, g, t4);
      if (st + 1 < n_stages)
        chunk(s, ring, a1, a0, st + 2 < n_stages, warp, g, t4);
    }
  }

  __device__ static __forceinline__ void finish_step(State& s,
                                                     float (&xs)[2][CN / 2],
                                                     const rscan::Args&, int,
                                                     int) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) xs[mt][i] = s.run[mt][i];
  }
};

}  // namespace

// w_img: the parts as stage images (hopper_scan.py prepare_bf16_operand):
// [n_steps][n_stages][num_parts][64 * 64] bf16; y_res: (n_steps * 64,) f32;
// q0t: (q, n_steps * 64) f32; row_mean: (rows,) f32 or null (fully observed:
// missing codes count as 0).
// K2 and K5 share one argument list: w_scale is K2's and is not read here.
extern "C" int rotate_scan_bf16_packed(const void* packed, long long rows,
                                       int rb, int num_parts,
                                       const void* w_img, int n_steps,
                                       int n_stages, const void* /*w_scale*/,
                                       const void* y_res, const void* q0t,
                                       int q, const void* row_mean,
                                       float rss0, float dof, void* out,
                                       void* stream) {
  const rscan::Args a{(const uint8_t*)packed, rows, rb,
                      (const uint8_t*)w_img, n_steps, n_stages, nullptr,
                      (const float*)y_res, (const float*)q0t, q,
                      (const float*)row_mean, rss0, dof, (float*)out};
  auto s = (cudaStream_t)stream;
  switch (num_parts) {
    case 1: return rscan::launch<Bf16Policy, 1>(a, s);
    case 2: return rscan::launch<Bf16Policy, 2>(a, s);
    case 3: return rscan::launch<Bf16Policy, 3>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
