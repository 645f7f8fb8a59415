// K2: fused int8 digit-plane rotate + GLS F scan over 2-bit packed rows
// (Hopper).
//
// Replaces: mixmogam_tpu/ops/pallas_scan.py _make_int8_rotate_scan_kernel /
// _int8_rotate_scan_padded (pallas_rotate_scan_int8), and the int8xK tier
// the JAX main path runs in XLA (ops/scan.py apply_rotation +
// scan_epilogue via models/resident.py emmax_scan_packed).
//
// Xs = (sum_p 256^p * (G @ P_p)) * w_scale, with G the unpacked int8
// dosages and P_p the K int8 digit planes of W = U * sd; every plane product
// accumulates EXACTLY in int32 over all n inputs before the f32 recombine,
// low digit first (the XLA tier's numerics). Row sums and the GLS epilogue:
// rotate_scan_tile.cuh, shared with K5. Output (4, rows) = [f, beta,
// var_perc, mask].
//
// Bound on the H100: int8 tensor-core throughput (K * rows * n^2
// multiply-adds); device memory sees the planes once and the packed rows
// once, everything else is L2 traffic (the header says how it is held down).
// Design (the kernel's own part; ring, barriers and row sums are the
// header's): the K planes of one column step lie side by side along the
// wgmma N axis, CN = 192 / K columns each, so that every tier issues
// wgmma.mma_async m64n192k32 s8 x s8 -> s32 with one accumulator set of 96
// registers a 64-row tile, 192 a thread. A stage is 128 samples: the 8
// packed bytes a thread needs of each of its 4 rows are two aligned words,
// and one byte is one A register (4 consecutive samples). With 192
// accumulators there is no room for a second set of A registers, so a
// warpgroup unpacks and multiplies in turn and the two warpgroups overlap
// each other.

#include <cstdint>
#include <cuda_runtime.h>

#include "rotate_scan_tile.cuh"

namespace {

// one packed word (4 bytes of 4 samples, 2 bits each) -> 4 registers of 4
// int8 lanes, r[j] from byte j; code 3 (missing, or column padding beyond
// n) becomes 0. The four codes of every byte are masked out for the whole
// word at once and byte permutes gather them: 19 operations a word.
__device__ __forceinline__ void unpack_word(uint32_t w, uint32_t (&r)[4]) {
  const uint32_t m3 = w & (w >> 1) & 0x55555555u;
  w ^= m3 * 3u;
  const uint32_t c0 = w & 0x03030303u, c1 = (w >> 2) & 0x03030303u;
  const uint32_t c2 = (w >> 4) & 0x03030303u, c3 = (w >> 6) & 0x03030303u;
  const uint32_t lo01 = __byte_perm(c0, c1, 0x5140);  // bytes 0, 1: c0 c1
  const uint32_t lo23 = __byte_perm(c0, c1, 0x7362);  // bytes 2, 3
  const uint32_t hi01 = __byte_perm(c2, c3, 0x5140);  // bytes 0, 1: c2 c3
  const uint32_t hi23 = __byte_perm(c2, c3, 0x7362);
  r[0] = __byte_perm(lo01, hi01, 0x5410);
  r[1] = __byte_perm(lo01, hi01, 0x7632);
  r[2] = __byte_perm(lo23, hi23, 0x5410);
  r[3] = __byte_perm(lo23, hi23, 0x7632);
}

#define K2_D8(i)                                                       \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),          \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define K2_D32(i) K2_D8(i), K2_D8(i + 8), K2_D8(i + 16), K2_D8(i + 24)

// d (64 x 192, s32) += A (64 x 32 s8, registers) * B (32 x 192 s8, shared)
__device__ __forceinline__ void wgmma_m64n192k32_s8(int32_t (&d)[96],
                                                    const uint32_t (&a)[4],
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p;\n"
      "}\n"
      : K2_D32(0), K2_D32(32), K2_D32(64)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef K2_D32
#undef K2_D8

template <int NP, bool AL>
struct Int8Policy {
  static constexpr bool ALIGNED = AL;
  static constexpr int CN = 192 / NP;      // output columns a step
  static constexpr int KS = 128;           // samples a stage
  static constexpr int GB = KS / 4;        // packed bytes a row a stage
  static constexpr int GBW = GB + (AL ? 0 : 16);   // a row's window
  static constexpr int W_STAGE = 192 * KS; // bytes of a W stage image
  static constexpr int LBO = 24 * 128;     // between 16-byte K chunks
  static constexpr int STAGES = 5;
  static constexpr int NJ = CN / 8;

  struct State {
    int32_t acc[2][96];
    int shift[AL ? 1 : 4]; // where row (mt, hh)'s bytes start in its window
  };

  __device__ static __forceinline__ void init(State& s, const rscan::Args& a,
                                              long long row0, int warp,
                                              int g) {
#pragma unroll
    for (int i = 0; i < (AL ? 1 : 4); ++i)
      s.shift[i] = AL ? 0 : rscan::row_shift(a, row0 + (i >> 1) * 64 +
                                                    16 * warp + 8 * (i & 1) + g);
  }

  // One column step: all n samples into the step's int32 accumulators.
  // A stage goes in two halves of two k-steps: a thread unpacks one 32-bit
  // word of each of its 4 rows into the halves' 16 A registers, issues the
  // 4 wgmma and waits for them; meanwhile the other consumer warpgroup
  // unpacks or multiplies.
  __device__ static __forceinline__ void step(State& s, rscan::Ring& ring,
                                              int n_stages, int warp, int g,
                                              int t4) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 96; ++i) s.acc[mt][i] = 0;
    for (int st = 0; st < n_stages; ++st) {
      ring.wait_full();
      const uint32_t sW = ring.sW();
      // this thread's bytes 8 t4 .. 8 t4 + 7 of row (mt, hh): byte
      // 2 * ks + h is the A register of k-step ks, half h (samples
      // 16 h + 4 t4 ..+3 of the step)
      const uint8_t* sG = ring.sG() + (16 * warp + g) * GBW + 8 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t a[2][2][4];     // [k-step of the half][tile][register]
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            uint32_t r[4];
            unpack_word(rscan::lds_word<AL>(
                            sG + (mt * 64 + 8 * hh) * GBW +
                            s.shift[AL ? 0 : 2 * mt + hh] + 4 * half),
                        r);
#pragma unroll
            for (int ks = 0; ks < 2; ++ks) {
              a[ks][mt][hh] = r[2 * ks];
              a[ks][mt][2 + hh] = r[2 * ks + 1];
            }
          }
        rscan::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const uint64_t db =
              rscan::b_desc(sW + (2 * half + ks) * 2 * LBO, LBO);
          wgmma_m64n192k32_s8(s.acc[0], a[ks][0], db);
          wgmma_m64n192k32_s8(s.acc[1], a[ks][1], db);
        }
        rscan::wgmma_commit();
        rscan::wgmma_wait<0>();
      }
      ring.release(ring.slot);
      ring.advance();
    }
  }

  // recombine the planes in f32, low digit first, then the column's scale
  __device__ static __forceinline__ void finish_step(State& s,
                                                     float (&xs)[2][CN / 2],
                                                     const rscan::Args& a,
                                                     int j0, int t4) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 ws = __ldg(
          reinterpret_cast<const float2*>(a.w_scale + j0 + 8 * j + 2 * t4));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = (float)s.acc[mt][4 * j + e];
          float scale = 1.f;
#pragma unroll
          for (int p = 1; p < NP; ++p) {
            scale *= 256.f;
            x = x + (float)s.acc[mt][4 * (p * NJ + j) + e] * scale;
          }
          xs[mt][4 * j + e] = x * ((e & 1) ? ws.y : ws.x);
        }
    }
  }
};

}  // namespace

// w_img: the planes as stage images (hopper_scan.py prepare_int8_operand):
// [n_steps][n_stages][192 * 128] int8; w_scale / y_res: (n_steps * CN,)
// f32; q0t: (q, n_steps * CN) f32.
// K2 and K5 share one argument list: row_mean is K5's and is not read here.
extern "C" int rotate_scan_int8_packed(const void* packed, long long rows,
                                       int rb, int num_planes,
                                       const void* w_img, int n_steps,
                                       int n_stages, const void* w_scale,
                                       const void* y_res, const void* q0t,
                                       int q, const void* /*row_mean*/,
                                       float rss0, float dof, void* out,
                                       void* stream) {
  const rscan::Args a{(const uint8_t*)packed, rows, rb,
                      (const uint8_t*)w_img, n_steps, n_stages,
                      (const float*)w_scale, (const float*)y_res,
                      (const float*)q0t, q, nullptr, rss0, dof, (float*)out};
  auto s = (cudaStream_t)stream;
  switch (num_planes) {
    case 2: return rscan::launch<Int8Policy, 2>(a, s);
    case 3: return rscan::launch<Int8Policy, 3>(a, s);
    case 4: return rscan::launch<Int8Policy, 4>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
