// The fused rotate + GLS F-scan over 2-bit packed genotype rows on Hopper's
// tensor cores, shared by K2 (rotate_scan_int8.cu, int8 digit planes) and
// K5 (rotate_scan_bf16.cu, split-W bf16 parts).
//
// For a block of TM = 256 SNP rows, one column step after another: Xs = G @ W
// (the operand type, the decode of G and the accumulation are the two
// kernels' own: their Policy), then per row ss = sum Xs^2, xy = Xs . y_res
// and cc = Xs @ Q0 over all columns; Xs never reaches device memory. Each row
// then gets ops/scan.py scan_epilogue in f32: mask = xx > 100*eps*max(ss,
// tiny), expl clamped to rss0, rss1 floored at tiny, outputs zeroed
// off-mask, into out (4, rows) = [f, beta, var_perc, mask].
//
// Design.
//  * Three warpgroups a block, one block an SM. Two consumer warpgroups own
//    128 rows each (two 64-row wgmma tiles) and issue wgmma.mma_async with A
//    FROM REGISTERS and B from shared memory; the third is the producer and
//    gives most of its registers to the consumers (setmaxnreg: 2 x 128 x 240
//    + 128 x 24 is what the block was launched with, 384 x 168; a sum above
//    that makes the last warpgroup wait for ever).
//  * The contraction axis (samples) is the packed rows' contiguous axis, so
//    a wgmma A fragment register is decoded from one packed byte. The order
//    of the samples inside a stage is permuted (the sum does not care, and W
//    is laid out to match: hopper_scan.py _stage_perm), so that the bytes a
//    thread decodes in one stage are 8 (K2) or 4 (K5) consecutive bytes of
//    the raw packed row. The G side of a stage in shared memory is
//    nothing but those raw bytes, and each is decoded once for the whole
//    width of the column step and every plane / part.
//  * W is prepared once per rotated null (hopper_scan.py) as the exact
//    shared-memory image of every (column step, K stage): K-major 8 x 16-byte
//    core matrices, no swizzle, 128 bytes apart along the columns. A stage
//    of W is one contiguous block that one producer thread brings with
//    cp.async.bulk onto the stage's "full" mbarrier; the producer's 128
//    threads copy the stage's packed bytes with cp.async, 16 bytes a copy,
//    which arrive on the same barrier when they land (nothing waits in the
//    producer but "empty"). A pitch or a base that is no multiple of 16
//    bytes takes the aligned chunks around each row's bytes instead.
//    Consumers wait on "full", decode, issue, and arrive on "empty" when the
//    stage's wgmma have completed (K5 decodes the next stage meanwhile; K2's
//    two warpgroups overlap each other). A ring of Policy::STAGES stages.
//  * L2 traffic: every block re-reads all of W, so the block is tall (256
//    rows: half the bytes a multiply-add of a 128-row block) rather than a
//    cluster of two. A launch fills the card from one row block an SM on
//    (33,792 rows on 132 SMs).
//  * Row sums: after each column step ss, xy and cc go through quad
//    shuffles into the row's own shared slots (one writer a slot, no
//    atomics): results repeat bit for bit.

#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace rscan {

constexpr int TM = 256;        // SNP rows per block
constexpr int WG_ROWS = 128;   // rows per consumer warpgroup (2 wgmma tiles)
constexpr int THREADS = 384;   // 2 consumer warpgroups + 1 producer
constexpr int QMAX = 16;

// ---- PTX helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// wait until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "RSCAN_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra RSCAN_DONE;\n"
      "bra RSCAN_WAIT;\n"
      "RSCAN_DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// contiguous global -> shared copy by the copy engine, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wg_sync(int wg) {   // one consumer warpgroup
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// B operand descriptor: K-major, no swizzle; core matrices (8 columns x 16
// K-bytes, 128 contiguous bytes) 128 bytes apart along the columns and `lbo`
// bytes apart along K
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, int lbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(128 >> 4) << 32);
}

// ---- the kernels' arguments ------------------------------------------------

struct Args {
  const uint8_t* packed;   // (rows, rb) 2-bit codes, 4 samples a byte
  long long rows;
  int rb;
  const uint8_t* w_img;    // [column step][K stage] stage images
  int n_steps;             // column steps in all (n_out_pad / CN)
  int n_stages;            // K stages a column step (n_in_pad / KS)
  const float* w_scale;    // (n_out_pad,) K2 only
  const float* y_res;      // (n_out_pad,)
  const float* q0t;        // (q, n_out_pad): Q0 transposed
  int q;
  const float* row_mean;   // (rows,) or null, K5 only
  float rss0, dof;         // the null model's residual sum and n - q - 1
  float* out;              // (4, rows)
};

// ---- producer ----------------------------------------------------------------

// The packed bytes of one stage: a window of P::GBW bytes a row, copied with
// cp.async in 16-byte chunks that arrive on the stage's "full" barrier when
// they land (nothing in the producer waits for memory), zero-filled where a
// chunk lies outside the tensor.
//  * ALIGNED (the pitch ceil(n / 4) and the base address are multiples of
//    16 bytes): the window is the row's GB stage bytes.
//  * Otherwise a packed row starts at any address. The window is GB + 16
//    bytes: the GB / 16 + 1 aligned chunks that hold the row's stage bytes,
//    which start `row_shift` = (row address & 15) bytes into it, the same
//    for every stage; the consumers read their words there (lds_word).
//    Bytes of a window beyond the pitch are the next row's: they meet zero
//    entries of W. An aligned chunk that holds a byte of the tensor is read
//    whole: up to 15 bytes before its first or after its last byte, inside
//    the same 16-byte granule of the allocation.
__device__ __forceinline__ int row_shift(const Args& a, long long row) {
  return (int)((reinterpret_cast<uintptr_t>(a.packed) + row * a.rb) & 15);
}

template <int GB, bool ALIGNED>
__device__ __forceinline__ void load_g_stage(const Args& a, long long r0,
                                             int kbyte0, uint8_t* sG, int ptid,
                                             uint32_t full) {
  constexpr int CPR = GB / 16 + (ALIGNED ? 0 : 1);   // 16-byte chunks a row
  constexpr int PER = TM * CPR / 128;                // chunks a thread
  const uintptr_t lo = reinterpret_cast<uintptr_t>(a.packed);
  const uintptr_t hi = lo + a.rows * a.rb;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int u = ptid + i * 128;
    const uintptr_t c = ((lo + (r0 + u / CPR) * a.rb) & ~uintptr_t(15)) +
                        kbyte0 + (u % CPR) * 16;
    // (ALIGNED: chunks lie inside one row, so inside the pitch too)
    const bool in = ALIGNED ? c < hi && kbyte0 + (u % CPR) * 16 < a.rb
                            : c + 16 > lo && c < hi;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(sG + u * 16)),
                 "l"(in ? c : lo & ~uintptr_t(15)), "r"(in ? 16 : 0)
                 : "memory");
  }
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(full)
               : "memory");
}

// the 32-bit word at shared address p; without ALIGNED whatever its
// alignment (the word after the aligned one it starts in is read too: a
// row's window has room)
template <bool ALIGNED>
__device__ __forceinline__ uint32_t lds_word(const uint8_t* p) {
  if (ALIGNED) return *reinterpret_cast<const uint32_t*>(p);
  const uint32_t sh = (uint32_t)reinterpret_cast<uintptr_t>(p) & 3u;
  const uint32_t* q = reinterpret_cast<const uint32_t*>(p - sh);
  return __funnelshift_r(q[0], q[1], 8 * sh);
}

// ---- row sums ------------------------------------------------------------------

// xs: this thread's finished Xs values of the column step starting at
// column j0: element 4 * j + 2 * hh + ee of tile mt is row 16 * warp + 8 * hh
// + g of the tile, column j0 + 8 * j + 2 * t4 + ee. ssum, xsum (WG_ROWS) and
// cc (WG_ROWS, QMAX): the warpgroup's shared slots, one writer each.
template <int NJ>
__device__ __forceinline__ void step_sums(const float (&xs)[2][4 * NJ],
                                          int j0, int n_out_pad, int warp,
                                          int g, int t4, const Args& a,
                                          float* ssum, float* xsum,
                                          float* cc) {
  const float* yr = a.y_res + j0 + 2 * t4;
  float ss[4] = {0.f, 0.f, 0.f, 0.f}, xy[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float2 y = __ldg(reinterpret_cast<const float2*>(yr + 8 * j));
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float x0 = xs[mt][4 * j + 2 * hh];
        const float x1 = xs[mt][4 * j + 2 * hh + 1];
        ss[2 * mt + hh] += x0 * x0;
        ss[2 * mt + hh] += x1 * x1;
        xy[2 * mt + hh] += x0 * y.x;
        xy[2 * mt + hh] += x1 * y.y;
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], 1);
    ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], 2);
    xy[i] += __shfl_xor_sync(0xffffffffu, xy[i], 1);
    xy[i] += __shfl_xor_sync(0xffffffffu, xy[i], 2);
  }
  if (t4 == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int lr = (i >> 1) * 64 + 16 * warp + 8 * (i & 1) + g;
      ssum[lr] += ss[i];
      xsum[lr] += xy[i];
    }
  }
  for (int qq = 0; qq < a.q; ++qq) {
    const float* qr = a.q0t + (long long)qq * n_out_pad + j0 + 2 * t4;
    float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float2 v = __ldg(reinterpret_cast<const float2*>(qr + 8 * j));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          c[2 * mt + hh] += xs[mt][4 * j + 2 * hh] * v.x;
          c[2 * mt + hh] += xs[mt][4 * j + 2 * hh + 1] * v.y;
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c[i] += __shfl_xor_sync(0xffffffffu, c[i], 1);
      c[i] += __shfl_xor_sync(0xffffffffu, c[i], 2);
    }
    if (t4 == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cc[((i >> 1) * 64 + 16 * warp + 8 * (i & 1) + g) * QMAX + qq] += c[i];
    }
  }
}

// ---- the kernel ------------------------------------------------------------------
//
// Policy gives: CN (output columns a step), KS (samples a stage), GB (packed
// bytes a row a stage = KS / 4), ALIGNED and GBW (a row's window of packed
// bytes, above), W_STAGE (bytes of a W stage image), STAGES,
// a per-thread State, and the device functions
//   init(State&, Args, row0 of the warpgroup, warp, g)
//   step(State&, Ring&, n_stages, warp, g, t4)
//                        one column step: waits for, decodes, multiplies
//                        and releases n_stages stages of the ring; returns
//                        with every wgmma complete
//   finish_step(State&, xs, Args, j0, t4)   accumulators -> Xs values

// A consumer thread's view of the ring of stages.
struct Ring {
  uint8_t* smem;
  uint32_t full0, empty0;
  int stage_bytes, w_bytes, g_off;   // g_off: this warpgroup's packed rows
  int stages;
  int slot;
  uint32_t parity;

  __device__ __forceinline__ void wait_full() const {
    mbar_wait(full0 + 8 * slot, parity);
  }
  __device__ __forceinline__ uint32_t sW() const {
    return smem_u32(smem + slot * stage_bytes);
  }
  __device__ __forceinline__ const uint8_t* sG() const {
    return smem + slot * stage_bytes + w_bytes + g_off;
  }
  __device__ __forceinline__ void advance() {
    if (++slot == stages) { slot = 0; parity ^= 1u; }
  }
  // this thread is done with stage `s` (its wgmma complete, its bytes read)
  __device__ __forceinline__ void release(int s) const {
    mbar_arrive(empty0 + 8 * s);
  }
};

template <class P>
struct Layout {
  static constexpr int G_STAGE = TM * P::GBW;
  static constexpr int STAGE = P::W_STAGE + G_STAGE;
  static constexpr int CC = P::STAGES * STAGE;            // 2 x WG_ROWS x QMAX
  static constexpr int SUM = CC + 2 * WG_ROWS * QMAX * 4;  // ss, xy: TM each
  static constexpr int BAR = SUM + 2 * TM * 4;
  static constexpr int BYTES = BAR + 2 * P::STAGES * 8;
  static_assert(P::W_STAGE % 128 == 0 && G_STAGE % 128 == 0, "alignment");
  static_assert(BYTES <= 232448, "shared memory a block may use");
};

template <class P>
__global__ void __launch_bounds__(THREADS, 1) rotate_scan_kernel(const Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  using L = Layout<P>;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const uint32_t full0 = smem_u32(smem + L::BAR);
  const uint32_t empty0 = full0 + P::STAGES * 8;
  if (tid == 0) {
    for (int s = 0; s < P::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 128);    // the producer's threads (+ W bytes)
      mbar_init(empty0 + 8 * s, 256);   // the consumers' threads
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const long long r0 = (long long)blockIdx.x * TM;

  if (wg == 2) {
    // ===== producer =====
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    const int ptid = tid - 256;
    int slot = 0;
    uint32_t parity = 1;              // the ring starts empty
    for (int js = 0; js < a.n_steps; ++js) {
      const uint8_t* wsrc =
          a.w_img + (long long)js * a.n_stages * P::W_STAGE;
      for (int ks = 0; ks < a.n_stages; ++ks) {
        uint8_t* st = smem + slot * L::STAGE;
        mbar_wait(empty0 + 8 * slot, parity);
        if (ptid == 0) {
          mbar_expect_tx(full0 + 8 * slot, P::W_STAGE);
          bulk_load(smem_u32(st), wsrc + (long long)ks * P::W_STAGE,
                    P::W_STAGE, full0 + 8 * slot);
        }
        load_g_stage<P::GB, P::ALIGNED>(a, r0, ks * P::GB, st + P::W_STAGE,
                                        ptid, full0 + 8 * slot);
        if (++slot == P::STAGES) { slot = 0; parity ^= 1u; }
      }
    }
  } else {
    // ===== consumers =====
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wtid = tid & 127;
    const int warp = wtid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    float* cc = reinterpret_cast<float*>(smem + L::CC) + wg * WG_ROWS * QMAX;
    float* ssum = reinterpret_cast<float*>(smem + L::SUM) + wg * WG_ROWS;
    float* xsum = ssum + TM;
    for (int i = wtid; i < WG_ROWS * QMAX; i += 128) cc[i] = 0.f;
    ssum[wtid] = 0.f;
    xsum[wtid] = 0.f;
    wg_sync(wg);

    typename P::State st;
    P::init(st, a, r0 + wg * WG_ROWS, warp, g);
    const int n_out_pad = a.n_steps * P::CN;

    Ring ring{smem, full0, empty0, L::STAGE, P::W_STAGE,
              wg * WG_ROWS * P::GBW, P::STAGES, 0, 0u};
    for (int js = 0; js < a.n_steps; ++js) {
      P::step(st, ring, a.n_stages, warp, g, t4);
      float xs[2][P::CN / 2];
      P::finish_step(st, xs, a, js * P::CN, t4);
      step_sums<P::CN / 8>(xs, js * P::CN, n_out_pad, warp, g, t4, a, ssum, xsum,
                           cc);
    }

    wg_sync(wg);
    // one row a thread: the GLS epilogue
    const long long row = r0 + wg * WG_ROWS + wtid;
    if (row < a.rows) {
      const float ss = ssum[wtid], xy = xsum[wtid];
      float c2 = 0.f;
      for (int qq = 0; qq < a.q; ++qq) {
        const float c = cc[wtid * QMAX + qq];
        c2 += c * c;
      }
      const float eps = 100.f * FLT_EPSILON;
      const float tiny = FLT_MIN;
      const float xx = ss - c2;
      const bool mask = xx > eps * fmaxf(ss, tiny);
      const float xx_safe = mask ? xx : 1.f;
      const float expl = mask ? fminf(xy * xy / xx_safe, a.rss0) : 0.f;
      const float rss1 = fmaxf(a.rss0 - expl, tiny);
      a.out[row] = mask ? expl * a.dof / rss1 : 0.f;
      a.out[a.rows + row] = mask ? xy / xx_safe : 0.f;
      a.out[2 * a.rows + row] = mask ? expl / a.rss0 : 0.f;
      a.out[3 * a.rows + row] = mask ? 1.f : 0.f;
    }
  }
}

template <class P>
inline int launch_t(const Args& a, cudaStream_t stream) {
  if (a.rows <= 0 || a.q < 0 || a.q > QMAX || a.n_steps < 1 ||
      a.n_stages < 1)
    return (int)cudaErrorInvalidValue;
  auto kern = rotate_scan_kernel<P>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<P>::BYTES);
  if (err != cudaSuccess) return (int)err;
  kern<<<(unsigned)((a.rows + TM - 1) / TM), THREADS, Layout<P>::BYTES,
         stream>>>(a);
  return (int)cudaGetLastError();
}

// Policy<NP, ALIGNED> by what the packed rows' pitch and address allow
template <template <int, bool> class Policy, int NP>
inline int launch(const Args& a, cudaStream_t stream) {
  const bool aligned =
      a.rb % 16 == 0 && reinterpret_cast<uintptr_t>(a.packed) % 16 == 0;
  return aligned ? launch_t<Policy<NP, true>>(a, stream)
                 : launch_t<Policy<NP, false>>(a, stream);
}

}  // namespace rscan
