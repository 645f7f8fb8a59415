// The IBS sharing-count gram over 2-bit packed genotype rows on Hopper's
// int8 tensor cores, shared by K1 (ibs_gram.cu, every row, base
// ploidy*M) and K4 (ibs_gram_tri.cu, a row range, base ploidy*(e - s)).
//
// S[i][j] = base - sum_k |g_ki - g_kj| (int32) over the `rows` packed rows
// given. Dosages enter in thermometer code, one 0/1 plane for binary
// genotypes (z = [g >= 1]) and two for diploid ones (u = [g >= 1],
// v = [g >= 2], stacked along the contraction), so that
// |a - b| = sum over planes of z_a + z_b - 2 z_a z_b and
//   S = base - d_i - d_j + 2 D,   D = Z^T Z,   d = column sums of Z,
// which is one s8 x s8 -> s32 gram for either ploidy. Zero pad rows and rows
// past `rows` are zero in every plane and add nothing.
//
// Bound on the H100: the tensor cores' dense s8 rate (1,979 TOP/s): the
// upper triangle of n^2 * planes * rows MACs. The packed input is n/4 bytes
// a row (device memory: microseconds), but every block reads (128 + 256)/4
// bytes a row for its two strips, gigabytes over the grid, so those reads
// have to come from L2: the grid's blocks start together and walk the SNP
// axis at the same pace, so blocks in flight read the same rows.
//
// Design.
//  * Pre-pass (ibs_colsum_kernel): d, the column sums of the planes, by
//    atomics into an n-vector the wrapper allocates. It reads the packed
//    rows once; the gram's epilogue then needs no other block's diagonal
//    and no second pass over the n x n output.
//  * Gram (ibs_gram_kernel): one block of 256 threads (two warpgroups) per
//    128 x 256 output tile (bi, bj) that holds an element with i <= j, that
//    is bi <= 2 bj + 1. Each warpgroup accumulates 64 x 256 in 128 int32
//    registers a thread with wgmma.mma_async m64n256k32.s32.s8.s8, both
//    operands from shared memory.
//  * Unpack with transpose. wgmma takes 8-bit operands K-major only and the
//    contraction (SNP) axis is the container's strided axis. A thread loads
//    one 32-bit word (16 samples) from each of 16/planes consecutive rows,
//    transposes 4 x 4 byte blocks with __byte_perm so that a word w holds
//    the bytes of 4 consecutive rows for the same 4 samples, and then
//    (w >> 2s) & 0x01010101 is sample s's plane at those 4 SNPs, K-major.
//    Four such words are one 16-byte row of a wgmma core matrix.
//  * Operand layout: no swizzle; core matrices (8 samples x 16 K-bytes, 128
//    contiguous bytes) at a pitch of 144 bytes, and the 16 samples of a
//    loaded word split into two row groups that lie a half strip apart. So
//    the eight threads of a store phase write eight different 16-byte bank
//    groups (no conflicts) and the sample order inside a strip is a
//    permutation, which the epilogue undoes (strip_sample).
//  * Overlap: two stages of 256 K-bytes (256 / planes rows) in dynamic
//    shared memory. While the tensor cores run the eight wgmma of stage t,
//    the same warps unpack stage t + 1 from words already in registers and
//    then load stage t + 2's words, which have until the next round's
//    unpack to arrive; fence.proxy.async orders the stores before the next
//    wgmma.
//  * Epilogue: S = base - d_i - d_j + 2 D from the accumulators, stored to
//    (i, j) for i <= j and mirrored to (j, i) by the same block (transposed
//    through shared memory, so that both stores run along output rows): the
//    lower triangle costs one more store and no pass over the output.
//  * A pitch that is not a multiple of 4 bytes (the wrapper decides) takes
//    other loads (WIDE = false): a word is cut out of the two aligned words
//    around it, or gathered byte by byte at the edges of the range and the
//    pitch; the arithmetic is the same.

#pragma once

#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace ibs {

constexpr int TI = 128;             // output tile rows (samples i)
constexpr int TJ = 256;             // output tile columns (samples j)
constexpr int THREADS = 256;        // two warpgroups, 64 tile rows each
constexpr int KS = 256;             // K bytes (plane rows) per stage
constexpr int KCH = KS / 16;        // 16-byte K chunks per stage
constexpr int CM = 144;             // core-matrix pitch in bytes (128 + 16)
constexpr int NCW_I = TI / 16;      // 32-bit column words per strip row
constexpr int NCW_J = TJ / 16;
constexpr int NCW = NCW_I + NCW_J;
constexpr int LBO_I = (TI / 8) * CM;   // bytes between K chunks
constexpr int LBO_J = (TJ / 8) * CM;
constexpr int STRIP_I = KCH * LBO_I;
constexpr int STAGE = STRIP_I + KCH * LBO_J;
constexpr int SMEM_BYTES = 2 * STAGE;  // 221,184 of the 232,448 a block may use
constexpr int UNITS = KCH * NCW;       // (K chunk, column word) pairs a stage
static_assert(UNITS > THREADS && UNITS <= 2 * THREADS, "unit split");

// sample offset inside a strip of T samples held by operand row x
__device__ __forceinline__ int strip_sample(int x, int T) {
  const int p = x >> 3;             // row group = half * (T / 16) + word
  return 16 * (p % (T / 16)) + 8 * (p / (T / 16)) + (x & 7);
}

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, int lbo) {
  // no swizzle, K-major: leading offset between K chunks, stride offset
  // between 8-row groups, both in 16-byte units
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(CM >> 4) << 32);
}

#define IBS_R4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define IBS_R16(i) IBS_R4(i), IBS_R4(i + 4), IBS_R4(i + 8), IBS_R4(i + 12)

__device__ __forceinline__ void wgmma_m64n256k32_s8(int32_t (&d)[128],
                                                    uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
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
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p;\n"
      "}\n"
      : IBS_R16(0), IBS_R16(16), IBS_R16(32), IBS_R16(48), IBS_R16(64),
        IBS_R16(80), IBS_R16(96), IBS_R16(112)
      : "l"(da), "l"(db), "r"(1));
}

#undef IBS_R16
#undef IBS_R4

// One unit of the unpack: K chunk kc (16 K-bytes = 16 / PLOIDY packed rows)
// of the 16 samples of column word cw (0..7 the i strip, 8..23 the j strip).
template <int PLOIDY>
struct Unit {
  static constexpr int ROWS = 16 / PLOIDY;
  uint32_t w[ROWS];
  const uint8_t* ptr;   // the unit's first row in the next stage to load
  long long left;       // rows of the range from that row on (may be <= 0)
  int nbytes;           // bytes of the column word inside the pitch, 0..4
  int smem_off;         // of sample 0's 16 bytes inside the stage
  int half_off;         // from samples 0..7 to samples 8..15

  __device__ __forceinline__ void init(const uint8_t* __restrict__ packed,
                                       long long rows, int rb, int i0, int j0,
                                       int u) {
    const int kc = u / NCW, cw = u % NCW;
    const bool is_j = cw >= NCW_I;
    const int cwl = is_j ? cw - NCW_I : cw;
    const int bytecol = (is_j ? j0 : i0) / 4 + 4 * cwl;
    smem_off = (is_j ? STRIP_I + kc * LBO_J : kc * LBO_I) + cwl * CM;
    half_off = (is_j ? NCW_J : NCW_I) * CM;
    nbytes = max(0, min(4, rb - bytecol));
    ptr = packed + (long long)kc * ROWS * rb + bytecol;
    left = rows - kc * ROWS;
  }

  // this stage's words into w (zeros outside the range and the pitch),
  // then on to the next stage
  template <bool WIDE>
  __device__ __forceinline__ void load(int rb, long long stage_bytes) {
    const uint8_t* p = ptr;
#pragma unroll
    for (int r = 0; r < ROWS; ++r, p += rb) {
      uint32_t v = 0u;
      if (WIDE) {
        if (r < left && nbytes > 0)
          v = __ldg(reinterpret_cast<const uint32_t*>(p));
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (r < left && b < nbytes) v |= (uint32_t)__ldg(p + b) << (8 * b);
      }
      w[r] = v;
    }
    ptr += stage_bytes;
    left -= KS / PLOIDY;
  }

  // the same for a stage that lies whole inside the range and the pitch,
  // with more rows after it: no bounds to check. Without WIDE the word
  // comes from the two aligned words around it (the second may reach up to
  // 4 bytes past the word, into the rows that follow).
  template <bool WIDE>
  __device__ __forceinline__ void load_fast(int rb, long long stage_bytes) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const uint8_t* p = ptr + (long long)r * rb;
      if (WIDE) {
        w[r] = __ldg(reinterpret_cast<const uint32_t*>(p));
      } else {
        const uintptr_t q = reinterpret_cast<uintptr_t>(p);
        const uint32_t* a = reinterpret_cast<const uint32_t*>(q & ~uintptr_t(3));
        w[r] = __funnelshift_r(__ldg(a), __ldg(a + 1), ((uint32_t)q & 3u) * 8);
      }
    }
    ptr += stage_bytes;
    left -= KS / PLOIDY;
  }

  __device__ __forceinline__ void store(uint8_t* __restrict__ stage) const {
    // t[g][c]: byte column c of rows 4g..4g+3, one byte a row
    uint32_t t[ROWS / 4][4];
#pragma unroll
    for (int g = 0; g < ROWS / 4; ++g) {
      const uint32_t x0 = __byte_perm(w[4 * g], w[4 * g + 1], 0x5140);
      const uint32_t x1 = __byte_perm(w[4 * g + 2], w[4 * g + 3], 0x5140);
      const uint32_t y0 = __byte_perm(w[4 * g], w[4 * g + 1], 0x7362);
      const uint32_t y1 = __byte_perm(w[4 * g + 2], w[4 * g + 3], 0x7362);
      t[g][0] = __byte_perm(x0, x1, 0x5410);
      t[g][1] = __byte_perm(x0, x1, 0x7632);
      t[g][2] = __byte_perm(y0, y1, 0x5410);
      t[g][3] = __byte_perm(y0, y1, 0x7632);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t o[4];
        if (PLOIDY == 1) {
#pragma unroll
          for (int g = 0; g < 4; ++g)
            o[g] = (t[g][c] >> (2 * s)) & 0x01010101u;
        } else {
#pragma unroll
          for (int g = 0; g < 2; ++g) {
            const uint32_t x = (t[g][c] >> (2 * s)) & 0x03030303u;
            const uint32_t h = x >> 1;
            o[2 * g] = (x | h) & 0x01010101u;      // u = [g >= 1]
            o[2 * g + 1] = h & 0x01010101u;        // v = [g >= 2]
          }
        }
        const int q = 4 * c + s;    // sample of the word's 16
        *reinterpret_cast<uint4*>(stage + smem_off + (q >> 3) * half_off +
                                  (q & 7) * 16) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  }
};

// d[i] = sum over rows and planes of sample i's thermometer bits
template <int PLOIDY>
__global__ void __launch_bounds__(128)
ibs_colsum_kernel(const uint8_t* __restrict__ packed, long long rows, int rb,
                  int n, int rows_per_block, int32_t* __restrict__ d) {
  const int bc = blockIdx.x * blockDim.x + threadIdx.x;
  if (bc >= rb) return;
  const long long r0 = (long long)blockIdx.y * rows_per_block;
  const long long r1 = min(rows, r0 + rows_per_block);
  int cnt[4] = {0, 0, 0, 0};
  for (long long r = r0; r < r1; ++r) {
    const uint32_t b = __ldg(packed + r * rb + bc);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t x = (b >> (2 * s)) & 3u;
      cnt[s] += PLOIDY == 1 ? (x & 1u) : (((x | (x >> 1)) & 1u) + (x >> 1));
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s)
    if (4 * bc + s < n && cnt[s] != 0) atomicAdd(d + 4 * bc + s, cnt[s]);
}

template <int PLOIDY, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
ibs_gram_kernel(const uint8_t* __restrict__ packed, long long rows, int rb,
                int n, int base, const int32_t* __restrict__ d,
                int32_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int STAGE_ROWS = KS / PLOIDY;

  // blockIdx.x -> (bi, bj) with bi <= 2 bj + 1, column by column
  const int ni = (n + TI - 1) / TI;
  int p = blockIdx.x, bj = 0;
  for (;; ++bj) {
    const int cnt = min(ni, 2 * bj + 2);
    if (p < cnt) break;
    p -= cnt;
  }
  const int i0 = p * TI, j0 = bj * TJ;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const bool two = tid + THREADS < UNITS;   // the first 128 threads

  int32_t acc[128];
#pragma unroll
  for (int r = 0; r < 128; ++r) acc[r] = 0;

  Unit<PLOIDY> ua, ub;
  const long long nstage = (rows + STAGE_ROWS - 1) / STAGE_ROWS;
  const long long stage_bytes = (long long)STAGE_ROWS * rb;
  ua.init(packed, rows, rb, i0, j0, tid);
  if (two) ub.init(packed, rows, rb, i0, j0, tid + THREADS);
  auto store_stage = [&](uint8_t* stage) {
    ua.store(stage);
    if (two) ub.store(stage);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  };
  // LOAD: 0 nothing, 1 the next stage's words with bounds checked, 2
  // without (load_fast)
  auto load_stage = [&](auto how) {
    constexpr int LOAD = decltype(how)::value;
    if (LOAD == 2) {
      ua.template load_fast<WIDE>(rb, stage_bytes);
      if (two) ub.template load_fast<WIDE>(rb, stage_bytes);
    } else if (LOAD == 1) {
      ua.template load<WIDE>(rb, stage_bytes);
      if (two) ub.template load<WIDE>(rb, stage_bytes);
    }
  };
  const uint32_t sbase = (uint32_t)__cvta_generic_to_shared(smem);
  // one round: the wgmma of stage kt; meanwhile stage kt + 1 is unpacked
  // from the words in registers (STORE) and stage kt + 2's words are
  // loaded, which then have until the next round's unpack to arrive
  auto round = [&](long long kt, auto store, auto how) {
    const int cur = (int)(kt & 1);
    const uint32_t sa = sbase + cur * STAGE + wg * 8 * CM;
    const uint32_t sb = sbase + cur * STAGE + STRIP_I;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < KCH / 2; ++ks)
      wgmma_m64n256k32_s8(acc, smem_desc(sa + ks * 2 * LBO_I, LBO_I),
                          smem_desc(sb + ks * 2 * LBO_J, LBO_J));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the other stage's last reader finished before the barrier below
    // was passed in the previous round
    if (decltype(store)::value) store_stage(smem + (cur ^ 1) * STAGE);
    load_stage(how);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    __syncthreads();
  };
  using No = std::integral_constant<int, 0>;
  using Yes = std::integral_constant<int, 1>;     // store; checked load
  using Fast = std::integral_constant<int, 2>;
  // every stage but the last lies whole inside the range; a tile whose two
  // strips lie whole inside the pitch loads those without checks
  const bool fast = i0 / 4 + TI / 4 <= rb && j0 / 4 + TJ / 4 <= rb;
  if (fast && nstage > 1) load_stage(Fast{}); else load_stage(Yes{});
  store_stage(smem);
  if (fast && nstage > 2) load_stage(Fast{});
  else if (nstage > 1) load_stage(Yes{});
  __syncthreads();
  long long kt = 0;
  if (fast)
    for (; kt + 3 < nstage; ++kt) round(kt, Yes{}, Fast{});
  for (; kt + 2 < nstage; ++kt) round(kt, Yes{}, Yes{});
  if (kt + 1 < nstage) round(kt++, Yes{}, No{});
  round(kt, No{}, No{});

  // accumulator fragment: register 4*jn + 2*hh + ee of lane l in warp w is
  // operand row 64*wg + 16*w + 8*hh + l/4, operand column 8*jn + 2*(l%4) + ee.
  // (i, j) is stored from the registers; the mirror (j, i) goes through
  // shared memory (free after the last round) as T[j][i], so that a warp
  // writes 32 consecutive entries of an output row.
  int32_t* T = reinterpret_cast<int32_t*>(smem);
  constexpr int TP = TI + 4;        // row pitch in words: no bank conflicts
  static_assert(TJ * TP * 4 <= SMEM_BYTES, "mirror tile");
  const int w = (tid & 127) >> 5, lane = tid & 31;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int il = strip_sample(64 * wg + 16 * w + 8 * hh + (lane >> 2), TI);
    const int i = i0 + il;
    if (i >= n) continue;
    const int bi_ = base - d[i];
#pragma unroll
    for (int jn = 0; jn < 32; ++jn) {
#pragma unroll
      for (int ee = 0; ee < 2; ++ee) {
        const int jl = strip_sample(8 * jn + 2 * (lane & 3) + ee, TJ);
        const int j = j0 + jl;
        if (j >= n) continue;
        const int32_t v = bi_ - d[j] + 2 * acc[4 * jn + 2 * hh + ee];
        T[jl * TP + il] = v;
        if (i <= j) out[(long long)i * n + j] = v;
      }
    }
  }
  __syncthreads();
  for (int jl = tid >> 5; jl < TJ; jl += THREADS / 32) {
    const int j = j0 + jl;
    if (j >= n) break;
#pragma unroll
    for (int il = lane; il < TI; il += 32) {
      const int i = i0 + il;
      if (i < n && i < j) out[(long long)j * n + i] = T[jl * TP + il];
    }
  }
}

template <int PLOIDY, bool WIDE>
inline cudaError_t launch_t(const uint8_t* packed, long long rows, int rb,
                            int n, int base, int32_t* d, int32_t* out,
                            cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(d, 0, sizeof(int32_t) * n, stream);
  if (err != cudaSuccess) return err;
  const int rpb = 256;
  dim3 cgrid((rb + 127) / 128, (unsigned)((rows + rpb - 1) / rpb));
  ibs_colsum_kernel<PLOIDY><<<cgrid, 128, 0, stream>>>(packed, rows, rb, n,
                                                       rpb, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kern = ibs_gram_kernel<PLOIDY, WIDE>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const int ni = (n + TI - 1) / TI, nj = (n + TJ - 1) / TJ;
  int tiles = 0;
  for (int bj = 0; bj < nj; ++bj) tiles += ni < 2 * bj + 2 ? ni : 2 * bj + 2;
  kern<<<tiles, THREADS, SMEM_BYTES, stream>>>(packed, rows, rb, n, base, d,
                                               out);
  return cudaGetLastError();
}

// S (n, n) int32 over `rows` packed rows of pitch rb; d: n int32 of scratch
// wide: 32-bit loads (rb and the base address multiples of 4), else bytes
inline int launch(const void* packed, long long rows, int rb, int n, int base,
                  int ploidy, int wide, void* d, void* out, void* stream) {
  const uint8_t* p = (const uint8_t*)packed;
  if (wide && (rb % 4 != 0 || (uintptr_t)p % 4 != 0))
    return (int)cudaErrorMisalignedAddress;
  auto s = (cudaStream_t)stream;
  auto dd = (int32_t*)d;
  auto oo = (int32_t*)out;
  cudaError_t err;
  if (ploidy == 1)
    err = wide ? launch_t<1, true>(p, rows, rb, n, base, dd, oo, s)
               : launch_t<1, false>(p, rows, rb, n, base, dd, oo, s);
  else
    err = wide ? launch_t<2, true>(p, rows, rb, n, base, dd, oo, s)
               : launch_t<2, false>(p, rows, rb, n, base, dd, oo, s);
  return (int)err;
}

}  // namespace ibs
