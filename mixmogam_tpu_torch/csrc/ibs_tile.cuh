// One 64 x 64 output tile of the IBS sharing-count gram over 2-bit packed
// genotype rows, shared by K1 (ibs_gram.cu, every tile) and K4
// (ibs_gram_tri.cu, upper-triangle tiles of a row range).
//
// S[i][j] = ploidy*m - sum_k |g_ki - g_kj| (int32) over the `rows` packed
// rows given, which for fully observed dosages in 0..ploidy equals the JAX
// formulas (binary 2*CtC - s_i - s_j + m; diploid 2m - (a2_i + a2_j
// - 2*CtC - 2*(C02 + C02^T))). Zero pad rows contribute |0 - 0| = 0.
//
// A block of 256 threads owns the tile and walks the SNP (contraction)
// axis in chunks of 64 rows. The load stage reads the packed bytes of both
// sample strips and unpacks them into shared memory as 32-bit words
// holding the dosages of one sample at 4 consecutive SNPs; each thread
// then accumulates a 4x4 micro-tile with one __vsadu4 per word pair.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ibs {

constexpr int TILE = 64;     // output tile edge (samples)
constexpr int KC = 64;       // SNP rows per chunk
constexpr int KW = KC / 4;   // 32-bit words per sample per chunk
constexpr int THREADS = 256;

__device__ __forceinline__ void unpack_strip(
    const uint8_t* __restrict__ packed, long long rows, int rb, long long k0,
    int s0, uint8_t* __restrict__ dst /* [KW][TILE][4] bytes */) {
  // KC rows x 16 packed bytes (64 samples) per strip
  for (int t = threadIdx.x; t < KC * (TILE / 4); t += THREADS) {
    const int k = t / (TILE / 4);
    const int bcol = t % (TILE / 4);
    const long long row = k0 + k;
    const int byte_col = s0 / 4 + bcol;
    uint32_t b = 0;
    if (row < rows && byte_col < rb) b = packed[row * rb + byte_col];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t code = (b >> (2 * s)) & 3u;
      if (code == 3u) code = 0u;  // missing / column padding: outside n
      dst[((k / 4) * TILE + bcol * 4 + s) * 4 + (k % 4)] = (uint8_t)code;
    }
  }
}

// the tile at samples [i0, i0 + TILE) x [j0, j0 + TILE) of out (n, n)
__device__ __forceinline__ void ibs_tile(const uint8_t* __restrict__ packed,
                                         long long rows, int rb, int n,
                                         int base, int i0, int j0,
                                         int32_t* __restrict__ out) {
  __shared__ uint32_t sA[KW * TILE];
  __shared__ uint32_t sB[KW * TILE];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  uint32_t acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0u;

  for (long long k0 = 0; k0 < rows; k0 += KC) {
    unpack_strip(packed, rows, rb, k0, i0, reinterpret_cast<uint8_t*>(sA));
    unpack_strip(packed, rows, rb, k0, j0, reinterpret_cast<uint8_t*>(sB));
    __syncthreads();
#pragma unroll 4
    for (int w = 0; w < KW; ++w) {
      uint32_t a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = sA[w * TILE + ty + 16 * r];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = sB[w * TILE + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] += __vsadu4(a[r], b[c]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= n) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx + 16 * c;
      if (j < n) out[(long long)i * n + j] = base - (int32_t)acc[r][c];
    }
  }
}

}  // namespace ibs
