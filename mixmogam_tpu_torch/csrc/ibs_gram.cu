// K1: IBS sharing-count gram over 2-bit packed genotype rows (Hopper).
//
// Replaces: mixmogam_tpu/ops/pallas_kinship.py _ibs_kernel/_ibs_gram_padded
// (binary IBS gram, int8 MXU) and the diploid gram that the JAX main path
// runs in XLA (mixmogam_tpu/models/resident.py _ibs_resident_fused).
//
// Computes S[i][j] = ploidy*M - sum_k |g_ki - g_kj| (int32), which for
// fully observed dosages in 0..ploidy equals the JAX formulas
// (binary 2*CtC - s_i - s_j + M; diploid 2M - (a2_i + a2_j - 2*CtC
// - 2*(C02 + C02^T))). Zero pad rows contribute |0 - 0| = 0.
//
// Bound on the H100: integer ALU throughput. The work is n^2 * M_pad / 4
// four-byte absolute-difference sums (__vsadu4); the packed input is
// n/4 bytes per SNP row and every block re-reads only two 16-byte strips
// per row, so device-memory traffic is small next to the ALU work.
// Design: a block of 256 threads owns a 64x64 output tile and walks the
// SNP (contraction) axis in chunks of 64 rows. The load stage reads the
// packed bytes of both sample strips and unpacks them into shared memory
// as 32-bit words holding the dosages of one sample at 4 consecutive
// SNPs; each thread then accumulates a 4x4 micro-tile with one __vsadu4
// per word pair. Simple first: no tensor cores, both triangles computed.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

__global__ void __launch_bounds__(THREADS)
ibs_gram_kernel(const uint8_t* __restrict__ packed, long long rows, int rb,
                int n, int M, int ploidy, int32_t* __restrict__ out) {
  __shared__ uint32_t sA[KW * TILE];
  __shared__ uint32_t sB[KW * TILE];
  const int i0 = blockIdx.y * TILE;
  const int j0 = blockIdx.x * TILE;
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
  const int base = ploidy * M;
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

}  // namespace

extern "C" int ibs_gram_packed(const void* packed, long long rows, int rb,
                               int n, int M, int ploidy, void* out,
                               void* stream) {
  const int nt = (n + TILE - 1) / TILE;
  dim3 grid(nt, nt);
  ibs_gram_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, rows, rb, n, M, ploidy, (int32_t*)out);
  return (int)cudaGetLastError();
}
