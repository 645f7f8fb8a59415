// K4: upper-triangle IBS sharing-count gram over a row range [s, e) of
// 2-bit packed genotype rows (Hopper).
//
// Replaces: mixmogam_tpu/ops/pallas_kinship.py _ibs_tri_kernel /
// _ibs_gram_tri (pallas_ibs_kinship_tri), and the range-masked gram the
// JAX LOCO path runs in XLA (mixmogam_tpu/models/resident.py
// _ibs_resident_fused_range): one chromosome's gram per launch.
//
// Computes S[i][j] = ploidy*m - sum_k |g_ki - g_kj| (int32, m = e - s) for
// the 64 x 64 tiles (bi, bj) with bi <= bj only; the wrapper mirrors the
// strict upper tiles into the lower half on the device. The packed rows
// are SNP-major and contiguous, so the range is a pointer offset and a row
// count: no row mask, and a range that cuts a tile costs nothing extra.
//
// Bound on the H100: integer ALU throughput, as K1, at about half of K1's
// work for one gram (B(B+1)/2 of B^2 tiles). Design: a 1-D grid over the
// upper-triangle tile pairs; each block runs K1's tile body
// (ibs_tile.cuh). Simple first: no tensor cores or bit-sliced popcount.

#include <cstdint>
#include <cuda_runtime.h>

#include "ibs_tile.cuh"

namespace {

__global__ void __launch_bounds__(ibs::THREADS)
ibs_gram_tri_kernel(const uint8_t* __restrict__ packed, long long rows,
                    int rb, int n, int nt, int ploidy,
                    int32_t* __restrict__ out) {
  // blockIdx.x -> (bi, bj), bi <= bj, row-major over the upper triangle
  int p = blockIdx.x;
  int bi = 0;
  while (p >= nt - bi) {
    p -= nt - bi;
    ++bi;
  }
  const int bj = bi + p;
  ibs::ibs_tile(packed, rows, rb, n, ploidy * (int)rows, bi * ibs::TILE,
                bj * ibs::TILE, out);
}

}  // namespace

// packed: the first of the range's rows (already offset by s * rb);
// rows = e - s
extern "C" int ibs_gram_tri_packed(const void* packed, long long rows,
                                   int rb, int n, int ploidy, void* out,
                                   void* stream) {
  const int nt = (n + ibs::TILE - 1) / ibs::TILE;
  const int pairs = nt * (nt + 1) / 2;
  ibs_gram_tri_kernel<<<pairs, ibs::THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, rows, rb, n, nt, ploidy, (int32_t*)out);
  return (int)cudaGetLastError();
}
