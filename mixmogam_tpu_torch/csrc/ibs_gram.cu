// K1: IBS sharing-count gram over 2-bit packed genotype rows (Hopper).
//
// Replaces: mixmogam_tpu/ops/pallas_kinship.py _ibs_kernel/_ibs_gram_padded
// (binary IBS gram, int8 MXU) and the diploid gram that the JAX main path
// runs in XLA (mixmogam_tpu/models/resident.py _ibs_resident_fused).
//
// Computes S[i][j] = ploidy*M - sum_k |g_ki - g_kj| (int32) over all packed
// rows; the tile body is ibs_tile.cuh, shared with K4.
//
// Bound on the H100: integer ALU throughput. The work is n^2 * M_pad / 4
// four-byte absolute-difference sums (__vsadu4); the packed input is
// n/4 bytes per SNP row and every block re-reads only two 16-byte strips
// per row, so device-memory traffic is small next to the ALU work.
// Design: one block of 256 threads per 64x64 output tile (ibs_tile.cuh).
// Simple first: no tensor cores, both triangles computed.

#include <cstdint>
#include <cuda_runtime.h>

#include "ibs_tile.cuh"

namespace {

__global__ void __launch_bounds__(ibs::THREADS)
ibs_gram_kernel(const uint8_t* __restrict__ packed, long long rows, int rb,
                int n, int M, int ploidy, int32_t* __restrict__ out) {
  ibs::ibs_tile(packed, rows, rb, n, ploidy * M, blockIdx.y * ibs::TILE,
                blockIdx.x * ibs::TILE, out);
}

}  // namespace

extern "C" int ibs_gram_packed(const void* packed, long long rows, int rb,
                               int n, int M, int ploidy, void* out,
                               void* stream) {
  const int nt = (n + ibs::TILE - 1) / ibs::TILE;
  dim3 grid(nt, nt);
  ibs_gram_kernel<<<grid, ibs::THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, rows, rb, n, M, ploidy, (int32_t*)out);
  return (int)cudaGetLastError();
}
