// K1: IBS sharing-count gram over 2-bit packed genotype rows (Hopper).
//
// Replaces: mixmogam_tpu/ops/pallas_kinship.py _ibs_kernel/_ibs_gram_padded
// (binary IBS gram, int8 MXU) and the diploid gram that the JAX main path
// runs in XLA (mixmogam_tpu/models/resident.py _ibs_resident_fused).
//
// Computes S[i][j] = ploidy*M - sum_k |g_ki - g_kj| (int32) over all packed
// rows (zero pad rows add nothing), as the thermometer-coded s8 gram of
// ibs_tile.cuh, shared with K4.
//
// Bound on the H100: the tensor cores' s8 rate over the upper triangle,
// n^2/2 * ploidy * M_pad MACs at 1,979 TOP/s; device memory sees the packed
// rows once (n/4 bytes a row) and the int32 output once, and the blocks'
// strip reads (96 bytes a row and tile) come from L2.
// Design: K4's grid over every row: upper-triangle 128 x 256 tiles on wgmma,
// each mirrored into the lower half by the block that computed it.

#include <cstdint>
#include <cuda_runtime.h>

#include "ibs_tile.cuh"

// d: n int32 of scratch (the planes' column sums)
extern "C" int ibs_gram_packed(const void* packed, long long rows, int rb,
                               int n, int M, int ploidy, int wide, void* d,
                               void* out, void* stream) {
  return ibs::launch(packed, rows, rb, n, ploidy * M, ploidy, wide, d, out,
                     stream);
}
