// K4: IBS sharing-count gram over a row range [s, e) of 2-bit packed
// genotype rows, computed on upper-triangle tiles (Hopper).
//
// Replaces: mixmogam_tpu/ops/pallas_kinship.py _ibs_tri_kernel /
// _ibs_gram_tri (pallas_ibs_kinship_tri), and the range-masked gram the
// JAX LOCO path runs in XLA (mixmogam_tpu/models/resident.py
// _ibs_resident_fused_range): one chromosome's gram per launch.
//
// Computes S[i][j] = ploidy*m - sum_k |g_ki - g_kj| (int32, m = e - s). The
// packed rows are SNP-major and contiguous, so the range is a pointer
// offset and a row count: no row mask; rows past the range's end enter the
// last stage as zeros, so a range may cut a stage anywhere.
//
// Bound on the H100: the tensor cores' s8 rate, n^2/2 * ploidy * m MACs at
// 1,979 TOP/s, as K1. Design: the tile body and grid of ibs_tile.cuh: only
// the 128 x 256 tiles that hold an element with i <= j are computed (wgmma
// s8), and each block stores its tile and the tile's mirror.

#include <cstdint>
#include <cuda_runtime.h>

#include "ibs_tile.cuh"

// packed: the first of the range's rows (already offset by s * rb);
// rows = e - s; d: n int32 of scratch (the planes' column sums)
extern "C" int ibs_gram_tri_packed(const void* packed, long long rows,
                                   int rb, int n, int ploidy, int wide,
                                   void* d, void* out, void* stream) {
  return ibs::launch(packed, rows, rb, n, ploidy * (int)rows, ploidy, wide, d,
                     out, stream);
}
