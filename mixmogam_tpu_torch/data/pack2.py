"""2-bit genotype rows on the host, in numpy (copy of the numpy versions
of mixmogam_tpu/native.py's pack_2bit / unpack_2bit).

The byte layout of the file containers (write_packed, PLINK .bed remaps,
read_vcf_packed) and of ops/pack2.py::pack_2bit_device, which packs the
same rows on a device: codes 0/1/2 = dosage, 3 = missing (-1); sample k
of a byte sits at bits 2k; column padding (n % 4 != 0) is code 3.
"""

from __future__ import annotations

import numpy as np


def pack_2bit(mat: np.ndarray) -> np.ndarray:
    """int8 (M, n) dosages (0..2, -1 missing) -> (M, ceil(n/4)) uint8."""
    src = np.asarray(mat)
    if np.issubdtype(src.dtype, np.floating):
        # validate BEFORE the lossy int8 cast: fractional dosages would
        # silently truncate (0.7 -> 0) and NaN casts to an undefined int8
        if src.size and (np.isnan(src).any()
                         or not np.array_equal(src, np.rint(src))):
            raise ValueError(
                "pack_2bit needs integer hard calls (0..2, -1 = "
                "missing); this float matrix has fractional or NaN "
                "dosages — 2-bit packing would silently fabricate hard "
                "calls. Use the HDF5 container for imputed dosages.")
    mat = np.ascontiguousarray(mat, dtype=np.int8)
    if mat.size and (mat.min() < -1 or mat.max() > 2):
        raise ValueError(
            "pack_2bit stores dosages 0..2 (+ -1 = missing); the matrix "
            "contains values outside that range, which 2-bit packing "
            "would silently convert to missing. Use the HDF5 container "
            "for >2 dosages.")
    M, n = mat.shape
    rb = (n + 3) // 4
    codes = np.where(mat >= 0, mat, 3).astype(np.uint8)
    pad = rb * 4 - n
    if pad:
        codes = np.concatenate(
            [codes, np.full((M, pad), 3, dtype=np.uint8)], axis=1)
    codes = codes.reshape(M, rb, 4)
    return (codes[:, :, 0] | (codes[:, :, 1] << 2) | (codes[:, :, 2] << 4)
            | (codes[:, :, 3] << 6)).astype(np.uint8)


def unpack_2bit(packed: np.ndarray, n_samples: int,
                chunk: int = 65_536) -> np.ndarray:
    """(M, ceil(n/4)) uint8 -> (M, n) int8 with code 3 -> -1 (missing),
    decoded `chunk` rows at a time into the output (a whole-genome decode
    in one piece would hold several temporaries of the output's size)."""
    packed = np.asarray(packed, dtype=np.uint8)
    M = packed.shape[0]
    out = np.empty((M, n_samples), dtype=np.int8)
    for s in range(0, M, chunk):
        blk = packed[s:s + chunk]
        codes = np.stack([(blk >> (2 * k)) & 3 for k in range(4)],
                         axis=2).reshape(blk.shape[0], -1)[:, :n_samples]
        o = out[s:s + chunk]
        o[...] = codes                       # 0..3 fits int8
        o[codes == 3] = -1
    return out
