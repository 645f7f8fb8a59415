"""2-bit genotype rows on the host: the C++ packer and unpacker of the
port's host library (native.py) when it is available, numpy otherwise
(the counterpart of mixmogam_tpu/native.py's pack_2bit / unpack_2bit and
their numpy routes).

The byte layout of the file containers (write_packed, PLINK .bed remaps,
the packed cache of ResidentGenome.from_source) and of
ops/pack2.py::pack_2bit_device, which packs the same rows on a device:
codes 0/1/2 = dosage, 3 = missing (-1); sample k of a byte sits at bits
2k; column padding (n % 4 != 0) is code 3.
"""

from __future__ import annotations

import ctypes

import numpy as np

from mixmogam_tpu_torch import native


def _hard_calls(mat) -> np.ndarray:
    """mat as contiguous int8, refused when a float matrix holds fractional
    or NaN dosages (checked BEFORE the lossy cast: 0.7 would truncate to
    0, NaN cast to an undefined int8) or any value lies outside -1..2."""
    src = np.asarray(mat)
    if np.issubdtype(src.dtype, np.floating):
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
    return mat


def pack_2bit(mat: np.ndarray) -> np.ndarray:
    """int8 (M, n) dosages (0..2, -1 missing) -> (M, ceil(n/4)) uint8."""
    mat = _hard_calls(mat)
    lib = native.get_lib()
    if lib is None:
        return _pack_numpy(mat)
    M, n = mat.shape
    out = np.empty((M, (n + 3) // 4), dtype=np.uint8)
    lib.pack_2bit(mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), M, n,
                  out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out


def unpack_2bit(packed: np.ndarray, n_samples: int) -> np.ndarray:
    """(M, ceil(n/4)) uint8 -> (M, n) int8 with code 3 -> -1 (missing)."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    if packed.ndim != 2 or packed.shape[1] != (n_samples + 3) // 4:
        raise ValueError(f"packed rows of shape {packed.shape} do not hold "
                         f"{n_samples} samples (ceil(n/4) bytes a row)")
    lib = native.get_lib()
    if lib is None:
        return _unpack_numpy(packed, n_samples)
    M = packed.shape[0]
    out = np.empty((M, n_samples), dtype=np.int8)
    lib.unpack_2bit(packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                    M, n_samples,
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)))
    return out


def _pack_numpy(mat: np.ndarray) -> np.ndarray:
    """pack_2bit's Python route, on rows _hard_calls has checked."""
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


def _unpack_numpy(packed: np.ndarray, n_samples: int,
                  chunk: int = 65_536) -> np.ndarray:
    """unpack_2bit's Python route, decoding `chunk` rows at a time into the
    output (a whole-genome decode in one piece would hold several
    temporaries of the output's size)."""
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
