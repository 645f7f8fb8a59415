"""IBS sharing-count grams over 2-bit packed rows: kernels K1 and K4 and
their plain PyTorch versions.

K1 replaces the TPU kernel mixmogam_tpu/ops/pallas_kinship.py
(_ibs_kernel / _ibs_gram_padded, binary) and covers the diploid gram the
JAX main path runs in XLA (models/resident.py:_ibs_resident_fused). K4
replaces the triangular kernel (_ibs_tri_kernel / _ibs_gram_tri) and
takes a row range [s, e), which is LOCO's per-chromosome gram
(models/resident.py:_ibs_resident_fused_range in the JAX package).
Output: int32 (n, n) sharing counts S —

  ploidy 1:  S = 2·CtC − s_i − s_j + M
  ploidy 2:  S = 2M − (a2_i + a2_j − 2·CtC − 2·(C02 + C02ᵀ))

with CtC = GᵀG, s / a2 the column sums of G / G², C02 = W0ᵀW2
(indicators of dosage 0 and 2) over the M real rows. For fully observed
dosages in 0..ploidy both reduce to S = ploidy·M − Σ_k |g_ki − g_kj|,
which is what the CUDA kernel accumulates (csrc/ibs_gram.cu). Zero pad
rows add nothing to either form. kinship_resident divides by M (binary)
or 2M (diploid).
"""

from __future__ import annotations

import ctypes

import torch

from mixmogam_tpu_torch.ops.pack2 import unpack_2bit_device

_TRI_TILE = 64        # K4's output tile edge (csrc/ibs_tile.cuh)


def ibs_gram_packed_plain(packed: torch.Tensor, n: int, M: int,
                          ploidy: int, chunk: int = 16_384
                          ) -> torch.Tensor:
    """The JAX main path's formulas in plain torch. Grams in float64 are
    exact here (every sum stays below 2^53)."""
    dev = packed.device
    CtC = torch.zeros((n, n), dtype=torch.float64, device=dev)
    corr = torch.zeros((n, n), dtype=torch.float64, device=dev)
    s = torch.zeros(n, dtype=torch.float64, device=dev)
    for r0 in range(0, packed.shape[0], chunk):
        G = unpack_2bit_device(packed[r0:r0 + chunk], n).double()
        CtC += G.T @ G
        if ploidy == 1:
            s += G.sum(dim=0)
        else:
            corr += (G == 0).double().T @ (G == 2).double()
            s += (G * G).sum(dim=0)
    if ploidy == 1:
        S = 2 * CtC - s[:, None] - s[None, :] + M
    else:
        S = 2 * M - (s[:, None] + s[None, :] - 2 * CtC - 2 * (corr + corr.T))
    return S.to(torch.int32)


def ibs_gram_packed(packed: torch.Tensor, n: int, M: int,
                    ploidy: int) -> torch.Tensor:
    """int32 (n, n) IBS sharing counts of a fully observed packed genome
    (M_pad, ceil(n/4)) uint8 — kernel K1 for a CUDA tensor, the plain
    version for a CPU tensor."""
    if packed.device.type == "cpu":
        return ibs_gram_packed_plain(packed, n, M, ploidy)
    if packed.device.type != "cuda":
        raise ValueError(f"ibs_gram_packed: unsupported device "
                         f"{packed.device}")
    rb = (n + 3) // 4
    if (packed.dtype != torch.uint8 or packed.ndim != 2
            or packed.shape[1] != rb or not packed.is_contiguous()):
        raise ValueError(f"ibs_gram_packed needs a contiguous uint8 "
                         f"(M_pad, {rb}) tensor; got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    if ploidy not in (1, 2) or not 0 < M <= packed.shape[0]:
        raise ValueError(f"ibs_gram_packed: ploidy {ploidy}, M {M}, "
                         f"rows {packed.shape[0]}")
    from mixmogam_tpu_torch.ops._build import build, check_launch

    lib = build("ibs_gram")
    fn = lib.ibs_gram_packed
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p]
    out = torch.empty((n, n), dtype=torch.int32, device=packed.device)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    rc = fn(packed.data_ptr(), packed.shape[0], rb, n, M, ploidy,
            out.data_ptr(), stream)
    check_launch(rc, "ibs_gram_packed")
    ibs_gram_packed.launches += 1
    return out


ibs_gram_packed.launches = 0


def ibs_gram_tri_packed_plain(packed: torch.Tensor, n: int, s: int, e: int,
                              ploidy: int) -> torch.Tensor:
    """The JAX range gram's formulas over packed rows [s, e) in float64
    torch (exact): ibs_gram_packed_plain of the row slice."""
    return ibs_gram_packed_plain(packed[s:e], n, e - s, ploidy)


def ibs_gram_tri_packed(packed: torch.Tensor, n: int, s: int, e: int,
                        ploidy: int) -> torch.Tensor:
    """int32 (n, n) IBS sharing counts of the fully observed packed rows
    [s, e) — kernel K4 for a CUDA tensor (upper-triangle tiles, mirrored
    on the device), the plain version for a CPU tensor."""
    if packed.device.type == "cpu":
        return ibs_gram_tri_packed_plain(packed, n, s, e, ploidy)
    if packed.device.type != "cuda":
        raise ValueError(f"ibs_gram_tri_packed: unsupported device "
                         f"{packed.device}")
    rb = (n + 3) // 4
    if (packed.dtype != torch.uint8 or packed.ndim != 2
            or packed.shape[1] != rb or not packed.is_contiguous()):
        raise ValueError(f"ibs_gram_tri_packed needs a contiguous uint8 "
                         f"(M_pad, {rb}) tensor; got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    if ploidy not in (1, 2) or not 0 <= s < e <= packed.shape[0]:
        raise ValueError(f"ibs_gram_tri_packed: ploidy {ploidy}, rows "
                         f"[{s}, {e}) of {packed.shape[0]}")
    from mixmogam_tpu_torch.ops._build import build, check_launch

    fn = build("ibs_gram_tri").ibs_gram_tri_packed
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p]
    out = torch.empty((n, n), dtype=torch.int32, device=packed.device)
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    rc = fn(packed[s].data_ptr(), e - s, rb, n, ploidy, out.data_ptr(),
            stream)
    check_launch(rc, "ibs_gram_tri_packed")
    ibs_gram_tri_packed.launches += 1
    # the kernel wrote the tiles (bi, bj) with bi <= bj; copy the strict
    # upper tiles' transposes into the lower ones
    t = torch.arange(n, device=packed.device) // _TRI_TILE
    return torch.where(t[:, None] > t[None, :], out.T, out)


ibs_gram_tri_packed.launches = 0
