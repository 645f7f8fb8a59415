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
dosages in 0..ploidy both reduce to S = ploidy·M − Σ_k |g_ki − g_kj|.
The CUDA kernels (csrc/ibs_tile.cuh) compute that sum as one s8 gram on
the tensor cores: with the thermometer planes u = [g ≥ 1], v = [g ≥ 2]
stacked along the SNP axis into Z (one plane for binary dosages),
|a − b| = Σ_planes z_a + z_b − 2·z_a·z_b, so S = ploidy·M − d_i − d_j +
2·ZᵀZ with d the column sums of Z. Zero pad rows add nothing to any
form. kinship_resident divides by M (binary) or 2M (diploid).
"""

from __future__ import annotations

import ctypes

import torch

from mixmogam_tpu_torch.ops.pack2 import unpack_2bit_device


def _check_packed(what: str, packed: torch.Tensor, n: int, ploidy: int
                  ) -> int:
    """The kernels' input contract; returns the row pitch in bytes."""
    rb = (n + 3) // 4
    if (packed.dtype != torch.uint8 or packed.ndim != 2
            or packed.shape[1] != rb or not packed.is_contiguous()):
        raise ValueError(f"{what} needs a contiguous uint8 (M_pad, {rb}) "
                         f"tensor; got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    if ploidy not in (1, 2):
        raise ValueError(f"{what}: ploidy {ploidy}")
    return rb


def _launch(what: str, lib_name: str, packed: torch.Tensor, rows: int,
            rb: int, n: int, ploidy: int, extra: tuple, narrow: bool
            ) -> torch.Tensor:
    """Launch K1 / K4 over `rows` rows starting at `packed`'s first byte."""
    # every partial sum of S = base - d_i - d_j + 2 D stays inside int32
    if 4 * ploidy * rows >= 2 ** 31:
        raise ValueError(f"{what}: {rows} rows at ploidy {ploidy} overflow "
                         "the int32 sharing counts")
    from mixmogam_tpu_torch.ops._build import build, check_launch

    fn = getattr(build(lib_name), what)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int] + [ctypes.c_int] * (len(extra) + 2)
                   + [ctypes.c_void_p] * 3)
    out = torch.empty((n, n), dtype=torch.int32, device=packed.device)
    colsum = torch.empty(n, dtype=torch.int32, device=packed.device)
    # 32-bit loads need a pitch of whole words (the base is then aligned
    # too: a row offset into an allocation); other pitches take the
    # kernels' second load path (`narrow` forces it, for the tests)
    wide = rb % 4 == 0 and not narrow
    stream = torch.cuda.current_stream(packed.device).cuda_stream
    rc = fn(packed.data_ptr(), rows, rb, n, *extra, ploidy, int(wide),
            colsum.data_ptr(), out.data_ptr(), stream)
    check_launch(rc, what)
    return out


def ibs_gram_emulated(packed: torch.Tensor, n: int, base: int, ploidy: int
                      ) -> torch.Tensor:
    """The kernels' arithmetic in plain torch, in their order (for the CPU
    tests; nothing on the card's path calls it): the 4 x 4 byte transpose
    of four packed rows into words, (w >> 2s) & mask per sample, the
    thermometer planes, D = Z^T Z and its column sums d in integers,
    S = base - d_i - d_j + 2 D on the entries with i <= j, mirrored."""
    rows, rb = packed.shape
    pad = -rows % 4
    p = torch.cat([packed, packed.new_zeros((pad, rb))]).to(torch.int64)
    # word w[g, c] holds byte column c of rows 4g..4g+3, lowest byte first
    w = (p.view(-1, 4, rb) << (8 * torch.arange(4))[None, :, None]).sum(1)
    planes = []
    for s in range(4):
        x = (w >> (2 * s)) & 0x03030303
        if ploidy == 1:
            zs = [x & 0x01010101]
        else:
            zs = [(x | (x >> 1)) & 0x01010101, (x >> 1) & 0x01010101]
        # bytes of a word = the plane's value at the word's 4 rows
        planes.append(torch.stack(
            [torch.stack([(z >> (8 * b)) & 0xFF for b in range(4)], 1)
             for z in zs], 1))                  # (groups, planes, 4, rb)
    Z = torch.stack(planes, -1)                 # (..., rb, 4 samples)
    Z = Z.reshape(-1, 4 * rb)[:, :n]            # (planes * rows, n)
    D = Z.T @ Z
    d = Z.sum(0)
    S = base - d[:, None] - d[None, :] + 2 * D
    if int(S.abs().max()) >= 2 ** 31:
        raise ValueError("sharing counts overflow int32")
    upper = torch.arange(n)[:, None] <= torch.arange(n)[None, :]
    return torch.where(upper, S, S.T).to(torch.int32)


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
                    ploidy: int, *, _narrow: bool = False) -> torch.Tensor:
    """int32 (n, n) IBS sharing counts of a fully observed packed genome
    (M_pad, ceil(n/4)) uint8 — kernel K1 for a CUDA tensor, the plain
    version for a CPU tensor."""
    if packed.device.type == "cpu":
        return ibs_gram_packed_plain(packed, n, M, ploidy)
    if packed.device.type != "cuda":
        raise ValueError(f"ibs_gram_packed: unsupported device "
                         f"{packed.device}")
    rb = _check_packed("ibs_gram_packed", packed, n, ploidy)
    if not 0 < M <= packed.shape[0]:
        raise ValueError(f"ibs_gram_packed: M {M}, rows {packed.shape[0]}")
    out = _launch("ibs_gram_packed", "ibs_gram", packed, packed.shape[0],
                  rb, n, ploidy, (M,), _narrow)
    ibs_gram_packed.launches += 1
    return out


ibs_gram_packed.launches = 0


def ibs_gram_tri_packed_plain(packed: torch.Tensor, n: int, s: int, e: int,
                              ploidy: int) -> torch.Tensor:
    """The JAX range gram's formulas over packed rows [s, e) in float64
    torch (exact): ibs_gram_packed_plain of the row slice."""
    return ibs_gram_packed_plain(packed[s:e], n, e - s, ploidy)


def ibs_gram_tri_packed(packed: torch.Tensor, n: int, s: int, e: int,
                        ploidy: int, *, _narrow: bool = False
                        ) -> torch.Tensor:
    """int32 (n, n) IBS sharing counts of the fully observed packed rows
    [s, e) — kernel K4 for a CUDA tensor (upper-triangle tiles, each
    mirrored by the block that computed it), the plain version for a CPU
    tensor."""
    if packed.device.type == "cpu":
        return ibs_gram_tri_packed_plain(packed, n, s, e, ploidy)
    if packed.device.type != "cuda":
        raise ValueError(f"ibs_gram_tri_packed: unsupported device "
                         f"{packed.device}")
    rb = _check_packed("ibs_gram_tri_packed", packed, n, ploidy)
    if not 0 <= s < e <= packed.shape[0]:
        raise ValueError(f"ibs_gram_tri_packed: rows [{s}, {e}) of "
                         f"{packed.shape[0]}")
    out = _launch("ibs_gram_tri_packed", "ibs_gram_tri", packed[s:e], e - s,
                  rb, n, ploidy, (), _narrow)
    ibs_gram_tri_packed.launches += 1
    return out


ibs_gram_tri_packed.launches = 0
