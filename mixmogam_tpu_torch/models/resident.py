"""Device-resident 2-bit genome container and the main path over it
(counterpart of mixmogam_tpu/models/resident.py).

The packed rows (n/4 bytes per SNP) are uploaded once; kinship and every
scan then run on the device with no host traffic:

- kinship_resident: fully observed IBS through kernel K1
  (ops/hopper_kinship.py), which reads the packed rows directly;
- kinship_resident_range: the same gram over a row range [s, e) (LOCO's
  per-chromosome grams) through kernel K4, upper-triangle tiles only;
- emmax_scan_packed: the int8 tiers through kernel K2 and the bf16 tiers
  through kernel K5 (ops/hopper_scan.py), which read the packed rows
  directly (K5 replaces missing genotypes by per-row means); the exact
  tier unpacks each tile, mean-imputes missing genotypes, rotates by a
  full-fp32 GEMM and finishes in kernel K3.

Missing-data and VanRaden kinship wait for ROADMAP Queue 1 item 5.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mixmogam_tpu_torch.ops.pack2 import (pack_2bit_device,
                                         unpack_2bit_device)

#: share of the card's memory the auto-promotion lets the packed genome
#: take. The scan also holds the (n, n) rotation (U in f32, or K int8
#: planes plus their padded transposed copy), one unpacked tile and its
#: rotated f32 image: about 3 GB at n = 10,240 and tile = 16,384.
RESIDENT_MEMORY_FRACTION = 0.5


def resident_budget_bytes(device) -> int:
    """Packed-genome budget for emmax()'s auto-promotion on `device`,
    from the card's own memory (torch.cuda.get_device_properties)."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0
    total = torch.cuda.get_device_properties(device).total_memory
    return int(total * RESIDENT_MEMORY_FRACTION)


class ResidentGenome:
    """(M, n) int8 dosages held 2-bit packed on a device.

    Quacks like a read-only SNP-major matrix source: `.shape`, `.dtype`
    (int8), and slicing / integer-array row indexing return HOST int8
    rows (-1 for missing), decoded from the host copy of the packed rows
    (no read-back from the card)."""

    def __init__(self, packed: torch.Tensor, M: int, n: int, ploidy: int,
                 tile: int, has_missing: bool,
                 host_packed: Optional[np.ndarray] = None):
        """packed: (rows >= M, ceil(n/4)) uint8 rows on the device; rows
        past M are zero padding. host_packed: the same rows on the host,
        read back from `packed` when not given."""
        self.packed = packed
        self.host_packed = (packed.cpu().numpy() if host_packed is None
                            else host_packed)
        self.M = int(M)
        self.n = int(n)
        self.ploidy = int(ploidy)
        self.tile = int(tile)
        self.has_missing = bool(has_missing)
        self._content_key: Optional[str] = None

    def content_key(self) -> str:
        """Stable content identity: sha256 of 'M:n:tile:' and the host
        packed rows (pad rows are zeros), first 16 hex digits, memoized.
        The JAX package's key for the same rows: the LOCO eigen caches of
        both packages agree."""
        if self._content_key is None:
            import hashlib

            h = hashlib.sha256()
            h.update(f"{self.M}:{self.n}:{self.tile}:".encode())
            h.update(np.ascontiguousarray(self.host_packed).tobytes())
            self._content_key = h.hexdigest()[:16]
        return self._content_key

    @property
    def device(self) -> torch.device:
        return self.packed.device

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.M, self.n)

    @property
    def dtype(self):
        return np.dtype(np.int8)

    @property
    def nbytes_packed(self) -> int:
        return int(self.packed.shape[0]) * int(self.packed.shape[1])

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        out = self[0:self.M]
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, key) -> np.ndarray:
        """Rows as HOST int8 (missing = -1). Step-1 slices and 1-D
        integer-array indexing only."""
        if isinstance(key, slice):
            s, e, step = key.indices(self.M)
            if step != 1:
                raise IndexError("ResidentGenome supports step-1 slices")
            rows = self.host_packed[s:e]
        else:
            idx = np.asarray(key)
            if idx.ndim != 1:
                raise IndexError("ResidentGenome supports 1-D row indexing")
            rows = self.host_packed[idx]
        return unpack_2bit_device(
            torch.from_numpy(np.ascontiguousarray(rows)), self.n).numpy()

    def slice_rows(self, s: int, e: int) -> "ResidentGenome":
        """Row range [s, e) as a container over views of this one's
        packed rows, on the device and on the host: no copy and no tile
        padding (the kernels and the exact tier's tile loop stop at the
        view's last row)."""
        if not (0 <= s < e <= self.M):
            raise ValueError(f"invalid row range [{s}, {e}) for "
                             f"M={self.M}")
        return ResidentGenome(self.packed[s:e], e - s, self.n, self.ploidy,
                              self.tile, self.has_missing,
                              host_packed=self.host_packed[s:e])

    @classmethod
    def from_source(cls, G, tile: int = 16_384, chunk: int = 65_536,
                    ploidy: Optional[int] = None,
                    device=None) -> "ResidentGenome":
        """Pack an int8 host source (ndarray / memmap / h5py /
        GenotypeData) chunk by chunk on `device` (the card by default,
        'cpu' on request; pack_2bit_device) and
        keep a host copy of the packed rows (one read-back). Rows are
        zero-padded to a tile multiple: dosage-0 pad rows are degenerate
        in the scan (masked) and add nothing to any kinship term."""
        from mixmogam_tpu_torch.models.source import resolve_source
        from mixmogam_tpu_torch.ops import resolve_device

        device = resolve_device(device)
        mat = resolve_source(G)
        if np.dtype(mat.dtype) != np.int8:
            raise TypeError(
                "ResidentGenome stores int8 dosages 0..2 (+ -1 missing); "
                f"got dtype {mat.dtype}")
        if ploidy is None:
            ploidy = getattr(G, "ploidy", None)
        M, n = mat.shape
        M_pad = -(-M // tile) * tile
        packed = torch.zeros((M_pad, (n + 3) // 4), dtype=torch.uint8,
                             device=device)
        has_missing = False
        vmax = 0
        for s in range(0, M, chunk):
            e = min(s + chunk, M)
            c = torch.from_numpy(np.ascontiguousarray(
                np.asarray(mat[s:e], dtype=np.int8))).to(device)
            lo, hi = (int(v) for v in torch.aminmax(c))
            if lo < -1 or hi > 2:
                raise ValueError("ResidentGenome stores dosages 0..2 (+ -1 "
                                 "= missing); the source holds other "
                                 "values")
            has_missing |= lo < 0
            vmax = max(vmax, hi)
            packed[s:e] = pack_2bit_device(c)
        if ploidy is None:
            ploidy = 2 if vmax > 1 else 1
        return cls(packed, M, n, ploidy, tile, has_missing)


def scale_k(K: np.ndarray) -> np.ndarray:
    """K / mean(diag(K)): the JAX package's oracle.kinship.scale_k, the
    normalization every kinship gets before REML."""
    return K / np.mean(np.diag(K))


def row_means_packed(packed: torch.Tensor, n: int, tile: int, dtype
                     ) -> torch.Tensor:
    """(M_pad,) per-row mean dosage over the observed genotypes, 0 for an
    all-missing row, in dtype on packed's device: _impute_tile's rule,
    tile by tile."""
    from mixmogam_tpu_torch.models.streaming import _impute_means

    means = []
    for s in range(0, packed.shape[0], tile):
        mu, _, _ = _impute_means(unpack_2bit_device(packed[s:s + tile], n),
                                 dtype)
        means.append(mu[:, 0])
    return torch.cat(means)


def emmax_scan_packed(packed: torch.Tensor, rot, n: int, tile: int,
                      impute: bool = False) -> torch.Tensor:
    """(4, M_pad) EMMAX stats [f, beta, var_perc, mask] over a packed
    genome on its device. int8 tiers: one K2 launch over every row. bf16
    tiers: one K5 launch over every row (with per-row means when
    imputing). Exact tier: per tile, unpack (+ mean-impute) -> fp32 GEMM by
    U -> K3."""
    from mixmogam_tpu_torch.models.streaming import _impute_tile
    from mixmogam_tpu_torch.ops.hopper_scan import (rotate_scan_bf16_packed,
                                                    rotate_scan_int8_packed,
                                                    scan_operand)
    from mixmogam_tpu_torch.ops.scan import emmax_scan_stats

    dt = rot.sd.dtype
    # the kernels' prepared W, built once per rotated null and kept with it
    op = scan_operand(rot) if packed.device.type == "cuda" else None
    if rot.parts is not None:
        mu = row_means_packed(packed, n, tile, dt) if impute else None
        return rotate_scan_bf16_packed(packed, n, rot.parts, rot.y_res,
                                       rot.Q0, rot.rss0, rot.dof, mu,
                                       operand=op)
    if rot.planes is not None:
        if impute:
            raise ValueError("int8 digit-plane tiers need fully observed "
                             "dosages")
        return rotate_scan_int8_packed(packed, n, rot.planes, rot.w_scale,
                                       rot.y_res, rot.Q0, rot.rss0, rot.dof,
                                       operand=op)
    outs = []
    for s in range(0, packed.shape[0], tile):
        Gt = unpack_2bit_device(packed[s:s + tile], n)
        Gt = _impute_tile(Gt, dt) if impute else Gt.to(dt)
        outs.append(emmax_scan_stats(Gt, rot))
    return torch.cat(outs, dim=1)


def _default_dtype(device) -> torch.dtype:
    """Compute dtype when the caller gives none: float32 on the card (the
    kernels' working type), float64 on the CPU (the reference path)."""
    return (torch.float32 if torch.device(device).type == "cuda"
            else torch.float64)


def emmax_resident(rg: ResidentGenome, y, K=None, X0=None, eig_k=None,
                   ngrids: int = 100, llim: float = -10.0,
                   ulim: float = 10.0, esp: float = 1e-6,
                   with_betas: bool = True, dtype=None,
                   precision: Optional[str] = None, rotate_in_bf16=False,
                   rescore_top: int = 0, rescore_cut_M: Optional[int] = None
                   ) -> dict:
    """EMMAX over a ResidentGenome — the JAX package's emmax_resident
    semantics and return dict, on rg's device. Missing genotypes are
    mean-imputed on the device on the exact and bf16 tiers; int8 tiers
    refuse them. rescore_cut_M: the study's SNP count for the rescore cut
    when rg holds part of it (LOCO's chromosomes)."""
    from mixmogam_tpu_torch.models.emmax import _as_design
    from mixmogam_tpu_torch.models.streaming import finalize_scan
    from mixmogam_tpu_torch.ops.reml import (esp_to_refine_iters,
                                             fit_null_model)
    from mixmogam_tpu_torch.ops.scan import (build_rotated_null,
                                             normalize_rotate_tier,
                                             resolve_precision)

    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    if n != rg.n:
        raise ValueError(f"y has {n} samples but the resident genome "
                         f"holds {rg.n}")
    device = rg.device
    if dtype is None:
        dtype = _default_dtype(device)
    if str(precision) == "fast" and not rescore_top:
        rescore_top = 1024
    if X0 is None:
        X0 = np.ones((n, 1))
    X0 = _as_design(X0, n)
    tier_name = None
    if precision is not None:
        if rotate_in_bf16:
            raise ValueError("pass either precision= or the legacy "
                             "rotate_in_bf16 kwarg, not both")
        rotate_in_bf16, tier_name = resolve_precision(precision)
    rd = normalize_rotate_tier(rotate_in_bf16)
    if rd is not None and rd.startswith("int8") and rg.has_missing:
        raise ValueError(
            "int8 digit-plane tiers need fully-observed dosages; this "
            "resident genome has missing genotypes (device-imputed to "
            "fractions). Use precision='exact'/'bf16' instead.")
    null = fit_null_model(y, X0, K=K, eig_k=eig_k, ngrids=ngrids,
                          llim=llim, ulim=ulim,
                          refine_iters=esp_to_refine_iters(
                              esp, ngrids, llim, ulim),
                          eigh_dtype=(np.float32 if str(precision) == "fast"
                                      else None),
                          device=device, dtype=dtype)
    rot = build_rotated_null(null, rotate_dtype=rd)
    out = emmax_scan_packed(rg.packed, rot, rg.n, rg.tile,
                            impute=rg.has_missing)
    h = out[:, :rg.M].detach().cpu().double().numpy()
    return finalize_scan(
        rg, null, dtype, h[0].copy(), h[3] > 0.5,
        betas=h[1].copy() if with_betas else None,
        var_perc=h[2].copy() if with_betas else None,
        with_betas=with_betas, rescore_top=rescore_top, rd=rd,
        tier_name=tier_name, dof=int(rot.dof), rescore_cut_M=rescore_cut_M)


def _check_ported_kinship(rg: ResidentGenome, method: str) -> None:
    if method in ("vanraden", "ibd"):
        raise NotImplementedError(
            "VanRaden kinship is not ported yet: ROADMAP Queue 1 item 5")
    if method != "ibs":
        raise ValueError(f"unknown kinship method {method!r}")
    if rg.has_missing:
        raise NotImplementedError(
            "IBS kinship with missing genotypes (the mean-imputed float "
            "accumulation) is not ported yet: ROADMAP Queue 1 item 5")


def _sharing_fractions(S: torch.Tensor, m: int, ploidy: int,
                       return_den: bool):
    """int32 sharing counts over m SNPs -> float64 host fractions (/ m
    binary, / 2m diploid), with the denominator's SNP count if asked."""
    Sh = S.cpu().numpy().astype(np.float64)
    Kh = Sh / m if ploidy == 1 else Sh / (2.0 * m)
    return (Kh, float(m)) if return_den else Kh


def kinship_resident(rg: ResidentGenome, method: str = "ibs",
                     ploidy: Optional[int] = None,
                     return_den: bool = False):
    """IBS kinship (float64 host (n, n) sharing fractions) of a fully
    observed ResidentGenome: kernel K1 on the card, its plain version on
    the CPU; divided by M (binary) or 2M (diploid). return_den also
    returns the denominator's SNP count."""
    from mixmogam_tpu_torch.ops.hopper_kinship import ibs_gram_packed

    _check_ported_kinship(rg, method)
    ploidy = rg.ploidy if ploidy is None else ploidy
    S = ibs_gram_packed(rg.packed, rg.n, rg.M, ploidy)
    return _sharing_fractions(S, rg.M, ploidy, return_den)


def kinship_resident_range(rg: ResidentGenome, s: int, e: int,
                           method: str = "ibs",
                           ploidy: Optional[int] = None,
                           return_den: bool = False):
    """IBS kinship over the SNP row range [s, e) of a fully observed
    ResidentGenome (LOCO's per-chromosome grams): kernel K4 on the card,
    its plain version on the CPU; divided by m = e - s (binary) or 2m."""
    from mixmogam_tpu_torch.ops.hopper_kinship import ibs_gram_tri_packed

    if not (0 <= s < e <= rg.M):
        raise ValueError(f"invalid row range [{s}, {e}) for M={rg.M}")
    _check_ported_kinship(rg, method)
    ploidy = rg.ploidy if ploidy is None else ploidy
    S = ibs_gram_tri_packed(rg.packed, rg.n, s, e, ploidy)
    return _sharing_fractions(S, e - s, ploidy, return_den)
