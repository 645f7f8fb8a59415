"""Device-resident 2-bit genome container and the main path over it
(counterpart of mixmogam_tpu/models/resident.py).

The packed rows (n/4 bytes per SNP) are uploaded once; kinship and every
scan then run on the device with no host traffic:

- kinship_resident: fully observed IBS through kernel K1
  (ops/hopper_kinship.py), which reads the packed rows directly; IBS with
  missing genotypes and VanRaden unpack and mean-impute each tile on the
  device and accumulate float matmuls (ops/kinship.py);
- kinship_resident_range: the same over a row range [s, e) (LOCO's
  per-chromosome grams), fully observed IBS through kernel K4,
  upper-triangle tiles only;
- emmax_scan_packed: the int8 tiers through kernel K2 and the bf16 tiers
  through kernel K5 (ops/hopper_scan.py), which read the packed rows
  directly (K5 replaces missing genotypes by per-row means); the exact
  tier unpacks each tile, mean-imputes missing genotypes, rotates by a
  full-fp32 GEMM and finishes in kernel K3.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from mixmogam_tpu_torch.oracle.kinship import scale_k  # noqa: F401
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

    # from_source calls so far, counted like the kernel wrappers' .launches
    packs = 0

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
        ResidentGenome.packs += 1
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


def _float_tiles(rg: ResidentGenome, dtype):
    """The genome's REAL rows tile by tile as float tiles on its device,
    mean-imputed when it has missing genotypes. The last tile is cut at
    rg.M, so the zero pad rows (which would look like genotype 0) never
    reach a float update and need no mask."""
    from mixmogam_tpu_torch.models.streaming import _impute_tile

    for s in range(0, rg.M, rg.tile):
        Gt = unpack_2bit_device(rg.packed[s:min(s + rg.tile, rg.M)], rg.n)
        yield _impute_tile(Gt, dtype) if rg.has_missing else Gt.to(dtype)


def rotate_resident_to_device(rg: ResidentGenome, U=None, dtype=None,
                              design=None):
    """(G_rot, keep): G_rot = impute(G) @ U (M, n) built tile by tile from
    the packed rows on rg's device (unpack, mean-impute where rg has
    missing genotypes, full-fp32 GEMM), with no host traffic; U=None gives
    the imputed dosages themselves (the identity K). design and keep: as in
    models/streaming.py::rotate_tiles."""
    from mixmogam_tpu_torch.models.streaming import rotate_tiles

    if dtype is None:
        dtype = _default_dtype(rg.device)
    return rotate_tiles(_float_tiles(rg, dtype), rg.M, rg.n, U, dtype,
                        rg.device, design)


def _vanraden_freqs(C: torch.Tensor, ploidy: int):
    """Per-row allele frequencies p of a mean-imputed float tile, and the
    tile's part of VanRaden's denominator, ploidy * sum p (1 - p), as a
    float64 0-d tensor."""
    p = C.sum(dim=1) / (ploidy * C.shape[1])
    return p, (ploidy * (p * (1.0 - p)).sum()).double()


def kinship_den(rg: ResidentGenome, method: str = "ibs",
                ploidy: Optional[int] = None, dtype=None) -> float:
    """The denominator kinship_resident(rg, method, return_den=True) gives,
    without the gram: the SNP count for IBS; for VanRaden one pass over
    the mean-imputed tiles (LOCO's num_total when the caller brings the
    whole-genome K)."""
    from mixmogam_tpu_torch.ops.kinship import (check_kinship_method,
                                                resolve_compute_dtype)

    if check_kinship_method(method) == "ibs":
        return float(rg.M)
    ploidy = rg.ploidy if ploidy is None else ploidy
    dtype = resolve_compute_dtype(dtype, rg.device)
    return float(sum(_vanraden_freqs(C, ploidy)[1]
                     for C in _float_tiles(rg, dtype)))


def kinship_resident(rg: ResidentGenome, method: str = "ibs",
                     ploidy: Optional[int] = None, dtype=None,
                     return_den: bool = False):
    """Kinship (float64 host (n, n)) from a ResidentGenome, on its device.

    Fully observed IBS: the integer sharing counts of kernel K1 (its plain
    version on the CPU), divided by M (binary) or 2M (diploid). IBS with
    missing genotypes and VanRaden: each tile is unpacked and mean-imputed
    on the device and accumulated by the float updates of ops/kinship.py
    (matmuls in `dtype`: float32 on the card, float64 on the CPU, unless
    given). Every route divides in float64 on the device and copies the
    matrix once.

    return_den=True also returns the normalization denominator (VanRaden:
    ploidy * sum p(1-p); IBS: the SNP count) — what LOCO's
    gram-subtraction identity needs."""
    from mixmogam_tpu_torch.ops.hopper_kinship import ibs_gram_packed
    from mixmogam_tpu_torch.ops.kinship import (_check_matmul_precision,
                                                _ibs_binary_update,
                                                _ibs_diploid_update,
                                                _soft_onehots,
                                                _vanraden_update,
                                                check_kinship_method,
                                                finish_on_device,
                                                resolve_compute_dtype)

    method = check_kinship_method(method)
    ploidy = rg.ploidy if ploidy is None else ploidy
    M, n = rg.M, rg.n
    if method == "ibs" and not rg.has_missing:
        S = ibs_gram_packed(rg.packed, n, M, ploidy)
        Kh = finish_on_device(S, float(M) if ploidy == 1 else 2.0 * M)
        return (Kh, float(M)) if return_den else Kh

    dtype = resolve_compute_dtype(dtype, rg.device)
    K = torch.zeros((n, n), dtype=dtype, device=rg.device)
    _check_matmul_precision(K)
    if method == "vanraden":
        den = torch.zeros((), dtype=torch.float64, device=rg.device)
        for C in _float_tiles(rg, dtype):
            p, d = _vanraden_freqs(C, ploidy)
            den += d
            _vanraden_update(K, C - (ploidy * p)[:, None])
        denom = float(den)
    else:
        # missing genotypes: device-imputed float accumulation (the rule of
        # ops.kinship.kinship's float path)
        for C in _float_tiles(rg, dtype):
            if ploidy == 1:
                _ibs_binary_update(K, C, float(C.shape[0]))
            else:
                _ibs_diploid_update(K, C, *_soft_onehots(C),
                                    float(C.shape[0]))
        denom = float(M)
    Kh = finish_on_device(K, denom)
    return (Kh, denom) if return_den else Kh


def kinship_resident_range(rg: ResidentGenome, s: int, e: int,
                           method: str = "ibs",
                           ploidy: Optional[int] = None, dtype=None,
                           return_den: bool = False):
    """Kinship over the SNP row range [s, e) of a ResidentGenome (LOCO's
    per-chromosome grams). Fully observed IBS: kernel K4 on the card, its
    plain version on the CPU, divided by m = e - s (binary) or 2m;
    everything else: kinship_resident over a view of those rows."""
    from mixmogam_tpu_torch.ops.hopper_kinship import ibs_gram_tri_packed
    from mixmogam_tpu_torch.ops.kinship import (check_kinship_method,
                                                finish_on_device)

    if not (0 <= s < e <= rg.M):
        raise ValueError(f"invalid row range [{s}, {e}) for M={rg.M}")
    method = check_kinship_method(method)
    ploidy = rg.ploidy if ploidy is None else ploidy
    if method == "ibs" and not rg.has_missing:
        m = e - s
        S = ibs_gram_tri_packed(rg.packed, rg.n, s, e, ploidy)
        Kh = finish_on_device(S, float(m) if ploidy == 1 else 2.0 * m)
        return (Kh, float(m)) if return_den else Kh
    return kinship_resident(rg.slice_rows(s, e), method=method,
                            ploidy=ploidy, dtype=dtype,
                            return_den=return_den)
