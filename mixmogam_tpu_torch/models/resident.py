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
  directly (K5 replaces missing genotypes by per-row means), with the
  design folded into their W (ops/scan.py fold_design) and the rows
  inside col(X0) masked by one more pass over the packed rows; the exact
  tier unpacks each tile, mean-imputes missing genotypes, rotates by a
  full-fp32 GEMM and finishes in kernel K3.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from mixmogam_tpu_torch.data.pack2 import pack_2bit, unpack_2bit
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


def subdivide_tile(tile: int, target: int = 2048) -> int:
    """Largest divisor of `tile` <= target reached by halving (a copy of
    the JAX package's function). Packed rows fix the outer tile; the class
    tests (models/linear.py), which hold several (rows, n) float
    intermediates a step, view the packed rows at this finer granularity
    to bound device memory."""
    sub = tile
    while sub > target and sub % 2 == 0:
        sub //= 2
    return sub


def device_key(device) -> torch.device:
    """`device` with its index: a bare 'cuda' names the current card, so
    memos keyed on a device find the same entry either way."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


class ResidentGenome:
    """(M, n) int8 dosages held 2-bit packed on a device (or on the host
    only: from_source(upload=False), for the mesh routes).

    Quacks like a read-only SNP-major matrix source: `.shape`, `.dtype`
    (int8), and slicing / integer-array row indexing return HOST int8
    rows (-1 for missing), decoded from the host copy of the packed rows
    by data/pack2.py (no read-back from the card)."""

    # from_source calls so far, counted like the kernel wrappers' .launches
    packs = 0
    # copies of a host-only container's rows to a device so far (on_device,
    # parallel/distributed.py::shard_packed_rows), counted the same way
    uploads = 0

    def __init__(self, packed, M: int, n: int, ploidy: int,
                 tile: int, has_missing: bool,
                 host_packed: Optional[np.ndarray] = None):
        """packed: (rows >= M, ceil(n/4)) uint8 rows on the device, or a
        numpy array for a host-only container (from_source(upload=False));
        rows past M are zero padding. host_packed: the same rows on the
        host, read back from `packed` when not given."""
        self.packed = packed
        if host_packed is None:
            host_packed = (packed if isinstance(packed, np.ndarray)
                           else packed.cpu().numpy())
        self.host_packed = host_packed
        self.M = int(M)
        self.n = int(n)
        self.ploidy = int(ploidy)
        self.tile = int(tile)
        self.has_missing = bool(has_missing)
        self._content_key: Optional[str] = None
        # device -> this container's rows uploaded there (on_device), and
        # shard_packed_rows' shards: both hold device memory for as long
        # as the container lives
        self._uploads: dict = {}
        self._shards: dict = {}

    @property
    def on_host(self) -> bool:
        """True for a host-only container: its rows are on no device."""
        return isinstance(self.packed, np.ndarray)

    def on_device(self, device=None) -> "ResidentGenome":
        """The container a single-device entry point scans: this one when
        its rows are on a device (which it scans on, whatever `device`
        says); for a host-only container, its rows uploaded once to
        resolve_device(device) (the card unless 'cpu' is asked for; it
        raises without a card) and memoized here per device, so the
        upload holds device memory for as long as this container lives."""
        from mixmogam_tpu_torch.ops import resolve_device

        if not self.on_host:
            return self
        dev = device_key(resolve_device(device))
        rg = self._uploads.get(dev)
        if rg is None:
            rg = self._uploads[dev] = self._upload(dev)
        return rg

    def _upload(self, dev) -> "ResidentGenome":
        """This container's host rows copied to `dev` (counted in
        uploads), not memoized: the copy lives as long as its caller
        holds it."""
        ResidentGenome.uploads += 1
        rg = ResidentGenome(torch.from_numpy(self.host_packed).to(dev),
                            self.M, self.n, self.ploidy, self.tile,
                            self.has_missing, host_packed=self.host_packed)
        rg._content_key = self._content_key
        return rg

    def content_key(self) -> str:
        """Stable content identity: sha256 of 'M:n:tile:' and the host
        packed rows (pad rows are zeros), first 16 hex digits, memoized.
        The JAX package's key for the same rows: the LOCO eigen caches of
        both packages agree."""
        if self._content_key is None:
            h = hashlib.sha256()
            h.update(f"{self.M}:{self.n}:{self.tile}:".encode())
            h.update(np.ascontiguousarray(self.host_packed).tobytes())
            self._content_key = h.hexdigest()[:16]
        return self._content_key

    @property
    def device(self) -> Optional[torch.device]:
        """The rows' device; None for a host-only container."""
        return None if self.on_host else self.packed.device

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.M, self.n)

    @property
    def dtype(self):
        return np.dtype(np.int8)

    @property
    def nbytes_packed(self) -> int:
        return int(self.host_packed.nbytes)

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
        return unpack_2bit(rows, self.n)

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
                    ploidy: Optional[int] = None, device=None,
                    cache_path: Optional[str] = None,
                    trust_cache: bool = False,
                    upload: bool = True) -> "ResidentGenome":
        """Pack an int8 host source (ndarray / memmap / h5py /
        GenotypeData) chunk by chunk on `device` (the card by default,
        'cpu' on request; pack_2bit_device) and
        keep a host copy of the packed rows (one read-back). Rows are
        zero-padded to a tile multiple: dosage-0 pad rows are degenerate
        in the scan (masked) and add nothing to any kinship term.

        cache_path: keep the host packed rows in an .npy at that path and
        a .json sidecar {M, n, ploidy, tile, has_missing, src_hash}, the
        JAX package's format (a cache either package writes loads in the
        other). src_hash is the first 16 hex digits of a sha256 of the
        source's int8 rows, folded into the pack pass. The cache is reused
        only when it matches the request: the same tile and source shape,
        the same explicit ploidy, and the same content (one read of the
        source to hash it) unless trust_cache=True. Otherwise the source
        is packed again and the cache rewritten. A hit uploads the cached
        rows once and does not count in ResidentGenome.packs. G=None loads
        the cache as it is, and raises with the reason when it is missing
        or does not match.

        upload=False packs on the host (data/pack2.py, the host library's
        packer, bit-equal to pack_2bit_device) and allocates nothing on
        any device: a host-only container, whose `packed` is the numpy
        array, for the mesh routes (parallel/distributed.py::
        shard_packed_rows uploads each rank's rows only). A single-device
        entry point uploads its rows once, to the device it resolves
        (ResidentGenome.on_device). device= then has no meaning and
        raises."""
        from mixmogam_tpu_torch.models.source import resolve_source
        from mixmogam_tpu_torch.ops import resolve_device

        if not upload and device is not None:
            raise ValueError("upload=False keeps the packed rows on the "
                             f"host; device={device!r} has no meaning")
        device = resolve_device(device) if upload else None
        mat = None if G is None else resolve_source(G)
        if mat is not None and np.dtype(mat.dtype) != np.int8:
            raise TypeError(
                "ResidentGenome stores int8 dosages 0..2 (+ -1 missing); "
                f"got dtype {mat.dtype}")
        src_hash = None
        meta_path = cache_path + ".json" if cache_path else None
        if cache_path and os.path.exists(cache_path) \
                and os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            ok = (meta["tile"] == tile
                  and (mat is None
                       or tuple(mat.shape) == (meta["M"], meta["n"]))
                  and (ploidy is None or ploidy == meta["ploidy"]))
            if ok and mat is not None and not trust_cache:
                src_hash = _source_hash(mat, chunk)
                ok = meta.get("src_hash") == src_hash
            if ok:
                hp = np.load(cache_path)
                return cls(torch.from_numpy(hp).to(device) if upload else hp,
                           meta["M"], meta["n"], meta["ploidy"], tile,
                           meta["has_missing"], host_packed=hp)
            if mat is None:
                raise ValueError(
                    f"packed cache at {cache_path} does not match the "
                    f"request (meta={meta}, tile={tile}, "
                    f"ploidy={ploidy}) and no source was given to "
                    "repack from")
        if mat is None:
            raise ValueError(
                f"packed cache at {cache_path!r} is missing or has no "
                ".json sidecar, and no source was given to repack from")
        ResidentGenome.packs += 1
        if ploidy is None:
            ploidy = getattr(G, "ploidy", None)
        M, n = mat.shape
        M_pad = -(-M // tile) * tile
        shape = (M_pad, (n + 3) // 4)
        packed = (torch.zeros(shape, dtype=torch.uint8, device=device)
                  if upload else np.zeros(shape, dtype=np.uint8))
        has_missing = False
        vmax = 0
        # the content hash rides the pack pass (no second source read),
        # unless the cache's validation computed it already
        h = hashlib.sha256() if cache_path and src_hash is None else None
        for s in range(0, M, chunk):
            e = min(s + chunk, M)
            c = np.ascontiguousarray(np.asarray(mat[s:e], dtype=np.int8))
            if h is not None:
                h.update(c)
            if upload:
                c = torch.from_numpy(c).to(device)
                lo, hi = (int(v) for v in torch.aminmax(c))
            else:
                lo, hi = int(c.min(initial=0)), int(c.max(initial=0))
            if lo < -1 or hi > 2:
                raise ValueError("ResidentGenome stores dosages 0..2 (+ -1 "
                                 "= missing); the source holds other "
                                 "values")
            has_missing |= lo < 0
            vmax = max(vmax, hi)
            packed[s:e] = pack_2bit_device(c) if upload else pack_2bit(c)
        if ploidy is None:
            ploidy = 2 if vmax > 1 else 1
        rg = cls(packed, M, n, ploidy, tile, has_missing)
        if cache_path:
            # the sidecar goes first and comes back last: rows written
            # halfway never sit beside a sidecar that would vouch for them
            if os.path.exists(meta_path):
                os.remove(meta_path)
            tmp = f"{cache_path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                np.save(f, rg.host_packed)
            os.replace(tmp, cache_path)
            with open(tmp, "w") as f:
                json.dump({"M": M, "n": n, "ploidy": int(ploidy),
                           "tile": tile, "has_missing": has_missing,
                           "src_hash": src_hash or h.hexdigest()[:16]}, f)
            os.replace(tmp, meta_path)
        return rg


def _source_hash(mat, chunk: int) -> str:
    """First 16 hex digits of the sha256 of the source's int8 rows, read
    `chunk` rows at a time: the packed cache's src_hash."""
    h = hashlib.sha256()
    for s in range(0, mat.shape[0], chunk):
        h.update(np.ascontiguousarray(
            np.asarray(mat[s:s + chunk], dtype=np.int8)))
    return h.hexdigest()[:16]


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


def _tile_from_packed_cols(packed: torch.Tensor, s: int, tile: int, n: int,
                           cols: torch.Tensor) -> torch.Tensor:
    """Rows [s, s + tile) of a packed genome unpacked on its device, with
    the sample columns `cols` (an int64 index on that device) gathered
    there: a missing-phenotype group of models/multitrait.py scans a
    column subset of the container, with no host decode. Raw int8 (-1 =
    missing): impute after the gather, so the means are the subset's."""
    return unpack_2bit_device(packed[s:s + tile], n).index_select(1, cols)


def design_mask_packed(packed: torch.Tensor, rot, n: int, tile: int,
                       impute: bool = False) -> torch.Tensor:
    """(M_pad,) bool on packed's device: ops/scan.py outside_design of
    every packed row (mean-imputed first where imputing, as _impute_tile),
    in rot's dtype, one tile at a time: the rows whose part outside
    col(X0) is more than rounding. The int8 / bf16 tiers' W'' sends a row
    inside col(X0) (a monomorphic SNP, a cofactor's own row) to rounding
    noise, which their relative mask would pass. Zero pad rows come out
    False."""
    from mixmogam_tpu_torch.models.streaming import _impute_tile
    from mixmogam_tpu_torch.ops.scan import outside_design

    dt = rot.X0p.dtype
    keep = []
    for s in range(0, packed.shape[0], tile):
        Gt = unpack_2bit_device(packed[s:s + tile], n)
        Gt = _impute_tile(Gt, dt) if impute else Gt.to(dt)
        keep.append(outside_design(Gt, rot.X0, rot.X0p))
    return torch.cat(keep)


def emmax_scan_packed(packed: torch.Tensor, rot, n: int, tile: int,
                      impute: bool = False) -> torch.Tensor:
    """(4, M_pad) EMMAX stats [f, beta, var_perc, mask] over a packed
    genome on its device. int8 tiers: one K2 launch over every row. bf16
    tiers: one K5 launch over every row (with per-row means when
    imputing). Both take rot.scan_q0 (no columns for the folded W'' of
    build_rotated_null) and then the mask of the rows inside col(X0)
    (design_mask_packed, one pass over the packed rows a call). Exact
    tier: per tile, unpack (+ mean-impute) -> fp32 GEMM by U (with
    rot.high, the 'high' tier's three bf16 passes on the int8 rows or the
    imputed ones) -> K3."""
    from mixmogam_tpu_torch.models.streaming import _impute_tile
    from mixmogam_tpu_torch.ops.hopper_scan import (rotate_scan_bf16_packed,
                                                    rotate_scan_int8_packed,
                                                    scan_operand)
    from mixmogam_tpu_torch.ops.scan import emmax_scan_stats

    dt = rot.sd.dtype
    if rot.parts is None and rot.planes is None:
        outs = []
        for s in range(0, packed.shape[0], tile):
            Gt = unpack_2bit_device(packed[s:s + tile], n)
            # int8 rows go as they are: the rotation casts them (and the
            # 'high' tier skips their zero lo part)
            Gt = _impute_tile(Gt, dt) if impute else Gt
            outs.append(emmax_scan_stats(Gt, rot))
        return torch.cat(outs, dim=1)
    # the kernels' prepared W, built once per rotated null and kept with it
    op = scan_operand(rot) if packed.device.type == "cuda" else None
    if rot.parts is not None:
        mu = row_means_packed(packed, n, tile, dt) if impute else None
        out = rotate_scan_bf16_packed(packed, n, rot.parts, rot.y_res,
                                      rot.scan_q0, rot.rss0, rot.dof, mu,
                                      operand=op)
    else:
        if impute:
            raise ValueError("int8 digit-plane tiers need fully observed "
                             "dosages")
        out = rotate_scan_int8_packed(packed, n, rot.planes, rot.w_scale,
                                      rot.y_res, rot.scan_q0, rot.rss0,
                                      rot.dof, operand=op)
    if not rot.folded:
        return out
    keep = design_mask_packed(packed, rot, n, tile, impute)
    # every output zeroed off the mask, the mask included
    return torch.where(keep[None, :], out, 0.0)


def resident_and_device(G, device):
    """(rg, device) of a single-device entry point: a ResidentGenome's
    container on a device and that device (ResidentGenome.on_device: a
    host-only container is uploaded once to resolve_device(device)); any
    other source: (None, resolve_device(device))."""
    from mixmogam_tpu_torch.ops import resolve_device

    if isinstance(G, ResidentGenome):
        rg = G.on_device(device)
        return rg, rg.device
    return None, resolve_device(device)


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
    refuse them. 'high' runs the exact tier's route, each tile's rows
    rotated in three bf16 passes (ops/rotate.py::rotate_high), at the JAX
    package's scan tile for its matmul tiers, subdivide_tile(rg.tile,
    8,192). rescore_cut_M: the study's SNP count for the rescore cut
    when rg holds part of it (LOCO's chromosomes)."""
    from mixmogam_tpu_torch.models.emmax import _as_design
    from mixmogam_tpu_torch.models.streaming import finalize_scan
    from mixmogam_tpu_torch.ops.reml import (esp_to_refine_iters,
                                             fit_null_model)
    from mixmogam_tpu_torch.ops.scan import (build_rotated_null, matmul_tier,
                                             normalize_rotate_tier,
                                             probe_for_source,
                                             resolve_precision)

    rg = rg.on_device()
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
        rotate_in_bf16, tier_name = resolve_precision(
            precision, G=probe_for_source(rg), device=device)
    rd, mp = matmul_tier(normalize_rotate_tier(rotate_in_bf16))
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
    rot = build_rotated_null(null, rotate_dtype=rd, matmul_precision=mp)
    # the JAX package's scan tile for its matmul tiers (the exact tier's
    # is rg.tile; the packed kernels take every row in one launch)
    scan_tile = rg.tile if mp is None else subdivide_tile(rg.tile, 8_192)
    out = emmax_scan_packed(rg.packed, rot, rg.n, scan_tile,
                            impute=rg.has_missing)
    h = out[:, :rg.M].detach().cpu().double().numpy()
    return finalize_scan(
        rg, null, dtype, h[0].copy(), h[3] > 0.5,
        betas=h[1].copy() if with_betas else None,
        var_perc=h[2].copy() if with_betas else None,
        with_betas=with_betas, rescore_top=rescore_top, rd=rd,
        matmul_precision=mp, tier_name=tier_name, dof=int(rot.dof),
        rescore_cut_M=rescore_cut_M, fractional=bool(mp and rg.has_missing))


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

    rg = rg.on_device()
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
    rg = rg.on_device()
    ploidy = rg.ploidy if ploidy is None else ploidy
    dtype = resolve_compute_dtype(dtype, rg.device)
    return float(sum(_vanraden_freqs(C, ploidy)[1]
                     for C in _float_tiles(rg, dtype)))


def ibs_counts_resident(rg: ResidentGenome, ploidy: Optional[int] = None
                        ) -> torch.Tensor:
    """The int32 (n, n) IBS sharing counts of a fully observed
    ResidentGenome by kernel K1 (its plain version on the CPU), before
    the division by M (binary) or 2M (diploid) that kinship_resident
    makes: the partial gram a rank of distributed_kinship sums with the
    others'."""
    from mixmogam_tpu_torch.ops.hopper_kinship import ibs_gram_packed

    rg = rg.on_device()
    return ibs_gram_packed(rg.packed, rg.n, rg.M,
                           rg.ploidy if ploidy is None else ploidy)


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
    from mixmogam_tpu_torch.ops.kinship import (_check_matmul_precision,
                                                _ibs_binary_update,
                                                _ibs_diploid_update,
                                                _soft_onehots,
                                                _vanraden_update,
                                                check_kinship_method,
                                                finish_on_device,
                                                resolve_compute_dtype)

    method = check_kinship_method(method)
    rg = rg.on_device()
    ploidy = rg.ploidy if ploidy is None else ploidy
    M, n = rg.M, rg.n
    if method == "ibs" and not rg.has_missing:
        S = ibs_counts_resident(rg, ploidy)
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
    rg = rg.on_device()
    ploidy = rg.ploidy if ploidy is None else ploidy
    if method == "ibs" and not rg.has_missing:
        m = e - s
        S = ibs_gram_tri_packed(rg.packed, rg.n, s, e, ploidy)
        Kh = finish_on_device(S, float(m) if ploidy == 1 else 2.0 * m)
        return (Kh, float(m)) if return_den else Kh
    return kinship_resident(rg.slice_rows(s, e), method=method,
                            ploidy=ploidy, dtype=dtype,
                            return_den=return_den)
