"""Leave-one-chromosome-out (LOCO) EMMAX (counterpart of
mixmogam_tpu/models/loco.py: loco_kinships, emmax_loco).

Each chromosome c is scanned under the null whose kinship leaves c out.
Every kinship here is a sum of per-SNP terms over its denominator, so

    num_loco(c) = num_total - num(c),  den_loco(c) = den_total - den(c)

with num = K x den: one whole-genome kinship plus one range kinship per
chromosome give every K_loco, in float64 on the host. The denominator is
the SNP count for IBS (fully observed: kernels K1 and K4, rows [s, e) of
the packed genome; with missing genotypes: mean-imputed tiles and float
matmuls, the SNP count all the same) and ploidy * sum p(1 - p) over the
rows for VanRaden, with each row's p taken after the same imputation
(models/resident.py::kinship_resident). The per-chromosome
eigh runs through ops/eigen.py::eigen_k (on the card: float64 cuSOLVER;
on the CPU: host LAPACK; 'fast': float32). With pipeline_eigh, a one-worker
thread builds chromosome c+1's K_loco and its eigh while chromosome c's
null fit and scan run (prefetch depth 1: two (phi, U) pairs alive). Each
chromosome's scan covers its own rows only (ResidentGenome.slice_rows, a
view of the packed rows), at the user's precision tier.

Sources: a ResidentGenome scans on its own device; an int8 array or a
GenotypeData (or a float array of integer dosages, NaN missing) is packed
into a ResidentGenome on `device`. Fractional dosages (imputed, NaN
missing) take the JAX package's host route: each kinship is built by
ops/kinship.py::kinship on `device` (float matmuls: float32 with TF32 off
on the card), with the SNP count (IBS) or _vanraden_den (VanRaden) as its
denominator, and each chromosome's float rows are scanned by the in-core
emmax, at the exact tier or a bf16 tier (the float route, ops/rotate.py).
The ploidy is resolved once from the whole matrix.

mesh= (the exact tier): every rank packs an integer-dosage source on the
host once (ResidentGenome.from_source(upload=False)); rank 0 alone builds
each chromosome's kinship and eigh as above, and each chromosome is
scanned by parallel/distributed.py: its rows of each rank's shard of the
packed rows (distributed_emmax_resident; the shards uploaded once for the
campaign), or a fractional source's rows by distributed_emmax.

_chrom_ranges, _vanraden_den and the eigen-cache helpers are numpy-only
copies of the JAX functions, pinned to the originals by
tests/test_torch_loco.py and tests/test_torch_fractional.py.
"""

from __future__ import annotations

import logging
import time as _time
from typing import Dict, List, Optional, Tuple

import numpy as np

from mixmogam_tpu_torch.ops.eigen import eigen_k_on

__all__ = ["loco_kinships", "emmax_loco"]

_log = logging.getLogger("mixmogam_tpu_torch.loco")


def _chrom_ranges(chromosomes: np.ndarray) -> List[Tuple[object, int, int]]:
    """[(chrom, start, end)] for a chromosome-sorted SNP axis; raises if
    a chromosome's rows are not contiguous (the container invariant —
    GenotypeData keeps SNPs chromosome-major)."""
    chromosomes = np.asarray(chromosomes)
    if chromosomes.ndim != 1:
        raise ValueError("chromosomes must be a 1-D per-SNP array")
    out = []
    seen = set()
    s = 0
    for i in range(1, len(chromosomes) + 1):
        if i == len(chromosomes) or chromosomes[i] != chromosomes[s]:
            c = chromosomes[s].item() if hasattr(chromosomes[s], "item") \
                else chromosomes[s]
            if c in seen:
                raise ValueError(
                    f"chromosome {c!r} appears in non-contiguous blocks; "
                    "sort SNPs chromosome-major first")
            seen.add(c)
            out.append((c, s, i))
            s = i
    return out


def _source_content_key(G) -> Optional[str]:
    """Stable content identity of a genotype source for the LOCO eigen
    cache: ResidentGenome hashes its packed rows, GenotypeData has
    content_hash(), small bare arrays hash directly; None (no caching) for
    unhashable/huge bare sources."""
    import hashlib

    from mixmogam_tpu_torch.models.resident import ResidentGenome

    if isinstance(G, ResidentGenome):
        return G.content_key()
    if hasattr(G, "content_hash"):
        return G.content_hash()[:16]
    arr = G.matrix if hasattr(G, "matrix") else G
    if isinstance(arr, np.ndarray) and arr.nbytes <= (1 << 30):
        return hashlib.sha256(
            np.ascontiguousarray(arr).tobytes()).hexdigest()[:16]
    return None


def _eigen_cache_path(cache_dir: str, key: str) -> str:
    import os

    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"loco_eigen_{key}.npz")


def _eigen_cache_load(path: str):
    import os

    if not os.path.exists(path):
        return None
    try:
        with np.load(path, allow_pickle=False) as z:
            return z["phi"], z["U"]
    except Exception:
        # a corrupt/truncated artifact (e.g. two campaigns racing the
        # same cache_dir) falls back to recomputing the eigh
        _log.warning("unreadable LOCO eigen cache entry %s; recomputing",
                     path)
        return None


def _eigen_cache_save(path: str, phi: np.ndarray, U: np.ndarray) -> None:
    import os

    # uncompressed (U is 839 MB in f64 at n = 10,240; compressing it
    # costs host CPU per chromosome); a PID-unique temp file + atomic
    # replace, so a killed run never leaves a truncated artifact and
    # campaigns sharing a cache_dir cannot interleave writes
    tmp = f"{path}.tmp{os.getpid()}.npz"
    np.savez(tmp, phi=phi, U=U)
    os.replace(tmp, path)


def _vanraden_den(rows: np.ndarray, ploidy: int) -> float:
    """ploidy * sum_j p_j (1 - p_j) with the kernel's imputation rule
    (ops.kinship._impute_chunk: per-SNP mean over observed)."""
    from mixmogam_tpu_torch.ops.kinship import _impute_chunk

    den = 0.0
    for s in range(0, rows.shape[0], 8192):
        C = _impute_chunk(rows[s:s + 8192], "float64")
        p = C.mean(axis=1) / ploidy
        den += float(ploidy * np.sum(p * (1.0 - p)))
    return den


def _as_resident(G, device, ploidy: Optional[int], upload: bool = True):
    """A ResidentGenome (its rows on `device` when it has none:
    ResidentGenome.on_device); an integer-dosage source packed onto
    `device`; None for fractional dosages (the host route). upload=False:
    a ResidentGenome as it is, an integer-dosage source packed on the
    host (the mesh route)."""
    from mixmogam_tpu_torch.models.resident import ResidentGenome
    from mixmogam_tpu_torch.models.source import as_int8_dosage

    if isinstance(G, ResidentGenome):
        return G.on_device(device) if upload else G
    G8 = as_int8_dosage(G)
    if G8 is None:
        return None
    if ploidy is None:
        ploidy = getattr(G, "ploidy", None)
    return ResidentGenome.from_source(G8, ploidy=ploidy,
                                      device=device if upload else None,
                                      upload=upload)


def _loco_resident(G, device, ploidy: Optional[int], method: str,
                   upload: bool = True):
    """_as_resident for a LOCO whose kinships are built here: an unknown
    kinship method is refused before the genome is packed."""
    from mixmogam_tpu_torch.ops.kinship import check_kinship_method

    check_kinship_method(method)
    return _as_resident(G, device, ploidy, upload)


class _HostRows:
    """The host route's fractional source: its float matrix, the ploidy
    resolved once from the whole matrix (a chromosome with no dosage above
    1 stays diploid), and each chromosome's kinship with its denominator,
    built by ops/kinship.py::kinship on `device`."""

    def __init__(self, G, ploidy: Optional[int], method: str, device,
                 dtype=None):
        from mixmogam_tpu_torch.models.source import resolve_source
        from mixmogam_tpu_torch.ops import resolve_device
        from mixmogam_tpu_torch.ops.kinship import check_kinship_method

        self.mat = resolve_source(G)
        if ploidy is None:
            ploidy = getattr(G, "ploidy", None)
        if ploidy is None:
            mx = max((np.nanmax(np.asarray(self.mat[s:s + 8192]),
                                initial=0.0)
                      for s in range(0, self.mat.shape[0], 8192)),
                     default=0.0)
            ploidy = 2 if mx > 1 else 1
        self.ploidy = ploidy
        self.method = check_kinship_method(method)
        self.device = resolve_device(device)
        self.dtype = dtype

    def rows(self, s: int, e: int) -> np.ndarray:
        return np.asarray(self.mat[s:e])

    def kinship(self, s: int, e: int) -> Tuple[np.ndarray, float]:
        """(K, den) of rows [s, e): den is the SNP count (IBS) or
        _vanraden_den (VanRaden)."""
        from mixmogam_tpu_torch.ops.kinship import kinship

        rows = self.rows(s, e)
        K = kinship(rows, method=self.method, ploidy=self.ploidy,
                    device=self.device, dtype=self.dtype)
        den = (_vanraden_den(rows, self.ploidy)
               if self.method == "vanraden" else float(e - s))
        return K, den

    def den_total(self, ranges) -> float:
        """The whole genome's denominator: the SNP count (IBS), or the sum
        of the chromosomes' _vanraden_den (VanRaden), as the JAX package
        recombines them."""
        if self.method != "vanraden":
            return float(self.mat.shape[0])
        return sum(_vanraden_den(self.rows(s, e), self.ploidy)
                   for _, s, e in ranges)

    def total(self, ranges) -> Tuple[np.ndarray, float]:
        """(K_total, den_total): the whole genome's kinship and its
        denominator."""
        from mixmogam_tpu_torch.ops.kinship import kinship

        K = kinship(self.mat, method=self.method, ploidy=self.ploidy,
                    device=self.device, dtype=self.dtype)
        return K, self.den_total(ranges)


def _check_chromosomes(G, chromosomes):
    if chromosomes is None:
        chromosomes = getattr(G, "chromosomes", None)
        if chromosomes is None:
            raise ValueError("pass chromosomes= for a bare matrix source")
    chromosomes = np.asarray(chromosomes)
    ranges = _chrom_ranges(chromosomes)
    if len(ranges) < 2:
        # den_tot - den_c == 0 would make K_loco = 0/0
        raise ValueError("LOCO needs at least 2 chromosomes")
    shp = getattr(G, "shape", None)
    if shp is not None and shp[0] != len(chromosomes):
        raise ValueError(f"chromosomes has {len(chromosomes)} entries but "
                         f"the source holds {shp[0]} SNPs")
    return chromosomes, ranges


def loco_kinships(G, chromosomes=None, method: str = "ibs",
                  ploidy: Optional[int] = None, scale: bool = True,
                  K_total: Optional[np.ndarray] = None,
                  device=None, dtype=None) -> Dict[object, np.ndarray]:
    """{chrom: K_loco} — kinship from every chromosome EXCEPT the key,
    float64 host arrays.

    G: ResidentGenome, GenotypeData (chromosomes taken from it when not
    given) or an (M, n) dosage array + explicit per-SNP chromosomes:
    integer dosages are packed onto `device` (the card by default, 'cpu'
    on request), fractional ones take the host route (float kinships on
    `device`, ploidy from the whole matrix). K_total: reuse an already-built
    whole-genome kinship of the same method (un-scaled); None builds it.
    scale: scale_k-normalize each LOCO matrix (the facade convention
    before REML). dtype: the float kinships' matmul dtype (VanRaden,
    missing genotypes): float32 on the card, float64 on the CPU by
    default."""
    from mixmogam_tpu_torch.models.resident import (kinship_den,
                                                    kinship_resident,
                                                    kinship_resident_range)

    chromosomes, ranges = _check_chromosomes(G, chromosomes)
    rg = _loco_resident(G, device, ploidy, method)
    if rg is None:
        host = _HostRows(G, ploidy, method, device, dtype)
        if K_total is None:
            K_total, den_tot = host.total(ranges)
        else:
            den_tot = host.den_total(ranges)
        return _recombine(K_total, den_tot, ranges, host.kinship, scale)
    pl = rg.ploidy if ploidy is None else ploidy
    if K_total is None:
        K_total, den_tot = kinship_resident(rg, method=method, ploidy=pl,
                                            dtype=dtype, return_den=True)
    else:
        den_tot = kinship_den(rg, method=method, ploidy=pl, dtype=dtype)

    def range_kinship(s, e):
        return kinship_resident_range(rg, s, e, method=method, ploidy=pl,
                                      dtype=dtype, return_den=True)
    return _recombine(K_total, den_tot, ranges, range_kinship, scale)


def _recombine(K_total, den_tot: float, ranges, range_kinship,
               scale: bool) -> Dict[object, np.ndarray]:
    """{chrom: K_loco} = (num_total - num(c)) / (den_total - den(c)) in
    float64, with num = K x den; range_kinship(s, e) -> (K_c, den_c)."""
    from mixmogam_tpu_torch.models.resident import scale_k

    num_tot = np.asarray(K_total, dtype=np.float64) * den_tot
    out: Dict[object, np.ndarray] = {}
    for c, s, e in ranges:
        K_c, den_c = range_kinship(s, e)
        Kl = (num_tot - np.asarray(K_c, np.float64) * den_c) \
            / (den_tot - den_c)
        out[c] = scale_k(Kl) if scale else Kl
    return out


def emmax_loco(G, y, chromosomes=None, method: str = "ibs",
               X0=None, ploidy: Optional[int] = None,
               kinships: Optional[Dict] = None,
               ngrids: int = 100, llim: float = -10.0, ulim: float = 10.0,
               esp: float = 1e-6, with_betas: bool = True,
               precision: Optional[str] = None,
               dtype=None, pipeline_eigh: bool = True,
               cache_dir: Optional[str] = None,
               mesh=None, device=None, **kw) -> Dict[str, np.ndarray]:
    """EMMAX where each chromosome is scanned under the null whose random
    effect excludes that chromosome (LOCO).

    Returns the emmax dict's per-SNP arrays (ps, f_stats, mask, betas,
    var_perc; source SNP order) plus 'loco': {chrom: {delta,
    pseudo_heritability, ll_null}} and 'dof'. kinships: reuse
    loco_kinships output; None builds each K_loco lazily (in the worker
    thread when pipeline_eigh, so only ~2 are alive at once).

    cache_dir: persist each chromosome's (phi, U), keyed by source content
    + chromosome range + method/ploidy/eigh dtype (the JAX package's
    keys); a repeated campaign then skips every eigh, and the
    total-kinship gram too when every chromosome hits. Explicit kinships
    are keyed by their own content hash.

    device: where an array or GenotypeData source is packed and scanned:
    the card by default (without one the call raises), 'cpu' on request;
    a ResidentGenome scans on its own device (a host-only one on
    `device`). Fractional dosages take the host route: float kinships on
    `device` and each chromosome's float rows scanned by the in-core emmax
    (the exact tier, 'high', or a bf16 tier's float route; int8 tiers
    raise).
    **kw goes to each chromosome's emmax_resident or emmax (e.g.
    rescore_top); the rescore cut counts the whole genome's SNPs.

    mesh: a parallel.Mesh (make_mesh()); every rank calls with the same
    arguments. The exact tier only (precision None or 'exact'), no **kw.
    Rank 0 builds each chromosome's kinship and eigh as above (on
    `device`, default the mesh's; kinships, cache_dir and pipeline_eigh
    as above); a ResidentGenome or an integer-dosage source (packed on the
    host once, upload=False) is scanned chromosome by chromosome through
    parallel/distributed.py::distributed_emmax_resident, each rank its
    shard's rows of the chromosome; a fractional source's rows through
    distributed_emmax. On a 'sample' axis (make_mesh((S_snp, S))) each
    chromosome's rotation reaches each rank as its contraction-row block
    and each rank scans its rows x its block of the samples (the
    tensor-parallel scan). Every rank returns the same dict. Device memory:
    each rank's shard is memoized on a caller's container (it lives as
    long as the container); rank 0's kinships read the whole packed
    genome on its device, an upload that a world of one memoizes on the
    container (its shard is a view of it) and a larger world holds for
    this call only."""
    from concurrent.futures import ThreadPoolExecutor

    from mixmogam_tpu_torch.models.emmax import emmax
    from mixmogam_tpu_torch.models.resident import device_key, emmax_resident

    if mesh is not None:
        _check_loco_mesh(mesh, precision, kw)
    chromosomes, ranges = _check_chromosomes(G, chromosomes)
    y = np.asarray(y, dtype=np.float64).ravel()
    M = len(chromosomes)
    if mesh is not None:
        import torch

        device = mesh.device if device is None else torch.device(device)
    upload = mesh is None
    rg = (_loco_resident(G, device, ploidy, method, upload)
          if kinships is None else _as_resident(G, device, ploidy, upload))
    host = None
    if rg is None:
        from mixmogam_tpu_torch.ops import resolve_device
        from mixmogam_tpu_torch.ops.scan import (normalize_rotate_tier,
                                                 resolve_precision)

        # the host route's source is fractional: no probe ('auto' is
        # exact, 'fast' bf16 on the card)
        rd = (None if precision is None
              else normalize_rotate_tier(resolve_precision(
                  precision, device=resolve_device(device))[0]))
        if rd is not None and rd.startswith("int8"):
            raise ValueError(
                f"tier {precision!r} requires integer dosages (the digit-"
                "plane products take int8 genotypes); these are "
                "fractional. Use the exact or a bf16 tier.")
        host = _HostRows(G, ploidy, method, device, dtype)
    dev = (device if mesh is not None
           else rg.device if rg is not None else host.device)
    factor_dtype = np.float32 if str(precision) == "fast" else None
    ftag = "f32" if factor_dtype is np.float32 else "f64"
    lazy = kinships is None
    # rank 0 alone builds the kinships and eighs, from the container's
    # rows on its device: a world of one's upload is memoized on the
    # container (its shard is then a view of it); a larger world's rank 0
    # holds the whole genome for this call only
    builds = mesh is None or mesh.rank == 0
    rg_k = rg
    if rg is not None and builds and lazy:
        rg_k = (rg._upload(device_key(dev))
                if mesh is not None and mesh.world > 1 and rg.on_host
                else rg.on_device(dev))
    src_key = (_source_content_key(G)
               if cache_dir is not None and lazy and builds else None)

    def _save(cpath, eig):
        if cpath is not None:
            _eigen_cache_save(cpath,
                              eig[0].cpu().numpy().astype(np.float64),
                              eig[1].cpu().numpy())

    def _eigh_k_cached(K_c):
        """Explicit kinships: eigh cached by the kinship's own content."""
        cpath = None
        if cache_dir is not None:
            import hashlib

            kh = hashlib.sha256(np.ascontiguousarray(
                K_c, dtype=np.float64).tobytes()).hexdigest()[:16]
            cpath = _eigen_cache_path(cache_dir, f"K{kh}_{ftag}")
            hit = _eigen_cache_load(cpath)
            if hit is not None:
                return hit
        eig = eigen_k_on(np.asarray(K_c, np.float64), dev,
                         factor_dtype=factor_dtype)
        _save(cpath, eig)
        return eig

    if lazy:
        # each K_loco is built right before its eigh: the range gram
        # (K4), its copy to the host, the recombination algebra and the
        # eigh run in the worker thread under the previous chromosome's
        # null fit + scan
        from mixmogam_tpu_torch.models import resident as res_mod

        if host is not None:
            pl = host.ploidy
            range_kinship = host.kinship

            def total_kinship():
                return host.total(ranges)
        else:
            pl = rg.ploidy if ploidy is None else ploidy

            def range_kinship(s_c, e_c):
                return res_mod.kinship_resident_range(
                    rg_k, s_c, e_c, method=method, ploidy=pl,
                    return_den=True)

            def total_kinship():
                return res_mod.kinship_resident(rg_k, method=method,
                                                ploidy=pl, return_den=True)
        tot: Dict[str, object] = {}

        def _ensure_tot():
            # the total gram on first need: skipped on a full cache hit
            if "num" not in tot:
                K_tot, den_tot = total_kinship()
                tot["num"] = np.asarray(K_tot, np.float64) * den_tot
                tot["den"] = den_tot
            return tot["num"], tot["den"]

        def prep(i: int):
            _, s_c, e_c = ranges[i]
            cpath = (None if src_key is None else _eigen_cache_path(
                cache_dir, f"{src_key}_{method}_p{pl}_{s_c}_{e_c}_{ftag}"))
            if cpath is not None:
                hit = _eigen_cache_load(cpath)
                if hit is not None:
                    _log.info("loco prep [%d,%d): eigen cache hit",
                              s_c, e_c)
                    return hit
            num_tot, den_tot = _ensure_tot()
            t0 = _time.time()
            K_c, den_c = range_kinship(s_c, e_c)
            t1 = _time.time()
            Kl = (num_tot - K_c * den_c) / (den_tot - den_c)
            eig = eigen_k_on(res_mod.scale_k(Kl), dev,
                             factor_dtype=factor_dtype)
            _log.info("loco prep [%d,%d): gram+fetch %.1fs, "
                      "algebra+eigh %.1fs", s_c, e_c, t1 - t0,
                      _time.time() - t1)
            _save(cpath, eig)
            return eig
    else:
        def prep(i: int):
            return _eigh_k_cached(kinships[ranges[i][0]])

    merged: Dict[str, np.ndarray] = {}
    loco_info: Dict[object, Dict[str, float]] = {}
    with ThreadPoolExecutor(max_workers=1) as ex:
        futs = {}

        def submit(i: int) -> None:
            if builds and pipeline_eigh and i < len(ranges):
                futs[i] = ex.submit(prep, i)

        submit(0)
        for i, (c, s, e) in enumerate(ranges):
            submit(i + 1)  # c+1's gram + eigh run under c's fit + scan
            t_w = _time.time()
            eig = (None if not builds
                   else futs.pop(i).result() if pipeline_eigh else prep(i))
            t_fit = _time.time()
            if mesh is not None:
                res = _loco_scan_on_mesh(rg, host, s, e, y, eig, X0, mesh,
                                         ngrids, llim, ulim, esp, dtype, dev)
                if not with_betas:
                    res.pop("betas")
                    res.pop("var_perc")
            else:
                fit_kw = dict(X0=X0, eig_k=eig, ngrids=ngrids, llim=llim,
                              ulim=ulim, esp=esp, with_betas=with_betas,
                              precision=precision, dtype=dtype,
                              rescore_cut_M=M, **kw)
                res = (emmax_resident(rg.slice_rows(s, e), y, **fit_kw)
                       if host is None else
                       emmax(host.rows(s, e), y, device=dev, **fit_kw))
            del eig            # free this chromosome's U before the next
            _log.info("loco chrom %s: waited-on-eigh %.1fs, "
                      "fit+scan %.1fs", c, t_fit - t_w,
                      _time.time() - t_fit)
            loco_info[c] = {
                "delta": res["delta"],
                "pseudo_heritability": res["pseudo_heritability"],
                "ll_null": res["ll_null"],
            }
            for k in ("ps", "f_stats", "mask", "betas", "var_perc"):
                if k not in res or res[k] is None:
                    continue
                if k not in merged:
                    merged[k] = np.empty((M,) + np.shape(res[k])[1:],
                                         dtype=np.asarray(res[k]).dtype)
                merged[k][s:e] = res[k]
    merged["loco"] = loco_info
    merged["dof"] = res["dof"]
    return merged


def _check_loco_mesh(mesh, precision, kw) -> None:
    """emmax_loco(mesh=)'s refusals, made on every rank before any
    collective: a mesh that is not a Mesh, a 'sample' axis on a mesh that
    does not hold the world (check_sample_mesh), a tier other than exact,
    and the single-device **kw (the JAX package's messages)."""
    from mixmogam_tpu_torch.parallel.distributed import check_sample_mesh
    from mixmogam_tpu_torch.parallel.mesh import Mesh

    if not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a mixmogam_tpu_torch.parallel.Mesh "
                        f"(make_mesh()); got {type(mesh).__name__}")
    check_sample_mesh(mesh)
    if precision not in (None, "exact"):
        raise ValueError("mesh-distributed LOCO runs the exact tier; pass "
                         "precision=None/'exact'")
    if kw:
        raise TypeError(
            f"mesh-distributed LOCO does not accept {sorted(kw)}")


def _loco_scan_on_mesh(rg, host, s: int, e: int, y, eig, X0, mesh, ngrids,
                       llim, ulim, esp, dtype, device) -> dict:
    """Chromosome [s, e)'s exact scan on the mesh under rank 0's eig (None
    on the other ranks): each rank's shard rows of [s, e) of the packed
    container (on a 'sample' axis its shard's byte block), or the host
    route's rows [s, e) sharded by distributed_emmax. On a 'sample' axis
    both take the tensor-parallel scan: rank 0 scatters each chromosome's
    rotation by contraction-row blocks (distributed.py::_tp_null)."""
    from mixmogam_tpu_torch.parallel.distributed import (
        distributed_emmax, distributed_emmax_resident)

    kw = dict(eig_k=eig, X0=X0, mesh=mesh, ngrids=ngrids, llim=llim,
              ulim=ulim, esp=esp, dtype=dtype, device=device)
    if host is None:
        return distributed_emmax_resident(rg, y, _rows=(s, e), **kw)
    return distributed_emmax(host.rows(s, e), y, **kw)
