"""Fixed-effects per-SNP tests (counterpart of mixmogam_tpu/models/linear.py:
_identity_rot, linear_model, _class_sums, _class_sums_packed, _as_classes,
_infer_ploidy, anova, _kw_missing_core, _kw_missing_packed,
_kw_sorted_precompute, kruskal_wallis).

- linear_model: the EMMAX scan with identity whitening (sd = 1, no
  rotation): each tile of mean-imputed dosage rows goes straight to kernel
  K3 (ops/scan.py::emmax_scan_prerotated, its plain version on the CPU),
  and the rows inside col(X0) come out masked (outside_design).
- anova and kruskal_wallis: per-SNP, per-genotype-class counts and sums
  through indicator products, one (rows, n) x (n, c) product a class, in
  plain torch on the data's device; the F-test and the H statistic finish
  on the host in float64. A ResidentGenome is read a subdivide_tile of
  packed rows at a time, with no host decode. Kruskal-Wallis with missing
  calls ranks each SNP's observed subset from cumulative sums in y's sorted
  order and tie-group gathers (_kw_missing_core), with no loop over SNPs.

The class sums run in float64 by default on every device: the F-test's
between-class sum of squares is a difference of sums of y^2, which float32
would leave with a few digits.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

#: rows of a host source uploaded at a time by the class tests
_CLASS_ROWS = 8_192


def _identity_rot(y: np.ndarray, X0: np.ndarray, dtype, device):
    """RotatedNull of the identity K: sd = 1, the orthonormal basis Q0 of
    X0, y's residual y_res, rss0 and dof, with the design's (X0, X0p) for
    outside_design. No n x n matrix is allocated."""
    from mixmogam_tpu_torch.ops.eigen import orthonormal_basis
    from mixmogam_tpu_torch.ops.scan import RotatedNull, design_basis

    n, q = X0.shape
    yd = torch.as_tensor(y, device=device).to(dtype)
    X0d = torch.as_tensor(X0, device=device).to(dtype)
    Q0 = orthonormal_basis(X0d)
    y_res = yd - Q0 @ (Q0.T @ yd)
    Xb, Xp = design_basis(X0d, device, dtype)
    return RotatedNull(sd=torch.ones(n, dtype=dtype, device=device), Q0=Q0,
                       y_res=y_res, rss0=y_res @ y_res,
                       dof=torch.tensor(n - q - 1, dtype=dtype, device=device),
                       X0=Xb, X0p=Xp)


def linear_model(G, y, X0: Optional[np.ndarray] = None, dtype=None,
                 tile: int = 8192, with_betas: bool = True, mesh=None,
                 device=None) -> Dict[str, np.ndarray]:
    """Per-SNP OLS F-test with the JAX package's arguments and return dict
    (ps, f_stats, mask, dof, and betas / var_perc): the EMMAX scan with
    identity whitening. G: a ResidentGenome (its own device, its tile), or
    a GenotypeData or (M, n) array (int8 with -1 missing, or float dosages
    with NaN missing) on `device`: the card by default (without one the
    call raises), 'cpu' on request. Each tile is one launch of kernel K3
    on the card. dtype: float32 on the card (K3's type), float64 on the
    CPU by default.

    mesh: a parallel.Mesh (make_mesh()) shards the scan by SNP rows, as
    the JAX package's mesh= does: every rank builds the identity null (no
    eigenbasis: cheap and the same everywhere) and scans its rows with K3
    (a ResidentGenome's shard, parallel/distributed.py::shard_packed_rows;
    a host source's rows at `tile`), and the (4, m_rank) statistics meet
    in one all-gather. A 'sample' axis replicates the scan (no W): each
    rank of a 'sample' group scans its 'snp' rows, in core (a
    ResidentGenome raises the JAX package's ValueError). Every rank
    returns the whole result; device: the rank's (default the mesh's)."""
    from mixmogam_tpu_torch.models.emmax import _as_design
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    _default_dtype,
                                                    _float_tiles,
                                                    resident_and_device)
    from mixmogam_tpu_torch.models.source import resolve_source
    from mixmogam_tpu_torch.models.streaming import host_tiles
    from mixmogam_tpu_torch.ops.scan import (emmax_scan_prerotated,
                                             outside_design)
    from mixmogam_tpu_torch.ops.stats import f_sf_host
    from mixmogam_tpu_torch.parallel import distributed as pd

    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    if mesh is None:
        rg, device = resident_and_device(G, device)
    else:
        mesh, device = pd.mesh_entry(mesh, G, "linear_model", device)
        rg = G if isinstance(G, ResidentGenome) else None
    if rg is not None and rg.n != n:
        raise ValueError(f"y has {n} samples but the resident genome holds "
                         f"{rg.n}")
    if dtype is None:
        dtype = _default_dtype(device)
    X0 = _as_design(np.ones((n, 1)) if X0 is None else X0, n)
    rot = _identity_rot(y, X0, dtype, device)
    # mean-imputed float tiles: the packed rows unpacked on their device (cut
    # at M), or a host source's rows uploaded a tile at a time; on a mesh
    # this rank's shard or rows
    src = None if rg is not None else resolve_source(G)
    M = rg.M if rg is not None else src.shape[0]
    part, src = pd.rank_sources(mesh, tile, device, rg, src)
    tiles = (_float_tiles(part, dtype) if part is not None
             else host_tiles(src, dtype, device, tile))
    h = pd.gathered_rows(pd.row_block(
        [emmax_scan_prerotated(Gt, rot, outside_design(Gt, rot.X0, rot.X0p))
         for Gt in tiles], (4,), dtype, device), mesh, M)
    mask = h[3] > 0.5
    dof = n - X0.shape[1] - 1
    out = {"ps": np.where(mask, f_sf_host(h[0], 1.0, dof), 1.0),
           "f_stats": h[0].copy(), "mask": mask, "dof": dof}
    if with_betas:
        out["betas"] = h[1].copy()
        out["var_perc"] = h[2].copy()
    return out


def _class_sums(G: torch.Tensor, W: torch.Tensor, n_classes: int
                ) -> torch.Tensor:
    """(m, n_classes, c) per-SNP, per-genotype-class sums of W's columns:
    one indicator product a class, (G == g) @ W. G: (m, n) integer classes
    (< 0 = missing, which matches no class); W: (n, c) weight columns, such
    as [1, y, y^2] (counts and sums) for ANOVA or [1, ranks] for KW."""
    return torch.stack([(G == g).to(W.dtype) @ W for g in range(n_classes)],
                       dim=1)


def _class_sums_packed(packed: torch.Tensor, W: torch.Tensor, n: int,
                       M: int, tile: int, n_classes: int) -> torch.Tensor:
    """(M, n_classes, c) _class_sums over the first M rows of a 2-bit
    packed genome on its device, `tile` rows unpacked at a time."""
    from mixmogam_tpu_torch.ops.pack2 import unpack_2bit_device

    if not M:
        return W.new_zeros((0, n_classes, W.shape[1]))
    return torch.cat([_class_sums(unpack_2bit_device(packed[s:min(s + tile,
                                                                  M)], n),
                                  W, n_classes)
                      for s in range(0, M, tile)])


def _as_classes(G: np.ndarray) -> np.ndarray:
    """int8 genotype classes with -1 = missing. Float input: NaN (the
    package's float missing convention) -> -1; fractional (mean-imputed)
    dosages classify by the nearest class."""
    if np.issubdtype(G.dtype, np.integer):
        return G.astype(np.int8)
    miss = np.isnan(G)
    return np.where(miss, -1, np.rint(np.where(miss, 0, G))).astype(np.int8)


def _infer_ploidy(G: np.ndarray) -> int:
    mx = (np.nanmax(G, initial=0) if np.issubdtype(G.dtype, np.floating)
          else G.max(initial=0))
    return 2 if mx > 1 else 1


def _class_source(G, y: np.ndarray, ploidy, device, mesh):
    """(rg, host int8 classes, ploidy, device): a ResidentGenome stays
    packed on its own device (on a mesh: as it is, each rank taking its
    shard); a GenotypeData or array becomes int8 classes on the host
    (_as_classes), the ploidy inferred from all of them."""
    from mixmogam_tpu_torch.models.resident import ResidentGenome
    from mixmogam_tpu_torch.ops import resolve_device

    if isinstance(G, ResidentGenome):
        if G.n != y.shape[0]:
            raise ValueError(f"y has {y.shape[0]} samples but the resident "
                             f"genome holds {G.n}")
        if mesh is None:
            G = G.on_device(device)
            device = G.device
        return G, None, G.ploidy if ploidy is None else ploidy, device
    if mesh is None:
        device = resolve_device(device)
    if hasattr(G, "matrix"):
        ploidy = G.ploidy if ploidy is None else ploidy
        G = G.matrix
    G = _as_classes(np.asarray(G))
    return None, G, _infer_ploidy(G) if ploidy is None else ploidy, device


def _class_sums_of(rg, Gc, W: torch.Tensor, C: int, mesh) -> np.ndarray:
    """(M, C, c) float64 host class sums of a resident genome or of host
    int8 classes, over the device W lives on. On a mesh each rank sums its
    rows (the container's shard, whose tile the 2,048-row subtile divides
    as it divides one device's rows; the classes' rank_range rows at
    _CLASS_ROWS) and the sums meet in one all-gather."""
    from mixmogam_tpu_torch.models.resident import subdivide_tile
    from mixmogam_tpu_torch.parallel.distributed import (gathered_rows,
                                                         rank_sources)

    M = rg.M if rg is not None else Gc.shape[0]
    part, rows = rank_sources(mesh, _CLASS_ROWS, W.device, rg, Gc)
    if part is not None:
        out = _class_sums_packed(part.packed, W, part.n, part.M,
                                 subdivide_tile(rg.tile), C)
    else:
        out = torch.cat([_class_sums(torch.from_numpy(np.ascontiguousarray(
            rows[s:s + _CLASS_ROWS])).to(W.device), W, C)
            for s in range(0, rows.shape[0], _CLASS_ROWS)]
            or [W.new_zeros((0, C, W.shape[1]))])
    return gathered_rows(out.permute(1, 2, 0), mesh, M).transpose(2, 0, 1)


def anova(G, y, ploidy: Optional[int] = None, dtype=None, mesh=None,
          device=None) -> Dict[str, np.ndarray]:
    """Per-SNP one-way ANOVA over genotype classes with the JAX package's
    arguments and return dict (ps, f_stats, dof1, dof2). G: a
    ResidentGenome (its own device) or a GenotypeData or array on `device`
    (the card by default, 'cpu' on request). dtype: float64 by default.

    mesh: a parallel.Mesh (make_mesh()) shards the class sums by SNP rows,
    as the JAX package's mesh= does (_class_sums_of): [1, y, y^2] is the
    same on every rank, each rank sums its rows, one all-gather; a
    'sample' axis replicates the sums (in core; a ResidentGenome raises
    the JAX package's ValueError); every rank returns the whole result.
    device: the rank's (default the mesh's)."""
    from mixmogam_tpu_torch.ops.stats import f_sf_host
    from mixmogam_tpu_torch.parallel.distributed import mesh_entry

    if mesh is not None:
        mesh, device = mesh_entry(mesh, G, "anova", device)
    y = np.asarray(y, dtype=np.float64).ravel()
    rg, Gc, ploidy, device = _class_source(G, y, ploidy, device, mesh)
    W = torch.as_tensor(np.column_stack([np.ones_like(y), y, y * y]),
                        device=device).to(dtype or torch.float64)
    out = _class_sums_of(rg, Gc, W, ploidy + 1, mesh)
    cnt, s1, s2 = out[:, :, 0], out[:, :, 1], out[:, :, 2]
    N = cnt.sum(axis=1)
    T = s1.sum(axis=1)
    ss_tot = s2.sum(axis=1) - T**2 / np.maximum(N, 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        ssb = np.where(cnt > 0, s1**2 / np.maximum(cnt, 1), 0.0).sum(axis=1) \
            - T**2 / np.maximum(N, 1)
    ssw = np.maximum(ss_tot - ssb, 0.0)
    k = (cnt > 0).sum(axis=1)
    d1 = np.maximum(k - 1, 1)
    d2 = np.maximum(N - k, 1)
    valid = (k >= 2) & (ssw > 0) & (N - k > 0)
    f = np.where(valid, (ssb / d1) / np.maximum(ssw / d2, 1e-300), 0.0)
    ps = np.where(valid, f_sf_host(f, d1, d2), 1.0)
    return {"ps": ps, "f_stats": f, "dof1": d1, "dof2": d2}


def _kw_missing_core(Gs, a_idx, b_idx, starts, ends, n_classes: int, fdt):
    """Kruskal-Wallis (h, classes, valid) for a tile of SNP rows with
    per-SNP missing subsets. Gs: (m, n) int8 classes with the columns in
    y's ascending order (< 0 missing); a_idx / b_idx: (n,) start and end of
    each position's tie group; starts / ends: the tie groups' bounds.
    Within SNP j's observed subset a sample's rank is (#observed before its
    tie group) + (#observed in the group + 1) / 2: scipy.stats.rankdata's
    mid-ranks on the subset."""
    O = (Gs >= 0).to(fdt)
    c = torch.cumsum(O, dim=1)
    c0 = torch.cat([O.new_zeros((Gs.shape[0], 1)), c], dim=1)
    cA = c0[:, a_idx]
    ranks = cA + (c0[:, b_idx] - cA + 1.0) / 2.0
    nj = c[:, -1]
    hnum = torch.zeros_like(nj)
    kcls = torch.zeros_like(nj)
    for g in range(n_classes):
        ind = (Gs == g).to(fdt)
        cnt_g = ind.sum(dim=1)
        R_g = (ind * ranks).sum(dim=1)
        hnum = hnum + torch.where(cnt_g > 0, R_g * R_g
                                  / torch.clamp(cnt_g, min=1.0), 0.0)
        kcls = kcls + (cnt_g > 0).to(fdt)
    h = (12.0 / torch.clamp(nj * (nj + 1.0), min=1.0) * hnum
         - 3.0 * (nj + 1.0))
    # the tie correction over each SNP's observed tie-group sizes
    d = c0[:, ends] - c0[:, starts]
    tie = 1.0 - (d**3 - d).sum(dim=1) / torch.clamp(nj**3 - nj, min=1.0)
    # scipy.stats.kruskal's rule: >= 2 classes and not all y tied
    valid = (kcls >= 2) & (tie > 0)
    h = torch.where(valid, h / torch.where(valid, tie, 1.0), 0.0)
    return h, kcls, valid


def _kw_missing_packed(packed, order, a_idx, b_idx, starts, ends, n: int,
                       M: int, tile: int, n_classes: int, fdt):
    """_kw_missing_core over the first M rows of a 2-bit packed genome on
    its device: each tile is unpacked and its columns gathered into y's
    sorted order there."""
    from mixmogam_tpu_torch.ops.pack2 import unpack_2bit_device

    return [_kw_missing_core(
        unpack_2bit_device(packed[s:min(s + tile, M)], n).index_select(
            1, order), a_idx, b_idx, starts, ends, n_classes, fdt)
        for s in range(0, M, tile)]


def _kw_sorted_precompute(y: np.ndarray):
    """y's sorted order, each position's tie-group [start, end) and the
    distinct groups' bounds (the missing-call KW's y-only inputs)."""
    n = y.shape[0]
    order = np.argsort(y, kind="stable")
    ys = y[order]
    new_grp = np.r_[True, ys[1:] != ys[:-1]] if n else np.zeros(0, bool)
    gid = np.cumsum(new_grp) - 1
    starts = np.flatnonzero(new_grp)
    ends = np.append(starts[1:], n)
    return order, starts[gid], ends[gid], starts, ends


def kruskal_wallis(G, y, ploidy: Optional[int] = None, dtype=None,
                   tile: int = 4096, mesh=None, device=None
                   ) -> Dict[str, np.ndarray]:
    """Per-SNP Kruskal-Wallis with tie correction, with the JAX package's
    arguments and return dict (ps, stats). Fully observed genotypes: one
    global rank vector and the class-sum products; missing genotypes: each
    SNP's observed subset ranked on the device (_kw_missing_core). G: a
    ResidentGenome (its own device) or a GenotypeData or array on `device`
    (the card by default, 'cpu' on request). dtype: float64 by default.

    mesh: a parallel.Mesh (make_mesh()) shards either route by SNP rows,
    as the JAX package's mesh= does: the rank vector, or y's sorted order
    and tie groups, are the same on every rank; each rank takes its rows
    (a ResidentGenome's shard; a host source's rows at `tile` on the
    missing-call route, at the class sums' own rows otherwise), one
    all-gather; a 'sample' axis replicates them (in core; a ResidentGenome
    raises the JAX package's ValueError). Every rank returns the whole
    result; device: the rank's (default the mesh's)."""
    import scipy.stats

    from mixmogam_tpu_torch.models.resident import subdivide_tile
    from mixmogam_tpu_torch.ops.stats import chi2_sf_host
    from mixmogam_tpu_torch.parallel import distributed as pd

    if mesh is not None:
        mesh, device = pd.mesh_entry(mesh, G, "kruskal_wallis", device)
    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    fdt = dtype or torch.float64
    rg, Gc, ploidy, device = _class_source(G, y, ploidy, device, mesh)
    C = ploidy + 1
    if rg.has_missing if rg is not None else (Gc < 0).any():
        order, a, b, starts, ends = (
            torch.as_tensor(v, device=device)
            for v in _kw_sorted_precompute(y))
        M = rg.M if rg is not None else Gc.shape[0]
        part, rows = pd.rank_sources(mesh, tile, device, rg, Gc)
        if part is not None:
            outs = _kw_missing_packed(part.packed, order, a, b, starts, ends,
                                      n, part.M, subdivide_tile(rg.tile), C,
                                      fdt)
        else:
            Gsrt = rows[:, order.cpu().numpy()]
            outs = [_kw_missing_core(torch.from_numpy(np.ascontiguousarray(
                Gsrt[s:s + tile])).to(device), a, b, starts, ends, C, fdt)
                for s in range(0, Gsrt.shape[0], tile)]
        # [h, classes, valid] a tile, valid as 0 / 1
        hs, ks, vs = pd.gathered_rows(pd.row_block(
            [torch.stack([h, k, v.to(fdt)]) for h, k, v in outs], (3,), fdt,
            device), mesh, M)
        vs = vs > 0.5
        ps = np.where(vs, chi2_sf_host(hs, np.maximum(ks - 1, 1)), 1.0)
        return {"ps": ps, "stats": np.where(vs, hs, 0.0)}
    ranks = scipy.stats.rankdata(y)
    # the tie correction shared by all SNPs (the same samples everywhere)
    _, t = np.unique(y, return_counts=True)
    tie_c = 1.0 - np.sum(t**3 - t) / max(n**3 - n, 1)
    W = torch.as_tensor(np.column_stack([np.ones(n), ranks]),
                        device=device).to(fdt)
    out = _class_sums_of(rg, Gc, W, C, mesh)
    cnt, rsum = out[:, :, 0], out[:, :, 1]
    with np.errstate(divide="ignore", invalid="ignore"):
        h = 12.0 / (n * (n + 1)) * np.where(
            cnt > 0, rsum**2 / np.maximum(cnt, 1), 0.0).sum(axis=1) \
            - 3.0 * (n + 1)
    k = (cnt > 0).sum(axis=1)
    valid = (k >= 2) & (tie_c > 0)
    h = np.where(valid, h / tie_c, 0.0)
    ps = np.where(valid, chi2_sf_host(h, np.maximum(k - 1, 1)), 1.0)
    return {"ps": ps, "stats": h}
