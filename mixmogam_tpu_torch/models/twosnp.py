"""Two-SNP / epistasis scans (counterpart of mixmogam_tpu/models/twosnp.py:
emmax_two_snps, _pairwise_interaction; reference:
linear_models.emmax_two_snps).

For a focal SNP set A (top hits of a prior scan, or given rows) each pair
(a, b), b over all M SNPs, gets:
  cond_ps   g_b tested with g_a as a cofactor        ([X0, g_a] vs + g_b)
  inter_ps  g_a * g_b tested on top of [X0, g_a, g_b]   (1 dof)
delta is fit once on the global null [X0] (EMMAX), or per focal SNP on
[X0, g_a] with refit_delta_per_focal=True; each focal SNP's whitened null
is built in float64 at its delta (models/stepwise.py::_rot_null_from_delta).

The scan runs tile-outer, focal-inner (the JAX package loops focal-outer
over a rotated copy of the whole genome; the results do not depend on the
order). Each tile is rotated once, R = tile U' with U' = (I - P_X0) U
(ops/scan.py::project_design), an exact float32 GEMM (TF32 off); then for
each focal SNP:
- the conditional scan: kernel K3 on R with g_a's null
  (ops/scan.py::emmax_scan_prerotated; the JAX package's
  emmax_scan_all(pre_rotated=True), whose Pallas form is
  pallas_scan_stats): one launch a focal SNP a tile;
- the interaction: the products rotated, (tile o g_a) U' = tile (g_a o U')
  (one more GEMM, g_a on the tile's side: no (n, n) matrix stored a focal
  SNP), then the pairwise Gram-Schmidt in the whitened basis of g_a's null.
  That is GxE's interaction test with g_a in the place of the environment:
  models/gxe.py::_gxe_stats_whitened (its inter_f and mask_inter).

x U' and x U differ by a vector that whitening puts in col(Q0_a), and so
do (x o g_a) U' and (x o g_a) U: the statistics are those of the JAX
package in exact arithmetic, while no 1/sqrt(delta)-weighted coordinate of
a K singular along X0 reaches float32 sums. The degenerate rows are masked
from the dosages (models/gxe.py::_sample_space_keep with e = g_a): x inside
col([X0, g_a]) (the focal SNP itself: its cond_p is 1), x o g_a inside
col([X0, g_a, x]).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["emmax_two_snps"]


def _focal_set(focal_idx, from_result, top_k: int, M: int) -> np.ndarray:
    """The focal SNP rows: focal_idx, or the top_k smallest p-values of
    from_result (a p array, a dict with 'ps', or a results.Result scored as
    'pvals' or 'neg_log_pvals'), with the JAX package's refusals."""
    if focal_idx is None:
        if from_result is None:
            raise ValueError(
                "emmax_two_snps needs an explicit focal set: pass "
                "focal_idx=[...] (SNP row indices) or "
                "from_result=<prior scan> to use its top_k hits")
        ps = from_result
        if isinstance(ps, dict):
            ps = ps["ps"]
        elif hasattr(ps, "scores"):  # results.Result
            if ps.score_type == "pvals":
                ps = ps.scores
            elif ps.score_type == "neg_log_pvals":
                ps = np.power(10.0, -np.asarray(ps.scores))
            else:
                raise ValueError(
                    f"from_result Result has score_type "
                    f"{ps.score_type!r}; cannot rank hits — pass "
                    "p-values (score_type 'pvals'/'neg_log_pvals') or "
                    "an explicit focal_idx")
        ps = np.asarray(ps, dtype=np.float64).ravel()
        if ps.shape[0] != M:
            raise ValueError(
                f"from_result has {ps.shape[0]} p-values but G has {M} "
                "SNPs — the prior scan must cover the same SNP set")
        focal_idx = np.argsort(ps, kind="stable")[:min(top_k, M)]
    focal_idx = np.asarray(list(focal_idx), dtype=np.int64)
    if focal_idx.size == 0:
        raise ValueError("focal_idx is empty")
    if focal_idx.min() < 0 or focal_idx.max() >= M:
        raise ValueError(f"focal_idx out of range [0, {M})")
    return focal_idx


def emmax_two_snps(G, y, K=None, focal_idx: Optional[Sequence[int]] = None,
                   X0: Optional[np.ndarray] = None, eig_k=None,
                   ngrids: int = 100, llim: float = -10.0, ulim: float = 10.0,
                   dtype=None, tile: int = 8192,
                   refit_delta_per_focal: bool = False,
                   from_result=None, top_k: int = 32, mesh=None,
                   device=None) -> Dict[str, np.ndarray]:
    """Pairwise scan of each focal SNP against all M partners, with the
    JAX package's arguments and return dict (see the module docstring).

    G: a ResidentGenome (unpacked a tile at a time on its own device), or a
    GenotypeData or (M, n) array (int8 with -1 missing, or float dosages
    with NaN missing; mean-imputed) read a tile at a time onto `device`:
    the card by default (without one the call raises), 'cpu' on request.
    The focal set is explicit: focal_idx (SNP rows), or from_result (a
    prior scan's p array, a dict with 'ps', or a results.Result) for its
    top_k hits; neither raises. K (n, n) or eig_k = (phi, U). dtype:
    float32 on the card, float64 on the CPU by default. tile: SNP rows a
    tile.

    Returns cond_ps and inter_ps (A, M), focal_idx, the global null's delta
    and pseudo_heritability, and timings_s: seconds of the eigh and the
    nulls, the tiles' loading, the rotations (the tile's and the products'),
    the K3 conditional scans (with the sample-space masks), the pairwise
    statistics and the host p-values (device time from CUDA events on the
    card). p-values finalize in float64 on the host.

    mesh: a parallel.Mesh (make_mesh()) shards the partner SNPs by rows,
    as the JAX package's mesh= does: every rank holds the whole source and
    reads the focal rows itself; rank 0 takes the eigh, the global null
    and a null and a design a focal SNP (K or eig_k needed there only),
    one broadcast replicates them, each rank scans its rows (a
    ResidentGenome's shard, parallel/distributed.py::shard_packed_rows; a
    host source's rows at `tile`) with no communication, and the (A, 4,
    m_rank) statistics meet in one all-gather. On a 'sample' axis each
    rank is sent only its block of U''s contraction rows and rotates its
    rows' block of sample columns (a ResidentGenome read as its host rows,
    as the JAX function reads it): R and each focal SNP's product
    (tile o g_a, from the rank's blocks of both) summed over 'sample'
    (ops/scan.py::apply_rotation_psum), the masks from sums over 'sample',
    kernel K3 and the pairwise statistics on the whole rotated rows. Every
    rank returns the whole result; device: the rank's (default the
    mesh's)."""
    from mixmogam_tpu_torch.models.emma import _StageClock
    from mixmogam_tpu_torch.models.emmax import _as_design
    from mixmogam_tpu_torch.models.gxe import (_gxe_stats_whitened,
                                               _sample_space_keep,
                                               _source_tiles)
    from mixmogam_tpu_torch.ops.rotate import (SharedRotation, rotate_tile,
                                               rotation_rows,
                                               shared_rotation)
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    _default_dtype,
                                                    resident_and_device)
    from mixmogam_tpu_torch.models.source import resolve_source
    from mixmogam_tpu_torch.models.stepwise import _rot_null_from_delta
    from mixmogam_tpu_torch.models.streaming import source_rows
    from mixmogam_tpu_torch.ops.eigen import eigen_k_on
    from mixmogam_tpu_torch.ops.reml import fit_null_model
    from mixmogam_tpu_torch.ops.scan import (apply_rotation_psum,
                                             design_basis,
                                             emmax_scan_prerotated,
                                             project_design)
    from mixmogam_tpu_torch.ops.stats import f_sf_host
    from mixmogam_tpu_torch.ops.xreml import explicit_reml
    from mixmogam_tpu_torch.parallel import distributed as pd

    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    if mesh is None:
        rg, device = resident_and_device(G, device)
    else:
        mesh, device = pd.mesh_entry(mesh, G, "emmax_two_snps", device)
        rg = G if isinstance(G, ResidentGenome) else None
    if dtype is None:
        dtype = _default_dtype(device)
    G_src = None if rg is not None else resolve_source(G)
    source = rg if rg is not None else G_src
    if source.shape[1] != n:
        raise ValueError(f"y has {n} samples but G holds {source.shape[1]}")
    M = source.shape[0]
    focal_idx = _focal_set(focal_idx, from_result, top_k, M)
    X0 = _as_design(np.ones((n, 1)) if X0 is None else X0, n)
    # the focal rows, read from the source (on a mesh by every rank)
    ga64 = source_rows(source, focal_idx, torch.float64, device)   # (A, n)
    A = len(focal_idx)

    def null():
        """One eigh, the global null, and a whitened null and a design a
        focal SNP; the rotation by U' = (I - P_X0) U."""
        clock = _StageClock(device)
        eig = (eigen_k_on(np.asarray(K, np.float64), device)
               if eig_k is None and K is not None else eig_k)
        if eig is None:
            raise ValueError("need K or eig_k")
        fit = fit_null_model(y, X0, eig_k=eig, ngrids=ngrids, llim=llim,
                             ulim=ulim, device=device, dtype=torch.float64)
        phi64, U64 = fit.phi, fit.U
        X0_64 = torch.as_tensor(X0, device=device)
        y_rot = U64.T @ torch.as_tensor(y, device=device)
        X_rot = U64.T @ X0_64
        ga_rot = ga64 @ U64
        phi_dt = phi64.to(dtype)
        out = {"delta": float(fit.delta),
               "h2": float(fit.pseudo_heritability)}
        for i in range(A):
            Xa_rot = torch.cat([X_rot, ga_rot[i][:, None]], dim=1)
            delta = (explicit_reml(phi64, y_rot, Xa_rot, ngrids=ngrids,
                                   llim=llim, ulim=ulim)["delta"]
                     if refit_delta_per_focal else fit.delta)
            out.update(pd.null_fields(_rot_null_from_delta(
                phi_dt, float(delta), y_rot, Xa_rot, dtype), f"null{i}_"))
            out[f"Xa{i}"], out[f"Xap{i}"] = design_basis(
                torch.cat([X0_64, ga64[i][:, None]], dim=1), device, dtype)
        Up = project_design(U64, X0_64)[0].to(dtype)
        clock.lap("null")
        out["timings"] = clock.seconds()
        if tp is not None:
            return out, Up
        out.update(pd.fields_of(shared_rotation(Up, None, dtype), "rot_"))
        return out

    # ---- on a mesh rank 0's, replicated by one broadcast; on a 'sample'
    # axis each rank is sent only its block of U''s rows ----
    tp_mesh = tp = None
    if mesh is not None and mesh.shape[1] > 1:
        tp_mesh, tp = mesh, pd.tp_columns(n, mesh, packed=False)
        nl, U_b = pd.on_rank0_rows(null, mesh, *tp)
        rot = rotation_rows(U_b, None, dtype)
    else:
        nl = pd.on_rank0(null, mesh)
        rot = pd.from_fields(SharedRotation, nl, "rot_")
    nulls = [pd.null_from_fields(nl, f"null{i}_") for i in range(A)]
    designs = [(nl[f"Xa{i}"], nl[f"Xap{i}"]) for i in range(A)]
    ga = ga64.to(dtype)
    clock = _StageClock(device)

    # ---- the scan: each tile rotated once, then focal by focal (on a mesh
    # this rank's rows; on a 'sample' axis their block of sample columns,
    # each product summed over 'sample' and K3 on the whole rotated rows;
    # a ResidentGenome read as its host rows, as the JAX package reads it)
    if tp is None:
        part, src = pd.rank_sources(mesh, tile, device, rg, G_src)
        tiles = _source_tiles(part, src, None, dtype, device, tile)

        def rotate(X):
            return rotate_tile(X, rot)
    else:
        lo, hi = pd.rank_range(M, mesh, tile)
        tiles = pd.tp_blocks(np.asarray(source[lo:hi]), None, None, mesh,
                             device, dtype, tile, *tp[1:])
        ga = pd.block_cols(ga, *tp[1:])
        designs = [tuple(pd.block_rows(d, *tp[1:]) for d in design)
                   for design in designs]

        def rotate(X):
            return apply_rotation_psum(X, rot, None, dtype, mesh, n)
    outs = []
    clock.lap()
    for Gt in tiles:
        clock.lap("load")
        Gf = Gt.to(dtype)
        R = rotate(Gt)
        clock.lap("rotation")
        rows = []
        for null_a, g_a, design in zip(nulls, ga, designs):
            keep_b, keep_p = _sample_space_keep(Gf, g_a, *design,
                                                mesh=tp_mesh)
            cond = emmax_scan_prerotated(R, null_a, keep_b)
            clock.lap("conditional")
            P = rotate(Gf * g_a)
            clock.lap("rotation")
            st = _gxe_stats_whitened(R * null_a.sd, P * null_a.sd, null_a,
                                     keep_b, keep_p)
            rows.append(torch.stack([cond[0], cond[3], st[1], st[4]]))
            clock.lap("interaction")
        outs.append(torch.stack(rows))
    del rot
    timings = dict(nl["timings"], **clock.seconds())
    h = pd.gathered_rows(pd.row_block(outs, (A, 4), dtype, device), mesh,
                         M)                                      # (A, 4, M)
    del outs
    ts = time.perf_counter()
    dof = n - X0.shape[1] - 2
    cond_ps = np.where(h[:, 1] > 0.5, f_sf_host(h[:, 0], 1.0, dof), 1.0)
    inter_ps = np.where(h[:, 3] > 0.5, f_sf_host(h[:, 2], 1.0, dof - 1.0),
                        1.0)
    timings["p_values"] = time.perf_counter() - ts
    return {"cond_ps": cond_ps, "inter_ps": inter_ps,
            "focal_idx": focal_idx, "delta": nl["delta"],
            "pseudo_heritability": nl["h2"],
            "timings_s": timings}
