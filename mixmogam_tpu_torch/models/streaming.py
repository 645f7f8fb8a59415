"""The helpers of mixmogam_tpu/models/streaming.py that the port has:
_impute_tile, _host_float_tile, finalize_scan, _exact_rescore (its row
reader source_rows is the GxE rescore's too), and
rotate_streamed_to_device (G_rot = impute(G) @ U built on the device tile
by tile from a host source: stepwise's 'rotate once, scan many'). The
streamed scan itself (host -> device tiles with checkpoint/resume) waits
for ROADMAP slice 3."""

from __future__ import annotations

import numpy as np
import torch


def _impute_means(t_i8: torch.Tensor, dtype=torch.float32):
    """(per-SNP means (m, 1) over the observed dosages in dtype, 0 for an
    all-missing row; the missing mask; the tile in dtype) — the rule of
    _impute_tile, shared with the bf16 scan's per-row means."""
    t = t_i8.to(dtype)
    miss = t_i8 < 0
    obs = torch.where(miss, torch.zeros((), dtype=dtype,
                                        device=t.device), t)
    cnt = torch.clamp((~miss).sum(dim=1, keepdim=True), min=1)
    return obs.sum(dim=1, keepdim=True) / cnt, miss, t


def _impute_tile(t_i8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """int8 tile (m, n) with -1 missing -> float (dtype), per-SNP mean
    imputed on the tensor's device (oracle.kinship.mean_impute's rule)."""
    mu, miss, t = _impute_means(t_i8, dtype)
    return torch.where(miss, mu, t)


def _host_float_tile(chunk: np.ndarray, dtype) -> np.ndarray:
    """Float-source tile: NaN = missing, per-SNP mean imputed on the host.
    np.array COPY: imputing a view in place would overwrite the caller's
    NaNs."""
    C = np.array(chunk, dtype=np.float64)
    miss = np.isnan(C)
    if miss.any():
        mu = np.nanmean(C, axis=1)
        mu = np.where(np.isnan(mu), 0.0, mu)
        idx = np.where(miss)
        C[idx] = mu[idx[0]]
    return C.astype(dtype)


def host_tiles(G_src, dtype, device, tile: int = 16_384):
    """Float tiles (m, n) in dtype on device over the rows of a host
    source, in order: an int8 source (-1 missing) goes up as int8 and is
    mean-imputed on the device (_impute_tile); a float source (NaN
    missing, fractional dosages) is imputed per tile on the host."""
    int8_source = np.dtype(getattr(G_src, "dtype", np.int8)) == np.int8
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    for s in range(0, G_src.shape[0], tile):
        if int8_source:
            t = torch.from_numpy(np.ascontiguousarray(
                np.asarray(G_src[s:s + tile], dtype=np.int8))).to(device)
            yield _impute_tile(t, dtype)
        else:
            yield torch.from_numpy(_host_float_tile(
                G_src[s:s + tile], np_dt)).to(device)


def rotate_tiles(tiles, M: int, n: int, U, dtype, device, design=None):
    """(G_rot, keep): G_rot (M, n) in dtype on device, the float tiles
    (which cover the M rows in order) times U, a full-fp32 GEMM on the card
    (TF32 off), or the tiles themselves for U=None (the identity K); one
    preallocated output, so the device holds G_rot and one tile. design:
    the (X0, X0p) of a projected U (ops/scan.py::project_design): keep is
    then outside_design of every row, from the same tiles; else None."""
    from mixmogam_tpu_torch.ops import assert_fp32_matmuls
    from mixmogam_tpu_torch.ops.scan import outside_design

    out = torch.empty((M, n), dtype=dtype, device=device)
    keep = (None if design is None
            else torch.empty(M, dtype=torch.bool, device=device))
    if U is not None:
        U = U.to(device=device, dtype=dtype)
        assert_fp32_matmuls()
    s = 0
    for t in tiles:
        e = s + t.shape[0]
        out[s:e] = t if U is None else t @ U
        if keep is not None:
            keep[s:e] = outside_design(t, *design)
        s = e
    if s != M:
        raise ValueError(f"the tiles held {s} rows, not {M}")
    return out, keep


def rotate_streamed_to_device(G_src, U, dtype=None, tile: int = 16_384,
                              design=None, device=None):
    """(G_rot, keep) = rotate_tiles over host_tiles(G_src): the rotated
    genotype matrix of a host source built on the device (U's, else
    `device`: the card unless asked for the CPU). G_src: (M, n) sliceable,
    int8 (-1 missing) or float (NaN missing, fractional dosages)."""
    from mixmogam_tpu_torch.models.resident import _default_dtype
    from mixmogam_tpu_torch.ops import resolve_device

    device = U.device if U is not None else resolve_device(device)
    if dtype is None:
        dtype = _default_dtype(device)
    M, n = G_src.shape
    return rotate_tiles(host_tiles(G_src, dtype, device, tile), M, n, U,
                        dtype, device, design)


def finalize_scan(matrix_source, null, dtype, f_stats, mask,
                  betas=None, var_perc=None, with_betas: bool = True,
                  rescore_top: int = 0, rd=None, tier_name=None,
                  dof: int = 0, rescore_cut_M=None):
    """p-value finalize + threshold-complete exact rescore + output dict,
    shared by the in-core and resident paths. f_stats/mask (and betas/
    var_perc when given) are float64/bool host arrays, patched in place by
    the rescore pass, which engages only on an int8 or bf16 tier (rd set).
    rescore_cut_M: the study's SNP count for the rescore cut when these
    rows are part of it (LOCO); default the row count."""
    from mixmogam_tpu_torch.ops.scan import (select_rescore_idx,
                                             tier_drift_name)
    from mixmogam_tpu_torch.ops.stats import f_sf_host as _fsf

    dof = int(dof)
    ps = np.where(mask, _fsf(f_stats, 1.0, dof), 1.0)
    rescored = np.zeros(0, dtype=np.int64)
    if rescore_top and rd is not None:
        idx = select_rescore_idx(ps, rescore_top, tier_drift_name(rd),
                                 M_cut=rescore_cut_M)
        idx, d_ex = _exact_rescore(matrix_source, idx, null, dtype)
        f_stats[idx] = d_ex["f_stats"]
        mask[idx] = d_ex["mask"]
        ps[idx] = np.where(mask[idx], _fsf(f_stats[idx], 1.0, dof), 1.0)
        if betas is not None:
            betas[idx] = d_ex["betas"]
            var_perc[idx] = d_ex["var_perc"]
        rescored = idx
    out = {
        "ps": ps, "f_stats": f_stats, "mask": mask,
        "rescored_idx": rescored,
        "pseudo_heritability": float(null.pseudo_heritability),
        "delta": float(null.delta), "sigma_g2": float(null.sigma_g2),
        "sigma_e2": float(null.sigma_e2), "dof": dof,
        "ll_null": float(null.ll),
        "precision_tier": (tier_name if tier_name is not None
                           else (rd or "exact")),
    }
    if with_betas and betas is not None:
        out["betas"] = betas
        out["var_perc"] = var_perc
    return out


def source_rows(matrix_source, idx, dtype, device) -> torch.Tensor:
    """Rows idx of a host source (a ResidentGenome answers from its host
    copy of the packed rows), mean-imputed, in dtype on device: the exact
    rescores' input."""
    rows = np.asarray(matrix_source[idx])
    if rows.dtype == np.int8:
        return _impute_tile(torch.as_tensor(rows, device=device), dtype)
    return torch.as_tensor(_host_float_tile(rows, np.float64),
                           device=device).to(dtype)


def _exact_rescore(matrix_source, idx, null, dtype, tile: int = 16_384):
    """Re-test SNP rows `idx` at the exact tier. Rows come from the host
    source (a ResidentGenome answers from its host copy of the packed
    rows, never by a read-back from the card), strictly increasing and
    unique; the scan runs on the null model's device, tile by tile."""
    from mixmogam_tpu_torch.ops.scan import (build_rotated_null,
                                             emmax_scan_stats, stats_dict)

    idx = np.unique(np.asarray(idx, dtype=np.int64))
    rot_ex = build_rotated_null(null)       # exact tier, same delta
    dev = null.U.device
    outs = []
    for s in range(0, len(idx), tile):
        rows_d = source_rows(matrix_source, idx[s:s + tile], dtype, dev)
        outs.append(stats_dict(emmax_scan_stats(rows_d, rot_ex)))
    if not outs:
        return idx, {"f_stats": np.zeros(0), "betas": np.zeros(0),
                     "var_perc": np.zeros(0),
                     "mask": np.zeros(0, dtype=bool)}
    return idx, {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
