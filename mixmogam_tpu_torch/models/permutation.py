"""Permutation tests for empirical significance thresholds (counterpart of
mixmogam_tpu/models/permutation.py: _perm_tile_max_f, _perm_scan_packed,
emmax_perm_test; reference: linear_models.emmax_perm_test).

The null model's variance components are fit ONCE on the unpermuted
phenotype (float64 REML); each of the P permutations shuffles the
phenotype, is whitened by the same H^(-1/2) and rescanned. The P
permutations are drawn on the host by np.random.default_rng(seed), as the
JAX package draws them, so both packages permute identically. Their
whitened residuals Y_res (P, n) are formed in float64 and cast to the
scan's dtype. Per tile, the P F-statistic columns come from ONE
(m, n) x (n, P) product; only each permutation's max F over SNPs survives.

The tiles are rotated by W = U' * sd with U' = (I - P_X0) U
(ops/scan.py::project_design), not by U * sd as in the JAX package: x U'
and x U differ by a vector that whitening puts in col(Q0), so xx and xy are
the same in exact arithmetic. Where K is singular along X0 and delta small
(VanRaden's K along the intercept) the unprojected rows carry a
1/sqrt(delta)-weighted coordinate that float32 loses xx to. The rows inside
col(X0) (a monomorphic SNP) reach the scan as rounding noise after the
projection: they are masked from the dosages (ops/scan.py::outside_design).
With the identity K (no K, no eig_k: the linear-model permutation test)
U' is I - P_X0, applied as its rank-q form.

The rotation is an XLA dot in the JAX package, outside any Pallas kernel;
here it is a library product by tier (ops/rotate.py::rotate_tile),
and so is the P-column product (a float32 GEMM with TF32 off). The max-F
epilogue is plain torch, as the JAX package fuses it in XLA.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["emmax_perm_test"]


def _perm_tile_max_f(Xs: torch.Tensor, Q0: torch.Tensor, Y_res, rss0,
                     dof: float, running_max: torch.Tensor,
                     keep: torch.Tensor, lap) -> torch.Tensor:
    """running_max (P,) updated with the max F over the whitened rows Xs
    (m, n) of each permutation's residual Y_res (P, n) (rss0 (P,)). keep:
    (m,) bool of outside_design; the other rows count as masked (F = 0).
    lap: the stage clock's lap, called after the P-column product and after
    the epilogue."""
    dt = Xs.dtype
    fi = torch.finfo(dt)
    xy = Xs @ Y_res.T                              # (m, P)
    lap("product")
    c = Xs @ Q0
    ss = (Xs * Xs).sum(dim=1)
    xx = ss - (c * c).sum(dim=1)
    mask = keep & (xx > 100.0 * fi.eps * torch.clamp(ss, min=fi.tiny))
    xx_safe = torch.where(mask, xx, 1.0)
    expl = torch.where(mask[:, None],
                       torch.minimum(xy * xy / xx_safe[:, None],
                                     rss0[None, :]), 0.0)
    rss1 = torch.clamp(rss0[None, :] - expl, min=fi.tiny)
    f = expl * dof / rss1
    out = torch.maximum(running_max, f.amax(dim=0))
    lap("epilogue")
    return out


def emmax_perm_test(G, y, K=None, num_perm: int = 100,
                    X0: Optional[np.ndarray] = None, seed: int = 0,
                    alpha: float = 0.05, dtype=None, tile: int = 4096,
                    eig_k=None, precision: Optional[str] = None,
                    mesh=None, device=None) -> Dict[str, np.ndarray]:
    """The empirical min-p distribution of num_perm permutations and its
    alpha-quantile genome-wide threshold, with the JAX package's arguments
    and return dict.

    G: a ResidentGenome (unpacked a tile at a time on its own device,
    mean-imputed where it has missing calls), or a GenotypeData or (M, n)
    array (int8 with -1 missing, or float dosages with NaN missing) read a
    tile at a time onto `device`: the card by default (without one the call
    raises), 'cpu' on request. K (n, n) or eig_k = (phi, U); neither: the
    identity K. dtype: float32 on the card, float64 on the CPU by default.
    tile: SNP rows a tile. precision (a ResidentGenome only; a host source
    runs exact and takes only 'exact' / 'auto'): 'exact', 'int8x2' /
    'int8x3' / 'int8x4' (fully observed dosages only), 'bf16' / 'bf16x2' /
    'bf16x3', 'auto' and 'fast' (ops/scan.py::resolve_precision: on the
    card int8x3 / int8x2 for a fully observed container, exact / bf16 for
    one with missing calls; on the CPU both exact) or 'high' (the split of
    U'·sd and of each tile in three bf16 passes, ops/rotate.py::
    rotate_high), for the rotation.

    mesh: a parallel.Mesh (make_mesh()) shards the sweep by SNP rows, as
    the JAX package's mesh= does: rank 0 fits the null, draws the
    permutations and builds the permuted residuals and the rotation (K or
    eig_k needed there only), one broadcast replicates them, each rank
    sweeps its rows (a ResidentGenome's shard, parallel/distributed.py::
    shard_packed_rows; a host source's rows at `tile`) with no
    communication, and the (P,) max F meet in ONE max all-reduce (the
    JAX package's pmax: order-free, so equal to one device's; a rank with
    no rows adds zeros). On a 'sample' axis (in core; a ResidentGenome
    raises the JAX package's ValueError) each rank is sent only its block
    of W's contraction rows, a tile's block of sample columns is rotated
    and summed over 'sample' (ops/scan.py::apply_rotation_psum), its mask
    from sums over 'sample' (outside_design_psum), and the max-F epilogue
    runs on the whole rows; the identity K has no W and replicates. Every
    rank returns the whole result; device: the rank's (default the
    mesh's).

    Returns min_ps (sorted), threshold, alpha, num_perm, delta, and
    timings_s: seconds of the null (eigh, REML, the permuted residuals and
    the rotation's operand), the tiles' loading, the rotations, the
    P-column products, the max-F epilogue and the p-values (device time
    from CUDA events on the card)."""
    import torch.distributed as dist

    from mixmogam_tpu_torch.models.emma import _StageClock
    from mixmogam_tpu_torch.models.emmax import _as_design
    from mixmogam_tpu_torch.models.gxe import _source_tiles
    from mixmogam_tpu_torch.ops.rotate import (SharedRotation, rotate_tile,
                                               rotation_rows,
                                               shared_rotation)
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    _default_dtype,
                                                    resident_and_device)
    from mixmogam_tpu_torch.models.source import resolve_source
    from mixmogam_tpu_torch.ops.eigen import orthonormal_basis
    from mixmogam_tpu_torch.ops.reml import fit_null_model
    from mixmogam_tpu_torch.ops.scan import (apply_rotation_psum,
                                             design_basis,
                                             normalize_rotate_tier,
                                             outside_design,
                                             outside_design_psum,
                                             probe_for_source, project_design,
                                             resolve_precision)
    from mixmogam_tpu_torch.ops.stats import f_sf_host
    from mixmogam_tpu_torch.parallel import distributed as pd
    from mixmogam_tpu_torch.parallel.mesh import all_reduce

    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    if mesh is None:
        rg, device = resident_and_device(G, device)
    else:
        mesh, device = pd.mesh_entry(mesh, G, "emmax_perm_test", device)
        rg = G if isinstance(G, ResidentGenome) else None
    if dtype is None:
        dtype = _default_dtype(device)
    if rg is not None and rg.n != n:
        raise ValueError(f"y has {n} samples but the resident genome "
                         f"holds {rg.n}")
    X0 = _as_design(np.ones((n, 1)) if X0 is None else X0, n)
    q = X0.shape[1]
    # ---- the tier: a ResidentGenome takes one, a host source runs exact --
    rd = None
    if rg is not None:
        if precision is not None:
            rd = normalize_rotate_tier(resolve_precision(
                precision, G=probe_for_source(rg), device=device)[0])
            if rd is not None and rd.startswith("int8") and rg.has_missing:
                raise ValueError(
                    "int8 digit-plane tiers need fully-observed dosages; "
                    "use precision='exact'/'bf16'")
    elif precision is not None and str(precision) not in ("exact", "auto"):
        raise ValueError(
            f"precision={precision!r}: tiered permutation sweeps need a "
            "ResidentGenome source (the host-tile path runs exact; "
            "'exact'/'auto' are accepted as no-ops)")
    G_src = None if rg is not None else resolve_source(G)
    dof = n - q - 1

    def null():
        """One float64 REML, the permuted residuals in float64 and, for a
        kinship, the rotation W = U' * sd at the tier (whitened on the
        weight side as the JAX package's W). Neither K nor eig_k: the
        identity K (on a mesh, as rank 0 is given them)."""
        identity_k = K is None and eig_k is None
        X0_64 = torch.as_tensor(X0, device=device)
        if identity_k:
            sd64 = torch.ones(n, dtype=torch.float64, device=device)
            delta = 1.0
            X0_star = X0_64
        else:
            fit = fit_null_model(y, X0, K=K, eig_k=eig_k, device=device,
                                 dtype=torch.float64)
            delta = float(fit.delta)
            sd64 = 1.0 / torch.sqrt(fit.phi + fit.delta)
            U64 = fit.U
            X0_star = (U64.T @ X0_64) * sd64[:, None]
        rng = np.random.default_rng(seed)
        perms = np.stack([rng.permutation(n) for _ in range(num_perm)])
        Yp = torch.as_tensor(y[perms], device=device)         # (P, n)
        Ys = (Yp if identity_k else Yp @ U64) * sd64[None, :]
        Q0_64 = orthonormal_basis(X0_star)
        Y_res64 = Ys - (Ys @ Q0_64) @ Q0_64.T
        X0d, X0p = design_basis(X0_64, device, dtype)
        out = {"identity_k": identity_k, "delta": delta,
               "Q0": Q0_64.to(dtype),
               "Y_res": Y_res64.to(dtype),
               "rss0": (Y_res64 * Y_res64).sum(dim=1).to(dtype),
               "X0d": X0d, "X0p": X0p}
        W = (None if identity_k
             else project_design(U64, X0_64)[0] * sd64[None, :])
        if tp is not None:
            # the exact tier (a host source's): W's contraction rows are
            # scattered, none for the identity K
            return out, [] if W is None else [W.to(dtype)]
        if W is not None:
            out.update(pd.fields_of(shared_rotation(W, rd, dtype), "rot_"))
        return out

    # ---- the null: on a mesh rank 0's, replicated by one broadcast; on a
    # 'sample' axis each rank is sent only its block of W's rows ----
    clock = _StageClock(device)
    tp = None
    if mesh is not None and mesh.shape[1] > 1:
        tp = pd.tp_columns(n, mesh, packed=False)
        nl, W_b = pd.on_rank0_rows(null, mesh, *tp)
    else:
        nl = pd.on_rank0(null, mesh)
    Q0, Y_res, rss0, X0d, X0p = (nl[k] for k in ("Q0", "Y_res", "rss0",
                                                 "X0d", "X0p"))
    identity_k = nl["identity_k"]
    # the identity K has no W to shard: its sweep replicates over 'sample'
    tp = None if identity_k else tp
    if tp is not None:
        rot = rotation_rows(W_b[0], None, dtype)
        X0d, X0p = (pd.block_rows(X, *tp[1:]) for X in (X0d, X0p))
    elif not identity_k:
        rot = pd.from_fields(SharedRotation, nl, "rot_")
    clock.lap("null")

    # ---- the sweep, a tile at a time (on a mesh: this rank's rows; on a
    # 'sample' axis their block of sample columns, rotated by the block of
    # W and summed over 'sample', the mask from sums over 'sample') ----
    part, src = pd.rank_sources(mesh, tile, device, rg, G_src)
    tiles = (_source_tiles(part, src, None, dtype, device, tile)
             if tp is None else
             pd.tp_blocks(np.asarray(src), None, None, mesh, device, dtype,
                          tile, *tp[1:]))
    max_f = torch.zeros(num_perm, dtype=dtype, device=device)
    clock.lap()
    for Gt in tiles:
        clock.lap("load")
        Gf = Gt.to(dtype)
        if tp is not None:
            keep = outside_design_psum(Gf, X0d, X0p, mesh)
            Xs = apply_rotation_psum(Gt, rot, None, dtype, mesh, n)
        else:
            keep = outside_design(Gf, X0d, X0p)
            Xs = (Gf - (Gf @ X0p) @ X0d.T if identity_k
                  else rotate_tile(Gt, rot))
        clock.lap("rotation")
        max_f = _perm_tile_max_f(Xs, Q0, Y_res, rss0, float(dof), max_f,
                                 keep, clock.lap)
    if mesh is not None:
        max_f = all_reduce(max_f, mesh, dist.ReduceOp.MAX)
    timings = clock.seconds()
    ts = time.perf_counter()
    min_ps = f_sf_host(max_f.cpu().double().numpy(), 1.0, dof)
    thr = float(np.quantile(min_ps, alpha))
    timings["p_values"] = time.perf_counter() - ts
    return {"min_ps": np.sort(min_ps), "threshold": thr, "alpha": alpha,
            "num_perm": num_perm, "delta": nl["delta"], "timings_s": timings}
