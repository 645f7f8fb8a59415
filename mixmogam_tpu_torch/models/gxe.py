"""Gene-environment (GxE) interaction scan (counterpart of
mixmogam_tpu/models/gxe.py: _gxe_stats_whitened, _gxe_envs_incore,
_gxe_scan_packed, emmax_gxe).

Model per SNP x, with an environment e (a per-sample covariate forced into
the null): y = X0 b + e c + x b_x + (x * e) b_xe + u + eps. Per SNP, with
delta fitted once per environment on the null [X0, e] (EMMAX):
  marginal_ps  x tested on [X0, e]                 (1 dof)
  inter_ps     x * e tested on [X0, e, x]          (1 dof: the GxE test)
  joint_ps     {x, x * e} tested on [X0, e]        (2 dof)

Each tile is rotated E + 1 times: once for the genotypes, R = G U', shared
by every environment (B_e = R * sd_e), and once a environment for the
products, G (e o U') = (G o e) U' (the environment folded into the weight
side). The statistics are then elementwise Gram-Schmidt in the whitened
basis of each environment's own null Q0_e of [X0, e].

The rotation is U' = (I - P_X0) U (ops/scan.py::project_design, on the
shared X0), not U as in the JAX package. x U' and x U differ by a vector
in span(U' X0) whitened, which lies in col(Q0_e) for every environment, and
so do (x o e) U' and (x o e) U: the statistics are the same in exact
arithmetic. Where K is singular along X0 and delta small (VanRaden's K
along the intercept) the unprojected rows carry a 1/sqrt(delta)-weighted
coordinate that the float32 Gram-Schmidt would cancel. A row inside col(X0)
(a monomorphic SNP) then reaches the statistics as rounding noise, which
their relative masks would pass: the degenerate rows (x inside
col([X0, e]), x o e inside col([X0, e, x])) are masked from their
unrotated values (_sample_space_keep, the rule of ops/scan.py::
outside_design), as models/emmax.py::_anova_pair_f masks its indicators.

The rotations are the JAX package's XLA dots, not Pallas kernels; here they
are library products by tier (ops/rotate.py::rotate_tile): a
float32 GEMM with TF32 off ('exact'), int8 digit-plane products with int32
sums ('int8xK'), bf16 parts with float32 outputs ('bf16', 'bf16xK'). The
statistics are plain torch.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

__all__ = ["emmax_gxe"]

#: rows of one rescore dispatch, as in the JAX package
_RESCORE_ROWS = 8192


def _scan_rows(E: int) -> int:
    """Rows a tile of the scan for E environments (the JAX package's
    _sub_tile target): the (E + 1) rotated (rows, n) blocks of a tile stay
    near 16,384 rows' worth."""
    return max(2048, 16_384 // E)


def _gxe_stats_whitened(B: torch.Tensor, P: torch.Tensor, rot,
                        keep_b: Optional[torch.Tensor] = None,
                        keep_p: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(5, m) rows [marginal_f, inter_f, joint_f, mask, mask_inter] (the
    masks as 0/1) of whitened SNP rows B and product rows P (m, n), for one
    environment's null `rot` (a RotatedNull: its orthonormal Q0 of the
    whitened [X0, e], y_res, rss0 and dof = n - q - 1, the marginal test's
    denominator dof; the pair model has dof - 1). keep_b / keep_p: the
    sample-space masks of _sample_space_keep; the rows outside them come
    out masked."""
    dt = B.dtype
    fi = torch.finfo(dt)
    eps, tiny = 100.0 * fi.eps, fi.tiny
    Q0, y_res, rss0, dof = rot.Q0, rot.y_res, rot.rss0, rot.dof
    Br = B - (B @ Q0) @ Q0.T
    Pr = P - (P @ Q0) @ Q0.T
    bb = (Br * Br).sum(dim=1)
    mask_b = bb > eps * torch.clamp((B * B).sum(dim=1), min=tiny)
    if keep_b is not None:
        mask_b &= keep_b
    bb_safe = torch.where(mask_b, bb, 1.0)
    by = Br @ y_res
    expl_b = by * by / bb_safe                    # variance explained by x
    rss_b = torch.clamp(rss0 - expl_b, min=tiny)
    f_marg = expl_b / (rss_b / dof)
    # the product residualized against the SNP direction
    pb = (Pr * Br).sum(dim=1) / bb_safe
    Pr2 = Pr - pb[:, None] * Br
    pp = (Pr2 * Pr2).sum(dim=1)
    mask_p = mask_b & (pp > eps * torch.clamp((P * P).sum(dim=1), min=tiny))
    if keep_p is not None:
        mask_p &= keep_p
    pp_safe = torch.where(mask_p, pp, 1.0)
    py = Pr2 @ y_res
    expl_p = py * py / pp_safe                    # explained by x * e | x
    dof_pair = dof - 1.0
    rss_pair = torch.clamp(rss_b - expl_p, min=tiny)
    f_inter = expl_p / (rss_pair / dof_pair)
    # the joint test's numerator rss0 - rss_pair, which is expl_b + expl_p
    # where neither floor binds and rss0 (up to tiny) where one does: the
    # difference of the two RSS would keep float32 rounding of rss0 itself
    f_joint = (torch.minimum(expl_b + expl_p, rss0) / 2.0) / (
        rss_pair / dof_pair)
    return torch.stack([torch.where(mask_b, f_marg, 0.0),
                        torch.where(mask_p, f_inter, 0.0),
                        torch.where(mask_p, f_joint, 0.0),
                        mask_b.to(dt), mask_p.to(dt)])


def _finalize(fm, fi, fj, mb, mp, dof: int):
    """Float64 host p-values (marginal, interaction, joint); 1 off mask."""
    from mixmogam_tpu_torch.ops.stats import f_sf_host

    return (np.where(mb, f_sf_host(fm, 1.0, dof), 1.0),
            np.where(mp, f_sf_host(fi, 1.0, dof - 1.0), 1.0),
            np.where(mp, f_sf_host(fj, 2.0, dof - 1.0), 1.0))


def _sample_space_keep(Gf: torch.Tensor, e: torch.Tensor, Xe: torch.Tensor,
                       Xep: torch.Tensor, mesh=None):
    """(keep_b, keep_p), (m,) bool each, from the unrotated rows Gf (m, n)
    in the scan's dtype: x keeps a part outside col([X0, e]), and x o e a
    part outside col([X0, e, x]), each more than eps (the dtype's) times
    its squared norm, in sample space (ops/scan.py::outside_design's rule;
    Xe = [X0, e] and Xep = Xe (Xe' Xe)^-1, ops/scan.py::design_basis).

    The whitening is invertible, so these are the degeneracies the
    whitened masks of _gxe_stats_whitened test for; from the dosages they
    hold at every tier. A monomorphic SNP lies in col(X0); a SNP whose
    carriers share one environment value (a singleton, or x == e for a 0/1
    environment) has x o e collinear with [x, e]. After the projected
    rotation such rows are rounding noise of the rotation's own tier, which
    the whitened relative masks would let through.

    mesh: on a 'sample' axis, Gf, e, Xe and Xep are the rank's block of
    sample columns (zero past n) and every sum over samples is summed over
    'sample' (three small all-reduces, as ops/scan.py::outside_design_psum
    mirrors outside_design): every rank of the group gets the masks of the
    whole rows."""
    from mixmogam_tpu_torch.parallel.mesh import all_reduce

    def psum(t):
        return t if mesh is None else all_reduce(t, mesh, axis="sample")

    fi = torch.finfo(Gf.dtype)
    P = Gf * e
    GX, PX = psum(torch.stack([Gf @ Xep, P @ Xep]))
    xr = Gf - GX @ Xe.T
    pr = P - PX @ Xe.T
    xx, gg, px, PP = psum(torch.stack([(xr * xr).sum(dim=1),
                                       (Gf * Gf).sum(dim=1),
                                       (pr * xr).sum(dim=1),
                                       (P * P).sum(dim=1)]))
    keep_b = xx > fi.eps * torch.clamp(gg, min=fi.tiny)
    c = px / torch.where(keep_b, xx, 1.0)
    pr = pr - c[:, None] * xr
    keep_p = keep_b & (psum((pr * pr).sum(dim=1))
                       > fi.eps * torch.clamp(PP, min=fi.tiny))
    return keep_b, keep_p


def _tile_stats(Gt: torch.Tensor, rot_g, rot_e, nulls, env_dt, designs,
                lap, mesh=None) -> torch.Tensor:
    """(len(nulls), 5, m) statistics of one tile Gt (int8 dosages, or
    mean-imputed rows in the scan's dtype): the shared rotation rot_g and
    each environment's product rotation rot_e[i] (ops/rotate.py::
    SharedRotation), then _gxe_stats_whitened with the environment's null
    nulls[i] and the masks of _sample_space_keep. env_dt: (E, n)
    environments in the scan's dtype; designs: each environment's
    ([X0, e], its pseudo-inverse transposed). lap: the stage clock's lap,
    called after the rotations ('rotation') and the statistics. mesh: on a
    'sample' axis Gt, env_dt and designs are the rank's block of sample
    columns, the rotations its block of contraction rows
    (ops/rotate.py::rotation_rows): each product is summed over 'sample'
    (ops/scan.py::apply_rotation_psum) and so are the masks' sums; the
    statistics run on the whole rotated rows."""
    from mixmogam_tpu_torch.ops.rotate import rotate_tile
    from mixmogam_tpu_torch.ops.scan import apply_rotation_psum

    def rotate(r):
        if mesh is None:
            return rotate_tile(Gt, r)
        return apply_rotation_psum(Gt, r, r.w_scale, r.dt, mesh,
                                   nulls[0].sd.shape[0])

    Gf = Gt.to(env_dt.dtype)
    R = rotate(rot_g)
    Ps = [rotate(r) for r in rot_e]
    lap("rotation")
    out = []
    for P, null, e, design in zip(Ps, nulls, env_dt, designs):
        keep_b, keep_p = _sample_space_keep(Gf, e, *design, mesh=mesh)
        out.append(_gxe_stats_whitened(R * null.sd, P * null.sd, null,
                                       keep_b, keep_p))
    lap("statistics")
    return torch.stack(out)


def _source_tiles(rg, G_src, G8, dtype, device, rows: int):
    """Tiles over the genome's real rows in order. A ResidentGenome
    is unpacked on its device (mean-imputed where it has missing
    genotypes); a host source goes up a tile at a time: int8 for the int8
    tiers (G8, fully observed), else float tiles in dtype
    (models/streaming.py::host_tiles)."""
    from mixmogam_tpu_torch.models.resident import subdivide_tile
    from mixmogam_tpu_torch.models.streaming import _impute_tile, host_tiles
    from mixmogam_tpu_torch.ops.pack2 import unpack_2bit_device

    if rg is not None:
        step = subdivide_tile(rg.tile, rows)
        for s in range(0, rg.M, step):
            Gt = unpack_2bit_device(rg.packed[s:min(s + step, rg.M)], rg.n)
            yield _impute_tile(Gt, dtype) if rg.has_missing else Gt
    elif G8 is not None:
        for s in range(0, G8.shape[0], rows):
            yield torch.from_numpy(np.ascontiguousarray(
                G8[s:s + rows])).to(device)
    else:
        yield from host_tiles(G_src, dtype, device, rows)


def _tp_rotations(nl, blocks, env: np.ndarray, tp, rd, rescore: bool,
                  dtype, device):
    """rotations(pre) of emmax_gxe on a 'sample' axis: (rot_g, [rot_e])
    at the scan's tier ('') or the rescore's exact tier ('ex_'), each
    ops/rotate.py::rotation_rows of the rank's block of contraction rows
    (blocks, in the order null() lists its operands). The exact tier's
    come from the one float64 block of U': U' rounded to dtype, and
    (e o U') from the block of e times it, rounded once, as one device's
    shared_rotation rounds the whole."""
    from mixmogam_tpu_torch.ops.rotate import rotation_rows
    from mixmogam_tpu_torch.parallel.distributed import block_rows

    E = env.shape[1]
    _, lo, hi = tp
    env_b = block_rows(torch.as_tensor(env, dtype=torch.float64,
                                       device=device), lo, hi)
    fast = [] if rd is None else blocks[:E + 1]
    Up_b = blocks[-1] if rd is None or rescore else None

    def rotations(pre):
        if pre == "" and rd is not None:
            rots = [rotation_rows(W, nl[f"scale{i}"], dtype, rd)
                    for i, W in enumerate(fast)]
        else:
            rots = [rotation_rows(W, None, dtype) for W in
                    [Up_b] + [env_b[:, e:e + 1] * Up_b for e in range(E)]]
        return rots[0], rots[1:]

    return rotations


def emmax_gxe(G, y, env, K=None, X0: Optional[np.ndarray] = None,
              eig_k=None, ngrids: int = 100, llim: float = -10.0,
              ulim: float = 10.0, dtype=None,
              precision: Optional[str] = None, rescore_top: int = 0,
              mesh=None, device=None) -> Dict[str, np.ndarray]:
    """GxE interaction scan with the JAX package's arguments and return
    dict (see the module docstring).

    G: a ResidentGenome (scanned on its own device, tile by tile), or a
    GenotypeData or (M, n) array (int8 with -1 missing, or float dosages
    with NaN missing) read a tile at a time onto `device`: the card by
    default (without one the call raises), 'cpu' on request. env: (n,)
    per-sample environment (continuous or 0/1), or (n, E) for E
    environments sharing one genotype rotation; each is appended to the
    null design. K (n, n) or eig_k = (phi, U). dtype: float32 on the card,
    float64 on the CPU by default. precision: None / 'exact', 'int8x2' /
    'int8x3' / 'int8x4' (fully observed integer dosages only), 'bf16' /
    'bf16x2' / 'bf16x3', 'high' (each rotation's operand and each tile
    split for three bf16 passes, ops/rotate.py::rotate_high), 'auto' and
    'fast' (ops/scan.py::resolve_precision: on the CPU both exact; 'fast'
    sets rescore_top = 1024), for both rotations. rescore_top: re-test that many leading interaction hits per
    environment (and every one under the tier's p cut, ops/scan.py::
    select_rescore_idx with GxE's own drift, GXE_P_DRIFT) at the exact
    tier.

    Returns marginal_ps, inter_ps, joint_ps, f_inter, mask, mask_inter
    ((M,), or (E, M) for (n, E) input), deltas and pseudo_heritabilities
    ((E,); delta and pseudo_heritability for (n,) input), precision_tier,
    rescored_idx, and timings_s (seconds of the eigh, the nulls, the tiles'
    loading, the rotations, the statistics, the p-values and the rescore;
    device time from CUDA events on the card). p-values finalize in float64
    on the host.

    mesh: a parallel.Mesh (make_mesh()) shards the scan by SNP rows, as the
    JAX package's mesh= does: rank 0 takes the eigh, the E fits and nulls
    and the rotations (K or eig_k needed there only), one broadcast
    replicates them, each rank scans its rows tile by tile at the
    single-device tile (a ResidentGenome's shard, parallel/distributed.py::
    shard_packed_rows; a host source's rows) with no communication, and
    the (E, 5, m_rank) statistics meet in one all-gather. The exact
    rescore then runs on every rank over the whole source, with the same
    rows and values everywhere. On a 'sample' axis (in core; a
    ResidentGenome raises the JAX package's ValueError) rank 0 sends each
    rank only its block of contraction rows of each rotation (at the
    exact tier one float64 block of U', from which a rank forms its rows
    of e o U' as one device rounds them; at a fast tier each rotation's
    planes or parts, and U''s block for the rescore); a tile's block of
    sample columns is rotated, each product summed over 'sample'
    (ops/scan.py::apply_rotation_psum), the masks from sums over 'sample'
    (_sample_space_keep), the statistics on the whole rows, one
    all-gather over 'snp'; the rescore takes the same route. Every rank
    returns the whole result; device: the rank's (default the mesh's)."""
    from mixmogam_tpu_torch.models.emma import _StageClock
    from mixmogam_tpu_torch.models.emmax import _as_design
    from mixmogam_tpu_torch.ops.rotate import SharedRotation, shared_rotation
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    _default_dtype,
                                                    resident_and_device)
    from mixmogam_tpu_torch.models.source import (as_int8_dosage,
                                                  resolve_source)
    from mixmogam_tpu_torch.models.stepwise import _rot_null_from_delta
    from mixmogam_tpu_torch.models.streaming import source_rows
    from mixmogam_tpu_torch.ops.eigen import eigen_k_on
    from mixmogam_tpu_torch.ops.scan import (GXE_P_DRIFT, design_basis,
                                             normalize_rotate_tier,
                                             probe_for_source,
                                             project_design,
                                             quantize_rotation,
                                             resolve_precision,
                                             select_rescore_idx,
                                             tier_drift_name)
    from mixmogam_tpu_torch.ops.xreml import explicit_reml
    from mixmogam_tpu_torch.parallel import distributed as pd

    if mesh is not None:
        mesh, device = pd.mesh_entry(mesh, G, "emmax_gxe", device)
    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    env = np.asarray(env, dtype=np.float64)
    single = env.ndim == 1
    if single:
        env = env[:, None]
    if env.ndim != 2 or env.shape[0] != n:
        raise ValueError(f"env must be (n,) or (n, E) aligned to y's "
                         f"n={n} samples; got shape {env.shape}")
    E = env.shape[1]
    if not np.isfinite(env).all():
        raise ValueError("env contains non-finite values; GxE needs "
                         "complete environment columns (drop or impute "
                         "samples first — run_gwas's env_pid path drops)")
    if mesh is None:
        rg, device = resident_and_device(G, device)
    else:
        rg = G if isinstance(G, ResidentGenome) else None
    if dtype is None:
        dtype = _default_dtype(device)
    if rg is not None and rg.n != n:
        raise ValueError(f"y has {n} samples but the resident genome "
                         f"holds {rg.n}")
    X0 = _as_design(np.ones((n, 1)) if X0 is None else X0, n)
    for e in range(E):
        X0e = np.column_stack([X0, env[:, e]])
        if np.linalg.matrix_rank(X0e) < X0e.shape[1]:
            raise ValueError(
                f"environment column {e} is linearly dependent on the "
                "null fixed effects (constant env duplicates the "
                "intercept?) — the null design [X0, env] must have "
                "full column rank")
    # ---- the tier (the same contract as emmax) ----
    rd, tier_name = None, "exact"
    G_src = None if rg is not None else resolve_source(G)
    if precision is not None:
        rb, tier_name = resolve_precision(
            precision, G=probe_for_source(rg, G_src), device=device)
        rd = normalize_rotate_tier(rb)
    G8 = None
    if rd is not None and rd.startswith("int8"):
        if rg is not None:
            if rg.has_missing:
                raise ValueError(
                    "int8 digit-plane tiers need fully-observed dosages; "
                    "this resident genome has missing genotypes (device-"
                    "imputed to fractions). Use precision='exact'/'bf16'.")
        else:
            G8 = as_int8_dosage(G)
            if G8 is None or (np.asarray(G8) < 0).any():
                raise ValueError(
                    "int8 digit-plane tiers need exact integer dosages, "
                    "fully observed; these are fractional or missing "
                    "(mean-imputed). Use precision='exact'/'bf16'.")
    if str(precision) == "fast" and not rescore_top:
        rescore_top = 1024
    rescore = bool(rescore_top) and rd is not None

    def null():
        """One eigh, a float64 REML and a whitened null per environment;
        the rotations by U' = (I - P_X0) U, shared and e o U' an
        environment (and at the exact tier for the rescore); each
        environment's design."""
        clock = _StageClock(device)
        if eig_k is None:
            if K is None:
                raise ValueError("need K or eig_k")
            phi, U = eigen_k_on(np.asarray(K, np.float64), device)
        else:
            phi, U = eig_k
        phi64 = torch.as_tensor(phi).to(device=device, dtype=torch.float64)
        U64 = torch.as_tensor(U).to(device=device, dtype=torch.float64)
        clock.lap("eigh")
        X0_64 = torch.as_tensor(X0, device=device)
        env64 = torch.as_tensor(env, device=device)
        y_rot = U64.T @ torch.as_tensor(y, device=device)
        X_rot, e_rot = U64.T @ X0_64, U64.T @ env64
        phi_dt = phi64.to(dtype)
        out = {"deltas": np.empty(E), "h2s": np.empty(E)}
        for e in range(E):
            Xe = torch.cat([X_rot, e_rot[:, e:e + 1]], dim=1)
            fit = explicit_reml(phi64, y_rot, Xe, ngrids=ngrids, llim=llim,
                                ulim=ulim)
            out["deltas"][e] = float(fit["delta"])
            out["h2s"][e] = float(fit["pseudo_heritability"])
            out.update(pd.null_fields(_rot_null_from_delta(
                phi_dt, out["deltas"][e], y_rot, Xe, dtype), f"null{e}_"))
            out[f"Xe{e}"], out[f"Xep{e}"] = design_basis(
                torch.cat([X0_64, env64[:, e:e + 1]], dim=1), device, dtype)
        Up = project_design(U64, X0_64)[0]
        del U64
        out["env_dt"] = env64.T.to(dtype)                     # (E, n)
        tiers = ("", "ex_") if rescore else ("",)
        if tp is not None:
            # the operands whose contraction rows are scattered: at a fast
            # tier each rotation's planes (their column scale broadcast)
            # or parts; at the exact tier U' in float64, from whose block
            # and e's block a rank forms its e o U' rows as one device
            # rounds them, and rounds U' itself
            ops = []
            for pre, tier in zip(tiers, (rd, None)):
                if tier is None:
                    ops.append(Up)
                    continue
                for i, Wop in enumerate(
                        [Up] + [env64[:, e:e + 1] * Up for e in range(E)]):
                    W, out[f"{pre}scale{i}"] = quantize_rotation(
                        Wop, tier, sd_dtype=dtype)
                    ops.append(W)
            clock.lap("nulls")
            out["timings"] = clock.seconds()
            return out, ops
        for pre, tier in zip(tiers, (rd, None)):
            out.update(pd.fields_of(shared_rotation(Up, tier, dtype),
                                    pre + "rot_g_"))
            for e in range(E):
                out.update(pd.fields_of(shared_rotation(
                    env64[:, e:e + 1] * Up, tier, dtype), f"{pre}rot_e{e}_"))
        clock.lap("nulls")
        out["timings"] = clock.seconds()
        return out

    # ---- on a mesh rank 0's, replicated by one broadcast; on a 'sample'
    # axis each rank is sent only its block of each rotation's rows ----
    tp = None
    if mesh is not None and mesh.shape[1] > 1:
        tp = pd.tp_columns(n, mesh, packed=False)
        nl, blocks = pd.on_rank0_rows(null, mesh, *tp)
        rotations = _tp_rotations(nl, blocks, env, tp, rd, rescore,
                                  dtype, device)
    else:
        nl = pd.on_rank0(null, mesh)

        def rotations(pre):
            return (pd.from_fields(SharedRotation, nl, pre + "rot_g_"),
                    [pd.from_fields(SharedRotation, nl, f"{pre}rot_e{e}_")
                     for e in range(E)])

    deltas, h2s, env_dt = nl["deltas"], nl["h2s"], nl["env_dt"]
    nulls = [pd.null_from_fields(nl, f"null{e}_") for e in range(E)]
    designs = [(nl[f"Xe{e}"], nl[f"Xep{e}"]) for e in range(E)]
    tp_mesh, cut = None, (lambda t: t)
    if tp is not None:
        # the rank's block of sample columns of every per-sample operand
        tp_mesh = mesh
        cut = (lambda t: pd.block_cols(t, *tp[1:]))
        env_dt = cut(env_dt)
        designs = [tuple(pd.block_rows(d, *tp[1:]) for d in design)
                   for design in designs]
    rot_g, rot_e = rotations("")
    dof = n - X0.shape[1] - 2
    clock = _StageClock(device)

    # ---- the scan, a tile at a time (on a mesh: this rank's rows; on a
    # 'sample' axis their block of sample columns) ----
    rows = _scan_rows(E)
    part, src, src8 = pd.rank_sources(mesh, rows, device, rg, G_src, G8)
    tiles = (_source_tiles(part, src, src8, dtype, device, rows)
             if tp is None else
             pd.tp_blocks(np.asarray(src if src8 is None else src8), None,
                          None, mesh, device, dtype, rows, *tp[1:]))
    outs = []
    clock.lap()
    for Gt in tiles:
        clock.lap("load")
        outs.append(_tile_stats(Gt, rot_g, rot_e, nulls, env_dt, designs,
                                clock.lap, tp_mesh))
    del rot_g, rot_e
    timings = dict(nl["timings"], **clock.seconds())
    M = rg.M if rg is not None else G_src.shape[0]
    h = pd.gathered_rows(pd.row_block(outs, (E, 5), dtype, device), mesh, M)
    del outs
    f_marg, f_inter, f_joint = h[:, 0].copy(), h[:, 1].copy(), h[:, 2].copy()
    mask_b, mask_p = h[:, 3] > 0.5, h[:, 4] > 0.5
    ts = time.perf_counter()
    marg_ps, inter_ps, joint_ps = np.empty((E, M)), np.empty((E, M)), \
        np.empty((E, M))
    for e in range(E):
        marg_ps[e], inter_ps[e], joint_ps[e] = _finalize(
            f_marg[e], f_inter[e], f_joint[e], mask_b[e], mask_p[e], dof)
    timings["p_values"] = time.perf_counter() - ts

    # ---- the exact rescore of each environment's leading interactions,
    # over the whole source (on a mesh: on every rank, the same rows) ----
    rescored = [np.zeros(0, dtype=np.int64)] * E
    if rescore:
        ts = time.perf_counter()
        source = rg if rg is not None else G_src
        ex_g, ex_e = rotations("ex_")
        for e in range(E):
            idx = select_rescore_idx(inter_ps[e], rescore_top,
                                     tier_drift_name(rd), table=GXE_P_DRIFT)
            for s0 in range(0, len(idx), _RESCORE_ROWS):
                sub = idx[s0:s0 + _RESCORE_ROWS]
                st = _tile_stats(
                    cut(source_rows(source, sub, dtype, device)), ex_g,
                    [ex_e[e]], [nulls[e]], env_dt[e:e + 1], [designs[e]],
                    lambda stage=None: None,
                    tp_mesh)[0].cpu().double().numpy()
                f_marg[e][sub], f_inter[e][sub], f_joint[e][sub] = st[:3]
                mask_b[e][sub], mask_p[e][sub] = st[3] > 0.5, st[4] > 0.5
                marg_ps[e][sub], inter_ps[e][sub], joint_ps[e][sub] = \
                    _finalize(*st[:3], st[3] > 0.5, st[4] > 0.5, dof)
            rescored[e] = idx
        timings["rescore"] = time.perf_counter() - ts
    out = {
        "marginal_ps": marg_ps, "inter_ps": inter_ps,
        "joint_ps": joint_ps, "f_inter": f_inter,
        "mask": mask_b, "mask_inter": mask_p,
        "deltas": deltas, "pseudo_heritabilities": h2s,
        "precision_tier": tier_name, "rescored_idx": rescored,
        "timings_s": timings,
    }
    if single:
        for k in ("marginal_ps", "inter_ps", "joint_ps", "f_inter", "mask",
                  "mask_inter"):
            out[k] = out[k][0]
        out["rescored_idx"] = rescored[0]
        out["delta"] = float(deltas[0])
        out["pseudo_heritability"] = float(h2s[0])
    return out
