"""EMMAX entry points (counterpart of mixmogam_tpu/models/emmax.py:
_as_dosage, _as_design, emmax, _anova_pair_f, emmax_anova).

Routes: the resident route (a ResidentGenome, or a big int8 source
auto-packed onto the card), the streamed route (models/streaming.py::
emmax_streamed: a source over the in-core budget that does not fit packed,
or stream=True; checkpoint_dir= resumes it) and the in-core route (the
whole genome on the scan's device). An int8 or bf16 tier on in-core
integer dosages packs them and takes the resident route, where kernel K2
(int8) or K5 (bf16, which also takes missing genotypes) reads packed rows.
Fractional dosages at a bf16 tier stay in core as float rows and take the
float route (ops/rotate.py: a bf16 rotation by the parts of U', then
kernel K3); at an int8 tier they raise. mesh= sends an in-core source to
parallel/distributed.py::distributed_emmax (each rank scans its own rows
by the routes above), and a ResidentGenome, resident=True or an int8
source over the in-core budget that fits packed (packed on the host,
ResidentGenome.from_source(upload=False)) to distributed_emmax_resident
(each rank scans its shard of the packed rows).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def _as_dosage(G, dtype) -> np.ndarray:
    """GenotypeData (anything with dosage_f64()) or array -> (M, n) float
    array (numpy dtype) with the per-SNP mean imputation (int8: -1 =
    missing; float: NaN = missing)."""
    if hasattr(G, "dosage_f64"):
        return G.dosage_f64().astype(dtype)
    G = np.asarray(G)
    if G.dtype == np.int8:
        if not (G < 0).any():
            return G.astype(dtype)
        Gf = G.astype(np.float64)
        Gf[G < 0] = np.nan
    elif np.issubdtype(G.dtype, np.floating) and np.isnan(G).any():
        Gf = G.astype(np.float64)
    else:
        return G.astype(dtype)
    mu = np.nanmean(Gf, axis=1)
    mu = np.where(np.isnan(mu), 0.0, mu)
    idx = np.where(np.isnan(Gf))
    Gf[idx] = mu[idx[0]]
    return Gf.astype(dtype)


def _as_design(X0, n: int) -> np.ndarray:
    """1-D covariates become a column; the shape is checked against n."""
    X0 = np.asarray(X0, dtype=np.float64)
    if X0.ndim == 1:
        X0 = X0[:, None]
    if X0.ndim != 2 or X0.shape[0] != n:
        raise ValueError(f"X0 must be (n_samples={n}, q); got {X0.shape}")
    return X0


def _incore_rows(G, dtype) -> np.ndarray:
    """The in-core route's host rows: fully observed int8 dosages as they
    are, float dosages (NaN missing) mean-imputed a block of rows at a
    time straight into the compute dtype (no float64 copy of G), anything
    else (int8 with -1 missing) mean-imputed in float64."""
    from mixmogam_tpu_torch.models.streaming import _host_float_tile

    G_raw = G.matrix if hasattr(G, "matrix") else np.asarray(G)
    if (isinstance(G_raw, np.ndarray) and G_raw.dtype == np.int8
            and not (G_raw < 0).any()):
        return G_raw
    if (isinstance(G_raw, np.ndarray)
            and np.issubdtype(G_raw.dtype, np.floating)):
        return _host_float_tile(G_raw,
                                torch.empty((), dtype=dtype).numpy().dtype)
    return _as_dosage(G, np.float64)


def _scan_incore(Gf: np.ndarray, rot, srot, tile: int, device, dtype
                 ) -> torch.Tensor:
    """(4, m) [f, beta, var_perc, mask] of the host rows Gf on `device`, a
    tile at a time: the exact tier (fp32 GEMM by U', or with rot.high the
    'high' tier's three bf16 passes; then K3), or with srot the float
    route (ops/rotate.py: the bf16 parts of U', then K3). Fully observed
    int8 rows go to the device as int8 and reach the rotation so (the
    'high' tier skips their zero lo part), float rows in the compute dtype
    (the footprint should_stream assumed)."""
    from mixmogam_tpu_torch.ops.rotate import scan_float_rows
    from mixmogam_tpu_torch.ops.scan import emmax_scan_stats

    if Gf.shape[0] == 0:
        return torch.zeros((4, 0), dtype=dtype, device=device)
    if srot is None:
        def scan(t):
            return emmax_scan_stats(t, rot)
    else:
        def scan(t):
            return scan_float_rows(t, srot, rot)
    G_dev = torch.from_numpy(np.ascontiguousarray(Gf))
    if G_dev.dtype != torch.int8:
        G_dev = G_dev.to(dtype)
    G_dev = G_dev.to(device)
    return torch.cat([scan(G_dev[s:s + tile])
                      for s in range(0, G_dev.shape[0], tile)], dim=1)


#: share of the card's memory the in-core route may fill. The JAX
#: package's fixed 4 GiB (STREAM_BUDGET_BYTES, sized for a 16 GB TPU) is
#: re-derived from the card's own memory: should_stream counts G plus its
#: full rotated image, and a quarter of the card leaves the rest for U,
#: the working tile and the caching allocator.
INCORE_MEMORY_FRACTION = 0.25


def incore_budget_bytes(device) -> Optional[int]:
    device = torch.device(device)
    if device.type != "cuda":
        return None                 # host memory: no device budget
    total = torch.cuda.get_device_properties(device).total_memory
    return int(total * INCORE_MEMORY_FRACTION)


_RESIDENT_NO_RESUME = ("checkpoint_dir applies to streamed mode; the "
                       "resident route has no resume (its scan is device "
                       "compute over the packed genome)")
_MP_RESIDENT = ("matmul_precision is not supported on the resident path; "
                "use precision='high'")


def _legacy_matmul_precision(matmul_precision):
    """The JAX package's legacy matmul_precision kwarg -> the 'high' tier's
    matmul precision or None: 'high' is the three-pass bf16 tier, 'highest'
    (or 'float32') the exact tier the port always runs; any other value
    would lower the exact tier's float32 GEMM (TF32 or one bf16 pass),
    which the port does not do."""
    from mixmogam_tpu_torch.ops.scan import HIGH

    if matmul_precision in (None, "", "highest", "float32"):
        return None
    if matmul_precision == HIGH:
        return HIGH
    raise ValueError(
        f"matmul_precision={matmul_precision!r}: the port takes 'high' (the "
        "three-pass bf16 tier) or 'highest'; its float32 GEMMs run with "
        "TF32 off")


def emmax(G, y, K=None, X0=None, eig_k: Optional[Tuple] = None,
          ngrids: int = 100, llim: float = -10.0, ulim: float = 10.0,
          esp: float = 1e-6, with_betas: bool = True, dtype=None,
          tile: int = 16_384, host_eigh: Optional[bool] = None,
          rotate_in_bf16=False, matmul_precision: str = None,
          precision: str = None, stream: Optional[bool] = None,
          stream_budget_bytes: Optional[int] = None,
          checkpoint_dir: Optional[str] = None, rescore_top: int = 0,
          resident: Optional[bool] = None, mesh=None,
          rescore_cut_M: Optional[int] = None, device=None) -> dict:
    """EMMAX scan with the JAX package's emmax() arguments and return
    dict. G: GenotypeData, (M, n) dosages or a ResidentGenome; y: (n,);
    K: (n, n) kinship or eig_k=(phi, U); X0: (n, q) null design.

    device: where the scan runs: the card by default (without one the
    call raises), 'cpu' on request. A ResidentGenome scans on its own
    device. host_eigh: None takes the card's float64 eigh on the card and
    host LAPACK on the CPU; True asks for host LAPACK. dtype (a torch dtype)
    defaults to float32 on the card and float64 on the CPU. precision:
    'exact', 'bf16' / 'bf16x2' / 'bf16x3' (and the 'c' spellings) or
    'int8x2' / 'int8x3' / 'int8x4'; 'auto' and 'fast' by ops/scan.py::
    resolve_precision (on the CPU both exact; on the card 'auto' is exact
    while the card's int8x3 drift entry exceeds AUTO_MAX_DRIFT, 'fast' is
    int8x2 for integer dosages, else bf16, with rescore_top = 1024). The
    int8 tiers take integer dosages only; the bf16 tiers
    take fractional ones too (the float route). 'high': the exact tier's
    route with its rotation in three bf16 passes (ops/rotate.py::
    rotate_high; the dosages split too), on every single-device route;
    mesh= refuses it, as the JAX package does. matmul_precision: the JAX
    package's legacy spelling of 'high' (None, 'high', or 'highest', the
    exact tier), in core only (the resident and streamed routes and mesh=
    raise the JAX package's ValueErrors). rescore_top: a fast tier's
    threshold-complete exact rescore (finalize_scan); rescore_cut_M: the
    study's SNP count for its cut when G is part of the study (LOCO).

    Routing: a ResidentGenome (or resident=True) takes the resident route.
    With stream=None a source over the in-core budget (stream_budget_bytes,
    by default incore_budget_bytes of the device; none on the CPU) is packed
    resident if it is int8 and fits resident_budget_bytes, else streamed
    from the host (emmax_streamed, tile=max(tile, 8192)); stream=True
    streams at any size, stream=False never. checkpoint_dir needs the
    streamed route. mesh: a parallel.Mesh (make_mesh()) routes the scan
    through parallel/distributed.py (the JAX package's refusals first:
    'fast', stream=True, checkpoint_dir / rescore_top, matmul_precision):
    a ResidentGenome, resident=True or an int8 source over the in-core
    budget that fits packed (packed on the host, upload=False) to
    distributed_emmax_resident, any other source to distributed_emmax. A
    host-only ResidentGenome (from_source(upload=False)) without mesh=
    scans on `device`, its rows uploaded there once."""
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    _default_dtype,
                                                    emmax_resident,
                                                    resident_budget_bytes)
    from mixmogam_tpu_torch.models.source import (as_int8_dosage,
                                                  resolve_source,
                                                  should_stream)
    from mixmogam_tpu_torch.models.streaming import finalize_scan
    from mixmogam_tpu_torch.ops import resolve_device
    from mixmogam_tpu_torch.ops.reml import (esp_to_refine_iters,
                                             fit_null_model)
    from mixmogam_tpu_torch.ops.rotate import float_route_eig, float_rotation
    from mixmogam_tpu_torch.ops.scan import (build_rotated_null,
                                             is_integer_dosage, matmul_tier,
                                             normalize_rotate_tier,
                                             probe_for_source,
                                             resolve_precision)

    G_src = resolve_source(G)
    rg_given = isinstance(G_src, ResidentGenome)
    if stream is True and (resident is True or rg_given):
        raise ValueError("stream=True and resident=True are mutually "
                         "exclusive (a resident genome never streams)")
    if mesh is not None:
        return _emmax_on_mesh(
            G, G_src, y, K=K, X0=X0, eig_k=eig_k, ngrids=ngrids, llim=llim,
            ulim=ulim, esp=esp, with_betas=with_betas, dtype=dtype,
            tile=tile, host_eigh=host_eigh, rotate_in_bf16=rotate_in_bf16,
            matmul_precision=matmul_precision, precision=precision,
            stream=stream, stream_budget_bytes=stream_budget_bytes,
            checkpoint_dir=checkpoint_dir, rescore_top=rescore_top,
            resident=resident, mesh=mesh, device=device)
    if str(precision) == "fast" and not rescore_top:
        # 'fast' pairs its tier with the threshold-complete exact rescore
        rescore_top = 1024
    mp = _legacy_matmul_precision(matmul_precision)
    kw = dict(ngrids=ngrids, llim=llim, ulim=ulim, esp=esp,
              with_betas=with_betas, precision=precision,
              rotate_in_bf16=rotate_in_bf16, rescore_top=rescore_top,
              rescore_cut_M=rescore_cut_M)
    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    if rg_given:
        if checkpoint_dir is not None:
            raise ValueError(_RESIDENT_NO_RESUME)
        if mp:
            raise ValueError(_MP_RESIDENT)
        return emmax_resident(G_src.on_device(device), y, K=K, X0=X0,
                              eig_k=eig_k, dtype=dtype, **kw)
    device = resolve_device(device)
    if dtype is None:
        dtype = _default_dtype(device)
    itemsize = torch.empty((), dtype=dtype).element_size()
    budget = (incore_budget_bytes(device) if stream_budget_bytes is None
              else stream_budget_bytes)
    over_incore = (budget is not None
                   and should_stream(G_src, n, itemsize, budget))
    int8_src = np.dtype(G_src.dtype) == np.int8
    if resident is True or (
            resident is None and stream is not True and over_incore
            and int8_src and G_src.shape[0] * ((n + 3) // 4)
            <= resident_budget_bytes(device)):
        if checkpoint_dir is not None:
            raise ValueError(_RESIDENT_NO_RESUME)
        if mp:
            raise ValueError(_MP_RESIDENT)
        rg = ResidentGenome.from_source(G_src, device=device)
        return emmax_resident(rg, y, K=K, X0=X0, eig_k=eig_k, dtype=dtype,
                              **kw)
    if stream is None:
        stream = over_incore
    if stream:
        from mixmogam_tpu_torch.models.streaming import emmax_streamed

        if mp:
            # the legacy knob: streamed mode takes the unified name
            raise ValueError("matmul_precision is not supported in streamed "
                             "mode; use precision='high'")
        return emmax_streamed(
            G_src, y, K=K, X0=X0, eig_k=eig_k, tile=max(tile, 8192),
            checkpoint_dir=checkpoint_dir, dtype=dtype, host_eigh=host_eigh,
            device=device, **kw)
    if checkpoint_dir is not None:
        raise ValueError("checkpoint_dir requires streamed mode "
                         "(stream=True or a source over the budget)")

    rb, tier_name = rotate_in_bf16, None
    if precision is not None:
        if rotate_in_bf16 or matmul_precision:
            raise ValueError("pass either precision= or the legacy "
                             "rotate_in_bf16/matmul_precision kwargs, "
                             "not both")
        rb, tier_name = resolve_precision(
            precision, G=probe_for_source(None, G_src), device=device)
    rd, mp_tier = matmul_tier(normalize_rotate_tier(rb))
    # the legacy knob with a rotation tier: the tier's route, as the JAX
    # package's kernels run it
    mp = mp_tier or (mp if rd is None else None)
    if rd is not None:
        # int8 and bf16 tiers on integer dosages run on packed rows
        # (kernels K2 / K5): pack them (-1 / NaN missing; K5 imputes per
        # row) and take the resident route; fractional dosages at a bf16
        # tier take the float route below
        G8 = as_int8_dosage(G)
        if rd.startswith("int8") and (G8 is None
                                      or (np.asarray(G8) < 0).any()):
            raise ValueError(
                f"tier {precision or rotate_in_bf16!r} requires "
                "integer dosages (the digit-plane products take int8 "
                "genotypes; mean-imputed fractional dosages would be "
                "silently altered). Use the exact tier for imputed "
                "dosages.")
        if G8 is not None:
            rg = ResidentGenome.from_source(G8, tile=tile, device=device)
            return emmax_resident(rg, y, K=K, X0=X0, eig_k=eig_k,
                                  dtype=dtype, **kw)
    Gf = _incore_rows(G, dtype)
    if X0 is None:
        X0 = np.ones((n, 1))
    X0 = _as_design(X0, n)
    if rd is not None:
        # the float route cuts its parts from this eigenbasis in float64
        eig_k = float_route_eig(K, eig_k, device, host_eigh)
    null = fit_null_model(y, X0, K=K, eig_k=eig_k, ngrids=ngrids,
                          llim=llim, ulim=ulim,
                          refine_iters=esp_to_refine_iters(
                              esp, ngrids, llim, ulim),
                          host_eigh=host_eigh,
                          eigh_dtype=(np.float32 if str(precision) == "fast"
                                      else None),
                          device=device, dtype=dtype)
    rot = build_rotated_null(null, matmul_precision=mp)
    # the float route: each tile cast to bf16 and rotated by the bf16 parts
    # of the exact tier's U', then K3 (ops/rotate.py)
    srot = (None if rd is None
            else float_rotation(eig_k[1], X0, rd, dtype, device))
    h = _scan_incore(Gf, rot, srot, tile, device,
                     dtype).cpu().double().numpy()
    return finalize_scan(
        Gf, null, dtype, h[0].copy(), h[3] > 0.5,
        betas=h[1].copy() if with_betas else None,
        var_perc=h[2].copy() if with_betas else None,
        with_betas=with_betas, rescore_top=rescore_top, rd=rd,
        matmul_precision=mp, dof=int(rot.dof), rescore_cut_M=rescore_cut_M,
        # the float route's drift; at 'high' that of fractional dosages
        # where the rows are not integers
        fractional=rd is not None or bool(
            mp and rescore_top and Gf.dtype != np.int8
            and not is_integer_dosage(Gf)),
        tier_name=tier_name)


def _emmax_on_mesh(G, G_src, y, K, X0, eig_k, ngrids, llim, ulim, esp,
                   with_betas, dtype, tile, host_eigh, rotate_in_bf16,
                   matmul_precision, precision, stream, stream_budget_bytes,
                   checkpoint_dir, rescore_top, resident, mesh, device
                   ) -> dict:
    """emmax(mesh=): the JAX package's refusals in its order, then its
    routes. A ResidentGenome, resident=True (the source packed on the
    host), or an int8 source over the in-core budget that fits packed
    (models/source.py::pack_for_mesh) go to parallel/distributed.py::
    distributed_emmax_resident; any other source to distributed_emmax."""
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    _default_dtype,
                                                    resident_budget_bytes)
    from mixmogam_tpu_torch.models.source import pack_for_mesh, should_stream
    from mixmogam_tpu_torch.ops.scan import (probe_for_source,
                                             refuse_high_on_mesh,
                                             resolve_precision)
    from mixmogam_tpu_torch.parallel.distributed import (
        distributed_emmax, distributed_emmax_resident, mesh_entry)

    mesh, device = mesh_entry(mesh, G, "emmax", device)
    if str(precision) == "fast":
        raise ValueError(
            "'fast' pairs a tier with the single-device rescore pass; pick "
            "an explicit tier for mesh scans")
    if stream is True:
        raise ValueError("stream=True is a single-device feature; the mesh "
                         "path shards in-core or packed rows")
    if checkpoint_dir is not None or rescore_top:
        raise ValueError("checkpoint_dir/rescore_top are single-device "
                         "features; drop mesh= or rescore the gathered "
                         "result")
    if matmul_precision:
        raise ValueError("matmul_precision is not supported on the mesh "
                         "path; use a precision= tier name")
    if dtype is None:
        dtype = _default_dtype(device)
    n = np.asarray(y).size
    rg = G_src if isinstance(G_src, ResidentGenome) else None
    if rg is None and resident is True:
        rg = ResidentGenome.from_source(G_src, upload=False)
    elif rg is None and resident is not False:
        itemsize = torch.empty((), dtype=dtype).element_size()
        budget = (incore_budget_bytes(device) if stream_budget_bytes is None
                  else stream_budget_bytes)
        if (budget is not None and should_stream(G_src, n, itemsize, budget)
                and np.dtype(G_src.dtype) == np.int8
                and G_src.shape[0] * ((n + 3) // 4)
                <= resident_budget_bytes(device)):
            rg = pack_for_mesh(G_src, n, "emmax", device)
    rb = rotate_in_bf16
    if precision is not None:
        if rotate_in_bf16:
            raise ValueError("pass either precision= or the legacy "
                             "rotate_in_bf16 kwarg, not both")
        rb, _ = resolve_precision(
            precision, G=probe_for_source(rg, G_src), device=device)
        refuse_high_on_mesh(rb)
    kw = dict(K=K, X0=X0, mesh=mesh, eig_k=eig_k, ngrids=ngrids, llim=llim,
              ulim=ulim, esp=esp, dtype=dtype, rotate_in_bf16=rb,
              host_eigh=host_eigh, device=device)
    res = (distributed_emmax_resident(rg, y, **kw) if rg is not None
           else distributed_emmax(G, y, tile=tile, **kw))
    if not with_betas:
        res.pop("betas", None)
        res.pop("var_perc", None)
    return res


def _anova_pair_f(Aw: torch.Tensor, Bw: torch.Tensor, rot,
                  keep_a: torch.Tensor, keep_b: torch.Tensor):
    """(f, d1, dof2, mask) of the joint F-test of two genotype-class
    indicator columns a tile, from their whitened rows Aw, Bw (the
    indicators times W = U' sd, whole rows): residualized against Q0 and
    Gram-Schmidt'ed against each other. keep_a / keep_b: outside_design
    of the unrotated indicators; an indicator inside col(X0) (I1 of a SNP
    where every sample is heterozygous: the intercept) counts as no
    column, whatever rounding leaves of it after the projected W."""
    dt = rot.sd.dtype
    fi = torch.finfo(dt)
    eps = 100.0 * fi.eps
    Q0 = rot.Q0
    Ar = Aw - (Aw @ Q0) @ Q0.T
    Br = Bw - (Bw @ Q0) @ Q0.T
    aa = (Ar * Ar).sum(dim=1)
    maska = keep_a & (aa > eps * torch.clamp((Aw * Aw).sum(dim=1),
                                             min=fi.tiny))
    aa_s = torch.where(maska, aa, 1.0)
    ab = (Ar * Br).sum(dim=1)
    Br2 = Br - torch.where(maska, ab / aa_s, 0.0)[:, None] * Ar
    bb = (Br2 * Br2).sum(dim=1)
    maskb = keep_b & (bb > eps * torch.clamp((Bw * Bw).sum(dim=1),
                                             min=fi.tiny))
    bb_s = torch.where(maskb, bb, 1.0)
    ay = Ar @ rot.y_res
    by = Br2 @ rot.y_res
    expl = (torch.where(maska, ay * ay / aa_s, 0.0)
            + torch.where(maskb, by * by / bb_s, 0.0))
    d1 = maska.to(dt) + maskb.to(dt)
    mask = d1 > 0
    expl = torch.minimum(expl, rot.rss0)
    dof2 = rot.dof + 1.0 - d1                                   # n - q - d1
    rss1 = torch.clamp(rot.rss0 - expl, min=fi.tiny)
    f = torch.where(mask, (expl / torch.clamp(d1, min=1.0))
                    / (rss1 / torch.clamp(dof2, min=1.0)), 0.0)
    return f, d1, dof2, mask


def emmax_anova(G, y, K=None, X0=None, eig_k=None, ngrids: int = 100,
                llim: float = -10.0, ulim: float = 10.0, esp: float = 1e-6,
                host_eigh: Optional[bool] = None, dtype=None,
                tile: int = 4096, mesh=None, device=None, **kw) -> dict:
    """EMMAX with the SNP coded as genotype classes, with the JAX
    package's arguments and return dict. Binary genotypes: emmax() itself,
    every kwarg (precision= among them) forwarded. Diploid: the joint
    F-test of the indicator columns [g = 1] and [g >= 1.5] (d1 = the
    classes present - 1), dominance not assumed additive, with the exact
    tier's null on `device` (the card by default, 'cpu' on request) in its
    dtype (float32 on the card, float64 on the CPU): the indicators are
    whitened by W = U' sd with the projected U' = (I - P_X0) U of
    build_rotated_null, and an indicator inside col(X0) is masked from its
    unrotated values (ops/scan.py::outside_design).

    mesh: a parallel.Mesh (make_mesh()). Binary genotypes go to
    emmax(mesh=); the diploid test shards by SNP rows, as the JAX package's
    mesh= does: rank 0 fits the null and builds its rotated null (K or
    eig_k needed there only), one broadcast replicates it, each rank tests
    its rows (rank_range at `tile`) with no communication, and the (4,
    m_rank) results meet in one all-gather. On a 'sample' axis each rank
    is sent only its block of W's contraction rows; the indicators' blocks
    of sample columns are rotated and summed over 'sample'
    (ops/scan.py::apply_rotation_psum), their masks from sums over
    'sample' (outside_design_psum), and the pair test runs on the whole
    rows. Every rank returns the whole result; device: the rank's (default
    the mesh's)."""
    from mixmogam_tpu_torch.models.resident import _default_dtype
    from mixmogam_tpu_torch.ops import assert_fp32_matmuls, resolve_device
    from mixmogam_tpu_torch.ops.reml import (esp_to_refine_iters,
                                             fit_null_model)
    from mixmogam_tpu_torch.ops.rotate import rotation_rows
    from mixmogam_tpu_torch.ops.scan import (apply_rotation_psum,
                                             build_rotated_null,
                                             outside_design,
                                             outside_design_psum)
    from mixmogam_tpu_torch.ops.stats import f_sf_host
    from mixmogam_tpu_torch.parallel import distributed as pd

    if mesh is not None:
        # the mesh's checks come first; the binary route makes them again
        mesh, mesh_device = pd.mesh_entry(mesh, G, "emmax_anova", device)
    if hasattr(G, "matrix"):
        ploidy = G.ploidy
        G_int = G.matrix
    else:
        G_int = np.asarray(G)
        mx = (np.nanmax(G_int, initial=0)
              if np.issubdtype(G_int.dtype, np.floating)
              else G_int.max(initial=0))
        ploidy = 2 if mx > 1 else 1
    if ploidy == 1:
        return emmax(G_int, y, K=K, X0=X0, eig_k=eig_k, ngrids=ngrids,
                     llim=llim, ulim=ulim, esp=esp, host_eigh=host_eigh,
                     dtype=dtype, tile=tile, mesh=mesh, device=device, **kw)
    if kw:
        # the diploid test has no precision tiers or with_betas: refuse
        # rather than drop them
        raise TypeError(
            f"emmax_anova diploid path does not accept {sorted(kw)}; "
            "supported kwargs: K/X0/eig_k/ngrids/llim/ulim/esp/"
            "host_eigh/dtype/tile/mesh/device")
    device = resolve_device(device) if mesh is None else mesh_device
    if dtype is None:
        dtype = _default_dtype(device)
    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    X0 = _as_design(np.ones((n, 1)) if X0 is None else X0, n)

    def null():
        """The exact tier's rotated null and the fit's two scalars."""
        fit = fit_null_model(y, X0, K=K, eig_k=eig_k, ngrids=ngrids,
                             llim=llim, ulim=ulim,
                             refine_iters=esp_to_refine_iters(
                                 esp, ngrids, llim, ulim),
                             host_eigh=host_eigh, device=device, dtype=dtype)
        return dict(pd.null_fields(build_rotated_null(fit)),
                    delta=float(fit.delta),
                    h2=float(fit.pseudo_heritability))

    if dtype == torch.float32:
        assert_fp32_matmuls()
    if mesh is not None and mesh.shape[1] > 1:
        # on a 'sample' axis each rank is sent only its block of W's rows;
        # the indicators' blocks of sample columns are rotated by it and
        # summed over 'sample', their masks from sums over 'sample'
        tp = pd.tp_columns(n, mesh, packed=False)

        def null_w():
            nl = null()
            return dict(nl, U=None), nl["U"] * nl["sd"][None, :]

        nl, W_b = pd.on_rank0_rows(null_w, mesh, *tp)
        rot = pd.null_from_fields(nl)
        W_b = rotation_rows(W_b, None, dtype)
        X0b, X0pb = (pd.block_rows(X, *tp[1:]) for X in (rot.X0, rot.X0p))

        def rotated(I):
            I = pd.block_cols(I, *tp[1:])
            return (apply_rotation_psum(I, W_b, None, dtype, mesh, n),
                    outside_design_psum(I, X0b, X0pb, mesh))
    else:
        # on a mesh rank 0's, replicated by one broadcast
        nl = pd.on_rank0(null, mesh)
        rot = pd.null_from_fields(nl)
        W = rot.U * rot.sd[None, :]

        def rotated(I):
            return I @ W, outside_design(I, rot.X0, rot.X0p)
    # the indicators of the mean-imputed dosages (a missing call falls in
    # the class nearest its SNP's mean); on a mesh this rank's rows
    _, rows = pd.rank_sources(mesh, tile, device, None, G_int)
    Gf = _as_dosage(rows, np.float64)
    outs = []
    for s in range(0, Gf.shape[0], tile):
        g = torch.from_numpy(Gf[s:s + tile]).to(device)
        (Aw, keep_a), (Bw, keep_b) = (
            rotated(I.to(dtype)) for I in ((g - 1.0).abs() < 0.5, g >= 1.5))
        outs.append(torch.stack([v.to(dtype) for v in _anova_pair_f(
            Aw, Bw, rot, keep_a, keep_b)]))
    h = pd.gathered_rows(pd.row_block(outs, (4,), dtype, device), mesh,
                         G_int.shape[0])
    fs, d1s, d2s, masks = h[0], h[1], h[2], h[3] > 0.5
    ps = np.where(masks, f_sf_host(fs, np.maximum(d1s, 1.0),
                                   np.maximum(d2s, 1.0)), 1.0)
    return {"ps": ps, "f_stats": fs, "dof1": d1s, "dof2": d2s,
            "mask": masks, "delta": nl["delta"],
            "pseudo_heritability": nl["h2"]}
