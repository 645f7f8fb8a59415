"""Multi-trait EMMAX over one shared eigenbasis (counterpart of
mixmogam_tpu/models/multitrait.py: _trait_nulls, _scan_tile_multitrait,
emmax_multi_trait, _multi_trait_grouped; BASELINE config #4).

All T traits share eigh(K), the one O(n^3) step. Each trait gets its own
float64 REML (ops/xreml.py::explicit_reml, on the data's device) and its
own whitened null: a RotatedNull of sd_t, an orthonormal Q0_t, y_res_t and
rss0_t (models/stepwise.py::_rot_null_from_delta, float64, then cast to
the compute dtype). The scan rotates each genotype tile ONCE, shared by all
T traits, then launches kernel K3 once per trait on the rotated tile
(ops/scan.py::emmax_scan_prerotated): K3 whitens by the trait's sd_t and
runs its GLS epilogue. K3's operand is prepared once per trait and call
(ops/hopper_scan.py::k3_operand).

The shared rotation is U' = (I - P_X0) U (ops/scan.py::project_design),
not U as in the JAX package. (I - P_X0) g differs from g by X0 b, which
after whitening by any trait's sd_t lies in col(X~0_t): every trait gets
the same F and beta, and where K is singular along X0 with delta small
(VanRaden's K along the intercept) no 1/sqrt(delta)-weighted coordinate
reaches K3's float32 sums. Rows inside col(X0) are masked
(ops/scan.py::outside_design), once per tile for all traits.

The shared product is an XLA dot in the JAX package, outside any Pallas
kernel; here it is a library product by tier (ops/rotate.py::rotate_tile:
a float32 GEMM, int8 digit planes or bf16 parts with float32 outputs).

mesh= (_multi_trait_on_mesh) runs the same null (_mt_null) on rank 0 and
the same tile loop (_mt_scan) over each rank's rows. On a 'sample' axis
each rank holds its contraction-row block of the shared rotation and
rotates its block of each tile's sample columns; the partial products meet
over 'sample' (ops/scan.py::apply_rotation_psum) before K3 runs once a
trait on the whole rotated rows.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

from mixmogam_tpu_torch.ops.rotate import (SharedRotation,  # noqa: F401
                                           rotate_tile, shared_rotation)

__all__ = ["emmax_multi_trait"]

#: tiles whose (T, 4, rows) statistics wait on the card before their copy
#: to the host: the copy of one tile overlaps the next tile's work
_PENDING = 2


def _scan_tile_multitrait(G_rot_tile: torch.Tensor, nulls, keep=None):
    """(f, beta, mask), each (T, m), of one rotated tile (m, n) for the
    traits' RotatedNulls `nulls` (the JAX package's triple): one launch of
    K3 a trait (its plain version on the CPU); the rows outside `keep`
    (outside_design) come out zeroed, mask included."""
    from mixmogam_tpu_torch.ops.scan import emmax_scan_prerotated

    out = torch.stack([emmax_scan_prerotated(G_rot_tile, r, keep)
                       for r in nulls])
    return out[:, 0], out[:, 1], out[:, 3] > 0.5


def _trait_nulls(phi, Y_rot64, X_rot64, deltas, dtype) -> list:
    """Per-trait RotatedNulls (sd_t, Q0_t, y_res_t, rss0_t, dof), whitened
    in float64 from Y_rot64 (T, n) and X_rot64 (n, q), cast to dtype; phi
    in dtype (the scan's sd = 1/sqrt(phi + delta_t))."""
    from mixmogam_tpu_torch.models.stepwise import _rot_null_from_delta

    return [_rot_null_from_delta(phi, float(d), Y_rot64[t], X_rot64, dtype)
            for t, d in enumerate(deltas)]


def emmax_multi_trait(G, Y, K=None, X0: Optional[np.ndarray] = None,
                      eig_k=None, ngrids: int = 100, llim: float = -10.0,
                      ulim: float = 10.0, esp: float = 1e-6, dtype=None,
                      tile: Optional[int] = None, tile_budget: int = 1 << 28,
                      stream_budget_bytes: Optional[int] = None,
                      precision: Optional[str] = None,
                      _keep_cols: Optional[np.ndarray] = None, mesh=None,
                      device=None) -> Dict[str, np.ndarray]:
    """EMMAX over T phenotypes sharing one kinship and its eigenbasis, with
    the JAX package's arguments and return dict.

    G: a ResidentGenome (scanned on its own device), or a GenotypeData or
    (M, n) array (int8 with -1 missing, or float dosages with NaN missing)
    on `device`: the card by default (without one the call raises), 'cpu'
    on request. Fully observed int8 goes up as int8; a source over the
    card's in-core budget (stream_budget_bytes) is packed resident if it is
    int8 and fits packed, as models/emmax.py does, else streamed from the
    host a tile at a time, at the exact tier only. Y: (T, n), a row a
    trait; NaN phenotypes group the traits by their missingness pattern,
    each group on its own sample subset with its K sub-block and its own
    eigh. dtype: float32 on the card, float64 on
    the CPU by default. precision: 'exact', 'auto' (ops/scan.py::
    resolve_precision: on the CPU exact), 'int8x2' / 'int8x3' / 'int8x4'
    (fully observed integer dosages only), 'bf16' / 'bf16x2' / 'bf16x3' or
    'high' (the three-pass bf16 split of U' and of each tile, ops/rotate.py::
    rotate_high) for the shared rotation, split once; 'fast' raises (no
    rescore pass), and so does any tier on a streamed source, as in the
    JAX package. tile: SNP rows a tile (None: the resident
    genome's tile, else as many rows as keep one rotated tile under
    tile_budget values, at most 16,384).

    mesh: a parallel.Mesh (make_mesh()) shards the scan by SNP rows, as the
    JAX package's mesh= does (_multi_trait_on_mesh): rank 0 takes the
    eigh, the T fits and the shared rotation, one broadcast replicates
    them, each rank scans its rows, one all-gather. A 'sample' axis also
    shards the rotation's contraction rows and the samples (the
    tensor-parallel scan). device: the rank's (default the mesh's).

    Returns ps / f_stats / betas / mask of shape (T, M), per-trait deltas
    and pseudo_heritabilities, 'dof' (an int, or a (T,) array when the
    missingness groups differ), 'precision_tier', and 'timings_s' (host
    seconds of the eigh, the T REML fits, the scan and the p-values)."""
    from mixmogam_tpu_torch.models.emmax import (_as_design,
                                                 incore_budget_bytes)
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    _default_dtype,
                                                    resident_and_device,
                                                    resident_budget_bytes)
    from mixmogam_tpu_torch.models.source import (resolve_source,
                                                  should_stream)
    from mixmogam_tpu_torch.ops.scan import (normalize_rotate_tier,
                                             probe_for_source,
                                             resolve_precision)

    if mesh is not None:
        return _multi_trait_on_mesh(
            G, Y, K=K, X0=X0, eig_k=eig_k, ngrids=ngrids, llim=llim,
            ulim=ulim, esp=esp, dtype=dtype, tile=tile,
            tile_budget=tile_budget, stream_budget_bytes=stream_budget_bytes,
            precision=precision, mesh=mesh, device=device)
    Y = np.atleast_2d(np.asarray(Y, dtype=np.float64))
    T, n = Y.shape
    rg, device = resident_and_device(G, device)
    if dtype is None:
        dtype = _default_dtype(device)
    # ---- refusals before any eigh or REML fit ----
    rd, tier_name = None, "exact"
    _refuse_fast(precision)
    G_src = resolve_source(G)
    M = G_src.shape[0]
    streamed = False
    if rg is None:
        itemsize = torch.empty((), dtype=dtype).element_size()
        budget = (incore_budget_bytes(device) if stream_budget_bytes is None
                  else stream_budget_bytes)
        if budget is not None and should_stream(G_src, n, itemsize, budget):
            if (np.dtype(G_src.dtype) == np.int8
                    and M * ((n + 3) // 4) <= resident_budget_bytes(device)):
                rg = ResidentGenome.from_source(G_src, device=device)
            else:
                streamed = True
    if precision is not None:
        # 'auto' / 'fast' look at the dosages: the container's flag, the
        # in-core matrix; a streamed source never takes an int8 tier
        probe = None if streamed else probe_for_source(rg, G_src)
        rb, tier_name = resolve_precision(precision, G=probe, device=device)
        rd = normalize_rotate_tier(rb)
    if streamed and rd is not None:
        raise ValueError("precision tiers on the multi-trait path need an "
                         "in-core or resident source; a streamed source "
                         "scans at the exact tier")
    G8 = _refuse_int8(rd, rg, G)
    if rg is not None:
        if _keep_cols is not None:
            if len(_keep_cols) != n:
                raise ValueError("_keep_cols must list one container "
                                 "column per Y column")
        elif rg.n != n:
            raise ValueError(f"Y has {n} samples but the resident genome "
                             f"holds {rg.n}")
    if np.isnan(Y).any():
        src = rg if rg is not None else G_src
        kw = dict(ngrids=ngrids, llim=llim, ulim=ulim, esp=esp, dtype=dtype,
                  tile=tile, tile_budget=tile_budget,
                  stream_budget_bytes=stream_budget_bytes,
                  precision=precision, device=device)

        def scan_group(Yg, Kg, X0g, keep, idx):
            # a container gathers the group's columns on the device; an
            # in-core source is cut to them
            if rg is not None:
                return emmax_multi_trait(
                    rg, Yg, K=Kg, X0=X0g,
                    _keep_cols=None if keep.all() else idx, **kw)
            return emmax_multi_trait(
                np.ascontiguousarray(np.asarray(src)[:, keep]), Yg, K=Kg,
                X0=X0g, **kw)

        return _multi_trait_grouped(M, Y, K, X0, scan_group)
    X0 = _as_design(np.ones((n, 1)) if X0 is None else X0, n)
    nl = _mt_null(Y, X0, K, eig_k, rd, dtype, device, ngrids, llim, ulim,
                  esp)
    timings = nl["timings"]

    # ---- the scan: a tile rotated once, then K3 once per trait ----
    ts = time.perf_counter()
    cols = None
    if rg is not None:
        tile = rg.tile
        if _keep_cols is not None:
            cols = torch.as_tensor(np.asarray(_keep_cols), dtype=torch.int64,
                                   device=device)
        G_dev = None
    else:
        tile = tile or _default_tile(n, tile_budget)
        G_dev = None if streamed else _incore_tensor(G, G8, dtype, device)
    fs, betas, masks = _mt_scan(
        _tiles_of(rg, G_dev, G_src if streamed else None, M, tile, cols,
                  dtype, device), T, M, nl, dtype)
    timings["scan"] = time.perf_counter() - ts
    return _mt_result(fs, betas, masks, nl, n - X0.shape[1] - 1, tier_name,
                      timings)


def _refuse_fast(precision) -> None:
    """The refusals of a tier name that come before any routing: 'fast'
    (no rescore pass here), then unknown names."""
    from mixmogam_tpu_torch.ops.scan import resolve_precision

    if str(precision) == "fast":
        raise ValueError(
            "multi-trait has no rescore pass; pick an explicit tier "
            "('int8x3' / 'bf16x3' are fp32-grade) or leave exact")
    if precision is not None:
        resolve_precision(precision)      # unknown names raise


def _refuse_int8(rd, rg, G):
    """An int8 tier's refusal of missing calls or fractional dosages (a
    container from its flag, an in-core source from its dosages); returns
    the in-core source as int8 dosages when the tier takes them."""
    from mixmogam_tpu_torch.models.source import as_int8_dosage

    if rd is None or not rd.startswith("int8"):
        return None
    if rg is not None:
        if rg.has_missing:
            raise ValueError(
                "int8 digit-plane tiers need fully-observed dosages "
                "(this container has missing genotypes)")
        return None
    G8 = as_int8_dosage(G)
    if G8 is None or (np.asarray(G8) < 0).any():
        raise ValueError(
            "int8 digit-plane tiers need exact integer dosages, "
            "fully observed; these are fractional or missing (mean-"
            "imputed). Use the exact tier")
    return G8


def _default_tile(n: int, tile_budget: int) -> int:
    """SNP rows a tile of an in-core or streamed source: one rotated tile
    under tile_budget values, at most 16,384."""
    return max(64, min(16_384, tile_budget // max(n, 1)))


def _incore_tensor(G, G8, dtype, device) -> torch.Tensor:
    """The in-core rows on the device: int8 for an int8 tier (G8) or a
    fully observed int8 source, else mean-imputed in dtype."""
    from mixmogam_tpu_torch.models.emmax import _as_dosage

    if G8 is not None:
        Gh = np.asarray(G8)
    else:
        G_raw = G.matrix if hasattr(G, "matrix") else np.asarray(G)
        Gh = (G_raw if (isinstance(G_raw, np.ndarray)
                        and G_raw.dtype == np.int8
                        and not (G_raw < 0).any())
              else _as_dosage(G, np.float64))
    G_dev = torch.from_numpy(np.ascontiguousarray(Gh))
    return (G_dev if G_dev.dtype == torch.int8
            else G_dev.to(dtype)).to(device)


def _mt_null(Y, X0, K, eig_k, rd, dtype, device, ngrids, llim, ulim,
             esp) -> dict:
    """One eigh, T float64 REML fits where the data live, the traits'
    RotatedNulls (_trait_nulls) and the shared rotation of U' at the tier
    rd, with X0's (X0, X0p) in dtype for the design mask: a dict with
    deltas and h2s (host) and the seconds of the eigh and the fits."""
    from mixmogam_tpu_torch.ops.eigen import eigen_k_on
    from mixmogam_tpu_torch.ops.reml import esp_to_refine_iters
    from mixmogam_tpu_torch.ops.scan import project_design
    from mixmogam_tpu_torch.ops.xreml import explicit_reml

    T = Y.shape[0]
    timings = {}
    ts = time.perf_counter()
    if eig_k is None:
        if K is None:
            raise ValueError("need K or eig_k")
        phi, U = eigen_k_on(np.asarray(K, np.float64), device)
    else:
        phi, U = eig_k
    phi = torch.as_tensor(phi).to(device)
    U64 = torch.as_tensor(U).to(device=device, dtype=torch.float64)
    timings["eigh"] = time.perf_counter() - ts
    ts = time.perf_counter()
    phi64 = phi.double()
    X0_64 = torch.as_tensor(X0, device=device)
    X_rot64 = U64.T @ X0_64
    Y_rot64 = torch.as_tensor(Y, device=device) @ U64          # (T, n)
    ri = esp_to_refine_iters(esp, ngrids, llim, ulim)
    fits = [explicit_reml(phi64, Y_rot64[t], X_rot64, ngrids=ngrids,
                          llim=llim, ulim=ulim, refine_iters=ri)
            for t in range(T)]
    deltas = np.array([float(f["delta"]) for f in fits])
    h2s = np.array([float(f["pseudo_heritability"]) for f in fits])
    timings["reml"] = time.perf_counter() - ts
    nulls = _trait_nulls(phi.to(dtype), Y_rot64, X_rot64, deltas, dtype)
    Up, X0d, X0p = project_design(U64, X0_64)
    del U64
    rot = shared_rotation(Up, rd, dtype)
    del Up
    return {"deltas": deltas, "h2s": h2s, "nulls": nulls, "rot": rot,
            "X0d": X0d.to(dtype), "X0p": X0p.to(dtype), "timings": timings}


def _mt_scan(tiles, T: int, M: int, nl: dict, dtype):
    """(f_stats, betas, masks), (T, M) host arrays, of the tiles (s, e,
    rows) that cover M rows: each tile's design mask and rotation once,
    then K3 once a trait (_scan_tile_multitrait); a tile's statistics wait
    on the device while the next ones run (_PENDING)."""
    from mixmogam_tpu_torch.ops.scan import outside_design

    fs = np.empty((T, M))
    betas = np.empty((T, M))
    masks = np.empty((T, M), dtype=bool)
    pending = []

    def drain(s, e, out):
        h = out.cpu().double().numpy()
        fs[:, s:e], betas[:, s:e], masks[:, s:e] = h[0], h[1], h[2] > 0.5

    for s, e, Gt in tiles:
        keep = outside_design(Gt.to(dtype), nl["X0d"], nl["X0p"])
        f, b, mk = _scan_tile_multitrait(rotate_tile(Gt, nl["rot"]),
                                         nl["nulls"], keep)
        pending.append((s, e, torch.stack((f, b, mk.to(f.dtype)))))
        if len(pending) > _PENDING:
            drain(*pending.pop(0))
    for item in pending:
        drain(*item)
    return fs, betas, masks


def _mt_result(fs, betas, masks, nl: dict, dof: int, tier_name: str,
               timings: dict) -> Dict[str, np.ndarray]:
    """The return dict, p-values in float64 on the host."""
    from mixmogam_tpu_torch.ops.stats import f_sf_host

    ts = time.perf_counter()
    ps = np.where(masks, f_sf_host(fs, 1.0, dof), 1.0)
    timings["p_values"] = time.perf_counter() - ts
    return {"ps": ps, "f_stats": fs, "betas": betas, "mask": masks,
            "deltas": nl["deltas"], "pseudo_heritabilities": nl["h2s"],
            "dof": dof, "precision_tier": tier_name, "timings_s": timings}


def _multi_trait_on_mesh(G, Y, K=None, X0=None, eig_k=None,
                         ngrids: int = 100, llim: float = -10.0,
                         ulim: float = 10.0, esp: float = 1e-6, dtype=None,
                         tile=None, tile_budget: int = 1 << 28,
                         stream_budget_bytes=None, precision=None,
                         mesh=None, device=None) -> Dict[str, np.ndarray]:
    """emmax_multi_trait(mesh=): the JAX package's route over torch.
    distributed. Its refusals come first, on every rank: the mesh
    (parallel/distributed.py::mesh_entry), 'fast', a source over the
    in-core budget packed on the host (models/source.py::pack_for_mesh,
    which refuses a float source or one over the packed budget), then the
    tier resolved for the source and an int8 tier's refusal of missing or
    fractional dosages, and on a 'sample' axis a missingness group over a
    container (the JAX package's ValueError). Then, per missingness group
    (or once): rank 0 takes the eigh, the T fits and the shared rotation
    (_mt_null), one broadcast replicates them; each rank scans its rows
    with no communication (a ResidentGenome's shard, shard_packed_rows,
    with the group's columns gathered a tile at a time; an in-core
    source's rank_range rows at the call's tile, cut to the group's
    columns on the rank only); one all-gather of the (T, 3, m_rank)
    statistics; float64 host p-values. On a 'sample' axis (_mt_tp_scan)
    the rotation is scattered by contraction-row blocks instead of
    broadcast, and each tile's rotation is summed over 'sample'."""
    from mixmogam_tpu_torch.models.emmax import _as_design, incore_budget_bytes
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    _default_dtype)
    from mixmogam_tpu_torch.models.source import (pack_for_mesh,
                                                  resolve_source,
                                                  should_stream)
    from mixmogam_tpu_torch.ops.scan import (normalize_rotate_tier,
                                             probe_for_source,
                                             resolve_precision)
    from mixmogam_tpu_torch.parallel import distributed as pd

    mesh, device = pd.mesh_entry(mesh, G, "emmax_multi_trait", device)
    Y = np.atleast_2d(np.asarray(Y, dtype=np.float64))
    T, n = Y.shape
    if dtype is None:
        dtype = _default_dtype(device)
    _refuse_fast(precision)
    rg = G if isinstance(G, ResidentGenome) else None
    G_src = resolve_source(G)
    M = G_src.shape[0]
    if rg is None:
        itemsize = torch.empty((), dtype=dtype).element_size()
        budget = (incore_budget_bytes(device) if stream_budget_bytes is None
                  else stream_budget_bytes)
        if budget is not None and should_stream(G_src, n, itemsize, budget):
            rg = pack_for_mesh(G_src, n, "multi-trait", device)
    rd, tier_name = None, "exact"
    if precision is not None:
        rb, tier_name = resolve_precision(
            precision, G=probe_for_source(rg, G_src), device=device)
        rd = normalize_rotate_tier(rb)
    _refuse_int8(rd, rg, G_src)
    if rg is not None and rg.n != n:
        raise ValueError(f"Y has {n} samples but the resident genome holds "
                         f"{rg.n}")
    sample_axis = mesh.shape[1] > 1
    if sample_axis and rg is not None and np.isnan(Y).any():
        # the JAX package's refusal: a group's columns are gathered from
        # whole byte rows, which a rank's byte block is not
        raise ValueError(
            "a missing-Y pattern group over a packed container gathers "
            "sample columns per tile and shards 'snp' only; use a "
            "('snp', 1) mesh")
    X0 = _as_design(np.ones((n, 1)) if X0 is None else X0, n)

    def scan(Yg, Kg, X0g, keep=None, idx=None, eig=None):
        """One multi-trait scan of the samples `keep` (None: all)."""
        ng = Yg.shape[1]
        all_cols = keep is None or keep.all()
        if sample_axis:
            ts = time.perf_counter()
            tg, rows = tile or _default_tile(ng, tile_budget), None
            if rg is None:
                lo, hi = pd.rank_range(M, mesh, tg)
                rows = np.asarray(G_src[lo:hi])
                if not all_cols:
                    rows = rows[:, keep]
                # an int8 tier takes the rows as int8, as below
                G8 = _refuse_int8(rd, None, rows)
                rows = rows if G8 is None else np.asarray(G8)
            h, nl = _mt_tp_scan(rows, rg, Yg, Kg, X0g, eig, rd, dtype,
                                device, mesh, M, tg, ngrids, llim, ulim, esp)
            nl["timings"]["scan"] = time.perf_counter() - ts
            return _mt_result(h[:, 0].copy(), h[:, 1].copy(), h[:, 2] > 0.5,
                              nl, ng - X0g.shape[1] - 1, tier_name,
                              nl["timings"])

        def null():
            return _flat_null(_mt_null(Yg, X0g, Kg, eig, rd, dtype, device,
                                       ngrids, llim, ulim, esp))

        nl = _unflat_null(pd.on_rank0(null, mesh))
        ts = time.perf_counter()
        if rg is not None:
            shard = pd.shard_packed_rows(rg, mesh, device=device)
            cols = (None if all_cols else torch.as_tensor(
                idx, dtype=torch.int64, device=device))
            tiles = _tiles_of(shard, None, None, shard.M, rg.tile, cols,
                              dtype, device)
            m = shard.M
        else:
            tg = tile or _default_tile(ng, tile_budget)
            lo, hi = pd.rank_range(M, mesh, tg)
            rows = np.asarray(G_src[lo:hi])
            if not all_cols:
                rows = rows[:, keep]
            m = rows.shape[0]
            # an int8 tier takes the rows as int8 (the whole source passed
            # _refuse_int8 above)
            G8 = _refuse_int8(rd, None, rows)
            tiles = _tiles_of(None, _incore_tensor(rows, G8, dtype, device),
                              None, m, tg, None, dtype, device)
        fs, betas, masks = _mt_scan(tiles, Yg.shape[0], m, nl, dtype)
        h = pd.gathered_rows(torch.from_numpy(np.stack(
            [fs, betas, masks.astype(np.float64)], axis=1)), mesh, M)
        nl["timings"]["scan"] = time.perf_counter() - ts
        return _mt_result(h[:, 0].copy(), h[:, 1].copy(), h[:, 2] > 0.5, nl,
                          ng - X0g.shape[1] - 1, tier_name, nl["timings"])

    if np.isnan(Y).any():
        return _multi_trait_grouped(M, Y, K, X0, scan)
    return scan(Y, K, X0, eig=eig_k)


def _mt_tp_scan(rows, rg, Y, K, X0, eig_k, rd, dtype, device, mesh, M: int,
                tile: int, ngrids, llim, ulim, esp):
    """((T, 3, M) gathered [f, beta, mask], _mt_null's dict) of one
    multi-trait scan on a mesh with a 'sample' axis: rank 0's _mt_null,
    the traits' constants broadcast and each rank sent only its block of
    the shared rotation's contraction rows (distributed.py::
    on_rank0_rows); each tile's block of sample columns (distributed.py::
    tp_blocks: rows, the rank's host rows already cut to the group's
    samples, or rg, the container) rotated, the partial products summed
    over 'sample' (ops/scan.py::apply_rotation_psum; the int8 planes in
    integers before the recombine), the design mask from sums over
    'sample' (outside_design_psum), K3 once a trait on the whole rotated
    rows (_scan_tile_multitrait), and one all-gather over 'snp'."""
    from mixmogam_tpu_torch.ops.rotate import rotation_rows
    from mixmogam_tpu_torch.ops.scan import (apply_rotation_psum,
                                             outside_design_psum)
    from mixmogam_tpu_torch.parallel import distributed as pd

    n = Y.shape[1]
    n_pad, lo, hi = pd.tp_columns(n, mesh, packed=rg is not None)

    def null():
        nl = _mt_null(Y, X0, K, eig_k, rd, dtype, device, ngrids, llim,
                      ulim, esp)
        rot = nl.pop("rot")
        p = _flat_null(nl)
        p["w_scale"], p["tier"] = rot.w_scale, rot.tier
        return p, rot.W

    p, Wb = pd.on_rank0_rows(null, mesh, n_pad, lo, hi)
    nl = _unflat_null(p)
    W = rotation_rows(Wb, p["w_scale"], dtype, p["tier"])
    del Wb
    X0b, X0pb = (pd.block_rows(nl[k], lo, hi) for k in ("X0d", "X0p"))
    outs = []
    for Gb in pd.tp_blocks(rows, rg, rg.has_missing if rg is not None
                           else None, mesh, device, dtype, tile, lo, hi):
        Xs = apply_rotation_psum(Gb, W, W.w_scale, W.dt, mesh, n)
        keep = outside_design_psum(Gb.to(dtype), X0b, X0pb, mesh)
        f, b, mk = _scan_tile_multitrait(Xs, nl["nulls"], keep)
        outs.append(torch.stack((f, b, mk.to(f.dtype)), dim=1))
    out = pd.row_block(outs, (Y.shape[0], 3), dtype, device)
    return pd.gathered_rows(out, mesh, M), nl


def _flat_null(nl: dict) -> dict:
    """_mt_null's dict as broadcast_from_rank0's payload: each trait's
    RotatedNull and the SharedRotation (when it holds one) field by
    field."""
    from mixmogam_tpu_torch.parallel.distributed import fields_of, null_fields

    out = {k: v for k, v in nl.items() if k not in ("nulls", "rot")}
    out["T"] = len(nl["nulls"])
    for t, r in enumerate(nl["nulls"]):
        out.update(null_fields(r, f"null{t}_"))
    if "rot" in nl:
        out.update(fields_of(nl["rot"], "rot_"))
    return out


def _unflat_null(p: dict) -> dict:
    """_flat_null's payload back as _mt_null's dict."""
    from mixmogam_tpu_torch.parallel.distributed import (from_fields,
                                                         null_from_fields)

    out = {k: p[k] for k in ("deltas", "h2s", "X0d", "X0p", "timings")}
    out["nulls"] = [null_from_fields(p, f"null{t}_") for t in range(p["T"])]
    if "rot_W" in p:
        out["rot"] = from_fields(SharedRotation, p, "rot_")
    return out


def _tiles_of(rg, G_dev, G_host, M: int, tile: int, cols, dtype, device):
    """(s, e, rows [s, e)) tile by tile, the rows as the scan takes them:
    int8 where fully observed, else mean-imputed in dtype. Three sources: a
    ResidentGenome (unpacked on its device; over the gathered columns of a
    missingness group, so the means are the subset's), the in-core G_dev,
    or a host source G_host streamed a tile at a time (models/source.py:
    host_tile in prefetch_iter's thread, then ship_tile)."""
    from mixmogam_tpu_torch.models.resident import _tile_from_packed_cols
    from mixmogam_tpu_torch.models.source import (host_tile, prefetch_iter,
                                                  ship_tile)
    from mixmogam_tpu_torch.models.streaming import _impute_tile
    from mixmogam_tpu_torch.ops.pack2 import unpack_2bit_device

    starts = range(0, M, tile)
    if G_host is not None:
        n = G_host.shape[1]
        np_dt = torch.empty((), dtype=dtype).numpy().dtype
        for s, chunk in prefetch_iter(starts, lambda s: host_tile(
                G_host, s, min(s + tile, M), min(s + tile, M) - s, n,
                np_dt)):
            yield s, s + chunk.shape[0], ship_tile(chunk, dtype, device)
        return
    for s in starts:
        e = min(s + tile, M)
        if rg is None:
            yield s, e, G_dev[s:e]
            continue
        Gt = (unpack_2bit_device(rg.packed[s:e], rg.n) if cols is None
              else _tile_from_packed_cols(rg.packed, s, e - s, rg.n, cols))
        yield s, e, _impute_tile(Gt, dtype) if rg.has_missing else Gt


def _multi_trait_grouped(M: int, Y, K, X0, scan_group
                         ) -> Dict[str, np.ndarray]:
    """Traits grouped by their missingness pattern: each group is one
    sample subset with its K sub-block, its own eigh and one multi-trait
    scan, scan_group(Y_g, K_g, X0_g, keep, idx) (keep: the group's sample
    mask, idx: its columns). A SNP that is degenerate on a subset comes out
    masked (p = 1)."""
    from mixmogam_tpu_torch.models.emmax import _as_design

    T, n = Y.shape
    X0 = _as_design(np.ones((n, 1)) if X0 is None else X0, n)
    q = X0.shape[1]
    if K is None:
        raise ValueError("per-trait missing phenotypes need an explicit "
                         "(n, n) kinship matrix (eig_k cannot be shared "
                         "across different sample subsets)")
    K = np.asarray(K, dtype=np.float64)
    groups: Dict[bytes, List[int]] = {}
    obs = ~np.isnan(Y)
    for t in range(T):
        groups.setdefault(obs[t].tobytes(), []).append(t)
    ps = np.ones((T, M))
    fs = np.zeros((T, M))
    betas = np.zeros((T, M))
    masks = np.zeros((T, M), dtype=bool)
    deltas = np.empty(T)
    h2s = np.empty(T)
    dofs = np.empty(T, dtype=np.int64)
    timings: Dict[str, float] = {}
    for key, tids in groups.items():
        keep = np.frombuffer(key, dtype=bool)
        ns = int(keep.sum())
        if ns < q + 3:
            raise ValueError(
                f"traits {tids} have only {ns} observed samples "
                f"(need at least q+3 = {q + 3})")
        idx = np.flatnonzero(keep)
        sub = scan_group(Y[np.ix_(tids, idx)], K[np.ix_(idx, idx)],
                         X0[keep], keep, idx)
        for out, k in ((ps, "ps"), (fs, "f_stats"), (betas, "betas"),
                       (masks, "mask"), (deltas, "deltas"),
                       (h2s, "pseudo_heritabilities"), (dofs, "dof")):
            out[tids] = sub[k]
        for k, v in sub["timings_s"].items():
            timings[k] = timings.get(k, 0.0) + v
        tier = sub["precision_tier"]
    return {"ps": ps, "f_stats": fs, "betas": betas, "mask": masks,
            "deltas": deltas, "pseudo_heritabilities": h2s,
            "dof": int(dofs[0]) if len(groups) == 1 else dofs,
            "precision_tier": tier, "timings_s": timings}
