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
    (fully observed integer dosages only) or 'bf16' / 'bf16x2' / 'bf16x3'
    for the shared rotation; 'fast'
    raises (no rescore pass). tile: SNP rows a tile (None: the resident
    genome's tile, else as many rows as keep one rotated tile under
    tile_budget values, at most 16,384).

    Returns ps / f_stats / betas / mask of shape (T, M), per-trait deltas
    and pseudo_heritabilities, 'dof' (an int, or a (T,) array when the
    missingness groups differ), 'precision_tier', and 'timings_s' (host
    seconds of the eigh, the T REML fits, the scan and the p-values)."""
    from mixmogam_tpu_torch.models.emmax import (_as_design, _as_dosage,
                                                 incore_budget_bytes)
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    _default_dtype,
                                                    resident_and_device,
                                                    resident_budget_bytes)
    from mixmogam_tpu_torch.models.source import (as_int8_dosage,
                                                  resolve_source,
                                                  should_stream)
    from mixmogam_tpu_torch.ops.scan import (normalize_rotate_tier,
                                             probe_for_source,
                                             resolve_precision)

    if mesh is not None:
        raise NotImplementedError("mesh= (the SNP-sharded multi-trait scan) "
                                  "is not ported yet: ROADMAP Queue 1 item "
                                  "16c")
    Y = np.atleast_2d(np.asarray(Y, dtype=np.float64))
    T, n = Y.shape
    rg, device = resident_and_device(G, device)
    if dtype is None:
        dtype = _default_dtype(device)
    # ---- refusals before any eigh or REML fit ----
    rd, tier_name = None, "exact"
    if str(precision) == "fast":
        raise ValueError(
            "multi-trait has no rescore pass; pick an explicit tier "
            "('int8x3' / 'bf16x3' are fp32-grade) or leave exact")
    if precision is not None:
        resolve_precision(precision)      # unknown names and 'high' raise
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
    G8 = None
    if rd is not None and rd.startswith("int8"):
        if rg is not None:
            if rg.has_missing:
                raise ValueError(
                    "int8 digit-plane tiers need fully-observed dosages "
                    "(this container has missing genotypes)")
        else:
            G8 = as_int8_dosage(G)
            if G8 is None or (np.asarray(G8) < 0).any():
                raise ValueError(
                    "int8 digit-plane tiers need exact integer dosages, "
                    "fully observed; these are fractional or missing (mean-"
                    "imputed). Use the exact tier")
    if rg is not None:
        if _keep_cols is not None:
            if len(_keep_cols) != n:
                raise ValueError("_keep_cols must list one container "
                                 "column per Y column")
        elif rg.n != n:
            raise ValueError(f"Y has {n} samples but the resident genome "
                             f"holds {rg.n}")
    if np.isnan(Y).any():
        return _multi_trait_grouped(
            rg if rg is not None else G_src, Y, K=K, X0=X0, ngrids=ngrids,
            llim=llim, ulim=ulim, esp=esp, dtype=dtype, tile=tile,
            tile_budget=tile_budget, stream_budget_bytes=stream_budget_bytes,
            precision=precision, device=device)
    X0 = _as_design(np.ones((n, 1)) if X0 is None else X0, n)
    q = X0.shape[1]

    # ---- one eigh, T float64 REML fits where the data live ----
    from mixmogam_tpu_torch.ops.eigen import eigen_k_on
    from mixmogam_tpu_torch.ops.reml import esp_to_refine_iters
    from mixmogam_tpu_torch.ops.scan import outside_design, project_design
    from mixmogam_tpu_torch.ops.xreml import explicit_reml

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
    X0d, X0p = X0d.to(dtype), X0p.to(dtype)
    dof = n - q - 1

    # ---- the scan: a tile rotated once, then K3 once per trait ----
    ts = time.perf_counter()
    cols = None
    if rg is not None:
        tile = rg.tile
        if _keep_cols is not None:
            cols = torch.as_tensor(np.asarray(_keep_cols), dtype=torch.int64,
                                   device=device)
        G_dev = None
    elif streamed:
        tile = tile or max(64, min(16_384, tile_budget // max(n, 1)))
        G_dev = None
    else:
        tile = tile or max(64, min(16_384, tile_budget // max(n, 1)))
        if G8 is not None:
            Gh = np.asarray(G8)
        else:
            G_raw = G.matrix if hasattr(G, "matrix") else np.asarray(G)
            Gh = (G_raw if (isinstance(G_raw, np.ndarray)
                            and G_raw.dtype == np.int8
                            and not (G_raw < 0).any())
                  else _as_dosage(G, np.float64))
        G_dev = torch.from_numpy(np.ascontiguousarray(Gh))
        G_dev = (G_dev if G_dev.dtype == torch.int8
                 else G_dev.to(dtype)).to(device)
    fs = np.empty((T, M))
    betas = np.empty((T, M))
    masks = np.empty((T, M), dtype=bool)
    pending = []

    def drain(s, e, out):
        h = out.cpu().double().numpy()
        fs[:, s:e], betas[:, s:e], masks[:, s:e] = h[0], h[1], h[2] > 0.5

    for s, e, Gt in _tiles_of(rg, G_dev, G_src if streamed else None, M,
                              tile, cols, dtype, device):
        keep = outside_design(Gt.to(dtype), X0d, X0p)
        f, b, mk = _scan_tile_multitrait(rotate_tile(Gt, rot), nulls, keep)
        pending.append((s, e, torch.stack((f, b, mk.to(f.dtype)))))
        if len(pending) > _PENDING:
            drain(*pending.pop(0))
    for item in pending:
        drain(*item)
    timings["scan"] = time.perf_counter() - ts
    ts = time.perf_counter()
    from mixmogam_tpu_torch.ops.stats import f_sf_host

    ps = np.where(masks, f_sf_host(fs, 1.0, dof), 1.0)
    timings["p_values"] = time.perf_counter() - ts
    return {"ps": ps, "f_stats": fs, "betas": betas, "mask": masks,
            "deltas": deltas, "pseudo_heritabilities": h2s, "dof": dof,
            "precision_tier": tier_name, "timings_s": timings}


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


def _multi_trait_grouped(G, Y, K=None, X0=None, ngrids: int = 100,
                         llim: float = -10.0, ulim: float = 10.0,
                         esp: float = 1e-6, dtype=None, tile=None,
                         tile_budget: int = 1 << 28,
                         stream_budget_bytes=None, precision=None,
                         device=None) -> Dict[str, np.ndarray]:
    """Traits grouped by their missingness pattern: each group is one
    sample subset with its K sub-block, its own eigh and one multi-trait
    scan. A ResidentGenome's group gathers its sample columns on the
    device a tile at a time (_keep_cols); an in-core source is cut to the
    subset's columns. A SNP that is degenerate on a subset comes out
    masked (p = 1)."""
    from mixmogam_tpu_torch.models.emmax import _as_design
    from mixmogam_tpu_torch.models.resident import ResidentGenome

    T, n = Y.shape
    rg = G if isinstance(G, ResidentGenome) else None
    M = G.shape[0]
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
    kw = dict(ngrids=ngrids, llim=llim, ulim=ulim, esp=esp, dtype=dtype,
              tile=tile, tile_budget=tile_budget,
              stream_budget_bytes=stream_budget_bytes, precision=precision,
              device=device)
    for key, tids in groups.items():
        keep = np.frombuffer(key, dtype=bool)
        ns = int(keep.sum())
        if ns < q + 3:
            raise ValueError(
                f"traits {tids} have only {ns} observed samples "
                f"(need at least q+3 = {q + 3})")
        idx = np.flatnonzero(keep)
        Yg, Kg = Y[np.ix_(tids, idx)], K[np.ix_(idx, idx)]
        if rg is not None:
            sub = emmax_multi_trait(rg, Yg, K=Kg, X0=X0[keep],
                                    _keep_cols=None if keep.all() else idx,
                                    **kw)
        else:
            sub = emmax_multi_trait(
                np.ascontiguousarray(np.asarray(G)[:, keep]), Yg, K=Kg,
                X0=X0[keep], **kw)
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
