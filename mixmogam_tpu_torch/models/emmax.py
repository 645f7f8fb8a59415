"""EMMAX entry point (counterpart of mixmogam_tpu/models/emmax.py:
_as_dosage, _as_design, emmax).

Ported routes: the resident route (a ResidentGenome, or a big int8
source auto-packed onto the card) and the in-core route (the whole
genome on the scan's device, exact tier). An int8 or bf16 tier on in-core
integer dosages packs them and takes the resident route, where kernel K2
(int8) or K5 (bf16, which also takes missing genotypes) reads packed
rows. Fractional dosages at a bf16 tier wait for a float-tile loader
(ROADMAP Queue 1); streaming (stream=True, checkpoint_dir=) and meshes
wait for ROADMAP slice 3.
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


def emmax(G, y, K=None, X0=None, eig_k: Optional[Tuple] = None,
          ngrids: int = 100, llim: float = -10.0, ulim: float = 10.0,
          esp: float = 1e-6, with_betas: bool = True, dtype=None,
          tile: int = 16_384, host_eigh: Optional[bool] = None,
          rotate_in_bf16=False, matmul_precision: str = None,
          precision: str = None, stream: Optional[bool] = None,
          stream_budget_bytes: Optional[int] = None,
          checkpoint_dir: Optional[str] = None, rescore_top: int = 0,
          resident: Optional[bool] = None, mesh=None,
          device=None) -> dict:
    """EMMAX scan with the JAX package's emmax() arguments and return
    dict. G: GenotypeData, (M, n) dosages or a ResidentGenome; y: (n,);
    K: (n, n) kinship or eig_k=(phi, U); X0: (n, q) null design.

    device: where the scan runs: the card by default (without one the
    call raises), 'cpu' on request. A ResidentGenome scans on its own
    device. host_eigh: None takes the card's float64 eigh on the card and
    host LAPACK on the CPU; True asks for host LAPACK. dtype (a torch dtype)
    defaults to float32 on the card and float64 on the CPU. precision:
    'exact', 'bf16' / 'bf16x2' / 'bf16x3' (and the 'c' spellings) or
    'int8x2' / 'int8x3' / 'int8x4'; 'auto' and 'fast' resolve to
    'exact'."""
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
    from mixmogam_tpu_torch.ops.scan import (build_rotated_null,
                                             emmax_scan_stats,
                                             normalize_rotate_tier,
                                             resolve_precision)

    if mesh is not None:
        raise NotImplementedError("mesh= (sharded scans) is not ported "
                                  "yet: ROADMAP slice 3 item 16")
    if stream or checkpoint_dir is not None:
        raise NotImplementedError("streamed scans (stream=True, "
                                  "checkpoint_dir=) are not ported yet: "
                                  "ROADMAP slice 3 item 15")
    if matmul_precision:
        raise NotImplementedError("the 'high' matmul tier is not ported "
                                  "yet: ROADMAP Queue 2")
    kw = dict(ngrids=ngrids, llim=llim, ulim=ulim, esp=esp,
              with_betas=with_betas, precision=precision,
              rotate_in_bf16=rotate_in_bf16, rescore_top=rescore_top)
    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    G_src = resolve_source(G)
    if isinstance(G_src, ResidentGenome):
        return emmax_resident(G_src, y, K=K, X0=X0, eig_k=eig_k,
                              dtype=dtype, **kw)
    device = resolve_device(device)
    if dtype is None:
        dtype = _default_dtype(device)
    itemsize = torch.empty((), dtype=dtype).element_size()
    budget = (incore_budget_bytes(device) if stream_budget_bytes is None
              else stream_budget_bytes)
    over_incore = (budget is not None
                   and should_stream(G_src, n, itemsize, budget))
    int8_src = np.dtype(G_src.dtype) == np.int8
    if resident is not False and (resident is True or (
            over_incore and int8_src and G_src.shape[0] * ((n + 3) // 4)
            <= resident_budget_bytes(device))):
        rg = ResidentGenome.from_source(G_src, device=device)
        return emmax_resident(rg, y, K=K, X0=X0, eig_k=eig_k, dtype=dtype,
                              **kw)
    if over_incore:
        raise NotImplementedError(
            "this source exceeds the card's in-core budget and does not "
            "fit 2-bit packed; streaming is ROADMAP slice 3 item 15")

    rb = rotate_in_bf16
    if precision is not None:
        if rotate_in_bf16:
            raise ValueError("pass either precision= or the legacy "
                             "rotate_in_bf16 kwarg, not both")
        rb, _ = resolve_precision(precision)
    rd = normalize_rotate_tier(rb)
    if rd is not None:
        # int8 and bf16 tiers run on packed rows (kernels K2 / K5): pack
        # the integer dosages (-1 / NaN missing; K5 imputes per row) and
        # take the resident route
        G8 = as_int8_dosage(G)
        if rd.startswith("int8") and (G8 is None
                                      or (np.asarray(G8) < 0).any()):
            raise ValueError(
                f"tier {precision or rotate_in_bf16!r} requires "
                "integer dosages (the digit-plane products take int8 "
                "genotypes; mean-imputed fractional dosages would be "
                "silently altered). Use the exact tier for imputed "
                "dosages.")
        if G8 is None:
            raise NotImplementedError(
                f"tier {precision or rotate_in_bf16!r} on fractional "
                "dosages needs the float-tile bf16 loader, which is "
                "not ported yet (ROADMAP Queue 1 item 17); use the "
                "exact tier")
        rg = ResidentGenome.from_source(G8, tile=tile, device=device)
        return emmax_resident(rg, y, K=K, X0=X0, eig_k=eig_k, dtype=dtype,
                              **kw)
    G_raw = G.matrix if hasattr(G, "matrix") else np.asarray(G)
    if (isinstance(G_raw, np.ndarray) and G_raw.dtype == np.int8
            and not (G_raw < 0).any()):
        Gf = G_raw
    else:
        Gf = _as_dosage(G, np.float64)
    if X0 is None:
        X0 = np.ones((n, 1))
    X0 = _as_design(X0, n)
    null = fit_null_model(y, X0, K=K, eig_k=eig_k, ngrids=ngrids,
                          llim=llim, ulim=ulim,
                          refine_iters=esp_to_refine_iters(
                              esp, ngrids, llim, ulim),
                          host_eigh=host_eigh,
                          eigh_dtype=(np.float32 if str(precision) == "fast"
                                      else None),
                          device=device, dtype=dtype)
    rot = build_rotated_null(null)
    # fully observed int8 dosages go to the device as int8; float dosages
    # in the compute dtype (the footprint should_stream assumed)
    G_dev = torch.from_numpy(np.ascontiguousarray(Gf))
    if G_dev.dtype != torch.int8:
        G_dev = G_dev.to(dtype)
    G_dev = G_dev.to(device)
    outs = [emmax_scan_stats(G_dev[s:s + tile].to(dtype), rot)
            for s in range(0, G_dev.shape[0], tile)]
    h = torch.cat(outs, dim=1).cpu().double().numpy()
    return finalize_scan(
        Gf, null, dtype, h[0].copy(), h[3] > 0.5,
        betas=h[1].copy() if with_betas else None,
        var_perc=h[2].copy() if with_betas else None,
        with_betas=with_betas, dof=int(rot.dof),
        tier_name="exact" if precision is not None else None)
