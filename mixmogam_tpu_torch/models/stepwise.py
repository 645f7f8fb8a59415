"""Stepwise MLMM: forward/backward multi-locus mixed model (counterpart of
mixmogam_tpu/models/stepwise.py: _log_binom, _rot_null_from_delta,
emmax_step_wise; Segura et al. 2012).

A host loop over device scans. Each forward step re-fits the null with the
current cofactors in eigh(K)'s basis (REML and ML, ops/xreml.py, float64 on
the device: no new eigh), scans the whole genome, and adds the argmin-p
SNP as a cofactor. Every recorded model re-tests each of its cofactors by
a one-row scan. Backward steps drop the least significant cofactor; BIC,
eBIC, mBIC and the multiple-Bonferroni rule select over the whole path.

The whole-genome scans take one of four routes:
- stored: the genotypes are rotated once, G_rot = impute(G) @ U, and kept
  on the device (models/resident.py::rotate_resident_to_device from a
  ResidentGenome, models/streaming.py::rotate_streamed_to_device from a
  host source); each scan is one launch of kernel K3 over all rows
  (ops/scan.py::emmax_scan_prerotated);
- over the rotation budget, from a ResidentGenome: each step scans the
  packed rows at the exact tier (models/resident.py::emmax_scan_packed:
  unpack, fp32 GEMM, K3 a tile);
- over the budget, from a host source: int8 or float tiles go up each step;
- K = None: the identity kinship (the reference's lm_step_wise): phi = 1,
  no rotation, the imputed dosages scanned as they are.

U is (I - P_X0) U (ops/scan.py::project_design), with X0 the base design:
the span of X0 leaves the rotated rows, which keeps a float32 scan exact
under a singular K with delta small (VanRaden's K along the intercept).
X0 stays inside every step's design, so the F-tests and the re-fits are
unchanged; rows inside X0's span are masked as the exact tier masks them.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["emmax_step_wise"]

#: share of the card's memory the stored rotation may take (10.7 GB at
#: 262,144 SNPs x 10,240 samples in float32); the reference's fixed 8 GiB
#: was sized for a TPU's memory
ROT_MEMORY_FRACTION = 0.5


def stored_budget_bytes(device) -> Optional[int]:
    """Budget of the stored rotation on `device`, from the card's own
    memory; None (no device budget) on the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    total = torch.cuda.get_device_properties(device).total_memory
    return int(total * ROT_MEMORY_FRACTION)


def _log_binom(m: int, k: int) -> float:
    import scipy.special

    return float(scipy.special.gammaln(m + 1) - scipy.special.gammaln(k + 1)
                 - scipy.special.gammaln(m - k + 1))


def _rot_null_from_delta(phi, delta: float, y_rot, X_rot, dtype, U=None,
                         design=None):
    """The RotatedNull of one design at a given delta, built in the
    eigenbasis: y_rot (n,) and X_rot (n, q) are float64 on phi's device,
    whitened by the scan's own sd = 1/sqrt(phi + delta) (phi in dtype) in
    float64; Q0, y_res and rss0 are cast to dtype. U (the exact tier's
    rotation) and design (its (X0, X0p)) are for scans of unrotated rows.
    Q0 keeps its true width: the reference's pad_to served one XLA
    compile."""
    from mixmogam_tpu_torch.ops.eigen import orthonormal_basis
    from mixmogam_tpu_torch.ops.scan import RotatedNull

    sd = 1.0 / torch.sqrt(phi + delta)
    sd64 = sd.double()
    y_star = y_rot * sd64
    Q0 = orthonormal_basis(X_rot * sd64[:, None])
    y_res = y_star - Q0 @ (Q0.T @ y_star)
    n, q = X_rot.shape
    X0, X0p = design if design is not None else (None, None)
    return RotatedNull(sd=sd, Q0=Q0.to(dtype), y_res=y_res.to(dtype),
                       rss0=(y_res @ y_res).to(dtype),
                       dof=torch.tensor(n - q - 1, dtype=dtype,
                                        device=sd.device),
                       U=U, X0=X0, X0p=X0p)


def _stats_host(out: torch.Tensor, M: int):
    h = out[:, :M].detach().cpu().double().numpy()
    return h[0], h[3] > 0.5


def emmax_step_wise(G, y, K=None, max_steps: int = 10,
                    X0: Optional[np.ndarray] = None, alpha: float = 0.05,
                    ngrids: int = 100, llim: float = -10.0,
                    ulim: float = 10.0, esp: float = 1e-6,
                    dtype=None, tile: int = 16_384, eig_k=None,
                    save_scans: bool = False, early_stop: bool = False,
                    rot_budget_bytes: Optional[int] = None,
                    mesh=None, device=None) -> Dict:
    """Returns {'steps': [...], 'selected': {criterion: {...}},
    'bonf_threshold': float, 'timings_s': {...}}: the JAX package's schema
    (and the oracle's, oracle.mlmm_step_wise) plus host seconds for the
    rotation and each forward step's scan.

    G: a ResidentGenome (scanned on its own device), or a GenotypeData or
    (M, n) array (int8 with -1 missing, or float with NaN missing and
    fractional dosages) on `device`: the card by default (without one the
    call raises), 'cpu' on request. dtype: float32 on the card, float64
    on the CPU by default. early_stop=True ends the forward phase once the
    scan's min p exceeds the Bonferroni threshold; by default all
    max_steps run and the criteria choose. rot_budget_bytes: the stored
    rotation's device budget (None: half the card's memory; no limit on
    the CPU); over it the scans rotate every step."""
    from mixmogam_tpu_torch.models.emmax import _as_design
    from mixmogam_tpu_torch.models.resident import (
        ResidentGenome, _default_dtype, _float_tiles, emmax_scan_packed,
        rotate_resident_to_device)
    from mixmogam_tpu_torch.models.source import as_int8_dosage
    from mixmogam_tpu_torch.models.streaming import (
        _host_float_tile, _impute_tile, host_tiles, rotate_streamed_to_device)
    from mixmogam_tpu_torch.ops import resolve_device
    from mixmogam_tpu_torch.ops.eigen import eigen_k_on
    from mixmogam_tpu_torch.ops.reml import esp_to_refine_iters
    from mixmogam_tpu_torch.ops.scan import (emmax_scan_prerotated,
                                             emmax_scan_stats,
                                             outside_design, project_design)
    from mixmogam_tpu_torch.ops.stats import f_sf_host
    from mixmogam_tpu_torch.ops.xreml import explicit_reml

    if mesh is not None:
        raise NotImplementedError("mesh= (the sharded stepwise campaign) is "
                                  "not ported yet: ROADMAP Queue 1 item 16")
    refine_iters = esp_to_refine_iters(esp, ngrids, llim, ulim)
    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    rg = G if isinstance(G, ResidentGenome) else None
    if rg is not None and rg.n != n:
        # the packed scan decodes n columns per row: a mismatched container
        # would scan a truncated sample subset
        raise ValueError(f"y has {n} samples but the resident genome "
                         f"holds {rg.n}")
    device = rg.device if rg is not None else resolve_device(device)
    if dtype is None:
        dtype = _default_dtype(device)
    src = None
    if rg is None:
        src = as_int8_dosage(G)
        if src is None:       # fractional dosages: float tiles, NaN missing
            src = np.asarray(G.matrix if hasattr(G, "matrix") else G,
                             dtype=np.float64)
    M = rg.M if rg is not None else src.shape[0]
    itemsize = torch.empty((), dtype=dtype).element_size()
    budget = (stored_budget_bytes(device) if rot_budget_bytes is None
              else rot_budget_bytes)
    use_stored = budget is None or M * n * itemsize <= budget
    X0 = _as_design(np.ones((n, 1)) if X0 is None else X0, n)
    X0_64 = torch.as_tensor(X0, dtype=torch.float64, device=device)
    y_64 = torch.as_tensor(y, dtype=torch.float64, device=device)
    identity_k = K is None and eig_k is None
    if identity_k:
        phi = torch.ones(n, dtype=dtype, device=device)
        Up = design = None
        y_rot, X0_rot = y_64, X0_64
    else:
        phi, U = (eigen_k_on(np.asarray(K, np.float64), device)
                  if eig_k is None else eig_k)
        phi = torch.as_tensor(phi).to(device=device, dtype=dtype)
        U = torch.as_tensor(U).to(device=device, dtype=dtype)
        U64 = U.double()
        y_rot, X0_rot = U64.T @ y_64, U64.T @ X0_64
        del U64
        Up, X0d, X0p = project_design(U, X0_64)
        design = (X0d, X0p)
        del U
    phi64 = phi.double()

    t0 = time.perf_counter()
    G_rot = keep = None
    if use_stored:
        if rg is not None:
            G_rot, keep = rotate_resident_to_device(rg, Up, dtype, design)
        else:
            G_rot, keep = rotate_streamed_to_device(src, Up, dtype, tile,
                                                    design, device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    t_rotate = time.perf_counter() - t0 if use_stored else 0.0

    def raw_row(c: int) -> torch.Tensor:
        """SNP c's imputed dosages, (1, n) in dtype on the device."""
        if rg is not None:
            return _impute_tile(torch.from_numpy(rg[np.array([c])]).to(
                device), dtype)
        if src.dtype == np.int8:
            return _impute_tile(torch.from_numpy(np.ascontiguousarray(
                src[c:c + 1])).to(device), dtype)
        np_dt = np.float64 if dtype == torch.float64 else np.float32
        return torch.from_numpy(_host_float_tile(src[c:c + 1],
                                                 np_dt)).to(device)

    cols: Dict[int, tuple] = {}

    def rot_col(c: int):
        """(SNP c's rotated row (n,) in float64, whether it lies outside
        X0's span), from its raw row on every route: the designs, and so
        the re-fits and re-tests, are the same whether the genome was
        rotated once or is rotated at each step."""
        if c not in cols:
            t = raw_row(c)
            x = t.double() if Up is None else t.double() @ Up.double()
            cols[c] = (x[0], True if design is None
                       else bool(outside_design(t, *design)[0]))
        return cols[c]

    def design_of(cof_now: List[int]) -> torch.Tensor:
        return torch.cat([X0_rot] + [rot_col(c)[0][:, None]
                                     for c in cof_now], dim=1)

    bonf = alpha / M
    steps: List[Dict] = []
    cof: List[int] = []
    scan_s: List[float] = []

    def model_stats(cof_now: List[int]):
        X_rot = design_of(cof_now)
        kw = dict(ngrids=ngrids, llim=llim, ulim=ulim,
                  refine_iters=refine_iters)
        r = explicit_reml(phi64, y_rot, X_rot, reml=True, **kw)
        m = explicit_reml(phi64, y_rot, X_rot, reml=False, **kw)
        k = len(cof_now)
        ll_ml = float(m["ll"])
        bic = -2.0 * ll_ml + k * np.log(n)
        ebic = bic + 2.0 * _log_binom(M, k)
        mbic = (-2.0 * ll_ml + k * np.log(n)
                + 2.0 * k * np.log(max(M / 2.2 - 1.0, 1.0)))
        # re-test each cofactor by dropping it (GLS F at this step's delta)
        cof_ps = np.ones(k)
        for i, c in enumerate(cof_now):
            rotm = _rot_null_from_delta(
                phi, float(r["delta"]), y_rot,
                design_of([o for o in cof_now if o != c]), dtype)
            xr, ok = rot_col(c)
            f, mask = _stats_host(emmax_scan_prerotated(
                xr.to(dtype)[None, :], rotm), 1)
            if ok and mask[0]:
                cof_ps[i] = float(f_sf_host(f, 1.0, float(rotm.dof))[0])
        return r, X_rot, {
            "cofactor_ps": cof_ps, "bic": bic, "ebic": ebic, "mbic": mbic,
            "ll_ml": ll_ml,
            "mbonf_ok": bool(np.all(cof_ps < bonf)) if cof_now else True,
        }

    def record(cof_now: List[int], phase: str):
        r, X_rot, stats = model_stats(cof_now)
        step = {"phase": phase, "cofactors": list(cof_now),
                "delta": float(r["delta"]),
                "pseudo_heritability": float(r["pseudo_heritability"]),
                **stats}
        return step, r, X_rot

    def full_scan(r, X_rot):
        delta = float(r["delta"])
        if G_rot is not None:
            rot = _rot_null_from_delta(phi, delta, y_rot, X_rot, dtype)
            return rot, _stats_host(emmax_scan_prerotated(G_rot, rot, keep),
                                    M)
        rot = _rot_null_from_delta(phi, delta, y_rot, X_rot, dtype, U=Up,
                                   design=design)
        if rg is not None and not identity_k:
            # the packed rows at the exact tier: unpack, fp32 GEMM, K3
            out = emmax_scan_packed(rg.packed, rot, n, rg.tile,
                                    impute=rg.has_missing)
            return rot, _stats_host(out, M)
        tiles = (_float_tiles(rg, dtype) if rg is not None
                 else host_tiles(src, dtype, device, tile))
        scan = emmax_scan_prerotated if identity_k else emmax_scan_stats
        return rot, _stats_host(torch.cat([scan(t, rot) for t in tiles],
                                          dim=1), M)

    for _ in range(max_steps):
        step, r, X_rot = record(cof, "forward")
        t1 = time.perf_counter()
        rot, (f_stats, mask) = full_scan(r, X_rot)
        ps = np.where(mask, f_sf_host(f_stats, 1.0, float(rot.dof)), 1.0)
        scan_s.append(time.perf_counter() - t1)
        if cof:
            ps[np.asarray(cof, dtype=int)] = 1.1      # never re-select
        jmin = int(np.argmin(ps))
        step["min_p"] = float(ps[jmin])
        step["min_p_snp"] = jmin
        if save_scans:
            step["scan_ps"] = ps
        steps.append(step)
        if early_stop and step["min_p"] > bonf:
            # the reference's stop rule: no genome-wide significant SNP
            # left to add
            stopped_early = True
            break
        cof = cof + [jmin]
    else:
        stopped_early = False

    if not stopped_early:
        # the model WITH the last added cofactor (after an early stop,
        # `cof` is the step just recorded)
        step, _, _ = record(cof, "forward")
        step["min_p"] = np.nan
        step["min_p_snp"] = -1
        steps.append(step)

    while cof:
        worst = int(np.argmax(steps[-1]["cofactor_ps"]))
        cof = [c for i, c in enumerate(cof) if i != worst]
        step, _, _ = record(cof, "backward")
        step["min_p"] = np.nan
        step["min_p_snp"] = -1
        steps.append(step)

    sel = {}
    for c in ("bic", "ebic", "mbic"):
        j = int(np.argmin([s[c] for s in steps]))
        sel[c] = {"step": j, "cofactors": steps[j]["cofactors"]}
    ok = [i for i, s in enumerate(steps) if s["mbonf_ok"]]
    jm = max(ok, key=lambda i: (len(steps[i]["cofactors"]), -i)) if ok else 0
    sel["mbonf"] = {"step": jm, "cofactors": steps[jm]["cofactors"]}
    return {"steps": steps, "selected": sel, "bonf_threshold": bonf,
            "timings_s": {"rotate": t_rotate, "scan": scan_s,
                          "route": ("stored" if use_stored else
                                    "resident" if rg is not None
                                    else "streamed")}}
