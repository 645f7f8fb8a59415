"""Facade API (counterpart of mixmogam_tpu/api.py; reference: mixmogam.py —
SURVEY.md L7: convenience functions gluing parse -> coordinate -> kinship ->
scan -> results/plots).

run_gwas runs method='emmax', 'emmax_loco' and 'emmax_stepwise' on the
port's models layer, on the card unless the caller passes device='cpu'. The
JAX package's
other methods are not ported yet: each raises NotImplementedError naming its
ROADMAP item before any file is read."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np

from mixmogam_tpu_torch.data.genotype import GenotypeData
from mixmogam_tpu_torch.data.parsers import parse_snp_data
from mixmogam_tpu_torch.data.phenotype import PhenotypeData
from mixmogam_tpu_torch.results.mtcorr import (
    bonferroni_threshold, get_bh_thres, get_bhy_thres,
)
from mixmogam_tpu_torch.results.result import Result
from mixmogam_tpu_torch.utils.caching import (
    cached_kinship, load_kinship_from_file, save_kinship_to_file,
)

__all__ = [
    "parse_snp_data", "parse_phenotype_file", "calc_ibs_kinship",
    "calc_ibd_kinship", "emmax", "emmax_loco", "emmax_step_wise", "run_gwas",
    "run_gwas_multi",
    "save_kinship_to_file", "load_kinship_from_file",
]

#: run_gwas methods of the JAX package that the port does not have yet, with
#: the ROADMAP item that brings each
_NOT_PORTED = {
    "emma": "ROADMAP Queue 1 item 11 (models/emma.py)",
    "lm": "ROADMAP Queue 1 item 12 (models/linear.py)",
    "anova": "ROADMAP Queue 1 item 12 (models/linear.py)",
    "kw": "ROADMAP Queue 1 item 12 (models/linear.py)",
    "emmax_gxe": "ROADMAP Queue 1 item 13 (models/gxe.py)",
}
_METHODS = ("emmax", "emmax_loco", "emmax_stepwise")


def __getattr__(name):
    # the scan entry points, without importing torch with the facade
    if name == "emmax":
        from mixmogam_tpu_torch.models.emmax import emmax

        return emmax
    if name == "emmax_loco":
        from mixmogam_tpu_torch.models.loco import emmax_loco

        return emmax_loco
    if name == "emmax_step_wise":
        from mixmogam_tpu_torch.models.stepwise import emmax_step_wise

        return emmax_step_wise
    raise AttributeError(
        f"module 'mixmogam_tpu_torch.api' has no attribute {name!r}")


def _check_method(method: str) -> None:
    if method in _NOT_PORTED:
        raise NotImplementedError(
            f"method={method!r} is not ported yet: {_NOT_PORTED[method]}; "
            f"the port's run_gwas has {_METHODS}")
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}")


def parse_phenotype_file(path: str, delimiter: str = ",") -> PhenotypeData:
    return PhenotypeData.parse_phenotype_file(path, delimiter=delimiter)


def _calc_kinship(gd_or_snps, method: str, use_device: bool,
                  cache_dir: Optional[str], scale: bool,
                  device) -> np.ndarray:
    if isinstance(gd_or_snps, GenotypeData):
        return cached_kinship(gd_or_snps, method, cache_dir=cache_dir,
                              use_device=use_device, scale=scale,
                              device=device)
    from mixmogam_tpu_torch.ops import kinship as dk
    from mixmogam_tpu_torch.oracle.kinship import scale_k

    K = dk.kinship(np.asarray(gd_or_snps), method=method,
                   use_device=use_device, device=device)
    return scale_k(K) if scale else K


def calc_ibs_kinship(gd_or_snps, use_device: bool = True,
                     cache_dir: Optional[str] = None,
                     scale: bool = True, device=None) -> np.ndarray:
    """IBS kinship (reference: mixmogam.calculate_ibs_kinship)."""
    return _calc_kinship(gd_or_snps, "ibs", use_device, cache_dir, scale,
                         device)


def calc_ibd_kinship(gd_or_snps, use_device: bool = True,
                     cache_dir: Optional[str] = None,
                     scale: bool = True, device=None) -> np.ndarray:
    """VanRaden/'IBD' kinship (reference: calc_ibd_kinship)."""
    return _calc_kinship(gd_or_snps, "vanraden", use_device, cache_dir,
                         scale, device)


def run_gwas(genotype_file: str, phenotype_file: str, pid: int = 1,
             method: str = "emmax", out_prefix: Optional[str] = None,
             data_format: str = "binary", transform: Optional[str] = None,
             min_mac: int = 15, kinship_method: str = "ibs",
             kinship_file: Optional[str] = None,
             cache_dir: Optional[str] = None, plots: bool = True,
             num_steps: int = 10, dtype=None,
             profile_dir: Optional[str] = None,
             covariate_pids: Optional[Sequence[int]] = None,
             env_pid: Optional[int] = None,
             ploidy: Optional[int] = None,
             config: Optional["GwasConfig"] = None, device=None,
             **model_kw) -> Dict:
    """End-to-end GWAS (reference: examples.py flow, SURVEY.md §3.1):
    parse -> transform -> coordinate -> MAC filter -> kinship (cached) ->
    scan -> ranked CSV + Manhattan/QQ plots + JSON run summary.

    method: 'emmax' | 'emmax_loco' (LOCO builds per-chromosome kinships
            itself) | 'emmax_stepwise' (num_steps forward steps; the
            result's scan is {'stepwise': ..., 'ps': None}: no ranked CSV
            and no plots). 'emma', 'lm', 'anova', 'kw' and 'emmax_gxe'
            raise NotImplementedError (env_pid is emmax_gxe's and stays in
            the signature for it).
    device: where the kinship and the scan run: the card by default (the
            call raises without one, before any file is read), 'cpu' on
            request.
    dtype:  a torch dtype for the scan (None: float32 on the card, float64
            on the CPU); numpy dtypes and strings are refused.
    transform: None | 'log' | 'sqrt' | 'box_cox' | 'exp' | 'arcsin_sqrt'
               | 'most_normal'.
    model_kw['X0'] (a user-supplied fixed-effects design) must have its
    rows in the COORDINATED sample order — the genotype/phenotype
    intersection order established by coordinate_with_phenotype (the
    order of the emitted result's samples). When covariate_pids drop
    further samples, X0 rows are subset by position; only the row COUNT is
    verifiable, so a same-sized design in a different sample order would
    be silently misaligned.
    Returns {'result': Result, 'scan': scan dict, 'files': {...}}.
    """
    from mixmogam_tpu_torch.config import DEFAULT
    from mixmogam_tpu_torch.ops import resolve_device
    from mixmogam_tpu_torch.ops.kinship import resolve_compute_dtype
    from mixmogam_tpu_torch.utils.profiling import RunMetrics, device_trace

    _check_method(method)
    device = resolve_device(device)
    if dtype is not None:
        resolve_compute_dtype(dtype, device)      # refuses numpy / strings
    cfg = config or DEFAULT
    # REML defaults from config (mirror the reference's numeric defaults;
    # explicit model_kw wins)
    for k, v in (("ngrids", cfg.reml.ngrids), ("llim", cfg.reml.llim),
                 ("ulim", cfg.reml.ulim), ("esp", cfg.reml.esp)):
        model_kw.setdefault(k, v)
    if method == "emmax":
        model_kw.setdefault("tile", cfg.tiles.scan_snp_tile)

    rm = RunMetrics(run_name=f"{method}_pid{pid}")
    with rm.phase("parse"):
        # ploidy: None infers 2 iff any dosage exceeds 1 — pass 2
        # explicitly for diploid data with no homozygous-alt calls
        # (e.g. an F1 cross), which the heuristic would call haploid
        gd = parse_snp_data(genotype_file, data_format=data_format,
                            ploidy=ploidy)
        phend = parse_phenotype_file(phenotype_file)

    if transform == "most_normal":
        phend.most_normal_transformation(pid)
    elif transform:
        phend.transform(pid, transform)

    with rm.phase("coordinate"):
        gd2, y, sample_ids = gd.coordinate_with_phenotype(phend, pid)
        if covariate_pids:
            cov_maps = [phend.value_dict(c) for c in covariate_pids]
            # ONE coordinated sample drop across all covariates —
            # subsetting after X0 is built would leave a stale-row design
            # in model_kw
            keep = [i for i, a in enumerate(sample_ids)
                    if all(a in m for m in cov_maps)]
            if len(keep) < len(sample_ids):
                gd2 = gd2.select_samples(keep).filter_monomorphic_snps()
                y = y[keep]
                if "X0" in model_kw and np.shape(
                        model_kw["X0"])[0] == len(sample_ids):
                    # a user-supplied design built on the pre-drop
                    # coordinated set: keep its rows aligned (the
                    # row-count match is all that can be verified here;
                    # see the docstring)
                    model_kw["X0"] = np.asarray(model_kw["X0"])[keep]
                sample_ids = [sample_ids[i] for i in keep]
            cov_cols = [np.array([np.mean(m[a])
                                  for a in sample_ids])[:, None]
                        for m in cov_maps]
            if "X0" in model_kw:
                # a user design + covariate_pids COMPOSE: append the
                # covariate columns
                X0u = np.asarray(model_kw["X0"], dtype=np.float64)
                if X0u.ndim == 1:
                    X0u = X0u[:, None]
                if X0u.shape[0] != len(sample_ids):
                    raise ValueError(
                        f"model_kw['X0'] has {X0u.shape[0]} rows but "
                        f"{len(sample_ids)} coordinated samples remain")
                model_kw["X0"] = np.hstack([X0u] + cov_cols)
            else:
                model_kw["X0"] = np.hstack(
                    [np.ones((len(sample_ids), 1))] + cov_cols)
        if min_mac:
            gd2 = gd2.filter_mac_snps(min_mac)

    K = None
    if method in ("emmax", "emmax_stepwise"):
        with rm.phase("kinship"):
            if kinship_file and os.path.exists(kinship_file):
                from mixmogam_tpu_torch.oracle.kinship import prepare_k

                K, acc = load_kinship_from_file(kinship_file)
                K = prepare_k(K, acc, gd2.accessions)
            else:
                K = cached_kinship(gd2, kinship_method, cache_dir=cache_dir,
                                   device=device)
        rm.throughput("kinship_snps_per_s", gd2.num_snps, "kinship")

    with rm.phase("scan"), device_trace(profile_dir):
        if method == "emmax":
            from mixmogam_tpu_torch.models.emmax import emmax

            scan = emmax(gd2, y, K=K, dtype=dtype, device=device, **model_kw)
        elif method == "emmax_stepwise":
            from mixmogam_tpu_torch.models.stepwise import emmax_step_wise

            sw = emmax_step_wise(gd2, y, K=K, max_steps=num_steps,
                                 dtype=dtype, save_scans=False,
                                 device=device, **model_kw)
            scan = {"stepwise": sw, "ps": None}
        else:
            # LOCO builds its own per-chromosome kinships (a global K
            # would be wasted work and scale_k breaks gram additivity)
            from mixmogam_tpu_torch.models.loco import emmax_loco

            # the kinship cache_dir doubles as the LOCO eigen cache
            # (per-chromosome (phi, U) keyed on content — a repeated
            # campaign resumes scan-bound)
            model_kw.setdefault("cache_dir", cache_dir)
            scan = emmax_loco(gd2, y, method=kinship_method, dtype=dtype,
                              device=device, **model_kw)
    rm.throughput("scan_snp_tests_per_s", gd2.num_snps, "scan")
    timings = dict(rm.phases)

    files = {}
    result = None
    if scan.get("ps") is not None:
        result = Result.from_scan(scan, gd2.chromosomes, gd2.positions,
                                  mafs=gd2.get_mafs(), macs=gd2.get_macs())
        if out_prefix:
            csv = f"{out_prefix}.pvals.csv"
            result.write_to_file(csv)
            files["pvals"] = csv
            if plots:
                from mixmogam_tpu_torch.plotting import (manhattan_plot,
                                                         qq_plot)

                man = f"{out_prefix}.manhattan.png"
                qq = f"{out_prefix}.qq.png"
                manhattan_plot(result, man,
                               threshold=bonferroni_threshold(len(result)))
                qq_plot(scan["ps"], qq)
                files.update(manhattan=man, qq=qq)
    timings["total"] = time.time() - rm._t0

    if out_prefix:
        rm.set("n_samples", gd2.num_samples)
        rm.set("n_snps", gd2.num_snps)
        rm.set("device", str(device))
        rm.write(f"{out_prefix}.metrics.json")
        files["metrics"] = f"{out_prefix}.metrics.json"
        summary = {
            "method": method, "pid": pid,
            "n_samples": gd2.num_samples, "n_snps": gd2.num_snps,
            "timings_s": {k: round(v, 3) for k, v in timings.items()},
        }
        for k in ("pseudo_heritability", "delta", "sigma_g2", "sigma_e2"):
            if k in scan:
                summary[k] = scan[k]
        if scan.get("ps") is not None:
            summary["min_p"] = float(np.min(scan["ps"]))
            summary["bonferroni"] = bonferroni_threshold(gd2.num_snps)
            summary["bh_thres"] = get_bh_thres(scan["ps"])
            summary["bhy_thres"] = get_bhy_thres(scan["ps"])
        sj = f"{out_prefix}.summary.json"
        with open(sj, "w") as f:
            json.dump(summary, f, indent=2, default=float)
        files["summary"] = sj

    return {"result": result, "scan": scan, "genotype": gd2, "y": y,
            "files": files, "timings": timings}


def run_gwas_multi(genotype_file: str, phenotype_file: str,
                   pids: Optional[Sequence[int]] = None,
                   out_prefix: Optional[str] = None,
                   batched: bool = False, data_format: str = "binary",
                   min_mac: int = 15, kinship_method: str = "ibs",
                   cache_dir: Optional[str] = None,
                   **kw) -> Dict[int, Dict]:
    """Run a scan for every phenotype id in the file (reference pattern:
    looping the facade over a multi-phenotype file). The kinship cache
    keys on genotype content, so with a cache_dir K is computed once
    across traits that share the sample set.

    batched=True (one shared-eigenbasis multi-trait scan) is not ported
    yet and raises NotImplementedError."""
    if batched:
        raise NotImplementedError(
            "run_gwas_multi(batched=True), the shared-eigenbasis "
            "multi-trait scan, is not ported yet: ROADMAP Queue 1 item 10 "
            "(models/multitrait.py); use batched=False")
    _check_method(kw.get("method", "emmax"))
    phend = parse_phenotype_file(phenotype_file)
    # pids=[] means "no phenotypes", not "all" (an empty filter result
    # must not fan out a full GWAS per phenotype in the file)
    pid_list = list(pids if pids is not None else phend.phenotype_ids())
    out = {}
    for pid in pid_list:
        prefix = f"{out_prefix}.pid{pid}" if out_prefix else None
        out[pid] = run_gwas(genotype_file, phenotype_file, pid=pid,
                            out_prefix=prefix,
                            data_format=data_format, min_mac=min_mac,
                            kinship_method=kinship_method,
                            cache_dir=cache_dir, **kw)
    return out
