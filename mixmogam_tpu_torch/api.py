"""Facade API (counterpart of mixmogam_tpu/api.py; reference: mixmogam.py —
SURVEY.md L7: convenience functions gluing parse -> coordinate -> kinship ->
scan -> results/plots).

run_gwas runs every method of the JAX package's: 'emmax', 'emmax_loco',
'emmax_stepwise', 'emma' (the exact per-SNP REML, float64 by default), the
fixed-effects tests 'lm', 'anova' and 'kw', and the GxE interaction scan
'emmax_gxe', on the port's models layer, on the card unless the caller
passes device='cpu'. run_gwas_multi loops run_gwas over the phenotypes, or
with batched=True runs one shared-eigenbasis multi-trait scan
(models/multitrait.py)."""

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
    "calc_ibd_kinship", "emmax", "emmax_loco", "emmax_step_wise",
    "emmax_multi_trait", "emma", "emmax_anova", "linear_model", "anova",
    "kruskal_wallis", "emmax_gxe", "gblup", "gblup_predict", "gblup_cv",
    "emmax_perm_test", "emmax_two_snps", "run_gwas", "run_gwas_multi", "save_kinship_to_file",
    "load_kinship_from_file",
]

_METHODS = ("emmax", "emmax_loco", "emmax_stepwise", "emma", "lm", "anova",
            "kw", "emmax_gxe")
#: the entry point of each lazily exported scan: (module, function)
_ENTRY = {
    "emmax": ("emmax", "emmax"), "emmax_anova": ("emmax", "emmax_anova"),
    "emmax_loco": ("loco", "emmax_loco"),
    "emmax_step_wise": ("stepwise", "emmax_step_wise"),
    "emmax_multi_trait": ("multitrait", "emmax_multi_trait"),
    "emma": ("emma", "emma"), "linear_model": ("linear", "linear_model"),
    "anova": ("linear", "anova"),
    "kruskal_wallis": ("linear", "kruskal_wallis"),
    "emmax_gxe": ("gxe", "emmax_gxe"), "gblup": ("gblup", "gblup"),
    "gblup_predict": ("gblup", "gblup_predict"),
    "gblup_cv": ("gblup", "gblup_cv"),
    "emmax_perm_test": ("permutation", "emmax_perm_test"),
    "emmax_two_snps": ("twosnp", "emmax_two_snps"),
}


def __getattr__(name):
    # the scan entry points, without importing torch with the facade
    if name in _ENTRY:
        import importlib

        mod, fn = _ENTRY[name]
        return getattr(importlib.import_module(
            f"mixmogam_tpu_torch.models.{mod}"), fn)
    raise AttributeError(
        f"module 'mixmogam_tpu_torch.api' has no attribute {name!r}")


def _check_method(method: str, covariate_pids=None, env_pid=None) -> None:
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r}")
    if method == "emmax_gxe" and env_pid is None:
        raise ValueError("method='emmax_gxe' needs env_pid (the phenotype "
                         "column holding the per-sample environment)")
    if covariate_pids and method in ("anova", "kw"):
        # the class tests have no covariate design: refuse rather than run
        # an unadjusted scan
        raise ValueError(
            f"covariate_pids is not supported by method {method!r} "
            "(anova/kw are covariate-free class tests); use emmax/emma/lm/"
            "emmax_stepwise")


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
            and no plots) | 'emma' (per-SNP REML, float64 unless dtype is
            given) | 'lm' (OLS) | 'anova' | 'kw' (Kruskal-Wallis; these
            two take no covariate_pids and, like 'lm', no kinship) |
            'emmax_gxe' (the GxE scan against the environment in phenotype
            column env_pid, which it requires; the ranked output is its
            interaction p-values, scan['inter_ps']).
    device: where the kinship and the scan run: the card by default (the
            call raises without one, before any file is read), 'cpu' on
            request.
    dtype:  a torch dtype for the scan (None: float32 on the card, float64
            on the CPU, for emmax, emmax_stepwise, emmax_loco, lm and
            emmax_gxe;
            float64 for emma, anova and kw); numpy dtypes and strings are
            refused.
    transform: None | 'log' | 'sqrt' | 'box_cox' | 'exp' | 'arcsin_sqrt'
               | 'most_normal'.
    model_kw['X0'] (a user-supplied fixed-effects design) must have its
    rows in the COORDINATED sample order — the genotype/phenotype
    intersection order established by coordinate_with_phenotype (the
    order of the emitted result's samples). When covariate_pids or env_pid
    drop further samples, X0 rows are subset by position; only the row
    COUNT is verifiable, so a same-sized design in a different sample
    order would be silently misaligned.
    Returns {'result': Result, 'scan': scan dict, 'files': {...}}.
    """
    from mixmogam_tpu_torch.config import DEFAULT
    from mixmogam_tpu_torch.ops import resolve_device
    from mixmogam_tpu_torch.ops.kinship import resolve_compute_dtype
    from mixmogam_tpu_torch.utils.profiling import RunMetrics, device_trace

    _check_method(method, covariate_pids, env_pid)
    device = resolve_device(device)
    if dtype is not None:
        resolve_compute_dtype(dtype, device)      # refuses numpy / strings
    cfg = config or DEFAULT
    # REML defaults from config (mirror the reference's numeric defaults;
    # explicit model_kw wins)
    if method not in ("lm", "anova", "kw"):
        for k, v in (("ngrids", cfg.reml.ngrids), ("llim", cfg.reml.llim),
                     ("ulim", cfg.reml.ulim), ("esp", cfg.reml.esp)):
            model_kw.setdefault(k, v)
    if method in ("emmax", "emma", "lm"):
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
        cov_maps = [phend.value_dict(c) for c in covariate_pids or ()]
        env_map = (phend.value_dict(env_pid) if method == "emmax_gxe"
                   else None)
        # ONE coordinated sample drop across the covariates AND the
        # environment — subsetting after X0 is built would leave a
        # stale-row design in model_kw
        req_maps = cov_maps + ([env_map] if env_map is not None else [])
        if req_maps:
            keep = [i for i, a in enumerate(sample_ids)
                    if all(a in m for m in req_maps)]
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
        if cov_maps:
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
        env = None
        if env_map is not None:
            env = np.array([np.mean(env_map[a]) for a in sample_ids])
        if min_mac:
            gd2 = gd2.filter_mac_snps(min_mac)

    K = None
    if method in ("emmax", "emmax_stepwise", "emma", "emmax_gxe"):
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
        elif method == "emma":
            from mixmogam_tpu_torch.models.emma import emma

            if dtype is not None:
                model_kw["dtype"] = dtype
            scan = emma(gd2, y, K=K, device=device, **model_kw)
        elif method in ("lm", "anova", "kw"):
            from mixmogam_tpu_torch.models import linear

            fn = {"lm": linear.linear_model, "anova": linear.anova,
                  "kw": linear.kruskal_wallis}[method]
            scan = fn(gd2, y, dtype=dtype, device=device, **model_kw)
        elif method == "emmax_stepwise":
            from mixmogam_tpu_torch.models.stepwise import emmax_step_wise

            sw = emmax_step_wise(gd2, y, K=K, max_steps=num_steps,
                                 dtype=dtype, save_scans=False,
                                 device=device, **model_kw)
            scan = {"stepwise": sw, "ps": None}
        elif method == "emmax_gxe":
            from mixmogam_tpu_torch.models.gxe import emmax_gxe

            model_kw.pop("esp", None)      # fixed-iteration bisection
            scan = emmax_gxe(gd2, y, env, K=K, dtype=dtype, device=device,
                             **model_kw)
            # the ranked output: the interaction tests (the scan's point)
            scan["ps"] = scan["inter_ps"]
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

    batched=True runs ONE shared-eigenbasis multi-trait scan instead
    (models/multitrait.py emmax_multi_trait): the genotypes are
    coordinated once against the union of phenotyped samples, a trait's
    missing phenotypes become NaN (its missingness pattern's group), and
    each genotype tile is rotated once for all traits. Each pid's entry
    also holds the coordinated genotypes (shared by all pids) and its
    phenotype row, NaN where missing. It takes the facade
    kwargs of batched=False that it can honour (method='emmax',
    transform, plots, ploidy, kinship_file) and emmax_multi_trait's own
    (device= among them); any other raises ValueError before a file is
    read."""
    if batched:
        return _run_gwas_batched(genotype_file, phenotype_file, pids,
                                 out_prefix, data_format, min_mac,
                                 kinship_method, cache_dir, kw)
    _check_method(kw.get("method", "emmax"), kw.get("covariate_pids"),
                  kw.get("env_pid"))
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


def _run_gwas_batched(genotype_file, phenotype_file, pids, out_prefix,
                      data_format, min_mac, kinship_method, cache_dir,
                      kw) -> Dict[int, Dict]:
    """run_gwas_multi(batched=True): the JAX package's translation of the
    facade kwargs, then emmax_multi_trait on the port's layers."""
    import inspect

    from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
    from mixmogam_tpu_torch.ops import resolve_device
    from mixmogam_tpu_torch.ops.kinship import resolve_compute_dtype

    kw = dict(kw)
    method = kw.pop("method", "emmax")
    if method != "emmax":
        raise ValueError(
            f"batched=True runs one shared-eigenbasis EMMAX scan; "
            f"method={method!r} is only available with batched=False")
    transform = kw.pop("transform", None)
    # same default as run_gwas: plots render per pid when out_prefix is
    # set, so batched=True produces the same artifact set as a loop
    plots = kw.pop("plots", True)
    ploidy = kw.pop("ploidy", None)
    kinship_file = kw.pop("kinship_file", None)
    mt_params = set(inspect.signature(emmax_multi_trait).parameters)
    unknown = sorted(set(kw) - mt_params)
    if unknown:
        raise ValueError(
            f"kwargs {unknown} are not supported with batched=True "
            "(the shared-eigenbasis scan accepts "
            f"{sorted(mt_params - {'G', 'Y', 'K'})}); use batched=False")
    device = kw["device"] = resolve_device(kw.get("device"))
    if kw.get("dtype") is not None:
        resolve_compute_dtype(kw["dtype"], device)  # refuses numpy / str
    phend = parse_phenotype_file(phenotype_file)
    pid_list = list(pids if pids is not None else phend.phenotype_ids())
    if transform:
        for pid in pid_list:
            if transform == "most_normal":
                phend.most_normal_transformation(pid)
            else:
                phend.transform(pid, transform)
    gd = parse_snp_data(genotype_file, data_format=data_format,
                        ploidy=ploidy)
    maps = {pid: phend.value_dict(pid) for pid in pid_list}
    keep = [i for i, a in enumerate(gd.accessions)
            if any(a in m for m in maps.values())]
    if not keep:
        raise ValueError("no sample overlaps any requested phenotype")
    gd2 = gd.select_samples(keep).filter_monomorphic_snps()
    if min_mac:
        gd2 = gd2.filter_mac_snps(min_mac)
    Y = np.full((len(pid_list), gd2.num_samples), np.nan)
    for t, pid in enumerate(pid_list):
        m = maps[pid]
        for j, a in enumerate(gd2.accessions):
            if a in m:
                Y[t, j] = np.mean(m[a])
    if kinship_file and os.path.exists(kinship_file):
        from mixmogam_tpu_torch.oracle.kinship import prepare_k

        K, acc = load_kinship_from_file(kinship_file)
        K = prepare_k(K, acc, gd2.accessions)
    else:
        K = cached_kinship(gd2, kinship_method, cache_dir=cache_dir,
                           device=device)
    mt = emmax_multi_trait(gd2, Y, K=K, **kw)
    out = {}
    dofs = np.broadcast_to(np.asarray(mt["dof"]), (len(pid_list),))
    # one pass each over the matrix, shared by every pid's Result
    mafs, macs = gd2.get_mafs(), gd2.get_macs()
    for t, pid in enumerate(pid_list):
        result = Result(mt["ps"][t], gd2.chromosomes, gd2.positions,
                        mafs=mafs, macs=macs,
                        additional={"betas": mt["betas"][t],
                                    "f_stats": mt["f_stats"][t]},
                        score_type="pvals")
        files = {}
        if out_prefix:
            csv = f"{out_prefix}.pid{pid}.pvals.csv"
            result.write_to_file(csv)
            files["pvals"] = csv
            if plots:
                from mixmogam_tpu_torch.plotting import (manhattan_plot,
                                                         qq_plot)

                man = f"{out_prefix}.pid{pid}.manhattan.png"
                qq = f"{out_prefix}.pid{pid}.qq.png"
                manhattan_plot(result, man,
                               threshold=bonferroni_threshold(len(result)))
                qq_plot(mt["ps"][t], qq)
                files.update(manhattan=man, qq=qq)
        out[pid] = {
            "result": result, "files": files, "genotype": gd2, "y": Y[t],
            "scan": {"ps": mt["ps"][t], "f_stats": mt["f_stats"][t],
                     "betas": mt["betas"][t], "mask": mt["mask"][t],
                     "delta": float(mt["deltas"][t]),
                     "pseudo_heritability":
                         float(mt["pseudo_heritabilities"][t]),
                     "dof": int(dofs[t])},
        }
    return out
