"""Command-line interface (counterpart of mixmogam_tpu/cli.py).

    mixmogam-tpu-torch run      genotype.csv phenotype.csv --method emmax ...
    mixmogam-tpu-torch kinship  genotype.csv -o K.npz --method ibs
    mixmogam-tpu-torch predict  genotype.csv phenotype.csv --folds 5 -o p.csv
    mixmogam-tpu-torch simulate -n 500 -m 10000 -o prefix
    mixmogam-tpu-torch info

run, kinship and predict compute on the card unless --device cpu is given;
without a card and without --device they fail. run --stream on streams the
SNP tiles from the host (models/streaming.py::emmax_streamed) and
--checkpoint-dir resumes such a scan tile by tile; both need --method
emmax. The options of the JAX package's CLI that the port does not have
yet are offered and refused with the ROADMAP item that brings them.
"""

from __future__ import annotations

import argparse
import json
import sys

_TIERS = ["exact", "auto", "fast", "int8x3", "int8x2", "int8x4", "bf16x3",
          "bf16x2", "bf16", "high"]


def _add_device(p):
    p.add_argument("--device", default=None,
                   help="torch device to compute on (default: the CUDA "
                        "card; 'cpu' runs the plain PyTorch versions of "
                        "the kernels in float64)")


def _add_run(sub):
    p = sub.add_parser("run", help="end-to-end GWAS scan")
    p.add_argument("genotype")
    p.add_argument("phenotype")
    p.add_argument("--pid", type=int, default=1,
                   help="phenotype id (column) to analyze")
    p.add_argument("--method", default="emmax",
                   choices=["emmax", "emma", "lm", "anova", "kw",
                            "emmax_stepwise", "emmax_loco",
                            "emmax_gxe"],
                   help="emmax_gxe (the GxE interaction scan) needs "
                        "--env-pid")
    p.add_argument("--env-pid", type=int, default=None,
                   help="phenotype column holding the per-sample "
                        "environment (for --method emmax_gxe)")
    p.add_argument("-o", "--out-prefix", default="gwas_out")
    p.add_argument("--ploidy", type=int, default=None, choices=[1, 2],
                   help="explicit ploidy (default: inferred as 2 iff any "
                        "dosage exceeds 1 — pass 2 explicitly for diploid "
                        "data with no homozygous-alt calls)")
    p.add_argument("--data-format", default="binary",
                   choices=["binary", "nucleotides", "plink", "vcf"],
                   help="genotype format ('.bed'/'.h5'/'.vcf'/'.vcf.gz' "
                        "paths auto-detect regardless)")
    p.add_argument("--transform", default=None,
                   choices=["log", "sqrt", "box_cox", "exp", "arcsin_sqrt",
                            "most_normal"])
    p.add_argument("--min-mac", type=int, default=15)
    p.add_argument("--kinship-method", default="ibs",
                   choices=["ibs", "vanraden"])
    p.add_argument("--kinship-file", default=None)
    p.add_argument("--cache-dir", default=None)
    p.add_argument("--num-steps", type=int, default=10,
                   help="stepwise forward steps (for --method "
                        "emmax_stepwise)")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler Chrome trace of the scan "
                        "here")
    p.add_argument("--covariate-pids", default=None,
                   help="comma-separated phenotype ids used as fixed-"
                        "effect covariates (e.g. '2,3')")
    p.add_argument("--precision", default="exact", choices=_TIERS,
                   help="EMMAX scan tier: exact=true fp32 (default); "
                        "int8x3=exact-grade digit planes (int dosages); "
                        "int8x2=fast digit planes; int8x4; "
                        "bf16x3=exact-grade split-W; bf16x2=split-W "
                        "2-pass; bf16=1-pass; auto: int8x3 on the card for fully "
                        "observed integer dosages, else exact; fast: "
                        "int8x2 (else bf16) on the card with an exact "
                        "rescore of the top 1024 hits; both exact on the "
                        "CPU; high=the exact route with its rotation in "
                        "three bf16 passes (TF32 stays off)")
    p.add_argument("--rescore-top", type=int, default=0,
                   help="with a fast --precision tier: re-test the top-K "
                        "SNPs (+ anything near Bonferroni) at the exact "
                        "tier so reported hits carry exact-grade p-values")
    p.add_argument("--stream", default=None, choices=["auto", "on", "off"],
                   help="stream SNP tiles from host (default auto: when "
                        "the scan would exceed the device budget; emmax "
                        "only)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="tile-granular resume directory for streamed "
                        "emmax scans (implies --stream on)")
    p.add_argument("--resident", default=None, choices=["auto", "on", "off"],
                   help="hold the genome 2-bit packed in device memory "
                        "(default auto: promotes int8 genomes that "
                        "exceed the in-core budget but fit packed; emmax "
                        "only)")
    _add_device(p)


def _add_kinship(sub):
    p = sub.add_parser("kinship", help="build + save a kinship matrix")
    p.add_argument("genotype")
    p.add_argument("-o", "--out", required=True)
    p.add_argument("--method", default="ibs", choices=["ibs", "vanraden"])
    p.add_argument("--data-format", default="binary")
    _add_device(p)


def _add_predict(sub):
    p = sub.add_parser(
        "predict",
        help="gBLUP genomic prediction (cross-validated accuracy, or "
             "per-sample breeding values)")
    p.add_argument("genotype")
    p.add_argument("phenotype")
    p.add_argument("--pid", type=int, default=1)
    p.add_argument("--data-format", default="binary",
                   choices=["binary", "nucleotides", "plink", "vcf"])
    p.add_argument("--kinship-method", default="ibs",
                   choices=["ibs", "vanraden"])
    p.add_argument("--folds", type=int, default=5,
                   help="cross-validation folds (0 = no CV; fit on all "
                        "samples and write breeding values only)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--out", default=None,
                   help="write per-sample predictions CSV here")
    _add_device(p)


def _add_simulate(sub):
    p = sub.add_parser("simulate", help="write a simulated dataset")
    p.add_argument("-n", "--samples", type=int, default=200)
    p.add_argument("-m", "--snps", type=int, default=10000)
    p.add_argument("--h2", type=float, default=0.5)
    p.add_argument("--n-causal", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("-o", "--out-prefix", required=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mixmogam-tpu-torch",
        description="Mixed-model GWAS (EMMAX, LOCO EMMAX, stepwise MLMM, "
                    "EMMA, GxE, OLS / ANOVA / Kruskal-Wallis) and gBLUP on "
                    "PyTorch/CUDA: the port of mixmogam-tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _add_run(sub)
    _add_kinship(sub)
    _add_predict(sub)
    _add_simulate(sub)
    sub.add_parser("info", help="backend/device info")
    args = ap.parse_args(argv)

    if args.cmd == "info":
        import torch

        import mixmogam_tpu_torch

        print(f"mixmogam-tpu-torch {mixmogam_tpu_torch.__version__}")
        n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
        names = [torch.cuda.get_device_name(i) for i in range(n_dev)]
        print(f"torch {torch.__version__}, cuda {torch.version.cuda}, "
              f"cuda devices={n_dev} {names}")
        return 0

    if args.cmd == "predict":
        from mixmogam_tpu_torch.api import parse_snp_data
        from mixmogam_tpu_torch.data.phenotype import PhenotypeData
        from mixmogam_tpu_torch.models.gblup import (_joint_kinship, gblup,
                                                     gblup_cv)
        from mixmogam_tpu_torch.ops import resolve_device

        device = resolve_device(args.device)     # before the files are read
        gd = parse_snp_data(args.genotype, data_format=args.data_format)
        phend = PhenotypeData.parse_phenotype_file(args.phenotype)
        gd2, y, _ = gd.coordinate_with_phenotype(phend, args.pid)
        summary = {"n": len(y), "m": gd2.num_snps}
        if args.folds:
            cv = gblup_cv(gd2, y, n_folds=args.folds, seed=args.seed,
                          kinship_method=args.kinship_method, device=device)
            summary.update(r=cv["r"], r_folds=cv["r_folds"], mse=cv["mse"])
            y_col, y_hat = "y_hat_cv", cv["y_hat"]
        else:
            m = gblup(y, K=_joint_kinship(gd2, args.kinship_method,
                                          device=device), device=device)
            summary.update(h2=m.pseudo_heritability, delta=m.delta)
            y_col, y_hat = "genetic_value", m.u_hat
        if args.out:
            with open(args.out, "w") as f:
                f.write(f"ecotype_id,y,{y_col}\n")
                for acc, yv, gv in zip(gd2.accessions, y, y_hat):
                    f.write(f"{acc},{yv},{gv}\n")
            summary["file"] = args.out
        print(json.dumps(summary, indent=2))
        return 0

    if args.cmd == "run":
        import numpy as np

        from mixmogam_tpu_torch.api import run_gwas

        cov = ([int(x) for x in args.covariate_pids.split(",")]
               if args.covariate_pids else None)
        tier_kw = {}
        if args.precision != "exact":
            if args.method != "emmax":
                ap.error(f"--precision {args.precision} is only supported "
                         f"for --method emmax (got {args.method})")
            tier_kw["precision"] = args.precision
        if args.rescore_top:
            if args.method != "emmax":
                ap.error("--rescore-top requires --method emmax")
            tier_kw["rescore_top"] = args.rescore_top
        if args.stream in ("on", "off"):
            if args.method != "emmax":
                ap.error("--stream requires --method emmax")
            tier_kw["stream"] = args.stream == "on"
        if args.checkpoint_dir:
            if args.method != "emmax":
                ap.error("--checkpoint-dir requires --method emmax")
            tier_kw["checkpoint_dir"] = args.checkpoint_dir
            tier_kw.setdefault("stream", True)
        if args.resident in ("on", "off"):
            if args.method != "emmax":
                ap.error("--resident requires --method emmax")
            tier_kw["resident"] = args.resident == "on"
        out = run_gwas(
            args.genotype, args.phenotype, pid=args.pid,
            method=args.method, out_prefix=args.out_prefix,
            data_format=args.data_format, transform=args.transform,
            min_mac=args.min_mac, kinship_method=args.kinship_method,
            kinship_file=args.kinship_file, cache_dir=args.cache_dir,
            plots=not args.no_plots, num_steps=args.num_steps,
            profile_dir=args.profile_dir, covariate_pids=cov,
            env_pid=args.env_pid, ploidy=args.ploidy, device=args.device,
            **tier_kw)
        if args.method == "emmax_stepwise":
            sw = out["scan"]["stepwise"]
            sel = {k: v["cofactors"] for k, v in sw["selected"].items()}
            print(json.dumps({"selected": sel}, indent=2))
            return 0
        ps = out["scan"]["ps"]
        print(f"scanned {len(ps)} SNPs; min p = {np.min(ps):.3e}; "
              f"files: {json.dumps(out['files'])}")
        st = out["scan"].get("stream_stats")
        if st is not None:
            print(f"streamed {st['tiles']} tiles: {st['scanned']} scanned, "
                  f"{st['restored']} restored from the checkpoint")
        return 0

    if args.cmd == "kinship":
        from mixmogam_tpu_torch.api import (calc_ibd_kinship,
                                            calc_ibs_kinship,
                                            parse_snp_data,
                                            save_kinship_to_file)
        from mixmogam_tpu_torch.ops import resolve_device

        device = resolve_device(args.device)     # before the file is read
        gd = parse_snp_data(args.genotype, data_format=args.data_format)
        fn = calc_ibs_kinship if args.method == "ibs" else calc_ibd_kinship
        K = fn(gd, device=device)
        save_kinship_to_file(args.out, K, gd.accessions)
        print(f"wrote {args.out} ({K.shape[0]}x{K.shape[1]})")
        return 0

    if args.cmd == "simulate":
        import numpy as np

        from mixmogam_tpu_torch.data.genotype import GenotypeData
        from mixmogam_tpu_torch.data.phenotype import PhenotypeData
        from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                      simulate_phenotype)

        G, ch, po = simulate_genotypes(args.samples, args.snps,
                                       seed=args.seed)
        gd = GenotypeData(G, ch, po,
                          [f"acc{i}" for i in range(args.samples)])
        y, causal = simulate_phenotype(G, h2=args.h2,
                                       n_causal=args.n_causal,
                                       seed=args.seed)
        gfile = f"{args.out_prefix}.genotypes.csv"
        pfile = f"{args.out_prefix}.phenotypes.csv"
        gd.write_csv(gfile)
        PhenotypeData.from_arrays(1, "sim_trait", gd.accessions,
                                  y).write_to_file(pfile)
        np.savetxt(f"{args.out_prefix}.causal.txt", causal, fmt="%d")
        print(f"wrote {gfile}, {pfile} "
              f"({args.samples} samples x {args.snps} SNPs)")
        return 0
    return 1


if __name__ == "__main__":
    sys.exit(main())
