"""Runnable end-to-end examples on the port (counterpart of
examples/examples.py): the same scenarios, under the same names, each
driven through the port's entry points on one device.

    python -m mixmogam_tpu_torch.examples                 # every scenario
    python -m mixmogam_tpu_torch.examples --device cpu lm stepwise
    python -m mixmogam_tpu_torch.examples --samples 60 --snps 400 \\
        --out /tmp/ex reference_classes

Without --device every entry point runs on the card (raising without one).
Outputs go under --out, by default a temporary directory removed at the
end. --samples / --snps size the simulated cohort files that the
file-driven scenarios share (the JAX examples' 300 x 5,000 by default);
the scenarios that draw their own cohort keep the JAX examples' sizes.
Plots are drawn where matplotlib is installed and skipped, with a line
saying so, where it is not. Each scenario's wall is printed as
"[example] <name>: <seconds> s".

mesh_campaign runs its entry points with mesh=make_mesh(): a world of one
in a lone process (on the card, or the CPU under --device cpu), every rank
of the group when launched under torchrun.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import os
import sys
import tempfile
import time

import numpy as np


@dataclasses.dataclass
class Ctx:
    """Where a run writes, the device its entry points take, and the size
    of the shared simulated cohort."""

    out: str
    device: object = None
    samples: int = 300
    snps: int = 5_000

    @property
    def plots(self) -> bool:
        return importlib.util.find_spec("matplotlib") is not None

    def path(self, name: str) -> str:
        return os.path.join(self.out, name)


def _no_plots(what: str) -> None:
    print(f"{what} skipped: matplotlib is not installed")


def _simulate_files(ctx: Ctx, h2=0.6, n_causal=5, seed=17,
                    missing_rate=0.01, tag="sim"):
    """Write a simulated genotype/phenotype pair of ctx.samples x ctx.snps
    (like the bundled at_data/ of the reference), once per tag."""
    from mixmogam_tpu_torch.data.genotype import GenotypeData
    from mixmogam_tpu_torch.data.phenotype import PhenotypeData
    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)

    gfile = ctx.path(f"{tag}.genotypes.csv")
    pfile = ctx.path(f"{tag}.phenotypes.csv")
    if not (os.path.exists(gfile) and os.path.exists(pfile)):
        n = ctx.samples
        G, ch, po = simulate_genotypes(n, ctx.snps,
                                       missing_rate=missing_rate, seed=seed)
        gd = GenotypeData(G, ch, po, [f"acc{i}" for i in range(n)])
        y, causal = simulate_phenotype(G, h2=h2, n_causal=n_causal,
                                       causal_effect=1.0, seed=seed)
        gd.write_csv(gfile)
        PhenotypeData.from_arrays(1, "flowering_time", gd.accessions,
                                  y).write_to_file(pfile)
        np.savetxt(ctx.path(f"{tag}.causal.txt"), causal, fmt="%d")
    return gfile, pfile


def _coordinated(ctx: Ctx, tag: str = "sim"):
    """The shared cohort's genotypes coordinated with trait 1 and filtered
    at MAC 5, with the trait and its IBS kinship."""
    from mixmogam_tpu_torch.api import (calc_ibs_kinship,
                                        parse_phenotype_file,
                                        parse_snp_data)

    g, p = _simulate_files(ctx, tag=tag)
    gd = parse_snp_data(g)
    phend = parse_phenotype_file(p)
    gd2, y, _ = gd.coordinate_w_phenotype_data(phend, 1)
    gd2 = gd2.filter_mac_snps(5)
    return gd2, y, calc_ibs_kinship(gd2, device=ctx.device)


def example_emmax(ctx: Ctx):
    """Standard single-trait EMMAX mixed-model GWAS with plots."""
    from mixmogam_tpu_torch.api import run_gwas

    g, p = _simulate_files(ctx)
    if not ctx.plots:
        _no_plots("Manhattan / QQ plots")
    out = run_gwas(g, p, method="emmax", min_mac=5,
                   out_prefix=ctx.path("emmax"),
                   cache_dir=ctx.path("cache"), plots=ctx.plots,
                   device=ctx.device)
    top = out["result"].get_top_snps(5)
    print("EMMAX pseudo-heritability:",
          round(out["scan"]["pseudo_heritability"], 3))
    print("top-5 positions:", list(top.positions))
    print("files:", out["files"])


def example_precision_tiers(ctx: Ctx):
    """Opt-in fast scan tiers: the int8x3 digit-plane tier (kernel K2 on
    the card) against exact; on mean-imputed dosages the int8 tiers refuse
    rather than silently round."""
    from mixmogam_tpu_torch.api import run_gwas

    # fully-observed cohort: int8 tiers apply
    g, p = _simulate_files(ctx, missing_rate=0.0, tag="sim_complete")
    exact = run_gwas(g, p, method="emmax", min_mac=5,
                     cache_dir=ctx.path("cache"), plots=False,
                     device=ctx.device)
    fast = run_gwas(g, p, method="emmax", min_mac=5,
                    cache_dir=ctx.path("cache"), plots=False,
                    rotate_in_bf16="int8x3", device=ctx.device)
    dp = float(np.max(np.abs(exact["scan"]["ps"] - fast["scan"]["ps"])))
    print(f"int8x3 vs exact: max |dp| = {dp:.2e} (expect ~1e-6)")

    # imputed cohort: the guard refuses the int8 tier
    g2, p2 = _simulate_files(ctx)
    try:
        run_gwas(g2, p2, method="emmax", min_mac=5, plots=False,
                 rotate_in_bf16="int8x3", device=ctx.device)
    except ValueError as e:
        print("imputed dosages correctly refused:", str(e)[:60], "...")
    else:
        raise AssertionError("the int8 tier took mean-imputed dosages")


def example_linear_model(ctx: Ctx):
    """OLS scan (no kinship) — shows population-structure inflation on the
    QQ plot compared to EMMAX."""
    from mixmogam_tpu_torch.api import run_gwas

    g, p = _simulate_files(ctx)
    if not ctx.plots:
        _no_plots("Manhattan / QQ plots")
    out = run_gwas(g, p, method="lm", min_mac=5, out_prefix=ctx.path("lm"),
                   plots=ctx.plots, device=ctx.device)
    print("LM min p:", out["scan"]["ps"].min())


def example_transformations(ctx: Ctx):
    """Phenotype transformations incl. Shapiro-driven most-normal pick."""
    from mixmogam_tpu_torch.api import parse_phenotype_file

    _, p = _simulate_files(ctx)
    phend = parse_phenotype_file(p)
    phend.convert_to_averages()
    best = phend.most_normal_transformation(1)
    print("most-normal transformation:", best,
          "W =", round(phend.shapiro_wilk(1), 4))
    if ctx.plots:
        phend.plot_histogram(1, ctx.path("phen_hist.png"))
    else:
        _no_plots("the phenotype histogram")


def example_stepwise(ctx: Ctx):
    """Stepwise MLMM (forward/backward, eBIC/mBIC/mbonf selection)."""
    from mixmogam_tpu_torch.api import emmax_step_wise

    gd2, y, K = _coordinated(ctx)
    sw = emmax_step_wise(gd2, y, K=K, max_steps=4, device=ctx.device)
    for s in sw["steps"]:
        print(f"  {s['phase']:8s} cof={s['cofactors']} "
              f"h2={s['pseudo_heritability']:.3f} ebic={s['ebic']:.1f}")
    print("selected:", {k: v["cofactors"]
                        for k, v in sw["selected"].items()})


def example_multi_trait(ctx: Ctx):
    """50 phenotypes sharing one eigenbasis (BASELINE config #4 shape)."""
    from mixmogam_tpu_torch.api import (calc_ibs_kinship, emmax_multi_trait,
                                        parse_snp_data)

    g, _ = _simulate_files(ctx)
    gd = parse_snp_data(g).filter_mac_snps(5)
    rng = np.random.default_rng(0)
    Y = rng.normal(size=(50, gd.num_samples))
    K = calc_ibs_kinship(gd, device=ctx.device)
    mt = emmax_multi_trait(gd, Y, K=K, device=ctx.device)
    print("per-trait h2 range:",
          round(mt["pseudo_heritabilities"].min(), 3), "-",
          round(mt["pseudo_heritabilities"].max(), 3))
    print("ps shape:", mt["ps"].shape)


def example_permutation(ctx: Ctx):
    """Empirical genome-wide threshold via permutation."""
    from mixmogam_tpu_torch.api import emmax_perm_test

    gd2, y, K = _coordinated(ctx)
    r = emmax_perm_test(gd2, y, K=K, num_perm=50, device=ctx.device)
    print(f"5% empirical threshold over {r['num_perm']} perms:",
          f"{r['threshold']:.2e}")


def example_reference_classes(ctx: Ctx):
    """The reference's class-based workflow, unchanged (compat layer):
    LinearMixedModel + add_random_effect + get_expedited_REMLE +
    emmax_f_test — mixmogam scripts port line-for-line. h2 and delta are
    printed in full."""
    from mixmogam_tpu_torch.compat import LinearMixedModel

    gd2, y, K = _coordinated(ctx)
    lmm = LinearMixedModel(y, device=ctx.device)
    lmm.add_random_effect(K)
    reml = lmm.get_expedited_REMLE()
    print("REML: h2 =", repr(reml["pseudo_heritability"]),
          "delta =", repr(reml["delta"]))
    res = lmm.emmax_f_test(gd2.get_snps())
    print("min p =", f"{res['ps'].min():.2e}")


def example_streaming_at_scale(ctx: Ctx):
    """Scale features on a small cohort: (a) a streamed scan with
    tile-granular checkpoints, (b) a fast int8 tier with exact rescoring of
    the top hits, (c) per-trait missing phenotypes in the multi-trait batch
    (grouped by missingness pattern, exact)."""
    from mixmogam_tpu_torch.data.parsers import parse_snp_data
    from mixmogam_tpu_torch.models.emmax import emmax
    from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
    from mixmogam_tpu_torch.ops.kinship import kinship
    from mixmogam_tpu_torch.oracle.kinship import scale_k

    g, p = _simulate_files(ctx, missing_rate=0.0, tag="scale")
    gd = parse_snp_data(g)
    K = scale_k(kinship(gd, device=ctx.device))
    rng = np.random.default_rng(0)
    y = rng.normal(size=gd.num_samples) + gd.matrix[7].astype(float)

    # (a) force streamed mode + checkpointing (automatic over the card's
    # in-core budget)
    ck = ctx.path("scale_ck")
    st = emmax(gd, y, K=K, stream=True, checkpoint_dir=ck,
               device=ctx.device)
    print("streamed scan min p:", f"{st['ps'].min():.2e}",
          "(resume manifest in", ck + ")")

    # (b) fast int8x2 tier + exact rescore: the reported hits' p-values
    # are exact-grade, the genome-wide pass ran at fast-tier cost
    fast = emmax(gd, y, K=K, precision="int8x2", rescore_top=50,
                 device=ctx.device)
    ex = emmax(gd, y, K=K, device=ctx.device)
    idx = fast["rescored_idx"]
    print(f"rescored {len(idx)} hits; max |p - exact| on them:",
          f"{np.abs(fast['ps'][idx] - ex['ps'][idx]).max():.2e}")

    # (c) multi-trait with per-trait missing phenotypes
    Y = np.stack([y, y + rng.normal(size=len(y))])
    Y[1, rng.random(len(y)) < 0.2] = np.nan
    mt = emmax_multi_trait(gd, Y, K=K, device=ctx.device)
    print("multi-trait dofs (per-trait sample subsets):", mt["dof"])


def example_resident_genome(ctx: Ctx):
    """The device-resident 2-bit genome: pack the cohort once into device
    memory and run the whole study off it — repeated scans, kinship,
    stepwise — with no per-scan host traffic."""
    from mixmogam_tpu_torch.data.parsers import parse_snp_data
    from mixmogam_tpu_torch.models.emmax import emmax
    from mixmogam_tpu_torch.models.resident import ResidentGenome
    from mixmogam_tpu_torch.models.stepwise import emmax_step_wise
    from mixmogam_tpu_torch.ops.kinship import kinship
    from mixmogam_tpu_torch.oracle.kinship import scale_k

    g, p = _simulate_files(ctx, missing_rate=0.0, tag="resident")
    gd = parse_snp_data(g)
    rng = np.random.default_rng(0)
    y = rng.normal(size=gd.num_samples) + gd.matrix[7].astype(float)

    rg = ResidentGenome.from_source(gd, device=ctx.device)  # one upload
    K = scale_k(kinship(rg))                  # kinship from device memory
    res = emmax(rg, y, K=K)                   # scan from device memory
    print("resident scan min p:", f"{res['ps'].min():.2e}",
          f"(packed {rg.nbytes_packed/1e6:.1f} MB for "
          f"{rg.M}x{rg.n} genotypes)")
    sw = emmax_step_wise(rg, y, K=K, max_steps=2)
    print("stepwise over the same container:",
          sw["selected"]["mbonf"]["cofactors"])


def example_plink_and_clumping(ctx: Ctx):
    """PLINK .bed/.bim/.fam in, LD-clumped hits out. The bed payload is
    re-coded to the container's 2-bit layout on the device, never
    decoded on the host."""
    from mixmogam_tpu_torch.data.genotype import GenotypeData
    from mixmogam_tpu_torch.data.plink import (read_plink,
                                               resident_from_plink,
                                               write_plink)
    from mixmogam_tpu_torch.models.resident import emmax_resident
    from mixmogam_tpu_torch.ops.kinship import kinship
    from mixmogam_tpu_torch.oracle.kinship import scale_k
    from mixmogam_tpu_torch.results import Result

    rng = np.random.default_rng(2)
    G = rng.integers(0, 3, (2000, 150)).astype(np.int8)
    G[101] = np.clip(G[100] + (rng.random(150) < 0.05), 0, 2)  # LD proxy
    gd = GenotypeData(G, np.repeat([1, 2], 1000),
                      np.tile(np.arange(1000) * 500, 2),
                      [f"iid{i}" for i in range(150)], ploidy=2)
    prefix = ctx.path("cohort")
    write_plink(prefix, gd)                       # export a fileset

    gd2 = read_plink(prefix)                      # ...and read it back
    y = gd2.matrix[100].astype(float) + rng.normal(size=150) * 0.8
    rg, chroms, poss, ids = resident_from_plink(prefix, device=ctx.device)
    K = scale_k(kinship(rg))
    res = emmax_resident(rg, y, K=K)
    r = Result.from_scan(res, chroms, poss)
    clumps = r.clump(rg, p_threshold=1e-5, window_bp=5000)
    print("clumps (lead <- members):",
          [(c["lead"], c["members"]) for c in clumps[:3]])


def example_loco(ctx: Ctx):
    """Leave-one-chromosome-out association: per-chromosome kinships
    recombine from one extra pass; each chromosome is scanned under the
    null that excludes it."""
    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)
    from mixmogam_tpu_torch.models.emmax import emmax
    from mixmogam_tpu_torch.models.loco import emmax_loco
    from mixmogam_tpu_torch.ops.kinship import kinship
    from mixmogam_tpu_torch.oracle.kinship import scale_k

    G, ch, po = simulate_genotypes(250, 4000, seed=5)
    y, causal = simulate_phenotype(G, h2=0.6, n_causal=4,
                                   causal_effect=1.2, seed=5)
    res = emmax_loco(G, y, ch, ploidy=1, device=ctx.device)
    glob = emmax(G, y, K=scale_k(kinship(G, ploidy=1, device=ctx.device)),
                 device=ctx.device)
    top = np.argsort(res["ps"])[:6]
    print("LOCO top hits:", sorted(top.tolist()), "causal:",
          sorted(causal.tolist()))
    print("per-chrom h2:", {c: round(v["pseudo_heritability"], 3)
                            for c, v in res["loco"].items()},
          "| global h2:", round(glob["pseudo_heritability"], 3))


def example_vcf_and_gblup(ctx: Ctx):
    """VCF in, association + genomic prediction out: the fitted null model
    that whitens the scan is the breeding-value predictor."""
    from mixmogam_tpu_torch.data.genotype import GenotypeData
    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)
    from mixmogam_tpu_torch.data.vcf import read_vcf, write_vcf
    from mixmogam_tpu_torch.models.gblup import gblup_cv, gblup_predict

    G, ch, po = simulate_genotypes(200, 2000, seed=8)
    y, _ = simulate_phenotype(G, h2=0.8, n_causal=200, seed=8)
    gd = GenotypeData(G, ch, po, [f"s{i}" for i in range(200)], ploidy=1)
    path = ctx.path("cohort.vcf.gz")
    write_vcf(gd, path)                      # export VCF (gzipped)
    gd2 = read_vcf(path)                     # ...and read it back

    cv = gblup_cv(gd2, y, n_folds=5, seed=0, device=ctx.device)
    print(f"gBLUP 5-fold CV: r = {cv['r']:.3f} (polygenic h2=0.8 trait)")
    train = np.arange(150)
    new = np.arange(150, 200)                # "unphenotyped" candidates
    y_hat, model = gblup_predict(gd2, y, train, new, device=ctx.device)
    r = np.corrcoef(y_hat, y[new])[0, 1]
    print(f"predicted 50 unphenotyped samples: r = {r:.3f}, "
          f"h2_hat = {model.pseudo_heritability:.2f}")


def example_gxe(ctx: Ctx):
    """SNP x environment interaction under the mixed model. The
    environment is forced into the null; the ranked p-values are the
    1-dof interaction tests (marginal and joint 2-dof alongside)."""
    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)
    from mixmogam_tpu_torch.models.gxe import emmax_gxe
    from mixmogam_tpu_torch.ops.kinship import kinship
    from mixmogam_tpu_torch.oracle.kinship import scale_k

    G, ch, po = simulate_genotypes(250, 3000, seed=4)
    rng = np.random.default_rng(4)
    env = rng.normal(size=250)                   # e.g. temperature
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=8, seed=4)
    y = y + 1.2 * G[1500].astype(float) * env    # plant a GxE effect
    K = scale_k(kinship(G, ploidy=1, device=ctx.device))
    res = emmax_gxe(G, y, env, K=K, device=ctx.device)
    j = int(np.argmin(res["inter_ps"]))
    print(f"top GxE hit: SNP {j} (planted 1500), "
          f"p_inter = {res['inter_ps'][j]:.2e}, "
          f"p_marginal = {res['marginal_ps'][j]:.2e}, "
          f"p_joint = {res['joint_ps'][j]:.2e}")


def example_multi_env_gxe(ctx: Ctx):
    """Multi-environment GxE batch: env is (n, E); the genotype rotation
    is computed once per tile and shared across environments, each
    environment gets its own exact null fit."""
    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)
    from mixmogam_tpu_torch.models.gxe import emmax_gxe
    from mixmogam_tpu_torch.ops.kinship import kinship
    from mixmogam_tpu_torch.oracle.kinship import scale_k

    G, ch, po = simulate_genotypes(250, 3000, seed=9)
    rng = np.random.default_rng(9)
    envs = np.column_stack([rng.normal(size=250),          # temperature
                            (rng.random(250) > 0.5) * 1.0,  # site A/B
                            rng.normal(size=250)])          # rainfall
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=8, seed=9)
    # plant a site-dependent QTL on a common SNP
    mafs = G.mean(axis=1)
    j_qtl = int(np.argmin(np.abs(mafs - 0.5)))
    y = y + 1.6 * G[j_qtl].astype(float) * envs[:, 1]
    K = scale_k(kinship(G, ploidy=1, device=ctx.device))
    res = emmax_gxe(G, y, envs, K=K, device=ctx.device)
    print(f"inter_ps shape (E, M) = {res['inter_ps'].shape}; "
          f"per-env deltas = {np.round(res['deltas'], 3)}")
    for e in range(3):
        j = int(np.argmin(res["inter_ps"][e]))
        print(f"  env {e}: top GxE SNP {j} "
              f"p = {res['inter_ps'][e][j]:.2e}"
              + ("  <- the planted site QTL" if j == j_qtl else ""))


def example_many_phenotypes_missing(ctx: Ctx):
    """A many-phenotype study with per-trait missing phenotype coverage,
    batched over one device-resident genome: traits are grouped by
    missingness pattern, and each group gathers its sample columns on the
    device from the packed 2-bit rows."""
    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)
    from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
    from mixmogam_tpu_torch.models.resident import ResidentGenome
    from mixmogam_tpu_torch.ops.kinship import kinship
    from mixmogam_tpu_torch.oracle.kinship import scale_k

    n, m, T = 200, 2000, 12
    G, ch, po = simulate_genotypes(n, m, seed=12)
    rng = np.random.default_rng(12)
    Y = np.stack([simulate_phenotype(G, h2=0.5, n_causal=5,
                                     seed=12 + t)[0] for t in range(T)])
    # three field seasons -> three missingness patterns over the traits
    Y[0:4, :30] = np.nan
    Y[4:8, 150:] = np.nan
    K = scale_k(kinship(G, ploidy=1, device=ctx.device))
    rg = ResidentGenome.from_source(G, device=ctx.device)   # one upload
    res = emmax_multi_trait(rg, Y, K=K)
    n_pat = len({tuple(np.isnan(Y[t])) for t in range(T)})
    print(f"{T} traits, {n_pat} missingness patterns, genome resident "
          f"2-bit on {rg.device}; ps shape = {res['ps'].shape}")
    n_sig = int((np.min(res["ps"], axis=1) < 0.05 / m).sum())
    print(f"{n_sig}/{T} traits carry a Bonferroni-significant hit")


def example_cohort_vcf_packed(ctx: Ctx):
    """Cohort-scale VCF -> device-resident container without ever holding
    the (M, n) int8 matrix: the parser feeds the device packer chunk by
    chunk. Also: read_vcf(field='DS') for imputed dosages."""
    from mixmogam_tpu_torch.data.genotype import GenotypeData
    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)
    from mixmogam_tpu_torch.data.vcf import (read_vcf, read_vcf_packed,
                                             write_vcf)
    from mixmogam_tpu_torch.models.emmax import emmax
    from mixmogam_tpu_torch.ops.kinship import kinship
    from mixmogam_tpu_torch.oracle.kinship import scale_k

    G, ch, po = simulate_genotypes(150, 3000, seed=21)
    y, causal = simulate_phenotype(G, h2=0.6, n_causal=4, seed=21)
    gd = GenotypeData(G, ch, po, [f"s{i}" for i in range(150)], ploidy=1)
    path = ctx.path("cohort_big.vcf.gz")
    write_vcf(gd, path)

    rg, meta = read_vcf_packed(path, tile=1024, device=ctx.device)
    print(f"packed container: {rg.shape}, "
          f"{rg.nbytes_packed / 1e3:.0f} KB packed "
          f"(int8 would be {rg.M * rg.n / 1e3:.0f} KB)")
    K = scale_k(kinship(rg))
    res = emmax(rg, y, K=K)
    top = np.argsort(res["ps"])[:6]
    hits = len(set(po[causal]) & set(meta["positions"][top]))
    print(f"EMMAX off the VCF-packed container: {hits}/4 causal in "
          f"top 6")

    # DS (imputed dosage) read: fractional dosages -> float container
    ds_path = ctx.path("dosages.vcf")
    with open(ds_path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL"
                "\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(f"s{i}" for i in range(4)) + "\n")
        f.write("1\t100\t.\tA\tG\t.\t.\t.\tDS\t0.12\t1.40\t1.96\t.\n")
    dd = read_vcf(ds_path, field="DS")
    print(f"DS read -> {type(dd).__name__}, dosages {dd.matrix[0]} "
          "(NaN = missing; routed to the non-int8 tiers)")


def example_mesh_campaign(ctx: Ctx):
    """The campaign's entry points through mesh=: stepwise MLMM, LOCO, GxE,
    the permutation sweep, multi-trait with a missing phenotype block, EMMA
    and Kruskal-Wallis, each SNP-sharded over the ranks of make_mesh()
    (nulls on rank 0 and broadcast, a rank's rows scanned, one gather). A
    lone process is a world of one; under torchrun the same code spans
    every rank. The JAX example's cohort, 96 x 600."""
    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)
    from mixmogam_tpu_torch.models.emma import emma
    from mixmogam_tpu_torch.models.gxe import emmax_gxe
    from mixmogam_tpu_torch.models.linear import kruskal_wallis
    from mixmogam_tpu_torch.models.loco import emmax_loco
    from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
    from mixmogam_tpu_torch.models.permutation import emmax_perm_test
    from mixmogam_tpu_torch.models.stepwise import emmax_step_wise
    from mixmogam_tpu_torch.oracle.kinship import ibs_kinship, scale_k
    from mixmogam_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=ctx.device)
    shape = {"snp": mesh.shape[0], "sample": mesh.shape[1]}
    G, ch, po = simulate_genotypes(96, 600, seed=30)
    y, causal = simulate_phenotype(G, h2=0.6, n_causal=3, seed=30)
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    sw = emmax_step_wise(G, y, K=K, max_steps=3, mesh=mesh)
    print(f"mesh {shape}: stepwise selected "
          f"{sw['selected']['ebic']['cofactors']} (causal: "
          f"{sorted(int(c) for c in causal)})")
    lc = emmax_loco(G, y, chromosomes=ch, ploidy=1, mesh=mesh)
    print(f"LOCO min p {np.min(lc['ps']):.2e} over "
          f"{len(lc['loco'])} chromosomes")
    rng = np.random.default_rng(1)
    env = (rng.random(96) < 0.5).astype(np.float64)
    gx = emmax_gxe(G, y, env, K=K, mesh=mesh)
    pm = emmax_perm_test(G, y, K=K, num_perm=16, seed=2, mesh=mesh)
    print(f"GxE min interaction p {np.min(gx['inter_ps']):.2e}; "
          f"permutation threshold {pm['threshold']:.2e}")
    Y = np.stack([y, y * 0.5 + rng.normal(size=96)])
    Y[1, :9] = np.nan
    mt = emmax_multi_trait(G, Y, K=K, mesh=mesh)
    em = emma(G, y, K=K, tile=64, mesh=mesh)
    kw = kruskal_wallis(G, y, mesh=mesh)
    print(f"multi-trait min p {np.min(mt['ps']):.2e} (T=2, one trait "
          f"9 samples missing); EMMA exact min p {np.min(em['ps']):.2e}; "
          f"KW min p {np.min(kw['ps']):.2e} - all mesh-sharded")


EXAMPLES = {
    "emmax": example_emmax,
    "mesh_campaign": example_mesh_campaign,
    "multi_env_gxe": example_multi_env_gxe,
    "many_phenotypes_missing": example_many_phenotypes_missing,
    "cohort_vcf_packed": example_cohort_vcf_packed,
    "loco": example_loco,
    "vcf_and_gblup": example_vcf_and_gblup,
    "gxe": example_gxe,
    "streaming_at_scale": example_streaming_at_scale,
    "resident_genome": example_resident_genome,
    "plink_and_clumping": example_plink_and_clumping,
    "precision_tiers": example_precision_tiers,
    "lm": example_linear_model,
    "transforms": example_transformations,
    "stepwise": example_stepwise,
    "multitrait": example_multi_trait,
    "permutation": example_permutation,
    "reference_classes": example_reference_classes,
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", metavar="name",
                    help=f"scenarios to run (default: all): "
                         f"{', '.join(EXAMPLES)}")
    ap.add_argument("--device", default=None,
                    help="the entry points' device (default: the card)")
    ap.add_argument("--out", default=None,
                    help="output directory (default: a temporary one, "
                         "removed at the end)")
    ap.add_argument("--samples", type=int, default=300,
                    help="samples of the shared simulated cohort")
    ap.add_argument("--snps", type=int, default=5_000,
                    help="SNPs of the shared simulated cohort")
    args = ap.parse_args(argv)
    unknown = [n for n in args.names if n not in EXAMPLES]
    if unknown:
        ap.error(f"unknown example(s) {unknown}; choose from "
                 f"{list(EXAMPLES)}")
    tmp = None
    if args.out is None:
        tmp = tempfile.TemporaryDirectory(prefix="mixmogam_examples_")
        out = tmp.name
    else:
        out = args.out
        os.makedirs(out, exist_ok=True)
    ctx = Ctx(out=out, device=args.device, samples=args.samples,
              snps=args.snps)
    try:
        for name in args.names or list(EXAMPLES):
            print(f"=== {name} ===", flush=True)
            t0 = time.perf_counter()
            EXAMPLES[name](ctx)
            print(f"[example] {name}: {time.perf_counter() - t0:.3f} s",
                  flush=True)
    finally:
        if tmp is not None:
            tmp.cleanup()
    return 0


if __name__ == "__main__":
    sys.exit(main())
