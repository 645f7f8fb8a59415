"""PyTorch port, the facade: mixmogam_tpu_torch.api.run_gwas (device="cpu",
float64) against mixmogam_tpu.api.run_gwas from the same files. Limits:
max |dp| <= 1e-9 at the exact tier and at bf16x3 (the split-W parts are
bit-equal to the JAX package's split of the same folded W'':
tests/test_torch_fold.py), max |dlog10 p| < 1e-4 at int8x3
(tests/test_torch_emmax.py); identical samples, SNPs, CSV header and
summary keys."""

import json
import os

import numpy as np
import pytest
import torch

import mixmogam_tpu_torch
from mixmogam_tpu import api as japi
from mixmogam_tpu.data import simulate as jsim
from mixmogam_tpu_torch import api
from mixmogam_tpu_torch.data.genotype import GenotypeData
from mixmogam_tpu_torch.data.phenotype import PhenotypeData
from mixmogam_tpu_torch.data.plink import write_plink
from mixmogam_tpu_torch.models.emmax import emmax
from mixmogam_tpu_torch.oracle import kinship as oracle
from test_torch_fold import fold_jax_tiers

torch.set_num_threads(1)
N, M = 150, 1500


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A genotype CSV (binary coding, 5 chromosomes) and a phenotype file
    with the trait (pid 1, positive values), two covariates (pid 2
    complete, pid 3 missing for some samples) and samples the genotypes
    lack; 10 genotyped samples have no phenotype."""
    d = tmp_path_factory.mktemp("api")
    G, ch, po = jsim.simulate_genotypes(N, M, ploidy=1, seed=17)
    acc = [f"acc{i:03d}" for i in range(N)]
    gd = GenotypeData(G, ch, po, acc, ploidy=1)
    y, _ = jsim.simulate_phenotype(G, h2=0.5, n_causal=5, seed=17)
    rng = np.random.default_rng(17)
    keep = np.sort(rng.permutation(N)[:N - 10])
    ph = PhenotypeData()
    ecos = [acc[i] for i in keep] + ["stranger1", "stranger2"]
    ph.add_phenotype(1, "trait", ecos,
                     np.r_[np.exp(0.3 * y[keep]), 1.0, 2.0])
    ph.add_phenotype(2, "cov_a", ecos, rng.normal(size=len(ecos)))
    c3 = rng.normal(size=len(ecos))
    c3[rng.permutation(len(keep))[:12]] = np.nan
    ph.add_phenotype(3, "cov_b", ecos, c3)
    g, p = str(d / "geno.csv"), str(d / "pheno.csv")
    gd.write_csv(g)
    ph.write_to_file(p)
    return {"dir": d, "geno": g, "pheno": p, "gd": gd}


def _both(files, name, **kw):
    out = {}
    for tag, mod, extra in (("jax", japi, {}),
                            ("port", api, {"device": "cpu"})):
        prefix = str(files["dir"] / f"{name}_{tag}")
        out[tag] = mod.run_gwas(files["geno"], files["pheno"], plots=False,
                                out_prefix=prefix, **kw, **extra)
    return out["jax"], out["port"]


def _same_run(ref, res, limit=1e-9, log10=False):
    assert res["genotype"].accessions == ref["genotype"].accessions
    np.testing.assert_array_equal(res["genotype"].positions,
                                  ref["genotype"].positions)
    np.testing.assert_array_equal(res["genotype"].chromosomes,
                                  ref["genotype"].chromosomes)
    np.testing.assert_array_equal(res["y"], ref["y"])
    ps, jps = res["scan"]["ps"], np.asarray(ref["scan"]["ps"])
    assert ps.shape == jps.shape
    if log10:
        assert np.abs(np.log10(ps) - np.log10(jps)).max() < limit
    else:
        assert np.abs(ps - jps).max() <= limit
    assert sorted(res["files"]) == sorted(ref["files"])
    with open(res["files"]["pvals"]) as a, open(ref["files"]["pvals"]) as b:
        la, lb = a.read().splitlines(), b.read().splitlines()
    assert la[0] == lb[0] and len(la) == len(lb) == len(ps) + 1
    with open(res["files"]["summary"]) as a, \
            open(ref["files"]["summary"]) as b:
        sa, sb = json.load(a), json.load(b)
    assert sorted(sa) == sorted(sb)
    assert sorted(sa["timings_s"]) == sorted(sb["timings_s"])
    for k in ("method", "pid", "n_samples", "n_snps", "bonferroni"):
        assert sa[k] == sb[k]
    assert sorted(res["timings"]) == sorted(ref["timings"])
    return la, lb


def test_emmax_exact_matches_jax(files):
    ref, res = _both(files, "exact")
    la, lb = _same_run(ref, res)
    assert res["genotype"].num_samples == N - 10
    # the ranked CSV: the same SNPs in the same order, the same p-values
    ca = np.array([l.split(",")[:2] for l in la[1:]], dtype=np.int64)
    cb = np.array([l.split(",")[:2] for l in lb[1:]], dtype=np.int64)
    np.testing.assert_array_equal(ca[:50], cb[:50])
    pa = np.array([float(l.split(",")[2]) for l in la[1:]])
    np.testing.assert_array_equal(pa, np.sort(res["scan"]["ps"]))
    for k in ("pseudo_heritability", "delta"):
        assert abs(res["scan"][k] - ref["scan"][k]) < 1e-8
    with open(res["files"]["metrics"]) as f:
        met = json.load(f)
    assert met["metrics"]["device"] == "cpu"
    assert set(met["phases_s"]) == {"parse", "coordinate", "kinship",
                                    "scan"}


@pytest.mark.parametrize("tier,limit,log10", [("int8x3", 1e-4, True),
                                              ("bf16x3", 1e-9, False)])
def test_emmax_fast_tiers_match_jax(files, tier, limit, log10, monkeypatch):
    # the JAX reference quantizes the port's folded W'' (test_torch_fold.py)
    fold_jax_tiers(monkeypatch)
    ref, res = _both(files, tier, precision=tier)
    _same_run(ref, res, limit, log10)
    assert res["scan"]["precision_tier"] == tier


def test_covariate_pids_match_jax(files):
    """pid 3 lacks 12 samples: one coordinated drop, then the design."""
    ref, res = _both(files, "cov", covariate_pids=[2, 3])
    _same_run(ref, res)
    assert res["genotype"].num_samples < N - 10
    assert res["scan"]["dof"] == ref["scan"]["dof"] == \
        res["genotype"].num_samples - 4


def test_user_design_composes_with_covariates(files):
    rng = np.random.default_rng(3)
    X0 = np.column_stack([np.ones(N - 10), rng.normal(size=N - 10)])
    ref, res = _both(files, "x0", X0=X0)
    _same_run(ref, res)
    # rows given on the pre-drop coordinated set are subset with it
    ref, res = _both(files, "x0cov", X0=X0, covariate_pids=[3])
    _same_run(ref, res)
    assert res["scan"]["dof"] == res["genotype"].num_samples - 4
    with pytest.raises(ValueError, match="coordinated samples remain"):
        api.run_gwas(files["geno"], files["pheno"], plots=False,
                     X0=X0[:50], covariate_pids=[3], device="cpu")


@pytest.mark.parametrize("transform", ["log", "most_normal"])
def test_transform_matches_jax(files, transform):
    ref, res = _both(files, f"tr_{transform}", transform=transform)
    _same_run(ref, res)


def test_kinship_file_is_prepared_to_the_samples(files):
    """A kinship saved over ALL genotyped samples, in another order, is
    subset and reordered to the coordinated samples by prepare_k."""
    gd = files["gd"]
    perm = np.random.default_rng(5).permutation(N)
    K = oracle.scale_k(oracle.ibs_kinship(
        gd.matrix[:, perm].astype(np.float64)))
    kf = str(files["dir"] / "kin.npz")
    api.save_kinship_to_file(kf, K, [gd.accessions[i] for i in perm])
    ref, res = _both(files, "kfile", kinship_file=kf)
    _same_run(ref, res)
    base = api.run_gwas(files["geno"], files["pheno"], plots=False,
                        device="cpu")
    # K over all samples differs from K over the coordinated ones
    assert np.abs(base["scan"]["ps"] - res["scan"]["ps"]).max() > 1e-6


def test_cache_dir_hit_in_both_directions(files):
    """The kinship cache written by one package is read by the other: the
    same entry name, and a poisoned entry shows in the reader's result."""
    dj, dp = str(files["dir"] / "cache_j"), str(files["dir"] / "cache_p")
    ref, _ = _both(files, "c0")
    japi.run_gwas(files["geno"], files["pheno"], plots=False, cache_dir=dj)
    first = api.run_gwas(files["geno"], files["pheno"], plots=False,
                         cache_dir=dp, device="cpu")
    assert os.listdir(dj) == os.listdir(dp) and len(os.listdir(dp)) == 1
    hit = api.run_gwas(files["geno"], files["pheno"], plots=False,
                       cache_dir=dj, device="cpu")      # JAX's entry
    np.testing.assert_array_equal(hit["scan"]["ps"], first["scan"]["ps"])
    jhit = japi.run_gwas(files["geno"], files["pheno"], plots=False,
                         cache_dir=dp)                   # the port's entry
    assert np.abs(jhit["scan"]["ps"] - ref["scan"]["ps"]).max() <= 1e-12
    f = os.path.join(dj, os.listdir(dj)[0])
    K, acc = api.load_kinship_from_file(f)
    api.save_kinship_to_file(f, np.eye(len(acc)), acc)
    poisoned = api.run_gwas(files["geno"], files["pheno"], plots=False,
                            cache_dir=dj, device="cpu")
    assert np.abs(poisoned["scan"]["ps"] - first["scan"]["ps"]).max() > 1e-6


def test_emmax_loco_matches_jax(files):
    ref, res = _both(files, "loco", method="emmax_loco")
    _same_run(ref, res)
    assert set(res["scan"]["loco"]) == set(ref["scan"]["loco"])
    assert "kinship" not in res["timings"]
    # the kinship cache_dir doubles as LOCO's eigen cache: a second run
    # finds every chromosome's (phi, U) and adds no entry. (From a
    # GenotypeData the JAX package builds explicit kinships and keys them
    # by their own bytes; the keys the packages share are the resident
    # route's, held in tests/test_torch_loco.py.)
    d = str(files["dir"] / "cache_loco")
    a = api.run_gwas(files["geno"], files["pheno"], plots=False,
                     method="emmax_loco", cache_dir=d, device="cpu")
    entries = sorted(os.listdir(d))
    assert len(entries) == len(res["scan"]["loco"])
    key = res["genotype"].content_hash()
    assert all(e.startswith(f"loco_eigen_{key}_ibs_p1_") for e in entries)
    b = api.run_gwas(files["geno"], files["pheno"], plots=False,
                     method="emmax_loco", cache_dir=d, device="cpu")
    assert sorted(os.listdir(d)) == entries
    np.testing.assert_array_equal(a["scan"]["ps"], b["scan"]["ps"])


def test_plink_input_with_missing_and_vanraden(files):
    """A PLINK fileset with missing calls: the facade's float kinships
    (IBS and VanRaden) against the port's emmax under the float64 oracle
    kinship of the same rows (1e-9), and against the JAX facade, whose
    float kinships accumulate in float32 (1e-4)."""
    gd = files["gd"]
    rng = np.random.default_rng(9)
    Gm = np.where(rng.random(gd.matrix.shape) < 0.02, -1,
                  gd.matrix * 2).astype(np.int8)
    Gm[::3] = np.where(Gm[::3] == 2, 1, Gm[::3])
    prefix = str(files["dir"] / "bed")
    write_plink(prefix, GenotypeData(Gm, gd.chromosomes, gd.positions,
                                     gd.accessions, ploidy=2))
    for km in ("ibs", "vanraden"):
        kw = dict(data_format="plink", plots=False, kinship_method=km)
        res = api.run_gwas(prefix + ".bed", files["pheno"], device="cpu",
                           **kw)
        g2 = res["genotype"]
        assert g2.ploidy == 2 and (g2.matrix < 0).any()
        Z = np.where(g2.matrix < 0, np.nan, g2.matrix.astype(np.float64))
        K = oracle.scale_k((oracle.ibs_kinship if km == "ibs" else
                            oracle.vanraden_kinship)(Z, ploidy=2))
        direct = emmax(g2, res["y"], K=K, device="cpu")
        assert np.abs(res["scan"]["ps"] - direct["ps"]).max() <= 1e-9
        ref = japi.run_gwas(prefix + ".bed", files["pheno"], **kw)
        assert ref["genotype"].accessions == g2.accessions
        np.testing.assert_array_equal(ref["genotype"].matrix, g2.matrix)
        assert np.abs(res["scan"]["ps"] - ref["scan"]["ps"]).max() <= 1e-4


def test_emmax_stepwise_matches_jax(files):
    """method='emmax_stepwise' from the same files, with the covariates:
    the same cofactor path and selected models, no ranked CSV, the same
    summary keys."""
    ref, res = _both(files, "sw", method="emmax_stepwise", num_steps=2,
                     covariate_pids=[2])
    assert res["scan"]["ps"] is None and res["result"] is None
    sw, jsw = res["scan"]["stepwise"], ref["scan"]["stepwise"]
    assert [s["cofactors"] for s in sw["steps"]] == [
        s["cofactors"] for s in jsw["steps"]]
    assert sw["selected"] == jsw["selected"]
    for a, b in zip(sw["steps"], jsw["steps"]):
        for k in ("bic", "ebic", "mbic", "delta"):
            assert abs(a[k] - b[k]) <= 1e-8 * max(1.0, abs(b[k])), k
    assert sorted(res["files"]) == sorted(ref["files"]) == [
        "metrics", "summary"]
    with open(res["files"]["summary"]) as f, \
            open(ref["files"]["summary"]) as g:
        assert sorted(json.load(f)) == sorted(json.load(g))


@pytest.mark.parametrize("method", ["emma", "lm", "anova", "kw",
                                    "emmax_gxe"])
def test_unported_methods_raise_before_parsing(method):
    """Every method of the JAX package's run_gwas is ported: emma, lm,
    anova, kw and emmax_gxe (given its env_pid) pass the method check and
    reach the file read (the paths do not exist)."""
    kw = {"env_pid": 2} if method == "emmax_gxe" else {}
    with pytest.raises(FileNotFoundError, match="no_such"):
        api.run_gwas("no_such.csv", "no_such_pheno.csv", method=method,
                     device="cpu", **kw)
    with pytest.raises(FileNotFoundError, match="no_such"):
        api.run_gwas_multi("no_such.csv", "no_such_pheno.csv",
                           method=method, device="cpu", **kw)


def test_other_refusals_come_before_parsing():
    with pytest.raises(ValueError, match="unknown method"):
        api.run_gwas("no_such.csv", "no_such_pheno.csv", method="nope",
                     device="cpu")
    # batched=True runs (tests/test_torch_multitrait.py holds it to the
    # JAX package); its refusals of a method and of an unknown kwarg come
    # before parsing too
    with pytest.raises(ValueError, match="batched=False"):
        api.run_gwas_multi("no_such.csv", "no_such_pheno.csv",
                           batched=True, method="kw", device="cpu")
    for bad in (np.float32, "float32"):
        with pytest.raises(TypeError, match="torch floating dtype"):
            api.run_gwas("no_such.csv", "no_such_pheno.csv", dtype=bad,
                         device="cpu")
    with pytest.raises(FileNotFoundError):
        api.run_gwas("no_such.csv", "no_such_pheno.csv", device="cpu")


def test_default_device_is_the_card_or_an_error(files):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    for call in (
            lambda: api.run_gwas("no_such.csv", "no_such_pheno.csv"),
            lambda: api.run_gwas_multi(files["geno"], files["pheno"]),
            lambda: api.calc_ibs_kinship(files["gd"]),
            lambda: api.calc_ibd_kinship(files["gd"].matrix)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


@pytest.mark.parametrize("kw,packs", [
    (dict(), 1), (dict(precision="int8x3"), 2), (dict(precision="bf16x3"), 2),
    (dict(method="emmax_loco"), 1)])
def test_run_gwas_counts_its_packings(files, kw, packs):
    """ResidentGenome.packs counts from_source calls as the kernel wrappers
    count launches: the exact tier packs the genome once (for the kinship)
    and scans in-core, a fast tier packs it again for the resident scan,
    LOCO packs it once for its grams and its scan."""
    from mixmogam_tpu_torch.models.resident import ResidentGenome

    ResidentGenome.packs = 0
    api.run_gwas(files["geno"], files["pheno"], plots=False, device="cpu",
                 **kw)
    assert ResidentGenome.packs == packs


def test_run_gwas_multi_loops(files):
    out = api.run_gwas_multi(files["geno"], files["pheno"], pids=[1, 2],
                             out_prefix=str(files["dir"] / "multi"),
                             plots=False, device="cpu")
    ref = japi.run_gwas_multi(files["geno"], files["pheno"], pids=[1, 2],
                              plots=False)
    assert sorted(out) == [1, 2]
    for pid in (1, 2):
        assert np.abs(out[pid]["scan"]["ps"]
                      - ref[pid]["scan"]["ps"]).max() <= 1e-9
        assert os.path.exists(str(files["dir"] / f"multi.pid{pid}.pvals.csv"))
    assert api.run_gwas_multi(files["geno"], files["pheno"], pids=[],
                              device="cpu") == {}


def test_calc_kinship_and_float32(files):
    gd = files["gd"]
    K = api.calc_ibs_kinship(gd, device="cpu")
    np.testing.assert_array_equal(K, japi.calc_ibs_kinship(
        gd.matrix, use_device=False))
    Kv = api.calc_ibd_kinship(gd.matrix, scale=False, device="cpu")
    assert np.abs(Kv - oracle.vanraden_kinship(
        gd.matrix.astype(np.float64), ploidy=1)).max() <= 1e-10
    r32 = api.run_gwas(files["geno"], files["pheno"], plots=False,
                       dtype=torch.float32, device="cpu")
    r64 = api.run_gwas(files["geno"], files["pheno"], plots=False,
                       device="cpu")
    assert 0 < np.abs(r32["scan"]["ps"] - r64["scan"]["ps"]).max() < 1e-4


def test_plots_and_profile(files):
    d = files["dir"]
    out = api.run_gwas(files["geno"], files["pheno"], device="cpu",
                       out_prefix=str(d / "plots"),
                       profile_dir=str(d / "prof"))
    for k in ("manhattan", "qq", "pvals", "summary", "metrics"):
        assert os.path.getsize(out["files"][k]) > 0
    traces = os.listdir(d / "prof")
    assert len(traces) == 1 and traces[0].endswith(".json")


def test_lazy_facade():
    assert mixmogam_tpu_torch.run_gwas is api.run_gwas
    assert mixmogam_tpu_torch.GenotypeData is GenotypeData
    assert mixmogam_tpu_torch.PhenotypeData is PhenotypeData
    assert mixmogam_tpu_torch.emmax is emmax is api.emmax
    from mixmogam_tpu_torch.ops.kinship import kinship

    assert mixmogam_tpu_torch.kinship is kinship
    from mixmogam_tpu_torch.models.emma import emma
    from mixmogam_tpu_torch.models.linear import kruskal_wallis

    assert mixmogam_tpu_torch.emma is api.emma is emma
    assert mixmogam_tpu_torch.kruskal_wallis is kruskal_wallis
    from mixmogam_tpu_torch.models.gxe import emmax_gxe

    assert mixmogam_tpu_torch.emmax_gxe is api.emmax_gxe is emmax_gxe
