"""PyTorch port, the fixed-effects per-SNP tests (mixmogam_tpu_torch/models/
linear.py: linear_model, anova, kruskal_wallis; models/emmax.py:
emmax_anova) against the JAX package's under x64, float64 on both sides,
on the CPU, with the facade's methods 'lm', 'anova' and 'kw'.

Limits: p within 1e-10 and identical masks (validity for anova / kw, where
p < 1). chi2_sf_host, f_sf_host and subdivide_tile are pinned to the JAX
package's originals."""

import importlib
import json

import numpy as np
import pytest
import torch

from mixmogam_tpu import api as japi
from mixmogam_tpu.models import resident as jresident
from mixmogam_tpu.ops import stats as jstats
from mixmogam_tpu_torch import api, cli
from mixmogam_tpu_torch.data.genotype import GenotypeData
from mixmogam_tpu_torch.data.phenotype import PhenotypeData
from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                              simulate_phenotype)
from mixmogam_tpu_torch.models import linear
from mixmogam_tpu_torch.models.emmax import emmax, emmax_anova
from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                subdivide_tile)
from mixmogam_tpu_torch.ops import stats
from mixmogam_tpu_torch.oracle.kinship import (ibs_kinship, scale_k,
                                               vanraden_kinship)

jlin = importlib.import_module("mixmogam_tpu.models.linear")
jemmax = importlib.import_module("mixmogam_tpu.models.emmax")
torch.set_num_threads(1)
N, M = 96, 160


def _genome(ploidy, missing, seed=31):
    G, _, _ = simulate_genotypes(N, M, ploidy=ploidy, missing_rate=missing,
                                 seed=seed)
    y, _ = simulate_phenotype(np.where(G < 0, 0, G), h2=0.5, n_causal=3,
                              seed=seed)
    return G, y


def _same(got, ref, mask_key="mask"):
    ref_ps = np.asarray(ref["ps"])
    if mask_key in ref:
        np.testing.assert_array_equal(got[mask_key], np.asarray(ref[mask_key]))
    np.testing.assert_array_equal(got["ps"] < 1.0, ref_ps < 1.0)
    np.testing.assert_allclose(got["ps"], ref_ps, rtol=0, atol=1e-10)


@pytest.mark.parametrize("x", [0.0, 1e-12, 0.5, 3.84, 40.0, 1500.0])
@pytest.mark.parametrize("df", [1.0, 2.0, 7.0])
def test_chi2_and_f_sf_host_are_the_originals(x, df):
    assert stats.chi2_sf_host(x, df) == jstats.chi2_sf_host(x, df)
    assert stats.f_sf_host(x, df, 90.0) == jstats.f_sf_host(x, df, 90.0)


@pytest.mark.parametrize("tile", [1, 7, 2048, 2049, 4096, 16_384, 12_288,
                                  65_536])
def test_subdivide_tile_is_the_original(tile):
    assert subdivide_tile(tile) == jresident.subdivide_tile(tile)
    assert subdivide_tile(tile, 512) == jresident.subdivide_tile(tile, 512)


# ---- linear_model ----------------------------------------------------

@pytest.mark.parametrize("source", ["array", "resident", "covariate",
                                    "missing", "genotype_data"])
def test_linear_model_matches_jax(source):
    G, y = _genome(1, 0.04 if source == "missing" else 0.0)
    G = G.copy()
    G[5] = 1                                      # inside the intercept
    X0 = None
    if source == "covariate":
        X0 = np.column_stack([np.ones(N),
                              np.random.default_rng(2).normal(size=N)])
    src = G
    if source in ("resident", "missing"):
        src = ResidentGenome.from_source(G, tile=64, device="cpu")
    if source == "genotype_data":
        src = GenotypeData(G, np.ones(M, int), np.arange(M), [
            f"s{i}" for i in range(N)], ploidy=1)
    got = linear.linear_model(src, y, X0=X0, tile=48, device="cpu")
    jG = G.astype(np.float64)
    if source == "missing":
        jG[G < 0] = np.nan
        jG = np.where(np.isnan(jG), np.nanmean(jG, axis=1)[:, None], jG)
    ref = jlin.linear_model(jG, y, X0=X0, tile=48)
    _same(got, ref)
    assert not got["mask"][5] and got["ps"][5] == 1.0
    assert got["dof"] == ref["dof"]
    for k in ("f_stats", "betas", "var_perc"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-10,
                                   atol=1e-12)


def test_linear_model_one_k3_call_a_tile(monkeypatch):
    """Each tile reaches the scan kernel's wrapper once, and nothing else
    scans (K3's plain version on the CPU)."""
    from mixmogam_tpu_torch.ops import hopper_scan

    G, y = _genome(1, 0.0)
    calls = []
    real = hopper_scan.scan_stats
    monkeypatch.setattr(hopper_scan, "scan_stats",
                        lambda Xr, *a, **k: calls.append(Xr.shape[0])
                        or real(Xr, *a, **k))
    linear.linear_model(ResidentGenome.from_source(G, tile=64, device="cpu"),
                        y)
    assert calls == [64, 64, 32]


# ---- anova and Kruskal-Wallis ----------------------------------------

@pytest.mark.parametrize("ploidy,missing", [(1, 0.0), (2, 0.0), (1, 0.05),
                                            (2, 0.05)])
@pytest.mark.parametrize("resident", [False, True])
def test_anova_matches_jax(ploidy, missing, resident):
    G, y = _genome(ploidy, missing)
    src = (ResidentGenome.from_source(G, tile=64, device="cpu") if resident
           else G)
    got = linear.anova(src, y, device="cpu")
    ref = jlin.anova(G, y)
    _same(got, ref)
    for k in ("f_stats", "dof1", "dof2"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("ploidy,missing,ties", [
    (1, 0.0, False), (2, 0.0, True), (1, 0.05, False), (2, 0.05, True),
    (1, 0.05, True)])
@pytest.mark.parametrize("resident", [False, True])
def test_kruskal_wallis_matches_jax(ploidy, missing, ties, resident):
    """Fully observed (one global rank vector) and missing calls (each
    SNP's observed subset ranked), with and without ties in y."""
    G, y = _genome(ploidy, missing)
    if ties:
        y = np.round(y, 1)
    src = (ResidentGenome.from_source(G, tile=64, device="cpu") if resident
           else G)
    got = linear.kruskal_wallis(src, y, tile=40, device="cpu")
    ref = jlin.kruskal_wallis(G, y, tile=40)
    _same(got, ref)
    np.testing.assert_allclose(got["stats"], np.asarray(ref["stats"]),
                               rtol=1e-10, atol=1e-10)


def test_class_tests_take_float_sources():
    """NaN = missing, fractional dosages classify by the nearest class."""
    G, y = _genome(2, 0.05)
    Gf = G.astype(np.float64)
    Gf[G < 0] = np.nan
    Gf[0, :10] += 0.3
    for fn in ("anova", "kruskal_wallis"):
        _same(getattr(linear, fn)(Gf, y, device="cpu"),
              getattr(jlin, fn)(Gf, y))


# ---- emmax_anova -----------------------------------------------------

@pytest.fixture(scope="module")
def diploid():
    G, y = _genome(2, 0.0, seed=33)
    G = G.copy()
    G[4] = 1                                      # every sample heterozygous
    G[9] = 2                                      # every sample homozygous
    K = scale_k(ibs_kinship(G.astype(np.float64), ploidy=2))
    return G, y, K


def test_emmax_anova_binary_is_emmax():
    G, y = _genome(1, 0.0)
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    a = emmax_anova(G, y, K=K, device="cpu")
    b = emmax(G, y, K=K, tile=4096, device="cpu")
    assert sorted(a) == sorted(b)
    for k in ("ps", "f_stats", "mask", "betas"):
        np.testing.assert_array_equal(a[k], b[k])
    c = emmax_anova(G, y, K=K, precision="bf16x3", device="cpu")
    np.testing.assert_array_equal(
        c["ps"], emmax(G, y, K=K, tile=4096, precision="bf16x3",
                       device="cpu")["ps"])


@pytest.mark.parametrize("covariate", [False, True])
def test_emmax_anova_diploid_matches_jax(diploid, covariate):
    G, y, K = diploid
    X0 = None
    if covariate:
        X0 = np.column_stack([np.ones(N),
                              np.random.default_rng(4).normal(size=N)])
    got = emmax_anova(G, y, K=K, X0=X0, tile=64, device="cpu")
    ref = jemmax.emmax_anova(G, y, K=K, X0=X0, tile=64)
    _same(got, ref)
    for k in ("f_stats", "dof1", "dof2"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-10,
                                   atol=1e-12)
    assert got["delta"] == pytest.approx(ref["delta"], rel=1e-10)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_emmax_anova_masks_an_indicator_inside_the_design(diploid, dtype):
    """The all-heterozygous SNP's I1 is the intercept and its I2 is zero:
    no column is left (d1 = 0, masked, p = 1), also in float32 where the
    projected W leaves rounding noise of I1; the all-homozygous SNP too."""
    G, y, K = diploid
    got = emmax_anova(G, y, K=K, dtype=dtype, device="cpu")
    for j in (4, 9):
        assert got["dof1"][j] == 0 and not got["mask"][j]
        assert got["ps"][j] == 1.0
    assert got["mask"].sum() >= M - 10


def test_emmax_anova_singular_k_float32_vs_float64():
    """VanRaden's K (a zero eigenvalue along the intercept; n = 256, seed
    3) with the null's delta at its lower bound: the float32 pair test on
    the projected W against float64, identical masks, max |dp| <= 1e-4."""
    G, _, _ = simulate_genotypes(256, 3_000, ploidy=2, seed=3)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=4, seed=3)
    K = scale_k(vanraden_kinship(G.astype(np.float64), ploidy=2))
    a = emmax_anova(G[:200], y, K=K, dtype=torch.float32, device="cpu")
    b = emmax_anova(G[:200], y, K=K, device="cpu")
    assert b["delta"] == pytest.approx(np.exp(-10.0), rel=1e-6)
    np.testing.assert_array_equal(a["mask"], b["mask"])
    assert np.abs(a["ps"] - b["ps"]).max() <= 1e-4


def test_emmax_anova_diploid_refuses_tier_kwargs(diploid):
    G, y, K = diploid
    with pytest.raises(TypeError, match="does not accept"):
        emmax_anova(G, y, K=K, precision="bf16x3", device="cpu")


# ---- device and mesh refusals ------------------------------------------

_ENTRIES = {
    "linear_model": lambda G, y, K, **kw: linear.linear_model(G, y, **kw),
    "anova": lambda G, y, K, **kw: linear.anova(G, y, **kw),
    "kruskal_wallis": lambda G, y, K, **kw: linear.kruskal_wallis(G, y, **kw),
    "emmax_anova": lambda G, y, K, **kw: emmax_anova(G, y, K=K, **kw),
}


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
def test_default_device_is_the_card_or_an_error(diploid, entry):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    G, y, K = diploid
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _ENTRIES[entry](G, y, K)


@pytest.mark.parametrize("entry", sorted(_ENTRIES))
def test_mesh_is_refused(diploid, entry):
    """mesh= takes only a parallel.Mesh, and a 'sample' axis above 1 only
    on a mesh that holds its world (make_mesh's); the mesh= routes
    themselves are held in tests/test_torch_parallel_scans.py and, on a
    'sample' axis, tests/test_torch_parallel_tp_scans.py."""
    import dataclasses

    from mixmogam_tpu_torch.parallel import make_mesh

    G, y, K = diploid
    with pytest.raises(TypeError, match="make_mesh"):
        _ENTRIES[entry](G, y, K, mesh=object(), device="cpu")
    tp = dataclasses.replace(make_mesh(devices="cpu"), shape=(1, 2))
    with pytest.raises(ValueError, match="make_mesh"):
        _ENTRIES[entry](G, y, K, mesh=tp, device="cpu")


# ---- the facade and the command line ----------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("linear_api")
    n, m = 110, 500
    G, ch, po = simulate_genotypes(n, m, ploidy=2, missing_rate=0.02,
                                   seed=37)
    acc = [f"a{i}" for i in range(n)]
    y, _ = simulate_phenotype(np.where(G < 0, 0, G), h2=0.5, n_causal=3,
                              seed=37)
    g, p = str(d / "g.csv"), str(d / "p.csv")
    GenotypeData(G, ch, po, acc, ploidy=2).write_csv(g)
    ph = PhenotypeData.from_arrays(1, "t", acc, y)
    ph.add_phenotype(2, "cov", acc, np.random.default_rng(37).normal(size=n))
    ph.write_to_file(p)
    return d, g, p


_DIRECT = {"lm": "linear_model", "anova": "anova", "kw": "kruskal_wallis"}


@pytest.mark.parametrize("method,covariates", [
    ("lm", None), ("lm", [2]), ("anova", None), ("kw", None)])
def test_run_gwas_class_methods(files, method, covariates):
    """run_gwas against the JAX package's (the same ranked CSV rows) and
    against the port's direct call on the run's own rows and y (1e-12);
    no kinship phase."""
    d, g, p = files
    tag = f"{method}_{'cov' if covariates else 'plain'}"
    kw = dict(method=method, plots=False, min_mac=5,
              covariate_pids=covariates)
    res = api.run_gwas(g, p, out_prefix=str(d / f"port_{tag}"), device="cpu",
                       **kw)
    ref = japi.run_gwas(g, p, out_prefix=str(d / f"jax_{tag}"), **kw)
    _same(res["scan"], ref["scan"])
    with open(res["files"]["pvals"]) as a, open(ref["files"]["pvals"]) as b:
        ra, rb = a.read().splitlines(), b.read().splitlines()
    assert ra[0] == rb[0]
    assert [r.split(",")[:2] for r in ra] == [r.split(",")[:2] for r in rb]
    g2 = res["genotype"]
    kw2 = {}
    if covariates:
        cov = PhenotypeData.parse_phenotype_file(p).value_dict(2)
        kw2["X0"] = np.column_stack([np.ones(g2.num_samples),
                                     [cov[a][0] for a in g2.accessions]])
    if method == "lm":
        kw2["tile"] = 16_384
    direct = getattr(linear, _DIRECT[method])(g2, res["y"], device="cpu",
                                              **kw2)
    np.testing.assert_allclose(res["scan"]["ps"], direct["ps"], rtol=0,
                               atol=1e-12)
    with open(res["files"]["summary"]) as f:
        assert "kinship" not in json.load(f)["timings_s"]


@pytest.mark.parametrize("method", ["anova", "kw"])
def test_covariates_with_a_class_test_raise_before_parsing(method):
    with pytest.raises(ValueError, match="covariate_pids is not supported"):
        api.run_gwas("no_such.csv", "no_such_pheno.csv", method=method,
                     covariate_pids=[2], device="cpu")
    with pytest.raises(ValueError, match="covariate_pids is not supported"):
        api.run_gwas_multi("no_such.csv", "no_such_pheno.csv",
                           method=method, covariate_pids=[2], device="cpu")


@pytest.mark.parametrize("method", ["lm", "anova", "kw"])
def test_cli_run_class_methods(files, capsys, method):
    d, g, p = files
    out = str(d / f"cli_{method}")
    assert cli.main(["run", g, p, "--method", method, "-o", out,
                     "--no-plots", "--min-mac", "5", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("scanned ")
    with open(out + ".summary.json") as f:
        assert json.load(f)["method"] == method


def test_lazy_exports():
    import mixmogam_tpu_torch

    assert mixmogam_tpu_torch.linear_model is linear.linear_model
    assert mixmogam_tpu_torch.anova is api.anova is linear.anova
    assert mixmogam_tpu_torch.emmax_anova is emmax_anova
