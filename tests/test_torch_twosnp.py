"""PyTorch port, the two-SNP scan (mixmogam_tpu_torch/models/twosnp.py)
against the JAX package's models/twosnp.py under x64, float64 on both
sides, on the CPU, and against a float64 brute force by the JAX package's
oracle (oracle/lmm.py::gls_f_test) at the global delta.

Limits: cond_ps and inter_ps within 1e-8 of JAX's with identical masks
(the p = 1 positions), delta within 1e-10, with and without the per-focal
REML; the oracle within 1e-8. The port rotates by U' = (I - P_X0) U where
the JAX package rotates by U (the same statistics in exact arithmetic) and
masks the degenerate rows from the dosages. float32 under VanRaden's
singular K with delta at its bound holds to float64 within 1e-4."""

import importlib

import numpy as np
import pytest
import torch

from mixmogam_tpu.oracle.lmm import gls_f_test
from mixmogam_tpu.results.result import Result as JResult
from mixmogam_tpu_torch import api
from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                              simulate_phenotype)
from mixmogam_tpu_torch.models import twosnp
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.oracle.kinship import (ibs_kinship, scale_k,
                                               vanraden_kinship)
from mixmogam_tpu_torch.results.result import Result

jtwo = importlib.import_module("mixmogam_tpu.models.twosnp")
torch.set_num_threads(1)
_FOCAL = [3, 17, 50]


@pytest.fixture(scope="module")
def data():
    """An epistatic pair (3, 17) planted on an LMM phenotype."""
    G, _, _ = simulate_genotypes(100, 200, seed=5)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=5, seed=5)
    y = y + 1.5 * G[3] * G[17]
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    return G, y, K


def _same(got, ref, tol=1e-8):
    for k in ("cond_ps", "inter_ps"):
        r = np.asarray(ref[k])
        np.testing.assert_array_equal(got[k] == 1.0, r == 1.0, err_msg=k)
        np.testing.assert_allclose(got[k], r, rtol=0, atol=tol, err_msg=k)


@pytest.mark.parametrize("refit", [False, True])
def test_matches_jax(data, refit):
    G, y, K = data
    got = twosnp.emmax_two_snps(G, y, K=K, focal_idx=_FOCAL, tile=64,
                                refit_delta_per_focal=refit, device="cpu")
    ref = jtwo.emmax_two_snps(G, y, K=K, focal_idx=_FOCAL, tile=64,
                              refit_delta_per_focal=refit)
    _same(got, ref)
    np.testing.assert_allclose(got["delta"], ref["delta"], rtol=1e-10)
    np.testing.assert_allclose(got["pseudo_heritability"],
                               ref["pseudo_heritability"], rtol=1e-10)
    np.testing.assert_array_equal(got["focal_idx"], _FOCAL)
    assert got["cond_ps"].shape == got["inter_ps"].shape == (3, 200)
    assert (got["inter_ps"] < 1.0).sum() > 300
    assert {"null", "rotation", "conditional", "interaction",
            "p_values"} <= set(got["timings_s"])


def test_brute_force_oracle(data):
    """Each pair's two F-tests by lstsq in the explicit H^(-1/2) basis at
    the global delta: cond = g_b on [1, g_a], inter = g_a g_b on
    [1, g_a, g_b]."""
    G, y, K = data
    Gs = G[:60]
    res = twosnp.emmax_two_snps(Gs, y, K=K, focal_idx=[3, 17], device="cpu")
    phi, U = np.linalg.eigh(K)
    Hs = (U / np.sqrt(phi + res["delta"])) @ U.T
    ys, one = Hs @ y, Hs @ np.ones(len(y))
    for i, a in enumerate([3, 17]):
        ga = Gs[a].astype(np.float64)
        for b in range(60):
            gb = Gs[b].astype(np.float64)
            for k, null, x in (
                    ("cond_ps", [one, Hs @ ga], Hs @ gb),
                    ("inter_ps", [one, Hs @ ga, Hs @ gb], Hs @ (ga * gb))):
                p = res[k][i, b]
                if p < 1.0:
                    ref = gls_f_test(ys, np.column_stack(null), x)["p"]
                    assert abs(p - ref) <= 1e-8, (k, a, b, p, ref)
    assert (res["cond_ps"] < 1.0).sum() == 2 * 59


def test_focal_snp_is_masked(data):
    G, y, K = data
    res = twosnp.emmax_two_snps(G, y, K=K, focal_idx=_FOCAL, device="cpu")
    for i, a in enumerate(_FOCAL):
        assert res["cond_ps"][i, a] == 1.0 and res["inter_ps"][i, a] == 1.0
        assert (res["cond_ps"][i] < 1.0).sum() == 199


def test_pure_interaction_is_detected():
    """The JAX tests' synthetic pure-interaction phenotype: the causal
    pair's interaction p is below 1e-4, as in the JAX package."""
    rng = np.random.default_rng(0)
    n = 50
    G = (rng.random((30, n)) < 0.5).astype(np.float64)
    y = 2.0 * (G[3] * G[17]) + 0.3 * rng.normal(size=n)
    got = twosnp.emmax_two_snps(G, y, K=np.eye(n), focal_idx=[3], tile=32,
                                device="cpu")
    ref = jtwo.emmax_two_snps(G, y, K=np.eye(n), focal_idx=[3], tile=32)
    assert got["inter_ps"][0, 17] < 1e-4
    assert int(np.argmin(got["inter_ps"][0])) == 17
    _same(got, ref)


def _from_results(ps):
    """(name, port from_result, JAX from_result) of one prior scan."""
    chrom, pos = np.ones(len(ps), int), np.arange(len(ps))
    return [("dict", {"ps": ps}, {"ps": ps}), ("array", ps, ps),
            ("pvals", Result(ps, chrom, pos), JResult(ps, chrom, pos)),
            ("neg_log_pvals",
             Result(-np.log10(ps), chrom, pos, score_type="neg_log_pvals"),
             JResult(-np.log10(ps), chrom, pos,
                     score_type="neg_log_pvals"))]


@pytest.mark.parametrize("kind", ["dict", "array", "pvals",
                                  "neg_log_pvals"])
def test_from_result_picks_jax_focal_set(data, kind):
    G, y, K = data
    Gs = G[:40]
    ps = np.random.default_rng(4).random(40)
    ps[[7, 21]] = ps[5]                              # ties: stable order
    _, mine, theirs = next(c for c in _from_results(ps) if c[0] == kind)
    got = twosnp.emmax_two_snps(Gs, y, K=K, from_result=mine, top_k=4,
                                device="cpu")
    ref = jtwo.emmax_two_snps(Gs, y, K=K, from_result=theirs, top_k=4)
    np.testing.assert_array_equal(got["focal_idx"], ref["focal_idx"])
    assert len(got["focal_idx"]) == 4
    _same(got, ref)


@pytest.mark.parametrize("kw,match", [
    (dict(), "explicit focal set"),
    (dict(focal_idx=[]), "empty"),
    (dict(focal_idx=[0, 40]), "out of range"),
    (dict(focal_idx=[-1]), "out of range"),
    (dict(from_result=np.ones(39)), "same SNP set"),
    (dict(from_result="scores"), "score_type"),
])
def test_refusals_match_jax(data, kw, match):
    G, y, K = data
    Gs = G[:40]
    kj = dict(kw)
    if isinstance(kw.get("from_result"), str):
        kw = dict(from_result=Result(np.ones(40), np.ones(40), np.arange(40),
                                     score_type="scores"))
        kj = dict(from_result=JResult(np.ones(40), np.ones(40),
                                      np.arange(40), score_type="scores"))
    with pytest.raises(ValueError, match=match):
        twosnp.emmax_two_snps(Gs, y, K=K, device="cpu", **kw)
    with pytest.raises(ValueError, match=match):
        jtwo.emmax_two_snps(Gs, y, K=K, **kj)


def test_other_refusals(data):
    G, y, K = data
    with pytest.raises(TypeError, match="make_mesh"):
        twosnp.emmax_two_snps(G, y, K=K, focal_idx=[1], mesh=object(),
                              device="cpu")
    with pytest.raises(ValueError, match="need K or eig_k"):
        twosnp.emmax_two_snps(G, y, focal_idx=[1], device="cpu")
    with pytest.raises(ValueError, match="samples"):
        twosnp.emmax_two_snps(G, y[:-1], K=K, focal_idx=[1], device="cpu")


def test_default_device_is_the_card_or_an_error(data):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    G, y, K = data
    with pytest.raises(RuntimeError, match='device="cpu"'):
        twosnp.emmax_two_snps(G, y, K=K, focal_idx=[1])


@pytest.mark.parametrize("missing", [False, True])
def test_resident_equals_array(data, missing):
    G, y, K = data
    if missing:
        G = G.copy()
        G[np.random.default_rng(2).random(G.shape) < 0.04] = -1
    ref = twosnp.emmax_two_snps(G, y, K=K, focal_idx=_FOCAL, tile=64,
                                device="cpu")
    rg = ResidentGenome.from_source(G, tile=128, device="cpu")
    _same(twosnp.emmax_two_snps(rg, y, K=K, focal_idx=_FOCAL, tile=64),
          ref, tol=1e-12)


def test_float_source_with_nan_matches_jax(data):
    G, y, K = data
    Gf = G.astype(np.float64)
    Gf[np.random.default_rng(3).random(G.shape) < 0.03] = np.nan
    _same(twosnp.emmax_two_snps(Gf, y, K=K, focal_idx=_FOCAL, device="cpu"),
          jtwo.emmax_two_snps(Gf, y, K=K, focal_idx=_FOCAL))


def test_float32_under_a_singular_kinship():
    """tests/test_torch_fold.py's fixture (n = 256, M = 3,000, binary, seed
    3, no noise; VanRaden's K singular along the intercept, delta at
    exp(-10)): float32 against float64, identical masks, max |dp| <= 1e-4."""
    G, _, _ = simulate_genotypes(256, 3_000, ploidy=1, seed=3)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=4, seed=3)
    K = scale_k(vanraden_kinship(G.astype(np.float64), ploidy=1))
    focal = [0, 1_000, 2_999]
    ref = twosnp.emmax_two_snps(G, y, K=K, focal_idx=focal, device="cpu")
    assert np.isclose(ref["delta"], np.exp(-10.0), rtol=1e-6)
    got = twosnp.emmax_two_snps(G, y, K=K, focal_idx=focal,
                                dtype=torch.float32, device="cpu")
    _same(got, ref, tol=1e-4)


def test_lazy_exports():
    import mixmogam_tpu_torch

    assert (mixmogam_tpu_torch.emmax_two_snps is api.emmax_two_snps
            is twosnp.emmax_two_snps)
    assert "emmax_two_snps" in api.__all__
    assert "emmax_two_snps" in mixmogam_tpu_torch.__all__
