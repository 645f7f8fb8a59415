"""PyTorch port, the slice as a whole: emmax / emmax_resident against the
JAX package on the same data (CPU, float64)."""

import numpy as np
import pytest
import torch

import mixmogam_tpu_torch as mt
from mixmogam_tpu.models.emmax import emmax as j_emmax
from mixmogam_tpu.models.resident import ResidentGenome as JResident
from mixmogam_tpu.models.resident import emmax_resident as j_resident
from mixmogam_tpu.ops.eigen import eigen_k as j_eigen_k
from mixmogam_tpu.ops.kinship import kinship as j_kinship
from mixmogam_tpu.oracle.kinship import scale_k
from mixmogam_tpu_torch.convert import resident_from_packed
from test_torch_fold import fold_jax_tiers
from mixmogam_tpu_torch.models.emmax import emmax
from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                emmax_resident)

torch.set_num_threads(1)


def _data(seed=0, n=96, m=500, ploidy=1, missing=0.0):
    """tests/test_resident.py's generator."""
    rng = np.random.default_rng(seed)
    G = rng.integers(0, ploidy + 1, (m, n)).astype(np.int8)
    if missing:
        G[rng.random((m, n)) < missing] = -1
    Gf = G.astype(np.float64)
    Gf[G < 0] = np.nan
    mu = np.nanmean(Gf, axis=1)
    imp = np.where(np.isnan(Gf), np.where(np.isnan(mu), 0, mu)[:, None], Gf)
    y = imp[3] * 0.9 + rng.normal(size=n)
    return G, imp, y


def _pair(G, tile=128):
    jrg = JResident.from_source(G, tile=tile)
    rg = resident_from_packed(jrg.host_packed, jrg.M, jrg.n, jrg.ploidy,
                              jrg.tile, jrg.has_missing)
    return jrg, rg


def _eig(K):
    phi, U = j_eigen_k(K)
    return np.asarray(phi), np.asarray(U)


@pytest.mark.parametrize("ploidy", [1, 2])
def test_resident_exact_matches_jax(ploidy):
    G, _, y = _data(3, ploidy=ploidy)
    K = scale_k(j_kinship(G, method="ibs"))
    jrg, rg = _pair(G)
    ref = j_resident(jrg, y, K=K)
    res = emmax_resident(rg, y, K=K)
    np.testing.assert_allclose(res["ps"], ref["ps"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(res["betas"], ref["betas"], atol=1e-9)
    np.testing.assert_allclose(res["var_perc"], ref["var_perc"], atol=1e-9)
    np.testing.assert_array_equal(res["mask"], ref["mask"])
    assert res["dof"] == ref["dof"]
    for k in ("delta", "pseudo_heritability", "ll_null"):
        assert abs(res[k] - ref[k]) < 1e-9
    assert res["precision_tier"] == ref["precision_tier"] == "exact"


def test_resident_missing_imputed_exact_matches_jax():
    G, _, y = _data(4, missing=0.04)
    K = scale_k(j_kinship(G, method="ibs"))
    jrg, rg = _pair(G)
    ref = j_resident(jrg, y, K=K)
    res = emmax_resident(rg, y, K=K)
    np.testing.assert_allclose(res["ps"], ref["ps"], rtol=0, atol=1e-9)
    assert res["dof"] == ref["dof"]


def test_resident_int8x3_rescore_matches_jax(monkeypatch):
    # the JAX reference quantizes the port's folded W'' (test_torch_fold.py)
    fold_jax_tiers(monkeypatch)
    G, _, y = _data(6)
    eig = _eig(scale_k(j_kinship(G, method="ibs")))
    jrg, rg = _pair(G)
    ref = j_resident(jrg, y, eig_k=eig, precision="int8x3", rescore_top=16)
    res = emmax_resident(rg, y, eig_k=eig, precision="int8x3",
                         rescore_top=16)
    assert res["precision_tier"] == "int8x3"
    np.testing.assert_array_equal(res["rescored_idx"], ref["rescored_idx"])
    assert len(res["rescored_idx"]) >= 16
    lp = np.abs(np.log10(res["ps"]) - np.log10(ref["ps"]))
    assert lp.max() < 1e-4


@pytest.mark.parametrize("tier", ["int8x2", "int8x4"])
def test_resident_int8_tiers_close_to_exact(tier):
    G, _, y = _data(8)
    eig = _eig(scale_k(j_kinship(G, method="ibs")))
    rg = ResidentGenome.from_source(G, tile=128, device="cpu")
    ex = emmax_resident(rg, y, eig_k=eig)
    q = emmax_resident(rg, y, eig_k=eig, precision=tier)
    np.testing.assert_array_equal(q["mask"], ex["mask"])
    assert np.abs(q["ps"] - ex["ps"]).max() < (1e-3 if tier == "int8x2"
                                               else 1e-7)


def test_int8_refused_with_missing():
    G, _, y = _data(5, missing=0.04)
    K = scale_k(j_kinship(G, method="ibs"))
    rg = ResidentGenome.from_source(G, tile=128, device="cpu")
    with pytest.raises(ValueError, match="fully-observed"):
        emmax_resident(rg, y, K=K, rotate_in_bf16="int8x2")
    with pytest.raises(ValueError, match="integer dosages"):
        emmax(G, y, K=K, precision="int8x3", device="cpu")


@pytest.mark.parametrize("source", ["float", "int8"])
def test_incore_route_matches_jax(small_dataset, kinship_small, source):
    G = small_dataset["G"] if source == "float" else small_dataset["G_int"]
    y, K = small_dataset["y"], kinship_small
    ref = j_emmax(G, y, K=K, stream=False)
    res = emmax(G, y, K=K, device="cpu")
    np.testing.assert_allclose(res["ps"], ref["ps"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(res["betas"], ref["betas"], atol=1e-9)
    assert res["dof"] == ref["dof"]


def test_incore_covariates_match_jax(small_dataset, kinship_small):
    G, y, K = small_dataset["G"], small_dataset["y"], kinship_small
    rng = np.random.default_rng(2)
    X0 = np.column_stack([np.ones(len(y)), rng.normal(size=len(y))])
    ref = j_emmax(G, y, K=K, X0=X0, stream=False)
    res = emmax(G, y, K=K, X0=X0, device="cpu")
    np.testing.assert_allclose(res["ps"], ref["ps"], rtol=0, atol=1e-9)
    assert res["dof"] == ref["dof"] == len(y) - 3


def test_incore_int8_tier_packs_and_matches_jax(small_dataset,
                                                kinship_small, monkeypatch):
    # the JAX reference quantizes the port's folded W'' (test_torch_fold.py)
    fold_jax_tiers(monkeypatch)
    G, y = small_dataset["G_int"], small_dataset["y"]
    eig = _eig(kinship_small)
    ref = j_emmax(G, y, eig_k=eig, precision="int8x3", stream=False)
    res = emmax(G, y, eig_k=eig, precision="int8x3", device="cpu")
    assert res["precision_tier"] == ref["precision_tier"] == "int8x3"
    lp = np.abs(np.log10(res["ps"]) - np.log10(ref["ps"]))
    assert lp.max() < 1e-4


def test_emmax_routes_resident_genome_and_facade():
    G, _, y = _data(9)
    K = scale_k(j_kinship(G, method="ibs"))
    rg = ResidentGenome.from_source(G, tile=128, device="cpu")
    a = mt.emmax(rg, y, K=K)
    b = mt.emmax_resident(rg, y, K=K)
    np.testing.assert_array_equal(a["ps"], b["ps"])
    assert mt.ResidentGenome is ResidentGenome
    np.testing.assert_array_equal(rg[[0, 7, 499]], G[[0, 7, 499]])
    np.testing.assert_array_equal(np.asarray(rg), G)


@pytest.mark.parametrize("kw", [dict(mesh="cpu", precision="high"),
                                dict(precision="high"),
                                dict(matmul_precision="high")])
def test_unported_options_raise(kw, small_dataset, kinship_small):
    """'high' is ported: the mesh route raises the JAX package's ValueError
    (its distributed scans take rotation tiers only; the mesh routes are
    tests/test_torch_parallel.py's), one device runs it, and the legacy
    matmul_precision='high' in core equals precision='high' bit for bit,
    within TIER_P_DRIFT['high'] of the JAX package's call (on the CPU JAX
    runs 'high' as its exact tier)."""
    from mixmogam_tpu_torch.ops.scan import TIER_P_DRIFT

    G, y = small_dataset["G"], small_dataset["y"]
    if "mesh" in kw:
        from mixmogam_tpu_torch.parallel import make_mesh

        kw = dict(kw, mesh=make_mesh(devices=kw["mesh"]))
        with pytest.raises(ValueError, match="not supported on the mesh"):
            emmax(G, y, K=kinship_small, **kw, device="cpu")
        return
    got = emmax(G, y, K=kinship_small, **kw, device="cpu")
    ref = j_emmax(G, y, K=kinship_small, **kw)
    assert got["precision_tier"] == ref["precision_tier"] == "high"
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    assert np.abs(got["ps"] - ref["ps"]).max() <= TIER_P_DRIFT["high"]
    np.testing.assert_array_equal(
        got["ps"], emmax(G, y, K=kinship_small, precision="high",
                         device="cpu")["ps"])


def _entry_points():
    """name -> call(device kwargs) for every entry point that picks a
    device for array input."""
    from mixmogam_tpu_torch.models.loco import emmax_loco, loco_kinships
    from mixmogam_tpu_torch.models.streaming import emmax_streamed
    from mixmogam_tpu_torch.ops.reml import fit_null_model

    G, imp, y = _data(seed=4, n=40, m=120)
    K = scale_k(np.asarray(j_kinship(imp)))
    ch = np.repeat([1, 2], [70, 50])
    return {
        "emmax": lambda **d: emmax(G, y, K=K, **d),
        "from_source": lambda **d: ResidentGenome.from_source(G, **d),
        "emmax_loco": lambda **d: emmax_loco(G, y, chromosomes=ch, **d),
        "loco_kinships": lambda **d: loco_kinships(G, ch, **d),
        "fit_null_model": lambda **d: fit_null_model(
            y, np.ones((40, 1)), K=K, **d),
        "emmax_streamed": lambda **d: emmax_streamed(G, y, K=K, **d),
    }


@pytest.mark.parametrize("name", ["emmax", "from_source", "emmax_loco",
                                  "loco_kinships", "fit_null_model",
                                  "emmax_streamed"])
def test_default_device_is_the_card_or_an_error(name, monkeypatch):
    """Without a card and without device= every entry point raises and
    names device="cpu"; it never carries on on the CPU by itself. Asked
    for the CPU it runs there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = _entry_points()[name]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()
    out = call(device="cpu")
    where = {"from_source": lambda r: r.device,
             "fit_null_model": lambda r: r.U.device}.get(name)
    if where is not None:
        assert where(out).type == "cpu"


def test_device_default_leaves_cpu_results_unchanged():
    """device="cpu" gives what the CPU default gave: host LAPACK eigh
    (host_eigh=None on the CPU) and float64, equal to the JAX package."""
    from mixmogam_tpu_torch.ops import resolve_device
    from mixmogam_tpu_torch.ops.eigen import eigen_k, eigen_k_on

    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cpu")).type == "cpu"
    G, imp, y = _data(seed=6, n=48, m=200)
    K = scale_k(np.asarray(j_kinship(imp)))
    for host_eigh in (None, True):
        phi, U = eigen_k_on(K, "cpu", host_eigh)
        ref_phi, ref_U = eigen_k(K, host=True)
        assert torch.equal(phi, ref_phi) and torch.equal(U, ref_U)
    ref = j_emmax(G, y, K=K, stream=False)
    res = emmax(G, y, K=K, device="cpu")
    np.testing.assert_allclose(res["ps"], np.asarray(ref["ps"]), rtol=1e-8,
                               atol=1e-12)


# ---- a singular kinship with delta at its bound (ROADMAP Queue 3) --------

def _vanraden_fixture(tmp_path):
    """The input of the card test test_card_run_gwas_vanraden_delta_at_its_
    bound: n = 256, M = 3,000, binary, seed 3, no noise on the phenotype.
    VanRaden's K is singular along the intercept and REML puts delta at
    exp(-10)."""
    from mixmogam_tpu_torch.data.genotype import GenotypeData
    from mixmogam_tpu_torch.data.phenotype import PhenotypeData
    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)

    G, ch, po = simulate_genotypes(256, 3_000, ploidy=1, seed=3)
    acc = [f"s{i}" for i in range(256)]
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=4, seed=3)
    g, p = str(tmp_path / "g.csv"), str(tmp_path / "p.csv")
    GenotypeData(G, ch, po, acc, ploidy=1).write_csv(g)
    PhenotypeData.from_arrays(1, "t", acc, y).write_to_file(p)
    return g, p


def test_float32_scan_under_a_singular_kinship(tmp_path):
    """The CPU twin of the card test: run_gwas with the VanRaden kinship
    in float32 against float64, identical masks and max |dp| <= 1e-4 (the
    float32 exact scan masked one SNP and lost 1e-3 elsewhere before the
    design was projected out of the rotation)."""
    g, p = _vanraden_fixture(tmp_path)
    kw = dict(kinship_method="vanraden", plots=False, device="cpu")
    a = mt.run_gwas(g, p, dtype=torch.float32, **kw)["scan"]
    b = mt.run_gwas(g, p, **kw)["scan"]
    assert b["delta"] < 1e-4
    np.testing.assert_array_equal(a["mask"], b["mask"])
    assert np.abs(a["ps"] - b["ps"]).max() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("method", ["ibs", "vanraden"])
def test_rows_inside_the_design_stay_masked(method, dtype):
    """Monomorphic SNPs lie in the intercept's span: the projected rotation
    turns them into rounding noise, and the exact tier still masks them as
    the JAX package does (p = 1); every other row as in JAX x64."""
    G, _, y = _data(5, n=96, m=300)
    G[[4, 9, 17]] = np.array([1, 0, 1], dtype=np.int8)[:, None]
    K = scale_k(j_kinship(G, method=method, dtype=np.float64))
    ref = j_emmax(G, y, K=K)
    res = emmax(G, y, K=K, device="cpu", dtype=dtype)
    assert not res["mask"][[4, 9, 17]].any()
    np.testing.assert_array_equal(res["mask"], np.asarray(ref["mask"]))
    np.testing.assert_array_equal(res["ps"][[4, 9, 17]], 1.0)
    limit = 1e-10 if dtype == torch.float64 else 1e-4
    assert np.abs(res["ps"] - np.asarray(ref["ps"])).max() <= limit
