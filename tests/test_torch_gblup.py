"""PyTorch port, gBLUP genomic prediction (mixmogam_tpu_torch/models/
gblup.py and the CLI's predict) against the JAX package's models/gblup.py
under x64, float64 on both sides, on the CPU.

Limits: beta, u_hat, fitted, reliability() and the cross-validated y_hat
within 1e-8, delta to rtol 1e-10; the joint IBS kinship within 1e-12.
The port solves the whitened GLS by QR where the JAX package calls the
SVD-based np.linalg.lstsq, and takes the reliabilities from the
eigenbasis where the JAX package forms K and H^-1."""

import importlib
import json

import numpy as np
import pytest
import torch

from mixmogam_tpu.oracle.kinship import vanraden_kinship as j_vanraden
from mixmogam_tpu_torch import api, cli, convert
from mixmogam_tpu_torch.data.genotype import GenotypeData
from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                              simulate_phenotype)
from mixmogam_tpu_torch.models import gblup as tg
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.oracle.kinship import ibs_kinship, scale_k

jg = importlib.import_module("mixmogam_tpu.models.gblup")
jcli = importlib.import_module("mixmogam_tpu.cli")
torch.set_num_threads(1)
N, M = 120, 400


@pytest.fixture(scope="module")
def data():
    G, ch, po = simulate_genotypes(N, M, seed=5)
    y, _ = simulate_phenotype(G, h2=0.7, n_causal=40, seed=5)
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    cov = np.random.default_rng(4).normal(size=N)
    return {"G": G, "ch": ch, "po": po, "y": y + 2.0 * cov, "K": K,
            "X": np.column_stack([np.ones(N), cov])}


def _same_model(got, ref, tol=1e-8):
    for k in ("beta", "u_hat", "fitted"):
        np.testing.assert_allclose(getattr(got, k),
                                   np.asarray(getattr(ref, k)), rtol=0,
                                   atol=tol, err_msg=k)
    for k in ("delta", "sigma_g2", "sigma_e2", "pseudo_heritability"):
        assert getattr(got, k) == pytest.approx(getattr(ref, k), rel=1e-10)


_FITS = {
    "intercept": lambda d: dict(K=d["K"]),
    "covariate": lambda d: dict(K=d["K"], X0=d["X"]),
    "eig_k": lambda d: dict(eig_k=tuple(np.linalg.eigh(d["K"]))),
}


@pytest.mark.parametrize("design", sorted(_FITS))
def test_gblup_matches_jax(data, design):
    """The fit and reliability() on every design of the JAX tests."""
    kw = _FITS[design](data)
    got = tg.gblup(data["y"], device="cpu", **kw)
    ref = jg.gblup(data["y"], **kw)
    _same_model(got, ref)
    rel = got.reliability()
    np.testing.assert_allclose(rel, ref.reliability(), rtol=0, atol=1e-8)
    assert rel.shape == (N,) and ((rel >= 0) & (rel <= 1)).all()


def test_identity_kinship_uniform_shrinkage():
    """K = I: u_hat = r / (1 + delta) exactly. (The REML surface is flat
    in delta there, so delta itself is not compared with JAX's.)"""
    y = np.random.default_rng(0).normal(size=60)
    m = tg.gblup(y, K=np.eye(60), device="cpu")
    r = y - float(m.beta[0])
    np.testing.assert_allclose(m.u_hat, r / (1 + m.delta), atol=1e-8)
    assert m.beta[0] == pytest.approx(y.mean(), abs=1e-10)


def test_explicit_formula_parity(data):
    """u_hat and beta equal the dense-inverse Henderson / GLS formulas at
    the fitted delta; predict(K) of the train samples is u_hat."""
    y, K, X = data["y"], data["K"], data["X"]
    m = tg.gblup(y, K=K, X0=X, device="cpu")
    Hinv = np.linalg.inv(K + m.delta * np.eye(N))
    beta = np.linalg.solve(X.T @ Hinv @ X, X.T @ Hinv @ y)
    u = K @ Hinv @ (y - X @ beta)
    np.testing.assert_allclose(m.beta, beta, atol=1e-8)
    np.testing.assert_allclose(m.u_hat, u, atol=1e-8)
    np.testing.assert_allclose(m.fitted, X @ beta + u, atol=1e-8)
    np.testing.assert_allclose(m.predict(K), m.u_hat, atol=1e-10)
    np.testing.assert_allclose(m.predict(K, X_new=X), m.fitted, atol=1e-10)
    # reliability: 1 - PEV / (sg2 K_ii) from the inverse of the MME
    KHi = K @ Hinv
    adj = KHi @ X @ np.linalg.inv(X.T @ Hinv @ X) @ (KHi @ X).T
    pev = np.diag(K) - np.sum(KHi * K, axis=1) + np.diag(adj)
    np.testing.assert_allclose(m.reliability(),
                               np.clip(1 - pev / np.diag(K), 0, 1),
                               atol=1e-8)


def test_predict_and_reliability_of_the_jax_model(data):
    """convert.gblup_model_from_fields carries JAX's fitted model over:
    predict (with and without X_new) and reliability() agree on it."""
    ref = jg.gblup(data["y"], K=data["K"], X0=data["X"])
    got = convert.gblup_model_from_fields(ref)
    Kc = data["K"][:30]
    np.testing.assert_allclose(got.predict(Kc), ref.predict(Kc), atol=1e-10)
    np.testing.assert_allclose(got.predict(Kc, X_new=data["X"][:30]),
                               ref.predict(Kc, X_new=data["X"][:30]),
                               atol=1e-10)
    np.testing.assert_allclose(got.reliability(), ref.reliability(),
                               atol=1e-8)


@pytest.mark.parametrize("with_x", [False, True])
def test_gblup_predict_matches_jax(data, with_x):
    X = data["X"] if with_x else None
    train, test = np.arange(90), np.arange(90, N)
    got, gm = tg.gblup_predict(None, data["y"], train, test, X=X,
                               K_all=data["K"], device="cpu")
    ref, rm = jg.gblup_predict(None, data["y"], train, test, X=X,
                               K_all=data["K"])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-8)
    _same_model(gm, rm)


@pytest.mark.parametrize("source", ["genotype_data", "resident"])
def test_gblup_predict_builds_the_joint_kinship(data, source):
    """From a GenotypeData (the IBS gram of kernel K1's plain version) or a
    ResidentGenome, equal to the precomputed-K call and to JAX's."""
    gd = GenotypeData(data["G"], data["ch"], data["po"],
                      [f"s{i}" for i in range(N)])
    src = (gd if source == "genotype_data"
           else ResidentGenome.from_source(data["G"], device="cpu"))
    train, test = np.arange(80), np.arange(80, N)
    a, _ = tg.gblup_predict(src, data["y"], train, test, device="cpu")
    b, _ = tg.gblup_predict(None, data["y"], train, test, K_all=data["K"],
                            device="cpu")
    c, _ = jg.gblup_predict(data["G"], data["y"], train, test)
    np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
    np.testing.assert_allclose(a, c, rtol=0, atol=1e-8)


@pytest.mark.parametrize("with_x", [False, True])
def test_gblup_cv_matches_jax(data, with_x):
    """The same folds (np.random.default_rng(seed)), y_hat within 1e-8."""
    X = data["X"] if with_x else None
    got = tg.gblup_cv(None, data["y"], n_folds=4, seed=3, X=X,
                      K_all=data["K"], device="cpu")
    ref = jg.gblup_cv(None, data["y"], n_folds=4, seed=3, X=X,
                      K_all=data["K"])
    np.testing.assert_allclose(got["y_hat"], ref["y_hat"], rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(got["r_folds"], ref["r_folds"], atol=1e-8)
    assert got["r"] == pytest.approx(ref["r"], abs=1e-8)
    assert got["mse"] == pytest.approx(ref["mse"], rel=1e-8)
    assert got["r"] > 0.15


@pytest.mark.parametrize("method", ["ibs", "vanraden", "ibd"])
def test_joint_kinship_matches_jax(data, method):
    """IBS: JAX's integer gram, within 1e-12. VanRaden (JAX builds it in
    float32): the float64 oracle's, within 1e-12, and JAX's within its
    float32 rounding."""
    got = tg._joint_kinship(data["G"], method, device="cpu")
    ref = jg._joint_kinship(data["G"], method)
    if method == "ibs":
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    else:
        np.testing.assert_allclose(
            got, scale_k(j_vanraden(data["G"].astype(np.float64),
                                    ploidy=1)), rtol=0, atol=1e-12)
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_errors(data):
    y = data["y"].copy()
    for fn in (tg, jg):
        with pytest.raises(ValueError, match="n_folds >= 2"):
            fn.gblup_cv(None, y, n_folds=1, K_all=data["K"],
                        **({"device": "cpu"} if fn is tg else {}))
        with pytest.raises(ValueError, match="exceeds"):
            fn.gblup_cv(None, y, n_folds=N + 1, K_all=data["K"],
                        **({"device": "cpu"} if fn is tg else {}))
        with pytest.raises(ValueError, match="unknown kinship method"):
            fn._joint_kinship(data["G"], "vanRaden")
    y[3] = np.nan
    with pytest.raises(ValueError, match="fully-observed"):
        tg.gblup(y, K=data["K"], device="cpu")


@pytest.mark.parametrize("entry", ["gblup", "gblup_predict", "gblup_cv"])
def test_default_device_is_the_card_or_an_error(data, entry):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    call = {
        "gblup": lambda: tg.gblup(data["y"], K=data["K"]),
        "gblup_predict": lambda: tg.gblup_predict(
            None, data["y"], np.arange(90), np.arange(90, N),
            K_all=data["K"]),
        "gblup_cv": lambda: tg.gblup_cv(None, data["y"], K_all=data["K"]),
    }[entry]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        call()


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    d = tmp_path_factory.mktemp("predict")
    assert cli.main(["simulate", "-n", "90", "-m", "300", "--h2", "0.8",
                     "--n-causal", "60", "--seed", "13", "-o",
                     str(d / "sim")]) == 0
    return d, str(d / "sim.genotypes.csv"), str(d / "sim.phenotypes.csv")


@pytest.mark.parametrize("folds,method", [("0", "ibs"), ("3", "ibs"),
                                          ("3", "vanraden")])
def test_cli_predict_matches_jax(sim, capsys, folds, method):
    """The port's CSV and summary equal the JAX CLI's (values within
    1e-8; VanRaden within its float32 kinship in JAX)."""
    d, g, p = sim
    tol = 1e-8 if method == "ibs" else 1e-4
    out = {}
    for name, main in (("port", cli.main), ("jax", jcli.main)):
        csv = str(d / f"{name}_{folds}_{method}.csv")
        argv = ["predict", g, p, "--folds", folds, "--kinship-method",
                method, "-o", csv]
        capsys.readouterr()
        assert main(argv + (["--device", "cpu"] if name == "port"
                            else [])) == 0
        summary = json.loads(capsys.readouterr().out)
        with open(csv) as f:
            rows = f.read().splitlines()
        out[name] = summary, rows
    (sa, ra), (sb, rb) = out["port"], out["jax"]
    assert sorted(sa) == sorted(sb)
    for k, v in sb.items():
        if k == "file":
            continue
        np.testing.assert_allclose(sa[k], v, rtol=0, atol=tol, err_msg=k)
    assert ra[0] == rb[0] == ("ecotype_id,y,y_hat_cv" if folds != "0"
                              else "ecotype_id,y,genetic_value")
    assert len(ra) == len(rb) == 91
    a = [r.split(",") for r in ra[1:]]
    b = [r.split(",") for r in rb[1:]]
    assert [r[:2] for r in a] == [r[:2] for r in b]
    np.testing.assert_allclose([float(r[2]) for r in a],
                               [float(r[2]) for r in b], rtol=0, atol=tol)


def test_lazy_exports():
    import mixmogam_tpu_torch

    for name in ("gblup", "gblup_predict", "gblup_cv"):
        assert getattr(mixmogam_tpu_torch, name) is getattr(api, name) \
            is getattr(tg, name)


def test_cli_predict_default_device_is_the_card_or_an_error(sim):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    d, g, p = sim
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["predict", g, p, "-o", str(d / "never.csv")])
    assert not (d / "never.csv").exists()
