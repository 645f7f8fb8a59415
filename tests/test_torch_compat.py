"""PyTorch port, the reference class facade (mixmogam_tpu_torch/compat.py):
each test of tests/test_compat.py mirrored against the JAX class on the
same state (convert.linear_mixed_model_from_fields carries a JAX
LinearMixedModel's Y, X, K and eigenbasis across), plus the eigenbasis
cache rule, the package's lazy exports and the card default.

Tolerances: REML dicts within 1e-8; scan p-values within 1e-10 (float64
on the CPU); get_estimates' betas and standard errors within 1e-8;
lm_step_wise the same cofactors and criteria within 1e-8."""

import numpy as np
import pytest
import torch

from mixmogam_tpu import compat as jcompat
from mixmogam_tpu_torch import compat
from mixmogam_tpu_torch.compat import (LinearMixedModel, LinearModel,
                                       lm_step_wise)
from mixmogam_tpu_torch.convert import linear_mixed_model_from_fields

torch.set_num_threads(1)

_REML_KEYS = ("max_ll", "delta", "log_delta", "pseudo_heritability", "vg",
              "ve", "sigma_g2", "sigma_e2")


def _same_dict(got, ref, keys=_REML_KEYS, tol=1e-8):
    for k in keys:
        assert abs(got[k] - ref[k]) <= tol * max(1.0, abs(ref[k])), k


def _pair(y, K, factors=(), cls="lmm"):
    """The port's and the JAX package's instance in one state."""
    if cls == "lm":
        a, b = LinearModel(y, device="cpu"), jcompat.LinearModel(y)
    else:
        a, b = LinearMixedModel(y, device="cpu"), jcompat.LinearMixedModel(y)
        a.add_random_effect(K)
        b.add_random_effect(K)
    for f in factors:
        assert a.add_factor(f) == b.add_factor(f)
    return a, b


class TestLinearModelCompat:
    def test_least_square_estimate_matches_jax(self, tiny_dataset):
        y = tiny_dataset["y"]
        a, b = _pair(y, None, [tiny_dataset["G"][5]], cls="lm")
        ea, eb = a.least_square_estimate(), b.least_square_estimate()
        np.testing.assert_allclose(ea["betas"], eb["betas"], atol=1e-10)
        np.testing.assert_allclose(ea["residuals"], eb["residuals"],
                                   atol=1e-10)
        assert abs(ea["rss"] - eb["rss"]) < 1e-8 and ea["rank"] == 2
        assert a.get_estimates()["rss"] == ea["rss"]

    def test_add_factor_rejects_collinear(self, tiny_dataset):
        lm = LinearModel(tiny_dataset["y"], device="cpu")
        cov = tiny_dataset["G"][5]
        assert lm.add_factor(cov)
        assert not lm.add_factor(2.0 * cov + 3.0)   # in span(1, cov)
        assert lm.p == 2

    def test_add_factor_wrong_length_raises(self, tiny_dataset):
        lm = LinearModel(tiny_dataset["y"], device="cpu")
        with pytest.raises(ValueError):
            lm.add_factor(np.ones(3))

    def test_fast_f_test_matches_jax(self, tiny_dataset):
        G, y = tiny_dataset["G"], tiny_dataset["y"]
        a, b = _pair(y, None, [G[7]], cls="lm")
        da, db = a.fast_f_test(G[:30], tile=32), b.fast_f_test(G[:30],
                                                               tile=32)
        np.testing.assert_allclose(da["ps"], db["ps"], rtol=0, atol=1e-10)
        np.testing.assert_allclose(da["betas"], db["betas"], atol=1e-10)
        tv = a.test_explained_variance(G[:30], tile=32)
        np.testing.assert_array_equal(tv["ps"], da["ps"])

    def test_anova_f_test_matches_jax_and_refuses_cofactors(self,
                                                            tiny_dataset):
        G, y = tiny_dataset["G"], tiny_dataset["y"]
        a, b = _pair(y, None, cls="lm")
        np.testing.assert_allclose(a.anova_f_test(G[:20])["ps"],
                                   b.anova_f_test(G[:20])["ps"], atol=1e-10)
        a.add_factor(G[3])
        with pytest.raises(NotImplementedError):
            a.anova_f_test(G[:20])


class TestLinearMixedModelCompat:
    def test_remle_matches_jax(self, tiny_dataset, kinship_tiny):
        a, b = _pair(tiny_dataset["y"], kinship_tiny)
        _same_dict(a.get_expedited_REMLE(), b.get_expedited_REMLE())
        _same_dict(a.get_REML(), b.get_REML())

    def test_requires_random_effect(self, tiny_dataset):
        lmm = LinearMixedModel(tiny_dataset["y"], device="cpu")
        with pytest.raises(ValueError):
            lmm.get_expedited_REMLE()
        with pytest.raises(ValueError):
            lmm._get_eigen_R_()
        with pytest.raises(ValueError):
            lmm.add_random_effect(np.eye(3))

    def test_eigen_layouts(self, tiny_dataset, kinship_tiny):
        """Tensors on the device in the reference's layout (rows are
        eigenvectors); the values and projectors equal JAX's."""
        y, K = tiny_dataset["y"], kinship_tiny
        a, b = _pair(y, K, [tiny_dataset["G"][3]])
        eL, jL = a._get_eigen_L_(K), b._get_eigen_L_(K)
        n = len(y)
        assert isinstance(eL["values"], torch.Tensor)
        assert eL["values"].shape == (n,) and eL["vectors"].shape == (n, n)
        np.testing.assert_allclose(eL["values"].numpy(), jL["values"],
                                   atol=1e-10)
        V = eL["vectors"]
        recon = (V.T @ torch.diag(eL["values"]) @ V).numpy()
        np.testing.assert_allclose(recon, K, atol=1e-8)
        eR, jR = a._get_eigen_R_(), b._get_eigen_R_()
        assert eR["values"].shape == (n - 2,)
        np.testing.assert_allclose(eR["values"].numpy(), jR["values"],
                                   atol=1e-10)
        W = eR["vectors"].numpy()
        np.testing.assert_allclose(W.T @ W, jR["vectors"].T @ jR["vectors"],
                                   atol=1e-10)
        # an explicit X
        X = np.ones((n, 1))
        np.testing.assert_allclose(a._get_eigen_R_(X)["values"].numpy(),
                                   b._get_eigen_R_(X)["values"],
                                   atol=1e-10)

    def test_emmax_f_test_matches_jax(self, tiny_dataset, kinship_tiny):
        G = tiny_dataset["G"]
        a, b = _pair(tiny_dataset["y"], kinship_tiny, [G[3]])
        da, db = a.emmax_f_test(G[:40], tile=64), b.emmax_f_test(G[:40],
                                                                 tile=64)
        np.testing.assert_allclose(da["ps"], db["ps"], rtol=0, atol=1e-10)
        np.testing.assert_array_equal(da["mask"], db["mask"])

    def test_emmax_anova_matches_jax(self, tiny_dataset, kinship_tiny):
        G = tiny_dataset["G"]
        a, b = _pair(tiny_dataset["y"], kinship_tiny)
        np.testing.assert_allclose(a.emmax_anova(G[:30])["ps"],
                                   b.emmax_anova(G[:30])["ps"], rtol=0,
                                   atol=1e-10)
        assert LinearMixedModel.emmax_anova is \
            LinearMixedModel.emmax_anova_f_test

    def test_get_estimates_matches_jax(self, tiny_dataset, kinship_tiny):
        """GLS betas and standard errors at the REML delta, against the JAX
        class and against a direct solve of (X'H^-1X) b = X'H^-1 y."""
        G, y, K = tiny_dataset["G"], tiny_dataset["y"], kinship_tiny
        a, b = _pair(y, K, [G[3], G[11]])
        ea, eb = a.get_estimates(), b.get_estimates()
        for k in ("betas", "beta_ses"):
            assert isinstance(ea[k], np.ndarray)
            np.testing.assert_allclose(ea[k], eb[k], rtol=1e-8, atol=1e-10)
        assert abs(ea["rss"] - eb["rss"]) <= 1e-8 * eb["rss"]
        assert ea["dof"] == eb["dof"] == len(y) - 3
        _same_dict(ea, eb)
        Hi = np.linalg.inv(K + ea["delta"] * np.eye(len(y)))
        X = a.X
        beta = np.linalg.solve(X.T @ Hi @ X, X.T @ Hi @ y)
        np.testing.assert_allclose(ea["betas"], beta, atol=1e-6)
        assert np.all(ea["beta_ses"] > 0)

    def test_get_estimates_rank_deficient_design(self, tiny_dataset,
                                                 kinship_tiny):
        """A design set directly with a repeated column (add_factor would
        refuse it; the JAX class's REML cannot fit it): lstsq's rank and
        minimum-norm solution on the whitened design."""
        G, y, K = tiny_dataset["G"], tiny_dataset["y"], kinship_tiny
        a = LinearMixedModel(y, device="cpu")
        a.add_random_effect(K)
        a.X = np.column_stack([np.ones(len(y)), G[3], G[3]])
        ea = a.get_estimates()
        U = a._reml.U.numpy()
        sd = 1.0 / np.sqrt(a._reml.phi.numpy() + ea["delta"])
        Xs, ys = (U.T @ a.X) * sd[:, None], (U.T @ y) * sd
        beta, _, rank, _ = np.linalg.lstsq(Xs, ys, rcond=None)
        assert rank == 2 and ea["dof"] == len(y) - 2
        np.testing.assert_allclose(ea["betas"], beta, atol=1e-8)

    def test_ml_matches_jax(self, tiny_dataset, kinship_tiny):
        a, b = _pair(tiny_dataset["y"], kinship_tiny)
        _same_dict(a.get_ML(), b.get_ML())

    def test_perm_and_twosnp_match_jax(self, tiny_dataset, kinship_tiny):
        G = tiny_dataset["G"]
        a, b = _pair(tiny_dataset["y"], kinship_tiny)
        pa = a.emmax_perm_test(G[:16], num_perm=8, tile=16)
        pb = b.emmax_perm_test(G[:16], num_perm=8, tile=16)
        assert pa["min_ps"].shape == (8,)
        np.testing.assert_allclose(pa["min_ps"], pb["min_ps"], rtol=1e-8)
        ta = a.emmax_two_snps(G[:12], focal_idx=[0, 1], tile=16)
        tb = b.emmax_two_snps(G[:12], focal_idx=[0, 1], tile=16)
        assert ta["cond_ps"].shape == (2, 12)
        for k in ("cond_ps", "inter_ps"):
            np.testing.assert_allclose(ta[k], tb[k], rtol=0, atol=1e-10)

    def test_state_carried_from_jax(self, tiny_dataset, kinship_tiny):
        """linear_mixed_model_from_fields: a JAX instance's Y, X, K and
        _eig_k, read by attribute, give the port's instance the same
        scans and fits without another eigh."""
        G = tiny_dataset["G"]
        b = jcompat.LinearMixedModel(tiny_dataset["y"])
        b.add_random_effect(kinship_tiny)
        b.add_factor(G[3])
        rb = b.get_expedited_REMLE()
        a = linear_mixed_model_from_fields(b.Y, b.X, K=b.K,
                                           eig_k=b._eig_k, device="cpu")
        assert isinstance(a._eig_k[1], torch.Tensor)
        np.testing.assert_array_equal(a._eig_k[1].numpy(), b._eig_k[1])
        _same_dict(a.get_expedited_REMLE(), rb)
        np.testing.assert_allclose(a.emmax_f_test(G[:20], tile=32)["ps"],
                                   b.emmax_f_test(G[:20], tile=32)["ps"],
                                   rtol=0, atol=1e-10)

    def test_the_same_k_keeps_the_cached_eigh(self, tiny_dataset,
                                              kinship_tiny, monkeypatch):
        """Passing K again (the object itself or an equal copy) keeps the
        eigh; a different K re-factors and resets the REML cache."""
        from mixmogam_tpu_torch.ops import eigen

        calls = []
        real = eigen.eigen_k_on

        def counting(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        monkeypatch.setattr(eigen, "eigen_k_on", counting)
        K = kinship_tiny
        lmm = LinearMixedModel(tiny_dataset["y"], device="cpu")
        lmm.add_random_effect(K)
        lmm._get_eigen_L_(K)
        lmm.get_expedited_REMLE()
        for again in (K, K.copy(), lmm.K, torch.as_tensor(K)):
            lmm._get_eigen_L_(again)
        assert len(calls) == 1 and lmm._reml is not None
        K2 = K + 0.1 * np.eye(len(K))
        lmm._get_eigen_L_(K2)
        assert len(calls) == 2 and lmm._reml is None
        assert torch.equal(lmm.K, torch.as_tensor(K2))
        assert not lmm._same_k(np.eye(3))


class TestLmStepwise:
    def test_first_step_picks_ols_argmin(self, tiny_dataset):
        from mixmogam_tpu_torch.models.linear import linear_model

        G, y = tiny_dataset["G"], tiny_dataset["y"]
        out = lm_step_wise(G, y, max_steps=2, tile=64, save_scans=True,
                           device="cpu")
        ref = linear_model(G, y, tile=64, device="cpu")
        np.testing.assert_allclose(out["steps"][0]["scan_ps"], ref["ps"],
                                   atol=1e-8)
        assert out["steps"][0]["min_p_snp"] == int(np.argmin(ref["ps"]))
        assert out["steps"][0]["pseudo_heritability"] == 0.0

    def test_matches_jax(self, tiny_dataset):
        """The same steps, cofactors and selections as the JAX function;
        the criteria within 1e-8."""
        G, y = tiny_dataset["G"], tiny_dataset["y"]
        a = lm_step_wise(G, y, max_steps=2, tile=64, device="cpu")
        b = jcompat.lm_step_wise(G, y, max_steps=2, tile=64)
        assert len(a["steps"]) == len(b["steps"])
        for s_a, s_b in zip(a["steps"], b["steps"]):
            assert s_a["cofactors"] == s_b["cofactors"]
            assert s_a["pseudo_heritability"] == 0.0
            for k in ("bic", "ebic", "mbic"):
                assert abs(s_a[k] - s_b[k]) <= 1e-8 * max(1, abs(s_b[k]))
        assert {k: v["cofactors"] for k, v in a["selected"].items()} == {
            k: v["cofactors"] for k, v in b["selected"].items()}

    def test_identity_path_equals_explicit_identity_eigk(self,
                                                         tiny_dataset):
        """K=None matches the explicit eig_k=(ones, I) route step for step,
        and so does the stored-rotation budget forced to 0."""
        from mixmogam_tpu_torch.models.stepwise import emmax_step_wise

        G, y = tiny_dataset["G"], tiny_dataset["y"]
        n = len(y)
        a = lm_step_wise(G, y, max_steps=2, tile=64, device="cpu")
        b = emmax_step_wise(G, y, max_steps=2, tile=64, device="cpu",
                            eig_k=(np.ones(n), np.eye(n)))
        c = lm_step_wise(G.astype(np.int8), y, max_steps=2, tile=64,
                         rot_budget_bytes=0, device="cpu")
        for s_a, s_b, s_c in zip(a["steps"], b["steps"], c["steps"]):
            assert s_a["cofactors"] == s_b["cofactors"] == s_c["cofactors"]
            assert abs(s_a["bic"] - s_b["bic"]) < 1e-6
            assert abs(s_a["bic"] - s_c["bic"]) < 1e-6

    def test_criteria_finite_and_selection_present(self, tiny_dataset):
        G, y = tiny_dataset["G"], tiny_dataset["y"]
        out = lm_step_wise(G, y, max_steps=2, tile=64, device="cpu")
        for s in out["steps"]:
            assert np.isfinite(s["bic"]) and np.isfinite(s["ebic"])
        assert set(out["selected"]) == {"bic", "ebic", "mbic", "mbonf"}


class TestReferenceAliases:
    def test_genotype_aliases(self):
        from mixmogam_tpu_torch.data.genotype import GenotypeData
        from mixmogam_tpu_torch.data.phenotype import PhenotypeData

        assert compat.SNPsDataSet is GenotypeData
        G = np.array([[0, 1, 1, 0], [1, 1, 0, 0], [0, 0, 0, 1]], np.int8)
        gd = compat.SNPsDataSet(G, [1, 1, 2], [100, 200, 50],
                                ["a", "b", "c", "d"])
        np.testing.assert_array_equal(
            gd.get_region_snps(1, 150, 250), G[1:2])
        ph = PhenotypeData.from_arrays(
            1, "trait", ["a", "b", "c"], [1.0, 2.0, 3.0])
        sub, y, ids = gd.coordinate_w_phenotype_data(ph, 1)
        assert ids == ["a", "b", "c"] and len(y) == 3

    def test_package_level_exports(self):
        import mixmogam_tpu_torch

        assert mixmogam_tpu_torch.LinearMixedModel is LinearMixedModel
        assert mixmogam_tpu_torch.LinearModel is LinearModel
        assert mixmogam_tpu_torch.lm_step_wise is lm_step_wise
        assert {"LinearModel", "LinearMixedModel", "lm_step_wise"} <= set(
            mixmogam_tpu_torch.__all__)

    def test_every_public_method_of_the_jax_classes(self):
        for mine, ref in ((LinearModel, jcompat.LinearModel),
                          (LinearMixedModel, jcompat.LinearMixedModel)):
            names = {k for k in dir(ref) if not k.startswith("__")}
            assert names <= set(dir(mine)), names - set(dir(mine))
        assert set(jcompat.__all__) == set(compat.__all__)


def test_the_card_is_the_default(tiny_dataset):
    """Without a card the constructors, lm_step_wise and the converter
    from a JAX instance's fields raise naming device="cpu"."""
    G, y = tiny_dataset["G"], tiny_dataset["y"]
    for call in (lambda: LinearModel(y), lambda: LinearMixedModel(y),
                 lambda: lm_step_wise(G, y, max_steps=1),
                 lambda: linear_mixed_model_from_fields(
                     y, np.ones((len(y), 1)))):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert LinearMixedModel(y, device="cpu").device == torch.device("cpu")
