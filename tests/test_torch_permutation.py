"""PyTorch port, the permutation test (mixmogam_tpu_torch/models/
permutation.py) against the JAX package's models/permutation.py under x64,
float64 on both sides, on the CPU.

Limits: min_ps and threshold within rtol 1e-8 of JAX's, delta within 1e-10,
for host and resident sources, the identity K, a 3-column design and a
given eig_k. Both packages draw the same permutations from the seed. The
port rotates by W = U' * sd with U' = (I - P_X0) U where the JAX package
rotates by U * sd (the same statistics in exact arithmetic) and masks the
rows inside col(X0) from the dosages. The fast tiers hold to exact within
rtol 1e-4 on each permutation's max F, and so does float32 against float64
under VanRaden's singular K with delta at its bound: the test that shows
the projected rotation is needed."""

import importlib

import numpy as np
import pytest
import torch

from mixmogam_tpu.models.resident import ResidentGenome as JResidentGenome
from mixmogam_tpu_torch import api
from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                              simulate_phenotype)
from mixmogam_tpu_torch.models import permutation
from mixmogam_tpu_torch.models.emmax import emmax
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.ops import scan
from mixmogam_tpu_torch.oracle.kinship import (ibs_kinship, scale_k,
                                               vanraden_kinship)

jperm = importlib.import_module("mixmogam_tpu.models.permutation")
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def data():
    G, _, _ = simulate_genotypes(96, 240, seed=8)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=5, seed=8)
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    return G, y, K


def _missing(G, rate, seed=1):
    Gm = G.copy()
    Gm[np.random.default_rng(seed).random(G.shape) < rate] = -1
    return Gm


def _case(name, G, y, K):
    """(port source, JAX source, kwargs) of one parity case."""
    rng = np.random.default_rng(12)
    if name == "float_nan":
        Gf = G.astype(np.float64)
        Gf[rng.random(G.shape) < 0.03] = np.nan
        return Gf, Gf, dict(K=K)
    if name in ("resident", "resident_missing", "identity_resident"):
        Gs = _missing(G, 0.04) if name == "resident_missing" else G
        kw = {} if name == "identity_resident" else dict(K=K)
        return (ResidentGenome.from_source(Gs, tile=64, device="cpu"),
                JResidentGenome.from_source(Gs, tile=64), kw)
    if name == "identity_host":
        return G, G, {}
    if name == "covariates":
        X0 = np.column_stack([np.ones(len(y)), rng.normal(size=len(y)),
                              (rng.random(len(y)) < 0.5) * 1.0])
        return G, G, dict(K=K, X0=X0)
    if name == "eig_k":
        w, v = np.linalg.eigh(K)
        return G, G, dict(eig_k=(w[::-1].copy(), v[:, ::-1].copy()))
    return G, G, dict(K=K)                                  # host int8


@pytest.mark.parametrize("case", ["int8", "float_nan", "resident",
                                  "resident_missing", "identity_host",
                                  "identity_resident", "covariates",
                                  "eig_k"])
def test_matches_jax(data, case):
    G, y, K = data
    src, jsrc, kw = _case(case, G, y, K)
    got = permutation.emmax_perm_test(src, y, num_perm=24, seed=3, tile=64,
                                      device="cpu", **kw)
    ref = jperm.emmax_perm_test(jsrc, y, num_perm=24, seed=3, tile=64, **kw)
    np.testing.assert_allclose(got["min_ps"], ref["min_ps"], rtol=1e-8)
    np.testing.assert_allclose(got["threshold"], ref["threshold"],
                               rtol=1e-8)
    np.testing.assert_allclose(got["delta"], ref["delta"], rtol=1e-10)
    assert got["num_perm"] == 24 and got["alpha"] == 0.05
    assert got["min_ps"].shape == (24,) and 0 < got["threshold"] < 0.05
    assert {"null", "rotation", "product", "epilogue",
            "p_values"} <= set(got["timings_s"])


def _max_f(res, dof):
    """Each permutation's max F back from its min p (sorted)."""
    from scipy.stats import f as f_dist

    return f_dist.isf(res["min_ps"], 1, dof)


@pytest.mark.parametrize("tier", ["int8x3", "bf16x3"])
def test_fast_tiers_close_to_exact(data, tier):
    G, y, K = data
    rg = ResidentGenome.from_source(G, tile=64, device="cpu")
    ref = permutation.emmax_perm_test(rg, y, K=K, num_perm=24, device="cpu")
    got = permutation.emmax_perm_test(rg, y, K=K, num_perm=24,
                                      precision=tier)
    dof = len(y) - 2
    np.testing.assert_allclose(_max_f(got, dof), _max_f(ref, dof),
                               rtol=1e-4)
    np.testing.assert_allclose(got["threshold"], ref["threshold"],
                               rtol=1e-4)


@pytest.mark.parametrize("precision", ["auto", "fast"])
def test_auto_and_fast_resolve_to_exact(data, precision):
    G, y, K = data
    rg = ResidentGenome.from_source(G, tile=64, device="cpu")
    ref = permutation.emmax_perm_test(rg, y, K=K, num_perm=8)
    got = permutation.emmax_perm_test(rg, y, K=K, num_perm=8,
                                      precision=precision)
    np.testing.assert_array_equal(got["min_ps"], ref["min_ps"])


def test_identity_permutation_reproduces_emmax(data, monkeypatch):
    """A first permutation that is the identity gives the real scan's max F:
    the smaller min p of two permutations is emmax's min p (the JAX test's
    check, to 1e-8 here)."""
    G, y, K = data

    class _Rng:
        first = True

        def permutation(self, n):
            if self.first:
                self.first = False
                return np.arange(n)
            return np.random.RandomState(0).permutation(n)

    monkeypatch.setattr(np.random, "default_rng", lambda seed=None: _Rng())
    r = permutation.emmax_perm_test(G, y, K=K, num_perm=2, tile=64,
                                    device="cpu")
    monkeypatch.undo()
    # esp giving emmax's REML the 32 bisection steps of fit_null_model's
    direct = emmax(G, y, K=K, esp=0.2 / 2 ** 31.5, device="cpu")
    np.testing.assert_allclose(r["min_ps"].min(), direct["ps"].min(),
                               rtol=1e-8)


# ---- VanRaden's K with delta at its bound (ROADMAP item 13's rule) --------

@pytest.fixture(scope="module")
def singular():
    """tests/test_torch_fold.py's fixture: n = 256, M = 3,000, binary, seed
    3, no noise on the phenotype; VanRaden's K is singular along the
    intercept and the REML puts delta at exp(-10). The float64 sweep."""
    G, _, _ = simulate_genotypes(256, 3_000, ploidy=1, seed=3)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=4, seed=3)
    K = scale_k(vanraden_kinship(G.astype(np.float64), ploidy=1))
    rg = ResidentGenome.from_source(G, tile=1_024, device="cpu")
    ref = permutation.emmax_perm_test(rg, y, K=K, num_perm=16)
    assert np.isclose(ref["delta"], np.exp(-10.0), rtol=1e-6)
    return rg, y, K, ref


def _f32_drift(got, ref):
    a, b = _max_f(got, 254), _max_f(ref, 254)
    return float(np.abs(a / b - 1).max())


@pytest.mark.parametrize("tier", ["exact", "int8x3", "bf16x3"])
def test_float32_under_a_singular_kinship(singular, tier):
    """float32 against float64: every permutation's max F within rtol
    1e-4, the threshold within 1e-4 relative."""
    rg, y, K, ref = singular
    got = permutation.emmax_perm_test(rg, y, K=K, num_perm=16,
                                      dtype=torch.float32, precision=tier)
    assert _f32_drift(got, ref) <= 1e-4
    assert abs(got["threshold"] / ref["threshold"] - 1) <= 1e-4


def test_the_unprojected_rotation_fails_there(singular, monkeypatch):
    """The JAX package's rotation by U * sd itself (project_design made the
    identity on U) misses the max F in float32 on that fixture by more than
    ten times the gate of test_float32_under_a_singular_kinship."""
    rg, y, K, ref = singular
    orig = scan.project_design
    monkeypatch.setattr(scan, "project_design",
                        lambda U, X0: (U,) + orig(U, X0)[1:])
    got = permutation.emmax_perm_test(rg, y, K=K, num_perm=16,
                                      dtype=torch.float32)
    assert _f32_drift(got, ref) > 1e-3          # ten times the gate


# ---- refusals and exports -------------------------------------------------

def test_refusals(data):
    G, y, K = data
    with pytest.raises(ValueError, match="ResidentGenome"):
        permutation.emmax_perm_test(G, y, K=K, precision="int8x3",
                                    device="cpu")
    for p in ("exact", "auto"):                     # host no-ops, as in JAX
        permutation.emmax_perm_test(G[:20], y, K=K, num_perm=2, precision=p,
                                    device="cpu")
    rgm = ResidentGenome.from_source(_missing(G, 0.05), device="cpu")
    with pytest.raises(ValueError, match="int8"):
        permutation.emmax_perm_test(rgm, y, K=K, precision="int8x2")
    rg = ResidentGenome.from_source(G, device="cpu")
    # 'high' runs on a ResidentGenome (tests/test_torch_high.py holds it to
    # the JAX package); a host source refuses it, as in the JAX package
    hi = permutation.emmax_perm_test(rg, y, K=K, num_perm=2,
                                     precision="high")
    assert np.isfinite(hi["min_ps"]).all()
    with pytest.raises(ValueError, match="ResidentGenome"):
        permutation.emmax_perm_test(G, y, K=K, precision="high",
                                    device="cpu")
    with pytest.raises(TypeError, match="make_mesh"):
        permutation.emmax_perm_test(G, y, K=K, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="samples"):
        permutation.emmax_perm_test(rg, y[:-2], K=K[:-2, :-2])


def test_default_device_is_the_card_or_an_error(data):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    G, y, K = data
    with pytest.raises(RuntimeError, match='device="cpu"'):
        permutation.emmax_perm_test(G, y, K=K)


def test_lazy_exports():
    import mixmogam_tpu_torch

    assert (mixmogam_tpu_torch.emmax_perm_test is api.emmax_perm_test
            is permutation.emmax_perm_test)
    assert "emmax_perm_test" in api.__all__
    assert "emmax_perm_test" in mixmogam_tpu_torch.__all__
