"""PyTorch port, ops/reml.py::h2_profile_ci: held to the JAX function under
x64 (both ends within 1e-9) for a REML null and for an ML null carried
across through convert.null_from_numpy(..., ml=True), and the five
properties of tests/test_h2_ci.py on the port's own fits."""

import numpy as np
import pytest
import torch
from scipy.stats import chi2

from mixmogam_tpu.ops import reml as jreml
from mixmogam_tpu_torch.convert import null_from_numpy
from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                              simulate_phenotype)
from mixmogam_tpu_torch.ops.reml import fit_null_model, h2_profile_ci
from mixmogam_tpu_torch.ops.xreml import ll_explicit
from mixmogam_tpu_torch.oracle.kinship import ibs_kinship, scale_k

torch.set_num_threads(1)

_FIELDS = ("phi", "U", "delta", "log_delta", "ll", "sigma_g2", "sigma_e2",
           "pseudo_heritability", "y", "X0")


def _data(n=200, m=600, h2=0.6, seed=21):
    G, _, _ = simulate_genotypes(n, m, seed=seed)
    y, _ = simulate_phenotype(G, h2=h2, n_causal=max(10, m // 10),
                              seed=seed)
    return y, scale_k(ibs_kinship(G.astype(np.float64)))


def _fit(n=200, m=600, h2=0.6, seed=21, ml=False):
    y, K = _data(n, m, h2, seed)
    return fit_null_model(y, np.ones((n, 1)), K=K, ml=ml, device="cpu")


def _carried(jnull, ml):
    return null_from_numpy(*(np.asarray(getattr(jnull, f))
                             for f in _FIELDS), ml=ml)


@pytest.mark.parametrize("ml", [False, True])
@pytest.mark.parametrize("level", [0.9, 0.95])
def test_matches_jax(ml, level):
    """The JAX null's fields carried across, with its objective: both ends
    within 1e-9 of the JAX interval."""
    y, K = _data(n=150, m=400, seed=4)
    X0 = np.column_stack([np.ones(150), np.random.default_rng(4).normal(
        size=150)])
    jn = jreml.fit_null_model(y, X0, K=K, ml=ml)
    ref = jreml.h2_profile_ci(jn, level=level)
    got = h2_profile_ci(_carried(jn, jn._ml), level=level)
    assert isinstance(got[0], float) and isinstance(got[1], float)
    assert np.abs(np.subtract(got, ref)).max() <= 1e-9


def test_an_ml_null_profiles_the_ml_curve():
    """NullModel.ml: fit_null_model(ml=True) records it, null_from_numpy
    carries it (default False), and h2_profile_ci profiles that objective:
    the ML null's interval is JAX's ML interval, and profiling the REML
    curve around the ML optimum instead gives another one."""
    y, K = _data(n=150, m=400, seed=4)
    X0 = np.ones((150, 1))
    assert fit_null_model(y, X0, K=K, ml=True, device="cpu").ml is True
    assert fit_null_model(y, X0, K=K, device="cpu").ml is False
    jn = jreml.fit_null_model(y, X0, K=K, ml=True)
    ref = jreml.h2_profile_ci(jn)
    as_ml = h2_profile_ci(_carried(jn, ml=True))
    as_reml = h2_profile_ci(_carried(jn, ml=False))
    assert np.abs(np.subtract(as_ml, ref)).max() <= 1e-9
    assert np.abs(np.subtract(as_reml, ref)).max() > 1e-4
    assert _carried(jn, ml=False).ml is False


def test_contains_point_estimate():
    null = _fit()
    lo, hi = h2_profile_ci(null)
    h2 = float(null.pseudo_heritability)
    assert 0.0 <= lo <= h2 <= hi <= 1.0
    assert hi - lo < 0.999  # informative at n=200


def test_brute_force_grid_parity():
    """Endpoints match a dense-grid inversion of the same likelihood to
    about the grid resolution."""
    null = _fit(n=150, m=400, seed=4)
    lo, hi = h2_profile_ci(null, level=0.95)
    U = null.U
    phi, y_rot, X_rot = null.phi, U.T @ null.y, U.T @ null.X0
    cut = float(ll_explicit(float(null.log_delta), phi, y_rot, X_rot)) \
        - 0.5 * chi2.ppf(0.95, 1)
    grid = np.linspace(-10, 10, 20001)
    lls = ll_explicit(torch.as_tensor(grid), phi, y_rot, X_rot).numpy()
    ld_in = grid[lls >= cut]
    lo_b = 1.0 / (1.0 + np.exp(ld_in.max()))
    hi_b = 1.0 / (1.0 + np.exp(ld_in.min()))
    assert abs(lo - lo_b) < 2e-3, (lo, lo_b)
    assert abs(hi - hi_b) < 2e-3, (hi, hi_b)


def test_level_ordering():
    null = _fit(seed=9)
    lo90, hi90 = h2_profile_ci(null, level=0.90)
    lo99, hi99 = h2_profile_ci(null, level=0.99)
    assert lo99 <= lo90 and hi90 <= hi99
    assert (hi99 - lo99) > (hi90 - lo90)


def test_null_trait_boundary():
    """h2 ~ 0 trait: the interval collapses toward 0 at the bottom and
    stays well below 1 at the top (n is informative)."""
    rng = np.random.default_rng(3)
    G, _, _ = simulate_genotypes(250, 500, seed=3)
    y = rng.normal(size=250)  # no genetic signal at all
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    null = fit_null_model(y, np.ones((250, 1)), K=K, device="cpu")
    lo, hi = h2_profile_ci(null)
    assert lo <= 0.05
    assert hi < 0.95


def test_width_shrinks_with_n():
    w = {}
    for n in (80, 500):
        lo, hi = h2_profile_ci(_fit(n=n, m=500, seed=13))
        w[n] = hi - lo
    assert w[500] < w[80]


def test_float32_null_is_profiled_in_float64():
    """A float32 model (the card's scan dtype) is profiled in float64 from
    its own fields: the same interval as its float64 twin up to the float32
    rounding of log delta."""
    y, K = _data(n=150, m=400, seed=4)
    a = fit_null_model(torch.as_tensor(y, dtype=torch.float32),
                       np.ones((150, 1)), K=K)
    b = fit_null_model(y, np.ones((150, 1)), K=K, device="cpu")
    assert a.U.dtype == torch.float32
    assert np.abs(np.subtract(h2_profile_ci(a), h2_profile_ci(b))).max() \
        <= 1e-5
