"""PyTorch port, ops/xreml.py: the small-matrix helpers and single-design
(RE)ML against mixmogam_tpu/ops/xreml.py (CPU, x64) on the same numpy
inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixmogam_tpu.ops import xreml as jx
from mixmogam_tpu.oracle.kinship import ibs_kinship, scale_k
from mixmogam_tpu_torch.ops import xreml

torch.set_num_threads(1)


def _design(p, seed=0, n=120):
    """(phi, y_rot, X_rot) in the eigenbasis of an IBS kinship; X holds an
    intercept and p - 1 normal covariates."""
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 2, (400, n)).astype(np.float64)
    w, v = np.linalg.eigh(scale_k(ibs_kinship(G)))
    phi, U = w[::-1].copy(), v[:, ::-1].copy()
    X = np.column_stack([np.ones(n), rng.normal(size=(n, p - 1))])
    y = G[3] * 0.9 + X @ rng.normal(size=p) * 0.3 + rng.normal(size=n)
    return phi, U.T @ y, U.T @ X


def _spd(p, batch=(3,), seed=0):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=batch + (p, p + 2))
    return B @ np.swapaxes(B, -1, -2) + 0.1 * np.eye(p)


@pytest.mark.parametrize("p", [1, 4, 12])
def test_small_helpers_match_jax(p):
    A = _spd(p, seed=p)
    b = np.random.default_rng(p).normal(size=(3, p))
    L = xreml.chol_small(torch.from_numpy(A))
    Lj = np.asarray(jx.chol_small(jnp.asarray(A)))
    np.testing.assert_allclose(L.numpy(), Lj, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(
        xreml.chol_solve_small(L, torch.from_numpy(b)).numpy(),
        np.asarray(jx.chol_solve_small(jnp.asarray(Lj), jnp.asarray(b))),
        rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        xreml.inv_small(torch.from_numpy(A)).numpy(),
        np.asarray(jx.inv_small(jnp.asarray(A))), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(
        xreml.chol_logdet_small(L).numpy(),
        np.asarray(jx.chol_logdet_small(jnp.asarray(Lj))), rtol=1e-12)


def test_chol_small_clamps_a_semidefinite_pivot():
    """A rank-1 2 x 2 matrix: the second pivot is 0 (or rounding below
    it) and is clamped at tiny, as in the JAX package: finite factors."""
    v = np.array([[1.0], [2.0]])
    A = v @ v.T
    L = xreml.chol_small(torch.from_numpy(A)).numpy()
    np.testing.assert_array_equal(np.isfinite(L), True)
    np.testing.assert_allclose(L, np.asarray(jx.chol_small(jnp.asarray(A))),
                               atol=1e-150)


@pytest.mark.parametrize("p", [1, 4, 12])
@pytest.mark.parametrize("reml", [True, False])
def test_explicit_reml_matches_jax(p, reml):
    """log delta, LL and beta to 1e-10 (the other values follow)."""
    phi, yr, Xr = _design(p, seed=p)
    ref = jx.explicit_reml(jnp.asarray(phi), jnp.asarray(yr), jnp.asarray(Xr),
                           refine_iters=24, reml=reml)
    got = xreml.explicit_reml(torch.from_numpy(phi), torch.from_numpy(yr),
                              torch.from_numpy(Xr), refine_iters=24,
                              reml=reml)
    for k in ("log_delta", "ll", "delta", "sigma_g2", "sigma_e2",
              "pseudo_heritability"):
        r = float(ref[k])
        assert abs(float(got[k]) - r) <= 1e-10 * max(1.0, abs(r)), k
    np.testing.assert_allclose(got["beta"].numpy(), np.asarray(ref["beta"]),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("p,reml", [(1, True), (4, False), (12, True)])
def test_dll_signs_match_jax_autodiff(p, reml):
    """The analytic dLL/dlog delta against jax.grad of ll_explicit on the
    grid: the same value to 1e-8 relative, so the same bracket signs; LL
    itself to 1e-10."""
    phi, yr, Xr = _design(p, seed=10 + p)
    grid = np.linspace(-10.0, 10.0, 101)
    args = (jnp.asarray(phi), jnp.asarray(yr), jnp.asarray(Xr))
    dref = np.asarray(jax.vmap(jax.grad(
        lambda g: jx.ll_explicit(g, *args, reml=reml)))(jnp.asarray(grid)))
    targs = tuple(torch.from_numpy(a) for a in (phi, yr, Xr))
    d = xreml.dll_explicit(torch.from_numpy(grid), *targs, reml=reml).numpy()
    np.testing.assert_array_equal(np.sign(d), np.sign(dref))
    np.testing.assert_allclose(d, dref, rtol=1e-8, atol=1e-10)
    ll = xreml.ll_explicit(torch.from_numpy(grid), *targs, reml=reml).numpy()
    np.testing.assert_allclose(
        ll, np.asarray(jx.ll_explicit(jnp.asarray(grid), *args, reml=reml)),
        rtol=1e-10)


def test_explicit_reml_at_a_grid_end():
    """y without kinship signal: the fit can sit at an end of the grid
    (no bracket, no bisection); the port and JAX pick the same candidate."""
    phi, _, Xr = _design(2, seed=5)
    yr = np.random.default_rng(9).normal(size=phi.shape[0])
    ref = jx.explicit_reml(jnp.asarray(phi), jnp.asarray(yr), jnp.asarray(Xr),
                           refine_iters=18)
    got = xreml.explicit_reml(torch.from_numpy(phi), torch.from_numpy(yr),
                              torch.from_numpy(Xr), refine_iters=18)
    assert abs(float(got["log_delta"]) - float(ref["log_delta"])) <= 1e-10
    assert abs(float(got["ll"]) - float(ref["ll"])) <= 1e-10 * abs(
        float(ref["ll"]))
