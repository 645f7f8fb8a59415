"""PyTorch port, the spectrum REML: ops/eigen.py::projected_spectrum,
ops/reml.py::reml_from_spectrum and fit_null_model(method='spectrum'),
held to the JAX package under x64 and to the port's own X-explicit path.

Eigenvectors of a degenerate eigenspace are not unique (K = I, VanRaden's
singular K), so V is compared by its projector V V', never column by
column. Tolerances: xi to 1e-10 relative to max |xi|, V V' to 1e-10;
reml_from_spectrum's log delta to 1e-9 and ll / sigma_g2 to 1e-9
relative; spectrum against explicit to tests/test_explicit_reml.py's own
gates (|d log delta| < 1e-6, |d h2| < 1e-9)."""

import functools

import jax
import numpy as np
import pytest
import torch

from mixmogam_tpu.ops import eigen as jeigen
from mixmogam_tpu.ops import reml as jreml
from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                              simulate_phenotype)
from mixmogam_tpu_torch.ops.eigen import projected_spectrum
from mixmogam_tpu_torch.ops.reml import fit_null_model, reml_from_spectrum
from mixmogam_tpu_torch.oracle.kinship import (ibs_kinship, scale_k,
                                               vanraden_kinship)

torch.set_num_threads(1)

_KEYS = ("log_delta", "delta", "ll", "sigma_g2", "sigma_e2",
         "pseudo_heritability")


def _sim(seed, n=120, q=1, m=300):
    """IBS kinship of random 0/1 genotypes, a design of an intercept and
    q - 1 normal covariates, y = X b + u + noise."""
    rng = np.random.default_rng(seed)
    Z = rng.integers(0, 2, (m, n)).astype(np.float64)
    K = (Z.T @ Z + (1 - Z).T @ (1 - Z)) / m
    X0 = np.column_stack([np.ones(n), rng.normal(size=(n, q - 1))])
    u = rng.multivariate_normal(np.zeros(n), K)
    y = X0 @ rng.normal(size=q) + u + 0.7 * rng.normal(size=n)
    return y, X0, K


@functools.lru_cache(maxsize=None)
def _singular():
    """tests/test_torch_fold.py's fixture: VanRaden's K (a zero eigenvalue
    along the intercept), n = 256, seed 3; REML puts delta at its lower
    bound."""
    G, _, _ = simulate_genotypes(256, 3_000, ploidy=1, seed=3)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=4, seed=3)
    K = scale_k(vanraden_kinship(G.astype(np.float64), ploidy=1))
    return y, np.ones((256, 1)), K


def _identity(n=90, seed=4):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n), np.column_stack(
        [np.ones(n), rng.normal(size=n)]), np.eye(n)


_FIXTURES = {"ibs_q1": lambda: _sim(0), "ibs_q3": lambda: _sim(1, q=3),
             "singular": _singular, "identity": _identity}


def _proj(V):
    V = np.asarray(V, np.float64)
    return V @ V.T


@pytest.mark.parametrize("host", [True, False])
@pytest.mark.parametrize("case", sorted(_FIXTURES))
def test_projected_spectrum_matches_jax(case, host):
    y, X0, K = _FIXTURES[case]()
    xi_j, V_j = jeigen.projected_spectrum(K, X0, host=host)
    xi, V = projected_spectrum(K, X0, host=host, device="cpu")
    n, q = X0.shape
    assert xi.dtype == V.dtype == torch.float64
    assert xi.shape == (n - q,) and V.shape == (n, n - q)
    xi_j = np.asarray(xi_j)
    assert np.abs(xi.numpy() - xi_j).max() <= 1e-10 * np.abs(xi_j).max()
    assert np.abs(_proj(V) - _proj(V_j)).max() <= 1e-10
    # descending, and V spans the complement of col(X0)
    assert (np.diff(xi.numpy()) <= 1e-12).all()
    assert np.abs(V.numpy().T @ X0).max() <= 1e-9 * np.abs(X0).max()


def test_projected_spectrum_null_split_under_the_singular_k():
    """Under VanRaden's K the kept eigenvalues of S(K+I)S are xi + 1 >= 1
    and the q dropped ones 0: the split is a gap of about 1, and the
    projector V V' is exactly I - P_X."""
    y, X0, K = _singular()
    xi, V = projected_spectrum(K, X0, device="cpu")
    assert xi.min() > -1e-10
    n = K.shape[0]
    P = X0 @ np.linalg.solve(X0.T @ X0, X0.T)
    assert np.abs(_proj(V) - (np.eye(n) - P)).max() <= 1e-10


def test_projected_spectrum_default_host_and_one_dimensional_x():
    """host=None on the CPU is host LAPACK, equal to host=True; a 1-D X is
    taken as (1, n), np.atleast_2d's rule, as the JAX function does."""
    y, X0, K = _sim(2)
    a = projected_spectrum(K, X0, device="cpu")
    b = projected_spectrum(K, X0, host=True, device="cpu")
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(RuntimeError):
        projected_spectrum(K, X0[:, 0], device="cpu")
    with pytest.raises(ValueError):
        jeigen.projected_spectrum(K, X0[:, 0], host=True)


def _spectrum(case):
    y, X0, K = _FIXTURES[case]()
    xi, V = jeigen.projected_spectrum(K, X0, host=True)
    eta2 = (np.asarray(V).T @ y) ** 2
    phi = np.linalg.eigvalsh(K)[::-1].copy()
    return eta2, np.asarray(xi), phi


def _close(got, ref, keys=_KEYS):
    for k in keys:
        g, r = got[k].numpy(), np.asarray(ref[k])
        if k == "log_delta":
            assert np.abs(g - r).max() <= 1e-9, k
        else:
            assert np.abs(g - r).max() <= 1e-9 * np.abs(r).max(), k


@pytest.mark.parametrize("ml", [False, True])
@pytest.mark.parametrize("case", ["ibs_q1", "ibs_q3", "singular"])
def test_reml_from_spectrum_matches_jax(case, ml):
    eta2, xi, phi = _spectrum(case)
    kw = dict(phi=phi if ml else None, ml=ml)
    ref = jreml.reml_from_spectrum(eta2, xi, **kw)
    got = reml_from_spectrum(eta2, xi, device="cpu", **kw)
    for k in _KEYS:
        assert got[k].dtype == torch.float64 and got[k].shape == ()
    _close(got, ref)


def test_reml_from_spectrum_batched_matches_vmap():
    """(T = 4, n - q) eta2 against jax.vmap over traits, REML and ML, and
    each row against its own unbatched call."""
    _, X0, K = _sim(5)
    xi, V = jeigen.projected_spectrum(K, X0, host=True)
    xi = np.array(xi)
    phi = np.linalg.eigvalsh(K)[::-1].copy()
    Y = np.random.default_rng(6).normal(size=(4, K.shape[0]))
    Y[1] += np.random.default_rng(7).multivariate_normal(
        np.zeros(K.shape[0]), 3.0 * K)
    eta2 = (Y @ np.asarray(V)) ** 2
    for ml in (False, True):
        kw = dict(phi=phi if ml else None, ml=ml)
        ref = jax.vmap(lambda e: jreml.reml_from_spectrum(e, xi, **kw))(
            eta2)
        got = reml_from_spectrum(torch.as_tensor(eta2), torch.as_tensor(xi),
                                 **kw)
        assert got["delta"].shape == (4,)
        _close(got, ref)
        one = reml_from_spectrum(eta2[1], xi, device="cpu", **kw)
        assert float(one["log_delta"]) == float(got["log_delta"][1])


def test_reml_from_spectrum_runs_float64_on_float32_input():
    """A float32 spectrum runs in float64 (JAX's jitted function keeps the
    input's dtype; the port does not): equal to the float64 call on the
    upcast inputs, and held to JAX under x64 there."""
    eta2, xi, _ = _spectrum("ibs_q1")
    e32, x32 = eta2.astype(np.float32), xi.astype(np.float32)
    got = reml_from_spectrum(torch.as_tensor(e32), torch.as_tensor(x32))
    ref = reml_from_spectrum(e32.astype(np.float64), x32.astype(np.float64),
                             device="cpu")
    for k in _KEYS:
        assert got[k].dtype == torch.float64
        assert float(got[k]) == float(ref[k])
    _close(got, jreml.reml_from_spectrum(e32.astype(np.float64),
                                         x32.astype(np.float64)))


def test_reml_from_spectrum_flat_surface_under_identity_k():
    """K = I: every xi is 1, so LL does not depend on delta and dLL's sign
    is rounding. The maximum LL and sigma_g2 (1 + delta) = sum eta2 / (n -
    q) are what both packages must agree on."""
    eta2, xi, _ = _spectrum("identity")
    assert np.abs(xi - 1.0).max() <= 1e-12
    got = reml_from_spectrum(eta2, xi, device="cpu")
    ref = jreml.reml_from_spectrum(eta2, xi)
    assert abs(float(got["ll"]) - float(ref["ll"])) <= 1e-9 * abs(
        float(ref["ll"]))
    for r in (got, ref):
        inv = float(r["sigma_g2"]) * (1.0 + float(r["delta"]))
        assert abs(inv - eta2.sum() / eta2.size) <= 1e-12 * inv


def test_reml_from_spectrum_ml_needs_phi():
    eta2, xi, _ = _spectrum("ibs_q1")
    with pytest.raises(ValueError, match="phi"):
        reml_from_spectrum(eta2, xi, ml=True, device="cpu")


@pytest.mark.parametrize("case,ml", [("ibs_q1", False), ("ibs_q3", False),
                                     ("ibs_q1", True), ("ibs_q3", True),
                                     ("singular", False),
                                     ("singular", True)])
def test_fit_null_model_spectrum(case, ml):
    """method='spectrum' against the JAX package's spectrum path (1e-9)
    and against the port's own explicit path (the gates of
    tests/test_explicit_reml.py)."""
    y, X0, K = _FIXTURES[case]()
    a = fit_null_model(y, X0, K=K, method="spectrum", ml=ml, device="cpu")
    b = fit_null_model(y, X0, K=K, method="explicit", ml=ml, device="cpu")
    j = jreml.fit_null_model(y, X0, K=K, method="spectrum", ml=ml)
    assert a.ml is ml and b.ml is ml
    _close(vars(a), {k: getattr(j, k) for k in _KEYS})
    assert abs(float(a.log_delta) - float(b.log_delta)) < 1e-6
    assert abs(float(a.ll) - float(b.ll)) < 1e-8
    assert abs(float(a.pseudo_heritability)
               - float(b.pseudo_heritability)) < 1e-9
    assert torch.equal(a.phi, b.phi) and torch.equal(a.U, b.U)


def test_fit_null_model_spectrum_from_eig_k_alone():
    """eig_k without K: K is rebuilt as U diag(phi) U' (as in JAX)."""
    y, X0, K = _sim(7)
    w, v = np.linalg.eigh(K)
    phi, U = w[::-1].copy(), v[:, ::-1].copy()
    a = fit_null_model(y, X0, eig_k=(phi, U), method="spectrum",
                       device="cpu")
    j = jreml.fit_null_model(y, X0, eig_k=(phi, U), method="spectrum")
    b = fit_null_model(y, X0, K=K, method="explicit", device="cpu")
    _close(vars(a), {k: getattr(j, k) for k in _KEYS})
    assert abs(float(a.log_delta) - float(b.log_delta)) < 1e-6


def test_fit_null_model_spectrum_casts_to_the_model_dtype():
    y, X0, K = _sim(8)
    a = fit_null_model(torch.as_tensor(y, dtype=torch.float32), X0, K=K,
                       method="spectrum")
    b = fit_null_model(y, X0, K=K, method="spectrum", device="cpu")
    assert a.delta.dtype == a.U.dtype == torch.float32
    assert float(a.delta) == pytest.approx(float(b.delta), rel=1e-6)


def test_fit_null_model_spectrum_k_identity():
    """K = I (degenerate): the flat LL is the same at whatever delta each
    package picks, and sigma_g2 (1 + delta) is the residual variance."""
    y, X0, K = _identity()
    a = fit_null_model(y, X0, K=K, method="spectrum", device="cpu")
    j = jreml.fit_null_model(y, X0, K=K, method="spectrum")
    assert abs(float(a.ll) - float(j.ll)) <= 1e-9 * abs(float(j.ll))
    r = y - X0 @ np.linalg.lstsq(X0, y, rcond=None)[0]
    inv = float(a.sigma_g2) * (1.0 + float(a.delta))
    assert inv == pytest.approx(r @ r / (len(y) - 2), rel=1e-10)


def test_spectrum_entry_points_default_to_the_card():
    """Without a card, device=None on array input raises naming
    device="cpu" (a tensor xi keeps its own device); the unknown method is
    refused."""
    y, X0, K = _sim(9, n=40)
    eta2, xi, _ = _spectrum("ibs_q1")
    for call in (lambda: projected_spectrum(K, X0),
                 lambda: fit_null_model(y, X0, K=K, method="spectrum"),
                 lambda: reml_from_spectrum(eta2, xi)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    got = reml_from_spectrum(torch.tensor(eta2), torch.tensor(xi))
    assert got["delta"].device == torch.device("cpu")
    with pytest.raises(ValueError, match="spectrum"):
        fit_null_model(y, X0, K=K, method="grid", device="cpu")
