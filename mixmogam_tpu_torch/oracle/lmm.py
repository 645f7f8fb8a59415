"""Oracle linear mixed model: REML + EMMAX + EMMA (copy of
mixmogam_tpu/oracle/lmm.py; SURVEY.md A.2–A.4).

Model: y = X beta + u + eps, u ~ N(0, sg2*K), eps ~ N(0, se2*I),
delta = se2/sg2, pseudo-heritability h2 = 1/(1+delta).

Reference shape (linear_models.py): LinearMixedModel._get_eigen_L_ /
_get_eigen_R_ / get_expedited_REMLE / emmax_f_test / emma — implemented
here from the published formulas (Kang et al. 2008, 2010), float64, with
the reference's defaults (ngrids=100, llim=-10, ulim=10, esp=1e-6).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import scipy.linalg
import scipy.optimize
import scipy.stats

DEG_EPS = 1e-8  # relative threshold below which a SNP is degenerate


def eigen_K(K: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """eigh(K) -> (phi, U) with eigenvalues descending.
    (reference: LinearMixedModel._get_eigen_L_)"""
    phi, U = scipy.linalg.eigh(np.asarray(K, dtype=np.float64))
    return phi[::-1].copy(), U[:, ::-1].copy()


def eigen_R(K: np.ndarray, X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Projected spectrum: eigh of S(K+I)S with S = I - X(X'X)^-1 X'.

    Returns (xi, V): the n-q nonzero eigenvalues MINUS the +1 shift
    (descending) and their eigenvectors. (reference: _get_eigen_R_;
    the +I shift is the reference's numerical-stability trick, A.2.)
    """
    K = np.asarray(K, dtype=np.float64)
    X = np.atleast_2d(np.asarray(X, dtype=np.float64))
    n, q = X.shape
    S = np.eye(n) - X @ np.linalg.solve(X.T @ X, X.T)
    M = S @ (K + np.eye(n)) @ S
    M = (M + M.T) / 2.0
    lam, V = scipy.linalg.eigh(M)
    lam = lam[::-1][: n - q] - 1.0
    V = V[:, ::-1][:, : n - q]
    return lam.copy(), V.copy()


def _ll_reml(logdelta: np.ndarray, eta2: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """REML log-likelihood on a grid of log(delta) (A.2 step 4)."""
    d = np.exp(np.atleast_1d(logdelta))[:, None]
    nq = len(xi)
    denom = xi[None, :] + d
    s1 = np.sum(eta2[None, :] / denom, axis=1)
    s2 = np.sum(np.log(denom), axis=1)
    return 0.5 * (nq * (np.log(nq / (2.0 * np.pi)) - 1.0 - np.log(s1)) - s2)


def _dll_reml(logdelta: np.ndarray, eta2: np.ndarray, xi: np.ndarray) -> np.ndarray:
    """d/d(delta) of the REML LL, evaluated at exp(logdelta) (A.2 step 4)."""
    d = np.exp(np.atleast_1d(logdelta))[:, None]
    nq = len(xi)
    denom = xi[None, :] + d
    s1 = np.sum(eta2[None, :] / denom, axis=1)
    s2 = np.sum(eta2[None, :] / denom**2, axis=1)
    s3 = np.sum(1.0 / denom, axis=1)
    return 0.5 * (nq * s2 / s1 - s3)


def _ll_ml(logdelta: np.ndarray, eta2: np.ndarray, xi: np.ndarray,
           phi: np.ndarray) -> np.ndarray:
    """Full ML log-likelihood (EMMA eq. for ML): quadratic part over the
    projected spectrum (xi, eta), determinant over eigenvalues of K (phi)."""
    d = np.exp(np.atleast_1d(logdelta))[:, None]
    n = len(phi)
    s1 = np.sum(eta2[None, :] / (xi[None, :] + d), axis=1)
    s2 = np.sum(np.log(phi[None, :] + d), axis=1)
    return 0.5 * (n * (np.log(n / (2.0 * np.pi)) - 1.0 - np.log(s1)) - s2)


def _dll_ml(logdelta: np.ndarray, eta2: np.ndarray, xi: np.ndarray,
            phi: np.ndarray) -> np.ndarray:
    d = np.exp(np.atleast_1d(logdelta))[:, None]
    n = len(phi)
    denom = xi[None, :] + d
    s1 = np.sum(eta2[None, :] / denom, axis=1)
    s2 = np.sum(eta2[None, :] / denom**2, axis=1)
    s3 = np.sum(1.0 / (phi[None, :] + d), axis=1)
    return 0.5 * (n * s2 / s1 - s3)


def _grid_optimize(ll_fn, dll_fn, ngrids: int, llim: float, ulim: float,
                   esp: float) -> Tuple[float, float]:
    """Reference-style expedited optimizer (A.2 step 5): evaluate dLL on an
    (ngrids+1)-point grid of log(delta); refine every +->- sign-change
    bracket with brentq to esp; candidates are the refined roots plus the
    two endpoints; return (log(delta*), LL*) at the argmax of LL."""
    grid = np.linspace(llim, ulim, ngrids + 1)
    dll = dll_fn(grid)
    cand = [llim, ulim]
    for i in range(ngrids):
        if dll[i] > 0 and dll[i + 1] < 0:
            root = scipy.optimize.brentq(
                lambda x: float(dll_fn(np.array([x]))[0]),
                grid[i], grid[i + 1], xtol=esp)
            cand.append(root)
    cand = np.array(cand)
    lls = ll_fn(cand)
    j = int(np.argmax(lls))
    return float(cand[j]), float(lls[j])


def reml(y: np.ndarray, X: np.ndarray, K: Optional[np.ndarray] = None,
         eig_R: Optional[Tuple[np.ndarray, np.ndarray]] = None,
         ngrids: int = 100, llim: float = -10.0, ulim: float = 10.0,
         esp: float = 1e-6) -> Dict[str, float]:
    """Null-model REML (reference: get_expedited_REMLE). Returns delta,
    variance components, pseudo-heritability and max LL."""
    y = np.asarray(y, dtype=np.float64).ravel()
    X = np.atleast_2d(np.asarray(X, dtype=np.float64))
    n, q = X.shape
    if eig_R is None:
        xi, V = eigen_R(K, X)
    else:
        xi, V = eig_R
    eta = V.T @ y
    eta2 = eta**2
    logdelta, ll = _grid_optimize(
        lambda g: _ll_reml(g, eta2, xi),
        lambda g: _dll_reml(g, eta2, xi),
        ngrids, llim, ulim, esp)
    delta = float(np.exp(logdelta))
    sg2 = float(np.sum(eta2 / (xi + delta)) / (n - q))
    return {
        "delta": delta, "log_delta": logdelta, "ll": ll,
        "sigma_g2": sg2, "sigma_e2": delta * sg2,
        "pseudo_heritability": 1.0 / (1.0 + delta),
    }


def ml(y: np.ndarray, X: np.ndarray, K: np.ndarray,
       eig_K: Optional[Tuple[np.ndarray, np.ndarray]] = None,
       eig_R: Optional[Tuple[np.ndarray, np.ndarray]] = None,
       ngrids: int = 100, llim: float = -10.0, ulim: float = 10.0,
       esp: float = 1e-6) -> Dict[str, float]:
    """Full maximum likelihood (used by LRT and the MLMM BIC criteria)."""
    y = np.asarray(y, dtype=np.float64).ravel()
    X = np.atleast_2d(np.asarray(X, dtype=np.float64))
    n, q = X.shape
    phi, _ = eigen_K(K) if eig_K is None else eig_K
    xi, V = eigen_R(K, X) if eig_R is None else eig_R
    eta2 = (V.T @ y) ** 2
    logdelta, ll = _grid_optimize(
        lambda g: _ll_ml(g, eta2, xi, phi),
        lambda g: _dll_ml(g, eta2, xi, phi),
        ngrids, llim, ulim, esp)
    delta = float(np.exp(logdelta))
    sg2 = float(np.sum(eta2 / (xi + delta)) / n)
    return {
        "delta": delta, "log_delta": logdelta, "ll": ll,
        "sigma_g2": sg2, "sigma_e2": delta * sg2,
        "pseudo_heritability": 1.0 / (1.0 + delta),
    }


def _h_inv_sqrt(phi: np.ndarray, U: np.ndarray, delta: float) -> np.ndarray:
    """H^{-1/2} = U diag(1/sqrt(phi+delta)) U^T (A.3 step 1)."""
    return (U / np.sqrt(phi + delta)[None, :]) @ U.T


def gls_f_test(y_star: np.ndarray, X0_star: np.ndarray, x_star: np.ndarray
               ) -> Dict[str, float]:
    """Single rotated-GLS F-test of one extra column x_star against the null
    design X0_star, both already whitened (A.3 step 3). Reference shape:
    the per-SNP body of emmax_f_test (lstsq + F + sf)."""
    n, q = X0_star.shape
    (b0, rss0_arr, _, _) = np.linalg.lstsq(X0_star, y_star, rcond=None)
    rss0 = float(rss0_arr[0]) if rss0_arr.size else float(
        np.sum((y_star - X0_star @ b0) ** 2))
    X1 = np.hstack([X0_star, x_star[:, None]])
    (b1, rss1_arr, rank1, _) = np.linalg.lstsq(X1, y_star, rcond=None)
    if rank1 <= q:
        return {"p": 1.0, "f_stat": 0.0, "beta": 0.0, "var_perc": 0.0,
                "rss0": rss0, "rss1": rss0}
    rss1 = float(rss1_arr[0]) if rss1_arr.size else float(
        np.sum((y_star - X1 @ b1) ** 2))
    d2 = n - q - 1
    f = (rss0 - rss1) / (rss1 / d2)
    p = float(scipy.stats.f.sf(f, 1, d2))
    return {"p": p, "f_stat": float(f), "beta": float(b1[-1]),
            "var_perc": float((rss0 - rss1) / rss0), "rss0": rss0,
            "rss1": rss1}


def emmax_scan(G: np.ndarray, y: np.ndarray, K: np.ndarray,
               X0: Optional[np.ndarray] = None,
               eig_K: Optional[Tuple[np.ndarray, np.ndarray]] = None,
               ngrids: int = 100, llim: float = -10.0, ulim: float = 10.0,
               esp: float = 1e-6, with_betas: bool = True) -> Dict[str, np.ndarray]:
    """EMMAX (A.3; reference: linear_models.emmax -> emmax_f_test):
    one null REML fit, then a per-SNP loop of rotated-GLS F-tests.

    G: (M, n) dosage rows; y: (n,); X0: (n, q) null design (default
    intercept-only); returns dict of arrays over SNPs plus scalars.
    """
    G = np.asarray(G, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    if X0 is None:
        X0 = np.ones((n, 1))
    X0 = np.atleast_2d(np.asarray(X0, dtype=np.float64))
    phi, U = eigen_K(K) if eig_K is None else eig_K
    r = reml(y, X0, K=K, ngrids=ngrids, llim=llim, ulim=ulim, esp=esp)
    delta = r["delta"]
    Hi = _h_inv_sqrt(phi, U, delta)
    y_star = Hi @ y
    X0_star = Hi @ X0
    M = G.shape[0]
    ps = np.empty(M)
    fs = np.empty(M)
    betas = np.empty(M)
    vps = np.empty(M)
    for j in range(M):  # reference-shaped python loop over SNPs
        x_star = Hi @ G[j]
        out = gls_f_test(y_star, X0_star, x_star)
        ps[j], fs[j] = out["p"], out["f_stat"]
        betas[j], vps[j] = out["beta"], out["var_perc"]
    res = {"ps": ps, "f_stats": fs, "pseudo_heritability":
           r["pseudo_heritability"], "delta": delta, "reml": r}
    if with_betas:
        res["betas"] = betas
        res["var_perc"] = vps
    return res


def emma_scan(G: np.ndarray, y: np.ndarray, K: np.ndarray,
              X0: Optional[np.ndarray] = None,
              ngrids: int = 100, llim: float = -10.0, ulim: float = 10.0,
              esp: float = 1e-6) -> Dict[str, np.ndarray]:
    """EMMA exact scan (A.4; reference: linear_models.emma): per-SNP REML
    re-fit (projected spectrum recomputed for X=[X0,x]), then a GLS F-test
    at the per-SNP delta. O(M n^3) — oracle use on small cases only."""
    G = np.asarray(G, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    if X0 is None:
        X0 = np.ones((n, 1))
    X0 = np.atleast_2d(np.asarray(X0, dtype=np.float64))
    phi, U = eigen_K(K)
    M = G.shape[0]
    ps = np.empty(M)
    fs = np.empty(M)
    deltas = np.empty(M)
    betas = np.empty(M)
    for j in range(M):
        x = G[j]
        X = np.hstack([X0, x[:, None]])
        if np.linalg.matrix_rank(X) <= X0.shape[1]:
            ps[j], fs[j], deltas[j], betas[j] = 1.0, 0.0, np.nan, 0.0
            continue
        r = reml(y, X, K=K, ngrids=ngrids, llim=llim, ulim=ulim, esp=esp)
        deltas[j] = r["delta"]
        Hi = _h_inv_sqrt(phi, U, r["delta"])
        out = gls_f_test(Hi @ y, Hi @ X0, Hi @ x)
        ps[j], fs[j], betas[j] = out["p"], out["f_stat"], out["beta"]
    return {"ps": ps, "f_stats": fs, "deltas": deltas, "betas": betas}
