"""Oracle fixed-effects tests (copy of mixmogam_tpu/oracle/glm.py;
SURVEY.md A.6; reference: linear_models.py
linear_model / anova, plus the Kruskal-Wallis scan)."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import scipy.stats

from mixmogam_tpu_torch.oracle.lmm import gls_f_test


def _observed(row: np.ndarray) -> np.ndarray:
    """Mask of observed genotype calls (int8 -1 / float NaN = missing) —
    missing calls are EXCLUDED per SNP, never a genotype class."""
    if np.issubdtype(row.dtype, np.floating):
        return ~np.isnan(row) & (row >= 0)
    return row >= 0


def ols_scan(G: np.ndarray, y: np.ndarray,
             X0: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """Per-SNP OLS F-test (reference: linear_model): EMMAX with K absent,
    i.e. identity whitening."""
    G = np.asarray(G, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    if X0 is None:
        X0 = np.ones((n, 1))
    X0 = np.atleast_2d(np.asarray(X0, dtype=np.float64))
    M = G.shape[0]
    ps, fs, betas, vps = (np.empty(M) for _ in range(4))
    for j in range(M):
        out = gls_f_test(y, X0, G[j])
        ps[j], fs[j], betas[j], vps[j] = (
            out["p"], out["f_stat"], out["beta"], out["var_perc"])
    return {"ps": ps, "f_stats": fs, "betas": betas, "var_perc": vps}


def anova_scan(G: np.ndarray, y: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-SNP one-way ANOVA treating each distinct genotype value as a
    group (reference: anova / emmax_anova shape)."""
    G = np.asarray(G)
    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    M = G.shape[0]
    ps = np.ones(M)
    fs = np.zeros(M)
    for j in range(M):
        keep = _observed(G[j])
        yj = y[keep]
        nj = len(yj)
        vals = np.unique(G[j][keep])
        groups = [yj[G[j][keep] == v] for v in vals]
        groups = [g for g in groups if len(g) > 0]
        k = len(groups)
        if k < 2:
            continue
        grand = yj.mean()
        ssb = sum(len(g) * (g.mean() - grand) ** 2 for g in groups)
        ssw = sum(((g - g.mean()) ** 2).sum() for g in groups)
        d1, d2 = k - 1, nj - k
        if ssw <= 0 or d2 <= 0:
            continue
        f = (ssb / d1) / (ssw / d2)
        fs[j] = f
        ps[j] = scipy.stats.f.sf(f, d1, d2)
    return {"ps": ps, "f_stats": fs}


def kruskal_wallis_scan(G: np.ndarray, y: np.ndarray) -> Dict[str, np.ndarray]:
    """Per-SNP Kruskal-Wallis rank test with tie correction (A.6)."""
    G = np.asarray(G)
    y = np.asarray(y, dtype=np.float64).ravel()
    M = G.shape[0]
    ps = np.ones(M)
    hs = np.zeros(M)
    for j in range(M):
        keep = _observed(G[j])
        yj = y[keep]
        vals = np.unique(G[j][keep])
        groups = [yj[G[j][keep] == v] for v in vals]
        groups = [g for g in groups if len(g) > 0]
        if len(groups) < 2:
            continue
        try:
            h, p = scipy.stats.kruskal(*groups)
        except ValueError:  # all values identical
            continue
        hs[j], ps[j] = h, p
    return {"ps": ps, "stats": hs}
