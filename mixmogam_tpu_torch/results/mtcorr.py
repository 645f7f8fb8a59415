"""Multiple-testing corrections (copy of mixmogam_tpu/results/mtcorr.py;
reference: mtcorr.py, SURVEY.md §2.1):
Bonferroni, Benjamini-Hochberg step-up, and Benjamini-Hochberg-Yekutieli
(the log-harmonic-corrected variant; reference: get_bhy_thres)."""

from __future__ import annotations

from typing import Dict

import numpy as np


def bonferroni_threshold(num_tests: int, alpha: float = 0.05) -> float:
    return alpha / max(num_tests, 1)


def get_bh_thres(pvals, fdr_thres: float = 0.05) -> Dict[str, float]:
    """Benjamini-Hochberg step-up: largest p_(k) <= k/m * alpha.
    Returns {'thes_pval': threshold, 'thres_i': k} (0 rejections ->
    threshold below min p)."""
    p = np.sort(np.asarray(pvals, dtype=np.float64))
    m = len(p)
    ks = np.arange(1, m + 1)
    ok = p <= ks / m * fdr_thres
    if not ok.any():
        return {"thes_pval": 0.0, "thres_i": 0}
    k = int(np.max(np.nonzero(ok)[0])) + 1
    return {"thes_pval": float(p[k - 1]), "thres_i": k}


def get_bhy_thres(pvals, fdr_thres: float = 0.05) -> Dict[str, float]:
    """Benjamini-Hochberg-Yekutieli: BH with alpha divided by the harmonic
    sum c(m) = sum_{i=1..m} 1/i — valid under arbitrary dependence
    (the LD structure of GWAS p-values; reference: mtcorr.get_bhy_thres)."""
    m = len(np.asarray(pvals))
    c_m = np.sum(1.0 / np.arange(1, m + 1))
    return get_bh_thres(pvals, fdr_thres / c_m)
