"""Oracle stepwise MLMM (copy of mixmogam_tpu/oracle/stepwise.py;
SURVEY.md A.5; Segura et al. 2012; reference:
linear_models.emmax_step_wise).

Forward steps: full re-REML with current cofactors -> full EMMAX scan ->
add the argmin-p SNP as a cofactor. Per step we record pseudo-heritability
and the model-selection criteria:

- BIC   = -2*LL_ML + k*ln(n)
- eBIC  = BIC + 2*ln C(M, k)              (extended BIC, Chen & Chen 2008)
- mBIC  = -2*LL_ML + k*ln(n) + 2*k*ln(M/2.2 - 1)   (Bogdan et al. 2004)
- mbonf = the largest model in the path whose cofactors ALL pass the
          Bonferroni threshold alpha/M when re-tested in the full model.

Backward elimination then drops the least-significant cofactor one at a
time, extending the model path; each criterion selects its optimum over the
whole forward+backward path.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import scipy.special

from mixmogam_tpu_torch.oracle.lmm import (
    eigen_K, reml, ml, _h_inv_sqrt, gls_f_test, emmax_scan,
)


def _log_binom(m: int, k: int) -> float:
    return float(scipy.special.gammaln(m + 1) - scipy.special.gammaln(k + 1)
                 - scipy.special.gammaln(m - k + 1))


def _cofactor_pvals(G, y, K, phi, U, X0, cof: List[int], delta: float
                    ) -> np.ndarray:
    """Re-test each cofactor by dropping it from the full model (GLS F-test
    at the current delta)."""
    Hi = _h_inv_sqrt(phi, U, delta)
    y_star = Hi @ y
    out = np.ones(len(cof))
    for i, j in enumerate(cof):
        others = [c for c in cof if c != j]
        Xn = np.hstack([X0] + [G[c][:, None] for c in others])
        res = gls_f_test(y_star, Hi @ Xn, Hi @ G[j])
        out[i] = res["p"]
    return out


def _criteria(ml_res, k: int, n: int, M: int) -> Dict[str, float]:
    bic = -2.0 * ml_res["ll"] + k * np.log(n)
    ebic = bic + 2.0 * _log_binom(M, k)
    mbic = -2.0 * ml_res["ll"] + k * np.log(n) + 2.0 * k * np.log(max(M / 2.2 - 1.0, 1.0))
    return {"bic": float(bic), "ebic": float(ebic), "mbic": float(mbic)}


def mlmm_step_wise(G: np.ndarray, y: np.ndarray, K: np.ndarray,
                   max_steps: int = 10, X0: Optional[np.ndarray] = None,
                   alpha: float = 0.05, ngrids: int = 100,
                   llim: float = -10.0, ulim: float = 10.0, esp: float = 1e-6,
                   save_scans: bool = False) -> Dict:
    G = np.asarray(G, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    M = G.shape[0]
    if X0 is None:
        X0 = np.ones((n, 1))
    X0 = np.atleast_2d(np.asarray(X0, dtype=np.float64))
    phi_U = eigen_K(K)
    phi, U = phi_U
    bonf = alpha / M

    steps: List[Dict] = []
    cof: List[int] = []

    def record(cof_now: List[int], phase: str):
        X = np.hstack([X0] + [G[c][:, None] for c in cof_now])
        r = reml(y, X, K=K, ngrids=ngrids, llim=llim, ulim=ulim, esp=esp)
        m = ml(y, X, K, eig_K=phi_U, ngrids=ngrids, llim=llim, ulim=ulim,
               esp=esp)
        crit = _criteria(m, len(cof_now), n, M)
        cof_ps = _cofactor_pvals(G, y, K, phi, U, X0, cof_now, r["delta"])
        step = {
            "phase": phase,
            "cofactors": list(cof_now),
            "cofactor_ps": cof_ps,
            "delta": r["delta"],
            "pseudo_heritability": r["pseudo_heritability"],
            "ll_ml": m["ll"],
            "mbonf_ok": bool(np.all(cof_ps < bonf)) if cof_now else True,
            **crit,
        }
        return step, r

    # forward
    for _ in range(max_steps):
        step, r = record(cof, "forward")
        scan = emmax_scan(G, y, K, X0=np.hstack(
            [X0] + [G[c][:, None] for c in cof]), eig_K=phi_U,
            ngrids=ngrids, llim=llim, ulim=ulim, esp=esp, with_betas=False)
        ps = scan["ps"].copy()
        ps[cof] = 1.1  # never re-select a cofactor
        jmin = int(np.argmin(ps))
        step["min_p"] = float(ps[jmin])
        step["min_p_snp"] = jmin
        if save_scans:
            step["scan_ps"] = scan["ps"]
        steps.append(step)
        cof = cof + [jmin]

    # final forward model
    step, _ = record(cof, "forward")
    step["min_p"] = np.nan
    step["min_p_snp"] = -1
    steps.append(step)

    # backward elimination: drop the least significant cofactor each time
    while cof:
        last = steps[-1]
        worst = int(np.argmax(last["cofactor_ps"]))
        cof = [c for i, c in enumerate(cof) if i != worst]
        step, _ = record(cof, "backward")
        step["min_p"] = np.nan
        step["min_p_snp"] = -1
        steps.append(step)

    # selection per criterion over the whole path
    sel = {}
    for c in ("bic", "ebic", "mbic"):
        j = int(np.argmin([s[c] for s in steps]))
        sel[c] = {"step": j, "cofactors": steps[j]["cofactors"]}
    ok = [i for i, s in enumerate(steps) if s["mbonf_ok"]]
    jm = max(ok, key=lambda i: (len(steps[i]["cofactors"]), -i)) if ok else 0
    sel["mbonf"] = {"step": jm, "cofactors": steps[jm]["cofactors"]}

    return {"steps": steps, "selected": sel, "bonf_threshold": bonf}
