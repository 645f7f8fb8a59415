"""Reference-compatible class facade (counterpart of mixmogam_tpu/compat.py:
the `linear_models.py` class API).

Users of the reference drive GWAS through two stateful classes
(`LinearModel` / `LinearMixedModel` in `linear_models.py`): construct with
the phenotype, `add_factor()` cofactor columns, `add_random_effect(K)`,
then call `get_expedited_REMLE()` / `emmax_f_test(snps)` / etc. These
classes keep the reference's (and the JAX package's) method names, and
each method is a thin stateful shell over the port's functional core
(`ops.reml`, `ops.eigen`, `models.*`).

Where the state lives:
- the phenotype Y and the design X are float64 numpy arrays on the host,
  as in the JAX package; `add_factor`'s QR and `least_square_estimate`'s
  lstsq are O(n q^2) host algebra;
- the kinship K and its cached eigendecomposition (phi, U) are float64
  tensors on the instance's device, so repeated scans never re-pay the
  eigh, and `_get_eigen_L_` / `_get_eigen_R_` hand them back there.

The device is explicit: `LinearModel(Y)` / `LinearMixedModel(Y)` run on the
card (raising without one) unless `device="cpu"` is given, and every
delegate runs there.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


class LinearModel:
    """Fixed-effects-only model (reference: linear_models.LinearModel).

    >>> lm = LinearModel(y)                  # the card; device="cpu" asks
    >>> lm.add_factor(covariate)
    >>> res = lm.fast_f_test(snps)           # per-SNP OLS F-tests
    """

    def __init__(self, Y, device=None):
        from mixmogam_tpu_torch.ops import resolve_device

        self.device = resolve_device(device)
        self.Y = np.asarray(Y, dtype=np.float64).ravel()
        n = self.Y.shape[0]
        self.X = np.ones((n, 1), dtype=np.float64)  # intercept

    @property
    def n(self) -> int:
        return self.Y.shape[0]

    @property
    def p(self) -> int:
        return self.X.shape[1]

    def add_factor(self, x, lin_depend_thres: float = 1e-4) -> bool:
        """Append a fixed-effect column (reference: add_factor). Returns
        False (and does not add) if the column is linearly dependent on
        the current design, mirroring the reference's check."""
        x = np.asarray(x, dtype=np.float64).ravel()
        if x.shape[0] != self.n:
            raise ValueError(f"factor length {x.shape[0]} != n={self.n}")
        Q, _ = np.linalg.qr(self.X)
        r = x - Q @ (Q.T @ x)
        denom = float(x @ x) or 1.0
        if float(r @ r) / denom < lin_depend_thres:
            return False
        self.X = np.column_stack([self.X, x])
        return True

    def least_square_estimate(self) -> Dict[str, np.ndarray]:
        """OLS of Y on the current design (reference:
        least_square_estimate). Returns betas, residuals, rss, rank."""
        beta, rss, rank, _ = np.linalg.lstsq(self.X, self.Y, rcond=None)
        resid = self.Y - self.X @ beta
        rss_val = float(resid @ resid) if rss.size == 0 else float(rss[0])
        return {"betas": beta, "residuals": resid, "rss": rss_val,
                "rank": int(rank)}

    def get_estimates(self) -> Dict[str, np.ndarray]:
        return self.least_square_estimate()

    def fast_f_test(self, snps, with_betas: bool = True, **kw) -> Dict:
        """Per-SNP OLS F-tests against the current design (kernel K3 on
        the card; reference: LinearModel.fast_f_test)."""
        from mixmogam_tpu_torch.models.linear import linear_model

        return linear_model(snps, self.Y, X0=self.X, with_betas=with_betas,
                            device=self.device, **kw)

    def anova_f_test(self, snps, **kw) -> Dict:
        """Per-SNP genotype-class ANOVA (reference: anova_f_test).

        The categorical ANOVA tests genotype-class means against the
        grand mean only; covariate-adjusted class tests are a different
        model, so cofactors added via add_factor are NOT silently
        dropped — they raise."""
        from mixmogam_tpu_torch.models.linear import anova

        if self.X.shape[1] > 1:
            raise NotImplementedError(
                "anova_f_test does not support cofactors; use "
                "fast_f_test (additive coding) or "
                "LinearMixedModel.emmax_anova_f_test with X0")
        return anova(snps, self.Y, device=self.device, **kw)

    def test_explained_variance(self, snps, **kw) -> Dict:
        d = self.fast_f_test(snps, with_betas=True, **kw)
        return {"var_perc": d["var_perc"], "ps": d["ps"]}


class LinearMixedModel(LinearModel):
    """Mixed model y = Xb + u + e, u ~ N(0, sg2 K)
    (reference: linear_models.LinearMixedModel).

    >>> lmm = LinearMixedModel(y)            # the card; device="cpu" asks
    >>> lmm.add_random_effect(K)
    >>> reml = lmm.get_expedited_REMLE()     # variance components
    >>> res = lmm.emmax_f_test(snps)         # the EMMAX scan
    """

    def __init__(self, Y, device=None):
        super().__init__(Y, device)
        self.K = None               # (n, n) float64 tensor on self.device
        self._K_src = None          # the object K was given as
        self._eig_k = None          # cached (phi, U) of K, on self.device
        self._reml = None           # cached REML fit for the current X

    # ---- random effect / eigen caches ----
    def add_random_effect(self, cov_matrix) -> None:
        """Set the (single) genetic random effect's covariance
        (reference: add_random_effect; one K supported, as in EMMA)."""
        import torch

        K = torch.as_tensor(cov_matrix, device=self.device).to(
            torch.float64)
        if tuple(K.shape) != (self.n, self.n):
            raise ValueError(
                f"K must be ({self.n}, {self.n}); got {tuple(K.shape)}")
        self.K = K
        self._K_src = cov_matrix
        self._eig_k = None
        self._reml = None

    def add_factor(self, x, lin_depend_thres: float = 1e-4) -> bool:
        added = super().add_factor(x, lin_depend_thres)
        if added:
            self._reml = None      # X changed -> REML stale
        return added

    def _same_k(self, K) -> bool:
        """K is the stored kinship: the same object, or equal to it,
        compared on the device (no n^2 host copy)."""
        import torch

        if self.K is None:
            return False
        if K is self.K or K is self._K_src:
            return True
        if tuple(np.shape(K)) != tuple(self.K.shape):
            return False
        return torch.equal(torch.as_tensor(K, device=self.device).to(
            torch.float64), self.K)

    def _get_eigen_L_(self, K=None):
        """eigh(K), cached (reference: _get_eigen_L_). Returns
        {'values': phi, 'vectors': U^T} in the reference's layout, as
        float64 tensors on the instance's device: a numpy copy would be
        one n^2 device-to-host copy a call (839 MB at n = 10,240).

        Passing the SAME K again (the reference's call pattern re-passes
        it before every scan) keeps the cached eigh."""
        from mixmogam_tpu_torch.ops.eigen import eigen_k_on

        if K is not None and not self._same_k(K):
            self.add_random_effect(K)
        if self.K is None:
            raise ValueError("call add_random_effect(K) first")
        if self._eig_k is None:
            self._eig_k = eigen_k_on(self.K, self.device)
        phi, U = self._eig_k
        return {"values": phi, "vectors": U.T}

    def _get_eigen_R_(self, X=None):
        """Eigendecomposition of the projected S(K+I)S spectrum for design
        X (reference: _get_eigen_R_), in float64 on the instance's device.
        Returns {'values': xi, 'vectors': V^T} as tensors there (no host
        copy, as for _get_eigen_L_)."""
        from mixmogam_tpu_torch.ops.eigen import projected_spectrum

        if self.K is None:
            raise ValueError("call add_random_effect(K) first")
        X = self.X if X is None else np.asarray(X, dtype=np.float64)
        xi, V = projected_spectrum(self.K, X, device=self.device)
        return {"values": xi, "vectors": V.T}

    # ---- variance components ----
    def _fit(self, ngrids: int, llim: float, ulim: float, esp: float,
             ml: bool):
        import torch

        from mixmogam_tpu_torch.ops.reml import (esp_to_refine_iters,
                                                 fit_null_model)

        self._get_eigen_L_()
        return fit_null_model(
            self.Y, self.X, K=self.K, eig_k=self._eig_k, ngrids=ngrids,
            llim=llim, ulim=ulim,
            refine_iters=esp_to_refine_iters(esp, ngrids, llim, ulim),
            ml=ml, device=self.device, dtype=torch.float64)

    @staticmethod
    def _remle_dict(null) -> Dict[str, float]:
        d = {
            "max_ll": float(null.ll),
            "delta": float(null.delta),
            "log_delta": float(null.log_delta),
            "pseudo_heritability": float(null.pseudo_heritability),
            "vg": float(null.sigma_g2),
            "ve": float(null.sigma_e2),
        }
        # the JAX package's spellings as aliases
        d["sigma_g2"] = d["vg"]
        d["sigma_e2"] = d["ve"]
        return d

    def get_expedited_REMLE(self, ngrids: int = 100, llim: float = -10.0,
                            ulim: float = 10.0, esp: float = 1e-6,
                            **_ignored) -> Dict[str, float]:
        """REML variance components via grid + refinement on log(delta)
        (reference: get_expedited_REMLE, same defaults)."""
        null = self._fit(ngrids, llim, ulim, esp, ml=False)
        self._reml = null
        return self._remle_dict(null)

    def get_REML(self, ngrids: int = 100, llim: float = -10.0,
                 ulim: float = 10.0, esp: float = 1e-6) -> Dict[str, float]:
        return self.get_expedited_REMLE(ngrids, llim, ulim, esp)

    def get_ML(self, ngrids: int = 100, llim: float = -10.0,
               ulim: float = 10.0, esp: float = 1e-6) -> Dict[str, float]:
        """ML (all-eigenvalue likelihood; used by the stepwise BIC
        criteria — reference: get_ML)."""
        return self._remle_dict(self._fit(ngrids, llim, ulim, esp, ml=True))

    def get_estimates(self, ngrids: int = 100, llim: float = -10.0,
                      ulim: float = 10.0, esp: float = 1e-6
                      ) -> Dict[str, np.ndarray]:
        """GLS estimates of the fixed effects at the REML delta
        (reference: get_estimates): betas, their standard errors, rss,
        plus the variance components. The rotation U'X and the GLS run in
        float64 on the instance's device, the least squares by QR (CUDA's
        lstsq has only the full-rank gels), the rank from R's diagonal
        with lstsq's cut, and the standard errors by pinv, as in the JAX
        package."""
        import torch

        if self._reml is None:
            self.get_expedited_REMLE(ngrids, llim, ulim, esp)
        null = self._reml
        dev = null.U.device
        sd = 1.0 / torch.sqrt(null.phi + null.delta)
        Xs = (null.U.T @ torch.as_tensor(self.X, device=dev)) * sd[:, None]
        ys = (null.U.T @ torch.as_tensor(self.Y, device=dev)) * sd
        Q, R = torch.linalg.qr(Xs)
        diag = torch.diagonal(R).abs()
        cut = diag.max() * np.finfo(np.float64).eps * max(Xs.shape)
        rank = int((diag > cut).sum())
        if rank == Xs.shape[1]:
            beta = torch.linalg.solve_triangular(
                R, (Q.T @ ys)[:, None], upper=True)[:, 0]
        else:                       # lstsq's minimum-norm solution
            beta = torch.linalg.pinv(Xs) @ ys
        resid = ys - Xs @ beta
        rss = float(resid @ resid)
        dof = max(self.n - rank, 1)
        sigma2 = rss / dof
        XtX_inv = torch.linalg.pinv(Xs.T @ Xs)
        se = torch.sqrt(torch.clamp(torch.diagonal(XtX_inv) * sigma2,
                                    min=0.0))
        out = self._remle_dict(null)
        out.update({"betas": beta.cpu().numpy(),
                    "beta_ses": se.cpu().numpy(), "rss": rss, "dof": dof})
        return out

    # ---- scans (all delegate to the port's models) ----
    def _model_kwargs(self) -> Dict:
        self._get_eigen_L_()
        return {"eig_k": self._eig_k, "X0": self.X, "device": self.device}

    def emmax_f_test(self, snps, with_betas: bool = True,
                     ngrids: int = 100, llim: float = -10.0,
                     ulim: float = 10.0, esp: float = 1e-6, **kw) -> Dict:
        """The EMMAX scan against the current design + cofactors
        (reference: emmax_f_test; models/emmax.py::emmax)."""
        from mixmogam_tpu_torch.models.emmax import emmax

        return emmax(snps, self.Y, with_betas=with_betas, ngrids=ngrids,
                     llim=llim, ulim=ulim, esp=esp,
                     **self._model_kwargs(), **kw)

    def emmax_anova_f_test(self, snps, **kw) -> Dict:
        """Categorical genotype-class EMMAX test (reference:
        emmax_anova)."""
        from mixmogam_tpu_torch.models.emmax import emmax_anova

        return emmax_anova(snps, self.Y, **self._model_kwargs(), **kw)

    # reference method name (linear_models.LinearMixedModel.emmax_anova)
    emmax_anova = emmax_anova_f_test

    def emmax_two_snps(self, snps,
                       focal_idx: Optional[Sequence[int]] = None,
                       **kw) -> Dict:
        """Pairwise conditional + interaction scan (reference:
        emmax_two_snps)."""
        from mixmogam_tpu_torch.models.twosnp import emmax_two_snps

        return emmax_two_snps(snps, self.Y, focal_idx=focal_idx,
                              **self._model_kwargs(), **kw)

    def emmax_perm_test(self, snps, num_perm: int = 100, seed: int = 0,
                        **kw) -> Dict:
        """Permutation max-F null distribution (reference:
        emmax_perm_test)."""
        from mixmogam_tpu_torch.models.permutation import emmax_perm_test

        return emmax_perm_test(snps, self.Y, num_perm=num_perm, seed=seed,
                               **self._model_kwargs(), **kw)


def lm_step_wise(G, y, max_steps: int = 10, X0=None, device=None,
                 **kw) -> Dict:
    """Stepwise model selection with fixed effects only (reference:
    linear_models.lm_step_wise): the MLMM loop's identity-eigenbasis path
    (emmax_step_wise with K=None), where every per-step F-test equals its
    OLS F-test and the ML log-likelihood does not depend on delta. device:
    the card by default (raising without one), 'cpu' on request. Each
    step's pseudo_heritability is reported as 0, as in the JAX package."""
    from mixmogam_tpu_torch.models.stepwise import emmax_step_wise

    y = np.asarray(y, dtype=np.float64).ravel()
    out = emmax_step_wise(G, y, K=None, max_steps=max_steps, X0=X0,
                          device=device, **kw)
    for s in out["steps"]:  # h2 is meaningless for K=I; report 0
        s["pseudo_heritability"] = 0.0
    return out


# the reference's genome container class, re-exported under its name
# (snpsdata.SNPsDataSet — data/genotype.py holds the alias)
from mixmogam_tpu_torch.data.genotype import SNPsDataSet  # noqa: E402

__all__ = ["LinearModel", "LinearMixedModel", "lm_step_wise",
           "SNPsDataSet"]
