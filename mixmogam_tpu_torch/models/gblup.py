"""gBLUP genomic prediction (counterpart of mixmogam_tpu/models/gblup.py:
GblupModel, gblup, gblup_predict, gblup_cv, _joint_kinship).

The null mixed model y = X0 beta + u + e, u ~ N(0, sg2 K), fitted by REML
for the scans, is also the gBLUP predictor of breeding values (VanRaden
2008; Henderson's mixed-model equations). With eigh(K) = (phi, U) and
H = K + delta I (up to sg2):

  H^-1     = U diag(1/(phi + delta)) U'
  beta_hat = (X0' H^-1 X0)^-1 X0' H^-1 y       (GLS, whitened least squares)
  u_hat    = K H^-1 (y - X0 beta_hat)          (BLUP of the train samples)
  u_new    = K_cross H^-1 (y - X0 beta_hat)    (any samples covered by K)

Everything runs in float64 torch on the model's device: the card by
default (eigh(K) by cuSOLVER, ops/eigen.py::eigen_k_on), the CPU on
request. The whitened GLS is solved by a QR of the (n, q) design: the
JAX package's np.linalg.lstsq is SVD-based, and on CUDA torch's lstsq has
only the 'gels' driver; both agree with the QR solve on the full-rank
designs REML accepts. The kinship feeding gblup_predict / gblup_cv comes
from ops/kinship.py (kernel K1 on a fully observed int8 source).

reliability() is the PEV diagonal of the mixed-model equations,
r2_i = 1 - PEV_i / (sg2 K_ii) with
PEV_i / sg2 = (K - K H^-1 K + K H^-1 X0 (X0' H^-1 X0)^-1 X0' H^-1 K)_ii.
In the eigenbasis every term is a weighted row sum of U squared,
(K - K H^-1 K)_ii = sum_k U_ik^2 phi_k delta / (phi_k + delta), so it takes
O(n^2 q) and no (n, n) product.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["GblupModel", "gblup", "gblup_predict", "gblup_cv"]


@dataclasses.dataclass
class GblupModel:
    """Fitted gBLUP model. beta, u_hat and fitted are float64 host arrays,
    as in the JAX package; the internals that predict() and reliability()
    read are float64 tensors on the model's device."""

    beta: np.ndarray              # (q,) GLS fixed-effect estimates
    u_hat: np.ndarray             # (n,) BLUP breeding values, train order
    delta: float                  # REML variance ratio sigma_e2/sigma_g2
    sigma_g2: float
    sigma_e2: float
    pseudo_heritability: float
    fitted: np.ndarray            # (n,) X0 @ beta + u_hat
    # internals for out-of-sample prediction and the reliabilities
    _hinv_r: torch.Tensor         # (n,) H^-1 (y - X0 beta_hat)
    _X0: torch.Tensor             # (n, q)
    _phi: torch.Tensor            # (n,) eigenvalues of K_train
    _U: torch.Tensor              # (n, n) eigenvectors of K_train

    def _f64(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(device=self._U.device,
                                     dtype=torch.float64)

    def predict(self, K_cross, X_new=None) -> np.ndarray:
        """Predicted genetic (or phenotypic) values for new samples, as a
        float64 host array.

        K_cross: (n_new, n_train) kinship rows of the new samples against
        the TRAIN samples (array or tensor), from the same kinship
        construction as the training K. X_new: optional (n_new, q) fixed
        effects; when given, returns X_new @ beta + u_new (phenotype
        scale), otherwise u_new alone."""
        u_new = self._f64(K_cross) @ self._hinv_r
        if X_new is not None:
            u_new = self._f64(X_new) @ self._f64(self.beta) + u_new
        return u_new.cpu().numpy()

    def reliability(self) -> np.ndarray:
        """Per-train-sample reliability r2_i = 1 - PEV_i / (sg2 K_ii),
        clipped to [0, 1], computed on the model's device."""
        phi, U, d = self._phi, self._U, self.delta
        U2 = U * U
        k_diag = U2 @ phi
        # K - K H^-1 K on the diagonal, without the cancellation
        pev = U2 @ (phi * d / (phi + d))
        XU = U.T @ self._X0                          # (n, q) rotated design
        KHiX = U @ (XU * (phi / (phi + d))[:, None])
        XtHiX = XU.T @ (XU / (phi + d)[:, None])
        pev = pev + (KHiX * torch.linalg.solve(XtHiX, KHiX.T).T).sum(dim=1)
        rel = 1.0 - pev / k_diag                     # sg2 cancels
        return torch.clamp(rel, 0.0, 1.0).cpu().numpy()


def gblup(y, K=None, X0=None, eig_k: Optional[Tuple] = None,
          ngrids: int = 100, llim: float = -10.0, ulim: float = 10.0,
          device=None) -> GblupModel:
    """Fit gBLUP on phenotyped samples.

    y: (n,) phenotype; K: (n, n) kinship (scale_k'd; array or tensor), or
    eig_k = (phi, U). X0: (n, q) fixed effects (default: an intercept).
    The REML for delta is ops/reml.py::fit_null_model in float64. device:
    the card by default (without one the call raises), 'cpu' on request.

    No mesh=, as in the JAX package: gBLUP has no SNP scan to shard."""
    from mixmogam_tpu_torch.ops import resolve_device
    from mixmogam_tpu_torch.ops.reml import fit_null_model

    device = resolve_device(device)
    y = np.asarray(y, dtype=np.float64)
    if not np.isfinite(y).all():
        raise ValueError(
            "gblup needs fully-observed phenotypes (got non-finite "
            "values); drop unphenotyped samples from the TRAIN set and "
            "predict them through predict()/gblup_predict instead")
    n = y.shape[0]
    X0 = np.ones((n, 1)) if X0 is None else X0
    X0 = torch.as_tensor(np.asarray(X0, dtype=np.float64), device=device)
    if X0.ndim == 1:
        X0 = X0[:, None]
    null = fit_null_model(y, X0, K=K, eig_k=eig_k, ngrids=ngrids, llim=llim,
                          ulim=ulim, device=device, dtype=torch.float64)
    phi, U, delta = null.phi, null.U, float(null.delta)
    y_t = null.y
    # GLS in the eigenbasis: rotate, whiten by 1/sqrt(phi + delta), and
    # solve the least squares by QR
    w = 1.0 / torch.sqrt(phi + delta)
    Q, R = torch.linalg.qr((U.T @ X0) * w[:, None])
    beta = torch.linalg.solve_triangular(
        R, (Q.T @ ((U.T @ y_t) * w))[:, None], upper=True)[:, 0]
    r = y_t - X0 @ beta
    hinv_r = U @ ((U.T @ r) / (phi + delta))
    u_hat = U @ (phi * (U.T @ hinv_r))     # K H^-1 r without forming K
    return GblupModel(
        beta=beta.cpu().numpy(), u_hat=u_hat.cpu().numpy(), delta=delta,
        sigma_g2=float(null.sigma_g2), sigma_e2=float(null.sigma_e2),
        pseudo_heritability=float(null.pseudo_heritability),
        fitted=(X0 @ beta + u_hat).cpu().numpy(), _hinv_r=hinv_r, _X0=X0,
        _phi=phi, _U=U)


def gblup_predict(gd_or_G, y, train_idx: Sequence[int],
                  test_idx: Sequence[int], X: Optional[np.ndarray] = None,
                  kinship_method: str = "ibs", K_all=None, device=None
                  ) -> Tuple[np.ndarray, GblupModel]:
    """Split-fit-predict over one genotype source: the joint kinship over
    ALL samples (_joint_kinship, or K_all given as an array or tensor) goes
    to the device once; the model is fitted on K[train, train] with
    y[train_idx] and predicts the test samples through K[test, train].
    Returns (y_hat_test, model): y_hat on the phenotype scale when X is
    given (sliced per split), genetic values plus the intercept otherwise."""
    from mixmogam_tpu_torch.ops import resolve_device

    device = resolve_device(device)
    train_idx = np.asarray(train_idx, dtype=np.int64)
    test_idx = np.asarray(test_idx, dtype=np.int64)
    if K_all is None:
        K_all = _joint_kinship(gd_or_G, kinship_method, device=device)
    K_all = torch.as_tensor(K_all).to(device=device, dtype=torch.float64)
    y = np.asarray(y, dtype=np.float64)
    if X is not None:
        X = np.asarray(X, dtype=np.float64)
        X0_train, X_test = X[train_idx], X[test_idx]
    else:
        X0_train = None
        X_test = np.ones((len(test_idx), 1), dtype=np.float64)
    tr = torch.as_tensor(train_idx, device=device)
    te = torch.as_tensor(test_idx, device=device)
    K_tr = K_all.index_select(0, tr)
    model = gblup(y[train_idx], K=K_tr.index_select(1, tr), X0=X0_train,
                  device=device)
    y_hat = model.predict(K_all.index_select(0, te).index_select(1, tr),
                          X_new=X_test)
    return y_hat, model


def gblup_cv(gd_or_G, y, n_folds: int = 5, seed: int = 0,
             X: Optional[np.ndarray] = None, kinship_method: str = "ibs",
             K_all=None, device=None) -> dict:
    """K-fold cross-validated predictive accuracy of gBLUP, with the JAX
    package's folds (np.random.default_rng(seed).permutation, then
    np.array_split). Returns {'r': mean Pearson correlation of (y_hat, y)
    over folds, 'r_folds': per fold, 'mse': mean squared error, 'y_hat':
    (n,) out-of-fold predictions in sample order}."""
    from mixmogam_tpu_torch.ops import resolve_device

    device = resolve_device(device)
    y = np.asarray(y, dtype=np.float64)
    n = y.shape[0]
    if n_folds < 2:
        raise ValueError(
            f"gblup_cv needs n_folds >= 2 (got {n_folds}); a 1-fold "
            "split leaves an empty training set — use gblup() for a "
            "no-CV fit (CLI: --folds 0)")
    if n_folds > n:
        raise ValueError(f"n_folds={n_folds} exceeds the {n} phenotyped "
                         "samples (some folds would be empty)")
    if K_all is None:
        K_all = _joint_kinship(gd_or_G, kinship_method, device=device)
    K_all = torch.as_tensor(K_all).to(device=device, dtype=torch.float64)
    perm = np.random.default_rng(seed).permutation(n)
    y_hat = np.full(n, np.nan)
    rs = []
    for fold in np.array_split(perm, n_folds):
        train = np.setdiff1d(perm, fold)
        pred, _ = gblup_predict(None, y, train, fold, X=X, K_all=K_all,
                                device=device)
        y_hat[fold] = pred
        if len(fold) > 1 and np.std(y[fold]) > 0 and np.std(pred) > 0:
            rs.append(float(np.corrcoef(pred, y[fold])[0, 1]))
    return {"r": float(np.mean(rs)) if rs else float("nan"),
            "r_folds": rs,
            "mse": float(np.mean((y_hat - y) ** 2)),
            "y_hat": y_hat}


def _joint_kinship(gd_or_G, kinship_method: str, device=None) -> np.ndarray:
    """scale_k'd kinship (float64 host (n, n)) over ALL samples of a
    GenotypeData, dosage matrix or ResidentGenome, by ops/kinship.py on
    `device` (the card by default; kernel K1 for fully observed int8)."""
    from mixmogam_tpu_torch.ops.kinship import kinship
    from mixmogam_tpu_torch.oracle.kinship import scale_k

    if kinship_method not in ("ibs", "ibd", "vanraden"):
        # a typo ('vanRaden', 'grm') coerced to IBS would run the wrong
        # kinship and return plausible-but-wrong predictions
        raise ValueError(f"unknown kinship method {kinship_method!r}; "
                         "expected 'ibs', 'ibd' or 'vanraden'")
    method = "vanraden" if kinship_method in ("ibd", "vanraden") else "ibs"
    return scale_k(kinship(gd_or_G, method=method, device=device))
