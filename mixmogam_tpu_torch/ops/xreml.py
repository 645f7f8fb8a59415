"""X-explicit REML in the kinship eigenbasis (counterpart of
mixmogam_tpu/ops/xreml.py: chol_small, chol_solve_small, inv_small,
chol_logdet_small, _ll_from_moments, ll_explicit, explicit_reml).

In eigh(K)'s basis H = K + delta I is diagonal, so the (RE)ML likelihood
of one design X reduces to weighted moments of the rotated data, with
w = 1/(phi + delta): A = X'WX, b = X'Wy, c = y'Wy, and O(p^2) algebra:

  LL_R(d) = 1/2 [ (n-p)(ln((n-p)/2pi) - 1 - ln yPy)
                  - ( ln|H| + ln|X'H^-1 X| - ln|X'X| ) ],  yPy = c - b'A^-1 b.

explicit_reml maximizes it over log delta: dLL/dlog delta on a grid,
bisection in every +/- bracket, the argmax of LL over the refined roots and
both ends of the grid. It is the null fit of every entry point
(ops/reml.py::fit_null_model) and stepwise's per-step re-fit (REML and
ML). Everything runs in float64 on the data's device; the grid, and the
bisection of all brackets, each evaluate their points as one batch.

dLL/dlog delta is the analytic derivative (JAX takes it by autodiff):
0.5 d (scale |Py|^2 / yPy - tr P) with Py = W (y - X beta) and tr P =
sum w - tr(A^-1 X'W^2 X) (REML) or sum w (ML);
tests/test_torch_xreml.py holds its signs on the grid to JAX's.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

# ---------------------------------------------------------------------------
# small-matrix linear algebra, batched over leading dimensions
# ---------------------------------------------------------------------------


def chol_small(A: torch.Tensor) -> torch.Tensor:
    """Cholesky factor of (..., p, p) symmetric matrices, column by column
    with each pivot clamped at the dtype's tiny, so a semi-definite A gives
    finite factors (the JAX package's rule; torch.linalg.cholesky raises)."""
    p = A.shape[-1]
    tiny = torch.finfo(A.dtype).tiny
    L = torch.zeros_like(A)
    for j in range(p):
        s = A[..., j, j] - (L[..., j, :j] * L[..., j, :j]).sum(dim=-1)
        L[..., j, j] = torch.sqrt(torch.clamp(s, min=tiny))
        if j + 1 < p:
            col = A[..., j + 1:, j] - (L[..., j + 1:, :j]
                                       @ L[..., j, :j, None])[..., 0]
            L[..., j + 1:, j] = col / L[..., j, j, None]
    return L


def chol_solve_small(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x with A x = b, given L = chol_small(A); b is (..., p)."""
    p = L.shape[-1]
    # numpy's broadcast_shapes: torch's imports sympy at its first call
    # (seconds, once per process)
    y = torch.zeros(np.broadcast_shapes(tuple(L.shape[:-1]), tuple(b.shape)),
                    dtype=L.dtype, device=L.device)
    for i in range(p):
        y[..., i] = (b[..., i] - (L[..., i, :i] * y[..., :i]).sum(dim=-1)
                     ) / L[..., i, i]
    x = torch.zeros_like(y)
    for i in reversed(range(p)):
        x[..., i] = (y[..., i] - (L[..., i + 1:, i] * x[..., i + 1:]
                                  ).sum(dim=-1)) / L[..., i, i]
    return x


def inv_small(A: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., p, p) symmetric positive definite matrices through
    chol_small (every unit vector solved as one batch)."""
    p = A.shape[-1]
    L = chol_small(A)
    eye = torch.eye(p, dtype=A.dtype, device=A.device)
    # row i of the result solves A x = e_i: A^-1 is symmetric
    return chol_solve_small(L[..., None, :, :], eye)


def chol_logdet_small(L: torch.Tensor) -> torch.Tensor:
    """log|A| from L = chol_small(A)."""
    return 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(dim=-1)


# ---------------------------------------------------------------------------
# the likelihood of one design from weighted moments
# ---------------------------------------------------------------------------

def _ll_from_moments(A, b, c, logdet_H, logdet_XtX, n: int, p: int,
                     reml: bool):
    """(RE)ML log-likelihood, yPy and beta from A = X'H^-1X (..., p, p),
    b = X'H^-1y (..., p), c = y'H^-1y (...) and the log-determinants."""
    L = chol_small(A)
    beta = chol_solve_small(L, b)
    ypy = torch.clamp(c - (b * beta).sum(dim=-1),
                      min=torch.finfo(c.dtype).tiny)
    if reml:
        scale = n - p
        logdet = logdet_H + chol_logdet_small(L) - logdet_XtX
    else:
        scale = n
        logdet = logdet_H
    ll = 0.5 * (scale * (math.log(scale / (2.0 * math.pi)) - 1.0
                         - torch.log(ypy)) - logdet)
    return ll, ypy, beta


def _moments(d: torch.Tensor, phi, y_rot, X_rot):
    """w (..., n), A (..., p, p), b (..., p), c (...) at delta d (...)."""
    w = 1.0 / (phi + d[..., None])
    Xw = X_rot * w[..., :, None]
    A = X_rot.T @ Xw
    b = (Xw * y_rot[:, None]).sum(dim=-2)
    c = (w * y_rot * y_rot).sum(dim=-1)
    return w, Xw, A, b, c


def ll_explicit(logdelta, phi, y_rot, X_rot, reml: bool = True
                ) -> torch.Tensor:
    """LL of ONE design X_rot (n, p) at log delta (scalar or batched);
    y_rot = U'y and X_rot = U'X in the kinship's eigenbasis."""
    logdelta = torch.as_tensor(logdelta, dtype=phi.dtype, device=phi.device)
    d = torch.exp(logdelta)
    n, p = X_rot.shape
    _, _, A, b, c = _moments(d, phi, y_rot, X_rot)
    logdet_H = torch.log(phi + d[..., None]).sum(dim=-1)
    logdet_XtX = chol_logdet_small(chol_small(X_rot.T @ X_rot))
    ll, _, _ = _ll_from_moments(A, b, c, logdet_H, logdet_XtX, n, p, reml)
    return ll


def dll_explicit(logdelta, phi, y_rot, X_rot, reml: bool = True
                 ) -> torch.Tensor:
    """dLL/dlog delta of one design at log delta (scalar or batched)."""
    logdelta = torch.as_tensor(logdelta, dtype=phi.dtype, device=phi.device)
    d = torch.exp(logdelta)
    n, p = X_rot.shape
    w, Xw, A, b, c = _moments(d, phi, y_rot, X_rot)
    L = chol_small(A)
    beta = chol_solve_small(L, b)
    ypy = torch.clamp(c - (b * beta).sum(dim=-1),
                      min=torch.finfo(c.dtype).tiny)
    Py = w * (y_rot - beta @ X_rot.T)
    tr = w.sum(dim=-1)
    if reml:
        # tr(A^-1 X'W^2X), both symmetric
        tr = tr - (inv_small(A) * (Xw.transpose(-1, -2) @ Xw)).sum(
            dim=(-1, -2))
    scale = (n - p) if reml else n
    return 0.5 * d * (scale * (Py * Py).sum(dim=-1) / ypy - tr)


def explicit_reml(phi, y_rot, X_rot, ngrids: int = 100, llim: float = -10.0,
                  ulim: float = 10.0, refine_iters: int = 32,
                  reml: bool = True) -> Dict[str, torch.Tensor]:
    """Single-design REML (reml=True) or ML: grid of ngrids + 1 points in
    log delta, refine_iters bisections of every bracket where dLL changes
    from + to -, argmax of LL over the roots and both ends. phi (n,),
    y_rot (n,) and X_rot (n, p) are float64 tensors on one device; the
    result's values are 0-d tensors there (beta (p,))."""
    dt, dev = phi.dtype, phi.device
    if X_rot.ndim == 1:
        X_rot = X_rot[:, None]
    grid = torch.linspace(llim, ulim, ngrids + 1, dtype=dt, device=dev)
    dll = dll_explicit(grid, phi, y_rot, X_rot, reml)
    idx = torch.nonzero((dll[:-1] > 0) & (dll[1:] < 0))[:, 0]
    lo, hi = grid[idx], grid[idx + 1]
    if idx.numel():
        for _ in range(refine_iters):
            mid = (lo + hi) / 2.0
            up = dll_explicit(mid, phi, y_rot, X_rot, reml) > 0
            lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    ends = torch.tensor([llim, ulim], dtype=dt, device=dev)
    cands = torch.cat([(lo + hi) / 2.0, ends])
    lls = ll_explicit(cands, phi, y_rot, X_rot, reml)
    j = torch.argmax(lls)
    log_delta = cands[j]
    delta = torch.exp(log_delta)
    n, p = X_rot.shape
    _, _, A, b, c = _moments(delta, phi, y_rot, X_rot)
    beta = chol_solve_small(chol_small(A), b)
    ypy = c - (b * beta).sum()
    sg2 = ypy / ((n - p) if reml else n)
    return {"log_delta": log_delta, "delta": delta, "ll": lls[j],
            "sigma_g2": sg2, "sigma_e2": delta * sg2,
            "pseudo_heritability": 1.0 / (1.0 + delta), "beta": beta}
