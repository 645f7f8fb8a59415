"""Null-model REML (counterpart of mixmogam_tpu/ops/reml.py).

Only the X-explicit float64 host optimizer ('explicit' = 'auto') is
ported: it needs eigh(K) alone and every evaluation is O(n q^2) numpy.
esp_to_refine_iters, _explicit_reml_host and _explicit_ll_host are
numpy-only copies of the JAX package's functions (the originals live in a
module that imports jax); tests/test_torch_ops.py pins each copy to its
original. The device 'spectrum' optimizer waits for ROADMAP Queue 1 item 3.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from mixmogam_tpu_torch.ops import resolve_device
from mixmogam_tpu_torch.ops.eigen import eigen_k_on


def esp_to_refine_iters(esp: float, ngrids: int = 100, llim: float = -10.0,
                        ulim: float = 10.0) -> int:
    """Bisection iterations needed to shrink one grid bracket below the
    reference's esp tolerance on log(delta) (clamped to [16, 64])."""
    width = (ulim - llim) / max(ngrids, 1)
    need = math.log2(max(width / max(esp, 1e-30), 2.0))
    return max(16, min(64, int(math.ceil(need))))


def _explicit_reml_host(phi, y_rot, X_rot, ngrids: int = 100,
                        llim: float = -10.0, ulim: float = 10.0,
                        refine_iters: int = 32, ml: bool = False) -> dict:
    """X-explicit (RE)ML in float64 on the host: dLL/dlogd on the grid,
    bisection in every +->- bracket, argmax of LL over the refined roots
    and both endpoints."""
    ll_at, dll_at, moments, scale = _explicit_ll_host(phi, y_rot, X_rot,
                                                      ml=ml)
    grid = np.linspace(llim, ulim, ngrids + 1)
    dll = np.array([dll_at(g) for g in grid])
    cands = [float(llim), float(ulim)]
    for i in np.flatnonzero((dll[:-1] > 0) & (dll[1:] < 0)):
        lo, hi = float(grid[i]), float(grid[i + 1])
        for _ in range(refine_iters):
            mid = 0.5 * (lo + hi)
            if dll_at(mid) > 0:
                lo = mid
            else:
                hi = mid
        cands.append(0.5 * (lo + hi))
    lls = np.array([ll_at(c) for c in cands])
    j = int(np.argmax(lls))
    log_delta = cands[j]
    delta = float(np.exp(log_delta))
    ypy = moments(delta)[4]
    sg2 = ypy / scale
    return {"log_delta": log_delta, "delta": delta, "ll": float(lls[j]),
            "sigma_g2": sg2, "sigma_e2": delta * sg2,
            "pseudo_heritability": 1.0 / (1.0 + delta)}


def _explicit_ll_host(phi, y_rot, X_rot, ml: bool = False):
    """(ll_at, dll_at, moments, scale) closures over log-delta for the
    X-explicit host likelihood (see _explicit_reml_host)."""
    phi = np.asarray(phi, np.float64)
    y = np.asarray(y_rot, np.float64).ravel()
    X = np.asarray(X_rot, np.float64)
    if X.ndim == 1:
        X = X[:, None]
    n, q = X.shape
    scale = float(n if ml else n - q)
    logdet_XtX = np.linalg.slogdet(X.T @ X)[1]
    tiny = np.finfo(np.float64).tiny

    def moments(d):
        w = 1.0 / (phi + d)
        Xw = X * w[:, None]
        A = X.T @ Xw
        b = Xw.T @ y
        beta = np.linalg.solve(A, b)
        ypy = max(float(w @ (y * y) - b @ beta), tiny)
        return w, Xw, A, beta, ypy

    def ll_at(logd):
        d = float(np.exp(logd))
        _, _, A, _, ypy = moments(d)
        logdet = float(np.sum(np.log(phi + d)))
        if not ml:
            logdet += np.linalg.slogdet(A)[1] - logdet_XtX
        return 0.5 * (scale * (np.log(scale / (2.0 * np.pi)) - 1.0
                               - np.log(ypy)) - logdet)

    def dll_at(logd):
        d = float(np.exp(logd))
        w, Xw, A, beta, ypy = moments(d)
        Py = w * (y - X @ beta)                      # P y (H diagonal here)
        tr = float(np.sum(w))
        if not ml:
            tr -= float(np.trace(np.linalg.solve(A, Xw.T @ Xw)))
        return 0.5 * d * (scale * float(Py @ Py) / ypy - tr)

    return ll_at, dll_at, moments, scale


def _tensor(a) -> torch.Tensor:
    """A tensor as it is; an array-like as a tensor on the CPU (copied, so
    a read-only array such as a jax array's view stays untouched)."""
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.array(a))


@dataclasses.dataclass
class NullModel:
    """Fitted null model: everything the scan phase needs. Tensors live
    on the scan's device in its compute dtype."""

    phi: torch.Tensor           # (n,) eigenvalues of K, descending
    U: torch.Tensor             # (n, n) eigenvectors of K
    delta: torch.Tensor         # scalar REML variance ratio
    log_delta: torch.Tensor
    ll: torch.Tensor
    sigma_g2: torch.Tensor
    sigma_e2: torch.Tensor
    pseudo_heritability: torch.Tensor
    y: torch.Tensor             # (n,) phenotype
    X0: torch.Tensor            # (n, q) null fixed effects


def fit_null_model(y, X0, K=None, eig_k: Optional[Tuple] = None,
                   ngrids: int = 100, llim: float = -10.0,
                   ulim: float = 10.0, refine_iters: int = 32,
                   host_eigh: Optional[bool] = None,
                   ml: bool = False,
                   method: str = "auto", eigh_dtype=None, device=None,
                   dtype=None) -> NullModel:
    """Null-model REML from eigh(K) alone, optimized in float64 on the
    host. y/X0/K/eig_k may be numpy arrays or tensors; the model's
    tensors land on `device` (default: a tensor y's own device; for
    array input the card, or 'cpu' on request) in `dtype` (default: y's
    dtype, else float64). host_eigh: None factors K in float64 where the
    model lives (cuSOLVER on the card, host LAPACK on the CPU); True asks
    for host LAPACK."""
    if method == "spectrum":
        raise NotImplementedError(
            "method='spectrum' (the device grid optimizer) is not ported "
            "yet: ROADMAP Queue 1 item 3")
    if method not in ("auto", "explicit"):
        raise ValueError(f"unknown method {method!r} "
                         "(expected 'auto', 'explicit' or 'spectrum')")
    device = y.device if device is None and isinstance(
        y, torch.Tensor) else resolve_device(device)
    if dtype is None:
        dtype = (y.dtype if isinstance(y, torch.Tensor)
                 and y.is_floating_point() else torch.float64)
    y_t = torch.as_tensor(y, device=device).to(dtype).reshape(-1)
    X0_t = torch.as_tensor(X0, device=device).to(dtype)
    if X0_t.ndim == 1:
        X0_t = X0_t[None, :]        # np.atleast_2d semantics
    if eig_k is None:
        if K is None:
            raise ValueError("need K or eig_k")
        phi, U = eigen_k_on(K, device, host_eigh, eigh_dtype)
    else:
        phi, U = eig_k
    phi, U = _tensor(phi), _tensor(U)
    # y and X0 enter the eigenbasis in float64 on U's own device; only
    # the (n,) and (n, q) results go to the host REML, never U itself
    U64 = U.detach().to(torch.float64)

    def rotate(v):
        return (U64.T @ v.to(U.device, torch.float64)).cpu().numpy()

    r = _explicit_reml_host(
        phi.detach().cpu().double().numpy(), rotate(y_t), rotate(X0_t),
        ngrids=ngrids, llim=llim, ulim=ulim, refine_iters=refine_iters,
        ml=ml)
    scal = {k: torch.tensor(v, dtype=dtype, device=device)
            for k, v in r.items()}
    return NullModel(phi=phi.to(device=device, dtype=dtype),
                     U=U.to(device=device, dtype=dtype), y=y_t, X0=X0_t,
                     **scal)

