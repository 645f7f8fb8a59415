"""Null-model REML (counterpart of mixmogam_tpu/ops/reml.py).

Two optimizers, both in float64 where the model lives:
- 'explicit' (= 'auto', the default): ops/xreml.py::explicit_reml on
  eigh(K) alone, the X-explicit likelihood;
- 'spectrum': the reference-shaped path, the eigh of S(K+I)S
  (ops/eigen.py::projected_spectrum) and reml_from_spectrum's grid and
  bisection over its spectrum.

reml_from_spectrum is one broadcast over the (ngrids + 1)-point grid in
log delta and a fixed-iteration bisection of every + -> - bracket of dLL
at once (masked lanes idle), then the argmax of LL over the refined roots
and both ends: the JAX package's jitted function, in plain float64 torch.
Leading batch dimensions of eta2 take the place of jax.vmap over traits.
h2_profile_ci inverts the likelihood-ratio test on delta with the
X-explicit likelihood (ops/xreml.py::ll_explicit) of the same objective
the null was fitted with (NullModel.ml). esp_to_refine_iters is a copy of
the JAX package's function (the original lives in a module that imports
jax); tests/test_torch_ops.py pins it to the original.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mixmogam_tpu_torch.ops import resolve_device
from mixmogam_tpu_torch.ops.eigen import eigen_k_on, projected_spectrum
from mixmogam_tpu_torch.ops.xreml import explicit_reml, ll_explicit


def esp_to_refine_iters(esp: float, ngrids: int = 100, llim: float = -10.0,
                        ulim: float = 10.0) -> int:
    """Bisection iterations needed to shrink one grid bracket below the
    reference's esp tolerance on log(delta) (clamped to [16, 64])."""
    width = (ulim - llim) / max(ngrids, 1)
    need = math.log2(max(width / max(esp, 1e-30), 2.0))
    return max(16, min(64, int(math.ceil(need))))


def _ll_terms(logdelta, eta2, xi, det_eigs, scale: int):
    """LL at log delta (..., G) for the unified REML/ML likelihood of a
    spectrum: REML det_eigs = xi (n - q values), scale = n - q; ML
    det_eigs = phi (n values), scale = n. eta2 (..., n - q) and xi /
    det_eigs (n - q,) / (n,) or with eta2's batch dimensions."""
    d = torch.exp(logdelta)[..., None]
    s1 = (eta2[..., None, :] / (xi[..., None, :] + d)).sum(dim=-1)
    s2 = torch.log(det_eigs[..., None, :] + d).sum(dim=-1)
    return 0.5 * (scale * (math.log(scale / (2.0 * math.pi)) - 1.0
                           - torch.log(s1)) - s2)


def _dll_terms(logdelta, eta2, xi, det_eigs, scale: int):
    """dLL at log delta (..., G), up to a positive factor (its sign is
    what the bisection reads): the JAX package's _dll_terms."""
    d = torch.exp(logdelta)[..., None]
    denom = xi[..., None, :] + d
    s1 = (eta2[..., None, :] / denom).sum(dim=-1)
    s2 = (eta2[..., None, :] / denom ** 2).sum(dim=-1)
    s3 = (1.0 / (det_eigs[..., None, :] + d)).sum(dim=-1)
    return 0.5 * (scale * s2 / s1 - s3)


def reml_from_spectrum(eta2, xi, phi=None, ngrids: int = 100,
                       llim: float = -10.0, ulim: float = 10.0,
                       refine_iters: int = 32, ml: bool = False,
                       device=None) -> Dict[str, torch.Tensor]:
    """Optimize the (RE)ML likelihood of a projected spectrum in log delta.

    eta2: (..., n - q) squared projections (V'y)^2, any leading batch
    dimensions (traits); xi: (n - q,) projected eigenvalues (or with
    eta2's batch dimensions); phi: (n,) eigenvalues of K, needed for
    ml=True. Runs in float64 on `device` (default: a tensor xi's own
    device; for array input the card, or 'cpu' on request) and returns
    log_delta, delta, ll, sigma_g2, sigma_e2 and pseudo_heritability
    there, each of eta2's batch shape (0-d unbatched).
    The candidates are the refined roots of every + -> - bracket of dLL on
    the grid, then llim and ulim, in the JAX package's order: the first
    maximum of LL among them wins."""
    dev = xi.device if device is None and isinstance(
        xi, torch.Tensor) else resolve_device(device)
    xi = _tensor(xi).to(dev, torch.float64)
    eta2 = _tensor(eta2).to(dev, torch.float64)
    nq = xi.shape[-1]
    if ml:
        if phi is None:
            raise ValueError("ml=True needs phi, the eigenvalues of K")
        det_eigs = _tensor(phi).to(dev, torch.float64)
        scale = det_eigs.shape[-1]
    else:
        det_eigs, scale = xi, nq
    batch = eta2.shape[:-1]
    grid = torch.linspace(llim, ulim, ngrids + 1, dtype=torch.float64,
                          device=dev)
    dll = _dll_terms(grid, eta2, xi, det_eigs, scale)      # (..., G + 1)
    # every + -> - bracket bisected at once; the other lanes run idle
    lo = grid[:-1].expand(batch + (ngrids,))
    hi = grid[1:].expand(batch + (ngrids,))
    is_bracket = (dll[..., :-1] > 0) & (dll[..., 1:] < 0)
    for _ in range(refine_iters):
        mid = (lo + hi) / 2.0
        up = _dll_terms(mid, eta2, xi, det_eigs, scale) > 0
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    ends = torch.tensor([llim, ulim], dtype=torch.float64, device=dev)
    cands = torch.cat([(lo + hi) / 2.0, ends.expand(batch + (2,))], dim=-1)
    valid = torch.cat([is_bracket, torch.ones(batch + (2,), dtype=torch.bool,
                                              device=dev)], dim=-1)
    lls = torch.where(valid, _ll_terms(cands, eta2, xi, det_eigs, scale),
                      -torch.inf)
    j = torch.argmax(lls, dim=-1, keepdim=True)
    log_delta = torch.gather(cands, -1, j)[..., 0]
    ll = torch.gather(lls, -1, j)[..., 0]
    delta = torch.exp(log_delta)
    sg2 = (eta2 / (xi + delta[..., None])).sum(dim=-1) / scale
    return {"log_delta": log_delta, "delta": delta, "ll": ll,
            "sigma_g2": sg2, "sigma_e2": delta * sg2,
            "pseudo_heritability": 1.0 / (1.0 + delta)}


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
    ml: bool = False            # fitted by ML (else REML): h2_profile_ci
                                # profiles this same objective


def fit_null_model(y, X0, K=None, eig_k: Optional[Tuple] = None,
                   ngrids: int = 100, llim: float = -10.0,
                   ulim: float = 10.0, refine_iters: int = 32,
                   host_eigh: Optional[bool] = None,
                   ml: bool = False,
                   method: str = "auto", eigh_dtype=None, device=None,
                   dtype=None) -> NullModel:
    """Null-model (RE)ML, optimized in float64 where U lives. y/X0/K/eig_k
    may be numpy arrays or tensors; the model's tensors land on `device`
    (default: a tensor y's own device; for array input the card, or 'cpu'
    on request) in `dtype` (default: y's dtype, else float64). host_eigh:
    None factors in float64 where the model lives (cuSOLVER on the card,
    host LAPACK on the CPU); True asks for host LAPACK.

    method: 'explicit' (= 'auto') fits the X-explicit likelihood from
    eigh(K) alone (ops/xreml.py), on U's device; 'spectrum' the
    reference's path on `device`: the eigh of S(K+I)S (projected_spectrum;
    K rebuilt as U diag(phi) U' when only eig_k is given), eta2 = (V'y)^2
    and reml_from_spectrum. Both find the same optimum
    (tests/test_torch_spectrum.py holds them together)."""
    if method not in ("auto", "explicit", "spectrum"):
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
    if method == "spectrum":
        # the second eigh and the grid run in float64 on the model's device
        phi64 = phi.detach().to(device, torch.float64)
        if K is None:
            U64 = U.detach().to(device, torch.float64)
            K = (U64 * phi64[None, :]) @ U64.T
            del U64
        xi, V = projected_spectrum(K, X0_t, host=host_eigh, device=device)
        eta2 = (V.T @ y_t.to(torch.float64)) ** 2
        del V
        r = reml_from_spectrum(eta2, xi, phi=phi64 if ml else None,
                               ngrids=ngrids, llim=llim, ulim=ulim,
                               refine_iters=refine_iters, ml=ml)
    else:
        # y and X0 enter the eigenbasis, and the REML runs, in float64 on
        # U's own device
        U64 = U.detach().to(torch.float64)

        def rotate(v):
            return U64.T @ v.to(U.device, torch.float64)

        r = explicit_reml(phi.detach().to(U.device, torch.float64),
                          rotate(y_t), rotate(X0_t), ngrids=ngrids,
                          llim=llim, ulim=ulim, refine_iters=refine_iters,
                          reml=not ml)
    scal = {k: v.to(device=device, dtype=dtype) for k, v in r.items()
            if k != "beta"}
    return NullModel(phi=phi.to(device=device, dtype=dtype),
                     U=U.to(device=device, dtype=dtype), y=y_t, X0=X0_t,
                     ml=ml, **scal)


def h2_profile_ci(null: NullModel, level: float = 0.95, ngrids: int = 400,
                  llim: float = -10.0, ulim: float = 10.0,
                  refine_iters: int = 40) -> Tuple[float, float]:
    """Profile-likelihood confidence interval (h2_lo, h2_hi) for the
    pseudo-heritability: {delta : 2 (LL(delta_hat) - LL(delta)) <=
    chi2_1(level)} mapped through the decreasing h2 = 1/(1 + delta), with
    the JAX package's rules. LL is the X-explicit likelihood
    (ops/xreml.py::ll_explicit) of the null's own objective (ML for
    null.ml, else REML), in float64 on U's device; the ngrids + 1 grid
    points are one batched call, each edge's bisection refine_iters scalar
    steps. Brackets adjoin the outermost grid point outside the region, so
    a disconnected inside region cannot invert them; an edge that never
    leaves the region is clamped at llim / ulim."""
    from scipy.stats import chi2

    U64 = null.U.detach().to(torch.float64)
    dev = U64.device
    phi = null.phi.detach().to(dev, torch.float64)
    y_rot = U64.T @ null.y.to(dev, torch.float64)
    X0 = null.X0.to(dev, torch.float64)
    X_rot = U64.T @ (X0 if X0.ndim == 2 else X0[:, None])
    reml = not null.ml

    def ll_at(logdelta):
        return ll_explicit(torch.as_tensor(logdelta, dtype=torch.float64,
                                           device=dev),
                           phi, y_rot, X_rot, reml)

    ld_hat = float(null.log_delta)
    cut = float(ll_at(ld_hat)) - 0.5 * float(chi2.ppf(level, 1))

    def edge(lo, hi, rising: bool):
        """Bisect the ll == cut crossing in [lo, hi]."""
        for _ in range(refine_iters):
            mid = 0.5 * (lo + hi)
            if (float(ll_at(mid)) >= cut) == rising:
                hi = mid
            else:
                lo = mid
        return 0.5 * (lo + hi)

    grid = np.linspace(llim, ulim, ngrids + 1)
    inside = ll_at(grid).cpu().numpy() >= cut
    lo_out = grid[(grid < ld_hat) & ~inside]
    if lo_out.size:
        lo = float(lo_out.max())
        in_above_lo = grid[(grid > lo) & inside]
        hi = float(in_above_lo.min()) if in_above_lo.size else ld_hat
        ld_lo = edge(lo, hi, rising=True)
    else:
        ld_lo = llim
    hi_out = grid[(grid > ld_hat) & ~inside]
    if hi_out.size:
        hi = float(hi_out.min())
        in_below_hi = grid[(grid < hi) & inside]
        lo = float(in_below_hi.max()) if in_below_hi.size else ld_hat
        ld_hi = edge(lo, hi, rising=False)
    else:
        ld_hi = ulim
    # h2 = 1/(1 + delta) decreases in delta: the high delta is the low h2
    return (1.0 / (1.0 + float(np.exp(ld_hi))),
            1.0 / (1.0 + float(np.exp(ld_lo))))
