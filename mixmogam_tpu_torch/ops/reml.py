"""Null-model REML (counterpart of mixmogam_tpu/ops/reml.py).

Only the X-explicit optimizer ('explicit' = 'auto') is ported: it needs
eigh(K) alone, and ops/xreml.py::explicit_reml runs it in float64 where
the eigenbasis lives. esp_to_refine_iters is a copy of the JAX package's
function (the original lives in a module that imports jax);
tests/test_torch_ops.py pins it to the original. The device 'spectrum'
optimizer waits for ROADMAP Queue 1 item 3.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from mixmogam_tpu_torch.ops import resolve_device
from mixmogam_tpu_torch.ops.eigen import eigen_k_on
from mixmogam_tpu_torch.ops.xreml import explicit_reml


def esp_to_refine_iters(esp: float, ngrids: int = 100, llim: float = -10.0,
                        ulim: float = 10.0) -> int:
    """Bisection iterations needed to shrink one grid bracket below the
    reference's esp tolerance on log(delta) (clamped to [16, 64])."""
    width = (ulim - llim) / max(ngrids, 1)
    need = math.log2(max(width / max(esp, 1e-30), 2.0))
    return max(16, min(64, int(math.ceil(need))))


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
    """Null-model REML from eigh(K) alone, optimized in float64 where U
    lives (ops/xreml.py). y/X0/K/eig_k may be numpy arrays or tensors; the
    model's
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
    # y and X0 enter the eigenbasis, and the REML runs, in float64 on U's
    # own device
    U64 = U.detach().to(torch.float64)

    def rotate(v):
        return U64.T @ v.to(U.device, torch.float64)

    r = explicit_reml(
        phi.detach().to(U.device, torch.float64), rotate(y_t),
        rotate(X0_t), ngrids=ngrids, llim=llim, ulim=ulim,
        refine_iters=refine_iters, reml=not ml)
    scal = {k: v.to(device=device, dtype=dtype) for k, v in r.items()
            if k != "beta"}
    return NullModel(phi=phi.to(device=device, dtype=dtype),
                     U=U.to(device=device, dtype=dtype), y=y_t, X0=X0_t,
                     **scal)

