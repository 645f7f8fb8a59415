"""Symmetric eigendecomposition of the kinship and the null-design basis
(counterpart of mixmogam_tpu/ops/eigen.py: eigen_k, orthonormal_basis).

eigh(K) runs once per (K, X) pair. host=True is float64 numpy LAPACK, as
in the JAX package; host=False is torch.linalg.eigh on the tensor's own
device (cuSOLVER on the card) in the tensor's dtype."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def eigen_k(K, host: bool = True, factor_dtype=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """eigh(K) -> (phi, U), eigenvalues DESCENDING (EMMA convention).

    K: numpy array or tensor. Results come back on K's device (CPU for a
    numpy K) in K's dtype. factor_dtype: host factorization dtype (None =
    float64; np.float32 = the 'fast' tier's ssyevd)."""
    if isinstance(K, torch.Tensor):
        device, dt = K.device, K.dtype
    else:
        device, dt = torch.device("cpu"), torch.float64
    if host:
        Kh = (K.detach().cpu().numpy() if isinstance(K, torch.Tensor)
              else np.asarray(K))
        w, v = np.linalg.eigh(np.asarray(
            Kh, dtype=np.float64 if factor_dtype is None else factor_dtype))
        phi = torch.as_tensor(w[::-1].copy(), dtype=dt, device=device)
        U = torch.as_tensor(v[:, ::-1].copy(), dtype=dt, device=device)
        return phi, U
    w, v = torch.linalg.eigh(torch.as_tensor(K, device=device))
    return w.flip(0), v.flip(1)


def eigen_k_on(K, device, host_eigh=None, factor_dtype=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """eigh(K) where a null model lives: on a CUDA device cuSOLVER in
    float64 (float32 for factor_dtype=np.float32) unless host_eigh asks
    for host LAPACK; on the CPU host LAPACK (ssyevd for np.float32)."""
    device = torch.device(device)
    if host_eigh or device.type != "cuda":
        return eigen_k(K, host=True, factor_dtype=factor_dtype)
    dt = torch.float32 if factor_dtype is np.float32 else torch.float64
    return eigen_k(torch.as_tensor(K, device=device).to(dt), host=False)


def orthonormal_basis(X: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of span(X) for tall-skinny X (n, q): Gram matrix
    on the device, q x q Cholesky in float64 on the host (q is tiny),
    back-substitution as a matmul — the JAX package's recipe."""
    if X.ndim == 1:
        X = X[:, None]
    C = (X.T @ X).double().cpu().numpy()
    L = np.linalg.cholesky(C)
    Linv_T = torch.as_tensor(np.linalg.inv(L).T, dtype=X.dtype,
                             device=X.device)
    return X @ Linv_T
