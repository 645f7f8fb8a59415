"""Symmetric eigendecompositions of the mixed-model core and the
null-design basis (counterpart of mixmogam_tpu/ops/eigen.py: eigen_k,
projected_spectrum, orthonormal_basis).

eigh(K) runs once per (K, X) pair. host=True is float64 numpy LAPACK, as
in the JAX package; host=False is torch.linalg.eigh on the tensor's own
device (cuSOLVER on the card) in the tensor's dtype. projected_spectrum is
the reference's second eigh, of S(K+I)S, in float64 where the model
lives."""

from __future__ import annotations

from typing import Optional, Tuple

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


def projected_spectrum(K, X, host: Optional[bool] = None, device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spectrum of S(K+I)S with S = I - X(X'X)^-1 X' (the reference's
    _get_eigen_R_): (xi, V), the n - q largest eigenvalues minus the +1
    shift, descending, and their eigenvectors (n, n - q), as float64
    tensors on `device`. The +I shift keeps the matrix positive definite
    on range(S), so the q null eigenvalues (0) sit a gap of at least 1
    below the kept ones.

    K: (n, n) and X: (n, q) numpy arrays or tensors (a 1-D X becomes
    (1, n), np.atleast_2d's rule, as in the JAX package). device: None
    takes a tensor K's own device, else the card (raising without one);
    'cpu' on request. host: None factors in float64 on the device
    (cuSOLVER on the card, host LAPACK on the CPU); True asks for host
    LAPACK; False for torch.linalg.eigh on the device. K + I, S(K+I) and
    M are formed in one float64 n^2 buffer (839 MB at n = 10,240), each
    step's product the only other n^2 tensor alive."""
    from mixmogam_tpu_torch.ops import resolve_device

    if device is None and isinstance(K, torch.Tensor):
        device = K.device
    device = resolve_device(device)
    on_host = host or (host is None and device.type != "cuda")
    work = torch.device("cpu") if on_host else device
    X = torch.as_tensor(np.asarray(X) if not isinstance(X, torch.Tensor)
                        else X, device=work).to(torch.float64)
    if X.ndim == 1:
        X = X[None, :]              # np.atleast_2d semantics
    n, q = X.shape
    S_X = torch.linalg.solve(X.T @ X, X.T)                 # (q, n)
    # one n^2 buffer, updated in place (the caller's K stays untouched)
    M = torch.as_tensor(K, device=work).to(torch.float64, copy=True)
    M.diagonal().add_(1.0)                                 # K + I
    M -= X @ (S_X @ M)                                     # S (K + I)
    M -= (M @ X) @ S_X                                     # S (K + I) S
    M = M + M.T
    M /= 2.0
    if on_host:
        w, v = np.linalg.eigh(M.numpy())
        w, v = torch.from_numpy(w), torch.from_numpy(v)
    else:
        w, v = torch.linalg.eigh(M)
    del M
    # ascending: the n - q kept ones are the last, flipped to descending
    xi = w[q:].flip(0) - 1.0
    V = v[:, q:].flip(1)
    del w, v
    return xi.to(device), V.to(device)


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
