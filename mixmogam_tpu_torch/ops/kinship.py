"""Kinship construction on a device (counterpart of
mixmogam_tpu/ops/kinship.py: kinship, _impute_chunk, the float updates).

  IBS binary:  C'C + (1-C)'(1-C) = 2 C'C - s (x) 1 - 1 (x) s + m J
               (s = per-sample chunk sums) — half the naive matmul flops.
  IBS diploid: sum of (2 - |a-b|) / 2 with
               |a-b| = (a-b)^2 - 2([a=0][b=2] + [a=2][b=0]).
  VanRaden:    W = C - ploidy * p;  K += W'W;  denom += ploidy*sum p(1-p).

Routes of kinship():
- a fully observed int8 source at ploidy 1 or 2 is packed onto the device
  (ResidentGenome.from_source) and goes through kernel K1
  (ops/hopper_kinship.py): integer-exact sharing counts;
- missing genotypes or float dosages: per-chunk mean imputation on the host
  (the normative rule, shared with the oracle), then the float updates
  below, which are plain matmuls (float32 with TF32 off on the card,
  float64 on the CPU and on request);
- use_device=False: the float64 numpy oracle (oracle/kinship.py).

Every route finishes in finish_on_device: the accumulator is converted to
float64 and divided on its device, and the float64 matrix is copied to the
host once.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def finish_on_device(acc: torch.Tensor, den) -> np.ndarray:
    """acc (int32 counts or a float accumulator) -> float64 acc / den as a
    host array: converted and divided on acc's device (the same IEEE
    division as acc.astype(float64) / den on the host), copied once. The
    denominator goes in as a tensor on the device: by a Python number
    PyTorch's CUDA kernel multiplies by the reciprocal, which rounds
    differently."""
    d = torch.tensor(float(den), dtype=torch.float64, device=acc.device)
    return torch.div(acc.double(), d).cpu().numpy()


def _check_matmul_precision(K_acc: torch.Tensor) -> None:
    if K_acc.dtype == torch.float32 and K_acc.device.type == "cuda":
        from mixmogam_tpu_torch.ops import assert_fp32_matmuls

        assert_fp32_matmuls()


def _ibs_binary_update(K_acc, C, m_eff: float):
    """K_acc += 2 C'C - s(x)1 - 1(x)s + m_eff * J, in place."""
    s = C.sum(dim=0)
    K_acc.add_(C.T @ C, alpha=2.0)
    K_acc.sub_(s[:, None]).sub_(s[None, :]).add_(m_eff)
    return K_acc


def _vanraden_update(K_acc, W):
    """K_acc += W'W, in place."""
    K_acc.add_(W.T @ W)
    return K_acc


def _soft_onehots(C):
    """Soft one-hot weights of genotypes 0 and 2, max(0, 1 - |a - g|):
    indicators for integer dosages, the oracle's weights for imputed
    fractions."""
    return (torch.clamp(1.0 - torch.abs(C), min=0.0),
            torch.clamp(1.0 - torch.abs(C - 2.0), min=0.0))


def _ibs_diploid_update(K_acc, C, W0, W2, m_eff: float):
    """Diploid IBS sharing via |a-b| = (a-b)^2 - 2([a=0][b=2]+[a=2][b=0]):
    K_acc += sum over the chunk of (2 - |a-b|)/2, in place (see
    oracle.kinship)."""
    a2 = (C * C).sum(dim=0)
    corr = W0.T @ W2
    # (2 m - absd) / 2 with absd = a2_i + a2_j - 2 CtC - 2 (corr + corr')
    K_acc.add_(C.T @ C).add_(corr).add_(corr.T)
    K_acc.sub_(a2[:, None] / 2.0).sub_(a2[None, :] / 2.0).add_(m_eff)
    return K_acc


def _impute_chunk(chunk: np.ndarray, dtype) -> np.ndarray:
    """(m, n) chunk -> float (numpy dtype), per-SNP mean imputed (signed
    integer: < 0 = missing; float: NaN = missing — the normative rule
    shared with the oracle). A float chunk takes the streamed scan's
    blocked imputation (models/streaming.py::_host_float_tile: nanmean's
    arithmetic, the same values, without a float64 copy of the chunk)."""
    if np.issubdtype(chunk.dtype, np.floating):
        from mixmogam_tpu_torch.models.streaming import _host_float_tile

        return _host_float_tile(chunk, np.dtype(dtype))
    if np.issubdtype(chunk.dtype, np.integer):
        miss = chunk < 0
        C = chunk.astype(np.float64)
        if miss.any():
            C[miss] = np.nan
    else:
        C = chunk.astype(np.float64)
        miss = np.isnan(C)
    if miss.any():
        mu = np.nanmean(C, axis=1)
        mu = np.where(np.isnan(mu), 0.0, mu)
        idx = np.where(miss)
        C[idx] = mu[idx[0]]
    return C.astype(dtype)


def resolve_compute_dtype(dtype, device) -> torch.dtype:
    """A torch float dtype, or None for the device's default (float32 on
    the card, float64 on the CPU). numpy dtypes and strings are refused,
    not coerced."""
    if dtype is None:
        from mixmogam_tpu_torch.models.resident import _default_dtype

        return _default_dtype(device)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise TypeError(
            f"dtype must be a torch floating dtype (torch.float32 / "
            f"torch.float64) or None; got {dtype!r}")
    return dtype


def _np_dtype(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


def check_kinship_method(method: str) -> str:
    """'ibs' or 'vanraden' ('ibd' is the reference's name for the latter);
    anything else raises."""
    if method == "ibd":
        return "vanraden"
    if method not in ("ibs", "vanraden"):
        raise ValueError(f"unknown kinship method {method!r}")
    return method


def kinship(data, method: str = "ibs", ploidy: Optional[int] = None,
            chunk: int = 2048, dtype=None, use_device: bool = True,
            device=None) -> np.ndarray:
    """Build a kinship matrix from a GenotypeData, a ResidentGenome or an
    (M, n) dosage array.

    method: 'ibs' (allele sharing) or 'vanraden' (a.k.a. 'ibd' in the
    reference's naming). device: the card by default (without one the
    call raises), 'cpu' on request; unused with use_device=False, the
    float64 numpy oracle. dtype: a torch float dtype for the float
    accumulations (None: float32 on the card, float64 on the CPU).
    Returns an (n, n) float64 numpy array.
    """
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    kinship_resident)

    if isinstance(data, ResidentGenome):
        if not use_device:
            raise ValueError("a ResidentGenome lives in device memory; "
                             "use_device=False needs a host source")
        return kinship_resident(data.on_device(device), method=method,
                                ploidy=ploidy, dtype=dtype)
    if hasattr(data, "matrix") and hasattr(data, "ploidy"):
        mat = data.matrix
        ploidy = data.ploidy if ploidy is None else ploidy
    else:
        mat = np.asarray(data)
        if ploidy is None:
            ploidy = 2 if mat.max(initial=0) > 1 else 1
    method = check_kinship_method(method)
    if not use_device:
        from mixmogam_tpu_torch import oracle

        Z = mat.astype(np.float64)
        if np.issubdtype(mat.dtype, np.integer):
            Z[mat < 0] = np.nan
        fn = oracle.ibs_kinship if method == "ibs" \
            else oracle.vanraden_kinship
        return fn(Z, ploidy=ploidy)

    from mixmogam_tpu_torch.ops import resolve_device

    device = resolve_device(device)
    dtype = resolve_compute_dtype(dtype, device)
    M, n = mat.shape
    if method == "vanraden":
        return _vanraden(mat, ploidy, chunk, dtype, device)

    # fully observed int8 coding -> integer-exact sharing counts from the
    # packed rows (K1). The missing-check runs CHUNKED: one (M, n) bool
    # temporary would be as large as the source itself
    def _any_negative(m_):
        return any((np.asarray(m_[s:s + chunk]) < 0).any()
                   for s in range(0, m_.shape[0], chunk))

    if (np.dtype(mat.dtype) == np.int8 and ploidy in (1, 2)
            and not _any_negative(mat)):
        rg = ResidentGenome.from_source(mat, ploidy=ploidy, device=device)
        return kinship_resident(rg, method="ibs", ploidy=ploidy)

    return finish_on_device(ibs_float_partial(mat, ploidy, chunk, dtype,
                                              device), float(M))


def ibs_float_partial(mat, ploidy: int, chunk: int, dtype: torch.dtype,
                      device) -> torch.Tensor:
    """The IBS sharing sums of the rows of mat, before the division by
    their count: per-chunk host mean imputation, then the float updates in
    dtype on device. An accumulator a rank of distributed_kinship sums
    with the others'."""
    M, n = mat.shape
    K = torch.zeros((n, n), dtype=dtype, device=device)
    _check_matmul_precision(K)
    for s in range(0, M, chunk):
        e = min(s + chunk, M)
        C = torch.from_numpy(_impute_chunk(np.asarray(mat[s:e]),
                                           _np_dtype(dtype))).to(device)
        if ploidy == 1:
            _ibs_binary_update(K, C, float(e - s))
        else:
            _ibs_diploid_update(K, C, *_soft_onehots(C), float(e - s))
    return K


def vanraden_partial(mat, ploidy: int, chunk: int, dtype: torch.dtype,
                     device):
    """(W'W, ploidy * sum p(1 - p)) of the rows of mat: VanRaden's
    numerator in dtype on device and its denominator, before the
    division."""
    M, n = mat.shape
    K = torch.zeros((n, n), dtype=dtype, device=device)
    _check_matmul_precision(K)
    denom = 0.0
    for s in range(0, M, chunk):
        e = min(s + chunk, M)
        C = _impute_chunk(np.asarray(mat[s:e]), _np_dtype(dtype))
        p = C.mean(axis=1) / ploidy
        denom += float(ploidy * np.sum(p * (1.0 - p)))
        W = C - (ploidy * p)[:, None]
        _vanraden_update(K, torch.from_numpy(W).to(device))
    return K, denom


def _vanraden(mat, ploidy: int, chunk: int, dtype: torch.dtype,
              device) -> np.ndarray:
    return finish_on_device(*vanraden_partial(mat, ploidy, chunk, dtype,
                                              device))
