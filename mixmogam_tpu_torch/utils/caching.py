"""Artifact caches (counterpart of mixmogam_tpu/utils/caching.py; SURVEY.md
§5 'Checkpoint / resume': the reference caches kinship matrices keyed by
dataset). Keys are the genotype CONTENT hash, file names and npz fields are
the JAX package's, so either package reads the other's entries; the
eigendecomposition cache is the other one-time O(n^3) artifact worth reusing
across traits/runs.

Every artifact writes via a PID-unique temp file + os.replace (a kill
mid-savez must not leave a truncated .npz), and loads tolerate a corrupt
entry by recomputing instead of aborting."""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

import numpy as np

_log = logging.getLogger("mixmogam_tpu_torch.caching")


def _atomic_savez(path: str, compressed: bool = True, **arrays) -> None:
    tmp = f"{path}.tmp{os.getpid()}.npz"
    (np.savez_compressed if compressed else np.savez)(tmp, **arrays)
    os.replace(tmp, path)


def save_kinship_to_file(path: str, K: np.ndarray,
                         accessions: List[str]) -> None:
    """Reference-compatible named saver (npz instead of pickle: portable,
    no code execution on load); atomic write."""
    _atomic_savez(path if path.endswith(".npz") else path + ".npz",
                  k=np.asarray(K, dtype=np.float64),
                  accessions=np.array(accessions, dtype="U"))


def load_kinship_from_file(path: str) -> Tuple[np.ndarray, List[str]]:
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path, allow_pickle=False) as z:
        return z["k"], [str(a) for a in z["accessions"]]


def _key_path(cache_dir: str, kind: str, key: str) -> str:
    os.makedirs(cache_dir, exist_ok=True)
    return os.path.join(cache_dir, f"{kind}_{key}.npz")


def cached_kinship(gd, method: str = "ibs",
                   cache_dir: Optional[str] = None,
                   use_device: bool = True, scale: bool = True,
                   device=None) -> np.ndarray:
    """Kinship with content-hash cache (reference flow §3.1: 'load cached
    OR calc_ibs_kinship'). A corrupt cache entry recomputes (and is
    overwritten) rather than aborting the run. device: where a miss is
    computed (ops.kinship.kinship: the card by default)."""
    from mixmogam_tpu_torch.oracle.kinship import scale_k

    p = None
    if cache_dir:
        # hashed only when there is a cache: content_hash reads every byte
        # of the genotype matrix
        key = f"{gd.content_hash()}_{method}{'_scaled' if scale else ''}"
        p = _key_path(cache_dir, "kinship", key)
        if os.path.exists(p):
            try:
                K, acc = load_kinship_from_file(p)
                if acc == list(gd.accessions):
                    return K
            except Exception:
                _log.warning("unreadable kinship cache entry %s; "
                             "recomputing", p)
    from mixmogam_tpu_torch.ops import kinship as dk

    K = dk.kinship(gd, method=method, use_device=use_device, device=device)
    if scale:
        K = scale_k(K)
    if p:
        save_kinship_to_file(p, K, list(gd.accessions))
    return K


def cached_eigen(K: np.ndarray, cache_dir: Optional[str] = None,
                 key: Optional[str] = None, device=None
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """eigh(K) (descending) as float64 host arrays, with an on-disk cache
    (uncompressed: U is an orthonormal basis, which barely compresses).
    device: where a miss is factored (ops.eigen.eigen_k_on): the card by
    default, in float64 cuSOLVER (without one the call raises, before the
    cache is read); host LAPACK on 'cpu'."""
    import hashlib

    from mixmogam_tpu_torch.ops import resolve_device

    device = resolve_device(device)

    p = None
    if cache_dir:
        if key is None:
            key = hashlib.sha256(
                np.ascontiguousarray(K, dtype=np.float64).tobytes()
            ).hexdigest()[:16]
        p = _key_path(cache_dir, "eigen", key)
        if os.path.exists(p):
            try:
                with np.load(p, allow_pickle=False) as z:
                    return z["phi"], z["U"]
            except Exception:
                _log.warning("unreadable eigen cache entry %s; "
                             "recomputing", p)
    from mixmogam_tpu_torch.ops.eigen import eigen_k_on

    phi, U = eigen_k_on(np.asarray(K, dtype=np.float64), device)
    phi = phi.cpu().numpy().astype(np.float64)
    U = U.cpu().numpy().astype(np.float64)
    if p:
        _atomic_savez(p, compressed=False, phi=phi, U=U)
    return phi, U
