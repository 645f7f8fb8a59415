"""Host genotype-source plumbing (counterpart of
mixmogam_tpu/models/source.py: resolve_source, should_stream)."""

from __future__ import annotations

import numpy as np


def resolve_source(G):
    """GenotypeData -> its int8 matrix; lazy array-likes (ndarray,
    np.memmap, h5py datasets) pass through unmaterialized."""
    if hasattr(G, "matrix"):
        return G.matrix
    if hasattr(G, "shape") and hasattr(G, "dtype"):
        return G
    return np.asarray(G)


def should_stream(G_src, n: int, itemsize: int, budget_bytes: int) -> bool:
    """True when the in-core scan's device footprint (G itself plus its
    rotated image at the compute dtype's itemsize) exceeds the budget."""
    g_item = 1 if np.dtype(G_src.dtype) == np.int8 else itemsize
    return G_src.shape[0] * n * (itemsize + g_item) > budget_bytes


def as_int8_dosage(G):
    """An (M, n) source as int8 dosages 0..127 with -1 for missing, or
    None when some observed dosage is fractional, negative or above 127.
    int8 matrices (GenotypeData's included) pass through; float matrices
    (NaN = missing) are checked and converted."""
    mat = resolve_source(G)
    if np.dtype(mat.dtype) == np.int8:
        return mat
    A = np.asarray(mat)
    if not np.issubdtype(A.dtype, np.floating):
        return A.astype(np.int8) if (
            A.size == 0 or (A.min() >= 0 and A.max() <= 127)) else None
    miss = np.isnan(A)
    obs = np.where(miss, 0.0, A)
    if A.size and (obs.min() < 0 or obs.max() > 127
                   or not np.array_equal(obs, np.round(obs))):
        return None
    out = obs.astype(np.int8)
    out[miss] = -1
    return out
