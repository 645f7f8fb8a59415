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
