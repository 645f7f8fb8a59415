"""Float64 host p-values (scipy) — the default output path, as in the
JAX package (mixmogam_tpu/ops/stats.py: p ~ 1e-300 tails stay exact)."""

from __future__ import annotations

import numpy as np


def f_sf_host(f_stat, d1, d2) -> np.ndarray:
    """Survival function of F(d1, d2) in float64 on the host."""
    import scipy.stats

    return scipy.stats.f.sf(np.asarray(f_stat, dtype=np.float64), d1, d2)
