"""Float64 host p-values (scipy) — the default output path, as in the
JAX package (mixmogam_tpu/ops/stats.py: p ~ 1e-300 tails stay exact).
f_sf_host and chi2_sf_host are copies of the JAX package's functions
(tests/test_torch_linear.py pins them to the originals); its device forms
(f_sf, chi2_sf, neg_log10_f_sf) wait until a model calls them."""

from __future__ import annotations

import numpy as np


def f_sf_host(f_stat, d1, d2) -> np.ndarray:
    """Survival function of F(d1, d2) in float64 on the host."""
    import scipy.stats

    return scipy.stats.f.sf(np.asarray(f_stat, dtype=np.float64), d1, d2)


def chi2_sf_host(x, df) -> np.ndarray:
    """Survival function of chi2(df) in float64 on the host."""
    import scipy.stats

    return scipy.stats.chi2.sf(np.asarray(x, dtype=np.float64), df)
