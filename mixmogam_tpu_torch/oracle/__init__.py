"""Float64 numpy/scipy oracle: ground truth the port answers to, runnable
on the card's machine, where the JAX package is absent. Copies of
mixmogam_tpu/oracle/{kinship,lmm,glm,stepwise}.py (numpy and scipy only),
each pinned to its original by the port's tests
(tests/test_torch_datalayer.py for the kinships, tests/test_torch_oracle.py
for the rest). The kinships load with the package; the scipy-backed REML,
scans and stepwise at first use, so that the scan path's
`oracle.kinship.scale_k` imports no scipy.optimize."""

from mixmogam_tpu_torch.oracle.kinship import (ibs_kinship, mean_impute,
                                               prepare_k, scale_k,
                                               vanraden_kinship)

_LAZY = {"eigen_K": "lmm", "eigen_R": "lmm", "reml": "lmm", "ml": "lmm",
         "emmax_scan": "lmm", "emma_scan": "lmm", "gls_f_test": "lmm",
         "ols_scan": "glm", "anova_scan": "glm",
         "kruskal_wallis_scan": "glm", "mlmm_step_wise": "stepwise"}

__all__ = ["ibs_kinship", "vanraden_kinship", "scale_k", "prepare_k",
           "mean_impute"] + list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(
            f"mixmogam_tpu_torch.oracle.{_LAZY[name]}")
        return getattr(mod, name)
    raise AttributeError(
        f"module 'mixmogam_tpu_torch.oracle' has no attribute {name!r}")
