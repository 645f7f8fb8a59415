"""PyTorch port, the float64 oracle: mixmogam_tpu_torch/oracle/lmm.py,
glm.py and stepwise.py are copies of mixmogam_tpu/oracle/*.py (numpy and
scipy only), which the card's machine can run without the JAX package.
Each function is pinned to its original: the same outputs, bit for bit, on
small fixtures (the kinship copies are pinned in
tests/test_torch_datalayer.py)."""

import numpy as np
import pytest

from mixmogam_tpu import oracle as joracle
from mixmogam_tpu_torch import oracle


def _fixture():
    rng = np.random.default_rng(31)
    n, m = 40, 24
    G = rng.integers(0, 2, (m, n)).astype(np.float64)
    G3 = rng.integers(0, 3, (m, n)).astype(np.float64)
    G3[2, :5] = np.nan                      # missing calls
    K = joracle.scale_k(joracle.ibs_kinship(G))
    y = G[3] * 0.9 + rng.normal(size=n)
    X0 = np.column_stack([np.ones(n), rng.normal(size=n)])
    return dict(G=G, G3=G3, K=K, y=y, X0=X0, x=G[5])


_FX = _fixture()


def _args(name):
    f = _FX
    return {
        "eigen_K": ((f["K"],), {}),
        "eigen_R": ((f["K"], f["X0"]), {}),
        "reml": ((f["y"], f["X0"], f["K"]), {}),
        "ml": ((f["y"], f["X0"], f["K"]), {}),
        "emmax_scan": ((f["G"], f["y"], f["K"]), {"X0": f["X0"]}),
        "emma_scan": ((f["G"][:6], f["y"], f["K"]), {}),
        "gls_f_test": ((f["y"], f["X0"], f["x"]), {}),
        "ols_scan": ((f["G"], f["y"]), {"X0": f["X0"]}),
        "anova_scan": ((f["G3"], f["y"]), {}),
        "kruskal_wallis_scan": ((f["G3"], f["y"]), {}),
        "mlmm_step_wise": ((f["G"], f["y"], f["K"]), {"max_steps": 2}),
    }[name]


def _equal(a, b, path="out"):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _equal(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _equal(u, v, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


_NAMES = ["eigen_K", "eigen_R", "reml", "ml", "emmax_scan", "emma_scan",
          "gls_f_test", "ols_scan", "anova_scan", "kruskal_wallis_scan",
          "mlmm_step_wise"]


@pytest.mark.parametrize("name", _NAMES)
def test_oracle_copy_equals_the_original(name):
    a, kw = _args(name)
    _equal(getattr(oracle, name)(*a, **kw), getattr(joracle, name)(*a, **kw))


def test_the_package_exports_what_the_original_exports():
    assert set(joracle.__all__) <= set(oracle.__all__)
    assert set(_NAMES) == set(oracle.__all__) - {
        "ibs_kinship", "vanraden_kinship", "scale_k", "prepare_k",
        "mean_impute"}
    for name in oracle.__all__:
        assert callable(getattr(oracle, name))
    with pytest.raises(AttributeError):
        oracle.no_such_function
