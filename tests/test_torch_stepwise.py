"""PyTorch port, stepwise MLMM (models/stepwise.py) against
mixmogam_tpu.models.stepwise.emmax_step_wise (CPU, x64) and the float64
oracle (mixmogam_tpu.oracle.stepwise.mlmm_step_wise), on every route: the
stored rotation (from a ResidentGenome and from a host array), the packed
rows rotated at each step (over the rotation budget), int8 and float
tiles streamed from the host, and the identity kinship. Per-step cofactors
and the selected models equal; delta, h2, BIC, eBIC, mBIC and the
cofactor re-tests to 1e-8 (delta and h2 not under the identity kinship,
whose likelihood is flat in delta); forward min_p to rtol 1e-6."""

import numpy as np
import pytest
import torch

from mixmogam_tpu import oracle
from mixmogam_tpu.models import resident as jres
from mixmogam_tpu.models import stepwise as jsw
from mixmogam_tpu.oracle.kinship import ibs_kinship, scale_k
from mixmogam_tpu_torch.models import stepwise
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.ops.hopper_scan import scan_stats

torch.set_num_threads(1)

N, M, STEPS = 80, 240, 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    G = rng.integers(0, 2, (M, N)).astype(np.int8)
    G[rng.random(G.shape) < 0.02] = -1
    Gf = np.where(G < 0, 1, G).astype(np.float64)
    y = Gf[10] + 0.8 * Gf[50] + rng.normal(size=N)
    K = scale_k(ibs_kinship(Gf))
    # a float source with fractional (imputed-looking) dosages and NaNs
    Gfrac = Gf + rng.uniform(-0.3, 0.3, Gf.shape) * (rng.random(Gf.shape)
                                                     < 0.1)
    Gfrac[rng.random(Gf.shape) < 0.01] = np.nan
    return {"G": G, "Gfrac": Gfrac, "y": y, "K": K}


@pytest.fixture(scope="module")
def ref(data):
    """JAX results, computed once per source."""
    G, y, K = data["G"], data["y"], data["K"]
    return {
        "int8": jsw.emmax_step_wise(G, y, K=K, max_steps=STEPS,
                                    save_scans=True),
        "float": jsw.emmax_step_wise(data["Gfrac"], y, K=K, max_steps=STEPS,
                                     save_scans=True),
        "identity": jsw.emmax_step_wise(G, y, K=None, max_steps=STEPS,
                                        save_scans=True),
    }


def _same(res, ref, scans=True, flat=False):
    """flat: the identity kinship, where the likelihood does not depend on
    delta (H = (1 + delta) I), so delta and h2 are the grid's pick among
    equal values, and only what does not depend on them is compared."""
    assert len(res["steps"]) == len(ref["steps"])
    keys = ("bic", "ebic", "mbic", "ll_ml") + (
        () if flat else ("delta", "pseudo_heritability"))
    for a, b in zip(res["steps"], ref["steps"]):
        assert a["phase"] == b["phase"]
        assert a["cofactors"] == b["cofactors"]
        assert a["min_p_snp"] == b["min_p_snp"]
        for k in keys:
            assert abs(a[k] - b[k]) <= 1e-8 * max(1.0, abs(b[k])), k
        np.testing.assert_allclose(a["cofactor_ps"], b["cofactor_ps"],
                                   rtol=1e-8, atol=1e-12)
        assert a["mbonf_ok"] == b["mbonf_ok"]
        if b["phase"] == "forward" and b["min_p_snp"] >= 0:
            np.testing.assert_allclose(a["min_p"], b["min_p"], rtol=1e-6)
        if scans and "scan_ps" in b:
            np.testing.assert_allclose(a["scan_ps"], b["scan_ps"],
                                       rtol=1e-6, atol=1e-12)
    assert res["selected"] == ref["selected"]
    assert res["bonf_threshold"] == ref["bonf_threshold"]


_ROUTES = {
    "stored_resident": ("int8", "rg", {}, "stored"),
    "stored_host": ("int8", "host", {}, "stored"),
    "over_budget_resident": ("int8", "rg", {"rot_budget_bytes": 1024},
                             "resident"),
    "streamed_int8": ("int8", "host", {"rot_budget_bytes": 1024, "tile": 64},
                      "streamed"),
    "streamed_float": ("float", "host", {"rot_budget_bytes": 1024,
                                         "tile": 64}, "streamed"),
    "stored_float": ("float", "host", {}, "stored"),
}


@pytest.mark.parametrize("route", sorted(_ROUTES))
def test_routes_match_jax(data, ref, route):
    src, kind, kw, want = _ROUTES[route]
    G = data["G"] if src == "int8" else data["Gfrac"]
    if kind == "rg":
        G = ResidentGenome.from_source(G, tile=64, device="cpu")
    else:
        kw = dict(kw, device="cpu")
    before = scan_stats.launches
    res = stepwise.emmax_step_wise(G, data["y"], K=data["K"],
                                   max_steps=STEPS, save_scans=True, **kw)
    assert res["timings_s"]["route"] == want
    assert scan_stats.launches == before         # the plain version on CPU
    _same(res, ref[src])


def test_oracle_agrees(data, ref):
    """The float64 oracle (per-SNP lstsq) on the mean-imputed dosages: the
    same path of cofactors and the same selected models."""
    Gf = np.where(data["G"] < 0, np.nan, data["G"]).astype(np.float64)
    mu = np.nanmean(Gf, axis=1)
    Gf = np.where(np.isnan(Gf), mu[:, None], Gf)
    o = oracle.mlmm_step_wise(Gf, data["y"], data["K"], max_steps=STEPS)
    res = stepwise.emmax_step_wise(data["G"], data["y"], K=data["K"],
                                   max_steps=STEPS, device="cpu")
    assert [s["cofactors"] for s in res["steps"]] == [
        s["cofactors"] for s in o["steps"]]
    assert res["selected"] == o["selected"]
    for a, b in zip(res["steps"], o["steps"]):
        for k in ("bic", "ebic", "mbic", "pseudo_heritability"):
            assert abs(a[k] - b[k]) <= 1e-6 * max(1.0, abs(b[k])), k


@pytest.mark.parametrize("budget", [None, 1024])
def test_identity_kinship_matches_jax(data, ref, budget):
    rg = ResidentGenome.from_source(data["G"], tile=64, device="cpu")
    res = stepwise.emmax_step_wise(rg, data["y"], K=None, max_steps=STEPS,
                                   save_scans=True, rot_budget_bytes=budget)
    _same(res, ref["identity"], flat=True)


def test_early_stop_matches_jax(data):
    y = np.random.default_rng(2).normal(size=N)        # no signal
    r = jsw.emmax_step_wise(data["G"], y, K=data["K"], max_steps=STEPS,
                            early_stop=True)
    res = stepwise.emmax_step_wise(data["G"], y, K=data["K"],
                                   max_steps=STEPS, early_stop=True,
                                   device="cpu")
    assert len(res["steps"]) == len(r["steps"]) == 1
    _same(res, r)


def test_wide_design_runs_on_the_cpu_route(data):
    """q = 17 columns in the base design (kernel K3 takes up to 128; the
    CPU route takes any q), held to the float64 oracle: the JAX package
    compiles its unrolled 19 x 19 Cholesky for minutes."""
    rng = np.random.default_rng(3)
    X0 = np.column_stack([np.ones(N), rng.normal(size=(N, 16))])
    G = np.where(data["G"] < 0, 1, data["G"]).astype(np.int8)
    o = oracle.mlmm_step_wise(G.astype(np.float64), data["y"], data["K"],
                              X0=X0, max_steps=2)
    res = stepwise.emmax_step_wise(G, data["y"], K=data["K"], X0=X0,
                                   max_steps=2, device="cpu")
    assert [s["cofactors"] for s in res["steps"]] == [
        s["cofactors"] for s in o["steps"]]
    assert res["selected"] == o["selected"]
    for a, b in zip(res["steps"], o["steps"]):
        for k in ("bic", "ebic", "mbic", "pseudo_heritability"):
            assert abs(a[k] - b[k]) <= 1e-6 * max(1.0, abs(b[k])), k


def test_errors_and_defaults(data):
    rg = ResidentGenome.from_source(data["G"], tile=64, device="cpu")
    with pytest.raises(ValueError, match="resident genome holds"):
        stepwise.emmax_step_wise(rg, data["y"][:-1], K=data["K"][:-1, :-1])
    with pytest.raises(NotImplementedError, match="Queue 1 item 16"):
        stepwise.emmax_step_wise(data["G"], data["y"], K=data["K"],
                                 mesh=object(), device="cpu")
    assert stepwise.stored_budget_bytes("cpu") is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            stepwise.emmax_step_wise(data["G"], data["y"], K=data["K"])


def test_log_binom_and_rot_null_match_jax(data):
    import jax.numpy as jnp

    for m, k in ((240, 0), (240, 3), (10 ** 6, 10)):
        assert stepwise._log_binom(m, k) == jsw._log_binom(m, k)
    w, v = np.linalg.eigh(data["K"])
    phi, U = w[::-1].copy(), v[:, ::-1].copy()
    X = np.column_stack([np.ones(N), data["G"][10].clip(0)])
    yr, Xr = U.T @ data["y"], U.T @ X
    rj = jsw._rot_null_from_delta(jnp.asarray(phi), 0.7, jnp.asarray(yr),
                                  jnp.asarray(Xr), jnp.float64)
    rt = stepwise._rot_null_from_delta(torch.from_numpy(phi), 0.7,
                                       torch.from_numpy(yr),
                                       torch.from_numpy(Xr), torch.float64)
    for f in ("sd", "Q0", "y_res", "rss0", "dof"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=1e-10,
                                   atol=1e-12)


def test_singular_kinship_float32_matches_float64():
    """VanRaden's K (singular along the intercept) with delta at its
    lower bound: the float32 CPU route (the card's dtype) chooses what
    float64 chooses; the rotated rows carry X0's span projected out."""
    from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                                  simulate_phenotype)
    from mixmogam_tpu_torch.ops.kinship import kinship

    G, _, _ = simulate_genotypes(256, 3_000, ploidy=1, seed=3)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=4, seed=3)
    K = scale_k(kinship(G, method="vanraden", device="cpu"))
    a = stepwise.emmax_step_wise(G, y, K=K, max_steps=2, save_scans=True,
                                 device="cpu", dtype=torch.float32)
    b = stepwise.emmax_step_wise(G, y, K=K, max_steps=2, save_scans=True,
                                 device="cpu")
    assert b["steps"][0]["delta"] < 1e-4            # delta at its bound
    assert [s["cofactors"] for s in a["steps"]] == [
        s["cofactors"] for s in b["steps"]]
    assert a["selected"] == b["selected"]
    dp = np.abs(a["steps"][0]["scan_ps"] - b["steps"][0]["scan_ps"])
    assert dp.max() <= 1e-4
    assert np.array_equal(a["steps"][0]["scan_ps"] < 1.0,
                          b["steps"][0]["scan_ps"] < 1.0)


def test_resident_rotation_equals_the_host_one(data):
    """rotate_resident_to_device and rotate_streamed_to_device give the same
    rows and the same design mask from the packed and the host source."""
    from mixmogam_tpu_torch.models.resident import rotate_resident_to_device
    from mixmogam_tpu_torch.models.streaming import rotate_streamed_to_device
    from mixmogam_tpu_torch.ops.scan import project_design

    G = data["G"].copy()
    G[7] = 1                                       # inside the intercept
    rg = ResidentGenome.from_source(G, tile=64, device="cpu")
    U = torch.linalg.qr(torch.from_numpy(
        np.random.default_rng(0).normal(size=(N, N))))[0]
    Up, X0, X0p = project_design(U, torch.ones(N, 1, dtype=torch.float64))
    a, ka = rotate_resident_to_device(rg, Up, torch.float64, (X0, X0p))
    b, kb = rotate_streamed_to_device(G, Up, torch.float64, 50, (X0, X0p),
                                      "cpu")
    torch.testing.assert_close(a, b, rtol=0, atol=1e-12)
    assert torch.equal(ka, kb) and not bool(ka[7]) and int(ka.sum()) == M - 1
    assert a.shape == (M, N)
    i, _ = rotate_resident_to_device(rg, None, torch.float64)
    np.testing.assert_array_equal(i[8].numpy(), np.where(
        G[8] < 0, G[8][G[8] >= 0].mean(), G[8]))
    # the JAX package's rotation of the same rows by the same U'
    jrg = jres.ResidentGenome.from_source(G, tile=64)
    ja = np.asarray(jres.rotate_resident_to_device(jrg, Up.numpy(),
                                                   np.float64))
    np.testing.assert_allclose(a.numpy(), ja, atol=1e-12)
