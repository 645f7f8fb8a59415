"""PyTorch port, the GxE interaction scan (mixmogam_tpu_torch/models/gxe.py
and run_gwas(method='emmax_gxe')) against the JAX package's models/gxe.py
under x64, float64 on both sides, on the CPU, and against a brute-force
float64 lstsq oracle.

Limits: marginal_ps, inter_ps, joint_ps and f_inter within 1e-8 of JAX's,
identical mask and mask_inter; the oracle within 1e-8. The port rotates by
U' = (I - P_X0) U where the JAX package rotates by U (the same statistics
in exact arithmetic), and masks the degenerate rows from their unrotated
values. The fast tiers hold to exact within 1e-4 with identical masks, and
so does float32 against float64 under VanRaden's singular K with delta at
its bound: the test that shows the projected rotation is needed."""

import importlib

import numpy as np
import pytest
import torch
from scipy.stats import f as f_dist

import jax.numpy as jnp

from mixmogam_tpu import api as japi
from mixmogam_tpu_torch import api, cli, convert
from mixmogam_tpu_torch.data.genotype import GenotypeData
from mixmogam_tpu_torch.data.phenotype import PhenotypeData
from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                              simulate_phenotype)
from mixmogam_tpu_torch.models import gxe
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.ops import scan
from mixmogam_tpu_torch.oracle.kinship import (ibs_kinship, scale_k,
                                               vanraden_kinship)

jgxe = importlib.import_module("mixmogam_tpu.models.gxe")
torch.set_num_threads(1)
_P = ("marginal_ps", "inter_ps", "joint_ps")


def _data(n=120, m=200, seed=6):
    """The JAX tests' data: a planted GxE effect at SNP 7."""
    G, ch, po = simulate_genotypes(n, m, seed=seed)
    rng = np.random.default_rng(seed)
    env = rng.normal(size=n)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=10, seed=seed)
    y = y + 1.5 * G[7].astype(float) * env
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    return G, y, env, K


@pytest.fixture(scope="module")
def data():
    return _data()


def _same(got, ref, tol=1e-8):
    for k in ("mask", "mask_inter"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    for k in _P + ("f_inter",):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=0,
                                   atol=tol, err_msg=k)


def _case(name, G, y, env):
    """(G, env, X0) of one parity case."""
    rng = np.random.default_rng(11)
    if name == "binary_env":
        return G, (env > 0) * 1.0, None
    if name == "two_envs":
        return G, np.column_stack([env, (rng.normal(size=len(y)) > 0) * 1.0]
                                  ), None
    if name == "covariate":
        return G, env, np.column_stack([np.ones(len(y)),
                                        rng.normal(size=len(y))])
    if name == "missing":
        Gm = G.copy()
        Gm[rng.random(G.shape) < 0.05] = -1
        return Gm, env, None
    if name == "float":
        Gf = G.astype(np.float64)
        Gf[rng.random(G.shape) < 0.03] = np.nan
        return Gf, env, None
    return G, env, None


@pytest.mark.parametrize("case", ["continuous_env", "binary_env",
                                  "two_envs", "covariate", "missing",
                                  "float"])
def test_matches_jax(data, case):
    G, y, env, K = data
    Gc, e, X0 = _case(case, G, y, env)
    got = gxe.emmax_gxe(Gc, y, e, K=K, X0=X0, device="cpu")
    ref = jgxe.emmax_gxe(Gc, y, e, K=K, X0=X0)
    _same(got, ref)
    np.testing.assert_allclose(got["deltas"], ref["deltas"], rtol=1e-10)
    assert got["precision_tier"] == ref["precision_tier"] == "exact"
    assert got["mask_inter"].sum() > 150 * (np.ndim(e))


def _brute_force(G, y, env, K, delta):
    """Per-SNP OLS in the explicit H^(-1/2) basis at the given delta
    (tests/test_gxe.py's oracle)."""
    n = len(y)
    phi, U = np.linalg.eigh(K)
    Hinv_sqrt = (U / np.sqrt(phi + delta)) @ U.T
    X0s = Hinv_sqrt @ np.column_stack([np.ones(n), env])
    ys = Hinv_sqrt @ y

    def rss(cols):
        X = np.column_stack([X0s] + cols)
        r = ys - X @ np.linalg.lstsq(X, ys, rcond=None)[0]
        return float(r @ r)

    rss0 = rss([])
    d1, d2 = n - 3, n - 4
    out = {k: [] for k in _P}
    for j in range(G.shape[0]):
        x = G[j].astype(np.float64)
        r1 = rss([Hinv_sqrt @ x])
        r2 = rss([Hinv_sqrt @ x, Hinv_sqrt @ (x * env)])
        out["marginal_ps"].append(f_dist.sf((rss0 - r1) / (r1 / d1), 1, d1))
        out["inter_ps"].append(f_dist.sf((r1 - r2) / (r2 / d2), 1, d2))
        out["joint_ps"].append(f_dist.sf(((rss0 - r2) / 2) / (r2 / d2), 2,
                                         d2))
    return {k: np.asarray(v) for k, v in out.items()}


def test_brute_force_parity(data):
    G, y, env, K = data
    res = gxe.emmax_gxe(G, y, env, K=K, device="cpu")
    ref = _brute_force(G, y, env, K, res["delta"])
    for k, mk in (("marginal_ps", "mask"), ("inter_ps", "mask_inter"),
                  ("joint_ps", "mask_inter")):
        m = res[mk]
        np.testing.assert_allclose(res[k][m], ref[k][m], rtol=0, atol=1e-8)
    assert int(np.argmin(res["inter_ps"])) == 7
    assert res["inter_ps"][7] < 1e-6


def test_stats_match_jax_on_the_same_whitened_rows(data):
    """_gxe_stats_whitened on rows and nulls given to both: the JAX nulls
    carried over by convert.trait_nulls_from_numpy."""
    G, y, env, K = data
    rng = np.random.default_rng(2)
    n = len(y)
    B, P = rng.normal(size=(2, 50, n))
    P[3] = 2.0 * B[3]                          # a collinear product
    Q0, _ = np.linalg.qr(rng.normal(size=(n, 3)))
    y_res = rng.normal(size=n)
    y_res -= Q0 @ (Q0.T @ y_res)
    rss0, dof = float(y_res @ y_res), float(n - 4)
    ref = jgxe._gxe_stats_whitened(jnp.asarray(B), jnp.asarray(P),
                                   jnp.asarray(Q0), jnp.asarray(y_res),
                                   rss0, dof)
    null = convert.trait_nulls_from_numpy(np.ones((1, n)), Q0[None],
                                          y_res[None], np.array([rss0]),
                                          dof)[0]
    got = gxe._gxe_stats_whitened(torch.from_numpy(B), torch.from_numpy(P),
                                  null).numpy()
    for i in range(5):
        np.testing.assert_allclose(got[i], np.asarray(ref[i], np.float64),
                                   rtol=1e-10, atol=1e-12)
    assert got[4][3] == 0.0


def test_two_envs_equal_two_single_calls(data):
    G, y, env, K = data
    env2 = np.column_stack([env, (np.random.default_rng(21).normal(
        size=len(y)) > 0) * 1.0])
    res = gxe.emmax_gxe(G, y, env2, K=K, device="cpu")
    assert res["inter_ps"].shape == (2, G.shape[0])
    assert res["deltas"].shape == (2,)
    for e in range(2):
        one = gxe.emmax_gxe(G, y, env2[:, e], K=K, device="cpu")
        for k in _P + ("f_inter", "mask", "mask_inter"):
            np.testing.assert_allclose(res[k][e], one[k], rtol=0,
                                       atol=1e-10, err_msg=k)
        assert res["deltas"][e] == one["delta"]


@pytest.mark.parametrize("missing", [False, True])
def test_resident_equals_incore(missing):
    G, y, env, K = _data(n=64, m=96, seed=15)
    if missing:
        G = G.copy()
        G[np.random.default_rng(1).random(G.shape) < 0.05] = -1
    env2 = np.column_stack([env, np.random.default_rng(15).normal(size=64)])
    ref = gxe.emmax_gxe(G, y, env2, K=K, device="cpu")
    rg = ResidentGenome.from_source(G, tile=32, device="cpu")
    _same(gxe.emmax_gxe(rg, y, env2, K=K), ref, tol=1e-10)


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("tier", ["int8x3", "bf16x3"])
def test_fast_tiers_close_to_exact(data, tier, resident):
    G, y, env, K = data
    env2 = np.column_stack([env, (env > 0.3) * 1.0])
    src = ResidentGenome.from_source(G, tile=64, device="cpu") \
        if resident else G
    ref = gxe.emmax_gxe(G, y, env2, K=K, device="cpu")
    res = gxe.emmax_gxe(src, y, env2, K=K, precision=tier, device="cpu")
    assert res["precision_tier"] == tier
    for k in ("mask", "mask_inter"):
        np.testing.assert_array_equal(res[k], ref[k])
    for k in _P:
        assert np.abs(res[k] - ref[k]).max() <= 1e-4, k


@pytest.mark.parametrize("tier", ["int8x2", "bf16"])
def test_rescored_rows_equal_exact(data, tier):
    """rescore_top re-tests the leading interactions (and every one under
    the tier's cut) at the exact tier: those rows equal the exact scan."""
    G, y, env, K = data
    ref = gxe.emmax_gxe(G, y, env, K=K, device="cpu")
    res = gxe.emmax_gxe(G, y, env, K=K, precision=tier, rescore_top=20,
                        device="cpu")
    idx = res["rescored_idx"]
    assert len(idx) >= 20 and 7 in idx
    for k in _P + ("f_inter", "mask", "mask_inter"):
        np.testing.assert_allclose(res[k][idx], ref[k][idx], rtol=0,
                                   atol=1e-10, err_msg=k)


def test_fast_resolves_to_exact(data):
    """'fast' sets rescore_top = 1024, as in the JAX package, and resolves
    to the exact tier on this port, where nothing is left to rescore."""
    G, y, env, K = data
    ref = gxe.emmax_gxe(G, y, env, K=K, device="cpu")
    res = gxe.emmax_gxe(G, y, env, K=K, precision="fast", device="cpu")
    assert res["precision_tier"] == "exact" and len(res["rescored_idx"]) == 0
    _same(res, ref, tol=0.0)


def test_collinear_product_masked_per_snp(data):
    """A binary environment equal to SNP 3: x o e == x, so SNP 3's
    marginal and interaction tests are masked (p = 1) at every tier, while
    the rest scan; a singleton's product is collinear with it too."""
    G, y, env, K = data
    env_b = (env > 0).astype(np.float64)
    G = G.copy()
    G[3] = env_b.astype(G.dtype)
    G[5] = 0
    G[5, 17] = 1
    ref = jgxe.emmax_gxe(G, y, env_b, K=K)
    for tier in (None, "int8x3", "bf16x3"):
        res = gxe.emmax_gxe(G, y, env_b, K=K, precision=tier, device="cpu")
        assert not res["mask_inter"][[3, 5]].any()
        assert (res["inter_ps"][[3, 5]] == 1.0).all()
        np.testing.assert_array_equal(res["mask_inter"], ref["mask_inter"])
        assert res["mask_inter"].sum() > 150


def test_env_validation(data):
    G, y, env, K = data
    with pytest.raises(ValueError, match="full column rank"):
        gxe.emmax_gxe(G, y, np.ones_like(env), K=K, device="cpu")
    with pytest.raises(ValueError, match="complete"):
        gxe.emmax_gxe(G, y, np.r_[env[:-1], np.nan], K=K, device="cpu")
    with pytest.raises(ValueError, match="samples"):
        gxe.emmax_gxe(G, y, env[:-3], K=K, device="cpu")
    rg = ResidentGenome.from_source(G, device="cpu")
    with pytest.raises(ValueError, match="samples"):
        gxe.emmax_gxe(rg, y[:-2], env[:-2], K=K[:-2, :-2])


def test_refusals(data):
    G, y, env, K = data
    Gm = G.copy()
    Gm[0, :5] = -1
    with pytest.raises(ValueError, match="int8"):
        gxe.emmax_gxe(Gm, y, env, K=K, precision="int8x2", device="cpu")
    with pytest.raises(ValueError, match="int8"):
        gxe.emmax_gxe(ResidentGenome.from_source(Gm, device="cpu"), y, env,
                      K=K, precision="int8x3")
    with pytest.raises(ValueError, match="int8"):
        gxe.emmax_gxe(G + 0.5, y, env, K=K, precision="int8x3",
                      device="cpu")
    with pytest.raises(TypeError, match="make_mesh"):
        gxe.emmax_gxe(G, y, env, K=K, mesh=object(), device="cpu")
    # 'high' runs (tests/test_torch_high.py holds it to the JAX package)
    hi = gxe.emmax_gxe(G, y, env, K=K, precision="high", device="cpu")
    assert hi["precision_tier"] == "high"
    assert np.isfinite(hi["inter_ps"]).all()
    with pytest.raises(ValueError, match="need K or eig_k"):
        gxe.emmax_gxe(G, y, env, device="cpu")


def test_default_device_is_the_card_or_an_error(data):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    G, y, env, K = data
    with pytest.raises(RuntimeError, match='device="cpu"'):
        gxe.emmax_gxe(G, y, env, K=K)


# ---- VanRaden's K with delta at its bound (ROADMAP item 13's rule) --------

@pytest.fixture(scope="module")
def singular():
    """n = 256, M = 3,000, binary, seed 3, no noise on the phenotype:
    VanRaden's K is singular along the intercept and both environments'
    REML put delta at exp(-10). A N(0, 1) and a 0/1 environment; the
    float64 reference scan."""
    G, _, _ = simulate_genotypes(256, 3_000, ploidy=1, seed=3)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=4, seed=3)
    K = scale_k(vanraden_kinship(G.astype(np.float64), ploidy=1))
    rng = np.random.default_rng(3)
    env = np.column_stack([rng.normal(size=256),
                           (rng.random(256) < 0.5) * 1.0])
    ref = gxe.emmax_gxe(G, y, env, K=K, device="cpu")
    assert np.allclose(ref["deltas"], np.exp(-10.0), rtol=1e-6)
    return G, y, env, K, ref


def _drift(got, ref):
    nm = sum(int((got[k] != ref[k]).sum()) for k in ("mask", "mask_inter"))
    return nm, max(float(np.abs(got[k] - ref[k]).max()) for k in _P)


@pytest.mark.parametrize("tier", ["exact", "int8x3", "bf16x3"])
def test_float32_under_a_singular_kinship(singular, tier):
    """float32 against float64: identical masks, max |dp| <= 1e-4."""
    G, y, env, K, ref = singular
    got = gxe.emmax_gxe(G, y, env, K=K, dtype=torch.float32,
                        precision=tier, device="cpu")
    nm, dp = _drift(got, ref)
    assert nm == 0 and dp <= 1e-4, (nm, dp)


def test_the_unprojected_rotation_fails_there(singular, monkeypatch):
    """The JAX package's rotation by U itself (project_design made the
    identity on U) loses masks and p-values in float32 on that fixture."""
    G, y, env, K, ref = singular
    orig = scan.project_design
    monkeypatch.setattr(scan, "project_design",
                        lambda U, X0: (U,) + orig(U, X0)[1:])
    got = gxe.emmax_gxe(G, y, env, K=K, dtype=torch.float32, device="cpu")
    nm, dp = _drift(got, ref)
    assert nm > 0 and dp > 0.5, (nm, dp)


# ---- the facade and the command line ----------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A trait, a covariate missing sample 4 and an environment missing
    sample 9 (each drops its sample from the run)."""
    d = tmp_path_factory.mktemp("gxe_api")
    G, y, env, _ = _data(n=100, m=150, seed=8)
    acc = [f"s{i}" for i in range(100)]
    gd = GenotypeData(G, np.repeat([1, 2], 75), np.arange(150) * 100 + 100,
                      acc)
    g, p = str(d / "g.csv"), str(d / "p.csv")
    gd.write_csv(g)
    cov = np.random.default_rng(80).normal(size=100)
    ph = PhenotypeData.from_arrays(1, "trait", acc, y)
    ph.add_phenotype(2, "env", [a for i, a in enumerate(acc) if i != 9],
                     np.delete(env, 9))
    ph.add_phenotype(3, "cov", [a for i, a in enumerate(acc) if i != 4],
                     np.delete(cov, 4))
    ph.write_to_file(p)
    return d, g, p


def _ranked(path):
    with open(path) as f:
        head = f.readline().strip().split(",")
        rows = [line.strip().split(",") for line in f]
    return head, {(r[0], r[1]): float(r[2]) for r in rows}


@pytest.mark.parametrize("covariates", [None, [3]])
def test_run_gwas_emmax_gxe_matches_jax(files, covariates):
    d, g, p = files
    tag = "cov" if covariates else "plain"
    kw = dict(method="emmax_gxe", env_pid=2, min_mac=3, plots=False,
              covariate_pids=covariates)
    res = api.run_gwas(g, p, out_prefix=str(d / f"port_{tag}"),
                       device="cpu", **kw)
    ref = japi.run_gwas(g, p, out_prefix=str(d / f"jax_{tag}"), **kw)
    _same(res["scan"], ref["scan"])
    np.testing.assert_array_equal(res["scan"]["ps"], res["scan"]["inter_ps"])
    g2 = res["genotype"]
    assert g2.num_samples == 100 - (2 if covariates else 1)
    assert list(g2.accessions) == list(ref["genotype"].accessions)
    # the ranked CSVs: the same rows, p within 1e-8
    (ha, ra), (hb, rb) = (_ranked(r["files"]["pvals"]) for r in (res, ref))
    assert ha == hb and sorted(ra) == sorted(rb)
    np.testing.assert_allclose([ra[k] for k in sorted(ra)],
                               [rb[k] for k in sorted(rb)], rtol=0,
                               atol=1e-8)
    # the direct call on the run's own rows, y, environment and K
    ph = PhenotypeData.parse_phenotype_file(p)
    e = np.array([ph.value_dict(2)[a][0] for a in g2.accessions])
    X0 = None
    if covariates:
        c = ph.value_dict(3)
        X0 = np.column_stack([np.ones(g2.num_samples),
                              [c[a][0] for a in g2.accessions]])
    direct = gxe.emmax_gxe(g2, res["y"], e, K=api.calc_ibs_kinship(
        g2, device="cpu"), X0=X0, device="cpu")
    for k in _P:
        np.testing.assert_allclose(res["scan"][k], direct[k], rtol=0,
                                   atol=1e-12)


def test_env_pid_is_required_before_parsing():
    for fn in (api.run_gwas, api.run_gwas_multi):
        with pytest.raises(ValueError, match="env_pid"):
            fn("no_such.csv", "no_such_pheno.csv", method="emmax_gxe",
               device="cpu")


def test_cli_run_emmax_gxe(files, capsys):
    import json

    d, g, p = files
    out = str(d / "cli_gxe")
    assert cli.main(["run", g, p, "--method", "emmax_gxe", "--env-pid", "2",
                     "--min-mac", "3", "--no-plots", "-o", out, "--device",
                     "cpu"]) == 0
    assert "min p" in capsys.readouterr().out
    with open(out + ".summary.json") as f:
        s = json.load(f)
    assert s["method"] == "emmax_gxe" and "delta" in s


def test_lazy_exports():
    import mixmogam_tpu_torch

    assert mixmogam_tpu_torch.emmax_gxe is api.emmax_gxe is gxe.emmax_gxe
