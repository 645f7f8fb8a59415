"""PyTorch port, the shared-eigenbasis multi-trait scan
(mixmogam_tpu_torch/models/multitrait.py) and run_gwas_multi(batched=True),
against the JAX package's models/multitrait.py under x64, float64 on both
sides, on the CPU.

Limits: ps atol 1e-10, f_stats and betas rtol 1e-10, identical masks,
log delta within 1e-10, the same dof. The port rotates by
U' = (I - P_X0) U where the JAX package rotates by U; at the exact tier
both give the same F in float64. At the int8 / bf16 tiers the JAX
reference quantizes U' too (jax_projected: a test-local wrapper of the JAX
package's quantize_rotation), so both take the same digit planes and
parts, and the same limits hold."""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mixmogam_tpu.models import multitrait as jmt
from mixmogam_tpu.models.resident import ResidentGenome as JResident
from mixmogam_tpu.ops import scan as jscan
from mixmogam_tpu.oracle.kinship import ibs_kinship, scale_k
from mixmogam_tpu_torch import api, convert
from mixmogam_tpu_torch.data.genotype import GenotypeData
from mixmogam_tpu_torch.data.phenotype import PhenotypeData
from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                              simulate_phenotype)
from mixmogam_tpu_torch.models import multitrait
from mixmogam_tpu_torch.models.emmax import emmax
from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                _tile_from_packed_cols)
from mixmogam_tpu_torch.ops.scan import project_design
from mixmogam_tpu_torch.parallel.mesh import Mesh

torch.set_num_threads(1)
#: a mesh with a 'sample' axis of 2 (the tensor-parallel scan, ROADMAP Queue
#: 1 item 16d), which make_mesh refuses to build
SAMPLE_AXIS_MESH = Mesh((1, 2), None, None, 0, 1, torch.device("cpu"))
N, M, T = 96, 300, 3
_FAST = ("int8x3", "bf16x3")


def _traits(G, seed, T=T):
    """T phenotypes of G with h2 spread over 0.2-0.8."""
    return np.stack([simulate_phenotype(G, h2=h, n_causal=3,
                                        seed=seed + t)[0]
                     for t, h in enumerate(np.linspace(0.2, 0.8, T))])


@pytest.fixture(scope="module")
def data():
    """Binary genotypes with 3 % missing calls, their mean-imputed
    dosages, the IBS kinship of the imputed dosages and T traits."""
    G, _, _ = simulate_genotypes(N, M, ploidy=1, missing_rate=0.03, seed=5)
    imp = G.astype(np.float64)
    imp[G < 0] = np.nan
    mu = np.nanmean(imp, axis=1)
    imp = np.where(np.isnan(imp), mu[:, None], imp)
    K = scale_k(ibs_kinship(imp))
    return {"G": G, "G8": np.where(G < 0, 0, G).astype(np.int8), "imp": imp,
            "K": K, "Y": _traits(np.where(G < 0, 0, G), 7)}


def _close(got, ref):
    """The module's limits, got (port) against ref (JAX)."""
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    np.testing.assert_allclose(got["ps"], ref["ps"], rtol=0, atol=1e-10)
    for k in ("f_stats", "betas"):
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=1e-10,
                                   atol=0)
    np.testing.assert_allclose(np.log(got["deltas"]),
                               np.log(np.asarray(ref["deltas"])), rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(got["dof"], ref["dof"])


def jax_projected(monkeypatch, X0=None):
    """Point the JAX package's quantize_rotation at U' = (I - P_X0) U (the
    port's ops/scan.py project_design, float64), as the port quantizes it;
    X0=None: the intercept of each call's own sample count."""
    orig = jscan.quantize_rotation

    def quantize(W, rotate_dtype, sd_dtype=None):
        Wt = torch.from_numpy(np.array(W, dtype=np.float64))
        X = np.ones((Wt.shape[0], 1)) if X0 is None else X0
        Up = project_design(Wt, torch.from_numpy(np.asarray(X)))[0]
        return orig(jnp.asarray(Up.numpy()), rotate_dtype, sd_dtype=sd_dtype)

    monkeypatch.setattr(importlib.import_module("mixmogam_tpu.ops.scan"),
                        "quantize_rotation", quantize)


@pytest.mark.parametrize("source", ["int8", "float", "resident"])
def test_exact_tier_matches_jax(data, source):
    """Fully observed int8 in core, fractional float dosages in core (NaN
    missing) and a ResidentGenome with missing calls."""
    if source == "int8":
        got = emmax_multi_trait(data["G8"], data["Y"], K=data["K"],
                                device="cpu")
        ref = jmt.emmax_multi_trait(data["G8"], data["Y"], K=data["K"])
    elif source == "float":
        Gf = data["imp"] * 0.97 + 0.01                # fractional dosages
        Gf[data["G"] < 0] = np.nan
        got = emmax_multi_trait(Gf, data["Y"], K=data["K"], device="cpu")
        ref = jmt.emmax_multi_trait(Gf, data["Y"], K=data["K"])
    else:
        rg = ResidentGenome.from_source(data["G"], tile=128, device="cpu")
        got = emmax_multi_trait(rg, data["Y"], K=data["K"])
        ref = jmt.emmax_multi_trait(JResident.from_source(data["G"],
                                                          tile=128),
                                    data["Y"], K=data["K"])
    assert got["ps"].shape == (T, M) and got["precision_tier"] == "exact"
    assert got["dof"] == N - 2
    _close(got, ref)


def test_each_trait_equals_single_trait_emmax(data):
    """The JAX package's test_matches_per_trait_emmax, on the port alone:
    every trait of the batch is the port's single-trait emmax."""
    G = data["G8"][:120]
    Y = np.stack([data["Y"][0], np.random.default_rng(3).normal(size=N),
                  data["Y"][2] * 0.5 + 1.0])
    mt = emmax_multi_trait(G, Y, K=data["K"], device="cpu")
    for t in range(Y.shape[0]):
        single = emmax(G, Y[t], K=data["K"], device="cpu")
        assert abs(np.log(mt["deltas"][t]) - np.log(single["delta"])) <= 1e-10
        np.testing.assert_array_equal(mt["mask"][t], single["mask"])
        np.testing.assert_allclose(mt["ps"][t], single["ps"], rtol=0,
                                   atol=1e-10)
        np.testing.assert_allclose(mt["betas"][t], single["betas"],
                                   rtol=1e-10, atol=0)


@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("tier", _FAST)
def test_fast_tiers_match_jax_and_exact(data, tier, resident, monkeypatch):
    """int8x3 and bf16x3 against JAX on U' at the module's limits, and
    against the port's exact tier: max |d -log10 p| <= 1e-4."""
    G = data["G8"]
    src = (ResidentGenome.from_source(G, tile=128, device="cpu") if resident
           else G)
    got = emmax_multi_trait(src, data["Y"], K=data["K"], precision=tier,
                            device="cpu")
    ex = emmax_multi_trait(G, data["Y"], K=data["K"], device="cpu")
    assert got["precision_tier"] == tier
    np.testing.assert_array_equal(got["mask"], ex["mask"])
    assert np.abs(np.log10(got["ps"]) - np.log10(ex["ps"])).max() <= 1e-4
    jax_projected(monkeypatch)
    jsrc = JResident.from_source(G, tile=128) if resident else G
    ref = jmt.emmax_multi_trait(jsrc, data["Y"], K=data["K"],
                                precision=tier)
    _close(got, ref)


def _missing_y(Y):
    """Two missingness patterns and one complete trait."""
    Y = np.vstack([Y, Y[:1] * 0.7])
    Y[0, [3, 17]] = np.nan
    Y[1, [3, 17]] = np.nan
    Y[2, 40] = np.nan
    return Y


@pytest.mark.parametrize("source", ["incore", "resident"])
def test_missing_phenotype_groups_match_jax(data, source):
    """Two NaN patterns and one complete trait: each group on its sample
    subset, its K sub-block and its own eigh; the genome's missing calls
    imputed with the subset's means (a ResidentGenome gathers the group's
    columns a tile at a time: _tile_from_packed_cols)."""
    Y = _missing_y(data["Y"])
    if source == "incore":
        got = emmax_multi_trait(data["G"], Y, K=data["K"], device="cpu")
        ref = jmt.emmax_multi_trait(data["G"], Y, K=data["K"])
    else:
        rg = ResidentGenome.from_source(data["G"], tile=64, device="cpu")
        got = emmax_multi_trait(rg, Y, K=data["K"])
        ref = jmt.emmax_multi_trait(JResident.from_source(data["G"],
                                                          tile=64),
                                    Y, K=data["K"])
    np.testing.assert_array_equal(got["dof"], [N - 4, N - 4, N - 3, N - 2])
    _close(got, ref)


def test_missing_phenotype_groups_at_a_fast_tier(data, monkeypatch):
    """The groups at int8x3, in core and resident, against JAX on U'."""
    Y = _missing_y(data["Y"])
    G = data["G8"]
    rg = ResidentGenome.from_source(G, tile=64, device="cpu")
    got = emmax_multi_trait(rg, Y, K=data["K"], precision="int8x3")
    np.testing.assert_array_equal(
        got["ps"], emmax_multi_trait(G, Y, K=data["K"], precision="int8x3",
                                     device="cpu")["ps"])
    jax_projected(monkeypatch)
    _close(got, jmt.emmax_multi_trait(G, Y, K=data["K"],
                                      precision="int8x3"))


def test_tile_from_packed_cols_gathers_then_leaves_missing(data):
    """The gathered raw int8 columns of a tile, -1 kept for the imputation
    that follows (its means are the subset's)."""
    rg = ResidentGenome.from_source(data["G"], tile=64, device="cpu")
    cols = torch.tensor([5, 0, 17, 95, 40])
    got = _tile_from_packed_cols(rg.packed, 64, 64, N, cols)
    np.testing.assert_array_equal(got.numpy(), data["G"][64:128][:, cols])


def test_monomorphic_snp_on_a_subset_is_masked(data):
    """A SNP that varies over all samples but not over a group's observed
    samples is masked (p = 1) for that group's traits only, in core and
    resident, as in the JAX package."""
    G = data["G8"].copy()
    Y = _missing_y(data["Y"])
    G[11] = 0
    G[11, [3, 17]] = 1                 # varies only on samples 3 and 17
    rg = ResidentGenome.from_source(G, tile=64, device="cpu")
    for src in (G, rg):
        got = emmax_multi_trait(src, Y, K=data["K"], device="cpu")
        assert not got["mask"][:2, 11].any()
        assert (got["ps"][:2, 11] == 1.0).all()
        assert got["mask"][2:, 11].all()
    _close(got, jmt.emmax_multi_trait(G, Y, K=data["K"]))


@pytest.fixture(scope="module")
def singular():
    """test_torch_fold's fixture: VanRaden's K (a zero eigenvalue along
    the intercept), n = 256, seed 3; the trait's delta sits at its lower
    bound. Two more traits: a rescaled copy and a noisier one."""
    from mixmogam_tpu_torch.ops.kinship import kinship

    G, _, _ = simulate_genotypes(256, 3_000, ploidy=1, seed=3)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=4, seed=3)
    K = scale_k(kinship(G, method="vanraden", device="cpu"))
    rng = np.random.default_rng(4)
    Y = np.stack([y, 2.0 * y + 1.0, y + rng.normal(size=256)])
    return G, Y, K, emmax_multi_trait(G, Y, K=K, device="cpu")


@pytest.mark.parametrize("tier", ["exact", "int8x3", "bf16x3"])
def test_float32_under_a_singular_kinship(singular, tier):
    """float32 against float64 with delta at its bound: identical masks,
    max |dp| <= 1e-4 at every tier."""
    G, Y, K, ref = singular
    assert ref["deltas"][0] == pytest.approx(np.exp(-10.0), rel=1e-6)
    got = emmax_multi_trait(G, Y, K=K, precision=tier, device="cpu",
                            dtype=torch.float32)
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    assert np.abs(got["ps"] - ref["ps"]).max() <= 1e-4


def test_trait_nulls_carry_over_from_jax(data):
    """JAX's _trait_nulls through convert.trait_nulls_from_numpy: the
    port's per-trait scan of a rotated tile gives JAX's
    _scan_tile_multitrait (atol 1e-10)."""
    G = data["imp"][:128]
    w, v = np.linalg.eigh(data["K"])
    phi, U = w[::-1].copy(), v[:, ::-1].copy()
    X0 = np.column_stack([np.ones(N), np.arange(N) % 3])
    deltas = np.array([0.3, 1.7, 12.0])
    sd, X0s, L, y_res, rss0 = jmt._trait_nulls(
        jnp.asarray(data["Y"] @ U), jnp.asarray(U.T @ X0), jnp.asarray(phi),
        jnp.asarray(deltas))
    dof = float(N - 3)
    G_rot = G @ U
    f, b, mk = jmt._scan_tile_multitrait(jnp.asarray(G_rot), sd, X0s, L,
                                         y_res, rss0, dof)
    nulls = convert.trait_nulls_from_numpy(sd, X0s, y_res, rss0, dof)
    fp, bp, mp = multitrait._scan_tile_multitrait(torch.from_numpy(G_rot),
                                                  nulls)
    assert fp.shape == (3, 128)
    np.testing.assert_array_equal(mp.numpy(), np.asarray(mk))
    np.testing.assert_allclose(fp.numpy(), np.asarray(f), rtol=0, atol=1e-10)
    np.testing.assert_allclose(bp.numpy(), np.asarray(b), rtol=0, atol=1e-10)


def test_a_tile_is_rotated_once_and_scanned_once_a_trait(data, monkeypatch):
    """The shared rotation runs once a tile, the per-trait scan (K3 on the
    card) T times a tile."""
    from mixmogam_tpu_torch.ops import scan

    calls = {"rotate": 0, "scan": 0}
    real_rot, real_scan = multitrait.rotate_tile, scan.emmax_scan_prerotated

    def rot(*a):
        calls["rotate"] += 1
        return real_rot(*a)

    def sc(*a):
        calls["scan"] += 1
        return real_scan(*a)

    monkeypatch.setattr(multitrait, "rotate_tile", rot)
    monkeypatch.setattr(scan, "emmax_scan_prerotated", sc)
    rg = ResidentGenome.from_source(data["G8"], tile=64, device="cpu")
    emmax_multi_trait(rg, data["Y"], K=data["K"], precision="int8x3")
    tiles = -(-M // 64)
    assert calls == {"rotate": tiles, "scan": T * tiles}


@pytest.mark.parametrize("kw,exc,match", [
    (dict(precision="fast"), ValueError, "no rescore pass"),
    (dict(stream_budget_bytes=1, precision="high"), ValueError,
     "in-core or resident"),
    (dict(mesh=SAMPLE_AXIS_MESH), ValueError, "make_mesh"),
    (dict(stream_budget_bytes=1, precision="int8x3"), ValueError,
     "in-core or resident"),
    (dict(precision="int8x3", fractional=True), ValueError,
     "exact integer dosages"),
    (dict(precision="int8x3", missing=True), ValueError,
     "exact integer dosages"),
    (dict(precision="int8x3", resident_missing=True), ValueError,
     "fully-observed"),
])
def test_refusals_come_before_any_eigh(data, kw, exc, match):
    """Each refusal raises before the kinship is read: K and eig_k are
    absent, which would raise later ("need K or eig_k")."""
    G = data["imp"] + 0.0
    if kw.pop("fractional", False):
        G[0, 0] = 0.5
    elif kw.pop("missing", False):
        G = data["G"]
    elif kw.pop("resident_missing", False):
        G = ResidentGenome.from_source(data["G"], tile=64, device="cpu")
    with pytest.raises(exc, match=match):
        emmax_multi_trait(G, data["Y"], device="cpu", **kw)


def test_missing_y_needs_k_and_enough_samples(data):
    Y = _missing_y(data["Y"])
    with pytest.raises(ValueError, match="explicit"):
        emmax_multi_trait(data["G8"], Y, device="cpu")
    Y[0, 4:] = np.nan
    with pytest.raises(ValueError, match="at least q\\+3"):
        emmax_multi_trait(data["G8"], Y, K=data["K"], device="cpu")


def test_default_device_is_the_card_or_an_error(data):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        emmax_multi_trait(data["G8"], data["Y"], K=data["K"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        api.run_gwas_multi("no_such.csv", "no_such_pheno.csv",
                           batched=True)


# ---------------------------------------------------------------------------
# the facade: run_gwas_multi(batched=True)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A genotype CSV (n = 110) and four traits: two complete, one with
    missing values and one phenotyped on a subset; positive values (the
    'log' transform)."""
    d = tmp_path_factory.mktemp("multi")
    n = 110
    G, ch, po = simulate_genotypes(n, 500, ploidy=1, seed=21)
    acc = [f"a{i:03d}" for i in range(n)]
    GenotypeData(G, ch, po, acc, ploidy=1).write_csv(str(d / "g.csv"))
    Y = np.exp(_traits(G, 22, T=4) / 4)
    ph = PhenotypeData()
    for t in range(4):
        keep = np.arange(n)
        if t == 2:
            keep = np.delete(keep, [5, 9, 60])
        elif t == 3:
            keep = keep[10:]
        ph.add_phenotype(t + 1, f"t{t + 1}", [acc[i] for i in keep],
                         Y[t, keep])
    ph.write_to_file(str(d / "p.csv"))
    return str(d / "g.csv"), str(d / "p.csv"), d


def test_run_gwas_multi_batched_matches_jax(files):
    """Per pid, the same p-values, betas and dof as the JAX package's
    batched facade from the same files, and the CSVs they write."""
    from mixmogam_tpu import api as japi

    g, p, d = files
    kw = dict(batched=True, min_mac=5, plots=False, transform="log")
    got = api.run_gwas_multi(g, p, out_prefix=str(d / "port"),
                             device="cpu", **kw)
    ref = japi.run_gwas_multi(g, p, out_prefix=str(d / "jax"), **kw)
    assert sorted(got) == sorted(ref) == [1, 2, 3, 4]
    for pid in got:
        a, b = got[pid]["scan"], ref[pid]["scan"]
        np.testing.assert_allclose(a["ps"], b["ps"], rtol=0, atol=1e-10)
        np.testing.assert_allclose(a["betas"], b["betas"], rtol=1e-10,
                                   atol=0)
        assert a["dof"] == b["dof"]
        assert abs(a["delta"] - b["delta"]) <= 1e-10 * b["delta"]
        assert sorted(got[pid]["files"]) == sorted(ref[pid]["files"])
        with open(got[pid]["files"]["pvals"]) as f, \
                open(ref[pid]["files"]["pvals"]) as h:
            assert f.readline() == h.readline()
    assert len({got[pid]["scan"]["dof"] for pid in got}) == 3


def test_run_gwas_multi_batched_matches_the_loop(files):
    """The complete traits: batched=True against the port's batched=False
    loop (rtol 1e-5, atol 1e-8: the JAX package's own bound,
    tests/test_review3_fixes.py)."""
    g, p, _ = files
    kw = dict(pids=[1, 2], min_mac=5, plots=False, device="cpu",
              transform="log")
    loop = api.run_gwas_multi(g, p, **kw)
    bat = api.run_gwas_multi(g, p, batched=True, **kw)
    for pid in (1, 2):
        np.testing.assert_allclose(bat[pid]["scan"]["ps"],
                                   loop[pid]["scan"]["ps"], rtol=1e-5,
                                   atol=1e-8)


def test_run_gwas_multi_batched_kinship_file(files):
    """kinship_file: the saved K (another sample order) is loaded and cut
    to the coordinated samples (oracle.prepare_k): the same scan."""
    from mixmogam_tpu_torch.data.parsers import parse_snp_data
    from mixmogam_tpu_torch.utils.caching import (cached_kinship,
                                                  save_kinship_to_file)

    g, p, d = files
    gd = parse_snp_data(g).filter_monomorphic_snps()
    order = np.random.default_rng(0).permutation(gd.num_samples)
    K = cached_kinship(gd, "ibs", device="cpu")
    kf = str(d / "k.npz")
    save_kinship_to_file(kf, K[np.ix_(order, order)],
                         [gd.accessions[i] for i in order])
    kw = dict(batched=True, pids=[1, 3], min_mac=0, plots=False,
              device="cpu")
    a = api.run_gwas_multi(g, p, kinship_file=kf, **kw)
    b = api.run_gwas_multi(g, p, **kw)
    for pid in (1, 3):
        np.testing.assert_allclose(a[pid]["scan"]["ps"], b[pid]["scan"]["ps"],
                                   rtol=0, atol=1e-12)


@pytest.mark.parametrize("kw,match", [
    (dict(method="kw"), "batched=False"),
    (dict(method="emma"), "batched=False"),
    (dict(covariate_pids=[2]), "not supported with batched=True"),
    (dict(num_steps=3), "not supported with batched=True"),
])
def test_run_gwas_multi_batched_refusals(kw, match):
    """As the JAX package refuses them, and before any file is read."""
    with pytest.raises(ValueError, match=match):
        api.run_gwas_multi("no_such.csv", "no_such_pheno.csv", batched=True,
                           device="cpu", **kw)
