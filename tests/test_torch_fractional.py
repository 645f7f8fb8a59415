"""PyTorch port, imputed (fractional) dosages with NaN missing calls: the
bf16 tiers' float route in core and streamed (ops/rotate.py: the tile cast
to bf16, rotated by the bf16 parts of the exact tier's U' = (I - P_X0) U,
then kernel K3's plain version) and LOCO's host route (float kinships,
each chromosome's rows scanned in core), against the JAX package under
x64 on the CPU.

The float route's reference is the JAX package's computation on the same
operand: its emmax_multi_trait at one trait, whose shared rotation is the
same product (bf16 dosages times the parts of U, whitened after it), with
its quantize_rotation pointed at U' as the port quantizes it
(test_torch_multitrait.py::jax_projected). There the limit is 1e-10 in p
at every bf16 tier. JAX's own emmax quantizes W = U * sd instead, other
roundings of the same tier: the port's bf16x3 lies within 1e-6 of it.

Limits, as stated at each test: p 1e-10 against the same operand, masks
equal; LOCO's K 1e-10 and p 1e-10 (exact tier); the bf16 tiers within
ops/scan.py::FRACTIONAL_P_DRIFT of the port's exact tier."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixmogam_tpu.models import loco as jloco
from mixmogam_tpu.models import multitrait as jmt
from mixmogam_tpu.models.emmax import emmax as j_emmax
from mixmogam_tpu.ops.eigen import eigen_k as j_eigen_k
from mixmogam_tpu_torch import api
from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                              simulate_phenotype)
from mixmogam_tpu_torch.models import loco
from mixmogam_tpu_torch.models.emmax import emmax
from mixmogam_tpu_torch.models.streaming import emmax_streamed
from mixmogam_tpu_torch.ops import scan
from mixmogam_tpu_torch.ops.hopper_scan import scan_stats
from mixmogam_tpu_torch.oracle.kinship import ibs_kinship, scale_k
from test_torch_multitrait import jax_projected

torch.set_num_threads(1)

N, M = 96, 480
_CH = np.repeat([1, 2, 3], M // 3)
_BF16 = ("bf16x3", "bf16x2", "bf16")


def _imputed_form(G, seed, missing=0.01):
    """Fractional dosages g * 0.97 + 0.01 + U(-0.01, 0.01) (the imputed
    form of integer genotypes), a share `missing` of them NaN."""
    rng = np.random.default_rng(seed)
    Gf = G * 0.97 + 0.01 + rng.uniform(-0.01, 0.01, G.shape)
    Gf[rng.random(G.shape) < missing] = np.nan
    return Gf


@pytest.fixture(scope="module")
def data():
    G, _, _ = simulate_genotypes(N, M, ploidy=2, missing_rate=0.0, seed=21)
    Gf = _imputed_form(G, 21)
    y, _ = simulate_phenotype(G, h2=0.6, n_causal=4, seed=22)
    imp = np.where(np.isnan(Gf), np.nanmean(Gf, axis=1, keepdims=True), Gf)
    K = scale_k(ibs_kinship(imp))
    eig = tuple(np.asarray(a) for a in j_eigen_k(K))
    return {"G": G, "Gf": Gf, "y": y, "K": K, "eig": eig}


def _same_operand_ref(data, tier, monkeypatch):
    jax_projected(monkeypatch)
    ref = jmt.emmax_multi_trait(data["Gf"], data["y"][None],
                                eig_k=data["eig"], precision=tier)
    return {k: np.asarray(ref[k])[0] for k in ("ps", "mask", "betas")}


# ---- the cast of a fraction to bf16 --------------------------------------

def test_bf16_cast_bit_equal_to_jax():
    """Seeded fractions in [0, 2], and values a hair off a bf16 tie (where
    one rounding and two differ): the port's casts (float64 -> bf16 as
    ops/scan.py apply_rotation on the CPU; float64 -> float32 -> bf16 as a
    float32 tile on the card) give the bits of the JAX package's
    G.astype(bf16). Both packages round through float32: a direct
    float64 -> bf16 rounding differs from them on the near-tie values."""
    rng = np.random.default_rng(0)
    b = torch.from_numpy(rng.uniform(0.01, 2.0, 2000)).to(
        torch.bfloat16).double().numpy()
    e = np.frexp(b)[1]
    mid = b + np.ldexp(1.0, e - 9)            # half a bf16 ulp above b
    near = np.concatenate([mid + np.ldexp(1.0, e - 30),
                           mid - np.ldexp(1.0, e - 30)])
    x = np.concatenate([rng.uniform(0.0, 2.0, 4000), near])
    ref = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)).view(np.uint16)
    t64 = torch.from_numpy(x).to(torch.bfloat16).view(torch.uint16).numpy()
    t32 = torch.from_numpy(x).float().to(torch.bfloat16).view(
        torch.uint16).numpy()
    np.testing.assert_array_equal(t64, ref)
    np.testing.assert_array_equal(t32, ref)
    m, ex = np.frexp(near)
    once = np.ldexp(np.round(np.ldexp(m, 8)), ex - 8)
    assert (once != torch.from_numpy(near).to(
        torch.bfloat16).double().numpy()).sum() >= 1000


# ---- in core -------------------------------------------------------------

@pytest.mark.parametrize("tier", _BF16)
def test_incore_bf16_tiers_match_jax(data, tier, monkeypatch):
    """emmax in core (stream=False) at each bf16 tier: the float route,
    p within 1e-10 of the JAX package on the same operand, masks equal,
    betas within 1e-10 (relative); bf16x3 also within 1e-6 of the JAX
    package's own emmax (its W = U * sd split into parts)."""
    got = emmax(data["Gf"], data["y"], eig_k=data["eig"], precision=tier,
                stream=False, device="cpu")
    assert got["precision_tier"] == tier
    ref = _same_operand_ref(data, tier, monkeypatch)
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    np.testing.assert_allclose(got["ps"], ref["ps"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(got["betas"], ref["betas"], rtol=1e-10,
                               atol=1e-12)
    if tier == "bf16x3":
        monkeypatch.undo()
        own = j_emmax(data["Gf"], data["y"], eig_k=data["eig"],
                      precision=tier, stream=False)
        np.testing.assert_array_equal(got["mask"], own["mask"])
        np.testing.assert_allclose(got["ps"], own["ps"], rtol=0, atol=1e-6)


def test_bf16_tiers_within_their_fractional_drift(data):
    """Every bf16 tier within FRACTIONAL_P_DRIFT of the port's exact tier,
    masks equal. The dosages' own rounding to bf16 bounds every tier alike:
    bf16x3 and bf16x2 drift past TIER_P_DRIFT's integer-dosage values."""
    ex = emmax(data["Gf"], data["y"], eig_k=data["eig"], stream=False,
               device="cpu")
    for tier in _BF16:
        got = emmax(data["Gf"], data["y"], eig_k=data["eig"],
                    precision=tier, stream=False, device="cpu")
        np.testing.assert_array_equal(got["mask"], ex["mask"])
        drift = np.abs(got["ps"] - ex["ps"]).max()
        assert drift <= scan.FRACTIONAL_P_DRIFT[tier]
        if tier != "bf16":
            assert drift > scan.TIER_P_DRIFT[tier]


def test_rescore_is_threshold_complete(data):
    """bf16x3 with rescore_top: the float route's cut (FRACTIONAL_P_DRIFT)
    rescores every SNP with exact p <= 0.05 / M, and those SNPs come back
    with the exact tier's p (1e-12); the rescored set is the cut's."""
    ex = emmax(data["Gf"], data["y"], eig_k=data["eig"], stream=False,
               device="cpu")
    fast = emmax(data["Gf"], data["y"], eig_k=data["eig"], stream=False,
                 precision="bf16x3", device="cpu")
    got = emmax(data["Gf"], data["y"], eig_k=data["eig"], stream=False,
                precision="bf16x3", rescore_top=4, device="cpu")
    idx = got["rescored_idx"]
    assert set(np.flatnonzero(ex["ps"] <= 0.05 / M)) <= set(idx)
    want = scan.select_rescore_idx(fast["ps"], 4, "bf16x3", fractional=True)
    np.testing.assert_array_equal(idx, want)
    assert len(idx) > len(scan.select_rescore_idx(fast["ps"], 4, "bf16x3"))
    np.testing.assert_allclose(got["ps"][idx], ex["ps"][idx], rtol=1e-12,
                               atol=0)


def test_int8_tiers_refuse_fractions_and_integers_keep_k5(data):
    """The int8 tiers raise on fractional dosages, in core, streamed and in
    LOCO; a float source of integer dosages keeps the packed K5 route."""
    for kw in (dict(stream=False), dict(stream=True)):
        with pytest.raises(ValueError, match="integer dosages"):
            emmax(data["Gf"], data["y"], eig_k=data["eig"],
                  precision="int8x3", device="cpu", **kw)
    with pytest.raises(ValueError, match="integer dosages"):
        loco.emmax_loco(data["Gf"], data["y"], _CH, precision="int8x3",
                        device="cpu")
    ints = data["G"].astype(np.float64)
    a = emmax(ints, data["y"], eig_k=data["eig"], precision="bf16x3",
              device="cpu")
    b = emmax(data["G"], data["y"], eig_k=data["eig"], precision="bf16x3",
              device="cpu")
    np.testing.assert_array_equal(a["ps"], b["ps"])


def test_float_route_launches_k3_once_a_tile(data, monkeypatch):
    """On the CPU the float route runs K3's plain version, one call a
    tile (the wrapper counts launches on the card only)."""
    from mixmogam_tpu_torch.ops import hopper_scan

    calls = []
    real = hopper_scan.scan_stats_plain
    monkeypatch.setattr(hopper_scan, "scan_stats_plain",
                        lambda Xr, *a, **k: calls.append(Xr.shape[0])
                        or real(Xr, *a, **k))
    before = scan_stats.launches
    emmax(data["Gf"], data["y"], eig_k=data["eig"], precision="bf16x3",
          stream=False, tile=200, device="cpu")
    assert calls == [200, 200, 80]
    assert scan_stats.launches == before


# ---- streamed ------------------------------------------------------------

@pytest.mark.parametrize("tier", ("bf16x3", "bf16x2"))
def test_streamed_equals_incore_with_resume(data, tier, tmp_path,
                                            monkeypatch):
    """emmax_streamed at a bf16 tier: each fractional tile takes the float
    route; equal to the in-core call (1e-12) and to the JAX package on the
    same operand (1e-10). A run that lost half its tiles restores the rest
    from the checkpoint and gives the same bits."""
    ck = str(tmp_path / "ck")
    full = emmax_streamed(data["Gf"], data["y"], eig_k=data["eig"], tile=64,
                          precision=tier, checkpoint_dir=ck, device="cpu")
    incore = emmax(data["Gf"], data["y"], eig_k=data["eig"], precision=tier,
                   stream=False, device="cpu")
    np.testing.assert_array_equal(full["mask"], incore["mask"])
    np.testing.assert_allclose(full["ps"], incore["ps"], rtol=0, atol=1e-12)
    ref = _same_operand_ref(data, tier, monkeypatch)
    np.testing.assert_allclose(full["ps"], ref["ps"], rtol=0, atol=1e-10)
    tiles = sorted(f for f in os.listdir(ck) if f.startswith("tile_"))
    assert len(tiles) == full["stream_stats"]["tiles"] == 8
    for f in tiles[::2]:
        os.remove(os.path.join(ck, f))
    again = emmax_streamed(data["Gf"], data["y"], eig_k=data["eig"], tile=64,
                           precision=tier, checkpoint_dir=ck, device="cpu")
    assert again["stream_stats"]["restored"] == 4
    assert again["stream_stats"]["scanned"] == 4
    for k in ("ps", "betas", "mask"):
        np.testing.assert_array_equal(again[k], full[k])


def test_streamed_mixed_tiles_within_drift_of_exact(data):
    """A float source whose tiles are mixed: tiles of integer dosages go to
    K5 packed (their rows equal the int8 source's call bit for bit),
    fractional tiles take the float route (their rows equal the in-core
    float route's); the whole within FRACTIONAL_P_DRIFT['bf16x3'] of the
    exact tier, masks equal."""
    mixed = data["Gf"].copy()
    ints = data["G"].astype(np.float64)
    mixed[:64] = ints[:64]                       # tile 0: integer dosages
    mixed[256:320] = ints[256:320]               # tile 4
    kw = dict(eig_k=data["eig"], tile=64, precision="bf16x3", device="cpu")
    got = emmax_streamed(mixed, data["y"], **kw)
    packed = emmax_streamed(data["G"], data["y"], **kw)
    flt = emmax(mixed, data["y"], eig_k=data["eig"], precision="bf16x3",
                stream=False, device="cpu")
    rows_i = np.r_[0:64, 256:320]
    rows_f = np.setdiff1d(np.arange(M), rows_i)
    np.testing.assert_array_equal(got["ps"][rows_i], packed["ps"][rows_i])
    np.testing.assert_allclose(got["ps"][rows_f], flt["ps"][rows_f], rtol=0,
                               atol=1e-12)
    ex = emmax(mixed, data["y"], eig_k=data["eig"], stream=False,
               device="cpu")
    np.testing.assert_array_equal(got["mask"], ex["mask"])
    assert (np.abs(got["ps"] - ex["ps"]).max()
            <= scan.FRACTIONAL_P_DRIFT["bf16x3"])


# ---- LOCO ----------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_impute_chunk_of_fractions_bit_equal_to_jax(dtype):
    """ops/kinship.py::_impute_chunk on fractional dosages with NaN (an
    all-missing row among them), in blocks of rows: the JAX package's
    values, bit for bit, in float32 and float64."""
    from mixmogam_tpu.ops.kinship import _impute_chunk as j_impute_chunk
    from mixmogam_tpu_torch.ops.kinship import _impute_chunk

    G, _, _ = simulate_genotypes(1_000, 300, ploidy=2, seed=7)
    C = _imputed_form(G, 7, 0.03).astype(dtype)
    C[5] = np.nan
    for dt in (np.float32, np.float64, "float64"):
        got = _impute_chunk(C, dt)
        assert got.dtype == np.dtype(dt)
        np.testing.assert_array_equal(got, j_impute_chunk(C, dt))


def test_vanraden_den_copy():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 3, (9000, 20)).astype(np.float64) * 0.97
    rows[rng.random(rows.shape) < 0.05] = np.nan
    for ploidy in (1, 2):
        assert (loco._vanraden_den(rows, ploidy)
                == jloco._vanraden_den(rows, ploidy))
    r8 = rng.integers(-1, 3, (100, 20)).astype(np.int8)
    assert loco._vanraden_den(r8, 2) == jloco._vanraden_den(r8, 2)


@pytest.mark.parametrize("method,ploidy,missing", [
    ("ibs", 2, 0.02), ("vanraden", 2, 0.02), ("ibs", 1, 0.02),
    ("vanraden", 1, 0.0)])
def test_loco_float_source_matches_jax(method, ploidy, missing):
    """loco_kinships and emmax_loco (exact tier) on fractional dosages with
    NaN, IBS and VanRaden, ploidy 1 and 2: K within 1e-10 and p within
    1e-10 of the JAX package (its float64 kinships), masks and the
    per-chromosome nulls equal; the port resolves the ploidy from the
    whole matrix by itself."""
    G, _, _ = simulate_genotypes(80, 450, ploidy=ploidy, missing_rate=0.0,
                                 seed=4 + ploidy)
    Gf = _imputed_form(G, 5, missing)
    ch = np.repeat([1, 2, 3], 150)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=3, seed=6)
    ks = jloco.loco_kinships(Gf, ch, method=method, ploidy=ploidy,
                             dtype=jnp.float64)
    ours = loco.loco_kinships(Gf, ch, method=method, device="cpu")
    assert set(ours) == set(ks)
    for c in ks:
        assert np.abs(ours[c] - ks[c]).max() <= 1e-10
    ref = jloco.emmax_loco(Gf, y, ch, method=method, kinships=ks)
    got = loco.emmax_loco(Gf, y, ch, method=method, device="cpu")
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    np.testing.assert_allclose(got["ps"], ref["ps"], rtol=0, atol=1e-10)
    for c in ref["loco"]:
        assert abs(got["loco"][c]["delta"] - ref["loco"][c]["delta"]) <= 1e-8


def test_loco_float_ploidy_from_the_whole_matrix():
    """A diploid fractional source with NaN whose chromosome 3 holds no
    dosage above 1: the ploidy is resolved once (2) from the whole matrix,
    NaN-aware, so every chromosome's IBS kinship is the diploid one (the
    JAX package's max over a matrix with NaN is NaN, and resolves 1; it is
    given ploidy=2 here, and its ploidy-1 kinships differ)."""
    G, _, _ = simulate_genotypes(60, 300, ploidy=2, missing_rate=0.0,
                                 seed=8)
    G[200:] = np.minimum(G[200:], 1)
    Gf = _imputed_form(G, 9, 0.02)
    ch = np.repeat([1, 2, 3], 100)
    ours = loco.loco_kinships(Gf, ch, device="cpu")
    ks = jloco.loco_kinships(Gf, ch, ploidy=2, dtype=jnp.float64)
    k1 = jloco.loco_kinships(Gf, ch, dtype=jnp.float64)
    for c in ks:
        assert np.abs(ours[c] - ks[c]).max() <= 1e-10
        assert np.abs(ours[c] - k1[c]).max() > 1e-3
    assert loco._HostRows(Gf, None, "ibs", "cpu").ploidy == 2


@pytest.mark.parametrize("tier", ("bf16x3", "bf16"))
def test_loco_float_source_at_a_bf16_tier(data, tier, tmp_path):
    """emmax_loco at a bf16 tier on fractional dosages: each chromosome's
    rows take the float route; within FRACTIONAL_P_DRIFT of LOCO's exact
    tier, masks equal; pipelined or not, the same bits; the eigen cache
    (keyed by the source's content) serves a second run."""
    ex = loco.emmax_loco(data["Gf"], data["y"], _CH, device="cpu")
    got = loco.emmax_loco(data["Gf"], data["y"], _CH, precision=tier,
                          cache_dir=str(tmp_path), device="cpu")
    np.testing.assert_array_equal(got["mask"], ex["mask"])
    assert np.abs(got["ps"] - ex["ps"]).max() <= scan.FRACTIONAL_P_DRIFT[tier]
    assert len(os.listdir(tmp_path)) == 3
    again = loco.emmax_loco(data["Gf"], data["y"], _CH, precision=tier,
                            cache_dir=str(tmp_path), pipeline_eigh=False,
                            device="cpu")
    np.testing.assert_array_equal(again["ps"], got["ps"])


# ---- the facade ----------------------------------------------------------

def _write_ds_vcf(path, Gf, ch, accessions):
    """A VCF whose only FORMAT field is DS (3 decimals, '.' missing)."""
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\t" + "\t".join(accessions) + "\n")
        for j, row in enumerate(Gf):
            toks = ["." if np.isnan(v) else f"{v:.3f}" for v in row]
            f.write(f"{ch[j]}\t{100 * j + 1}\t.\tA\tC\t.\t.\t.\tDS\t"
                    + "\t".join(toks) + "\n")


@pytest.fixture(scope="module")
def ds_files(data, tmp_path_factory):
    d = tmp_path_factory.mktemp("ds")
    acc = [f"s{i}" for i in range(N)]
    _write_ds_vcf(str(d / "g.vcf"), data["Gf"], _CH, acc)
    with open(d / "p.csv", "w") as f:
        f.write("ecotype_id,trait\n")
        f.writelines(f"{a},{float(v)!r}\n" for a, v in zip(acc, data["y"]))
    return str(d / "g.vcf"), str(d / "p.csv")


@pytest.mark.parametrize("kw", [dict(method="emmax_loco"),
                                dict(method="emmax", precision="bf16x3")])
def test_run_gwas_from_imputed_dosages(ds_files, kw):
    """run_gwas from a DS VCF (fractional dosages, NaN missing) equal to
    the direct call on the facade's filtered genotypes: emmax_loco on the
    host route, emmax at bf16x3 on the float route (the facade's own IBS
    kinship)."""
    from mixmogam_tpu_torch.ops.kinship import kinship

    res = api.run_gwas(*ds_files, data_format="vcf_ds", plots=False,
                       device="cpu", **kw)
    gd, y = res["genotype"], res["y"]
    assert np.isnan(gd.matrix).any() and not np.array_equal(
        gd.matrix[~np.isnan(gd.matrix)],
        np.round(gd.matrix[~np.isnan(gd.matrix)]))
    if kw["method"] == "emmax_loco":
        ref = loco.emmax_loco(gd, y, device="cpu")
    else:
        K = scale_k(kinship(gd, method="ibs", device="cpu"))
        ref = emmax(gd, y, K=K, precision="bf16x3", device="cpu")
        assert res["scan"]["precision_tier"] == "bf16x3"
    np.testing.assert_array_equal(res["scan"]["ps"], ref["ps"])
