"""PyTorch port, LOCO: the range gram (kernel K4's plain version) against
the Pallas triangular kernel (interpret mode) and the JAX range gram,
loco_kinships and emmax_loco against the JAX package (CPU, x64), the
pipelined eighs, the eigen cache and the numpy helpers copied from
mixmogam_tpu/models/loco.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mixmogam_tpu.models.loco as jloco
import mixmogam_tpu_torch as mt
from mixmogam_tpu.models import resident as jres
from mixmogam_tpu.ops.pallas_kinship import pallas_ibs_kinship_tri
from mixmogam_tpu.oracle.kinship import scale_k
from mixmogam_tpu_torch.convert import resident_from_packed
from mixmogam_tpu_torch.models import loco
from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                kinship_resident,
                                                kinship_resident_range)
from mixmogam_tpu_torch.ops.hopper_kinship import (
    ibs_gram_packed_plain, ibs_gram_tri_packed, ibs_gram_tri_packed_plain)

torch.set_num_threads(1)

#: three chromosomes whose boundaries cut the 32-row tiles
_SIZES = (110, 70, 120)


def _data(seed=0, n=64, ploidy=2, missing=0.0):
    rng = np.random.default_rng(seed)
    m = sum(_SIZES)
    G = rng.integers(0, ploidy + 1, (m, n)).astype(np.int8)
    if missing:
        G[rng.random((m, n)) < missing] = -1
    ch = np.repeat(np.arange(1, len(_SIZES) + 1), _SIZES)
    y = np.where(G[7] < 0, 1, G[7]).astype(float) + rng.normal(size=n)
    return G, ch, y


def _pair(G, tile=32):
    jrg = jres.ResidentGenome.from_source(G, tile=tile)
    rg = resident_from_packed(jrg.host_packed, jrg.M, jrg.n, jrg.ploidy,
                              jrg.tile, jrg.has_missing)
    return jrg, rg


@pytest.mark.parametrize("ch", [
    np.array([1, 1, 2, 2, 2, 3]), np.array(["a", "b", "b", "c"]),
    np.array([5]), np.array([], dtype=int), np.array([1, 2, 1])])
def test_chrom_ranges_copy(ch):
    try:
        ref = jloco._chrom_ranges(ch)
    except ValueError as exc:
        with pytest.raises(ValueError, match="non-contiguous"):
            loco._chrom_ranges(ch)
        assert "non-contiguous" in str(exc)
        return
    assert loco._chrom_ranges(ch) == ref


def test_eigen_cache_helpers_copy(tmp_path):
    assert (loco._eigen_cache_path(str(tmp_path), "k1")
            == jloco._eigen_cache_path(str(tmp_path), "k1"))
    phi, U = np.arange(3.0), np.eye(3)
    loco._eigen_cache_save(str(tmp_path / "a.npz"), phi, U)
    for load in (loco._eigen_cache_load, jloco._eigen_cache_load):
        p2, U2 = load(str(tmp_path / "a.npz"))
        np.testing.assert_array_equal(p2, phi)
        np.testing.assert_array_equal(U2, U)
    (tmp_path / "bad.npz").write_bytes(b"not an npz")
    assert loco._eigen_cache_load(str(tmp_path / "bad.npz")) is None
    assert loco._eigen_cache_load(str(tmp_path / "none.npz")) is None


def test_content_keys_match_jax():
    G, ch, _ = _data(1)
    jrg, rg = _pair(G)
    assert rg.content_key() == jrg.content_key()
    assert ResidentGenome.from_source(G, tile=32, device="cpu").content_key() \
        == jrg.content_key()
    assert loco._source_content_key(rg) == jloco._source_content_key(jrg)
    assert loco._source_content_key(G) == jloco._source_content_key(G)
    G2 = G.copy()
    G2[0, 0] = (G2[0, 0] + 1) % 3
    assert ResidentGenome.from_source(G2, tile=32,
                                      device="cpu").content_key() \
        != rg.content_key()


def test_slice_rows():
    G, _, _ = _data(2, missing=0.03)
    rg = ResidentGenome.from_source(G, tile=32, device="cpu")
    sub = rg.slice_rows(60, 133)
    assert (sub.M, sub.n, sub.tile, sub.has_missing) == (73, rg.n, 32, True)
    # views of the parent's rows, on the device and on the host: no copy
    assert sub.packed.shape[0] == 73
    assert sub.packed.data_ptr() == rg.packed[60].data_ptr()
    assert np.shares_memory(sub.host_packed, rg.host_packed)
    np.testing.assert_array_equal(sub[0:73], G[60:133])
    np.testing.assert_array_equal(sub[np.array([72, 0, 5])],
                                  G[60:133][[72, 0, 5]])
    np.testing.assert_array_equal(sub.packed[:73].numpy(),
                                  rg.host_packed[60:133])
    with pytest.raises(ValueError, match="invalid row range"):
        rg.slice_rows(10, 5)


@pytest.mark.parametrize("s,e", [(0, 110), (110, 180), (45, 299), (0, 300)])
def test_tri_gram_plain_vs_pallas_tri_interpret(s, e):
    """Binary genotypes (the Pallas kernel's domain): K4's plain version
    over rows [s, e) == pallas_ibs_kinship_tri on the same rows."""
    G, _, _ = _data(3, ploidy=1)
    rg = ResidentGenome.from_source(G, tile=32, device="cpu")
    S = ibs_gram_tri_packed_plain(rg.packed, rg.n, s, e, 1)
    K = pallas_ibs_kinship_tri(G[s:e], tm=64, tn=32, interpret=True)
    np.testing.assert_array_equal(S.numpy() / (e - s), K)


@pytest.mark.parametrize("ploidy", [1, 2])
def test_range_kinship_equals_jax(ploidy):
    G, _, _ = _data(4 + ploidy, ploidy=ploidy)
    jrg, rg = _pair(G)
    for s, e in ((0, 110), (110, 180), (180, 300), (17, 201)):
        Kj, dj = jres.kinship_resident_range(jrg, s, e, return_den=True)
        Kt, dt = kinship_resident_range(rg, s, e, return_den=True)
        np.testing.assert_array_equal(Kt, Kj)
        assert dt == dj == e - s
        # and K1's gram on the slice, the container K4 stands in for
        S = ibs_gram_tri_packed(rg.packed, rg.n, s, e, ploidy)
        sub = rg.slice_rows(s, e)
        np.testing.assert_array_equal(
            S.numpy(), ibs_gram_packed_plain(sub.packed, rg.n, sub.M,
                                             ploidy).numpy())


def test_range_gram_wrapper_cpu_and_refusals():
    G, _, _ = _data(6)
    rg = ResidentGenome.from_source(G, tile=32, device="cpu")
    before = ibs_gram_tri_packed.launches
    ibs_gram_tri_packed(rg.packed, rg.n, 3, 50, 2)
    assert ibs_gram_tri_packed.launches == before
    meta = torch.zeros((64, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="device"):
        ibs_gram_tri_packed(meta, 64, 0, 10, 1)
    with pytest.raises(ValueError, match="invalid row range"):
        kinship_resident_range(rg, 50, 50)
    # VanRaden over a range is ported now (it used to raise): the range
    # call equals the whole call on those rows; an unknown method raises
    Kr = kinship_resident_range(rg, 0, 50, method="vanraden")
    np.testing.assert_array_equal(
        Kr, kinship_resident(rg.slice_rows(0, 50), method="vanraden"))
    with pytest.raises(ValueError, match="unknown kinship method"):
        kinship_resident_range(rg, 0, 50, method="nope")


@pytest.mark.parametrize("ploidy", [1, 2])
def test_loco_kinships_match_jax(ploidy):
    G, ch, _ = _data(7, ploidy=ploidy)
    jrg, rg = _pair(G)
    ref = jloco.loco_kinships(jrg, ch, ploidy=ploidy)
    ours = loco.loco_kinships(rg, ch, ploidy=ploidy)
    assert set(ours) == set(ref)
    for c in ref:
        assert np.abs(ours[c] - ref[c]).max() <= 1e-12
    # the recombination identity: K1's gram over the other chromosomes
    for c, s, e in loco._chrom_ranges(ch):
        rest = ResidentGenome.from_source(G[ch != c], tile=32,
                                          ploidy=ploidy, device="cpu")
        direct = scale_k(kinship_resident(rest))
        assert np.abs(ours[c] - direct).max() <= 1e-12
    unscaled = loco.loco_kinships(G, ch, ploidy=ploidy, scale=False,
                                  device="cpu")
    ref_u = jloco.loco_kinships(G, ch, ploidy=ploidy, scale=False)
    for c in ref_u:
        np.testing.assert_allclose(unscaled[c], ref_u[c], atol=1e-12)


@pytest.mark.parametrize("precision", ["exact", "bf16x3"])
def test_emmax_loco_matches_jax(precision):
    G, ch, y = _data(8)
    jrg, rg = _pair(G)
    ref = jloco.emmax_loco(jrg, y, chromosomes=ch, precision=precision)
    res = loco.emmax_loco(rg, y, chromosomes=ch, precision=precision)
    assert res["ps"].shape == (G.shape[0],)
    np.testing.assert_allclose(res["ps"], ref["ps"], rtol=0, atol=1e-8)
    np.testing.assert_array_equal(res["mask"], ref["mask"])
    np.testing.assert_allclose(res["betas"], ref["betas"], atol=1e-8)
    assert res["dof"] == ref["dof"]
    assert set(res["loco"]) == set(ref["loco"]) == {1, 2, 3}
    for c in ref["loco"]:
        for k in ("delta", "pseudo_heritability", "ll_null"):
            assert abs(res["loco"][c][k] - ref["loco"][c][k]) <= 1e-8


def test_pipeline_matches_serial():
    G, ch, y = _data(9)
    rg = ResidentGenome.from_source(G, tile=32, device="cpu")
    a = loco.emmax_loco(rg, y, chromosomes=ch, pipeline_eigh=True)
    b = loco.emmax_loco(rg, y, chromosomes=ch, pipeline_eigh=False)
    np.testing.assert_allclose(a["ps"], b["ps"], atol=1e-12)
    ks = loco.loco_kinships(rg, ch)
    c = loco.emmax_loco(rg, y, chromosomes=ch, kinships=ks)
    np.testing.assert_allclose(c["ps"], a["ps"], atol=1e-12)


def test_sources_array_genotype_data_and_facade():
    from mixmogam_tpu.data import GenotypeData

    G, ch, y = _data(10)
    rg = ResidentGenome.from_source(G, tile=32, device="cpu")
    ref = loco.emmax_loco(rg, y, chromosomes=ch)
    gd = GenotypeData(G, ch, np.arange(G.shape[0]),
                      [f"a{i}" for i in range(G.shape[1])], ploidy=2)
    for src, kw in ((G, dict(chromosomes=ch)), (gd, {})):
        out = mt.emmax_loco(src, y, **kw, device="cpu")
        np.testing.assert_allclose(out["ps"], ref["ps"], atol=1e-12)
    assert mt.loco_kinships is loco.loco_kinships


def test_cache_hit_skips_eigh_and_gram(tmp_path, monkeypatch):
    from mixmogam_tpu_torch.models import resident as res_mod

    G, ch, y = _data(11, n=48)
    rg = ResidentGenome.from_source(G, tile=32, device="cpu")
    r1 = loco.emmax_loco(rg, y, chromosomes=ch, cache_dir=str(tmp_path))
    files = sorted(tmp_path.glob("loco_eigen_*.npz"))
    assert len(files) == len(np.unique(ch))
    calls = {"kin": 0}

    def no_eigh(*a, **k):
        raise AssertionError("eigh ran despite a full cache")

    real_kin = res_mod.kinship_resident

    def count_kin(*a, **k):
        calls["kin"] += 1
        return real_kin(*a, **k)

    monkeypatch.setattr(loco, "eigen_k_on", no_eigh)
    monkeypatch.setattr(res_mod, "kinship_resident", count_kin)
    r2 = loco.emmax_loco(rg, y, chromosomes=ch, cache_dir=str(tmp_path))
    assert calls["kin"] == 0          # total gram skipped on a full cache
    np.testing.assert_allclose(r2["ps"], r1["ps"], atol=1e-10)


def test_cache_entries_named_as_jax(tmp_path):
    """Same content key, range, method, ploidy and eigh dtype: the two
    packages write (and would reuse) the same cache entries."""
    G, ch, y = _data(12, n=48)
    jrg, rg = _pair(G)
    jloco.emmax_loco(jrg, y, chromosomes=ch, cache_dir=str(tmp_path / "j"))
    loco.emmax_loco(rg, y, chromosomes=ch, cache_dir=str(tmp_path / "t"))
    names = {p.name for p in (tmp_path / "t").glob("*.npz")}
    assert names == {p.name for p in (tmp_path / "j").glob("*.npz")}
    assert len(names) == 3


def test_explicit_kinships_cached_by_content(tmp_path, monkeypatch):
    G, ch, y = _data(13, n=48)
    ks = loco.loco_kinships(G, ch, device="cpu")
    r1 = loco.emmax_loco(G, y, chromosomes=ch, kinships=ks,
                         cache_dir=str(tmp_path), device="cpu")
    assert list(tmp_path.glob("loco_eigen_K*.npz"))

    def no_eigh(*a, **k):
        raise AssertionError("eigh ran despite a full cache")

    monkeypatch.setattr(loco, "eigen_k_on", no_eigh)
    r2 = loco.emmax_loco(G, y, chromosomes=ch, kinships=ks,
                         cache_dir=str(tmp_path), device="cpu")
    np.testing.assert_allclose(r2["ps"], r1["ps"], atol=1e-12)


def test_rescore_cut_counts_the_whole_genome():
    from mixmogam_tpu.ops import scan as jscan
    from mixmogam_tpu_torch.ops import scan

    ps = np.random.default_rng(0).uniform(size=120) ** 6
    got = scan.select_rescore_idx(ps, 5, "bf16x2", M_cut=1_000_000)
    want = np.union1d(np.argsort(ps, kind="stable")[:5], np.flatnonzero(
        ps <= jscan.rescore_p_cut(1_000_000, "bf16x2")))
    np.testing.assert_array_equal(got, want)
    G, ch, y = _data(14)
    res = loco.emmax_loco(G, y, chromosomes=ch, precision="bf16x2",
                          rescore_top=8, device="cpu")
    ex = loco.emmax_loco(G, y, chromosomes=ch, device="cpu")
    top = np.argsort(res["ps"])[:8]
    np.testing.assert_allclose(res["ps"][top], ex["ps"][top], rtol=1e-12)


@pytest.mark.parametrize("kw,exc", [
    (dict(mesh=object()), NotImplementedError),
    (dict(precision="high"), NotImplementedError),
    (dict(chromosomes=np.ones(300, int)), ValueError),
    (dict(chromosomes=np.r_[np.ones(150, int), np.full(100, 2),
                            np.ones(50, int)]), ValueError),
    (dict(chromosomes=np.ones(10, int)), ValueError)])
def test_refusals(kw, exc):
    G, ch, y = _data(15)
    kw = {"chromosomes": ch, **kw}
    with pytest.raises(exc):
        loco.emmax_loco(G, y, **kw, device="cpu")


def test_missing_genotypes_raise_until_ported():
    """Missing calls are ported (the tests below hold them to JAX);
    fractional dosages still wait for the float kinship accumulation."""
    G, ch, y = _data(16, missing=0.03)
    res = loco.emmax_loco(G, y, chromosomes=ch, device="cpu")
    assert np.isfinite(res["ps"]).all() and res["ps"].shape == (300,)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        loco.emmax_loco(np.where(G < 0, 0.5, G).astype(float), y,
                        chromosomes=ch, device="cpu")


_FLOAT_KINSHIPS = [("vanraden", 2, 0.0), ("vanraden", 1, 0.0),
                   ("ibs", 2, 0.02), ("ibs", 1, 0.02), ("vanraden", 2, 0.02)]


@pytest.mark.parametrize("method,ploidy,missing", _FLOAT_KINSHIPS)
def test_loco_float_kinships_match_jax_and_direct(method, ploidy, missing):
    """VanRaden and IBS with 2 % missing calls: K_loco against the JAX
    package's loco_kinships and against the direct kinship over the other
    chromosomes' rows (VanRaden's denominator recomputed over them), both
    to 1e-12."""
    G, ch, _ = _data(30 + ploidy, ploidy=ploidy, missing=missing)
    _, rg = _pair(G)
    # the JAX package's float kinships default to float32: ask for float64
    ref = jloco.loco_kinships(G, ch, method=method, ploidy=ploidy,
                              dtype=jnp.float64)
    ours = loco.loco_kinships(rg, ch, method=method, ploidy=ploidy)
    assert set(ours) == set(ref)
    for c, s, e in loco._chrom_ranges(ch):
        assert np.abs(ours[c] - ref[c]).max() <= 1e-12
        rest = ResidentGenome.from_source(G[ch != c], tile=32,
                                          ploidy=ploidy, device="cpu")
        direct = scale_k(kinship_resident(rest, method=method))
        assert np.abs(ours[c] - direct).max() <= 1e-12
    # a caller's whole-genome K: the denominator is recomputed from rg
    K_tot = kinship_resident(rg, method=method, ploidy=ploidy)
    again = loco.loco_kinships(rg, ch, method=method, ploidy=ploidy,
                               K_total=K_tot)
    for c in ref:
        assert np.abs(again[c] - ours[c]).max() <= 1e-12


@pytest.mark.parametrize("method,ploidy,missing", _FLOAT_KINSHIPS[::2])
def test_emmax_loco_float_kinships_match_jax(method, ploidy, missing):
    """emmax_loco with VanRaden or missing calls against the JAX package's
    (x64): p to 1e-10, identical masks, the per-chromosome nulls."""
    G, ch, y = _data(40 + ploidy, ploidy=ploidy, missing=missing)
    _, rg = _pair(G)
    ks = jloco.loco_kinships(G, ch, method=method, ploidy=ploidy,
                             dtype=jnp.float64)
    ref = jloco.emmax_loco(G, y, chromosomes=ch, method=method,
                           ploidy=ploidy, kinships=ks)
    res = loco.emmax_loco(rg, y, chromosomes=ch, method=method)
    np.testing.assert_allclose(res["ps"], ref["ps"], rtol=0, atol=1e-10)
    np.testing.assert_array_equal(res["mask"], ref["mask"])
    for c in ref["loco"]:
        for k in ("delta", "pseudo_heritability", "ll_null"):
            assert abs(res["loco"][c][k] - ref["loco"][c][k]) <= 1e-8
    # an int8 array source: the same call, packed on the CPU
    direct = loco.emmax_loco(G, y, chromosomes=ch, method=method,
                             device="cpu")
    np.testing.assert_allclose(direct["ps"], res["ps"], atol=1e-12)
