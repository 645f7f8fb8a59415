"""PyTorch port, ResidentGenome.from_source's packed cache (cache_path=,
trust_cache=): the JAX package's tests of the cache
(tests/test_resident.py TestPackedCache) on the port, and a cache written
by either package loaded by the other, bit-equal."""

import json
import os

import numpy as np
import pytest
import torch

from mixmogam_tpu.data import simulate as jsim
from mixmogam_tpu.models import resident as jres
from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                emmax_resident,
                                                kinship_resident, scale_k)

torch.set_num_threads(1)


def _data(seed, n=48, m=200, missing=0.0, ploidy=1):
    G, _, _ = jsim.simulate_genotypes(n, m, ploidy=ploidy,
                                      missing_rate=missing, seed=seed)
    y = np.random.default_rng(seed).normal(size=n)
    return G, y


def _from_source(G, cp, **kw):
    return ResidentGenome.from_source(G, cache_path=cp, device="cpu", **kw)


def _mtimes(cp):
    return os.stat(cp).st_mtime_ns, os.stat(cp + ".json").st_mtime_ns


def test_round_trip(tmp_path):
    G, _ = _data(40, m=200, missing=0.03)
    cp = str(tmp_path / "packed.bin")
    a = _from_source(G, cp, tile=64)
    assert os.path.exists(cp) and os.path.exists(cp + ".json")
    with open(cp + ".json") as f:
        meta = json.load(f)
    assert meta == {"M": 200, "n": 48, "ploidy": a.ploidy, "tile": 64,
                    "has_missing": True, "src_hash": meta["src_hash"]}
    assert len(meta["src_hash"]) == 16
    np.testing.assert_array_equal(np.load(cp), a.host_packed)
    b = _from_source(None, cp, tile=64)
    assert (b.M, b.n, b.ploidy, b.has_missing, b.tile) == \
        (a.M, a.n, a.ploidy, a.has_missing, a.tile)
    assert torch.equal(b.packed, a.packed)
    np.testing.assert_array_equal(b[0:200], G)


def test_npy_suffix_is_kept(tmp_path):
    G, _ = _data(47, m=70)
    cp = str(tmp_path / "rows.npy")
    a = _from_source(G, cp, tile=32)
    assert sorted(os.listdir(tmp_path)) == ["rows.npy", "rows.npy.json"]
    assert torch.equal(_from_source(None, cp, tile=32).packed, a.packed)


def test_hit_does_not_pack(tmp_path):
    G, _ = _data(48, m=150)
    cp = str(tmp_path / "p.bin")
    _from_source(G, cp, tile=64)
    before = ResidentGenome.packs
    stamp = _mtimes(cp)
    for kw in ({}, {"trust_cache": True}, {"ploidy": 1}):
        rg = _from_source(G, cp, tile=64, **kw)
        np.testing.assert_array_equal(rg[0:150], G)
    _from_source(None, cp, tile=64)
    assert ResidentGenome.packs == before and _mtimes(cp) == stamp


def test_tile_mismatch_repacks(tmp_path):
    G, _ = _data(41, n=32, m=100)
    cp = str(tmp_path / "packed.bin")
    _from_source(G, cp, tile=64)
    before = ResidentGenome.packs
    c = _from_source(G, cp, tile=32)
    assert c.tile == 32 and ResidentGenome.packs == before + 1
    np.testing.assert_array_equal(c[0:100], G)
    with open(cp + ".json") as f:
        assert json.load(f)["tile"] == 32


def test_ploidy_mismatch_repacks(tmp_path):
    G, _ = _data(49, n=32, m=100)
    cp = str(tmp_path / "packed.bin")
    assert _from_source(G, cp, tile=64).ploidy == 1
    before = ResidentGenome.packs
    assert _from_source(G, cp, tile=64, ploidy=2).ploidy == 2
    assert ResidentGenome.packs == before + 1


def test_same_shape_other_content_repacks(tmp_path):
    G1, _ = _data(42, n=32, m=128)
    G2, _ = _data(43, n=32, m=128)
    assert G1.shape == G2.shape and not np.array_equal(G1, G2)
    cp = str(tmp_path / "p.bin")
    _from_source(G1, cp, tile=64)
    before = ResidentGenome.packs
    rg2 = _from_source(G2, cp, tile=64)
    assert ResidentGenome.packs == before + 1
    np.testing.assert_array_equal(rg2[0:128], G2)
    np.testing.assert_array_equal(_from_source(None, cp, tile=64)[0:128],
                                  G2)


def test_trust_cache_skips_the_content_check(tmp_path):
    G1, _ = _data(44, n=32, m=128)
    G2, _ = _data(45, n=32, m=128)
    cp = str(tmp_path / "p.bin")
    _from_source(G1, cp, tile=64)
    before = ResidentGenome.packs
    rg2 = _from_source(G2, cp, tile=64, trust_cache=True)
    # the cached rows come back by design: shape, tile and ploidy only
    np.testing.assert_array_equal(rg2[0:128], G1)
    assert ResidentGenome.packs == before
    G3, _ = _data(46, n=32, m=100)
    rg3 = _from_source(G3, cp, tile=64, trust_cache=True)
    np.testing.assert_array_equal(rg3[0:100], G3)       # other shape


def test_missing_src_hash_repacks(tmp_path):
    G, _ = _data(46, n=32, m=128)
    cp = str(tmp_path / "p.bin")
    _from_source(G, cp, tile=64)
    with open(cp + ".json") as f:
        meta = json.load(f)
    meta.pop("src_hash")
    with open(cp + ".json", "w") as f:
        json.dump(meta, f)
    rg = _from_source(G, cp, tile=64)
    np.testing.assert_array_equal(rg[0:128], G)
    with open(cp + ".json") as f:
        assert "src_hash" in json.load(f)
    np.testing.assert_array_equal(_from_source(None, cp, tile=64)[0:128],
                                  G)


def test_none_raises_with_the_reason(tmp_path):
    G, _ = _data(50, n=32, m=100)
    cp = str(tmp_path / "p.bin")
    with pytest.raises(ValueError, match="missing or has no .json"):
        _from_source(None, cp, tile=64)
    _from_source(G, cp, tile=64)
    with pytest.raises(ValueError, match="does not match the request"):
        _from_source(None, cp, tile=32)
    with pytest.raises(ValueError, match="does not match the request"):
        _from_source(None, cp, tile=64, ploidy=2)
    os.remove(cp + ".json")
    with pytest.raises(ValueError, match="missing or has no .json"):
        _from_source(None, cp, tile=64)


def test_rewrite_drops_the_sidecar_first(tmp_path, monkeypatch):
    """A rewrite that stops while the rows are written leaves no sidecar,
    so the half-written rows are never loaded or reused."""
    G1, _ = _data(54, n=32, m=128)
    G2, _ = _data(55, n=32, m=128)
    cp = str(tmp_path / "p.bin")
    _from_source(G1, cp, tile=64)

    def stop(*a, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(np, "save", stop)
    with pytest.raises(OSError, match="disk full"):
        _from_source(G2, cp, tile=64)
    monkeypatch.undo()
    assert not os.path.exists(cp + ".json")
    with pytest.raises(ValueError, match="missing or has no .json"):
        _from_source(None, cp, tile=64)
    np.testing.assert_array_equal(_from_source(G1, cp, tile=64)[0:128], G1)


def test_no_cache_path_writes_nothing(tmp_path):
    G, _ = _data(51, n=20, m=50)
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        ResidentGenome.from_source(G, tile=32, device="cpu")
    finally:
        os.chdir(cwd)
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("missing,ploidy", [(0.0, 1), (0.04, 2)])
def test_jax_cache_loads_in_the_port(tmp_path, missing, ploidy):
    G, y = _data(52, n=44, m=300, missing=missing, ploidy=ploidy)
    cp = str(tmp_path / "jax.bin")
    jrg = jres.ResidentGenome.from_source(G, tile=64, cache_path=cp)
    stamp = _mtimes(cp)
    before = ResidentGenome.packs
    hits = [_from_source(G, cp, tile=64), _from_source(None, cp, tile=64),
            _from_source(G, cp, tile=64, trust_cache=True)]
    assert ResidentGenome.packs == before and _mtimes(cp) == stamp
    plain = ResidentGenome.from_source(G, tile=64, device="cpu")
    for rg in hits:
        np.testing.assert_array_equal(rg.host_packed, jrg.host_packed)
        assert torch.equal(rg.packed, plain.packed)
        assert (rg.M, rg.n, rg.ploidy, rg.has_missing) == (
            jrg.M, jrg.n, jrg.ploidy, jrg.has_missing)
        assert rg.content_key() == jrg.content_key()
    K = scale_k(kinship_resident(plain))
    ref = emmax_resident(plain, y, K=K)
    got = emmax_resident(hits[1], y, K=K)
    assert np.abs(got["ps"] - ref["ps"]).max() <= 1e-12
    np.testing.assert_array_equal(got["mask"], ref["mask"])


@pytest.mark.parametrize("missing,ploidy", [(0.0, 1), (0.04, 2)])
def test_port_cache_loads_in_jax(tmp_path, missing, ploidy):
    G, _ = _data(53, n=45, m=260, missing=missing, ploidy=ploidy)
    cp = str(tmp_path / "port.bin")
    rg = _from_source(G, cp, tile=64)
    stamp = _mtimes(cp)
    for src in (None, G):
        jrg = jres.ResidentGenome.from_source(src, tile=64, cache_path=cp)
        np.testing.assert_array_equal(np.asarray(jrg.packed),
                                      rg.host_packed)
        assert (jrg.M, jrg.n, jrg.ploidy, jrg.has_missing) == (
            rg.M, rg.n, rg.ploidy, rg.has_missing)
    # the JAX package validated the port's src_hash: no rewrite
    assert _mtimes(cp) == stamp
    ref = jres.ResidentGenome.from_source(G, tile=64,
                                          cache_path=str(tmp_path / "j"))
    with open(str(tmp_path / "j.json")) as f, open(cp + ".json") as g:
        assert json.load(f) == json.load(g)
    np.testing.assert_array_equal(np.load(str(tmp_path / "j")),
                                  np.load(cp))
    np.testing.assert_array_equal(ref.host_packed, rg.host_packed)
