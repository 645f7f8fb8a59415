"""PyTorch port, the kinship module: kinship() and kinship_resident() for
every method and kind of source, against the JAX package's
ops.kinship.kinship under x64 (dtype float64) and against the float64
oracle, on the same genotypes. Limits: max |dK| <= 1e-10 for the float
accumulations (matmuls in another order), == 0.0 for the integer grams of
fully observed int8 genotypes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mixmogam_tpu import oracle
from mixmogam_tpu.data import genotype as jgeno
from mixmogam_tpu.data import simulate as jsim
from mixmogam_tpu.models import resident as jres
from mixmogam_tpu.ops.kinship import _impute_chunk as j_impute_chunk
from mixmogam_tpu.ops.kinship import kinship as j_kinship
from mixmogam_tpu_torch.data import genotype
from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                kinship_resident,
                                                kinship_resident_range)
from mixmogam_tpu_torch.ops import kinship as tk
from mixmogam_tpu_torch.ops.hopper_kinship import ibs_gram_packed
from mixmogam_tpu_torch.ops.kinship import kinship

torch.set_num_threads(1)
LIMIT = 1e-10


def _genome(n=57, m=700, ploidy=1, missing=0.0, seed=0):
    G, _, _ = jsim.simulate_genotypes(n, m, ploidy=ploidy,
                                      missing_rate=missing, seed=seed)
    return G


def _oracle(G, method, ploidy):
    Z = np.asarray(G, dtype=np.float64)
    if np.issubdtype(np.asarray(G).dtype, np.integer):
        Z = np.where(np.asarray(G) < 0, np.nan, Z)
    fn = oracle.ibs_kinship if method == "ibs" else oracle.vanraden_kinship
    return fn(Z, ploidy=ploidy)


def _dmax(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max())


@pytest.mark.parametrize("ploidy", [1, 2])
def test_fully_observed_int8_is_exact_and_goes_through_the_gram(ploidy):
    G = _genome(ploidy=ploidy, seed=ploidy)
    before = ibs_gram_packed.launches
    K = kinship(G, ploidy=ploidy, device="cpu")
    assert ibs_gram_packed.launches == before        # CPU: plain version
    assert _dmax(K, _oracle(G, "ibs", ploidy)) == 0.0
    assert _dmax(K, j_kinship(G, ploidy=ploidy, dtype=jnp.float64)) == 0.0
    assert K.dtype == np.float64
    rg = ResidentGenome.from_source(G, tile=256, ploidy=ploidy,
                                    device="cpu")
    np.testing.assert_array_equal(kinship(rg), K)
    np.testing.assert_array_equal(
        genotype.GenotypeData(G, np.ones(700), np.arange(700),
                              range(57), ploidy).get_ibs_kinship_matrix(
                                  device="cpu"), K)


@pytest.mark.parametrize("ploidy", [1, 2])
def test_division_on_the_device_is_the_host_division(ploidy):
    """S.double() / den on the device is bit-equal to the numpy division
    of the int32 counts (257 rows: an M that does not divide evenly)."""
    G = _genome(m=257, ploidy=ploidy, seed=3)
    rg = ResidentGenome.from_source(G, tile=64, ploidy=ploidy, device="cpu")
    S = ibs_gram_packed(rg.packed, rg.n, rg.M, ploidy).numpy()
    K, den = kinship_resident(rg, return_den=True)
    assert den == 257.0
    np.testing.assert_array_equal(
        K, S.astype(np.float64) / (257 if ploidy == 1 else 2.0 * 257))
    Kr, denr = kinship_resident_range(rg, 10, 201, return_den=True)
    sub = ResidentGenome.from_source(G[10:201], tile=64, ploidy=ploidy,
                                     device="cpu")
    np.testing.assert_array_equal(Kr, kinship_resident(sub))
    assert denr == 191.0
    assert _dmax(Kr, _oracle(G[10:201], "ibs", ploidy)) == 0.0


# fully observed IBS is the integer route, held to == 0.0 above
_FLOAT_CASES = [("ibs", 1, 0.04), ("ibs", 2, 0.04), ("vanraden", 1, 0.04),
                ("vanraden", 2, 0.04), ("vanraden", 1, 0.0),
                ("vanraden", 2, 0.0)]


@pytest.mark.parametrize("method,ploidy,missing", _FLOAT_CASES)
def test_kinship_matches_jax_and_oracle(method, ploidy, missing):
    G = _genome(ploidy=ploidy, missing=missing, seed=7 + ploidy)
    K = kinship(G, method=method, ploidy=ploidy, chunk=256, device="cpu")
    ref = j_kinship(G, method=method, ploidy=ploidy, chunk=256,
                    dtype=jnp.float64)
    assert _dmax(K, ref) <= LIMIT
    assert _dmax(K, _oracle(G, method, ploidy)) <= LIMIT
    assert K.dtype == np.float64 and np.allclose(K, K.T, atol=1e-13)
    # 'ibd' is the reference's name for VanRaden; GenotypeData delegates
    if method == "vanraden":
        np.testing.assert_array_equal(
            kinship(G, method="ibd", ploidy=ploidy, chunk=256,
                    device="cpu"), K)
        gd = genotype.GenotypeData(G, np.ones(700), np.arange(700),
                                   range(57), ploidy)
        assert _dmax(gd.get_ibd_kinship_matrix(device="cpu"), K) <= LIMIT


@pytest.mark.parametrize("method,ploidy,missing", _FLOAT_CASES)
@pytest.mark.parametrize("tile", [256, 1024])
def test_kinship_resident_matches_jax_and_oracle(method, ploidy, missing,
                                                 tile):
    """Tiles of 256 leave a ragged last tile (700 rows) whose pad rows must
    not count; a tile of 1,024 holds everything plus 324 pad rows."""
    G = _genome(ploidy=ploidy, missing=missing, seed=11 + ploidy)
    rg = ResidentGenome.from_source(G, tile=tile, ploidy=ploidy,
                                    device="cpu")
    jrg = jres.ResidentGenome.from_source(G, tile=tile, ploidy=ploidy)
    K, den = kinship_resident(rg, method=method, return_den=True)
    Kj, denj = jres.kinship_resident(jrg, method=method, dtype=jnp.float64,
                                     return_den=True)
    assert _dmax(K, Kj) <= LIMIT
    assert abs(den - denj) <= 1e-9 * abs(denj)
    assert _dmax(K, _oracle(G, method, ploidy)) <= LIMIT
    np.testing.assert_array_equal(
        kinship_resident(rg, method=method), K)
    # the in-core route and the resident one agree
    assert _dmax(kinship(G, method=method, ploidy=ploidy, device="cpu"),
                 K) <= LIMIT
    assert _dmax(kinship(rg, method=method), K) == 0.0


@pytest.mark.parametrize("method", ["ibs", "vanraden"])
@pytest.mark.parametrize("ploidy", [1, 2])
def test_kinship_resident_range_matches_jax(method, ploidy):
    G = _genome(ploidy=ploidy, missing=0.03, seed=21)
    rg = ResidentGenome.from_source(G, tile=128, ploidy=ploidy,
                                    device="cpu")
    jrg = jres.ResidentGenome.from_source(G, tile=128, ploidy=ploidy)
    K, den = kinship_resident_range(rg, 100, 533, method=method,
                                    return_den=True)
    Kj, denj = jres.kinship_resident_range(jrg, 100, 533, method=method,
                                           return_den=True)
    # the JAX range call accumulates in float32 (it takes no dtype)
    assert _dmax(K, Kj) <= 5e-5
    assert abs(den - denj) <= 1e-5 * abs(denj)
    assert _dmax(K, _oracle(G[100:533], method, ploidy)) <= LIMIT
    with pytest.raises(ValueError, match="invalid row range"):
        kinship_resident_range(rg, 5, 5, method=method)


@pytest.mark.parametrize("method", ["ibs", "vanraden"])
def test_float_dosages(method):
    """Fractional dosages with NaN missing (a VCF's DS field): the float
    route, from an array and from a DosageData."""
    rng = np.random.default_rng(5)
    D = rng.uniform(0, 2, (400, 31)).astype(np.float32)
    D[rng.random(D.shape) < 0.05] = np.nan
    K = kinship(D, method=method, ploidy=2, chunk=128, device="cpu")
    assert _dmax(K, j_kinship(D, method=method, ploidy=2, chunk=128,
                              dtype=jnp.float64)) <= LIMIT
    assert _dmax(K, _oracle(D, method, 2)) <= LIMIT
    kw = dict(chromosomes=np.ones(400), positions=np.arange(400),
              accessions=range(31), ploidy=2)
    Kd = kinship(genotype.DosageData(D, **kw), method=method, chunk=128,
                 device="cpu")
    np.testing.assert_array_equal(Kd, K)
    assert _dmax(Kd, j_kinship(jgeno.DosageData(D, **kw), method=method,
                               chunk=128, dtype=jnp.float64)) <= LIMIT


@pytest.mark.parametrize("method,ploidy,missing", [
    ("ibs", 1, 0.0), ("ibs", 2, 0.05), ("vanraden", 2, 0.05),
    ("vanraden", 1, 0.0)])
def test_use_device_false_is_the_oracle(method, ploidy, missing):
    """No device is resolved on the oracle path: it runs without a card
    and without device='cpu'."""
    G = _genome(ploidy=ploidy, missing=missing, seed=2)
    K = kinship(G, method=method, ploidy=ploidy, use_device=False)
    np.testing.assert_array_equal(K, _oracle(G, method, ploidy))
    np.testing.assert_array_equal(
        K, j_kinship(G, method=method, ploidy=ploidy, use_device=False))
    rg = ResidentGenome.from_source(G, device="cpu")
    with pytest.raises(ValueError, match="use_device=False"):
        kinship(rg, use_device=False)


def test_float32_accumulation_stays_near_float64():
    G = _genome(ploidy=2, missing=0.04, seed=4)
    for method in ("ibs", "vanraden"):
        K32 = kinship(G, method=method, ploidy=2, dtype=torch.float32,
                      device="cpu")
        assert _dmax(K32, _oracle(G, method, 2)) <= 2e-5
        rg = ResidentGenome.from_source(G, tile=256, device="cpu")
        assert _dmax(kinship_resident(rg, method=method,
                                      dtype=torch.float32),
                     _oracle(G, method, 2)) <= 2e-5


@pytest.mark.parametrize("chunk_dtype", [np.int8, np.int32, np.float32])
def test_impute_chunk_copy(chunk_dtype):
    rng = np.random.default_rng(0)
    C = rng.integers(0, 3, (20, 9)).astype(chunk_dtype)
    miss = rng.random(C.shape) < 0.2
    miss[4] = True                                     # an all-missing row
    C[miss] = np.nan if chunk_dtype == np.float32 else -1
    for dt in (np.float32, np.float64):
        got = tk._impute_chunk(C, dt)
        assert got.dtype == dt
        np.testing.assert_array_equal(got, j_impute_chunk(C, dt))


def test_refusals_and_defaults():
    G = _genome()
    with pytest.raises(ValueError, match="unknown kinship method"):
        kinship(G, method="nope", device="cpu")
    for bad in (np.float32, "float32", torch.int32):
        with pytest.raises(TypeError, match="torch floating dtype"):
            kinship(G, method="vanraden", dtype=bad, device="cpu")
    if not torch.cuda.is_available():
        for method in ("ibs", "vanraden"):
            with pytest.raises(RuntimeError, match='device="cpu"'):
                kinship(G, method=method)
    assert tk.resolve_compute_dtype(None, "cpu") == torch.float64
    assert tk.resolve_compute_dtype(None, "cuda") == torch.float32


def test_loco_still_refuses_these_kinships():
    """LOCO takes VanRaden ('ibd' too) and missing genotypes now
    (tests/test_torch_loco.py holds them to the JAX package); what it
    still refuses: fractional dosages and an unknown kinship method."""
    from mixmogam_tpu_torch.models import loco

    G = _genome(m=300, missing=0.03)
    ch = np.repeat([1, 2, 3], 100)
    y = np.random.default_rng(0).normal(size=57)
    ks = loco.loco_kinships(G, ch, device="cpu")
    assert set(ks) == {1, 2, 3}
    kv = loco.loco_kinships(np.abs(G), ch, method="ibd", device="cpu")
    assert all(np.isfinite(k).all() for k in kv.values())
    res = loco.emmax_loco(np.abs(G), y, ch, method="ibd", device="cpu")
    assert np.isfinite(res["ps"]).all()
    frac = np.where(G < 0, 0.5, G).astype(float)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        loco.loco_kinships(frac, ch, device="cpu")
    with pytest.raises(ValueError, match="unknown kinship method"):
        loco.emmax_loco(np.abs(G), y, ch, method="nope", device="cpu")
