"""PyTorch port, kinship: the packed IBS gram (kernel K1's plain version)
against the JAX main path's _ibs_resident_fused, the Pallas IBS kernel
(interpret mode) and kinship_resident — integer-exact, so compared with
==."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mixmogam_tpu.models import resident as jres
from mixmogam_tpu.ops.pallas_kinship import pallas_ibs_kinship
from mixmogam_tpu_torch.convert import resident_from_packed
from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                kinship_resident)
from mixmogam_tpu_torch.ops.hopper_kinship import (ibs_gram_packed,
                                                   ibs_gram_packed_plain)

torch.set_num_threads(1)


def _genome(n, m, ploidy, seed=0, missing=0.0):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, ploidy + 1, (m, n)).astype(np.int8)
    if missing:
        G[rng.random((m, n)) < missing] = -1
    return G


@pytest.mark.parametrize("n", [150, 153])
@pytest.mark.parametrize("ploidy", [1, 2])
def test_plain_gram_equals_jax_fused(ploidy, n):
    """M % tile != 0 (zero pad rows) and n % 4 != 0 for n = 153 (code-3
    pad columns)."""
    G = _genome(n, 300, ploidy, seed=ploidy + n)
    rg = ResidentGenome.from_source(G, tile=128)
    ours = ibs_gram_packed_plain(rg.packed, n, rg.M, ploidy)
    ref = jres._ibs_resident_fused(jnp.asarray(rg.host_packed), n, 128,
                                   rg.M, ploidy)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_plain_gram_equals_pallas_ibs_interpret():
    G = _genome(130, 300, 1, seed=3)
    rg = ResidentGenome.from_source(G, tile=128)
    S = ibs_gram_packed_plain(rg.packed, 130, rg.M, 1).numpy()
    K = pallas_ibs_kinship(G, tm=128, tn=128, interpret=True)
    np.testing.assert_array_equal(S / 300.0, K)


@pytest.mark.parametrize("ploidy", [1, 2])
def test_kinship_resident_matches_jax(ploidy):
    G = _genome(97, 260, ploidy, seed=7 + ploidy)
    jrg = jres.ResidentGenome.from_source(G, tile=128)
    rg = resident_from_packed(jrg.host_packed, jrg.M, jrg.n, jrg.ploidy,
                              jrg.tile, jrg.has_missing)
    Kj, dj = jres.kinship_resident(jrg, return_den=True)
    Kt, dt = kinship_resident(rg, return_den=True)
    np.testing.assert_array_equal(Kt, Kj)
    assert dt == dj


def test_wrapper_routes_cpu_to_plain_and_counts_no_launch():
    G = _genome(40, 70, 2, seed=1)
    rg = ResidentGenome.from_source(G, tile=64)
    before = ibs_gram_packed.launches
    S = ibs_gram_packed(rg.packed, 40, rg.M, 2)
    assert ibs_gram_packed.launches == before
    np.testing.assert_array_equal(
        S.numpy(), ibs_gram_packed_plain(rg.packed, 40, rg.M, 2).numpy())


def test_wrapper_refuses_other_devices():
    packed = torch.zeros((64, 10), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="device"):
        ibs_gram_packed(packed, 40, 64, 1)


def test_abs_difference_identity():
    """The CUDA kernel accumulates ploidy*M - sum |g_i - g_j|; for dosages
    in 0..ploidy that equals the JAX formulas the plain version uses."""
    for ploidy in (1, 2):
        G = _genome(33, 90, ploidy, seed=ploidy)
        Gi = G.astype(np.int64)
        absd = np.abs(Gi[:, :, None] - Gi[:, None, :]).sum(axis=0)
        rg = ResidentGenome.from_source(G, tile=64)
        S = ibs_gram_packed_plain(rg.packed, 33, 90, ploidy).numpy()
        np.testing.assert_array_equal(S, ploidy * 90 - absd)


@pytest.mark.parametrize("method,missing", [("vanraden", 0.0),
                                            ("ibs", 0.05)])
def test_not_ported_kinship_routes_raise(method, missing):
    rg = ResidentGenome.from_source(_genome(20, 40, 1, missing=missing),
                                    tile=64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kinship_resident(rg, method=method)
