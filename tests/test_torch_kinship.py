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
from mixmogam_tpu_torch.ops.hopper_kinship import (
    ibs_gram_emulated, ibs_gram_packed, ibs_gram_packed_plain,
    ibs_gram_tri_packed_plain)
from mixmogam_tpu_torch.ops.pack2 import unpack_2bit_device

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
    rg = ResidentGenome.from_source(G, tile=128, device="cpu")
    ours = ibs_gram_packed_plain(rg.packed, n, rg.M, ploidy)
    ref = jres._ibs_resident_fused(jnp.asarray(rg.host_packed), n, 128,
                                   rg.M, ploidy)
    assert ours.dtype == torch.int32
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def test_plain_gram_equals_pallas_ibs_interpret():
    G = _genome(130, 300, 1, seed=3)
    rg = ResidentGenome.from_source(G, tile=128, device="cpu")
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
    rg = ResidentGenome.from_source(G, tile=64, device="cpu")
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
        rg = ResidentGenome.from_source(G, tile=64, device="cpu")
        S = ibs_gram_packed_plain(rg.packed, 33, 90, ploidy).numpy()
        np.testing.assert_array_equal(S, ploidy * 90 - absd)


@pytest.mark.parametrize("method,missing", [("vanraden", 0.0),
                                            ("ibs", 0.05)])
def test_not_ported_kinship_routes_raise(method, missing):
    """The two routes that used to raise NotImplementedError (VanRaden, IBS
    with missing genotypes) are ported: they run and agree with the float64
    oracle (tests/test_torch_kinship_methods.py holds them to the JAX
    package). An unknown method still raises."""
    from mixmogam_tpu import oracle

    G = _genome(20, 40, 1, missing=missing)
    rg = ResidentGenome.from_source(G, tile=64, device="cpu")
    K = kinship_resident(rg, method=method)
    Z = np.where(G < 0, np.nan, G.astype(np.float64))
    ref = (oracle.vanraden_kinship(Z, ploidy=1) if method == "vanraden"
           else oracle.ibs_kinship(Z, ploidy=1))
    assert float(np.abs(K - ref).max()) <= 1e-10
    with pytest.raises(ValueError, match="unknown kinship method"):
        kinship_resident(rg, method="nope")


def _thermometer_planes(G, ploidy):
    """(ploidy * m, n) int64: u = [g >= 1] and, for diploid dosages,
    v = [g >= 2], stacked along the SNP axis."""
    Gi = G.astype(np.int64)
    return np.concatenate([(Gi >= t).astype(np.int64)
                           for t in range(1, ploidy + 1)])


@pytest.mark.parametrize("n", [150, 153])
@pytest.mark.parametrize("ploidy", [1, 2])
def test_thermometer_gram_identity(ploidy, n):
    """What the tensor-core kernels compute: with the thermometer planes
    stacked into Z, sum_k |g_ki - g_kj| = d_i + d_j - 2 Z^T Z (d the column
    sums of Z), in integers — equal to the plain version and to the JAX
    main path's fused gram."""
    m = 300
    G = _genome(n, m, ploidy, seed=11 * ploidy + n)
    Gi = G.astype(np.int64)
    Z = _thermometer_planes(G, ploidy)
    D, d = Z.T @ Z, Z.sum(axis=0)
    absd = np.abs(Gi[:, :, None] - Gi[:, None, :]).sum(axis=0)
    np.testing.assert_array_equal(d[:, None] + d[None, :] - 2 * D, absd)
    S = ploidy * m - d[:, None] - d[None, :] + 2 * D
    rg = ResidentGenome.from_source(G, tile=128, device="cpu")
    np.testing.assert_array_equal(
        S, ibs_gram_packed_plain(rg.packed, n, m, ploidy).numpy())
    np.testing.assert_array_equal(S, np.asarray(jres._ibs_resident_fused(
        jnp.asarray(rg.host_packed), n, 128, m, ploidy)))


@pytest.mark.parametrize("n", [150, 153])
@pytest.mark.parametrize("ploidy", [1, 2])
def test_emulated_kernel_arithmetic_equals_plain_and_jax(ploidy, n):
    """ibs_gram_emulated repeats the CUDA kernels' steps (byte transpose,
    shift-and-mask unpack, planes, integer gram, epilogue, mirror): over
    all rows (K1) and over a range that cuts tiles (K4) it equals the
    plain versions and the JAX fused grams exactly."""
    m, tile = 300, 128
    G = _genome(n, m, ploidy, seed=5 * ploidy + n)
    rg = ResidentGenome.from_source(G, tile=tile, device="cpu")
    S = ibs_gram_emulated(rg.packed, n, ploidy * m, ploidy)
    assert S.dtype == torch.int32
    assert torch.equal(S, ibs_gram_packed_plain(rg.packed, n, m, ploidy))
    jp = jnp.asarray(rg.host_packed)
    np.testing.assert_array_equal(S.numpy(), np.asarray(
        jres._ibs_resident_fused(jp, n, tile, m, ploidy)))
    for s, e in ((37, 201), (0, m), (m - 1, m), (130, 131)):
        Sr = ibs_gram_emulated(rg.packed[s:e], n, ploidy * (e - s), ploidy)
        assert torch.equal(Sr, ibs_gram_tri_packed_plain(rg.packed, n, s, e,
                                                         ploidy))
        np.testing.assert_array_equal(Sr.numpy(), np.asarray(
            jres._ibs_resident_fused_range(jp, jnp.int32(s), jnp.int32(e), n,
                                           tile, ploidy)))


@pytest.mark.parametrize("n", [150, 153, 64])
def test_word_trick_equals_unpack(n):
    """The kernels' unpack: the bytes of 4 consecutive packed rows for the
    same 4 samples in one 32-bit word w (a 4 x 4 byte transpose), then
    (w >> 2s) & 0x03030303 is sample s's codes at those 4 SNPs, lowest
    byte first — the codes unpack_2bit_device gives."""
    rng = np.random.default_rng(n)
    G = rng.integers(-1, 3, (8, n)).astype(np.int8)      # -1: code 3
    rg = ResidentGenome.from_source(G, tile=8, device="cpu")
    ref = unpack_2bit_device(rg.packed, n).numpy()
    ref = np.where(ref < 0, 3, ref)
    p = rg.packed.numpy().astype(np.uint32)               # (8, rb)
    rb = p.shape[1]
    for g in range(2):
        rows = p[4 * g:4 * g + 4]
        w = rows[0] | rows[1] << 8 | rows[2] << 16 | rows[3] << 24
        for s in range(4):
            x = (w >> (2 * s)) & 0x03030303
            for b in range(4):
                cols = 4 * np.arange(rb) + s
                keep = cols < n
                np.testing.assert_array_equal(
                    ((x >> (8 * b)) & 0xFF)[keep], ref[4 * g + b, cols[keep]])
