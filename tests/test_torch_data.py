"""PyTorch port, host data helpers: the numpy copies of the JAX package's
simulator and scale_k, and the port's own 2-bit packing, each pinned to
the JAX package's function on the same inputs (exact equality)."""

import numpy as np
import pytest
import torch

from mixmogam_tpu import native
from mixmogam_tpu.data import simulate as jsim
from mixmogam_tpu.models import resident as jres
from mixmogam_tpu.oracle.kinship import scale_k as j_scale_k
from mixmogam_tpu_torch.data import simulate
from mixmogam_tpu_torch.models.resident import ResidentGenome, scale_k
from mixmogam_tpu_torch.ops.pack2 import pack_2bit_device

torch.set_num_threads(1)


@pytest.mark.parametrize("n,m,ploidy,missing", [
    (40, 300, 1, 0.0), (33, 1000, 2, 0.05), (1, 7, 1, 0.5)])
def test_simulate_genotypes_copy(n, m, ploidy, missing):
    kw = dict(ploidy=ploidy, missing_rate=missing, seed=n + m)
    for got, ref in zip(simulate.simulate_genotypes(n, m, **kw),
                        jsim.simulate_genotypes(n, m, **kw)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("with_k,missing,effect", [
    (False, 0.0, 0.0), (False, 0.05, 1.0), (True, 0.0, 0.5)])
def test_simulate_phenotype_copy(with_k, missing, effect):
    G, _, _ = jsim.simulate_genotypes(50, 400, missing_rate=missing, seed=3)
    K = None
    if with_k:
        Z = np.where(G < 0, 0, G).astype(np.float64)
        K = j_scale_k(Z.T @ Z / G.shape[0])
    kw = dict(h2=0.4, n_causal=6, causal_effect=effect, K=K, seed=9)
    y, causal = simulate.simulate_phenotype(G, **kw)
    y_ref, causal_ref = jsim.simulate_phenotype(G, **kw)
    np.testing.assert_array_equal(y, y_ref)
    np.testing.assert_array_equal(causal, causal_ref)


def test_scale_k_copy():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(30, 30))
    K = A @ A.T
    np.testing.assert_array_equal(scale_k(K), j_scale_k(K))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 150, 151, 152, 153])
def test_pack_matches_native(n):
    rng = np.random.default_rng(n)
    G = rng.integers(-1, 3, (37, n)).astype(np.int8)
    P = pack_2bit_device(torch.from_numpy(G))
    assert P.dtype == torch.uint8
    np.testing.assert_array_equal(P.numpy(), native.pack_2bit(G))


@pytest.mark.parametrize("n,missing,ploidy", [
    (64, 0.0, 1), (61, 0.03, 2), (130, 0.0, 2)])
def test_from_source_matches_jax_package(n, missing, ploidy):
    """Packed rows, flags and host decoding equal the JAX container's
    (chunked packing, a last chunk and a tile cut short)."""
    G, _, _ = jsim.simulate_genotypes(n, 301, ploidy=ploidy,
                                      missing_rate=missing, seed=n)
    jrg = jres.ResidentGenome.from_source(G, tile=64)
    rg = ResidentGenome.from_source(G, tile=64, chunk=100, device="cpu")
    np.testing.assert_array_equal(rg.host_packed, jrg.host_packed)
    np.testing.assert_array_equal(rg.packed.numpy(), jrg.host_packed)
    assert (rg.M, rg.n, rg.ploidy, rg.has_missing) == (
        jrg.M, jrg.n, jrg.ploidy, jrg.has_missing)
    idx = np.array([300, 0, 17, 17])
    np.testing.assert_array_equal(rg[idx], jrg[idx])
    np.testing.assert_array_equal(rg[5:290], G[5:290])
    np.testing.assert_array_equal(
        rg[0:301], native.unpack_2bit(jrg.host_packed[:301], n))


def test_from_source_refuses_out_of_range():
    G = np.zeros((5, 8), np.int8)
    G[2, 3] = 3
    with pytest.raises(ValueError, match="0..2"):
        ResidentGenome.from_source(G, device="cpu")
    with pytest.raises(TypeError, match="int8"):
        ResidentGenome.from_source(G.astype(np.float32), device="cpu")
