"""PyTorch port, the pieces of the sharded resident scan that run in one
process: ResidentGenome.from_source(upload=False) (packed on the host,
nothing on a device), a host-only container at the single-device entry
points (uploaded once to the device they resolve: the card, or the CPU
only when asked), models/source.py::pack_for_mesh against the JAX
package's copy, and parallel/distributed.py::shard_packed_rows' cache (its
keys, its one upload, its life with the container). The gloo worlds are
tests/test_torch_parallel.py's."""

import dataclasses
import gc
import json
import os
import weakref

import numpy as np
import pytest
import torch

from mixmogam_tpu.data import simulate as jsim
from mixmogam_tpu.models import resident as jres
from mixmogam_tpu.models import source as jsource
from mixmogam_tpu_torch import convert
from mixmogam_tpu_torch.models import resident, source
from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                emmax_resident,
                                                kinship_resident, scale_k)
from mixmogam_tpu_torch.parallel import make_mesh, shard_packed_rows
from mixmogam_tpu_torch.parallel.multihost import host_snp_range

torch.set_num_threads(1)
CPU_MESH = make_mesh(devices="cpu")


def _data(seed, n=50, m=300, missing=0.0, ploidy=1):
    G, _, _ = jsim.simulate_genotypes(n, m, ploidy=ploidy,
                                      missing_rate=missing, seed=seed)
    y = np.random.default_rng(seed).normal(size=n)
    return G, y


# ---- upload=False -------------------------------------------------------

@pytest.mark.parametrize("ploidy, missing, n, tile", [
    (1, 0.0, 50, 64), (1, 0.05, 49, 128), (2, 0.0, 51, 64),
    (2, 0.03, 48, 300)])
def test_host_rows_equal_the_device_packed_containers(ploidy, missing, n,
                                                      tile):
    """The host packer (data/pack2.py) gives the rows, pad, flags and
    content key of the packing on a device (pack_2bit_device), and counts
    in packs the same way."""
    G, _ = _data(ploidy + n, n=n, missing=missing, ploidy=ploidy)
    p0 = ResidentGenome.packs
    h = ResidentGenome.from_source(G, tile=tile, upload=False)
    d = ResidentGenome.from_source(G, tile=tile, device="cpu")
    assert ResidentGenome.packs == p0 + 2
    assert isinstance(h.packed, np.ndarray) and h.on_host
    assert h.device is None and h.packed is h.host_packed
    np.testing.assert_array_equal(h.host_packed, d.host_packed)
    assert (h.M, h.n, h.ploidy, h.tile, h.has_missing) == (
        d.M, d.n, d.ploidy, d.tile, d.has_missing)
    assert h.content_key() == d.content_key()
    assert h.nbytes_packed == d.nbytes_packed
    np.testing.assert_array_equal(h[5:40], G[5:40])
    np.testing.assert_array_equal(np.asarray(h.slice_rows(3, 9)), G[3:9])


def test_upload_false_resolves_no_device(monkeypatch):
    """upload=False never asks for a device (the card would be the
    default): it packs without one, and a device= beside it raises."""
    from mixmogam_tpu_torch import ops

    def no_device(device=None):
        raise AssertionError("from_source(upload=False) resolved a device")

    monkeypatch.setattr(ops, "resolve_device", no_device)
    G, _ = _data(3)
    rg = ResidentGenome.from_source(G, tile=64, upload=False)
    assert rg.on_host and not rg._uploads
    with pytest.raises(ValueError, match="upload=False"):
        ResidentGenome.from_source(G, upload=False, device="cpu")


def test_upload_false_refuses_what_from_source_refuses():
    G, _ = _data(4)
    bad = G.copy()
    bad[0, 0] = 3
    with pytest.raises(ValueError, match="dosages 0..2"):
        ResidentGenome.from_source(bad, upload=False)
    with pytest.raises(TypeError, match="int8"):
        ResidentGenome.from_source(G.astype(np.float64), upload=False)


def test_the_packed_cache_with_upload_false(tmp_path):
    """upload=False writes and reads the packed cache as the upload does
    (the JAX package's format: its own upload=False container loads it); a
    hit does not count in packs and stays on the host."""
    G, _ = _data(5, missing=0.02)
    cp = str(tmp_path / "packed.bin")
    p0 = ResidentGenome.packs
    a = ResidentGenome.from_source(G, tile=64, cache_path=cp, upload=False)
    assert ResidentGenome.packs == p0 + 1 and a.on_host
    with open(cp + ".json") as f:
        meta = json.load(f)
    assert (meta["M"], meta["tile"], meta["has_missing"]) == (300, 64, True)
    b = ResidentGenome.from_source(G, tile=64, cache_path=cp, upload=False)
    c = ResidentGenome.from_source(None, tile=64, cache_path=cp,
                                   upload=False)
    d = ResidentGenome.from_source(G, tile=64, cache_path=cp, device="cpu")
    assert ResidentGenome.packs == p0 + 1
    assert b.on_host and c.on_host and not d.on_host
    for rg in (b, c, d):
        np.testing.assert_array_equal(rg.host_packed, a.host_packed)
    j = jres.ResidentGenome.from_source(G, tile=64, cache_path=cp,
                                        upload=False)
    assert isinstance(j.packed, np.ndarray)
    np.testing.assert_array_equal(j.host_packed, a.host_packed)
    # a source changed under the cache repacks on the host
    G2 = G.copy()
    G2[7, 3] = 1 - max(G2[7, 3], 0)
    e = ResidentGenome.from_source(G2, tile=64, cache_path=cp, upload=False)
    assert ResidentGenome.packs == p0 + 2 and e.on_host
    np.testing.assert_array_equal(np.asarray(e), G2)
    assert os.path.exists(cp)


def test_a_jax_host_only_container_carries_across(tmp_path):
    """convert.resident_from_packed takes a JAX upload=False container
    (its packed a numpy array) as it is: a host-only port container of
    the same rows (upload=False), or one on a device."""
    G, y = _data(6, missing=0.03)
    j = jres.ResidentGenome.from_source(G, tile=64, upload=False)
    fields = (j.M, j.n, j.ploidy, j.tile, j.has_missing)
    h = convert.resident_from_packed(j.packed, *fields, upload=False)
    d = convert.resident_from_packed(j.packed, *fields)
    assert h.on_host and not d.on_host
    for rg in (h, d):
        np.testing.assert_array_equal(rg.host_packed, j.host_packed)
        assert rg.content_key() == ResidentGenome.from_source(
            G, tile=64, upload=False).content_key()
    K = scale_k(kinship_resident(d))
    a = emmax_resident(h.on_device("cpu"), y, K=K)
    b = emmax_resident(d, y, K=K)
    np.testing.assert_array_equal(a["ps"], b["ps"])


# ---- a host-only container at the single-device entry points -------------

def _entries():
    """name -> call(rg, y, K, **device kwargs) of the single-device entry
    points that take a ResidentGenome."""
    from mixmogam_tpu_torch import api
    from mixmogam_tpu_torch.models.emmax import emmax
    from mixmogam_tpu_torch.models.loco import emmax_loco, loco_kinships
    from mixmogam_tpu_torch.ops.kinship import kinship

    ch = np.repeat([1, 2], [150, 150])
    return {
        "emmax": lambda rg, y, K, **d: emmax(rg, y, K=K, **d)["ps"],
        "emmax int8x3": lambda rg, y, K, **d: emmax(
            rg, y, K=K, precision="int8x3", **d)["ps"],
        "kinship": lambda rg, y, K, **d: kinship(rg, **d),
        "emmax_loco": lambda rg, y, K, **d: emmax_loco(
            rg, y, chromosomes=ch, **d)["ps"],
        "loco_kinships": lambda rg, y, K, **d: loco_kinships(
            rg, ch, **d)[1],
        "emmax_step_wise": lambda rg, y, K, **d: api.emmax_step_wise(
            rg, y, K=K, max_steps=2, **d)["steps"][-1]["min_p"],
        "emmax_multi_trait": lambda rg, y, K, **d: api.emmax_multi_trait(
            rg, np.stack([y, -y]), K=K, **d)["ps"],
        "emma": lambda rg, y, K, **d: api.emma(rg, y, K=K, **d)["ps"],
        "linear_model": lambda rg, y, K, **d: api.linear_model(
            rg, y, **d)["ps"],
        "anova": lambda rg, y, K, **d: api.anova(rg, y, **d)["ps"],
        "emmax_gxe": lambda rg, y, K, **d: api.emmax_gxe(
            rg, y, np.arange(y.size) % 2 * 1.0, K=K, **d)["inter_ps"],
        "emmax_perm_test": lambda rg, y, K, **d: api.emmax_perm_test(
            rg, y, K=K, num_perm=4, **d)["min_ps"],
        "emmax_two_snps": lambda rg, y, K, **d: api.emmax_two_snps(
            rg, y, K=K, focal_idx=[1], **d)["cond_ps"],
    }


@pytest.fixture(scope="module")
def genome():
    G, y = _data(8)
    d = ResidentGenome.from_source(G, tile=128, device="cpu")
    return G, y, scale_k(kinship_resident(d)), d


@pytest.mark.parametrize("entry", sorted(_entries()))
def test_a_host_only_container_scans_on_the_cpu_when_asked(genome, entry):
    """device="cpu": the rows go up once (memoized on the container) and
    the call equals it on the container packed there."""
    G, y, K, d = genome
    h = ResidentGenome.from_source(G, tile=128, upload=False)
    call = _entries()[entry]
    u0 = ResidentGenome.uploads
    got = call(h, y, K, device="cpu")
    call(h, y, K, device="cpu")
    assert ResidentGenome.uploads == u0 + 1
    assert list(h._uploads) == [torch.device("cpu")]
    np.testing.assert_array_equal(got, call(d, y, K, device="cpu"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("entry", sorted(_entries()))
def test_a_host_only_container_never_scans_on_the_cpu_unasked(genome,
                                                              entry):
    """device=None resolves the card: without one the call raises and
    nothing is uploaded; the CPU is never taken quietly."""
    G, y, K, _ = genome
    h = ResidentGenome.from_source(G, tile=128, upload=False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _entries()[entry](h, y, K)
    assert not h._uploads


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("fn", [emmax_resident, kinship_resident])
def test_the_resident_functions_upload_to_the_card(genome, fn):
    G, y, K, _ = genome
    h = ResidentGenome.from_source(G, tile=128, upload=False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fn(h, y, K=K) if fn is emmax_resident else fn(h)


def test_a_device_container_ignores_device(genome):
    """A container with rows on a device scans there, as before: on_device
    returns it, whatever device is asked."""
    *_, d = genome
    assert d.on_device("meta") is d and d.on_device() is d


# ---- pack_for_mesh -------------------------------------------------------

def test_pack_for_mesh_is_the_jax_packages(monkeypatch):
    """Within the budget: the JAX copy's host-only container, row for row
    (the port reads the rank's device budget, here given one)."""
    monkeypatch.setattr(resident, "resident_budget_bytes", lambda d: 1 << 40)
    G, _ = _data(9, missing=0.02)
    got = source.pack_for_mesh(G, G.shape[1], "emmax", device="cpu")
    ref = jsource.pack_for_mesh(G, G.shape[1], "emmax")
    assert got.on_host and isinstance(ref.packed, np.ndarray)
    np.testing.assert_array_equal(got.host_packed, ref.host_packed)
    assert (got.M, got.n, got.ploidy, got.tile, got.has_missing) == (
        ref.M, ref.n, ref.ploidy, ref.tile, ref.has_missing)


@pytest.mark.parametrize("case", ["float source", "over the budget"])
def test_pack_for_mesh_refuses_as_the_jax_package(monkeypatch, case):
    G, _ = _data(10)
    if case == "float source":
        G = G.astype(np.float64)
    else:
        monkeypatch.setattr(resident, "resident_budget_bytes", lambda d: 10)
        monkeypatch.setattr(jres, "RESIDENT_BUDGET_BYTES", 10)
    with pytest.raises(ValueError) as ref:
        jsource.pack_for_mesh(G, G.shape[1], "multi-trait")
    with pytest.raises(ValueError) as got:
        source.pack_for_mesh(G, G.shape[1], "multi-trait", device="cpu")
    assert str(got.value) == str(ref.value)


def test_pack_for_mesh_has_no_budget_on_the_cpu():
    """The CPU has no packed budget (resident_budget_bytes is the card's),
    so there it refuses."""
    G, _ = _data(11)
    with pytest.raises(ValueError, match="2-bit resident budgets"):
        source.pack_for_mesh(G, G.shape[1], "emmax", device="cpu")


# ---- shard_packed_rows' cache -------------------------------------------

def test_the_shard_cache_is_keyed_and_uploads_once():
    G, _ = _data(12)
    h = ResidentGenome.from_source(G, tile=64, upload=False)
    u0 = ResidentGenome.uploads
    a = shard_packed_rows(h, CPU_MESH)
    b = shard_packed_rows(h, CPU_MESH, device="cpu")
    assert a is b and ResidentGenome.uploads == u0 + 1
    assert list(h._shards) == [(None, 0, 1, torch.device("cpu"))]
    # another (rank, world) is another key: rank 1 of 2 takes its own
    # tile-aligned rows, uploaded once more
    r1 = dataclasses.replace(CPU_MESH, shape=(2, 1), rank=1, world=2)
    c = shard_packed_rows(h, r1)
    assert c is not a and ResidentGenome.uploads == u0 + 2
    assert len(h._shards) == 2
    lo, hi = host_snp_range(h.M, 2, 1, tile=h.tile)
    assert lo % h.tile == 0 and c.M == hi - lo and c.tile == h.tile
    np.testing.assert_array_equal(c.packed.numpy(), h.host_packed[lo:])
    # a world of one holds every row, with the container's pad rows
    assert a.M == h.M and a.packed.shape == h.host_packed.shape
    np.testing.assert_array_equal(a.packed.numpy(), h.host_packed)
    assert not a.on_host and a.tile == h.tile


def test_a_shard_is_a_view_of_rows_already_on_the_device():
    """The container's rows (or its single-device upload) on the rank's
    device: the shard is a view of them, and nothing is uploaded."""
    G, _ = _data(13)
    d = ResidentGenome.from_source(G, tile=64, device="cpu")
    h = ResidentGenome.from_source(G, tile=64, upload=False)
    up = h.on_device("cpu")
    u0 = ResidentGenome.uploads
    for rg, rows in ((d, d.packed), (h, up.packed)):
        sh = shard_packed_rows(rg, CPU_MESH)
        assert sh.packed.data_ptr() == rows.data_ptr()
    assert ResidentGenome.uploads == u0


def test_the_shard_cache_dies_with_its_container():
    """The shards (and a single-device upload) are held by the container
    only: when it goes, their memory goes with it."""
    G, _ = _data(14)
    h = ResidentGenome.from_source(G, tile=64, upload=False)
    shard = weakref.ref(shard_packed_rows(h, CPU_MESH).packed)
    up = weakref.ref(h.on_device("cpu").packed)
    owner = weakref.ref(h)
    assert shard() is not None and up() is not None
    del h
    gc.collect()
    assert owner() is None and shard() is None and up() is None
