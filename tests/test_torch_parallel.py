"""PyTorch port, parallel/'s data-parallel core (mixmogam_tpu_torch/
parallel: make_mesh, multihost, distributed_kinship, distributed_emmax,
emmax(mesh=)) and its sharded resident scan (shard_packed_rows,
distributed_emmax_resident and distributed_kinship over a ResidentGenome,
emmax(mesh=) over one, emmax_loco(mesh=)), on gloo worlds of 2 and 3 ranks
on the CPU.

One module fixture runs both worlds once: each rank is a subprocess that
pins torch to one thread, joins its group through a file:// store under
the test's directory (no port to clash under xdist), runs every case and
writes its results there. The fixture joins them with its own deadline
and fails with the ranks' stderr. The world of 3 splits the rows
unevenly, and leaves a rank with no rows on the 300-row genome (in core,
and packed at a 256-row tile); LOCO's first chromosome lies on rank 0
alone. The packed containers are host-only (from_source(upload=False)),
so each rank uploads its own shard.

Limits: kinship within 1e-12 of the port's single-device kinship and
1e-10 of the JAX package's distributed_kinship on the conftest's 8-device
mesh; EMMAX (float64, the tiers' plain versions) within 1e-10 in p of the
port's single-device emmax and of the JAX package's distributed_emmax
under x64 (its fast tiers pointed at the folded W'', test_torch_fold.
fold_jax_tiers), identical masks, also under VanRaden's singular K. The
resident scan and LOCO: within 1e-10 in p of the port's emmax_resident /
emmax_loco and of the JAX package's distributed_emmax_resident /
emmax_loco(mesh=); the integer kinship of a container bit-equal."""

import os
import pickle
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mixmogam_tpu.models.loco import emmax_loco as j_emmax_loco
from mixmogam_tpu.models.loco import loco_kinships as j_loco_kinships
from mixmogam_tpu.models.resident import ResidentGenome as JResident
from mixmogam_tpu.parallel import distributed as jdist
from mixmogam_tpu.parallel import mesh as jmesh
from mixmogam_tpu.parallel import multihost as jmultihost
from mixmogam_tpu.ops import scan as jscan
from mixmogam_tpu.oracle.kinship import vanraden_kinship
from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                              simulate_phenotype)
from mixmogam_tpu_torch.models.emma import emma
from mixmogam_tpu_torch.models.emmax import emmax, emmax_anova
from mixmogam_tpu_torch.models.gxe import emmax_gxe
from mixmogam_tpu_torch.models.linear import (anova, kruskal_wallis,
                                              linear_model)
from mixmogam_tpu_torch.models.loco import emmax_loco
from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
from mixmogam_tpu_torch.models.permutation import emmax_perm_test
from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                emmax_resident,
                                                kinship_resident, scale_k)
from mixmogam_tpu_torch.models.stepwise import emmax_step_wise
from mixmogam_tpu_torch.models.twosnp import emmax_two_snps
from mixmogam_tpu_torch.ops.kinship import kinship
from mixmogam_tpu_torch.parallel import (distributed_emmax,
                                         distributed_emmax_resident,
                                         distributed_kinship,
                                         make_global_snp_array, make_mesh)
from mixmogam_tpu_torch.parallel import distributed as tdist
from mixmogam_tpu_torch.parallel import mesh as tmesh
from mixmogam_tpu_torch.parallel.mesh import Mesh
from mixmogam_tpu_torch.parallel import multihost as tmultihost
from test_torch_fold import fold_jax_tiers

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 3)
TIERS = ("exact", "int8x3", "bf16x3")
_RB = {"exact": False, "int8x3": "int8x3", "bf16x3": "bf16x3"}
#: the packed containers' tiles: main's 700 rows split over every rank;
#: miss's 300 rows leave rank 2 of the world of 3 with none
_TILE = {"main": 128, "missing": 256}
#: LOCO's chromosomes on main's 700 rows
CHROMS = np.repeat([1, 2, 3], [250, 250, 200])


def _data():
    """main: n = 120 binary lines, M = 700; miss: 300 rows, 4 % missing
    calls; dip: diploid dosages; frac: main's imputed fractions with NaN;
    sing: the n = 256 VanRaden singular-K fixture of test_torch_fold.py
    (seed 3; delta at its bound), its kinship from all 3,000 rows and its
    scan cut to the first 2,000."""
    G, _, _ = simulate_genotypes(120, 700, ploidy=1, seed=31)
    y, _ = simulate_phenotype(G, h2=0.6, n_causal=4, seed=31)
    rng = np.random.default_rng(31)
    miss = G[:300].copy()
    miss[rng.random(miss.shape) < 0.04] = -1
    dip, _, _ = simulate_genotypes(120, 400, ploidy=2, seed=32)
    frac = G * 0.97 + rng.uniform(0.0, 0.02, G.shape)
    frac[rng.random(G.shape) < 0.01] = np.nan
    Gs, _, _ = simulate_genotypes(256, 3_000, ploidy=1, seed=3)
    ys, _ = simulate_phenotype(Gs, h2=0.5, n_causal=4, seed=3)
    K = scale_k(kinship(G, device="cpu"))
    Ks = scale_k(vanraden_kinship(Gs.astype(np.float64), ploidy=1))
    Gs = Gs[:2_000]
    return dict(G=G, y=y, K=K, miss=miss, dip=dip, frac=frac, Gs=Gs, ys=ys,
                Ks=Ks)


_WORKER = r'''
import pickle, sys
import numpy as np
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from mixmogam_tpu_torch.models.emmax import emmax
from mixmogam_tpu_torch.models.loco import emmax_loco
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.parallel import (distributed_emmax,
    distributed_emmax_resident, distributed_kinship, initialize_multihost,
    make_global_snp_array, make_mesh)
from mixmogam_tpu_torch.parallel.mesh import broadcast_from_rank0
from mixmogam_tpu_torch.parallel.multihost import host_snp_range

rank, world = {rank}, {world}
initialize_multihost("file://" + {store!r}, world, rank, device="cpu")
mesh = make_mesh(devices="cpu")
z = dict(np.load({data!r}))
res = {{"mesh": (mesh.shape, mesh.backend, mesh.rank, mesh.world)}}
# rank 0's tensors, a column-major one among them, and a scalar and a None
sent = broadcast_from_rank0(
    {{"t": torch.arange(12.0).reshape(3, 4).T, "s": 2.5, "n": None}}
    if rank == 0 else None, mesh)
res["bcast"] = (sent["t"].stride(), sent["t"].numpy(), sent["s"], sent["n"])


def run(name, fn):
    try:
        res[name] = ("ok", fn())
    except Exception as e:
        res[name] = ("raised", type(e).__name__, str(e))


run("kin_ibs", lambda: distributed_kinship(z["G"], mesh))
run("kin_missing", lambda: distributed_kinship(z["miss"], mesh))
run("kin_vanraden", lambda: distributed_kinship(z["G"], mesh,
                                                method="vanraden"))
run("kin_vanraden_dip", lambda: distributed_kinship(z["dip"], mesh,
                                                    method="vanraden"))
run("kin_diploid_ibs", lambda: distributed_kinship(z["dip"], mesh))
M = z["G"].shape[0]
lo, hi = host_snp_range(M, world, rank)
run("kin_shard", lambda: distributed_kinship(
    make_global_snp_array(z["G"][lo:hi], M, mesh), mesh))
for tier, rb in {rb!r}.items():
    run("emmax_main_" + tier, lambda: distributed_emmax(
        z["G"], z["y"], K=z["K"], mesh=mesh, rotate_in_bf16=rb))
    run("emmax_sing_" + tier, lambda: distributed_emmax(
        z["Gs"], z["ys"], K=z["Ks"], mesh=mesh, rotate_in_bf16=rb))
    run("emmax_missing_" + tier, lambda: distributed_emmax(
        z["miss"], z["y"], K=z["K"], mesh=mesh, rotate_in_bf16=rb))
run("emmax_shard", lambda: distributed_emmax(
    make_global_snp_array(z["G"][lo:hi], M, mesh), z["y"], K=z["K"],
    mesh=mesh, rotate_in_bf16="int8x3"))
run("emmax_frac_bf16x3", lambda: distributed_emmax(
    z["frac"], z["y"], K=z["K"], mesh=mesh, rotate_in_bf16="bf16x3"))
run("emmax_frac_int8x3", lambda: distributed_emmax(
    z["frac"], z["y"], K=z["K"], mesh=mesh, rotate_in_bf16="int8x3"))
run("emmax_route", lambda: emmax(z["G"], z["y"], K=z["K"], mesh=mesh,
                                 precision="bf16x3", with_betas=False))
run("emmax_sing_f32", lambda: distributed_emmax(
    z["Gs"], z["ys"], K=z["Ks"], mesh=mesh, dtype=torch.float32))

# ---- the sharded resident scan over host-only containers ----
rgs = {{f: ResidentGenome.from_source(z[g], tile=t, upload=False)
        for f, g, t in (("main", "G", {tile_main}),
                        ("missing", "miss", {tile_missing}))}}
u0 = ResidentGenome.uploads
for tier, rb in {rb!r}.items():
    run("res_main_" + tier, lambda: distributed_emmax_resident(
        rgs["main"], z["y"], K=z["K"], mesh=mesh, rotate_in_bf16=rb))
res["uploads_first"] = ResidentGenome.uploads - u0
u0 = ResidentGenome.uploads
for tier in {rb!r}:
    run("res_route_" + tier, lambda: emmax(rgs["main"], z["y"], K=z["K"],
                                           mesh=mesh, precision=tier))
run("res_as_distributed_emmax", lambda: distributed_emmax(
    rgs["main"], z["y"], K=z["K"], mesh=mesh, rotate_in_bf16="int8x3"))
run("kin_res_ibs", lambda: distributed_kinship(rgs["main"], mesh))
res["uploads_again"] = ResidentGenome.uploads - u0
res["shard_keys"] = [k[1:] for k in rgs["main"]._shards]
for tier, rb in {rb!r}.items():
    run("res_missing_" + tier, lambda: distributed_emmax_resident(
        rgs["missing"], z["y"], K=z["K"], mesh=mesh, rotate_in_bf16=rb))
res["shard_rows"] = {{f: [sh.M for sh in rg._shards.values()]
                      for f, rg in rgs.items()}}
run("kin_res_vanraden", lambda: distributed_kinship(
    rgs["main"], mesh, method="vanraden"))
run("kin_res_missing", lambda: distributed_kinship(rgs["missing"], mesh))
chroms = np.repeat([1, 2, 3], [250, 250, 200])
run("loco_resident", lambda: emmax_loco(rgs["main"], z["y"],
                                        chromosomes=chroms, mesh=mesh))
res["uploads_kept_after_loco"] = list(rgs["main"]._uploads)
run("loco_int8", lambda: emmax_loco(z["G"], z["y"], chromosomes=chroms,
                                    mesh=mesh))
run("loco_frac", lambda: emmax_loco(z["frac"], z["y"], chromosomes=chroms,
                                    mesh=mesh))
with open({out!r}, "wb") as f:
    pickle.dump(res, f)
# no rank tears its group down while another still works (a gloo peer that
# exits first can abort the other's teardown)
dist.barrier()
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def worlds(data, tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]} of one run of every case
    on each world."""
    d = tmp_path_factory.mktemp("gloo")
    dpath = str(d / "data.npz")
    np.savez(dpath, **data)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    procs = []
    for world in WORLDS:
        store = str(d / f"store_{world}")
        for rank in range(world):
            out = str(d / f"out_{world}_{rank}.pkl")
            err = open(d / f"err_{world}_{rank}.txt", "w")
            src = _WORKER.format(repo=REPO, rank=rank, world=world,
                                 store=store, data=dpath, out=out, rb=_RB,
                                 tile_main=_TILE["main"],
                                 tile_missing=_TILE["missing"])
            procs.append((world, rank, out, err, subprocess.Popen(
                [sys.executable, "-c", src], stdout=err,
                stderr=subprocess.STDOUT, env=env)))
    deadline = time.time() + 600
    try:
        for *_, p in procs:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for *_, err, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
            err.close()
    bad = [(w, r, p.returncode, open(e.name).read()[-3000:])
           for w, r, _, e, p in procs if p.returncode != 0]
    if bad:
        pytest.fail(f"gloo ranks failed (world, rank, rc, output): {bad}")
    out = {w: [] for w in WORLDS}
    for w, _, path, _, _ in procs:
        with open(path, "rb") as f:
            out[w].append(pickle.load(f))
    return out


def _ok(res, name):
    assert res[name][0] == "ok", res[name]
    return res[name][1]


# ---- the worlds ran as asked ----------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_sees_its_mesh(worlds, world):
    got = [r["mesh"] for r in worlds[world]]
    assert got == [((world, 1), "gloo", i, world) for i in range(world)]


@pytest.mark.parametrize("world", WORLDS)
def test_the_broadcast_keeps_rank_0s_layout(worlds, world):
    """broadcast_from_rank0 gives every rank rank 0's values with rank 0's
    strides (a column-major U stays column-major: the exact tier's GEMM
    then rounds alike on every rank), and its scalars and Nones."""
    want = np.arange(12.0).reshape(3, 4).T
    for res in worlds[world]:
        stride, t, sc, none = res["bcast"]
        assert stride == (1, 4) and sc == 2.5 and none is None
        np.testing.assert_array_equal(t, want)


_KIN = ("kin_ibs", "kin_missing", "kin_vanraden", "kin_vanraden_dip",
        "kin_shard")
#: (fixture, tier) of the scans that run (int8x3 refuses missing calls)
_SCANS = [(f, t) for f in ("main", "sing", "missing") for t in TIERS
          if (f, t) != ("missing", "int8x3")]
_EMX = tuple(f"emmax_{f}_{t}" for f, t in _SCANS) + (
    "emmax_shard", "emmax_frac_bf16x3", "emmax_route", "emmax_sing_f32")
#: the resident scan's cases that run (int8x3 refuses missing calls)
_RES = [(f, t) for f in ("main", "missing") for t in TIERS
        if (f, t) != ("missing", "int8x3")]
_RESIDENT = (tuple(f"res_{f}_{t}" for f, t in _RES)
             + tuple(f"res_route_{t}" for t in TIERS)
             + ("res_as_distributed_emmax", "kin_res_ibs", "kin_res_vanraden",
                "kin_res_missing"))
_LOCO = ("loco_resident", "loco_int8", "loco_frac")


@pytest.mark.parametrize("case", _KIN + _EMX + _RESIDENT + _LOCO)
@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_result(worlds, world, case):
    first = _ok(worlds[world][0], case)
    for res in worlds[world][1:]:
        other = _ok(res, case)
        if isinstance(first, dict):
            assert first.keys() == other.keys()
            for k in first:
                if k == "loco":
                    assert other[k] == first[k]
                else:
                    np.testing.assert_array_equal(other[k], first[k])
        else:
            np.testing.assert_array_equal(other, first)


# ---- distributed_kinship ----------------------------------------------------

def _kin_source(data, case):
    return {"kin_ibs": (data["G"], "ibs"),
            "kin_missing": (data["miss"], "ibs"),
            "kin_vanraden": (data["G"], "vanraden"),
            "kin_vanraden_dip": (data["dip"], "vanraden"),
            "kin_shard": (data["G"], "ibs")}[case]


@pytest.mark.parametrize("case", _KIN)
@pytest.mark.parametrize("world", WORLDS)
def test_kinship_matches_the_single_device_port(worlds, data, world, case):
    G, method = _kin_source(data, case)
    ref = kinship(G, method=method, device="cpu")
    got = _ok(worlds[world][0], case)
    assert got.dtype == np.float64 and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("case", _KIN)
@pytest.mark.parametrize("world", WORLDS)
def test_kinship_matches_jax(worlds, data, world, case):
    G, method = _kin_source(data, case)
    mesh = jmesh.make_mesh((8, 1), devices=jax.devices()[:8])
    if G.dtype == np.int8 and not (G < 0).any():
        G = G.astype(np.float64)     # JAX's gram would sum in int8
    ref = jdist.distributed_kinship(G, mesh=mesh, method=method)
    np.testing.assert_allclose(_ok(worlds[world][0], case), ref, rtol=0,
                               atol=1e-10)


def test_integer_kinship_is_bit_equal_across_worlds(worlds, data):
    """K1's integer counts summed in int64: the same bits on every world
    and on one device."""
    ref = kinship(data["G"], device="cpu")
    for w in WORLDS:
        np.testing.assert_array_equal(_ok(worlds[w][0], "kin_ibs"), ref)


@pytest.mark.parametrize("world", WORLDS)
def test_diploid_ibs_is_refused_on_every_rank(worlds, world):
    for res in worlds[world]:
        kind, name, msg = res["kin_diploid_ibs"]
        assert (kind, name) == ("raised", "ValueError")
        assert "BINARY" in msg


# ---- distributed_emmax ------------------------------------------------------

def _emx_inputs(data, fixture):
    if fixture == "sing":
        return data["Gs"], data["ys"], data["Ks"]
    G = data["miss"] if fixture == "missing" else data["G"]
    return G, data["y"], data["K"]


def _close(got, ref, tol=1e-10):
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    np.testing.assert_allclose(got["ps"], ref["ps"], rtol=0, atol=tol)
    np.testing.assert_allclose(got["f_stats"], ref["f_stats"], rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("fixture, tier", _SCANS)
@pytest.mark.parametrize("world", WORLDS)
def test_emmax_matches_the_single_device_port(worlds, data, world, fixture,
                                              tier):
    G, y, K = _emx_inputs(data, fixture)
    got = _ok(worlds[world][0], f"emmax_{fixture}_{tier}")
    ref = emmax(G, y, K=K, precision=tier, device="cpu")
    _close(got, ref)
    np.testing.assert_allclose(got["betas"], ref["betas"], rtol=1e-9,
                               atol=1e-10)
    for k in ("delta", "pseudo_heritability", "dof", "ll_null"):
        assert got[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("fixture", ["main", "sing"])
@pytest.mark.parametrize("world", WORLDS)
def test_emmax_matches_jax(worlds, data, world, fixture, tier, monkeypatch):
    G, y, K = _emx_inputs(data, fixture)
    fold_jax_tiers(monkeypatch)
    monkeypatch.setattr(jdist, "build_rotated_null",
                        jscan.build_rotated_null)
    mesh = jmesh.make_mesh((8, 1), devices=jax.devices()[:8])
    ref = jdist.distributed_emmax(G.astype(np.float64), y, K=K, mesh=mesh,
                                  rotate_in_bf16=_RB[tier])
    got = _ok(worlds[world][0], f"emmax_{fixture}_{tier}")
    assert sorted(got) == sorted(ref)
    _close(got, ref)


def test_the_singular_fixture_has_delta_at_its_bound(worlds):
    got = _ok(worlds[2][0], "emmax_sing_exact")
    assert got["delta"] == pytest.approx(np.exp(-10.0), rel=1e-6)


@pytest.mark.parametrize("world", WORLDS)
def test_float32_under_the_singular_kinship(worlds, data, world):
    """The float32 scan of the singular fixture (the projected U') on the
    mesh: equal to one device's float32 call, and within 1e-6 of float64
    with the same masks."""
    got = _ok(worlds[world][0], "emmax_sing_f32")
    ref = emmax(data["Gs"], data["ys"], K=data["Ks"], dtype=torch.float32,
                device="cpu")
    _close(got, ref, tol=1e-12)
    f64 = _ok(worlds[world][0], "emmax_sing_exact")
    np.testing.assert_array_equal(got["mask"], f64["mask"])
    assert np.abs(got["ps"] - f64["ps"]).max() <= 1e-6


@pytest.mark.parametrize("world", WORLDS)
def test_a_shard_scans_as_the_full_matrix(worlds, world):
    res = worlds[world][0]
    _close(_ok(res, "emmax_shard"), _ok(res, "emmax_main_int8x3"), tol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_fractional_dosages_take_the_float_route(worlds, data, world):
    ref = emmax(data["frac"], data["y"], K=data["K"], precision="bf16x3",
                device="cpu")
    _close(_ok(worlds[world][0], "emmax_frac_bf16x3"), ref)


@pytest.mark.parametrize("case", ["emmax_frac_int8x3", "emmax_missing_int8x3"])
@pytest.mark.parametrize("world", WORLDS)
def test_int8_refusals_on_every_rank(worlds, world, case):
    for res in worlds[world]:
        kind, name, msg = res[case]
        assert (kind, name) == ("raised", "ValueError")
        assert "integer dosages" in msg


@pytest.mark.parametrize("world", WORLDS)
def test_emmax_mesh_route_is_distributed_emmax(worlds, world):
    res = worlds[world][0]
    got, ref = _ok(res, "emmax_route"), _ok(res, "emmax_main_bf16x3")
    assert "betas" not in got and "var_perc" not in got
    _close(got, ref, tol=0)


# ---- the sharded resident scan ---------------------------------------------

def _res_inputs(data, fixture):
    G = data["miss"] if fixture == "missing" else data["G"]
    return G, data["y"], data["K"]


def _jax_mesh():
    return jmesh.make_mesh((8, 1), devices=jax.devices()[:8])


@pytest.mark.parametrize("fixture, tier", _RES)
@pytest.mark.parametrize("world", WORLDS)
def test_resident_matches_the_single_device_port(worlds, data, world,
                                                 fixture, tier):
    G, y, K = _res_inputs(data, fixture)
    rg = ResidentGenome.from_source(G, tile=_TILE[fixture], device="cpu")
    ref = emmax_resident(rg, y, K=K, precision=tier)
    got = _ok(worlds[world][0], f"res_{fixture}_{tier}")
    _close(got, ref)
    np.testing.assert_allclose(got["betas"], ref["betas"], rtol=1e-9,
                               atol=1e-10)
    for k in ("delta", "pseudo_heritability", "dof", "ll_null"):
        assert got[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("fixture, tier", _RES)
@pytest.mark.parametrize("world", WORLDS)
def test_resident_matches_jax(worlds, data, world, fixture, tier,
                              monkeypatch):
    G, y, K = _res_inputs(data, fixture)
    fold_jax_tiers(monkeypatch)
    monkeypatch.setattr(jdist, "build_rotated_null",
                        jscan.build_rotated_null)
    jrg = JResident.from_source(G, tile=_TILE[fixture], upload=False)
    ref = jdist.distributed_emmax_resident(jrg, y, K=K, mesh=_jax_mesh(),
                                           rotate_in_bf16=_RB[tier])
    got = _ok(worlds[world][0], f"res_{fixture}_{tier}")
    assert sorted(got) == sorted(ref)
    _close(got, ref)


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("world", WORLDS)
def test_emmax_mesh_over_a_container_is_the_resident_scan(worlds, world,
                                                          tier):
    """emmax(rg, mesh=) and distributed_emmax(rg) route to
    distributed_emmax_resident, tier names resolved for the container."""
    res = worlds[world][0]
    _close(_ok(res, f"res_route_{tier}"), _ok(res, f"res_main_{tier}"),
           tol=0)
    if tier == "int8x3":
        _close(_ok(res, "res_as_distributed_emmax"),
               _ok(res, "res_main_int8x3"), tol=0)


@pytest.mark.parametrize("world", WORLDS)
def test_int8_on_a_container_with_missing_calls_is_refused_on_every_rank(
        worlds, world):
    for res in worlds[world]:
        kind, name, msg = res["res_missing_int8x3"]
        assert (kind, name) == ("raised", "ValueError")
        assert "fully-observed" in msg


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_its_shard(worlds, data, world):
    """Each rank uploaded its shard once (host_snp_range at the
    container's tile; rank 2 of the world of 3 holds none of the 300-row
    genome) and a second round of calls uploaded none."""
    for rank, res in enumerate(worlds[world]):
        rows = {f: tmultihost.host_snp_range(data[g].shape[0], world, rank,
                                             tile=_TILE[f])
                for f, g in (("main", "G"), ("missing", "miss"))}
        assert res["shard_rows"] == {f: [hi - lo] for f, (lo, hi)
                                     in rows.items()}
        assert res["shard_keys"] == [(rank, world, torch.device("cpu"))]
        assert (res["uploads_first"], res["uploads_again"]) == (1, 0)
    if world == 3:
        assert worlds[3][2]["shard_rows"]["missing"] == [0]


@pytest.mark.parametrize("world", WORLDS)
def test_loco_keeps_no_whole_upload_on_the_container(worlds, world):
    """emmax_loco(mesh=) over a caller's host-only container: rank 0 read
    the whole genome for its kinships from an upload held for that call
    only, so no rank's container keeps more than its shard."""
    for res in worlds[world]:
        _ok(res, "loco_resident")
        assert res["uploads_kept_after_loco"] == []


_KIN_RES = {"kin_res_ibs": ("G", "ibs"), "kin_res_vanraden": ("G", "vanraden"),
            "kin_res_missing": ("miss", "ibs")}


@pytest.mark.parametrize("case", sorted(_KIN_RES))
@pytest.mark.parametrize("world", WORLDS)
def test_resident_kinship_matches_one_device_and_jax(worlds, data, world,
                                                     case):
    g, method = _KIN_RES[case]
    got = _ok(worlds[world][0], case)
    rg = ResidentGenome.from_source(data[g], device="cpu")
    np.testing.assert_allclose(got, kinship_resident(rg, method=method),
                               rtol=0, atol=1e-10)
    G = data[g] if (data[g] < 0).any() else data[g].astype(np.float64)
    np.testing.assert_allclose(
        got, jdist.distributed_kinship(G, mesh=_jax_mesh(), method=method),
        rtol=0, atol=1e-10)


def test_resident_integer_kinship_is_bit_equal_across_worlds(worlds, data):
    """K1's counts over each rank's packed shard, summed in int64: the same
    bits on every world as kinship_resident on one device."""
    ref = kinship_resident(ResidentGenome.from_source(data["G"],
                                                      device="cpu"))
    for w in WORLDS:
        np.testing.assert_array_equal(_ok(worlds[w][0], "kin_res_ibs"), ref)


def _loco_source(data, case):
    return {"loco_resident": ResidentGenome.from_source(
                data["G"], tile=_TILE["main"], device="cpu"),
            "loco_int8": data["G"], "loco_frac": data["frac"]}[case]


def _loco_close(got, ref, tol=1e-10):
    _close(got, ref, tol)
    assert got["dof"] == ref["dof"]
    assert got["loco"].keys() == ref["loco"].keys()
    for c in ref["loco"]:
        for k in ("delta", "pseudo_heritability", "ll_null"):
            assert got["loco"][c][k] == pytest.approx(ref["loco"][c][k],
                                                      rel=1e-10, abs=1e-12)


@pytest.mark.parametrize("case", _LOCO)
@pytest.mark.parametrize("world", WORLDS)
def test_loco_mesh_matches_the_single_device_port(worlds, data, world, case):
    ref = emmax_loco(_loco_source(data, case), data["y"], chromosomes=CHROMS,
                     device="cpu")
    got = _ok(worlds[world][0], case)
    assert sorted(got) == sorted(ref)
    _loco_close(got, ref)
    np.testing.assert_allclose(got["betas"], ref["betas"], rtol=1e-9,
                               atol=1e-10)


@pytest.mark.parametrize("case", _LOCO)
def test_loco_mesh_matches_jax(worlds, data, case):
    """The JAX package's emmax_loco(mesh=) on its 8 virtual devices (a
    container scanned whole under each null by its distributed_emmax_
    resident, an array's rows by its distributed_emmax); fractional
    dosages with its float64 kinships, as tests/test_torch_fractional.py
    holds the single-device LOCO."""
    src = {"loco_resident": JResident.from_source(data["G"],
                                                  tile=_TILE["main"]),
           "loco_int8": data["G"], "loco_frac": data["frac"]}[case]
    ks = (j_loco_kinships(src, CHROMS, ploidy=1, dtype=jnp.float64)
          if case == "loco_frac" else None)
    ref = j_emmax_loco(src, data["y"], chromosomes=CHROMS, ploidy=1,
                       kinships=ks, mesh=_jax_mesh())
    for w in WORLDS:
        _loco_close(_ok(worlds[w][0], case), ref)


# ---- refusals, copies, defaults (one process) ------------------------------

_CPU_MESH = make_mesh(devices="cpu")


@pytest.mark.parametrize("kw, exc, match", [
    (dict(precision="fast"), ValueError, "'fast'"),
    (dict(precision="fast", rescore_top=8), ValueError, "'fast'"),
    (dict(stream=True), ValueError, "stream=True"),
    (dict(checkpoint_dir="ck"), ValueError, "checkpoint_dir"),
    (dict(rescore_top=8), ValueError, "rescore_top"),
    (dict(matmul_precision="high"), ValueError, "matmul_precision"),
    (dict(precision="high"), ValueError, "not supported on the mesh path"),
    (dict(precision="int8x3", rotate_in_bf16="bf16x3"), ValueError,
     "either precision"),
])
def test_emmax_mesh_refusals(data, kw, exc, match):
    with pytest.raises(exc, match=match):
        emmax(data["G"], data["y"], K=data["K"], mesh=_CPU_MESH,
              device="cpu", **kw)


@pytest.mark.parametrize("tier", TIERS)
def test_resident_true_packs_on_the_host(data, tier):
    """resident=True on a mesh packs the source on the host
    (upload=False) and scans it by distributed_emmax_resident: equal to
    the single-device resident scan bit for bit on a world of one."""
    got = emmax(data["G"].astype(np.int8), data["y"], K=data["K"],
                mesh=_CPU_MESH, resident=True, precision=tier, device="cpu")
    rg = ResidentGenome.from_source(data["G"], device="cpu")
    _close(got, emmax_resident(rg, data["y"], K=data["K"], precision=tier),
           tol=0)


def test_an_int8_source_over_the_budget_packs_on_the_host(data,
                                                          monkeypatch):
    """An int8 source over the in-core budget that fits packed is packed
    on the host (models/source.py::pack_for_mesh, upload=False) and takes
    the resident route, as in the JAX package; the CPU has no packed
    budget, so it is given one here."""
    from mixmogam_tpu_torch.models import resident, source

    monkeypatch.setattr(resident, "resident_budget_bytes", lambda d: 1 << 40)
    made = []
    pack = source.pack_for_mesh
    monkeypatch.setattr(source, "pack_for_mesh",
                        lambda *a, **k: made.append(pack(*a, **k)) or made[-1])
    got = emmax(data["G"], data["y"], K=data["K"], mesh=_CPU_MESH,
                stream_budget_bytes=1, precision="int8x3", device="cpu")
    assert len(made) == 1 and made[0].on_host
    _close(got, emmax(data["G"], data["y"], K=data["K"], precision="int8x3",
                      device="cpu"), tol=0)


def test_a_resident_genome_on_a_mesh_scans_its_shards(data):
    """A ResidentGenome on a mesh, in emmax(mesh=) and distributed_emmax,
    takes the resident route; on a world of one its shard is a view of the
    container's rows (no upload)."""
    rg = ResidentGenome.from_source(data["G"], device="cpu")
    ref = emmax_resident(rg, data["y"], K=data["K"])
    u0 = ResidentGenome.uploads
    _close(emmax(rg, data["y"], K=data["K"], mesh=_CPU_MESH), ref, tol=0)
    _close(distributed_emmax(rg, data["y"], K=data["K"], mesh=_CPU_MESH),
           ref, tol=0)
    assert ResidentGenome.uploads == u0
    (shard,) = rg._shards.values()
    assert shard.packed.data_ptr() == rg.packed.data_ptr()


def test_a_float_source_over_the_budget_stays_in_core(data):
    """Only an int8 source that would fit packed takes the resident route;
    a float source over the in-core budget scans SNP-sharded in core, as
    in the JAX package."""
    Gf = data["G"].astype(np.float64)
    got = emmax(Gf, data["y"], K=data["K"], mesh=_CPU_MESH,
                stream_budget_bytes=1, device="cpu")
    _close(got, emmax(Gf, data["y"], K=data["K"], device="cpu"))


@pytest.mark.parametrize("bad", [object(), "mesh"])
def test_emmax_takes_only_a_mesh(data, bad):
    with pytest.raises(TypeError, match="make_mesh"):
        emmax(data["G"], data["y"], K=data["K"], mesh=bad, device="cpu")


def test_emmax_mesh_takes_no_shard(data):
    shard = make_global_snp_array(data["G"], data["G"].shape[0], _CPU_MESH)
    with pytest.raises(TypeError, match="SnpShard"):
        emmax(shard, data["y"], K=data["K"], mesh=_CPU_MESH, device="cpu")


#: a (1, 2) mesh built by hand on a lone process (make_mesh refuses it)
_TP_MESH = Mesh((1, 2), None, None, 0, 1, torch.device("cpu"))


def _sample_axis_refusals(data):
    """{case: (call, exception, match)}: what refuses a 'sample' axis
    above 1, before any collective: the JAX package's own refusals (emma
    on any source; GxE, the permutation test and the class tests over a
    ResidentGenome, in its words), and on a mesh that does not hold its
    world (a lone process's hand-built (1, 2) mesh) every route that takes
    the axis, naming make_mesh."""
    G, y, K, m = data["G"], data["y"], data["K"], _TP_MESH
    env = np.random.default_rng(3).normal(size=y.shape[0])
    rg = ResidentGenome.from_source(G, tile=_TILE["main"], upload=False)
    routes = {
        "emmax_gxe": lambda: emmax_gxe(G, y, env, K=K, mesh=m),
        "emmax_perm_test": lambda: emmax_perm_test(G, y, K=K, mesh=m),
        "emmax_anova": lambda: emmax_anova(G, y, K=K, mesh=m),
        "emmax_two_snps": lambda: emmax_two_snps(G, y, K=K, focal_idx=[1],
                                                 mesh=m),
        "linear_model": lambda: linear_model(G, y, mesh=m),
        "anova": lambda: anova(G, y, mesh=m),
        "kruskal_wallis": lambda: kruskal_wallis(G, y, mesh=m),
    }
    cases = {e: (fn, ValueError, "make_mesh") for e, fn in routes.items()}
    packed = {
        "emmax_gxe resident": (lambda: emmax_gxe(rg, y, env, K=K, mesh=m),
                               "resident GxE shards 'snp' only"),
        "emmax_perm_test resident": (lambda: emmax_perm_test(
            rg, y, K=K, mesh=m), "resident permutation shards 'snp' only"),
        "linear_model resident": (lambda: linear_model(rg, y, mesh=m),
                                  "no rotation operator to sample-shard"),
        "anova resident": (lambda: anova(rg, y, mesh=m),
                           "packed class tests shard 'snp' only"),
        "kruskal_wallis resident": (lambda: kruskal_wallis(rg, y, mesh=m),
                                    "packed class tests shard 'snp' only"),
    }
    cases.update({c: (fn, ValueError, match)
                  for c, (fn, match) in packed.items()})
    cases.update({
        "make_mesh (1, 2)": (lambda: make_mesh((1, 2), devices="cpu"),
                             ValueError, "ranks"),
        "make_mesh (2, 1)": (lambda: make_mesh((2, 1), devices="cpu"),
                             ValueError, "ranks"),
        "make_mesh (2, 2)": (lambda: make_mesh((2, 2), devices="cpu"),
                             ValueError, "ranks"),
        "_mesh_device": (lambda: tdist._mesh_device(m, None), ValueError,
                         "make_mesh"),
        "LOCO's row window": (lambda: distributed_emmax_resident(
            rg, y, K=K, mesh=m, _rows=(0, 10)), ValueError, "make_mesh"),
        "emma": (lambda: emma(G, y, K=K, mesh=m), ValueError,
                 "shards 'snp' only"),
        # the routes that have a 'sample' route: a lone process's (1, 2)
        # mesh would scan half the samples as the whole
        "distributed_emmax": (lambda: distributed_emmax(G, y, K=K, mesh=m),
                              ValueError, "make_mesh"),
        "distributed_emmax_resident": (lambda: distributed_emmax_resident(
            rg, y, K=K, mesh=m), ValueError, "make_mesh"),
        "distributed_kinship": (lambda: distributed_kinship(G, m),
                                ValueError, "make_mesh"),
        "emmax": (lambda: emmax(G, y, K=K, mesh=m), ValueError,
                  "make_mesh"),
        "emmax_step_wise": (lambda: emmax_step_wise(G, y, K=K, mesh=m),
                            ValueError, "make_mesh"),
        "emmax_loco": (lambda: emmax_loco(G, y, chromosomes=CHROMS, mesh=m),
                       ValueError, "make_mesh"),
        "emmax_multi_trait": (lambda: emmax_multi_trait(
            G, np.stack([y, y[::-1]]), K=K, mesh=m), ValueError,
            "make_mesh"),
    })
    return cases


@pytest.mark.parametrize("case", [
    "make_mesh (1, 2)", "make_mesh (2, 1)", "make_mesh (2, 2)",
    "_mesh_device", "LOCO's row window", "emma", "distributed_emmax",
    "distributed_emmax_resident", "distributed_kinship", "emmax",
    "emmax_step_wise", "emmax_loco", "emmax_multi_trait", "emmax_gxe",
    "emmax_perm_test", "emmax_anova", "emmax_two_snps", "linear_model",
    "anova", "kruskal_wallis", "emmax_gxe resident",
    "emmax_perm_test resident", "linear_model resident", "anova resident",
    "kruskal_wallis resident"])
def test_what_still_refuses_a_sample_axis(data, case):
    """A shape that does not hold the world; the JAX package's refusals of
    the axis (emma; GxE, the permutation test and the class tests over a
    ResidentGenome), each its ValueError in its words; and every route
    that takes the axis (each entry point of docs/DISTRIBUTED.md's table
    but emma, and LOCO's row window), on a mesh that is not the world's:
    ValueError naming make_mesh. No entry point raises
    NotImplementedError for the axis."""
    call, exc, match = _sample_axis_refusals(data)[case]
    with pytest.raises(exc, match=match):
        call()


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("shape", [None, (1, 1)])
def test_a_lone_mesh_needs_a_card_unless_asked(shape):
    """make_mesh on a lone process: the card by default (ROADMAP's rule for
    the port's defaults), so without one it raises naming device="cpu";
    devices="cpu" gives a world of one with no collectives."""
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_mesh(shape)
    mesh = make_mesh(shape, devices="cpu")
    assert (mesh.shape, mesh.world, mesh.distributed) == ((1, 1), 1, False)
    assert (mesh.snp_index, mesh.sample_index) == (0, 0)


def test_a_shard_must_be_the_ranks_range(data):
    with pytest.raises(ValueError, match="host_snp_range"):
        make_global_snp_array(data["G"][:10], 700, _CPU_MESH)


@pytest.mark.parametrize("args", [(1000, 8, 3), (1000, 8, 7), (7, 4, 0),
                                  (7, 4, 3), (100_001, 3, 2), (0, 2, 1)])
def test_host_snp_range_is_the_jax_packages(args):
    assert (tmultihost.host_snp_range(*args)
            == jmultihost.host_snp_range(*args))


@pytest.mark.parametrize("shape, mult, axis", [((101, 3), 8, 0),
                                               ((96, 5), 8, 0),
                                               ((4, 13), 4, 1)])
def test_pad_to_multiple_is_the_jax_packages(shape, mult, axis):
    x = np.arange(np.prod(shape), dtype=np.float64).reshape(shape)
    got, size = tmesh.pad_to_multiple(x, mult, axis)
    ref, rsize = jmesh.pad_to_multiple(x, mult, axis)
    assert size == rsize
    np.testing.assert_array_equal(got, ref)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("call", ["make_mesh", "distributed_kinship",
                                  "distributed_emmax"])
def test_entry_points_need_a_card_unless_asked(data, call):
    fn = {"make_mesh": lambda: make_mesh(),
          "distributed_kinship": lambda: distributed_kinship(data["G"]),
          "distributed_emmax": lambda: distributed_emmax(
              data["G"], data["y"], K=data["K"])}[call]
    with pytest.raises(RuntimeError, match='device="cpu"'):
        fn()


def test_one_process_starts_no_group(monkeypatch):
    """initialize_multihost does nothing for a single process, asked or
    from the environment."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    tmultihost.initialize_multihost(num_processes=1)
    tmultihost.initialize_multihost()
    assert not torch.distributed.is_initialized()


def test_a_world_of_one_has_no_collectives(data):
    """Without a process group the mesh is a world of one, and the
    distributed calls equal the single-device ones bit for bit."""
    assert _CPU_MESH.world == 1 and not _CPU_MESH.distributed
    np.testing.assert_array_equal(
        distributed_kinship(data["G"], _CPU_MESH),
        kinship(data["G"], device="cpu"))
    got = distributed_emmax(data["G"], data["y"], K=data["K"],
                            mesh=_CPU_MESH, rotate_in_bf16="int8x3")
    _close(got, emmax(data["G"], data["y"], K=data["K"], precision="int8x3",
                      device="cpu"), tol=0)


def _other_entries():
    """name -> call(G, y, K, mesh) of every other entry point with mesh=."""
    from mixmogam_tpu_torch import api
    from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
    from mixmogam_tpu_torch.models.stepwise import emmax_step_wise

    return {
        "emmax_step_wise": lambda G, y, K, m: emmax_step_wise(
            G, y, K=K, mesh=m, device="cpu"),
        "emmax_multi_trait": lambda G, y, K, m: emmax_multi_trait(
            G, np.stack([y, y]), K=K, mesh=m, device="cpu"),
        "emma": lambda G, y, K, m: api.emma(G, y, K=K, mesh=m, device="cpu"),
        "linear_model": lambda G, y, K, m: api.linear_model(
            G, y, mesh=m, device="cpu"),
        "anova": lambda G, y, K, m: api.anova(G, y, mesh=m, device="cpu"),
        "kruskal_wallis": lambda G, y, K, m: api.kruskal_wallis(
            G, y, mesh=m, device="cpu"),
        "emmax_gxe": lambda G, y, K, m: api.emmax_gxe(
            G, y, np.arange(y.size) % 2 * 1.0, K=K, mesh=m, device="cpu"),
        "emmax_perm_test": lambda G, y, K, m: api.emmax_perm_test(
            G, y, K=K, mesh=m, device="cpu"),
        "emmax_two_snps": lambda G, y, K, m: api.emmax_two_snps(
            G, y, K=K, focal_idx=[1], mesh=m, device="cpu"),
        "emmax_anova": lambda G, y, K, m: api.emmax_anova(
            G.astype(np.int8) * 2, y, K=K, mesh=m, device="cpu"),
    }


@pytest.mark.parametrize("precision", [None, "exact"])
def test_emmax_loco_on_a_mesh_of_one(data, precision):
    """emmax_loco(mesh=) on a world of one with no process group: the
    single-device LOCO bit for bit (its kinships and eighs, each
    chromosome's rows of the one shard)."""
    G, y = data["G"], data["y"]
    got = emmax_loco(G, y, chromosomes=CHROMS, mesh=_CPU_MESH,
                     precision=precision, with_betas=False)
    ref = emmax_loco(G, y, chromosomes=CHROMS, device="cpu",
                     with_betas=False)
    assert sorted(got) == sorted(ref)
    _loco_close(got, ref, tol=0)


@pytest.mark.parametrize("kw, exc, match", [
    (dict(mesh=object()), TypeError, "make_mesh"),
    (dict(precision="bf16x3"), ValueError, "exact tier"),
    (dict(precision="int8x3"), ValueError, "exact tier"),
    (dict(rescore_top=8), TypeError, "rescore_top"),
])
def test_emmax_loco_mesh_refusals(data, kw, exc, match):
    kw = {"mesh": _CPU_MESH, **kw}
    with pytest.raises(exc, match=match):
        emmax_loco(data["G"], data["y"], chromosomes=CHROMS, **kw)


@pytest.mark.parametrize("entry", sorted(_other_entries()))
def test_the_other_entry_points_on_a_mesh_of_one(data, entry):
    """Every other entry point's mesh= (item 16c: the campaign scans, GxE,
    the permutation test, the class tests, two-SNP and emmax_anova's
    diploid test) runs on a world of one, equal to one device bit for bit;
    gloo worlds of 2 and 3 hold them in tests/test_torch_parallel_campaign.py
    and tests/test_torch_parallel_scans.py."""
    call = _other_entries()[entry]
    args = (data["G"], data["y"], data["K"])
    got, ref = call(*args, _CPU_MESH), call(*args, None)
    if "selected" in ref:
        assert got["selected"] == ref["selected"]
        assert ([s["min_p"] for s in got["steps"]]
                == [s["min_p"] for s in ref["steps"]])
        return
    keys = [k for k in ("ps", "f_stats", "mask", "stats", "min_ps",
                        "threshold", "marginal_ps", "inter_ps", "joint_ps",
                        "mask_inter", "cond_ps", "dof1", "dof2")
            if k in ref]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(got[k], ref[k])
