"""PyTorch port, the 'sample' tensor-parallel scan (parallel/: make_mesh with
a 'sample' axis, distributed_emmax, distributed_emmax_resident,
emmax(mesh=) and distributed_kinship over row blocks of the rotation and
blocks of the samples), on gloo worlds of 2 as a (1, 2) mesh and of 4 as a
(2, 2) mesh, on the CPU.

One module fixture runs both worlds once, each rank a subprocess pinned to
one thread that joins its group through a file:// store under the test's
directory and writes its results there (the harness of
tests/test_torch_parallel.py). n = 99 samples pad to 112 on both routes
(in core to a multiple of 8 S, packed to a multiple of 2 S bytes), so
each rank's block ends in padding; the 300-row genome splits unevenly
over the (2, 2) mesh's 'snp' axis at the containers' 64-row tile.

Limits: against the port's single-device calls, the int8 tier's summed
plane products bit-equal and its statistics within 1e-12 (float64), the
exact and bf16 tiers within 1e-10 in p; against the JAX package's
distributed_emmax / distributed_emmax_resident on the same mesh shape over
the conftest's virtual devices in x64, the exact tier within 1e-10 in p;
masks equal everywhere; the integer kinship bit-equal."""

import os
import pickle
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from mixmogam_tpu.models.resident import ResidentGenome as JResident
from mixmogam_tpu.parallel import distributed as jdist
from mixmogam_tpu.parallel import mesh as jmesh
from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                              simulate_phenotype)
from mixmogam_tpu_torch.models.emmax import emmax
from mixmogam_tpu_torch.models.loco import emmax_loco
from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                emmax_resident, scale_k)
from mixmogam_tpu_torch.ops.kinship import kinship
from mixmogam_tpu_torch.ops.scan import (apply_rotation, apply_rotation_psum,
                                         quantize_rotation)
from mixmogam_tpu_torch.parallel import make_mesh
from mixmogam_tpu_torch.parallel.mesh import Mesh
from mixmogam_tpu_torch.parallel.multihost import host_snp_range

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: world size -> mesh shape
SHAPES = {2: (1, 2), 4: (2, 2)}
WORLDS = tuple(SHAPES)
TIERS = ("exact", "int8x3", "bf16x3")
_RB = {"exact": False, "int8x3": "int8x3", "bf16x3": "bf16x3"}
TILE = 64
N, M = 99, 300
#: n = 99 padded to 112 on both routes: a rank's block of 56 samples
N_PAD, BLOCK = 112, 56


def _data():
    """main: n = 99 binary lines, M = 300; miss: the same with 4 % missing
    calls; frac: main's imputed fractions with NaN; cov: a design of an
    intercept and one covariate."""
    G, _, _ = simulate_genotypes(N, M, ploidy=1, seed=41)
    y, _ = simulate_phenotype(G, h2=0.6, n_causal=4, seed=41)
    rng = np.random.default_rng(41)
    miss = G.copy()
    miss[rng.random(G.shape) < 0.04] = -1
    frac = G * 0.97 + rng.uniform(0.0, 0.02, G.shape)
    frac[rng.random(G.shape) < 0.01] = np.nan
    cov = np.column_stack([np.ones(N), rng.normal(size=N)])
    K = scale_k(kinship(G, device="cpu"))
    return dict(G=G, y=y, K=K, miss=miss, frac=frac, cov=cov)


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
from mixmogam_tpu_torch.ops.reml import esp_to_refine_iters, fit_null_model
from mixmogam_tpu_torch.ops.rotate import rotate_tile
from mixmogam_tpu_torch.ops.scan import build_rotated_null
from mixmogam_tpu_torch.parallel import (distributed_emmax,
    distributed_emmax_resident, distributed_kinship, initialize_multihost,
    make_global_snp_array, make_mesh)
from mixmogam_tpu_torch.parallel import distributed as pd
from mixmogam_tpu_torch.parallel.mesh import all_reduce, gather_rows
from mixmogam_tpu_torch.parallel.multihost import host_snp_range

rank, world, shape = {rank}, {world}, {shape!r}
initialize_multihost("file://" + {store!r}, world, rank, device="cpu")
mesh = make_mesh(shape, devices="cpu")
z = dict(np.load({data!r}))
G, y, K = z["G"], z["y"], z["K"]
M = G.shape[0]
res = {{"mesh": (mesh.shape, mesh.rank, mesh.snp_index, mesh.sample_index)}}
# the 'snp' all-gather: every shard once, in 'snp' order
res["gathered"] = gather_rows(torch.tensor([[float(mesh.snp_index)]]),
                              mesh).numpy()
res["sample_sum"] = float(all_reduce(torch.tensor(float(rank)), mesh,
                                     axis="sample"))


def run(name, fn):
    try:
        res[name] = ("ok", fn())
    except Exception as e:
        res[name] = ("raised", type(e).__name__, str(e))


lo, hi = host_snp_range(M, shape[0], mesh.snp_index)
run("kin_ibs", lambda: distributed_kinship(G, mesh))
run("kin_missing", lambda: distributed_kinship(z["miss"], mesh))
run("kin_vanraden", lambda: distributed_kinship(G, mesh, method="vanraden"))
run("kin_shard", lambda: distributed_kinship(
    make_global_snp_array(G[lo:hi], M, mesh), mesh))
for tier, rb in {rb!r}.items():
    for f in ("main", "miss"):
        src = G if f == "main" else z["miss"]
        run(f"emmax_{{f}}_{{tier}}", lambda: distributed_emmax(
            src, y, K=K, mesh=mesh, rotate_in_bf16=rb))
    run("emmax_cov_" + tier, lambda: distributed_emmax(
        G, y, K=K, X0=z["cov"], mesh=mesh, rotate_in_bf16=rb))
run("emmax_shard", lambda: distributed_emmax(
    make_global_snp_array(G[lo:hi], M, mesh), y, K=K, mesh=mesh,
    rotate_in_bf16="int8x3"))
run("emmax_frac_exact", lambda: distributed_emmax(z["frac"], y, K=K,
                                                  mesh=mesh))
run("emmax_frac_bf16x3", lambda: distributed_emmax(
    z["frac"], y, K=K, mesh=mesh, rotate_in_bf16="bf16x3"))
run("emmax_frac_int8x3", lambda: distributed_emmax(
    z["frac"], y, K=K, mesh=mesh, rotate_in_bf16="int8x3"))
run("emmax_route", lambda: emmax(G, y, K=K, mesh=mesh, precision="int8x3",
                                 with_betas=False))

# ---- the packed route over host-only containers ----
rgs = {{f: ResidentGenome.from_source(z[g], tile={tile}, upload=False)
        for f, g in (("main", "G"), ("miss", "miss"))}}
u0 = ResidentGenome.uploads
for tier, rb in {rb!r}.items():
    for f in ("main", "miss"):
        run(f"res_{{f}}_{{tier}}", lambda: distributed_emmax_resident(
            rgs[f], y, K=K, mesh=mesh, rotate_in_bf16=rb))
res["uploads"] = ResidentGenome.uploads - u0
run("res_route", lambda: emmax(rgs["main"], y, K=K, mesh=mesh,
                               precision="bf16x3"))
run("res_cov_int8x3", lambda: distributed_emmax_resident(
    rgs["main"], y, K=K, X0=z["cov"], mesh=mesh, rotate_in_bf16="int8x3"))
run("kin_res", lambda: distributed_kinship(rgs["main"], mesh))
res["shards"] = {{k[4:]: (tuple(sh.packed.shape), sh.M, sh.n)
                  for k, sh in rgs["main"]._shards.items()}}
run("res_rows_window", lambda: distributed_emmax_resident(
    rgs["main"], y, K=K, mesh=mesh, _rows=(0, 100)))
run("loco", lambda: emmax_loco(G, y, chromosomes=np.repeat([1, 2], 150),
                               mesh=mesh))

# ---- each rank's block of the rotation, and the int8 plane sums ----
X0 = np.ones((G.shape[1], 1))
n_pad, b0, b1 = pd.sample_blocks(G.shape[1], mesh)
res["blocks"] = {{"in core": (n_pad, b0, b1),
                  "packed": pd.sample_blocks(G.shape[1], mesh, packed=True)}}
args = (mesh, torch.device("cpu"), torch.float64, y, X0, K, None)
for tier, rb in {rb!r}.items():
    tp, _ = pd._tp_null(*args, rb or None, False, 100, -10.0, 10.0, 1e-6,
                        True, n_pad, b0, b1)
    res["w_" + tier] = (tuple(tp.W.W.shape), tp.lo, tp.width)
    if tier == "int8x3":
        Gb = torch.zeros((hi - lo, b1 - b0), dtype=torch.int8)
        Gb[:, :tp.width] = torch.from_numpy(G[lo:hi, b0:b0 + tp.width])
        sums = [all_reduce(rotate_tile(Gb, tp.W, plane=i), mesh,
                           axis="sample") for i in range(3)]
        # one device's planes: the same null, fitted here on its own
        null = fit_null_model(y, X0, K=K, refine_iters=esp_to_refine_iters(
            1e-6, 100, -10.0, 10.0), host_eigh=True, device="cpu",
                              dtype=torch.float64)
        planes = build_rotated_null(null, rotate_dtype="int8x3").planes
        whole = [torch.from_numpy(G[lo:hi]).double() @ p.double()
                 for p in planes]
        res["plane_sums_equal"] = [bool(torch.equal(a, b))
                                   for a, b in zip(sums, whole)]
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
    d = tmp_path_factory.mktemp("gloo_tp")
    dpath = str(d / "data.npz")
    np.savez(dpath, **data)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    procs = []
    for world, shape in SHAPES.items():
        store = str(d / f"store_{world}")
        for rank in range(world):
            out = str(d / f"out_{world}_{rank}.pkl")
            err = open(d / f"err_{world}_{rank}.txt", "w")
            src = _WORKER.format(repo=REPO, rank=rank, world=world,
                                 shape=shape, store=store, data=dpath,
                                 out=out, rb=_RB, tile=TILE)
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


def _close(got, ref, tol):
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    np.testing.assert_allclose(got["ps"], ref["ps"], rtol=0, atol=tol)
    np.testing.assert_allclose(got["f_stats"], ref["f_stats"], rtol=1e-9,
                               atol=1e-9)


#: the limit in p against the port's single device, by tier
_TOL = {"exact": 1e-10, "int8x3": 1e-12, "bf16x3": 1e-10}


# ---- the mesh -------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_ranks_lie_row_major(worlds, world):
    """rank r at ('snp' r // S, 'sample' r % S), as the JAX package
    reshapes its devices; the 'sample' all-reduce sums the ranks of one
    'snp' coordinate; the 'snp' all-gather takes each shard once."""
    shape = SHAPES[world]
    S = shape[1]
    for r, res in enumerate(worlds[world]):
        assert res["mesh"] == (shape, r, r // S, r % S)
        assert res["sample_sum"] == sum(range(r // S * S, r // S * S + S))
        np.testing.assert_array_equal(res["gathered"],
                                      [np.arange(shape[0], dtype=float)])


def test_make_mesh_matches_the_jax_layout():
    devs = jax.devices()[:4]
    j = jmesh.make_mesh((2, 2), devices=devs)
    ids = np.vectorize(lambda d: d.id)(j.devices)
    for r in range(4):
        m = Mesh((2, 2), None, None, r, 4, torch.device("cpu"))
        assert ids[m.snp_index, m.sample_index] == devs[r].id


#: (fixture, tier) of the scans that run (int8x3 refuses missing calls)
_IN_CORE = [(f, t) for f in ("main", "miss", "cov") for t in TIERS
            if (f, t) != ("miss", "int8x3")]
_PACKED = [(f, t) for f in ("main", "miss") for t in TIERS
           if (f, t) != ("miss", "int8x3")]


_CASES = ([f"emmax_{f}_{t}" for f, t in _IN_CORE]
          + [f"res_{f}_{t}" for f, t in _PACKED]
          + ["emmax_shard", "emmax_frac_exact", "emmax_frac_bf16x3",
             "emmax_route", "res_route", "res_cov_int8x3", "kin_ibs",
             "kin_missing", "kin_vanraden", "kin_shard", "kin_res"])


@pytest.mark.parametrize("case", _CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_result(worlds, world, case):
    first = _ok(worlds[world][0], case)
    for res in worlds[world][1:]:
        other = _ok(res, case)
        if isinstance(first, dict):
            assert first.keys() == other.keys()
            for k in first:
                np.testing.assert_array_equal(other[k], first[k])
        else:
            np.testing.assert_array_equal(other, first)


# ---- distributed_kinship ----------------------------------------------------

_KIN = {"kin_ibs": ("G", "ibs"), "kin_missing": ("miss", "ibs"),
        "kin_vanraden": ("G", "vanraden"), "kin_shard": ("G", "ibs"),
        "kin_res": ("G", "ibs")}


@pytest.mark.parametrize("case", sorted(_KIN))
@pytest.mark.parametrize("world", WORLDS)
def test_kinship_matches_one_device(worlds, data, world, case):
    """The rows split over every rank of the world: the integer IBS gram
    (K1's counts) bit-equal, the float routes to summation order."""
    g, method = _KIN[case]
    got = _ok(worlds[world][0], case)
    ref = kinship(data[g], method=method, device="cpu")
    if case in ("kin_ibs", "kin_shard", "kin_res"):
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


# ---- distributed_emmax and distributed_emmax_resident --------------------

def _src(data, f):
    return data["miss"] if f == "miss" else data["G"]


@pytest.mark.parametrize("fixture, tier", _IN_CORE)
@pytest.mark.parametrize("world", WORLDS)
def test_in_core_matches_one_device(worlds, data, world, fixture, tier):
    X0 = data["cov"] if fixture == "cov" else None
    ref = emmax(_src(data, fixture), data["y"], K=data["K"], X0=X0,
                precision=tier, device="cpu")
    got = _ok(worlds[world][0], f"emmax_{fixture}_{tier}")
    _close(got, ref, _TOL[tier])
    np.testing.assert_allclose(got["betas"], ref["betas"], rtol=1e-9,
                               atol=1e-10)
    for k in ("delta", "pseudo_heritability", "dof", "ll_null"):
        assert got[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("fixture, tier", _PACKED)
@pytest.mark.parametrize("world", WORLDS)
def test_packed_matches_one_device(worlds, data, world, fixture, tier):
    rg = ResidentGenome.from_source(_src(data, fixture), tile=TILE,
                                    device="cpu")
    ref = emmax_resident(rg, data["y"], K=data["K"], precision=tier)
    got = _ok(worlds[world][0], f"res_{fixture}_{tier}")
    _close(got, ref, _TOL[tier])
    np.testing.assert_allclose(got["betas"], ref["betas"], rtol=1e-9,
                               atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_int8_statistics_within_1e12_of_one_device(worlds, data, world):
    """int8x3 sums its plane products in integers before the recombine:
    its statistics equal one device's to 1e-12 in float64, in core and
    packed."""
    rg = ResidentGenome.from_source(data["G"], tile=TILE, device="cpu")
    ref = emmax_resident(rg, data["y"], K=data["K"], precision="int8x3")
    for case in ("emmax_main_int8x3", "res_main_int8x3"):
        got = _ok(worlds[world][0], case)
        for k in ("f_stats", "betas", "var_perc"):
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_int8_plane_sums_are_bit_equal(worlds, world):
    """Each rank's int8 digit-plane products, summed over 'sample', equal
    one device's whole-row products bit for bit, every plane."""
    for res in worlds[world]:
        assert res["plane_sums_equal"] == [True, True, True]


@pytest.mark.parametrize("world", WORLDS)
def test_a_covariate_on_the_packed_route(worlds, data, world):
    rg = ResidentGenome.from_source(data["G"], tile=TILE, device="cpu")
    ref = emmax_resident(rg, data["y"], K=data["K"], X0=data["cov"],
                         precision="int8x3")
    _close(_ok(worlds[world][0], "res_cov_int8x3"), ref, 1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_fractional_dosages(worlds, data, world):
    """The exact tier and the float route (the bf16 parts of U'), their
    NaN imputed from moments summed over 'sample'."""
    for tier in ("exact", "bf16x3"):
        ref = emmax(data["frac"], data["y"], K=data["K"], precision=tier,
                    device="cpu")
        _close(_ok(worlds[world][0], f"emmax_frac_{tier}"), ref, 1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_a_shard_and_the_entry_point_route(worlds, world):
    """A rank's SnpShard scans as the whole matrix; emmax(mesh=) takes the
    'sample' axis to distributed_emmax (in core) and to
    distributed_emmax_resident (a container)."""
    res = worlds[world][0]
    ref = _ok(res, "emmax_main_int8x3")
    _close(_ok(res, "emmax_shard"), ref, 0)
    got = _ok(res, "emmax_route")
    assert "betas" not in got
    _close(got, ref, 0)
    _close(_ok(res, "res_route"), _ok(res, "res_main_bf16x3"), 0)


@pytest.mark.parametrize("case", ["emmax_miss_int8x3", "emmax_frac_int8x3",
                                  "res_miss_int8x3"])
@pytest.mark.parametrize("world", WORLDS)
def test_int8_refusals_on_every_rank(worlds, world, case):
    for res in worlds[world]:
        kind, name, msg = res[case]
        assert (kind, name) == ("raised", "ValueError")
        assert "fully" in msg or "integer dosages" in msg


@pytest.mark.parametrize("case", ["res_rows_window", "loco"])
@pytest.mark.parametrize("world", WORLDS)
def test_routes_without_a_sample_route_refuse_on_every_rank(worlds, data,
                                                            world, case):
    """LOCO's row window of distributed_emmax_resident and emmax_loco(mesh=)
    refused a 'sample' axis until they took the tensor-parallel scan: now
    every rank returns one device's result (the window: rows [0, 100) of
    emmax_resident's, covered in order; LOCO: emmax_loco's), p within
    1e-10 and masks equal (tests/test_torch_parallel_tp_campaign.py holds
    LOCO's routes in full)."""
    if case == "loco":
        ref = emmax_loco(data["G"], data["y"],
                         chromosomes=np.repeat([1, 2], 150), device="cpu")
    else:
        rg = ResidentGenome.from_source(data["G"], tile=TILE, device="cpu")
        ref = {k: v[:100] if k in ("ps", "f_stats", "mask") else v
               for k, v in emmax_resident(rg, data["y"], K=data["K"]).items()}
    for res in worlds[world]:
        got = _ok(res, case)
        assert got["ps"].shape == (100 if case != "loco" else M,)
        _close(got, ref, 1e-10)


# ---- against the JAX package on the same mesh shape -----------------------

def _jax_mesh(world):
    return jmesh.make_mesh(SHAPES[world], devices=jax.devices()[:world])


@pytest.mark.parametrize("fixture", ["main", "miss"])
@pytest.mark.parametrize("world", WORLDS)
def test_in_core_exact_matches_jax(worlds, data, world, fixture):
    ref = jdist.distributed_emmax(_src(data, fixture), data["y"],
                                  K=data["K"], mesh=_jax_mesh(world))
    got = _ok(worlds[world][0], f"emmax_{fixture}_exact")
    assert sorted(got) == sorted(ref)
    _close(got, ref, 1e-10)


@pytest.mark.parametrize("fixture", ["main", "miss"])
@pytest.mark.parametrize("world", WORLDS)
def test_packed_exact_matches_jax(worlds, data, world, fixture):
    jrg = JResident.from_source(_src(data, fixture), tile=TILE,
                                upload=False)
    ref = jdist.distributed_emmax_resident(jrg, data["y"], K=data["K"],
                                           mesh=_jax_mesh(world))
    got = _ok(worlds[world][0], f"res_{fixture}_exact")
    assert sorted(got) == sorted(ref)
    _close(got, ref, 1e-10)


# ---- what each rank holds ---------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_its_block_of_the_rotation(worlds, world):
    """(n_pad / S, n) rows of U', of each digit plane, of each bf16 part:
    the JAX package's test_w_is_sharded_over_samples."""
    for res in worlds[world]:
        j = res["mesh"][3]
        assert res["blocks"]["in core"] == (N_PAD, j * BLOCK,
                                            (j + 1) * BLOCK)
        assert res["blocks"]["packed"] == (N_PAD, j * BLOCK // 4,
                                           (j + 1) * BLOCK // 4)
        width = min(BLOCK, N - j * BLOCK)
        assert res["w_exact"] == ((BLOCK, N), j * BLOCK, width)
        assert res["w_int8x3"] == ((3, BLOCK, N), j * BLOCK, width)
        assert res["w_bf16x3"] == ((3, BLOCK, N), j * BLOCK, width)


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_its_rows_and_byte_block(worlds, world):
    """One upload a container and rank: its 'snp' rows (to the tile) x its
    14 of the 28 padded bytes, keyed with the mesh's shape and its
    'sample' coordinate."""
    shape = SHAPES[world]
    for res in worlds[world]:
        _, r, i, j = res["mesh"]
        lo, hi = host_snp_range(M, shape[0], i, tile=TILE)
        rows = -(-hi // TILE) * TILE - lo
        assert res["shards"][(shape, j)] == ((rows, BLOCK // 4), hi - lo,
                                             BLOCK)
        assert res["uploads"] == 2


@pytest.mark.parametrize("tier", TIERS)
def test_apply_rotation_psum_on_a_lone_mesh_is_apply_rotation(data, tier):
    """With no 'sample' group to sum over, apply_rotation_psum of the
    tier's raw W (U', the int8 planes with their scale, the bf16 parts) is
    apply_rotation bit for bit; an n_out that W does not give raises."""
    W = torch.from_numpy(np.random.default_rng(5).normal(size=(N, N)))
    Wq, ws = quantize_rotation(W, None if tier == "exact" else tier,
                               sd_dtype=torch.float64)
    G = torch.from_numpy(data["G"][:40])
    mesh = make_mesh(devices="cpu")
    got = apply_rotation_psum(G, Wq, ws, torch.float64, mesh, N)
    assert torch.equal(got, apply_rotation(G, Wq, ws, torch.float64))
    with pytest.raises(ValueError, match="outputs"):
        apply_rotation_psum(G, Wq, ws, torch.float64, mesh, N - 1)
