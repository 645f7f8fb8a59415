"""PyTorch port, the 'sample' tensor-parallel route of the three campaign
entry points (emmax_step_wise, emmax_loco and emmax_multi_trait on a
('snp', 'sample') mesh, in core and over host-only packed containers), on
gloo worlds of 2 as a (1, 2) mesh and of 4 as a (2, 2) mesh, on the CPU.

The harness is tests/test_torch_parallel_tp.py's: one module fixture runs
both worlds once, each rank a subprocess pinned to one thread that joins
its group through a file:// store under the test's directory and pickles
its results there. The data are that file's _data() (n = 99 binary lines
x 300 rows; miss: 4 % missing calls; frac: imputed fractions with NaN;
cov: an intercept and one covariate), with four traits and two
missing-phenotype patterns. n = 99 pads to 112 on both routes, so each
rank's block of 56 samples ends in padding on 'sample' coordinate 1. The
containers' and the in-core scans' tile is 64 rows; LOCO's chromosome
bounds lie off it and across the (2, 2) mesh's 'snp' shards.

Each rank records what it holds: the shape of every rotation block it is
sent (parallel/mesh.py::scatter_from_rank0) and of stepwise's stored
rotated rows (models/streaming.py::rotate_tiles).

Limits, in float64: against the port's single-device calls p within 1e-10
and masks equal (multi-trait's int8x3 f_stats bit-equal over a packed
container; stepwise's cofactors, min_p SNPs and selections equal, BIC
within rtol 1e-8; LOCO's per-chromosome delta within rtol 1e-10); against
the JAX package's mesh= calls on the same mesh shape over the conftest's
virtual devices in x64, p within 1e-10 (multi-trait's fast tiers with the
JAX reference quantizing the port's U' = (I - P_X0) U,
test_torch_multitrait.jax_projected; 'high' within TIER_P_DRIFT['high']
of the JAX package's 'high' call, which runs as exact on the CPU, with
identical masks)."""

import os
import pickle
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from mixmogam_tpu.models import multitrait as jmt
from mixmogam_tpu.models import stepwise as jsw
from mixmogam_tpu.models.loco import emmax_loco as j_emmax_loco
from mixmogam_tpu.models.resident import ResidentGenome as JResident
from mixmogam_tpu.parallel import mesh as jmesh
from mixmogam_tpu_torch.models.loco import emmax_loco
from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.models.stepwise import emmax_step_wise
from mixmogam_tpu_torch.ops.scan import TIER_P_DRIFT
from mixmogam_tpu_torch.parallel.multihost import host_snp_range
from test_torch_multitrait import jax_projected
from test_torch_parallel_tp import _data

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: world size -> mesh shape
SHAPES = {2: (1, 2), 4: (2, 2)}
WORLDS = tuple(SHAPES)
TIERS = ("exact", "int8x3", "bf16x3", "high")
#: the 'high' tier's drift entry (against the JAX package, which runs
#: 'high' as its exact tier on the CPU; tests/test_torch_high.py)
HIGH = TIER_P_DRIFT["high"]
TILE = 64
N, M = 99, 300
#: n = 99 padded to 112 on both routes: a rank's block of 56 samples
N_PAD, BLOCK = 112, 56
_STEPS = 3
#: LOCO's chromosomes: bounds off the 64-row tile, chromosome 2 across the
#: (2, 2) mesh's two 'snp' shards
CHROMS = np.repeat([1, 2, 3], [100, 120, 80])


def _tp_data():
    """_data() and four traits of its genome, with two missing-phenotype
    patterns (the JAX package's tests/test_parallel.py)."""
    d = _data()
    rng = np.random.default_rng(22)
    y = d["y"]
    Y = np.stack([y, y + rng.normal(size=N), rng.normal(size=N),
                  0.5 * y + rng.normal(size=N)])
    Ym = Y.copy()
    Ym[1, :11] = np.nan
    Ym[2, 5:9] = np.nan
    return dict(d, Y=Y, Ym=Ym, chroms=CHROMS)


_WORKER = r'''
import pickle, sys
import numpy as np
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from mixmogam_tpu_torch.models import resident, streaming
from mixmogam_tpu_torch.models.loco import emmax_loco
from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.models.stepwise import emmax_step_wise
from mixmogam_tpu_torch.parallel import initialize_multihost, make_mesh
from mixmogam_tpu_torch.parallel import mesh as pmesh

rank, world, shape = {rank}, {world}, {shape!r}
initialize_multihost("file://" + {store!r}, world, rank, device="cpu")
mesh = make_mesh(shape, devices="cpu")
z = dict(np.load({data!r}))
G, y, K, Y, Ym = z["G"], z["y"], z["K"], z["Y"], z["Ym"]
t = {tile}
res = {{"mesh": (mesh.shape, mesh.rank, mesh.snp_index, mesh.sample_index)}}

# what each rank is sent of a rotation, and what stepwise stores
held = {{"scattered": [], "stored": []}}
_scatter, _rotate_tiles = pmesh.scatter_from_rank0, streaming.rotate_tiles


def scatter(*a, **k):
    out = _scatter(*a, **k)
    held["scattered"].append(tuple(out.shape))
    return out


def rotate_tiles(*a, **k):
    out = _rotate_tiles(*a, **k)
    held["stored"].append(tuple(out[0].shape))
    return out


pmesh.scatter_from_rank0, streaming.rotate_tiles = scatter, rotate_tiles


def run(name, fn):
    for v in held.values():
        v.clear()
    try:
        res[name] = ("ok", fn())
    except Exception as e:
        res[name] = ("raised", type(e).__name__, str(e))
    res[name + "/held"] = {{k: list(v) for k, v in held.items()}}


rgs = {{f: ResidentGenome.from_source(z[g], tile=t, upload=False)
        for f, g in (("main", "G"), ("miss", "miss"))}}
# ---- stepwise ----
run("sw_k", lambda: emmax_step_wise(G, y, K=K, max_steps={steps}, mesh=mesh,
                                    tile=t))
run("sw_identity", lambda: emmax_step_wise(G, y, K=None, max_steps={steps},
                                           mesh=mesh, tile=t))
run("sw_miss", lambda: emmax_step_wise(z["miss"], y, K=K, max_steps={steps},
                                       mesh=mesh, tile=t))
run("sw_frac", lambda: emmax_step_wise(z["frac"], y, K=K, max_steps={steps},
                                       mesh=mesh, tile=t))
run("sw_cov", lambda: emmax_step_wise(G, y, K=K, X0=z["cov"],
                                      max_steps={steps}, mesh=mesh, tile=t))
run("sw_k_on_rank0", lambda: emmax_step_wise(
    G, y, K=K if rank == 0 else None, max_steps={steps}, mesh=mesh, tile=t))
# the JAX package's stepwise takes a 'sample' axis on n divisible by S: the
# first 96 samples (whole blocks of 48) for the comparison with it
e = 96
for name, Ke, X0e in (("sw_even_k", K[:e, :e], None),
                      ("sw_even_identity", None, None),
                      ("sw_even_cov", K[:e, :e], z["cov"][:e])):
    run(name, lambda: emmax_step_wise(G[:, :e], y[:e], K=Ke, X0=X0e,
                                      max_steps={steps}, mesh=mesh, tile=t))
# ---- multi-trait ----
for tier in {tiers!r}:
    run("mt_incore_" + tier, lambda: emmax_multi_trait(
        G, Y, K=K, mesh=mesh, precision=tier, tile=t))
    run("mt_packed_" + tier, lambda: emmax_multi_trait(
        rgs["main"], Y, K=K, mesh=mesh, precision=tier))
run("mt_miss_incore", lambda: emmax_multi_trait(z["miss"], Y, K=K,
                                                mesh=mesh, tile=t))
run("mt_miss_packed", lambda: emmax_multi_trait(rgs["miss"], Y, K=K,
                                                mesh=mesh))
run("mt_frac_incore", lambda: emmax_multi_trait(z["frac"], Y, K=K,
                                                mesh=mesh, tile=t))
run("mt_cov_incore", lambda: emmax_multi_trait(
    G, Y, K=K, X0=z["cov"], mesh=mesh, precision="int8x3", tile=t))
run("mt_nan_incore", lambda: emmax_multi_trait(G, Ym, K=K, mesh=mesh,
                                               tile=t))
run("mt_nan_miss_incore", lambda: emmax_multi_trait(z["miss"], Ym, K=K,
                                                    mesh=mesh, tile=t))
run("mt_k_on_rank0", lambda: emmax_multi_trait(
    G, Y, K=K if rank == 0 else None, mesh=mesh, tile=t))
# one device's int8x3 calls, in this process: its f_stats are held to the
# mesh's bit for bit
one = ResidentGenome.from_source(G, tile=t, device="cpu")
for name, src in (("mt_one_packed_int8x3", one), ("mt_one_incore_int8x3", G)):
    run(name, lambda: emmax_multi_trait(src, Y, K=K, precision="int8x3",
                                        tile=t, device="cpu"))
# the in-core budget pushed down: an int8 source packs on the host
# (pack_for_mesh), which the CPU allows only with a packed budget
resident.resident_budget_bytes = lambda device: 1 << 40
run("mt_pack_for_mesh", lambda: emmax_multi_trait(
    G, Y, K=K, mesh=mesh, stream_budget_bytes=1, precision="int8x3"))
# ---- LOCO: a container, an int8 array packed on the host, the host route
run("loco_resident", lambda: emmax_loco(rgs["main"], y, chromosomes=z[
    "chroms"], mesh=mesh))
run("loco_int8", lambda: emmax_loco(G, y, chromosomes=z["chroms"],
                                    mesh=mesh))
run("loco_frac", lambda: emmax_loco(z["frac"], y, chromosomes=z["chroms"],
                                    mesh=mesh))
# ---- refusals on every rank, before any collective ----
run("no_mt_nan_packed", lambda: emmax_multi_trait(rgs["main"], Ym, K=K,
                                                  mesh=mesh))
run("no_mt_nan_pack_for_mesh", lambda: emmax_multi_trait(
    G, Ym, K=K, mesh=mesh, stream_budget_bytes=1))
run("no_sw_resident", lambda: emmax_step_wise(rgs["main"], y, K=K,
                                              mesh=mesh))
run("no_loco_int8x3", lambda: emmax_loco(G, y, chromosomes=z["chroms"],
                                         mesh=mesh, precision="int8x3"))
res["shards"] = {{f: [(k[4:], tuple(sh.packed.shape), sh.M, sh.n)
                       for k, sh in rg._shards.items()]
                   for f, rg in rgs.items()}}
with open({out!r}, "wb") as f:
    pickle.dump(res, f)
# no rank tears its group down while another still works (a gloo peer that
# exits first can abort the other's teardown)
dist.barrier()
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def data():
    return _tp_data()


@pytest.fixture(scope="module")
def worlds(data, tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]} of one run of every case
    on each world."""
    d = tmp_path_factory.mktemp("gloo_tp_campaign")
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
                                 out=out, tile=TILE, steps=_STEPS,
                                 tiers=TIERS)
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


def _jax_mesh(world):
    return jmesh.make_mesh(SHAPES[world], devices=jax.devices()[:world])


def _close(got, ref, tol=1e-10):
    np.testing.assert_array_equal(got["mask"], np.asarray(ref["mask"]))
    np.testing.assert_allclose(got["ps"], np.asarray(ref["ps"]), rtol=0,
                               atol=tol)


def _same(a, b) -> None:
    """Rank results equal: arrays bit for bit, dicts and lists entry by
    entry (timings aside: each rank's own clock)."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            if k != "timings_s":
                _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _same(u, v)
    else:
        np.testing.assert_array_equal(a, b)


_SW = ("sw_k", "sw_identity", "sw_miss", "sw_frac", "sw_cov",
       "sw_k_on_rank0", "sw_even_k", "sw_even_identity", "sw_even_cov")
_MT = (tuple(f"mt_{s}_{t}" for s in ("incore", "packed") for t in TIERS)
       + ("mt_miss_incore", "mt_miss_packed", "mt_frac_incore",
          "mt_cov_incore", "mt_nan_incore", "mt_nan_miss_incore",
          "mt_k_on_rank0", "mt_pack_for_mesh"))
_LOCO = ("loco_resident", "loco_int8", "loco_frac")


@pytest.mark.parametrize("case", _SW + _MT + _LOCO)
@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_result(worlds, world, case):
    first = _ok(worlds[world][0], case)
    for res in worlds[world][1:]:
        _same(_ok(res, case), first)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_lie_row_major(worlds, world):
    shape = SHAPES[world]
    for r, res in enumerate(worlds[world]):
        assert res["mesh"] == (shape, r, r // shape[1], r % shape[1])


# ---- stepwise -------------------------------------------------------------

def _sw_inputs(data, case):
    G = {"sw_miss": data["miss"], "sw_frac": data["frac"]}.get(case,
                                                               data["G"])
    K = None if case.endswith("identity") else data["K"]
    X0 = data["cov"] if case.endswith("cov") else None
    y = data["y"]
    if "_even_" in case:
        e = 96
        G, y = G[:, :e], y[:e]
        K = None if K is None else K[:e, :e]
        X0 = None if X0 is None else X0[:e]
    return G, y, K, X0


def _sw_close(got, ref, flat=False):
    """The same path and selections, min_p within 1e-10, BIC within rtol
    1e-8 (delta too, but where the identity kinship's likelihood is flat
    in delta: tests/test_torch_stepwise.py)."""
    assert got["selected"] == ref["selected"]
    assert len(got["steps"]) == len(ref["steps"])
    for a, b in zip(got["steps"], ref["steps"]):
        assert (a["phase"], list(a["cofactors"]), a["min_p_snp"]) == (
            b["phase"], list(b["cofactors"]), b["min_p_snp"])
        np.testing.assert_allclose(a["min_p"], b["min_p"], rtol=0,
                                   atol=1e-10)
        for k in ("bic", "ebic", "mbic") + (() if flat else ("delta",)):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-8)
        np.testing.assert_allclose(a["cofactor_ps"], b["cofactor_ps"],
                                   rtol=0, atol=1e-10)
    assert got["bonf_threshold"] == ref["bonf_threshold"]


@pytest.mark.parametrize("case", _SW)
@pytest.mark.parametrize("world", WORLDS)
def test_stepwise_matches_the_single_device_port(worlds, data, world, case):
    G, y, K, X0 = _sw_inputs(data, case)
    ref = emmax_step_wise(G, y, K=K, X0=X0, max_steps=_STEPS, tile=TILE,
                          device="cpu")
    got = _ok(worlds[world][0], case)
    assert sorted(got) == sorted(ref)
    assert got["timings_s"]["route"] == "stored"
    _sw_close(got, ref)


@pytest.mark.parametrize("case", ["sw_even_k", "sw_even_identity",
                                  "sw_even_cov"])
@pytest.mark.parametrize("world", WORLDS)
def test_stepwise_matches_jax(worlds, data, world, case):
    """The JAX package's emmax_step_wise(mesh=) on the same mesh shape (its
    test_stepwise_mesh_parity), on the first 96 samples: its G_rot's
    sharding over 'sample' takes n divisible by S."""
    G, y, K, X0 = _sw_inputs(data, case)
    ref = jsw.emmax_step_wise(G, y, K=K, X0=X0, max_steps=_STEPS,
                              mesh=_jax_mesh(world))
    got = _ok(worlds[world][0], case)
    assert sorted(ref) == sorted(set(got) - {"timings_s"})
    _sw_close(got, ref, flat=K is None)


@pytest.mark.parametrize("case", _SW)
@pytest.mark.parametrize("world", WORLDS)
def test_each_stepwise_rank_stores_its_block_of_columns(worlds, world, case):
    """Each rank stores its 'snp' rows (host_snp_range at the tile) x its
    block of n_pad / S rotated columns, and holds only its (n, n_pad / S)
    block of U' (K None: no rotation is sent)."""
    shape = SHAPES[world]
    n = 96 if "_even_" in case else N
    block = -(-n // (8 * shape[1])) * 8        # n_pad / S
    for res in worlds[world]:
        _, _, i, _ = res["mesh"]
        lo, hi = host_snp_range(M, shape[0], i, tile=TILE)
        held = res[case + "/held"]
        assert held["stored"] == [(hi - lo, block)]
        want = [] if case.endswith("identity") else [(block, n)]
        assert held["scattered"] == want


# ---- multi-trait ------------------------------------------------------------

def _mt_inputs(data, case):
    """(port source, JAX source, Y, precision, X0) of a multi-trait case."""
    tier = next((t for t in TIERS if case.endswith("_" + t)), None)
    if case in ("mt_cov_incore", "mt_pack_for_mesh"):
        tier = "int8x3"
    G = next((data[f] for f in ("miss", "frac") if f"_{f}_" in case),
             data["G"])
    if "packed" in case or case == "mt_pack_for_mesh":
        tile = 16_384 if case == "mt_pack_for_mesh" else TILE
        src = ResidentGenome.from_source(G, tile=tile, device="cpu")
        jsrc = JResident.from_source(G, tile=tile)
    else:
        src = G
        jsrc = G.astype(np.float64)
        jsrc[G < 0] = np.nan
    Y = data["Ym"] if "_nan_" in case else data["Y"]
    X0 = data["cov"] if case == "mt_cov_incore" else None
    return src, jsrc, Y, tier, X0


def _mt_close(got, ref, tol=1e-10, high=False):
    """Masks equal, p within tol, f_stats within 1e-9, the same REML
    (log delta within 1e-10) and dof; high: the port's 'high' against the
    JAX package's (exact on the CPU), masks equal and p within
    TIER_P_DRIFT['high'], the REML as before."""
    _close(got, ref, HIGH if high else tol)
    if not high:
        np.testing.assert_allclose(got["f_stats"],
                                   np.asarray(ref["f_stats"]), rtol=1e-9,
                                   atol=1e-9)
    np.testing.assert_allclose(np.log(got["deltas"]),
                               np.log(np.asarray(ref["deltas"])), rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(got["dof"], ref["dof"])


@pytest.mark.parametrize("case", _MT)
@pytest.mark.parametrize("world", WORLDS)
def test_multi_trait_matches_the_single_device_port(worlds, data, world,
                                                    case):
    src, _, Y, tier, X0 = _mt_inputs(data, case)
    ref = emmax_multi_trait(src, Y, K=data["K"], X0=X0, precision=tier,
                            tile=TILE, device="cpu")
    got = _ok(worlds[world][0], case)
    assert sorted(got) == sorted(ref)
    assert got["precision_tier"] == ref["precision_tier"]
    _mt_close(got, ref)
    np.testing.assert_allclose(got["betas"], ref["betas"], rtol=1e-9,
                               atol=1e-10)


@pytest.mark.parametrize("case, one", [
    ("mt_packed_int8x3", "mt_one_packed_int8x3"),
    ("mt_pack_for_mesh", "mt_one_packed_int8x3"),
    ("mt_incore_int8x3", "mt_one_incore_int8x3")])
@pytest.mark.parametrize("world", WORLDS)
def test_int8_f_stats_are_bit_equal(worlds, world, case, one):
    """The int8 plane products summed over 'sample' in integers before the
    recombine: f_stats bit-equal to one device's call in the same process
    (the same eigh and REML arithmetic), on every rank, as the JAX
    package's test_multitrait_mesh_resident_source asserts."""
    for res in worlds[world]:
        np.testing.assert_array_equal(_ok(res, case)["f_stats"],
                                      _ok(res, one)["f_stats"])


_MT_JAX = ("mt_incore_exact", "mt_incore_int8x3", "mt_incore_bf16x3",
           "mt_incore_high", "mt_packed_exact", "mt_packed_int8x3",
           "mt_packed_bf16x3", "mt_packed_high", "mt_miss_packed",
           "mt_nan_incore")


@pytest.mark.parametrize("case", _MT_JAX)
@pytest.mark.parametrize("world", WORLDS)
def test_multi_trait_matches_jax(worlds, data, world, case, monkeypatch):
    """The JAX package's emmax_multi_trait(mesh=) on the same mesh shape
    (its test_multitrait_mesh_parity and _resident_source); 'high' within
    TIER_P_DRIFT['high'] of the JAX package's 'high' call, which runs as
    exact here (tests/test_torch_high.py's bound)."""
    src, jsrc, Y, tier, X0 = _mt_inputs(data, case)
    if tier not in (None, "exact", "high"):
        jax_projected(monkeypatch)
    ref = jmt.emmax_multi_trait(jsrc, Y, K=data["K"], precision=tier,
                                mesh=_jax_mesh(world))
    got = _ok(worlds[world][0], case)
    assert sorted(ref) == sorted(set(got) - {"timings_s"})
    _mt_close(got, ref, high=tier == "high")


@pytest.mark.parametrize("case", ["mt_incore_exact", "mt_incore_int8x3",
                                  "mt_packed_bf16x3", "mt_incore_high",
                                  "mt_miss_packed", "mt_nan_incore"])
@pytest.mark.parametrize("world", WORLDS)
def test_each_multi_trait_rank_holds_its_block_of_the_rotation(worlds, world,
                                                               case):
    """One scatter a scan (a missingness group each): the rank's (n_pad / S,
    n) rows of U', or of each digit plane / bf16 part ('high': U''s hi and
    lo); n the group's."""
    for res in worlds[world]:
        got = res[case + "/held"]["scattered"]
        if case == "mt_nan_incore":
            # three groups: all 99 samples, 88 (pad 96) and 95 (pad 96)
            assert sorted(got) == sorted([(BLOCK, N), (48, 88), (48, 95)])
            continue
        lead = ((3,) if case.endswith(("int8x3", "bf16x3")) else
                (2,) if case.endswith("high") else ())
        assert got == [lead + (BLOCK, N)]
        assert res[case + "/held"]["stored"] == []


# ---- LOCO -----------------------------------------------------------------

def _loco_source(data, case):
    return {"loco_resident": ResidentGenome.from_source(
                data["G"], tile=TILE, device="cpu"),
            "loco_int8": data["G"], "loco_frac": data["frac"]}[case]


@pytest.mark.parametrize("case", _LOCO)
@pytest.mark.parametrize("world", WORLDS)
def test_loco_matches_the_single_device_port(worlds, data, world, case):
    """The packed route (a container; an int8 array packed on the host)
    and the host route (fractional dosages): p within 1e-10, masks equal,
    each chromosome's delta within rtol 1e-10."""
    ref = emmax_loco(_loco_source(data, case), data["y"], chromosomes=CHROMS,
                     device="cpu")
    got = _ok(worlds[world][0], case)
    assert sorted(got) == sorted(ref)
    _close(got, ref)
    assert got["dof"] == ref["dof"]
    assert got["loco"].keys() == ref["loco"].keys()
    for c in ref["loco"]:
        np.testing.assert_allclose(got["loco"][c]["delta"],
                                   ref["loco"][c]["delta"], rtol=1e-10)
    np.testing.assert_allclose(got["betas"], ref["betas"], rtol=1e-9,
                               atol=1e-10)


@pytest.mark.parametrize("case", ["loco_resident", "loco_int8"])
@pytest.mark.parametrize("world", WORLDS)
def test_loco_matches_jax(worlds, data, world, case):
    """The JAX package's emmax_loco(mesh=) on the same mesh shape (its
    test_loco_mesh_parity and test_loco_mesh_resident_source)."""
    src = (JResident.from_source(data["G"], tile=TILE)
           if case == "loco_resident" else data["G"])
    ref = j_emmax_loco(src, data["y"], chromosomes=CHROMS, ploidy=1,
                       mesh=_jax_mesh(world))
    got = _ok(worlds[world][0], case)
    _close(got, ref)
    for c in ref["loco"]:
        np.testing.assert_allclose(got["loco"][c]["delta"],
                                   ref["loco"][c]["delta"], rtol=1e-10)


@pytest.mark.parametrize("case", _LOCO)
@pytest.mark.parametrize("world", WORLDS)
def test_each_loco_rank_holds_its_block_of_each_rotation(worlds, world,
                                                         case):
    """One scatter of a (n_pad / S, n) block of U' a chromosome."""
    for res in worlds[world]:
        assert res[case + "/held"]["scattered"] == [(BLOCK, N)] * 3


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_one_byte_block_a_container(worlds, world):
    """A caller's container holds one shard a rank, its 'snp' rows (to the
    tile) x its 14 of the 28 padded bytes, keyed with the mesh's shape and
    the rank's 'sample' coordinate: multi-trait's three tiers and LOCO's
    three chromosomes all read the one upload."""
    shape = SHAPES[world]
    for res in worlds[world]:
        _, _, i, j = res["mesh"]
        lo, hi = host_snp_range(M, shape[0], i, tile=TILE)
        rows = -(-hi // TILE) * TILE - lo
        for f in ("main", "miss"):
            assert res["shards"][f] == [((shape, j), (rows, BLOCK // 4),
                                         hi - lo, BLOCK)]


# ---- refusals ---------------------------------------------------------------

@pytest.mark.parametrize("case, exc, match", [
    ("no_mt_nan_packed", "ValueError", "shards 'snp' only"),
    ("no_mt_nan_pack_for_mesh", "ValueError", "shards 'snp' only"),
    ("no_sw_resident", "ValueError", "host source"),
    ("no_loco_int8x3", "ValueError", "exact tier"),
])
@pytest.mark.parametrize("world", WORLDS)
def test_refusals_raise_on_every_rank(worlds, world, case, exc, match):
    """The JAX package's refusals, before any collective: a missing-Y
    pattern group over a packed container (the caller's, or the one
    pack_for_mesh builds) on a 'sample' axis, stepwise over a container,
    LOCO at a fast tier."""
    for res in worlds[world]:
        kind, name, msg = res[case]
        assert (kind, name) == ("raised", exc)
        assert match in msg
        assert res[case + "/held"]["scattered"] == []
