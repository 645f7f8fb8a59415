"""PyTorch port, mesh= on the three campaign scans (ROADMAP Queue 1 item
16c, first half): emmax_step_wise, emmax_multi_trait (with its
missing-phenotype groups) and emma, over SNP-sharded in-core rows and
host-only packed containers, on gloo worlds of 2 and 3 ranks on the CPU.

The harness is tests/test_torch_parallel.py's: one module fixture runs
both worlds once, each rank a subprocess with one torch thread that joins
its group through a file:// store under the test's directory, runs every
case and pickles its results there; the fixture has its own deadline and
fails with the ranks' output. The data are that file's _data() (main:
n = 120 x 700 binary rows; miss: 300 rows with 4 % missing calls; frac:
imputed fractions). The in-core scans run at a 128-row tile, so the rows
split over every rank; miss at a 256-row tile leaves rank 2 of the world
of 3 with no rows (in core and packed).

Limits: each case within 1e-10 in p of the port's single-device call in
float64 with identical masks (stepwise: the same cofactors, min_p SNPs and
selections, bic within rtol 1e-10), and within 1e-10 in p of the JAX
package's own mesh= call under x64 on the conftest's 8-device mesh
(multi-trait's fast tiers with the JAX reference quantizing the port's
U' = (I - P_X0) U, test_torch_multitrait.jax_projected; EMMA within
tests/test_torch_emma.py's bound against JAX: 1e-8 in p, 1e-6 in log
delta; 'high' within TIER_P_DRIFT['high'] of the JAX package's 'high'
call, which runs as exact on the CPU, with identical masks). The refusals
raise on every rank."""

import os
import pickle
import subprocess
import sys
import time

import importlib

import jax
import numpy as np
import pytest
import torch

from mixmogam_tpu.models import multitrait as jmt
from mixmogam_tpu.models import stepwise as jsw
from mixmogam_tpu.models.resident import ResidentGenome as JResident
from mixmogam_tpu.parallel import mesh as jmesh
from mixmogam_tpu_torch.models.emma import emma
from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.models.stepwise import emmax_step_wise
from mixmogam_tpu_torch.ops.scan import TIER_P_DRIFT
from test_torch_multitrait import jax_projected
from test_torch_parallel import _data

jemma = importlib.import_module("mixmogam_tpu.models.emma")
torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 3)
TIERS = ("exact", "int8x3", "bf16x3", "high")
#: the 'high' tier's drift entry (against the JAX package, which runs
#: 'high' as its exact tier on the CPU; tests/test_torch_high.py)
HIGH = TIER_P_DRIFT["high"]
#: the in-core scans' tile and the containers' (main's rows split over
#: every rank; miss's 300 rows leave rank 2 of the world of 3 with none)
_TILE = {"main": 128, "missing": 256}
_STEPS = 3


def _campaign_data():
    """_data() and four traits of main's genome, with the missing-phenotype
    patterns of the JAX package's test (tests/test_parallel.py)."""
    d = _data()
    rng = np.random.default_rng(21)
    y = d["y"]
    Y = np.stack([y, y + rng.normal(size=y.size), rng.normal(size=y.size),
                  0.5 * y + rng.normal(size=y.size)])
    Ym = Y.copy()
    Ym[1, :11] = np.nan
    Ym[2, 5:9] = np.nan
    return dict(d, Y=Y, Ym=Ym)


_WORKER = r'''
import pickle, sys
import numpy as np
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from mixmogam_tpu_torch.models import resident
from mixmogam_tpu_torch.models.emma import emma
from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.models.stepwise import emmax_step_wise
from mixmogam_tpu_torch.parallel import (initialize_multihost,
                                         make_global_snp_array, make_mesh)
from mixmogam_tpu_torch.parallel.multihost import host_snp_range

rank, world = {rank}, {world}
initialize_multihost("file://" + {store!r}, world, rank, device="cpu")
mesh = make_mesh(devices="cpu")
z = dict(np.load({data!r}))
tiles = {tiles!r}
res = {{}}


def run(name, fn):
    try:
        res[name] = ("ok", fn())
    except Exception as e:
        res[name] = ("raised", type(e).__name__, str(e))


rgs = {{f: ResidentGenome.from_source(z[g], tile=tiles[f], upload=False)
        for f, g in (("main", "G"), ("missing", "miss"))}}
G, y, K, Y, Ym = z["G"], z["y"], z["K"], z["Y"], z["Ym"]
t, tm = tiles["main"], tiles["missing"]

# ---- stepwise ----
run("sw_k", lambda: emmax_step_wise(G, y, K=K, max_steps={steps}, mesh=mesh,
                                    tile=t))
run("sw_identity", lambda: emmax_step_wise(G, y, K=None, max_steps={steps},
                                           mesh=mesh, tile=t))
run("sw_missing", lambda: emmax_step_wise(z["miss"], y, K=K,
                                          max_steps={steps}, mesh=mesh,
                                          tile=tm))
run("sw_k_on_rank0", lambda: emmax_step_wise(
    G, y, K=K if rank == 0 else None, max_steps={steps}, mesh=mesh, tile=t))
# ---- multi-trait ----
for tier in {tiers!r}:
    run("mt_incore_" + tier, lambda: emmax_multi_trait(
        G, Y, K=K, mesh=mesh, precision=tier, tile=t))
    run("mt_packed_" + tier, lambda: emmax_multi_trait(
        rgs["main"], Y, K=K, mesh=mesh, precision=tier))
run("mt_k_on_rank0", lambda: emmax_multi_trait(
    G, Y, K=K if rank == 0 else None, mesh=mesh, tile=t))
run("mt_nan_incore", lambda: emmax_multi_trait(G, Ym, K=K, mesh=mesh,
                                               tile=t))
run("mt_nan_packed", lambda: emmax_multi_trait(rgs["main"], Ym, K=K,
                                               mesh=mesh))
run("mt_nan_packed_int8x3", lambda: emmax_multi_trait(
    rgs["main"], Ym, K=K, mesh=mesh, precision="int8x3"))
run("mt_missing_incore", lambda: emmax_multi_trait(z["miss"], Ym, K=K,
                                                   mesh=mesh, tile=tm))
run("mt_missing_packed", lambda: emmax_multi_trait(rgs["missing"], Y, K=K,
                                                   mesh=mesh))
# the in-core budget pushed down: an int8 source packs on the host
# (pack_for_mesh), which the CPU allows only with a packed budget
resident.resident_budget_bytes = lambda device: 1 << 40
u0 = ResidentGenome.packs
run("mt_pack_for_mesh", lambda: emmax_multi_trait(
    G, Y, K=K, mesh=mesh, stream_budget_bytes=1, precision="int8x3"))
res["packs_for_mesh"] = ResidentGenome.packs - u0
run("mt_pack_float", lambda: emmax_multi_trait(
    z["frac"], Y, K=K, mesh=mesh, stream_budget_bytes=1))
# ---- EMMA ----
for test in ("f", "lrt"):
    run("emma_incore_" + test, lambda: emma(G, y, K=K, mesh=mesh, tile=t,
                                            test=test))
    run("emma_packed_" + test, lambda: emma(rgs["main"], y, K=K, mesh=mesh,
                                            test=test))
run("emma_k_on_rank0", lambda: emma(G, y, K=K if rank == 0 else None,
                                    mesh=mesh, tile=t))
run("emma_missing_incore", lambda: emma(z["miss"], y, K=K, mesh=mesh,
                                        tile=tm))
run("emma_missing_packed", lambda: emma(rgs["missing"], y, K=K, mesh=mesh))
# ---- refusals ----
M = G.shape[0]
lo, hi = host_snp_range(M, world, rank)
shard = make_global_snp_array(G[lo:hi], M, mesh)
run("no_sw_resident", lambda: emmax_step_wise(rgs["main"], y, K=K,
                                              mesh=mesh))
run("no_sw_budget", lambda: emmax_step_wise(G, y, K=K, mesh=mesh,
                                            rot_budget_bytes=1))
run("no_mt_fast", lambda: emmax_multi_trait(G, Y, K=K, mesh=mesh,
                                            precision="fast"))
run("no_mt_int8_missing", lambda: emmax_multi_trait(
    z["miss"], Y, K=K, mesh=mesh, precision="int8x3"))
run("no_mt_int8_packed_missing", lambda: emmax_multi_trait(
    rgs["missing"], Y, K=K, mesh=mesh, precision="int8x3"))
run("no_sw_shard", lambda: emmax_step_wise(shard, y, K=K, mesh=mesh))
run("no_mt_shard", lambda: emmax_multi_trait(shard, Y, K=K, mesh=mesh))
run("no_emma_shard", lambda: emma(shard, y, K=K, mesh=mesh))
res["shard_rows"] = {{f: [sh.M for sh in rg._shards.values()]
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
    return _campaign_data()


@pytest.fixture(scope="module")
def worlds(data, tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]} of one run of every case
    on each world."""
    d = tmp_path_factory.mktemp("gloo_campaign")
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
                                 store=store, data=dpath, out=out,
                                 tiles=_TILE, steps=_STEPS, tiers=TIERS)
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


def _jax_mesh():
    return jmesh.make_mesh((8, 1), devices=jax.devices()[:8])


def _close(got, ref, tol=1e-10):
    np.testing.assert_array_equal(got["mask"], np.asarray(ref["mask"]))
    np.testing.assert_allclose(got["ps"], np.asarray(ref["ps"]), rtol=0,
                               atol=tol)


_SW = ("sw_k", "sw_identity", "sw_missing", "sw_k_on_rank0")
_MT = (tuple(f"mt_{s}_{t}" for s in ("incore", "packed") for t in TIERS)
       + ("mt_k_on_rank0", "mt_nan_incore", "mt_nan_packed",
          "mt_nan_packed_int8x3", "mt_missing_incore", "mt_missing_packed",
          "mt_pack_for_mesh"))
_EMMA = (tuple(f"emma_{s}_{t}" for s in ("incore", "packed")
               for t in ("f", "lrt"))
         + ("emma_k_on_rank0", "emma_missing_incore", "emma_missing_packed"))


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


@pytest.mark.parametrize("case", _SW + _MT + _EMMA)
@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_result(worlds, world, case):
    first = _ok(worlds[world][0], case)
    for res in worlds[world][1:]:
        _same(_ok(res, case), first)


# ---- stepwise -----------------------------------------------------------

def _sw_inputs(data, case):
    G = data["miss"] if case == "sw_missing" else data["G"]
    K = None if case == "sw_identity" else data["K"]
    return G, data["y"], K


def _sw_close(got, ref, flat=False):
    """The same path and selections, min_p within 1e-10 and the criteria
    within rtol 1e-10. flat: the identity kinship, whose likelihood is flat
    in delta (tests/test_torch_stepwise.py), so delta is not compared."""
    assert got["selected"] == ref["selected"]
    assert len(got["steps"]) == len(ref["steps"])
    for a, b in zip(got["steps"], ref["steps"]):
        assert (a["phase"], list(a["cofactors"]), a["min_p_snp"]) == (
            b["phase"], list(b["cofactors"]), b["min_p_snp"])
        np.testing.assert_allclose(a["min_p"], b["min_p"], rtol=0,
                                   atol=1e-10)
        for k in ("bic", "ebic", "mbic") + (() if flat else ("delta",)):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-10)
        np.testing.assert_allclose(a["cofactor_ps"], b["cofactor_ps"],
                                   rtol=0, atol=1e-10)
    assert got["bonf_threshold"] == ref["bonf_threshold"]


@pytest.mark.parametrize("case", _SW)
@pytest.mark.parametrize("world", WORLDS)
def test_stepwise_matches_the_single_device_port(worlds, data, world, case):
    G, y, K = _sw_inputs(data, case)
    tile = _TILE["missing" if case == "sw_missing" else "main"]
    got = _ok(worlds[world][0], case)
    ref = emmax_step_wise(G, y, K=K, max_steps=_STEPS, tile=tile,
                          device="cpu")
    assert sorted(got) == sorted(ref)
    assert got["timings_s"]["route"] == "stored"
    _sw_close(got, ref)


@pytest.mark.parametrize("case", _SW)
def test_stepwise_matches_jax(worlds, data, case):
    G, y, K = _sw_inputs(data, case)
    Gj = G.astype(np.float64)
    Gj[G < 0] = np.nan
    ref = jsw.emmax_step_wise(Gj if case == "sw_missing" else G, y, K=K,
                              max_steps=_STEPS, mesh=_jax_mesh())
    for w in WORLDS:
        got = _ok(worlds[w][0], case)
        assert sorted(ref) == sorted(set(got) - {"timings_s"})
        _sw_close(got, ref, flat=K is None)


# ---- multi-trait ----------------------------------------------------------

def _mt_inputs(data, case):
    """(port source, JAX source, Y, precision) of a multi-trait case."""
    tier = next((t for t in TIERS if case.endswith("_" + t)), None)
    packed = "packed" in case or case == "mt_pack_for_mesh"
    missing = case.startswith("mt_missing")
    g, f = ("miss", "missing") if missing else ("G", "main")
    G = data[g]
    if packed:
        tile = 16_384 if case == "mt_pack_for_mesh" else _TILE[f]
        src = ResidentGenome.from_source(G, tile=tile, device="cpu")
        jsrc = JResident.from_source(G, tile=tile)
    else:
        src = G
        jsrc = G.astype(np.float64)
        jsrc[G < 0] = np.nan
    Y = data["Ym"] if ("nan" in case or case == "mt_missing_incore") \
        else data["Y"]
    if case == "mt_pack_for_mesh":
        tier = "int8x3"
    return src, jsrc, Y, tier


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
    src, _, Y, tier = _mt_inputs(data, case)
    tile = _TILE["missing" if case == "mt_missing_incore" else "main"]
    ref = emmax_multi_trait(src, Y, K=data["K"], precision=tier, tile=tile,
                            device="cpu")
    got = _ok(worlds[world][0], case)
    assert sorted(got) == sorted(ref)
    assert got["precision_tier"] == ref["precision_tier"]
    _mt_close(got, ref)
    np.testing.assert_allclose(got["betas"], ref["betas"], rtol=1e-9,
                               atol=1e-10)


@pytest.mark.parametrize("case", _MT)
def test_multi_trait_matches_jax(worlds, data, case, monkeypatch):
    """The JAX package's emmax_multi_trait(mesh=) on the conftest's mesh;
    'high' within TIER_P_DRIFT['high'] of the JAX package's 'high' call,
    which runs as exact here (tests/test_torch_high.py's bound)."""
    src, jsrc, Y, tier = _mt_inputs(data, case)
    if tier not in (None, "exact", "high"):
        jax_projected(monkeypatch)
    ref = jmt.emmax_multi_trait(jsrc, Y, K=data["K"], precision=tier,
                                mesh=_jax_mesh())
    for w in WORLDS:
        got = _ok(worlds[w][0], case)
        assert sorted(ref) == sorted(set(got) - {"timings_s"})
        _mt_close(got, ref, high=tier == "high")


@pytest.mark.parametrize("world", WORLDS)
def test_an_int8_source_over_the_budget_packs_on_the_host(worlds, world):
    """pack_for_mesh ran once on every rank (ResidentGenome.packs); a float
    source over the budget is refused on every rank, as in the JAX
    package."""
    for res in worlds[world]:
        assert res["packs_for_mesh"] == 1
        kind, name, msg = res["mt_pack_float"]
        assert (kind, name) == ("raised", "ValueError")
        assert "exceeds both" in msg


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_its_shard(worlds, data, world):
    """The host-only containers went up a shard a rank (host_snp_range at
    the container's tile); rank 2 of the world of 3 holds none of miss."""
    from mixmogam_tpu_torch.parallel.multihost import host_snp_range

    for rank, res in enumerate(worlds[world]):
        for f, g in (("main", "G"), ("missing", "miss")):
            lo, hi = host_snp_range(data[g].shape[0], world, rank,
                                    tile=_TILE[f])
            assert res["shard_rows"][f] == [hi - lo]
    if world == 3:
        assert worlds[3][2]["shard_rows"]["missing"] == [0]


# ---- EMMA -----------------------------------------------------------------

def _emma_inputs(data, case):
    missing = "missing" in case
    G = data["miss"] if missing else data["G"]
    f = "missing" if missing else "main"
    test = "lrt" if case.endswith("lrt") else "f"
    if "packed" in case:
        return (ResidentGenome.from_source(G, tile=_TILE[f], device="cpu"),
                JResident.from_source(G, tile=_TILE[f]), test, f)
    jsrc = G.astype(np.float64)
    jsrc[G < 0] = np.nan
    mu = np.nanmean(jsrc, axis=1)
    return G, np.where(np.isnan(jsrc), mu[:, None], jsrc), test, f


@pytest.mark.parametrize("case", _EMMA)
@pytest.mark.parametrize("world", WORLDS)
def test_emma_matches_the_single_device_port(worlds, data, world, case):
    src, _, test, f = _emma_inputs(data, case)
    ref = emma(src, data["y"], K=data["K"], tile=_TILE[f], test=test,
               device="cpu")
    got = _ok(worlds[world][0], case)
    assert sorted(got) == sorted(ref)
    assert set(got["timings_s"]) == set(ref["timings_s"])
    _close(got, ref)
    m = ref["mask"]
    for k in ("deltas", "f_stats", "betas", "lls"):
        np.testing.assert_allclose(got[k][m], ref[k][m], rtol=1e-9,
                                   atol=1e-12)


@pytest.mark.parametrize("case", _EMMA)
def test_emma_matches_jax(worlds, data, case):
    """The JAX package's emma(mesh=) under x64, at tests/test_torch_emma.py's
    bound (1e-8 in p, 1e-6 in log delta)."""
    _, jsrc, test, f = _emma_inputs(data, case)
    ref = jemma.emma(jsrc, data["y"], K=data["K"], tile=_TILE[f], test=test,
                     mesh=_jax_mesh())
    for w in WORLDS:
        got = _ok(worlds[w][0], case)
        assert sorted(ref) == sorted(set(got) - {"timings_s"})
        _close(got, ref, tol=1e-8)
        m = got["mask"]
        np.testing.assert_allclose(np.log(got["deltas"][m]),
                                   np.log(np.asarray(ref["deltas"])[m]),
                                   rtol=0, atol=1e-6)


# ---- refusals on every rank -------------------------------------------------

@pytest.mark.parametrize("case, exc, match", [
    ("no_sw_resident", "ValueError", "host source"),
    ("no_sw_budget", "ValueError", "rot_budget_bytes"),
    ("no_mt_fast", "ValueError", "no rescore pass"),
    ("no_mt_int8_missing", "ValueError", "exact integer dosages"),
    ("no_mt_int8_packed_missing", "ValueError", "fully-observed"),
    ("no_sw_shard", "TypeError", "SnpShard"),
    ("no_mt_shard", "TypeError", "SnpShard"),
    ("no_emma_shard", "TypeError", "SnpShard"),
])
@pytest.mark.parametrize("world", WORLDS)
def test_refusals_raise_on_every_rank(worlds, world, case, exc, match):
    for res in worlds[world]:
        kind, name, msg = res[case]
        assert (kind, name) == ("raised", exc)
        assert match in msg


@pytest.mark.parametrize("entry", ["emma", "emmax_multi_trait",
                                   "emmax_step_wise"])
def test_the_entry_points_take_only_a_mesh(data, entry):
    fn = {"emma": lambda m: emma(data["G"], data["y"], K=data["K"], mesh=m),
          "emmax_multi_trait": lambda m: emmax_multi_trait(
              data["G"], data["Y"], K=data["K"], mesh=m),
          "emmax_step_wise": lambda m: emmax_step_wise(
              data["G"], data["y"], K=data["K"], mesh=m)}[entry]
    with pytest.raises(TypeError, match="make_mesh"):
        fn(object())
