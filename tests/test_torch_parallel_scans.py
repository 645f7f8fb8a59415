"""PyTorch port, mesh= on the five remaining scans (ROADMAP Queue 1 item
16c, second half): emmax_gxe, emmax_perm_test, the class tests
(linear_model, anova, kruskal_wallis), emmax_two_snps and emmax_anova's
diploid test, over SNP-sharded in-core rows and host-only packed
containers, on gloo worlds of 2 and 3 ranks on the CPU.

The harness is tests/test_torch_parallel.py's: one module fixture runs
both worlds once, each rank a subprocess with one torch thread that joins
its group through a file:// store under the test's directory, runs every
case and pickles its results there; the fixture has its own deadline and
fails with the ranks' output. The data are that file's _data() (main:
n = 120 x 700 binary rows; miss: 300 rows with 4 % missing calls; dip:
400 diploid rows) with two environments, a tied phenotype for
Kruskal-Wallis and dip with 3 % missing calls. The in-core scans run at a
128-row tile (the class sums' host chunk and GxE's tile set to 128 rows
in the ranks and in the references alike), so main's rows split over
every rank; miss at a 256-row tile (its container's and the in-core
calls') leaves rank 2 of the world of 3 with no rows.

Limits: each case within 1e-10 in p of the port's single-device call in
float64 with identical masks (the permutation test: min_ps and threshold;
GxE: also rescored_idx), and within the bound of the entry point's own
single-device JAX test of the JAX package's mesh= call under x64 on the
conftest's 8-device mesh: 1e-8 in p (GxE, two-SNP, the class tests,
emmax_anova; the permutation test 1e-8 relative in min_ps and threshold,
its fast tiers with the JAX reference quantizing the port's U' =
(I - P_X0) U, test_torch_multitrait.jax_projected). GxE's fast tiers hold
to the JAX package's exact call within the fast tiers' bound against
exact (1e-4, test_torch_gxe.py) with identical masks: the JAX package's
own fast tiers quantize the unprojected U and e o U. 'high' (GxE in core
and packed, the permutation test packed) is held to one device as every
tier is, and to the JAX package's 'high' call, which runs as exact on the
CPU, within TIER_P_DRIFT['high'] (GXE_P_DRIFT['high'] for GxE) with
identical masks, tests/test_torch_high.py's bounds; in core the
permutation test refuses it as the JAX package does. The refusals raise
on every rank."""

import dataclasses
import importlib
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
from mixmogam_tpu.parallel import mesh as jmesh
from mixmogam_tpu_torch.models import gxe, linear
from mixmogam_tpu_torch.models.emmax import emmax_anova
from mixmogam_tpu_torch.models.permutation import emmax_perm_test
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.models.twosnp import emmax_two_snps
from mixmogam_tpu_torch.ops.scan import GXE_P_DRIFT, TIER_P_DRIFT
from mixmogam_tpu_torch.parallel import make_mesh
from test_torch_multitrait import jax_projected
from test_torch_parallel import _data

jemmax = importlib.import_module("mixmogam_tpu.models.emmax")
jgxe = importlib.import_module("mixmogam_tpu.models.gxe")
jlin = importlib.import_module("mixmogam_tpu.models.linear")
jperm = importlib.import_module("mixmogam_tpu.models.permutation")
jtwo = importlib.import_module("mixmogam_tpu.models.twosnp")
torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 3)
TIERS = ("exact", "int8x3", "bf16x3", "high")
#: the 'high' tier's drift entries (against the JAX package, which runs
#: 'high' as its exact tier on the CPU; tests/test_torch_high.py)
HIGH, GXE_HIGH = TIER_P_DRIFT["high"], GXE_P_DRIFT["high"]
#: the containers' tiles and the in-core calls' (main's and dip's rows
#: split over every rank; miss's 300 rows at 256 leave rank 2 of 3 none)
_TILE = {"main": 128, "missing": 256, "dip": 128}
#: the class sums' host chunk and GxE's tile in the ranks and references
_ROWS = 128
_PERMS = 16
_FOCAL = {"main": [3, 41, 100, 650], "missing": [3, 41, 100, 290]}


def _scans_data():
    """_data(), two environments (N(0, 1) and 0/1), y rounded for
    Kruskal-Wallis's tie groups, dip with 3 % missing calls, and a prior
    scan's p-values for from_result."""
    d = _data()
    rng = np.random.default_rng(23)
    n = d["y"].size
    dipm = d["dip"].copy()
    dipm[rng.random(dipm.shape) < 0.03] = -1
    env = np.column_stack([rng.normal(size=n), (rng.random(n) < 0.5) * 1.0])
    return dict(d, env=env, yt=np.round(d["y"], 1), dipm=dipm,
                prior=rng.random(d["G"].shape[0]))


_WORKER = r'''
import pickle, sys
import numpy as np
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from mixmogam_tpu_torch.models import gxe, linear
from mixmogam_tpu_torch.models.emmax import emmax_anova
from mixmogam_tpu_torch.models.gxe import emmax_gxe
from mixmogam_tpu_torch.models.linear import (anova, kruskal_wallis,
                                              linear_model)
from mixmogam_tpu_torch.models.permutation import emmax_perm_test
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.models.twosnp import emmax_two_snps
from mixmogam_tpu_torch.parallel import (initialize_multihost,
                                         make_global_snp_array, make_mesh)
from mixmogam_tpu_torch.parallel.multihost import host_snp_range

rank, world = {rank}, {world}
initialize_multihost("file://" + {store!r}, world, rank, device="cpu")
mesh = make_mesh(devices="cpu")
linear._CLASS_ROWS = {rows}
gxe._scan_rows = lambda E: {rows}
z = dict(np.load({data!r}))
tiles, focal, P = {tiles!r}, {focal!r}, {perms}
res = {{}}


def run(name, fn):
    try:
        res[name] = ("ok", fn())
    except Exception as e:
        res[name] = ("raised", type(e).__name__, str(e))


rgs = {{f: ResidentGenome.from_source(z[g], tile=tiles[f], upload=False)
        for f, g in (("main", "G"), ("missing", "miss"), ("dip", "dip"))}}
G, y, K, env = z["G"], z["y"], z["K"], z["env"]
K0 = K if rank == 0 else None
t, tm = tiles["main"], tiles["missing"]
srcs = {{"incore": (G, t), "missing_incore": (z["miss"], tm),
         "packed": (rgs["main"], t), "missing_packed": (rgs["missing"], tm)}}
# ---- the class tests ----
for s, (src, tt) in srcs.items():
    run("lm_" + s, lambda: linear_model(src, y, mesh=mesh, tile=tt))
for s, src in (("incore", G), ("dip", z["dip"]), ("missing", z["miss"]),
               ("packed", rgs["main"]), ("dip_packed", rgs["dip"]),
               ("missing_packed", rgs["missing"])):
    run("an_" + s, lambda: anova(src, y, mesh=mesh))
for s, src, tt in (("incore", G, t), ("dip", z["dip"], t),
                   ("missing", z["miss"], tm), ("dipm", z["dipm"], t),
                   ("packed", rgs["main"], t),
                   ("missing_packed", rgs["missing"], t)):
    run("kw_" + s, lambda: kruskal_wallis(src, z["yt"], mesh=mesh, tile=tt))
# ---- emmax_anova ----
run("ea_dip", lambda: emmax_anova(z["dip"], y, K=K, mesh=mesh, tile=t))
run("ea_dipm", lambda: emmax_anova(z["dipm"], y, K=K, mesh=mesh, tile=t))
run("ea_k_on_rank0", lambda: emmax_anova(z["dip"], y, K=K0, mesh=mesh,
                                         tile=t))
run("ea_binary", lambda: emmax_anova(G, y, K=K, mesh=mesh, tile=t))
# ---- the permutation test ----
for s, (src, tt) in srcs.items():
    run("perm_" + s, lambda: emmax_perm_test(src, y, K=K, num_perm=P,
                                             seed=3, tile=tt, mesh=mesh))
for tier in {tiers!r}[1:]:
    run("perm_packed_" + tier, lambda: emmax_perm_test(
        rgs["main"], y, K=K, num_perm=P, seed=3, precision=tier,
        mesh=mesh))
run("perm_identity", lambda: emmax_perm_test(G, y, num_perm=P, seed=3,
                                             tile=t, mesh=mesh))
run("perm_identity_packed", lambda: emmax_perm_test(
    rgs["main"], y, num_perm=P, seed=3, mesh=mesh))
run("perm_k_on_rank0", lambda: emmax_perm_test(G, y, K=K0, num_perm=P,
                                               seed=3, tile=t, mesh=mesh))
# ---- GxE ----
for s, (src, tt) in srcs.items():
    run("gxe_" + s, lambda: emmax_gxe(src, y, env, K=K, mesh=mesh))
for tier in {tiers!r}[1:]:
    run("gxe_incore_" + tier, lambda: emmax_gxe(G, y, env, K=K, mesh=mesh,
                                                precision=tier))
    run("gxe_packed_" + tier, lambda: emmax_gxe(
        rgs["main"], y, env, K=K, mesh=mesh, precision=tier))
run("gxe_single_env", lambda: emmax_gxe(G, y, env[:, 0], K=K, mesh=mesh))
run("gxe_rescore", lambda: emmax_gxe(G, y, env, K=K, mesh=mesh,
                                     precision="bf16x3", rescore_top=8))
run("gxe_k_on_rank0", lambda: emmax_gxe(G, y, env, K=K0, mesh=mesh))
# ---- two-SNP ----
for s, (src, tt) in srcs.items():
    f = focal["missing" if s.startswith("missing") else "main"]
    run("two_" + s, lambda: emmax_two_snps(src, y, K=K, focal_idx=f,
                                           tile=tt, mesh=mesh))
run("two_refit", lambda: emmax_two_snps(G, y, K=K, focal_idx=focal["main"],
                                        tile=t, mesh=mesh,
                                        refit_delta_per_focal=True))
run("two_from_result", lambda: emmax_two_snps(
    G, y, K=K, from_result={{"ps": z["prior"]}}, top_k=3, tile=t,
    mesh=mesh))
run("two_k_on_rank0", lambda: emmax_two_snps(G, y, K=K0,
                                             focal_idx=focal["main"],
                                             tile=t, mesh=mesh))
# ---- refusals ----
M = G.shape[0]
lo, hi = host_snp_range(M, world, rank)
shard = make_global_snp_array(G[lo:hi], M, mesh)
run("no_gxe_int8_missing", lambda: emmax_gxe(z["miss"], y, env, K=K,
                                             mesh=mesh, precision="int8x3"))
run("no_gxe_int8_packed_missing", lambda: emmax_gxe(
    rgs["missing"], y, env, K=K, mesh=mesh, precision="int8x3"))
run("no_gxe_k", lambda: emmax_gxe(G, y, env, mesh=mesh))
run("no_perm_host_tier", lambda: emmax_perm_test(G, y, K=K, mesh=mesh,
                                                 precision="int8x3"))
run("no_perm_host_high", lambda: emmax_perm_test(G, y, K=K, mesh=mesh,
                                                 precision="high"))
run("no_perm_int8_missing", lambda: emmax_perm_test(
    rgs["missing"], y, K=K, mesh=mesh, precision="int8x2"))
run("no_two_k", lambda: emmax_two_snps(G, y, focal_idx=[1], mesh=mesh))
run("no_two_focal", lambda: emmax_two_snps(G, y, K=K, mesh=mesh))
run("no_ea_tier", lambda: emmax_anova(z["dip"], y, K=K, mesh=mesh,
                                      precision="bf16x3"))
for name, fn in (("lm", linear_model), ("an", anova),
                 ("kw", kruskal_wallis)):
    run(f"no_{{name}}_shard", lambda: fn(shard, y, mesh=mesh))
run("no_gxe_shard", lambda: emmax_gxe(shard, y, env, K=K, mesh=mesh))
run("no_perm_shard", lambda: emmax_perm_test(shard, y, K=K, mesh=mesh))
run("no_two_shard", lambda: emmax_two_snps(shard, y, K=K, focal_idx=[1],
                                           mesh=mesh))
run("no_ea_shard", lambda: emmax_anova(shard, y, K=K, mesh=mesh))
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
    return _scans_data()


@pytest.fixture(scope="module")
def worlds(data, tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]} of one run of every case
    on each world."""
    d = tmp_path_factory.mktemp("gloo_scans")
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
                                 tiles=_TILE, rows=_ROWS, focal=_FOCAL,
                                 perms=_PERMS, tiers=TIERS)
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


@pytest.fixture
def small_tiles(monkeypatch):
    """The ranks' class-sum chunk and GxE tile in this process too."""
    monkeypatch.setattr(linear, "_CLASS_ROWS", _ROWS)
    monkeypatch.setattr(gxe, "_scan_rows", lambda E: _ROWS)


def _ok(res, name):
    assert res[name][0] == "ok", res[name]
    return res[name][1]


def _jax_mesh():
    return jmesh.make_mesh((8, 1), devices=jax.devices()[:8])


def _close_p(got, ref, keys, tol=1e-10):
    for k in keys:
        np.testing.assert_allclose(got[k], np.asarray(ref[k]), rtol=0,
                                   atol=tol, err_msg=k)


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


def _tier(case):
    """A case's precision: the tier its name ends with, else None."""
    return next((t for t in TIERS[1:] if case.endswith("_" + t)), None)


#: the quantized tiers (the JAX reference quantizes the port's U')
_FAST = ("int8x3", "bf16x3")


def _source(data, case, jax_side=False):
    """(source, fixture) of a case: main, miss or dip (dipm for the cases
    named so) in core, or a container of it on the CPU at its tile (the
    JAX package's container for jax_side)."""
    f = ("missing" if "missing" in case else
         "dip" if "_dip" in case else "main")
    g = {"main": "G", "missing": "miss", "dip": "dip"}[f]
    if case.endswith("_dipm"):
        g = "dipm"
    if "packed" in case:
        return ((JResident.from_source(data[g], tile=_TILE[f]) if jax_side
                 else ResidentGenome.from_source(data[g], tile=_TILE[f],
                                                 device="cpu")), f)
    return data[g], f


# ---- the class tests --------------------------------------------------------

_LM = tuple("lm_" + s for s in ("incore", "missing_incore", "packed",
                                "missing_packed"))
_AN = tuple("an_" + s for s in ("incore", "dip", "missing", "packed",
                                "dip_packed", "missing_packed"))
_KW = tuple("kw_" + s for s in ("incore", "dip", "missing", "dipm",
                                "packed", "missing_packed"))
_EA = ("ea_dip", "ea_dipm", "ea_k_on_rank0", "ea_binary")
_PERM = (tuple("perm_" + s for s in ("incore", "missing_incore", "packed",
                                     "missing_packed"))
         + tuple("perm_packed_" + t for t in TIERS[1:])
         + ("perm_identity", "perm_identity_packed", "perm_k_on_rank0"))
_GXE = (tuple("gxe_" + s for s in ("incore", "missing_incore", "packed",
                                   "missing_packed"))
        + tuple(f"gxe_{s}_{t}" for s in ("incore", "packed")
                for t in TIERS[1:])
        + ("gxe_single_env", "gxe_rescore", "gxe_k_on_rank0"))
_TWO = (tuple("two_" + s for s in ("incore", "missing_incore", "packed",
                                   "missing_packed"))
        + ("two_refit", "two_from_result", "two_k_on_rank0"))


@pytest.mark.parametrize("case", _LM + _AN + _KW + _EA + _PERM + _GXE
                         + _TWO)
@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_returns_the_same_result(worlds, world, case):
    first = _ok(worlds[world][0], case)
    for res in worlds[world][1:]:
        _same(_ok(res, case), first)


def _class_call(data, case, jax_side=False):
    """The single-device call of a class-test case, the port's on the CPU
    or the JAX package's (mesh= added by the caller)."""
    src, f = _source(data, case, jax_side)
    mod = jlin if jax_side else linear
    kw = {} if jax_side else {"device": "cpu"}
    if case.startswith("lm_"):
        if jax_side and not isinstance(src, JResident):
            src = src.astype(np.float64)
            src[data[{"main": "G", "missing": "miss"}[f]] < 0] = np.nan
        return lambda **m: mod.linear_model(src, data["y"], tile=_TILE[f],
                                            **kw, **m)
    if case.startswith("an_"):
        return lambda **m: mod.anova(src, data["y"], **kw, **m)
    tile = _TILE["missing"] if case == "kw_missing" else _TILE["main"]
    return lambda **m: mod.kruskal_wallis(src, data["yt"], tile=tile, **kw,
                                          **m)


def _class_close(got, ref, tol=1e-10):
    if "mask" in ref:
        np.testing.assert_array_equal(got["mask"], np.asarray(ref["mask"]))
    np.testing.assert_array_equal(got["ps"] < 1, np.asarray(ref["ps"]) < 1)
    stat = "stats" if "stats" in ref else "f_stats"
    _close_p(got, ref, ("ps",), tol)
    np.testing.assert_allclose(got[stat], np.asarray(ref[stat]), rtol=1e-9,
                               atol=1e-9)


@pytest.mark.parametrize("case", _LM + _AN + _KW)
@pytest.mark.parametrize("world", WORLDS)
def test_class_tests_match_the_single_device_port(worlds, data, world, case,
                                                  small_tiles):
    ref = _class_call(data, case)()
    got = _ok(worlds[world][0], case)
    assert sorted(got) == sorted(ref)
    _class_close(got, ref)


@pytest.mark.parametrize("case", _LM + _AN + _KW)
def test_class_tests_match_jax(worlds, data, case):
    ref = _class_call(data, case, jax_side=True)(mesh=_jax_mesh())
    for w in WORLDS:
        got = _ok(worlds[w][0], case)
        assert sorted(ref) == sorted(got)
        _class_close(got, ref, tol=1e-8)


# ---- emmax_anova --------------------------------------------------------------

def _ea_source(data, case):
    return data["G"] if case == "ea_binary" else data[
        "dipm" if case == "ea_dipm" else "dip"]


def _ea_close(got, ref, tol=1e-10):
    np.testing.assert_array_equal(got["mask"], np.asarray(ref["mask"]))
    _close_p(got, ref, ("ps",), tol)
    if "dof1" in ref:
        for k in ("dof1", "dof2"):
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]))


@pytest.mark.parametrize("case", _EA)
@pytest.mark.parametrize("world", WORLDS)
def test_emmax_anova_matches_the_single_device_port(worlds, data, world,
                                                    case):
    ref = emmax_anova(_ea_source(data, case), data["y"], K=data["K"],
                      tile=_TILE["dip"], device="cpu")
    got = _ok(worlds[world][0], case)
    if case != "ea_binary":         # emmax(mesh=) has distributed_emmax's
        assert sorted(got) == sorted(ref)
    _ea_close(got, ref)
    assert got["delta"] == ref["delta"]


@pytest.mark.parametrize("case", _EA)
def test_emmax_anova_matches_jax(worlds, data, case):
    ref = jemmax.emmax_anova(_ea_source(data, case), data["y"], K=data["K"],
                             tile=_TILE["dip"], mesh=_jax_mesh())
    for w in WORLDS:
        got = _ok(worlds[w][0], case)
        _ea_close(got, ref, tol=1e-8)
        assert got["delta"] == pytest.approx(float(ref["delta"]), rel=1e-10)


# ---- the permutation test -------------------------------------------------------

def _perm_call(data, case, jax_side=False):
    tier = _tier(case)
    src, f = _source(data, case.replace("perm_identity_packed",
                                        "perm_packed"), jax_side)
    K = None if "identity" in case else data["K"]
    kw = dict(K=K, num_perm=_PERMS, seed=3, precision=tier)
    if "packed" not in case:
        kw["tile"] = _TILE[f]
    if not jax_side:
        return lambda **m: emmax_perm_test(src, data["y"], device="cpu",
                                           **kw, **m)
    return lambda **m: jperm.emmax_perm_test(src, data["y"], **kw, **m)


@pytest.mark.parametrize("case", _PERM)
@pytest.mark.parametrize("world", WORLDS)
def test_perm_test_matches_the_single_device_port(worlds, data, world, case):
    ref = _perm_call(data, case)()
    got = _ok(worlds[world][0], case)
    assert sorted(got) == sorted(ref)
    assert set(got["timings_s"]) == set(ref["timings_s"])
    _close_p(got, ref, ("min_ps", "threshold"))
    assert got["delta"] == ref["delta"]


@pytest.mark.parametrize("case", _PERM)
def test_perm_test_matches_jax(worlds, data, case, monkeypatch):
    """The same permutations and max F: min_ps and the threshold within
    1e-8 relative (tests/test_torch_permutation.py's bound); 'high' within
    its drift entry (tests/test_torch_high.py's bound: the JAX package
    runs it as exact here)."""
    tier = _tier(case)
    if tier in _FAST:
        jax_projected(monkeypatch)
    tol = (dict(rtol=HIGH, atol=HIGH) if tier == "high" else
           dict(rtol=1e-8))
    ref = _perm_call(data, case, jax_side=True)(mesh=_jax_mesh())
    for w in WORLDS:
        got = _ok(worlds[w][0], case)
        np.testing.assert_allclose(got["min_ps"], ref["min_ps"], **tol)
        np.testing.assert_allclose(got["threshold"], ref["threshold"], **tol)


# ---- GxE --------------------------------------------------------------------------

_GXE_P = ("marginal_ps", "inter_ps", "joint_ps")


def _gxe_call(data, case, jax_side=False):
    tier = _tier(case)
    src, _ = _source(data, case, jax_side)
    env = data["env"][:, 0] if case == "gxe_single_env" else data["env"]
    kw = dict(K=data["K"], precision=tier)
    if case == "gxe_rescore":
        kw.update(precision="bf16x3", rescore_top=8)
    if jax_side:
        return lambda **m: jgxe.emmax_gxe(src, data["y"], env, **kw, **m)
    return lambda **m: gxe.emmax_gxe(src, data["y"], env, device="cpu",
                                     **kw, **m)


def _gxe_close(got, ref, tol=1e-10):
    for k in ("mask", "mask_inter"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)
    _close_p(got, ref, _GXE_P, tol)


@pytest.mark.parametrize("case", _GXE)
@pytest.mark.parametrize("world", WORLDS)
def test_gxe_matches_the_single_device_port(worlds, data, world, case,
                                            small_tiles):
    ref = _gxe_call(data, case)()
    got = _ok(worlds[world][0], case)
    assert sorted(got) == sorted(ref)
    assert set(got["timings_s"]) == set(ref["timings_s"])
    assert got["precision_tier"] == ref["precision_tier"]
    _gxe_close(got, ref)
    _same(got["rescored_idx"], ref["rescored_idx"])
    np.testing.assert_array_equal(got["deltas"], ref["deltas"])
    if case == "gxe_rescore":
        assert all(len(i) >= 8 for i in got["rescored_idx"])


@pytest.mark.parametrize("case", _GXE)
def test_gxe_matches_jax(worlds, data, case):
    """At exact within 1e-8 (tests/test_torch_gxe.py's bound); a fast tier
    (and the rescored bf16x3 call) within 1e-4 of the JAX package's exact
    call, with identical masks: that file's bound of a fast tier against
    exact. The JAX package's own fast tiers quantize U and e o U, not U'
    and e o U', and let the rounding of a degenerate product row through
    its mask (the port masks those rows from the dosages). 'high' within
    GXE_P_DRIFT['high'] of the JAX package's 'high' call, which runs as
    exact here (tests/test_torch_high.py's bound)."""
    tier = _tier(case)
    fast = tier in _FAST or case == "gxe_rescore"
    exact = case.rsplit("_", 1)[0] if tier in _FAST else (
        "gxe_incore" if fast else case)
    ref = _gxe_call(data, exact, jax_side=True)(mesh=_jax_mesh())
    tol = 1e-4 if fast else GXE_HIGH if tier == "high" else 1e-8
    for w in WORLDS:
        got = _ok(worlds[w][0], case)
        _gxe_close(got, ref, tol=tol)
        np.testing.assert_allclose(got["deltas"], np.asarray(ref["deltas"]),
                                   rtol=1e-10)


# ---- two-SNP ----------------------------------------------------------------------

def _two_call(data, case, jax_side=False):
    src, f = _source(data, case, jax_side)
    kw = dict(K=data["K"], focal_idx=_FOCAL[f], tile=_TILE[f])
    if case == "two_refit":
        kw["refit_delta_per_focal"] = True
    elif case == "two_from_result":
        kw.update(focal_idx=None, from_result={"ps": data["prior"]},
                  top_k=3)
    if jax_side:
        return lambda **m: jtwo.emmax_two_snps(src, data["y"], **kw, **m)
    return lambda **m: emmax_two_snps(src, data["y"], device="cpu", **kw,
                                      **m)


def _two_close(got, ref, tol=1e-10):
    np.testing.assert_array_equal(got["focal_idx"], ref["focal_idx"])
    for k in ("cond_ps", "inter_ps"):
        np.testing.assert_array_equal(got[k] == 1.0, np.asarray(ref[k]) == 1.0,
                                      err_msg=k)
    _close_p(got, ref, ("cond_ps", "inter_ps"), tol)


@pytest.mark.parametrize("case", _TWO)
@pytest.mark.parametrize("world", WORLDS)
def test_two_snps_match_the_single_device_port(worlds, data, world, case):
    ref = _two_call(data, case)()
    got = _ok(worlds[world][0], case)
    assert sorted(got) == sorted(ref)
    assert set(got["timings_s"]) == set(ref["timings_s"])
    _two_close(got, ref)
    assert got["delta"] == ref["delta"]


@pytest.mark.parametrize("case", _TWO)
def test_two_snps_match_jax(worlds, data, case):
    """tests/test_torch_twosnp.py's bound: 1e-8 in p."""
    ref = _two_call(data, case, jax_side=True)(mesh=_jax_mesh())
    for w in WORLDS:
        got = _ok(worlds[w][0], case)
        _two_close(got, ref, tol=1e-8)


# ---- shards, refusals ---------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_its_shard(worlds, data, world):
    """Each host-only container went up once a rank (host_snp_range at its
    tile), whichever of the five took it; rank 2 of the world of 3 holds
    none of miss."""
    from mixmogam_tpu_torch.parallel.multihost import host_snp_range

    for rank, res in enumerate(worlds[world]):
        for f, g in (("main", "G"), ("missing", "miss"), ("dip", "dip")):
            lo, hi = host_snp_range(data[g].shape[0], world, rank,
                                    tile=_TILE[f])
            assert res["shard_rows"][f] == [hi - lo]
    if world == 3:
        assert worlds[3][2]["shard_rows"]["missing"] == [0]


@pytest.mark.parametrize("case, exc, match", [
    ("no_gxe_int8_missing", "ValueError", "exact integer dosages"),
    ("no_gxe_int8_packed_missing", "ValueError", "fully-observed"),
    ("no_gxe_k", "ValueError", "need K or eig_k"),
    ("no_perm_host_tier", "ValueError", "ResidentGenome"),
    ("no_perm_host_high", "ValueError", "ResidentGenome"),
    ("no_perm_int8_missing", "ValueError", "fully-observed"),
    ("no_two_k", "ValueError", "need K or eig_k"),
    ("no_two_focal", "ValueError", "explicit focal set"),
    ("no_ea_tier", "TypeError", "does not accept"),
] + [(f"no_{e}_shard", "TypeError", "SnpShard")
     for e in ("lm", "an", "kw", "gxe", "perm", "two", "ea")])
@pytest.mark.parametrize("world", WORLDS)
def test_refusals_raise_on_every_rank(worlds, world, case, exc, match):
    for res in worlds[world]:
        kind, name, msg = res[case]
        assert (kind, name) == ("raised", exc)
        assert match in msg


def _entries(data):
    G, y, K = data["G"], data["y"], data["K"]
    return {
        "linear_model": lambda m: linear.linear_model(G, y, mesh=m),
        "anova": lambda m: linear.anova(G, y, mesh=m),
        "kruskal_wallis": lambda m: linear.kruskal_wallis(G, y, mesh=m),
        "emmax_anova": lambda m: emmax_anova(data["dip"], y, K=K, mesh=m),
        "emmax_perm_test": lambda m: emmax_perm_test(G, y, K=K, mesh=m),
        "emmax_gxe": lambda m: gxe.emmax_gxe(G, y, data["env"], K=K,
                                             mesh=m),
        "emmax_two_snps": lambda m: emmax_two_snps(G, y, K=K, focal_idx=[1],
                                                   mesh=m),
    }


@pytest.mark.parametrize("entry", ["linear_model", "anova", "kruskal_wallis",
                                   "emmax_anova", "emmax_perm_test",
                                   "emmax_gxe", "emmax_two_snps"])
def test_the_entry_points_take_a_mesh_with_no_sample_axis(data, entry):
    """A mesh= that is no parallel.Mesh raises TypeError; a 'sample' axis
    above 1 on a mesh that does not hold its world (a lone process's) raises
    ValueError naming make_mesh, before any work: every one of these entry
    points takes the axis on make_mesh's mesh
    (tests/test_torch_parallel_tp_scans.py)."""
    call = _entries(data)[entry]
    with pytest.raises(TypeError, match="make_mesh"):
        call(object())
    tp = dataclasses.replace(make_mesh(devices="cpu"), shape=(1, 2))
    with pytest.raises(ValueError, match="make_mesh"):
        call(tp)
