"""PyTorch port, the 'sample' tensor-parallel route of the remaining entry
points (emmax_gxe, emmax_perm_test, emmax_two_snps, emmax_anova and the
class tests linear_model, anova and kruskal_wallis on a ('snp', 'sample')
mesh), on gloo worlds of 2 as a (1, 2) mesh and of 4 as a (2, 2) mesh, on
the CPU.

The harness is tests/test_torch_parallel_tp.py's: one module fixture runs
both worlds once, each rank a subprocess pinned to one thread that joins
its group through a file:// store under the test's directory and pickles
its results there. The data are that file's _data() (n = 99 binary lines
x 300 rows; miss: 4 % missing calls; cov: an intercept and one
covariate), with two environments (N(0, 1) and 0/1), 200 diploid rows
(dipm: with 3 % missing calls) and a tied phenotype for Kruskal-Wallis.
n = 99 pads to 112, so each rank's block of 56 samples ends in padding on
'sample' coordinate 1. Every scan runs at a 64-row tile (GxE's tile and
the class sums' host chunk set to 64 rows in the ranks and in the
references alike), so the rows split over the (2, 2) mesh's 'snp' axis.

Each rank records the shape of every rotation block it is sent
(parallel/mesh.py::scatter_from_rank0).

Limits, in float64: against the port's single-device calls p within 1e-10
and masks equal (the permutation test: min_ps and threshold; the int8x3
GxE's statistics bit-equal to one device's call in the rank's own
process off its exact rescore's rows, its int8 plane products summed in
integers; the class tests bit-equal: the 'sample' axis replicates them);
against the JAX package's mesh= calls on the same mesh shape over the
conftest's virtual devices in x64, p within 1e-10 (the permutation test
1e-10 relative in min_ps and the threshold; GxE on the first 96 samples,
its fast tier within 1e-4 of the JAX package's exact call with identical
masks, as tests/test_torch_parallel_scans.py holds them: the JAX
package's own fast tiers quantize the unprojected U and e o U; GxE at
'high', each rank sent its block of the hi and lo parts of U' and of each
e o U', within GXE_P_DRIFT['high'] of the JAX package's 'high' call,
which runs as exact on the CPU). The permutation test refuses 'high' on a
'sample' axis either way, as the JAX package does: in core it takes no
tier, and a container refuses the axis."""

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

from mixmogam_tpu.parallel import mesh as jmesh
from mixmogam_tpu_torch.data.simulate import simulate_genotypes
from mixmogam_tpu_torch.models import gxe, linear
from mixmogam_tpu_torch.models.emmax import emmax_anova
from mixmogam_tpu_torch.models.permutation import emmax_perm_test
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.models.twosnp import emmax_two_snps
from mixmogam_tpu_torch.ops.scan import GXE_P_DRIFT
from test_torch_parallel_tp import _data

jemmax = importlib.import_module("mixmogam_tpu.models.emmax")
jgxe = importlib.import_module("mixmogam_tpu.models.gxe")
jlin = importlib.import_module("mixmogam_tpu.models.linear")
jperm = importlib.import_module("mixmogam_tpu.models.permutation")
jtwo = importlib.import_module("mixmogam_tpu.models.twosnp")
torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: world size -> mesh shape
SHAPES = {2: (1, 2), 4: (2, 2)}
WORLDS = tuple(SHAPES)
TILE = 64
N, M = 99, 300
#: n = 99 padded to 112: a rank's block of 56 samples
N_PAD, BLOCK = 112, 56
_PERMS = 16
_FOCAL = [3, 41, 100, 290]


def _tp_scans_data():
    """_data(), two environments, 200 diploid rows (dipm: 3 % missing
    calls), y rounded for Kruskal-Wallis's tie groups."""
    d = _data()
    rng = np.random.default_rng(23)
    dip, _, _ = simulate_genotypes(N, 200, ploidy=2, seed=23)
    dipm = dip.copy()
    dipm[rng.random(dipm.shape) < 0.03] = -1
    env = np.column_stack([rng.normal(size=N), (rng.random(N) < 0.5) * 1.0])
    return dict(d, env=env, dip=dip, dipm=dipm, yt=np.round(d["y"], 1))


_WORKER = r'''
import pickle, sys
import numpy as np
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from mixmogam_tpu_torch.models import gxe, linear
from mixmogam_tpu_torch.models.emma import emma
from mixmogam_tpu_torch.models.emmax import emmax_anova
from mixmogam_tpu_torch.models.gxe import emmax_gxe
from mixmogam_tpu_torch.models.linear import (anova, kruskal_wallis,
                                              linear_model)
from mixmogam_tpu_torch.models.permutation import emmax_perm_test
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.models.twosnp import emmax_two_snps
from mixmogam_tpu_torch.parallel import initialize_multihost, make_mesh
from mixmogam_tpu_torch.parallel import mesh as pmesh

rank, world, shape = {rank}, {world}, {shape!r}
initialize_multihost("file://" + {store!r}, world, rank, device="cpu")
mesh = make_mesh(shape, devices="cpu")
t, P, focal = {tile}, {perms}, {focal!r}
linear._CLASS_ROWS = t
gxe._scan_rows = lambda E: t
z = dict(np.load({data!r}))
G, y, K, env = z["G"], z["y"], z["K"], z["env"]
res = {{"mesh": (mesh.shape, mesh.rank, mesh.snp_index, mesh.sample_index)}}

# what each rank is sent of a rotation
scattered = []
_scatter = pmesh.scatter_from_rank0


def scatter(*a, **k):
    out = _scatter(*a, **k)
    scattered.append(tuple(out.shape))
    return out


pmesh.scatter_from_rank0 = scatter


def run(name, fn):
    scattered.clear()
    try:
        res[name] = ("ok", fn())
    except Exception as e:
        res[name] = ("raised", type(e).__name__, str(e))
    res[name + "/scattered"] = list(scattered)


rg = ResidentGenome.from_source(G, tile=t, upload=False)
# ---- GxE ----
for tier in ("exact", "int8x3", "bf16x3", "high"):
    run("gxe_" + tier, lambda: emmax_gxe(G, y, env, K=K, mesh=mesh,
                                         precision=tier))
run("gxe_int8x3_rescore", lambda: emmax_gxe(
    G, y, env, K=K, mesh=mesh, precision="int8x3", rescore_top=8))
run("gxe_missing", lambda: emmax_gxe(z["miss"], y, env, K=K, mesh=mesh))
run("gxe_cov", lambda: emmax_gxe(G, y, env, K=K, X0=z["cov"], mesh=mesh))
run("gxe_single_env", lambda: emmax_gxe(G, y, env[:, 0], K=K, mesh=mesh))
# the JAX package's GxE takes a 'sample' axis on n divisible by S: the
# first 96 samples (whole blocks of 48) for the comparison with it
e = 96
for name, src, kw in (("exact", G, {{}}), ("missing", z["miss"], {{}}),
                      ("int8x3_rescore", G, dict(precision="int8x3",
                                                 rescore_top=8)),
                      ("high", G, dict(precision="high"))):
    run("gxe_even_" + name, lambda: emmax_gxe(src[:, :e], y[:e], env[:e],
                                              K=K[:e, :e], mesh=mesh, **kw))
# one device's int8x3 call in this process: its f_stats are held to the
# mesh's bit for bit
for name, top in (("gxe_one_int8x3", 0), ("gxe_one_int8x3_rescore", 8)):
    run(name, lambda: emmax_gxe(G, y, env, K=K, precision="int8x3",
                                rescore_top=top, device="cpu"))
# ---- the permutation test ----
run("perm_exact", lambda: emmax_perm_test(G, y, K=K, num_perm=P, seed=3,
                                          tile=t, mesh=mesh))
run("perm_missing", lambda: emmax_perm_test(z["miss"], y, K=K, num_perm=P,
                                            seed=3, tile=t, mesh=mesh))
run("perm_identity", lambda: emmax_perm_test(G, y, num_perm=P, seed=3,
                                             tile=t, mesh=mesh))
# ---- two-SNP ----
run("two_incore", lambda: emmax_two_snps(G, y, K=K, focal_idx=focal,
                                         tile=t, mesh=mesh))
run("two_missing", lambda: emmax_two_snps(z["miss"], y, K=K,
                                          focal_idx=focal, tile=t,
                                          mesh=mesh))
run("two_resident", lambda: emmax_two_snps(rg, y, K=K, focal_idx=focal,
                                           tile=t, mesh=mesh))
# ---- emmax_anova ----
run("ea_binary", lambda: emmax_anova(G, y, K=K, tile=t, mesh=mesh))
run("ea_dip", lambda: emmax_anova(z["dip"], y, K=K, tile=t, mesh=mesh))
run("ea_dipm", lambda: emmax_anova(z["dipm"], y, K=K, tile=t, mesh=mesh))
# ---- the class tests: the 'sample' axis replicates ----
for name, src, tt in (("incore", G, t), ("missing", z["miss"], t),
                      ("dip", z["dip"], t), ("dipm", z["dipm"], t)):
    run("lm_" + name, lambda: linear_model(src, y, tile=tt, mesh=mesh))
    run("an_" + name, lambda: anova(src, y, mesh=mesh))
    run("kw_" + name, lambda: kruskal_wallis(src, z["yt"], tile=tt,
                                             mesh=mesh))
    # one device's calls in this process, held bit for bit
    run("lm_one_" + name, lambda: linear_model(src, y, tile=tt,
                                               device="cpu"))
    run("an_one_" + name, lambda: anova(src, y, device="cpu"))
    run("kw_one_" + name, lambda: kruskal_wallis(src, z["yt"], tile=tt,
                                                 device="cpu"))
# ---- the JAX package's refusals, on every rank before any collective ----
run("no_gxe_resident", lambda: emmax_gxe(rg, y, env, K=K, mesh=mesh))
run("no_perm_resident", lambda: emmax_perm_test(rg, y, K=K, mesh=mesh))
# 'high': GxE and the permutation test over a container keep the refusal;
# in core the permutation test takes no tier (the JAX package's ValueError)
run("no_gxe_resident_high", lambda: emmax_gxe(rg, y, env, K=K, mesh=mesh,
                                              precision="high"))
run("no_perm_resident_high", lambda: emmax_perm_test(
    rg, y, K=K, mesh=mesh, precision="high"))
run("no_perm_incore_high", lambda: emmax_perm_test(
    G, y, K=K, tile=t, mesh=mesh, precision="high"))
run("no_lm_resident", lambda: linear_model(rg, y, mesh=mesh))
run("no_an_resident", lambda: anova(rg, y, mesh=mesh))
run("no_kw_resident", lambda: kruskal_wallis(rg, y, mesh=mesh))
run("no_emma", lambda: emma(G, y, K=K, mesh=mesh))
with open({out!r}, "wb") as f:
    pickle.dump(res, f)
# no rank tears its group down while another still works (a gloo peer that
# exits first can abort the other's teardown)
dist.barrier()
dist.destroy_process_group()
'''


@pytest.fixture(scope="module")
def data():
    return _tp_scans_data()


@pytest.fixture(scope="module")
def worlds(data, tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]} of one run of every case
    on each world."""
    d = tmp_path_factory.mktemp("gloo_tp_scans")
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
                                 out=out, tile=TILE, perms=_PERMS,
                                 focal=_FOCAL)
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
    monkeypatch.setattr(linear, "_CLASS_ROWS", TILE)
    monkeypatch.setattr(gxe, "_scan_rows", lambda E: TILE)


def _ok(res, name):
    assert res[name][0] == "ok", res[name]
    return res[name][1]


def _jax_mesh(world):
    return jmesh.make_mesh(SHAPES[world], devices=jax.devices()[:world])


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


_GXE = ("gxe_exact", "gxe_int8x3", "gxe_bf16x3", "gxe_high",
        "gxe_int8x3_rescore", "gxe_missing", "gxe_cov", "gxe_single_env",
        "gxe_even_exact", "gxe_even_missing", "gxe_even_int8x3_rescore",
        "gxe_even_high")
_PERM = ("perm_exact", "perm_missing", "perm_identity")
_TWO = ("two_incore", "two_missing", "two_resident")
_EA = ("ea_binary", "ea_dip", "ea_dipm")
_CLS = tuple(f"{t}_{s}" for t in ("lm", "an", "kw")
             for s in ("incore", "missing", "dip", "dipm"))


@pytest.mark.parametrize("case", _GXE + _PERM + _TWO + _EA + _CLS)
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


# ---- GxE --------------------------------------------------------------------

_GXE_P = ("marginal_ps", "inter_ps", "joint_ps")


def _gxe_call(data, case, jax_side=False):
    tier = next((t for t in ("int8x3", "bf16x3", "high") if t in case),
                None)
    src = data["miss"] if case.endswith("missing") else data["G"]
    y, env, K = data["y"], data["env"], data["K"]
    if case == "gxe_single_env":
        env = env[:, 0]
    if "_even_" in case:
        e = 96
        src, y, env, K = src[:, :e], y[:e], env[:e], K[:e, :e]
    kw = dict(K=K, precision=tier,
              X0=data["cov"] if case == "gxe_cov" else None)
    if case.endswith("rescore"):
        kw["rescore_top"] = 8
    if jax_side:
        if case.endswith("missing"):
            src = np.where(src < 0, np.nan, src.astype(np.float64))
        return lambda **m: jgxe.emmax_gxe(src, y, env, **kw, **m)
    return lambda **m: gxe.emmax_gxe(src, y, env, device="cpu", **kw, **m)


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
    if case.endswith("rescore"):
        assert all(len(i) >= 8 for i in got["rescored_idx"])


@pytest.mark.parametrize("case", ["gxe_int8x3", "gxe_int8x3_rescore"])
@pytest.mark.parametrize("world", WORLDS)
def test_int8_gxe_f_stats_are_bit_equal(worlds, world, case):
    """The int8x3 plane products of U' and of each e o U' summed over
    'sample' in integers before the recombine: the statistics bit-equal to
    one device's call in the rank's own process (the same REML
    arithmetic), on every rank. The exact rescore's rows (their float
    products summed over 'sample') are held within 1e-10 in p by
    test_gxe_matches_the_single_device_port; the other rows bit-equal."""
    for res in worlds[world]:
        got, one = _ok(res, case), _ok(res, case.replace("gxe_", "gxe_one_"))
        _same(got["rescored_idx"], one["rescored_idx"])
        off = np.ones(np.shape(got["f_inter"]), dtype=bool)
        for e, idx in enumerate(got["rescored_idx"]):
            off[e, idx] = False
        assert off.sum() >= off.size - 16 * len(got["rescored_idx"])
        for k in ("f_inter", "mask", "mask_inter") + _GXE_P:
            np.testing.assert_array_equal(got[k][off], one[k][off],
                                          err_msg=k)


@pytest.mark.parametrize("case", ["gxe_even_exact", "gxe_even_missing",
                                  "gxe_even_int8x3_rescore",
                                  "gxe_even_high"])
@pytest.mark.parametrize("world", WORLDS)
def test_gxe_matches_jax(worlds, data, world, case):
    """The JAX package's emmax_gxe(mesh=) on the same mesh shape (in core,
    its table's 'sample' route), on the first 96 samples: its in-core
    sharding over 'sample' takes n divisible by S. At exact within 1e-10;
    the int8x3 tier (with its exact rescore) within 1e-4 of the JAX exact
    call, with identical masks; 'high' within GXE_P_DRIFT['high'] of the
    JAX package's 'high' call, which runs as exact here
    (tests/test_torch_high.py's bound)."""
    fast = "int8" in case
    ref = _gxe_call(data, "gxe_even_exact" if fast else case,
                    jax_side=True)(mesh=_jax_mesh(world))
    got = _ok(worlds[world][0], case)
    _gxe_close(got, ref, tol=1e-4 if fast else GXE_P_DRIFT["high"]
               if "high" in case else 1e-10)
    np.testing.assert_allclose(got["deltas"], np.asarray(ref["deltas"]),
                               rtol=1e-10)


# ---- the permutation test ---------------------------------------------------

def _perm_call(data, case, jax_side=False):
    src = data["miss"] if case == "perm_missing" else data["G"]
    K = None if case == "perm_identity" else data["K"]
    kw = dict(K=K, num_perm=_PERMS, seed=3, tile=TILE)
    if jax_side:
        if case == "perm_missing":
            src = src.astype(np.float64)
            src[data["miss"] < 0] = np.nan
        return lambda **m: jperm.emmax_perm_test(src, data["y"], **kw, **m)
    return lambda **m: emmax_perm_test(src, data["y"], device="cpu", **kw,
                                       **m)


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
@pytest.mark.parametrize("world", WORLDS)
def test_perm_test_matches_jax(worlds, data, world, case):
    """The same permutations and max F: min_ps and the threshold within
    1e-10 relative of the JAX package's mesh= call on the same shape."""
    ref = _perm_call(data, case, jax_side=True)(mesh=_jax_mesh(world))
    got = _ok(worlds[world][0], case)
    np.testing.assert_allclose(got["min_ps"], ref["min_ps"], rtol=1e-10)
    np.testing.assert_allclose(got["threshold"], ref["threshold"],
                               rtol=1e-10)


# ---- two-SNP ----------------------------------------------------------------

def _two_call(data, case, jax_side=False):
    src = data["miss"] if case == "two_missing" else data["G"]
    if case == "two_resident" and not jax_side:
        src = ResidentGenome.from_source(src, tile=TILE, device="cpu")
    if jax_side and case == "two_missing":
        src = src.astype(np.float64)
        src[data["miss"] < 0] = np.nan
    kw = dict(K=data["K"], focal_idx=_FOCAL, tile=TILE)
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
@pytest.mark.parametrize("world", WORLDS)
def test_two_snps_match_jax(worlds, data, world, case):
    """The JAX package's emmax_two_snps(mesh=) on the same shape, over the
    rows (a container's host rows, as the JAX function reads them)."""
    ref = _two_call(data, case, jax_side=True)(mesh=_jax_mesh(world))
    _two_close(_ok(worlds[world][0], case), ref)


# ---- emmax_anova ------------------------------------------------------------

def _ea_source(data, case):
    return data[{"ea_binary": "G", "ea_dip": "dip", "ea_dipm": "dipm"}[case]]


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
                      tile=TILE, device="cpu")
    got = _ok(worlds[world][0], case)
    if case != "ea_binary":         # emmax(mesh=) has distributed_emmax's
        assert sorted(got) == sorted(ref)
    _ea_close(got, ref)
    assert got["delta"] == ref["delta"]


@pytest.mark.parametrize("case", _EA)
@pytest.mark.parametrize("world", WORLDS)
def test_emmax_anova_matches_jax(worlds, data, world, case):
    """The JAX package's emmax_anova(mesh=) on the same shape: binary
    genotypes through its emmax(mesh=), the diploid pair test row-parallel
    over the replicated null."""
    ref = jemmax.emmax_anova(_ea_source(data, case), data["y"], K=data["K"],
                             tile=TILE, mesh=_jax_mesh(world))
    got = _ok(worlds[world][0], case)
    _ea_close(got, ref)
    assert got["delta"] == pytest.approx(float(ref["delta"]), rel=1e-10)


# ---- the class tests --------------------------------------------------------

_CLS_KEYS = {"lm": ("ps", "f_stats", "mask", "betas", "var_perc"),
             "an": ("ps", "f_stats", "dof1", "dof2"), "kw": ("ps", "stats")}


def _cls_call(data, case, jax_side=False):
    kind, f = case.split("_")
    src = data[{"incore": "G", "missing": "miss"}.get(f, f)]
    mod = jlin if jax_side else linear
    kw = {} if jax_side else {"device": "cpu"}
    if kind == "lm":
        if jax_side:
            src = np.where(src < 0, np.nan, src.astype(np.float64))
        return lambda **m: mod.linear_model(src, data["y"], tile=TILE,
                                            **kw, **m)
    if kind == "an":
        return lambda **m: mod.anova(src, data["y"], **kw, **m)
    return lambda **m: mod.kruskal_wallis(src, data["yt"], tile=TILE, **kw,
                                          **m)


@pytest.mark.parametrize("case", _CLS)
@pytest.mark.parametrize("world", WORLDS)
def test_class_tests_are_one_devices(worlds, data, world, case,
                                     small_tiles):
    """The 'sample' axis replicates the class tests (no W): each rank of a
    'sample' group takes its 'snp' rows, so every rank's result is one
    device's call in its own process bit for bit, and the test process's
    within 1e-10 in p."""
    kind, f = case.split("_")
    for res in worlds[world]:
        got = _ok(res, case)
        one = _ok(res, f"{kind}_one_{f}")
        assert sorted(got) == sorted(one)
        for k in _CLS_KEYS[kind]:
            np.testing.assert_array_equal(got[k], one[k], err_msg=k)
    ref = _cls_call(data, case)()
    _close_p(_ok(worlds[world][0], case), ref, ("ps",))


@pytest.mark.parametrize("case", _CLS)
@pytest.mark.parametrize("world", WORLDS)
def test_class_tests_match_jax(worlds, data, world, case):
    """The JAX package's class tests with mesh= on the same shape (in core:
    its 'sample' axis replicates)."""
    ref = _cls_call(data, case, jax_side=True)(mesh=_jax_mesh(world))
    got = _ok(worlds[world][0], case)
    _close_p(got, ref, ("ps",))
    if "mask" in ref:
        np.testing.assert_array_equal(got["mask"], np.asarray(ref["mask"]))


# ---- what each rank holds ---------------------------------------------------

#: the blocks of contraction rows a case's call sends each rank, in order:
#: U' (in float64 for GxE at exact: a rank forms e o U' from it), W = U' sd,
#: the int8x3 planes (or bf16x3 parts) of U' and of each e o U'
_HELD = {
    "gxe_exact": [(BLOCK, N)],
    "gxe_int8x3": [(3, BLOCK, N)] * 3,
    "gxe_bf16x3": [(3, BLOCK, N)] * 3,
    "gxe_high": [(2, BLOCK, N)] * 3,
    "gxe_int8x3_rescore": [(3, BLOCK, N)] * 3 + [(BLOCK, N)],
    "gxe_missing": [(BLOCK, N)], "gxe_cov": [(BLOCK, N)],
    "gxe_single_env": [(BLOCK, N)], "gxe_even_exact": [(48, 96)],
    "gxe_even_missing": [(48, 96)],
    "gxe_even_int8x3_rescore": [(3, 48, 96)] * 3 + [(48, 96)],
    "gxe_even_high": [(2, 48, 96)] * 3,
    "perm_exact": [(BLOCK, N)], "perm_missing": [(BLOCK, N)],
    "perm_identity": [],
    "two_incore": [(BLOCK, N)], "two_missing": [(BLOCK, N)],
    "two_resident": [(BLOCK, N)],
    "ea_binary": [(BLOCK, N)], "ea_dip": [(BLOCK, N)],
    "ea_dipm": [(BLOCK, N)],
    **{c: [] for c in _CLS},
}


@pytest.mark.parametrize("case", sorted(_HELD))
@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_its_block_of_each_rotation(worlds, world, case):
    """One scatter an operand: the rank's (n_pad / S, n) rows of it, and no
    rank but 0 ever holds a whole n x n rotation; the identity K and the
    class tests have no W to send."""
    for res in worlds[world]:
        assert res[case + "/scattered"] == _HELD[case]


# ---- refusals ---------------------------------------------------------------

@pytest.mark.parametrize("case, match", [
    ("no_gxe_resident", "resident GxE shards 'snp' only"),
    ("no_perm_resident", "resident permutation shards 'snp' only"),
    ("no_gxe_resident_high", "resident GxE shards 'snp' only"),
    ("no_perm_resident_high", "resident permutation shards 'snp' only"),
    ("no_perm_incore_high", "tiered permutation sweeps need a "
                            "ResidentGenome"),
    ("no_lm_resident", "no rotation operator to sample-shard"),
    ("no_an_resident", "packed class tests shard 'snp' only"),
    ("no_kw_resident", "packed class tests shard 'snp' only"),
    ("no_emma", "EMMA shards 'snp' only"),
])
@pytest.mark.parametrize("world", WORLDS)
def test_refusals_raise_on_every_rank(worlds, world, case, match):
    """The JAX package's ValueErrors, in its words, on every rank before
    any collective (nothing scattered)."""
    for res in worlds[world]:
        kind, name, msg = res[case]
        assert (kind, name) == ("raised", "ValueError")
        assert match in msg
        assert res[case + "/scattered"] == []
