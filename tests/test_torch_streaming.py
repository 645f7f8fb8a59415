"""PyTorch port, the streamed scan (mixmogam_tpu_torch/models/streaming.py::
emmax_streamed, models/source.py::prefetch_iter / fetch_tile) and the
routes to it (emmax stream= / checkpoint_dir= / a source over the in-core
budget, emmax_multi_trait over that budget, the CLI's --stream on and
--checkpoint-dir), against the JAX package under x64 on the CPU.

Limits: exact tier p and betas within 1e-9 of JAX's emmax_streamed,
identical masks; int8x3 / bf16x3 |d log10 p| < 1e-4 against JAX with its
fast tiers pointed at the folded W'' (test_torch_fold.fold_jax_tiers), and
within 1e-12 of the port's resident route (the same plain arithmetic); a
resumed scan within 1e-12 of an uninterrupted one. The port rotates by the
projected U' = (I - P_X0) U where JAX's emmax_streamed rotates by U: under
VanRaden's singular K, float32 holds 1e-6 against float64 only with U'."""

import glob
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mixmogam_tpu.models import source as jsource
from mixmogam_tpu.models import streaming as jstreaming
from mixmogam_tpu.models.multitrait import emmax_multi_trait as j_mt
from mixmogam_tpu.oracle.kinship import ibs_kinship, scale_k
from mixmogam_tpu_torch import cli
from mixmogam_tpu_torch.api import run_gwas
from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                              simulate_phenotype)
from mixmogam_tpu_torch.models import source, streaming
from mixmogam_tpu_torch.models.emmax import emmax
from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.models.streaming import emmax_streamed
from mixmogam_tpu_torch.ops import scan
from mixmogam_tpu_torch.oracle.kinship import vanraden_kinship
from test_torch_fold import fold_jax_tiers

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imputed(G):
    Gf = G.astype(np.float64)
    Gf[G < 0] = np.nan
    mu = np.nanmean(Gf, axis=1)
    return np.where(np.isnan(Gf), np.where(np.isnan(mu), 0, mu)[:, None],
                    Gf)


@pytest.fixture(scope="module")
def data():
    """n = 120 binary lines, M = 300; 4 % missing calls in G_miss."""
    G, _, _ = simulate_genotypes(120, 300, ploidy=1, seed=21)
    y, _ = simulate_phenotype(G, h2=0.6, n_causal=4, seed=21)
    rng = np.random.default_rng(21)
    G_miss = G.copy()
    G_miss[rng.random(G.shape) < 0.04] = -1
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    return {"G": G, "G_miss": G_miss, "y": y, "K": K,
            "X0": np.column_stack([np.ones(120), rng.normal(size=120)])}


def _source(data, kind):
    if kind == "int8":
        return data["G"]
    if kind == "int8_missing":
        return data["G_miss"]
    Gf = _imputed(data["G_miss"]) * 0.97            # fractional dosages
    Gf[data["G_miss"] < 0] = np.nan
    return Gf


def _close(got, ref, tol=1e-9):
    np.testing.assert_array_equal(got["mask"], np.asarray(ref["mask"]))
    np.testing.assert_allclose(got["ps"], np.asarray(ref["ps"]), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(got["betas"], np.asarray(ref["betas"]),
                               rtol=0, atol=tol)


# ---- the port against JAX's emmax_streamed -------------------------------

@pytest.mark.parametrize("kind,tile,covariates", [
    ("int8", 64, False), ("int8_missing", 64, False),
    ("float_nan", 64, False), ("int8", 64, True), ("int8_missing", 70, True),
    ("float_nan", 97, False)])
def test_exact_tier_matches_jax(data, kind, tile, covariates):
    G = _source(data, kind)
    X0 = data["X0"] if covariates else None
    ref = jstreaming.emmax_streamed(G, data["y"], K=data["K"], X0=X0,
                                    tile=tile)
    got = emmax_streamed(G, data["y"], K=data["K"], X0=X0, tile=tile,
                         device="cpu")
    _close(got, ref)
    assert got["dof"] == ref["dof"]
    assert abs(got["delta"] - ref["delta"]) <= 1e-10 * ref["delta"]
    st = got["stream_stats"]
    assert st["tiles"] == st["scanned"] == -(-300 // tile)
    assert st["restored"] == 0 and st["h2d_bytes"] is None


@pytest.mark.parametrize("tier", ["int8x3", "bf16x3"])
def test_fast_tiers_match_jax_and_the_resident_route(data, tier,
                                                     monkeypatch):
    fold_jax_tiers(monkeypatch)
    G, y, K = data["G"], data["y"], data["K"]
    ref = jstreaming.emmax_streamed(G, y, K=K, tile=64, precision=tier)
    got = emmax_streamed(G, y, K=K, tile=64, precision=tier, device="cpu")
    assert got["precision_tier"] == ref["precision_tier"] == tier
    lp = np.abs(np.log10(got["ps"]) - np.log10(np.asarray(ref["ps"])))
    assert lp.max() < 1e-4
    rg = ResidentGenome.from_source(G, tile=64, device="cpu")
    res = emmax(rg, y, K=K, precision=tier)
    _close(got, res, tol=1e-12)


def test_bf16_tier_imputes_missing_calls_as_the_resident_route(data):
    G, y, K = data["G_miss"], data["y"], data["K"]
    got = emmax_streamed(G, y, K=K, tile=64, precision="bf16x3",
                         device="cpu")
    rg = ResidentGenome.from_source(G, tile=64, device="cpu")
    _close(got, emmax(rg, y, K=K, precision="bf16x3"), tol=1e-12)


def test_exact_tier_rotates_the_last_tile_at_the_tiles_height(data,
                                                              monkeypatch):
    """300 rows in tiles of 64: the last tile's 44 rows reach the rotation
    with 20 zero rows after them, at the others' height, and the scan's
    statistics are its own rows', bit-equal to the resident route at the
    same tile (which pads its rows to whole tiles)."""
    heights = []
    orig = scan.emmax_scan_stats

    def spy(Gt, rot):
        heights.append(Gt.shape[0])
        return orig(Gt, rot)

    G, y, K = data["G_miss"], data["y"], data["K"]
    monkeypatch.setattr(scan, "emmax_scan_stats", spy)
    got = emmax_streamed(G, y, K=K, tile=64, device="cpu",
                         dtype=torch.float32)
    monkeypatch.setattr(scan, "emmax_scan_stats", orig)
    assert heights == [64] * 5
    assert got["ps"].shape == (300,)
    rg = ResidentGenome.from_source(G, tile=64, device="cpu")
    _close(got, emmax(rg, y, K=K, precision="exact", dtype=torch.float32),
           tol=0.0)


def test_float_integer_dosages_at_a_fast_tier(data):
    """A float source of integer dosages (NaN missing) goes to the packed
    kernels as the int8 source it equals."""
    Gf = data["G_miss"].astype(np.float64)
    Gf[data["G_miss"] < 0] = np.nan
    a = emmax_streamed(Gf, data["y"], K=data["K"], tile=64,
                       precision="bf16x3", device="cpu")
    b = emmax_streamed(data["G_miss"], data["y"], K=data["K"], tile=64,
                       precision="bf16x3", device="cpu")
    _close(a, b, tol=0.0)


@pytest.fixture(scope="module")
def singular():
    """tests/test_torch_fold.py's fixture: n = 256, M = 3,000, binary, seed
    3, no noise on the phenotype; VanRaden's K is singular along the
    intercept and the REML puts delta at exp(-10)."""
    G, _, _ = simulate_genotypes(256, 3_000, ploidy=1, seed=3)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=4, seed=3)
    K = scale_k(vanraden_kinship(G.astype(np.float64), ploidy=1))
    ref = emmax_streamed(G, y, K=K, tile=1_024, device="cpu")
    assert np.isclose(ref["delta"], np.exp(-10.0), rtol=1e-6)
    return G, y, K, ref


def test_float32_under_a_singular_kinship(singular):
    G, y, K, ref = singular
    got = emmax_streamed(G, y, K=K, tile=1_024, device="cpu",
                         dtype=torch.float32)
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    assert np.abs(got["ps"] - ref["ps"]).max() <= 1e-6


def test_the_unprojected_rotation_fails_there(singular, monkeypatch):
    """JAX's rotation by U itself (project_design made the identity on U)
    misses that gate in float32 by five orders: the intercept's coordinate,
    weighted by 1/sqrt(delta), swamps float32's row sums."""
    G, y, K, ref = singular
    orig = scan.project_design
    monkeypatch.setattr(scan, "project_design",
                        lambda U, X0: (U,) + orig(U, X0)[1:])
    got = emmax_streamed(G, y, K=K, tile=1_024, device="cpu",
                         dtype=torch.float32)
    assert np.abs(got["ps"] - ref["ps"]).max() > 0.1


# ---- checkpoint and resume -----------------------------------------------

def _manifest(ck):
    (path,) = glob.glob(os.path.join(ck, "manifest_*.json"))
    return path


def test_resume_from_a_manifest_cut_to_three_tiles(data, tmp_path):
    G, y, K = data["G_miss"], data["y"], data["K"]
    ck = str(tmp_path / "ck")
    full = emmax_streamed(G, y, K=K, tile=32, checkpoint_dir=ck,
                          device="cpu")
    mpath = _manifest(ck)
    with open(mpath) as f:
        man = json.load(f)
    assert man["done"] == list(range(10)) and man["n_tiles"] == 10
    assert man["delta"] == full["delta"]
    assert len(glob.glob(os.path.join(ck, "tile_*[0-9].npz"))) == 10
    man["done"] = man["done"][:3]
    with open(mpath, "w") as f:
        json.dump(man, f)
    resumed = emmax_streamed(G, y, K=K, tile=32, checkpoint_dir=ck,
                             device="cpu")
    assert resumed["stream_stats"]["restored"] == 3
    assert resumed["stream_stats"]["scanned"] == 7
    _close(resumed, full, tol=1e-12)
    again = emmax_streamed(G, y, K=K, tile=32, checkpoint_dir=ck,
                           device="cpu")
    assert again["stream_stats"]["scanned"] == 0
    _close(again, full, tol=0.0)


def test_a_truncated_manifest_restarts_from_the_tile_files(data, tmp_path):
    G, y, K = data["G"], data["y"], data["K"]
    ck = str(tmp_path / "ck")
    ref = emmax_streamed(G, y, K=K, tile=64, checkpoint_dir=ck,
                         device="cpu")
    os.remove(os.path.join(ck, glob.glob1(ck, "tile_*_2.npz")[0]))
    with open(_manifest(ck), "w") as f:
        f.write('{"done": [0, 1')              # cut by a kill mid-write
    d = emmax_streamed(G, y, K=K, tile=64, checkpoint_dir=ck, device="cpu")
    assert d["stream_stats"]["restored"] == 4
    assert d["stream_stats"]["scanned"] == 1
    _close(d, ref, tol=1e-12)
    with open(_manifest(ck)) as f:
        assert json.load(f)["done"] == [0, 1, 2, 3, 4]


@pytest.mark.parametrize("change", ["y", "precision", "dtype", "source"])
def test_another_run_reuses_no_tile(data, tmp_path, change):
    G, y, K = data["G"], data["y"], data["K"]
    ck = str(tmp_path / "ck")
    emmax_streamed(G, y, K=K, tile=64, checkpoint_dir=ck, device="cpu")
    kw = {"y": y + 0.01 * np.arange(len(y))} if change == "y" else {}
    if change == "precision":
        kw["precision"] = "int8x3"
    if change == "dtype":
        kw["dtype"] = torch.float32
    G2 = G.copy()
    if change == "source":
        G2[153] = 1 - G2[153]                  # a sampled row: 17 * (M // 32)
    out = emmax_streamed(G2, kw.pop("y", y), K=K, tile=64,
                         checkpoint_dir=ck, device="cpu", **kw)
    assert out["stream_stats"]["restored"] == 0
    assert len(glob.glob(os.path.join(ck, "manifest_*.json"))) == 2


def test_the_key_is_not_the_jax_packages(data, tmp_path):
    """A JAX run's checkpoint directory is never taken for the port's: the
    key names the port's torch dtype."""
    G, y, K = data["G"], data["y"], data["K"]
    ck = str(tmp_path / "ck")
    jstreaming.emmax_streamed(G, y, K=K, tile=64, checkpoint_dir=ck)
    out = emmax_streamed(G, y, K=K, tile=64, checkpoint_dir=ck,
                         device="cpu")
    assert out["stream_stats"]["restored"] == 0
    assert len(glob.glob(os.path.join(ck, "manifest_*.json"))) == 2


_WORKER = """
import sys, time
import numpy as np
sys.path.insert(0, {repo!r})
import torch
from mixmogam_tpu_torch.models.streaming import emmax_streamed

torch.set_num_threads(1)

z = np.load({data!r})


class Slow:
    shape = z["G"].shape
    dtype = z["G"].dtype

    def __getitem__(self, k):
        if k.stop - k.start > 1:
            time.sleep(0.3)            # pace the tiles: the kill lands mid-run
        return z["G"][k]


print("START", flush=True)
emmax_streamed(Slow(), z["y"], K=z["K"], tile=32, checkpoint_dir={ck!r},
               inflight=1, device="cpu")
print("DONE", flush=True)
"""


def test_a_sigkilled_scan_resumes(data, tmp_path):
    """SIGKILL a streamed scan in a subprocess once two tiles are on disk,
    resume in this process: equal to an uninterrupted run. The worker runs
    one thread (as this process does), and its clock starts at its START
    line: on a loaded host its imports alone took most of a minute."""
    G, y, K = data["G_miss"], data["y"], data["K"]
    ck, dpath = str(tmp_path / "ck"), str(tmp_path / "d.npz")
    np.savez(dpath, G=G, y=y, K=K)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    out_path, err_path = tmp_path / "worker.out", tmp_path / "worker.err"
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c",
             _WORKER.format(repo=REPO, data=dpath, ck=ck)],
            stdout=out, stderr=err, text=True, env=env)

    def fail(why):
        proc.kill()
        proc.wait(timeout=30)
        pytest.fail(f"{why}: stdout {out_path.read_text()!r}, stderr "
                    f"{err_path.read_text()!r}")

    try:
        deadline = time.time() + 300
        while "START" not in out_path.read_text():
            if proc.poll() is not None or time.time() > deadline:
                fail("the worker did not reach its scan")
            time.sleep(0.05)
        deadline = time.time() + 120
        while len(glob.glob(os.path.join(ck, "tile_*[0-9].npz"))) < 2:
            if proc.poll() is not None or time.time() > deadline:
                fail("no two tile files before the deadline or the "
                     "worker's end")
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    assert proc.returncode == -signal.SIGKILL
    on_disk = len(glob.glob(os.path.join(ck, "tile_*[0-9].npz")))
    assert 2 <= on_disk < 10
    resumed = emmax_streamed(G, y, K=K, tile=32, checkpoint_dir=ck,
                             device="cpu")
    assert resumed["stream_stats"]["restored"] >= 2
    clean = emmax_streamed(G, y, K=K, tile=32, device="cpu")
    _close(resumed, clean, tol=1e-12)


# ---- emmax's routes and refusals -----------------------------------------

def test_the_budget_routes_to_streaming(data):
    G, y, K = data["G"], data["y"], data["K"]
    ref = emmax(G, y, K=K, stream=False, device="cpu")
    st = emmax(G, y, K=K, stream_budget_bytes=1024, device="cpu")
    assert "stream_stats" in st and "stream_stats" not in ref
    _close(st, ref)


def test_stream_true_forces_it(data):
    Gf = _source(data, "float_nan")
    ref = emmax(Gf, data["y"], K=data["K"], stream=False, device="cpu")
    st = emmax(Gf, data["y"], K=data["K"], stream=True, tile=100,
               device="cpu")
    assert st["stream_stats"]["tiles"] == 1        # tile = max(tile, 8192)
    _close(st, ref)


def test_esp_reaches_the_streamed_null(data):
    kw = dict(K=data["K"], esp=1e-3, device="cpu")
    a = emmax(data["G"], data["y"], stream=True, **kw)
    b = emmax(data["G"], data["y"], stream=False, **kw)
    assert a["delta"] == b["delta"]
    assert a["delta"] != emmax(data["G"], data["y"], stream=True,
                               K=data["K"], device="cpu")["delta"]


@pytest.mark.parametrize("kw,match", [
    (dict(stream=False, checkpoint_dir="ck"), "streamed mode"),
    (dict(stream=True, resident=True), "mutually exclusive"),
    (dict(resident=True, checkpoint_dir="ck"), "no resume"),
    (dict(packed=True, stream=True), "mutually exclusive"),
    (dict(packed=True, checkpoint_dir="ck"), "no resume"),
])
def test_refused_combinations(data, kw, match, tmp_path):
    G = (ResidentGenome.from_source(data["G"], tile=64, device="cpu")
         if kw.pop("packed", False) else data["G"])
    if "checkpoint_dir" in kw:
        kw["checkpoint_dir"] = str(tmp_path / "ck")
    with pytest.raises(ValueError, match=match):
        emmax(G, data["y"], K=data["K"], device="cpu", **kw)
    assert not os.path.exists(str(tmp_path / "ck"))


@pytest.mark.parametrize("kind,precision,exc,match", [
    ("int8_missing", "int8x3", ValueError, "fully-observed"),
    ("float_nan", "int8x3", ValueError, "fractional"),
    ("float_nan", "bf16x3", None, None),
    ("int8", "high", None, None),
])
def test_tier_refusals(data, kind, precision, exc, match):
    """The tiers a streamed source refuses; fractional dosages at bf16x3
    are no longer refused: they stream through the float route and equal
    the in-core call (tests/test_torch_fractional.py holds the route to
    the JAX package); nor is 'high', which streams the exact tier's route
    and equals the in-core call."""
    kw = dict(K=data["K"], precision=precision, device="cpu")
    if exc is None:
        got = emmax(_source(data, kind), data["y"], stream=True, **kw)
        ref = emmax(_source(data, kind), data["y"], stream=False, **kw)
        assert got["precision_tier"] == precision
        _close(got, ref, tol=1e-12)
        return
    with pytest.raises(exc, match=match):
        emmax(_source(data, kind), data["y"], stream=True, **kw)


def test_a_tile_over_dosage_two_is_refused_at_a_fast_tier(data):
    G = data["G"].copy()
    G[40, 3] = 3
    with pytest.raises(ValueError, match="tile 0 holds values in"):
        emmax_streamed(G, data["y"], K=data["K"], tile=64,
                       precision="bf16x3", device="cpu")


def test_fast_resolves_to_exact_as_the_in_core_route(data):
    """'fast' is the exact tier here (with its float32 eigh, and a rescore
    that only a fast tier engages), as on the in-core route."""
    a = emmax_streamed(data["G"], data["y"], K=data["K"], precision="fast",
                       device="cpu")
    b = emmax(data["G"], data["y"], K=data["K"], precision="fast",
              device="cpu")
    assert a["precision_tier"] == b["precision_tier"] == "exact"
    assert len(a["rescored_idx"]) == 0
    _close(a, b, tol=1e-12)


def test_rescore_reads_its_rows_back_from_the_source(data, monkeypatch):
    """A fast tier with rescore_top re-tests the top rows at the exact tier
    from the host source, as JAX's streamed path does."""
    fold_jax_tiers(monkeypatch)
    G, y, K = data["G"], data["y"], data["K"]
    got = emmax_streamed(G, y, K=K, tile=64, precision="int8x2",
                         rescore_top=16, device="cpu")
    ref = jstreaming.emmax_streamed(G, y, K=K, tile=64, precision="int8x2",
                                    rescore_top=16)
    ex = emmax_streamed(G, y, K=K, tile=64, device="cpu")
    idx = got["rescored_idx"]
    np.testing.assert_array_equal(idx, np.asarray(ref["rescored_idx"]))
    np.testing.assert_allclose(got["ps"][idx], ex["ps"][idx], atol=1e-12)


def test_a_read_only_float_memmap_streams(data, tmp_path):
    Gf = _source(data, "float_nan")
    path = str(tmp_path / "g.npy")
    np.save(path, Gf)
    mm = np.load(path, mmap_mode="r")
    got = emmax_streamed(mm, data["y"], K=data["K"], tile=64, device="cpu")
    _close(got, emmax(Gf, data["y"], K=data["K"], device="cpu"))
    assert np.isnan(mm).sum() == np.isnan(Gf).sum()


# ---- prefetch_iter, fetch_tile and the host imputation --------------------

@pytest.mark.parametrize("shape,dtype", [((130, 77), np.float64),
                                         ((130, 77), np.float32),
                                         ((1, 5), np.float32),
                                         ((64, 300), np.float64)])
def test_host_float_tile_bit_equal_to_jax(shape, dtype):
    """Row blocks of 64 in place of one whole-tile pass: JAX's values bit
    for bit (an all-missing row imputes to 0), the caller's NaNs kept."""
    rng = np.random.default_rng(shape[0])
    for src_dt in (np.float64, np.float32):
        A = (rng.random(shape) * 2).astype(src_dt)
        A[rng.random(shape) < 0.05] = np.nan
        A[0] = np.nan
        before = A.copy()
        with np.errstate(all="ignore"), pytest.warns(RuntimeWarning):
            ref = jstreaming._host_float_tile(A, dtype)
        got = streaming._host_float_tile(A, dtype)
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(A, before)
        out = np.empty(shape, dtype)
        assert streaming._host_float_tile(A, dtype, out=out) is out
        np.testing.assert_array_equal(out, ref)


def test_prefetch_iter_order_and_lookahead():
    started, gate = [], threading.Event()

    def prep(k):
        started.append(k)
        if k == 0:
            gate.wait(timeout=10)
        return k * k

    it = source.prefetch_iter(range(6), prep, lookahead=3)
    first = threading.Thread(target=lambda: gate.set())
    time.sleep(0.05)
    assert started == []                   # nothing runs before the first next
    first.start()
    assert next(it) == (0, 0)
    first.join(timeout=10)
    assert list(it) == [(k, k * k) for k in range(1, 6)]
    assert started == list(range(6))


def test_prefetch_iter_runs_lookahead_items_ahead():
    seen = []
    ahead = []

    def prep(k):
        seen.append(k)
        return k

    for k, _ in source.prefetch_iter(range(8), prep, lookahead=2):
        time.sleep(0.02)                   # the worker fills its queue
        ahead.append(max(seen) - k)
    assert max(ahead) == 2 and ahead[-1] == 0


def test_prefetch_iter_raises_at_the_failing_key():
    def prep(k):
        if k == 3:
            raise KeyError(k)
        return k

    got = []
    with pytest.raises(KeyError):
        for k, v in source.prefetch_iter(range(6), prep):
            got.append(k)
    assert got == [0, 1, 2]


@pytest.mark.parametrize("kind,s,e,tile", [
    ("int8_missing", 0, 64, 64), ("int8_missing", 280, 300, 64),
    ("float_nan", 10, 50, 40), ("float_nan", 290, 300, 16)])
def test_fetch_tile_equals_the_jax_copy(data, kind, s, e, tile):
    G = _source(data, kind)
    ref = np.asarray(jsource.fetch_tile(G, s, e, tile, 120, np.float64,
                                        False))
    got = source.fetch_tile(G, s, e, tile, 120, torch.float64, device="cpu")
    assert got.shape == (tile, 120) and got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), ref)


# ---- the multi-trait streamed route --------------------------------------

def _traits(G, T=3, seed=30):
    return np.stack([simulate_phenotype(G, h2=h, n_causal=3,
                                        seed=seed + t)[0]
                     for t, h in enumerate(np.linspace(0.2, 0.8, T))])


def _mt_close(got, ref):
    np.testing.assert_array_equal(got["mask"], np.asarray(ref["mask"]))
    np.testing.assert_allclose(got["ps"], np.asarray(ref["ps"]), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(got["betas"], np.asarray(ref["betas"]),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("kind,missing_y", [("int8_missing", False),
                                            ("float_nan", False),
                                            ("int8_missing", True)])
def test_multi_trait_streamed_matches_jax(data, kind, missing_y,
                                          monkeypatch):
    G = _source(data, kind)
    Y = _traits(data["G"])
    if missing_y:
        Y[1, np.random.default_rng(2).random(120) < 0.2] = np.nan
    calls = []
    orig = source.host_tile
    monkeypatch.setattr(source, "host_tile",
                        lambda *a: calls.append(a[1]) or orig(*a))
    ref = j_mt(G, Y, K=data["K"], stream_budget_bytes=1, tile=64)
    got = emmax_multi_trait(G, Y, K=data["K"], stream_budget_bytes=1,
                            tile=64, device="cpu")
    _mt_close(got, ref)
    assert calls[:5] == [0, 64, 128, 192, 256]   # read from the host source
    one = emmax(G, Y[0], K=data["K"], device="cpu")
    np.testing.assert_allclose(got["ps"][0], one["ps"], atol=1e-10)


def test_multi_trait_streamed_k3_once_a_trait_a_tile(data, monkeypatch):
    calls = {"scan": 0}
    real = scan.emmax_scan_prerotated

    def sc(*a):
        calls["scan"] += 1
        return real(*a)

    monkeypatch.setattr(scan, "emmax_scan_prerotated", sc)
    emmax_multi_trait(_source(data, "float_nan"), _traits(data["G"]),
                      K=data["K"], stream_budget_bytes=1, tile=64,
                      device="cpu")
    assert calls["scan"] == 3 * 5


# ---- the CLI -------------------------------------------------------------

@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_stream")
    prefix = str(d / "sim")
    assert cli.main(["simulate", "-n", "80", "-m", "600", "--seed", "5",
                     "-o", prefix]) == 0
    return d, prefix


def test_cli_stream_on_with_checkpoints_equals_run_gwas(sim, capsys):
    d, prefix = sim
    g, p = prefix + ".genotypes.csv", prefix + ".phenotypes.csv"
    ck = str(d / "ck")
    argv = ["run", g, p, "-o", str(d / "st"), "--no-plots", "--device",
            "cpu", "--stream", "on", "--checkpoint-dir", ck]
    assert cli.main(argv) == 0
    first = capsys.readouterr().out
    ref = run_gwas(g, p, plots=False, device="cpu")["scan"]
    st = run_gwas(g, p, plots=False, device="cpu", stream=True)["scan"]
    np.testing.assert_allclose(st["ps"], ref["ps"], rtol=0, atol=1e-12)
    rows = np.loadtxt(str(d / "st.pvals.csv"), delimiter=",", skiprows=1,
                      usecols=2)
    np.testing.assert_allclose(np.sort(rows), np.sort(ref["ps"]), rtol=1e-12)
    tiles = st["stream_stats"]["tiles"]
    assert f"{tiles} scanned, 0 restored" in first
    assert cli.main(argv) == 0
    assert f"0 scanned, {tiles} restored" in capsys.readouterr().out
    # --checkpoint-dir alone implies --stream on
    assert cli.main(argv[:-4] + ["--checkpoint-dir", ck]) == 0
    assert f"0 scanned, {tiles} restored" in capsys.readouterr().out
