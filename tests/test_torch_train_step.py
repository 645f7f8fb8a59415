"""PyTorch port, parallel/distributed.py::distributed_train_step (the JAX
package's end-to-end multi-trait step: the kinship all-reduce, eigh and a
batched spectrum REML on rank 0, K3 a trait, one top-k gather) and
parallel/dryrun.py (the twins of __graft_entry__.py's entry and
dryrun_multichip), on the CPU.

Fixtures: n = 58 samples (even, as the JAX package's (4, 2) mesh takes
it), M = 230 rows, T = 3 traits, top_k = 4, on binary int8 dosages, the
same as float32, diploid dosages and binary with 5 % of calls -1 (the JAX
step takes -1 as a value: it imputes nothing), plus a genome of 12 rows
with 2 polymorphic ones (fewer than top_k unmasked rows) and one with
three copies of a row (tied F).

Limits. Against the JAX step (float32, its REML in float32) on the
conftest's meshes one, snp8 and mix: K within 1e-6 (measured 1.2e-7),
top_idx equal, top_f within 1e-4 relative (measured 6.5e-6) and deltas
within 5e-4 relative (measured 1.3e-4: the JAX step's float32 REML on a
flat surface; the JAX package's REML in float64 on the port's K gives the
port's deltas within 1e-12, measured 9e-16). Against the port's own
float64 steps (fit_null_model(method='spectrum') a trait, the
single-device exact scan emmax_scan_stats on that null): deltas and top_f
within 1e-10 relative, top_idx equal, K equal to the formula's float64
value. On gloo worlds of 2 and 4 (meshes (2, 1), (1, 2), (2, 2) and
(4, 1), one module fixture, tests/test_torch_parallel_tp.py's harness, a
64-row tile so the rows split over the ranks): every rank's result
bit-equal to a world of one in rank 0's process.
"""

import os
import pickle
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from mixmogam_tpu.parallel.distributed import \
    distributed_train_step as jax_train_step
from mixmogam_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                              simulate_phenotype)
from mixmogam_tpu_torch.ops.reml import fit_null_model
from mixmogam_tpu_torch.ops.scan import build_rotated_null, emmax_scan_stats
from mixmogam_tpu_torch.parallel import distributed_train_step
from mixmogam_tpu_torch.parallel import dryrun
from mixmogam_tpu_torch.parallel.distributed import rank_top, select_top

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, M, T, TOP = 58, 230, 3, 4
#: the gloo worlds' mesh shapes, and the tile that splits the rows
SHAPES = {2: ((2, 1), (1, 2)), 4: ((2, 2), (4, 1))}
TILE = 64


def _genomes():
    """name -> (M, n) dosages, and Y (T, n)."""
    B, _, _ = simulate_genotypes(N, M, ploidy=1, seed=51)
    D, _, _ = simulate_genotypes(N, M, ploidy=2, seed=52)
    rng = np.random.default_rng(53)
    miss = B.copy()
    miss[rng.random(B.shape) < 0.05] = -1
    y, causal = simulate_phenotype(B, h2=0.6, n_causal=4, seed=51)
    Y = np.stack([y, y + rng.normal(size=N), rng.normal(size=N)])
    # 12 rows, 2 of them polymorphic: fewer unmasked rows than top_k
    few = np.zeros((12, N), dtype=np.int8)
    few[[1, 6, 9]] = 1
    few[[4, 8]] = B[causal[:2]]
    # trait 0's strongest row, and three copies of it: tied F
    top = distributed_train_step(None, B, Y, top_k=1,
                                 device="cpu")["top_idx"][0, 0]
    tied = B.copy()
    tied[[40, 120, 200]] = B[top]
    return {"binary": B, "binary_f32": B.astype(np.float32), "diploid": D,
            "missing": miss, "few": few, "tied": tied}, Y


@pytest.fixture(scope="module")
def data():
    return _genomes()


@pytest.fixture(scope="module")
def port(data):
    """The port's world of one on the CPU, a call a genome."""
    Gs, Y = data
    return {g: distributed_train_step(None, G, Y, top_k=TOP, device="cpu")
            for g, G in Gs.items()}


@pytest.fixture(scope="module")
def jax_meshes():
    devs = jax.devices()
    return {"one": jax_make_mesh((1, 1), devices=devs[:1]),
            "snp8": jax_make_mesh((8, 1), devices=devs[:8]),
            "mix": jax_make_mesh((4, 2), devices=devs[:8])}


def _same_keys(got, ref):
    for k in ("top_f", "top_idx", "deltas", "K"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# ---- against the JAX step --------------------------------------------------

@pytest.mark.parametrize("genome", ["binary", "binary_f32", "diploid",
                                    "missing"])
@pytest.mark.parametrize("mesh", ["one", "snp8", "mix"])
def test_the_step_is_the_jax_packages(data, port, jax_meshes, mesh, genome):
    """K, top_idx, top_f and deltas against the JAX step on each of the
    conftest's meshes: the port in float64, the JAX step in float32."""
    Gs, Y = data
    ref = jax_train_step(jax_meshes[mesh], Gs[genome], Y, top_k=TOP)
    got = port[genome]
    assert got["top_f"].shape == got["top_idx"].shape == (T, TOP)
    np.testing.assert_allclose(got["K"], ref["K"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["top_idx"], ref["top_idx"])
    np.testing.assert_allclose(got["top_f"], ref["top_f"], rtol=1e-4)
    np.testing.assert_allclose(got["deltas"], ref["deltas"], rtol=5e-4)


@pytest.mark.parametrize("genome", ["binary", "diploid", "missing",
                                    "tied"])
def test_the_deltas_are_the_jax_reml_in_float64(data, port, genome):
    """The JAX step fits its REML in float32, which moves a flat
    surface's optimum (1.3e-4 relative on the binary genome's noise trait,
    delta 7.19). The JAX package's own projected_spectrum and
    reml_from_spectrum in float64, on the port's K, give the port's deltas
    (measured 9e-16 relative)."""
    import jax.numpy as jnp
    from mixmogam_tpu.ops.eigen import projected_spectrum
    from mixmogam_tpu.ops.reml import reml_from_spectrum

    Gs, Y = data
    got = port[genome]
    xi, V = projected_spectrum(got["K"], np.ones((N, 1)), host=True)
    ref = [float(reml_from_spectrum(jnp.asarray((Y[t] @ V) ** 2),
                                    jnp.asarray(xi))["delta"])
           for t in range(T)]
    np.testing.assert_allclose(got["deltas"], ref, rtol=1e-12)


@pytest.mark.parametrize("genome", ["few", "tied"])
@pytest.mark.parametrize("mesh", ["one", "snp8"])
def test_the_tie_order_is_jax_top_ks(data, port, jax_meshes, mesh, genome):
    """Fewer unmasked rows than top_k: the two polymorphic rows, then the
    masked rows of lowest index (not padding rows, which the JAX step's
    snp8 mesh adds past row 11); trait 0's strongest row and three copies
    of it (which change K, so one row may now lead them): equal F, taken in
    row order. Both as the JAX step orders
    them."""
    Gs, Y = data
    ref = jax_train_step(jax_meshes[mesh], Gs[genome], Y, top_k=TOP)
    got = port[genome]
    np.testing.assert_array_equal(got["top_idx"], ref["top_idx"])
    np.testing.assert_allclose(got["top_f"], ref["top_f"], rtol=1e-4)
    if genome == "few":
        assert got["top_idx"].max() < 12
        np.testing.assert_array_equal(np.sort(got["top_idx"][:, :2]),
                                      [[4, 8]] * T)
        np.testing.assert_array_equal(got["top_idx"][:, 2:], [[0, 1]] * T)
        np.testing.assert_array_equal(got["top_f"][:, 2:], 0.0)
    else:
        G = Gs["tied"]
        copies = [r for r in range(M) if np.array_equal(G[r], G[40])]
        assert len(copies) == 4
        at = np.isin(got["top_idx"][0], copies)
        # at least three copies in trait 0's list, in row order, one F
        assert at.sum() >= 3
        np.testing.assert_array_equal(got["top_idx"][0][at],
                                      copies[:at.sum()])
        assert np.all(got["top_f"][0][at] == got["top_f"][0][at][0])


@pytest.mark.parametrize("k, ranks", [(1, 1), (4, 3), (8, 3), (8, 5)])
def test_the_selection_is_jax_top_k(k, ranks):
    """rank_top over a split of the rows, then select_top, against
    jax.lax.top_k on the whole (T, M) array, with ties inside a rank and
    across ranks and a trait of fewer nonzero values than k."""
    rng = np.random.default_rng(k * 10 + ranks)
    F = np.round(rng.exponential(size=(3, 40)) * 4) / 4   # many ties
    F[2] = 0.0
    F[2, [7, 31]] = [1.5, 2.0]
    bounds = np.linspace(0, 40, ranks + 1).astype(int)
    h = np.concatenate([rank_top(torch.from_numpy(F[:, a:b]), int(a),
                                 k).numpy()
                        for a, b in zip(bounds[:-1], bounds[1:])], axis=-1)
    vals, idx = select_top(h, k)
    jv, ji = jax.lax.top_k(jax.numpy.asarray(F), k)
    np.testing.assert_array_equal(idx, np.asarray(ji))
    np.testing.assert_array_equal(vals, np.asarray(jv))


# ---- against the port's own float64 steps ----------------------------------

@pytest.mark.parametrize("genome", ["binary", "diploid", "missing"])
def test_the_step_is_the_ports_spectrum_reml_and_scan(data, port, genome):
    """K is the formula's float64 value; each trait's delta is
    fit_null_model(method='spectrum')'s, and top_f / top_idx those of the
    single-device exact scan on that null (emmax_scan_stats), within
    1e-10 relative."""
    Gs, Y = data
    G = Gs[genome].astype(np.float64)
    got = port[genome]
    s = G.sum(axis=0)
    Kf = (2.0 * G.T @ G - s[:, None] - s[None, :] + M) / M
    np.testing.assert_array_equal(got["K"], Kf)
    X0 = np.ones((N, 1))
    Gt = torch.from_numpy(G)
    for t in range(T):
        null = fit_null_model(Y[t], X0, K=got["K"], method="spectrum",
                              device="cpu")
        np.testing.assert_allclose(got["deltas"][t], float(null.delta),
                                   rtol=1e-10)
        f = emmax_scan_stats(Gt, build_rotated_null(null))[0].numpy()
        order = np.lexsort((np.arange(M), -f))[:TOP]
        np.testing.assert_array_equal(got["top_idx"][t], order)
        np.testing.assert_allclose(got["top_f"][t], f[order], rtol=1e-10)


def test_top_k_outside_the_rows_raises(data):
    Gs, Y = data
    for k in (13, 0):
        with pytest.raises(ValueError, match="top_k"):
            distributed_train_step(None, Gs["few"], Y, top_k=k,
                                   device="cpu")


def test_the_card_is_the_default(data):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    Gs, Y = data
    with pytest.raises(RuntimeError, match='device="cpu"'):
        distributed_train_step(None, Gs["binary"], Y)


# ---- gloo worlds: every mesh shape bit-equal to a world of one ------------

_WORKER = r'''
import pickle, sys
import numpy as np
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from mixmogam_tpu_torch.parallel import (distributed_train_step,
                                         initialize_multihost, make_mesh)
from mixmogam_tpu_torch.parallel.mesh import Mesh

rank, world = {rank}, {world}
initialize_multihost("file://" + {store!r}, world, rank, device="cpu")
z = np.load({data!r})
Y = z["Y"]
res = {{}}
for shape in {shapes!r}:
    mesh = make_mesh(shape, devices="cpu")
    for g in {genomes!r}:
        res[(shape, g)] = distributed_train_step(mesh, z[g], Y, top_k={top},
                                                 tile={tile}, device="cpu")
if rank == 0:
    # a world of one in this process: no process group, no collective
    one = Mesh((1, 1), None, None, 0, 1, torch.device("cpu"))
    for g in {genomes!r}:
        res[("one", g)] = distributed_train_step(one, z[g], Y, top_k={top},
                                                 tile={tile}, device="cpu")
with open({out!r}, "wb") as f:
    pickle.dump(res, f)
dist.barrier()
dist.destroy_process_group()
'''
_GLOO_GENOMES = ("binary", "diploid", "missing", "tied")


@pytest.fixture(scope="module")
def worlds(data, tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]}, each {(shape, genome):
    the step's dict}, rank 0's also {('one', genome): a world of one}."""
    Gs, Y = data
    d = tmp_path_factory.mktemp("gloo_step")
    dpath = str(d / "data.npz")
    np.savez(dpath, Y=Y, **Gs)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1")
    procs = []
    for world, shapes in SHAPES.items():
        store = str(d / f"store_{world}")
        for rank in range(world):
            out = str(d / f"out_{world}_{rank}.pkl")
            err = open(d / f"err_{world}_{rank}.txt", "w")
            src = _WORKER.format(repo=REPO, rank=rank, world=world,
                                 store=store, data=dpath, out=out,
                                 shapes=shapes, genomes=_GLOO_GENOMES,
                                 top=TOP, tile=TILE)
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
    out = {w: [] for w in SHAPES}
    for w, _, path, _, _ in procs:
        with open(path, "rb") as f:
            out[w].append(pickle.load(f))
    return out


@pytest.mark.parametrize("genome", _GLOO_GENOMES)
@pytest.mark.parametrize("world, shape", [(w, s) for w, ss in SHAPES.items()
                                          for s in ss])
def test_every_mesh_shape_is_bit_equal_to_a_world_of_one(worlds, world,
                                                         shape, genome):
    """Every rank's top_f, top_idx, deltas and K on each mesh shape equal
    rank 0's world of one bit for bit: rows split at the tile, so every
    tile is one device's."""
    ref = worlds[world][0][("one", genome)]
    for res in worlds[world]:
        _same_keys(res[(shape, genome)], ref)


@pytest.mark.parametrize("genome", ["binary", "diploid"])
def test_a_rank_of_one_is_this_process_call(data, worlds, genome):
    """The world of one in a rank's process equals the same call here (one
    thread each)."""
    Gs, Y = data
    got = distributed_train_step(None, Gs[genome], Y, top_k=TOP, tile=TILE,
                                 device="cpu")
    for world in SHAPES:
        _same_keys(worlds[world][0][("one", genome)], got)


def test_the_rows_split_over_the_ranks():
    """The fixture's tile gives every rank of both worlds rows of its own
    (so the gathers do real work)."""
    from mixmogam_tpu_torch.parallel.multihost import host_snp_range

    for world in SHAPES:
        spans = [host_snp_range(M, world, r, tile=TILE)
                 for r in range(world)]
        assert all(hi > lo for lo, hi in spans), spans


# ---- the __graft_entry__.py twins -----------------------------------------

def test_entry_is_the_jax_entry():
    """The tile forward step: the same draws as __graft_entry__.entry, its
    f_stats within 1e-4 relative of the JAX step's (both float32)."""
    sys.path.insert(0, REPO)
    import __graft_entry__ as ge

    fn, args = dryrun.entry(device="cpu")
    got = fn(*args).numpy()
    jfn, jargs = ge.entry()
    ref = np.asarray(jax.jit(jfn)(*jargs))
    assert got.shape == ref.shape == (256,)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_the_dry_run_passes_on_four_gloo_ranks():
    """dryrun_multichip(4, device="cpu"): a (2, 2) mesh of gloo ranks, the
    JAX dry run's shapes (n = 32, M = 64, T = 3); every phase passes (a
    failure raises here with the ranks' output)."""
    assert dryrun.mesh_shape(4) == (2, 2)
    line = dryrun.dryrun_multichip(4, device="cpu")
    assert line.startswith("dryrun_multichip OK on mesh {'snp': 2, "
                           "'sample': 2}")
    assert "resident_sample_tp=" in line and "emma=" in line


@pytest.mark.parametrize("world, shape", [(1, (1, 1)), (2, (2, 1)),
                                          (3, (3, 1)), (4, (2, 2)),
                                          (8, (4, 2))])
def test_the_dry_run_mesh_is_the_jax_rule(world, shape):
    assert dryrun.mesh_shape(world) == shape
