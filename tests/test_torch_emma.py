"""PyTorch port, EMMA (mixmogam_tpu_torch/models/emma.py and the per-SNP
half of ops/xreml.py) against the JAX package's models/emma.py and
ops/xreml.py under x64, float64 on both sides, on the CPU; and against the
float64 oracle (mixmogam_tpu.oracle.emma_scan).

Limits against JAX: identical masks, max |d log delta| <= 1e-6 over the
unmasked SNPs (the bisection's last bracket is 7.6e-7 wide at the
defaults) and max |dp| <= 1e-8. Against the oracle: the JAX package's own
bounds (tests/test_models.py: log delta 1e-5, p and beta 1e-6). The
analytic dLL/dlog delta against autograd of _ll_snps_at and jax.grad of
the JAX package's: 1e-10 relative.
"""

import importlib
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mixmogam_tpu import api as japi
from mixmogam_tpu import oracle as joracle
from mixmogam_tpu.ops import xreml as jxreml
from mixmogam_tpu_torch import api, cli
from mixmogam_tpu_torch.data.genotype import GenotypeData
from mixmogam_tpu_torch.data.phenotype import PhenotypeData
from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                              simulate_phenotype)
from mixmogam_tpu_torch.models import emma as temma
from mixmogam_tpu_torch.models.emma import emma
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.ops import xreml
from mixmogam_tpu_torch.oracle.kinship import (ibs_kinship, scale_k,
                                               vanraden_kinship)
from mixmogam_tpu_torch.parallel.mesh import Mesh

jemma = importlib.import_module("mixmogam_tpu.models.emma")
torch.set_num_threads(1)
#: a mesh with a 'sample' axis of 2 built by hand on a lone process, which
#: emma refuses as the JAX package does (it shards 'snp' only)
SAMPLE_AXIS_MESH = Mesh((1, 2), None, None, 0, 1, torch.device("cpu"))
N, M = 80, 150


@pytest.fixture(scope="module")
def data():
    G, _, _ = simulate_genotypes(N, M, ploidy=1, seed=21)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=3, seed=21)
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    w, v = np.linalg.eigh(K)
    return {"G": G, "y": y, "K": K, "phi": w[::-1].copy(),
            "U": v[:, ::-1].copy()}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float64))


def _rotated(data, q=1, rows=slice(0, 64)):
    """(Gt, X0_rot, y_rot, phi, logdet) of a tile, as numpy float64."""
    n = N
    X0 = np.ones((n, 1)) if q == 1 else np.column_stack(
        [np.ones(n), np.random.default_rng(3).normal(size=(n, q - 1))])
    U = data["U"]
    Gt = data["G"][rows].astype(np.float64) @ U
    Xr = U.T @ X0
    ld = np.asarray(jemma._logdet_xtx_tile(jnp.asarray(Gt), jnp.asarray(Xr)))
    return Gt, Xr, U.T @ data["y"], data["phi"], ld


def _close(got, ref, p_atol=1e-8):
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    m = got["mask"]
    np.testing.assert_allclose(np.log(got["deltas"][m]),
                               np.log(np.asarray(ref["deltas"])[m]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["ps"], ref["ps"], rtol=0, atol=p_atol)


@pytest.mark.parametrize("reml", [True, False])
@pytest.mark.parametrize("q", [1, 2])
def test_emma_delta_scan_matches_jax(data, reml, q):
    Gt, Xr, yr, phi, ld = _rotated(data, q)
    ref = jxreml.emma_delta_scan(*(jnp.asarray(v) for v in
                                   (Gt, Xr, yr, phi, ld)),
                                 refine_iters=18, reml=reml)
    got = xreml.emma_delta_scan(*(_t(v) for v in (Gt, Xr, yr, phi, ld)),
                                refine_iters=18, reml=reml)
    np.testing.assert_allclose(got["log_delta"].numpy(),
                               np.asarray(ref["log_delta"]), rtol=0,
                               atol=1e-6)
    for k in ("ll", "ypy", "beta"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-9, atol=1e-12)


def _chol_out_of_place(A):
    """xreml.chol_small's arithmetic, built without writing into a tensor
    (the in-place version cannot be differentiated by autograd)."""
    p = A.shape[-1]
    tiny = torch.finfo(A.dtype).tiny
    cols = []                       # column j: (..., p), zero above j
    for j in range(p):
        L = (torch.stack(cols, dim=-1) if cols
             else A.new_zeros(A.shape[:-1] + (0,)))
        s = A[..., j, j] - (L[..., j, :] * L[..., j, :]).sum(dim=-1)
        d = torch.sqrt(torch.clamp(s, min=tiny))
        parts = [A.new_zeros(A.shape[:-2] + (j,)), d[..., None]]
        if j + 1 < p:
            parts.append((A[..., j + 1:, j] - (L[..., j + 1:, :]
                                               @ L[..., j, :, None])[..., 0])
                         / d[..., None])
        cols.append(torch.cat(parts, dim=-1))
    return torch.stack(cols, dim=-1)


def _chol_solve_out_of_place(L, b):
    """xreml.chol_solve_small's arithmetic, out of place."""
    p = L.shape[-1]
    shape = np.broadcast_shapes(tuple(L.shape[:-1]), tuple(b.shape))
    ys = []
    for i in range(p):
        done = (torch.stack(ys, dim=-1) if ys
                else L.new_zeros(shape[:-1] + (0,)))
        ys.append((b[..., i] - (L[..., i, :i] * done).sum(dim=-1))
                  / L[..., i, i])
    y = torch.stack(ys, dim=-1).expand(shape)
    xs = []                         # x_{p-1}, x_{p-2}, ...
    for i in reversed(range(p)):
        later = (torch.stack(xs[::-1], dim=-1) if xs
                 else L.new_zeros(shape[:-1] + (0,)))
        xs.append((y[..., i] - (L[..., i + 1:, i] * later).sum(dim=-1))
                  / L[..., i, i])
    return torch.stack(xs[::-1], dim=-1)


@pytest.mark.parametrize("reml", [True, False])
@pytest.mark.parametrize("q", [1, 3])
def test_analytic_dll_equals_autograd(data, reml, q, monkeypatch):
    """_dll_snps_at against torch.autograd.grad of _ll_snps_at (its small
    solves swapped for out-of-place copies of the same arithmetic) and
    against jax.grad of the JAX package's _ll_snps_at, at random per-SNP
    log deltas over the grid's range: 1e-10 relative."""
    import jax

    rot = _rotated(data, q)
    Gt, Xr, yr, phi, ld = (_t(v) for v in rot)
    logd_np = np.random.default_rng(q).uniform(-9.0, 9.0, size=Gt.shape[0])
    ana = xreml._dll_snps_at(_t(logd_np), Gt, Xr, yr, phi, reml)
    monkeypatch.setattr(xreml, "chol_small", _chol_out_of_place)
    monkeypatch.setattr(xreml, "chol_solve_small", _chol_solve_out_of_place)
    logd = _t(logd_np).requires_grad_(True)
    ll, _, _ = xreml._ll_snps_at(logd, Gt, Xr, yr, phi, ld, reml)
    (auto,) = torch.autograd.grad(ll.sum(), logd)
    jgrad = np.asarray(jax.grad(lambda v: jxreml._ll_snps_at(
        v, *(jnp.asarray(a) for a in rot), reml)[0].sum())(
        jnp.asarray(logd_np)))
    for ref in (auto.numpy(), jgrad):
        scale = np.abs(ref).max()
        assert (np.abs(ana.numpy() - ref)
                <= 1e-10 * np.maximum(np.abs(ref), scale)).all()


def test_grid_is_the_jax_grid_evaluation(data):
    """_grid_lls (all grid points as shared products) equals the JAX
    package's per-point evaluation, including a wide design evaluated a
    few grid points at a time."""
    Gt, Xr, yr, phi, ld = _rotated(data, 4)
    grid = np.linspace(-10.0, 10.0, 101)
    ref = np.stack([np.asarray(jxreml._ll_from_moments(
        *jxreml._assemble(*jxreml._snp_moments(
            jnp.asarray(Gt), jnp.asarray(Xr), jnp.asarray(yr),
            1.0 / (jnp.asarray(phi) + np.exp(g)))),
        float(np.log(phi + np.exp(g)).sum()), jnp.asarray(ld), N, 5,
        True)[0]) for g in grid], axis=1)
    got = xreml._grid_lls(*(_t(v) for v in (Gt, Xr, yr, phi, ld)),
                          _t(grid), True)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-11, atol=0)


def test_grid_in_chunks_equals_one_chunk(data, monkeypatch):
    args = [_t(v) for v in _rotated(data, 2)]
    grid = _t(np.linspace(-10.0, 10.0, 101))
    whole = xreml._grid_lls(*args, grid, True)
    monkeypatch.setattr(xreml, "_GRID_CHUNK_ELEMS", 64 * 9 * 7)
    assert torch.equal(xreml._grid_lls(*args, grid, True), whole)


@pytest.mark.parametrize("case", ["intercept", "two_columns", "degenerate",
                                  "lrt", "resident_missing", "float_source"])
def test_emma_matches_jax(data, case):
    G, y, K = data["G"], data["y"], data["K"]
    kw, jkw = {}, {}
    if case == "two_columns":
        kw["X0"] = jkw["X0"] = np.column_stack(
            [np.ones(N), np.random.default_rng(5).normal(size=N)])
    if case == "degenerate":
        G = np.vstack([np.ones((1, N), np.int8), G[:40]])
    if case == "lrt":
        kw["test"] = jkw["test"] = "lrt"
    src, jsrc = G, G.astype(np.float64)
    if case == "resident_missing":
        G, _, _ = simulate_genotypes(N, 100, ploidy=1, missing_rate=0.05,
                                     seed=22)
        src = ResidentGenome.from_source(G, tile=64, device="cpu")
        jsrc = G.astype(np.float64)
        jsrc[G < 0] = np.nan
        mu = np.nanmean(jsrc, axis=1)
        jsrc = np.where(np.isnan(jsrc), mu[:, None], jsrc)
    if case == "float_source":
        src = G[:60].astype(np.float64)
        src[3, 5] = np.nan
        jsrc = src.copy()
        jsrc[3, 5] = np.nanmean(src[3])
    got = emma(src, y, K=K, tile=48, device="cpu", **kw)
    ref = jemma.emma(jsrc, y, K=K, tile=48, **jkw)
    _close(got, ref)
    m = got["mask"]         # a masked SNP's beta and LL are undefined
    for k in ("f_stats", "betas", "lls"):
        np.testing.assert_allclose(got[k][m], np.asarray(ref[k])[m],
                                   rtol=1e-7, atol=1e-9)
    if case == "degenerate":
        assert got["ps"][0] == 1.0 and not got["mask"][0]
    if case == "lrt":
        np.testing.assert_allclose(got["lrt_stats"], ref["lrt_stats"],
                                   rtol=1e-7, atol=1e-9)
    assert sorted(got) == sorted(list(ref) + ["timings_s"])
    assert set(got["timings_s"]) == {"eigh", "rotation", "grid", "refine",
                                     "f", "p_values"}


def test_emma_matches_the_float64_oracle(tiny_dataset, kinship_tiny):
    """The JAX package's own EMMA test (tests/test_models.py) on the port."""
    G, y, K = tiny_dataset["G"], tiny_dataset["y"], kinship_tiny
    o = joracle.emma_scan(G, y, K)
    d = emma(G, y, K=K, tile=64, device="cpu")
    fin = np.isfinite(o["deltas"])
    assert np.max(np.abs(np.log(o["deltas"][fin])
                         - np.log(d["deltas"][fin]))) < 1e-5
    assert np.max(np.abs(o["ps"] - d["ps"])) < 1e-6
    assert np.max(np.abs(o["betas"] - d["betas"])) < 1e-6


@pytest.fixture(scope="module")
def singular():
    """VanRaden's K of n = 256 binary genomes, seed 3 (a zero eigenvalue
    along the intercept; the null's delta sits at its lower bound)."""
    G, _, _ = simulate_genotypes(256, 3_000, ploidy=1, seed=3)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=4, seed=3)
    K = scale_k(vanraden_kinship(G.astype(np.float64), ploidy=1))
    return G, y, K


def test_emma_singular_k_matches_the_oracle(singular):
    G, y, K = singular
    G = G[:40]
    o = joracle.emma_scan(G.astype(np.float64), y, K)
    d = emma(G, y, K=K, device="cpu")
    fin = np.isfinite(o["deltas"])
    assert np.max(np.abs(np.log(o["deltas"][fin])
                         - np.log(d["deltas"][fin]))) < 1e-5
    assert np.max(np.abs(o["ps"] - d["ps"])) < 1e-6
    assert np.max(np.abs(o["betas"] - d["betas"])) < 1e-6
    np.testing.assert_array_equal(d["mask"], fin)


def test_emma_singular_k_f_test_ignores_the_summation_order(singular):
    """The same scan with the samples and the eigenvectors in another order
    (every sum taken in another order, as on another device): identical
    masks and deltas, max |dp| <= 1e-9 over all 3,000 SNPs. rss0 - rss1 from
    the moments (the JAX function's) moved p by up to 2.7e-7 here: a
    1/delta-weighted intercept coordinate cancels in it."""
    G, y, K = singular
    phi, U = (torch.from_numpy(v) for v in np.linalg.eigh(K))
    a = emma(G, y, eig_k=(phi, U), device="cpu")
    g = torch.Generator().manual_seed(5)
    ps, pe = torch.randperm(256, generator=g), torch.randperm(256, generator=g)
    b = emma(np.ascontiguousarray(G[:, ps.numpy()]), y[ps.numpy()],
             eig_k=(phi[pe], U[ps][:, pe]), device="cpu")
    np.testing.assert_array_equal(a["mask"], b["mask"])
    np.testing.assert_array_equal(a["deltas"], b["deltas"])
    assert np.abs(a["ps"] - b["ps"]).max() <= 1e-9


def test_emma_float32_finishes_with_finite_p(data):
    """dtype=torch.float32 is accepted; its drift from float64 is not
    bounded here (chip_smoke.py prints it)."""
    a = emma(data["G"], data["y"], K=data["K"], dtype=torch.float32,
             device="cpu")
    b = emma(data["G"], data["y"], K=data["K"], device="cpu")
    assert np.isfinite(a["ps"]).all() and a["ps"].shape == (M,)
    assert np.abs(a["ps"] - b["ps"]).max() < 0.5


def test_emma_eig_k_equals_k(data):
    a = emma(data["G"], data["y"], K=data["K"], device="cpu")
    b = emma(data["G"], data["y"], eig_k=(data["phi"], data["U"]),
             device="cpu")
    np.testing.assert_allclose(a["ps"], b["ps"], rtol=0, atol=1e-12)


@pytest.mark.parametrize("kw,exc,match", [
    (dict(mesh=SAMPLE_AXIS_MESH), ValueError, "shards 'snp' only"),
    (dict(K=None, device="cpu"), ValueError, "need K or eig_k"),
    (dict(test="wald", device="cpu"), ValueError, "test must be"),
])
def test_emma_refusals(data, kw, exc, match):
    with pytest.raises(exc, match=match):
        emma(data["G"], data["y"], **{"K": data["K"], **kw})


def test_emma_host_source_goes_up_a_tile_at_a_time(data):
    """A host source of any size is read `tile` rows at a time, as
    linear_model reads one: no resident pack, no whole-genome upload, and
    the tile and the budget change no result."""
    before = ResidentGenome.packs
    a = emma(data["G"], data["y"], K=data["K"], tile=32,
             stream_budget_bytes=1, device="cpu")
    assert ResidentGenome.packs == before
    b = emma(data["G"], data["y"], K=data["K"], tile=M, device="cpu")
    np.testing.assert_allclose(a["ps"], b["ps"], rtol=0, atol=1e-12)


def test_emma_default_device_is_the_card_or_an_error(data):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        emma(data["G"], data["y"], K=data["K"])


def test_logdet_xtx_tile_matches_jax(data):
    Gt, Xr, _, _, ld = _rotated(data, 3)
    np.testing.assert_allclose(temma._logdet_xtx_tile(_t(Gt), _t(Xr)).numpy(),
                               ld, rtol=1e-12, atol=0)


# ---- the facade and the command line ----------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("emma_api")
    n, m = 90, 400
    G, ch, po = simulate_genotypes(n, m, ploidy=1, seed=23)
    acc = [f"a{i}" for i in range(n)]
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=3, seed=23)
    g, p = str(d / "g.csv"), str(d / "p.csv")
    GenotypeData(G, ch, po, acc, ploidy=1).write_csv(g)
    ph = PhenotypeData.from_arrays(1, "t", acc, y)
    ph.add_phenotype(2, "cov", acc, np.random.default_rng(23).normal(size=n))
    ph.write_to_file(p)
    return d, g, p


@pytest.mark.parametrize("covariates", [None, [2]])
def test_run_gwas_emma(files, covariates):
    """The port's run_gwas(method='emma') against the JAX package's (the
    same ranked CSV rows) and against the port's direct call on the run's
    own rows, y and K (1e-12)."""
    from mixmogam_tpu_torch.utils.caching import cached_kinship

    d, g, p = files
    tag = "cov" if covariates else "plain"
    kw = dict(method="emma", plots=False, min_mac=5,
              covariate_pids=covariates)
    res = api.run_gwas(g, p, out_prefix=str(d / f"port_{tag}"), device="cpu",
                       **kw)
    ref = japi.run_gwas(g, p, out_prefix=str(d / f"jax_{tag}"), **kw)
    assert res["genotype"].accessions == ref["genotype"].accessions
    _close(res["scan"], ref["scan"])
    with open(res["files"]["pvals"]) as a, open(ref["files"]["pvals"]) as b:
        ra, rb = a.read().splitlines(), b.read().splitlines()
    assert ra[0] == rb[0] and len(ra) == len(rb)
    assert [r.split(",")[:2] for r in ra] == [r.split(",")[:2] for r in rb]
    g2 = res["genotype"]
    X0 = None
    if covariates:
        X0 = np.column_stack([np.ones(g2.num_samples), [
            PhenotypeData.parse_phenotype_file(p).value_dict(2)[a][0]
            for a in g2.accessions]])
    direct = emma(g2, res["y"], K=cached_kinship(g2, "ibs", device="cpu"),
                  X0=X0, tile=16_384, device="cpu")
    np.testing.assert_allclose(res["scan"]["ps"], direct["ps"], rtol=0,
                               atol=1e-12)
    with open(res["files"]["summary"]) as f:
        assert "kinship" in json.load(f)["timings_s"]


def test_cli_run_emma(files, capsys):
    d, g, p = files
    out = str(d / "cli_emma")
    assert cli.main(["run", g, p, "--method", "emma", "-o", out,
                     "--no-plots", "--min-mac", "5", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.startswith("scanned ")
    with open(out + ".summary.json") as f:
        assert json.load(f)["method"] == "emma"
