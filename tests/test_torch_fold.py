"""PyTorch port, the int8 / bf16 tiers' folded operand: they quantize
W'' = W (I - Q0 Q0^T) with W = U * sd, so the kernels K2 / K5 take Q0 with
no columns whatever the design's width, and the rows inside col(X0) are
masked by ops/scan.py outside_design (CPU, x64).

The JAX package quantizes the unprojected W. Its reference for the port's
fast tiers is therefore JAX's own quantize_rotation applied to W'' built
here from JAX's W and Q0 in float64, with Q0 given no columns
(jax_folded / fold_jax_tiers): the same roundings as the port's, so the
tolerances of the unfolded comparisons stand. Other test files import
these two helpers."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

import jax.numpy as jnp

from mixmogam_tpu.ops import scan as jscan
from mixmogam_tpu.ops.eigen import eigen_k as j_eigen_k
from mixmogam_tpu.ops.reml import fit_null_model as j_fit
from mixmogam_tpu.oracle.kinship import ibs_kinship, scale_k
from mixmogam_tpu_torch import api
from mixmogam_tpu_torch.data.genotype import GenotypeData
from mixmogam_tpu_torch.data.phenotype import PhenotypeData
from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                              simulate_phenotype)
from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                design_mask_packed,
                                                emmax_resident,
                                                emmax_scan_packed)
from mixmogam_tpu_torch.ops import scan
from mixmogam_tpu_torch.ops.hopper_scan import scan_operand
from mixmogam_tpu_torch.ops.reml import fit_null_model

torch.set_num_threads(1)

_FAST = ("int8x3", "bf16x3")


def _jax_tier(tier):
    return jnp.bfloat16 if tier == "bf16" else tier


def folded_w(W, Q0) -> np.ndarray:
    """W'' = W - (W Q0) Q0^T in float64 from JAX's exact-tier W and Q0."""
    W = torch.from_numpy(np.array(W, dtype=np.float64))
    Q = torch.from_numpy(np.array(Q0, dtype=np.float64).reshape(
        W.shape[0], -1))
    return (W - (W @ Q) @ Q.T).numpy()


def jax_folded(rot_exact, tier):
    """JAX's RotatedNull at `tier` re-pointed at the folded operand: its
    quantize_rotation of W'' (from the exact tier's W and Q0), Q0 with no
    columns (the port's kernels take none), sd / y_res / rss0 / dof kept."""
    Wq, ws = jscan.quantize_rotation(
        jnp.asarray(folded_w(rot_exact.W, rot_exact.Q0)), _jax_tier(tier),
        sd_dtype=rot_exact.sd.dtype)
    return dataclasses.replace(rot_exact, W=Wq, w_scale=ws,
                               Q0=rot_exact.Q0[:, :0])


def fold_jax_tiers(monkeypatch):
    """Make every JAX entry point build its fast-tier rotated null as
    jax_folded does (the exact tier and the rescore are left as they
    are): a test-local wrapper of the JAX package's build_rotated_null."""
    orig = jscan.build_rotated_null

    def build(null, rotate_dtype=None):
        rot = orig(null)
        return rot if rotate_dtype is None else jax_folded(rot, rotate_dtype)

    for name in ("mixmogam_tpu.ops.scan", "mixmogam_tpu.models.emmax",
                 "mixmogam_tpu.models.streaming"):
        monkeypatch.setattr(importlib.import_module(name),
                            "build_rotated_null", build)


def _null(seed, n=90, m=200, q=1):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 2, (m, n)).astype(np.int8)
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    y = G[5] * 0.8 + rng.normal(size=n)
    X0 = np.ones((n, 1)) if q == 1 else np.column_stack(
        [np.ones(n), rng.normal(size=(n, q - 1))])
    nj = j_fit(y, X0, K=K)
    nt = fit_null_model(y, X0, eig_k=(np.asarray(nj.phi), np.asarray(nj.U)),
                        device="cpu")
    return G, y, X0, nj, nt


@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("tier", ["int8x2", "int8x3", "int8x4", "bf16",
                                  "bf16x2", "bf16x3"])
def test_folded_operand_bit_equal_to_jax(tier, q):
    """build_rotated_null's planes / parts are JAX's quantize_rotation of
    W'' built from JAX's W and Q0, bit for bit; Q0, y_res, rss0 and dof
    keep the values of the unfolded null."""
    _, _, _, nj, nt = _null(20 + q, q=q)
    ref = jax_folded(jscan.build_rotated_null(nj), tier)
    rt = scan.build_rotated_null(nt, rotate_dtype=tier)
    assert rt.folded and rt.U is None and rt.scan_q0.shape == (90, 0)
    if tier.startswith("int8"):
        np.testing.assert_array_equal(rt.planes.numpy(), np.asarray(ref.W))
        np.testing.assert_allclose(rt.w_scale.numpy(),
                                   np.asarray(ref.w_scale), rtol=1e-13,
                                   atol=0)
    else:
        parts = np.asarray(ref.W).astype(np.float32).reshape(
            (-1,) + rt.parts.shape[1:])
        np.testing.assert_array_equal(rt.parts.float().numpy(), parts)
    unf = jscan.build_rotated_null(nj, rotate_dtype=_jax_tier(tier))
    for f in ("sd", "Q0", "y_res", "rss0", "dof"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(unf, f)), rtol=1e-10,
                                   atol=1e-10)


def test_folded_rows_are_orthogonal_to_q0():
    """Rows rotated by the dequantized W'' have no part along Q0 beyond
    the tier's rounding, and their xy with y_res is the unfolded one."""
    G, _, _, nj, nt = _null(31, q=3)
    rt = scan.build_rotated_null(nt, rotate_dtype="int8x4")
    Xs = scan.apply_rotation(torch.from_numpy(G).double(), rt.planes,
                             rt.w_scale, torch.float64)
    W = torch.from_numpy(np.array(jscan.build_rotated_null(nj).W))
    X = torch.from_numpy(G).double() @ W
    c = Xs @ rt.Q0
    assert float(c.abs().max()) < 1e-6 * float(Xs.abs().max())
    torch.testing.assert_close(Xs @ rt.y_res, X @ rt.y_res, rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_quantize_rotation_zero_and_tiny_columns(dtype):
    """An all-zero column and one below the scale dtype's smallest normal
    (a folded design column at rounding level) give zero digits and a
    finite power-of-two scale, never 0 or a NaN; the bf16 split of a zero
    column is zero parts."""
    rng = np.random.default_rng(4)
    W = torch.from_numpy(rng.normal(size=(40, 40)))
    W[:, 3] = 0.0
    # below the smallest normal of the scale's dtype
    W[:, 9] = torch.from_numpy(rng.normal(size=40)) * (
        torch.finfo(dtype).tiny * 1e-2)
    for tier in ("int8x2", "int8x3", "int8x4"):
        planes, ws = scan.quantize_rotation(W, tier, sd_dtype=dtype)
        assert ws.dtype == dtype
        assert bool(torch.isfinite(ws).all()) and bool((ws > 0).all())
        m, e = torch.frexp(ws)
        assert bool((m == 0.5).all())            # powers of two
        assert not planes[:, :, 3].any() and not planes[:, :, 9].any()
        back = scan.apply_rotation(torch.eye(40, dtype=torch.float64),
                                   planes, ws, torch.float64)
        keep = [j for j in range(40) if j not in (3, 9)]
        torch.testing.assert_close(back[:, keep], W[:, keep], rtol=0,
                                   atol=float(W.abs().max()) * 2.0 ** -12)
    for tier in ("bf16", "bf16x3"):
        parts, _ = scan.quantize_rotation(W, tier)
        assert not parts[:, :, 3].float().any()
        assert not parts[:, :, 9].float().any()


def _design(n, q, seed):
    """An intercept and q - 1 standard-normal covariates."""
    rng = np.random.default_rng(seed)
    return np.column_stack([np.ones(n), rng.normal(size=(n, q - 1))])


@pytest.mark.parametrize("q", [20, 128])
@pytest.mark.parametrize("tier", _FAST)
def test_wide_designs_at_the_fast_tiers(tier, q, monkeypatch):
    """An intercept + 19 covariates and a 128-column design through
    emmax_resident: against JAX x64 on the folded operand at the fast-tier
    tests' 1e-9, against the port's exact tier with identical masks and
    max |dp| <= 1e-4; the kernels' operand has no Q0 columns."""
    from mixmogam_tpu.models.resident import ResidentGenome as JResident
    from mixmogam_tpu.models.resident import emmax_resident as j_resident

    n, m = 160, 300
    G, _, _ = simulate_genotypes(n, m, ploidy=1, seed=q)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=3, seed=q)
    X0 = _design(n, q, q + 1)
    eig = tuple(np.asarray(a) for a in j_eigen_k(
        scale_k(ibs_kinship(G.astype(np.float64)))))
    rg = ResidentGenome.from_source(G, tile=128, device="cpu")
    res = emmax_resident(rg, y, X0=X0, eig_k=eig, precision=tier)
    ex = emmax_resident(rg, y, X0=X0, eig_k=eig)
    assert res["dof"] == ex["dof"] == n - q - 1
    np.testing.assert_array_equal(res["mask"], ex["mask"])
    assert np.abs(res["ps"] - ex["ps"]).max() <= 1e-4
    fold_jax_tiers(monkeypatch)
    # one BLAS thread: the JAX null fit's 128-column solves otherwise spin
    # against the other test workers' threads
    with threadpool_limits(1):
        ref = j_resident(JResident.from_source(G, tile=128), y, X0=X0,
                         eig_k=eig, precision=tier)
    np.testing.assert_array_equal(res["mask"], ref["mask"])
    np.testing.assert_allclose(res["ps"], ref["ps"], rtol=0, atol=1e-9)


@pytest.mark.parametrize("tier", _FAST + ("exact",))
def test_129_design_columns_raise(tier):
    """The int8 / bf16 tiers take designs of up to 128 columns (the TPU
    kernels' QPAD; their exact rescore runs K3); 129 raise before any
    scan. The exact tier on the CPU has no such limit (its plain K3)."""
    n = 160
    G, _, _ = simulate_genotypes(n, 200, ploidy=1, seed=5)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=3, seed=5)
    X0 = _design(n, 129, 6)
    rg = ResidentGenome.from_source(G, tile=128, device="cpu")
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    if tier == "exact":
        assert emmax_resident(rg, y, X0=X0, K=K)["dof"] == n - 130
        return
    with pytest.raises(ValueError, match="up to 128 columns"):
        emmax_resident(rg, y, X0=X0, K=K, precision=tier)


@pytest.fixture(scope="module")
def wide_files(tmp_path_factory):
    """A CSV genotype file, a phenotype and 19 covariate phenotypes."""
    tmp = tmp_path_factory.mktemp("wide")
    n = 150
    G, ch, po = simulate_genotypes(n, 400, ploidy=1, seed=9)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=3, seed=9)
    acc = [f"s{i}" for i in range(n)]
    GenotypeData(G, ch, po, acc, ploidy=1).write_csv(str(tmp / "g.csv"))
    ph = PhenotypeData.from_arrays(1, "t", acc, y)
    rng = np.random.default_rng(10)
    for k in range(19):
        ph.add_phenotype(2 + k, f"c{k}", acc, list(rng.normal(size=n)))
    ph.write_to_file(str(tmp / "p.csv"))
    return str(tmp / "g.csv"), str(tmp / "p.csv")


@pytest.mark.parametrize("tier", _FAST)
def test_run_gwas_with_19_covariates(wide_files, tier):
    """run_gwas with an intercept + 19 covariate phenotypes at a fast
    tier: the same masks as the exact tier and max |dp| <= 1e-4."""
    kw = dict(covariate_pids=list(range(2, 21)), plots=False,
              device="cpu")
    a = api.run_gwas(*wide_files, precision=tier, **kw)["scan"]
    b = api.run_gwas(*wide_files, **kw)["scan"]
    assert a["dof"] == b["dof"] == 150 - 21
    np.testing.assert_array_equal(a["mask"], b["mask"])
    assert np.abs(a["ps"] - b["ps"]).max() <= 1e-4


@pytest.mark.parametrize("tier", _FAST)
def test_vanraden_delta_at_its_bound_float32(tier, tmp_path):
    """The CPU twin of chip_smoke.py's singular-K check: VanRaden's K
    (a zero eigenvalue along the intercept), n = 256, seed 3, no noise,
    delta at its lower bound; the fast tier in float32 against the float64
    path: identical masks, max |dp| <= 1e-4."""
    G, ch, po = simulate_genotypes(256, 3_000, ploidy=1, seed=3)
    acc = [f"s{i}" for i in range(256)]
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=4, seed=3)
    gv, pv = str(tmp_path / "v.csv"), str(tmp_path / "p.csv")
    GenotypeData(G, ch, po, acc, ploidy=1).write_csv(gv)
    PhenotypeData.from_arrays(1, "t", acc, y).write_to_file(pv)
    kw = dict(kinship_method="vanraden", plots=False, device="cpu")
    ref = api.run_gwas(gv, pv, **kw)["scan"]
    got = api.run_gwas(gv, pv, precision=tier, dtype=torch.float32,
                       **kw)["scan"]
    assert ref["delta"] == pytest.approx(np.exp(-10.0), rel=1e-6)
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    assert np.abs(got["ps"] - ref["ps"]).max() <= 1e-4


@pytest.mark.parametrize("tier", ["int8x2", "int8x3", "int8x4", "bf16",
                                  "bf16x2", "bf16x3"])
def test_rows_inside_the_design_masked_at_every_fast_tier(tier):
    """A monomorphic row (inside the intercept) and a row equal to a design
    column come out masked with every output zero; a real row does not;
    the exact tier masks the same rows."""
    n, m = 96, 64
    G, _, _ = simulate_genotypes(n, m, ploidy=1, seed=12)
    G = G.copy()
    G[3] = 1                                      # monomorphic
    G[7] = 0                                      # all zero
    cov = (np.arange(n) % 2).astype(np.int8)      # a 0/1 covariate
    G[11] = cov                                   # the covariate's own row
    X0 = np.column_stack([np.ones(n), cov])
    y = G[20] * 0.5 + np.random.default_rng(13).normal(size=n)
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    rg = ResidentGenome.from_source(G, tile=64, device="cpu")
    res = emmax_resident(rg, y, X0=X0, K=K, precision=tier)
    ex = emmax_resident(rg, y, X0=X0, K=K)
    inside = [3, 7, 11]
    assert not res["mask"][inside].any()
    assert (res["f_stats"][inside] == 0).all()
    assert (res["ps"][inside] == 1.0).all()
    np.testing.assert_array_equal(res["mask"], ex["mask"])
    assert res["mask"].sum() == m - 3


def test_design_mask_is_one_pass_a_call(monkeypatch):
    """emmax_scan_packed unpacks the genome once for the mask at a fast
    tier (a tile at a time), and imputes missing calls as K5 does."""
    from mixmogam_tpu_torch.models import resident

    n = 80
    rng = np.random.default_rng(14)
    G = rng.integers(0, 3, (300, n)).astype(np.int8)
    G[rng.random(G.shape) < 0.05] = -1
    G[5] = np.where(G[5] < 0, -1, 2)              # observed calls all 2
    K = scale_k(ibs_kinship(np.where(G < 0, 0, G).astype(np.float64)))
    rg = ResidentGenome.from_source(G, tile=128, device="cpu")
    nt = fit_null_model(rng.normal(size=n), np.ones((n, 1)), K=K,
                        device="cpu")
    rot = scan.build_rotated_null(nt, rotate_dtype="bf16x3")
    keep = design_mask_packed(rg.packed, rot, n, rg.tile, impute=True)
    assert keep.shape == (rg.packed.shape[0],)
    assert not keep[5] and keep[:300].sum() == 299 and not keep[300:].any()
    calls = []
    real = resident.unpack_2bit_device
    monkeypatch.setattr(resident, "unpack_2bit_device",
                        lambda p, n_: calls.append(p.shape[0]) or real(p, n_))
    out = emmax_scan_packed(rg.packed, rot, n, rg.tile, impute=True)
    # the mask pass (3 tiles) and the per-row means (3 tiles)
    assert calls == [128, 128, 128] * 2
    assert out[3, 5] == 0 and bool((out[:, ~keep] == 0).all())


def test_operand_takes_no_q0_columns():
    """scan_operand builds K2 / K5's operand from the kernels' Q0, which
    has no columns for the folded W'', whatever the design's width."""
    _, _, _, _, nt = _null(40, q=17)
    for tier in ("int8x3", "bf16x3"):
        rot = scan.build_rotated_null(nt, rotate_dtype=tier)
        assert rot.Q0.shape == (90, 17)
        op = scan_operand(rot)
        assert op.q0t.shape == (0, op.n_steps * op.cn)
