"""PyTorch port, the split-W bf16 tiers: the parts bit-equal to the JAX
package's, the plain version of kernel K5 against the Pallas kernel
(interpret mode) and against the XLA tier, the tier names, and the bf16
tiers on a resident genome with missing genotypes (CPU, x64)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mixmogam_tpu.models.emmax import emmax as j_emmax
from mixmogam_tpu.models.resident import ResidentGenome as JResident
from mixmogam_tpu.models.resident import emmax_resident as j_resident
from mixmogam_tpu.models.resident import emmax_scan_packed as j_scan_packed
from mixmogam_tpu.ops import scan as jscan
from mixmogam_tpu.ops.eigen import eigen_k as j_eigen_k
from mixmogam_tpu.ops.kinship import kinship as j_kinship
from mixmogam_tpu.ops.pallas_scan import pallas_rotate_scan
from mixmogam_tpu.ops.reml import fit_null_model as j_fit
from mixmogam_tpu.oracle.kinship import scale_k
from mixmogam_tpu_torch.convert import (resident_from_packed,
                                        rotated_null_from_numpy)
from mixmogam_tpu_torch.models.emmax import emmax
from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                emmax_resident,
                                                emmax_scan_packed)
from mixmogam_tpu_torch.ops import scan
from mixmogam_tpu_torch.ops.hopper_scan import (
    rotate_scan_bf16_packed, rotate_scan_bf16_packed_plain)
from test_torch_fold import fold_jax_tiers, jax_folded

torch.set_num_threads(1)

_ROT_FIELDS = ("W", "sd", "Q0", "y_res", "rss0", "dof", "w_scale")


def _data(seed=0, n=96, m=400, missing=0.0):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 3, (m, n)).astype(np.int8)
    if missing:
        G[rng.random((m, n)) < missing] = -1
        G[7] = -1                                   # an all-missing row
    Gf = np.where(G < 0, 1.0, G).astype(np.float64)
    y = Gf[3] * 0.9 + rng.normal(size=n)
    return G, y


def _kinship(G):
    return scale_k(j_kinship(G, method="ibs"))


def _pair(G, tile=128):
    jrg = JResident.from_source(G, tile=tile)
    rg = resident_from_packed(jrg.host_packed, jrg.M, jrg.n, jrg.ploidy,
                              jrg.tile, jrg.has_missing)
    return jrg, rg


def _carry(rot_j, dtype):
    return rotated_null_from_numpy(
        *(None if getattr(rot_j, f) is None else np.asarray(getattr(rot_j, f))
          for f in _ROT_FIELDS), dtype=dtype)


def _rotation(dtype, n=90, seed=3, subnormal=True):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.normal(size=(n, n)))
    W = U * rng.uniform(0.1, 3.0, n)[None, :]
    W[:, 7] = 0.0                                    # an all-zero column
    if subnormal:                                    # below f32's tiny
        W[:, 5] *= 1e-39
        W[:, 6] = rng.normal(size=n) * 1e-41
        W[:, 8] *= 1e-36
    return W.astype(dtype)


def _bits(t):
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("tier", ["bf16x2", "bf16x3", "bf16x2c",
                                  "bf16x3c"])
def test_split_w_parts_bit_equal_to_jax(tier):
    """float64 W (the tests' x64 rotation), subnormal columns included:
    every part bit for bit, whatever the layout (stacked or concat)."""
    W = _rotation(np.float64)
    n, k = W.shape[0], int(tier[5])
    pj, sj = jscan.quantize_rotation(jnp.asarray(W), tier)
    pj = np.asarray(pj)
    if tier.endswith("c"):
        pj = np.stack([pj[:, i * n:(i + 1) * n] for i in range(k)])
    pt, st = scan.quantize_rotation(torch.from_numpy(W), tier)
    assert sj is None and st is None
    assert pt.dtype == torch.bfloat16 and pt.shape == (k, n, n)
    np.testing.assert_array_equal(_bits(pt), pj.view(np.int16))


@pytest.mark.parametrize("tier", ["bf16", "bf16x2", "bf16x3"])
def test_parts_bit_equal_for_float32_w(tier):
    """The card's case: W = U * sd in float32 (normal entries)."""
    W = _rotation(np.float32, seed=4, subnormal=False)
    jt = jnp.bfloat16 if tier == "bf16" else tier
    pj = np.asarray(jscan.quantize_rotation(jnp.asarray(W), jt)[0])
    pt, _ = scan.quantize_rotation(torch.from_numpy(W), tier)
    np.testing.assert_array_equal(_bits(pt), pj.reshape(pt.shape).view(
        np.int16))


def test_parts_sum_to_w():
    W = _rotation(np.float32, seed=5, subnormal=False)
    for k in (2, 3):
        pt, _ = scan.quantize_rotation(torch.from_numpy(W), f"bf16x{k}")
        rec = pt.double().sum(dim=0).numpy()
        bound = 2.0 ** (-8 * k) * np.abs(W).max(axis=0)[None, :]
        assert (np.abs(rec - W) <= bound).all()


@pytest.mark.parametrize("tier", ["bf16x2", "bf16x3"])
def test_plain_k5_vs_pallas_interpret(tier):
    """tests/test_kernels.py's tolerances for the Pallas kernel against
    XLA: f rtol 1e-4 / atol 1e-3, beta atol 1e-5, identical masks."""
    G, y = _data(1)
    null = j_fit(y.astype(np.float32), np.ones((len(y), 1), np.float32),
                 K=_kinship(G).astype(np.float32))
    rot_j = jscan.build_rotated_null(null, rotate_dtype=tier)
    pal = pallas_rotate_scan(G, rot_j, tm=128, nb=128, interpret=True)
    rot = _carry(rot_j, torch.float32)
    rg = ResidentGenome.from_source(G, tile=128, device="cpu")
    ours = rotate_scan_bf16_packed_plain(rg.packed, rg.n, rot.parts,
                                         rot.y_res, rot.Q0, rot.rss0,
                                         rot.dof)[:, :rg.M]
    assert ours.dtype == torch.float32
    np.testing.assert_array_equal(ours[3].numpy() > 0.5,
                                  np.asarray(pal["mask"]))
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(pal["f_stats"]),
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(pal["betas"]),
                               atol=1e-5)


@pytest.mark.parametrize("missing", [0.0, 0.04])
def test_plain_scan_matches_jax_xla_tier_f64(missing):
    """The port's K5 plain path (with per-row means on a genome with
    missing genotypes) against JAX's XLA emmax_scan_packed at bf16x3,
    float64: the bf16 roundings are the same, the products exact."""
    G, y = _data(2, missing=missing)
    K = scale_k(j_kinship(np.where(G < 0, 0, G).astype(np.int8),
                          method="ibs"))
    null = j_fit(y, np.ones((len(y), 1)), K=K)
    rot_j = jscan.build_rotated_null(null, rotate_dtype="bf16x3")
    jrg, rg = _pair(G)
    ref = j_scan_packed(jrg.packed, rot_j, jrg.n, jrg.tile,
                        impute=jrg.has_missing)
    rot = _carry(rot_j, torch.float64)
    ours = emmax_scan_packed(rg.packed, rot, rg.n, rg.tile,
                             impute=rg.has_missing)
    assert rg.has_missing == bool(missing)
    np.testing.assert_array_equal(ours[3].numpy() > 0.5,
                                  np.asarray(ref["mask"]))
    for i, k in enumerate(("f_stats", "betas", "var_perc")):
        np.testing.assert_allclose(ours[i].numpy(), np.asarray(ref[k]),
                                   rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("missing", [0.0, 0.04])
@pytest.mark.parametrize("tier", ["bf16", "bf16x3"])
def test_resident_bf16_matches_jax(tier, missing, monkeypatch):
    """emmax_resident end to end at a bf16 tier; missing genotypes run
    (the has-missing check refuses int8 tiers only). The JAX reference
    quantizes the port's folded W'' (test_torch_fold.py)."""
    fold_jax_tiers(monkeypatch)
    G, y = _data(3, missing=missing)
    eig = tuple(np.asarray(a) for a in j_eigen_k(_kinship(
        np.where(G < 0, 0, G).astype(np.int8))))
    jrg, rg = _pair(G)
    ref = j_resident(jrg, y, eig_k=eig, precision=tier)
    res = emmax_resident(rg, y, eig_k=eig, precision=tier)
    assert res["precision_tier"] == ref["precision_tier"] == tier
    np.testing.assert_allclose(res["ps"], ref["ps"], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(res["mask"], ref["mask"])
    assert not res["mask"][7] or not missing


def test_int8_tiers_still_refuse_missing():
    G, y = _data(4, missing=0.04)
    rg = ResidentGenome.from_source(G, tile=128, device="cpu")
    K = _kinship(np.where(G < 0, 0, G).astype(np.int8))
    out = emmax_resident(rg, y, K=K, precision="bf16x3")
    assert np.isfinite(out["ps"]).all()
    for tier in ("int8x2", "int8x3", "int8x4"):
        with pytest.raises(ValueError, match="fully-observed"):
            emmax_resident(rg, y, K=K, precision=tier)


def test_bf16_tiers_close_to_exact():
    G, y = _data(5)
    eig = tuple(np.asarray(a) for a in j_eigen_k(_kinship(G)))
    rg = ResidentGenome.from_source(G, tile=128, device="cpu")
    ex = emmax_resident(rg, y, eig_k=eig)
    for tier, tol in (("bf16x3", 1e-7), ("bf16x2", 1e-4), ("bf16", 5e-2)):
        q = emmax_resident(rg, y, eig_k=eig, precision=tier)
        np.testing.assert_array_equal(q["mask"], ex["mask"])
        assert np.abs(q["ps"] - ex["ps"]).max() < tol, tier


@pytest.mark.parametrize("k", [2, 3])
def test_concat_tier_gives_the_stacked_numbers(k):
    G, y = _data(6)
    eig = tuple(np.asarray(a) for a in j_eigen_k(_kinship(G)))
    rg = ResidentGenome.from_source(G, tile=128, device="cpu")
    a = emmax_resident(rg, y, eig_k=eig, precision=f"bf16x{k}")
    b = emmax_resident(rg, y, eig_k=eig, precision=f"bf16x{k}c")
    np.testing.assert_array_equal(a["ps"], b["ps"])
    assert b["precision_tier"] == f"bf16x{k}c"


@pytest.mark.parametrize("spelling", [True, "bf16", "bfloat16", "x2", "x3",
                                      "bf16x2", "bf16x3", "bf16x2c",
                                      "bf16x3c", "int8x3", False, None])
def test_tier_spellings_match_jax(spelling):
    ref = jscan.normalize_rotate_tier(spelling)
    ours = scan.normalize_rotate_tier(spelling)
    assert ours == ("bf16" if ref is jnp.bfloat16 else ref)
    assert scan.tier_drift_name(ours) == jscan.tier_drift_name(ref, None)


def test_precision_names_match_jax():
    for p in ("exact", "bf16", "bf16x2", "bf16x3", "bf16x2c", "bf16x3c",
              "int8x2", "int8x3", "int8x4"):
        rb, mp, name = jscan.resolve_precision(p)
        ours = scan.resolve_precision(p)
        assert ours == (rb, name) and mp is None
    # 'high': JAX's (False, 'high') pair, the exact tier's route with the
    # 'high' matmul precision (ops/scan.py::matmul_tier)
    rb, mp, name = jscan.resolve_precision("high")
    ours = scan.resolve_precision("high")
    assert ours == (scan.HIGH, name) == ("high", "high")
    assert scan.matmul_tier(scan.normalize_rotate_tier(ours[0])) == (
        jscan.normalize_rotate_tier(rb), mp)
    for bad in ("bf16x4", "int8"):
        with pytest.raises(ValueError):
            scan.resolve_precision(bad)
        with pytest.raises(ValueError):
            jscan.resolve_precision(bad)
    with pytest.raises(ValueError):
        scan.normalize_rotate_tier("bf16x5")


@pytest.mark.parametrize("tier", ["bf16", "bf16x3", "bf16x2c"])
def test_convert_carries_jax_bf16_w(tier):
    G, y = _data(7, n=40, m=60)
    null = j_fit(y, np.ones((len(y), 1)), K=_kinship(G))
    # JAX's split of the port's folded W'' (test_torch_fold.py)
    rot_j = jax_folded(jscan.build_rotated_null(null), tier)
    rot = _carry(rot_j, torch.float64)
    from mixmogam_tpu_torch.ops.reml import fit_null_model

    nt = fit_null_model(y, np.ones((len(y), 1)),
                        eig_k=(np.asarray(null.phi), np.asarray(null.U)),
                        device="cpu")
    own = scan.build_rotated_null(nt, rotate_dtype=tier)
    assert rot.U is None and rot.planes is None
    np.testing.assert_array_equal(_bits(rot.parts), _bits(own.parts))


def test_incore_bf16_routes_and_fractional_refusal(monkeypatch):
    # the JAX reference quantizes the port's folded W'' (test_torch_fold.py)
    fold_jax_tiers(monkeypatch)
    G, y = _data(8, missing=0.03)
    K = _kinship(np.where(G < 0, 0, G).astype(np.int8))
    eig = tuple(np.asarray(a) for a in j_eigen_k(K))
    ref = j_emmax(G, y, eig_k=eig, precision="bf16x3", stream=False)
    res = emmax(G, y, eig_k=eig, precision="bf16x3", device="cpu")
    np.testing.assert_allclose(res["ps"], ref["ps"], rtol=0, atol=1e-9)
    Gf = G.astype(np.float64)
    Gf[G < 0] = np.nan                               # NaN-missing float
    np.testing.assert_array_equal(
        emmax(Gf, y, eig_k=eig, precision="bf16x3",
              device="cpu")["ps"], res["ps"])
    # fractional dosages take the float route (bf16 products by the parts
    # of U', then K3): p within 1e-6 of the JAX package's bf16x3 and the
    # same masks, but for the all-missing row, now a constant 0.5: it lies
    # inside col(X0), and the port masks it (ops/scan.py::outside_design)
    Gh = np.where(G < 0, 0.5, G).astype(np.float64)
    frac = emmax(Gh, y, eig_k=eig, precision="bf16x3", device="cpu")
    ref = j_emmax(Gh, y, eig_k=eig, precision="bf16x3", stream=False)
    assert frac["precision_tier"] == "bf16x3"
    assert not frac["mask"][7] and frac["ps"][7] == 1.0
    rest = np.flatnonzero(np.arange(Gh.shape[0]) != 7)
    np.testing.assert_array_equal(frac["mask"][rest], ref["mask"][rest])
    np.testing.assert_allclose(frac["ps"][rest], ref["ps"][rest], rtol=0,
                               atol=1e-6)


def test_k5_wrapper_routes_cpu_to_plain_and_refuses_other_devices():
    G, y = _data(9, n=40, m=70)
    null = j_fit(y, np.ones((len(y), 1)), K=_kinship(G))
    rot = _carry(jscan.build_rotated_null(null, rotate_dtype="bf16x2"),
                 torch.float64)
    rg = ResidentGenome.from_source(G, tile=64, device="cpu")
    a = (rg.packed, rg.n, rot.parts, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    before = rotate_scan_bf16_packed.launches
    torch.testing.assert_close(rotate_scan_bf16_packed(*a),
                               rotate_scan_bf16_packed_plain(*a), rtol=0,
                               atol=0)
    assert rotate_scan_bf16_packed.launches == before
    meta = torch.zeros((64, 10), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="device"):
        rotate_scan_bf16_packed(meta, 40, *a[2:])
