"""PyTorch port, ops layer: unpack, digit planes, REML, rotated null —
each held against the JAX package (CPU, x64) on the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mixmogam_tpu import native
from mixmogam_tpu.ops import eigen as jeigen
from mixmogam_tpu.ops import reml as jreml
from mixmogam_tpu.ops import scan as jscan
from mixmogam_tpu.ops.pack2 import unpack_2bit_device as j_unpack
from mixmogam_tpu.oracle.kinship import ibs_kinship, scale_k
from mixmogam_tpu_torch.ops import eigen, reml, scan, xreml
from mixmogam_tpu_torch.ops.pack2 import unpack_2bit_device
from test_torch_fold import jax_folded

torch.set_num_threads(1)


def _problem(seed=0, n=120, m=300, q=1):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 2, (m, n)).astype(np.int8)
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    y = G[5] * 0.8 + rng.normal(size=n)
    X0 = np.ones((n, 1)) if q == 1 else np.column_stack(
        [np.ones(n), rng.normal(size=(n, q - 1))])
    return G, K, y, X0


def test_tf32_pinned_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("n", [150, 151, 152, 153])
def test_unpack_matches_native_and_jax(n):
    rng = np.random.default_rng(n)
    G = rng.integers(-1, 3, (37, n)).astype(np.int8)
    P = native.pack_2bit(G)
    ours = unpack_2bit_device(torch.from_numpy(P), n).numpy()
    np.testing.assert_array_equal(ours, native.unpack_2bit(P, n))
    np.testing.assert_array_equal(ours, np.asarray(j_unpack(jnp.asarray(P),
                                                            n)))
    np.testing.assert_array_equal(ours, G)


def _rotation(dtype, n=90, seed=3):
    rng = np.random.default_rng(seed)
    U, _ = np.linalg.qr(rng.normal(size=(n, n)))
    W = (U * rng.uniform(0.1, 3.0, n)[None, :]).astype(dtype)
    W[:, 7] = 0.0                                   # an all-zero column
    return W


@pytest.mark.parametrize("tier", ["int8x2", "int8x3", "int8x4"])
def test_quantize_rotation_bit_equal(tier):
    """Digit planes bit-equal to the JAX function's (float64). w_scale is
    the exact power of two 2^(e - (8K-2)) both define; XLA's CPU exp2
    computes exp(x ln 2) and lands up to ~1e-14 (relative) off it, so the
    JAX scale is held to the same exponent and to rtol 1e-13."""
    W = _rotation(np.float64)
    pj, sj = jscan.quantize_rotation(jnp.asarray(W), tier)
    pt, st = scan.quantize_rotation(torch.from_numpy(W), tier)
    assert pt.dtype == torch.int8 and st.dtype == torch.float64
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    sj = np.asarray(sj)
    np.testing.assert_array_equal(np.frexp(st.numpy())[0], 0.5)
    np.testing.assert_allclose(st.numpy(), sj, rtol=1e-13, atol=0)
    np.testing.assert_array_equal(np.frexp(st.numpy())[1],
                                  np.frexp(sj * (1 + 2 ** -40))[1])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("tier", ["int8x2", "int8x3", "int8x4"])
def test_quantize_rotation_digits_reconstruct(tier, dtype):
    """Balanced base-256 digits, power-of-two scale: sum_p 256^p P_p *
    w_scale rounds W to 8K-2 bits below each column's max."""
    W = _rotation(dtype)
    pt, st = scan.quantize_rotation(torch.from_numpy(W), tier)
    assert st.dtype == torch.from_numpy(W).dtype
    np.testing.assert_array_equal(np.frexp(st.numpy())[0], 0.5)
    P = pt.numpy().astype(np.int64)
    assert P.min() >= -128 and P.max() <= 127
    Wi = sum(P[p] * 256 ** p for p in range(P.shape[0]))
    rec = Wi * st.numpy().astype(np.float64)[None, :]
    err = np.abs(rec - W.astype(np.float64))
    assert (err <= 0.5 * st.numpy()[None, :] * (1 + 1e-6)).all()


@pytest.mark.parametrize("tier", [None, "int8x2", "int8x3", "int8x4"])
def test_apply_rotation_matches_jax(tier):
    """Same W representation (the JAX planes and scale, carried over) into
    both apply_rotation functions, float64. The int8 plane sums are exact
    integers in both; the recombine and scale round alike to ~1e-16."""
    W = _rotation(np.float64)
    rng = np.random.default_rng(11)
    G = rng.integers(0, 3, (25, W.shape[0])).astype(np.int8)
    Wj, sj = jscan.quantize_rotation(jnp.asarray(W), tier)
    ref = np.asarray(jscan.apply_rotation(jnp.asarray(G), Wj, sj,
                                          jnp.float64))
    ours = scan.apply_rotation(
        torch.from_numpy(G), torch.from_numpy(np.array(Wj)),
        None if sj is None else torch.from_numpy(np.array(sj)),
        torch.float64)
    assert ours.dtype == torch.float64
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("esp", [1e-6, 1e-3, 1e-9, 0.5, 1e-30])
@pytest.mark.parametrize("ngrids", [10, 100])
def test_esp_to_refine_iters_copy(esp, ngrids):
    assert (reml.esp_to_refine_iters(esp, ngrids)
            == jreml.esp_to_refine_iters(esp, ngrids))


@pytest.mark.parametrize("q,ml", [(1, False), (3, False), (1, True)])
def test_explicit_reml_copy(q, ml):
    """fit_null_model's optimizer, ops/xreml.py's explicit_reml (float64,
    torch), against the JAX package's host optimizer, whose numpy copy it
    replaced in the port: the fit to 1e-10, LL and dLL/dlog delta to
    1e-10 relative."""
    G, K, y, X0 = _problem(q=q)
    w, v = np.linalg.eigh(K)
    phi, U = w[::-1], v[:, ::-1]
    args = (phi, U.T @ y, U.T @ X0)
    targs = tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in args)
    ref = jreml._explicit_reml_host(*args, ml=ml)
    ours = xreml.explicit_reml(*targs, reml=not ml)
    for k, v in ref.items():
        assert abs(float(ours[k]) - v) <= 1e-10 * max(1.0, abs(v)), k
    ll_at, dll_at = jreml._explicit_ll_host(*args, ml=ml)[:2]
    for ld in (-3.0, 0.0, 2.5):
        got = float(xreml.ll_explicit(ld, *targs, reml=not ml))
        assert abs(got - ll_at(ld)) <= 1e-10 * abs(ll_at(ld))
        got = float(xreml.dll_explicit(ld, *targs, reml=not ml))
        assert abs(got - dll_at(ld)) <= 1e-10 * max(1.0, abs(dll_at(ld)))


def test_numpy_helper_copies(monkeypatch):
    """The drift table holds the card's own values (chip_smoke.py phases 4
    and 12) for every tier of the JAX package, 'high' included; the
    rescore cut and selection are the JAX functions' copies, held to them
    with the JAX table pointed at the port's values."""
    rng = np.random.default_rng(4)
    assert set(scan.TIER_P_DRIFT) == set(jscan.TIER_P_DRIFT)
    assert set(scan.GXE_P_DRIFT) == set(scan.TIER_P_DRIFT)
    monkeypatch.setattr(jscan, "TIER_P_DRIFT", dict(scan.TIER_P_DRIFT))
    ps = rng.uniform(size=500) ** 4
    for tier in ("int8x2", "int8x3", "bf16x3", "high", "exact", "nope"):
        cut = scan.rescore_p_cut(500, tier)
        drift = scan.TIER_P_DRIFT.get(tier, max(scan.TIER_P_DRIFT.values()))
        assert cut == 0.05 / 500 + 8.0 * drift
        assert cut == jscan.rescore_p_cut(500, tier)
        np.testing.assert_array_equal(
            scan.select_rescore_idx(ps, 16, tier),
            jscan.select_rescore_idx(ps, 16, tier))
        assert scan.rescore_p_cut(500, tier, table=scan.GXE_P_DRIFT) == (
            0.05 / 500 + 8.0 * scan.GXE_P_DRIFT.get(
                tier, max(scan.GXE_P_DRIFT.values())))


def test_eigen_k_host_matches_jax():
    _, K, _, _ = _problem()
    pj, uj = jeigen.eigen_k(K)
    pt, ut = eigen.eigen_k(K)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    # torch.linalg.eigh agrees on the spectrum (eigenvectors: up to sign)
    pd, _ = eigen.eigen_k(torch.from_numpy(K), host=False)
    np.testing.assert_allclose(pd.numpy(), np.asarray(pj), atol=1e-10)


@pytest.mark.parametrize("q", [1, 3])
def test_fit_null_model_matches_jax(q):
    _, K, y, X0 = _problem(seed=q, q=q)
    nj = jreml.fit_null_model(y, X0, K=K)
    nt = reml.fit_null_model(y, X0, K=K, device="cpu")
    for f in ("delta", "ll", "pseudo_heritability", "sigma_g2",
              "log_delta"):
        np.testing.assert_allclose(float(getattr(nt, f)),
                                   float(getattr(nj, f)), rtol=1e-10,
                                   atol=1e-10)


def test_fit_null_model_spectrum_not_ported():
    """method='spectrum' was refused until the spectrum REML was ported;
    it now fits, equal to the JAX package's spectrum path, and only an
    unknown method is refused (tests/test_torch_spectrum.py has the rest)."""
    _, K, y, X0 = _problem()
    nj = jreml.fit_null_model(y, X0, K=K, method="spectrum")
    nt = reml.fit_null_model(y, X0, K=K, method="spectrum", device="cpu")
    for f in ("delta", "ll", "pseudo_heritability", "sigma_g2",
              "log_delta"):
        np.testing.assert_allclose(float(getattr(nt, f)),
                                   float(getattr(nj, f)), rtol=1e-9,
                                   atol=1e-9)
    with pytest.raises(ValueError, match="unknown method"):
        reml.fit_null_model(y, X0, K=K, method="grid", device="cpu")


@pytest.mark.parametrize("q", [1, 3])
def test_build_rotated_null_matches_jax(q):
    _, K, y, X0 = _problem(seed=10 + q, q=q)
    nj = jreml.fit_null_model(y, X0, K=K)
    nt = reml.fit_null_model(y, X0, eig_k=(np.asarray(nj.phi),
                                          np.asarray(nj.U)), device="cpu")
    rj = jscan.build_rotated_null(nj)
    rt = scan.build_rotated_null(nt)
    # the exact tier rotates by (I - P_X0) U: the null design projected
    # out in sample space (scan.project_design)
    X = np.asarray(X0, dtype=np.float64).reshape(len(y), -1)
    W = np.asarray(rj.W)
    np.testing.assert_allclose((rt.U * rt.sd[None, :]).numpy(),
                               W - X @ np.linalg.solve(X.T @ X, X.T @ W),
                               atol=1e-10)
    np.testing.assert_allclose(rt.X0.numpy(), X, atol=0)
    for f in ("sd", "Q0", "y_res", "rss0", "dof"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=1e-10,
                                   atol=1e-10)
    # the fast tiers quantize the folded W'' = W (I - Q0 Q0^T): JAX's own
    # quantize_rotation of it (test_torch_fold.py)
    rj8 = jax_folded(rj, "int8x3")
    rt8 = scan.build_rotated_null(nt, rotate_dtype="int8x3")
    assert rt8.U is None
    np.testing.assert_array_equal(rt8.planes.numpy(), np.asarray(rj8.W))
    # exact powers of two vs XLA's CPU exp2 (see the quantize test)
    np.testing.assert_allclose(rt8.w_scale.numpy(),
                               np.asarray(rj8.w_scale), rtol=1e-13, atol=0)


@pytest.mark.parametrize("spelling", [True, "bf16", "x3", "bf16x2",
                                      "bf16x3c"])
def test_bf16_tiers_not_ported(spelling):
    """The bf16 spellings, refused before kernel K5, now normalize as the
    JAX package's do (its jnp.bfloat16 is the port's 'bf16')."""
    ref = jscan.normalize_rotate_tier(spelling)
    assert scan.normalize_rotate_tier(spelling) == (
        "bf16" if ref is jnp.bfloat16 else ref)


def test_tier_names():
    assert scan.normalize_rotate_tier(False) is None
    assert scan.normalize_rotate_tier("int8x3") == "int8x3"
    with pytest.raises(ValueError):
        scan.normalize_rotate_tier("int8x5")
    assert scan.resolve_precision("auto") == (False, "exact")
    assert scan.resolve_precision("fast") == (False, "exact")
    G = np.zeros((4, 8), dtype=np.int8)
    for p in ("auto", "fast"):
        assert scan.resolve_precision(p, G=G, device="cpu") == (False,
                                                                 "exact")
    assert scan.resolve_precision("int8x2") == ("int8x2", "int8x2")
    assert scan.resolve_precision("bf16") == (True, "bf16")
    assert scan.resolve_precision("bf16x3") == ("bf16x3", "bf16x3")
    assert scan.resolve_precision("high") == ("high", "high")
    with pytest.raises(ValueError):
        scan.resolve_precision("int8")


def test_impute_tile_matches_jax():
    from mixmogam_tpu.models.streaming import _impute_tile as j_impute
    from mixmogam_tpu_torch.models.streaming import _impute_tile

    rng = np.random.default_rng(5)
    G = rng.integers(-1, 3, (20, 33)).astype(np.int8)
    G[4] = -1                                      # an all-missing row
    ours = _impute_tile(torch.from_numpy(G), torch.float64).numpy()
    np.testing.assert_allclose(ours, np.asarray(j_impute(jnp.asarray(G),
                                                         jnp.float64)),
                               rtol=0, atol=1e-15)


_CUDA = torch.device("cuda")


def _dosages(kind):
    rng = np.random.default_rng(5)
    G = rng.integers(0, 3, (6, 10)).astype(np.int8)
    if kind == "integer":
        return G
    if kind == "integer_float":
        return G.astype(np.float64)
    if kind == "missing":
        G[2, 3] = -1
        return G
    if kind == "nan":
        Gf = G.astype(np.float64)
        Gf[1, 1] = np.nan
        return Gf
    return G * 0.97                                       # fractional


@pytest.mark.parametrize("kind, auto, fast", [
    ("integer", "int8x3", "int8x2"), ("integer_float", "int8x3", "int8x2"),
    ("missing", "exact", "bf16"), ("nan", "exact", "bf16"),
    ("fractional", "exact", "bf16"), (None, "exact", "bf16")])
def test_auto_and_fast_on_the_card(kind, auto, fast, monkeypatch):
    """The JAX package's rule with "the device is CUDA" for "on TPU", with
    the card's int8x3 entry within the gate (the gate itself: the next
    test); no card is needed to resolve a name."""
    monkeypatch.setitem(scan.TIER_P_DRIFT, "int8x3", scan.AUTO_MAX_DRIFT)
    G = None if kind is None else _dosages(kind)
    assert scan.resolve_precision("auto", G=G, device=_CUDA)[1] == auto
    assert scan.resolve_precision("fast", G=G, device=_CUDA)[1] == fast
    assert scan.resolve_precision("auto", G=G, device="cuda:0")[1] == auto


@pytest.mark.parametrize("entry, auto", [(5e-6, "int8x3"), (1e-5, "int8x3"),
                                         (2e-5, "exact")])
def test_auto_takes_int8x3_only_within_the_exact_tiers_gate(
        monkeypatch, entry, auto):
    """'auto' picks int8x3 on the card only while the card's int8x3 drift
    entry is within AUTO_MAX_DRIFT (1e-5: the exact tier's own gate on the
    card); 'fast' pairs with the rescore and does not look at it."""
    assert scan.AUTO_MAX_DRIFT == 1e-5
    monkeypatch.setitem(scan.TIER_P_DRIFT, "int8x3", entry)
    G = _dosages("integer")
    assert scan.resolve_precision("auto", G=G, device=_CUDA)[1] == auto
    assert scan.resolve_precision("fast", G=G, device=_CUDA)[1] == "int8x2"


@pytest.mark.parametrize("kind", ["integer", "integer_float", "missing",
                                  "nan", "fractional"])
def test_is_integer_dosage_is_the_jax_packages(kind):
    G = _dosages(kind)
    assert scan.is_integer_dosage(G) == jscan.is_integer_dosage(G)
    assert scan.is_integer_dosage(G.astype(np.int16) * 100) == \
        jscan.is_integer_dosage(G.astype(np.int16) * 100)


@pytest.mark.parametrize("has_missing", [False, True])
def test_probe_for_source_is_the_jax_packages(has_missing):
    class _RG:
        pass

    rg = _RG()
    rg.has_missing = has_missing
    got, ref = scan.probe_for_source(rg), jscan.probe_for_source(rg)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == ref.dtype
    G = _dosages("integer")
    assert scan.probe_for_source(None, G) is G
    assert jscan.probe_for_source(None, G) is G
