"""PyTorch port, the 'high' tier (the JAX package's precision='high': XLA's
three-pass bf16 rotation) against the JAX package under x64 and the float64
oracle, on the CPU.

On the CPU the JAX package ignores the matmul precision and runs 'high' as
its exact tier; the port runs its plain version of the three passes
(ops/scan.py::apply_rotation_high: U' and the dosages split into bf16 hi +
lo, each product in float64 on the bf16 values). Limits: the split
bit-equal to the bf16x2 parts of the port and of the JAX package; the
rotation within 1e-12 relative of a float64 construction of the three
products; every entry point within its tier's drift entry of the JAX
call (TIER_P_DRIFT['high'], GXE_P_DRIFT['high'] for GxE,
FRACTIONAL_P_DRIFT['high'] on imputed dosages) and of the oracle, with
identical masks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mixmogam_tpu import oracle as joracle
from mixmogam_tpu.models.emmax import emmax as j_emmax
from mixmogam_tpu.ops import scan as jscan
from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                              simulate_phenotype)
from mixmogam_tpu_torch.models.emmax import emmax
from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                emmax_resident)
from mixmogam_tpu_torch.models.streaming import emmax_streamed
from mixmogam_tpu_torch.ops import scan
from mixmogam_tpu_torch.ops.rotate import (SharedRotation, rotate_tile,
                                           shared_rotation)
from mixmogam_tpu_torch.oracle.kinship import ibs_kinship, scale_k

torch.set_num_threads(1)

HIGH = scan.TIER_P_DRIFT["high"]


@pytest.fixture(scope="module")
def data():
    """Binary genotypes (n = 128, M = 400), an LMM trait, their IBS K,
    and the imputed form of the genotypes (g * 0.97 + 0.01 + U(-0.01,
    0.01), 2 % NaN: chip_smoke.py phase 17's rule)."""
    G, ch, _ = simulate_genotypes(128, 400, ploidy=1, seed=31)
    y, _ = simulate_phenotype(G, h2=0.6, n_causal=6, seed=31)
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    rng = np.random.default_rng(31)
    Gf = G * 0.97 + 0.01 + rng.uniform(-0.01, 0.01, G.shape)
    Gf[rng.random(G.shape) < 0.02] = np.nan
    return {"G": G, "y": y, "K": K, "Gf": Gf, "ch": ch}


def _close(got, ref, tol, keys=("ps",)):
    if "mask" in ref:                          # the oracle has no mask
        np.testing.assert_array_equal(got["mask"], np.asarray(ref["mask"]))
    for k in keys:
        d = np.abs(np.asarray(got[k]) - np.asarray(ref[k])).max()
        assert d <= tol, (k, d, tol)


def _oracle(G, y, K):
    return joracle.emmax_scan(np.asarray(G, np.float64), y, K)


# ---- the split and the three products ---------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_split_is_bf16x2s_parts_and_jaxs(dtype):
    """split_high is quantize_rotation's bf16x2 rule: bit-equal to its
    parts and to the JAX package's parts of the same float32 operand."""
    rng = np.random.default_rng(1)
    W = rng.normal(size=(48, 40)) * np.exp(rng.normal(size=(48, 40)) * 3)
    Wt = torch.as_tensor(W).to(dtype)
    got = scan.split_high(Wt)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 48, 40)
    assert torch.equal(got, scan.quantize_rotation(Wt, "bf16x2")[0])
    ref, _ = jscan.quantize_rotation(
        jnp.asarray(Wt.to(torch.float32).numpy()), "bf16x2")
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(ref, np.float32))
    # hi + lo holds the float32 value to 2^-16 of its magnitude
    W32 = Wt.to(torch.float32).double()
    err = (got.double().sum(0) - W32).abs() / W32.abs()
    assert float(err.max()) <= 2.0 ** -16


def _float64_three(G, U, dt):
    """The three products of the 'high' tier from float64 copies of the
    bf16 splits, summed (G_hi U_lo + G_lo U_hi) + G_hi U_hi in float64."""
    Uh, Ul = (p.double() for p in scan.split_high(U))
    Gh, Gl = (p.double() for p in scan.split_high(G))
    return ((Gh @ Ul + Gl @ Uh) + Gh @ Uh).to(dt)


@pytest.mark.parametrize("rows", ["int8", "imputed"])
def test_rotation_is_the_three_products(rows):
    """rotate_tile / apply_rotation_high at 'high' equal a float64
    construction of the three products to 1e-12 relative, and the result
    sits within 2^-15 relative of the float64 product (the bf16x3 split's
    grade), where one bf16 pass would not."""
    rng = np.random.default_rng(2)
    U = torch.as_tensor(np.linalg.qr(rng.normal(size=(96, 96)))[0])
    G = rng.integers(0, 3, (70, 96)).astype(np.int8)
    Gt = (torch.as_tensor(G) if rows == "int8" else
          torch.as_tensor(G * 0.97 + rng.uniform(-0.01, 0.01, G.shape)))
    rot = shared_rotation(U, "high", torch.float64)
    assert rot.tier == "high" and rot.W.shape == (2, 96, 96)
    got = rotate_tile(Gt, rot)
    assert torch.equal(got, scan.apply_rotation_high(Gt, rot.W,
                                                      torch.float64))
    ref = _float64_three(Gt, U, torch.float64)
    scale = (Gt.double().abs() @ U.abs()).max()
    assert float((got - ref).abs().max() / scale) <= 1e-12
    exact = Gt.double() @ U
    assert float((got - exact).abs().max() / scale) <= 2.0 ** -15
    one = scan.apply_rotation(Gt, scan.quantize_rotation(U, "bf16")[0],
                              None, torch.float64)
    assert float((one - exact).abs().max() / scale) > 2.0 ** -12


def test_integer_rows_skip_the_lo_product_bit_equal():
    """An int8 tile skips G_lo U_hi (G_lo = 0): bit-equal to the same
    rows given as floats, whose G_lo product adds exact zeros; the
    in-core route's int8 rows and float rows give the same scan."""
    rng = np.random.default_rng(3)
    U = torch.as_tensor(np.linalg.qr(rng.normal(size=(64, 64)))[0])
    parts = scan.split_high(U)
    G = torch.as_tensor(rng.integers(0, 3, (50, 64)).astype(np.int8))
    assert not scan.split_high(G)[1].any()
    for dt in (torch.float64, torch.float32):
        assert torch.equal(scan.apply_rotation_high(G, parts, dt),
                           scan.apply_rotation_high(G.to(dt), parts, dt))


def test_tf32_stays_off_around_a_high_call(data):
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    assert before == (False, "highest")
    emmax(data["G"], data["y"], K=data["K"], precision="high",
          device="cpu")
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision()) == before


def test_rotated_null_carries_the_split_of_its_projected_u(data):
    from mixmogam_tpu_torch.ops.reml import fit_null_model

    n = data["y"].shape[0]
    null = fit_null_model(data["y"], np.ones((n, 1)), K=data["K"],
                          device="cpu", dtype=torch.float64)
    ex = scan.build_rotated_null(null)
    hi = scan.build_rotated_null(null, matmul_precision="high")
    assert ex.high is None and torch.equal(hi.U, ex.U)
    assert torch.equal(hi.high, scan.split_high(ex.U))
    assert not hi.folded and hi.parts is None and hi.planes is None
    with pytest.raises(ValueError, match="matmul precision"):
        scan.build_rotated_null(null, matmul_precision="bfloat16")


# ---- every single-device entry point against the JAX package ----------

ROUTES = ["incore", "incore_float", "resident", "resident_missing",
          "streamed_int8", "streamed_float"]


def _route(name, d):
    """(port call, JAX call) of emmax at 'high' by one route."""
    G, y, K = d["G"], d["y"], d["K"]
    if name == "incore":
        return (lambda: emmax(G, y, K=K, precision="high", device="cpu"),
                lambda: j_emmax(G, y, K=K, precision="high"))
    if name == "incore_float":
        Gf = G.astype(np.float64)
        return (lambda: emmax(Gf, y, K=K, precision="high", device="cpu"),
                lambda: j_emmax(Gf, y, K=K, precision="high"))
    if name.startswith("resident"):
        from mixmogam_tpu.models.resident import ResidentGenome as JRG
        from mixmogam_tpu.models.resident import emmax_resident as jres

        Gs = G.copy()
        if name == "resident_missing":
            Gs[np.random.default_rng(4).random(G.shape) < 0.03] = -1
        rg = ResidentGenome.from_source(Gs, tile=128, device="cpu")
        return (lambda: emmax_resident(rg, y, K=K, precision="high"),
                lambda: jres(JRG.from_source(Gs, tile=128), y, K=K,
                             precision="high"))
    src = G if name == "streamed_int8" else G.astype(np.float32)
    return (lambda: emmax(src, y, K=K, precision="high", stream=True,
                          tile=128, device="cpu"),
            lambda: j_emmax(src.astype(np.float64), y, K=K,
                            precision="high"))


@pytest.mark.parametrize("route", ROUTES)
def test_emmax_routes_match_jax_and_the_oracle(data, route):
    port, jax_call = _route(route, data)
    got, ref = port(), jax_call()
    assert got["precision_tier"] == "high"
    _close(got, ref, HIGH)
    if route != "resident_missing":
        _close(got, _oracle(data["G"], data["y"], data["K"]), HIGH)


def test_streamed_equals_resident_bit_for_bit_at_one_tile(data):
    """The streamed 'high' scan (int8 tiles, the short last one rotated at
    the tiles' height) equals emmax_resident at the same tile bit for bit
    (the resident route scans 'high' at subdivide_tile(tile, 8192))."""
    rg = ResidentGenome.from_source(data["G"], tile=128, device="cpu")
    res = emmax_resident(rg, data["y"], K=data["K"], precision="high")
    st = emmax_streamed(data["G"], data["y"], K=data["K"], tile=128,
                        precision="high", device="cpu")
    for k in ("ps", "f_stats", "betas", "mask"):
        np.testing.assert_array_equal(st[k], res[k], err_msg=k)


def test_rescore_at_high_is_threshold_complete(data):
    """'high' engages the exact rescore (the JAX package's rescore_top on a
    matmul tier): every SNP under the cut of TIER_P_DRIFT['high'] and the
    top rescore_top re-tested at exact, equal to the exact call there."""
    y, K, G = data["y"], data["K"], data["G"]
    hi = emmax(G, y, K=K, precision="high", rescore_top=16, device="cpu")
    ex = emmax(G, y, K=K, device="cpu")
    idx = hi["rescored_idx"]
    assert len(idx) >= 16
    want = scan.select_rescore_idx(
        emmax(G, y, K=K, precision="high", device="cpu")["ps"], 16, "high")
    np.testing.assert_array_equal(idx, want)
    np.testing.assert_allclose(hi["ps"][idx], ex["ps"][idx], rtol=1e-12,
                               atol=0)
    ref = j_emmax(G, y, K=K, precision="high", rescore_top=16)
    _close(hi, ref, HIGH)


def test_imputed_dosages_split_and_beat_bf16x3(data):
    """On imputed dosages 'high' splits the rows too: within
    FRACTIONAL_P_DRIFT['high'] of the JAX package's exact call, and
    closer to it than bf16x3, which rounds each dosage to bf16."""
    Gf, y, K = data["Gf"], data["y"], data["K"]
    ref = j_emmax(Gf, y, K=K)
    hi = emmax(Gf, y, K=K, precision="high", device="cpu")
    b3 = emmax(Gf, y, K=K, precision="bf16x3", device="cpu")
    _close(hi, ref, scan.FRACTIONAL_P_DRIFT["high"])
    d_hi = np.abs(hi["ps"] - np.asarray(ref["ps"])).max()
    d_b3 = np.abs(b3["ps"] - np.asarray(ref["ps"])).max()
    assert d_hi < d_b3 / 10, (d_hi, d_b3)
    st = emmax(Gf.astype(np.float32), y, K=K, precision="high",
               stream=True, tile=128, device="cpu")
    _close(st, ref, scan.FRACTIONAL_P_DRIFT["high"])
    hr = emmax(Gf, y, K=K, precision="high", rescore_top=8, device="cpu")
    assert len(hr["rescored_idx"]) >= 8


def test_an_exact_checkpoint_is_not_resumed_at_high(data, tmp_path):
    """The checkpoint key carries the 'high' tier: a directory of an exact
    run restores nothing at 'high', and a second 'high' run restores all
    of its own tiles."""
    kw = dict(K=data["K"], tile=128, checkpoint_dir=str(tmp_path),
              device="cpu")
    ex = emmax_streamed(data["G"], data["y"], **kw)
    assert ex["stream_stats"]["restored"] == 0
    hi = emmax_streamed(data["G"], data["y"], precision="high", **kw)
    assert hi["stream_stats"]["restored"] == 0
    assert hi["stream_stats"]["scanned"] == hi["stream_stats"]["tiles"]
    again = emmax_streamed(data["G"], data["y"], precision="high", **kw)
    assert again["stream_stats"]["restored"] == again["stream_stats"][
        "tiles"]
    np.testing.assert_array_equal(again["ps"], hi["ps"])
    assert np.abs(hi["ps"] - ex["ps"]).max() > 0


def test_loco_matches_jax(data):
    from mixmogam_tpu.models.loco import emmax_loco as j_loco
    from mixmogam_tpu_torch.models.loco import emmax_loco

    G, y, ch = data["G"], data["y"], data["ch"]
    got = emmax_loco(G, y, chromosomes=ch, precision="high", device="cpu")
    ref = j_loco(G, y, chromosomes=ch, precision="high")
    _close(got, ref, HIGH)
    frac = np.nan_to_num(data["Gf"], nan=0.5)
    got = emmax_loco(frac, y, chromosomes=ch, precision="high",
                     device="cpu")
    ref = j_loco(frac, y, chromosomes=ch)
    _close(got, ref, scan.FRACTIONAL_P_DRIFT["high"])


@pytest.mark.parametrize("source", ["incore", "resident"])
def test_multi_trait_matches_jax_and_the_oracle(data, source):
    from mixmogam_tpu.models.multitrait import emmax_multi_trait as j_mt
    from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait

    G, K = data["G"], data["K"]
    rng = np.random.default_rng(5)
    Y = np.stack([data["y"], G[11] * 0.7 + rng.normal(size=G.shape[1])])
    src = (G if source == "incore"
           else ResidentGenome.from_source(G, tile=128, device="cpu"))
    got = emmax_multi_trait(src, Y, K=K, precision="high", device="cpu")
    ref = j_mt(G, Y, K=K, precision="high")
    assert got["precision_tier"] == "high"
    np.testing.assert_array_equal(got["mask"], np.asarray(ref["mask"]))
    assert np.abs(got["ps"] - np.asarray(ref["ps"])).max() <= HIGH
    for t in range(2):
        o = _oracle(G, Y[t], K)
        assert np.abs(got["ps"][t] - o["ps"]).max() <= HIGH


def test_gxe_matches_jax(data):
    from mixmogam_tpu.models.gxe import emmax_gxe as j_gxe
    from mixmogam_tpu_torch.models.gxe import emmax_gxe

    G, y, K = data["G"], data["y"], data["K"]
    env = np.random.default_rng(6).normal(size=G.shape[1])
    y = y + 1.2 * G[9] * env
    got = emmax_gxe(G, y, env, K=K, precision="high", device="cpu")
    ref = j_gxe(G, y, env, K=K, precision="high")
    tol = scan.GXE_P_DRIFT["high"]
    for k in ("mask", "mask_inter"):
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
    for k in ("marginal_ps", "inter_ps", "joint_ps"):
        assert np.abs(got[k] - np.asarray(ref[k])).max() <= tol, k
    ex = emmax_gxe(G, y, env, K=K, device="cpu")
    assert np.abs(got["inter_ps"] - ex["inter_ps"]).max() > 0
    # the exact rescore of the leading interactions on GXE_P_DRIFT['high']
    rs = emmax_gxe(G, y, env, K=K, precision="high", rescore_top=8,
                   device="cpu")
    idx = rs["rescored_idx"]
    assert len(idx) >= 8
    np.testing.assert_allclose(rs["inter_ps"][idx], ex["inter_ps"][idx],
                               rtol=1e-12)


def test_perm_test_matches_jax(data):
    from mixmogam_tpu.models.permutation import emmax_perm_test as j_perm
    from mixmogam_tpu.models.resident import ResidentGenome as JRG
    from mixmogam_tpu_torch.models.permutation import emmax_perm_test

    G, y, K = data["G"], data["y"], data["K"]
    rg = ResidentGenome.from_source(G, tile=128, device="cpu")
    got = emmax_perm_test(rg, y, K=K, num_perm=8, precision="high")
    ref = j_perm(JRG.from_source(G, tile=128), y, K=K, num_perm=8,
                 precision="high")
    np.testing.assert_allclose(got["min_ps"], np.asarray(ref["min_ps"]),
                               rtol=HIGH, atol=HIGH)
    assert abs(got["threshold"] - float(ref["threshold"])) <= HIGH


def test_run_gwas_and_the_cli_at_high(data, tmp_path):
    """run_gwas(..., precision='high') runs the 'high' tier: within
    TIER_P_DRIFT['high'] of the JAX package's facade and of its own exact
    call; the CLI's --precision high runs it from the same files."""
    from mixmogam_tpu import api as japi
    from mixmogam_tpu_torch import api, cli
    from mixmogam_tpu_torch.data.genotype import GenotypeData
    from mixmogam_tpu_torch.data.phenotype import PhenotypeData

    G, y = data["G"], data["y"]
    acc = [f"a{i}" for i in range(G.shape[1])]
    gd = GenotypeData(G, data["ch"], np.arange(1, G.shape[0] + 1) * 10,
                      acc, ploidy=1)
    ph = PhenotypeData()
    ph.add_phenotype(1, "trait", acc, y)
    g, p = str(tmp_path / "g.csv"), str(tmp_path / "p.csv")
    gd.write_csv(g)
    ph.write_to_file(p)
    got = api.run_gwas(g, p, plots=False, precision="high", device="cpu",
                       out_prefix=str(tmp_path / "port"), min_mac=0)
    ref = japi.run_gwas(g, p, plots=False, precision="high",
                        out_prefix=str(tmp_path / "jax"), min_mac=0)
    assert np.abs(got["scan"]["ps"]
                  - np.asarray(ref["scan"]["ps"])).max() <= HIGH
    assert got["scan"]["precision_tier"] == "high"
    ex = api.run_gwas(g, p, plots=False, device="cpu",
                      out_prefix=str(tmp_path / "exact"), min_mac=0)
    d = np.abs(got["scan"]["ps"] - ex["scan"]["ps"]).max()
    assert 0 < d <= HIGH
    assert cli.main(["run", g, p, "-o", str(tmp_path / "cli"),
                     "--no-plots", "--device", "cpu", "--min-mac", "0",
                     "--precision", "high"]) == 0


@pytest.mark.parametrize("n, chunk", [(1_000, 300), (96, 32), (50, 64)])
def test_contraction_chunks_sum_to_the_whole(n, chunk):
    """rotate_high's chunks (ops/rotate.py::contraction_chunks) cover
    [0, n) once, in order, the last one short where chunk does not divide
    n; apply_rotation_high summed over them in float64 equals the whole
    to 1e-12 of its scale."""
    from mixmogam_tpu_torch.ops.rotate import contraction_chunks

    cuts = contraction_chunks(n, chunk)
    assert cuts[0][0] == 0 and cuts[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(cuts, cuts[1:]))
    assert all(e - s == chunk for s, e in cuts[:-1])
    assert 0 < cuts[-1][1] - cuts[-1][0] <= chunk
    rng = np.random.default_rng(4)
    U = torch.as_tensor(np.linalg.qr(rng.normal(size=(n, n)))[0])
    G = torch.as_tensor(rng.integers(0, 3, (40, n)) * 0.97
                        + rng.uniform(-0.01, 0.01, (40, n)))
    parts = scan.split_high(U)
    whole = scan.apply_rotation_high(G, parts, torch.float64)
    summed = sum(scan.apply_rotation_high(G[:, s:e], parts[:, s:e],
                                          torch.float64)
                 for s, e in cuts)
    scale = float((G.abs() @ U.abs()).max())
    assert float((summed - whole).abs().max()) <= 1e-12 * scale


def test_mesh_routes_raise_the_jax_packages_value_errors(data):
    from mixmogam_tpu_torch.models.loco import emmax_loco
    from mixmogam_tpu_torch.parallel import make_mesh
    from mixmogam_tpu_torch.parallel.distributed import (
        distributed_emmax, distributed_emmax_resident)

    mesh = make_mesh(devices="cpu")
    G, y, K = data["G"], data["y"], data["K"]
    with pytest.raises(ValueError, match="not supported on the mesh path"):
        emmax(G, y, K=K, precision="high", mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="matmul_precision"):
        emmax(G, y, K=K, matmul_precision="high", mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="exact tier"):
        emmax_loco(G, y, chromosomes=data["ch"], precision="high",
                   mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="not supported on the mesh path"):
        distributed_emmax(G, y, K=K, mesh=mesh, rotate_in_bf16="high",
                          device="cpu")
    rg = ResidentGenome.from_source(G, upload=False)
    with pytest.raises(ValueError, match="not supported on the mesh path"):
        distributed_emmax_resident(rg, y, K=K, mesh=mesh,
                                   rotate_in_bf16="high", device="cpu")


@pytest.mark.parametrize("kw,match", [
    (dict(resident=True), "resident path"),
    (dict(stream=True), "streamed mode"),
    (dict(precision="high"), "either precision"),
    (dict(matmul_precision="bfloat16", precision=None), "TF32"),
])
def test_legacy_matmul_precision(data, kw, match):
    """matmul_precision='high' runs in core only, as in the JAX package;
    the resident and streamed routes and a precision= beside it raise
    the JAX package's ValueErrors; a precision that would lower the
    exact tier's float32 GEMM is refused."""
    kw = dict(dict(matmul_precision="high"), **kw)
    with pytest.raises(ValueError, match=match):
        emmax(data["G"], data["y"], K=data["K"], device="cpu", **kw)


def test_multi_trait_and_gxe_high_on_a_mesh_of_one(data):
    """Where the JAX package runs 'high' on a mesh (multi-trait, GxE, the
    permutation test), the port runs it: a world of one bit-equal to one
    device's call."""
    from mixmogam_tpu_torch.models.gxe import emmax_gxe
    from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
    from mixmogam_tpu_torch.models.permutation import emmax_perm_test
    from mixmogam_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices="cpu")
    G, y, K = data["G"], data["y"], data["K"]
    Y = np.stack([y, y[::-1].copy()])
    a = emmax_multi_trait(G, Y, K=K, precision="high", mesh=mesh)
    b = emmax_multi_trait(G, Y, K=K, precision="high", device="cpu")
    np.testing.assert_array_equal(a["ps"], b["ps"])
    env = np.random.default_rng(7).normal(size=G.shape[1])
    a = emmax_gxe(G, y, env, K=K, precision="high", mesh=mesh)
    b = emmax_gxe(G, y, env, K=K, precision="high", device="cpu")
    np.testing.assert_array_equal(a["inter_ps"], b["inter_ps"])
    rg = ResidentGenome.from_source(G, device="cpu")
    a = emmax_perm_test(rg, y, K=K, num_perm=4, precision="high", mesh=mesh)
    b = emmax_perm_test(rg, y, K=K, num_perm=4, precision="high")
    np.testing.assert_array_equal(a["min_ps"], b["min_ps"])


def test_shared_rotation_rows_keep_the_tier():
    """A 'sample' block of the 'high' rotation (ops/rotate.py::
    rotation_rows with its tier) rotates a block of columns by the three
    passes, and two blocks sum to one device's rotation."""
    from mixmogam_tpu_torch.ops.rotate import rotation_rows

    rng = np.random.default_rng(8)
    U = torch.as_tensor(np.linalg.qr(rng.normal(size=(40, 40)))[0])
    G = torch.as_tensor(rng.integers(0, 3, (9, 40)).astype(np.int8))
    whole = shared_rotation(U, "high", torch.float64)
    parts = whole.W
    a = rotation_rows(parts[:, :24], None, torch.float64, "high")
    b = rotation_rows(parts[:, 24:], None, torch.float64, "high")
    assert isinstance(a, SharedRotation) and a.tier == "high"
    got = rotate_tile(G[:, :24], a) + rotate_tile(G[:, 24:], b)
    ref = rotate_tile(G, whole)
    assert float((got - ref).abs().max()) <= 1e-12 * float(ref.abs().max())
