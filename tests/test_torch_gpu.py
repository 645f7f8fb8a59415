"""PyTorch port on the card: each CUDA kernel against its plain version
at small, ragged shapes. Marked `gpu`; skips without CUDA. This file
imports no jax, so the card's machine runs it without the JAX package's
conftest:

  python -m pytest tests/test_torch_gpu.py --noconftest -m gpu -q
"""

import numpy as np
import pytest
import torch

from mixmogam_tpu_torch.data.simulate import simulate_genotypes
from mixmogam_tpu_torch.models.emmax import emmax
from mixmogam_tpu_torch.models.loco import emmax_loco
from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                row_means_packed)
from mixmogam_tpu_torch.ops.hopper_kinship import (
    ibs_gram_packed, ibs_gram_packed_plain, ibs_gram_tri_packed,
    ibs_gram_tri_packed_plain)
from mixmogam_tpu_torch.ops.hopper_scan import (
    rotate_scan_bf16_packed, rotate_scan_bf16_packed_plain,
    rotate_scan_int8_packed, rotate_scan_int8_packed_plain, scan_operand,
    scan_stats, scan_stats_plain)
from mixmogam_tpu_torch.ops.reml import NullModel
from mixmogam_tpu_torch.ops.scan import build_rotated_null

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


def _null(n, q, dev, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    U, _ = torch.linalg.qr(torch.randn(n, n, generator=g))
    X0 = torch.cat([torch.ones(n, 1), torch.randn(n, q - 1, generator=g)],
                   dim=1)
    one = torch.ones(())
    null = NullModel(phi=torch.rand(n, generator=g).sort(
        descending=True).values, U=U, delta=one, log_delta=0 * one, ll=one,
        sigma_g2=one, sigma_e2=one, pseudo_heritability=one / 2,
        y=torch.randn(n, generator=g), X0=X0)
    return NullModel(**{k: v.to(dev) for k, v in vars(null).items()})


def _close(got, ref):
    assert torch.equal(got[3] > 0.5, ref[3] > 0.5)
    torch.testing.assert_close(got[0], ref[0], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[1], ref[1], rtol=0, atol=1e-5)


# pitches ceil(n/4): 251, 16, 65, 511, 38 and 375 bytes take the kernels' byte
# loads or (16, 256, 320) their 32-bit loads; n < one 128 x 256 tile and
# n over several; rows below one 256-row stage, ragged, and over several
_GRAM_SHAPES = [(1002, 700), (64, 64), (257, 3001), (2042, 300), (150, 100),
                (1024, 513), (1280, 1100), (300, 7), (1500, 2100)]


@pytest.mark.parametrize("n,m", _GRAM_SHAPES)
@pytest.mark.parametrize("ploidy", [1, 2])
def test_k1_bit_equal(cuda, n, m, ploidy):
    G, _, _ = simulate_genotypes(n, m, ploidy=ploidy, seed=n + m)
    rg = ResidentGenome.from_source(G, tile=512, ploidy=ploidy, device=cuda)
    before = ibs_gram_packed.launches
    S = ibs_gram_packed(rg.packed, n, m, ploidy)
    assert ibs_gram_packed.launches == before + 1
    ref = ibs_gram_packed_plain(rg.packed, n, m, ploidy)
    assert torch.equal(S, ref)
    # the byte-load path on every pitch, and K4 over all rows
    assert torch.equal(ibs_gram_packed(rg.packed, n, m, ploidy,
                                       _narrow=True), ref)
    assert torch.equal(ibs_gram_tri_packed(rg.packed, n, 0, m, ploidy), ref)


# K2 / K5 shapes (n, q, rows): n = 2,042 has a row pitch of 511 bytes (the
# producer's byte loads), 1,024 one of 256 (its 16-byte copies); n = 64 and 77
# lie below one K stage; rows 1, 127, 129 and 3,001 end inside a 256-row block
_SCAN_SHAPES = [(1002, 1, 900), (130, 3, 129), (64, 16, 127), (77, 5, 1),
                (2042, 16, 3001), (1024, 2, 700)]


def _rows(n, m, cuda, seed, missing=0.0):
    """m packed rows (no tile padding) of a simulated genome."""
    G, _, _ = simulate_genotypes(n, m, seed=seed, missing_rate=missing)
    rg = ResidentGenome.from_source(G, tile=512, device=cuda)
    return rg, rg.packed[:m]


@pytest.mark.parametrize("tier", ["int8x2", "int8x3", "int8x4"])
@pytest.mark.parametrize("n,q,m", _SCAN_SHAPES)
def test_k2_vs_plain(cuda, tier, n, q, m):
    rg, packed = _rows(n, m, cuda, n)
    rot = build_rotated_null(_null(n, q, cuda), rotate_dtype=tier)
    a = (n, rot.planes, rot.w_scale, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    before = rotate_scan_int8_packed.launches
    got = rotate_scan_int8_packed(packed, *a)
    assert rotate_scan_int8_packed.launches == before + 1
    _close(got, rotate_scan_int8_packed_plain(packed, *a))
    # the same launch again, on the operand kept with the rotated null
    assert torch.equal(got, rotate_scan_int8_packed(
        packed, *a, operand=scan_operand(rot)))
    pad = rotate_scan_int8_packed(rg.packed, *a)
    assert not (pad[3, m:] > 0.5).any()         # zero pad rows masked


@pytest.mark.parametrize("n,q", [(1002, 1), (130, 3), (64, 16), (77, 5)])
def test_k3_vs_plain(cuda, n, q):
    G, _, _ = simulate_genotypes(n, 700, seed=n + 1)
    rot = build_rotated_null(_null(n, q, cuda))
    Xr = torch.as_tensor(G, device=cuda).float() @ rot.U
    a = (Xr, rot.sd, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    _close(scan_stats(*a), scan_stats_plain(*a))


@pytest.mark.parametrize("q", [1, 11, 17, 64, 128])
def test_k3_wide_q_vs_plain(cuda, q):
    """K3 takes Q0 up to 128 columns (a grown stepwise design): within the
    kernel tolerances of its plain version, identical masks, bit-equal from
    launch to launch; 129 columns raise."""
    n = 300
    G, _, _ = simulate_genotypes(n, 1_000, seed=q)
    rot = build_rotated_null(_null(n, q, cuda))
    Xr = torch.as_tensor(G, device=cuda).float() @ rot.U
    a = (Xr, rot.sd, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    before = scan_stats.launches
    got = scan_stats(*a)
    assert scan_stats.launches == before + 1
    _close(got, scan_stats_plain(*a))
    assert torch.equal(got, scan_stats(*a))
    # one row, as stepwise re-tests a cofactor
    _close(scan_stats(Xr[5:6].contiguous(), *a[1:]),
           scan_stats_plain(Xr[5:6], *a[1:]))
    if q == 128:
        wide = torch.zeros((n, 129), device=cuda)
        with pytest.raises(ValueError, match="q <= 128"):
            scan_stats(Xr, rot.sd, rot.y_res, wide, rot.rss0, rot.dof)


def test_card_stepwise_vs_cpu_float64(cuda):
    """emmax_step_wise on the card (float32, no device=) against the float64
    CPU path: the same cofactor path and selected models, step 0's scan
    within max |dp| 1e-5 with identical masks; the stored route launches
    K3 once a forward step plus once a cofactor re-test, and the
    over-budget resident route agrees."""
    from mixmogam_tpu_torch.models.stepwise import emmax_step_wise
    from mixmogam_tpu_torch.oracle.kinship import ibs_kinship, scale_k

    G, _, _ = simulate_genotypes(400, 3_000, seed=8, missing_rate=0.01)
    rng = np.random.default_rng(8)
    Gf = np.where(G < 0, 1, G).astype(np.float64)
    y = Gf[100] + 0.7 * Gf[2_000] + rng.normal(size=400)
    K = scale_k(ibs_kinship(Gf))
    rg = ResidentGenome.from_source(G, tile=1_024)
    before = scan_stats.launches
    a = emmax_step_wise(rg, y, K=K, max_steps=3, save_scans=True)
    k3 = scan_stats.launches - before
    b = emmax_step_wise(G, y, K=K, max_steps=3, save_scans=True,
                        device="cpu")
    assert a["timings_s"]["route"] == "stored"
    retests = sum(len(s["cofactors"]) for s in a["steps"])
    assert k3 == 3 + retests
    assert [s["cofactors"] for s in a["steps"]] == [
        s["cofactors"] for s in b["steps"]]
    assert a["selected"] == b["selected"]
    pa, pb = a["steps"][0]["scan_ps"], b["steps"][0]["scan_ps"]
    assert np.array_equal(pa < 1.0, pb < 1.0)
    assert np.abs(pa - pb).max() <= 1e-5
    c = emmax_step_wise(rg, y, K=K, max_steps=3, rot_budget_bytes=1 << 20)
    assert c["timings_s"]["route"] == "resident"
    assert c["selected"] == a["selected"]


def test_card_loco_vanraden_and_missing_vs_cpu_float64(cuda):
    """LOCO with the VanRaden kinship over a genome with missing calls on
    the card (float32 kinship matmuls) against the float64 CPU path; in
    float64 on the card, K_loco equals the direct kinship over the other
    chromosomes' rows to 1e-12."""
    from mixmogam_tpu_torch.models.loco import loco_kinships
    from mixmogam_tpu_torch.models.resident import kinship_resident
    from mixmogam_tpu_torch.oracle.kinship import scale_k

    G, _, _ = simulate_genotypes(250, 2_400, ploidy=2, seed=9,
                                 missing_rate=0.02)
    ch = np.repeat([1, 2, 3], [900, 700, 800])
    y = np.where(G[11] < 0, 1, G[11]) + np.random.default_rng(9).normal(
        size=250)
    a = emmax_loco(G, y, chromosomes=ch, method="vanraden")
    b = emmax_loco(G, y, chromosomes=ch, method="vanraden", device="cpu")
    assert np.array_equal(a["mask"], b["mask"])
    assert np.abs(a["ps"] - b["ps"]).max() <= 1e-4
    rg = ResidentGenome.from_source(G)
    ks = loco_kinships(rg, ch, method="vanraden", dtype=torch.float64)
    rest = ResidentGenome.from_source(G[ch != 2])
    direct = scale_k(kinship_resident(rest, method="vanraden",
                                      dtype=torch.float64))
    assert np.abs(ks[2] - direct).max() <= 1e-12


@pytest.mark.parametrize("n,m", _GRAM_SHAPES)
@pytest.mark.parametrize("ploidy", [1, 2])
def test_k4_bit_equal(cuda, n, m, ploidy):
    G, _, _ = simulate_genotypes(n, m, ploidy=ploidy, seed=n + m + 1)
    rg = ResidentGenome.from_source(G, tile=512, ploidy=ploidy, device=cuda)
    for s, e in ((0, m), (m // 3 + 1, m - 2), (m - 1, m),
                 (0, rg.packed.shape[0])):
        before = ibs_gram_tri_packed.launches
        S = ibs_gram_tri_packed(rg.packed, n, s, e, ploidy)
        assert ibs_gram_tri_packed.launches == before + 1
        assert torch.equal(S, ibs_gram_tri_packed_plain(rg.packed, n, s, e,
                                                        ploidy))
        assert torch.equal(S, ibs_gram_packed(rg.packed[s:e], n, e - s,
                                              ploidy))
        assert torch.equal(S, ibs_gram_tri_packed(rg.packed, n, s, e, ploidy,
                                                  _narrow=True))


@pytest.mark.parametrize("tier", ["bf16", "bf16x2", "bf16x3"])
@pytest.mark.parametrize("n,q,m", _SCAN_SHAPES)
@pytest.mark.parametrize("missing", [0.0, 0.03])
def test_k5_vs_plain(cuda, tier, n, q, m, missing):
    rg, packed = _rows(n, m, cuda, n + 2, missing)
    rot = build_rotated_null(_null(n, q, cuda), rotate_dtype=tier)
    mu_all = (row_means_packed(rg.packed, n, rg.tile, torch.float32)
              if missing else None)
    mu = mu_all[:m] if missing else None
    a = (n, rot.parts, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    before = rotate_scan_bf16_packed.launches
    got = rotate_scan_bf16_packed(packed, *a, mu)
    assert rotate_scan_bf16_packed.launches == before + 1
    _close(got, rotate_scan_bf16_packed_plain(packed, *a, mu))
    # the same launch again, on the operand kept with the rotated null
    assert torch.equal(got, rotate_scan_bf16_packed(
        packed, *a, mu, operand=scan_operand(rot)))
    pad = rotate_scan_bf16_packed(rg.packed, *a, mu_all)
    assert not (pad[3, m:] > 0.5).any()         # zero pad rows masked


@pytest.mark.parametrize("n", [1002, 77, 2042, 1024])
def test_scan_kernels_on_row_views(cuda, n):
    """slice_rows hands K2 and K5 views that start at any row; each row's
    stats match those of the launch over the whole genome."""
    G, _, _ = simulate_genotypes(n, 1500, seed=n + 3)
    rg = ResidentGenome.from_source(G, tile=512, device=cuda)
    s, e = 333, 1201
    sub = rg.slice_rows(s, e)
    null = _null(n, 2, cuda)
    rot = build_rotated_null(null, rotate_dtype="bf16x3")
    a = (n, rot.parts, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    _close(rotate_scan_bf16_packed(sub.packed, *a),
           rotate_scan_bf16_packed(rg.packed, *a)[:, s:e])
    rot = build_rotated_null(null, rotate_dtype="int8x3")
    a = (n, rot.planes, rot.w_scale, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    _close(rotate_scan_int8_packed(sub.packed, *a),
           rotate_scan_int8_packed(rg.packed, *a)[:, s:e])


@pytest.mark.parametrize("n,q", [(130, 3), (1002, 1)])
def test_scan_kernels_over_more_row_blocks_than_sms(cuda, n, q):
    """The main path's grid: several 256-row blocks to an SM, the last one
    ragged; every row against the plain version, and the same bits as a
    launch over a row view of the last blocks alone."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    m = 256 * (2 * sms + 3) + 77
    rg, packed = _rows(n, m, cuda, n + 7)
    null = _null(n, q, cuda)
    rot = build_rotated_null(null, rotate_dtype="bf16x3")
    a = (n, rot.parts, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    got = rotate_scan_bf16_packed(packed, *a)
    _close(got, rotate_scan_bf16_packed_plain(packed, *a))
    s = 256 * 2 * sms
    assert torch.equal(got[:, s:], rotate_scan_bf16_packed(packed[s:], *a))
    rot = build_rotated_null(null, rotate_dtype="int8x3")
    a = (n, rot.planes, rot.w_scale, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    got = rotate_scan_int8_packed(packed, *a)
    _close(got, rotate_scan_int8_packed_plain(packed, *a))
    assert torch.equal(got[:, s:], rotate_scan_int8_packed(packed[s:], *a))


def test_wrappers_refuse_another_nulls_operand(cuda):
    n = 130
    _, packed = _rows(n, 300, cuda, 9)
    rot = build_rotated_null(_null(n, 2, cuda), rotate_dtype="int8x3")
    other = build_rotated_null(_null(n, 2, cuda, seed=1),
                               rotate_dtype="int8x3")
    with pytest.raises(ValueError, match="does not belong"):
        rotate_scan_int8_packed(packed, n, rot.planes, rot.w_scale,
                                rot.y_res, rot.Q0, rot.rss0, rot.dof,
                                operand=scan_operand(other))


@pytest.mark.parametrize("offset", [1, 4, 8])
def test_scan_kernels_on_a_base_that_is_not_16_byte_aligned(cuda, offset):
    """A 16-byte pitch (n = 1,024: 256 bytes a row) on a base address that
    is not: the kernels take their byte loads and give the aligned launch's
    bits."""
    n, m = 1024, 700
    rg, packed = _rows(n, m, cuda, 11)
    buf = torch.zeros(packed.numel() + 16, dtype=torch.uint8, device=cuda)
    base = (-buf.data_ptr()) % 16 + offset
    view = buf[base:base + packed.numel()].view(packed.shape)
    view.copy_(packed)
    assert view.is_contiguous() and view.data_ptr() % 16 == offset
    null = _null(n, 3, cuda)
    rot = build_rotated_null(null, rotate_dtype="bf16x2")
    a = (n, rot.parts, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    assert torch.equal(rotate_scan_bf16_packed(view, *a),
                       rotate_scan_bf16_packed(packed, *a))
    rot = build_rotated_null(null, rotate_dtype="int8x3")
    a = (n, rot.planes, rot.w_scale, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    assert torch.equal(rotate_scan_int8_packed(view, *a),
                       rotate_scan_int8_packed(packed, *a))


def test_scan_operand_is_built_once_on_the_main_path(cuda):
    from mixmogam_tpu_torch.models.resident import emmax_scan_packed

    n = 130
    rg, _ = _rows(n, 900, cuda, 5)
    rot = build_rotated_null(_null(n, 2, cuda), rotate_dtype="int8x3")
    before = scan_operand.builds
    a = emmax_scan_packed(rg.packed, rot, n, rg.tile)
    b = emmax_scan_packed(rg.packed, rot, n, rg.tile)
    assert scan_operand.builds == before + 1 and torch.equal(a, b)


@pytest.mark.parametrize("precision", ["exact", "bf16x3"])
def test_card_loco_vs_cpu_float64(cuda, precision):
    rng = np.random.default_rng(3)
    G = rng.integers(0, 3, (1500, 200)).astype(np.int8)
    ch = np.repeat([1, 2, 3], [600, 333, 567])
    y = G[5] + rng.normal(size=200)
    a = emmax_loco(G, y, chromosomes=ch, precision=precision, device=cuda)
    b = emmax_loco(G, y, chromosomes=ch, precision=precision, device="cpu")
    assert np.array_equal(a["mask"], b["mask"])
    assert np.abs(a["ps"] - b["ps"]).max() <= 1e-5


def test_card_emmax_vs_cpu_float64(cuda):
    from mixmogam_tpu.oracle.kinship import ibs_kinship, scale_k

    G, _, _ = simulate_genotypes(300, 2000, seed=5, missing_rate=0.01)
    Gf = G.astype(np.float64)
    Gf[G < 0] = np.nan
    K = scale_k(ibs_kinship(Gf))
    y = np.nan_to_num(Gf[10], nan=0.5) + np.random.default_rng(0).normal(
        size=300)
    a = emmax(G, y, K=K, device="cuda")
    b = emmax(G, y, K=K, device="cpu")
    assert np.array_equal(a["mask"], b["mask"])
    assert np.abs(a["ps"] - b["ps"]).max() <= 1e-5


def test_cuda_wrappers_refuse_float64(cuda):
    rot = build_rotated_null(_null(64, 1, cuda))
    Xr = torch.zeros((8, 64), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        scan_stats(Xr, rot.sd.double(), rot.y_res.double(),
                   rot.Q0.double(), rot.rss0, rot.dof)


def test_default_device_is_the_card(cuda):
    """Without device= the entry points pack, fit and scan on the card."""
    from mixmogam_tpu_torch.models.loco import loco_kinships
    from mixmogam_tpu_torch.ops import resolve_device
    from mixmogam_tpu_torch.ops.reml import fit_null_model

    assert resolve_device(None).type == "cuda"
    rng = np.random.default_rng(4)
    G = rng.integers(0, 2, (900, 130)).astype(np.int8)
    ch = np.repeat([1, 2], [500, 400])
    y = G[3] + rng.normal(size=130)
    rg = ResidentGenome.from_source(G)
    assert rg.device.type == "cuda"
    before = (ibs_gram_packed.launches, ibs_gram_tri_packed.launches,
              scan_stats.launches)
    Ks = loco_kinships(G, ch)
    res = emmax_loco(G, y, chromosomes=ch)
    assert ibs_gram_packed.launches >= before[0] + 2
    assert ibs_gram_tri_packed.launches >= before[1] + 4
    null = fit_null_model(y, np.ones((130, 1)), K=Ks[1])
    assert null.U.device.type == "cuda"
    a = emmax(G, y, K=Ks[1])
    assert scan_stats.launches > before[2]
    b = emmax(G, y, K=Ks[1], device="cpu")
    assert np.abs(a["ps"] - b["ps"]).max() <= 1e-5
    assert np.isfinite(res["ps"]).all()


# ---- the kinship module and the facade on the card ----------------------

def _float_genome(n=301, m=4_000, ploidy=2, missing=0.02, seed=0):
    G, ch, po = simulate_genotypes(n, m, ploidy=ploidy,
                                   missing_rate=missing, seed=seed)
    return G, ch, po


@pytest.mark.parametrize("method,ploidy,missing", [
    ("ibs", 1, 0.02), ("ibs", 2, 0.02), ("vanraden", 2, 0.02),
    ("vanraden", 1, 0.0)])
def test_card_float_kinships_vs_cpu_float64(cuda, method, ploidy, missing):
    """The float kinships accumulate in float32 on the card (TF32 off):
    against the float64 CPU path max |dK| <= 1e-5 (chip_smoke.py saw 2.9e-7
    for IBS and 1.2e-6 for VanRaden at n = 2,048 x 8,186 on an NVIDIA H100
    80GB HBM3 at 700.00 W), and agreement to 1e-12 when the card is asked for
    float64."""
    from mixmogam_tpu_torch.models.resident import kinship_resident
    from mixmogam_tpu_torch.ops.kinship import kinship

    G, _, _ = _float_genome(ploidy=ploidy, missing=missing)
    ref = kinship(G, method=method, ploidy=ploidy, device="cpu")
    K = kinship(G, method=method, ploidy=ploidy)          # the card, f32
    assert np.abs(K - ref).max() <= 1e-5
    K64 = kinship(G, method=method, ploidy=ploidy, dtype=torch.float64)
    assert np.abs(K64 - ref).max() <= 1e-12
    rg = ResidentGenome.from_source(G, tile=1_024, ploidy=ploidy)
    Kr, den = kinship_resident(rg, method=method, return_den=True)
    rc = ResidentGenome.from_source(G, tile=1_024, ploidy=ploidy,
                                    device="cpu")
    Kc, denc = kinship_resident(rc, method=method, return_den=True)
    assert np.abs(Kr - Kc).max() <= 1e-5
    assert abs(den - denc) <= 1e-5 * abs(denc)
    assert np.abs(kinship_resident(rg, method=method, dtype=torch.float64)
                  - Kc).max() <= 1e-12


@pytest.mark.parametrize("ploidy", [1, 2])
def test_card_integer_kinship_divides_on_the_card(cuda, ploidy):
    """Fully observed int8: K1, then the float64 division on the card,
    bit-equal to the host division of the same counts and to the CPU
    path."""
    from mixmogam_tpu_torch.models.resident import kinship_resident
    from mixmogam_tpu_torch.ops.kinship import kinship

    G, _, _ = _float_genome(m=3_001, ploidy=ploidy, missing=0.0)
    before = ibs_gram_packed.launches
    K = kinship(G, ploidy=ploidy)
    assert ibs_gram_packed.launches == before + 1
    rg = ResidentGenome.from_source(G, ploidy=ploidy)
    S = ibs_gram_packed(rg.packed, rg.n, rg.M, ploidy).cpu().numpy()
    np.testing.assert_array_equal(
        K, S.astype(np.float64) / (3_001 if ploidy == 1 else 2.0 * 3_001))
    np.testing.assert_array_equal(K, kinship(G, ploidy=ploidy,
                                             device="cpu"))
    np.testing.assert_array_equal(kinship_resident(rg), K)


def test_card_resident_from_plink_and_vcf(cuda, tmp_path):
    from mixmogam_tpu_torch.data.genotype import GenotypeData
    from mixmogam_tpu_torch.data.plink import (resident_from_plink,
                                               write_plink)
    from mixmogam_tpu_torch.data.vcf import read_vcf_packed, write_vcf

    G, ch, po = _float_genome(n=203, m=700)
    gd = GenotypeData(G, ch, po, [f"s{i}" for i in range(203)], ploidy=2)
    write_plink(str(tmp_path / "a"), gd)
    rg = resident_from_plink(str(tmp_path / "a"), tile=256)[0]
    ref = ResidentGenome.from_source(gd, tile=256)
    assert rg.device.type == "cuda" and rg.has_missing
    assert torch.equal(rg.packed, ref.packed)
    assert rg.content_key() == ref.content_key()
    write_vcf(gd, str(tmp_path / "a.vcf"))
    rv = read_vcf_packed(str(tmp_path / "a.vcf"), tile=256,
                         chunk_rows=300)[0]
    assert rv.device.type == "cuda" and torch.equal(rv.packed, ref.packed)


def _facade_card_and_cpu(tmp_path, kw, noise: bool):
    """run_gwas from the same files on the card (no device=) and on the
    float64 CPU path. noise: add unit-variance noise to the phenotype, which
    keeps delta off its lower bound."""
    from mixmogam_tpu_torch import api
    from mixmogam_tpu_torch.data.genotype import GenotypeData
    from mixmogam_tpu_torch.data.phenotype import PhenotypeData
    from mixmogam_tpu_torch.data.simulate import simulate_phenotype

    G, ch, po = _float_genome(n=256, m=3_000, ploidy=1, missing=0.0, seed=3)
    acc = [f"s{i}" for i in range(256)]
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=4, seed=3)
    if noise:
        y = y + np.random.default_rng(3).normal(size=256) * y.std()
    g, p = str(tmp_path / "g.csv"), str(tmp_path / "p.csv")
    GenotypeData(G, ch, po, acc, ploidy=1).write_csv(g)
    PhenotypeData.from_arrays(1, "t", acc, y).write_to_file(p)
    a = api.run_gwas(g, p, plots=False, out_prefix=str(tmp_path / "o"), **kw)
    b = api.run_gwas(g, p, plots=False, device="cpu", **kw)
    return a, b


@pytest.mark.parametrize("kw", [
    dict(), dict(precision="int8x3"), dict(method="emmax_loco"),
    dict(kinship_method="vanraden")])
def test_card_run_gwas_vs_cpu_float64(cuda, tmp_path, kw):
    """The facade from files: no device= runs on the card; against the
    same call on the float64 CPU path max |dp| <= 1e-4 (int8x3 and the
    float32 VanRaden kinship) or 1e-5 (exact, as the direct calls above).
    The phenotype carries noise that keeps delta off its lower bound: the
    case at the bound is the test below."""
    k3 = scan_stats.launches
    a, b = _facade_card_and_cpu(tmp_path, kw, noise=True)
    assert kw.get("precision") or scan_stats.launches > k3
    limit = 1e-5 if kw in (dict(), dict(method="emmax_loco")) else 1e-4
    assert np.abs(a["scan"]["ps"] - b["scan"]["ps"]).max() <= limit
    np.testing.assert_array_equal(a["scan"]["mask"], b["scan"]["mask"])
    assert a["genotype"].accessions == b["genotype"].accessions


def test_card_run_gwas_vanraden_delta_at_its_bound(cuda, tmp_path):
    """The input that showed a float32 fault: n = 256, seed 3, no added
    noise. VanRaden's K has a zero eigenvalue along the intercept and REML
    puts delta at exp(-10); the exact tier rotates by (I - P_X0) U, so that
    coordinate no longer dwarfs the rest of each row and the float32 scan
    keeps every mask and p of the float64 path (before: one mask differed,
    max |dp| 0.917, 1.363e-3 elsewhere)."""
    a, b = _facade_card_and_cpu(tmp_path, dict(kinship_method="vanraden"),
                                noise=False)
    assert a["scan"]["delta"] < 1e-4
    same = a["scan"]["mask"] == b["scan"]["mask"]
    dp = np.abs(a["scan"]["ps"] - b["scan"]["ps"])
    assert same.all() and dp.max() <= 1e-4, (
        f"delta {a['scan']['delta']:.3e}: {int((~same).sum())} mask(s) differ "
        f"(rows {np.flatnonzero(~same).tolist()}, max|dp| {dp.max():.3e}); "
        f"max|dp| {dp[same].max():.3e} where the masks agree")


def test_card_cached_eigen_default_is_the_card(cuda, tmp_path, monkeypatch):
    """cached_eigen without device= factors on the card (float64 cuSOLVER)
    and agrees with host LAPACK on request."""
    from mixmogam_tpu_torch.ops import eigen
    from mixmogam_tpu_torch.utils.caching import cached_eigen

    rng = np.random.default_rng(0)
    A = rng.normal(size=(300, 300))
    K = A @ A.T / 300
    seen = []
    factor = eigen.eigen_k_on
    monkeypatch.setattr(eigen, "eigen_k_on", lambda K_, device: (
        seen.append(torch.device(device).type), factor(K_, device))[1])
    phi, U = cached_eigen(K, cache_dir=str(tmp_path / "card"))
    assert seen == ["cuda"] and U.dtype == np.float64
    np.testing.assert_allclose((U * phi) @ U.T, K, atol=1e-12)
    phic, _ = cached_eigen(K, cache_dir=str(tmp_path / "cpu"), device="cpu")
    assert seen == ["cuda", "cpu"]
    np.testing.assert_allclose(phi, phic, atol=1e-12)
    # a hit factors nothing
    cached_eigen(K, cache_dir=str(tmp_path / "card"))
    assert seen == ["cuda", "cpu"]
