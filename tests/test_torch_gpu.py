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
