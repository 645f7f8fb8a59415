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
    return NullModel(**{k: v.to(dev) if isinstance(v, torch.Tensor) else v
                        for k, v in vars(null).items()})


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
    # the main path's launch: the kernels' Q0 (no columns for the folded
    # W''), on the operand kept with the rotated null, as prepared on the spot
    a0 = a[:4] + (rot.scan_q0,) + a[5:]
    assert torch.equal(rotate_scan_int8_packed(packed, *a0),
                       rotate_scan_int8_packed(packed, *a0,
                                               operand=scan_operand(rot)))
    pad = rotate_scan_int8_packed(rg.packed, *a)
    assert not (pad[3, m:] > 0.5).any()         # zero pad rows masked


@pytest.mark.parametrize("n,q", [(1002, 1), (130, 3), (64, 16), (77, 5)])
def test_k3_vs_plain(cuda, n, q):
    G, _, _ = simulate_genotypes(n, 700, seed=n + 1)
    rot = build_rotated_null(_null(n, q, cuda))
    Xr = torch.as_tensor(G, device=cuda).float() @ rot.U
    a = (Xr, rot.sd, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    _close(scan_stats(*a), scan_stats_plain(*a))


@pytest.mark.parametrize("q", [1, 2, 4, 8, 11, 16, 17, 20, 32, 64, 96, 128])
def test_k3_wide_q_vs_plain(cuda, q):
    """K3 takes Q0 up to 128 columns (a grown stepwise design), every width
    class of its one kernel: within the kernel tolerances of its plain
    version, identical masks, bit-equal from launch to launch; 129 columns
    raise."""
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


@pytest.mark.parametrize("q", [1, 20, 128])
def test_k3_pitches_and_row_blocks(cuda, q):
    """K3 on rows whose pitch is no multiple of 16 bytes (n = 2,042: 8-byte
    copies), on a view of n columns of wider rows, on a view that starts 4
    bytes in (4-byte copies), and over more 128-row blocks than SMs: each
    against the plain version."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n, m in ((2_042, 300), (1_000, 128 * (2 * sms + 1) + 37)):
        rot = build_rotated_null(_null(n, q if q < n else 1, cuda))
        Xr = torch.randn(m, n + 6, device=cuda)
        a = (rot.sd, rot.y_res, rot.Q0, rot.rss0, rot.dof)
        for X in (Xr[:, :n].contiguous(), Xr[:, :n], Xr[:, 3:n + 3]):
            got = scan_stats(X, *a)
            _close(got, scan_stats_plain(X, *a))
            assert torch.equal(got, scan_stats(X.contiguous(), *a))


@pytest.mark.parametrize("tier", ["int8x3", "bf16x3"])
def test_card_fast_tiers_with_20_design_columns(cuda, tier):
    """An intercept and 19 covariates at a fast tier on the card (the
    folded W'': K2 / K5 see no Q0 columns) against the card's exact tier:
    identical masks, max |dp| <= 1e-4."""
    n = 300
    G, _, _ = simulate_genotypes(n, 2_000, seed=20)
    rng = np.random.default_rng(20)
    X0 = np.column_stack([np.ones(n), rng.normal(size=(n, 19))])
    y = G[7] * 0.5 + rng.normal(size=n)
    K = np.corrcoef(G.T.astype(np.float64)) + np.eye(n) * 1e-3
    ex = emmax(G, y, K=K, X0=X0, device=cuda)
    got = emmax(G, y, K=K, X0=X0, precision=tier, device=cuda)
    assert got["dof"] == ex["dof"] == n - 21
    np.testing.assert_array_equal(got["mask"], ex["mask"])
    assert np.abs(got["ps"] - ex["ps"]).max() <= 1e-4


@pytest.mark.parametrize("tier", ["int8x2", "int8x3", "int8x4", "bf16",
                                  "bf16x2", "bf16x3"])
def test_card_tier_drift_within_its_entry(cuda, tier):
    """Each tier against the card's exact tier on a small fixture:
    identical masks, max |dp| within the tier's entry of the card's own
    drift table (ops/scan.py::TIER_P_DRIFT, chip_smoke.py phase 4)."""
    from mixmogam_tpu_torch.ops.scan import TIER_P_DRIFT

    n = 300
    G, _, _ = simulate_genotypes(n, 2_000, seed=21)
    rng = np.random.default_rng(21)
    y = G[7] * 0.5 + rng.normal(size=n)
    K = np.corrcoef(G.T.astype(np.float64)) + np.eye(n) * 1e-3
    ex = emmax(G, y, K=K, precision="exact", device=cuda)
    got = emmax(G, y, K=K, precision=tier, device=cuda)
    np.testing.assert_array_equal(got["mask"], ex["mask"])
    assert np.abs(got["ps"] - ex["ps"]).max() <= TIER_P_DRIFT[tier]


def test_card_auto_and_fast_resolve_by_the_cards_table(cuda):
    """On the card 'auto' takes int8x3 for integer dosages exactly when
    the card's int8x3 entry is within AUTO_MAX_DRIFT; 'fast' takes int8x2
    with its exact rescore; fractional dosages take exact / bf16."""
    from mixmogam_tpu_torch.ops.scan import AUTO_MAX_DRIFT, TIER_P_DRIFT

    n = 200
    G, _, _ = simulate_genotypes(n, 1_000, seed=22)
    y = G[3] * 0.5 + np.random.default_rng(22).normal(size=n)
    K = np.corrcoef(G.T.astype(np.float64)) + np.eye(n) * 1e-3
    auto = emmax(G, y, K=K, precision="auto", device=cuda)
    assert auto["precision_tier"] == (
        "int8x3" if TIER_P_DRIFT["int8x3"] <= AUTO_MAX_DRIFT else "exact")
    fast = emmax(G, y, K=K, precision="fast", device=cuda)
    assert fast["precision_tier"] == "int8x2"
    assert len(fast["rescored_idx"]) >= 1024 or len(
        fast["rescored_idx"]) == G.shape[0]
    frac = G * 0.97
    assert emmax(frac, y, K=K, precision="auto",
                 device=cuda)["precision_tier"] == "exact"
    assert emmax(frac, y, K=K, precision="fast",
                 device=cuda)["precision_tier"] == "bf16"


def test_card_world_of_one_distributed_emmax(cuda, tmp_path):
    """A world of one over NCCL (a file store): distributed_kinship equal
    to kinship_resident bit for bit, distributed_emmax at exact / int8x3 /
    bf16x3 equal to emmax_resident (masks, max |dp| <= 1e-12)."""
    import torch.distributed as dist

    from mixmogam_tpu_torch.models.resident import (emmax_resident,
                                                    kinship_resident)
    from mixmogam_tpu_torch.parallel import (distributed_emmax,
                                             distributed_kinship, make_mesh)

    n = 256
    G, _, _ = simulate_genotypes(n, 3_000, seed=23)
    y = G[11] * 0.5 + np.random.default_rng(23).normal(size=n)
    rg = ResidentGenome.from_source(G, tile=1_024, device=cuda)
    K = kinship_resident(rg)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh()
        assert mesh.backend == "nccl" and mesh.device.type == "cuda"
        np.testing.assert_array_equal(distributed_kinship(G, mesh), K)
        for tier, rb in (("exact", False), ("int8x3", "int8x3"),
                         ("bf16x3", "bf16x3")):
            got = distributed_emmax(G, y, K=K, mesh=mesh, rotate_in_bf16=rb,
                                    host_eigh=None, tile=1_024)
            ref = emmax_resident(rg, y, K=K, precision=tier)
            np.testing.assert_array_equal(got["mask"], ref["mask"])
            assert np.abs(got["ps"] - ref["ps"]).max() <= 1e-12
    finally:
        dist.destroy_process_group()


def test_card_world_of_one_resident_mesh_and_loco(cuda, tmp_path):
    """A world of one over NCCL over a host-only container
    (from_source(upload=False), no device memory taken): emmax(mesh=) at
    exact / int8x3 / bf16x3 bit-equal to emmax_resident, one shard upload
    and none on the second call; distributed_kinship bit-equal to
    kinship_resident; emmax_loco(mesh=) bit-equal to the single-device
    emmax_loco."""
    import torch.distributed as dist

    from mixmogam_tpu_torch.models.resident import (emmax_resident,
                                                    kinship_resident)
    from mixmogam_tpu_torch.parallel import distributed_kinship, make_mesh

    n = 256
    G, _, _ = simulate_genotypes(n, 3_000, seed=24)
    y = G[17] * 0.5 + np.random.default_rng(24).normal(size=n)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    host = ResidentGenome.from_source(G, tile=1_024, upload=False)
    assert torch.cuda.memory_allocated() == before and host.on_host
    rg = ResidentGenome.from_source(G, tile=1_024, device=cuda)
    K = kinship_resident(rg)
    chrom = np.repeat([1, 2, 3], [900, 1_300, 800])
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh()
        for tier in ("exact", "int8x3", "bf16x3"):
            ref = emmax_resident(rg, y, K=K, precision=tier)
            for again in (0, 1):
                u0 = ResidentGenome.uploads
                got = emmax(host, y, K=K, mesh=mesh, precision=tier)
                assert ResidentGenome.uploads - u0 == int(
                    tier == "exact" and not again)
                for k in ("ps", "mask", "f_stats", "betas"):
                    np.testing.assert_array_equal(got[k], ref[k])
        np.testing.assert_array_equal(distributed_kinship(host, mesh), K)
        got = emmax_loco(G, y, chromosomes=chrom, mesh=mesh)
        ref = emmax_loco(G, y, chromosomes=chrom)
        for k in ("ps", "mask", "f_stats", "betas"):
            np.testing.assert_array_equal(got[k], ref[k])
        assert got["loco"] == ref["loco"]
    finally:
        dist.destroy_process_group()


def test_card_world_of_one_campaign_scans(cuda, tmp_path):
    """A world of one over NCCL: emmax_step_wise(mesh=) on a host source,
    emmax_multi_trait(mesh=) (exact and int8x3 in core; exact over a
    host-only container; NaN phenotypes) and emma(mesh=) over a container,
    each bit-equal to the single-device call on the same tiles."""
    import torch.distributed as dist

    from mixmogam_tpu_torch.models.emma import emma
    from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
    from mixmogam_tpu_torch.models.resident import kinship_resident
    from mixmogam_tpu_torch.models.stepwise import emmax_step_wise
    from mixmogam_tpu_torch.parallel import make_mesh

    n = 256
    G, _, _ = simulate_genotypes(n, 3_000, seed=25)
    rng = np.random.default_rng(25)
    y = G[29] * 0.5 + rng.normal(size=n)
    Y = np.stack([y, rng.normal(size=n), G[7] * 0.3 + rng.normal(size=n)])
    Ym = Y.copy()
    Ym[1, :9] = np.nan
    host = ResidentGenome.from_source(G, tile=1_024, upload=False)
    rg = ResidentGenome.from_source(G, tile=1_024, device=cuda)
    K = kinship_resident(rg)
    keys = ("ps", "mask", "f_stats", "betas")
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh()
        got = emmax_step_wise(G, y, K=K, max_steps=3, tile=1_024, mesh=mesh)
        ref = emmax_step_wise(G, y, K=K, max_steps=3, tile=1_024)
        assert got["selected"] == ref["selected"]
        assert ([s["min_p"] for s in got["steps"]]
                == [s["min_p"] for s in ref["steps"]])
        for src, YY, tier in ((G, Y, "exact"), (G, Y, "int8x3"),
                              (host, Y, "exact"), (G, Ym, "exact"),
                              (host, Ym, "exact")):
            got = emmax_multi_trait(src, YY, K=K, precision=tier, tile=1_024,
                                    mesh=mesh)
            ref = emmax_multi_trait(rg if src is host else G, YY, K=K,
                                    precision=tier, tile=1_024)
            for k in keys:
                np.testing.assert_array_equal(got[k], ref[k])
        got = emma(host, y, K=K, mesh=mesh)
        ref = emma(rg, y, K=K)
        for k in keys:
            np.testing.assert_array_equal(got[k], ref[k])
    finally:
        dist.destroy_process_group()


def test_card_world_of_one_remaining_scans(cuda, tmp_path):
    """A world of one over NCCL: linear_model, anova and kruskal_wallis
    (over a host-only container and in core), emmax_anova's diploid test,
    emmax_perm_test (exact and int8x3 over a container, exact in core),
    emmax_gxe (exact and int8x3, E = 2) and emmax_two_snps, each mesh=
    call bit-equal to the single-device call on the same tiles."""
    import torch.distributed as dist

    from mixmogam_tpu_torch.models.gxe import emmax_gxe
    from mixmogam_tpu_torch.models.emmax import emmax_anova
    from mixmogam_tpu_torch.models.linear import (anova, kruskal_wallis,
                                                  linear_model)
    from mixmogam_tpu_torch.models.permutation import emmax_perm_test
    from mixmogam_tpu_torch.models.resident import kinship_resident
    from mixmogam_tpu_torch.models.twosnp import emmax_two_snps
    from mixmogam_tpu_torch.parallel import make_mesh

    n = 256
    G, _, _ = simulate_genotypes(n, 3_000, seed=26)
    D, _, _ = simulate_genotypes(n, 2_000, ploidy=2, missing_rate=0.02,
                                 seed=27)
    rng = np.random.default_rng(26)
    y = G[31] * 0.5 + rng.normal(size=n)
    env = np.column_stack([rng.normal(size=n), (rng.random(n) < 0.5) * 1.0])
    host = ResidentGenome.from_source(G, tile=1_024, upload=False)
    rg = ResidentGenome.from_source(G, tile=1_024, device=cuda)
    K = kinship_resident(rg)

    def same(got, ref, keys):
        for k in keys:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)

    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = make_mesh()
        for fn, keys in ((linear_model, ("ps", "f_stats", "mask", "betas")),
                         (anova, ("ps", "f_stats", "dof1", "dof2")),
                         (kruskal_wallis, ("ps", "stats"))):
            same(fn(host, y, mesh=mesh), fn(rg, y), keys)
            same(fn(G, y, mesh=mesh), fn(G, y), keys)
        same(emmax_anova(D, y, K=K, mesh=mesh), emmax_anova(D, y, K=K),
             ("ps", "f_stats", "mask", "dof1", "dof2"))
        for src, ref_src, tier in ((host, rg, "exact"), (host, rg, "int8x3"),
                                   (G, G, None)):
            same(emmax_perm_test(src, y, K=K, num_perm=16, precision=tier,
                                 mesh=mesh),
                 emmax_perm_test(ref_src, y, K=K, num_perm=16,
                                 precision=tier), ("min_ps", "threshold"))
        for tier in ("exact", "int8x3"):
            same(emmax_gxe(G, y, env, K=K, precision=tier, mesh=mesh),
                 emmax_gxe(G, y, env, K=K, precision=tier),
                 ("marginal_ps", "inter_ps", "joint_ps", "mask",
                  "mask_inter"))
        same(emmax_two_snps(host, y, K=K, focal_idx=[5, 31, 700], mesh=mesh),
             emmax_two_snps(rg, y, K=K, focal_idx=[5, 31, 700]),
             ("cond_ps", "inter_ps"))
    finally:
        dist.destroy_process_group()


_TP_RANK = r"""
import pickle, sys
import numpy as np
sys.path.insert(0, {repo!r})
import torch
import torch.distributed as dist
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.parallel import (distributed_emmax,
    distributed_emmax_resident, distributed_kinship, make_mesh)

rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method="file://" + {store!r},
                        rank=rank, world_size=2)
mesh = make_mesh((1, 2))                 # both ranks on the card
z = np.load({data!r})
G, y, K = z["G"], z["y"], z["K"]
host = ResidentGenome.from_source(G, tile=1_024, upload=False)
out = {{"K": distributed_kinship(G, mesh)}}
for tier, rb in (("exact", False), ("int8x3", "int8x3"),
                 ("bf16x3", "bf16x3")):
    out["in_" + tier] = distributed_emmax(G, y, K=K, mesh=mesh,
                                          rotate_in_bf16=rb, tile=1_024)
    out["res_" + tier] = distributed_emmax_resident(host, y, K=K, mesh=mesh,
                                                    rotate_in_bf16=rb)
if rank == 0:
    with open({out!r}, "wb") as f:
        pickle.dump(out, f)
dist.destroy_process_group()
"""


def test_card_sample_axis_on_two_gloo_ranks(cuda, tmp_path):
    """Two gloo ranks sharing the card as a (1, 2) 'sample' mesh, n = 250
    (padded to 256: a block of 128 a rank) x 3,000 rows: distributed_kinship
    bit-equal to kinship_resident; distributed_emmax and
    distributed_emmax_resident at exact / int8x3 / bf16x3 with the masks of
    emmax_resident and p within the tier's TIER_P_DRIFT entry (exact: 1e-5,
    the float32 exact tier's partial sums in other shapes)."""
    import os
    import pickle
    import subprocess
    import sys

    from mixmogam_tpu_torch.models.resident import (emmax_resident,
                                                    kinship_resident)
    from mixmogam_tpu_torch.ops.scan import TIER_P_DRIFT

    n = 250
    G, _, _ = simulate_genotypes(n, 3_000, seed=29)
    y = G[17] * 0.5 + np.random.default_rng(29).normal(size=n)
    rg = ResidentGenome.from_source(G, tile=1_024, device=cuda)
    K = kinship_resident(rg)
    data, out = str(tmp_path / "data.npz"), str(tmp_path / "out.pkl")
    np.savez(data, G=G, y=y, K=K)
    src = _TP_RANK.format(repo=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), store=str(tmp_path / "store"),
        data=data, out=out)
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), logs
    with open(out, "rb") as f:
        got = pickle.load(f)
    np.testing.assert_array_equal(got["K"], K)
    for tier in ("exact", "int8x3", "bf16x3"):
        ref = emmax_resident(rg, y, K=K, precision=tier)
        tol = 1e-5 if tier == "exact" else TIER_P_DRIFT[tier]
        for route in ("in_", "res_"):
            res = got[route + tier]
            np.testing.assert_array_equal(res["mask"], ref["mask"])
            assert np.abs(res["ps"] - ref["ps"]).max() <= tol


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
    # the main path's launch: the kernels' Q0 (no columns for the folded
    # W''), on the operand kept with the rotated null, as prepared on the spot
    a0 = a[:3] + (rot.scan_q0,) + a[4:]
    assert torch.equal(rotate_scan_bf16_packed(packed, *a0, mu),
                       rotate_scan_bf16_packed(packed, *a0, mu,
                                               operand=scan_operand(rot)))
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


@pytest.mark.parametrize("precision", ["exact", "int8x3", "bf16x3"])
def test_card_run_gwas_vanraden_delta_at_its_bound(cuda, tmp_path,
                                                   precision):
    """The input that showed a float32 fault: n = 256, seed 3, no added
    noise. VanRaden's K has a zero eigenvalue along the intercept and REML
    puts delta at exp(-10); the exact tier rotates by (I - P_X0) U and the
    fast tiers by W'' = W (I - Q0 Q0^T), so that coordinate no longer dwarfs
    the rest of each row and the float32 scan keeps every mask and p of the
    float64 path (before: one mask differed, max |dp| 0.917, about 1e-3
    elsewhere)."""
    a, b = _facade_card_and_cpu(
        tmp_path, dict(kinship_method="vanraden", precision=precision),
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


@pytest.mark.parametrize("precision,bound", [("exact", 1e-5),
                                             ("int8x3", 1e-4),
                                             ("bf16x3", 1e-4)])
def test_card_multi_trait_vs_cpu_float64(cuda, precision, bound):
    """emmax_multi_trait on the card (float32, no device=) against the
    float64 CPU path, n = 1,024, T = 4 traits, one of them with missing
    phenotypes (a second sample subset): identical masks, max |dp| within
    the tier's bound. Each tile is rotated once and K3 launched once a
    trait on it: T x tiles launches."""
    from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait
    from mixmogam_tpu_torch.oracle.kinship import ibs_kinship, scale_k

    n, m, tile = 1_024, 2_500, 1_024
    G, _, _ = simulate_genotypes(n, m, seed=12)
    rng = np.random.default_rng(12)
    Y = np.stack([G[30 * t] * 0.8 + rng.normal(size=n) for t in range(4)])
    Y[3, rng.permutation(n)[:40]] = np.nan
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    rg = ResidentGenome.from_source(G, tile=tile)
    before = scan_stats.launches
    a = emmax_multi_trait(rg, Y, K=K, precision=precision)
    assert scan_stats.launches - before == 4 * -(-m // tile)
    b = emmax_multi_trait(G, Y, K=K, precision=precision, device="cpu")
    assert np.array_equal(a["mask"], b["mask"])
    assert np.abs(a["ps"] - b["ps"]).max() <= bound
    np.testing.assert_array_equal(a["dof"], [n - 2] * 3 + [n - 42])


@pytest.mark.parametrize("q", [1, 11, 20, 128])
def test_k3_prepared_operand_is_bit_equal(cuda, q):
    """K3 on the operand prepared once per rotated null (k3_operand, kept
    with it) gives the output of the wrapper that prepares it at every
    call; another null's operand is refused."""
    from mixmogam_tpu_torch.ops.hopper_scan import k3_operand

    n = 1_002
    G, _, _ = simulate_genotypes(n, 700, seed=q)
    rot = build_rotated_null(_null(n, q, cuda))
    Xr = torch.as_tensor(G, device=cuda).float() @ rot.U
    a = (Xr, rot.sd, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    before = k3_operand.builds
    op = k3_operand(rot)
    assert k3_operand(rot) is op and k3_operand.builds == before + 1
    assert torch.equal(scan_stats(*a, operand=op), scan_stats(*a))
    other = build_rotated_null(_null(n, q, cuda, seed=1))
    with pytest.raises(ValueError, match="does not belong"):
        scan_stats(*a, operand=k3_operand(other))


def test_card_emma_vs_cpu_float64(cuda):
    """emma in float64 on the card (no device=) against the float64 CPU
    path, on one eigenbasis: identical masks, max |dp| <= 1e-8, max |d log
    delta| <= 1e-6 over the unmasked SNPs (phase 10's gates (a), (b)); a
    resident genome with missing calls and test='lrt' alike."""
    from mixmogam_tpu_torch.models.emma import emma
    from mixmogam_tpu_torch.oracle.kinship import ibs_kinship, scale_k

    n, m = 300, 1_500
    G, _, _ = simulate_genotypes(n, m, seed=14, missing_rate=0.02)
    y = G[40].clip(0) * 0.7 + np.random.default_rng(14).normal(size=n)
    K = scale_k(ibs_kinship(np.where(G < 0, 0, G).astype(np.float64)))
    w, v = np.linalg.eigh(K)
    eig = (w[::-1].copy(), v[:, ::-1].copy())
    rg = ResidentGenome.from_source(G, tile=1_024)
    for test in ("f", "lrt"):
        a = emma(rg, y, eig_k=eig, test=test)
        b = emma(G, y, eig_k=eig, test=test, device="cpu")
        assert np.array_equal(a["mask"], b["mask"])
        assert np.abs(a["ps"] - b["ps"]).max() <= 1e-8
        mk = b["mask"]
        assert np.abs(np.log(a["deltas"][mk])
                      - np.log(b["deltas"][mk])).max() <= 1e-6
        tm = a["timings_s"]         # device seconds, read from CUDA events
        assert set(tm) == {"eigh", "rotation", "grid", "refine", "f",
                           "p_values"} and min(tm.values()) >= 0.0


def test_card_class_tests_vs_cpu_float64(cuda):
    """linear_model (K3 once a tile), anova and kruskal_wallis (missing
    calls) on the card against the float64 CPU path; emmax_anova at ploidy 2
    (its all-heterozygous SNP masked) and at ploidy 1 (emmax itself)."""
    from mixmogam_tpu_torch.models.emmax import emmax_anova
    from mixmogam_tpu_torch.models.linear import (anova, kruskal_wallis,
                                                  linear_model)
    from mixmogam_tpu_torch.oracle.kinship import ibs_kinship, scale_k

    n, m = 512, 2_100
    G, _, _ = simulate_genotypes(n, m, ploidy=2, seed=15, missing_rate=0.02)
    G[0] = 1
    y = G[50].clip(0) * 0.5 + np.random.default_rng(15).normal(size=n)
    for fn in (anova, kruskal_wallis):
        a, b = fn(G, y), fn(G, y, device="cpu")
        assert np.array_equal(a["ps"] < 1, b["ps"] < 1)
        assert np.abs(a["ps"] - b["ps"]).max() <= 1e-8
    rg = ResidentGenome.from_source(G, tile=1_024)
    before = scan_stats.launches
    a = linear_model(rg, y)
    assert scan_stats.launches - before == 3
    b = linear_model(G, y, device="cpu")
    assert np.array_equal(a["mask"], b["mask"])
    assert np.abs(a["ps"] - b["ps"]).max() <= 1e-5
    K = scale_k(ibs_kinship(np.where(G < 0, 0, G).astype(np.float64),
                            ploidy=2))
    a = emmax_anova(G, y, K=K)
    b = emmax_anova(G, y, K=K, device="cpu")
    assert np.array_equal(a["mask"], b["mask"]) and not a["mask"][0]
    assert np.abs(a["ps"] - b["ps"]).max() <= 1e-5
    Gb, _, _ = simulate_genotypes(n, 1_000, seed=16)
    Kb = scale_k(ibs_kinship(Gb.astype(np.float64)))
    a = emmax_anova(Gb, y, K=Kb)
    assert np.array_equal(a["ps"], emmax(Gb, y, K=Kb, tile=4096)["ps"])


@pytest.mark.parametrize("precision,bound", [("exact", 1e-5),
                                             ("int8x3", 1e-4),
                                             ("bf16x3", 1e-4)])
def test_card_gxe_vs_cpu_float64(cuda, precision, bound):
    """emmax_gxe on the card (float32, no device=) against the float64 CPU
    path, n = 1,024, a N(0, 1) and a 0/1 environment: identical masks, max
    |dp| within the tier's bound on the three p fields, from a resident
    genome and from a host array; no scan kernel launches (the rotations
    are library products, the statistics plain torch)."""
    from mixmogam_tpu_torch.models.gxe import emmax_gxe
    from mixmogam_tpu_torch.oracle.kinship import ibs_kinship, scale_k

    n, m = 1_024, 2_500
    G, _, _ = simulate_genotypes(n, m, seed=17)
    rng = np.random.default_rng(17)
    env = np.column_stack([rng.normal(size=n), (rng.random(n) < 0.4) * 1.0])
    y = G[30] * 0.6 + G[70] * env[:, 0] + rng.normal(size=n)
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    b = emmax_gxe(G, y, env, K=K, precision=precision, device="cpu")
    kernels = (scan_stats, rotate_scan_int8_packed, rotate_scan_bf16_packed)
    before = [k.launches for k in kernels]
    for src in (ResidentGenome.from_source(G, tile=1_024), G):
        a = emmax_gxe(src, y, env, K=K, precision=precision)
        for k in ("mask", "mask_inter"):
            assert np.array_equal(a[k], b[k])
        for k in ("marginal_ps", "inter_ps", "joint_ps"):
            assert np.abs(a[k] - b[k]).max() <= bound, k
        assert int(np.argmin(a["inter_ps"][0])) == 70
        assert {"rotation", "statistics", "p_values"} <= set(a["timings_s"])
    assert [k.launches for k in kernels] == before


def test_card_gblup_vs_cpu_float64(cuda):
    """gblup, reliability() and gblup_cv in float64 on the card (no
    device=) against the CPU: within 1e-8 of their scale."""
    from mixmogam_tpu_torch.models.gblup import _joint_kinship, gblup, gblup_cv

    n, m = 800, 3_000
    G, _, _ = simulate_genotypes(n, m, seed=18)
    rng = np.random.default_rng(18)
    y = G[:200].T @ rng.normal(scale=0.1, size=200) + rng.normal(size=n)
    K = _joint_kinship(G, "ibs")
    assert np.abs(K - _joint_kinship(G, "ibs", device="cpu")).max() == 0.0
    a, b = gblup(y, K=K), gblup(y, K=K, device="cpu")
    assert a._U.device.type == "cuda"
    for got, ref in ((a.u_hat, b.u_hat), (a.reliability(), b.reliability()),
                     (gblup_cv(None, y, K_all=K)["y_hat"],
                      gblup_cv(None, y, K_all=K, device="cpu")["y_hat"])):
        assert np.abs(got - ref).max() <= 1e-8 * np.abs(ref).max()


@pytest.mark.parametrize("precision", ["exact", "int8x3", "bf16x3"])
def test_card_perm_test_vs_cpu_float64(cuda, precision):
    """emmax_perm_test on the card (float32, no device=) from a resident
    genome at each tier, and from a host array at exact, against the
    float64 CPU path: every permutation's max F within rtol 1e-4, the
    threshold within 1e-4 relative; no scan kernel launches (the products
    are library GEMMs, the max-F epilogue plain torch)."""
    from scipy.stats import f as f_dist

    from mixmogam_tpu_torch.models.permutation import emmax_perm_test
    from mixmogam_tpu_torch.oracle.kinship import ibs_kinship, scale_k

    n, m = 1_024, 2_500
    G, _, _ = simulate_genotypes(n, m, seed=19)
    y = G[40] * 0.5 + np.random.default_rng(19).normal(size=n)
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    b = emmax_perm_test(G, y, K=K, num_perm=32, device="cpu")
    kernels = (scan_stats, rotate_scan_int8_packed, rotate_scan_bf16_packed)
    before = [k.launches for k in kernels]
    srcs = [ResidentGenome.from_source(G, tile=1_024)]
    if precision == "exact":
        srcs.append(G)
    for src in srcs:
        a = emmax_perm_test(src, y, K=K, num_perm=32,
                            precision=None if src is G else precision)
        fa, fb = (f_dist.isf(r["min_ps"], 1, n - 2) for r in (a, b))
        assert np.abs(fa / fb - 1).max() <= 1e-4
        assert abs(a["threshold"] / b["threshold"] - 1) <= 1e-4
        assert {"rotation", "product", "epilogue"} <= set(a["timings_s"])
    assert [k.launches for k in kernels] == before


def test_card_two_snps_vs_cpu_float64(cuda):
    """emmax_two_snps on the card (float32, no device=) against the float64
    CPU path, n = 1,024, 4 focal SNPs, with and without the per-focal
    REML: identical masks, max |dp| <= 1e-5; K3 launches once a focal SNP a
    tile, and no other scan kernel."""
    from mixmogam_tpu_torch.models.twosnp import emmax_two_snps
    from mixmogam_tpu_torch.oracle.kinship import ibs_kinship, scale_k

    n, m, tile = 1_024, 2_500, 1_024
    G, _, _ = simulate_genotypes(n, m, seed=20)
    y = 2.0 * (G[10] * G[16]) + np.random.default_rng(20).normal(size=n)
    K = scale_k(ibs_kinship(G.astype(np.float64)))
    focal = [10, 16, 900, 2_000]
    for refit in (False, True):
        b = emmax_two_snps(G, y, K=K, focal_idx=focal, tile=tile,
                           refit_delta_per_focal=refit, device="cpu")
        for src in (ResidentGenome.from_source(G, tile=tile), G):
            before = [k.launches for k in (scan_stats,
                                           rotate_scan_int8_packed,
                                           rotate_scan_bf16_packed)]
            a = emmax_two_snps(src, y, K=K, focal_idx=focal, tile=tile,
                               refit_delta_per_focal=refit)
            assert scan_stats.launches - before[0] == 4 * -(-m // tile)
            assert rotate_scan_int8_packed.launches == before[1]
            assert rotate_scan_bf16_packed.launches == before[2]
            for k in ("cond_ps", "inter_ps"):
                assert np.array_equal(a[k] == 1.0, b[k] == 1.0)
                assert np.abs(a[k] - b[k]).max() <= 1e-5
            assert [a["cond_ps"][i, f] for i, f in enumerate(focal)] == [
                1.0] * 4
            assert int(np.argmin(a["inter_ps"][0])) == 16


def test_card_is_the_default_for_perm_and_two_snps(cuda):
    """Without device= both entry points run on the card: K3 launches for
    the two-SNP scan; the permutation test's result equals an explicit
    device='cuda' call."""
    from mixmogam_tpu_torch.models.permutation import emmax_perm_test
    from mixmogam_tpu_torch.models.twosnp import emmax_two_snps
    from mixmogam_tpu_torch.ops import resolve_device

    assert resolve_device(None).type == "cuda"
    rng = np.random.default_rng(21)
    G = rng.integers(0, 2, (600, 200)).astype(np.int8)
    y = G[5] + rng.normal(size=200)
    K = np.corrcoef(G.T.astype(np.float64)) + np.eye(200)
    a = emmax_perm_test(G, y, K=K, num_perm=8)
    c = emmax_perm_test(G, y, K=K, num_perm=8, device="cuda")
    assert np.array_equal(a["min_ps"], c["min_ps"])
    before = scan_stats.launches
    r = emmax_two_snps(G, y, K=K, focal_idx=[5, 9])
    assert scan_stats.launches == before + 2
    assert r["cond_ps"][0, 5] == 1.0


def _reml_fixture(n, seed, q=1):
    from mixmogam_tpu_torch.data.simulate import simulate_phenotype
    from mixmogam_tpu_torch.oracle.kinship import ibs_kinship, scale_k

    G, _, _ = simulate_genotypes(n, 2_000, seed=seed)
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=10, seed=seed)
    X0 = np.column_stack([np.ones(n), np.random.default_rng(seed).normal(
        size=(n, q - 1))])
    return G, y, X0, scale_k(ibs_kinship(G.astype(np.float64)))


def test_card_projected_spectrum_vs_host(cuda):
    """projected_spectrum on the card (cuSOLVER, float64, no device=)
    against host LAPACK: max |dxi| <= 1e-9 max xi, the projectors V V'
    within 1e-9."""
    from mixmogam_tpu_torch.ops.eigen import projected_spectrum

    _, _, X0, K = _reml_fixture(1_024, 30, q=3)
    a = projected_spectrum(K, X0)
    b = projected_spectrum(K, X0, host=True, device="cpu")
    assert a[0].device.type == "cuda" and a[0].dtype == torch.float64
    xa, xb = a[0].cpu(), b[0]
    assert (xa - xb).abs().max() <= 1e-9 * xb.abs().max()
    Pa = (a[1] @ a[1].T).cpu()
    assert (Pa - b[1] @ b[1].T).abs().max() <= 1e-9


@pytest.mark.parametrize("ml", [False, True])
def test_card_spectrum_vs_explicit(cuda, ml):
    """fit_null_model(method='spectrum') against 'explicit', both on the
    card in float64 (|d log delta| <= 1e-6, |d h2| <= 1e-9), and against
    the spectrum path on the CPU (1e-9)."""
    from mixmogam_tpu_torch.ops.reml import fit_null_model

    _, y, X0, K = _reml_fixture(1_024, 31, q=2)
    kw = dict(K=K, ml=ml, dtype=torch.float64)
    a = fit_null_model(y, X0, method="spectrum", **kw)
    b = fit_null_model(y, X0, method="explicit", **kw)
    c = fit_null_model(y, X0, method="spectrum", device="cpu", **kw)
    assert a.delta.device.type == "cuda" and a.ml is ml
    assert abs(float(a.log_delta) - float(b.log_delta)) <= 1e-6
    assert abs(float(a.pseudo_heritability)
               - float(b.pseudo_heritability)) <= 1e-9
    assert abs(float(a.log_delta) - float(c.log_delta)) <= 1e-9


def test_card_h2_profile_ci_vs_cpu(cuda):
    """h2_profile_ci of a null on the card against the same null's fields on
    the CPU in float64: both ends within 1e-8, REML and ML."""
    from mixmogam_tpu_torch.ops.reml import NullModel, fit_null_model
    from mixmogam_tpu_torch.ops.reml import h2_profile_ci

    _, y, X0, K = _reml_fixture(1_024, 32)
    for ml in (False, True):
        a = fit_null_model(y, X0, K=K, ml=ml, dtype=torch.float64)
        b = NullModel(**{k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                         for k, v in vars(a).items()})
        ca, cb = h2_profile_ci(a), h2_profile_ci(b)
        assert max(abs(ca[0] - cb[0]), abs(ca[1] - cb[1])) <= 1e-8


def test_card_compat_vs_cpu(cuda):
    """The class facade on the card (no device=): its REML equals
    fit_null_model on its eigenbasis; emmax_f_test on a resident genome at
    exact, int8x3 and bf16x3 equals the direct emmax on the same eig_k and
    launches the tier's kernel; get_estimates within 1e-8 relative of the
    CPU's float64; lm_step_wise selects the CPU's cofactors."""
    from mixmogam_tpu_torch.compat import LinearMixedModel, lm_step_wise
    from mixmogam_tpu_torch.ops.reml import (esp_to_refine_iters,
                                             fit_null_model)

    G, y, _, K = _reml_fixture(1_024, 33)
    lmm = LinearMixedModel(y)
    assert lmm.device.type == "cuda"
    lmm.add_random_effect(K)
    lmm.add_factor(G[7])
    r = lmm.get_expedited_REMLE()
    # the facade's esp=1e-6 is 18 bisection steps, as in emmax's null fit
    null = fit_null_model(y, lmm.X, eig_k=lmm._eig_k, dtype=torch.float64,
                          refine_iters=esp_to_refine_iters(1e-6))
    assert abs(r["log_delta"] - float(null.log_delta)) <= 1e-9
    rg = ResidentGenome.from_source(G, tile=1_024)
    for tier, k in (("exact", scan_stats),
                    ("int8x3", rotate_scan_int8_packed),
                    ("bf16x3", rotate_scan_bf16_packed)):
        before = k.launches
        a = lmm.emmax_f_test(rg, precision=tier)
        assert k.launches > before
        b = emmax(rg, y, eig_k=lmm._eig_k, X0=lmm.X, precision=tier)
        assert np.abs(a["ps"] - b["ps"]).max() <= 1e-12
    cpu = LinearMixedModel(y, device="cpu")
    cpu.add_random_effect(K)
    cpu.add_factor(G[7])
    ea, eb = lmm.get_estimates(), cpu.get_estimates()
    for key in ("betas", "beta_ses"):
        assert np.abs(ea[key] - eb[key]).max() <= 1e-8 * np.abs(
            eb[key]).max()
    sa = lm_step_wise(G, y, max_steps=3)
    sb = lm_step_wise(G, y, max_steps=3, device="cpu")
    assert [s["cofactors"] for s in sa["steps"]] == [
        s["cofactors"] for s in sb["steps"]]


# ---- the streamed scan ----------------------------------------------------

def _stream_fixture(n=512, m=2_500, missing=0.0, seed=41):
    from mixmogam_tpu_torch.data.simulate import simulate_phenotype
    from mixmogam_tpu_torch.oracle.kinship import ibs_kinship, scale_k

    G, _, _ = simulate_genotypes(n, m, ploidy=1, missing_rate=missing,
                                 seed=seed)
    y, _ = simulate_phenotype(np.where(G < 0, 0, G).astype(np.int8), h2=0.5,
                              n_causal=4, seed=seed)
    Gf = np.where(G < 0, 0, G).astype(np.float64)
    return G, y, scale_k(ibs_kinship(Gf))


@pytest.mark.parametrize("precision,missing,kname", [
    ("exact", 0.02, "scan_stats"), ("int8x3", 0.0, "rotate_scan_int8"),
    ("bf16x3", 0.02, "rotate_scan_bf16")])
def test_card_streamed_vs_resident(cuda, precision, missing, kname):
    """emmax_streamed on the card (no device=) at each tier: one launch of
    the tier's kernel a tile (K3 on the exact tier; K2 / K5 on the tile's
    packed rows), equal to the resident route at the same tier (max |dp|
    <= 1e-6, same masks); the pinned copies counted in h2d_bytes."""
    from mixmogam_tpu_torch.models.streaming import emmax_streamed

    G, y, K = _stream_fixture(missing=missing)
    k = {"scan_stats": scan_stats, "rotate_scan_int8": rotate_scan_int8_packed,
         "rotate_scan_bf16": rotate_scan_bf16_packed}[kname]
    before = k.launches
    got = emmax_streamed(G, y, K=K, tile=1_024, precision=precision)
    st = got["stream_stats"]
    assert k.launches - before == st["tiles"] == 3
    assert st["h2d_bytes"] == G.nbytes and st["busy_s"] > 0
    rg = ResidentGenome.from_source(G, tile=1_024)
    ref = emmax(rg, y, K=K, precision=precision)
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    assert np.abs(got["ps"] - ref["ps"]).max() <= 1e-6


@pytest.mark.parametrize("precision", ["exact", "bf16x3"])
def test_card_pinned_ring_reuse_gives_the_same_bits(cuda, precision):
    """inflight=1 (one pinned buffer reused by every tile) and inflight=4,
    on an int8 and a float source: the same bits."""
    from mixmogam_tpu_torch.models.streaming import emmax_streamed

    G, y, K = _stream_fixture(missing=0.02, m=4_100)
    Gf = G.astype(np.float32)
    Gf[G < 0] = np.nan
    for src in (G, Gf):
        a = emmax_streamed(src, y, K=K, tile=512, inflight=1,
                           precision=precision)
        b = emmax_streamed(src, y, K=K, tile=512, inflight=4,
                           precision=precision)
        np.testing.assert_array_equal(a["ps"], b["ps"])
        np.testing.assert_array_equal(a["betas"], b["betas"])


def test_card_kill_and_resume(cuda, tmp_path):
    """A streamed scan on the card in a subprocess, SIGKILLed once two tile
    files exist, resumes in this process equal to an uninterrupted run
    (max |dp| <= 1e-12)."""
    import glob
    import os
    import signal
    import subprocess
    import sys
    import time

    from mixmogam_tpu_torch.models.streaming import emmax_streamed

    G, y, K = _stream_fixture(m=6_000)
    ck, dpath = str(tmp_path / "ck"), str(tmp_path / "d.npz")
    np.savez(dpath, G=G, y=y, K=K)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = (
        "import sys, time\nimport numpy as np\n"
        f"sys.path.insert(0, {repo!r})\n"
        "from mixmogam_tpu_torch.models.streaming import emmax_streamed\n"
        f"z = np.load({dpath!r})\n"
        "class Slow:\n"
        "    shape, dtype = z['G'].shape, z['G'].dtype\n"
        "    def __getitem__(self, k):\n"
        "        if k.stop - k.start > 1:\n"
        "            time.sleep(0.3)\n"
        "        return z['G'][k]\n"
        f"emmax_streamed(Slow(), z['y'], K=z['K'], tile=500, "
        f"checkpoint_dir={ck!r}, inflight=1)\n")
    proc = subprocess.Popen([sys.executable, "-c", worker],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        deadline = time.time() + 120
        while len(glob.glob(os.path.join(ck, "tile_*[0-9].npz"))) < 2:
            assert proc.poll() is None and time.time() < deadline, \
                proc.communicate()
            time.sleep(0.05)
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
    resumed = emmax_streamed(G, y, K=K, tile=500, checkpoint_dir=ck)
    assert 2 <= resumed["stream_stats"]["restored"] < 12
    clean = emmax_streamed(G, y, K=K, tile=500)
    assert np.abs(resumed["ps"] - clean["ps"]).max() <= 1e-12


def test_card_packed_cache_round_trip(cuda, tmp_path):
    """from_source's cache on the card: cold packs once and writes; warm,
    trust_cache and G=None upload the cached rows, torch.equal to the
    uncached genome, packs unchanged."""
    G, _, _ = simulate_genotypes(123, 700, ploidy=2, missing_rate=0.03,
                                 seed=31)
    ref = ResidentGenome.from_source(G, tile=256)
    cp = str(tmp_path / "g.packed")
    ResidentGenome.from_source(G, tile=256, cache_path=cp)
    before = ResidentGenome.packs
    for src, kw in ((G, {}), (G, {"trust_cache": True}), (None, {})):
        rg = ResidentGenome.from_source(src, tile=256, cache_path=cp, **kw)
        assert rg.device.type == "cuda" and torch.equal(rg.packed,
                                                        ref.packed)
        assert (rg.M, rg.n, rg.ploidy, rg.has_missing) == (
            ref.M, ref.n, ref.ploidy, ref.has_missing)
    assert ResidentGenome.packs == before


def test_card_read_vcf_packed_native(cuda, tmp_path):
    """read_vcf_packed on the card through the host library equals
    from_source of the same rows."""
    from mixmogam_tpu_torch import native
    from mixmogam_tpu_torch.data.genotype import GenotypeData
    from mixmogam_tpu_torch.data.vcf import read_vcf_packed, write_vcf

    assert native.available(), native.BUILD_LOG
    G, ch, po = simulate_genotypes(77, 500, ploidy=2, missing_rate=0.02,
                                   seed=32)
    p = str(tmp_path / "g.vcf.gz")
    write_vcf(GenotypeData(G, ch, po, [f"s{i}" for i in range(77)],
                           ploidy=2), p)
    rg, meta = read_vcf_packed(p, tile=128, chunk_rows=97)
    ref = ResidentGenome.from_source(G, tile=128)
    assert rg.device.type == "cuda" and torch.equal(rg.packed, ref.packed)
    np.testing.assert_array_equal(meta["positions"], po)


def _fractional(n, m, seed):
    """Imputed dosages (g * 0.97 + 0.01 + U(-0.01, 0.01), 1 % NaN) of a
    diploid genome, a phenotype and the IBS kinship of the imputed rows."""
    from mixmogam_tpu_torch.data.simulate import simulate_phenotype
    from mixmogam_tpu_torch.oracle.kinship import ibs_kinship, scale_k

    G, _, _ = simulate_genotypes(n, m, ploidy=2, seed=seed)
    rng = np.random.default_rng(seed)
    Gf = (G * 0.97 + 0.01 + rng.uniform(-0.01, 0.01, G.shape)).astype(
        np.float32)
    Gf[rng.random(G.shape) < 0.01] = np.nan
    y, _ = simulate_phenotype(G, h2=0.5, n_causal=4, seed=seed)
    imp = np.where(np.isnan(Gf), np.nanmean(Gf, axis=1, keepdims=True), Gf)
    return G, Gf, y, scale_k(ibs_kinship(imp.astype(np.float64)))


@pytest.mark.parametrize("tier", ["bf16x3", "bf16x2", "bf16"])
def test_card_float_route_vs_cpu_float64(cuda, tier):
    """emmax on fractional dosages at a bf16 tier on the card (no device=):
    the float route, K3 once a tile and no K5, against the port's float64
    CPU path at n = 512 (identical masks, max |dp| <= 1e-5); emmax_streamed
    on the same source equal to the in-core call (max |dp| <= 1e-6)."""
    from mixmogam_tpu_torch.models.streaming import emmax_streamed

    _, Gf, y, K = _fractional(512, 3_000, 31)
    k3, k5 = scan_stats.launches, rotate_scan_bf16_packed.launches
    a = emmax(Gf, y, K=K, precision=tier, stream=False, tile=1_024)
    assert scan_stats.launches - k3 == 3
    assert rotate_scan_bf16_packed.launches == k5
    b = emmax(Gf, y, K=K, precision=tier, stream=False, device="cpu")
    np.testing.assert_array_equal(a["mask"], b["mask"])
    assert np.abs(a["ps"] - b["ps"]).max() <= 1e-5
    s = emmax_streamed(Gf, y, K=K, precision=tier, tile=1_024)
    assert s["stream_stats"]["h2d_bytes"] == Gf.nbytes
    np.testing.assert_array_equal(s["mask"], a["mask"])
    assert np.abs(s["ps"] - a["ps"]).max() <= 1e-6
    assert rotate_scan_bf16_packed.launches == k5


def test_card_loco_float_route_vs_resident(cuda):
    """LOCO's host route on the card: on integer dosages cast to float32
    its kinships (float32 matmuls) equal the resident route's (K1 / K4)
    within 1e-6; on fractional dosages emmax_loco at exact and bf16x3
    against the float64 CPU path (identical masks, max |dp| <= 1e-5), K3
    once a chromosome and no K1, K4 or K5."""
    from mixmogam_tpu_torch.models import loco

    G, Gf, y, _ = _fractional(384, 1_500, 32)
    ch = np.repeat([1, 2, 3], 500)
    ranges = loco._chrom_ranges(ch)
    host = loco._HostRows(G.astype(np.float32), None, "ibs", cuda)
    kf = loco._recombine(*host.total(ranges), ranges, host.kinship, True)
    kr = loco.loco_kinships(G, ch)
    assert max(np.abs(kf[c] - kr[c]).max() for c in kr) <= 1e-6
    for tier in ("exact", "bf16x3"):
        before = {k: k.launches for k in (scan_stats, ibs_gram_packed,
                                          ibs_gram_tri_packed,
                                          rotate_scan_bf16_packed)}
        a = emmax_loco(Gf, y, ch, precision=tier)
        assert {k: k.launches - v for k, v in before.items()} == {
            scan_stats: 3, ibs_gram_packed: 0, ibs_gram_tri_packed: 0,
            rotate_scan_bf16_packed: 0}
        b = emmax_loco(Gf, y, ch, precision=tier, device="cpu")
        np.testing.assert_array_equal(a["mask"], b["mask"])
        assert np.abs(a["ps"] - b["ps"]).max() <= 1e-5


@pytest.mark.parametrize("ploidy", [1, 2])
def test_card_train_step_vs_cpu_float64(cuda, ploidy):
    """distributed_train_step on a world of one on the card (no device=)
    against the CPU in float64, n = 300, M = 1,000 at a 256-row tile, T = 3:
    K bit-equal (binary: K1 once; diploid: the float64 gram, no K1), deltas
    within 1e-8 relative (cuSOLVER's eigh against LAPACK's), top_idx equal,
    top_f within 1e-4 relative; K3 once a trait a tile."""
    from mixmogam_tpu_torch.data.simulate import simulate_phenotype
    from mixmogam_tpu_torch.parallel import distributed_train_step

    G, _, _ = simulate_genotypes(300, 1_000, ploidy=ploidy, seed=61)
    y, _ = simulate_phenotype(G, h2=0.6, n_causal=4, seed=61)
    rng = np.random.default_rng(61)
    Y = np.stack([y, y + rng.normal(size=300), rng.normal(size=300)])
    before = {k: k.launches for k in (ibs_gram_packed, scan_stats)}
    a = distributed_train_step(None, G, Y, top_k=8, tile=256)
    assert {k: k.launches - v for k, v in before.items()} == {
        ibs_gram_packed: int(ploidy == 1), scan_stats: 3 * 4}
    b = distributed_train_step(None, G, Y, top_k=8, tile=256, device="cpu")
    np.testing.assert_array_equal(a["K"], b["K"])
    np.testing.assert_allclose(a["deltas"], b["deltas"], rtol=1e-8)
    np.testing.assert_array_equal(a["top_idx"], b["top_idx"])
    np.testing.assert_allclose(a["top_f"], b["top_f"], rtol=1e-4)
    assert a["top_f"].dtype == np.float32


def test_card_dryrun_entry_vs_cpu(cuda):
    """The tile forward step (parallel/dryrun.py::entry) on the card, an
    fp32 GEMM and K3, against its CPU run: f_stats within 1e-4."""
    from mixmogam_tpu_torch.parallel.dryrun import entry

    fn, args = entry()
    before = scan_stats.launches
    got = fn(*args).cpu().numpy()
    assert scan_stats.launches == before + 1
    fn, args = entry(device="cpu")
    np.testing.assert_allclose(got, fn(*args).numpy(), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("rows", ["int8", "imputed"])
def test_card_high_vs_cpu_float64(cuda, rows):
    """precision='high' on the card (no device=): the exact tier's route,
    each tile rotated in three bf16 passes with float32 outputs, then K3;
    against the port's float64 CPU path at n = 2,048 within the tier's
    drift entry (TIER_P_DRIFT['high'], FRACTIONAL_P_DRIFT['high'] on
    imputed rows), identical masks; TF32 still off after the call."""
    from mixmogam_tpu_torch.ops.scan import FRACTIONAL_P_DRIFT, TIER_P_DRIFT

    if rows == "int8":
        G, y, K = _stream_fixture(n=2_048, m=3_000)
        tol = TIER_P_DRIFT["high"]
    else:
        _, G, y, K = _fractional(2_048, 3_000, 33)
        tol = FRACTIONAL_P_DRIFT["high"]
    k3 = scan_stats.launches
    got = emmax(G, y, K=K, precision="high", tile=1_024)
    assert scan_stats.launches - k3 == 3
    assert got["precision_tier"] == "high"
    ref = emmax(G, y, K=K, device="cpu")
    np.testing.assert_array_equal(got["mask"], ref["mask"])
    assert np.abs(got["ps"] - ref["ps"]).max() <= tol
    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"


def test_card_high_streamed_equals_resident(cuda):
    """The streamed 'high' scan (int8 tiles, the short last one rotated at
    the tiles' height) bit-equal to emmax_resident at the same tile."""
    from mixmogam_tpu_torch.models.streaming import emmax_streamed

    G, y, K = _stream_fixture()
    rg = ResidentGenome.from_source(G, tile=1_024)
    ref = emmax(rg, y, K=K, precision="high")
    got = emmax_streamed(G, y, K=K, tile=1_024, precision="high")
    for k in ("ps", "f_stats", "betas", "mask"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("rows", ["int8", "imputed"])
def test_card_high_products_vs_plain(cuda, rows):
    """ops/rotate.py::rotate_high's library products against the plain
    version (ops/scan.py::apply_rotation_high on the same bf16 splits, in
    float64): float32 sums within n 2^-24 of sum |g u|; int8 rows skip
    the G_lo product bit-equal to the same rows as float32."""
    from mixmogam_tpu_torch.ops.rotate import rotate_high
    from mixmogam_tpu_torch.ops.scan import apply_rotation_high, split_high

    n, m = 1_000, 700
    g = torch.Generator(device="cpu").manual_seed(5)
    U = torch.linalg.qr(torch.randn(n, n, generator=g,
                                    dtype=torch.float64))[0]
    G8 = torch.randint(0, 3, (m, n), generator=g, dtype=torch.int8)
    G = (G8 if rows == "int8" else
         G8.float() * 0.97 + 0.01 + torch.rand(m, n, generator=g) * 0.02)
    parts = split_high(U.float())
    got = rotate_high(G.to(cuda), parts.to(cuda), torch.float32).cpu()
    ref = apply_rotation_high(G, parts, torch.float64)
    scale = (G.double().abs() @ U.abs()).max()
    assert float((got.double() - ref).abs().max() / scale) <= n * 2.0 ** -24
    if rows == "int8":
        assert torch.equal(got, rotate_high(G.float().to(cuda),
                                            parts.to(cuda),
                                            torch.float32).cpu())


@pytest.mark.parametrize("n", [4_096, 5_000])
def test_card_high_imputed_beta_vs_plain(cuda, n):
    """rotate_high on a tile of imputed rows (chunks of HIGH_CHUNK
    contraction samples; at n = 5,000 the last chunk is short), then the
    exact tier's mask and K3, against the plain version on the same bf16
    splits (apply_rotation_high: each product in float64, summed in
    float32; then scan_stats_plain): f within K3's limits, masks equal
    and beta within 1e-5, the gate chip_smoke.py phase 3 holds imputed
    rows to."""
    from mixmogam_tpu_torch.ops.rotate import HIGH_CHUNK, rotate_high
    from mixmogam_tpu_torch.ops.scan import (apply_rotation_high,
                                             emmax_scan_stats,
                                             outside_design)

    assert n > HIGH_CHUNK
    rot = build_rotated_null(_null(n, 1, cuda, seed=9),
                             matmul_precision="high")
    g = torch.Generator(device="cpu").manual_seed(9)
    G8 = torch.randint(0, 2, (1_500, n), generator=g, dtype=torch.int8)
    G = (G8.float() * 0.97 + 0.01
         + (torch.rand(G8.shape, generator=g) - 0.5) * 0.02).to(cuda)
    keep = outside_design(G, rot.X0, rot.X0p)
    got = emmax_scan_stats(G, rot)
    ref = torch.where(keep[None, :], scan_stats_plain(
        apply_rotation_high(G, rot.high, torch.float32), rot.sd, rot.y_res,
        rot.Q0, rot.rss0, rot.dof), 0.0)
    _close(got, ref)
    scale = apply_rotation_high(G.abs(), rot.high.abs(), torch.float64)
    err = (rotate_high(G, rot.high, torch.float32).double()
           - apply_rotation_high(G, rot.high, torch.float64)).abs() / scale
    assert float(err.max()) <= n * 2.0 ** -24
