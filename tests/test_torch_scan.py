"""PyTorch port, scan: the plain versions of kernels K2 (int8 rotate +
scan over packed rows) and K3 (scan over pre-rotated rows) against the
Pallas kernels in interpret mode on a JAX rotated null carried over by
convert.py, and the f64 epilogue / exact-tier tile scan against JAX."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mixmogam_tpu.ops import scan as jscan
from mixmogam_tpu.ops.pallas_scan import (pallas_rotate_scan_int8,
                                          pallas_scan_stats)
from mixmogam_tpu.ops.reml import fit_null_model as j_fit
from mixmogam_tpu_torch.convert import (null_from_numpy,
                                        rotated_null_from_numpy)
from mixmogam_tpu_torch.models.resident import ResidentGenome
from mixmogam_tpu_torch.ops import scan
from mixmogam_tpu_torch.ops.hopper_scan import (
    rotate_scan_int8_packed, rotate_scan_int8_packed_plain, scan_stats,
    scan_stats_plain)

torch.set_num_threads(1)

_ROT_FIELDS = ("W", "sd", "Q0", "y_res", "rss0", "dof", "w_scale")


def _jax_null(small_dataset, kinship_small, dtype):
    y = small_dataset["y"].astype(dtype)
    return j_fit(y, np.ones((len(y), 1), dtype), K=kinship_small.astype(
        dtype))


def _carry(rot_j, dtype):
    return rotated_null_from_numpy(
        *(None if getattr(rot_j, f) is None else np.asarray(getattr(rot_j, f))
          for f in _ROT_FIELDS), dtype=dtype)


def _assert_f32_parity(ours, pal):
    """tests/test_kernels.py's f32 kernel tolerances, identical masks."""
    np.testing.assert_array_equal(ours[3].numpy() > 0.5,
                                  np.asarray(pal["mask"]))
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(pal["f_stats"]),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(pal["betas"]),
                               atol=1e-5)


@pytest.mark.parametrize("tier", ["int8x2", "int8x3"])
def test_plain_int8_packed_vs_pallas_interpret(small_dataset, kinship_small,
                                               tier):
    G = small_dataset["G_int"]
    null = _jax_null(small_dataset, kinship_small, np.float32)
    rot_j = jscan.build_rotated_null(null, rotate_dtype=tier)
    pal = pallas_rotate_scan_int8(G, rot_j, tm=128, nb=128,
                                  interpret=True)
    rot = _carry(rot_j, torch.float32)
    rg = ResidentGenome.from_source(G, tile=128, device="cpu")
    ours = rotate_scan_int8_packed_plain(
        rg.packed, rg.n, rot.planes, rot.w_scale, rot.y_res, rot.Q0,
        rot.rss0, rot.dof)[:, :rg.M]
    assert ours.dtype == torch.float32
    _assert_f32_parity(ours, pal)
    # pad rows (dosage 0) are masked
    pad = rotate_scan_int8_packed(rg.packed, rg.n, rot.planes, rot.w_scale,
                                  rot.y_res, rot.Q0, rot.rss0,
                                  rot.dof)[:, rg.M:]
    assert not (pad[3] > 0.5).any() and (pad[:3] == 0).all()


def test_plain_int8_packed_matches_jax_xla_tier_f64(small_dataset,
                                                    kinship_small):
    """In f64 the plain K2 version is the XLA int8 tier to rounding."""
    G = small_dataset["G_int"]
    null = _jax_null(small_dataset, kinship_small, np.float64)
    rot_j = jscan.build_rotated_null(null, rotate_dtype="int8x3")
    ref = jscan.emmax_scan_all(jnp.asarray(G), rot_j, tile=256)
    rot = _carry(rot_j, torch.float64)
    rg = ResidentGenome.from_source(G, tile=128, device="cpu")
    ours = rotate_scan_int8_packed_plain(
        rg.packed, rg.n, rot.planes, rot.w_scale, rot.y_res, rot.Q0,
        rot.rss0, rot.dof)[:, :rg.M]
    np.testing.assert_array_equal(ours[3].numpy() > 0.5,
                                  np.asarray(ref["mask"]))
    for i, k in enumerate(("f_stats", "betas", "var_perc")):
        np.testing.assert_allclose(ours[i].numpy(), np.asarray(ref[k]),
                                   rtol=1e-10, atol=1e-10)


def test_plain_scan_stats_vs_pallas_interpret(small_dataset,
                                              kinship_small):
    G = small_dataset["G"].astype(np.float32)
    null = _jax_null(small_dataset, kinship_small, np.float32)
    rot_j = jscan.build_rotated_null(null)
    G_rot = np.array(jnp.asarray(G) @ null.U)
    pal = pallas_scan_stats(G_rot, rot_j, tm=128, tn=128, interpret=True)
    rot = _carry(rot_j, torch.float32)
    ours = scan_stats_plain(torch.from_numpy(G_rot), rot.sd, rot.y_res,
                            rot.Q0, rot.rss0, rot.dof)
    _assert_f32_parity(ours, pal)
    wrapped = scan_stats(torch.from_numpy(G_rot), rot.sd, rot.y_res, rot.Q0,
                         rot.rss0, rot.dof)
    torch.testing.assert_close(wrapped, ours, rtol=0, atol=0)


@pytest.mark.parametrize("q", [1, 3])
def test_scan_epilogue_matches_jax_f64(q):
    rng = np.random.default_rng(q)
    n, m = 60, 40
    Xs = rng.normal(size=(m, n))
    Xs[3] = 0.0                                        # degenerate row
    Q0, _ = np.linalg.qr(rng.normal(size=(n, q)))
    Xs[5] = Q0[:, 0] * 2.0                             # inside span(Q0)
    y_res = rng.normal(size=n)
    y_res -= Q0 @ (Q0.T @ y_res)
    rss0 = float(y_res @ y_res)
    rot_j = jscan.RotatedNull(W=None, sd=jnp.ones(n), Q0=jnp.asarray(Q0),
                              y_res=jnp.asarray(y_res),
                              rss0=jnp.asarray(rss0),
                              dof=jnp.asarray(n - q - 1.0))
    ref = jscan.scan_epilogue(jnp.asarray(Xs), rot_j)
    ours = scan.scan_epilogue(torch.from_numpy(Xs), torch.from_numpy(Q0),
                              torch.from_numpy(y_res), rss0, n - q - 1.0)
    np.testing.assert_array_equal(ours[3].numpy() > 0.5,
                                  np.asarray(ref["mask"]))
    assert not ours[3, 3] and not ours[3, 5]
    for i, k in enumerate(("f_stats", "betas", "var_perc")):
        np.testing.assert_allclose(ours[i].numpy(), np.asarray(ref[k]),
                                   rtol=1e-10, atol=1e-10)


def test_exact_tile_scan_matches_jax(small_dataset, kinship_small):
    G = small_dataset["G"]
    null_j = _jax_null(small_dataset, kinship_small, np.float64)
    ref = jscan.emmax_scan_stats(jnp.asarray(G),
                                 jscan.build_rotated_null(null_j))
    null = null_from_numpy(*(np.asarray(getattr(null_j, f)) for f in (
        "phi", "U", "delta", "log_delta", "ll", "sigma_g2", "sigma_e2",
        "pseudo_heritability", "y", "X0")))
    ours = scan.emmax_scan_stats(torch.from_numpy(G),
                                 scan.build_rotated_null(null))
    np.testing.assert_array_equal(ours[3].numpy() > 0.5,
                                  np.asarray(ref["mask"]))
    for i, k in enumerate(("f_stats", "betas", "var_perc")):
        np.testing.assert_allclose(ours[i].numpy(), np.asarray(ref[k]),
                                   rtol=1e-10, atol=1e-10)


def test_scan_wrappers_refuse_other_devices():
    x = torch.zeros((4, 8), device="meta")
    v = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="device"):
        scan_stats(x, v, v, torch.zeros((8, 1), device="meta"), 1.0, 6.0)
    packed = torch.zeros((64, 2), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="device"):
        rotate_scan_int8_packed(packed, 8, torch.zeros(
            (3, 8, 8), dtype=torch.int8), v, v, v[:, None], 1.0, 6.0)


@pytest.mark.parametrize("q", [11, 17, 64, 128])
def test_plain_scan_stats_wide_q_vs_pallas_interpret(q):
    """K3 takes Q0 up to the TPU kernel's QPAD (128): its plain version at
    the widths of a grown stepwise design against pallas_scan_stats in
    interpret mode (float32, the kernel tolerances, identical masks)."""
    rng = np.random.default_rng(q)
    n, m = 150, 40
    G_rot = rng.normal(size=(m, n)).astype(np.float32)
    Q0, _ = np.linalg.qr(rng.normal(size=(n, q)))
    G_rot[7] = (Q0[:, :2] @ np.array([1.5, -2.0])).astype(np.float32)
    sd = rng.uniform(0.5, 1.5, n)
    G_rot[7] /= sd                             # inside span(Q0) once whitened
    y_res = rng.normal(size=n)
    y_res -= Q0 @ (Q0.T @ y_res)
    rss0 = float(y_res @ y_res)
    rot_j = jscan.RotatedNull(W=None, sd=jnp.asarray(sd, jnp.float32),
                              Q0=jnp.asarray(Q0, jnp.float32),
                              y_res=jnp.asarray(y_res, jnp.float32),
                              rss0=jnp.asarray(rss0, jnp.float32),
                              dof=jnp.asarray(n - q - 1.0, jnp.float32))
    pal = pallas_scan_stats(G_rot, rot_j, tm=64, tn=128, interpret=True)
    t = (lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32)))
    ours = scan_stats(t(G_rot), t(sd), t(y_res), t(Q0), rss0, n - q - 1.0)
    _assert_f32_parity(ours, pal)
    assert not ours[3, 7]


def test_k2_k5_keep_q_at_most_16():
    """At the kernel level K2 and K5 take Q0 with q <= 16 (their wgmma
    epilogue holds a row's q sums in shared slots of that width), and
    q = 0. The entry points no longer pass them Q0 columns: the design is
    folded into their W'' (ops/scan.py fold_design), so designs of up to
    128 columns reach them with q = 0. K3's wrapper takes 128 and refuses
    129."""
    from mixmogam_tpu_torch.ops import hopper_scan

    hopper_scan._check_q0("rotate_scan_int8_packed", torch.zeros(8, 16), 8)
    hopper_scan._check_q0("rotate_scan_int8_packed", torch.zeros(8, 0), 8)
    with pytest.raises(ValueError, match=r"rotate_scan_bf16_packed: Q0 must "
                                         r"be \(n, q <= 16\); got \(8, 17\)"):
        hopper_scan._check_q0("rotate_scan_bf16_packed", torch.zeros(8, 17),
                              8)
    assert hopper_scan._K3_QMAX == 128
