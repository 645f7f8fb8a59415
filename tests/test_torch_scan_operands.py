"""PyTorch port, the prepared W operand of kernels K2 and K5 (CPU): the stage
images undo to the transposed planes / parts bit for bit with zero padding;
a NumPy walk over the images and the raw packed bytes, in the order the
kernels' threads read them, gives the plain product exactly; the operand is
built once per RotatedNull; and the wrappers on CPU tensors (no operand)
still match the JAX package under x64."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mixmogam_tpu.ops import scan as jscan
from mixmogam_tpu.ops.reml import fit_null_model as j_fit
from mixmogam_tpu_torch.convert import rotated_null_from_numpy
from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                emmax_scan_packed)
from mixmogam_tpu_torch.ops import hopper_scan as hs
from mixmogam_tpu_torch.ops.pack2 import unpack_2bit_device
from mixmogam_tpu_torch.ops.scan import quantize_rotation

torch.set_num_threads(1)

_NS = [64, 77, 130, 1002, 2042]
_TIERS = ["int8x2", "int8x3", "int8x4", "bf16", "bf16x2", "bf16x3"]
_ROT_FIELDS = ("W", "sd", "Q0", "y_res", "rss0", "dof", "w_scale")


def _operand(n, tier, seed=0, q=2):
    rng = np.random.default_rng(seed + n)
    W = torch.from_numpy(rng.normal(size=(n, n)).astype(np.float32))
    y_res = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    Q0 = torch.from_numpy(rng.normal(size=(n, q)).astype(np.float32))
    Wq, w_scale = quantize_rotation(W, tier)
    if tier.startswith("int8"):
        return Wq, hs.prepare_int8_operand(Wq, w_scale, y_res, Q0), (
            w_scale, y_res, Q0)
    return Wq, hs.prepare_bf16_operand(Wq, y_res, Q0), (None, y_res, Q0)


@pytest.mark.parametrize("tier", _TIERS)
@pytest.mark.parametrize("n", _NS)
def test_operand_undoes_to_transposed_w(n, tier):
    Wq, op, (w_scale, y_res, Q0) = _operand(n, tier)
    K = Wq.shape[0]
    cn, ks = (192 // K, 128) if tier.startswith("int8") else (64, 64)
    assert (op.cn, op.ks, op.K, op.n) == (cn, ks, K, n)
    assert op.n_steps == -(-n // cn) and op.n_stages == -(-n // ks)
    dense = hs.operand_dense(op)
    assert dense.shape == (K, op.n_steps * cn, op.n_stages * ks)
    assert dense.dtype == Wq.dtype and op.w_img.is_contiguous()
    view = torch.int8 if Wq.dtype == torch.int8 else torch.int16
    assert torch.equal(dense[:, :n, :n].contiguous().view(view),
                       Wq.transpose(1, 2).contiguous().view(view))
    pad = dense.clone()
    pad[:, :n, :n] = 0
    assert not pad.view(view).any()
    # the column vectors: padded with zeros to the step, Q0 transposed
    npad = op.n_steps * cn
    assert op.y_res.shape == (npad,) and op.q0t.shape == (Q0.shape[1], npad)
    assert torch.equal(op.y_res[:n], y_res) and not op.y_res[n:].any()
    assert torch.equal(op.q0t[:, :n], Q0.t()) and not op.q0t[:, n:].any()
    if w_scale is None:
        assert op.w_scale is None
    else:
        assert torch.equal(op.w_scale[:n], w_scale)
        assert not op.w_scale[n:].any()


def _walk_stage_images(op, packed):
    """G @ W_p for every plane / part p, (K, rows, steps * cn) float64,
    gathered the way the kernels do: a thread (quad lane t) reads bytes
    8t..8t+7 (K2) or 4t..4t+3 (K5) of a row's stage bytes; byte 2 ks + h
    (K2: samples 16 h + 4 t + i of k-step ks) or byte ks (K5: samples
    {2t, 2t+1, 2t+8, 2t+9}[i]) holds codes i = 0..3; the B operand's entry
    for logical sample L of the stage is core-matrix chunk L // kb, byte
    (element) L % kb of the image."""
    rows = packed.shape[0]
    gb = op.ks // 4
    raw = np.zeros((rows, op.n_stages * gb), np.uint8)
    raw[:, :packed.shape[1]] = packed.numpy()
    codes = (raw[:, :, None] >> (2 * np.arange(4))) & 3     # (rows, bytes, 4)
    vals = np.where(codes == 3, 0, codes).astype(np.float64)
    img = op.w_img.to(torch.float64).numpy()
    out = np.zeros((op.K, rows, op.n_steps * op.cn))
    for st in range(op.n_stages):
        A = np.zeros((rows, op.ks))
        for t in range(4):
            for ks in range(4):
                if op.kind == "int8":
                    for h in range(2):
                        b = st * gb + 8 * t + 2 * ks + h
                        A[:, 32 * ks + 16 * h + 4 * t + np.arange(4)] = \
                            vals[:, b]
                else:
                    b = st * gb + 4 * t + ks
                    A[:, 16 * ks + np.array([2 * t, 2 * t + 1, 2 * t + 8,
                                             2 * t + 9])] = vals[:, b]
        for js in range(op.n_steps):
            for p in range(op.K):
                if op.kind == "int8":        # (kc, K, cn, kb) -> (L, cn)
                    B = img[js, st, :, p].transpose(0, 2, 1)
                else:                        # (K, kc, cn, kb) -> (L, cn)
                    B = img[js, st, p].transpose(0, 2, 1)
                out[p, :, js * op.cn:(js + 1) * op.cn] += \
                    A @ B.reshape(op.ks, op.cn)
    return out


@pytest.mark.parametrize("tier", _TIERS)
@pytest.mark.parametrize("n", [64, 77, 130, 301])
def test_stage_walk_gives_the_plain_product(n, tier):
    Wq, op, _ = _operand(n, tier, seed=1)
    rng = np.random.default_rng(n)
    G = rng.integers(0, 3, (37, n)).astype(np.int8)
    rg = ResidentGenome.from_source(G, tile=64, device="cpu")
    got = _walk_stage_images(op, rg.packed)
    Gd = unpack_2bit_device(rg.packed, n).to(torch.float64).numpy()
    for p in range(op.K):
        ref = Gd @ Wq[p].to(torch.float64).numpy()
        np.testing.assert_array_equal(got[p][:, :n], ref)   # exact products
        assert not got[p][:, n:].any()


def _rot(tier, seed, n=70):
    rng = np.random.default_rng(seed)
    G = rng.integers(0, 3, (200, n)).astype(np.int8)
    y = G[3] * 0.8 + rng.normal(size=n)
    K = np.corrcoef(G.T.astype(np.float64)) + np.eye(n)
    null = j_fit(y, np.ones((n, 1)), K=K)
    rot_j = jscan.build_rotated_null(
        null, rotate_dtype=jscan.normalize_rotate_tier(tier))
    rot = rotated_null_from_numpy(
        *(None if getattr(rot_j, f) is None else np.asarray(getattr(rot_j, f))
          for f in _ROT_FIELDS), dtype=torch.float64)
    return G, rot_j, rot


@pytest.mark.parametrize("tier", ["int8x3", "bf16x3", "bf16"])
def test_operand_built_once_per_rotated_null(tier):
    _, _, rot = _rot(tier, 0)
    _, _, other = _rot(tier, 1)
    assert rot.operand is None
    before = hs.scan_operand.builds
    op = hs.scan_operand(rot)
    assert hs.scan_operand.builds == before + 1 and rot.operand is op
    assert hs.scan_operand(rot) is op                  # kept, not rebuilt
    assert hs.scan_operand.builds == before + 1
    op2 = hs.scan_operand(other)                       # another null: again
    assert hs.scan_operand.builds == before + 2 and op2 is not op
    assert op.kind == tier[:4] and op.K == (1 if tier == "bf16" else 3)
    W = rot.planes if rot.planes is not None else rot.parts
    assert torch.equal(hs.operand_dense(op)[:, :70, :70].float(),
                       W.transpose(1, 2).float())


def test_exact_tier_has_no_operand():
    _, _, rot = _rot(None, 2)
    assert hs.scan_operand(rot) is None and rot.operand is None


@pytest.mark.parametrize("tier", ["int8x2", "int8x3", "bf16", "bf16x3"])
def test_cpu_scan_prepares_nothing_and_matches_jax(tier):
    """On CPU tensors the wrappers take their plain versions: no operand is
    built, and the stats equal the JAX package's apply_rotation +
    scan_epilogue under x64 (rtol 1e-9: float64 summation order only)."""
    G, rot_j, rot = _rot(tier, 3)
    ref = jscan.emmax_scan_all(jnp.asarray(G), rot_j, tile=256)
    rg = ResidentGenome.from_source(G, tile=64, device="cpu")
    before = hs.scan_operand.builds
    ours = emmax_scan_packed(rg.packed, rot, rg.n, rg.tile)[:, :rg.M]
    assert hs.scan_operand.builds == before and rot.operand is None
    np.testing.assert_array_equal(ours[3].numpy() > 0.5,
                                  np.asarray(ref["mask"]))
    for i, k in enumerate(("f_stats", "betas", "var_perc")):
        np.testing.assert_allclose(ours[i].numpy(), np.asarray(ref[k]),
                                   rtol=1e-9, atol=1e-12)


def test_wrappers_refuse_a_foreign_operand():
    """The kernels read W, y_res, Q0 and w_scale from the operand: one
    built from other tensors, of the same shape too, is refused."""
    Wq, op, (w_scale, y_res, Q0) = _operand(64, "int8x3")
    Wo, other, (ws_o, y_o, Q0_o) = _operand(64, "int8x3", seed=5)
    with pytest.raises(ValueError, match="does not belong"):
        hs._check_operand("k2", other, "int8", Wq, y_res, Q0, w_scale)
    with pytest.raises(ValueError, match="does not belong"):
        hs._check_operand("k2", op, "int8", Wq, y_o, Q0, w_scale)
    with pytest.raises(ValueError, match="does not belong"):
        hs._check_operand("k2", op, "int8", Wq, y_res, Q0, ws_o)
    with pytest.raises(ValueError, match="does not belong"):
        hs._check_operand("k5", op, "bf16", Wq, y_res, Q0)
    hs._check_operand("k2", op, "int8", Wq, y_res, Q0, w_scale)
    y_res += 1.0                                  # written to since
    with pytest.raises(ValueError, match="does not belong"):
        hs._check_operand("k2", op, "int8", Wq, y_res, Q0, w_scale)


@pytest.mark.parametrize("tier", ["int8x3", "bf16x2"])
def test_operand_is_rebuilt_when_the_rotated_null_changes(tier):
    _, _, rot = _rot(tier, 4)
    op = hs.scan_operand(rot)
    before = hs.scan_operand.builds
    if rot.planes is not None:
        rot.planes = rot.planes.clone()
    else:
        rot.parts = rot.parts.clone()
    op2 = hs.scan_operand(rot)
    assert op2 is not op and hs.scan_operand.builds == before + 1
    assert torch.equal(op2.w_img, op.w_img)
    rot.y_res.mul_(2.0)                           # in place
    op3 = hs.scan_operand(rot)
    assert hs.scan_operand.builds == before + 2
    assert torch.equal(op3.y_res, 2.0 * op2.y_res)
    assert hs.scan_operand(rot) is op3            # unchanged: kept
