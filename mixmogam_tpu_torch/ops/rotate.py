"""The library rotation products of float and int8 dosage rows, shared by
every scan that rotates a tile once outside the Pallas kernels' ports:
multi-trait (models/multitrait.py), GxE, the permutation test, the two-SNP
scan, and the bf16 tiers on fractional dosages in emmax, the streamed scan
and LOCO (the float route).

The JAX package computes these products in XLA, outside any Pallas kernel
(mixmogam_tpu/ops/scan.py::apply_rotation); here they are library
products, by tier:
- 'exact': G @ U', a float32 GEMM with TF32 off;
- 'int8x2/3/4': the digit planes of U' (ops/scan.py::quantize_rotation),
  one int8 GEMM with int32 sums a plane on the int8 tile, recombined in
  base 256 in the compute dtype in the JAX package's order;
- 'bf16' / 'bf16x2' / 'bf16x3': the split parts of U', one bf16 GEMM a
  part with a float32 output, summed in float32;
- 'high' (rotate_high): the three-pass bf16 split of XLA's Precision.HIGH,
  U' and the tile each split into bf16 hi + lo (ops/scan.py::split_high),
  three bf16 GEMMs with float32 outputs, summed in float32 (float rows:
  one GEMM a chunk of HIGH_CHUNK contraction samples a pass).
On the CPU every tier takes ops/scan.py::apply_rotation (exact float64
products of the digit planes and parts; apply_rotation_high for 'high').

The float route (float_rotation, scan_float_rows): fractional dosages at a
bf16 tier. Kernel K5 reads packed 2-bit rows, which hold integer dosages
only, so a tile of mean-imputed float rows is cast to bf16 (round to
nearest even, as the JAX package's G.astype(bf16)), rotated by the bf16
parts of the exact tier's projected U' = (I - P_X0) U, and kernel K3
whitens the rotated rows by the null's sd and runs the GLS epilogue; the
rows inside col(X0) are masked (ops/scan.py::outside_design).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

#: torch._int_mm takes more than 16 rows, and a contraction and an output
#: width that are multiples of 8
_INT_MM_ROWS, _INT_MM_ALIGN = 17, 8
#: contraction samples a bf16 product of rotate_high sums on the tensor
#: cores before its sum leaves them (float rows)
HIGH_CHUNK = 2_048


@dataclasses.dataclass
class SharedRotation:
    """A rotation on the scan's device: U' in the compute dtype ('exact'),
    its int8 digit planes with their column scale ('int8xK') or its bf16
    parts ('bf16', 'bf16xK'). On the card the int8 planes are kept
    transposed and zero-padded to a multiple of 8, (K, n8, n8), so that
    each plane is a column-major operand."""

    tier: Optional[str]          # None: exact; 'high': W its (2, n, n) split
    W: torch.Tensor              # U' (n, n), planes or parts (K, n, n)
    w_scale: Optional[torch.Tensor]
    dt: torch.dtype
    planes_t: Optional[torch.Tensor] = None   # int8 tiers on the card
    w_scale_pad: Optional[torch.Tensor] = None


def shared_rotation(Up: torch.Tensor, rotate_dtype, dt) -> SharedRotation:
    """The SharedRotation of U' (float64 or the compute dtype, on the
    scan's device) at the tier `rotate_dtype` (normalize_rotate_tier's
    name, None for exact). 'high' holds the split of U' in dt
    (ops/scan.py::split_high), as the exact tier's operand would be
    rounded."""
    from mixmogam_tpu_torch.ops.scan import HIGH, quantize_rotation, split_high

    if rotate_dtype is None:
        return SharedRotation(None, Up.to(dt), None, dt)
    if rotate_dtype == HIGH:
        return SharedRotation(HIGH, split_high(Up.to(dt)), None, dt)
    W, ws = quantize_rotation(Up, rotate_dtype, sd_dtype=dt)
    rot = SharedRotation(rotate_dtype, W, ws, dt)
    if ws is not None and Up.device.type == "cuda":
        K, n = W.shape[0], W.shape[1]
        n8 = -(-n // _INT_MM_ALIGN) * _INT_MM_ALIGN
        rot.planes_t = torch.zeros((K, n8, n8), dtype=torch.int8,
                                   device=Up.device)
        rot.planes_t[:, :n, :n] = W.transpose(1, 2)
        rot.w_scale_pad = torch.zeros(n8, dtype=dt, device=Up.device)
        rot.w_scale_pad[:n] = ws
    return rot


def rotation_rows(W_rows: torch.Tensor, w_scale, dt, tier=None
                  ) -> SharedRotation:
    """The SharedRotation of a block of a rotation's contraction rows, as
    the tensor-parallel scan holds it (ops/scan.py::apply_rotation_psum):
    (nb, n) U' rows in dt ('exact'), (K, nb, n) int8 digit planes with
    their (n,) column scale w_scale, (K, nb, n) bf16 parts, or with tier
    'high' the (2, nb, n) split of U''s rows. On the card
    the planes are kept transposed, (K, n8, nb) with n padded to a
    multiple of 8, as torch._int_mm's column-major right operand; nb must
    be a multiple of 8 there (the mesh pads the sample axis so)."""
    from mixmogam_tpu_torch.ops.scan import HIGH

    if tier == HIGH:
        return SharedRotation(HIGH, W_rows, None, dt)
    if w_scale is None:
        tier = "bf16" if W_rows.dtype == torch.bfloat16 else None
        W = W_rows if tier else W_rows.to(dt)
        return SharedRotation(tier, W, None, dt)
    rot = SharedRotation("int8", W_rows, w_scale, dt)
    if W_rows.device.type == "cuda":
        K, nb, n = W_rows.shape
        if nb % _INT_MM_ALIGN:
            raise ValueError(f"torch._int_mm takes a contraction width "
                             f"that is a multiple of {_INT_MM_ALIGN}; the "
                             f"planes hold {nb} rows")
        n8 = -(-n // _INT_MM_ALIGN) * _INT_MM_ALIGN
        rot.planes_t = torch.zeros((K, n8, nb), dtype=torch.int8,
                                   device=W_rows.device)
        rot.planes_t[:, :n] = W_rows.transpose(1, 2)
        rot.w_scale_pad = torch.zeros(n8, dtype=dt, device=W_rows.device)
        rot.w_scale_pad[:n] = w_scale
    return rot


def rotate_tile(G_tile: torch.Tensor, rot: SharedRotation,
                plane: Optional[int] = None) -> torch.Tensor:
    """(m, n) Xr = G_tile @ W in rot's dtype, n the width of W's outputs.
    G_tile: int8 dosages (the int8 tiers need them, fully observed) or
    mean-imputed float rows. On the CPU: ops/scan.py apply_rotation.
    plane: at an int8 tier, digit plane `plane`'s product alone, in exact
    integers (int32 from torch._int_mm on the card; float64 on the CPU,
    exact: |sum| <= 2 * 128 * n << 2^53), before the recombine (the
    'sample' route sums it over its ranks first). 'high': rotate_high."""
    from mixmogam_tpu_torch.ops import assert_fp32_matmuls
    from mixmogam_tpu_torch.ops.scan import HIGH, apply_rotation

    if rot.tier == HIGH:
        return rotate_high(G_tile, rot.W, rot.dt)
    if G_tile.device.type == "cpu":
        if plane is not None:
            return G_tile.to(torch.float64) @ rot.W[plane].to(torch.float64)
        return apply_rotation(G_tile, rot.W, rot.w_scale, rot.dt)
    assert_fp32_matmuls()
    if rot.tier is None:
        return G_tile.to(rot.dt) @ rot.W
    if rot.w_scale is None:
        # bf16 parts: float32 products (a bf16 output would round each
        # product to 8 bits), summed in float32 as the JAX package does
        Gb = G_tile.to(torch.bfloat16)
        Xs = torch.mm(Gb, rot.W[0], out_dtype=torch.float32)
        for part in rot.W[1:]:
            Xs += torch.mm(Gb, part, out_dtype=torch.float32)
        return Xs.to(rot.dt)
    if G_tile.dtype != torch.int8:
        raise ValueError("the int8 digit-plane tiers take int8 dosages")
    m, n = G_tile.shape
    k8, n_out = rot.planes_t.shape[2], rot.W.shape[2]
    if m < _INT_MM_ROWS or k8 != n:
        Gp = torch.zeros((max(m, _INT_MM_ROWS), k8), dtype=torch.int8,
                         device=G_tile.device)
        Gp[:m, :n] = G_tile
    else:
        Gp = G_tile.contiguous()
    if plane is not None:
        return torch._int_mm(Gp, rot.planes_t[plane].t())[:m, :n_out]
    # the JAX package's recombine: A_i in dt times 256^i (exact: |A_i| <
    # 2^24), summed low digit first, then the column scale
    Xs = torch._int_mm(Gp, rot.planes_t[0].t()).to(rot.dt)
    for i in range(1, rot.planes_t.shape[0]):
        Xs.add_(torch._int_mm(Gp, rot.planes_t[i].t()).to(rot.dt),
                alpha=256.0 ** i)
    Xs.mul_(rot.w_scale_pad[None, :])
    return Xs[:m, :n_out]


def contraction_chunks(n: int, chunk: int):
    """[(s, e), ...]: [0, n) cut into consecutive chunks of `chunk`
    contraction samples, the last one shorter where chunk does not divide
    n (rotate_high's chunks)."""
    return [(s, min(s + chunk, n)) for s in range(0, n, chunk)]


def rotate_high(G_tile: torch.Tensor, parts: torch.Tensor, dt
                ) -> torch.Tensor:
    """(m, n) Xr ~ G_tile @ U' at the 'high' tier, in dt: parts = (U_hi,
    U_lo), ops/scan.py::split_high of U'; the tile split the same way
    (int8 dosages: G_lo = 0, whose product is skipped, which leaves the
    float32 sum unchanged bit for bit; float rows: split_high of the rows
    as the exact tier would cast them), then

        Xr = (G_hi U_lo + G_lo U_hi) + G_hi U_hi,

    each product torch.mm of bf16 operands with a float32 output, summed
    in float32 in that order: the three passes of XLA's bf16_3x
    (Precision.HIGH on a TPU), the two small terms first. TF32 stays off
    (assert_fp32_matmuls): every product here takes bf16 operands. On
    the CPU: ops/scan.py::apply_rotation_high, its plain version. A CUDA
    tile never falls back to the float32 GEMM.

    Float rows split the contraction: each pass runs one product a chunk
    of HIGH_CHUNK samples (contraction_chunks), so the tensor cores'
    float32 sums, which lose more than a float32 FMA does, run over
    HIGH_CHUNK samples only, and torch.addmm adds each chunk's product into
    one float32 accumulator in cuBLAS's FMA epilogue. The pass order holds
    across the chunks: every chunk of G_hi U_lo, then of G_lo U_hi, then
    of G_hi U_hi. int8 rows keep one product a pass over all n: their
    sums hold beta to 1e-5 without chunks."""
    from mixmogam_tpu_torch.ops import assert_fp32_matmuls
    from mixmogam_tpu_torch.ops.scan import apply_rotation_high, split_high

    if G_tile.device.type == "cpu":
        return apply_rotation_high(G_tile, parts, dt)
    assert_fp32_matmuls()
    Uh, Ul = parts[0], parts[1]
    if G_tile.dtype == torch.int8:
        Gh = G_tile.to(torch.bfloat16)
        Xs = torch.mm(Gh, Ul, out_dtype=torch.float32)
        Xs += torch.mm(Gh, Uh, out_dtype=torch.float32)
        return Xs.to(dt)
    Gh, Gl = split_high(G_tile.to(dt))
    Xs = None
    for A, B in ((Gh, Ul), (Gl, Uh), (Gh, Uh)):
        for s, e in contraction_chunks(A.shape[1], HIGH_CHUNK):
            if Xs is None:
                Xs = torch.mm(A[:, s:e], B[s:e], out_dtype=torch.float32)
            else:
                torch.addmm(Xs, A[:, s:e], B[s:e], out_dtype=torch.float32,
                            out=Xs)
    return Xs.to(dt)


def float_route_eig(K, eig_k, device, host_eigh=None):
    """The eigenbasis (phi, U) the float route's null is fitted on and its
    parts are cut from: eig_k as given, else eigh(K) on `device`
    (ops/eigen.py::eigen_k_on, float64)."""
    from mixmogam_tpu_torch.ops.eigen import eigen_k_on

    if eig_k is not None:
        return eig_k
    if K is None:
        raise ValueError("need K or eig_k")
    return eigen_k_on(K, device, host_eigh)


def float_rotation(U, X0, rotate_dtype, dt, device) -> SharedRotation:
    """The float route's rotation: the bf16 parts (tier `rotate_dtype`,
    'bf16', 'bf16x2' or 'bf16x3' and the 'c' spellings) of U' = (I - P_X0)
    U, projected in float64 on `device` from the eigenbasis U in float64,
    as multi-trait cuts its parts. A float32 U would move U' in its last
    bits before the cut, and the 1-pass tier's single part would round a
    few entries the other way from the float64 path's, each by a whole
    bf16 step."""
    from mixmogam_tpu_torch.ops.scan import project_design

    U64 = torch.as_tensor(U).to(device=device, dtype=torch.float64)
    Up = project_design(U64, torch.as_tensor(np.asarray(X0, np.float64)))[0]
    del U64
    return shared_rotation(Up, rotate_dtype, dt)


def scan_float_rows(G_tile: torch.Tensor, srot: SharedRotation, rot
                    ) -> torch.Tensor:
    """(4, m) [f, beta, var_perc, mask] of a tile of mean-imputed float
    rows at a bf16 tier: one rotation by srot's parts (float_rotation),
    then one launch of kernel K3 (its plain version on the CPU), which
    whitens by the exact tier's rot.sd (rot: build_rotated_null(null));
    the rows inside col(X0) come out masked."""
    from mixmogam_tpu_torch.ops.scan import (emmax_scan_prerotated,
                                             outside_design)

    keep = outside_design(G_tile.to(rot.X0p.dtype), rot.X0, rot.X0p)
    return emmax_scan_prerotated(rotate_tile(G_tile, srot), rot, keep)
