"""The EMMAX scan core (counterpart of mixmogam_tpu/ops/scan.py).

With eigh(K) = (phi, U) and the null REML delta, sd = 1/sqrt(phi+delta):

  Xs = (G_tile @ U) * sd       whitened SNP rows
  c  = Xs @ Q0, xy = Xs @ y_res, xx = row_sum(Xs^2) - row_sum(c^2)
  F  = (xy^2/xx) * dof / (rss0 - xy^2/xx)

Tiers ported in this slice: 'exact' (full fp32 GEMM G @ U on the card,
then the scan_stats kernel K3 whitens and runs the epilogue) and the int8
digit-plane tiers 'int8x2/3/4' (kernel K2 on the packed rows). The bf16
tiers and 'high' wait for ROADMAP Queue 2 (kernel #4). On CUDA, 'auto' and
'fast' resolve to 'exact', as resolve_precision does off-TPU in the JAX
package. is_integer_dosage, TIER_P_DRIFT, rescore_p_cut and
select_rescore_idx are numpy-only copies of the JAX functions, pinned to
the originals by tests/test_torch_ops.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from mixmogam_tpu_torch.ops.reml import NullModel

_NOT_PORTED = ("the {} tier is not ported yet (ROADMAP Queue 2: the "
               "bf16/split-W rotate+scan kernel); use 'exact' or "
               "'int8x2'/'int8x3'/'int8x4'")


@dataclasses.dataclass
class RotatedNull:
    """Scan-phase constants, on the scan's device in its compute dtype.

    Exactly one of U / planes is set: the exact tier rotates by the
    eigenbasis U and whitens by sd inside the scan kernel; the int8 tiers
    carry the digit planes of W = U * sd (low digit first) with their
    per-column power-of-two scale w_scale."""

    sd: torch.Tensor                 # (n,) 1/sqrt(phi+delta)
    Q0: torch.Tensor                 # (n, q) orthonormal whitened design
    y_res: torch.Tensor              # (n,) whitened phenotype residual
    rss0: torch.Tensor               # scalar null RSS
    dof: torch.Tensor                # n - q - 1
    U: Optional[torch.Tensor] = None       # (n, n) exact tier
    planes: Optional[torch.Tensor] = None  # (K, n, n) int8, int8xK tiers
    w_scale: Optional[torch.Tensor] = None  # (n,) int8xK tiers


_ROTATE_TIERS = frozenset({"int8x2", "int8x3", "int8x4"})
_BF16_TIERS = frozenset({"bf16x2", "bf16x3", "bf16x2c", "bf16x3c"})


def normalize_rotate_tier(rotate_in_bf16):
    """The JAX package's tier spelling -> None (exact fp32) or an
    'int8xK' name. bf16 spellings raise NotImplementedError, unknown
    names ValueError."""
    if not rotate_in_bf16:
        return None
    if rotate_in_bf16 is True:
        raise NotImplementedError(_NOT_PORTED.format("bf16"))
    s = str(rotate_in_bf16)
    if s in ("bf16", "bfloat16"):
        raise NotImplementedError(_NOT_PORTED.format("bf16"))
    if not s.startswith(("bf16", "int8")):
        s = "bf16" + s
    if s in _BF16_TIERS:
        raise NotImplementedError(_NOT_PORTED.format(s))
    if s not in _ROTATE_TIERS:
        raise ValueError(
            f"unknown rotation tier {rotate_in_bf16!r}; choose from "
            f"False (exact fp32), {sorted(_ROTATE_TIERS)}")
    return s


def is_integer_dosage(G) -> bool:
    """True when every dosage is an exact small integer (int8-safe)."""
    G = np.asarray(G)
    if np.issubdtype(G.dtype, np.integer):
        return bool(G.min(initial=0) >= 0 and G.max(initial=0) <= 127)
    if not np.issubdtype(G.dtype, np.floating):
        return False
    if G.size and (np.isnan(G).any() or np.abs(G).max() > 127):
        return False
    return bool(np.array_equal(G, np.round(G)))


#: user-facing precision names -> rotate tier (ported tiers only)
PRECISION_TIERS = {"exact": False, "int8x2": "int8x2", "int8x3": "int8x3",
                   "int8x4": "int8x4"}


def resolve_precision(precision: str):
    """Resolve a unified `precision` name -> (rotate tier, resolved name).
    'auto' and 'fast' resolve to 'exact': their int8 routing was measured
    on the TPU only (ROADMAP H100 cell 1(a) decides it for the card)."""
    p = str(precision)
    if p in ("auto", "fast"):
        p = "exact"
    if p == "high" or p.startswith("bf16"):
        raise NotImplementedError(_NOT_PORTED.format(p))
    if p not in PRECISION_TIERS:
        raise ValueError(
            f"unknown precision tier {precision!r}; choose from "
            f"{['auto', 'fast'] + sorted(PRECISION_TIERS)}")
    return PRECISION_TIERS[p], p


#: absolute p-value drift bound per tier, as measured for the JAX
#: package (its TPU runs); the card's own values come from ROADMAP
#: cell 1(a). Feeds the rescore cut.
TIER_P_DRIFT = {
    "exact": 0.0,
    "high": 2e-5,
    "bf16": 6e-3,
    "bf16x2": 1e-5, "bf16x2c": 1e-5,
    "bf16x3": 1e-6, "bf16x3c": 1e-6,
    "int8x2": 5e-4,
    "int8x3": 1.5e-6,
    "int8x4": 1e-6,
}


def rescore_p_cut(M: int, tier, alpha: float = 0.05,
                  safety: float = 8.0) -> float:
    """Fast-tier p cut below which every SNP is exactly re-scored:
    alpha/M + safety * drift (unknown tiers take the worst drift)."""
    drift = TIER_P_DRIFT.get(str(tier), max(TIER_P_DRIFT.values()))
    return alpha / max(M, 1) + safety * drift


def select_rescore_idx(ps, rescore_top: int, tier,
                       alpha: float = 0.05, safety: float = 8.0):
    """{all SNPs with p <= rescore_p_cut} ∪ {top rescore_top by p},
    uncapped (the JAX package's threshold-complete rescore contract)."""
    ps = np.asarray(ps)
    M = ps.shape[0]
    k = min(int(rescore_top), M)
    cand = np.argsort(ps, kind="stable")[:k]
    near = np.flatnonzero(ps <= rescore_p_cut(M, tier, alpha, safety))
    return np.union1d(cand, near)


def quantize_rotation(W: torch.Tensor, rotate_dtype, sd_dtype=None):
    """(n, n) W -> ((K, n, n) int8 balanced base-256 digit planes, low
    digit first; (n,) power-of-two column scale) for 'int8xK'. Bit-equal
    to the JAX package's quantize_rotation (tests/test_torch_ops.py):
    torch.remainder / floor_divide follow Python's sign rule like jnp's
    % and //."""
    if rotate_dtype is None:
        return W, None
    if rotate_dtype not in _ROTATE_TIERS:
        raise NotImplementedError(_NOT_PORTED.format(rotate_dtype))
    if sd_dtype is None:
        sd_dtype = W.dtype
    k = int(rotate_dtype[5])
    bits = 8 * k - 2                       # top balanced digit fits int8
    colmax = W.abs().amax(dim=0)
    _, e = torch.frexp(colmax)             # colmax <= 2^e exactly
    # 2^(e - bits) via numpy's ldexp, which is exact (torch.exp2 on the
    # CPU can miss a power of two by one ulp)
    np_dt = torch.empty((), dtype=sd_dtype).numpy().dtype
    w_scale = torch.as_tensor(
        np.ldexp(np.ones(e.shape[0], np_dt), e.cpu().numpy() - bits),
        device=W.device)
    r = torch.round(W / w_scale[None, :]).to(torch.int32)
    planes = []
    for _ in range(k):
        d = torch.remainder(r + 128, 256) - 128
        planes.append(d.to(torch.int8))
        r = torch.floor_divide(r - d, 256)
    return torch.stack(planes), w_scale


def apply_rotation(G_tile: torch.Tensor, W: torch.Tensor, w_scale, dt
                   ) -> torch.Tensor:
    """Xs = G_tile @ W in plain torch, accumulated and returned in dt, for
    the exact tier (float W) and the int8xK tiers (W = the (K, n, n) digit
    planes with their scale w_scale). Each plane product runs in float64,
    which is exact for these integers (|sum| <= 2 * 128 * n << 2^53), so
    it equals the int32 accumulation of kernel K2 and of XLA; the
    base-256 recombine follows in dt, as in the JAX package."""
    if W.dtype != torch.int8:
        return (G_tile.to(W.dtype) @ W).to(dt)
    Gd = G_tile.to(torch.float64)
    Xs = None
    for i in range(W.shape[0]):
        term = (Gd @ W[i].to(torch.float64)).to(dt) * (256.0 ** i)
        Xs = term if Xs is None else Xs + term
    return Xs * w_scale[None, :].to(dt)


def build_rotated_null(null: NullModel, rotate_dtype=None) -> RotatedNull:
    """Scan constants of the null model, on the null's device and dtype.
    rotate_dtype: None (exact) or 'int8x2' / 'int8x3' / 'int8x4'."""
    from mixmogam_tpu_torch.ops.eigen import orthonormal_basis

    phi, U, delta = null.phi, null.U, null.delta
    sd = 1.0 / torch.sqrt(phi + delta)
    if rotate_dtype is None:
        Ur, planes, w_scale = U, None, None
    else:
        Ur = None
        planes, w_scale = quantize_rotation(U * sd[None, :], rotate_dtype,
                                            sd_dtype=sd.dtype)
    y_star = (null.y @ U) * sd
    X0_star = (null.X0.T @ U).T * sd[:, None]
    Q0 = orthonormal_basis(X0_star)
    y_res = y_star - Q0 @ (Q0.T @ y_star)
    rss0 = y_res @ y_res
    n, q = X0_star.shape
    return RotatedNull(sd=sd, Q0=Q0, y_res=y_res, rss0=rss0,
                       dof=torch.tensor(n - q - 1, dtype=sd.dtype,
                                        device=sd.device),
                       U=Ur, planes=planes, w_scale=w_scale)


def scan_epilogue(Xs: torch.Tensor, Q0, y_res, rss0, dof
                  ) -> torch.Tensor:
    """F statistics from whitened SNP rows Xs (m, n) -> (4, m) rows
    [f, beta, var_perc, mask] in Xs's dtype (mask as 0/1). eps and tiny
    follow the compute dtype, as ops/scan.py's scan_epilogue does."""
    dt = Xs.dtype
    fi = torch.finfo(dt)
    c = Xs @ Q0
    xy = Xs @ y_res
    ss = (Xs * Xs).sum(dim=1)
    xx = ss - (c * c).sum(dim=1)
    eps = 100.0 * fi.eps
    mask = xx > eps * torch.clamp(ss, min=fi.tiny)
    rss0 = torch.as_tensor(rss0, dtype=dt, device=Xs.device)
    dof = torch.as_tensor(dof, dtype=dt, device=Xs.device)
    zero = torch.zeros((), dtype=dt, device=Xs.device)
    xx_safe = torch.where(mask, xx, torch.ones((), dtype=dt,
                                               device=Xs.device))
    expl = xy * xy / xx_safe
    expl = torch.where(mask, torch.minimum(expl, rss0), zero)
    rss1 = rss0 - expl
    rss1_safe = torch.clamp(rss1, min=fi.tiny)
    f = expl * dof / rss1_safe
    beta = torch.where(mask, xy / xx_safe, zero)
    var_perc = torch.where(mask, expl / rss0, zero)
    return torch.stack([torch.where(mask, f, zero), beta, var_perc,
                        mask.to(dt)])


def emmax_scan_stats(G_tile: torch.Tensor, rot: RotatedNull
                     ) -> torch.Tensor:
    """(4, m) [f, beta, var_perc, mask] for one tile of float dosage rows
    (mean-imputed) at the exact tier: Xr = G_tile @ U (full fp32 GEMM on
    the card, TF32 off), then scan_stats (kernel K3 on CUDA)."""
    from mixmogam_tpu_torch.ops import assert_fp32_matmuls
    from mixmogam_tpu_torch.ops.hopper_scan import scan_stats

    if rot.U is None:
        raise ValueError("emmax_scan_stats runs the exact tier; int8 "
                         "tiers scan packed rows (rotate_scan_int8_packed)")
    assert_fp32_matmuls()
    Xr = apply_rotation(G_tile, rot.U, None, rot.U.dtype)
    return scan_stats(Xr, rot.sd, rot.y_res, rot.Q0, rot.rss0, rot.dof)


def stats_dict(out: torch.Tensor) -> Dict[str, np.ndarray]:
    """(4, m) kernel output -> the JAX package's per-row dict (host)."""
    h = out.detach().cpu().double().numpy()
    return {"f_stats": h[0], "betas": h[1], "var_perc": h[2],
            "mask": h[3] > 0.5}
