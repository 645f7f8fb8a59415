"""The EMMAX scan core (counterpart of mixmogam_tpu/ops/scan.py).

With eigh(K) = (phi, U) and the null REML delta, sd = 1/sqrt(phi+delta):

  Xs = (G_tile @ U) * sd       whitened SNP rows
  c  = Xs @ Q0, xy = Xs @ y_res, xx = row_sum(Xs^2) - row_sum(c^2)
  F  = (xy^2/xx) * dof / (rss0 - xy^2/xx)

Tiers: 'exact' (full fp32 GEMM G @ U on the card, then the scan_stats
kernel K3 whitens and runs the epilogue), the int8 digit-plane tiers
'int8x2/3/4' (kernel K2 on the packed rows) and the split-W bf16 tiers
'bf16' / 'bf16x2' / 'bf16x3' (kernel K5 on the packed rows; the 'c'
concat spellings are an XLA layout choice and take the same K5 path).
'high' would mean TF32 on the card, which the port pins off
(ops/__init__.py); it raises (ROADMAP Queue 1). On CUDA, 'auto' and
'fast' resolve to 'exact', as resolve_precision does off-TPU in the JAX
package. TIER_P_DRIFT, tier_drift_name, rescore_p_cut and
select_rescore_idx are numpy-only copies of the JAX functions, pinned
to the originals by tests/test_torch_ops.py and tests/test_torch_bf16.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from mixmogam_tpu_torch.ops.reml import NullModel

_HIGH_NOT_PORTED = ("the 'high' tier (a TF32 rotation GEMM on the card) is "
                    "not ported: the port pins TF32 off (ROADMAP Queue 1); "
                    "use 'exact', 'bf16x3' or 'int8x3'")


@dataclasses.dataclass
class RotatedNull:
    """Scan-phase constants, on the scan's device in its compute dtype.

    Exactly one of U / planes / parts is set: the exact tier rotates by
    the eigenbasis U and whitens by sd inside the scan kernel; the int8
    tiers carry the digit planes of W = U * sd (low digit first) with
    their per-column power-of-two scale w_scale; the bf16 tiers carry the
    split-W parts of W = U * sd (largest first; W ~ sum of the parts)."""

    sd: torch.Tensor                 # (n,) 1/sqrt(phi+delta)
    Q0: torch.Tensor                 # (n, q) orthonormal whitened design
    y_res: torch.Tensor              # (n,) whitened phenotype residual
    rss0: torch.Tensor               # scalar null RSS
    dof: torch.Tensor                # n - q - 1
    U: Optional[torch.Tensor] = None       # (n, n) exact tier
    planes: Optional[torch.Tensor] = None  # (K, n, n) int8, int8xK tiers
    w_scale: Optional[torch.Tensor] = None  # (n,) int8xK tiers
    parts: Optional[torch.Tensor] = None   # (K, n, n) bf16, bf16 tiers
    #: the exact tier's design: X0 and X0p = X0 (X0^T X0)^-1, (n, q) each.
    #: Its U is then (I - P_X0) U (project_design), and the scan masks the
    #: rows that lie in X0's span in sample space (outside_design)
    X0: Optional[torch.Tensor] = None
    X0p: Optional[torch.Tensor] = None
    #: kernels K2 / K5's prepared form of planes / parts on the card
    #: (ops/hopper_scan.py scan_operand builds it at the first scan)
    operand: Optional[object] = dataclasses.field(default=None, repr=False,
                                                  compare=False)


_INT8_TIERS = frozenset({"int8x2", "int8x3", "int8x4"})
_BF16_TIERS = frozenset({"bf16x2", "bf16x3", "bf16x2c", "bf16x3c"})
_ROTATE_TIERS = _INT8_TIERS | _BF16_TIERS


def normalize_rotate_tier(rotate_in_bf16):
    """The JAX package's tier spelling -> None (exact fp32), 'bf16' (the
    1-pass tier, which the JAX function returns as jnp.bfloat16) or a
    split/digit tier name ('bf16x3', 'int8x3', ...). Unknown names raise
    ValueError, as in the JAX package."""
    if not rotate_in_bf16:
        return None
    if rotate_in_bf16 is True:
        return "bf16"
    s = str(rotate_in_bf16)
    if s in ("bf16", "bfloat16"):
        return "bf16"
    if not s.startswith(("bf16", "int8")):
        s = "bf16" + s
    if s not in _ROTATE_TIERS:
        raise ValueError(
            f"unknown rotation tier {rotate_in_bf16!r}; choose from "
            f"False (exact fp32), True/'bf16', {sorted(_ROTATE_TIERS)}")
    return s


def bf16_parts_count(rotate_dtype) -> int:
    """Number of split-W parts of a bf16 tier name ('bf16' -> 1), 0 for
    any other tier."""
    if rotate_dtype == "bf16":
        return 1
    return int(rotate_dtype[5]) if rotate_dtype in _BF16_TIERS else 0


#: user-facing precision names -> rotate tier ('high' is refused)
PRECISION_TIERS = {
    "exact": False,
    "bf16": True,
    "bf16x2": "bf16x2", "bf16x3": "bf16x3",
    "bf16x2c": "bf16x2c", "bf16x3c": "bf16x3c",
    "int8x2": "int8x2", "int8x3": "int8x3", "int8x4": "int8x4",
}


def resolve_precision(precision: str):
    """Resolve a unified `precision` name -> (rotate tier, resolved name).
    'auto' and 'fast' resolve to 'exact': their int8 routing was measured
    on the TPU only (ROADMAP H100 cell 1(a) decides it for the card).
    'high' raises NotImplementedError: on the card it would be TF32."""
    p = str(precision)
    if p in ("auto", "fast"):
        p = "exact"
    if p == "high":
        raise NotImplementedError(_HIGH_NOT_PORTED)
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


def tier_drift_name(rd, matmul_precision=None) -> str:
    """normalize_rotate_tier's result (+ matmul_precision) -> the
    TIER_P_DRIFT key of the active scan tier."""
    if isinstance(rd, str):
        return rd
    return matmul_precision or "exact"


def rescore_p_cut(M: int, tier, alpha: float = 0.05,
                  safety: float = 8.0) -> float:
    """Fast-tier p cut below which every SNP is exactly re-scored:
    alpha/M + safety * drift (unknown tiers take the worst drift)."""
    drift = TIER_P_DRIFT.get(str(tier), max(TIER_P_DRIFT.values()))
    return alpha / max(M, 1) + safety * drift


def select_rescore_idx(ps, rescore_top: int, tier,
                       alpha: float = 0.05, safety: float = 8.0,
                       M_cut: Optional[int] = None):
    """{all SNPs with p <= rescore_p_cut} ∪ {top rescore_top by p},
    uncapped (the JAX package's threshold-complete rescore contract).
    M_cut: the SNP count of the Bonferroni cut when ps covers only part of
    the study (a LOCO chromosome); default len(ps)."""
    ps = np.asarray(ps)
    M = ps.shape[0] if M_cut is None else int(M_cut)
    k = min(int(rescore_top), ps.shape[0])
    cand = np.argsort(ps, kind="stable")[:k]
    near = np.flatnonzero(ps <= rescore_p_cut(M, tier, alpha, safety))
    return np.union1d(cand, near)


def _flush_subnormal(x: torch.Tensor) -> torch.Tensor:
    """float32 subnormals -> signed zero, as XLA gives them (flush-to-zero
    in its float64 -> float32 convert and its arithmetic, on the CPU and
    the TPU); torch keeps them. Only entries below 1.2e-38 are touched.
    The card's parts go through it too: a W built on the card then splits
    into the same parts as the JAX package's, and a JAX W carried over by
    convert.py scans like one built here."""
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny, x * 0, x)


def quantize_rotation(W: torch.Tensor, rotate_dtype, sd_dtype=None):
    """(n, n) W -> its representation in the tier `rotate_dtype`:

    - 'int8xK': ((K, n, n) int8 balanced base-256 digit planes, low digit
      first; (n,) power-of-two column scale). torch.remainder /
      floor_divide follow Python's sign rule like jnp's % and //.
    - 'bf16' / 'bf16xK' (and the 'c' spellings): ((K, n, n) bf16 split-W
      parts, None). The residual stays in float32 and each part is its
      round-to-nearest-even bf16 cast, as XLA's convert; 'bf16' is K = 1.
      Subnormal residuals flush to zero as in XLA, which makes the parts
      bit-equal to JAX's for a float64 W; for a float32 W with subnormal
      entries (below 1.2e-38) the lower parts may differ from XLA's.

    Bit-equal to the JAX package's quantize_rotation
    (tests/test_torch_ops.py, tests/test_torch_bf16.py)."""
    if rotate_dtype is None:
        return W, None
    k = bf16_parts_count(rotate_dtype)
    if k:
        resid = W.to(torch.float32)
        if W.dtype != torch.float32:
            resid = _flush_subnormal(resid)
        parts = []
        for _ in range(k):
            p = resid.to(torch.bfloat16)
            parts.append(p)
            resid = _flush_subnormal(resid - p.to(torch.float32))
        return torch.stack(parts), None
    if rotate_dtype not in _INT8_TIERS:
        raise ValueError(f"unknown rotation tier {rotate_dtype!r}")
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
    the exact tier (float W), the int8xK tiers (W = the (K, n, n) digit
    planes with their scale w_scale) and the bf16 tiers (W = the (K, n, n)
    bf16 parts).

    int8: each plane product runs in float64, which is exact for these
    integers (|sum| <= 2 * 128 * n << 2^53), so it equals the int32
    accumulation of kernel K2 and of XLA; the base-256 recombine follows
    in dt, as in the JAX package.

    bf16: G is rounded to bf16 first (as XLA's G.astype(bf16); integer
    dosages are exact, imputed means round), then each part's product runs
    on float64 copies: a bf16 x bf16 product is exact in float64, so this
    is XLA's dot with preferred_element_type=dt up to summation order. A
    bf16 `@` on the CPU would round its output to bf16."""
    if W.dtype == torch.bfloat16:
        Gd = G_tile.to(torch.bfloat16).to(torch.float64)
        Xs = None
        for i in range(W.shape[0]):
            term = (Gd @ W[i].to(torch.float64)).to(dt)
            Xs = term if Xs is None else Xs + term
        return Xs
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
    rotate_dtype: None (exact), a bf16 tier ('bf16', 'bf16x2', 'bf16x3',
    'bf16x2c', 'bf16x3c') or an int8 tier ('int8x2' / 'int8x3' /
    'int8x4')."""
    from mixmogam_tpu_torch.ops.eigen import orthonormal_basis

    phi, U, delta = null.phi, null.U, null.delta
    sd = 1.0 / torch.sqrt(phi + delta)
    Ur = planes = w_scale = parts = X0 = X0p = None
    if rotate_dtype is None:
        Ur, X0, X0p = project_design(U, null.X0)
    elif bf16_parts_count(rotate_dtype):
        parts, _ = quantize_rotation(U * sd[None, :], rotate_dtype)
    else:
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
                       U=Ur, planes=planes, w_scale=w_scale, parts=parts,
                       X0=X0, X0p=X0p)


def project_design(U: torch.Tensor, X0: torch.Tensor, block: int = 4_096):
    """((I - P_X0) U, X0, X0p) in U's dtype on U's device, with P_X0 =
    X0 (X0^T X0)^-1 X0^T the projection onto the null design's columns in
    sample space and X0p = X0 (X0^T X0)^-1; the product runs in float64, a
    block of U's columns at a time.

    A SNP row g and g - P_X0 g give the same F, beta and var_perc: the scan
    projects col(X0) out after whitening. Rotating by the projected U keeps
    that span out of the rotated rows. Where K is singular along a column
    of X0 (VanRaden's K along the intercept) and delta is small, that span
    would otherwise weigh 1/delta times the rest of the row, and a float32
    scan would lose the residual sum xx = ss - |Q0^T x|^2 to cancellation
    and mask the row."""
    X = X0.to(device=U.device, dtype=torch.float64)
    if X.ndim == 1:
        X = X[:, None]
    Xp = torch.linalg.solve(X.T @ X, X.T).T
    Up = torch.empty_like(U)
    for j in range(0, U.shape[1], block):
        Ub = U[:, j:j + block].double()
        Up[:, j:j + block] = Ub - X @ (Xp.T @ Ub)
    return Up, X.to(U.dtype), Xp.to(U.dtype)


def outside_design(G_tile: torch.Tensor, X0: torch.Tensor,
                   X0p: torch.Tensor) -> torch.Tensor:
    """(m,) bool: True where a dosage row g keeps a part outside col(X0)
    in sample space, |g - P_X0 g|^2 > eps * |g|^2 in G_tile's dtype.

    The exact tier rotates by the projected U, so a row inside col(X0) (a
    monomorphic SNP under an intercept) reaches the scan as rounding noise,
    which the scan's relative mask would pass; this mask catches it where
    the unprojected scan did. A real SNP leaves at least about |g|^2 / n
    outside: many orders of magnitude above eps."""
    fi = torch.finfo(G_tile.dtype)
    R = G_tile - (G_tile @ X0p) @ X0.T
    gg = (G_tile * G_tile).sum(dim=1)
    return (R * R).sum(dim=1) > fi.eps * torch.clamp(gg, min=fi.tiny)


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
    the card, TF32 off), then scan_stats (kernel K3 on CUDA); the rows
    inside the null design's span come out masked (outside_design)."""
    from mixmogam_tpu_torch.ops import assert_fp32_matmuls

    if rot.U is None:
        raise ValueError("emmax_scan_stats runs the exact tier; int8 and "
                         "bf16 tiers scan packed rows (rotate_scan_int8_"
                         "packed / rotate_scan_bf16_packed)")
    assert_fp32_matmuls()
    Xr = apply_rotation(G_tile, rot.U, None, rot.U.dtype)
    keep = (None if rot.X0p is None else
            outside_design(G_tile.to(rot.X0p.dtype), rot.X0, rot.X0p))
    return emmax_scan_prerotated(Xr, rot, keep)


def emmax_scan_prerotated(Xr: torch.Tensor, rot: RotatedNull, keep=None
                          ) -> torch.Tensor:
    """(4, m) stats of pre-rotated rows Xr = G @ U (or the imputed dosages
    themselves where K is the identity), all m rows in one launch of
    scan_stats (kernel K3 on CUDA; no tile padding). keep: (m,) bool from
    outside_design when U was projected; the other rows come out masked."""
    from mixmogam_tpu_torch.ops.hopper_scan import scan_stats

    out = scan_stats(Xr, rot.sd, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    # the rows inside X0's span: every output zeroed, the mask included
    # (a where, not a product: such a row's f may be inf)
    return out if keep is None else torch.where(keep[None, :], out, 0.0)


def stats_dict(out: torch.Tensor) -> Dict[str, np.ndarray]:
    """(4, m) kernel output -> the JAX package's per-row dict (host)."""
    h = out.detach().cpu().double().numpy()
    return {"f_stats": h[0], "betas": h[1], "var_perc": h[2],
            "mask": h[3] > 0.5}
