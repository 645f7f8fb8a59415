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
'high' is the JAX package's three-pass bf16 rotation (XLA's
Precision.HIGH on a TPU): the exact tier's route, U' and the dosage rows
each split into bf16 hi + lo parts, G·U' ~ G_hi·U_lo + G_lo·U_hi +
G_hi·U_hi in bf16 products with float32 outputs, then K3; TF32 stays off
(ops/__init__.py, ops/rotate.py::rotate_high). 'auto' and 'fast' follow
the JAX package's rule with "the device is CUDA" in place of "the backend
is a TPU": on the card, integer dosages take int8x3 ('auto', while the
card's own TIER_P_DRIFT entry for int8x3 stays within AUTO_MAX_DRIFT,
which the measured entry does not: exact) or int8x2 ('fast'), other
dosages exact ('auto') or bf16 ('fast'); on the CPU both resolve to
'exact'. TIER_P_DRIFT and GXE_P_DRIFT are the card's own drift against
the exact tier (chip_smoke.py phases 4 and 12).
is_integer_dosage, probe_for_source, tier_drift_name, rescore_p_cut and
select_rescore_idx are numpy-only copies of the JAX functions, pinned to
the originals by tests/test_torch_ops.py and tests/test_torch_bf16.py.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from mixmogam_tpu_torch.ops.reml import NullModel


@dataclasses.dataclass
class RotatedNull:
    """Scan-phase constants, on the scan's device in its compute dtype.

    Exactly one of U / planes / parts is set: the exact tier rotates by
    the eigenbasis U and whitens by sd inside the scan kernel; the int8
    tiers carry the digit planes of W (low digit first) with their
    per-column power-of-two scale w_scale; the bf16 tiers carry the
    split-W parts of W (largest first; W ~ sum of the parts). W is
    W'' = (U * sd)(I - Q0 Q0^T) where build_rotated_null made it
    (folded), U * sd as the JAX package has it where convert.py carried
    it over."""

    sd: torch.Tensor                 # (n,) 1/sqrt(phi+delta)
    Q0: torch.Tensor                 # (n, q) orthonormal whitened design
    y_res: torch.Tensor              # (n,) whitened phenotype residual
    rss0: torch.Tensor               # scalar null RSS
    dof: torch.Tensor                # n - q - 1
    U: Optional[torch.Tensor] = None       # (n, n) exact tier
    planes: Optional[torch.Tensor] = None  # (K, n, n) int8, int8xK tiers
    w_scale: Optional[torch.Tensor] = None  # (n,) int8xK tiers
    parts: Optional[torch.Tensor] = None   # (K, n, n) bf16, bf16 tiers
    #: the 'high' tier: the (2, n, n) bf16 (hi, lo) split of U (split_high),
    #: beside U; the exact tier's route rotates by it (ops/rotate.py::
    #: rotate_high)
    high: Optional[torch.Tensor] = None
    #: the exact tier's design: X0 and X0p = X0 (X0^T X0)^-1, (n, q) each.
    #: Its U is then (I - P_X0) U (project_design), and the scan masks the
    #: rows that lie in X0's span in sample space (outside_design)
    X0: Optional[torch.Tensor] = None
    X0p: Optional[torch.Tensor] = None
    #: the int8 / bf16 tiers' W is W'' = W (I - Q0 Q0^T): the rotated rows
    #: come out orthogonal to Q0, so the kernels take Q0 with no columns
    #: (scan_q0) and ss is xx itself; X0 / X0p then serve the mask of the
    #: rows inside col(X0) (outside_design), as on the exact tier
    folded: bool = False
    #: kernels K2 / K5's prepared form of planes / parts on the card
    #: (ops/hopper_scan.py scan_operand builds it at the first scan)
    operand: Optional[object] = dataclasses.field(default=None, repr=False,
                                                  compare=False)
    #: kernel K3's prepared sd / y_res / Q0 block and host rss0 / dof on
    #: the card (ops/hopper_scan.py k3_operand builds it at the first scan)
    k3: Optional[object] = dataclasses.field(default=None, repr=False,
                                             compare=False)

    @property
    def scan_q0(self) -> torch.Tensor:
        """The Q0 the scan kernels take: (n, 0) for a folded W, else Q0."""
        return self.Q0[:, :0] if self.folded else self.Q0


#: design columns the int8 / bf16 tiers take, the TPU kernels' QPAD: their
#: exact rescore runs kernel K3, which takes Q0 up to that width
DESIGN_QMAX = 128

_INT8_TIERS = frozenset({"int8x2", "int8x3", "int8x4"})
_BF16_TIERS = frozenset({"bf16x2", "bf16x3", "bf16x2c", "bf16x3c"})
_ROTATE_TIERS = _INT8_TIERS | _BF16_TIERS

#: the 'high' tier's name: a matmul precision of the exact tier's route in
#: the JAX package (its PRECISION_TIERS value (False, 'high')), not a
#: rotation tier
HIGH = "high"


def normalize_rotate_tier(rotate_in_bf16):
    """The JAX package's tier spelling -> None (exact fp32), 'bf16' (the
    1-pass tier, which the JAX function returns as jnp.bfloat16) or a
    split/digit tier name ('bf16x3', 'int8x3', ...). Unknown names raise
    ValueError, as in the JAX package. HIGH (resolve_precision's 'high')
    stays HIGH: the shared-rotation scans (multi-trait, GxE, the
    permutation test) take it as their rotation's tier, the exact tier's
    route splits it off (matmul_tier)."""
    if not rotate_in_bf16:
        return None
    if rotate_in_bf16 is True:
        return "bf16"
    s = str(rotate_in_bf16)
    if s in ("bf16", "bfloat16"):
        return "bf16"
    if s == HIGH:
        return HIGH
    if not s.startswith(("bf16", "int8")):
        s = "bf16" + s
    if s not in _ROTATE_TIERS:
        raise ValueError(
            f"unknown rotation tier {rotate_in_bf16!r}; choose from "
            f"False (exact fp32), True/'bf16', {sorted(_ROTATE_TIERS)}")
    return s


def matmul_tier(rd):
    """normalize_rotate_tier's result -> the JAX package's (rotate tier,
    matmul precision) pair: (None, 'high') for HIGH, the exact tier's route
    with its rotation split in three bf16 passes; (rd, None) otherwise."""
    return (None, HIGH) if rd == HIGH else (rd, None)


def refuse_high_on_mesh(rd) -> None:
    """The JAX package's ValueError for 'high' on the mesh path
    (mixmogam_tpu/models/emmax.py:207): its distributed scans take the
    rotation tiers only."""
    if rd == HIGH:
        raise ValueError("the 'high' matmul tier is not supported on the "
                         "mesh path")


def bf16_parts_count(rotate_dtype) -> int:
    """Number of split-W parts of a bf16 tier name ('bf16' -> 1), 0 for
    any other tier."""
    if rotate_dtype == "bf16":
        return 1
    return int(rotate_dtype[5]) if rotate_dtype in _BF16_TIERS else 0


#: user-facing precision names -> rotate tier ('high': HIGH, which
#: matmul_tier splits off)
PRECISION_TIERS = {
    "exact": False,
    "high": HIGH,
    "bf16": True,
    "bf16x2": "bf16x2", "bf16x3": "bf16x3",
    "bf16x2c": "bf16x2c", "bf16x3c": "bf16x3c",
    "int8x2": "int8x2", "int8x3": "int8x3", "int8x4": "int8x4",
}


def is_integer_dosage(G) -> bool:
    """True when every dosage is an exact small integer (int8-safe): the
    int8 digit-plane tiers are exact for this matrix. Negative integers
    (the missing sentinel), NaN and fractions give False."""
    G = np.asarray(G)
    if np.issubdtype(G.dtype, np.integer):
        return bool(G.min(initial=0) >= 0 and G.max(initial=0) <= 127)
    if not np.issubdtype(G.dtype, np.floating):
        return False
    if G.size and (np.isnan(G).any() or np.abs(G).max() > 127):
        return False
    return bool(np.array_equal(G, np.round(G)))


def probe_for_source(rg=None, Gf=None):
    """The dosage probe resolve_precision's 'auto' / 'fast' rule inspects:
    a ResidentGenome answers from its has_missing flag (no decode), an
    in-core matrix is probed itself."""
    if rg is not None:
        return (np.full((1, 1), np.nan) if rg.has_missing
                else np.zeros((1, 1), dtype=np.int8))
    return Gf


#: 'auto' takes int8x3 only while the card's int8x3 drift entry is at most
#: this: the accuracy the exact tier itself is held to on the card (its
#: float32 scan against the float64 CPU path, PERF.md section 2). The
#: card's entry is 2e-5 (TIER_P_DRIFT), so 'auto' resolves to exact there
AUTO_MAX_DRIFT = 1e-5


def resolve_precision(precision: str, G=None, device=None):
    """Resolve a unified `precision` name -> (rotate tier, resolved name).

    'auto' and 'fast' follow the JAX package's rule with "device is CUDA"
    in place of its TPU test. On the card, 'auto' gives int8x3 when the
    dosages G (probe_for_source) are exact small integers and the card's
    int8x3 entry of TIER_P_DRIFT is at most AUTO_MAX_DRIFT, else 'exact';
    'fast' gives int8x2 for integer dosages and bf16 otherwise (callers
    pair it with rescore_top). On the CPU, or with no device, both give
    'exact', as in the JAX package off the TPU. 'high' gives (HIGH,
    'high'): the three-pass bf16 rotation on the exact tier's route
    (matmul_tier), with TF32 off."""
    p = str(precision)
    if p in ("auto", "fast"):
        on_card = device is not None and torch.device(device).type == "cuda"
        int_ok = on_card and G is not None and is_integer_dosage(G)
        if p == "auto":
            p = ("int8x3" if int_ok
                 and TIER_P_DRIFT["int8x3"] <= AUTO_MAX_DRIFT else "exact")
        else:
            p = "int8x2" if int_ok else ("bf16" if on_card else "exact")
    if p not in PRECISION_TIERS:
        raise ValueError(
            f"unknown precision tier {precision!r}; choose from "
            f"{['auto', 'fast'] + sorted(PRECISION_TIERS)}")
    return PRECISION_TIERS[p], p


#: absolute p-value drift bound per tier against the exact tier, on the
#: card: NVIDIA H100 80GB HBM3, 700.00 W (chip_smoke.py phase 4: every
#: tier against exact on phase 4's genome, n = 10,240 x 262,144, under
#: designs of 1, 20 and 128 columns and VanRaden's singular K with delta at
#: its bound; largest max |dp| int8x2 5.081e-4, int8x3 6.204e-6, int8x4
#: 6.375e-6, bf16 8.235e-3, bf16x2 1.088e-5, bf16x3 6.631e-6). Each entry
#: is the smallest one-significant-digit value at least twice its tier's
#: largest. int8x3 / int8x4 / bf16x3 drift alike: what is left is the
#: float32 exact tier's own rounding, not the tier's. The 'c' spellings
#: run their tier's kernel. 'high' (the three bf16 passes, then K3):
#: largest max |dp| 1.471e-5 over the same four fixtures on the same card
#: (chip_smoke.py's phase 4 functions). Feeds the rescore cut.
TIER_P_DRIFT = {
    "exact": 0.0,
    "high": 3e-5,
    "bf16": 2e-2,
    "bf16x2": 3e-5, "bf16x2c": 3e-5,
    "bf16x3": 2e-5, "bf16x3c": 2e-5,
    "int8x2": 2e-3,
    "int8x3": 2e-5,
    "int8x4": 2e-5,
}


#: the same for emmax_gxe's p-values (the largest max |dp| over its
#: marginal, interaction and joint tests), on the card: NVIDIA H100 80GB
#: HBM3, 700.00 W (chip_smoke.py phase 12: E = 2 on phase 4's genome;
#: int8x2 1.575e-3, int8x3 4.472e-5, int8x4 7.314e-6, bf16 7.936e-3,
#: bf16x2 1.082e-4, bf16x3 7.692e-6; high 1.082e-4: on integer dosages its
#: products are bf16x2's of U', G_lo being zero), by the same rule. Feeds
#: GxE's rescore cut.
GXE_P_DRIFT = {
    "exact": 0.0,
    "high": 3e-4,
    "bf16": 2e-2,
    "bf16x2": 3e-4, "bf16x2c": 3e-4,
    "bf16x3": 2e-5, "bf16x3c": 2e-5,
    "int8x2": 4e-3,
    "int8x3": 9e-5,
    "int8x4": 2e-5,
}


#: the port's absolute p-value drift bound of the bf16 tiers on fractional
#: dosages (the float route, ops/rotate.py). TIER_P_DRIFT's bf16 values
#: hold for integer dosages, which bf16 holds exactly; a fractional dosage
#: rounds to bf16's 8 significant bits before any product, and that
#: rounding bounds every tier alike. Sized from the drift measured against
#: the exact tier (tests/test_torch_fractional.py, chip_smoke.py phase 17).
#: 'high' splits the dosages too (hi + lo: 16 significant bits), so it does
#: not round them to bf16: on the card, NVIDIA H100 80GB HBM3, 700.00 W,
#: phase 17 (a)'s imputed rows gave max |dp| 2.518e-5 against exact (bf16x3
#: 4.762e-3), and the entry is the rule's value (twice, one digit up).
#: Feeds the rescore cut of the float route and of 'high' on imputed rows.
FRACTIONAL_P_DRIFT = {
    "high": 6e-5,
    "bf16": 3e-2,
    "bf16x2": 2e-2, "bf16x2c": 2e-2,
    "bf16x3": 2e-2, "bf16x3c": 2e-2,
}


def tier_drift_name(rd, matmul_precision=None) -> str:
    """normalize_rotate_tier's result (+ matmul_precision, matmul_tier's
    'high') -> the TIER_P_DRIFT key of the active scan tier."""
    if isinstance(rd, str):
        return rd
    return matmul_precision or "exact"


def rescore_p_cut(M: int, tier, alpha: float = 0.05,
                  safety: float = 8.0, fractional: bool = False,
                  table=None) -> float:
    """Fast-tier p cut below which every SNP is exactly re-scored:
    alpha/M + safety * drift (unknown tiers take the worst drift).
    fractional: the bf16 tier ran on fractional dosages (the float route),
    whose drift is FRACTIONAL_P_DRIFT's. table: another drift table
    (GXE_P_DRIFT); default TIER_P_DRIFT."""
    if table is None:
        table = FRACTIONAL_P_DRIFT if fractional else TIER_P_DRIFT
    drift = table.get(str(tier), max(table.values()))
    return alpha / max(M, 1) + safety * drift


def select_rescore_idx(ps, rescore_top: int, tier,
                       alpha: float = 0.05, safety: float = 8.0,
                       M_cut: Optional[int] = None,
                       fractional: bool = False, table=None):
    """{all SNPs with p <= rescore_p_cut} ∪ {top rescore_top by p},
    uncapped (the JAX package's threshold-complete rescore contract).
    M_cut: the SNP count of the Bonferroni cut when ps covers only part of
    the study (a LOCO chromosome); default len(ps). fractional, table: see
    rescore_p_cut."""
    ps = np.asarray(ps)
    M = ps.shape[0] if M_cut is None else int(M_cut)
    k = min(int(rescore_top), ps.shape[0])
    cand = np.argsort(ps, kind="stable")[:k]
    near = np.flatnonzero(ps <= rescore_p_cut(M, tier, alpha, safety,
                                              fractional, table))
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
    - HIGH: the bf16x2 parts, (2, n, n): the 'high' tier's hi + lo split
      (split_high).

    Bit-equal to the JAX package's quantize_rotation
    (tests/test_torch_ops.py, tests/test_torch_bf16.py)."""
    if rotate_dtype is None:
        return W, None
    k = 2 if rotate_dtype == HIGH else bf16_parts_count(rotate_dtype)
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
    # a column below sd_dtype's smallest normal (all zero, or a folded
    # design column at rounding level) would get a scale that underflows
    # to 0: it takes the scale 2^-bits instead, and all-zero digits
    e = torch.where(colmax < torch.finfo(sd_dtype).tiny, 0, e)
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


def split_high(x: torch.Tensor) -> torch.Tensor:
    """The 'high' tier's split of a float (or int8) tensor: (2, *x.shape)
    bf16 (hi, lo), hi the round-to-nearest-even bf16 cast of x in float32,
    lo that of the float32 residual, subnormals flushed (quantize_rotation's
    bf16x2 rule, bit-equal to the JAX package's parts of a float32 x).
    hi + lo holds 16 of float32's 24 significant bits; an int8 dosage (or
    any integer up to 256 in magnitude) has lo = 0."""
    return quantize_rotation(x, HIGH)[0]


def apply_rotation_high(G_tile: torch.Tensor, parts: torch.Tensor, dt
                        ) -> torch.Tensor:
    """The 'high' tier's rotation in plain torch (the plain version of
    ops/rotate.py::rotate_high): G_tile split by split_high (int8 rows: lo
    = 0, its product skipped), parts = split_high(U'), then
    (G_hi U_lo + G_lo U_hi) + G_hi U_hi, each product on float64 copies of
    the bf16 values (a bf16 x bf16 product is exact in float64) rounded to
    dt, summed in dt in that order. The three passes of XLA's bf16_3x: the
    G_lo U_lo product is left out."""
    Uh, Ul = (p.to(torch.float64) for p in parts)
    if G_tile.dtype == torch.int8:
        Gh, Gl = G_tile.to(torch.float64), None
    else:
        Gh, Gl = (p.to(torch.float64) for p in split_high(G_tile))
    Xs = (Gh @ Ul).to(dt)
    if Gl is not None:
        Xs = Xs + (Gl @ Uh).to(dt)
    return Xs + (Gh @ Uh).to(dt)


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


def apply_rotation_psum(G_block: torch.Tensor, W_rows, w_scale, dt, mesh,
                        n_out: int) -> torch.Tensor:
    """Tensor-parallel apply_rotation (the JAX package's
    apply_rotation_psum): G_block (m, nb) holds a block of sample columns
    and W_rows the matching contraction rows of the rotation; the partial
    products are summed over the mesh's 'sample' axis (parallel/mesh.py::
    all_reduce), and every rank of the group gets the (m, n_out) rotated
    rows in dt.

    W_rows: (nb, n_out) U' rows (exact), (K, nb, n_out) int8 digit planes
    with their column scale w_scale, or (K, nb, n_out) bf16 parts; or the
    ops/rotate.py::rotation_rows of one of them, whose card layout is then
    prepared once. n_out is explicit, as in the JAX function: a
    row-sharded square W defeats a shape heuristic, and it is checked.

    int8: each plane's product in integers (ops/rotate.py::rotate_tile
    with its plane: int32 on the card, the exact float64 product of
    apply_rotation on the CPU), summed over 'sample' in those integers
    BEFORE the base-256 recombine and the scale in dt, in apply_rotation's
    order: bit-identical to one device's apply_rotation. bf16: the parts'
    products accumulated locally in float32 (float64 on the CPU), then
    summed. Exact: an fp32 GEMM with TF32 off, then summed. The float tiers
    match one device to the partial sums' rounding."""
    from mixmogam_tpu_torch.ops.rotate import (SharedRotation,
                                               rotate_tile, rotation_rows)
    from mixmogam_tpu_torch.parallel.mesh import all_reduce

    rot = (W_rows if isinstance(W_rows, SharedRotation)
           else rotation_rows(W_rows, w_scale, dt))
    if rot.W.shape[-1] != n_out or rot.W.shape[-2] != G_block.shape[1]:
        raise ValueError(f"apply_rotation_psum: a ({G_block.shape[1]}-"
                         f"column) block and W rows {tuple(rot.W.shape)} "
                         f"do not give {n_out} outputs")
    if rot.w_scale is None:
        return all_reduce(rotate_tile(G_block, rot), mesh, axis="sample")
    Xs = None
    for i in range(rot.W.shape[0]):
        A = all_reduce(rotate_tile(G_block, rot, plane=i), mesh,
                       axis="sample")
        term = A.to(dt) * (256.0 ** i)
        Xs = term if Xs is None else Xs + term
    return Xs * rot.w_scale[None, :].to(dt)


def build_rotated_null(null: NullModel, rotate_dtype=None,
                       matmul_precision=None) -> RotatedNull:
    """Scan constants of the null model, on the null's device and dtype.
    rotate_dtype: None (exact), a bf16 tier ('bf16', 'bf16x2', 'bf16x3',
    'bf16x2c', 'bf16x3c') or an int8 tier ('int8x2' / 'int8x3' /
    'int8x4'). The exact tier rotates by the projected U (project_design);
    the others quantize the folded W'' (fold_design), and take designs of
    up to DESIGN_QMAX columns. matmul_precision HIGH (matmul_tier's): the
    exact tier with the split of its projected U beside it (RotatedNull.
    high), which emmax_scan_stats then rotates by."""
    from mixmogam_tpu_torch.ops.eigen import orthonormal_basis

    phi, U, delta = null.phi, null.U, null.delta
    dt = U.dtype
    sd = 1.0 / torch.sqrt(phi + delta)
    # y and X0 whitened, Q0, y_res and rss0 in float64, rounded once to
    # the compute dtype: in float32 their own rounding alone moves the
    # exact scan's p by about 1e-6 under a singular K
    # (tests/test_torch_streaming.py)
    sd64 = sd.double()
    yX = torch.cat([null.y[None, :], null.X0.T]).double()
    yX_rot = torch.cat([yX @ U[:, j:j + 4_096].double()
                        for j in range(0, U.shape[1], 4_096)], dim=1)
    y_star = yX_rot[0] * sd64
    X0_star = yX_rot[1:].T * sd64[:, None]
    n, q = X0_star.shape
    if rotate_dtype is not None and q > DESIGN_QMAX:
        raise ValueError(f"the {rotate_dtype} tier takes null designs of up "
                         f"to {DESIGN_QMAX} columns; got {q}")
    Q0 = orthonormal_basis(X0_star)
    y_res = y_star - Q0 @ (Q0.T @ y_star)
    rss0 = (y_res @ y_res).to(dt)
    Q0, y_res = Q0.to(dt), y_res.to(dt)
    Ur = planes = w_scale = parts = None
    high = None
    if rotate_dtype is None:
        Ur, X0, X0p = project_design(U, null.X0)
        if matmul_precision == HIGH:
            high = split_high(Ur)
        elif matmul_precision is not None:
            raise ValueError(f"unknown matmul precision {matmul_precision!r}"
                             f"; the port runs {HIGH!r} or none")
    else:
        X0, X0p = design_basis(null.X0, U.device, U.dtype)
        W = fold_design(U, sd, null.X0)
        if bf16_parts_count(rotate_dtype):
            parts, _ = quantize_rotation(W, rotate_dtype)
        else:
            planes, w_scale = quantize_rotation(W, rotate_dtype,
                                                sd_dtype=sd.dtype)
    return RotatedNull(sd=sd, Q0=Q0, y_res=y_res, rss0=rss0,
                       dof=torch.tensor(n - q - 1, dtype=sd.dtype,
                                        device=sd.device),
                       U=Ur, planes=planes, w_scale=w_scale, parts=parts,
                       high=high, X0=X0, X0p=X0p,
                       folded=rotate_dtype is not None)


def design_basis(X0: torch.Tensor, device, dtype):
    """(X0, X0p) in dtype on device, with X0p = X0 (X0^T X0)^-1 solved in
    float64: the two factors of P_X0 = X0 X0p^T, the projection onto the
    null design's columns in sample space (project_design, outside_design)."""
    X = X0.to(device=device, dtype=torch.float64)
    if X.ndim == 1:
        X = X[:, None]
    Xp = torch.linalg.solve(X.T @ X, X.T).T
    return X.to(dtype), Xp.to(dtype)


def project_design(U: torch.Tensor, X0: torch.Tensor, block: int = 4_096):
    """((I - P_X0) U, X0, X0p) in U's dtype on U's device, with P_X0 =
    X0 X0p^T and X0p = X0 (X0^T X0)^-1 (design_basis); the product runs in
    float64, a block of U's columns at a time.

    A SNP row g and g - P_X0 g give the same F, beta and var_perc: the scan
    projects col(X0) out after whitening. Rotating by the projected U keeps
    that span out of the rotated rows. Where K is singular along a column
    of X0 (VanRaden's K along the intercept) and delta is small, that span
    would otherwise weigh 1/delta times the rest of the row, and a float32
    scan would lose the residual sum xx = ss - |Q0^T x|^2 to cancellation
    and mask the row."""
    X, Xp = design_basis(X0, U.device, torch.float64)
    Up = torch.empty_like(U)
    for j in range(0, U.shape[1], block):
        Ub = U[:, j:j + block].double()
        Up[:, j:j + block] = Ub - X @ (Xp.T @ Ub)
    return Up, X.to(U.dtype), Xp.to(U.dtype)


def fold_design(U: torch.Tensor, sd: torch.Tensor, X0: torch.Tensor,
                block: int = 4_096) -> torch.Tensor:
    """W'' = W (I - Q0 Q0^T) with W = U * sd, in float64 on U's device, a
    block of W's columns at a time; Q0 is the orthonormal basis of the
    whitened design W^T X0, taken in float64 too.

    A rotated row x = g W enters the scan through xy = x . y_res and
    xx = |(I - Q0 Q0^T) x|^2 only, and y_res is orthogonal to Q0: rotating
    by W'' gives both unchanged, with rows already orthogonal to Q0. The
    int8 / bf16 kernels then need no Q0 (RotatedNull.scan_q0), whatever the
    design's width, and their float32 row sum ss is xx itself: no
    cancellation where K is singular along X0 and delta small (VanRaden's
    K along the intercept, whitened by 1/sqrt(delta)). There W'' is W with
    that column zeroed, up to rounding. A row inside col(X0) becomes
    rounding noise: outside_design masks it."""
    from mixmogam_tpu_torch.ops.eigen import orthonormal_basis

    Ud, sdd = U.double(), sd.double()
    X = X0.to(device=U.device, dtype=torch.float64)
    if X.ndim == 1:
        X = X[:, None]
    Q = orthonormal_basis((X.T @ Ud).T * sdd[:, None])
    WQ = (Ud * sdd[None, :]) @ Q
    W = torch.empty_like(Ud)
    for j in range(0, W.shape[1], block):
        W[:, j:j + block] = (Ud[:, j:j + block] * sdd[None, j:j + block]
                             - WQ @ Q[j:j + block].T)
    return W


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


def outside_design_psum(G_block: torch.Tensor, X0_rows: torch.Tensor,
                        X0p_rows: torch.Tensor, mesh) -> torch.Tensor:
    """outside_design of whole rows held as blocks of sample columns
    (G_block, with the matching rows of X0 and X0p; zero where the block
    pads the sample axis), on every rank of the mesh's 'sample' group: G
    X0p summed over 'sample', then each block's |R_b|^2 and |g_b|^2 summed
    again (two small all-reduces)."""
    from mixmogam_tpu_torch.parallel.mesh import all_reduce

    fi = torch.finfo(G_block.dtype)
    GX = all_reduce(G_block @ X0p_rows, mesh, axis="sample")
    R = G_block - GX @ X0_rows.T
    rr, gg = all_reduce(torch.stack([(R * R).sum(dim=1),
                                     (G_block * G_block).sum(dim=1)]),
                        mesh, axis="sample")
    return rr > fi.eps * torch.clamp(gg, min=fi.tiny)


def scan_epilogue(Xs: torch.Tensor, Q0, y_res, rss0, dof
                  ) -> torch.Tensor:
    """F statistics from whitened SNP rows Xs (m, n) -> (4, m) rows
    [f, beta, var_perc, mask] in Xs's dtype (mask as 0/1). eps and tiny
    follow the compute dtype, as ops/scan.py's scan_epilogue does."""
    c = Xs @ Q0
    xy = Xs @ y_res
    ss = (Xs * Xs).sum(dim=1)
    return epilogue_from_sums(xy, ss, (c * c).sum(dim=1), rss0, dof)


def epilogue_from_sums(xy: torch.Tensor, ss: torch.Tensor, cc: torch.Tensor,
                       rss0, dof) -> torch.Tensor:
    """The GLS epilogue after a whitened row's sums: xy = x . y_res,
    ss = |x|^2 and cc = |Q0^T x|^2, each (m,) in the compute dtype, ->
    (4, m) [f, beta, var_perc, mask] (scan_epilogue's arithmetic after its
    sums; scan_epilogue_psum's after the sums meet over 'sample')."""
    dt = ss.dtype
    fi = torch.finfo(dt)
    xx = ss - cc
    eps = 100.0 * fi.eps
    mask = xx > eps * torch.clamp(ss, min=fi.tiny)
    rss0 = torch.as_tensor(rss0, dtype=dt, device=ss.device)
    dof = torch.as_tensor(dof, dtype=dt, device=ss.device)
    zero = torch.zeros((), dtype=dt, device=ss.device)
    xx_safe = torch.where(mask, xx, torch.ones((), dtype=dt,
                                               device=ss.device))
    expl = xy * xy / xx_safe
    expl = torch.where(mask, torch.minimum(expl, rss0), zero)
    rss1 = rss0 - expl
    rss1_safe = torch.clamp(rss1, min=fi.tiny)
    f = expl * dof / rss1_safe
    beta = torch.where(mask, xy / xx_safe, zero)
    var_perc = torch.where(mask, expl / rss0, zero)
    return torch.stack([torch.where(mask, f, zero), beta, var_perc,
                        mask.to(dt)])


def scan_epilogue_psum(X_block: torch.Tensor, sd_rows: torch.Tensor,
                       Q0_rows: torch.Tensor, y_res_rows: torch.Tensor, rss0,
                       dof, mesh, chunk: int = 16_384) -> torch.Tensor:
    """scan_stats_plain of whole rotated rows held as blocks of their
    columns (X_block (m, nb) with the matching entries of sd, Q0 and y_res;
    zero where the block pads the sample axis), on every rank of the
    mesh's 'sample' group: each block whitened by its sd and its partial
    sums x . Q0, x . y_res and |x|^2 formed (chunk rows at a time, so no
    whitened copy of the whole block is held), the (q + 2, m) sums summed
    over 'sample' in one all-reduce, then epilogue_from_sums."""
    from mixmogam_tpu_torch.parallel.mesh import all_reduce

    q = Q0_rows.shape[1]
    sums = torch.empty((q + 2, X_block.shape[0]), dtype=X_block.dtype,
                       device=X_block.device)
    for s in range(0, X_block.shape[0], chunk):
        Xs = X_block[s:s + chunk] * sd_rows[None, :]
        sums[:q, s:s + chunk] = (Xs @ Q0_rows).T
        sums[q, s:s + chunk] = Xs @ y_res_rows
        sums[q + 1, s:s + chunk] = (Xs * Xs).sum(dim=1)
    sums = all_reduce(sums, mesh, axis="sample")
    c = sums[:q].T
    return epilogue_from_sums(sums[q], sums[q + 1], (c * c).sum(dim=1),
                              rss0, dof)


def emmax_scan_stats(G_tile: torch.Tensor, rot: RotatedNull
                     ) -> torch.Tensor:
    """(4, m) [f, beta, var_perc, mask] for one tile of dosage rows (int8,
    or mean-imputed floats) at the exact tier: Xr = G_tile @ U (full fp32
    GEMM on the card, TF32 off; with rot.high the 'high' tier's three bf16
    passes, ops/rotate.py::rotate_high), then scan_stats (kernel K3 on
    CUDA); the rows inside the null design's span come out masked
    (outside_design)."""
    from mixmogam_tpu_torch.ops import assert_fp32_matmuls
    from mixmogam_tpu_torch.ops.rotate import rotate_high

    if rot.U is None:
        raise ValueError("emmax_scan_stats runs the exact tier; int8 and "
                         "bf16 tiers scan packed rows (rotate_scan_int8_"
                         "packed / rotate_scan_bf16_packed)")
    assert_fp32_matmuls()
    Xr = (apply_rotation(G_tile, rot.U, None, rot.U.dtype)
          if rot.high is None else rotate_high(G_tile, rot.high, rot.U.dtype))
    keep = (None if rot.X0p is None else
            outside_design(G_tile.to(rot.X0p.dtype), rot.X0, rot.X0p))
    return emmax_scan_prerotated(Xr, rot, keep)


def emmax_scan_prerotated(Xr: torch.Tensor, rot: RotatedNull, keep=None
                          ) -> torch.Tensor:
    """(4, m) stats of pre-rotated rows Xr = G @ U (or the imputed dosages
    themselves where K is the identity), all m rows in one launch of
    scan_stats (kernel K3 on CUDA; no tile padding). keep: (m,) bool from
    outside_design when U was projected; the other rows come out masked."""
    from mixmogam_tpu_torch.ops.hopper_scan import k3_operand, scan_stats

    # K3's operand, prepared once per rotated null and kept with it
    op = k3_operand(rot) if Xr.device.type == "cuda" else None
    out = scan_stats(Xr, rot.sd, rot.y_res, rot.Q0, rot.rss0, rot.dof,
                     operand=op)
    # the rows inside X0's span: every output zeroed, the mask included
    # (a where, not a product: such a row's f may be inf)
    return out if keep is None else torch.where(keep[None, :], out, 0.0)


def stats_dict(out: torch.Tensor) -> Dict[str, np.ndarray]:
    """(4, m) kernel output -> the JAX package's per-row dict (host)."""
    h = out.detach().cpu().double().numpy()
    return {"f_stats": h[0], "betas": h[1], "var_perc": h[2],
            "mask": h[3] > 0.5}
