"""The scan kernels and their plain PyTorch versions.

K2 rotate_scan_int8_packed (csrc/rotate_scan_int8.cu) replaces the TPU
kernel mixmogam_tpu/ops/pallas_scan.py pallas_rotate_scan_int8: int8
digit-plane rotate + GLS F epilogue, reading the 2-bit packed rows
directly. K5 rotate_scan_bf16_packed (csrc/rotate_scan_bf16.cu) replaces
pallas_rotate_scan: the split-W bf16 rotate + the same epilogue, also on
the packed rows, for the 'bf16' / 'bf16x2' / 'bf16x3' tiers. K3 scan_stats
(csrc/scan_stats.cu) replaces pallas_scan_stats: whiten + GLS F epilogue
over pre-rotated rows; it serves the exact tier after the fp32 G @ U
GEMM, and the exact rescore.

K2 and K5 (wgmma; csrc/rotate_scan_tile.cuh is their shared part) read W
as prepared stage images: scan_operand(rot) builds them once per
RotatedNull and keeps them with it; a call with bare planes / parts
prepares them on the spot.

All return (4, rows) [f, beta, var_perc, mask (0/1)]. A CUDA tensor
launches the kernel (float32 only) or raises; a CPU tensor takes the
plain version, which runs in the inputs' dtype.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from mixmogam_tpu_torch.ops.pack2 import unpack_2bit_device
from mixmogam_tpu_torch.ops.scan import apply_rotation, scan_epilogue

#: Q0 columns K2 and K5 take (their shared wgmma epilogue keeps each
#: row's q sums in shared slots of this width; the entry points pass none:
#: the design is folded into their W); K3 takes up to the TPU kernel's
#: QPAD, 128
_QMAX = 16
_K3_QMAX = 128


def _as_float(x) -> float:
    return float(x.item() if isinstance(x, torch.Tensor) else x)


def _check_cuda_f32(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be a float32 CUDA "
                             f"tensor; got {t.dtype} on {t.device}")


# ---------------------------------------------------------------------------
# The kernel-ready W operand of K2 and K5
# ---------------------------------------------------------------------------

def _stage_perm(kind: str) -> torch.Tensor:
    """perm[L] = the physical sample, inside a K stage of the packed row,
    that sits at the tensor cores' logical contraction position L. The
    kernels decode a thread's A fragment registers from consecutive bytes
    of the raw packed row, so the stage images of W hold their in-axis in
    this order (csrc/rotate_scan_tile.cuh).

    'int8': a stage is 128 samples = 4 k-steps of 32; position
    32 ks + 16 h + 4 t + i (thread-in-quad t, half h) is sample
    32 t + 8 ks + 4 h + i: the thread's bytes 8 t .. 8 t + 7 of the row.
    'bf16': a stage is 64 samples = 4 k-steps of 16; a thread's four k of
    a step are {2t, 2t+1, 2t+8, 2t+9}, so position 16 ks + l is sample
    16 t + 4 ks + i with t = (l % 8) // 2, i = l % 2 + 2 * (l // 8): byte
    ks of the thread's word 4 t .. 4 t + 3."""
    if kind == "int8":
        L = torch.arange(128)
        ks, l = L // 32, L % 32
        return 32 * ((l % 16) // 4) + 8 * ks + 4 * (l // 16) + l % 4
    L = torch.arange(64)
    ks, l = L // 16, L % 16
    return 16 * ((l % 8) // 2) + 4 * ks + l % 2 + 2 * (l // 8)


@dataclasses.dataclass
class ScanOperand:
    """What K2 / K5 read besides the packed rows, built once per rotated
    null: W as the shared-memory image of every (column step, K stage),
    and the column vectors padded to the step."""

    kind: str                 # 'int8' or 'bf16'
    n: int
    K: int                    # planes or parts
    cn: int                   # output columns a step
    ks: int                   # samples a stage
    w_img: torch.Tensor       # int8: (steps, stages, ks/16, K, cn, 16)
    #                           bf16: (steps, stages, K, ks/8, cn, 8)
    y_res: torch.Tensor       # (steps * cn,) f32
    q0t: torch.Tensor         # (q, steps * cn) f32
    w_scale: Optional[torch.Tensor] = None   # (steps * cn,) f32, int8 only
    source: tuple = ()        # _source_key of the tensors it was built from

    @property
    def n_steps(self) -> int:
        return self.w_img.shape[0]

    @property
    def n_stages(self) -> int:
        return self.w_img.shape[1]


def _source_key(*tensors) -> tuple:
    """Which tensors, in which state: address and in-place version of each
    (None for an absent one; a Python number stands for itself)."""
    return tuple(None if t is None else (t.data_ptr(), t._version)
                 if isinstance(t, torch.Tensor) else float(t)
                 for t in tensors)


def _prepare_operand(kind: str, W: torch.Tensor, n: int, y_res, Q0,
                     w_scale=None) -> ScanOperand:
    K = W.shape[0]
    cn, ks, kb = (192 // K, 128, 16) if kind == "int8" else (64, 64, 8)
    steps, stages = -(-n // cn), -(-n // ks)
    dev = W.device
    wt = torch.zeros((K, steps * cn, stages * ks), dtype=W.dtype, device=dev)
    wt[:, :n, :n] = W.transpose(1, 2)               # [p][out][in]
    wt = wt.view(K, steps, cn, stages, ks)[..., _stage_perm(kind).to(dev)]
    wt = wt.view(K, steps, cn, stages, ks // kb, kb)
    order = (1, 3, 4, 0, 2, 5) if kind == "int8" else (1, 3, 0, 4, 2, 5)
    img = wt.permute(*order).contiguous()

    def pad(v):
        o = torch.zeros(v.shape[:-1] + (steps * cn,), dtype=torch.float32,
                        device=dev)
        o[..., :n] = v
        return o

    return ScanOperand(kind=kind, n=n, K=K, cn=cn, ks=ks, w_img=img,
                       y_res=pad(y_res), q0t=pad(Q0.t()),
                       w_scale=None if w_scale is None else pad(w_scale),
                       source=_source_key(W, y_res, Q0, w_scale))


def prepare_int8_operand(planes, w_scale, y_res, Q0) -> ScanOperand:
    """K2's operand from the (K, n, n) int8 digit planes: the K planes of
    a column step side by side (192 / K columns each), 128 samples a
    stage; pad entries zero."""
    return _prepare_operand("int8", planes, planes.shape[1], y_res, Q0,
                            w_scale)


def prepare_bf16_operand(parts, y_res, Q0) -> ScanOperand:
    """K5's operand from the (K, n, n) bf16 parts: 64 columns a step, one
    64-sample chunk of every part a stage; pad entries zero."""
    return _prepare_operand("bf16", parts, parts.shape[1], y_res, Q0)


def operand_dense(op: ScanOperand) -> torch.Tensor:
    """Undo the stage images: (K, steps * cn, stages * ks) [p][out][in],
    whose [:, :n, :n] corner is the planes / parts transposed and whose
    other entries are zero."""
    order = (3, 0, 4, 1, 2, 5) if op.kind == "int8" else (2, 0, 4, 1, 3, 5)
    wt = op.w_img.permute(*order).reshape(
        op.K, op.n_steps, op.cn, op.n_stages, op.ks)
    out = torch.empty_like(wt)
    out[..., _stage_perm(op.kind).to(wt.device)] = wt
    return out.reshape(op.K, op.n_steps * op.cn, op.n_stages * op.ks)


def scan_operand(rot) -> Optional[ScanOperand]:
    """The K2 / K5 operand of a RotatedNull, built at first use and kept
    with it (built again if rot's tensors were replaced or written to
    since); None for the exact tier. (The plain versions read planes /
    parts as they are: on the CPU nothing asks for it.)"""
    if rot.planes is None and rot.parts is None:
        return None
    W = rot.planes if rot.planes is not None else rot.parts
    q0 = rot.scan_q0
    key = _source_key(W, rot.y_res, q0,
                      rot.w_scale if rot.planes is not None else None)
    if rot.operand is None or rot.operand.source != key:
        if rot.planes is not None:
            rot.operand = prepare_int8_operand(rot.planes, rot.w_scale,
                                               rot.y_res, q0)
        else:
            rot.operand = prepare_bf16_operand(rot.parts, rot.y_res, q0)
        scan_operand.builds += 1
    return rot.operand


scan_operand.builds = 0


def _check_q0(what: str, Q0: torch.Tensor, n: int) -> None:
    """K2 / K5 take Q0 (n, q <= 16): their wgmma epilogue keeps a row's q
    sums in shared slots of that width. The entry points give them none
    (q = 0: the folded W'' of ops/scan.py fold_design), whatever the
    design's width; with q = 0 the kernel reads no Q0, and the empty
    operand's pointer may be null."""
    if Q0.ndim != 2 or Q0.shape[0] != n or Q0.shape[1] > _QMAX:
        raise ValueError(f"{what}: Q0 must be (n, q <= {_QMAX}); got "
                         f"{tuple(Q0.shape)}")


def _check_packed(what: str, packed: torch.Tensor, n: int) -> None:
    rb = (n + 3) // 4
    if (packed.dtype != torch.uint8 or packed.ndim != 2
            or packed.shape[1] != rb or not packed.is_contiguous()
            or packed.shape[0] == 0):
        raise ValueError(f"{what} needs a contiguous uint8 (M_pad > 0, {rb}) "
                         f"tensor; got {packed.dtype} {tuple(packed.shape)}")


def _check_operand(what: str, op: ScanOperand, kind: str, W, y_res, Q0,
                   w_scale=None) -> None:
    """The kernel reads W, y_res, Q0 and w_scale from the operand, not from
    the wrapper's arguments: they must be the tensors it was built from."""
    if op.kind != kind or op.source != _source_key(W, y_res, Q0, w_scale):
        raise ValueError(f"{what}: the prepared operand ({op.kind}, n="
                         f"{op.n}, K={op.K}, q={op.q0t.shape[0]}, "
                         f"{op.w_img.device}) does not belong to these "
                         f"arguments")


def launch_rotate_scan(fn, packed: torch.Tensor, op: ScanOperand, rss0, dof,
                       row_mean=None) -> torch.Tensor:
    """Launch K2 / K5 through their C entry `fn` (one argument list for
    both) on checked arguments; allocates the (4, rows) output."""
    from mixmogam_tpu_torch.ops._build import check_launch

    dev, rows, q = packed.device, packed.shape[0], op.q0t.shape[0]
    out = torch.empty((4, rows), dtype=torch.float32, device=dev)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.restype = ci
    fn.argtypes = [vp, ctypes.c_longlong, ci, ci, vp, ci, ci, vp, vp, vp,
                   ci, vp, cf, cf, vp, vp]
    rc = fn(packed.data_ptr(), rows, packed.shape[1], op.K,
            op.w_img.data_ptr(), op.n_steps, op.n_stages,
            None if op.w_scale is None else op.w_scale.data_ptr(),
            op.y_res.data_ptr(), op.q0t.data_ptr(), q,
            None if row_mean is None else row_mean.data_ptr(),
            _as_float(rss0), _as_float(dof), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, fn.__name__)
    return out


# ---------------------------------------------------------------------------
# K2: int8 digit-plane rotate + scan over packed rows
# ---------------------------------------------------------------------------

def rotate_scan_int8_packed_plain(packed, n, planes, w_scale, y_res, Q0,
                                  rss0, dof, chunk: int = 16_384
                                  ) -> torch.Tensor:
    """ops/scan.py apply_rotation (int8 planes, exact float64 plane
    products) + scan_epilogue, in w_scale's dtype."""
    outs = []
    for r0 in range(0, packed.shape[0], chunk):
        G = unpack_2bit_device(packed[r0:r0 + chunk], n)
        Xs = apply_rotation(G, planes, w_scale, w_scale.dtype)
        outs.append(scan_epilogue(Xs, Q0, y_res, rss0, dof))
    return torch.cat(outs, dim=1)


def rotate_scan_int8_packed(packed: torch.Tensor, n: int,
                            planes: torch.Tensor, w_scale: torch.Tensor,
                            y_res: torch.Tensor, Q0: torch.Tensor, rss0,
                            dof, operand: Optional[ScanOperand] = None
                            ) -> torch.Tensor:
    """(4, M_pad) scan of every packed row at the int8xK tier (K2).
    operand: scan_operand(rot) of the RotatedNull the other arguments come
    from; without it the operand is prepared here, at every call."""
    if packed.device.type == "cpu":
        return rotate_scan_int8_packed_plain(packed, n, planes, w_scale,
                                             y_res, Q0, rss0, dof)
    if packed.device.type != "cuda":
        raise ValueError(f"rotate_scan_int8_packed: unsupported device "
                         f"{packed.device}")
    _check_packed("rotate_scan_int8_packed", packed, n)
    K = planes.shape[0]
    if (planes.dtype != torch.int8 or planes.device != packed.device
            or tuple(planes.shape) != (K, n, n) or K not in (2, 3, 4)):
        raise ValueError(f"rotate_scan_int8_packed needs int8 planes "
                         f"(K in 2..4, {n}, {n}) on {packed.device}; got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    _check_q0("rotate_scan_int8_packed", Q0, n)
    _check_cuda_f32("rotate_scan_int8_packed", w_scale=w_scale,
                    y_res=y_res, Q0=Q0)
    from mixmogam_tpu_torch.ops._build import build

    if operand is None:
        operand = prepare_int8_operand(planes, w_scale, y_res, Q0)
    _check_operand("rotate_scan_int8_packed", operand, "int8", planes,
                   y_res, Q0, w_scale)
    out = launch_rotate_scan(build("rotate_scan_int8").rotate_scan_int8_packed,
                             packed, operand, rss0, dof)
    rotate_scan_int8_packed.launches += 1
    return out


rotate_scan_int8_packed.launches = 0


# ---------------------------------------------------------------------------
# K5: split-W bf16 rotate + scan over packed rows
# ---------------------------------------------------------------------------

def rotate_scan_bf16_packed_plain(packed, n, parts, y_res, Q0, rss0, dof,
                                  row_mean=None, chunk: int = 16_384
                                  ) -> torch.Tensor:
    """Unpack -> missing codes to the row mean (row_mean given) or 0 ->
    ops/scan.py apply_rotation (bf16 parts; exact float64 products) ->
    scan_epilogue, in y_res's dtype."""
    dt = y_res.dtype
    outs = []
    for r0 in range(0, packed.shape[0], chunk):
        G = unpack_2bit_device(packed[r0:r0 + chunk], n)
        if row_mean is None:
            Gf = G.clamp(min=0).to(dt)
        else:
            mu = row_mean[r0:r0 + chunk].to(dt)[:, None]
            Gf = torch.where(G < 0, mu, G.to(dt))
        Xs = apply_rotation(Gf, parts, None, dt)
        outs.append(scan_epilogue(Xs, Q0, y_res, rss0, dof))
    return torch.cat(outs, dim=1)


def rotate_scan_bf16_packed(packed: torch.Tensor, n: int,
                            parts: torch.Tensor, y_res: torch.Tensor,
                            Q0: torch.Tensor, rss0, dof,
                            row_mean: torch.Tensor = None,
                            operand: Optional[ScanOperand] = None
                            ) -> torch.Tensor:
    """(4, M_pad) scan of every packed row at a bf16 tier (K5). parts:
    (K in 1..3, n, n) bf16 split-W parts of W (RotatedNull). row_mean:
    (M_pad,) per-row means that replace missing genotypes (rounded to bf16,
    as the cast after _impute_tile gives); None for a fully observed
    genome.
    operand: scan_operand(rot) of the RotatedNull the other arguments come
    from; without it the operand is prepared here, at every call."""
    if packed.device.type == "cpu":
        return rotate_scan_bf16_packed_plain(packed, n, parts, y_res, Q0,
                                             rss0, dof, row_mean)
    if packed.device.type != "cuda":
        raise ValueError(f"rotate_scan_bf16_packed: unsupported device "
                         f"{packed.device}")
    _check_packed("rotate_scan_bf16_packed", packed, n)
    K = parts.shape[0]
    if (parts.dtype != torch.bfloat16 or parts.device != packed.device
            or tuple(parts.shape) != (K, n, n) or K not in (1, 2, 3)):
        raise ValueError(f"rotate_scan_bf16_packed needs bf16 parts "
                         f"(K in 1..3, {n}, {n}) on {packed.device}; got "
                         f"{parts.dtype} {tuple(parts.shape)}")
    _check_q0("rotate_scan_bf16_packed", Q0, n)
    rows = packed.shape[0]
    _check_cuda_f32("rotate_scan_bf16_packed", y_res=y_res, Q0=Q0)
    if row_mean is not None:
        _check_cuda_f32("rotate_scan_bf16_packed", row_mean=row_mean)
        if row_mean.shape != (rows,):
            raise ValueError(f"rotate_scan_bf16_packed: row_mean must be "
                             f"({rows},); got {tuple(row_mean.shape)}")
        row_mean = row_mean.contiguous()
    from mixmogam_tpu_torch.ops._build import build

    if operand is None:
        operand = prepare_bf16_operand(parts, y_res, Q0)
    _check_operand("rotate_scan_bf16_packed", operand, "bf16", parts, y_res,
                   Q0)
    out = launch_rotate_scan(build("rotate_scan_bf16").rotate_scan_bf16_packed,
                             packed, operand, rss0, dof, row_mean)
    rotate_scan_bf16_packed.launches += 1
    return out


rotate_scan_bf16_packed.launches = 0


# ---------------------------------------------------------------------------
# K3: whiten + scan over pre-rotated rows
# ---------------------------------------------------------------------------

def scan_stats_plain(Xr, sd, y_res, Q0, rss0, dof) -> torch.Tensor:
    """ops/scan.py emmax_scan_stats(pre_rotated=True) in plain torch."""
    return scan_epilogue(Xr * sd[None, :], Q0, y_res, rss0, dof)


#: K3's width classes of Q0 (csrc/scan_stats.cu): Q0 is padded to the
#: least that holds its columns
_K3_WIDTHS = (8, 16, 32, 64, 96, 128)
_K3_NPAD = 256                  # n is padded to a multiple (K3's stages)
#: up to this width class K3 reads Q0's slice of a stage (256 rows) column
#: by column (csrc/scan_stats.cu, DIRECT)
_K3_DIRECT = (16, 256)


@dataclasses.dataclass
class K3Operand:
    """What K3 reads besides the rotated rows, built once per whitened
    null: Q0 (n_pad, qw), then sd and y_res (n_pad,), in one zero-padded
    block (Q0 in a stage's column order up to the direct widths), and rss0
    and dof as host numbers, read once."""

    n: int
    q: int
    qw: int                   # K3's width class of Q0
    n_pad: int
    buf: torch.Tensor         # (n_pad * (qw + 2),) f32
    rss0: float
    dof: float
    source: tuple = ()        # _source_key(sd, y_res, Q0, rss0, dof)

    @property
    def q0(self) -> torch.Tensor:
        return self.buf[:self.n_pad * self.qw]

    @property
    def sd(self) -> torch.Tensor:
        return self.buf[self.n_pad * self.qw:self.n_pad * (self.qw + 1)]

    @property
    def y_res(self) -> torch.Tensor:
        return self.buf[self.n_pad * (self.qw + 1):]


def prepare_k3_operand(sd: torch.Tensor, y_res: torch.Tensor,
                       Q0: torch.Tensor, rss0, dof) -> K3Operand:
    """K3's operand from one null's sd, y_res (n,), Q0 (n, 1 <= q <= 128)
    and rss0, dof: float32 CUDA tensors, checked here."""
    _check_cuda_f32("scan_stats", sd=sd, y_res=y_res, Q0=Q0)
    n = sd.shape[0] if sd.ndim == 1 else -1
    if (n < 1 or y_res.shape != (n,) or Q0.ndim != 2 or Q0.shape[0] != n
            or not 1 <= Q0.shape[1] <= _K3_QMAX):
        raise ValueError(f"scan_stats: sd/y_res must be (n,) and Q0 "
                         f"(n, q <= {_K3_QMAX}); got {tuple(sd.shape)}, "
                         f"{tuple(y_res.shape)}, {tuple(Q0.shape)}")
    q = Q0.shape[1]
    qw = next(w for w in _K3_WIDTHS if w >= q)
    n_pad = -(-n // _K3_NPAD) * _K3_NPAD
    buf = torch.zeros(n_pad * (qw + 2), dtype=torch.float32,
                      device=sd.device)
    q0 = buf[:n_pad * qw].view(n_pad, qw)
    if qw <= _K3_DIRECT[0]:
        # the narrow classes read a stage's slice column by column
        kc = _K3_DIRECT[1]
        qp = torch.zeros((n_pad, qw), dtype=torch.float32, device=sd.device)
        qp[:n, :q] = Q0
        q0.view(n_pad // kc, qw, kc).copy_(
            qp.view(n_pad // kc, kc, qw).transpose(1, 2))
    else:
        q0[:n, :q] = Q0
    sdp, yp = buf[n_pad * qw:].view(2, n_pad)
    sdp[:n] = sd
    yp[:n] = y_res
    return K3Operand(n=n, q=q, qw=qw, n_pad=n_pad, buf=buf,
                     rss0=_as_float(rss0), dof=_as_float(dof),
                     source=_source_key(sd, y_res, Q0, rss0, dof))


def k3_operand(rot) -> K3Operand:
    """The K3 operand of a RotatedNull (its sd, y_res, Q0, rss0, dof),
    built at first use and kept with it (built again if those were
    replaced or written to since): the exact tier, stepwise and each
    trait of a multi-trait scan launch K3 once per tile on it."""
    key = _source_key(rot.sd, rot.y_res, rot.Q0, rot.rss0, rot.dof)
    if rot.k3 is None or rot.k3.source != key:
        rot.k3 = prepare_k3_operand(rot.sd, rot.y_res, rot.Q0, rot.rss0,
                                    rot.dof)
        k3_operand.builds += 1
    return rot.k3


k3_operand.builds = 0


def scan_stats(Xr: torch.Tensor, sd: torch.Tensor, y_res: torch.Tensor,
               Q0: torch.Tensor, rss0, dof,
               operand: Optional[K3Operand] = None) -> torch.Tensor:
    """(4, m) scan of pre-rotated rows Xr = G @ U (K3); Q0 (n, 1 <= q <=
    128), as the TPU kernel's QPAD. Xr may have any row pitch (stride(0)
    >= n, stride(1) = 1): the kernel takes rows whose pitch or start is no
    multiple of 16 bytes by narrower copies. A wider Q0 on the card
    raises. operand: k3_operand(rot) of the RotatedNull the other
    arguments come from; without it the operand is prepared here, at
    every call (a zero-filled block and two reads of rss0 and dof to the
    host)."""
    if Xr.device.type == "cpu":
        return scan_stats_plain(Xr, sd, y_res, Q0, rss0, dof)
    if Xr.device.type != "cuda":
        raise ValueError(f"scan_stats: unsupported device {Xr.device}")
    _check_cuda_f32("scan_stats", Xr=Xr)
    if (Xr.ndim != 2 or Xr.shape[0] == 0 or Xr.stride(1) != 1
            or Xr.stride(0) < Xr.shape[1]):
        raise ValueError(f"scan_stats needs an (m > 0, n) Xr with unit "
                         f"column stride; got {tuple(Xr.shape)} strides "
                         f"{Xr.stride()}")
    m, n = Xr.shape
    if operand is None:
        operand = prepare_k3_operand(sd, y_res, Q0, rss0, dof)
    elif operand.source != _source_key(sd, y_res, Q0, rss0, dof):
        raise ValueError(f"scan_stats: the prepared operand (n={operand.n}, "
                         f"q={operand.q}) does not belong to these "
                         f"arguments")
    if operand.n != n or operand.buf.device != Xr.device:
        raise ValueError(f"scan_stats: Xr is {tuple(Xr.shape)} on "
                         f"{Xr.device}; the operand is for n={operand.n} on "
                         f"{operand.buf.device}")
    from mixmogam_tpu_torch.ops._build import build, check_launch

    out = torch.empty((4, m), dtype=torch.float32, device=Xr.device)
    fn = build("scan_stats").scan_stats
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                   ctypes.c_void_p]
    rc = fn(Xr.data_ptr(), m, n, Xr.stride(0), operand.sd.data_ptr(),
            operand.y_res.data_ptr(), operand.q0.data_ptr(), operand.qw,
            operand.n_pad, operand.rss0, operand.dof, out.data_ptr(),
            torch.cuda.current_stream(Xr.device).cuda_stream)
    check_launch(rc, "scan_stats")
    scan_stats.launches += 1
    return out


scan_stats.launches = 0
