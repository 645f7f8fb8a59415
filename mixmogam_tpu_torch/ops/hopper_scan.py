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

All return (4, rows) [f, beta, var_perc, mask (0/1)]. A CUDA tensor
launches the kernel (float32 only) or raises; a CPU tensor takes the
plain version, which runs in the inputs' dtype.
"""

from __future__ import annotations

import ctypes

import torch

from mixmogam_tpu_torch.ops.pack2 import unpack_2bit_device
from mixmogam_tpu_torch.ops.scan import apply_rotation, scan_epilogue

_QMAX = 16
_TK = 64          # K2's and K5's contraction chunk and column step


def _as_float(x) -> float:
    return float(x.item() if isinstance(x, torch.Tensor) else x)


def _check_cuda_f32(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.dtype != torch.float32:
            raise ValueError(f"{what}: {name} must be a float32 CUDA "
                             f"tensor; got {t.dtype} on {t.device}")


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
                            dof) -> torch.Tensor:
    """(4, M_pad) scan of every packed row at the int8xK tier (K2)."""
    if packed.device.type == "cpu":
        return rotate_scan_int8_packed_plain(packed, n, planes, w_scale,
                                             y_res, Q0, rss0, dof)
    if packed.device.type != "cuda":
        raise ValueError(f"rotate_scan_int8_packed: unsupported device "
                         f"{packed.device}")
    rb = (n + 3) // 4
    if (packed.dtype != torch.uint8 or packed.ndim != 2
            or packed.shape[1] != rb or not packed.is_contiguous()):
        raise ValueError(f"rotate_scan_int8_packed needs a contiguous "
                         f"uint8 (M_pad, {rb}) tensor; got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    K = planes.shape[0]
    if (planes.dtype != torch.int8 or planes.device != packed.device
            or tuple(planes.shape) != (K, n, n) or K not in (2, 3, 4)):
        raise ValueError(f"rotate_scan_int8_packed needs int8 planes "
                         f"(K in 2..4, {n}, {n}) on {packed.device}; got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    if Q0.ndim != 2 or Q0.shape[0] != n or Q0.shape[1] > _QMAX:
        raise ValueError(f"rotate_scan_int8_packed: Q0 must be (n, q <= "
                         f"{_QMAX}); got {tuple(Q0.shape)}")
    _check_cuda_f32("rotate_scan_int8_packed", w_scale=w_scale,
                    y_res=y_res, Q0=Q0)
    from mixmogam_tpu_torch.ops._build import build, check_launch

    # pre-transpose the planes to (K, n_out, n_in) and zero-pad both
    # sample axes to the kernel's chunk: 4 consecutive inputs form one
    # mma B-fragment register, and pad columns contribute exact zeros
    n_pad = -(-n // _TK) * _TK
    dev = packed.device
    wt = torch.zeros((K, n_pad, n_pad), dtype=torch.int8, device=dev)
    wt[:, :n, :n] = planes.transpose(1, 2)
    q = Q0.shape[1]

    def pad1(v):
        o = torch.zeros(n_pad, dtype=torch.float32, device=dev)
        o[:n] = v
        return o

    ws, yr = pad1(w_scale), pad1(y_res)
    q0 = torch.zeros((n_pad, q), dtype=torch.float32, device=dev)
    q0[:n] = Q0
    rows = packed.shape[0]
    out = torch.empty((4, rows), dtype=torch.float32, device=dev)
    fn = build("rotate_scan_int8").rotate_scan_int8_packed
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p]
    rc = fn(packed.data_ptr(), rows, rb, n_pad, K, wt.data_ptr(),
            ws.data_ptr(), yr.data_ptr(), q0.data_ptr(), q,
            _as_float(rss0), _as_float(dof), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "rotate_scan_int8_packed")
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
                            row_mean: torch.Tensor = None) -> torch.Tensor:
    """(4, M_pad) scan of every packed row at a bf16 tier (K5). parts:
    (K in 1..3, n, n) bf16 split-W parts of W = U * sd. row_mean: (M_pad,)
    per-row means that replace missing genotypes (rounded to bf16, as the
    cast after _impute_tile gives); None for a fully observed genome."""
    if packed.device.type == "cpu":
        return rotate_scan_bf16_packed_plain(packed, n, parts, y_res, Q0,
                                             rss0, dof, row_mean)
    if packed.device.type != "cuda":
        raise ValueError(f"rotate_scan_bf16_packed: unsupported device "
                         f"{packed.device}")
    rb = (n + 3) // 4
    if (packed.dtype != torch.uint8 or packed.ndim != 2
            or packed.shape[1] != rb or not packed.is_contiguous()):
        raise ValueError(f"rotate_scan_bf16_packed needs a contiguous "
                         f"uint8 (M_pad, {rb}) tensor; got {packed.dtype} "
                         f"{tuple(packed.shape)}")
    K = parts.shape[0]
    if (parts.dtype != torch.bfloat16 or parts.device != packed.device
            or tuple(parts.shape) != (K, n, n) or K not in (1, 2, 3)):
        raise ValueError(f"rotate_scan_bf16_packed needs bf16 parts "
                         f"(K in 1..3, {n}, {n}) on {packed.device}; got "
                         f"{parts.dtype} {tuple(parts.shape)}")
    if Q0.ndim != 2 or Q0.shape[0] != n or Q0.shape[1] > _QMAX:
        raise ValueError(f"rotate_scan_bf16_packed: Q0 must be (n, q <= "
                         f"{_QMAX}); got {tuple(Q0.shape)}")
    rows = packed.shape[0]
    _check_cuda_f32("rotate_scan_bf16_packed", y_res=y_res, Q0=Q0)
    if row_mean is not None:
        _check_cuda_f32("rotate_scan_bf16_packed", row_mean=row_mean)
        if row_mean.shape != (rows,):
            raise ValueError(f"rotate_scan_bf16_packed: row_mean must be "
                             f"({rows},); got {tuple(row_mean.shape)}")
        row_mean = row_mean.contiguous()
    from mixmogam_tpu_torch.ops._build import build, check_launch

    # pre-transpose the parts to (K, n_out, n_in) and zero-pad both sample
    # axes to the kernel's chunk: 4 consecutive inputs form one mma
    # B-fragment pair, and pad columns contribute exact zeros
    n_pad = -(-n // _TK) * _TK
    dev = packed.device
    wt = torch.zeros((K, n_pad, n_pad), dtype=torch.bfloat16, device=dev)
    wt[:, :n, :n] = parts.transpose(1, 2)
    q = Q0.shape[1]
    yr = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    yr[:n] = y_res
    q0 = torch.zeros((n_pad, q), dtype=torch.float32, device=dev)
    q0[:n] = Q0
    out = torch.empty((4, rows), dtype=torch.float32, device=dev)
    fn = build("rotate_scan_bf16").rotate_scan_bf16_packed
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p]
    rc = fn(packed.data_ptr(), rows, rb, n_pad, K, wt.data_ptr(),
            yr.data_ptr(), q0.data_ptr(), q,
            None if row_mean is None else row_mean.data_ptr(),
            _as_float(rss0), _as_float(dof), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "rotate_scan_bf16_packed")
    rotate_scan_bf16_packed.launches += 1
    return out


rotate_scan_bf16_packed.launches = 0


# ---------------------------------------------------------------------------
# K3: whiten + scan over pre-rotated rows
# ---------------------------------------------------------------------------

def scan_stats_plain(Xr, sd, y_res, Q0, rss0, dof) -> torch.Tensor:
    """ops/scan.py emmax_scan_stats(pre_rotated=True) in plain torch."""
    return scan_epilogue(Xr * sd[None, :], Q0, y_res, rss0, dof)


def scan_stats(Xr: torch.Tensor, sd: torch.Tensor, y_res: torch.Tensor,
               Q0: torch.Tensor, rss0, dof) -> torch.Tensor:
    """(4, m) scan of pre-rotated rows Xr = G @ U (K3)."""
    if Xr.device.type == "cpu":
        return scan_stats_plain(Xr, sd, y_res, Q0, rss0, dof)
    if Xr.device.type != "cuda":
        raise ValueError(f"scan_stats: unsupported device {Xr.device}")
    _check_cuda_f32("scan_stats", Xr=Xr, sd=sd, y_res=y_res, Q0=Q0)
    if Xr.ndim != 2 or not Xr.is_contiguous():
        raise ValueError(f"scan_stats needs a contiguous (m, n) Xr; got "
                         f"{tuple(Xr.shape)}")
    m, n = Xr.shape
    if (sd.shape != (n,) or y_res.shape != (n,) or Q0.ndim != 2
            or Q0.shape[0] != n or not 1 <= Q0.shape[1] <= _QMAX):
        raise ValueError(f"scan_stats: sd/y_res must be ({n},) and Q0 "
                         f"({n}, q <= {_QMAX}); got {tuple(sd.shape)}, "
                         f"{tuple(y_res.shape)}, {tuple(Q0.shape)}")
    from mixmogam_tpu_torch.ops._build import build, check_launch

    q = Q0.shape[1]
    qp = 1 << (q - 1).bit_length()           # 1, 2, 4, 8 or 16
    q0 = torch.zeros((n, qp), dtype=torch.float32, device=Xr.device)
    q0[:, :q] = Q0
    out = torch.empty((4, m), dtype=torch.float32, device=Xr.device)
    fn = build("scan_stats").scan_stats
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_float, ctypes.c_float,
                   ctypes.c_void_p, ctypes.c_void_p]
    rc = fn(Xr.data_ptr(), m, n, sd.contiguous().data_ptr(),
            y_res.contiguous().data_ptr(), q0.data_ptr(), qp,
            _as_float(rss0), _as_float(dof), out.data_ptr(),
            torch.cuda.current_stream(Xr.device).cuda_stream)
    check_launch(rc, "scan_stats")
    scan_stats.launches += 1
    return out


scan_stats.launches = 0
