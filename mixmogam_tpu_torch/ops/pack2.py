"""2-bit genotype rows: pack and unpack on the tensor's device.

Codes 0/1/2 = dosage, 3 = missing (-1); sample k of a byte sits at bits
2k, the byte layout of the JAX package's native.pack_2bit. Column padding
(n % 4 != 0) is code 3 and is cropped on unpacking; the hand-written
kernels unpack while loading instead."""

from __future__ import annotations

import torch


def pack_2bit_device(G: torch.Tensor) -> torch.Tensor:
    """(m, n) int8 dosages 0..2 (-1 = missing) -> (m, ceil(n/4)) uint8."""
    m, n = G.shape
    rb = (n + 3) // 4
    codes = torch.full((m, 4 * rb), 3, dtype=torch.uint8, device=G.device)
    codes[:, :n] = torch.where(G < 0, 3, G)
    c = codes.view(m, rb, 4)
    return c[:, :, 0] | c[:, :, 1] << 2 | c[:, :, 2] << 4 | c[:, :, 3] << 6


def unpack_2bit_device(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(m, ceil(n/4)) uint8 -> (m, n) int8 with code 3 -> -1 (missing)."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    codes = (packed[:, :, None] >> shifts) & 3               # (m, rb, 4)
    codes = codes.reshape(packed.shape[0], -1)[:, :n].to(torch.int8)
    return torch.where(codes == 3, torch.full_like(codes, -1), codes)
