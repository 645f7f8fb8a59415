"""2-bit genotype rows: unpack on the tensor's device.

Codes 0/1/2 = dosage, 3 = missing (-1); sample k of a byte sits at bits
2k (native.pack_2bit). Column padding (n % 4 != 0) is code 3 and is
cropped here; the hand-written kernels unpack while loading instead."""

from __future__ import annotations

import torch


def unpack_2bit_device(packed: torch.Tensor, n: int) -> torch.Tensor:
    """(m, ceil(n/4)) uint8 -> (m, n) int8 with code 3 -> -1 (missing)."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=packed.device)
    codes = (packed[:, :, None] >> shifts) & 3               # (m, rb, 4)
    codes = codes.reshape(packed.shape[0], -1)[:, :n].to(torch.int8)
    return torch.where(codes == 3, torch.full_like(codes, -1), codes)
