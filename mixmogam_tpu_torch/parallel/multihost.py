"""Multi-process start-up and per-rank row loading (counterpart of
mixmogam_tpu/parallel/multihost.py).

Every rank runs the same program: it joins the group, loads only its SNP
rows (host_snp_range), wraps them as a SnpShard, and passes that to
distributed_kinship / distributed_emmax in place of the full matrix.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Tuple

import numpy as np


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None,
                         device=None) -> None:
    """torch.distributed.init_process_group for this rank; nothing for a
    single process. coordinator_address: 'host:port' (as tcp://host:port)
    or an init_method URL ('tcp://...', 'file://...'); default
    MASTER_ADDR:MASTER_PORT. num_processes / process_id default to
    WORLD_SIZE / RANK. backend: NCCL for a CUDA device (the default: the
    card), gloo for device='cpu' or when asked."""
    import torch
    import torch.distributed as dist

    from mixmogam_tpu_torch.parallel.mesh import rank_device

    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes == 1:
        return
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ['MASTER_PORT']}")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    if backend is None or backend == "nccl":
        device = (torch.device(device) if device is not None
                  else rank_device(process_id))
        if backend is None:
            backend = "nccl" if device.type == "cuda" else "gloo"
        if backend == "nccl":
            torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)


def host_snp_range(M: int, num_hosts: int, host_id: int,
                   tile: int = 256) -> Tuple[int, int]:
    """The half-open SNP row range host `host_id` should LOAD from disk.
    Ranges are tile-aligned so shard boundaries coincide with device tile
    boundaries (even splits; the last host takes the remainder)."""
    per = math.ceil(M / num_hosts / tile) * tile
    lo = min(host_id * per, M)
    hi = min(lo + per, M)
    return lo, hi


@dataclasses.dataclass(frozen=True)
class SnpShard:
    """A rank's own rows [lo, lo + len(rows)) of an M-row genotype matrix
    (int8 with -1 missing, or float dosages with NaN missing)."""

    rows: np.ndarray
    lo: int
    M: int

    @property
    def hi(self) -> int:
        return self.lo + self.rows.shape[0]


def make_global_snp_array(local_rows: np.ndarray, M: int, mesh) -> SnpShard:
    """This rank's rows of the (M, n) genotype matrix as the SnpShard that
    distributed_kinship / distributed_emmax take in place of the whole
    matrix: the rows must be the host_snp_range of the rank's 'snp'
    coordinate."""
    lo, hi = host_snp_range(M, mesh.shape[0], mesh.snp_index)
    local_rows = np.ascontiguousarray(local_rows)
    if local_rows.shape[0] != hi - lo:
        raise ValueError(f"rank {mesh.rank} holds {local_rows.shape[0]} "
                         f"rows; host_snp_range gives it [{lo}, {hi})")
    return SnpShard(local_rows, lo, int(M))
