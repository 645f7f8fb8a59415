"""The mesh over torch.distributed (counterpart of
mixmogam_tpu/parallel/mesh.py).

Axes as in the JAX package: 'snp' shards genotype rows across ranks (a
rank = a process = one device); 'sample', the tensor-parallel axis of the
(n, n) rotation, shards the rotation's contraction rows and the genotype
columns that meet them. Ranks lie row-major, as the JAX package reshapes
its devices: rank r sits at ('snp' r // S, 'sample' r % S) on a
(S_snp, S) mesh. The S ranks of one 'sample' group share a 'snp'
coordinate, so they hold the same SNP rows: their partial rotations are
summed in that group. The ranks of one 'snp' group share a 'sample'
coordinate: the per-row results are gathered there, so no shard is
gathered S times. One process that never called init_process_group is a
world of one with no collectives.

The JAX package's snp_sharding and replicated are GSPMD annotations: XLA
places each array and emits the collectives from them. torch has no such
annotation, so they have no counterpart. Genotype rows are sharded by
each rank taking its own rows (multihost.host_snp_range), the null is
replicated by broadcast_from_rank0 (put_global's role) and the results
meet in one gather_rows (gather_if_multiprocess's role).

Collectives run where the backend runs them: NCCL on the rank's card,
gloo on the host. A gloo group is handed host tensors, moved there
explicitly (comm_device): gloo's CUDA support differs between builds (the
card's torch 2.11 took CUDA tensors in all_reduce, broadcast and
all_gather, chip_smoke.py phase 18), and a host copy works on every one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A rank's view of the ('snp', 'sample') mesh: its shape, the process
    group and backend (None for a lone process), its rank and the world
    size, the rank's own device, and the sub-groups of its two axes
    (make_mesh builds them where both axes are above 1; where one axis is
    1, the other's group is the world's and needs no sub-group, so the
    positional form Mesh(shape, group, backend, rank, world, device)
    stays whole)."""

    shape: Tuple[int, int]
    group: Optional[object]
    backend: Optional[str]
    rank: int
    world: int
    device: torch.device
    #: the ranks that share this rank's 'snp' coordinate (its SNP rows)
    sample_group: Optional[object] = None
    #: the ranks that share this rank's 'sample' coordinate
    snp_group: Optional[object] = None

    @property
    def distributed(self) -> bool:
        """True when collectives run (an initialised process group, even a
        world of one)."""
        return self.backend is not None

    @property
    def snp_index(self) -> int:
        """This rank's 'snp' coordinate: the index of its SNP shard."""
        return self.rank // self.shape[1]

    @property
    def sample_index(self) -> int:
        """This rank's 'sample' coordinate: the index of its block of
        sample columns (and of the rotation's contraction rows)."""
        return self.rank % self.shape[1]

    def axis_group(self, axis: Optional[str]):
        """(runs, group) of the collectives over `axis`: None is the whole
        world; 'sample' the ranks of this rank's SNP rows; 'snp' the ranks
        of its sample block. runs is False where the axis holds this rank
        alone (or no process group exists): nothing to reduce."""
        if not self.distributed:
            return False, None
        if axis is None:
            return True, self.group
        if axis not in ("snp", "sample"):
            raise ValueError(f"no mesh axis {axis!r}: 'snp' or 'sample'")
        size, given = ((self.shape[1], self.sample_group) if axis == "sample"
                       else (self.shape[0], self.snp_group))
        if size == 1:
            return False, None
        if given is not None:
            return True, given
        if size == self.world:
            return True, self.group
        raise ValueError(f"this Mesh has no {axis!r} sub-group; build it "
                         "with make_mesh()")


def rank_device(rank: int) -> torch.device:
    """The card a rank runs on: cuda:LOCAL_RANK when the launcher set it
    (torchrun), else rank % device_count(). Without a card it raises, as
    ops.resolve_device does."""
    from mixmogam_tpu_torch.ops import resolve_device

    if not torch.cuda.is_available():
        return resolve_device(None)          # raises, naming device="cpu"
    local = os.environ.get("LOCAL_RANK")
    idx = int(local) if local is not None else rank % torch.cuda.device_count()
    return torch.device("cuda", idx)


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """The mesh of this process's group (torch.distributed's default group
    when one is initialised, else a world of one), shape default
    (world, 1); a shape (S_snp, S) must hold every rank. Where both axes
    are above 1, every rank creates every axis sub-group (dist.new_group),
    in one fixed order: the S_snp 'sample' groups, then the S 'snp'
    groups. devices: this rank's device ('cpu', 'cuda:1', ...), or a
    sequence of one device a rank indexed by rank; default the card of
    rank_device."""
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
        rank, world = dist.get_rank(group), dist.get_world_size(group)
        backend = str(dist.get_backend(group))
    else:
        group, rank, world, backend = None, 0, 1, None
    shape = (world, 1) if shape is None else tuple(int(s) for s in shape)
    if len(shape) != 2 or min(shape) < 1 or shape[0] * shape[1] != world:
        raise ValueError(f"mesh shape {shape} != {world} ranks "
                         "('snp', 'sample')")
    if devices is None:
        device = rank_device(rank)
    elif isinstance(devices, (str, torch.device)):
        device = torch.device(devices)
    else:
        devices = list(devices)
        if len(devices) != world:
            raise ValueError(f"{len(devices)} devices for {world} ranks")
        device = torch.device(devices[rank])
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL group needs a CUDA device; rank {rank} "
                         f"was given {device}")
    sample_group = snp_group = None
    if min(shape) > 1:
        n_snp, S = shape
        for i in range(n_snp):
            g = dist.new_group([i * S + j for j in range(S)])
            if i == rank // S:
                sample_group = g
        for j in range(S):
            g = dist.new_group([i * S + j for i in range(n_snp)])
            if j == rank % S:
                snp_group = g
    return Mesh(shape, group, backend, rank, world, device, sample_group,
                snp_group)


def comm_device(mesh: Mesh) -> torch.device:
    """Where the mesh's collectives take their tensors: the rank's card
    under NCCL, the host under gloo."""
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def _dense_order(t: torch.Tensor):
    """The dimension order in which t's memory is contiguous (a transposed
    matrix: (1, 0)), or None when no order is."""
    perm = sorted(range(t.dim()), key=lambda d: -t.stride(d))
    return perm if t.permute(perm).is_contiguous() else None


def broadcast_from_rank0(tensors: Optional[Dict[str, object]], mesh: Mesh
                         ) -> Dict[str, object]:
    """Rank 0's dict of tensors (None entries and Python scalars allowed)
    on every rank, each tensor on the rank's device with rank 0's memory
    layout (a column-major U stays column-major, so the GEMMs that read it
    take the same path, and round the same way, on every rank): the
    names, shapes, dtypes, layouts and scalars go as one object, then one
    broadcast a tensor. Other ranks may pass None. A world with no process
    group returns the dict as it is."""
    if not mesh.distributed:
        return dict(tensors)
    meta = [None]
    if mesh.rank == 0:
        meta = [{k: (("t", tuple(v.shape), v.dtype, _dense_order(v))
                     if isinstance(v, torch.Tensor) else ("v", v))
                 for k, v in tensors.items()}]
    cdev = comm_device(mesh)
    dist.broadcast_object_list(meta, src=0, group=mesh.group,
                               device=cdev if cdev.type == "cuda" else None)
    out = {}
    for k, (kind, *rest) in meta[0].items():
        if kind == "v":
            out[k] = rest[0]
            continue
        shape, dtype, perm = rest
        perm = list(range(len(shape))) if perm is None else perm
        if mesh.rank == 0:
            buf = tensors[k].permute(perm).to(cdev).contiguous()
        else:
            buf = torch.empty([shape[d] for d in perm], dtype=dtype,
                              device=cdev)
        dist.broadcast(buf, src=0, group=mesh.group)
        # the inverse permutation: a view with rank 0's strides
        out[k] = buf.permute(np.argsort(perm).tolist()).to(mesh.device)
    return out


def gather_rows(block: torch.Tensor, mesh: Mesh, axis: Optional[str] = "snp"
                ) -> torch.Tensor:
    """The run's one all-gather: each rank's (..., m_rank) block of
    per-row results, concatenated along the last axis in the order of the
    ranks of `axis` (default 'snp': every SNP shard once, from the ranks of
    this rank's sample block; None: the whole world) on every rank (on the
    rank's device). Sizes may differ: the sizes are gathered first, each
    block padded to the largest, gathered, trimmed."""
    runs, group = mesh.axis_group(axis)
    if not runs:
        return block
    size = dist.get_world_size(group)
    cdev = comm_device(mesh)
    m = torch.tensor([block.shape[-1]], dtype=torch.int64, device=cdev)
    sizes = [torch.empty_like(m) for _ in range(size)]
    dist.all_gather(sizes, m, group=group)
    sizes = [int(s) for s in sizes]
    width = max(sizes)
    pad = torch.zeros(block.shape[:-1] + (width,), dtype=block.dtype,
                      device=cdev)
    pad[..., :block.shape[-1]] = block.to(cdev)
    parts = [torch.empty_like(pad) for _ in range(size)]
    dist.all_gather(parts, pad, group=group)
    return torch.cat([p[..., :s] for p, s in zip(parts, sizes)],
                     dim=-1).to(mesh.device)


def all_reduce(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM,
               axis: Optional[str] = None) -> torch.Tensor:
    """t reduced elementwise by op (a sum by default) over the ranks of
    `axis` (None: the whole world; 'sample': the ranks of this rank's SNP
    rows, where partial rotations are summed; 'snp'), on t's device. The
    bytes this rank hands the collective add to all_reduce.bytes."""
    runs, group = mesh.axis_group(axis)
    if not runs:
        return t
    buf = t.to(comm_device(mesh))
    dist.all_reduce(buf, op=op, group=group)
    all_reduce.bytes += buf.numel() * buf.element_size()
    return buf.to(t.device)


all_reduce.bytes = 0


def scatter_from_rank0(blocks: Optional[Sequence[torch.Tensor]], mesh: Mesh,
                       shape, dtype) -> torch.Tensor:
    """Rank 0's block blocks[j] on every rank whose 'sample' coordinate is
    j, on the rank's device, by one scatter over the world: no rank ever
    holds the blocks of the others. Every block has `shape` and `dtype`
    (given on every rank); only rank 0 passes blocks. A world with no
    process group returns its own block."""
    if not mesh.distributed:
        return blocks[mesh.sample_index].to(mesh.device)
    cdev = comm_device(mesh)
    out = torch.empty(tuple(shape), dtype=dtype, device=cdev)
    send = None
    if mesh.rank == 0:
        moved = [b.to(cdev).contiguous() for b in blocks]
        send = [moved[r % mesh.shape[1]] for r in range(mesh.world)]
    dist.scatter(out, send, src=0, group=mesh.group)
    return out.to(mesh.device)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0
                    ) -> Tuple[np.ndarray, int]:
    """Pad axis to a multiple (sharding needs even splits); returns
    (padded, original_size)."""
    size = x.shape[axis]
    target = -(-size // multiple) * multiple
    if target == size:
        return x, size
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, target - size)
    return np.pad(x, widths), size
