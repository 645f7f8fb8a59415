"""SNP data-parallel kinship and EMMAX over torch.distributed (counterpart
of mixmogam_tpu/parallel/distributed.py: distributed_kinship,
distributed_emmax, shard_packed_rows, distributed_emmax_resident).

The JAX package's design, with its collectives written out:
- genotype rows shard by rank: each rank takes its tile-aligned range
  (multihost.host_snp_range) of the full matrix, or is given only those
  rows (multihost.SnpShard); a ResidentGenome's packed rows shard the same
  way at the container's own tile (shard_packed_rows), uploaded to each
  rank's device once and kept with the container;
- kinship: each rank's partial gram, then ONE all-reduce of the (n, n)
  partial (int64 for the integer counts of kernel K1, float64 otherwise)
  and one division by the global denominator in float64;
- EMMAX: rank 0 fits the null and builds the rotated null at the tier and
  broadcasts it once (nulls replicate, genotypes shard); each rank scans
  its rows through the port's single-device scan functions, with no
  communication, and the (4, m_rank) statistics meet in ONE all-gather;
  p-values finalize in float64 on the host.

On a mesh with a 'sample' axis (the JAX package's tensor-parallel scan,
its _tp_resident_kernel and apply_rotation_psum), rank 0 sends each rank
only its block of the rotation's contraction rows (scatter_from_rank0);
each rank rotates its block of sample columns of its 'snp' rows, the
partial products are summed over 'sample' (ops/scan.py::
apply_rotation_psum; the int8 planes in integers), the mask of rows inside
col(X0) comes from two more sums, kernel K3 runs the epilogue on the whole
rows, and the statistics meet in one all-gather over 'snp'. Kinship has no
W: its rows split over the whole world. Every entry point takes the axis
(its rotations scattered by contraction-row blocks through on_rank0_rows,
its tiles' blocks from tp_blocks; the class tests, with no W, replicate
over it) but where the JAX package refuses it: SAMPLE_AXIS_REFUSALS.

Routes are decided for the whole mesh, so every rank takes the same route,
raises the same refusal, and the result equals the single-device call's: a
host source's facts (the largest dosage, missing calls, fractional
dosages) meet in one small all-reduce; a ResidentGenome's (M, n, tile,
has_missing, ploidy) are the same on every rank, so its routes need no
pass over dosages and no collective.

distributed_train_step, the JAX package's end-to-end step: the kinship
all-reduce (kernel K1 on integer rows), eigh, the projected spectrum and a
batched REML on rank 0 with one broadcast, each rank's rows rotated a tile
at a time and scanned by kernel K3 once a trait, a top-k a trait and one
all-gather. parallel/dryrun.py drives it and every campaign entry point on
a mesh (the JAX package's __graft_entry__.dryrun_multichip).

The entry points' own mesh= routes (models/emmax.py, loco.py, stepwise.py,
multitrait.py, emma.py, gxe.py, permutation.py, linear.py, twosnp.py) are
built from the helpers here on the same design: mesh_entry (the checks
every route makes first), on_rank0 (rank 0's null on every rank by one
broadcast; its exception raised on every rank), rank_range /
shard_packed_rows / rank_sources (a rank's rows at the call's tile),
row_block and gathered_rows (the one all-gather); with mesh None, on_rank0,
rank_sources and gathered_rows are the single-device call's own steps, so
one code path serves both.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from mixmogam_tpu_torch.parallel.mesh import (Mesh, all_reduce,
                                              broadcast_from_rank0,
                                              gather_rows, make_mesh)
from mixmogam_tpu_torch.parallel.multihost import SnpShard, host_snp_range


def _mesh_device(mesh: Optional[Mesh], device
                 ) -> Tuple[Mesh, torch.device]:
    """The mesh (default make_mesh(), whose device is the rank's card),
    checked by check_sample_mesh, and the device the rank computes on
    (default the mesh's)."""
    if mesh is None:
        mesh = make_mesh(devices=device)
    check_sample_mesh(mesh)
    return mesh, (mesh.device if device is None else torch.device(device))


def check_sample_mesh(mesh: Mesh) -> None:
    """A 'sample' axis above 1 must hold the world (make_mesh's mesh): on
    a hand-built mesh that does not, a block of the samples alone would
    scan as the whole. Raises ValueError naming make_mesh, on every rank
    and before any collective."""
    if mesh.shape[1] != 1 and mesh.shape[0] * mesh.shape[1] != mesh.world:
        raise ValueError(f"mesh shape {mesh.shape} != {mesh.world} "
                         "ranks; build the mesh with make_mesh()")


def _local_rows(G, mesh: Mesh) -> Tuple[np.ndarray, int]:
    """(this rank's rows, the global row count M): a SnpShard's own rows, a
    ResidentGenome's shard rows (shard_packed_rows' range) unpacked on the
    host, else rows host_snp_range gives the rank's 'snp' coordinate of
    the full matrix (the S ranks of a 'sample' group hold the same rows)."""
    from mixmogam_tpu_torch.models.resident import ResidentGenome
    from mixmogam_tpu_torch.models.source import resolve_source

    if isinstance(G, SnpShard):
        lo, hi = host_snp_range(G.M, mesh.shape[0], mesh.snp_index)
        if (G.lo, G.hi) != (lo, hi):
            raise ValueError(f"rank {mesh.rank}'s shard holds rows "
                             f"[{G.lo}, {G.hi}); host_snp_range gives it "
                             f"[{lo}, {hi})")
        return G.rows, G.M
    src = resolve_source(G)
    M = src.shape[0]
    if isinstance(src, ResidentGenome):
        lo, hi = host_snp_range(M, mesh.shape[0], mesh.snp_index,
                                tile=src.tile)
        return src[lo:hi], M
    lo, hi = host_snp_range(M, mesh.shape[0], mesh.snp_index)
    rows = src[lo:hi]
    # an in-memory matrix's rows are a view; a memmap's (or a lazy
    # source's) are read into memory here
    return (rows if type(rows) is np.ndarray else np.array(rows)), M


def _mesh_facts(rows: np.ndarray, mesh: Mesh, device) -> np.ndarray:
    """[largest observed dosage, any missing call, any non-int8 source]
    over every rank's rows: one all-reduce (MAX) of three float64s."""
    if rows.dtype == np.int8:
        mx = float(rows.max(initial=0))
        missing = bool((rows < 0).any())
    else:
        mx = float(np.nanmax(rows, initial=0.0)) if rows.size else 0.0
        missing = bool(np.isnan(rows).any())
    facts = torch.tensor([mx, float(missing), float(rows.dtype != np.int8)],
                         dtype=torch.float64, device=device)
    return all_reduce(facts, mesh, dist.ReduceOp.MAX).cpu().numpy()


def shard_packed_rows(rg, mesh: Mesh, device=None,
                      sample_axis: bool = False):
    """This rank's packed rows of a ResidentGenome, as a container on the
    rank's device (default the mesh's). The JAX package places every
    rank's rows at once; here each rank places its own.

    The rows are host_snp_range(rg.M, S_snp, the rank's 'snp' coordinate,
    tile=rg.tile), so every tile of the shard has the shape the
    single-device scan gives it; the last shard keeps the container's zero
    pad rows up to its tile. When the container's rows are on the rank's
    device already (or its single-device upload is: ResidentGenome.
    on_device), the shard is a view of them and a world of one uploads
    nothing twice; otherwise the rank's bytes of host_packed go up once
    (counted in ResidentGenome.uploads).

    sample_axis=True (the JAX package's, for a 'sample' axis of S): the
    byte axis is zero-padded to a multiple of 2 S (sample_blocks) and the
    rank takes only its byte block, 4 * nb / S samples of its 'sample'
    coordinate; its container's n is that block's sample count, and the
    samples past the genome's n decode as 0 (zero bytes) or -1 (the last
    byte's column padding), which the scan drops.

    Memoized on the container per (process group, rank, world, device),
    with the mesh's shape and the rank's 'sample' coordinate for a byte
    block: repeated mesh calls over one genome (LOCO's chromosomes, the
    tiers) reuse one upload. The shard holds device memory for as long as
    the container lives."""
    from mixmogam_tpu_torch.models.resident import ResidentGenome, device_key

    tile = rg.tile
    device = device_key(mesh.device if device is None else device)
    key = (mesh.group, mesh.rank, mesh.world, device)
    if sample_axis:
        key += (mesh.shape, mesh.sample_index)
    shard = rg._shards.get(key)
    if shard is None:
        lo, hi = host_snp_range(rg.M, mesh.shape[0], mesh.snp_index,
                                tile=tile)
        end = max(lo, min(-(-hi // tile) * tile, rg.host_packed.shape[0]))
        host = rg.host_packed[lo:end]
        n = rg.n
        if sample_axis:
            _, b0, b1 = sample_blocks(rg.n, mesh, packed=True)
            host = np.zeros((end - lo, b1 - b0), dtype=np.uint8)
            cut = rg.host_packed[lo:end, b0:b1]
            host[:, :cut.shape[1]] = cut
            n = 4 * (b1 - b0)
        on = rg if not rg.on_host else rg._uploads.get(device)
        if not sample_axis and on is not None and on.device == device:
            rows = on.packed[lo:end]
        else:
            ResidentGenome.uploads += 1
            rows = torch.from_numpy(np.ascontiguousarray(host)).to(device)
        shard = ResidentGenome(rows, hi - lo, n, rg.ploidy, tile,
                               rg.has_missing, host_packed=host)
        rg._shards[key] = shard
    return shard


def sample_blocks(n: int, mesh: Mesh, packed: bool = False
                  ) -> Tuple[int, int, int]:
    """(n_pad, lo, hi) of the 'sample' axis of S: the n samples padded to
    n_pad = a multiple of 8 S, and this rank's block [lo, hi) of
    n_pad / S. In core lo, hi are sample columns. packed=True: they are
    byte columns of the packed rows, ceil(n / 4) bytes padded to a
    multiple of 2 S, and n_pad = 4 bytes a byte. Each block is then a
    multiple of 8 samples wide, as the int8 products on the card take
    their contraction (ops/rotate.py::rotation_rows)."""
    S, j = mesh.shape[1], mesh.sample_index
    if packed:
        nb = -(-((n + 3) // 4) // (2 * S)) * 2 * S
        bb = nb // S
        return 4 * nb, j * bb, (j + 1) * bb
    n_pad = -(-n // (8 * S)) * 8 * S
    w = n_pad // S
    return n_pad, j * w, (j + 1) * w


def distributed_kinship(G, mesh: Optional[Mesh] = None, method: str = "ibs",
                        device=None) -> np.ndarray:
    """Kinship over SNP-sharded rows: each rank's partial gram, one
    all-reduce of the (n, n) partial, one float64 division by the global
    denominator. G: the full (M, n) matrix or a ResidentGenome on every
    rank (each takes its host_snp_range rows), or this rank's SnpShard.
    Routes as ops/kinship.py's kinship: fully observed binary int8 rows go
    through kernel K1 (a ResidentGenome's shard as it is packed,
    shard_packed_rows; an array's rows packed on the rank's device;
    integer counts, summed in int64); missing calls and float dosages take
    the per-chunk imputation and the float updates (float32 with TF32 off
    on the card, float64 on the CPU; a ResidentGenome's shard unpacked on
    the host), summed in float64; 'vanraden' sums its numerator and
    denominator across ranks. A ResidentGenome routes on its own
    has_missing and ploidy, with no collective. method='ibs' takes binary
    dosages only, as in the JAX package. Every rank returns the (n, n)
    float64 numpy array. device: the rank's (default the mesh's: its
    card). On a mesh with a 'sample' axis the gram has no W to shard: the
    rows split over every rank of the world (host_snp_range(M, world,
    rank); a rank's SnpShard is split among its 'sample' group), then one
    world-wide all-reduce, so the integer gram is bit-equal to one
    device's."""
    from mixmogam_tpu_torch.models.resident import ResidentGenome
    from mixmogam_tpu_torch.ops.kinship import (check_kinship_method,
                                                finish_on_device,
                                                ibs_float_partial,
                                                resolve_compute_dtype,
                                                vanraden_partial)

    method = check_kinship_method(method)
    mesh, device = _mesh_device(mesh, device)
    rows = None
    if mesh.shape[1] > 1:
        if isinstance(G, SnpShard):
            # a 'sample' group holds one shard: its ranks split its rows
            rows, M = _local_rows(G, mesh)
            a, b = host_snp_range(rows.shape[0], mesh.shape[1],
                                  mesh.sample_index, tile=1)
            rows = rows[a:b]
        # the gram has no W to shard: the rows split over the whole world
        # (a (world, 1) view of the group) and meet in one all-reduce
        mesh = Mesh((mesh.world, 1), mesh.group, mesh.backend, mesh.rank,
                    mesh.world, mesh.device)
    rg = G if isinstance(G, ResidentGenome) else None
    if rg is not None:
        rows, M, n = None, rg.M, rg.n
        ploidy, missing, not_int8 = rg.ploidy, rg.has_missing, False
    else:
        if rows is None:
            rows, M = _local_rows(G, mesh)
        n = rows.shape[1]
        mx, missing, not_int8 = _mesh_facts(rows, mesh, device)
        ploidy = 2 if mx > 1 else 1
    dtype = resolve_compute_dtype(None, device)
    if method == "ibs":
        if ploidy > 1:
            raise ValueError(
                "distributed_kinship(method='ibs') implements the BINARY "
                "allele-sharing formula; for diploid dosages use "
                "method='vanraden' here or ops.kinship.kinship (diploid "
                "IBS) on one device")
        if not (missing or not_int8):
            # integer counts of kernel K1 over the rank's packed rows
            if rg is not None:
                shard = shard_packed_rows(rg, mesh, device=device)
            elif rows.shape[0]:
                shard = ResidentGenome.from_source(rows, ploidy=1,
                                                   device=device)
            else:
                shard = None
            return finish_on_device(
                all_reduce(_ibs_counts(shard, n, device), mesh), float(M))
        if rows is None:
            rows, _ = _local_rows(rg, mesh)
        part = ibs_float_partial(rows, 1, _KINSHIP_CHUNK, dtype,
                                 device).double()
        return finish_on_device(all_reduce(part, mesh), float(M))
    if rows is None:
        rows, _ = _local_rows(rg, mesh)
    num, den = vanraden_partial(rows, ploidy, _KINSHIP_CHUNK, dtype,
                                device)
    # the numerator and its denominator in one all-reduce
    flat = torch.cat([num.double().reshape(-1),
                      torch.tensor([den], dtype=torch.float64,
                                   device=device)])
    flat = all_reduce(flat, mesh)
    return finish_on_device(flat[:-1].reshape(n, n), float(flat[-1]))


def _ibs_counts(shard, n: int, device) -> torch.Tensor:
    """The (n, n) int64 sharing counts of kernel K1 over a rank's packed
    binary rows (a ResidentGenome; zeros where the rank holds none): the
    partial that one all-reduce sums over the ranks."""
    from mixmogam_tpu_torch.models.resident import ibs_counts_resident

    if shard is None or not shard.M:
        return torch.zeros((n, n), dtype=torch.int64, device=device)
    return ibs_counts_resident(shard, ploidy=1).to(torch.int64)


#: rows a chunk of the float kinships' host imputation (kinship()'s default)
_KINSHIP_CHUNK = 2048

#: RotatedNull fields that are caches of a device's prepared operands
_ROT_CACHES = ("operand", "k3")

#: the null's scalars each rank returns, as NullModel names them
_NULL_SCALARS = ("pseudo_heritability", "delta", "sigma_g2", "sigma_e2",
                 "ll")


def _fit_rotated(device, dtype, y, X0, K, eig_k, rd, float_route: bool,
                 ngrids, llim, ulim, esp, host_eigh):
    """(payload, the float route's parts) of rank 0's null: it fits the
    null (K or eig_k needed there only) and builds the rotated null at the
    tier rd (the packed kernels' operand), or for the float route the
    exact tier's null and the bf16 parts of U' (else None). payload: the
    rotated null's fields (null_fields) and the null's scalars."""
    from mixmogam_tpu_torch.ops.reml import (esp_to_refine_iters,
                                             fit_null_model)
    from mixmogam_tpu_torch.ops.rotate import float_route_eig, float_rotation
    from mixmogam_tpu_torch.ops.scan import build_rotated_null

    eig = (float_route_eig(K, eig_k, device, host_eigh) if float_route
           else eig_k)
    null = fit_null_model(y, X0, K=K, eig_k=eig, ngrids=ngrids, llim=llim,
                          ulim=ulim, refine_iters=esp_to_refine_iters(
                              esp, ngrids, llim, ulim),
                          host_eigh=host_eigh, device=device, dtype=dtype)
    payload = null_fields(build_rotated_null(
        null, rotate_dtype=None if float_route else rd))
    for k in _NULL_SCALARS:
        payload["null_" + k] = float(getattr(null, k))
    # the float route cuts its parts from this eigenbasis in float64
    parts = (float_rotation(eig[1], X0, rd, dtype, device).W if float_route
             else None)
    return payload, parts


def _replicated_null(mesh: Mesh, device, dtype, y, X0, K, eig_k, rd,
                     float_route: bool, ngrids, llim, ulim, esp, host_eigh):
    """(rot, srot, null scalars) on every rank: rank 0's _fit_rotated (srot:
    the float route's SharedRotation of the bf16 parts of U'), then one
    broadcast."""
    from mixmogam_tpu_torch.ops.rotate import SharedRotation

    def fit():
        payload, parts = _fit_rotated(device, dtype, y, X0, K, eig_k, rd,
                                      float_route, ngrids, llim, ulim, esp,
                                      host_eigh)
        payload["srot"] = parts
        return payload

    payload = on_rank0(fit, mesh)
    rot = null_from_fields(payload)
    srot = (None if payload["srot"] is None
            else SharedRotation(rd, payload["srot"], None, dtype))
    return rot, srot, {k: payload["null_" + k] for k in _NULL_SCALARS}


@dataclasses.dataclass
class TPNull:
    """A rank's share of the rotated null on a mesh with a 'sample' axis:
    the epilogue's constants (kernel K3's sd, y_res, Q0, rss0, dof), the
    rank's block of the rotation's contraction rows and of the design's
    rows, and where the block lies."""

    #: the epilogue's null, with no rotation: the exact tier's and the
    #: float route's own (sd, Q0); the folded W'' of the int8 / bf16 tiers
    #: rotates and whitens, so sd = 1 and Q0 one zero column (K3 takes
    #: 1 <= q <= 128: c is then exactly 0)
    epi: object
    #: ops/rotate.py::rotation_rows of the rank's (n_pad / S, n) block of
    #: U' / every digit plane (with the column scale) / every bf16 part
    W: object
    X0: torch.Tensor          # (n_pad / S, q) rows of X0, zero past n
    X0p: torch.Tensor         # the same of X0p
    n: int
    lo: int                   # the block's first sample column
    width: int                # its sample columns below n


def _tp_null(mesh: Mesh, device, dtype, y, X0, K, eig_k, rd,
             float_route: bool, ngrids, llim, ulim, esp, host_eigh,
             n_pad: int, lo: int, hi: int):
    """(TPNull, null scalars) on every rank of a mesh with a 'sample'
    axis: rank 0's _fit_rotated, its small constants broadcast, and each
    rank sent only its contraction-row block [lo, hi) of the rotation (U',
    the planes or parts of W'', or the float route's parts of U'), its
    rows zero-padded to n_pad, by one scatter (parallel/mesh.py::
    scatter_from_rank0): no other rank holds the whole rotation."""
    from mixmogam_tpu_torch.ops.rotate import rotation_rows

    def fit():
        payload, parts = _fit_rotated(device, dtype, y, X0, K, eig_k, rd,
                                      float_route, ngrids, llim, ulim, esp,
                                      host_eigh)
        W = next(w for w in (parts, payload.pop("U"), payload.pop("planes"),
                             payload.pop("parts")) if w is not None)
        return payload, W

    payload, Wb = on_rank0_rows(fit, mesh, n_pad, lo, hi)
    rot = null_from_fields(dict(payload, U=None, planes=None, parts=None))
    n = rot.sd.shape[0]
    if rot.folded:
        dt = rot.sd.dtype
        epi = dataclasses.replace(
            rot, sd=torch.ones_like(rot.sd),
            Q0=torch.zeros((n, 1), dtype=dt, device=rot.sd.device),
            w_scale=None, folded=False)
    else:
        epi = rot
    tp = TPNull(epi=epi, W=rotation_rows(Wb, rot.w_scale, dtype),
                X0=block_rows(rot.X0, lo, hi), X0p=block_rows(rot.X0p, lo, hi),
                n=n, lo=lo, width=max(0, min(hi, n) - lo))
    return tp, {k: payload["null_" + k] for k in _NULL_SCALARS}


def on_rank0_rows(fn, mesh: Mesh, n_pad: int, lo: int, hi: int):
    """(payload, this rank's block) of fn() run on rank 0, which returns
    (payload, W) with W (..., n, k): the payload on every rank by on_rank0
    (an exception raised on every rank), and W's rows zero-padded to n_pad
    and cut in blocks of hi - lo, block j sent to the ranks of 'sample'
    coordinate j by one scatter (parallel/mesh.py::scatter_from_rank0): no
    other rank holds the whole of W. W may be a list of such operands (a
    rotation in several parts, or none): then a list of blocks, one
    scatter each, in order."""
    from mixmogam_tpu_torch.parallel.mesh import scatter_from_rank0

    held = {}

    def fit():
        payload, W = fn()
        Ws = [W] if isinstance(W, torch.Tensor) else list(W)
        held["W"] = [torch.nn.functional.pad(w, (0, 0, 0, n_pad - w.shape[-2]))
                     for w in Ws]
        payload["_w_blocks"] = (isinstance(W, torch.Tensor), [
            (tuple(w.shape[:-2]) + (hi - lo, w.shape[-1]), w.dtype)
            for w in Ws])
        return payload

    payload = on_rank0(fit, mesh)
    single, metas = payload.pop("_w_blocks")
    Ws = held.pop("W", None)
    blocks = []
    for i, (shape, wdt) in enumerate(metas):
        parts = None
        if Ws is not None:
            parts = list(torch.split(Ws[i], hi - lo, dim=-2))
            Ws[i] = None           # rank 0 lets each operand go once sent
        blocks.append(scatter_from_rank0(parts, mesh, shape, wdt))
    return payload, (blocks[0] if single else blocks)


def block_rows(A: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of A (a sample block of the rows of X0, of sd, ...),
    zero past A's own rows."""
    out = torch.zeros((hi - lo,) + tuple(A.shape[1:]), dtype=A.dtype,
                      device=A.device)
    width = max(0, min(hi, A.shape[0]) - lo)
    out[:width] = A[lo:lo + width]
    return out


def block_cols(A: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Columns [lo, hi) of A (..., n) (a block of sample columns of whole
    rows: a focal SNP's, an environment's, a rescore's rows), zero past
    its n."""
    return block_rows(A.movedim(-1, 0), lo, hi).movedim(0, -1)


def _tp_scan_tile(Gb: torch.Tensor, tp: TPNull, mesh: Mesh) -> torch.Tensor:
    """(4, m) [f, beta, var_perc, mask] of a tile's block of sample columns
    (int8 dosages, or mean-imputed float rows; zero past the genome's n),
    the same on every rank of the 'sample' group: the rotation's partial
    products summed over 'sample' (ops/scan.py::apply_rotation_psum), the
    mask of the rows inside col(X0) from sums over 'sample'
    (outside_design_psum), then kernel K3 on the whole rotated rows (its
    plain version on the CPU)."""
    from mixmogam_tpu_torch.ops.scan import (apply_rotation_psum,
                                             emmax_scan_prerotated,
                                             outside_design_psum)

    Xs = apply_rotation_psum(Gb, tp.W, tp.W.w_scale, tp.W.dt, mesh, tp.n)
    keep = outside_design_psum(Gb.to(tp.X0p.dtype), tp.X0, tp.X0p, mesh)
    return emmax_scan_prerotated(Xs, tp.epi, keep)


def _tp_imputed(G: torch.Tensor, miss: torch.Tensor, valid: torch.Tensor,
                dtype, mesh: Mesh) -> torch.Tensor:
    """A block of sample columns (m, nb) with its missing calls set to
    their row's mean over the observed calls of every block (moments
    summed over 'sample', in dtype; 0 for an all-missing row: the rule of
    models/streaming.py::_impute_tile), and the columns past the genome's
    n (valid False) to 0."""
    zero = torch.zeros((), dtype=dtype, device=G.device)
    obs = torch.where(miss | ~valid[None, :], zero, G.to(dtype))
    cnt = ((~miss) & valid[None, :]).sum(dim=1).to(dtype)
    tot, cnt = all_reduce(torch.stack([obs.sum(dim=1), cnt]), mesh,
                          axis="sample")
    mu = tot / torch.clamp(cnt, min=1)
    return torch.where(valid[None, :], torch.where(miss, mu[:, None], obs),
                       zero)


def gathered_rows(block: torch.Tensor, mesh: Optional[Mesh], M: int
                  ) -> np.ndarray:
    """Every rank's (..., m_rank) block of per-row results (the (4, m_rank)
    statistics, multi-trait's (T, 3, m_rank), EMMA's (5, m_rank)) in ONE
    all-gather, as the (..., M) float64 host array, rows in rank order.
    mesh None: one device's block, to the host."""
    h = (block if mesh is None else gather_rows(block, mesh)
         ).cpu().double().numpy()
    if h.shape[-1] != M:
        raise RuntimeError(f"the gathered statistics hold {h.shape[-1]} "
                           f"rows of {M}")
    return h


def row_block(blocks, lead, dtype, device) -> torch.Tensor:
    """A rank's (*lead, m) block of per-row results: its tiles' blocks
    joined along the last axis, or (*lead, 0) when it holds no rows."""
    if not blocks:
        return torch.zeros(tuple(lead) + (0,), dtype=dtype, device=device)
    return torch.cat(blocks, dim=-1)


def on_rank0(fn, mesh: Optional[Mesh]) -> Dict[str, object]:
    """fn() run on rank 0 (a dict of tensors, Python values and None), on
    every rank by one broadcast_from_rank0 (rank 0's memory layout kept).
    An exception fn raises on rank 0 is sent in its place and raised on
    every rank, so no rank waits on a broadcast that never comes. mesh
    None: fn() on one device."""
    if mesh is None:
        return fn()
    payload = None
    if mesh.rank == 0:
        try:
            payload = fn()
        except Exception as e:          # sent to every rank, raised there
            if not mesh.distributed:
                raise
            payload = {"_raised": e}
    payload = broadcast_from_rank0(payload, mesh)
    if "_raised" in payload:
        raise payload["_raised"]
    return payload


def fields_of(obj, prefix: str, skip=()) -> Dict[str, object]:
    """A dataclass's fields (less `skip`) as prefixed payload entries."""
    return {prefix + f.name: getattr(obj, f.name)
            for f in dataclasses.fields(obj) if f.name not in skip}


def from_fields(cls, payload: Dict[str, object], prefix: str, skip=()):
    """The dataclass `cls` rebuilt from fields_of's entries."""
    return cls(**{f.name: payload[prefix + f.name]
                  for f in dataclasses.fields(cls) if f.name not in skip})


def null_fields(rot, prefix: str = "") -> Dict[str, object]:
    """A RotatedNull's fields as payload entries, less its device caches
    (each rank prepares its own operands at its first scan)."""
    return fields_of(rot, prefix, _ROT_CACHES)


def null_from_fields(payload: Dict[str, object], prefix: str = ""):
    """The RotatedNull of null_fields' entries."""
    from mixmogam_tpu_torch.ops.scan import RotatedNull

    return from_fields(RotatedNull, payload, prefix, _ROT_CACHES)


def rank_range(M: int, mesh: Mesh, tile: int) -> Tuple[int, int]:
    """This rank's rows [lo, hi) of an M-row host source at the call's
    tile (multihost.host_snp_range of its 'snp' coordinate), so each of
    its tiles has the shape one device gives the same rows."""
    return host_snp_range(M, mesh.shape[0], mesh.snp_index, tile=tile)


def rank_sources(mesh: Optional[Mesh], tile: int, device, rg, *hosts):
    """(container, *host sources) of the rows a call scans. One device
    (mesh None): as given. On a mesh: a ResidentGenome's shard on the
    rank's device (shard_packed_rows, at the container's tile) and no host
    source; or, without one, each host source (the same M rows in other
    forms, or None) cut to this rank's rank_range rows at `tile`."""
    if mesh is None:
        return (rg,) + hosts
    if rg is not None:
        return ((shard_packed_rows(rg, mesh, device=device),)
                + (None,) * len(hosts))
    M = next(h for h in hosts if h is not None).shape[0]
    lo, hi = rank_range(M, mesh, tile)
    return (None,) + tuple(None if h is None else h[lo:hi] for h in hosts)


#: the JAX package's own refusals of a 'sample' axis above 1, by entry
#: point: (True where only a ResidentGenome source is refused, its
#: ValueError's words); every other route takes the axis
SAMPLE_AXIS_REFUSALS = {
    "emma": (False, "mesh-distributed EMMA shards 'snp' only; use a "
                    "('snp', 1) mesh"),
    "emmax_gxe": (True, "mesh-distributed resident GxE shards 'snp' only; "
                        "use a ('snp', 1) mesh"),
    "emmax_perm_test": (True, "mesh-distributed resident permutation "
                              "shards 'snp' only; use a ('snp', 1) mesh"),
    "linear_model": (True, "the pre-rotated (identity-whitening) scan has "
                           "no rotation operator to sample-shard; use a "
                           "('snp', 1) mesh"),
    "anova": (True, "mesh-distributed packed class tests shard 'snp' "
                    "only; use a ('snp', 1) mesh"),
    "kruskal_wallis": (True, "mesh-distributed packed class tests shard "
                             "'snp' only; use a ('snp', 1) mesh"),
}


def refuse_sample_axis(mesh: Mesh, what: str, G=None) -> None:
    """The checks of a 'sample' axis above 1, on every rank and before any
    collective: the JAX package's ValueError where it refuses the axis
    (SAMPLE_AXIS_REFUSALS: emma on any source; GxE, the permutation test
    and the class tests on a ResidentGenome), else the mesh must hold the
    world (check_sample_mesh)."""
    from mixmogam_tpu_torch.models.resident import ResidentGenome

    if mesh.shape[1] == 1:
        return
    resident_only, words = SAMPLE_AXIS_REFUSALS.get(what, (None, None))
    if words is not None and (not resident_only
                              or isinstance(G, ResidentGenome)):
        raise ValueError(words)
    check_sample_mesh(mesh)


def mesh_entry(mesh, G, what: str, device=None) -> Tuple[Mesh, torch.device]:
    """(mesh, the rank's device: `device`, default the mesh's) of an entry
    point's mesh= route, after the checks that route makes on every rank
    before anything else: mesh is a Mesh (make_mesh()), a 'sample' axis
    above 1 passes refuse_sample_axis (the JAX package's refusals; the
    mesh holds the world), and G is the whole source, not a rank's
    SnpShard (the entry points read their rows from it)."""
    if not isinstance(mesh, Mesh):
        raise TypeError("mesh must be a mixmogam_tpu_torch.parallel.Mesh "
                        f"(make_mesh()); got {type(mesh).__name__}")
    refuse_sample_axis(mesh, what, G)
    if isinstance(G, SnpShard):
        raise TypeError(f"{what}(mesh=) takes the whole matrix on every "
                        "rank; pass a rank's SnpShard to distributed_emmax")
    return mesh, (mesh.device if device is None else torch.device(device))


def _gathered_result(out: torch.Tensor, mesh: Mesh, M: int, rot,
                     nulls: Dict[str, float]) -> Dict[str, np.ndarray]:
    """The run's one all-gather of every rank's (4, m_rank) statistics,
    then float64 host p-values: distributed_emmax's return dict."""
    from mixmogam_tpu_torch.ops.stats import f_sf_host

    h = gathered_rows(out, mesh, M)
    f_stats, mask = h[0].copy(), h[3] > 0.5
    dof = int(rot.dof)
    ps = np.where(mask, f_sf_host(f_stats, 1.0, dof), 1.0)
    return {"ps": ps, "f_stats": f_stats, "mask": mask,
            "betas": h[1].copy(), "var_perc": h[2].copy(),
            "pseudo_heritability": nulls["pseudo_heritability"],
            "delta": nulls["delta"], "dof": dof,
            "sigma_g2": nulls["sigma_g2"], "sigma_e2": nulls["sigma_e2"],
            "ll_null": nulls["ll"]}


def distributed_emmax(G, y, K=None, X0: Optional[np.ndarray] = None,
                      mesh: Optional[Mesh] = None, eig_k=None,
                      ngrids: int = 100, llim: float = -10.0,
                      ulim: float = 10.0, esp: float = 1e-6, dtype=None,
                      rotate_in_bf16=False, host_eigh: Optional[bool] = True,
                      device=None, tile: int = 16_384
                      ) -> Dict[str, np.ndarray]:
    """EMMAX over SNP-sharded rows, with the JAX package's distributed_emmax
    arguments and return keys (ps, f_stats, mask, betas, var_perc,
    pseudo_heritability, delta, dof, sigma_g2, sigma_e2, ll_null), equal to
    the port's single-device emmax at the same tier.

    G: the full (M, n) matrix on every rank, or this rank's SnpShard; a
    ResidentGenome goes to distributed_emmax_resident (its own tile). Rank
    0 fits the null (K or eig_k needed there only) and builds the rotated
    null at the tier (rotate_in_bf16: False | True | 'x2' | 'x3' | 'x2c' |
    'x3c' | 'int8x2' | 'int8x3' | 'int8x4'), then broadcasts it once. Each
    rank scans its rows through the single-device routes of models/emmax.py
    and models/resident.py: the exact tier as fp32 GEMM by the projected
    U' = (I - P_X0) U then kernel K3; the int8 / bf16 tiers on integer
    dosages packed on the rank's device, then K2 / K5 (and the mask of the
    rows inside col(X0)); fractional dosages at a bf16 tier the float route
    (ops/rotate.py, then K3). An int8 tier on missing or fractional dosages
    raises, on every rank. Then one all-gather of the (4, m_rank)
    statistics, and float64 host p-values. On a mesh with a 'sample' axis
    every tier takes _tp_scan: each rank holds its block of U' / the
    planes / the parts and rotates its block of sample columns, the
    partials summed over 'sample', then K3. dtype: a torch dtype, float32 on
    the card and float64 on the CPU by default; device: the rank's
    (default the mesh's: its card)."""
    from mixmogam_tpu_torch.models.emmax import (_as_design, _incore_rows,
                                                 _scan_incore)
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    _default_dtype,
                                                    emmax_scan_packed)
    from mixmogam_tpu_torch.models.source import as_int8_dosage
    from mixmogam_tpu_torch.ops.scan import (normalize_rotate_tier,
                                             refuse_high_on_mesh)

    refuse_high_on_mesh(normalize_rotate_tier(rotate_in_bf16))
    if isinstance(G, ResidentGenome):
        return distributed_emmax_resident(
            G, y, K=K, X0=X0, mesh=mesh, eig_k=eig_k, ngrids=ngrids,
            llim=llim, ulim=ulim, esp=esp, dtype=dtype,
            rotate_in_bf16=rotate_in_bf16, host_eigh=host_eigh,
            device=device)
    mesh, device = _mesh_device(mesh, device)
    if dtype is None:
        dtype = _default_dtype(device)
    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    X0 = _as_design(np.ones((n, 1)) if X0 is None else X0, n)
    rows, M = _local_rows(G, mesh)
    rd = normalize_rotate_tier(rotate_in_bf16)
    sample_axis = mesh.shape[1] > 1
    # the route, for the whole mesh: packed rows where every rank's rows
    # are integer dosages, the float route where some rank's are fractional
    G8 = as_int8_dosage(rows) if rd is not None or sample_axis else None
    # (the 'sample' route imputes float rows' NaN from its own moments)
    nan = sample_axis and G8 is None and bool(np.isnan(rows).any())
    fractional, missing = all_reduce(torch.tensor(
        [float(G8 is None),
         float(G8 is not None and (G8 < 0).any() or nan)],
        dtype=torch.float64, device=device), mesh,
        dist.ReduceOp.MAX).tolist()
    if rd is not None and rd.startswith("int8") and (fractional or missing):
        raise ValueError(
            f"rotate_in_bf16={rotate_in_bf16!r} requires integer dosages, "
            "fully observed (digit-plane matmuls round genotypes to int8)")
    packed = rd is not None and not fractional
    if sample_axis:
        out, rot, nulls = _tp_scan(
            rows if G8 is None else G8, None, missing, mesh, device, dtype,
            y, X0, K, eig_k, rd, rd is not None and not packed, ngrids,
            llim, ulim, esp, host_eigh, tile)
        return _gathered_result(out, mesh, M, rot, nulls)
    rot, srot, nulls = _replicated_null(
        mesh, device, dtype, y, X0, K, eig_k, rd,
        rd is not None and not packed, ngrids, llim, ulim, esp, host_eigh)

    # ---- this rank's rows, no communication ----
    if rows.shape[0] == 0:
        out = torch.zeros((4, 0), dtype=dtype, device=device)
    elif packed:
        rg = ResidentGenome.from_source(G8, tile=tile, device=device)
        out = emmax_scan_packed(rg.packed, rot, n, rg.tile,
                                impute=rg.has_missing)[:, :rg.M]
    else:
        out = _scan_incore(_incore_rows(rows, dtype), rot, srot, tile,
                           device, dtype)
    return _gathered_result(out, mesh, M, rot, nulls)


def _tp_scan(rows: Optional[np.ndarray], rg, missing: bool, mesh: Mesh,
             device, dtype, y, X0, K, eig_k, rd, float_route: bool, ngrids,
             llim, ulim, esp, host_eigh, tile: int,
             window: Optional[Tuple[int, int]] = None):
    """The 'sample' route of distributed_emmax (rows: the rank's 'snp'
    rows, int8 dosages with -1 missing or float dosages with NaN) and of
    distributed_emmax_resident (rg: the container; rows None): ((4, m_rank)
    statistics, the epilogue's null, null scalars). Rank 0's null reaches
    each rank as its block of the rotation (_tp_null), each tile's block of
    sample columns comes from tp_blocks (window: the container's rows of
    [s, e) the rank's shard holds), then _tp_scan_tile."""
    n = rg.n if rg is not None else rows.shape[1]
    n_pad, lo, hi = tp_columns(n, mesh, packed=rg is not None)
    tp, nulls = _tp_null(mesh, device, dtype, y, X0, K, eig_k, rd,
                         float_route, ngrids, llim, ulim, esp, host_eigh,
                         n_pad, lo, hi)
    outs = [_tp_scan_tile(Gb, tp, mesh)
            for Gb in tp_blocks(rows, rg, missing, mesh, device, dtype,
                                tile, lo, hi, window)]
    return row_block(outs, (4,), dtype, device), tp.epi, nulls


def tp_columns(n: int, mesh: Mesh, packed: bool) -> Tuple[int, int, int]:
    """(n_pad, lo, hi) of this rank's block of sample columns on a 'sample'
    axis: sample_blocks' in core, its byte bounds times 4 packed."""
    n_pad, lo, hi = sample_blocks(n, mesh, packed=packed)
    return (n_pad, 4 * lo, 4 * hi) if packed else (n_pad, lo, hi)


def tp_blocks(rows: Optional[np.ndarray], rg, missing: bool, mesh: Mesh,
              device, dtype, tile: int, lo: int, hi: int,
              window: Optional[Tuple[int, int]] = None):
    """Each tile's (m, hi - lo) block of sample columns [lo, hi)
    (tp_columns) on the rank's device, in row order, as the 'sample' route
    rotates it: in core cut from the rank's host rows (rows: int8 with -1
    missing or float with NaN), a tile rows at a time; packed (rg, rows
    None) unpacked on the device from the rank's rows x its byte block
    (shard_packed_rows(sample_axis=True)), a container tile at a time, and
    with window (s, e) only the rows of [s, e) the shard holds. Missing
    calls (missing: on any rank of the group) are imputed from moments
    summed over 'sample' (_tp_imputed: in float64 in core, as the host
    imputation of one device; in the compute dtype packed, as its packed
    scans), the columns past n set to 0; a block that is not int8 is cast
    to dtype. missing None: whether the rows hold a missing call. Every
    rank of a 'sample' group holds the same rows, so each takes the same
    tiles, finds the same missing calls and makes the same collectives."""
    from mixmogam_tpu_torch.ops.pack2 import unpack_2bit_device

    packed = rg is not None
    if missing is None:
        missing = bool((rows < 0).any() if rows.dtype == np.int8
                       else np.isnan(rows).any())
    n = rg.n if packed else rows.shape[1]
    width = max(0, min(hi, n) - lo)
    valid = torch.arange(hi - lo, device=device) < width

    def host_block(s):
        blk = np.zeros((min(tile, rows.shape[0] - s), hi - lo),
                       dtype=np.int8 if rows.dtype == np.int8
                       else np.float64)
        blk[:, :width] = rows[s:s + blk.shape[0], lo:lo + width]
        return torch.from_numpy(blk).to(device)

    if packed:
        shard = shard_packed_rows(rg, mesh, device=device, sample_axis=True)
        a, m = 0, shard.M
        if window is not None:
            first = host_snp_range(rg.M, mesh.shape[0], mesh.snp_index,
                                   tile=rg.tile)[0]
            a = max(window[0], first) - first
            m = max(min(window[1], first + shard.M) - first - a, 0)
        tiles = (unpack_2bit_device(
            shard.packed[a + s:a + min(s + rg.tile, m)], hi - lo)
            for s in range(0, m, rg.tile))
    else:
        tiles = (host_block(s) for s in range(0, rows.shape[0], tile))
    for Gb in tiles:
        if missing:
            miss = torch.isnan(Gb) if Gb.is_floating_point() else Gb < 0
            Gb = _tp_imputed(Gb, miss, valid,
                             dtype if packed else torch.float64, mesh)
        else:
            # the last byte's column padding decodes as -1 (missing)
            Gb = torch.where(valid[None, :], Gb, 0)
        yield Gb if Gb.dtype == torch.int8 else Gb.to(dtype)


def distributed_emmax_resident(rg, y, K=None, X0: Optional[np.ndarray] = None,
                               mesh: Optional[Mesh] = None, eig_k=None,
                               ngrids: int = 100, llim: float = -10.0,
                               ulim: float = 10.0, esp: float = 1e-6,
                               dtype=None, rotate_in_bf16=False,
                               host_eigh: Optional[bool] = True, device=None,
                               _rows: Optional[Tuple[int, int]] = None
                               ) -> Dict[str, np.ndarray]:
    """EMMAX over a ResidentGenome's packed rows sharded by rank, with the
    JAX package's arguments (and device=, the rank's: default the mesh's,
    its card) and distributed_emmax's return keys, equal to the port's
    emmax_resident at the same tier.

    Each rank holds only its shard of the packed rows (shard_packed_rows:
    uploaded once and memoized on the container; here a host-only
    container, from_source(upload=False), never goes whole to one device
    of a larger world; emmax_loco(mesh=)'s rank 0 holds it whole for that
    call, to build the kinships). Rank 0 fits the null and builds the
    rotated null at the tier, then one broadcast; each rank runs models/resident.py::emmax_scan_packed over
    its shard (exact: unpack, fp32 GEMM by U', kernel K3 a tile; int8
    tiers: kernel K2, then the mask pass; bf16 tiers: kernel K5, imputing
    per row on missing calls, then the mask pass); one all-gather; float64
    host p-values. The routes come from the container's own n, tile,
    has_missing and ploidy: no pass over dosages. An int8 tier on a
    container with missing calls raises, on every rank, before any
    collective. On a mesh with a 'sample' axis each rank uploads only its
    rows x its byte block and scans it by _tp_scan. _rows: (s, e), scan
    only the rows of [s, e) each rank's shard holds (LOCO's chromosomes;
    the result covers [s, e)), on either kind of mesh."""
    from mixmogam_tpu_torch.models.emmax import _as_design
    from mixmogam_tpu_torch.models.resident import (_default_dtype,
                                                    emmax_scan_packed)
    from mixmogam_tpu_torch.ops.scan import (normalize_rotate_tier,
                                             refuse_high_on_mesh)

    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    if n != rg.n:
        raise ValueError(f"y has {n} samples, resident genome {rg.n}")
    rd = normalize_rotate_tier(rotate_in_bf16)
    refuse_high_on_mesh(rd)
    if rd is not None and rd.startswith("int8") and rg.has_missing:
        raise ValueError("int8 tiers need fully-observed dosages")
    mesh, device = _mesh_device(mesh, device)
    if dtype is None:
        dtype = _default_dtype(device)
    X0 = _as_design(np.ones((n, 1)) if X0 is None else X0, n)
    s, e = (0, rg.M) if _rows is None else _rows
    if mesh.shape[1] > 1:
        out, rot, nulls = _tp_scan(None, rg, rg.has_missing, mesh, device,
                                   dtype, y, X0, K, eig_k, rd, False,
                                   ngrids, llim, ulim, esp, host_eigh,
                                   rg.tile, window=_rows)
        return _gathered_result(out, mesh, e - s, rot, nulls)
    rot, _, nulls = _replicated_null(mesh, device, dtype, y, X0, K, eig_k,
                                     rd, False, ngrids, llim, ulim, esp,
                                     host_eigh)

    # ---- this rank's shard, no communication ----
    shard = shard_packed_rows(rg, mesh, device=device)
    lo = host_snp_range(rg.M, mesh.shape[0], mesh.snp_index,
                        tile=rg.tile)[0]
    if _rows is None:
        rows, m = shard.packed, shard.M          # with the zero pad rows
    else:
        a, b = max(s, lo) - lo, min(e, lo + shard.M) - lo
        m = max(b - a, 0)
        rows = shard.packed[a:a + m]             # a view, as slice_rows
    out = (emmax_scan_packed(rows, rot, n, rg.tile,
                             impute=rg.has_missing)[:, :m]
           if m else torch.zeros((4, 0), dtype=dtype, device=device))
    return _gathered_result(out, mesh, e - s, rot, nulls)


def _step_int8(rows) -> Optional[np.ndarray]:
    """A rank's rows as int8 when every value is an integer the int8 rows
    hold as it is (int8 rows pass through, -1 included), else None: float
    rows with NaN or a fraction, negative or large values elsewhere. The
    cast of such rows to float is exact, so the step computes the same on
    either form."""
    from mixmogam_tpu_torch.models.source import as_int8_dosage

    if (np.dtype(rows.dtype) != np.int8
            and np.issubdtype(rows.dtype, np.floating)
            and np.isnan(rows).any()):
        return None            # as_int8_dosage would read NaN as -1
    return as_int8_dosage(rows)


def _raw_ibs_partial(rows, n: int, device) -> torch.Tensor:
    """The JAX step's _ibs_partial of a rank's rows as they are: 2 C'C -
    s 1' - 1 s' + m, in float64 on device, _KINSHIP_CHUNK rows at a time,
    with no imputation and whatever the dosages (the float form of K1's
    binary sharing count)."""
    from mixmogam_tpu_torch.ops.kinship import _ibs_binary_update

    part = torch.zeros((n, n), dtype=torch.float64, device=device)
    for s in range(0, rows.shape[0], _KINSHIP_CHUNK):
        C = torch.from_numpy(np.asarray(rows[s:s + _KINSHIP_CHUNK],
                                        dtype=np.float64)).to(device)
        _ibs_binary_update(part, C, float(C.shape[0]))
    return part


def rank_top(F: torch.Tensor, lo: int, k: int) -> torch.Tensor:
    """A rank's candidates for the top k of each trait: F (T, m) holds the
    statistics of its rows [lo, lo + m); returns (T, 2, min(k, m)) float64,
    [:, 0] the largest F of each trait and [:, 1] their global row indices
    (exact below 2^53), ties in row order (a stable sort)."""
    order = torch.sort(F, dim=1, descending=True, stable=True).indices[:, :k]
    return torch.stack([torch.gather(F, 1, order).double(),
                        (order + lo).double()], dim=1)


def select_top(h: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """(values (T, k), row indices (T, k) int64) of the top k of each
    trait among every rank's rank_top candidates h (T, 2, C): F descending,
    the lower row first among equal F, as jax.lax.top_k orders them."""
    vals, idx = h[:, 0], h[:, 1].astype(np.int64)
    pick = np.lexsort((idx, -vals), axis=-1)[:, :k]
    return (np.take_along_axis(vals, pick, axis=1),
            np.take_along_axis(idx, pick, axis=1))


def distributed_train_step(mesh: Optional[Mesh], G, Y, top_k: int = 8,
                           tile: Optional[int] = None, device=None
                           ) -> Dict[str, np.ndarray]:
    """One end-to-end multi-trait GWAS step over the mesh: the JAX
    package's distributed_train_step, with its arguments and return keys
    (top_f (T, k), top_idx (T, k), deltas (T,) and K (n, n), numpy on
    every rank) and timings_s.

    G: the (M, n) dosage matrix on every rank; Y: (T, n), a row a trait.
    1. K = (2 C'C - s 1' - 1 s' + m) / M, the JAX step's binary
       allele-sharing gram, unscaled, float64. Fully observed binary
       integer rows (float rows of 0 and 1 too) take distributed_kinship's
       integer route: kernel K1 on each rank's packed rows, one int64
       all-reduce. Any other G takes the same formula on its values as they
       are, in float64 (_raw_ibs_partial), one all-reduce: the JAX step has
       no ploidy refusal and no imputation, so neither has this.
    2. On rank 0, then one broadcast (on_rank0): eigh(K) and the spectrum
       of S(K+I)S in float64 (ops/eigen.py), the T REML fits in float64,
       batched over the traits (ops/reml.py::reml_from_spectrum, X0 the
       intercept), the traits' whitened nulls and the shared rotation
       U' = (I - P_X0) U (multi-trait's _trait_nulls and shared_rotation).
    3. Each rank's rows (rank_range at `tile`), a tile at a time: the
       design mask and one rotation G U' (an fp32 library GEMM on the card,
       TF32 off; integer rows go up as int8, binary rows as K1's packed
       rows, unpacked on the device), then kernel K3 once a trait.
    4. A rank's top_k rows a trait by F with their global indices, one
       all-gather of (T, 2, k) a rank (gather_rows), the final selection
       on the host. Ties take the lower row first, as jax.lax.top_k does;
       masked rows have F = 0, so where a trait has fewer than top_k
       unmasked rows its masked rows of lowest index fill its list.

    Where the JAX step differs (ROADMAP, "Where the reference itself
    deviates"): its REML runs in float32, its rotation is U, and top_k > M
    returns padding rows on a mesh of more than one device; here REML is
    float64, the rotation U', and top_k outside [1, M] raises ValueError on
    every rank. The JAX step shards G over 'snp' alone: on a mesh with a
    'sample' axis this step takes the world as a (world, 1) view, as
    distributed_kinship does. The rows of a rank start on a tile boundary,
    so every tile is the one a single device scans: top_f, top_idx and
    deltas are bit-equal across mesh shapes, and K is too where the gram
    is integer.

    The scan runs in float32 on the card and float64 on the CPU. tile:
    rows a tile (default multi-trait's, at most 16,384); device: the
    rank's (default the mesh's: its card). mesh None is
    make_mesh(devices=device), which raises without a card unless
    device="cpu". timings_s: seconds of kinship, eigh_spectrum, reml and
    nulls (rank 0's), broadcast (elsewhere with the wait for rank 0),
    rotation (the tile's load, the design mask and the GEMM), k3 and
    topk_gather, from CUDA events on the card (EMMA's _StageClock)."""
    from mixmogam_tpu_torch.models.emma import _StageClock
    from mixmogam_tpu_torch.models.multitrait import (_default_tile,
                                                      _flat_null,
                                                      _scan_tile_multitrait,
                                                      _trait_nulls,
                                                      _unflat_null)
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    _default_dtype)
    from mixmogam_tpu_torch.models.source import resolve_source
    from mixmogam_tpu_torch.ops.kinship import finish_on_device
    from mixmogam_tpu_torch.ops.pack2 import unpack_2bit_device
    from mixmogam_tpu_torch.ops.rotate import rotate_tile
    from mixmogam_tpu_torch.ops.scan import outside_design

    mesh, device = _mesh_device(mesh, device)
    flat = Mesh((mesh.world, 1), mesh.group, mesh.backend, mesh.rank,
                mesh.world, device)
    G = resolve_source(G)
    Y = np.atleast_2d(np.asarray(Y, dtype=np.float64))
    T, n = Y.shape
    if len(G.shape) != 2 or G.shape[1] != n:
        raise ValueError(f"G has shape {tuple(G.shape)}; Y has {n} samples")
    M = G.shape[0]
    if not 1 <= top_k <= M:
        raise ValueError(f"top_k={top_k} must lie in [1, M = {M}]")
    dtype = _default_dtype(device)
    tile = _default_tile(n, 1 << 28) if tile is None else int(tile)
    lo, hi = rank_range(M, flat, tile)
    rows = np.asarray(G[lo:hi])
    clock = _StageClock(device)

    # ---- 1. the kinship: one all-reduce of every rank's partial ----
    R8 = _step_int8(rows)
    here = R8 is not None and (not R8.size or (R8.min() >= 0
                                               and R8.max() <= 1))
    binary = not all_reduce(torch.tensor([0.0 if here else 1.0],
                                         dtype=torch.float64, device=device),
                            flat, dist.ReduceOp.MAX).item()
    shard = None
    if binary:
        if rows.shape[0]:
            shard = ResidentGenome.from_source(R8, ploidy=1, tile=tile,
                                               device=device)
        part = _ibs_counts(shard, n, device)
    else:
        part = _raw_ibs_partial(rows, n, device)
    K = finish_on_device(all_reduce(part, flat), float(M))
    del part
    clock.lap("kinship")

    # ---- 2. rank 0's eigh, spectrum, REML and nulls; one broadcast ----
    def null():
        from mixmogam_tpu_torch.ops.eigen import (eigen_k_on,
                                                  projected_spectrum)
        from mixmogam_tpu_torch.ops.reml import reml_from_spectrum
        from mixmogam_tpu_torch.ops.rotate import shared_rotation
        from mixmogam_tpu_torch.ops.scan import project_design

        t = _StageClock(device)
        phi, U = eigen_k_on(K, device)
        X0 = torch.ones((n, 1), dtype=torch.float64, device=device)
        xi, V = projected_spectrum(K, X0, device=device)
        t.lap("eigh_spectrum")
        Y64 = torch.as_tensor(Y, device=device)
        fit = reml_from_spectrum((Y64 @ V) ** 2, xi)
        deltas = fit["delta"].cpu().numpy()
        t.lap("reml")
        del V, xi
        U64 = torch.as_tensor(U).to(device=device, dtype=torch.float64)
        phi = torch.as_tensor(phi).to(device)
        nulls = _trait_nulls(phi.to(dtype), Y64 @ U64, U64.T @ X0, deltas,
                             dtype)
        Up, X0d, X0p = project_design(U64, X0)
        del U64
        rot = shared_rotation(Up, None, dtype)
        del Up
        t.lap("nulls")
        return _flat_null({
            "deltas": deltas,
            "h2s": fit["pseudo_heritability"].cpu().numpy(),
            "nulls": nulls, "rot": rot, "X0d": X0d.to(dtype),
            "X0p": X0p.to(dtype), "timings": t.seconds()})

    nl = _unflat_null(on_rank0(null, flat))
    clock.lap("null")

    # ---- 3. this rank's rows: a tile rotated once, K3 once a trait ----
    fs = []
    for s in range(0, hi - lo, tile):
        e = min(s + tile, hi - lo)
        if binary:
            Gt = unpack_2bit_device(shard.packed[s:e], n)
        else:
            Gt = torch.from_numpy(np.ascontiguousarray(
                rows[s:e] if R8 is None else R8[s:e])).to(device)
        keep = outside_design(Gt.to(dtype), nl["X0d"], nl["X0p"])
        Xr = rotate_tile(Gt if Gt.dtype == torch.int8 else Gt.to(dtype),
                         nl["rot"])
        clock.lap("rotation")
        fs.append(_scan_tile_multitrait(Xr, nl["nulls"], keep)[0])
        clock.lap("k3")
        del Gt, Xr, keep

    # ---- 4. a rank's top-k a trait, one all-gather, the selection ----
    F = (torch.cat(fs, dim=1) if fs
         else torch.zeros((T, 0), dtype=dtype, device=device))
    del fs
    vals, top_idx = select_top(
        gather_rows(rank_top(F, lo, top_k), flat).cpu().numpy(), top_k)
    top_f = vals.astype(torch.empty((), dtype=dtype).numpy().dtype)
    clock.lap("topk_gather")
    timings = {"rotation": 0.0, "k3": 0.0, **nl["timings"],
               **clock.seconds()}
    # off rank 0 the null's lap is the wait for rank 0 and the broadcast
    timings["broadcast"] = max(0.0, timings.pop("null") - sum(
        nl["timings"].values()))
    return {"top_f": top_f, "top_idx": top_idx, "deltas": nl["deltas"],
            "K": K, "timings_s": timings}
