"""Streamed EMMAX over a host genotype source, with tile-granular checkpoint
and resume (counterpart of mixmogam_tpu/models/streaming.py:
emmax_streamed, _impute_tile, _host_float_tile, finalize_scan,
_exact_rescore, rotate_streamed_to_device).

emmax_streamed reads the source tile by tile in a prep thread
(models/source.py::prefetch_iter) into a ring of pinned host buffers,
copies each tile to the card on a side CUDA stream, and scans it there:
the exact tier through the fp32 GEMM by the projected U and kernel K3, the
int8 / bf16 tiers by packing the tile on the card and one launch of K2 /
K5, and a fractional tile at a bf16 tier through the float route
(ops/rotate.py: bf16 products, then K3). Each tile's statistics can land
in a checkpoint directory with a manifest, and a killed run resumes from
the completed tiles.

Also here: rotate_streamed_to_device (G_rot = impute(G) @ U built on the
device tile by tile from a host source: stepwise's 'rotate once, scan
many') and the exact rescore's row reader source_rows (GxE's too).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time
import zipfile
from typing import Dict, Optional

import numpy as np
import torch


def _impute_means(t_i8: torch.Tensor, dtype=torch.float32):
    """(per-SNP means (m, 1) over the observed dosages in dtype, 0 for an
    all-missing row; the missing mask; the tile in dtype) — the rule of
    _impute_tile, shared with the bf16 scan's per-row means."""
    t = t_i8.to(dtype)
    miss = t_i8 < 0
    obs = torch.where(miss, torch.zeros((), dtype=dtype,
                                        device=t.device), t)
    cnt = torch.clamp((~miss).sum(dim=1, keepdim=True), min=1)
    return obs.sum(dim=1, keepdim=True) / cnt, miss, t


def _impute_tile(t_i8: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """int8 tile (m, n) with -1 missing -> float (dtype), per-SNP mean
    imputed on the tensor's device (oracle.kinship.mean_impute's rule)."""
    mu, miss, t = _impute_means(t_i8, dtype)
    return torch.where(miss, mu, t)


#: rows a block of _host_float_tile: 64 x 10,240 float64 values (5 MB) stay
#: in the CPU's cache through the block's passes
_IMPUTE_ROWS = 64


def _host_float_tile(chunk: np.ndarray, dtype, out=None) -> np.ndarray:
    """Float-source tile: NaN = missing, per-SNP mean imputed on the host
    (the mean in float64, 0 for an all-missing row), in the numpy dtype
    `dtype`, or cast into `out` when given. Works on a float64 COPY, a
    block of _IMPUTE_ROWS rows at a time:
    imputing a view in place would overwrite the caller's NaNs. The mean is
    nanmean's own arithmetic (the float64 row summed with zeros for NaN,
    over the count): the JAX package's values, bit for bit."""
    chunk = np.asarray(chunk)
    m, n = chunk.shape
    if out is None:
        out = np.empty((m, n), dtype)
    rows = _IMPUTE_ROWS
    C = np.empty((min(rows, m), n))
    miss = np.empty(C.shape, dtype=bool)
    for r in range(0, m, rows):
        e = min(r + rows, m)
        c, mb = C[:e - r], miss[:e - r]
        np.copyto(c, chunk[r:e])
        np.isnan(c, out=mb)
        cnt = n - np.count_nonzero(mb, axis=1)
        if (cnt < n).any():
            c[mb] = 0.0
            with np.errstate(invalid="ignore", divide="ignore"):
                mu = c.sum(axis=1) / cnt
            np.copyto(c, np.where(np.isnan(mu), 0.0, mu)[:, None], where=mb)
        np.copyto(out[r:e], c, casting="same_kind")
    return out


def host_tiles(G_src, dtype, device, tile: int = 16_384):
    """Float tiles (m, n) in dtype on device over the rows of a host
    source, in order: an int8 source (-1 missing) goes up as int8 and is
    mean-imputed on the device (_impute_tile); a float source (NaN
    missing, fractional dosages) is imputed per tile on the host
    (models/source.py: host_tile, then ship_tile)."""
    from mixmogam_tpu_torch.models.source import host_tile, ship_tile

    M, n = G_src.shape
    np_dt = torch.empty((), dtype=dtype).numpy().dtype
    for s in range(0, M, tile):
        e = min(s + tile, M)
        yield ship_tile(host_tile(G_src, s, e, e - s, n, np_dt), dtype,
                        device)


def rotate_tiles(tiles, M: int, n: int, U, dtype, device, design=None):
    """(G_rot, keep): G_rot (M, k) in dtype on device, the float tiles
    (which cover the M rows in order) times U (n, k), a full-fp32 GEMM on
    the card (TF32 off), or the tiles themselves for U=None (the identity
    K; k = n); one preallocated output, so the device holds G_rot and one
    tile. U may be a block of a rotation's output columns (the 'sample'
    route of models/stepwise.py). design: the (X0, X0p) of a projected U
    (ops/scan.py::project_design): keep is then outside_design of every
    row, from the same tiles; else None."""
    from mixmogam_tpu_torch.ops import assert_fp32_matmuls
    from mixmogam_tpu_torch.ops.scan import outside_design

    out = torch.empty((M, n if U is None else U.shape[1]), dtype=dtype,
                      device=device)
    keep = (None if design is None
            else torch.empty(M, dtype=torch.bool, device=device))
    if U is not None:
        U = U.to(device=device, dtype=dtype)
        assert_fp32_matmuls()
    s = 0
    for t in tiles:
        e = s + t.shape[0]
        out[s:e] = t if U is None else t @ U
        if keep is not None:
            keep[s:e] = outside_design(t, *design)
        s = e
    if s != M:
        raise ValueError(f"the tiles held {s} rows, not {M}")
    return out, keep


def rotate_streamed_to_device(G_src, U, dtype=None, tile: int = 16_384,
                              design=None, device=None):
    """(G_rot, keep) = rotate_tiles over host_tiles(G_src): the rotated
    genotype matrix of a host source built on the device (U's, else
    `device`: the card unless asked for the CPU). G_src: (M, n) sliceable,
    int8 (-1 missing) or float (NaN missing, fractional dosages)."""
    from mixmogam_tpu_torch.models.resident import _default_dtype
    from mixmogam_tpu_torch.ops import resolve_device

    device = U.device if U is not None else resolve_device(device)
    if dtype is None:
        dtype = _default_dtype(device)
    M, n = G_src.shape
    return rotate_tiles(host_tiles(G_src, dtype, device, tile), M, n, U,
                        dtype, device, design)


def finalize_scan(matrix_source, null, dtype, f_stats, mask,
                  betas=None, var_perc=None, with_betas: bool = True,
                  rescore_top: int = 0, rd=None, tier_name=None,
                  dof: int = 0, rescore_cut_M=None, fractional=False,
                  matmul_precision=None):
    """p-value finalize + threshold-complete exact rescore + output dict,
    shared by the in-core and resident paths. f_stats/mask (and betas/
    var_perc when given) are float64/bool host arrays, patched in place by
    the rescore pass, which engages only on an approximate tier: an int8
    or bf16 tier (rd set) or 'high' (matmul_precision, ops/scan.py::
    matmul_tier). rescore_cut_M: the study's SNP count for the rescore cut
    when these rows are part of it (LOCO); default the row count.
    fractional: the tier scanned fractional dosages (a bf16 tier's float
    route, or 'high' on imputed rows), whose drift sets the cut
    (ops/scan.py::FRACTIONAL_P_DRIFT)."""
    from mixmogam_tpu_torch.ops.scan import (select_rescore_idx,
                                             tier_drift_name)
    from mixmogam_tpu_torch.ops.stats import f_sf_host as _fsf

    dof = int(dof)
    ps = np.where(mask, _fsf(f_stats, 1.0, dof), 1.0)
    rescored = np.zeros(0, dtype=np.int64)
    if rescore_top and (rd is not None or matmul_precision):
        idx = select_rescore_idx(ps, rescore_top,
                                 tier_drift_name(rd, matmul_precision),
                                 M_cut=rescore_cut_M, fractional=fractional)
        idx, d_ex = _exact_rescore(matrix_source, idx, null, dtype)
        f_stats[idx] = d_ex["f_stats"]
        mask[idx] = d_ex["mask"]
        ps[idx] = np.where(mask[idx], _fsf(f_stats[idx], 1.0, dof), 1.0)
        if betas is not None:
            betas[idx] = d_ex["betas"]
            var_perc[idx] = d_ex["var_perc"]
        rescored = idx
    out = {
        "ps": ps, "f_stats": f_stats, "mask": mask,
        "rescored_idx": rescored,
        "pseudo_heritability": float(null.pseudo_heritability),
        "delta": float(null.delta), "sigma_g2": float(null.sigma_g2),
        "sigma_e2": float(null.sigma_e2), "dof": dof,
        "ll_null": float(null.ll),
        "precision_tier": (tier_name if tier_name is not None
                           else (matmul_precision or rd or "exact")),
    }
    if with_betas and betas is not None:
        out["betas"] = betas
        out["var_perc"] = var_perc
    return out


def source_rows(matrix_source, idx, dtype, device) -> torch.Tensor:
    """Rows idx of a host source (a ResidentGenome answers from its host
    copy of the packed rows), mean-imputed, in dtype on device: the exact
    rescores' input."""
    rows = np.asarray(matrix_source[idx])
    if rows.dtype == np.int8:
        return _impute_tile(torch.as_tensor(rows, device=device), dtype)
    return torch.as_tensor(_host_float_tile(rows, np.float64),
                           device=device).to(dtype)


def _exact_rescore(matrix_source, idx, null, dtype, tile: int = 16_384):
    """Re-test SNP rows `idx` at the exact tier. Rows come from the host
    source (a ResidentGenome answers from its host copy of the packed
    rows, never by a read-back from the card), strictly increasing and
    unique; the scan runs on the null model's device, tile by tile."""
    from mixmogam_tpu_torch.ops.scan import (build_rotated_null,
                                             emmax_scan_stats, stats_dict)

    idx = np.unique(np.asarray(idx, dtype=np.int64))
    rot_ex = build_rotated_null(null)       # exact tier, same delta
    dev = null.U.device
    outs = []
    for s in range(0, len(idx), tile):
        rows_d = source_rows(matrix_source, idx[s:s + tile], dtype, dev)
        outs.append(stats_dict(emmax_scan_stats(rows_d, rot_ex)))
    if not outs:
        return idx, {"f_stats": np.zeros(0), "betas": np.zeros(0),
                     "var_perc": np.zeros(0),
                     "mask": np.zeros(0, dtype=bool)}
    return idx, {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}


def _run_key(src, M: int, n: int, tile: int, delta: float, q: int, rd,
             mp, dtype, y: np.ndarray, X0: np.ndarray) -> str:
    """The checkpoint run key: sha256 of the shapes, the tile, delta, q,
    the tier (rd and the matmul precision mp, ops/scan.py::matmul_tier:
    'high' or None, so an exact run's tiles are never taken for a 'high'
    run's) and the compute dtype (the port's torch name, so that a JAX
    run's directory is never taken for a port run's), of y and X0, and of
    a sample of source rows {0, M - 1, every M // 32} (the genotypes can
    change under the same model; hashing the whole source would read it
    twice); first 12 hex digits, the JAX package's key layout."""
    h = hashlib.sha256(f"{M}:{n}:{tile}:{delta:.10g}:{q}:{rd}:{mp}:"
                       f"{dtype}".encode())
    h.update(np.ascontiguousarray(y).tobytes())
    h.update(np.ascontiguousarray(np.asarray(X0, np.float64)).tobytes())
    for r in sorted({0, M - 1, *range(0, M, max(M // 32, 1))}):
        h.update(np.ascontiguousarray(np.asarray(src[r:r + 1])).tobytes())
    return h.hexdigest()[:12]


class _Checkpoint:
    """manifest_<key>.json ({'done', 'n_tiles', 'delta'}) and one
    tile_<key>_<t>.npz a completed tile (f_stats, betas, var_perc, mask),
    the JAX package's files. Every write is a tmp file and os.replace, so a
    kill mid-write leaves the previous file whole. A manifest that cannot
    be read (truncated by a writer without that rule) restarts from the
    tile files alone."""

    def __init__(self, directory: str, key: str, n_tiles: int,
                 delta: float):
        os.makedirs(directory, exist_ok=True)
        self.dir, self.key = directory, key
        self.n_tiles, self.delta = n_tiles, delta
        self.mpath = os.path.join(directory, f"manifest_{key}.json")
        self.done = set()
        if os.path.exists(self.mpath):
            try:
                with open(self.mpath) as f:
                    self.done = {int(t) for t in json.load(f)["done"]}
            except (json.JSONDecodeError, KeyError, TypeError, ValueError):
                self.done = {t for t in range(n_tiles)
                             if os.path.exists(self.tile_path(t))}

    def tile_path(self, t: int) -> str:
        return os.path.join(self.dir, f"tile_{self.key}_{t}.npz")

    def restore(self, t: int) -> Optional[Dict[str, np.ndarray]]:
        """Tile t's arrays, or None when it is not done or its file is
        missing or unreadable (it is then scanned again)."""
        if t not in self.done:
            return None
        try:
            with np.load(self.tile_path(t)) as z:
                return {k: z[k] for k in ("f_stats", "betas", "var_perc",
                                          "mask")}
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            return None

    def store(self, t: int, arrays: Dict[str, np.ndarray]) -> None:
        path = self.tile_path(t)
        np.savez(path + ".tmp.npz", **arrays)
        os.replace(path + ".tmp.npz", path)
        self.done.add(t)
        with open(self.mpath + ".tmp", "w") as f:
            json.dump({"done": sorted(self.done), "n_tiles": self.n_tiles,
                       "delta": self.delta}, f)
        os.replace(self.mpath + ".tmp", self.mpath)


def _check_fast_tile(chunk: np.ndarray, t: int, rd: str) -> bool:
    """An int8 tile at an int8 / bf16 tier: dosages 0..2 (-1 missing), the
    codes a packed row holds. Returns whether the tile has missing calls,
    which an int8 tier refuses (the digit planes take integer genotypes;
    mean-imputed fractions would be rounded)."""
    lo, hi = int(chunk.min(initial=0)), int(chunk.max(initial=0))
    if lo < -1 or hi > 2:
        raise ValueError(f"tier {rd!r} packs dosages 0..2 (-1 missing); "
                         f"tile {t} holds values in [{lo}, {hi}]")
    if lo < 0 and rd.startswith("int8"):
        raise ValueError(
            f"tier {rd!r} requires a fully-observed genotype source (tile "
            f"{t} has missing dosages; mean-imputed fractions would be "
            "rounded by the digit-plane cast). Use the exact/bf16 tiers.")
    return lo < 0


def _fast_tile_of_floats(raw: np.ndarray, t: int, rd: str):
    """A float source's tile at an int8 / bf16 tier as int8 dosages (NaN ->
    -1), which the packed kernels read, or None for a fractional tile at a
    bf16 tier (it takes the float route); an int8 tier refuses fractions."""
    from mixmogam_tpu_torch.models.source import as_int8_dosage

    G8 = as_int8_dosage(np.asarray(raw))
    if G8 is None and rd.startswith("int8"):
        raise ValueError(f"tier {rd!r} requires integer dosages (tile {t} "
                         "has fractional values). Use the exact tier.")
    return G8


#: the prep thread's mark of a tile that takes the float route
_FLOAT_TILE = "float"


class _PinnedRing:
    """`slots` pinned host buffers and their device twins, for the copy of
    a tile to the card on a side stream. Slot b's host buffer is handed to
    the prep thread through `free` (a queue of slot numbers); the thread
    fills it with numpy only. Slot b returns to `free` once its copy event
    has completed: that is when the host buffer may be written again. The
    copy into the device buffer waits on the event that marks the end of
    the compute that last read it."""

    def __init__(self, slots: int, rows: int, n: int, np_dtype, device):
        import queue

        tdt = torch.from_numpy(np.zeros(0, np_dtype)).dtype
        self.host = [torch.empty((rows, n), dtype=tdt, pin_memory=True)
                     for _ in range(slots)]
        self.host_np = [h.numpy() for h in self.host]
        self.dev = [torch.empty((rows, n), dtype=tdt, device=device)
                    for _ in range(slots)]
        self.copied = [torch.cuda.Event() for _ in range(slots)]
        self.used = [None] * slots
        self.copy_stream = torch.cuda.Stream(device)
        self.free = queue.Queue()
        for b in range(slots):
            self.free.put(b)
        self.held = []          # slots whose copy is in flight, oldest first
        self.closed = False

    def take(self):
        """(prep thread) a free slot number; None once the ring is
        closed."""
        return None if self.closed else self.free.get()

    def upload(self, b: int, m: int) -> torch.Tensor:
        """Copy rows [0, m) of slot b to the card on the side stream; the
        current (compute) stream waits for that copy. Returns the device
        rows."""
        comp = torch.cuda.current_stream(self.dev[b].device)
        if self.used[b] is not None:
            self.copy_stream.wait_event(self.used[b])
        with torch.cuda.stream(self.copy_stream):
            self.dev[b][:m].copy_(self.host[b][:m], non_blocking=True)
            self.copied[b].record(self.copy_stream)
        comp.wait_event(self.copied[b])
        self.held.append(b)
        return self.dev[b][:m]

    def computed(self, b: int) -> None:
        """Mark the end of the compute that read slot b's device rows."""
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.dev[b].device))
        self.used[b] = ev

    def recycle(self) -> None:
        """Return every slot whose copy has completed to the prep thread,
        and while none is free, wait for the oldest copy: the thread then
        always has a slot to fill or a filled one waiting."""
        while self.held and (self.copied[self.held[0]].query()
                             or self.free.empty()):
            b = self.held.pop(0)
            self.copied[b].synchronize()
            self.free.put(b)

    def close(self) -> None:
        """Stop handing out slots: a prep thread waiting for one gets None,
        and the preps queued behind it return at once, so the executor that
        runs them can shut down after a failure on either side."""
        self.closed = True
        for _ in range(len(self.host) + 1):
            self.free.put(None)


def emmax_streamed(matrix_source, y, K=None, X0: Optional[np.ndarray] = None,
                   eig_k=None, tile: int = 32_768, inflight: int = 4,
                   checkpoint_dir: Optional[str] = None,
                   ngrids: int = 100, llim: float = -10.0, ulim: float = 10.0,
                   esp: float = 1e-6, rotate_in_bf16=False,
                   precision: Optional[str] = None, dtype=None,
                   host_eigh: Optional[bool] = None, with_betas: bool = True,
                   rescore_top: int = 0, pack_transfer=None,
                   rescore_cut_M: Optional[int] = None, device=None
                   ) -> Dict[str, np.ndarray]:
    """EMMAX over a host genotype source, tile by tile, with the JAX
    package's arguments and return dict.

    matrix_source: (M, n), sliceable by [start:stop] (numpy, np.memmap, or
    any object with shape, dtype and row slices). An int8 source (-1 =
    missing) goes up as int8 and is mean-imputed on the device; a float
    source (NaN = missing, fractional dosages) is imputed per tile on the
    host. device: the card by default (without one the call raises), 'cpu'
    on request. dtype (a torch dtype): float32 on the card, float64 on the
    CPU by default. host_eigh: None takes the card's float64 eigh on the
    card and host LAPACK on the CPU; True asks for host LAPACK.

    Tiers (precision=, or the legacy rotate_in_bf16): 'exact' imputes each
    tile and rotates it by the projected U' = (I - P_X0) U (a full-fp32
    GEMM, TF32 off), masks the rows inside col(X0) and runs kernel K3 once a
    tile. 'int8x2/3/4' and 'bf16' / 'bf16x2' / 'bf16x3' pack each tile on
    the card and launch K2 / K5 once a tile on the folded W'' (the resident
    route's emmax_scan_packed); an int8 tier refuses a tile with missing
    calls or fractional dosages, a bf16 tier imputes missing calls in K5.
    A float source at a bf16 tier travels as float rows: a tile of integer
    dosages is packed on the card for K5, a fractional tile takes the
    float route (ops/rotate.py: a bf16 rotation by the parts of the exact
    tier's U', then K3), and the rescore cut takes the float route's drift
    (ops/scan.py::FRACTIONAL_P_DRIFT). 'auto' and 'fast' resolve by
    ops/scan.py::resolve_precision (on the card a fully observed int8
    source takes int8x3 / int8x2 and any other source exact / bf16; on the
    CPU both are exact), 'fast' with rescore_top = 1024. 'high' takes the
    exact tier's route, each tile rotated in three bf16 passes
    (ops/rotate.py::rotate_high; a fully observed int8 tile as int8, its
    zero lo part skipped), and its checkpoint key carries 'high'.
    rescore_cut_M: the study's SNP count for the rescore cut when the
    source is part of it (LOCO).
    pack_transfer is accepted and changes nothing: the port ships int8 and
    packs on the card.

    The pipeline: a prep thread (models/source.py::prefetch_iter) reads and
    checks each tile with numpy and fills one of `inflight` pinned host
    buffers; the main thread copies it to the card on a side CUDA stream
    and queues the tile's scan on the current stream behind that copy; at
    most `inflight` tiles' (4, rows) outputs wait on the card before their
    copy to the host. The kernels' tiles are not padded: the last one
    scans its own rows. The exact tier rotates a short last tile at the
    height of the others, its rows then zeros, as a ResidentGenome pads
    its rows: a GEMM may round a row differently as the product's height
    changes (cuBLAS does), and a row's statistics then do not depend on
    where the source ends (bit-equal to emmax_resident at the same tile).

    checkpoint_dir: each completed tile's statistics land there with a
    manifest (_Checkpoint), keyed on the model, tier, dtype and a sample of
    the source; a run with the same key restores the completed tiles and
    scans only the others.

    Returns emmax()'s dict plus 'stream_stats': tiles, scanned, restored,
    h2d_bytes (the bytes copied to the card), prep_wait_s (host seconds the
    main thread waited on the prep thread), busy_s (the card's seconds in
    the tiles' work, from CUDA events) and scan_s (the scan loop's host
    seconds); h2d_bytes and busy_s are None on the CPU."""
    from mixmogam_tpu_torch.models.emmax import _as_design
    from mixmogam_tpu_torch.models.resident import (_default_dtype,
                                                    emmax_scan_packed)
    from mixmogam_tpu_torch.models.source import prefetch_iter
    from mixmogam_tpu_torch.ops import resolve_device
    from mixmogam_tpu_torch.ops.pack2 import pack_2bit_device
    from mixmogam_tpu_torch.ops.reml import (esp_to_refine_iters,
                                             fit_null_model)
    from mixmogam_tpu_torch.ops.rotate import (float_route_eig,
                                               float_rotation,
                                               scan_float_rows)
    from mixmogam_tpu_torch.ops.scan import (build_rotated_null,
                                             emmax_scan_stats, matmul_tier,
                                             normalize_rotate_tier,
                                             resolve_precision)

    device = resolve_device(device)
    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    M = matrix_source.shape[0]
    if matrix_source.shape[1] != n:
        raise ValueError(
            f"matrix_source is (M={M}, {matrix_source.shape[1]}) but y has "
            f"{n} samples; expected an (M, n_samples) SNP-major source")
    if tile < 1 or inflight < 1:
        raise ValueError(f"tile ({tile}) and inflight ({inflight}) must be "
                         "positive")
    if str(precision) == "fast" and not rescore_top:
        rescore_top = 1024
    if dtype is None:
        dtype = _default_dtype(device)
    X0 = _as_design(np.ones((n, 1)) if X0 is None else X0, n)
    q = X0.shape[1]
    tier_name = None
    if precision is not None:
        if rotate_in_bf16:
            raise ValueError("pass either precision= or the legacy "
                             "rotate_in_bf16 kwarg, not both")
        probe = None
        if (str(precision) in ("auto", "fast")
                and np.dtype(getattr(matrix_source, "dtype",
                                     np.float64)) == np.int8):
            # an int8 source takes an int8 tier only when the WHOLE source
            # is fully observed: one chunked pass for the missing sentinel.
            # A float source never does (its integrality would cost a
            # second pass over the data); precision='int8x*' is checked
            # per tile
            missing = any((np.asarray(matrix_source[s0:s0 + 65_536])
                           < 0).any() for s0 in range(0, M, 65_536))
            probe = (np.full((1, 1), np.nan) if missing
                     else np.zeros((1, 1), dtype=np.int8))
        rotate_in_bf16, tier_name = resolve_precision(precision, G=probe,
                                                      device=device)
    rd, mp = matmul_tier(normalize_rotate_tier(rotate_in_bf16))
    # a float source at a bf16 tier: each tile of integer dosages goes to
    # K5 packed, each fractional tile takes the float route (ops/rotate.py),
    # which cuts its parts from the null's eigenbasis in float64
    int8_source = np.dtype(getattr(matrix_source, "dtype",
                                   np.int8)) == np.int8
    float_tiles = (not int8_source and rd is not None
                   and rd.startswith("bf16"))
    if float_tiles:
        eig_k = float_route_eig(K, eig_k, device, host_eigh)
    null = fit_null_model(y, X0, K=K, eig_k=eig_k, ngrids=ngrids, llim=llim,
                          ulim=ulim, refine_iters=esp_to_refine_iters(
                              esp, ngrids, llim, ulim),
                          host_eigh=host_eigh,
                          eigh_dtype=(np.float32 if str(precision) == "fast"
                                      else None),
                          device=device, dtype=dtype)
    rot = build_rotated_null(null, rotate_dtype=rd, matmul_precision=mp)
    if rd is not None:
        # K2 / K5 take rss0 and dof as host numbers: read them once here,
        # not at each tile's launch (a read from the card waits for its
        # queue, which would stall the pipeline every tile)
        rot = dataclasses.replace(rot, rss0=float(rot.rss0),
                                  dof=float(rot.dof))
    dof = n - q - 1

    n_tiles = -(-M // tile)
    ck = (_Checkpoint(checkpoint_dir,
                      _run_key(matrix_source, M, n, tile, float(null.delta),
                               q, rd, mp, dtype, y, X0),
                      n_tiles, float(null.delta))
          if checkpoint_dir else None)
    f_stats = np.zeros(M)
    betas = np.zeros(M)
    var_perc = np.zeros(M)
    mask = np.zeros(M, dtype=bool)
    outs = {"f_stats": f_stats, "betas": betas, "var_perc": var_perc,
            "mask": mask}

    def place(t, arrays):
        s, e = t * tile, min((t + 1) * tile, M)
        for k, v in arrays.items():
            outs[k][s:e] = v

    todo = []
    for t in range(n_tiles):
        got = ck.restore(t) if ck is not None else None
        if got is None:
            todo.append(t)
        else:
            place(t, got)

    # ---- the host side: the prep thread reads, checks, imputes ----
    np_dt = torch.empty((), dtype=dtype).numpy().dtype
    # a float source's tiles travel as float rows in the compute dtype at a
    # bf16 tier too: K5's tiles are cast to int8 on the card
    buf_dt = (np.int8 if int8_source or (rd is not None and not float_tiles)
              else np_dt)
    cuda = device.type == "cuda"
    ring = (_PinnedRing(inflight, min(tile, M), n, buf_dt, device)
            if cuda and todo else None)

    def read(t):
        s, e = t * tile, min((t + 1) * tile, M)
        raw = matrix_source[s:e]
        chunk = None
        if rd is not None and not int8_source:
            chunk = _fast_tile_of_floats(raw, t, rd)
        if (rd is None and not int8_source) or (float_tiles
                                                and chunk is None):
            # imputed on the host, straight into the pinned buffer on the
            # card's path: the exact tier, or a fractional tile at a bf16
            # tier
            kind = None if rd is None else _FLOAT_TILE
            if ring is None:
                return None, _host_float_tile(raw, np_dt), kind
            b = ring.take()
            if b is not None:
                _host_float_tile(raw, np_dt, out=ring.host_np[b][:e - s])
            return b, None, kind
        if int8_source:
            chunk = np.asarray(raw, dtype=np.int8)
        if rd is not None:
            missing = _check_fast_tile(chunk, t, rd)
        else:
            # the 'high' tier rotates a fully observed int8 tile as int8
            missing = bool(mp) and bool((chunk < 0).any())
        if ring is None:
            return None, np.array(chunk), missing
        b = ring.take()
        if b is not None:
            np.copyto(ring.host_np[b][:e - s], chunk)
        return b, None, missing

    def prep(t):
        # runs in prefetch_iter's thread: numpy and pinned host memory only
        if ring is None:
            return read(t)
        if ring.closed:
            return None, None, None
        try:
            return read(t)
        except BaseException:
            ring.close()               # the preps queued behind this one
            raise

    float_route = {}

    def scan(td, missing):
        if rd is None:
            # an int8 tile is imputed, but at 'high' a fully observed one
            # stays int8 (the resident route's rows at that tier)
            Gt = (_impute_tile(td, dtype)
                  if td.dtype == torch.int8 and (mp is None or missing)
                  else td)
            m = Gt.shape[0]
            if m < min(tile, M):
                Gt = torch.cat([Gt, Gt.new_zeros((min(tile, M) - m, n))])
            return emmax_scan_stats(Gt, rot)[:, :m]
        if missing == _FLOAT_TILE:
            if not float_route:
                # the float route's rotation, built at its first tile
                float_route.update(
                    rot=build_rotated_null(null),
                    srot=float_rotation(eig_k[1], X0, rd, dtype, device))
            return scan_float_rows(td.to(dtype), float_route["srot"],
                                   float_route["rot"])
        packed = pack_2bit_device(td.to(torch.int8))
        return emmax_scan_packed(packed, rot, n, packed.shape[0],
                                 impute=bool(missing))

    def drain(t, out):
        h = out.cpu().double().numpy()
        arrays = {"f_stats": h[0], "betas": h[1], "var_perc": h[2],
                  "mask": h[3] > 0.5}
        place(t, arrays)
        if ck is not None:
            ck.store(t, arrays)

    # ---- the device side: copy on a side stream, scan, d2h ----
    stats = {"tiles": n_tiles, "scanned": len(todo),
             "restored": n_tiles - len(todo),
             "h2d_bytes": 0 if cuda else None,
             "prep_wait_s": 0.0, "busy_s": None if not cuda else 0.0}
    marks = []
    pending = []
    it = prefetch_iter(todo, prep, lookahead=inflight)
    ts = time.perf_counter()
    try:
        while True:
            tw = time.perf_counter()
            try:
                t, (b, chunk, missing) = next(it)
            except StopIteration:
                break
            stats["prep_wait_s"] += time.perf_counter() - tw
            m = min((t + 1) * tile, M) - t * tile
            if ring is None:
                td = torch.from_numpy(chunk).to(device)
            else:
                td = ring.upload(b, m)
            if cuda:
                stats["h2d_bytes"] += td.numel() * td.element_size()
                ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                            for _ in range(2))
                ev0.record()
            out = scan(td, missing)
            if cuda:
                ev1.record()
                marks.append((ev0, ev1))
                ring.computed(b)
                ring.recycle()
            pending.append((t, out))
            if len(pending) >= inflight:
                drain(*pending.pop(0))
        for item in pending:
            drain(*item)
    finally:
        if ring is not None:
            ring.close()
        it.close()
    if cuda and marks:
        torch.cuda.synchronize(device)
        stats["busy_s"] = sum(a.elapsed_time(b) for a, b in marks) / 1e3
    stats["scan_s"] = time.perf_counter() - ts
    res = finalize_scan(matrix_source, null, dtype, f_stats, mask,
                        betas=betas, var_perc=var_perc,
                        with_betas=with_betas, rescore_top=rescore_top,
                        rd=rd, tier_name=tier_name, dof=dof,
                        rescore_cut_M=rescore_cut_M, matmul_precision=mp,
                        fractional=float_tiles or bool(mp
                                                       and not int8_source))
    res["stream_stats"] = stats
    return res
