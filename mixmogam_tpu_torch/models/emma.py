"""EMMA exact scan (counterpart of mixmogam_tpu/models/emma.py:
_logdet_xtx_tile, _f_stats_at_delta, _emma_tile_stats, emma).

Per SNP j the model is y = [X0, g_j] b + u + e with its OWN delta_j:
  1. delta_j by REML (grid + bisection, the reference's defaults),
  2. F-test of g_j at delta_j: F = (rss0_j - rss1_j) / (rss1_j / (n-q-1)),
     both RSS by GLS at delta_j,
  3. or an LRT against the null ML fit (test='lrt').
eigh(K) runs once; each SNP tile is rotated once, G_tile @ U, and
ops/xreml.py's emma_grid and emma_refine (the two stages of
emma_delta_scan) run the batched grid and bisection over it.

The whole per-SNP REML runs in float64 by default, on the card as on the
CPU: the rotation, the grid, the brackets, the bisection and the final
moments. The JAX package runs it in the device's float32, where a flat
REML surface can flip the grid argmax to another bracket; the card's
float64 products keep it exact for little cost at EMMA's sample counts.
dtype=torch.float32 computes what the JAX package computes in float32.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from mixmogam_tpu_torch.ops.xreml import (_assemble_gram, _snp_moments,
                                          chol_logdet_small, chol_small,
                                          chol_solve_small, emma_grid,
                                          emma_refine)


class _StageClock:
    """Seconds of each stage of a scan, summed over its tiles. On the card
    an event marks each stage's end on the device's stream and all are read
    once, after the scan, so no stage waits for the device; on the CPU,
    where each op returns when it is done, the host clock."""

    def __init__(self, device):
        self._stream = (torch.cuda.current_stream(device)
                        if torch.device(device).type == "cuda" else None)
        self._laps = []
        self._last = self._mark()

    def _mark(self):
        if self._stream is None:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self._stream)
        return ev

    def lap(self, stage: Optional[str] = None) -> None:
        """End the stage that ran since the last lap (stage=None: drop it)."""
        t = self._mark()
        if stage is not None:
            self._laps.append((stage, self._last, t))
        self._last = t

    def seconds(self) -> Dict[str, float]:
        if self._stream is not None:
            self._stream.synchronize()
        out: Dict[str, float] = {}
        for stage, a, b in self._laps:
            dt = b - a if self._stream is None else a.elapsed_time(b) / 1e3
            out[stage] = out.get(stage, 0.0) + dt
        return out


def _logdet_xtx_tile(Gt, X0_rot):
    """ln|[X0 g]'[X0 g]| per SNP of a rotated tile (U is orthogonal, so it
    is computable rotated)."""
    A = _assemble_gram(X0_rot.T @ X0_rot, Gt @ X0_rot, (Gt * Gt).sum(dim=1))
    return chol_logdet_small(chol_small(A))


def _f_stats_at_delta(Gt, X0_rot, y_rot, phi, log_delta, beta):
    """(rss0, rss1, mask) per SNP at the SNP's own delta: the GLS RSS of
    the null design and of the full design (beta (m, q + 1), the full
    model's fit), and the collinearity mask of g against X0 under those
    weights.

    Both RSS are weighted sums of explicit residuals, where the JAX function
    takes rss0 = c - b0'A00^-1 b0 and rss1 = yPy from the moments. Where K
    is singular along X0 and delta small (VanRaden's K along the intercept),
    the moments carry a 1/delta-weighted coordinate that cancels in those
    differences, and rss0 - rss1 of a SNP that explains little would keep
    rounding noise of the order of itself."""
    d = torch.exp(log_delta)[:, None]
    w = 1.0 / (phi[None, :] + d)
    A00, b0, _, a01, a11, _ = _snp_moments(Gt, X0_rot, y_rot, w)
    L0 = chol_small(A00)
    q = X0_rot.shape[1]
    r0 = y_rot[None, :] - chol_solve_small(L0, b0) @ X0_rot.T
    r1 = y_rot[None, :] - beta[:, :q] @ X0_rot.T - beta[:, q:] * Gt
    xx = a11 - (a01 * chol_solve_small(L0, a01)).sum(dim=-1)
    fi = torch.finfo(Gt.dtype)
    return ((w * r0 * r0).sum(dim=1), (w * r1 * r1).sum(dim=1),
            xx > 100.0 * fi.eps * torch.clamp(a11, min=fi.tiny))


def _emma_tile_stats(Gt_raw, U, X0_rot, y_rot, phi, ngrids: int,
                     llim: float, ulim: float, reml: bool,
                     refine_iters: int, n: int, q: int,
                     clock: Optional[_StageClock] = None
                     ) -> Dict[str, torch.Tensor]:
    """One tile of the EMMA pipeline: rotate -> grid + bisection per SNP
    -> F at the SNP's delta. clock: laps 'rotation' (with the tile's
    unpack or upload before it), 'grid', 'refine' and 'f'."""
    from mixmogam_tpu_torch.ops import assert_fp32_matmuls

    lap = clock.lap if clock is not None else (lambda stage=None: None)
    if U.dtype == torch.float32:
        assert_fp32_matmuls()
    Gt = Gt_raw @ U
    ld_xtx = _logdet_xtx_tile(Gt, X0_rot)
    lap("rotation")
    grid, k1, k2 = emma_grid(Gt, X0_rot, y_rot, phi, ld_xtx, ngrids, llim,
                             ulim, reml)
    lap("grid")
    r = emma_refine(Gt, X0_rot, y_rot, phi, ld_xtx, grid, k1, k2,
                    refine_iters, reml)
    lap("refine")
    rss0, rss1, mask = _f_stats_at_delta(Gt, X0_rot, y_rot, phi,
                                         r["log_delta"], r["beta"])
    f = (rss0 - rss1) * (n - q - 1) / torch.clamp(
        rss1, min=torch.finfo(Gt.dtype).tiny)
    f = torch.where(mask, torch.clamp(f, min=0.0), 0.0)
    lap("f")
    return {"delta": r["delta"], "ll": r["ll"], "f": f,
            "beta": r["beta"][:, -1], "mask": mask}


def emma(G, y, K=None, X0: Optional[np.ndarray] = None,
         eig_k: Optional[Tuple] = None, ngrids: int = 100,
         llim: float = -10.0, ulim: float = 10.0, esp: float = 1e-6,
         tile: int = 2048, dtype=torch.float64, test: str = "f",
         stream_budget_bytes: Optional[int] = None, mesh=None,
         device=None) -> Dict[str, np.ndarray]:
    """EMMA exact scan with the JAX package's arguments and return dict:
    f_stats, deltas, betas, mask, lls, pseudo_heritabilities, ps (and
    lrt_stats for test='lrt'), plus timings_s (seconds of the eigh, the
    rotation, the grid, the bisection, the F statistics and the p-values;
    device time on the card).

    G: a ResidentGenome (scanned on its own device, tile by tile, each
    unpacked and mean-imputed there), or a GenotypeData or (M, n) array
    (int8 with -1 missing, or float dosages with NaN missing) scanned on
    `device`: the card by default (without one the call raises), 'cpu' on
    request. A host source goes up `tile` rows at a time, whatever its
    size, so stream_budget_bytes (the JAX signature's switch to streaming)
    changes nothing. K: (n, n) kinship, or eig_k = (phi, U).
    dtype: float64 by default on every device; torch.float32 is accepted.
    test: 'f' (REML deltas, F-test) or 'lrt' (ML deltas, likelihood ratio
    against the null ML fit).

    mesh: a parallel.Mesh (make_mesh()) shards the scan by SNP rows, as
    the JAX package's mesh= does: rank 0 takes eigh(K) (K or eig_k needed
    there only) and, for test='lrt', the null ML fit, and one broadcast
    replicates them; each rank scans its rows with no communication (a
    ResidentGenome's shard, parallel/distributed.py::shard_packed_rows, a
    host source's rows at `tile`, host_snp_range), and the per-SNP results
    meet in one all-gather. Every rank returns the whole result; device:
    the rank's (default the mesh's)."""
    from mixmogam_tpu_torch.models.emmax import _as_design
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    _float_tiles,
                                                    resident_and_device)
    from mixmogam_tpu_torch.models.source import resolve_source
    from mixmogam_tpu_torch.models.streaming import host_tiles
    from mixmogam_tpu_torch.ops.reml import (esp_to_refine_iters,
                                             fit_null_model)
    from mixmogam_tpu_torch.ops.rotate import float_route_eig
    from mixmogam_tpu_torch.ops.stats import chi2_sf_host, f_sf_host
    from mixmogam_tpu_torch.parallel import distributed as pd

    if mesh is not None:
        mesh, device = pd.mesh_entry(mesh, G, "emma", device)
    if test not in ("f", "lrt"):
        raise ValueError(f"test must be 'f' or 'lrt'; got {test!r}")
    refine_iters = esp_to_refine_iters(esp, ngrids, llim, ulim)
    y = np.asarray(y, dtype=np.float64).ravel()
    n = y.shape[0]
    if mesh is None:
        rg, device = resident_and_device(G, device)
    else:
        # a host-only container stays on the host: each rank takes its shard
        rg = G if isinstance(G, ResidentGenome) else None
    if rg is not None and rg.n != n:
        raise ValueError(f"y has {n} samples but the resident genome holds "
                         f"{rg.n}")
    X0 = _as_design(np.ones((n, 1)) if X0 is None else X0, n)
    q = X0.shape[1]
    reml = test != "lrt"

    def null() -> Dict:
        """The eigenbasis in dtype, y and X0 rotated, and the null ML fit's
        log likelihood for the LRT."""
        phi, U = float_route_eig(K, eig_k, device)
        phi = torch.as_tensor(phi).to(device=device, dtype=dtype)
        U = torch.as_tensor(U).to(device=device, dtype=dtype)
        out = {"phi": phi, "U": U,
               "y_rot": U.T @ torch.as_tensor(y, device=device).to(dtype),
               "X0_rot": U.T @ torch.as_tensor(X0, device=device).to(dtype),
               "ll_null": None}
        if not reml:
            out["ll_null"] = float(fit_null_model(
                y, X0, eig_k=(phi, U), ngrids=ngrids, llim=llim, ulim=ulim,
                ml=True, device=device, dtype=dtype).ll)
        return out

    clock = _StageClock(device)
    # on a mesh rank 0's, replicated by one broadcast
    nl = pd.on_rank0(null, mesh)
    clock.lap("eigh")
    phi, U, y_rot, X0_rot = nl["phi"], nl["U"], nl["y_rot"], nl["X0_rot"]

    # mean-imputed float tiles: the packed rows unpacked on their device (cut
    # at M), or a host source's rows uploaded a tile at a time; on a mesh
    # this rank's shard or rows
    if rg is not None:
        tiles = _float_tiles(rg if mesh is None else pd.shard_packed_rows(
            rg, mesh, device=device), dtype)
    else:
        src = resolve_source(G)
        if mesh is not None:
            lo, hi = pd.rank_range(src.shape[0], mesh, tile)
            src = src[lo:hi]
        tiles = host_tiles(src, dtype, device, tile)
    clock.lap()
    outs = [_emma_tile_stats(Gt, U, X0_rot, y_rot, phi, ngrids, llim, ulim,
                             reml, refine_iters, n, q, clock)
            for Gt in tiles]
    keys = ("f", "delta", "beta", "ll", "mask")
    if mesh is None:
        res = {k: torch.cat([o[k] for o in outs]).cpu().numpy()
               for k in keys}
    else:
        # one all-gather of this rank's (5, m_rank) block (no rows: (5, 0))
        blk = (torch.stack([torch.cat([o[k].to(dtype) for o in outs])
                            for k in keys]) if outs
               else torch.zeros((len(keys), 0), dtype=dtype, device=device))
        h = pd.gathered_rows(blk, mesh, resolve_source(G).shape[0])
        res = dict(zip(keys, h))
    timings = clock.seconds()
    deltas = res["delta"].astype(np.float64)
    lls = res["ll"].astype(np.float64)
    fstats = res["f"].astype(np.float64)
    masks = res["mask"].astype(bool)
    ts = time.perf_counter()
    out = {"f_stats": fstats, "deltas": deltas,
           "betas": res["beta"].astype(np.float64), "mask": masks,
           "lls": lls, "pseudo_heritabilities": 1.0 / (1.0 + deltas)}
    if test == "lrt":
        lrt = np.maximum(2.0 * (lls - nl["ll_null"]), 0.0)
        out["ps"] = np.where(masks, chi2_sf_host(lrt, 1.0), 1.0)
        out["lrt_stats"] = lrt
    else:
        out["ps"] = np.where(masks, f_sf_host(fstats, 1.0, n - q - 1), 1.0)
    timings["p_values"] = time.perf_counter() - ts
    out["timings_s"] = timings
    return out
