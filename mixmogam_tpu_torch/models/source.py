"""Host genotype-source plumbing (counterpart of
mixmogam_tpu/models/source.py: resolve_source, should_stream,
pack_for_mesh, prefetch_iter, fetch_tile).

The host side of a streamed tile (host_tile: read, pad, impute a float
source) runs in prefetch_iter's worker thread and touches numpy only; the
device side (ship_tile) runs on the calling thread."""

from __future__ import annotations

import numpy as np


def resolve_source(G):
    """GenotypeData -> its int8 matrix; lazy array-likes (ndarray,
    np.memmap, h5py datasets) pass through unmaterialized."""
    if hasattr(G, "matrix"):
        return G.matrix
    if hasattr(G, "shape") and hasattr(G, "dtype"):
        return G
    return np.asarray(G)


def should_stream(G_src, n: int, itemsize: int, budget_bytes: int) -> bool:
    """True when the in-core scan's device footprint (G itself plus its
    rotated image at the compute dtype's itemsize) exceeds the budget."""
    g_item = 1 if np.dtype(G_src.dtype) == np.int8 else itemsize
    return G_src.shape[0] * n * (itemsize + g_item) > budget_bytes


def pack_for_mesh(G_src, n: int, what: str, device=None):
    """Big-source routing for mesh= paths (mirrors models.emmax): an int8
    source within the 2-bit resident budget of `device` (the rank's: the
    card by default; resident_budget_bytes) packs HOST-side (upload=False:
    the sharded path uploads each rank's shard, never the whole genome to
    one device); anything else is refused."""
    from mixmogam_tpu_torch.models.resident import (ResidentGenome,
                                                    resident_budget_bytes)
    from mixmogam_tpu_torch.ops import resolve_device

    if (np.dtype(G_src.dtype) == np.int8
            and G_src.shape[0] * ((n + 3) // 4)
            <= resident_budget_bytes(resolve_device(device))):
        return ResidentGenome.from_source(G_src, upload=False)
    raise ValueError(
        f"the mesh {what} path shards in-core or packed sources; this "
        "source exceeds both the in-core and the 2-bit resident budgets")


#: rows a block of as_int8_dosage's float check: imputed dosages show a
#: fraction in the first block, so a fractional source costs one block
_CHECK_ROWS = 4_096


def as_int8_dosage(G):
    """An (M, n) source as int8 dosages 0..127 with -1 for missing, or
    None when some observed dosage is fractional, negative or above 127.
    int8 matrices (GenotypeData's included) pass through; float matrices
    (NaN = missing) are checked and converted a block of rows at a time,
    and the check stops at the first block that fails."""
    mat = resolve_source(G)
    if np.dtype(mat.dtype) == np.int8:
        return mat
    A = np.asarray(mat)
    if not np.issubdtype(A.dtype, np.floating):
        return A.astype(np.int8) if (
            A.size == 0 or (A.min() >= 0 and A.max() <= 127)) else None
    if A.ndim != 2:
        A = A.reshape(1, -1) if A.ndim < 2 else A
    out = np.empty(A.shape, dtype=np.int8)
    for s in range(0, A.shape[0], _CHECK_ROWS):
        B = A[s:s + _CHECK_ROWS]
        miss = np.isnan(B)
        obs = np.where(miss, 0.0, B)
        if obs.size and (obs.min() < 0 or obs.max() > 127
                         or not np.array_equal(obs, np.round(obs))):
            return None
        o = out[s:s + _CHECK_ROWS]
        o[...] = obs
        o[miss] = -1
    return out.reshape(np.shape(mat))


def prefetch_iter(keys, prep, lookahead: int = 2):
    """Yield (key, prep(key)) in order with prep running `lookahead` items
    ahead in ONE worker thread, so host-side tile prep (a memmap read,
    padding, a float source's imputation: numpy, which releases the GIL)
    overlaps the consumer's work. A prep exception is raised at the yield
    of its key; the futures still queued are drained when the executor's
    context exits."""
    from concurrent.futures import ThreadPoolExecutor

    keys = list(keys)
    with ThreadPoolExecutor(max_workers=1) as ex:
        futs = {k: ex.submit(prep, k) for k in keys[:lookahead]}
        for i, k in enumerate(keys):
            for k_next in keys[i + lookahead:i + lookahead + 1]:
                futs[k_next] = ex.submit(prep, k_next)
            yield k, futs.pop(k).result()


def host_tile(G_src, s: int, e: int, tile: int, n: int, dtype
              ) -> np.ndarray:
    """Rows [s, e) of a host source as the (tile, n) host array a streamed
    tile starts from: int8 as read (-1 = missing; imputed on the device by
    ship_tile), a float source mean-imputed per SNP on the host in the
    numpy dtype `dtype` (NaN = missing). Rows past e are zero padding."""
    from mixmogam_tpu_torch.models.streaming import _host_float_tile

    if np.dtype(G_src.dtype) == np.int8:
        chunk = np.ascontiguousarray(np.asarray(G_src[s:e], dtype=np.int8))
    else:
        chunk = _host_float_tile(G_src[s:e], np.dtype(dtype))
    if e - s < tile:
        chunk = np.vstack([chunk, np.zeros((tile - (e - s), n),
                                           chunk.dtype)])
    return chunk


def ship_tile(chunk: np.ndarray, dtype, device):
    """A host_tile array on `device` as float rows in the torch dtype
    `dtype`: an int8 tile goes up as int8 and is mean-imputed there
    (streaming._impute_tile), a float tile goes up imputed."""
    import torch

    from mixmogam_tpu_torch.models.streaming import _impute_tile

    t = torch.from_numpy(chunk).to(device)
    return _impute_tile(t, dtype) if t.dtype == torch.int8 else t.to(dtype)


def fetch_tile(G_src, s: int, e: int, tile: int, n: int, dtype,
               pack: bool = False, device=None):
    """One (tile, n) float tile on `device` (the card unless asked for the
    CPU) from a host source, in the torch dtype `dtype`: host_tile, then
    ship_tile. `pack` is the JAX signature's 2-bit transfer switch and
    changes nothing: the port ships int8 and packs on the card where a
    kernel reads packed rows."""
    import torch

    from mixmogam_tpu_torch.ops import resolve_device

    np_dt = torch.empty((), dtype=dtype).numpy().dtype
    return ship_tile(host_tile(G_src, s, e, tile, n, np_dt), dtype,
                     resolve_device(device))
