"""LD utilities: pairwise r^2 and greedy clumping of association hits
(copy of mixmogam_tpu/results/ld.py, numpy only).

Capability extension (the reference's gwaResults.py has region/gene
proximity queries but no LD machinery; every practical GWAS pipeline
clumps its hits). Shapes are matmul-friendly: r^2 between k candidate
SNPs is one (k, n) standardized gram — k is the top-hit count (<= a few
thousand), so host numpy float64 is exact and instant; genotype rows
come through the source protocol (ndarray / GenotypeData /
PlinkBedSource / ResidentGenome all slice by row index).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _dosage_rows(G, idx: np.ndarray) -> np.ndarray:
    """(k, n) float64 mean-imputed dosage rows for SNP indices idx."""
    if hasattr(G, "matrix"):
        G = G.matrix
    raw = np.asarray(G[idx])
    rows = raw.astype(np.float64)
    if np.issubdtype(raw.dtype, np.integer):
        rows[raw < 0] = np.nan
    if np.isnan(rows).any():
        mu = np.nanmean(rows, axis=1)
        mu = np.where(np.isnan(mu), 0.0, mu)
        ij = np.where(np.isnan(rows))
        rows[ij] = mu[ij[0]]
    return rows


def ld_r2(G, idx: Sequence[int]) -> np.ndarray:
    """Pairwise r^2 matrix (k, k) between the SNP rows `idx` of G.
    r = Pearson correlation of dosages (the standard composite-LD r for
    unphased data); monomorphic rows get r^2 = 0 off-diagonal."""
    idx = np.asarray(idx, dtype=np.int64)
    X = _dosage_rows(G, idx)
    X = X - X.mean(axis=1, keepdims=True)
    sd = np.sqrt((X * X).sum(axis=1))
    ok = sd > 0
    Xn = np.where(ok[:, None], X / np.where(ok, sd, 1.0)[:, None], 0.0)
    R = Xn @ Xn.T
    r2 = R * R
    np.fill_diagonal(r2, 1.0)
    return r2


def clump_hits(ps: np.ndarray, G, chromosomes: np.ndarray,
               positions: np.ndarray, p_threshold: float = 1e-4,
               r2_threshold: float = 0.5, window_bp: int = 250_000,
               max_candidates: int = 2048,
               ) -> List[Dict[str, object]]:
    """Greedy LD clumping (plink --clump semantics, simplified):

    1. candidates = SNPs with p <= p_threshold (capped at
       max_candidates strongest),
    2. repeatedly take the most significant unassigned candidate as a
       clump LEAD; assign every unassigned candidate on the same
       chromosome within window_bp AND with r^2 >= r2_threshold to it.

    Returns a list of clumps (best p first):
      {'lead': snp_index, 'p': lead p, 'members': [snp_index...],
       'chromosome': ..., 'position': ...}
    `G` is any row-indexable genotype source (ResidentGenome included).
    """
    ps = np.asarray(ps, dtype=np.float64)
    chromosomes = np.asarray(chromosomes)
    positions = np.asarray(positions)
    cand = np.flatnonzero(ps <= p_threshold)
    if len(cand) == 0:
        return []
    if len(cand) > max_candidates:
        cand = cand[np.argsort(ps[cand], kind="stable")[:max_candidates]]
    order = cand[np.argsort(ps[cand], kind="stable")]
    # one r^2 matrix over all candidates (k <= max_candidates)
    r2 = ld_r2(G, order)

    assigned = np.zeros(len(order), dtype=bool)
    clumps: List[Dict[str, object]] = []
    for i, lead in enumerate(order):
        if assigned[i]:
            continue
        assigned[i] = True
        same_chr = chromosomes[order] == chromosomes[lead]
        near = np.abs(positions[order] - positions[lead]) <= window_bp
        linked = r2[i] >= r2_threshold
        members = order[~assigned & same_chr & near & linked]
        assigned[np.flatnonzero(same_chr & near & linked)] = True
        clumps.append({
            "lead": int(lead), "p": float(ps[lead]),
            "members": [int(m) for m in members],
            "chromosome": chromosomes[lead].item(),
            "position": int(positions[lead]),
        })
    return clumps
