"""Simulated GWAS datasets: a numpy-only copy of the JAX package's
mixmogam_tpu/data/simulate.py (Balding-Nichols genotypes, LMM
phenotypes), so that the port and chip_smoke.py draw the same data from
a seed without importing that package. tests/test_torch_data.py pins the
copy to the original."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def simulate_genotypes(n_samples: int, n_snps: int, ploidy: int = 1,
                       maf_low: float = 0.05, maf_high: float = 0.5,
                       n_pops: int = 3, fst: float = 0.1,
                       missing_rate: float = 0.0,
                       seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Structured population genotypes (Balding-Nichols model), so kinship
    actually matters. Returns (G, chromosomes, positions); G is (M, n) int8
    with -1 for missing."""
    rng = np.random.default_rng(seed)
    p_anc = rng.uniform(maf_low, maf_high, size=n_snps)
    a = p_anc * (1.0 - fst) / fst
    b = (1.0 - p_anc) * (1.0 - fst) / fst
    pop_freqs = rng.beta(a, b, size=(n_pops, n_snps)).astype(np.float32)
    pop = rng.integers(0, n_pops, size=n_samples)
    # chunk over SNPs: float32 draws, bounded temporaries (a naive
    # all-at-once version allocates multiple (n x M) float64 arrays,
    # minutes-slow at benchmark scale)
    G = np.empty((n_snps, n_samples), dtype=np.int8)
    chunk = max(1, (1 << 24) // max(n_samples, 1))
    for s in range(0, n_snps, chunk):
        e = min(s + chunk, n_snps)
        pf = pop_freqs[:, s:e][pop, :].T           # (mchunk, n) f32
        acc = np.zeros((e - s, n_samples), dtype=np.int8)
        for _ in range(ploidy):
            acc += (rng.random((e - s, n_samples), dtype=np.float32)
                    < pf).astype(np.int8)
        if missing_rate > 0:
            miss = rng.random((e - s, n_samples),
                              dtype=np.float32) < missing_rate
            acc[miss] = -1
        G[s:e] = acc
    n_chrom = 5
    chromosomes = (np.arange(n_snps) * n_chrom // n_snps + 1).astype(np.int32)
    positions = np.zeros(n_snps, dtype=np.int64)
    for c in range(1, n_chrom + 1):
        mask = chromosomes == c
        positions[mask] = np.sort(rng.integers(1, 30_000_000, size=mask.sum()))
    return G, chromosomes, positions


def simulate_phenotype(G: np.ndarray, h2: float = 0.5, n_causal: int = 10,
                       causal_effect: float = 0.0, K: Optional[np.ndarray] = None,
                       seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Phenotype from the LMM generative model: y = G_c beta + u + e with
    u ~ N(0, sg2 K) (polygenic background; if K is None a random dense
    polygenic term from all SNPs is used) and var tuned so heritability
    is ~h2. Returns (y, causal_idx)."""
    rng = np.random.default_rng(seed + 1)
    M, n = G.shape

    def dosage_rows(idx):
        Z = G[idx].astype(np.float64)
        miss = G[idx] < 0
        if miss.any():
            Z[miss] = np.nan
            mu = np.nanmean(Z, axis=1)
            w = np.where(np.isnan(Z))
            Z[w] = mu[w[0]]
        return Z

    causal = rng.choice(M, size=min(n_causal, M), replace=False)
    beta = rng.normal(0, 1.0, size=len(causal))
    if causal_effect:
        beta = np.sign(beta) * causal_effect
    fixed = dosage_rows(causal).T @ beta if len(causal) else np.zeros(n)

    if K is not None:
        L = np.linalg.cholesky(K + 1e-6 * np.eye(n))
        u = L @ rng.normal(size=n)
    else:
        # polygenic term accumulated in SNP chunks (memory-bounded)
        w = rng.normal(size=M) / np.sqrt(M)
        u = np.zeros(n)
        chunk = max(1, (1 << 24) // max(n, 1))
        for s in range(0, M, chunk):
            e = min(s + chunk, M)
            u += dosage_rows(np.arange(s, e)).T @ w[s:e]
    u = (u - u.mean())
    su = u.std() or 1.0
    e = rng.normal(size=n)
    y = fixed + np.sqrt(h2) * u / su + np.sqrt(1 - h2) * e
    return y, causal
