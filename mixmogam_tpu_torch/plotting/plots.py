"""Manhattan and QQ plots (copy of mixmogam_tpu/plotting/plots.py; reference: plotResults.py — SURVEY.md L6:
per-chromosome offsets + threshold line; simple and log QQ with confidence
band). Host-side matplotlib (Agg), semantics unchanged from the reference."""

from __future__ import annotations

from typing import Optional

import numpy as np


def _plt():
    """Headless-safe pyplot: select Agg only when pyplot has not been
    imported yet — force-switching the process-wide backend would break
    an interactive (Jupyter) session's later figures.
    Everything here saves via fig.savefig, which works on any backend."""
    import sys

    import matplotlib

    if "matplotlib.pyplot" not in sys.modules:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


_CHROM_COLORS = ("#4878CF", "#6ACC65")


def manhattan_plot(result, path: str, threshold: Optional[float] = None,
                   title: str = "", max_points: int = 200_000):
    """result: Result with score_type 'pvals' or 'neg_log_pvals'.
    threshold: p-value threshold (drawn as -log10 line).
    Returns the (closed) Figure so callers/tests can inspect artists."""
    plt = _plt()
    r = result.neg_log_trans() if result.score_type == "pvals" else result
    chroms = np.asarray(r.chromosomes)
    pos = np.asarray(r.positions, dtype=np.float64)
    scores = np.asarray(r.scores)
    if len(scores) > max_points:  # subsample the insignificant mass
        order = np.argsort(-scores)
        keep = np.concatenate([order[:max_points // 2],
                               np.random.default_rng(0).choice(
                                   order[max_points // 2:],
                                   max_points // 2, replace=False)])
        chroms, pos, scores = chroms[keep], pos[keep], scores[keep]
    fig, ax = plt.subplots(figsize=(10, 3.2))
    offset = 0.0
    ticks, labels = [], []
    for i, c in enumerate(np.unique(chroms)):
        m = chroms == c
        x = pos[m] + offset
        ax.scatter(x, scores[m], s=3, lw=0,
                   color=_CHROM_COLORS[i % 2], rasterized=True)
        ticks.append(offset + pos[m].mean() if m.any() else offset)
        labels.append(str(c))
        offset += (pos[m].max() if m.any() else 0) + 1e6
    if threshold is not None:
        ax.axhline(-np.log10(threshold), color="#D65F5F", lw=1.0, ls="--")
    ax.set_xticks(ticks)
    ax.set_xticklabels(labels)
    ax.set_xlabel("chromosome")
    ax.set_ylabel(r"$-\log_{10}(p)$")
    ax.set_ylim(bottom=0)
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return fig


def qq_plot(pvals_or_result, path: str, title: str = "",
            num_dots: int = 1000, max_neg_log: Optional[float] = None,
            with_confidence: bool = True):
    """Log-QQ plot of observed vs expected -log10(p) with a 95% band
    (reference: plotResults.simple_log_qqplot). Returns the Figure."""
    plt = _plt()
    if hasattr(pvals_or_result, "scores"):
        r = pvals_or_result
        p = (10.0 ** -np.asarray(r.scores)
             if r.score_type == "neg_log_pvals" else np.asarray(r.scores))
    else:
        p = np.asarray(pvals_or_result, dtype=np.float64)
    p = np.sort(p[np.isfinite(p)])
    m = len(p)
    if m == 0:
        raise ValueError(
            "qq_plot got no finite p-values (empty scan or all-NaN "
            "input) — nothing to plot")
    exp = (np.arange(1, m + 1) - 0.5) / m
    obs_l = -np.log10(np.maximum(p, 1e-323))
    exp_l = -np.log10(exp)
    if m > num_dots:  # thin the bulk, keep the tail
        keep = np.unique(np.concatenate(
            [np.arange(min(200, m)),
             np.linspace(0, m - 1, num_dots).astype(int)]))
        obs_l, exp_l = obs_l[keep], exp_l[keep]
        exp_keep = exp[keep]
    else:
        exp_keep = exp
    fig, ax = plt.subplots(figsize=(4.2, 4.2))
    if with_confidence:
        import scipy.stats

        ks = np.maximum(exp_keep * m, 1e-9)
        lo = scipy.stats.beta.ppf(0.025, ks, m + 1 - ks)
        hi = scipy.stats.beta.ppf(0.975, ks, m + 1 - ks)
        ax.fill_between(exp_l, -np.log10(hi), -np.log10(lo),
                        color="#D0D0D0", alpha=0.6, lw=0)
    lim = max_neg_log or max(exp_l.max(), obs_l.max()) * 1.05
    ax.plot([0, lim], [0, lim], color="#999999", lw=1)
    ax.scatter(exp_l, obs_l, s=6, lw=0, color="#4878CF")
    ax.set_xlim(0, exp_l.max() * 1.05)
    ax.set_ylim(0, lim)
    ax.set_xlabel(r"expected $-\log_{10}(p)$")
    ax.set_ylabel(r"observed $-\log_{10}(p)$")
    if title:
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)
    return fig
