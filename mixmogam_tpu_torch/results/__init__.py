"""Results layer (reference: gwaResults.py + mtcorr.py — SURVEY.md L5)."""

from mixmogam_tpu_torch.results.result import Result
from mixmogam_tpu_torch.results.mtcorr import (
    bonferroni_threshold, get_bh_thres, get_bhy_thres,
)
from mixmogam_tpu_torch.results.ld import clump_hits, ld_r2

__all__ = ["Result", "bonferroni_threshold", "get_bh_thres",
           "get_bhy_thres", "clump_hits", "ld_r2"]
