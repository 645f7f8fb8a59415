"""Central configuration dataclasses (counterpart of mixmogam_tpu/config.py).

The reference (mixmogam) has no config system — everything is function kwargs
with hardcoded defaults (SURVEY.md §5: ``ngrids=100, llim=-10, ulim=10,
esp=1e-6``, ``min_mac=15``, SNP chunk sizes). Those numeric defaults are
mirrored here so parity is preserved. The device-side knobs are the port's
own: the scan tile is models/emmax.py's default, and memory budgets are not
configured here at all, they come from the card's own memory
(models/emmax.py::incore_budget_bytes,
models/resident.py::resident_budget_bytes).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RemlConfig:
    """REML optimizer settings (reference defaults: linear_models.py
    get_expedited_REMLE(ngrids=100, llim=-10, ulim=10, esp=1e-6))."""

    ngrids: int = 100
    llim: float = -10.0   # lower bound on log(delta), natural log
    ulim: float = 10.0    # upper bound on log(delta)
    esp: float = 1e-6     # root refinement tolerance on log(delta)
                          # (maps to bisection iterations; ops.reml.esp_to_refine_iters)


@dataclasses.dataclass(frozen=True)
class FilterConfig:
    """SNP filtering (reference: SNPsDataSet.filter_mac_snps / filter_maf_snps)."""

    min_mac: int = 0
    min_maf: float = 0.0


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Device tiling of the SNP axis."""

    kinship_snp_block: int = 2048   # SNPs per float kinship accumulation block
    scan_snp_tile: int = 16_384     # SNPs per EMMAX-scan tile (emmax's default)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh for multi-device runs (not ported yet; kept so a
    GwasConfig carries across): 'snp' axis = data parallel over markers;
    'sample' axis = tensor-parallel fallback for very large n."""

    snp_axis: str = "snp"
    sample_axis: str = "sample"
    mesh_shape: Optional[Tuple[int, int]] = None  # None => (n_devices, 1)


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """Numerics policy.

    - compute_dtype: on-device linear algebra ('float32' on the card; the
      CPU path and the tests use 'float64').
    - rotate_in_bf16: opt-in fast path for the genotype-rotation matmul
      (bf16 inputs, fp32 accumulation); off by default to hold 1e-6
      p-parity.
    - host_float64_pvalues: finalize p-values from F statistics in float64
      on host (scipy) so tails (p ~ 1e-30) survive fp32.
    """

    compute_dtype: str = "float32"
    rotate_in_bf16: bool = False
    host_float64_pvalues: bool = True


@dataclasses.dataclass(frozen=True)
class GwasConfig:
    reml: RemlConfig = dataclasses.field(default_factory=RemlConfig)
    filters: FilterConfig = dataclasses.field(default_factory=FilterConfig)
    tiles: TileConfig = dataclasses.field(default_factory=TileConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    precision: PrecisionConfig = dataclasses.field(default_factory=PrecisionConfig)


DEFAULT = GwasConfig()
