"""mixmogam_tpu_torch — the PyTorch/CUDA port of mixmogam_tpu.

A second package beside ``mixmogam_tpu`` (the JAX reference, unchanged).
Slice 1 carries the main path: single-trait EMMAX over a fully observed
int8 genome held 2-bit packed in device memory —

  pack + upload once      models.resident.ResidentGenome.from_source
  IBS kinship (int gram)  models.resident.kinship_resident  -> kernel K1
  eigh(K)                 ops.eigen.eigen_k (host LAPACK or torch.linalg)
  null-model REML (f64)   ops.reml.fit_null_model
  rotated null            ops.scan.build_rotated_null
  per-tile scan           models.resident.emmax_scan_packed -> K2 / K3
  f64 p-values + rescore  models.streaming.finalize_scan

Slice 2 adds leave-one-chromosome-out EMMAX (models.loco: emmax_loco,
loco_kinships; per-chromosome range grams through kernel K4) and the
split-W bf16 tiers 'bf16' / 'bf16x2' / 'bf16x3' (kernel K5).

Slice 3 adds the way in: the facade api.run_gwas / api.run_gwas_multi and
the CLI (cli.py) for method 'emmax' and 'emmax_loco', with the data layer
(data/: GenotypeData, PhenotypeData, the CSV / PLINK / VCF / HDF5 parsers
and writers), the results layer (results/, plotting/), the artifact caches
(utils/caching.py), run metrics (utils/profiling.py), and the kinship
module ops.kinship.kinship (IBS with or without missing genotypes,
VanRaden; fully observed int8 through kernel K1).

Slice 4 adds stepwise MLMM (models.stepwise.emmax_step_wise, method
'emmax_stepwise' of run_gwas): the genome rotated once and scanned by kernel
K3 at every step, with the per-step REML of ops.xreml; LOCO takes the
VanRaden kinship and missing genotypes.

Modules keep the JAX package's paths and names. The port imports torch,
numpy and scipy, and nothing of jax or of the JAX package: the few numpy
modules it shares with that package (the data, results and plotting
layers, the kinship oracle, the caches) are copies, pinned to the originals
by its tests, and it packs genotypes on the
device itself. The device is explicit: tensors on a CUDA device run
the hand-written Hopper kernels (``csrc/``, ``ops/hopper_*.py``), tensors
on the CPU run each kernel's plain PyTorch version.
"""

__version__ = "0.1.0"

__all__ = ["emmax", "emmax_resident", "kinship_resident", "ResidentGenome",
           "emmax_loco", "loco_kinships", "emmax_step_wise", "kinship",
           "run_gwas",
           "run_gwas_multi", "parse_snp_data", "parse_phenotype_file",
           "calc_ibs_kinship", "calc_ibd_kinship", "save_kinship_to_file",
           "load_kinship_from_file", "GenotypeData", "PhenotypeData",
           "__version__"]

_API = {"run_gwas", "run_gwas_multi", "parse_snp_data",
        "parse_phenotype_file", "calc_ibs_kinship", "calc_ibd_kinship",
        "save_kinship_to_file", "load_kinship_from_file"}


def __getattr__(name):
    # lazy facade: `import mixmogam_tpu_torch` stays cheap (no torch import)
    if name == "emmax":
        from mixmogam_tpu_torch.models.emmax import emmax

        return emmax
    if name in {"ResidentGenome", "emmax_resident", "kinship_resident"}:
        from mixmogam_tpu_torch.models import resident

        return getattr(resident, name)
    if name in {"emmax_loco", "loco_kinships"}:
        from mixmogam_tpu_torch.models import loco

        return getattr(loco, name)
    if name == "emmax_step_wise":
        from mixmogam_tpu_torch.models.stepwise import emmax_step_wise

        return emmax_step_wise
    if name == "kinship":
        from mixmogam_tpu_torch.ops.kinship import kinship

        return kinship
    if name in _API:
        from mixmogam_tpu_torch import api

        return getattr(api, name)
    if name in {"GenotypeData", "PhenotypeData"}:
        from mixmogam_tpu_torch import data

        return getattr(data, name)
    raise AttributeError(
        f"module 'mixmogam_tpu_torch' has no attribute {name!r}")
