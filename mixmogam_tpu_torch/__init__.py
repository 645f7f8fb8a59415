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

Slice 5 adds the shared-eigenbasis multi-trait scan
(models.multitrait.emmax_multi_trait, api.run_gwas_multi(batched=True)):
one eigh, a float64 REML a trait, each genotype tile rotated once for all
traits and kernel K3 launched once a trait on it; traits with missing
phenotypes are grouped by their pattern.

Slice 6 adds EMMA, the exact per-SNP REML (models.emma.emma, float64 by
default on the card as on the CPU: one rotation a tile, then a batched grid
and a bisection per SNP), and the fixed-effects tests of models.linear
(linear_model through kernel K3 with identity whitening, anova,
kruskal_wallis) and models.emmax.emmax_anova: run_gwas methods 'emma',
'lm', 'anova' and 'kw'.

Slice 7 adds gBLUP genomic prediction (models.gblup: gblup, gblup_predict,
gblup_cv, in float64 on the card; the CLI's predict) and the GxE
interaction scan (models.gxe.emmax_gxe: E + 1 library rotations a tile by
the projected eigenbasis, then the statistics in plain torch; run_gwas
method 'emmax_gxe'). The facade now refuses no method and no command of
the JAX package's.

Slice 8 adds the permutation test (models.permutation.emmax_perm_test: one
float64 REML, P permuted residuals, a tile rotated once and one
(m, n) x (n, P) product with a running max F) and the two-SNP scan
(models.twosnp.emmax_two_snps: each tile rotated once, kernel K3 once a
focal SNP for the conditional scan, the interaction as GxE's with the
focal SNP as the environment). The port now has every model of the JAX
package.

Slice 9 adds the rest of the null-model layer and the reference's class
API: ops.eigen.projected_spectrum (the eigh of S(K+I)S in float64 on the
card), ops.reml.reml_from_spectrum (the grid and bisection over its
spectrum, batched over leading dimensions), fit_null_model(method=
'spectrum') and h2_profile_ci (the profile-likelihood interval of h2, on
the objective the null recorded in NullModel.ml); compat.py (LinearModel,
LinearMixedModel, lm_step_wise, SNPsDataSet: the reference's stateful
classes over the port's models, K and its eigenbasis kept on the card);
the float64 oracle (oracle/lmm.py, glm.py, stepwise.py); and examples.py,
the scenarios of examples/examples.py run on the port.

Slice 10 adds the streamed scan (models.streaming.emmax_streamed: tiles
read from a host source in a prep thread into pinned buffers, copied to the
card on a side stream, scanned by kernel K3 (exact) or packed there for K2 /
K5; a tile-granular checkpoint and resume), which emmax (stream=,
checkpoint_dir=, or a source over the in-core budget that does not fit
packed), emmax_multi_trait (such a source, exact tier), the CLI's --stream
on / --checkpoint-dir and the streaming_at_scale example reach.

Slice 11 adds the host data plane: native.py (g++ builds csrc/host/*.cpp,
copies of the JAX package's C++ parsers and packer, at first use), through
which the dosage-CSV and VCF readers, read_vcf_packed and data/pack2.py go,
each keeping its Python route; and ResidentGenome.from_source's packed
cache (cache_path=, trust_cache=), in the JAX package's file format.

Slice 12 adds the data-parallel core of parallel/ over torch.distributed:
make_mesh (a rank's view of the ('snp', 'sample') mesh), initialize_multihost
and the per-rank SnpShard, distributed_kinship (each rank's partial gram,
kernel K1 on its packed rows, one all-reduce) and distributed_emmax (the
null fitted on rank 0 and broadcast once, each rank's rows scanned by the
single-device routes, one all-gather), which emmax(mesh=) reaches for an
in-core source.

Slice 13 adds the sharded resident scan: ResidentGenome.from_source(
upload=False) (packed on the host, nothing on a device), shard_packed_rows
(each rank's packed rows uploaded once, kept with the container),
distributed_emmax_resident (kernels K3, K2, K5 on a rank's shard) and
distributed_kinship over a container (K1 on the shard), which emmax(mesh=)
reaches for a packed genome, and emmax_loco(mesh=) (the kinships and eighs
on rank 0, each chromosome scanned on the shards).

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
           "emmax_loco", "loco_kinships", "emmax_step_wise",
           "emmax_multi_trait", "emma", "emmax_anova", "linear_model",
           "anova", "kruskal_wallis", "emmax_gxe", "gblup", "gblup_predict",
           "gblup_cv", "emmax_perm_test", "emmax_two_snps", "kinship",
           "emmax_streamed", "run_gwas",
           "run_gwas_multi", "parse_snp_data", "parse_phenotype_file",
           "calc_ibs_kinship", "calc_ibd_kinship", "save_kinship_to_file",
           "load_kinship_from_file", "GenotypeData", "PhenotypeData",
           "LinearModel", "LinearMixedModel", "lm_step_wise",
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
    if name == "emmax_streamed":
        from mixmogam_tpu_torch.models.streaming import emmax_streamed

        return emmax_streamed
    if name == "emmax_step_wise":
        from mixmogam_tpu_torch.models.stepwise import emmax_step_wise

        return emmax_step_wise
    if name == "emmax_multi_trait":
        from mixmogam_tpu_torch.models.multitrait import emmax_multi_trait

        return emmax_multi_trait
    if name in {"emma", "emmax_anova", "linear_model", "anova",
                "kruskal_wallis", "emmax_gxe", "gblup", "gblup_predict",
                "gblup_cv", "emmax_perm_test", "emmax_two_snps"}:
        from mixmogam_tpu_torch import api

        return getattr(api, name)
    if name == "kinship":
        from mixmogam_tpu_torch.ops.kinship import kinship

        return kinship
    if name in _API:
        from mixmogam_tpu_torch import api

        return getattr(api, name)
    if name in {"LinearModel", "LinearMixedModel", "lm_step_wise"}:
        from mixmogam_tpu_torch import compat

        return getattr(compat, name)
    if name in {"GenotypeData", "PhenotypeData"}:
        from mixmogam_tpu_torch import data

        return getattr(data, name)
    raise AttributeError(
        f"module 'mixmogam_tpu_torch' has no attribute {name!r}")
