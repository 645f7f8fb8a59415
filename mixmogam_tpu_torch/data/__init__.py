"""Data layer: genotype/phenotype containers, parsers, simulation
(counterpart of mixmogam_tpu/data; numpy only, torch is imported only
inside the functions that put rows on a device).

Genotypes live as a single packed int8 (M, n) matrix + metadata arrays
(not per-chromosome Python lists), so device tiles slice straight out of
it.
"""

from mixmogam_tpu_torch.data.genotype import GenotypeData, SNPsDataSet
from mixmogam_tpu_torch.data.phenotype import PhenotypeData
from mixmogam_tpu_torch.data.simulate import (simulate_genotypes,
                                              simulate_phenotype)
from mixmogam_tpu_torch.data.plink import (read_plink, resident_from_plink,
                                           write_plink)
from mixmogam_tpu_torch.data.vcf import read_vcf, write_vcf

__all__ = [
    "GenotypeData", "SNPsDataSet", "PhenotypeData", "simulate_genotypes",
    "simulate_phenotype", "read_plink", "resident_from_plink",
    "write_plink", "read_vcf", "write_vcf",
]
