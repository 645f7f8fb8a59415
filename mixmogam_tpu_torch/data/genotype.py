"""Genotype data model (copy of mixmogam_tpu/data/genotype.py, numpy only;
its redesign of reference snpsdata.py).

The reference keeps per-chromosome Python lists of per-SNP lists
(SNPsDataSet / SnpsData — SURVEY.md §2.1). Here the genome is ONE packed
int8 matrix (M, n) + flat metadata arrays, so device tiles are zero-copy
slices and filters are boolean masks. Capability parity covered: get_snps/get_positions/get_mafs,
filter_mac_snps/filter_maf_snps, coordinate_w_phenotype_data,
get_region_snps, kinship delegation, writeToFile (CSV/HDF5).

content_hash() keys the kinship and LOCO eigen caches: it hashes the same
bytes as the JAX package's, so a cache written by either package is read
by the other.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

MISSING = -1  # int8 sentinel for missing genotype


#: bytes a chunk of write_csv's formatting may take, and what one cell
#: takes there: its U4 copy (16 bytes), before the chunk's str list (the
#: JAX package's chunk of 64 M cells is a 1 GiB U4 copy and its list)
CSV_CHUNK_BYTES = 64 << 20
CSV_BYTES_PER_CELL = 16


def csv_chunk_rows(n: int) -> int:
    """Rows a chunk of write_csv formats at once for n samples."""
    return max(1, CSV_CHUNK_BYTES // (CSV_BYTES_PER_CELL * max(n, 1)))


@dataclasses.dataclass
class GenotypeData:
    matrix: np.ndarray            # (M, n) int8 dosages, MISSING = -1
    chromosomes: np.ndarray       # (M,) int32
    positions: np.ndarray         # (M,) int64
    accessions: List[str]         # n sample ids (order == matrix columns)
    ploidy: int = 1               # 1 = binary coding, 2 = diploid
    alleles: Optional[np.ndarray] = None  # (M, 2) nucleotide chars, optional

    def __post_init__(self):
        self.matrix = np.ascontiguousarray(self.matrix, dtype=np.int8)
        self.chromosomes = np.asarray(self.chromosomes, dtype=np.int32)
        self.positions = np.asarray(self.positions, dtype=np.int64)
        self.accessions = [str(a) for a in self.accessions]
        assert self.matrix.shape == (len(self.chromosomes), len(self.accessions))

    # ---- basic accessors (reference: get_snps / get_positions) ----
    @property
    def num_snps(self) -> int:
        return self.matrix.shape[0]

    @property
    def num_samples(self) -> int:
        return self.matrix.shape[1]

    def get_snps(self) -> np.ndarray:
        return self.matrix

    def get_positions(self) -> np.ndarray:
        return self.positions

    def get_chromosomes(self) -> np.ndarray:
        return self.chromosomes

    # reference-named aliases (snpsdata.py surface)
    def writeToFile(self, path: str) -> None:  # noqa: N802
        self.write_csv(path)

    def convert_data_format(self, target: str = "binary") -> "GenotypeData":
        """Reference: SNPsDataSet.convert_data_format('binary'). Parsing
        already decodes nucleotides to 0/1 minor-allele dosages, so binary
        is the native representation; this is a documented no-op."""
        if target != "binary":
            raise ValueError(f"unsupported target format {target!r}")
        return self

    def dosage_f64(self) -> np.ndarray:
        """Float dosages with the normative per-SNP mean imputation."""
        Z = self.matrix.astype(np.float64)
        miss = self.matrix == MISSING
        if miss.any():
            Z[miss] = np.nan
            mu = np.nanmean(Z, axis=1)
            mu = np.where(np.isnan(mu), 0.0, mu)
            idx = np.where(miss)
            Z[idx] = mu[idx[0]]
        return Z

    # ---- allele frequency statistics (reference: get_mafs) ----
    def allele_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (mac, total_alleles) per SNP: minor allele count over
        observed calls."""
        obs = self.matrix != MISSING
        tot = obs.sum(axis=1) * self.ploidy
        alt = np.where(obs, self.matrix, 0).sum(axis=1)
        mac = np.minimum(alt, tot - alt)
        return mac.astype(np.int64), tot.astype(np.int64)

    def get_macs(self) -> np.ndarray:
        return self.allele_counts()[0]

    def get_mafs(self) -> np.ndarray:
        mac, tot = self.allele_counts()
        with np.errstate(divide="ignore", invalid="ignore"):
            maf = np.where(tot > 0, mac / np.maximum(tot, 1), 0.0)
        return maf

    # ---- filters (reference: filter_mac_snps / filter_maf_snps) ----
    def select_snps(self, mask: np.ndarray) -> "GenotypeData":
        mask = np.asarray(mask)
        return type(self)(
            matrix=self.matrix[mask],
            chromosomes=self.chromosomes[mask],
            positions=self.positions[mask],
            accessions=self.accessions,
            ploidy=self.ploidy,
            alleles=None if self.alleles is None else self.alleles[mask],
        )

    def filter_mac_snps(self, min_mac: int = 15) -> "GenotypeData":
        return self.select_snps(self.get_macs() >= min_mac)

    def filter_maf_snps(self, min_maf: float = 0.0) -> "GenotypeData":
        return self.select_snps(self.get_mafs() >= min_maf)

    def filter_monomorphic_snps(self) -> "GenotypeData":
        return self.filter_mac_snps(1)

    # ---- sample operations ----
    def select_samples(self, idx: Sequence[int]) -> "GenotypeData":
        idx = np.asarray(idx, dtype=np.int64)
        return type(self)(
            # np.take: the same columns as matrix[:, idx], gathered row by
            # row (about ten times faster than fancy indexing on axis 1)
            matrix=np.take(self.matrix, idx, axis=1),
            chromosomes=self.chromosomes,
            positions=self.positions,
            accessions=[self.accessions[i] for i in idx],
            ploidy=self.ploidy,
            alleles=self.alleles,
        )

    def coordinate_with_phenotype(self, phend, pid: int,
                                  drop_monomorphic: bool = True):
        """Sample intersection + reordering with a phenotype
        (reference: SNPsDataSet.coordinate_w_phenotype_data, SURVEY.md §3.5):
        genotype columns are subset/reordered to the phenotyped samples
        (in genotype accession order); phenotype values are averaged per
        accession and aligned; monomorphic SNPs after subsetting dropped.

        Returns (genotype_subset, y_aligned, sample_ids)."""
        eco2vals = phend.value_dict(pid)
        keep = [i for i, a in enumerate(self.accessions) if a in eco2vals]
        if not keep:
            raise ValueError("no overlapping samples between genotype and "
                             f"phenotype {pid}")
        gd = self.select_samples(keep)
        y = np.array([np.mean(eco2vals[a]) for a in gd.accessions],
                     dtype=np.float64)
        if drop_monomorphic:
            gd = gd.filter_monomorphic_snps()
        return gd, y, list(gd.accessions)

    # ---- region queries (reference: get_region_snps) ----
    def get_region(self, chromosome: int, start: int, stop: int) -> "GenotypeData":
        mask = ((self.chromosomes == chromosome)
                & (self.positions >= start) & (self.positions <= stop))
        return self.select_snps(mask)

    def get_region_snps(self, chromosome: int, start: int,
                        stop: int) -> np.ndarray:
        """Reference-named: SNP rows within [start, stop] on a chromosome
        (reference: SNPsDataSet.get_region_snps)."""
        return self.get_region(chromosome, start, stop).matrix

    def coordinate_w_phenotype_data(self, phend, pid: int,
                                    drop_monomorphic: bool = True):
        """Reference-named alias of coordinate_with_phenotype
        (reference: SNPsDataSet.coordinate_w_phenotype_data)."""
        return self.coordinate_with_phenotype(
            phend, pid, drop_monomorphic=drop_monomorphic)

    # ---- kinship delegation (reference: get_ibs/ibd_kinship_matrix) ----
    def get_ibs_kinship_matrix(self, use_device: bool = True,
                               device=None) -> np.ndarray:
        from mixmogam_tpu_torch.ops import kinship as dk

        return dk.kinship(self, method="ibs", use_device=use_device,
                          device=device)

    def get_ibd_kinship_matrix(self, use_device: bool = True,
                               device=None) -> np.ndarray:
        from mixmogam_tpu_torch.ops import kinship as dk

        return dk.kinship(self, method="vanraden", use_device=use_device,
                          device=device)

    # ---- content hash (keys the kinship/eigen artifact caches) ----
    def content_hash(self) -> str:
        h = hashlib.sha256()
        h.update(self.matrix.tobytes())
        h.update(self.chromosomes.tobytes())
        h.update(self.positions.tobytes())
        h.update("|".join(self.accessions).encode())
        h.update(str(self.ploidy).encode())
        return h.hexdigest()[:16]

    # ---- I/O ----
    def write_csv(self, path: str) -> None:
        """Binary/dosage CSV: header 'Chromosome,Position,acc1,...';
        one row per SNP (reference: SNPsDataSet.writeToFile shape)."""
        # vectorized formatting in ROW CHUNKS of CSV_CHUNK_BYTES: a
        # whole-matrix U4 copy + str list would be many times the matrix
        with open(path, "w") as f:
            f.write("Chromosome,Position," + ",".join(self.accessions)
                    + "\n")
            step = csv_chunk_rows(self.num_samples)
            for s in range(0, self.num_snps, step):
                m = self.matrix[s:s + step]
                S = m.astype("U4")
                S[m == MISSING] = "NA"
                ch = self.chromosomes[s:s + step].astype("U12").tolist()
                po = self.positions[s:s + step].astype("U20").tolist()
                rows = S.tolist()
                f.write("\n".join(f"{c},{p}," + ",".join(r)
                                  for c, p, r in zip(ch, po, rows)))
                if rows:
                    f.write("\n")

    def write_hdf5(self, path: str) -> None:
        import h5py

        with h5py.File(path, "w") as f:
            f.create_dataset("matrix", data=self.matrix,
                             chunks=(min(4096, self.num_snps),
                                     self.num_samples),
                             compression="gzip", compression_opts=1)
            f.create_dataset("chromosomes", data=self.chromosomes)
            f.create_dataset("positions", data=self.positions)
            f.create_dataset(
                "accessions",
                data=np.array(self.accessions, dtype=h5py.string_dtype()))
            f.attrs["ploidy"] = self.ploidy

    def write_packed(self, path: str) -> None:
        """Compact container: 2-bit genotypes (4 samples/byte;
        data/pack2.py) + metadata in one npz, the JAX package's layout."""
        from mixmogam_tpu_torch.data import pack2

        np.savez_compressed(
            path,
            packed=pack2.pack_2bit(self.matrix),
            n_samples=np.int64(self.num_samples),
            chromosomes=self.chromosomes,
            positions=self.positions,
            accessions=np.array(self.accessions, dtype="U"),
            ploidy=np.int64(self.ploidy))

    @staticmethod
    def read_packed(path: str) -> "GenotypeData":
        from mixmogam_tpu_torch.data import pack2

        if not os.path.exists(path) and os.path.exists(path + ".npz"):
            # np.savez_compressed appends '.npz' to suffix-less names,
            # so write_packed('x.packed') created 'x.packed.npz' —
            # accept the same name back
            path = path + ".npz"
        with np.load(path, allow_pickle=False) as z:
            n = int(z["n_samples"])
            return GenotypeData(
                matrix=pack2.unpack_2bit(z["packed"], n),
                chromosomes=z["chromosomes"],
                positions=z["positions"],
                accessions=[str(a) for a in z["accessions"]],
                ploidy=int(z["ploidy"]))

    @staticmethod
    def read_hdf5(path: str) -> "GenotypeData":
        import h5py

        with h5py.File(path, "r") as f:
            if f.attrs.get("dosage", False):
                # a DosageData container: dispatch instead of casting
                # the float matrix to int8 (0.7 -> 0, NaN -> undefined
                # — silent corruption)
                return DosageData.read_hdf5(path)
            return GenotypeData(
                matrix=f["matrix"][:],
                chromosomes=f["chromosomes"][:],
                positions=f["positions"][:],
                accessions=[a.decode() if isinstance(a, bytes) else str(a)
                            for a in f["accessions"][:]],
                ploidy=int(f.attrs.get("ploidy", 1)),
            )


# Reference-named class alias: the reference's genome-wide container is
# SNPsDataSet (snpsdata.py); this framework's single packed container plays
# that role.
SNPsDataSet = GenotypeData


class DosageData(GenotypeData):
    """Float dosage container — NaN = missing (capability extension;
    reference snpsdata.py stores hard calls only). Backing store for
    imputed/expected ALT dosages, e.g. a VCF's DS FORMAT field
    (data/vcf.py read_vcf(field='DS')).

    Mirrors the GenotypeData surface the pipelines use (filters,
    sample selection, phenotype coordination, kinship delegation); the
    scan paths treat the float matrix like any imputed source. Dosages
    are fractional, so the int8 digit-plane tiers refuse it
    (precision='auto'/'fast' resolve to exact/bf16) and the 2-bit
    ResidentGenome packing does not apply — use the streamed float path
    at scale. MAC/MAF are EXPECTED allele counts (sums of dosages over
    observed samples); filter_mac_snps thresholds that expectation."""

    def __post_init__(self):
        self.matrix = np.ascontiguousarray(self.matrix, dtype=np.float32)
        self.chromosomes = np.asarray(self.chromosomes, dtype=np.int32)
        self.positions = np.asarray(self.positions, dtype=np.int64)
        self.accessions = [str(a) for a in self.accessions]
        assert self.matrix.shape == (len(self.chromosomes),
                                     len(self.accessions))

    def allele_counts(self) -> Tuple[np.ndarray, np.ndarray]:
        obs = ~np.isnan(self.matrix)
        tot = obs.sum(axis=1) * self.ploidy
        alt = np.where(obs, self.matrix, 0.0).sum(axis=1)
        mac = np.minimum(alt, tot - alt)
        return mac, tot.astype(np.int64)

    def dosage_f64(self) -> np.ndarray:
        Z = self.matrix.astype(np.float64)
        miss = np.isnan(Z)
        if miss.any():
            mu = np.nanmean(np.where(miss, np.nan, Z), axis=1)
            mu = np.where(np.isnan(mu), 0.0, mu)
            idx = np.where(miss)
            Z[idx] = mu[idx[0]]
        return Z

    # content_hash: inherited from GenotypeData

    def write_csv(self, path: str) -> None:
        raise NotImplementedError(
            "DosageData holds fractional dosages; the CSV container "
            "stores hard calls. Use write_hdf5 or keep the source VCF.")

    def write_packed(self, path: str) -> None:
        raise NotImplementedError(
            "2-bit packing stores hard calls 0..2; fractional dosages "
            "cannot pack. Use write_hdf5.")

    def write_hdf5(self, path: str) -> None:
        import h5py

        with h5py.File(path, "w") as f:
            f.create_dataset("matrix", data=self.matrix,
                             compression="gzip")
            f.create_dataset("chromosomes", data=self.chromosomes)
            f.create_dataset("positions", data=self.positions)
            f.create_dataset(
                "accessions",
                data=np.asarray(self.accessions, dtype="S"))
            f.attrs["ploidy"] = self.ploidy
            f.attrs["dosage"] = True

    @staticmethod
    def read_hdf5(path: str) -> "DosageData":
        import h5py

        with h5py.File(path, "r") as f:
            return DosageData(
                matrix=f["matrix"][:],
                chromosomes=f["chromosomes"][:],
                positions=f["positions"][:],
                accessions=[a.decode() if isinstance(a, bytes) else str(a)
                            for a in f["accessions"][:]],
                ploidy=int(f.attrs.get("ploidy", 2)),
            )
