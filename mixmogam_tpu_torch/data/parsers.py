"""Genotype file parsing (counterpart of mixmogam_tpu/data/parsers.py: a
dosage CSV's body goes through the C++ threaded parser of the port's host
library, native.py, and takes the Python route below when the library is
unavailable or the body is irregular. Reference: dataParsers.py +
hdf5_data.py, SURVEY.md §2.1 L2).

Formats:
- 'binary'/'dosage' CSV: header 'Chromosome,Position,acc1,...'; rows of
  integer dosages (0/1 binary-coded inbred data like the reference's
  bundled Arabidopsis set, or 0/1/2 diploid), NA = missing.
- 'nucleotides' CSV: same layout but nucleotide calls; decoded to
  minor-allele dosage against the per-SNP major allele (two most frequent
  alleles kept, others -> missing), alleles recorded. Haploid single-letter
  calls ('A') -> 0/1; diploid two-allele calls ('AT', 'A/T', 'A|T') and
  IUPAC heterozygote codes (R/Y/S/W/K/M) -> 0/1/2 with ploidy=2. Ploidy is
  auto-detected (any two-allele or IUPAC-het call makes the file diploid)
  or forced via the ploidy kwarg.
- HDF5: the framework's own container (see GenotypeData.read_hdf5).

Parsing streams line-by-line into preallocated int8 — the entire genome is
one packed matrix, ready for device tiling (no per-chromosome Python
lists)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from mixmogam_tpu_torch import native
from mixmogam_tpu_torch.data.genotype import GenotypeData, MISSING

_MISSING_TOKENS = {"", "NA", "N", "NaN", "nan", "-", "?"}


def _try_native_dosage(path: str):
    """The C++ threaded parser's (matrix, chromosomes, positions, n), or
    None -> the Python route."""
    return native.parse_dosage_csv(path)


def parse_snp_data(path: str, data_format: str = "binary",
                   delimiter: str = ",", ploidy: Optional[int] = None
                   ) -> GenotypeData:
    """Parse a genotype file into a GenotypeData
    (reference: dataParsers.parse_snp_data)."""
    if path.endswith((".h5", ".hdf5")):
        gd = GenotypeData.read_hdf5(path)
        if ploidy is not None and ploidy != gd.ploidy:
            # explicit override of the container's stored ploidy (e.g. a
            # 0/1-coded diploid file whose max dosage never exceeded 1 was
            # auto-inferred haploid at write time); validate dosage range
            if gd.matrix.max(initial=0) > ploidy:
                raise ValueError(
                    f"ploidy={ploidy} conflicts with dosages up to "
                    f"{gd.matrix.max()} in {path}")
            gd = dataclasses.replace(gd, ploidy=ploidy)
        return gd
    if path.endswith((".vcf", ".vcf.gz")) or data_format in ("vcf",
                                                            "vcf_ds"):
        from mixmogam_tpu_torch.data.vcf import read_vcf

        if data_format == "vcf_ds":
            # imputed ALT dosages -> float DosageData (NaN missing);
            # fractional dosages route to the non-int8 scan tiers.
            # ploidy threads through (the DS range heuristic
            # misclassifies all-<=1 diploid chunks as haploid)
            return read_vcf(path, field="DS", ploidy=ploidy)
        gd = read_vcf(path)
        if ploidy is not None and ploidy != gd.ploidy:
            if gd.matrix.max(initial=0) > ploidy:
                raise ValueError(
                    f"ploidy={ploidy} conflicts with dosages up to "
                    f"{gd.matrix.max()} in {path}")
            gd = dataclasses.replace(gd, ploidy=ploidy)
        return gd
    if path.endswith(".bed") or data_format == "plink":
        from mixmogam_tpu_torch.data.plink import read_plink

        gd = read_plink(path)
        if ploidy is not None and ploidy != gd.ploidy:
            gd = dataclasses.replace(gd, ploidy=ploidy)
        return gd
    if data_format in ("binary", "dosage", "int"):
        return _parse_dosage_csv(path, delimiter, ploidy)
    if data_format in ("nucleotides", "nt"):
        return _parse_nucleotide_csv(path, delimiter, ploidy)
    raise ValueError(f"unknown data_format {data_format!r}")


def _read_header(f, delimiter: str) -> List[str]:
    header = f.readline().rstrip("\n").split(delimiter)
    if len(header) < 3:
        raise ValueError("genotype CSV needs Chromosome,Position,acc...")
    return [a.strip() for a in header[2:]]


def _parse_dosage_csv(path: str, delimiter: str,
                      ploidy: Optional[int]) -> GenotypeData:
    if delimiter == ",":
        nat = _try_native_dosage(path)
        if nat is not None:
            matrix, chroms_a, poss_a, n = nat
            with open(path) as f:
                accessions = _read_header(f, delimiter)
            if len(accessions) == n:
                if ploidy is None:
                    ploidy = 2 if matrix.max(initial=0) > 1 else 1
                return GenotypeData(matrix=matrix, chromosomes=chroms_a,
                                    positions=poss_a,
                                    accessions=accessions, ploidy=ploidy)
    chroms: List[int] = []
    poss: List[int] = []
    rows: List[np.ndarray] = []
    with open(path) as f:
        accessions = _read_header(f, delimiter)
        n = len(accessions)
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split(delimiter)
            chroms.append(int(parts[0]))
            poss.append(int(parts[1]))
            row = np.full(n, MISSING, dtype=np.int8)
            for i, tok in enumerate(parts[2:2 + n]):
                tok = tok.strip()
                if tok not in _MISSING_TOKENS:
                    v = int(tok)
                    # any negative token = missing sentinel; storing
                    # e.g. -5 verbatim would count it as an OBSERVED
                    # dosage downstream
                    row[i] = v if v >= 0 else MISSING
            rows.append(row)
    matrix = np.vstack(rows) if rows else np.zeros((0, n), dtype=np.int8)
    if ploidy is None:
        ploidy = 2 if matrix.max(initial=0) > 1 else 1
    return GenotypeData(matrix=matrix,
                        chromosomes=np.asarray(chroms, dtype=np.int32),
                        positions=np.asarray(poss, dtype=np.int64),
                        accessions=accessions, ploidy=ploidy)


# IUPAC ambiguity codes for heterozygous single-letter diploid calls
# (reference's nucleotide formats are diploid-capable, SURVEY.md §2.1).
_IUPAC_HET = {"R": "AG", "Y": "CT", "S": "CG", "W": "AT", "K": "GT",
              "M": "AC"}
_BASES = frozenset("ACGT")


def _call_alleles(tok: str) -> Optional[Tuple[str, ...]]:
    """Normalize one genotype call to its allele tuple, or None if missing.
    'A' -> ('A',); 'AT' / 'A/T' / 'A|T' -> ('A','T'); IUPAC het 'R' ->
    ('A','G'); anything else (incl. 'NN', 'N', '') -> None."""
    t = tok.strip().upper().replace("/", "").replace("|", "")
    if not t or t in _MISSING_TOKENS:
        return None
    if len(t) == 1:
        if t in _BASES:
            return (t,)
        het = _IUPAC_HET.get(t)
        return tuple(het) if het else None
    if len(t) == 2 and t[0] in _BASES and t[1] in _BASES:
        return (t[0], t[1])
    return None


def _parse_nucleotide_csv(path: str, delimiter: str,
                          ploidy: Optional[int] = None) -> GenotypeData:
    """Nucleotide CSV -> minor-allele dosages.

    One pass over the file. Rows parsed before diploid evidence appears
    (a two-allele or IUPAC-het call, when ploidy is auto) are coded with
    per-call copy counts and retro-doubled at the end if the file turns
    out diploid — exact, because a single-letter call under ploidy=2 is
    homozygous (2 copies of that allele)."""
    if ploidy not in (None, 1, 2):
        raise ValueError(f"ploidy must be 1, 2 or None, got {ploidy!r}")
    chroms: List[int] = []
    poss: List[int] = []
    rows: List[np.ndarray] = []
    alleles: List[List[str]] = []
    # True once a 2-allele call has been seen (or forced via ploidy=2)
    diploid = ploidy == 2
    # rows encoded while the file still looked haploid; their 0/1 dosages
    # become 0/2 if diploid evidence appears later
    haploid_coded: List[int] = []
    with open(path) as f:
        accessions = _read_header(f, delimiter)
        n = len(accessions)
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split(delimiter)
            chroms.append(int(parts[0]))
            poss.append(int(parts[1]))
            calls = [_call_alleles(t) for t in parts[2:2 + n]]
            if ploidy == 1:
                # forced haploid: heterozygous calls are uninterpretable
                # -> missing; homozygous two-letter calls collapse
                calls = [None if (c and len(set(c)) > 1)
                         else (c[:1] if c else None) for c in calls]
            elif not diploid and any(c and len(c) == 2 for c in calls):
                diploid = True
            # rank alleles by TRUE copy count: under diploid a
            # single-letter (homozygous) call carries 2 copies — raw
            # per-call counts would misrank 3+-allele sites (e.g.
            # A,A,A,GT,GT,GT,GT: true copies A=6 > G=T=4, but raw
            # counts A=3 < 4 would drop A as the "3rd" allele)
            cp = 2 if diploid else 1
            counts: dict = {}
            for c in calls:
                if c:
                    w = cp // len(c)
                    for a in c:
                        counts[a] = counts.get(a, 0) + w
            ranked = sorted(counts, key=lambda a: (-counts[a], a))
            major = ranked[0] if ranked else "N"
            minor = ranked[1] if len(ranked) > 1 else "N"
            keep = {major, minor} - {"N"}
            call_ploidy = 2 if diploid else 1
            row = np.full(n, MISSING, dtype=np.int8)
            for i, c in enumerate(calls):
                if c is None or not set(c) <= keep:
                    continue  # missing, or carries a 3rd allele
                copies = sum(1 for a in c if a == minor)
                # single-letter (homozygous) call under diploid = 2 copies
                row[i] = copies * (call_ploidy // len(c))
            if not diploid:
                haploid_coded.append(len(rows))
            rows.append(row)
            alleles.append([major, minor])
    matrix = np.vstack(rows) if rows else np.zeros((0, n), dtype=np.int8)
    out_ploidy = 2 if diploid else 1
    if diploid and haploid_coded and ploidy is None:
        # retro-fix rows parsed before the first diploid evidence
        fix = np.asarray(haploid_coded, dtype=np.int64)
        obs = matrix[fix] != MISSING
        matrix[fix] = np.where(obs, matrix[fix] * 2, MISSING)
    return GenotypeData(matrix=matrix,
                        chromosomes=np.asarray(chroms, dtype=np.int32),
                        positions=np.asarray(poss, dtype=np.int64),
                        accessions=accessions, ploidy=out_ploidy,
                        alleles=np.asarray(alleles))
