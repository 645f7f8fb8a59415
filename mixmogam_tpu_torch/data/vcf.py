"""VCF genotype input/output (counterpart of mixmogam_tpu/data/vcf.py). GT
records go through the C++ streaming parser of the port's host library
(native.py; plain text, gzip and bgzip through zlib) and take the
pure-Python route below when the library is unavailable or a record is
irregular: both give the same containers.

The reference reads only its own CSV/HDF5 formats (dataParsers.py per
SURVEY.md §2.1); modern cohorts ship as VCF, so this closes the same gap
as data/plink.py does for PLINK filesets. Plain-text and gzip/bgzip-
compressed files; GT hard calls by default, plus:

- ``read_vcf(field='DS')`` — imputed ALT-dosage floats into a
  DosageData (NaN missing), routed to the non-int8 scan tiers.
- ``read_vcf_packed`` — memory-bounded cohort-scale parse straight into
  the 2-bit device-resident container: rows pack chunk-by-chunk, the
  (M, n) int8 matrix is never materialized.
- ``read_vcf(field='DS')`` reads through the Python route only, as in
  the JAX package.

Conventions:
- Dosage counts ALT alleles (the VCF/PLINK "--keep-allele-order"
  convention; NOT necessarily the minor allele). ``alleles`` stores
  [REF, ALT] per site.
- Multi-allelic sites: the dosage counts allele index 1 (the FIRST ALT);
  any call carrying an allele index >= 2 is coded missing — the same
  "third allele -> missing" rule as the nucleotide CSV decoder
  (data/parsers.py).
- Ploidy is the maximum GT arity observed (diploid '0/1' -> 2, haploid
  '0' -> 1); phased '|' and unphased '/' are equivalent. A haploid call
  in a diploid file contributes its literal copy count (chrX-style mixed
  ploidy is preserved per call, not doubled).
- Chromosome names: a leading 'chr' prefix is stripped; numeric names
  keep their value; non-numeric names (X, Y, MT, scaffolds) get
  sequential integer codes above the largest numeric code, in first-
  appearance order. ``read_vcf(..., return_chrom_map=True)`` also
  returns the {name: code} dict.
"""

from __future__ import annotations

import gzip
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from mixmogam_tpu_torch import native
from mixmogam_tpu_torch.data.genotype import GenotypeData, MISSING

_MISSING_GT = {".", "./.", ".|."}


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def _chrom_code(name: str, numeric_max: List[int],
                mapping: Dict[str, int]) -> int:
    if name in mapping:
        return mapping[name]
    stripped = name[3:] if name.lower().startswith("chr") else name
    try:
        code = int(stripped)
        numeric_max[0] = max(numeric_max[0], code)
    except ValueError:
        code = None
    mapping[name] = code  # may be None for now; resolved in a 2nd pass
    return code


def _parse_gt(tok: str) -> Optional[Tuple[int, ...]]:
    """GT string -> tuple of allele indices, or None if missing.
    '0/1' -> (0, 1); '0|0' -> (0, 0); '1' -> (1,); './.' / '.' -> None.
    A partial call like './1' keeps the observed allele only."""
    if tok in _MISSING_GT:
        return None
    out = []
    for a in tok.replace("|", "/").split("/"):
        if a == ".":
            continue
        try:
            out.append(int(a))
        except ValueError:
            return None
    return tuple(out) if out else None


def _vcf_header_samples(path: str):
    """Sample IDs from the #CHROM header, or None when the header is
    malformed or absent (the Python route then raises the descriptive
    error)."""
    try:
        with _open_text(path) as f:
            for line in f:
                if line.startswith("##"):
                    continue
                if line.startswith("#CHROM"):
                    # rstrip \r too: a CRLF VCF must not leave a trailing
                    # \r on the last sample ID
                    parts = line.rstrip("\r\n").split("\t")
                    if len(parts) < 10 or parts[8] != "FORMAT":
                        return None
                    return parts[9:]
                break
    except (OSError, UnicodeDecodeError, EOFError):
        return None
    return None


def _chrom_names(names16: np.ndarray) -> List[str]:
    """The native parser's NUL-padded (m, 16) CHROM tokens as strings."""
    return [bytes(r).rstrip(b"\0").decode() for r in names16]


def _read_vcf_native(path: str):
    """(GenotypeData, chrom_map) through the C++ streaming parser, or None
    -> the pure-Python route (library unavailable, or any structural
    irregularity: the Python reader then raises where an error is due)."""
    samples = _vcf_header_samples(path)
    if not samples:
        return None
    out = native.parse_vcf(path, len(samples))
    if out is None:
        return None
    mat, poss, codes, names, alleles, arity = out
    # chromosome codes from _resolve_chrom_map, the Python route's own
    name_strs = _chrom_names(names)
    if name_strs:
        mapping = _resolve_chrom_map(name_strs)
        chrom_out = np.asarray([mapping[nm] for nm in name_strs],
                               dtype=np.int32)
    else:
        mapping = {}
        chrom_out = np.asarray(codes, dtype=np.int32).copy()
    gd = GenotypeData(
        matrix=mat, chromosomes=chrom_out, positions=poss,
        accessions=samples, ploidy=int(arity),
        alleles=alleles if len(alleles) else None)
    return gd, mapping


def read_vcf(path: str, return_chrom_map: bool = False,
             field: str = "GT", ploidy: Optional[int] = None
             ) -> Union[GenotypeData, Tuple[GenotypeData, Dict[str, int]]]:
    """Parse a VCF (.vcf or .vcf.gz) into a GenotypeData of hard-call
    ALT dosages. See the module docstring for coding conventions. GT
    files go through the C++ streaming parser (native.py) when it is
    available; anything irregular takes the pure-Python route below
    (the same containers).

    field='DS' reads the imputed ALT-dosage FORMAT field instead into a
    float DosageData (NaN missing; records without DS are skipped;
    multi-allelic DS lists take the first ALT, matching the GT rule).
    ploidy: explicit override for the DS path, where ploidy cannot be
    read off the calls — the range heuristic ('2 if any dosage > 1')
    misclassifies a diploid chunk whose dosages all happen to be <= 1
    (e.g. rare variants), halving allele_counts downstream.
    The GT path infers ploidy from call arity and ignores this kwarg
    (use parse_snp_data(ploidy=...) for a validated GT override)."""
    if field == "DS":
        return _read_vcf_ds(path, return_chrom_map, ploidy=ploidy)
    if field != "GT":
        raise ValueError(f"unsupported FORMAT field {field!r}; "
                         "supported: 'GT' (hard calls), 'DS' (dosages)")
    nat = _read_vcf_native(path)
    if nat is not None:
        gd, mapping = nat
        return (gd, mapping) if return_chrom_map else gd
    samples: List[str] = []
    chrom_names: List[str] = []
    poss_parts: List[np.ndarray] = []
    mats: List[np.ndarray] = []
    allele_parts: List[np.ndarray] = []
    max_arity = 1
    for (smp, mat, pos_c, names_c, all_c,
         arity_c) in _iter_vcf_python(path):
        samples = smp
        mats.append(mat)
        poss_parts.append(pos_c)
        chrom_names.extend(names_c)
        allele_parts.append(all_c)
        max_arity = max(max_arity, arity_c)
    mapping = _resolve_chrom_map(chrom_names)
    n = len(samples)
    matrix = np.vstack(mats) if mats else np.zeros((0, n), dtype=np.int8)
    alleles = (np.concatenate(allele_parts)
               if allele_parts and sum(a.shape[0] for a in allele_parts)
               else None)
    gd = GenotypeData(
        matrix=matrix,
        chromosomes=np.asarray([mapping[c] for c in chrom_names],
                               dtype=np.int32),
        positions=(np.concatenate(poss_parts) if poss_parts
                   else np.zeros(0, dtype=np.int64)),
        accessions=samples,
        ploidy=max_arity,
        alleles=alleles,
    )
    if return_chrom_map:
        return gd, {k: int(v) for k, v in mapping.items()}
    return gd


def _resolve_chrom_map(chrom_names: List[str]) -> Dict[str, int]:
    """First-appearance chromosome code assignment (module docstring):
    numeric names keep their value; non-numeric names get sequential
    codes above the largest numeric code."""
    numeric_max = [0]
    mapping: Dict[str, Optional[int]] = {}
    for name in chrom_names:
        _chrom_code(name, numeric_max, mapping)
    next_code = numeric_max[0]
    for name in mapping:
        if mapping[name] is None:
            next_code += 1
            mapping[name] = next_code
    return {k: int(v) for k, v in mapping.items()}


def _iter_vcf_python(path: str, chunk_rows: int = 65_536,
                     field: str = "GT"):
    """Pure-Python streaming VCF parser: yields per-chunk tuples
    (samples, matrix, positions, chrom_names list, alleles (m, 2) str,
    chunk_max_arity). field='GT' -> int8 hard calls (-1 missing);
    field='DS' -> float32 dosages (NaN missing; first ALT of a
    multi-allelic DS list, matching the GT rule; arity stays at its
    initial value 1 for DS chunks — it is meaningless there and MUST be
    ignored; callers take ploidy from an explicit kwarg or the dosage
    range instead, see _read_vcf_ds). At least
    one (possibly empty) chunk is yielded so callers always see the
    sample list. Raises descriptive ValueErrors on malformed input."""
    samples: List[str] = []
    seen_header = False
    mdt = np.float32 if field == "DS" else np.int8
    miss = np.nan if field == "DS" else MISSING

    def empty_chunk():
        return (samples, np.zeros((0, len(samples)), dtype=mdt),
                np.zeros(0, dtype=np.int64), [],
                np.zeros((0, 2), dtype=str), 1)

    rows: List[np.ndarray] = []
    poss: List[int] = []
    names: List[str] = []
    alleles: List[Tuple[str, str]] = []
    arity = 1
    yielded = False
    with _open_text(path) as f:
        for line in f:
            line = line.rstrip("\r\n")
            if not line:
                continue
            if line.startswith("##"):
                continue
            if line.startswith("#CHROM"):
                parts = line.split("\t")
                if len(parts) < 10 or parts[8] != "FORMAT":
                    raise ValueError(
                        "VCF has no sample/FORMAT columns: " + parts[0])
                samples = parts[9:]
                seen_header = True
                continue
            if not seen_header:
                raise ValueError("VCF data line before #CHROM header")
            parts = line.split("\t")
            if len(parts) < 9:
                raise ValueError(
                    f"truncated VCF record ({len(parts)} tab-separated "
                    f"fields, need >= 9): {line[:80]!r}")
            chrom, pos, _id, ref, alt = parts[:5]
            fmt = parts[8].split(":")
            try:
                f_idx = fmt.index(field)
            except ValueError:
                continue  # record lacks the requested field -> skip
            names.append(chrom)
            poss.append(int(pos))
            alleles.append((ref, alt.split(",")[0]))
            row = np.full(len(samples), miss, dtype=mdt)
            for i, call in enumerate(parts[9:9 + len(samples)]):
                if ":" in call:
                    toks = call.split(":")
                    # trailing FORMAT fields may be dropped per sample
                    # (VCF 4.x spec) -> missing, not IndexError
                    tok = toks[f_idx] if f_idx < len(toks) else "."
                else:
                    tok = call
                if field == "DS":
                    try:
                        row[i] = float(tok.split(",")[0])
                    except ValueError:
                        pass  # '.' / junk -> NaN
                    continue
                gt = _parse_gt(tok)
                if gt is None or any(a > 1 for a in gt):
                    continue  # missing, or carries a 2nd ALT allele
                arity = max(arity, len(gt))
                row[i] = sum(gt)
            rows.append(row)
            if len(rows) >= chunk_rows:
                yield (samples, np.vstack(rows),
                       np.asarray(poss, dtype=np.int64), names,
                       np.asarray(alleles, dtype=str), arity)
                yielded = True
                rows, poss, names, alleles = [], [], [], []
                arity = 1
    if rows:
        yield (samples, np.vstack(rows), np.asarray(poss, dtype=np.int64),
               names, np.asarray(alleles, dtype=str), arity)
    elif not yielded:
        yield empty_chunk()


def _read_vcf_ds(path: str, return_chrom_map: bool = False,
                 ploidy: Optional[int] = None):
    """read_vcf(field='DS'): imputed ALT dosages -> DosageData (float32,
    NaN missing). Fractional dosages route to the non-int8 scan tiers
    (resolve_precision refuses int8 digit planes for them). ploidy:
    explicit caller knowledge (validated against the dosage range);
    None falls back to the '2 if max dosage > 1' heuristic."""
    from mixmogam_tpu_torch.data.genotype import DosageData

    samples: List[str] = []
    chrom_names: List[str] = []
    mats, poss_parts, allele_parts = [], [], []
    for (smp, mat, pos_c, names_c, all_c,
         _a) in _iter_vcf_python(path, field="DS"):
        samples = smp
        mats.append(mat)
        poss_parts.append(pos_c)
        chrom_names.extend(names_c)
        allele_parts.append(all_c)
    mapping = _resolve_chrom_map(chrom_names)
    matrix = (np.vstack(mats) if mats
              else np.zeros((0, len(samples)), dtype=np.float32))
    vmax = np.nanmax(matrix, initial=0.0) if matrix.size else 0.0
    if ploidy is not None and vmax > ploidy:
        raise ValueError(
            f"ploidy={ploidy} conflicts with DS dosages up to {vmax} "
            f"in {path}")
    gd = DosageData(
        matrix=matrix,
        chromosomes=np.asarray([mapping[c] for c in chrom_names],
                               dtype=np.int32),
        positions=(np.concatenate(poss_parts) if poss_parts
                   else np.zeros(0, dtype=np.int64)),
        accessions=samples,
        ploidy=(int(ploidy) if ploidy is not None
                else (2 if vmax > 1 else 1)),
        alleles=(np.concatenate(allele_parts)
                 if chrom_names else None),
    )
    return (gd, mapping) if return_chrom_map else gd


def read_vcf_packed(path: str, tile: int = 16_384,
                    chunk_rows: int = 65_536, device=None):
    """Memory-bounded cohort-scale VCF parse straight into the 2-bit
    device-resident container: GT rows are uploaded and packed
    chunk-by-chunk on `device` (the card by default, 'cpu' on request), so
    the (M, n) int8 matrix is NEVER materialized: the host holds one
    parse chunk plus, at the end, its copy of the packed rows. The chunks
    come from the C++ streaming parser (native.iter_vcf), or from the
    pure-Python iterator when the library is unavailable or a record is
    irregular.

    Returns (ResidentGenome, meta) where meta carries 'chromosomes'
    (int32 codes), 'positions', 'accessions', 'alleles', 'chrom_map'.
    Diploid/haploid GT only (the 2-bit container stores dosages 0..2);
    polyploid files raise."""
    import torch

    from mixmogam_tpu_torch.models.resident import ResidentGenome
    from mixmogam_tpu_torch.ops import resolve_device
    from mixmogam_tpu_torch.ops.pack2 import pack_2bit_device

    device = resolve_device(device)

    def consume(chunks):
        acc = {"packed": [], "poss": [], "names": [], "alleles": [],
               "arity": 1, "missing": False, "samples": []}
        for smp, mat, pos_c, names_c, all_c, arity_c in chunks:
            acc["samples"] = smp
            if mat.shape[0] == 0:
                continue
            acc["arity"] = max(acc["arity"], int(arity_c))
            if acc["arity"] > 2 or (mat.size and mat.max(initial=0) > 2):
                raise ValueError(
                    "read_vcf_packed stores diploid/haploid dosages "
                    "0..2 in the 2-bit container; this VCF is "
                    f"polyploid (arity {acc['arity']}). Use read_vcf().")
            acc["missing"] |= bool((mat < 0).any())
            acc["packed"].append(pack_2bit_device(
                torch.from_numpy(np.ascontiguousarray(mat)).to(device)))
            acc["poss"].append(np.asarray(pos_c, dtype=np.int64))
            acc["names"].extend(names_c)
            acc["alleles"].append(np.asarray(all_c, dtype=str))
        return acc

    acc = None
    samples = _vcf_header_samples(path)
    if samples and native.available():
        def native_chunks():
            for mat, pos_c, _codes, names16, all_c, arity_c in \
                    native.iter_vcf(path, len(samples),
                                    chunk_rows=chunk_rows):
                yield (samples, mat, pos_c, _chrom_names(names16), all_c,
                       arity_c)
        try:
            acc = consume(native_chunks())
        except RuntimeError:
            acc = None       # the native header disagrees with Python's
        except ValueError as err:
            if "malformed VCF" not in str(err):
                raise        # the polyploid refusal is not a fallback
            acc = None       # an irregular record: the Python route
            #                  parses it or raises the descriptive error
    if acc is None:
        acc = consume(_iter_vcf_python(path, chunk_rows=chunk_rows))
    # a body with no record gives the native route no chunk
    samples = acc["samples"] or samples or []
    n = len(samples)
    M = sum(p.shape[0] for p in acc["packed"])
    M_pad = -(-max(M, 1) // tile) * tile
    packed = torch.zeros((M_pad, (n + 3) // 4), dtype=torch.uint8,
                         device=device)
    w = 0
    for p in acc["packed"]:
        packed[w:w + p.shape[0]] = p
        w += p.shape[0]
    rg = ResidentGenome(packed, M, n, acc["arity"], tile, acc["missing"])
    chrom_names = acc["names"]
    mapping = _resolve_chrom_map(chrom_names)
    meta = {
        "chromosomes": np.asarray([mapping[c] for c in chrom_names],
                                  dtype=np.int32),
        "positions": (np.concatenate(acc["poss"]) if acc["poss"]
                      else np.zeros(0, dtype=np.int64)),
        "accessions": list(samples),
        "alleles": (np.concatenate(acc["alleles"])
                    if chrom_names else None),
        "chrom_map": mapping,
    }
    return rg, meta


def write_vcf(gd: GenotypeData, path: str,
              chrom_names: Optional[Dict[int, str]] = None) -> None:
    """Write a GenotypeData as a minimal GT-only VCF (gzipped iff the
    path ends in .gz). Dosages are emitted as unphased hard calls
    counting the ALT allele; ``gd.alleles`` columns map to [REF, ALT]
    (placeholder A/C when absent). Round-trips through read_vcf."""
    ploidy = gd.ploidy
    if gd.matrix.size and int(gd.matrix.max(initial=0)) > ploidy:
        raise ValueError(
            f"dosages up to {int(gd.matrix.max())} exceed ploidy="
            f"{ploidy}; fix the container's ploidy before writing VCF")
    # generic GT codes for ANY ploidy (read_vcf can produce ploidy > 2
    # from polyploid files): dosage d -> (ploidy-d) REF
    # copies then d ALT copies, e.g. ploidy=4 d=3 -> '0/1/1/1'
    codes = {d: "/".join(["0"] * (ploidy - d) + ["1"] * d)
             for d in range(ploidy + 1)}
    codes[MISSING] = "/".join(["."] * ploidy)
    out = gzip.open(path, "wt") if path.endswith(".gz") else open(path, "w")
    with out as f:
        f.write("##fileformat=VCFv4.2\n")
        f.write("##source=mixmogam_tpu\n")
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description='
                '"Genotype">\n')
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(gd.accessions) + "\n")
        A = gd.alleles
        for j in range(gd.num_snps):
            chrom = int(gd.chromosomes[j])
            name = chrom_names.get(chrom, str(chrom)) if chrom_names \
                else str(chrom)
            ref, alt = (str(A[j, 0]), str(A[j, 1])) if A is not None \
                else ("A", "C")
            calls = "\t".join(codes[int(g)] for g in gd.matrix[j])
            f.write(f"{name}\t{int(gd.positions[j])}\t"
                    f"snp_{chrom}_{int(gd.positions[j])}\t{ref}\t{alt}"
                    f"\t.\t.\t.\tGT\t{calls}\n")
