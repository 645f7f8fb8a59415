"""PLINK 1 binary (.bed/.bim/.fam) genotype input (counterpart of
mixmogam_tpu/data/plink.py; numpy only, apart from resident_from_plink,
which re-codes the .bed rows on a device).

The reference reads only its own CSV/HDF5 formats (dataParsers.py per
SURVEY.md §2.1); real cohorts overwhelmingly ship as PLINK filesets, so
this is a capability extension of the reference. The .bed payload is
ALREADY 2-bit packed SNP-major — exactly the layout of this package's
packed container (data/pack2, ops/pack2, models/resident) — so loading is
a remap of the four codes, byte by byte, and a bed file can go
device-resident without ever materializing an int8 genome:

  bed code (per 2 bits, v1.00, SNP-major)   ours
    00  hom A1 (minor)                       2 (A1 dosage 2)
    01  missing                              3 (-> -1)
    10  het                                  1
    11  hom A2 (major)                       0

Dosages count A1 (minor) alleles, PLINK's convention.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

_MAGIC = b"\x6c\x1b"


def _byte_lut() -> np.ndarray:
    """uint8 -> uint8 remap of 4 bed genotype codes to ours (see module
    docstring); same bit positions, SNP-major in both."""
    code_map = np.array([2, 3, 1, 0], dtype=np.uint8)  # bed 00/01/10/11
    lut = np.empty(256, dtype=np.uint8)
    for b in range(256):
        out = 0
        for k in range(4):
            out |= int(code_map[(b >> (2 * k)) & 3]) << (2 * k)
        lut[b] = out
    return lut


_LUT = _byte_lut()


def read_fam(path: str) -> List[str]:
    """Sample IDs (IID column) from a .fam file."""
    ids = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) >= 2:
                ids.append(parts[1])
    return ids


def read_bim(path: str) -> Tuple[np.ndarray, np.ndarray, List[str],
                                 List[str], List[str]]:
    """(chromosomes int32, positions int64, snp_ids, a1, a2).

    Chromosome labels: digits pass through ('chr'/'Chr' prefixes are
    stripped), X/Y/XY/MT get the PLINK codes 23-26, and every other
    DISTINCT label (contig names etc.) gets its own stable code from 27
    up in order of first appearance — never a shared catch-all, which
    would merge different contigs in window-based queries/clumping."""
    chroms, poss, ids, a1s, a2s = [], [], [], [], []
    conv = {"X": 23, "Y": 24, "XY": 25, "MT": 26, "M": 26}
    extra: dict = {}
    with open(path) as f:
        pending = []                # (row index, label) for extras
        for line in f:
            p = line.split()
            if len(p) < 6:
                continue
            lab = p[0]
            if lab.lower().startswith("chr"):
                lab = lab[3:]
            if lab.isdigit():
                code = int(lab)
            elif lab.upper() in conv:
                code = conv[lab.upper()]
            else:
                code = None         # assigned after the numeric max is
                pending.append((len(chroms), lab))  # known (see below)
            chroms.append(code)
            ids.append(p[1])
            poss.append(int(p[3]))
            a1s.append(p[4])
            a2s.append(p[5])
    if pending:
        # non-standard contigs get codes ABOVE every numeric/PAR code
        # in the file (same rule as the VCF reader's
        # _resolve_chrom_map) — a hard-coded start at 27 would collide
        # with numeric chromosomes >= 27 (wheat/polyploid .bims)
        base = max([c for c in chroms if c is not None], default=26)
        base = max(base, 26)
        for row, lab in pending:
            if lab not in extra:
                base += 1
                extra[lab] = base
            chroms[row] = extra[lab]
    return (np.asarray(chroms, np.int32), np.asarray(poss, np.int64),
            ids, a1s, a2s)


class PlinkBedSource:
    """Lazy SNP-major (M, n) int8 dosage source over a .bed file.

    Sliceable like the other streamed sources ([s:e] and integer-array
    row indexing return host int8 with -1 missing), so it plugs into
    kinship chunking and ResidentGenome.from_source directly. Rows
    decode on demand via the byte LUT + the package's 2-bit unpacker."""

    def __init__(self, bed_path: str, n_samples: int, n_snps: int):
        self.path = bed_path
        self.n = int(n_samples)
        self.M = int(n_snps)
        self._rb = (self.n + 3) // 4
        with open(bed_path, "rb") as f:
            head = f.read(3)
        if head[:2] != _MAGIC:
            raise ValueError(f"{bed_path}: not a PLINK .bed file "
                             "(bad magic)")
        if head[2:3] != b"\x01":
            raise ValueError(f"{bed_path}: sample-major .bed (mode "
                             f"{head[2]}) is not supported — recode "
                             "SNP-major (plink --make-bed)")
        expect = 3 + self.M * self._rb
        actual = os.path.getsize(bed_path)
        if actual != expect:
            raise ValueError(
                f"{bed_path}: size {actual} != 3 + M*ceil(n/4) = "
                f"{expect} (M={self.M}, n={self.n} from .bim/.fam)")
        self._mm = np.memmap(bed_path, dtype=np.uint8, mode="r",
                             offset=3, shape=(self.M, self._rb))

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.M, self.n)

    @property
    def dtype(self):
        return np.dtype(np.int8)

    def __len__(self) -> int:
        return self.M

    def packed_rows(self, key) -> np.ndarray:
        """Raw rows remapped to OUR 2-bit codes (no unpack) — the
        zero-decode path into a ResidentGenome."""
        return _LUT[self._mm[key]]

    def __getitem__(self, key) -> np.ndarray:
        from mixmogam_tpu_torch.data.pack2 import unpack_2bit

        rows = self.packed_rows(key)
        scalar = rows.ndim == 1
        if scalar:
            rows = rows[None, :]
        out = unpack_2bit(np.ascontiguousarray(rows), self.n)
        return out[0] if scalar else out

    def __array__(self, dtype=None, copy=None) -> np.ndarray:
        """Full decode to (M, n) int8 — lets np.asarray(src) feed the
        in-core paths (emmax, kinship) for small beds."""
        out = self[0:self.M]
        return out if dtype is None else out.astype(dtype)


def read_plink(prefix: str, lazy: bool = False):
    """PLINK fileset -> GenotypeData (lazy=False) or a (PlinkBedSource,
    chromosomes, positions, sample_ids) tuple (lazy=True; for streaming
    / resident workflows at biobank scale). prefix may include or omit
    the .bed extension."""
    if prefix.endswith(".bed"):
        prefix = prefix[:-4]
    sample_ids = read_fam(prefix + ".fam")
    chroms, poss, _ids, _a1, _a2 = read_bim(prefix + ".bim")
    src = PlinkBedSource(prefix + ".bed", len(sample_ids), len(chroms))
    if lazy:
        return src, chroms, poss, sample_ids
    from mixmogam_tpu_torch.data.genotype import GenotypeData

    # PLINK genotypes are diploid by definition (het = code 10) — NEVER
    # infer from the dosage range: a bed with no hom-minor calls would
    # look haploid and silently flip kinship/MAF to the binary formulas
    return GenotypeData(src[0:src.M], chroms, poss, sample_ids, ploidy=2)


def _inverse_lut() -> np.ndarray:
    """uint8 -> uint8 remap of OUR packed codes back to bed codes."""
    code_map = np.array([0b11, 0b10, 0b00, 0b01], dtype=np.uint8)  # 0/1/2/3
    lut = np.empty(256, dtype=np.uint8)
    for b in range(256):
        out = 0
        for k in range(4):
            out |= int(code_map[(b >> (2 * k)) & 3]) << (2 * k)
        lut[b] = out
    return lut


_INV_LUT = _inverse_lut()


def write_plink(prefix: str, gd, chunk: int = 65_536) -> None:
    """GenotypeData -> PLINK .bed/.bim/.fam fileset (SNP-major v1.00).
    Dosages are written as A1 counts; alleles come from gd.alleles when
    present (else A/G placeholders). The encode runs through the 2-bit
    packer + an inverse byte LUT — no per-genotype Python."""
    from mixmogam_tpu_torch.data.pack2 import pack_2bit

    mat = gd.matrix
    M, n = mat.shape
    with open(prefix + ".bed", "wb") as f:
        f.write(_MAGIC + b"\x01")
        tail = n - 4 * ((n + 3) // 4 - 1)          # valid slots, 1..4
        for s in range(0, M, chunk):
            rows = _INV_LUT[pack_2bit(
                np.ascontiguousarray(mat[s:s + chunk]))]
            if tail < 4:
                # our sample-tail pad is code 3 (-> bed 01 'missing');
                # PLINK's convention is 0-bits — clear the unused slots
                rows[:, -1] &= (1 << (2 * tail)) - 1
            f.write(np.ascontiguousarray(rows).tobytes())
    with open(prefix + ".fam", "w") as f:
        for a in gd.accessions:
            f.write(f"{a} {a} 0 0 0 -9\n")
    al = gd.alleles
    with open(prefix + ".bim", "w") as f:
        for j in range(M):
            a1, a2 = (al[j] if al is not None else ("A", "G"))
            f.write(f"{gd.chromosomes[j]} snp{j} 0 {gd.positions[j]} "
                    f"{a1} {a2}\n")


def recode_bed_bytes(raw):
    """(m, ceil(n/4)) uint8 .bed rows on any device -> the same rows in
    this package's 2-bit codes, by bit arithmetic on whole bytes (_LUT's
    map without a gather): bed (hi, lo) -> ours (not hi, hi xor lo)."""
    return ((~raw) & 0xAA) | (((raw >> 1) ^ raw) & 0x55)


def resident_from_plink(prefix: str, tile: int = 16_384, device=None,
                        chunk: int = 65_536):
    """PLINK fileset -> device-resident packed genome WITHOUT decoding:
    the raw .bed rows are uploaded chunk by chunk and re-coded to this
    container's 2-bit codes on `device` (the card by default, 'cpu' on
    request). The sample-tail slots of the last byte, 0-bits in a .bed,
    become code 3 as ResidentGenome.from_source pads them. Returns
    (ResidentGenome, chromosomes, positions, sample_ids)."""
    import torch

    from mixmogam_tpu_torch.models.resident import ResidentGenome
    from mixmogam_tpu_torch.ops import resolve_device

    device = resolve_device(device)
    src, chroms, poss, sample_ids = read_plink(prefix, lazy=True)
    M, n = src.shape
    M_pad = -(-M // tile) * tile
    packed = torch.zeros((M_pad, src._rb), dtype=torch.uint8, device=device)
    tail_slots = n - 4 * (src._rb - 1)                        # 1..4
    pad_mask = (0xFF << (2 * tail_slots)) & 0xFF              # unused slots
    has_missing = False
    for s in range(0, M, chunk):
        e = min(s + chunk, M)
        # np.array copies: the memmap is read-only
        raw = torch.from_numpy(np.array(src._mm[s:e])).to(device)
        rows = recode_bed_bytes(raw)
        # missing = code 3 in any of the first n slots, found on the
        # packed bytes: both bits of a pair set
        both = rows & (rows >> 1) & 0x55
        both[:, -1] &= ~pad_mask & 0xFF
        has_missing |= bool(both.any())
        rows[:, -1] |= pad_mask
        packed[s:e] = rows
    rg = ResidentGenome(packed, M, n, 2, tile, has_missing)
    return rg, chroms, poss, sample_ids
