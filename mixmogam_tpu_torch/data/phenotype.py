"""Phenotype data model (copy of mixmogam_tpu/data/phenotype.py, numpy and
scipy only; reference: phenotypeData.py, SURVEY.md §2.1).

Capability parity: multi-phenotype container keyed by phenotype id;
parse/write phenotype files; replicate averaging (convert_to_averages);
transformations log / sqrt / box-cox / exp / arcsin-sqrt and
most_normal_transformation (Shapiro-Wilk driven auto-pick); sample
filtering; value access aligned to an accession list.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import scipy.stats

TRANSFORMATIONS = ("none", "log", "sqrt", "box_cox", "exp", "arcsin_sqrt")


@dataclasses.dataclass
class _Phen:
    name: str
    ecotypes: List[str]            # sample ids, replicates allowed
    values: List[float]
    transformation: str = "none"
    raw_values: Optional[List[float]] = None


class PhenotypeData:
    """dict pid -> {name, ecotypes, values, transformation}."""

    def __init__(self, phen_dict: Optional[Dict[int, _Phen]] = None):
        self.phen_dict: Dict[int, _Phen] = phen_dict or {}

    # ---- construction ----
    @staticmethod
    def from_arrays(pid: int, name: str, ecotypes: Sequence[str],
                    values: Sequence[float]) -> "PhenotypeData":
        pd = PhenotypeData()
        pd.add_phenotype(pid, name, ecotypes, values)
        return pd

    def add_phenotype(self, pid: int, name: str, ecotypes: Sequence[str],
                      values: Sequence[float]) -> None:
        self.phen_dict[pid] = _Phen(
            name=name, ecotypes=[str(e) for e in ecotypes],
            values=[float(v) for v in values])

    # ---- accessors ----
    def phenotype_ids(self) -> List[int]:
        return sorted(self.phen_dict)

    def get_name(self, pid: int) -> str:
        return self.phen_dict[pid].name

    def get_ecotypes(self, pid: int) -> List[str]:
        return list(self.phen_dict[pid].ecotypes)

    def get_values(self, pid: int) -> np.ndarray:
        return np.asarray(self.phen_dict[pid].values, dtype=np.float64)

    def value_dict(self, pid: int) -> Dict[str, List[float]]:
        """ecotype -> list of replicate values."""
        p = self.phen_dict[pid]
        out: Dict[str, List[float]] = {}
        for e, v in zip(p.ecotypes, p.values):
            if not np.isnan(v):
                out.setdefault(e, []).append(v)
        return out

    # ---- replicate handling (reference: convert_to_averages) ----
    def convert_to_averages(self, pids: Optional[Sequence[int]] = None) -> None:
        # pids=[] means "none", not "all"
        for pid in (pids if pids is not None else self.phenotype_ids()):
            d = self.value_dict(pid)
            ecos = sorted(d)
            p = self.phen_dict[pid]
            p.ecotypes = ecos
            p.values = [float(np.mean(d[e])) for e in ecos]
            # the averaged values are the new transform base: the old
            # replicate-level raw array no longer aligns with ecotypes
            # (a later transform() rebuilding from it would silently
            # pair values with the WRONG samples)
            p.raw_values = (list(p.values) if p.transformation == "none"
                            else None)

    # ---- filtering (reference: filter_ecotypes) ----
    def filter_ecotypes(self, pid: int, keep: Sequence[str]) -> None:
        keep_set = {str(k) for k in keep}
        p = self.phen_dict[pid]
        idx = [i for i, e in enumerate(p.ecotypes) if e in keep_set]
        p.ecotypes = [p.ecotypes[i] for i in idx]
        p.values = [p.values[i] for i in idx]
        if p.raw_values is not None:
            # keep the transform base aligned with the filtered samples
            p.raw_values = [p.raw_values[i] for i in idx]

    # ---- transformations (reference: transform / most_normal_transformation) ----
    def transform(self, pid: int, trans_type: str) -> bool:
        """Apply a transformation in place; returns success. Shifts are
        applied if needed to keep the domain valid (reference behavior:
        log/sqrt shifted by min when nonpositive values exist)."""
        p = self.phen_dict[pid]
        vals = np.asarray(p.values, dtype=np.float64)
        if p.raw_values is None or len(p.raw_values) != len(p.values):
            # (re)base on the current values; a length mismatch means
            # the sample set changed since the base was captured
            # (defense in depth vs positional misalignment)
            p.raw_values = list(map(float, vals))
        raw = np.asarray(p.raw_values, dtype=np.float64)
        new = _apply_transform(raw, trans_type)
        if new is None:
            return False
        p.values = list(map(float, new))
        p.transformation = trans_type
        return True

    def revert_to_raw_values(self, pid: int) -> None:
        p = self.phen_dict[pid]
        if p.raw_values is not None:
            p.values = list(p.raw_values)
            p.transformation = "none"

    def shapiro_wilk(self, pid: int) -> float:
        vals = self.get_values(pid)
        vals = vals[~np.isnan(vals)]
        if len(vals) < 3 or np.ptp(vals) == 0:
            return 0.0
        return float(scipy.stats.shapiro(vals)[0])

    def most_normal_transformation(
            self, pid: int,
            trans_types: Sequence[str] = ("none", "log", "sqrt", "exp",
                                          "box_cox", "arcsin_sqrt")) -> str:
        """Try each transformation, keep the one with the highest
        Shapiro-Wilk W (reference: most_normal_transformation)."""
        best_w, best_t = -np.inf, "none"
        for t in trans_types:
            if self.transform(pid, t):
                w = self.shapiro_wilk(pid)
                if w > best_w:
                    best_w, best_t = w, t
        self.transform(pid, best_t)
        return best_t

    # ---- I/O (reference: parse_phenotype_file / write_to_file) ----
    @staticmethod
    def parse_phenotype_file(path: str, delimiter: str = ",") -> "PhenotypeData":
        """Reference format: header 'ecotype_id,name1,name2,...'; one row
        per (possibly replicated) sample; 'NA'/'' = missing."""
        pd = PhenotypeData()
        with open(path) as f:
            # rstrip \r too: a CRLF file must not leave 'name\r' on the
            # last header column
            header = f.readline().rstrip("\r\n").split(delimiter)
            names = [h.strip() for h in header[1:]]
            ecos: List[str] = []
            cols: List[List[float]] = [[] for _ in names]
            for line in f:
                line = line.rstrip("\r\n")
                if not line:
                    continue
                parts = line.split(delimiter)
                ecos.append(parts[0].strip())
                # clamp to the header's width: short rows pad with NaN,
                # long rows drop the excess (otherwise one malformed row
                # silently shifts every later value to the wrong ecotype)
                toks = parts[1:1 + len(names)]
                toks += [""] * (len(names) - len(toks))
                for i, tok in enumerate(toks):
                    tok = tok.strip()
                    cols[i].append(
                        np.nan if tok in ("", "NA", "nan", "NaN") else float(tok))
        for i, name in enumerate(names):
            pd.add_phenotype(i + 1, name, ecos, cols[i])
        return pd

    def write_to_file(self, path: str, delimiter: str = ",") -> None:
        pids = self.phenotype_ids()
        self_ecos = sorted({e for pid in pids
                            for e in self.phen_dict[pid].ecotypes})
        with open(path, "w") as f:
            f.write("ecotype_id" + delimiter
                    + delimiter.join(self.get_name(p) for p in pids) + "\n")
            maps = [self.value_dict(pid) for pid in pids]
            for e in self_ecos:
                row = [e]
                for m in maps:
                    row.append(str(np.mean(m[e])) if e in m else "NA")
                f.write(delimiter.join(row) + "\n")

    def write_hdf5(self, path: str) -> None:
        """HDF5 phenotype container (reference: hdf5_data.py role)."""
        import h5py

        with h5py.File(path, "w") as f:
            for pid in self.phenotype_ids():
                p = self.phen_dict[pid]
                g = f.create_group(f"phenotype_{pid}")
                g.attrs["name"] = p.name
                g.attrs["transformation"] = p.transformation
                g.create_dataset("ecotypes", data=np.array(
                    p.ecotypes, dtype=h5py.string_dtype()))
                g.create_dataset("values", data=np.asarray(
                    p.values, dtype=np.float64))

    @staticmethod
    def read_hdf5(path: str) -> "PhenotypeData":
        import h5py

        pd = PhenotypeData()
        with h5py.File(path, "r") as f:
            for key in f:
                if not key.startswith("phenotype_"):
                    continue
                pid = int(key.split("_")[1])
                g = f[key]
                ecos = [e.decode() if isinstance(e, bytes) else str(e)
                        for e in g["ecotypes"][:]]
                pd.add_phenotype(pid, str(g.attrs["name"]), ecos,
                                 list(g["values"][:]))
                pd.phen_dict[pid].transformation = str(
                    g.attrs.get("transformation", "none"))
        return pd

    def plot_histogram(self, pid: int, path: str, bins: int = 20) -> None:
        from mixmogam_tpu_torch.plotting.plots import _plt

        plt = _plt()
        vals = self.get_values(pid)
        vals = vals[~np.isnan(vals)]
        fig, ax = plt.subplots(figsize=(6, 4))
        ax.hist(vals, bins=bins, color="#4878CF", edgecolor="white")
        ax.set_title(f"{self.get_name(pid)} "
                     f"({self.phen_dict[pid].transformation})")
        ax.set_xlabel("phenotype value")
        ax.set_ylabel("count")
        fig.tight_layout()
        fig.savefig(path, dpi=120)
        plt.close(fig)


def _apply_transform(raw: np.ndarray, trans_type: str) -> Optional[np.ndarray]:
    v = raw.copy()
    ok = ~np.isnan(v)
    if trans_type == "none":
        return v
    if trans_type == "log":
        shift = 0.0
        mn = np.nanmin(v)
        if mn <= 0:
            shift = -mn + 0.1 * float(np.nanstd(v) or 1.0)
        v[ok] = np.log(v[ok] + shift)
        return v
    if trans_type == "sqrt":
        shift = 0.0
        mn = np.nanmin(v)
        if mn < 0:
            shift = -mn
        v[ok] = np.sqrt(v[ok] + shift)
        return v
    if trans_type == "exp":
        s = float(np.nanstd(v))
        if s == 0 or not np.isfinite(s):
            return None
        v[ok] = np.exp((v[ok] - np.nanmean(v)) / s)
        return v
    if trans_type == "box_cox":
        mn = np.nanmin(v)
        shift = -mn + 0.1 * float(np.nanstd(v) or 1.0) if mn <= 0 else 0.0
        try:
            v[ok], _ = scipy.stats.boxcox(v[ok] + shift)
        except Exception:
            return None
        return v
    if trans_type == "arcsin_sqrt":
        mn, mx = np.nanmin(v), np.nanmax(v)
        if mn < 0 or mx > 1:
            rng = mx - mn
            if rng == 0:
                return None
            v[ok] = (v[ok] - mn) / rng
        v[ok] = np.arcsin(np.sqrt(v[ok]))
        return v
    return None
