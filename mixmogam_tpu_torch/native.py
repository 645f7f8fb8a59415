"""ctypes bindings for the port's C++ host data plane (counterpart of
mixmogam_tpu/native.py): csrc/host/fast_parse.cpp (a threaded dosage-CSV
parser and the 2-bit packer / unpacker) and csrc/host/fast_vcf.cpp (a
streaming VCF GT parser that reads plain text, gzip and bgzip through
zlib). Both are copies of the JAX package's native/ sources.

The library is built at first use, never at import: one g++ over both
sources into ``mixmogam_tpu_torch/_kernels/libfastparse-<key>.so``, keyed
on the sources, the flags and the compiler's version. It is written under
a temporary name and moved into place under a file lock, so processes
that start together never load a half-written file. Where it cannot be
built (no compiler, no zlib), every function here takes its Python route,
as the JAX package's does; ``BUILD_LOG`` then holds the compiler's
message."""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCES = [os.path.join(_PKG, "csrc", "host", f)
           for f in ("fast_parse.cpp", "fast_vcf.cpp")]
LIB_DIR = os.path.join(_PKG, "_kernels")
#: native/Makefile's flags, without -march=native (a library that another
#: machine's checkout might load stays portable)
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
#: the compiler's output of the last build, or why the library could not
#: be built or loaded
BUILD_LOG = ""


def _compiler() -> Tuple[str, str]:
    """(the C++ compiler, the first line of its --version)."""
    cxx = os.environ.get("CXX", "g++")
    r = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                       timeout=60)
    return cxx, (r.stdout.splitlines() or [""])[0]


def _lib_path(version: str) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + [version]).encode())
    for path in SOURCES:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(LIB_DIR, f"libfastparse-{h.hexdigest()[:12]}.so")


def _compile() -> str:
    """Path of the library of the current sources; runs g++ when none is
    cached. Raises (OSError, RuntimeError) when it cannot be built."""
    global BUILD_LOG
    cxx, version = _compiler()
    so = _lib_path(version)
    os.makedirs(LIB_DIR, exist_ok=True)
    with open(os.path.join(LIB_DIR, "libfastparse.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            r = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, *SOURCES, "-lz"],
                               capture_output=True, text=True, timeout=300)
            BUILD_LOG = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"{cxx} failed:\n{r.stderr}")
            os.replace(tmp, so)
    return so


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None when it cannot be
    built or loaded (BUILD_LOG says why)."""
    global _lib, _tried, BUILD_LOG
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(_compile())
            _bind(lib)
        except (OSError, RuntimeError, AttributeError,
                subprocess.SubprocessError) as exc:
            BUILD_LOG = str(exc)
            return None
        _lib = lib
        return _lib


def _bind(lib) -> None:
    """Declare every exported symbol's signature."""
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i8p = ctypes.POINTER(ctypes.c_int8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.count_csv.restype = ctypes.c_int
    lib.count_csv.argtypes = [ctypes.c_char_p, i64p, i64p]
    lib.parse_dosage_csv.restype = ctypes.c_int64
    lib.parse_dosage_csv.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, i8p, i32p, i64p,
        ctypes.c_int]
    lib.packed_row_bytes.restype = ctypes.c_int64
    lib.packed_row_bytes.argtypes = [ctypes.c_int64]
    lib.pack_2bit.restype = None
    lib.pack_2bit.argtypes = [i8p, ctypes.c_int64, ctypes.c_int64, u8p]
    lib.unpack_2bit.restype = None
    lib.unpack_2bit.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, i8p]
    lib.vcf_open.restype = ctypes.c_void_p
    lib.vcf_open.argtypes = [ctypes.c_char_p, i64p]
    lib.vcf_close.restype = None
    lib.vcf_close.argtypes = [ctypes.c_void_p]
    lib.vcf_next.restype = ctypes.c_int64
    lib.vcf_next.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, i8p, i64p, i32p, ctypes.c_char_p,
        ctypes.c_char_p, ctypes.c_int64, i64p, i32p, ctypes.c_int]


def available() -> bool:
    return get_lib() is not None


def parse_dosage_csv(path: str, n_threads: int = 0
                     ) -> Optional[Tuple[np.ndarray, np.ndarray,
                                         np.ndarray, int]]:
    """Parse a dosage CSV body natively: (matrix int8 (M, n), chromosomes
    int32, positions int64, n_samples), or None when the library is
    unavailable or the body is irregular (the Python route then parses it,
    or raises the descriptive error). The caller reads the header."""
    lib = get_lib()
    if lib is None:
        return None
    n_rows = ctypes.c_int64()
    n_fields = ctypes.c_int64()
    if lib.count_csv(path.encode(), ctypes.byref(n_rows),
                     ctypes.byref(n_fields)) != 0:
        return None
    M = int(n_rows.value)
    n = int(n_fields.value) - 2
    if n <= 0 or M < 0:
        return None
    mat = np.empty((M, n), dtype=np.int8)
    chroms = np.empty(M, dtype=np.int32)
    poss = np.empty(M, dtype=np.int64)
    got = lib.parse_dosage_csv(
        path.encode(), M, n,
        mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
        chroms.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        poss.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), n_threads)
    if got < 0:
        return None
    if got < M:
        mat, chroms, poss = mat[:got], chroms[:got], poss[:got]
    return mat, chroms, poss, n


def iter_vcf(path: str, n_samples: int, chunk_rows: int = 65_536,
             n_threads: int = 0):
    """Stream a VCF's GT records natively, one pass in bounded memory.
    Yields per-chunk tuples (matrix int8 (m, n), positions, chrom_codes
    int32 (-1 = non-numeric), chrom_names uint8 (m, 16) NUL-padded,
    alleles (m, 2) str, chunk_max_arity). Raises ValueError on a
    structurally irregular body (the caller takes the Python route, which
    raises the descriptive error where one is due) and RuntimeError when
    the library is unavailable or its header disagrees with Python's."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    ns = ctypes.c_int64()
    h = lib.vcf_open(path.encode(), ctypes.byref(ns))
    if not h:
        raise RuntimeError("native header parse failed")
    try:
        if int(ns.value) != n_samples:
            raise RuntimeError(
                f"native header sample count {int(ns.value)} != "
                f"python's {n_samples}")
        mat = np.empty((chunk_rows, n_samples), dtype=np.int8)
        poss = np.empty(chunk_rows, dtype=np.int64)
        codes = np.empty(chunk_rows, dtype=np.int32)
        names = np.zeros(chunk_rows * 16, dtype=np.uint8)
        offs = np.zeros(2 * chunk_rows, dtype=np.int64)
        arena = np.zeros(64 * chunk_rows, dtype=np.uint8)
        while True:
            arity = ctypes.c_int32(1)
            got = lib.vcf_next(
                h, chunk_rows,
                mat.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                poss.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                names.ctypes.data_as(ctypes.c_char_p),
                arena.ctypes.data_as(ctypes.c_char_p), arena.size,
                offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                ctypes.byref(arity), n_threads)
            if got == -3:
                # REF / ALT arena too small: grow it and ask again (the
                # chunk's lines wait in the native handle)
                arena = np.zeros(4 * arena.size, dtype=np.uint8)
                continue
            if got < 0:
                raise ValueError("malformed VCF body (native)")
            w = int(got)
            if w == 0:
                return
            # split only the arena's used extent: the last ALT starts at
            # offs[2w - 1] and ends at its NUL
            off_last = int(offs[2 * w - 1])
            used = off_last + int(np.argmax(arena[off_last:] == 0)) + 1
            parts = arena[:used].tobytes().split(b"\0")[:2 * w]
            alleles = np.asarray(
                [p.decode("utf-8", "replace") for p in parts],
                dtype=str).reshape(w, 2)
            yield (mat[:w].copy(), poss[:w].copy(), codes[:w].copy(),
                   names.reshape(chunk_rows, 16)[:w].copy(), alleles,
                   int(arity.value))
    finally:
        lib.vcf_close(h)


def parse_vcf(path: str, n_samples: int, n_threads: int = 0,
              chunk_rows: int = 65_536
              ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                  np.ndarray, np.ndarray, int]]:
    """A whole VCF through iter_vcf: (matrix int8 (M, n), positions,
    chrom_codes int32 (-1 = non-numeric), chrom_names uint8 (M, 16)
    NUL-padded, alleles (M, 2) str, max_arity), or None when the library
    is unavailable or the file needs the Python route (an irregular
    record, a chromosome name over 15 characters). The caller reads the
    sample IDs and resolves the chromosome codes."""
    try:
        chunks = list(iter_vcf(path, n_samples, chunk_rows=chunk_rows,
                               n_threads=n_threads))
    except (RuntimeError, ValueError):
        return None
    if not chunks:
        return (np.zeros((0, n_samples), np.int8),
                np.zeros(0, np.int64), np.zeros(0, np.int32),
                np.zeros((0, 16), np.uint8),
                np.zeros((0, 2), dtype=str), 1)
    return (np.vstack([c[0] for c in chunks]),
            np.concatenate([c[1] for c in chunks]),
            np.concatenate([c[2] for c in chunks]),
            np.vstack([c[3] for c in chunks]),
            np.concatenate([c[4] for c in chunks]),
            max(c[5] for c in chunks))


def pack_2bit(mat: np.ndarray) -> np.ndarray:
    """int8 (M, n) dosages (0..2, -1 missing) -> (M, ceil(n/4)) uint8,
    through this library or numpy (data/pack2.py)."""
    from mixmogam_tpu_torch.data import pack2

    return pack2.pack_2bit(mat)


def unpack_2bit(packed: np.ndarray, n_samples: int) -> np.ndarray:
    """(M, ceil(n/4)) uint8 -> (M, n) int8 (-1 missing), through this
    library or numpy (data/pack2.py)."""
    from mixmogam_tpu_torch.data import pack2

    return pack2.unpack_2bit(packed, n_samples)
