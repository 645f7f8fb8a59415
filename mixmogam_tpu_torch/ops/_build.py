"""Build and load the CUDA kernels of ``csrc/`` at first CUDA use.

Each ``csrc/<name>.cu`` exports a plain C interface and is compiled by
``nvcc`` alone (no PyTorch headers: seconds, not minutes) into
``mixmogam_tpu_torch/_kernels/<name>-<hash>.so``, keyed on the content of
the source and of the shared headers (``csrc/*.cuh``), and loaded with
ctypes. Every pointer and the stream cross as
``c_void_p``; each C entry returns ``cudaGetLastError()`` after its launch
and the wrappers raise when it is not 0. A failed build raises — there
is no fallback.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
KERNEL_DIR = os.path.join(_PKG, "_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
#: nvcc's output per kernel source (ptxas register/shared-memory report)
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the CUDA kernels cannot be built")
    return found


def _compile(name: str) -> str:
    """Path of ``csrc/<name>.cu``'s shared library; runs nvcc when no
    library of the current sources is cached."""
    src = os.path.join(CSRC, name + ".cu")
    h = hashlib.sha256()
    for path in [src] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    os.makedirs(KERNEL_DIR, exist_ok=True)
    so = os.path.join(KERNEL_DIR, f"{name}-{h.hexdigest()[:12]}.so")
    if not os.path.exists(so):
        tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
        r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                           capture_output=True, text=True)
        BUILD_LOG[name] = r.stdout + r.stderr
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{r.stderr}")
        os.replace(tmp, so)
    return so


def build(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load ``csrc/<name>.cu``."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(_compile(name))
        return lib


def build_all(names) -> Dict[str, float]:
    """Compile the named kernels with one nvcc each, all started
    together, then load them; returns each compile's seconds. Raises if
    any build fails."""
    from concurrent.futures import ThreadPoolExecutor

    def one(name):
        t0 = time.perf_counter()
        _compile(name)
        return time.perf_counter() - t0

    names = list(names)
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as ex:
        secs = dict(zip(names, ex.map(one, names)))
    for name in names:
        build(name)
    return secs


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed "
                           f"(cudaGetLastError() = {rc})")
