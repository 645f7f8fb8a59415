"""PyTorch port hygiene: no jax and nothing of the JAX package anywhere
in the port or chip_smoke.py, importing the port builds or loads no
kernel, and chip_smoke.py fails without a card."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "mixmogam_tpu_torch"
_FORBIDDEN = ("jax", "mixmogam_tpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            if node.module == "mixmogam_tpu":
                yield from (f"mixmogam_tpu.{a.name}" for a in node.names)


def _bad(name):
    return name.split(".")[0] in _FORBIDDEN


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imports(path) if _bad(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


#: the one function of the port that calls torch._int_mm: the shared int8
#: rotation of the multi-trait, GxE, permutation and two-SNP scans and the
#: 'sample' route's plane products, an XLA dot outside any Pallas kernel in
#: the JAX package; every Pallas kernel's int8 product is a hand-written
#: kernel (K1, K4, K2)
_INT_MM_CALLER = ("mixmogam_tpu_torch/ops/rotate.py", "rotate_tile")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_library_int8_gemm_in_the_port(path):
    """torch._int_mm is chip_smoke.py's yardstick for K1, K4 and K2; in
    the port only the multi-trait scan's shared rotation calls it
    (_INT_MM_CALLER), and no other module names it."""
    src = path.read_text()
    if path.relative_to(ROOT).as_posix() != _INT_MM_CALLER[0]:
        assert "_int_mm" not in src
        return
    tree = ast.parse(src)
    fn = next(node for node in tree.body
              if isinstance(node, ast.FunctionDef)
              and node.name == _INT_MM_CALLER[1])
    calls = [node.lineno for node in ast.walk(tree)
             if isinstance(node, ast.Attribute) and node.attr == "_int_mm"]
    assert calls and all(fn.lineno <= ln <= fn.end_lineno for ln in calls)


def _strings(path):
    """The string constants of a module other than its docstrings."""
    tree = ast.parse(path.read_text())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)}
    return [node.value for node in ast.walk(tree)
            if isinstance(node, ast.Constant) and isinstance(node.value, str)
            and id(node) not in docs]


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_no_path_into_the_jax_packages_native_dir(path):
    """The port builds its host library from its own csrc/host/ copies:
    no code string names the JAX package's native/ directory or its
    library."""
    bad = [s for s in _strings(path) if _names_native(s)]
    assert not bad, f"{path.relative_to(ROOT)} names {bad}"


def _names_native(s):
    import re

    return (s == "native" or re.search(r"(^|/)native/", s) is not None
            or "libfastparse.so" in s)


def test_string_scan_catches_a_path(tmp_path):
    f = tmp_path / "m.py"
    f.write_text('"""native/ in a docstring."""\n'
                 'import os\n'
                 'a = os.path.join(ROOT, "native")\n'
                 'b = "../native/fast_parse.cpp"\n'
                 'c = "csrc/host/fast_parse.cpp"\n')
    assert sorted(s for s in _strings(f) if _names_native(s)) == [
        "../native/fast_parse.cpp", "native"]


def test_ast_scan_catches_forbidden_forms(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom mixmogam_tpu import ops\n"
                 "from mixmogam_tpu.models.resident import x\n"
                 "from mixmogam_tpu import native\n"
                 "import mixmogam_tpu_torch.ops\n"
                 "from mixmogam_tpu_torch import models\n")
    assert [m for m in _imports(f) if _bad(m)] == [
        "jax.numpy", "mixmogam_tpu", "mixmogam_tpu.ops",
        "mixmogam_tpu.models.resident", "mixmogam_tpu",
        "mixmogam_tpu.native"]


def _run(code, cwd, **env):
    e = dict(os.environ)
    e.update(env)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=e,
                          capture_output=True, text=True, timeout=300)


def test_importing_the_port_builds_nothing():
    code = (
        "import pkgutil, sys, importlib\n"
        "import mixmogam_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'mixmogam_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "from mixmogam_tpu_torch.ops import _build\n"
        "assert _build._libs == {} and _build.BUILD_LOG == {}\n"
        "from mixmogam_tpu_torch import native\n"
        "assert native._lib is None and not native._tried\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'mixmogam_tpu' not in sys.modules, 'JAX package imported'\n"
        "assert 'triton' not in sys.modules\n"
        "assert 'h5py' not in sys.modules, 'h5py imported'\n"
        "assert 'matplotlib' not in sys.modules, 'matplotlib imported'\n"
        "print(len(mods))\n")
    r = _run(code, ROOT, PYTHONPATH=str(ROOT))
    assert r.returncode == 0, r.stderr
    # every module of the port, the facade's layers included
    assert int(r.stdout.strip()) == len(
        [f for f in PORT.rglob("*.py") if f.name != "__init__.py"]) + len(
        [d for d in PORT.rglob("__init__.py") if d.parent != PORT]) >= 38


def test_importing_the_package_alone_is_cheap():
    """`import mixmogam_tpu_torch` (and its lazy names' owner modules not
    touched) imports no torch, h5py or matplotlib."""
    code = (
        "import sys\n"
        "import mixmogam_tpu_torch as p\n"
        "bad = [m for m in ('torch', 'h5py', 'matplotlib', 'jax', 'scipy')"
        " if m in sys.modules]\n"
        "assert not bad, bad\n"
        "assert sorted(p.__all__) == sorted(set(p.__all__))\n"
        "p.GenotypeData, p.PhenotypeData\n"
        "assert 'torch' not in sys.modules, 'the data layer imported torch'\n"
        "for name in p.__all__: getattr(p, name)\n")
    r = _run(code, ROOT, PYTHONPATH=str(ROOT))
    assert r.returncode == 0, r.stderr


@pytest.mark.parametrize("fmt", ["csv", "plink"])
def test_the_facade_needs_no_h5py_or_matplotlib(tmp_path, fmt):
    """The main path with plots=False and CSV / PLINK input imports
    neither (the card's machine has neither), nor jax."""
    code = (
        "import sys\n"
        "from mixmogam_tpu_torch import cli\n"
        "from mixmogam_tpu_torch.data import parsers, plink\n"
        "assert cli.main(['simulate', '-n', '60', '-m', '400', '-o', "
        "'s']) == 0\n"
        "g = 's.genotypes.csv'\n"
        f"if {fmt == 'plink'!r}:\n"
        "    gd = parsers.parse_snp_data(g)\n"
        "    plink.write_plink('s', gd)\n"
        "    g = 's.bed'\n"
        "for extra in ([], ['--method', 'emmax_loco'], "
        "['--precision', 'int8x3']):\n"
        "    if extra == ['--precision', 'int8x3'] and g == 's.bed':\n"
        "        extra = ['--precision', 'bf16x3']\n"
        "    assert cli.main(['run', g, 's.phenotypes.csv', '--no-plots', "
        "'--min-mac', '3', '--device', 'cpu', '-o', 'o'] + extra) == 0\n"
        "bad = [m for m in ('h5py', 'matplotlib', 'jax', 'mixmogam_tpu') "
        "if m in sys.modules]\n"
        "assert not bad, bad\n")
    r = _run(code, tmp_path, PYTHONPATH=str(ROOT), MIXMOGAM_LOGLEVEL="ERROR")
    assert r.returncode == 0, r.stderr[-2000:]


def test_every_kernel_source_is_packaged():
    """An installed copy builds its kernels from csrc/: every file there
    (the .cu sources, the .cuh headers they include, and the host
    library's csrc/host/*.cpp) matches a pattern of pyproject.toml's
    package-data and of MANIFEST.in."""
    import fnmatch
    import tomllib

    files = sorted(f.relative_to(PORT / "csrc").as_posix()
                   for f in (PORT / "csrc").rglob("*") if f.is_file())
    assert any(f.endswith(".cuh") for f in files)
    assert "host/fast_parse.cpp" in files and "host/fast_vcf.cpp" in files
    pats = tomllib.loads((ROOT / "pyproject.toml").read_text())["tool"][
        "setuptools"]["package-data"]["mixmogam_tpu_torch"]
    line = [ln.split() for ln in (ROOT / "MANIFEST.in").read_text()
            .splitlines() if ln.startswith(
                "recursive-include mixmogam_tpu_torch/csrc")]
    assert len(line) == 1
    for f in files:
        assert any(fnmatch.fnmatch(f"csrc/{f}", p_) for p_ in pats), f
        assert any(fnmatch.fnmatch(f.split("/")[-1], p_)
                   for p_ in line[0][2:]), f
    # and each header a source includes is there
    for cu in (PORT / "csrc").glob("*.cu*"):
        for ln in cu.read_text().splitlines():
            if ln.startswith('#include "'):
                assert ln.split('"')[1] in files, (cu.name, ln)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """Here torch has no CUDA: the script must exit non-zero and print no
    result, in the repo and in a directory holding only the script."""
    if alone:
        (tmp_path / "chip_smoke.py").write_text(
            (ROOT / "chip_smoke.py").read_text())
        cwd, pp = tmp_path, ""
    else:
        cwd, pp = ROOT, str(ROOT)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                       env={**os.environ, "PYTHONPATH": pp},
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
