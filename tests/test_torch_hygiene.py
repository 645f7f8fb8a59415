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


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_library_int8_gemm_in_the_port(path):
    """torch._int_mm is chip_smoke.py's yardstick for K1 and K4 only: the
    port itself never names it."""
    assert "_int_mm" not in path.read_text()


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
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert 'mixmogam_tpu' not in sys.modules, 'JAX package imported'\n"
        "assert 'triton' not in sys.modules\n"
        "print(len(mods))\n")
    r = _run(code, ROOT, PYTHONPATH=str(ROOT))
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 14


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
