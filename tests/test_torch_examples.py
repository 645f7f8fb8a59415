"""PyTorch port, mixmogam_tpu_torch/examples.py: the scenarios of
examples/examples.py run on the port, driven here as a user runs them
(python -m mixmogam_tpu_torch.examples --device cpu) at a small size, and
reference_classes' h2 held to the JAX example's own computation on the
same files (1e-8)."""

import ast
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(*args, cwd):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               MIXMOGAM_LOGLEVEL="ERROR")
    return subprocess.run(
        [sys.executable, "-m", "mixmogam_tpu_torch.examples", *args],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=600)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("examples")
    r = _run("--device", "cpu", "--samples", "120", "--snps", "800",
             "--out", str(out), "reference_classes", "lm", "stepwise",
             cwd=out)
    return r, out


def test_the_scenarios_run_on_the_cpu(run):
    r, out = run
    assert r.returncode == 0, r.stderr[-3000:]
    for name in ("reference_classes", "lm", "stepwise"):
        assert re.search(rf"^\[example\] {name}: [0-9.]+ s$", r.stdout,
                         re.M), name
    assert "selected:" in r.stdout and "LM min p:" in r.stdout
    assert (out / "sim.genotypes.csv").exists()


def test_reference_classes_h2_matches_the_jax_example(run):
    """The JAX example's own steps (its facade, its LinearMixedModel) on the
    files the port's run wrote. The JAX facade's default kinship is its
    device gram, float32-grade on the CPU (1.3e-7 from the float64 oracle
    here); the port's CPU kinship is the float64 one. So the gate of 1e-8
    holds the JAX steps with the float64 kinship (use_device=False, equal
    to the port's bit for bit), and the JAX default is within 1e-6."""
    from mixmogam_tpu.api import (calc_ibs_kinship, parse_phenotype_file,
                                  parse_snp_data)
    from mixmogam_tpu.compat import LinearMixedModel

    r, out = run
    m = re.search(r"REML: h2 = (\S+) delta = (\S+)", r.stdout)
    assert m, r.stdout[-2000:]
    gd = parse_snp_data(str(out / "sim.genotypes.csv"))
    phend = parse_phenotype_file(str(out / "sim.phenotypes.csv"))
    gd2, y, _ = gd.coordinate_w_phenotype_data(phend, 1)
    gd2 = gd2.filter_mac_snps(5)
    for use_device, tol in ((False, 1e-8), (True, 1e-6)):
        lmm = LinearMixedModel(y)
        lmm.add_random_effect(calc_ibs_kinship(gd2, use_device=use_device))
        reml = lmm.get_expedited_REMLE()
        assert 0.05 < reml["pseudo_heritability"] < 0.999
        assert abs(float(m.group(1)) - reml["pseudo_heritability"]) <= tol
        assert abs(np.log(float(m.group(2))) - np.log(reml["delta"])) \
            <= 10 * tol


def test_the_scenario_names_are_the_jax_examples_less_mesh_campaign():
    """EXAMPLES holds every scenario of examples/examples.py (read from its
    source, which makes a directory when imported), mesh_campaign
    included, in the same order."""
    from mixmogam_tpu_torch.examples import EXAMPLES

    tree = ast.parse((ROOT / "examples" / "examples.py").read_text())
    node = next(n for n in tree.body if isinstance(n, ast.Assign)
                and n.targets[0].id == "EXAMPLES")
    names = [k.value for k in node.value.keys]
    assert list(EXAMPLES) == names


def test_an_unknown_name_is_refused(tmp_path):
    r = _run("--device", "cpu", "no_such_scenario", cwd=tmp_path)
    assert r.returncode != 0 and "unknown example" in r.stderr


def test_mesh_campaign_runs_on_the_cpu(tmp_path):
    """The mesh-sharded campaign on a world of one (make_mesh(devices=
    "cpu")): every entry point runs through mesh= and prints its line."""
    r = _run("--device", "cpu", "--samples", "60", "--snps", "400",
             "mesh_campaign", cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert re.search(r"^\[example\] mesh_campaign: [0-9.]+ s$", r.stdout,
                     re.M)
    assert "mesh {'snp': 1, 'sample': 1}: stepwise selected" in r.stdout
    assert "over 5 chromosomes" in r.stdout
    assert "all mesh-sharded" in r.stdout


def test_the_card_is_the_default(tmp_path):
    """Without --device the scenarios' entry points take the card: with
    none, the run fails naming device="cpu"."""
    r = _run("--samples", "40", "--snps", "200", "lm", cwd=tmp_path)
    assert r.returncode != 0 and 'device="cpu"' in r.stderr
