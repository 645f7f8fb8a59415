"""PyTorch port, the command line: main([...]) for simulate -> run ->
kinship on the CPU (--device cpu), the files they write, and the options
and commands that are refused."""

import json
import os

import numpy as np
import pytest
import torch

from mixmogam_tpu import cli as jcli
from mixmogam_tpu_torch import cli
from mixmogam_tpu_torch.utils.caching import load_kinship_from_file

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def sim(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    prefix = str(d / "sim")
    assert cli.main(["simulate", "-n", "90", "-m", "900", "--seed", "4",
                     "--n-causal", "4", "-o", prefix]) == 0
    return d, prefix


def test_simulate_writes_the_jax_clis_files(sim, tmp_path):
    d, prefix = sim
    jp = str(tmp_path / "sim")
    assert jcli.main(["simulate", "-n", "90", "-m", "900", "--seed", "4",
                      "--n-causal", "4", "-o", jp]) == 0
    for ext in (".genotypes.csv", ".phenotypes.csv", ".causal.txt"):
        with open(prefix + ext, "rb") as a, open(jp + ext, "rb") as b:
            assert a.read() == b.read(), ext


@pytest.mark.parametrize("extra,tier", [
    ([], "exact"), (["--precision", "int8x3"], "int8x3"),
    (["--precision", "bf16x2", "--rescore-top", "8"], "bf16x2"),
    (["--method", "emmax_loco"], None),
    (["--kinship-method", "vanraden", "--transform", "sqrt"], "exact"),
    (["--resident", "on", "--ploidy", "1"], "exact")])
def test_run(sim, capsys, extra, tier):
    d, prefix = sim
    out = str(d / ("run_" + "_".join(x.strip("-") for x in extra)))
    rc = cli.main(["run", prefix + ".genotypes.csv",
                   prefix + ".phenotypes.csv", "-o", out, "--no-plots",
                   "--min-mac", "5", "--device", "cpu"] + extra)
    assert rc == 0
    said = capsys.readouterr().out
    assert said.startswith("scanned ") and "min p = " in said
    with open(out + ".summary.json") as f:
        summary = json.load(f)
    assert summary["method"] == ("emmax_loco" if "emmax_loco" in extra
                                 else "emmax")
    assert summary["n_samples"] == 90 and 0 < summary["min_p"] <= 1
    with open(out + ".pvals.csv") as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("chromosomes,positions,scores,mafs,macs")
    assert len(lines) == summary["n_snps"] + 1
    ps = np.array([float(l.split(",")[2]) for l in lines[1:]])
    assert (np.diff(ps) >= 0).all() and ps[0] == summary["min_p"]
    assert os.path.exists(out + ".metrics.json")


def test_run_matches_the_jax_cli(sim, tmp_path):
    d, prefix = sim
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    args = ["run", prefix + ".genotypes.csv", prefix + ".phenotypes.csv",
            "--no-plots", "--min-mac", "5", "--transform", "most_normal"]
    assert cli.main(args + ["-o", a, "--device", "cpu"]) == 0
    assert jcli.main(args + ["-o", b]) == 0
    with open(a + ".pvals.csv") as f, open(b + ".pvals.csv") as g:
        la, lb = f.read().splitlines(), g.read().splitlines()
    assert la[0] == lb[0] and len(la) == len(lb)
    pa = np.array([float(l.split(",")[2]) for l in la[1:]])
    pb = np.array([float(l.split(",")[2]) for l in lb[1:]])
    assert np.abs(pa - pb).max() <= 1e-9


def test_stepwise_matches_the_jax_cli(sim, capsys, tmp_path):
    """--method emmax_stepwise prints the selected cofactors as JSON, as
    the JAX package's CLI does: the same selection."""
    d, prefix = sim
    args = ["run", prefix + ".genotypes.csv", prefix + ".phenotypes.csv",
            "-o", str(tmp_path / "sw"), "--no-plots", "--method",
            "emmax_stepwise", "--num-steps", "2"]
    assert cli.main(args + ["--device", "cpu"]) == 0
    ours = json.loads(capsys.readouterr().out)
    assert jcli.main(args) == 0
    assert ours == json.loads(capsys.readouterr().out)
    assert set(ours["selected"]) == {"bic", "ebic", "mbic", "mbonf"}


@pytest.mark.parametrize("method", ["ibs", "vanraden"])
def test_kinship_command(sim, capsys, method):
    d, prefix = sim
    out = str(d / f"K_{method}.npz")
    assert cli.main(["kinship", prefix + ".genotypes.csv", "-o", out,
                     "--method", method, "--device", "cpu"]) == 0
    assert "wrote" in capsys.readouterr().out
    K, acc = load_kinship_from_file(out)
    assert K.shape == (90, 90) and acc[:2] == ["acc0", "acc1"]
    assert abs(np.mean(np.diag(K)) - 1.0) < 1e-12          # scale_k
    # and the saved kinship feeds a run
    assert cli.main(["run", prefix + ".genotypes.csv",
                     prefix + ".phenotypes.csv", "-o", str(d / "kf"),
                     "--no-plots", "--kinship-file", out, "--device",
                     "cpu"]) == 0


def test_info_names_torch_and_never_jax(capsys):
    assert cli.main(["info"]) == 0
    said = capsys.readouterr().out
    assert "mixmogam-tpu-torch" in said and "torch " in said
    assert "cuda devices=" in said and "jax" not in said


@pytest.mark.parametrize("extra", [
    ["--method", "lm", "--precision", "high"],
    ["--method", "emmax_loco", "--stream", "on"],
    ["--method", "lm", "--checkpoint-dir", "ck"], ["--precision", "nope"],
    ["--method", "emmax_loco", "--precision", "bf16"],
    ["--method", "emmax_loco", "--rescore-top", "4"],
    ["--method", "emmax_loco", "--resident", "on"],
    ["--debug-nans"]])
def test_refused_options_exit_with_argparses_error(capsys, extra):
    """Refused before any file is read: the paths do not exist."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["run", "no_such.csv", "no_such_pheno.csv", "--device",
                  "cpu"] + extra)
    assert exc.value.code == 2
    assert "error:" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [
    ["predict", "no_such.csv", "no_such_pheno.csv", "--device", "cpu"],
    ["run", "no_such.csv", "no_such_pheno.csv", "--method", "emmax_gxe",
     "--env-pid", "2", "--device", "cpu"],
    ["run", "no_such.csv", "no_such_pheno.csv", "--method",
     "emmax_gxe", "--device", "cpu"]])
def test_unported_commands_raise_with_their_roadmap_item(argv):
    """predict and run --method emmax_gxe are ported: both reach the file
    read (the paths do not exist), and emmax_gxe without --env-pid is
    refused before it."""
    if "--env-pid" in argv or argv[0] == "predict":
        with pytest.raises(FileNotFoundError, match="no_such"):
            cli.main(argv)
    else:
        with pytest.raises(ValueError, match="env_pid"):
            cli.main(argv)


def test_default_device_is_the_card_or_an_error(sim):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without a card")
    d, prefix = sim
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["run", prefix + ".genotypes.csv",
                  prefix + ".phenotypes.csv", "--no-plots"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cli.main(["kinship", "no_such.csv", "-o", str(d / "never.npz")])
    assert not os.path.exists(str(d / "never.npz"))


def test_console_script_is_registered():
    import pathlib
    import tomllib

    root = pathlib.Path(__file__).resolve().parents[1]
    scripts = tomllib.loads((root / "pyproject.toml").read_text())[
        "project"]["scripts"]
    assert scripts["mixmogam-tpu-torch"] == "mixmogam_tpu_torch.cli:main"
    assert scripts["mixmogam-tpu"] == "mixmogam_tpu.cli:main"
