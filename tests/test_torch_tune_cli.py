"""The port's tuna-style CLI, ``python -m offt_tpu_torch.tune.cli``, in a
fresh process: the reference's two offt_tune cases of tests/test_cli.py
(a --pyfn objective, -m user), its result against the reference's CLI
on the same arguments, and the native engine and an auto-spawned native
server behind it."""

import json
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]


def run_cli(args, tmp_path, timeout=120):
    env = dict(os.environ)
    env["OFFT_TPU_TORCH_CACHE_DIR"] = str(tmp_path)
    return subprocess.run(
        [sys.executable, "-m", "offt_tpu_torch.tune.cli", *args],
        capture_output=True, text=True, cwd=str(REPO), env=env,
        timeout=timeout)


PYFN = ["-i", "a:1:50", "-i", "b:1:50", "-s", "nm", "-l", "60", "-q",
        "--pyfn", "offt_tpu_torch.tune.synth:_cli_test_obj"]


def test_offt_tune_pyfn_matches_the_reference(tmp_path, capsys):
    out = run_cli(PYFN, tmp_path)
    assert out.returncode == 0, out.stderr[-500:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["perf"] <= 9  # near the (20, 33) optimum
    from offt_tpu.tune.cli import main as r_main

    ref_args = PYFN[:-1] + ["offt_tpu.tune.synth:_cli_test_obj"]
    assert r_main(ref_args) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) \
        == rec


def test_offt_tune_method_user(tmp_path):
    out = run_cli(["-i", "a:1:4", "-s", "random", "-l", "3", "-q", "-m",
                   "user", "--", sys.executable, "-c", "pass"], tmp_path)
    assert out.returncode == 0, out.stderr[-500:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["best"] is not None and rec["perf"] > 0


@pytest.mark.parametrize("mode", ["--native", "--server=auto"])
def test_offt_tune_native(tmp_path, mode):
    from offt_tpu_torch.tune import engine_cpp

    if not engine_cpp.available():
        pytest.skip("no native toolchain")
    out = run_cli(PYFN[:6] + ["-l", "80", "-q", mode, "--pyfn",
                              "offt_tpu_torch.tune.synth:_cli_test_obj"],
                  tmp_path)
    assert out.returncode == 0, out.stderr[-500:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["trials"] > 0 and rec["perf"] <= 100
