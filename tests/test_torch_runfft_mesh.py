"""The port's run-fft driver on a mesh: the reference's tests/test_cli.py
mesh cases (a 2 x 4 mesh of 8 virtual JAX devices there) under
``torchrun`` on a 4-rank gloo world on 2 x 2, ``--device cpu``: the
pencil plan with knob overrides and --verify, and the per-stage
breakdown. The torch.fft cross-check and the tuning smoke run are in
tests/test_torch_runfft_mesh_tune.py."""

import json
import os
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
MESH = ["--p1", "2", "--p2", "2", "--device", "cpu"]


def run_world(args, tmp_path, timeout=240):
    """``args`` on the driver under torchrun: 4 ranks on one host (its
    rendezvous on a free localhost port), gloo."""
    env = dict(os.environ)
    env["OFFT_TPU_TORCH_CACHE_DIR"] = str(tmp_path)
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "4", "-m", "offt_tpu_torch.bench.runfft",
         *args, *MESH], capture_output=True, text=True, cwd=str(REPO),
        env=env, timeout=timeout)


def last_json(out):
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_runfft_mesh(tmp_path):
    """The reference's mesh case (knob overrides t1 = 2, ry = 5), with
    --verify: every rank's block against numpy, the norms summed over the
    world; rank 0 prints the one summary line."""
    out = run_world(["-N", "16", "-a", "offt", "-r", "1", "--t1", "2",
                     "--ry", "5", "--verify"], tmp_path)
    assert out.returncode == 0, out.stderr[-1500:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["gflops"] > 0 and rec["device"] == "cpu"
    errs = [float(e) for e in re.findall(r"rel_err = (\S+)", out.stderr)]
    assert len(errs) == 2 and max(errs) < 1e-6, errs


def test_runfft_mesh_breakdown(tmp_path):
    out = run_world(["-N", "16", "-a", "offt", "-r", "1", "--breakdown"],
                    tmp_path)
    assert out.returncode == 0, out.stderr[-1500:]
    for key in ("exchange_1", "exchange_2", "overlap_gain"):
        assert f"# {key}:" in out.stderr
    assert last_json(out)["t_ms"] > 0
