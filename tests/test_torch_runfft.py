"""The port's run-fft driver, ``python -m offt_tpu_torch.bench.runfft``,
in a fresh process with ``--device cpu``: the cases of the reference's
tests/test_cli.py that run this library's plans (offt small with
--verify, a batch with a knob override, r2c --packed, c2r -i), the
--verify rel_err against the reference driver's on the same arguments,
and the golden input's output against the reference plan's. The
baselines (``-a numpy``, ``-a torch``) and the refusals are in
tests/test_torch_runfft_baselines.py, the mesh cases in
tests/test_torch_runfft_mesh.py. The reference's two jaxdecomp cases have
no counterpart: jaxdecomp is a JAX package, the port imports no JAX, and
its driver's ``-a`` refuses the name."""

import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]


def run_cli(args, tmp_path, timeout=120, device="cpu"):
    env = dict(os.environ)
    env["OFFT_TPU_TORCH_CACHE_DIR"] = str(tmp_path)
    dev = ["--device", device] if device else []
    return subprocess.run(
        [sys.executable, "-m", "offt_tpu_torch.bench.runfft", *args, *dev],
        capture_output=True, text=True, cwd=str(REPO), env=env,
        timeout=timeout)


def last_json(out):
    return json.loads(out.stdout.strip().splitlines()[-1])


def rel_errs(stderr):
    """{"seeded": e, "golden": e} of --verify's lines."""
    return {("golden" if g else "seeded"): float(e) for g, e in
            re.findall(r"verify( golden)? rel_err = (\S+)", stderr)}


def test_runfft_offt_small_matches_the_reference(tmp_path, capsys):
    out = run_cli(["-N", "16", "-a", "offt", "-r", "2", "--verify"],
                  tmp_path)
    assert out.returncode == 0, out.stderr[-500:]
    rec = last_json(out)
    assert rec["algo"] == "offt" and rec["t_ms"] > 0
    assert rec["device"] == "cpu" and rec["kind"] == "c2c"
    assert set(rec) >= {"algo", "shape", "kind", "t_ms", "gflops",
                        "t_init_s", "bound_ms", "bound_by"}
    errs = rel_errs(out.stderr)
    assert set(errs) == {"seeded", "golden"}
    # the reference driver on the same arguments and the same seeded
    # input (rng(1)): both within the fp32 bar, of one order
    from offt_tpu.bench.runfft import main as r_main
    assert r_main(["-N", "16", "-a", "offt", "-r", "2", "--verify"]) == 0
    ref = rel_errs(capsys.readouterr().err)["seeded"]
    assert errs["seeded"] < 1e-6 and ref < 1e-6
    assert 0.1 < errs["seeded"] / ref < 10
    assert errs["golden"] < 1e-6


def test_golden_output_matches_the_reference_plan():
    """The driver's golden input f = z + 10y + 100x through the port's
    plan and the reference's: the same spectrum (1e-6 of its norm), and
    numpy's."""
    import offt_tpu
    import offt_tpu_torch as ot
    from offt_tpu_torch.bench.runfft import golden

    g = golden((16, 16, 16)).astype(np.float32)
    z = np.zeros_like(g)
    p = ot.plan((16, 16, 16), "complex64", planar=True, device="cpu")
    yr, yi = p(torch.from_numpy(g), torch.from_numpy(z))
    got = yr.double().numpy() + 1j * yi.double().numpy()
    q = offt_tpu.plan((16, 16, 16), "complex64", planar=True)
    rr, ri = q((g, z))
    ref = np.asarray(rr, np.float64) + 1j * np.asarray(ri, np.float64)
    want = np.fft.fftn(g.astype(np.float64))
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-6
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-6


def test_runfft_batch_with_override(tmp_path):
    """-b with a knob override builds the plan on the spatial shape (the
    reference's ADVICE round 1 fix)."""
    out = run_cli(["-N", "8", "-b", "2", "-a", "offt", "-r", "1", "--t1",
                   "1", "--verify"], tmp_path)
    assert out.returncode == 0, out.stderr[-800:]
    assert last_json(out)["shape"] == [2, 8, 8, 8]


def test_runfft_r2c_packed(tmp_path):
    out = run_cli(["-N", "8", "--nz", "256", "-a", "offt", "-R", "--packed",
                   "-r", "1", "--verify"], tmp_path)
    assert out.returncode == 0, out.stderr[-800:]
    errs = rel_errs(out.stderr)
    assert max(errs.values()) < 1e-6, errs


def test_runfft_c2r_inverse(tmp_path):
    out = run_cli(["-N", "16", "-a", "offt", "-R", "-i", "-r", "1",
                   "--verify"], tmp_path)
    assert out.returncode == 0, out.stderr[-800:]
    assert max(rel_errs(out.stderr).values()) < 1e-6
