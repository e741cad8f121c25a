"""The port's run-fft driver in a fresh process, its baselines and
refusals: the reference's tests/test_cli.py cases of the numpy baseline
and of the xla baseline's inverse and c2r (here ``-a torch``, cuFFT on a
card), ``-a jaxdecomp`` refused (the reference's two jaxdecomp cases have
no counterpart: it is a JAX package and the port imports no JAX), no
CPU fallback without ``--device``, a mesh flag without a world, and the
knobs the port ignores."""

import torch

from test_torch_runfft import last_json, run_cli


def test_runfft_numpy_baseline(tmp_path):
    out = run_cli(["-N", "16", "-a", "numpy", "-r", "1"], tmp_path,
                  device=None)
    assert out.returncode == 0
    assert last_json(out)["algo"] == "numpy"


def test_runfft_torch_honors_inverse_and_c2r(tmp_path):
    """The torch.fft baseline benches the same transform as the offt
    config (the reference's xla case): -i is ifftn, -R -i irfftn, and the
    packed layout has no analogue (a JSON error line, rc 2)."""
    out = run_cli(["-N", "16", "-a", "torch", "-i", "-r", "1"], tmp_path)
    assert out.returncode == 0, out.stderr[-500:]
    assert last_json(out)["torch_fn"] == "ifftn"
    out = run_cli(["-N", "16", "-a", "torch", "-R", "-i", "-r", "1"],
                  tmp_path)
    assert out.returncode == 0, out.stderr[-500:]
    assert last_json(out)["torch_fn"] == "irfftn"
    out = run_cli(["-N", "16", "-a", "torch", "-R", "--packed", "-r", "1"],
                  tmp_path)
    assert out.returncode == 2
    assert "no torch.fft analogue" in last_json(out)["error"]


def test_runfft_refuses_jaxdecomp_and_needs_a_card(tmp_path):
    """``-a jaxdecomp`` is refused by argparse; with no --device the
    driver runs on the card and raises without one (no CPU fallback);
    a mesh flag without a torch.distributed world raises."""
    out = run_cli(["-N", "16", "-a", "jaxdecomp"], tmp_path)
    assert out.returncode == 2 and "invalid choice" in out.stderr
    if not torch.cuda.is_available():
        out = run_cli(["-N", "16", "--verify"], tmp_path, device=None)
        assert out.returncode != 0 and "no CUDA device" in out.stderr
        assert not out.stdout.strip()
    out = run_cli(["-N", "16", "--p1", "2"], tmp_path)
    assert out.returncode != 0 and "torchrun" in out.stderr


def test_runfft_reports_ignored_knobs(tmp_path):
    """slab_rows and x_tile are accepted and ignored by the port's kernels,
    and a # line says so."""
    out = run_cli(["-N", "16", "-r", "1", "--slab-rows", "8", "--x-tile",
                   "8,16"], tmp_path)
    assert out.returncode == 0, out.stderr[-800:]
    assert "# slab_rows=8 is accepted and ignored" in out.stderr
    assert "# x_tile=(8, 16) is accepted and ignored" in out.stderr
