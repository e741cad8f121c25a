"""The port's examples (examples_torch/) run and check themselves: each
one asserts the reference example's checks and prints OK. Here the
single-process ones, each in a fresh process with ``--device cpu`` (the
kernels' plain versions) at the reference example's sizes; the FNO
layer, the runs without a card, and the mesh examples under torchrun are
in tests/test_torch_examples_fno.py and test_torch_examples_mesh.py."""

import pytest

from torch_examples import ALL, REPO, files, run


def test_every_example_is_listed():
    """The nine reference examples, one port file each, same names."""
    ref = sorted(p.stem for p in (REPO / "examples").glob("*.py"))
    assert files() == sorted(ALL) == ref


@pytest.mark.parametrize("name,args", [
    ("grad_spectral", ()),
    ("jvp_sensitivity", ()),
    ("packed_spectral", ()),
    ("steered_tuning", ()),
    ("tune_quadratic", ()),
    ("tune_quadratic", ("random", "--trials", "50")),
], ids=["grad_spectral", "jvp_sensitivity", "packed_spectral",
        "steered_tuning", "tune_quadratic", "tune_quadratic_random"])
def test_example_runs_on_cpu(name, args):
    out = run(name, "--device", "cpu", *args)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "OK" in out.stdout.splitlines()[-1], out.stdout[-500:]
