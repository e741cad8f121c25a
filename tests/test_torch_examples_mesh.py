"""The port's mesh examples (examples_torch/spectral_poisson.py,
distributed_fft.py, dist1d_signal.py) under torchrun as a 4-rank gloo
world on a 2 x 2 mesh, ``--device cpu``: each asserts its checks on
every rank's block (the norms summed over the world) and rank 0 prints
OK; the long-1-D example asserts that the distributed engine took the
record."""

import pytest

from torch_examples import WORLD, run


@pytest.mark.parametrize("name", ["spectral_poisson", "distributed_fft",
                                  "dist1d_signal"])
def test_mesh_example_on_four_ranks(name):
    out = run(name, "--device", "cpu", world=WORLD)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert lines.count("OK") == 1, out.stdout[-800:]
    assert "2 x 2" in out.stdout
    if name == "dist1d_signal":
        assert "route long1d" in out.stdout
