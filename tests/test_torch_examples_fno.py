"""The port's FNO example (examples_torch/fno_layer.py) at the reference
example's size and 200 SGD steps, and at a few steps (the loss must fall
at each), in a fresh process with ``--device cpu``; and every example
run with neither a card nor ``--device cpu``: it must fail, never carry
on on the CPU."""

import pytest
import torch

from torch_examples import ALL, run


def test_fno_example_converges_on_cpu():
    out = run("fno_layer", "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.splitlines()[-1] == "OK"
    assert "in 200 steps" in out.stdout


def test_fno_example_few_steps():
    out = run("fno_layer", "--device", "cpu", "--n", "16", "--modes", "4",
              "--steps", "3")
    assert out.returncode == 0, out.stderr[-2000:]
    assert "in 3 steps" in out.stdout


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a card is visible: the default device runs")
@pytest.mark.parametrize("name", ALL)
def test_example_without_a_card_fails(name):
    out = run(name, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device is visible" in out.stderr, out.stderr[-1000:]
    assert "OK" not in out.stdout
