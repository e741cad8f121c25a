"""The port's entry points (__graft_entry_torch__.py), the
counterparts of __graft_entry__.py: ``entry()``'s plan against
offt_tpu's at the same shape and inputs (a small n through its size
parameter), and ``dryrun_multichip`` on spawned gloo worlds of 4 ranks
(every step of the reference's dry run: the round trips, r2c / c2r,
the rank order bit for bit, the ring and the gather, a gradient, the
uneven shape, the long-1-D engine, the mesh tuner, a multi-slice mesh)
and of one rank."""

import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import __graft_entry_torch__ as entry_mod  # noqa: E402

TOL = 1e-6      # one float32 plan against another


def test_entry_matches_reference():
    import offt_tpu

    n = 16
    fn, (re, im) = entry_mod.entry(device="cpu", n=n)
    assert isinstance(fn, torch.nn.Module)
    assert fn.route == "fft3d" and fn.planar and not fn.spec.inverse
    rng = np.random.default_rng(0)
    want_re = rng.standard_normal((n,) * 3).astype(np.float32)
    want_im = rng.standard_normal((n,) * 3).astype(np.float32)
    assert np.array_equal(re.numpy(), want_re)
    assert np.array_equal(im.numpy(), want_im)
    yr, yi = fn(re, im)
    rr, ri = offt_tpu.plan((n,) * 3, "complex64", planar=True)(
        (want_re, want_im))
    got = yr.numpy() + 1j * yi.numpy()
    ref = np.asarray(rr) + 1j * np.asarray(ri)
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < TOL
    x = want_re.astype(np.float64) + 1j * want_im
    np_ref = np.fft.fftn(x)
    assert np.linalg.norm(got - np_ref) / np.linalg.norm(np_ref) < TOL


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a card is visible: the default device runs")
def test_entry_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry_mod.entry(n=16)


def test_dryrun_multichip_four_ranks():
    entry_mod.dryrun_multichip(4, device="cpu")


def test_dryrun_multichip_one_rank():
    entry_mod.dryrun_multichip(1, device="cpu")
