"""The 2-D and n-D forms of the port's numpy.fft namespace
(offt_tpu_torch.fft), held against offt_tpu.fft and numpy.fft case by
case after tests/test_npfft.py: axes subsets, out-of-order and repeated
axes, ``s`` crop and pad, norms composed across groups of three axes, the
real forms, and the fp64 route. Helpers and tolerances from
tests/test_torch_npfft.py."""

import numpy as np
import pytest
import torch

import offt_tpu_torch.fft as F

from test_torch_npfft import TOL64, c64, check, rng, wide

__all__ = ["rng"]


def test_fft2_default_and_axes(rng):
    x = c64(rng, (8, 16, 12))
    check("fft2", x, np.fft.fft2(wide(x)))
    check("fft2", x, np.fft.fft2(wide(x), axes=(0, 1)), axes=(0, 1))
    check("ifft2", x, np.fft.ifft2(wide(x)))


@pytest.mark.parametrize("shape", [(32,), (8, 16), (4, 8, 16), (2, 4, 8, 16),
                                   (2, 3, 4, 8, 16)])
def test_fftn_all_ranks(rng, shape):
    x = c64(rng, shape)
    check("fftn", x, np.fft.fftn(wide(x)))
    check("ifftn", x, np.fft.ifftn(wide(x)))


@pytest.mark.parametrize("axes", [(1,), (0, 2), (3, 1), (2, 0, 3)])
def test_fftn_axes_subset_and_order(rng, axes):
    x = c64(rng, (4, 8, 12, 16))
    check("fftn", x, np.fft.fftn(wide(x), axes=axes), axes=axes)


def test_fftn_s_crop_pad(rng):
    x = c64(rng, (8, 12))
    check("fftn", x, np.fft.fftn(wide(x), s=(6, 16), axes=(0, 1)),
          s=(6, 16))
    # s with axes=None means the LAST len(s) axes
    x3 = c64(rng, (4, 8, 12))
    check("fftn", x3, np.fft.fftn(wide(x3), s=(8, 8), axes=(1, 2)),
          s=(8, 8))


def test_fftn_repeated_axes(rng):
    x = c64(rng, (8, 8))
    check("fftn", x, np.fft.fftn(wide(x), axes=(0, 0)), axes=(0, 0))
    with pytest.raises(ValueError, match="repeated"):
        F.rfftn(torch.from_numpy(x.real.copy()), axes=(0, 0))
    with pytest.raises(ValueError, match="same length"):
        F.fftn(torch.from_numpy(x), s=(8,), axes=(0, 1))


@pytest.mark.parametrize("norm", ["ortho", "forward"])
def test_fftn_norm_composes_across_groups(rng, norm):
    # rank 5 over all axes: two plan groups; the per-group norm must
    # compose to numpy's whole-transform scaling
    x = c64(rng, (2, 3, 4, 6, 8))
    check("fftn", x, np.fft.fftn(wide(x), norm=norm), norm=norm)
    check("ifftn", x, np.fft.ifftn(wide(x), norm=norm), norm=norm)


@pytest.mark.parametrize("shape", [(16,), (8, 16), (4, 8, 16), (2, 4, 8, 16)])
def test_rfftn_ranks(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    check("rfftn", x, np.fft.rfftn(wide(x)))


def test_rfftn_axes(rng):
    x = rng.standard_normal((4, 8, 16)).astype(np.float32)
    check("rfftn", x, np.fft.rfftn(wide(x), axes=(2, 0)), axes=(2, 0))


def test_irfftn_roundtrip_and_odd(rng):
    x = rng.standard_normal((4, 8, 16)).astype(np.float32)
    y = np.fft.rfftn(wide(x)).astype(np.complex64)
    got = check("irfftn", y, np.fft.irfftn(wide(y)))
    assert np.linalg.norm(got - x) / np.linalg.norm(x) < 1e-6
    check("irfftn", y, np.fft.irfftn(wide(y), s=(4, 8, 15), axes=(0, 1, 2)),
          s=(4, 8, 15))


def test_rfft2_irfft2(rng):
    x = rng.standard_normal((3, 8, 16)).astype(np.float32)
    check("rfft2", x, np.fft.rfft2(wide(x)))
    y = np.fft.rfft2(wide(x)).astype(np.complex64)
    check("irfft2", y, np.fft.irfft2(wide(y)))


def test_fftn_prime_axes(rng):
    # lengths no kernel expresses: Bluestein on every axis of a group
    x = c64(rng, (131, 6, 137))
    check("fftn", x, np.fft.fftn(wide(x)))
    xr = rng.standard_normal((5, 131)).astype(np.float32)
    check("rfftn", xr, np.fft.rfftn(wide(xr)))


def test_fp64_nd(rng):
    x = rng.standard_normal((3, 4, 8, 9)) + 1j * rng.standard_normal(
        (3, 4, 8, 9))
    assert check("fftn", x, np.fft.fftn(x), tol=TOL64).dtype == \
        np.complex128
    check("ifftn", x, np.fft.ifftn(x, axes=(0, 3), norm="ortho"), tol=TOL64,
          axes=(0, 3), norm="ortho")
    xr = x.real.copy()
    y = check("rfftn", xr, np.fft.rfftn(xr), tol=TOL64)
    want = np.fft.irfftn(y, s=xr.shape, axes=(0, 1, 2, 3))
    assert check("irfftn", y, want, tol=TOL64, s=xr.shape).dtype == \
        np.float64


@pytest.mark.parametrize("axes", [None, (0, 2), (2, 0), (1, 2)])
@pytest.mark.parametrize("shape", [(6, 10, 12), (6, 10, 7), (4, 6, 5)])
def test_irfftn_of_non_hermitian_input_is_numpys(shape, axes):
    """c2r of random complex input, not Hermitian along the outer axes:
    the port follows numpy and torch.fft (planes 0 and n/2 of the last
    axis take their Hermitian part over the other axes, the real part
    numpy keeps after its outer inverse). The reference differs here and
    is not changed (``offt_tpu/fft.py:149-164`` feeds a multi-axis
    group's planes to its c2r as they are, 0.2-0.4 off numpy), so these
    cases are held against numpy and torch.fft only: complex128 at the
    fp64 bar, complex64 at the fp32 one."""
    g = np.random.default_rng(sum(shape) + len(axes or ()))
    x = g.standard_normal(shape) + 1j * g.standard_normal(shape)
    want = np.fft.irfftn(x, axes=axes)
    dims = axes if axes is not None else tuple(range(len(shape)))
    twin = torch.fft.irfftn(torch.from_numpy(x), dim=dims).numpy()
    assert np.abs(want - twin).max() < 1e-13
    got = F.irfftn(torch.from_numpy(x), axes=axes).numpy()
    assert got.dtype == np.float64
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < TOL64
    got = F.irfftn(torch.from_numpy(x.astype(np.complex64)), axes=axes)
    assert np.linalg.norm(got.numpy() - want) / np.linalg.norm(want) < 1e-6
    if axes is not None:
        got = F.irfft2(torch.from_numpy(x), axes=axes).numpy()
        assert np.linalg.norm(got - np.fft.irfft2(x, axes=axes)) \
            / np.linalg.norm(want) < TOL64
