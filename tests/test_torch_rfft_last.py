"""offt_tpu_torch's r2c kernel along the last axis and its unfused
r2c/c2r (``kernels/rfft.py``) held against offt_tpu's.

On the CPU each kernel wrapper runs its plain version; the reference's
Pallas kernel runs in interpret mode. Inputs are made from numpy seeds.
Tolerances: 1e-5 relative against the JAX functions (f32 on both sides,
sums in other orders), 1e-6 against complex128 numpy (the repo's fp32
bar)."""

import numpy as np
import pytest
import torch

from offt_tpu.kernels import pallas_fft as pf
from offt_tpu.kernels import rfft as rrf
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.kernels import rfft, tables

TOL_REF = 1e-5
TOL_NP = 1e-6


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def cplx(pair):
    return np.asarray(pair[0]).astype(np.float64) + 1j * np.asarray(pair[1])


@pytest.fixture(autouse=True)
def _zero_counts():
    ff.reset_counts()


@pytest.mark.parametrize("n", [4, 16, 192, 256, 2 ** 15, 2 ** 16, 255,
                               2 * 131])
def test_can_use_rfft_last_matches_reference(n):
    assert ff.can_use_rfft_last(n) == pf.can_use_rfft_last(n)
    for rad in [(16, 8), (128,), (4, 4, 8)]:
        assert (ff.can_use_rfft_last(256, rad)
                == pf.can_use_rfft_last(256, rad))


@pytest.mark.parametrize("n", [16, 255, 256])
@pytest.mark.parametrize("inverse", [False, True])
def test_half_twiddles_bit_equal_to_reference(n, inverse):
    w = rrf._half_twiddles(n, "complex64", inverse)
    tab = tables.half_twiddles(n, inverse)
    assert tab.dtype == np.float32 and tab.shape == (n // 2 + 1, 2)
    assert np.array_equal(tab[:, 0], w.real)
    assert np.array_equal(tab[:, 1], w.imag)


# M = 128 is one dense radix-128 stage, M = 256 two stages (16, 16)
@pytest.mark.parametrize("shape", [(37, 256), (5, 512), (2, 3, 256)])
@pytest.mark.parametrize("packed", [False, True])
def test_rfft_last_planar(shape, packed):
    x = real(shape, seed=shape[0] + packed)
    m = shape[-1] // 2
    port = ff.rfft_last_planar(t(x), packed=packed)
    ref = pf.rfft_last_planar(x, packed=packed)
    mo = m if packed else m + 1
    assert port[0].shape == (*shape[:-1], mo) == np.shape(ref[0])
    assert rel_err(cplx(port), cplx(ref)) < TOL_REF
    want = np.fft.rfft(x.astype(np.float64), axis=-1)
    if packed:
        want = want[..., :m].copy()
        want[..., 0] = want[..., 0].real + 1j * np.fft.rfft(
            x.astype(np.float64), axis=-1)[..., m].real
    else:
        # lanes 0 and M are exactly real
        assert not port[1][..., 0].abs().max() and \
            not port[1][..., m].abs().max()
    assert rel_err(cplx(port), want) < TOL_NP
    assert ff.counts()["rfft_last_planar"] == (0, 1)


def test_rfft_last_scale_radices_and_meta():
    x = real((6, 256), seed=3)
    a = ff.rfft_last_planar(t(x), radices=(16, 8), scale=0.5)
    want = 0.5 * np.fft.rfft(x.astype(np.float64), axis=-1)
    assert rel_err(cplx(a), want) < TOL_NP
    with pytest.raises(ValueError):
        ff.rfft_last_planar(t(real((4, 255), seed=1)))
    with pytest.raises(TypeError):
        ff.rfft_last_planar(torch.zeros(4, 256, dtype=torch.float64))
    ff.reset_counts()
    yr, yi = ff.rfft_last_planar(torch.empty(3, 7, 512, device="meta"))
    assert yr.shape == (3, 7, 257) and yr.device.type == "meta"
    assert all(c == (0, 0) for c in ff.counts().values())


def last_fft(vr, vi, inverse):
    """The inner c2c the tests inject: the 2-stage last-axis kernel."""
    return ff.fft_1d_planar(vr, vi, -1, inverse=inverse)


@pytest.mark.parametrize("n", [256, 255, 96])
@pytest.mark.parametrize("lead", [(3,), (2, 3)])
def test_rfft_1d_matches_reference(n, lead):
    x = real((*lead, n), seed=n)
    ref = np.asarray(rrf.rfft_1d(x))
    port = rfft.rfft_1d(t(x), last_fft)
    assert port[0].shape == ref.shape
    assert rel_err(cplx(port), ref) < TOL_REF
    want = np.fft.rfft(x.astype(np.float64))
    assert rel_err(cplx(port), want) < TOL_NP
    # the inner c2c: the last-axis kernel, at N/2 for even N and N for odd
    assert ff.counts()["fft_last"] == (0, 1)


@pytest.mark.parametrize("n", [256, 255, 96])
@pytest.mark.parametrize("lead", [(3,), (2, 3)])
def test_irfft_1d_matches_reference(n, lead):
    shape = (*lead, n)
    d = real(shape, seed=n + 1)
    w = np.fft.rfft(d.astype(np.float64)).astype(np.complex64)
    ref = np.asarray(rrf.irfft_1d(w, n=n))
    port = rfft.irfft_1d(t(w.real), t(w.imag), n, last_fft)
    assert port.shape == ref.shape == shape
    assert rel_err(port.numpy(), ref) < TOL_REF
    want = np.fft.irfft(w.astype(np.complex128), n=n)
    assert rel_err(port.numpy(), want) < TOL_NP
    if n % 2 == 0:     # an even N must come with N/2 + 1 bins
        with pytest.raises(ValueError):
            rfft.irfft_1d(t(w.real), t(w.imag), n + 4, last_fft)


def test_rfft_1d_takes_an_inner_fft_and_runs_on_meta():
    x = real((2, 64), seed=8)
    seen = []

    def fft_fn(vr, vi, inverse):
        seen.append((tuple(vr.shape), inverse))
        return last_fft(vr, vi, inverse)
    y = rfft.rfft_1d(t(x), fft_fn)
    back = rfft.irfft_1d(*y, 64, fft_fn)
    assert seen == [((2, 32), False), ((2, 32), True)]
    assert rel_err(back.numpy(), x) < TOL_NP
    m = torch.empty(2, 64, device="meta")
    yr, yi = rfft.rfft_1d(m, last_fft)
    assert yr.shape == (2, 33) and yr.device.type == "meta"
    assert rfft.irfft_1d(yr, yi, 64, last_fft).shape == (2, 64)
