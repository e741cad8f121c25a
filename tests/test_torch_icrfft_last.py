"""offt_tpu_torch's packed c2r kernel along the last axis
(``icrfft_last_planar``) held against offt_tpu's.

On the CPU the wrapper runs its plain version; the reference's Pallas
kernel runs in interpret mode (its dense G re-tangle up to M = 128, its
dual transform above). Inputs are made from numpy seeds. Tolerances:
1e-6 relative norm against the reference and against complex128 numpy
(both sides f32, sums in other orders; the repo's fp32 bar)."""

import numpy as np
import pytest
import torch

from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.kernels import fused_fft as ff

TOL = 1e-6


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def packed_spectrum(lead, n, seed):
    """(x, re, im): real rows x (lead, n) in float64 and the packed planar
    half-spectrum of them, lane 0 = X[0] + i X[M], in float32."""
    x = np.random.default_rng(seed).standard_normal((*lead, n))
    w = np.fft.rfft(x, axis=-1)
    m = n // 2
    p = w[..., :m].copy()
    p[..., 0] = w[..., 0].real + 1j * w[..., m].real
    return x, p.real.astype(np.float32), p.imag.astype(np.float32)


@pytest.fixture(autouse=True)
def _zero_counts():
    ff.reset_counts()


# M = 64 and 128 take the reference's dense G re-tangle, 256 its dual
# transform; 96 is off the power-of-two grid (radices (96,)); the batch
# (300 rows, 3 x 37) is no multiple of the reference's 128-row block
@pytest.mark.parametrize("m", [64, 96, 128, 256])
@pytest.mark.parametrize("lead", [(300,), (3, 37)])
def test_icrfft_last_matches_reference(m, lead):
    x, re, im = packed_spectrum(lead, 2 * m, seed=m + len(lead))
    port = ff.icrfft_last_planar(t(re), t(im))
    ref = np.asarray(pf.icrfft_last_planar(re, im))
    assert port.shape == ref.shape == (*lead, 2 * m)
    assert port.dtype == torch.float32
    assert rel_err(port.numpy(), ref) < TOL
    # the default scale 1/M is the exact inverse
    assert rel_err(port.numpy(), x) < TOL
    assert ff.counts()["icrfft_last_planar"] == (0, 1)


@pytest.mark.parametrize("m,radices", [(128, None), (256, (16, 16)),
                                       (64, (8, 8))])
def test_icrfft_last_explicit_scale(m, radices):
    n = 2 * m
    x, re, im = packed_spectrum((5, 7), n, seed=3)
    s = 0.25 / m
    port = ff.icrfft_last_planar(t(re), t(im), n, radices=radices, scale=s)
    ref = np.asarray(pf.icrfft_last_planar(re, im, n, radices=radices,
                                           scale=s))
    assert rel_err(port.numpy(), ref) < TOL
    assert rel_err(port.numpy(), 0.25 * x) < TOL


@pytest.mark.parametrize("n", [128, 192, 512])
def test_rfft_last_packed_round_trip(n):
    x = np.random.default_rng(n).standard_normal((11, n)).astype(np.float32)
    yr, yi = ff.rfft_last_planar(t(x), packed=True)
    back = ff.icrfft_last_planar(yr, yi)
    assert rel_err(back.numpy(), x) < TOL
    assert ff.counts()["rfft_last_planar"] == (0, 1)
    assert ff.counts()["icrfft_last_planar"] == (0, 1)


def test_icrfft_last_refusals_and_meta():
    with pytest.raises(ValueError):        # N must be 2M
        ff.icrfft_last_planar(torch.zeros(4, 64), torch.zeros(4, 64), 130)
    with pytest.raises(ValueError):        # M = 2^15 has no 2-stage pick
        ff.icrfft_last_planar(torch.zeros(1, 2 ** 15),
                              torch.zeros(1, 2 ** 15))
    with pytest.raises(TypeError):
        ff.icrfft_last_planar(torch.zeros(4, 64, dtype=torch.float64),
                              torch.zeros(4, 64, dtype=torch.float64))
    with pytest.raises(ValueError):        # re and im must match
        ff.icrfft_last_planar(torch.zeros(4, 64), torch.zeros(5, 64))
    out = ff.icrfft_last_planar(torch.empty(3, 7, 128, device="meta"),
                                torch.empty(3, 7, 128, device="meta"))
    assert out.shape == (3, 7, 256) and out.device.type == "meta"
    assert all(c == (0, 0) for c in ff.counts().values())
    assert ff.KERNELS["icrfft_last"]["wrappers"] == ("icrfft_last_planar",)
