"""offt_tpu_torch's four-step long 1-D route held against offt_tpu's.

On the CPU each kernel wrapper runs its plain version; the reference's
Pallas kernels run in interpret mode. Inputs are made from numpy seeds.
Tolerances: 1e-5 relative against the JAX kernel (f32 on both sides,
sums in other orders), 1e-6 against complex128 numpy (the repo's fp32
bar)."""

import numpy as np
import pytest
import torch

from offt_tpu.kernels import fourstep as rfs
from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.kernels import fourstep as fs
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.kernels import tables

from test_torch_local_plan import _check_routes, ref_routes

__all__ = ["ref_routes"]

TOL_REF = 1e-5
TOL_NP = 1e-6


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def rand_pair(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(2))


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def cplx(pair):
    return np.asarray(pair[0]).astype(np.float64) + 1j * np.asarray(pair[1])


@pytest.fixture(autouse=True)
def _zero_counts():
    ff.reset_counts()


# ---- split picks and the twiddle table -------------------------------------

SPLIT_NS = [2, 4096, 16384, 2 ** 15, 24576, 20480, 2 ** 20, 2 ** 21, 2 ** 22,
            2 ** 24, 10 ** 6, 3 * 2 ** 18, 5 * 2 ** 17, 2 ** 19, 16411,
            131 * 256, 99991 * 2]


@pytest.mark.parametrize("n", SPLIT_NS)
def test_pick_split_matches_reference(n):
    assert fs.pick_split(n) == rfs.pick_split(n)
    assert fs.can_use_four_step(n) == rfs.can_use_four_step(n)


def test_pick_split_measured_and_explicit():
    n = 3 * 2 ** 18
    assert fs._MEASURED_SPLITS == rfs._MEASURED_SPLITS
    assert fs.pick_split(n) == (1024, 768)
    for split in [(1024, 768), (768, 1024), (256, 3072), (3, 262144),
                  (1000, 786)]:
        assert fs.pick_split(n, split) == rfs.pick_split(n, split), split
        assert (fs.can_use_four_step(n, split)
                == rfs.can_use_four_step(n, split))
    # the reference's picks, checked against it above
    assert [fs.pick_split(m) for m in (2 ** 15, 24576, 20480, 2 ** 20,
                                       10 ** 6)] == [
        (128, 256), (192, 128), (160, 128), (1024, 1024), (1000, 1000)]


@pytest.mark.parametrize("n1,n2,inverse,scale", [
    (128, 256, False, 1.0), (192, 128, True, 1.0 / 24576),
    (1024, 768, False, 0.5), (160, 128, True, 2.0 ** -0.5)])
def test_fourstep_twiddle_bit_equal_to_reference(n1, n2, inverse, scale):
    twr, twi = rfs._twiddle_planar(n1, n2, inverse, scale)
    tab = tables.fourstep_twiddle(n1, n2, inverse, scale)
    assert tab.dtype == np.float32 and tab.shape == (n1, n2, 2)
    assert np.array_equal(tab[..., 0], twr)
    assert np.array_equal(tab[..., 1], twi)


# ---- the two kernels' plain versions ----------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("caller_tw", [False, True])
def test_step1_twiddle(inverse, caller_tw):
    b, n1, n2 = 2, 128, 256
    xr, xi = rand_pair((b, n1, n2), seed=n1 + inverse)
    rad = pf._pick_stages(n1)
    scale = 0.25
    kw = {}
    if caller_tw:
        # a chunk with its own scale, as the distributed engine passes it
        twr, twi = rfs._twiddle_planar(n1, 2 * n2, inverse, 0.5)
        twr, twi = twr[:, n2:].copy(), twi[:, n2:].copy()
        kw["tw"] = (twr, twi)
    ref = rfs._step1_twiddle(xr, xi, n1, n2, rad, inverse, "highest",
                             scale, 0, **kw)
    # the port's caller table is one (n1, n2, 2) tensor of (re, im) pairs
    port = fs._step1_twiddle(t(xr), t(xi), n1, n2, rad, inverse, "highest",
                             scale, 0, **{k: t(np.stack(v, -1))
                                          for k, v in kw.items()})
    assert port[0].shape == (b, n1, n2)
    assert rel_err(cplx(port), cplx(ref)) < TOL_REF
    f = np.fft.ifft if inverse else np.fft.fft
    y = f(cplx((xr, xi)), axis=1) * (n1 if inverse else 1)
    if caller_tw:
        want = y * (twr + 1j * twi.astype(np.float64))
    else:
        k1 = np.arange(n1)[:, None] * np.arange(n2)[None, :]
        sign = 1 if inverse else -1
        want = y * np.exp(sign * 2j * np.pi * k1 / (n1 * n2)) * scale
    assert rel_err(cplx(port), want) < TOL_NP
    assert ff.counts()["_step1_twiddle"] == (0, 1)


def test_step1_checks_its_table_and_shape():
    xr, xi = rand_pair((1, 128, 128), seed=4)
    tab = t(tables.fourstep_twiddle(128, 128, False, 1.0))
    a = fs._step1_twiddle(t(xr), t(xi), 128, 128, None, False, tw=tab)
    b = fs._step1_twiddle(t(xr), t(xi), 128, 128, None, False)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError):
        fs._step1_twiddle(t(xr), t(xi), 128, 128, None, False,
                          tw=tab[:64])
    with pytest.raises(ValueError):     # a (re, im) pair is not the layout
        fs._step1_twiddle(t(xr), t(xi), 128, 128, None, False,
                          tw=(tab[..., 0], tab[..., 1]))
    with pytest.raises(ValueError):
        fs._step1_twiddle(t(xr), t(xi), 64, 256, None, False)


@pytest.mark.parametrize("inverse", [False, True])
def test_step3_transposed(inverse):
    b, n1, n2 = 2, 128, 256
    xr, xi = rand_pair((b, n1, n2), seed=n2 + inverse)
    rad = pf._pick_stages(n2)
    ref = rfs._step3_transposed(xr, xi, n1, n2, rad, inverse, "highest", 0)
    port = fs._step3_transposed(t(xr), t(xi), n1, n2, rad, inverse,
                                "highest", 0)
    assert port[0].shape == (b, n2, n1) == np.shape(ref[0])
    assert rel_err(cplx(port), cplx(ref)) < TOL_REF
    f = np.fft.ifft if inverse else np.fft.fft
    want = f(cplx((xr, xi)), axis=2) * (n2 if inverse else 1)
    assert rel_err(cplx(port), want.transpose(0, 2, 1)) < TOL_NP
    assert ff.counts()["_step3_transposed"] == (0, 1)


def test_step12_step34_compose_to_the_transform():
    n1, n2 = 128, 256
    xr, xi = rand_pair((3, n1 * n2), seed=9)
    tw = t(tables.fourstep_twiddle(n1, n2, False, 1.0))
    zr, zi = fs.step12_planar(t(xr).reshape(3, n1, n2),
                              t(xi).reshape(3, n1, n2), None, False,
                              "highest", tw)
    yr, yi = fs.step34_planar(zr, zi, None, False, "highest")
    want = np.fft.fft(cplx((xr, xi)), axis=-1)
    assert rel_err(cplx((yr.reshape(3, -1), yi.reshape(3, -1))), want) \
        < TOL_NP


# ---- the whole route --------------------------------------------------------

@pytest.mark.parametrize("n", [2 ** 15, 24576, 20480])
@pytest.mark.parametrize("inverse", [False, True])
def test_fft_four_step_planar(n, inverse, ref_routes):
    xr, xi = rand_pair((2, n), seed=n + inverse)
    scale = 0.5
    ref = rfs.fft_four_step_planar(xr, xi, inverse=inverse, out_scale=scale)
    port = fs.fft_four_step_planar(t(xr), t(xi), inverse=inverse,
                                   out_scale=scale)
    assert port[0].shape == (2, n)
    assert rel_err(cplx(port), cplx(ref)) < TOL_REF
    f = np.fft.ifft if inverse else np.fft.fft
    assert rel_err(cplx(port), scale * f(cplx((xr, xi)), axis=-1)) < TOL_NP
    _check_routes(ref_routes)
    n1, n2 = fs.pick_split(n)
    fused = n1 % 128 == 0 and n2 % 128 == 0
    assert bool(ref_routes["_step1_twiddle"]) == fused


def test_four_step_explicit_split_and_meta():
    n = 2 ** 15
    xr, xi = rand_pair((n,), seed=1)
    a = fs.fft_four_step_planar(t(xr), t(xi), split=(256, 128))
    assert rel_err(cplx(a), np.fft.fft(cplx((xr, xi)))) < TOL_NP
    with pytest.raises(ValueError):
        fs.fft_four_step_planar(t(xr), t(xi), split=(100, 327))
    ff.reset_counts()
    for m in (2 ** 15, 20480):
        x = torch.empty(3, m, device="meta")
        yr, yi = fs.fft_four_step_planar(x, x, inverse=True)
        assert yr.shape == (3, m) and yr.device.type == "meta"
    assert all(c == (0, 0) for c in ff.counts().values())
