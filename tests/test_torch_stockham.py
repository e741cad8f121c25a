"""The unfused engine (kernels/stockham.py: the matmul chain, Bluestein,
fp64) and the plans it serves, held against offt_tpu and numpy.

- ``stockham.fft_1d`` against the reference's at smooth lengths (256,
  360, 1000) and Bluestein ones (primes 131, 1009, 10007), complex64 and
  complex128, with a radix override and an invalid one;
- its tables against the reference's, bit for bit;
- plans with ``use_pallas=0`` and complex128 / float64 real plans (odd
  and even N, norms, batch dims) against the reference's plans;
- a prime-length plan whose Bluestein inner transforms ride the kernels'
  plain versions, the wrapper counters showing which ran.

Both packages get the same numpy-seeded inputs; the reference runs with
x64 on (tests/conftest.py) and its Pallas kernels in interpret mode.
Tolerances: 1e-6 relative norm for fp32 and 1e-12 for fp64, against the
reference and against complex128 numpy."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import offt_tpu
import offt_tpu_torch as ot
from offt_tpu.kernels import dft as ref_dft
from offt_tpu.kernels import rfft as ref_rfft
from offt_tpu.kernels import stockham as ref_st
from offt_tpu.plan.params import PlanParams as RefParams
from offt_tpu_torch.dist.pencil import axis_fft
from offt_tpu_torch.kernels import dft, stockham
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.kernels import tables as tb
from offt_tpu_torch.plan.params import PlanParams

TOL = {np.complex64: 1e-6, np.complex128: 1e-12}


def rel_err(a, b):
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def _cplx(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _norm_factor(norm, inverse, total):
    if norm == "ortho":
        return total ** 0.5 if inverse else total ** -0.5
    if norm == "forward":
        return float(total) if inverse else 1.0 / total
    return 1.0


# ---- fft_1d ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("n", [256, 360, 1000, 131, 1009, 10007])
def test_fft_1d_matches_reference(n, dtype):
    x = _cplx((3, n), dtype, n)
    for inverse in (False, True):
        got = stockham.fft_1d(torch.from_numpy(x), inverse=inverse)
        assert got.dtype == (torch.complex64 if dtype == np.complex64
                             else torch.complex128)
        got = got.numpy()
        ref = np.asarray(ref_st.fft_1d(jnp.asarray(x), inverse=inverse))
        f = np.fft.ifft if inverse else np.fft.fft
        want = f(x.astype(np.complex128), axis=-1)
        assert rel_err(got, ref) < TOL[dtype]
        assert rel_err(got, want) < TOL[dtype]


@pytest.mark.parametrize("n,radices", [(360, (8, 45)), (360, (3, 4, 30)),
                                       (262, (2, 131)), (64, (64,))])
def test_fft_1d_radix_override(n, radices):
    x = _cplx((2, n), np.complex128, 5)
    got = stockham.fft_1d(torch.from_numpy(x), axis=-1,
                          radices=radices).numpy()
    ref = np.asarray(ref_st.fft_1d(jnp.asarray(x), radices=radices))
    assert rel_err(got, ref) < 1e-12
    assert rel_err(got, np.fft.fft(x, axis=-1)) < 1e-12


def test_fft_1d_invalid_override_and_axes():
    x = _cplx((360, 3), np.complex64, 6)
    with pytest.raises(ValueError, match="do not multiply"):
        stockham.fft_1d(torch.from_numpy(x), axis=0, radices=(7, 50))
    with pytest.raises(ValueError, match="do not multiply"):
        ref_st.fft_1d(jnp.asarray(x), axis=0, radices=(7, 50))
    for bad in [(7, 50), (2, 3)]:
        with pytest.raises(ValueError):
            dft.validate_factorization(360, bad)
        with pytest.raises(ValueError):
            ref_dft.validate_factorization(360, bad)
    assert dft.validate_factorization(262, [2, 131]) == \
        ref_dft.validate_factorization(262, [2, 131]) == (2, 131)
    got = stockham.ifft(torch.from_numpy(x), axis=0).numpy()
    assert rel_err(got, np.fft.ifft(x.astype(np.complex128), axis=0)) < 1e-6
    got = stockham.fft(torch.from_numpy(x.real.astype(np.float64)), axis=0)
    assert got.dtype == torch.complex128     # float64 gives complex128
    assert rel_err(got.numpy(), np.fft.fft(x.real.astype(np.float64),
                                           axis=0)) < 1e-12
    assert ot.fft_1d is stockham.fft_1d


@pytest.mark.parametrize("n", [131, 1009, 10007])
@pytest.mark.parametrize("inverse", [False, True])
def test_tables_equal_reference(n, inverse):
    for dtype in ("complex64", "complex128"):
        a, bf, m = ref_st._bluestein_tables(n, dtype, inverse)
        assert m == tb.bluestein_length(n)
        assert np.array_equal(tb.bluestein_chirp(n, dtype, inverse), a)
        assert np.array_equal(tb.bluestein_spectrum(n, dtype, inverse), bf)
        for r in (8, 45, 128):
            assert np.array_equal(tb.dft_table(r, dtype, inverse),
                                  ref_dft.dft_matrix(r, np.dtype(dtype),
                                                     inverse))
        assert np.array_equal(tb.stage_twiddle(8, 45, dtype, inverse),
                              ref_dft.twiddles(8, 45, np.dtype(dtype),
                                               inverse))
    for dt, cname in (("float32", "complex64"), ("float64", "complex128")):
        w = tb.half_twiddles(2 * n, inverse, dt)
        ref = ref_rfft._half_twiddles(2 * n, cname, inverse)
        assert w.dtype == np.dtype(dt)
        assert np.array_equal(w[:, 0], ref.real)
        assert np.array_equal(w[:, 1], ref.imag)


def test_axis_fft_dispatch():
    # a float64 pair, and a float32 pair with the kernels off, take the
    # unfused engine: no kernel wrapper runs
    x = _cplx((4, 6, 12), np.complex128, 7)
    for dtype, params in ((np.float64, PlanParams(use_pallas=1)),
                          (np.float32, PlanParams(use_pallas=0))):
        xr = torch.from_numpy(x.real.astype(dtype))
        xi = torch.from_numpy(x.imag.astype(dtype))
        ff.reset_counts()
        yr, yi = axis_fft(xr, xi, 1, False, None, params, out_scale=0.5)
        assert not any(any(c) for c in ff.counts().values())
        assert yr.dtype == xr.dtype and yr.is_contiguous()
        want = 0.5 * np.fft.fft(x.real.astype(dtype)
                                + 1j * x.imag.astype(dtype), axis=1)
        got = yr.numpy() + 1j * yi.numpy().astype(np.float64)
        assert rel_err(got, want) < (1e-12 if dtype == np.float64 else 1e-6)


# ---- plans on the unfused engine ------------------------------------------

def _plans(shape, dtype, kw, params=None):
    bd = len(shape) - 3
    rp = offt_tpu.plan(shape[bd:], dtype, use_cache=False, batch_dims=bd,
                       params=None if params is None else RefParams(**params),
                       **kw)
    pp = ot.plan(shape[bd:], dtype, device="cpu", use_cache=False,
                 batch_dims=bd,
                 params=None if params is None else PlanParams(**params),
                 **kw)
    assert pp.route == "local"
    return rp, pp


@pytest.mark.parametrize("case", [
    ((6, 10, 15), False, None, False),
    ((6, 10, 15), True, "ortho", False),
    ((2, 4, 8, 9), False, "forward", False),
    ((4, 6, 8), True, None, True),
])
def test_complex128_plans(case):
    shape, inverse, norm, planar = case
    x = _cplx(shape, np.complex128, sum(shape))
    rp, pp = _plans(shape, "complex128", {"inverse": inverse, "norm": norm,
                                          "planar": planar})
    assert pp.params.use_pallas == 0
    if planar:
        yr, yi = pp(torch.from_numpy(x.real.copy()),
                    torch.from_numpy(x.imag.copy()))
        assert yr.dtype == torch.float64
        got = yr.numpy() + 1j * yi.numpy()
        ref = rp((x.real.copy(), x.imag.copy()))
        ref = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
    else:
        y = pp(torch.from_numpy(x))
        assert y.dtype == torch.complex128
        got, ref = y.numpy(), np.asarray(rp(x))
        with pytest.raises(TypeError):       # a complex64 input
            pp(torch.from_numpy(x.astype(np.complex64)))
    f = np.fft.ifftn if inverse else np.fft.fftn
    want = f(x, axes=(-3, -2, -1), norm=norm)
    assert rel_err(got, ref) < 1e-12
    assert rel_err(got, want) < 1e-12


@pytest.mark.parametrize("case", [
    ((4, 6, 9), False, None, False),
    ((4, 6, 10), False, "ortho", True),
    ((4, 6, 9), True, "forward", False),
    ((2, 3, 4, 10), True, None, True),
])
def test_float64_real_plans(case):
    shape, inverse, norm, planar = case
    bd = len(shape) - 3
    rng = np.random.default_rng(sum(shape) + inverse)
    d = rng.standard_normal(shape)
    rp, pp = _plans(shape, "float64", {"real": True, "inverse": inverse,
                                       "norm": norm, "planar": planar})
    axes = (-3, -2, -1)
    total = shape[-3] * shape[-2] * shape[-1]
    if not inverse:
        got = pp(torch.from_numpy(d))
        ref = rp(d)
        if planar:
            assert got[0].dtype == torch.float64
            got = got[0].numpy() + 1j * got[1].numpy()
            ref = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
        else:
            assert got.dtype == torch.complex128
            got, ref = got.numpy(), np.asarray(ref)
        want = np.fft.rfftn(d, axes=axes) * _norm_factor(norm, False, total)
    else:
        w = np.fft.rfftn(d, axes=axes)
        if planar:
            got = pp(torch.from_numpy(w.real.copy()),
                     torch.from_numpy(w.imag.copy()))
            ref = rp((w.real.copy(), w.imag.copy()))
        else:
            got = pp(torch.from_numpy(w))
            ref = rp(w)
        assert got.dtype == torch.float64 and got.shape == shape
        got, ref = got.numpy(), np.asarray(ref)
        want = np.fft.irfftn(w, s=shape[bd:], axes=axes) * _norm_factor(
            norm, True, total)
    assert rel_err(got, ref) < 1e-12
    assert rel_err(got, want) < 1e-12


@pytest.mark.parametrize("case", [
    ((8, 12, 20), False, False, None),
    ((8, 12, 20), True, False, "ortho"),
    ((4, 6, 10), False, True, None),
    ((4, 6, 10), True, True, "forward"),
])
def test_use_pallas_0_plans(case):
    shape, inverse, real, norm = case
    prm = {"use_pallas": 0, "precision": "highest"}
    rng = np.random.default_rng(sum(shape) + 2 * inverse + real)
    axes = (-3, -2, -1)
    total = shape[0] * shape[1] * shape[2]
    rp, pp = _plans(shape, "float32" if real else "complex64",
                    {"real": real, "inverse": inverse, "norm": norm}, prm)
    ff.reset_counts()
    if real and not inverse:
        x = rng.standard_normal(shape).astype(np.float32)
        want = np.fft.rfftn(x.astype(np.float64), axes=axes)
    elif real:
        x = np.fft.rfftn(rng.standard_normal(shape), axes=axes).astype(
            np.complex64)
        want = np.fft.irfftn(x.astype(np.complex128), s=shape, axes=axes)
    else:
        x = _cplx(shape, np.complex64, 9)
        f = np.fft.ifftn if inverse else np.fft.fftn
        want = f(x.astype(np.complex128), axes=axes)
    want = want * _norm_factor(norm, inverse, total)
    got = pp(torch.from_numpy(x)).numpy()
    assert not any(any(c) for c in ff.counts().values())   # no kernel
    ref = np.asarray(rp(x))
    assert got.dtype == (np.float32 if real and inverse else np.complex64)
    assert rel_err(got, ref) < 1e-6
    assert rel_err(got, want) < 1e-6


# ---- Bluestein's inner transforms on the kernels --------------------------

@pytest.mark.parametrize("n,inverse,kernels", [
    (1009, False, {"fft_last": 2}),
    (1009, True, {"fft_last": 2}),
    (8209, False, {"_step1_twiddle": 2, "_step3_transposed": 2}),
])
def test_prime_plan_rides_the_kernels(n, inverse, kernels):
    # the default point turns the kernels on for a prime z whose inner
    # length has a kernel route (2048: the 2-stage core; 32768: the
    # four-step pair); the reference rides its kernels there only under
    # its stacked precisions, so its plan gets them explicitly
    x = _cplx((2, 1, 1, n), np.complex64, n)
    pp = ot.plan((1, 1, n), "complex64", device="cpu", use_cache=False,
                 inverse=inverse, batch_dims=1)
    assert pp.params.use_pallas == 1 and pp.route == "local"
    assert stockham.bluestein_rides_kernels(n)
    ff.reset_counts()
    got = pp(torch.from_numpy(x)).numpy()
    assert {k: v[1] for k, v in ff.counts().items() if v[1]} == kernels
    assert not any(v[0] for v in ff.counts().values())
    f = np.fft.ifft if inverse else np.fft.fft
    want = f(x.astype(np.complex128), axis=-1)
    assert rel_err(got, want) < 1e-6
    if n < 2048:
        rp = offt_tpu.plan((1, 1, n), "complex64", use_cache=False,
                           inverse=inverse, batch_dims=1,
                           params=RefParams(use_pallas=1,
                                            precision="stack6"))
        assert rel_err(got, np.asarray(rp(x))) < 1e-6
    # with the kernels off the same plan runs the matmul chain alone
    q = ot.plan((1, 1, n), "complex64", device="cpu", use_cache=False,
                inverse=inverse, batch_dims=1,
                params=PlanParams(use_pallas=0))
    ff.reset_counts()
    assert rel_err(q(torch.from_numpy(x)).numpy(), want) < 1e-6
    assert not any(any(c) for c in ff.counts().values())


def test_stockham_tables_are_plan_buffers():
    p = ot.plan((1, 1, 1009), "complex128", device="cpu")
    bufs = {k: v for k, v in p.named_buffers() if k.startswith("table")}
    kinds = sorted({k[0] for k in p._keys})
    assert kinds == ["chirp", "chirp_fft", "dft", "twiddle"]
    assert all(v.dtype == torch.complex128 for v in bufs.values())
