"""Real plans off the packed fast path (``planar=False``, or shapes
outside ``can_use_rfft3d``) through offt_tpu_torch.plan, held against
offt_tpu.plan: the axis-by-axis route, r2c along z (the ``rfft_last``
kernel, or the unfused r2c around the c2c kernels) then y and x, and its
mirror ending in the unfused c2r. Same parameters, inputs from numpy
seeds, route counts compared; helpers and tolerances from
tests/test_torch_local_plan.py. c2r inputs are spectra of real data."""

import numpy as np
import pytest
import torch

from offt_tpu_torch.kernels import fused_fft as ff

from test_torch_local_plan import (TOL_NP, TOL_REF, _both, _check_routes,
                                   _norm_factor, ref_routes, rel_err)

__all__ = ["ref_routes"]


# ---- real plans off the packed fast path ---------------------------------

def _real(shape, inverse, planar, routes, norm=None):
    bd = len(shape) - 3
    axes = (-3, -2, -1)
    rng = np.random.default_rng(sum(shape) + 2 * inverse + planar)
    d = rng.standard_normal(shape).astype(np.float32)
    rp, pp = _both(shape, {"real": True, "inverse": inverse,
                           "planar": planar, "norm": norm,
                           "batch_dims": bd})
    total = shape[-3] * shape[-2] * shape[-1]
    ff.reset_counts()
    if not inverse:
        ref = rp(d)
        got = pp(torch.from_numpy(d))
        if planar:
            ref = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
            got = got[0].numpy() + 1j * got[1].numpy().astype(np.float64)
        else:
            assert got.dtype == torch.complex64
            ref, got = np.asarray(ref), got.numpy().astype(np.complex128)
        want = np.fft.rfftn(d.astype(np.float64), axes=axes)
    else:
        w = np.fft.rfftn(d.astype(np.float64), axes=axes).astype(
            np.complex64)
        if planar:
            ref = rp((w.real.copy(), w.imag.copy()))
            got = pp(torch.from_numpy(w.real.copy()),
                     torch.from_numpy(w.imag.copy()))
        else:
            ref = rp(w)
            got = pp(torch.from_numpy(w))
        assert got.dtype == torch.float32 and got.shape == shape
        ref, got = np.asarray(ref), got.numpy()
        want = np.fft.irfftn(w.astype(np.complex128), s=shape[bd:],
                             axes=axes)
    _check_routes(routes)
    want = want * _norm_factor(norm, inverse, total)
    assert got.shape == want.shape
    assert rel_err(got, ref) < TOL_REF
    assert rel_err(got, want) < TOL_NP
    return routes


@pytest.mark.parametrize("inverse", [False, True])
def test_real_plan_planar_false(inverse, ref_routes):
    # inside the packed kernels' gate, but planar=False takes the
    # axis-by-axis route: the r2c kernel along z, then y and x
    routes = _real((8, 16, 256), inverse, False, ref_routes)
    assert routes["rfft_last_planar"] == (0 if inverse else 1)


@pytest.mark.parametrize("shape", [(8, 12, 96), (8, 8, 64)])
@pytest.mark.parametrize("inverse", [False, True])
def test_real_plan_outside_the_gate(shape, inverse, ref_routes):
    _real(shape, inverse, True, ref_routes, norm="ortho")


@pytest.mark.parametrize("inverse", [False, True])
def test_real_plan_odd_n(inverse, ref_routes):
    routes = _real((4, 6, 255), inverse, True, ref_routes)
    assert routes["rfft_last_planar"] == 0


@pytest.mark.parametrize("inverse", [False, True])
def test_real_plan_long_1d(inverse, ref_routes):
    # N = 2^16: the half-length inner c2c takes the four-step route
    routes = _real((1, 1, 2 ** 16), inverse, True, ref_routes,
                   norm="forward")
    assert routes["_step1_twiddle"] == routes["_step3_transposed"] == 1


def test_real_plan_batched_complex_boundary(ref_routes):
    _real((2, 4, 8, 96), False, False, ref_routes)
