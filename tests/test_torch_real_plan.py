"""The packed r2c/c2r slice through offt_tpu_torch.plan held against
offt_tpu.plan, in both layouts.

Both packages get the same inputs and the same parameters; the reference
runs its Pallas kernels in interpret mode. The routes are held against
each other too: each package's kernel-wrapper calls are counted and must
agree. c2r inputs are spectra of real data (Hermitian-consistent)."""

import numpy as np
import pytest
import torch

import offt_tpu
import offt_tpu_torch as ot
from offt_tpu.kernels import pallas_fft as pf
from offt_tpu.plan.params import PlanParams as RefParams
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.plan.params import PlanParams

TOL_REF = 1e-5
TOL_NP = 1e-6
ROUTED = ("fft_last", "fft_sublane", "_sublane_nd", "fft_slab_yz",
          "fft_x_from_padded", "fft_x_to_padded", "rfft_slab_yz",
          "irfft_slab_yz", "_assemble_mp1")
# (batch..., X, Y, N) at M = 128, the reference's dense H/G untangle;
# its dual-transform untangle (M = 256) is tests/test_torch_real_dual.py
SHAPES = [(8, 16, 256), (2, 8, 16, 256)]


def rel_err(a, b):
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


@pytest.fixture
def ref_routes(monkeypatch):
    """Counts the reference's kernel-wrapper calls while it traces."""
    calls = dict.fromkeys(ROUTED, 0)
    for name in ROUTED:
        orig = getattr(pf, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(pf, name, counted)
    return calls


def _launch_view(calls):
    """A reference fft_sublane that hands over to _sublane_nd is one
    kernel call, counted once, as the port counts it."""
    out = dict(calls)
    out["fft_sublane"] -= out["_sublane_nd"]
    return out


def _inputs(shape, inverse, packed, seed):
    """(port input, reference input, numpy answer without norm)."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal(shape).astype(np.float32)
    axes = (-3, -2, -1)
    if not inverse:
        return ((torch.from_numpy(d),), d,
                np.fft.rfftn(d.astype(np.float64), axes=axes))
    w = np.fft.rfftn(d.astype(np.float64), axes=axes).astype(np.complex64)
    want = np.fft.irfftn(w.astype(np.complex128), s=shape[-3:], axes=axes)
    if packed:
        m = shape[-1] // 2
        w = w[..., :m].copy()
        w[..., 0] = w[..., 0] + 1j * np.fft.rfftn(
            d.astype(np.float64), axes=axes)[..., m].astype(np.complex64)
    pair = (np.ascontiguousarray(w.real), np.ascontiguousarray(w.imag))
    return tuple(torch.from_numpy(p.copy()) for p in pair), pair, want


def _norm_factor(norm, inverse, total):
    if norm == "ortho":
        return total ** 0.5 if inverse else total ** -0.5
    if norm == "forward":
        return float(total) if inverse else 1.0 / total
    return 1.0


def _run_both(shape, inverse, packed, norm, routes):
    bd = len(shape) - 3
    port_in, ref_in, want = _inputs(shape, inverse, packed, sum(shape))
    kw = {"real": True, "planar": True, "packed": packed, "norm": norm,
          "inverse": inverse, "batch_dims": bd}
    rp = offt_tpu.plan(shape[bd:], "complex64", use_cache=False,
                       params=RefParams(use_pallas=1, precision="highest"),
                       **kw)
    ref = rp(ref_in)
    p = ot.plan(shape[bd:], "float32", device="cpu",
                params=PlanParams(use_pallas=1, precision="highest"), **kw)
    ff.reset_counts()
    got = p(*port_in)
    assert all(v[0] == 0 for v in ff.counts().values())
    # the wrappers of later slices join only if they ran
    port_calls = {k: v[1] for k, v in ff.counts().items()
                  if k in ROUTED or v[1]}
    assert port_calls == _launch_view(routes), (port_calls, routes)
    total = shape[-3] * shape[-2] * shape[-1]
    want = want * _norm_factor(norm, inverse, total)
    if inverse:
        assert got.shape == shape
        return got.numpy(), np.asarray(ref), want
    y = got[0].numpy() + 1j * got[1].numpy().astype(np.float64)
    r = np.asarray(ref[0]) + 1j * np.asarray(ref[1]).astype(np.float64)
    if packed:
        assert y.shape == (*shape[:-1], shape[-1] // 2)
        ur, ui = ot.unpack_rfft3d(*got)
        u = ur.numpy() + 1j * ui.numpy().astype(np.float64)
        assert rel_err(u, want) < TOL_NP
        m = shape[-1] // 2
        want = np.concatenate([want[..., :1] + 1j * want[..., m:],
                               want[..., 1:m]], -1)
    return y, r, want


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
def test_real_plan_matches_reference(shape, packed, inverse, ref_routes):
    got, ref, want = _run_both(shape, inverse, packed, None, ref_routes)
    assert rel_err(got, ref) < TOL_REF
    assert rel_err(got, want) < TOL_NP
