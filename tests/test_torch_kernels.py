"""offt_tpu_torch's kernel wrappers held against offt_tpu's Pallas kernels.

On the CPU each wrapper runs its plain version; the reference kernels run
in Pallas interpret mode, as tests/test_pallas_kernels.py runs them. The
CUDA kernels themselves are tested on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.kernels import fused_fft as ff

TOL_REF = 1e-5    # port vs the JAX kernel (tests/test_pallas_kernels.py)
TOL_NP = 1e-6     # port vs numpy.fft, the repo's fp32 bar


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (np.linalg.norm(a.ravel() - b.ravel())
            / max(np.linalg.norm(b.ravel()), 1e-30))


def rand_c64(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def planar(x):
    return (torch.from_numpy(np.ascontiguousarray(x.real)),
            torch.from_numpy(np.ascontiguousarray(x.imag)))


def cplx(pair, lanes=None):
    re, im = (np.asarray(p) for p in pair)
    if lanes is not None:
        re, im = re[..., :lanes], im[..., :lanes]
    return re.astype(np.float64) + 1j * im


def check(port, ref, want, lanes=None):
    got = cplx(port, lanes)
    assert rel_err(got, cplx(ref, lanes)) < TOL_REF
    assert rel_err(got, want) < TOL_NP


@pytest.fixture(autouse=True)
def _zero_counts():
    ff.reset_counts()


@pytest.mark.parametrize("n", [8, 64, 256])
@pytest.mark.parametrize("inv", [False, True])
def test_fft_last(n, inv):
    x = rand_c64((10, n), seed=n)
    scale = 1.0 / n if inv else 1.0
    port = ff.fft_last(*planar(x), inverse=inv, scale=scale)
    ref = pf.fft_last(x.real.copy(), x.imag.copy(), inverse=inv,
                      scale=scale)
    want = (np.fft.ifft if inv else np.fft.fft)(x.astype(np.complex128))
    check(port, ref, want)
    assert ff.fft_last.plain_calls == 1 and ff.fft_last.launches == 0


@pytest.mark.parametrize("rad", [(8, 8), (4, 4, 4)])
def test_fft_last_radices(rad):
    x = rand_c64((10, 64), seed=4)
    port = ff.fft_last(*planar(x), radices=rad)
    ref = pf.fft_last(x.real.copy(), x.imag.copy(), radices=rad)
    check(port, ref, np.fft.fft(x.astype(np.complex128)))
    with pytest.raises(ValueError):
        ff.fft_last(*planar(x), radices=(2, 2, 4, 4))


def test_fft_last_alias_ragged_batch():
    # the reference refuses alias on a batch that is not a block multiple
    x = rand_c64((3, 5, 20), seed=9)
    xr, xi = planar(x.copy())
    yr, yi = ff.fft_last(xr, xi, alias=True, scale=0.5)
    assert yr is xr and yi is xi
    assert rel_err(cplx((yr, yi)), 0.5 * np.fft.fft(x)) < TOL_NP
    with pytest.raises(ValueError):
        pf.fft_last(x.real.copy(), x.imag.copy(), alias=True)


@pytest.mark.parametrize("axis,route", [(0, "_sublane_nd"),
                                        (1, "fft_sublane")])
def test_fft_sublane(axis, route):
    x = rand_c64((16, 32, 128), seed=axis)
    port = ff.fft_sublane(*planar(x), axis, scale=0.5)
    ref = pf.fft_sublane(x.real.copy(), x.imag.copy(), axis, scale=0.5)
    check(port, ref, 0.5 * np.fft.fft(x.astype(np.complex128), axis=axis))
    assert ff.counts()[route] == (0, 1)
    assert sum(c[1] for c in ff.counts().values()) == 1


def test_fft_sublane_inverse_alias():
    x = rand_c64((6, 10, 12), seed=7)
    xr, xi = planar(x.copy())
    yr, yi = ff.fft_sublane(xr, xi, 1, inverse=True, scale=0.1, alias=True)
    assert yr is xr
    ref = pf.fft_sublane(x.real.copy(), x.imag.copy(), 1, inverse=True,
                         scale=0.1)
    check((yr, yi), ref, np.fft.ifft(x.astype(np.complex128), axis=1))


@pytest.mark.parametrize("alias", [False, True])
@pytest.mark.parametrize("inv", [False, True])
def test_fft_slab_yz(alias, inv):
    x = rand_c64((4, 32, 128), seed=11)
    zpad = 0 if alias else 8
    xr, xi = planar(x.copy())
    port = ff.fft_slab_yz(xr, xi, inverse=inv, zpad=zpad, scale=0.25,
                          alias=alias)
    ref = pf.fft_slab_yz(x.real.copy(), x.imag.copy(), inverse=inv,
                         zpad=zpad, scale=0.25, alias=alias)
    assert port[0].shape == (4, 32, 128 + zpad) == np.shape(ref[0])
    assert (port[0] is xr) == alias
    f = np.fft.ifft2 if inv else np.fft.fft2
    want = 0.25 * f(x.astype(np.complex128), axes=(-2, -1))
    if inv:
        want = want * 32 * 128
    check(port, ref, want, lanes=128)
    assert ff.fft_slab_yz.plain_calls == 1


def test_fft_slab_yz_z_true():
    x = rand_c64((3, 8, 24), seed=12)
    port = ff.fft_slab_yz(*planar(x), z_true=16)
    ref = pf.fft_slab_yz(x.real.copy(), x.imag.copy(), z_true=16)
    want = np.fft.fft2(x[..., :16].astype(np.complex128))
    check(port, ref, want)
    with pytest.raises(ValueError):
        ff.fft_slab_yz(*planar(x), z_true=16, alias=True)


@pytest.mark.parametrize("inv", [False, True])
def test_fft_x_from_padded(inv):
    x = rand_c64((16, 32, 136), seed=13)
    scale = 1.0 / 16 if inv else 2.0
    port = ff.fft_x_from_padded(*planar(x), 128, inverse=inv, scale=scale)
    ref = pf.fft_x_from_padded(x.real.copy(), x.imag.copy(), 128,
                               inverse=inv, scale=scale)
    assert port[0].shape == (16, 32, 128) == np.shape(ref[0])
    f = np.fft.ifft if inv else np.fft.fft
    want = f(x[..., :128].astype(np.complex128), axis=0)
    want = want * (scale * 16 if inv else scale)
    check(port, ref, want)
    assert ff.counts()["fft_x_from_padded"] == (0, 1)


def test_fft_x_from_padded_out_lanes_y_true():
    x = rand_c64((2, 8, 12, 20), seed=14)
    yr, yi = ff.fft_x_from_padded(*planar(x), 16, out_lanes=24, y_true=8)
    assert yr.shape == (2, 8, 8, 24)
    want = np.fft.fft(x[:, :, :8, :16].astype(np.complex128), axis=1)
    assert rel_err(cplx((yr, yi), lanes=16), want) < TOL_NP


def test_wrappers_check_their_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(TypeError):
        ff.fft_last(x.double(), x.double())
    with pytest.raises(ValueError):
        ff.fft_last(x, torch.zeros(4, 16))
    with pytest.raises(ValueError):
        ff.fft_last(x.t(), x.t())
    with pytest.raises(ValueError):
        ff.fft_sublane(x, x, 1)
    with pytest.raises(ValueError):
        ff.fft_last(torch.zeros(4, 131), torch.zeros(4, 131))


def test_meta_tensors_only_shape():
    m = torch.empty(4, 32, 128, device="meta")
    yr, yi = ff.fft_slab_yz(m, m.clone(), zpad=8)
    assert yr.shape == (4, 32, 136) and yr.device.type == "meta"
    yr, yi = ff.fft_x_from_padded(yr, yi, 128)
    assert yr.shape == (4, 32, 128)
    assert all(c == (0, 0) for c in ff.counts().values())


def test_plain_version_matches_wrapper_on_cpu():
    x = rand_c64((2, 16, 64), seed=15)
    a = ff.fft_slab_yz(*planar(x), zpad=4)
    b = ff.fft_slab_yz.plain(*planar(x), zpad=4)
    assert torch.equal(a[0][..., :64], b[0][..., :64])
    assert ff.fft_slab_yz.plain_calls == 2


# ---- lines too long for one block ------------------------------------------
# Three stages of at most 32 reach 32768 points, past one block's shared
# memory (about 29k points): every wrapper takes such a line through the
# four-step pair on (rows, r0, n / r0), on the CPU as on the card. Held
# against numpy only: the reference's interpret-mode compile of a
# three-stage 32768 takes over ten minutes on a CPU.

LONG = (32, 32, 32)


def _long_route(counts):
    assert {k: v for k, v in counts.items() if any(v)} == {
        "_step1_twiddle": (0, 1), "_step3_transposed": (0, 1)}


@pytest.mark.parametrize("inv", [False, True])
def test_fft_last_long_line(inv):
    assert not ff._fits_block(32768, sum(LONG))
    assert ff._fits_block(16384, 256)
    x = rand_c64((3, 32768), seed=21)
    yr, yi = ff.fft_last(*planar(x), inverse=inv, radices=LONG, scale=0.5)
    _long_route(ff.counts())
    f = np.fft.ifft if inv else np.fft.fft
    want = 0.5 * f(x.astype(np.complex128), axis=-1) * (32768 if inv else 1)
    assert rel_err(cplx((yr, yi)), want) < TOL_NP
    a, b = planar(x)
    out = ff.fft_last(a, b, inverse=inv, radices=LONG, scale=0.5,
                      alias=True)
    assert out[0] is a and out[1] is b
    assert rel_err(cplx((a, b)), want) < TOL_NP


@pytest.mark.parametrize("axis,shape", [(0, (32768, 2, 4)),
                                        (1, (2, 32768, 3, 4))])
def test_fft_sublane_long_axis(axis, shape):
    x = rand_c64(shape, seed=22)
    yr, yi = ff.fft_sublane(*planar(x), axis, radices=LONG, scale=0.5)
    _long_route(ff.counts())
    want = 0.5 * np.fft.fft(x.astype(np.complex128), axis=axis)
    assert rel_err(cplx((yr, yi)), want) < TOL_NP


@pytest.mark.parametrize("kw", [{}, {"zpad": 8},
                                {"inverse": True, "alias": True}])
def test_fft_slab_yz_long_z(kw):
    x = rand_c64((2, 8, 32768), seed=23)
    xr, xi = planar(x)
    yr, yi = ff.fft_slab_yz(xr, xi, rad_z=LONG, scale=0.5, **kw)
    assert ff.fft_sublane.plain_calls == 1
    assert yr.shape[-1] == 32768 + kw.get("zpad", 0)
    assert (yr is xr) == bool(kw.get("alias"))
    f = np.fft.ifft2 if kw.get("inverse") else np.fft.fft2
    want = 0.5 * f(x.astype(np.complex128), axes=(-2, -1))
    if kw.get("inverse"):
        want *= 8 * 32768
    assert rel_err(cplx((yr, yi), 32768), want) < TOL_NP


def test_long_three_stage_plan():
    import offt_tpu_torch as ot
    x = rand_c64((8, 8, 32768), seed=24)
    p = ot.plan((8, 8, 32768), "complex64", planar=True, device="cpu",
                params=ot.PlanParams(use_pallas=1, radix_z=LONG))
    assert p.route == "fft3d"
    assert {k[0] for k in p._keys} == {"core", "fourstep"}
    yr, yi = p(planar(x))
    assert ff.WRAPPERS["_step1_twiddle"].plain_calls == 1
    assert rel_err(cplx((yr, yi)), np.fft.fftn(x.astype(np.complex128))) \
        < TOL_NP
