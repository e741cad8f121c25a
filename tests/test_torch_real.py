"""offt_tpu_torch's packed r2c/c2r tables and kernel wrappers held against
offt_tpu's.

On the CPU each wrapper runs its plain version; the reference kernels run
in Pallas interpret mode, as tests/test_pallas_kernels.py runs them. The
CUDA kernels themselves are tested on the card by tests/test_torch_cuda.py.
c2r inputs are Hermitian-consistent: spectra of real data."""

import numpy as np
import pytest
import torch

import offt_tpu_torch as ot
from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.kernels import tables

TOL_REF = 1e-5    # port vs the JAX kernel
TOL_NP = 1e-6     # port vs numpy.fft, the repo's fp32 bar


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return (np.linalg.norm(a.ravel() - b.ravel())
            / max(np.linalg.norm(b.ravel()), 1e-30))


def real(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def cplx(pair, lanes=None):
    re, im = (np.asarray(p) for p in pair)
    if lanes is not None:
        re, im = re[..., :lanes], im[..., :lanes]
    return re.astype(np.float64) + 1j * im


def packed_z(x):
    """rfft along z in the packed layout: lane 0 = X[0] + i X[M]."""
    w = np.fft.rfft(x.astype(np.float64), axis=-1)
    m = x.shape[-1] // 2
    p = w[..., :m].copy()
    p[..., 0] = w[..., 0].real + 1j * w[..., m].real
    return p


@pytest.fixture(autouse=True)
def _zero_counts():
    ff.reset_counts()


# ---- tables ---------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 256, 512])
def test_rfft_table_bit_equal_to_reference(n):
    wr, wi = pf._rfft_tables(n)
    tab = tables.rfft_table(n)
    assert tab.dtype == np.float32 and tab.shape == (n // 2, 2)
    assert np.array_equal(tab[:, 0], wr[:, 0])
    assert np.array_equal(tab[:, 1], wi[:, 0])


def _dense_g(tab):
    """The folded (2M, 2M) matrix of the diagonal re-tangle table."""
    m = tab.shape[0]
    ab = tab.astype(np.float64)
    g = np.zeros((2 * m, 2 * m))
    for k in range(m):
        rho = (m - k) % m
        (ar, ai), (br, bi) = ab[k]
        g[k, k] += ar
        g[k, m + k] += -ai
        g[k, rho] += br
        g[k, m + rho] += bi
        g[m + k, k] += ai
        g[m + k, m + k] += ar
        g[m + k, rho] += bi
        g[m + k, m + rho] += -br
    return g


@pytest.mark.parametrize("n", [16, 256, 512])
@pytest.mark.parametrize("scale", [1.0, 1.0 / (8 * 16 * 128)])
def test_crfft_table_matches_g_matrix_and_dual_tables(n, scale):
    m = n // 2
    tab = tables.crfft_table(n, scale)
    assert tab.dtype == np.float32 and tab.shape == (m, 2, 2)
    # the dense G (M <= 128 route of the reference) entry for entry
    g = pf._crfft_g_matrix(n, scale)
    assert np.array_equal(_dense_g(tab).astype(np.float32), g)
    # the dual-route diagonals (rows k >= 1; row 0 is the packed V0 rule)
    ar, ai, gr, gi = (c[:, 0] * np.float32(scale)
                      for c in pf._crfft_dual_tables(n))
    k = np.arange(1, m)
    rho = (m - k) % m
    np.testing.assert_allclose(tab[1:, 0, 0], ar[1:], rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(tab[1:, 0, 1], ai[1:], rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(tab[1:, 1, 0], gr[rho], rtol=2.5e-7, atol=0)
    np.testing.assert_allclose(tab[1:, 1, 1], -gi[rho], rtol=2.5e-7, atol=0)
    row0 = np.float32([[0, 0], [0.5, 0.5]]) * np.float32(scale)
    assert np.array_equal(tab[0], row0)


def test_can_use_rfft3d_matches_reference():
    for nx, ny, nz in [(8, 16, 256), (4, 8, 512), (8, 8, 64), (256, 256, 256),
                       (512, 512, 512), (8, 12, 256), (8, 16, 255),
                       (3000, 8, 256), (8, 8192, 512), (131, 8, 256),
                       (16, 16, 768)]:
        assert (ff.can_use_rfft3d(nx, ny, nz)
                == pf.can_use_rfft3d(nx, ny, nz)), (nx, ny, nz)
    for rad in [((16,), (16,), (128,)), ((4, 4), None, (8, 16)),
                (None, (2, 2, 4), None)]:
        assert (ff.can_use_rfft3d(16, 16, 256, *rad)
                == pf.can_use_rfft3d(16, 16, 256, *rad)), rad


# ---- kernels --------------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 16, 256), (2, 8, 512)])
def test_rfft_slab_yz(shape):
    x = real(shape, seed=shape[-1])
    m = shape[-1] // 2
    port = ff.rfft_slab_yz(t(x), zpad=8)
    ref = pf.rfft_slab_yz(x, zpad=8)
    assert port[0].shape == (*shape[:-1], m + 8) == np.shape(ref[0])
    got = cplx(port, m)
    assert rel_err(got, cplx(ref, m)) < TOL_REF
    assert rel_err(got, np.fft.fft(packed_z(x), axis=-2)) < TOL_NP
    assert ff.counts()["rfft_slab_yz"] == (0, 1)


def _spectrum(shape, seed, pad):
    """A Hermitian-consistent (P, Y, M + 1) spectrum (rfft along z, fft
    along y, of real data) and that data; the spectrum's planar pair is
    pitched to M + pad lanes with random pad values."""
    d = real(shape, seed)
    w = np.fft.fft(np.fft.rfft(d.astype(np.float64), axis=-1), axis=-2)
    m = shape[-1] // 2
    junk = np.random.default_rng(seed + 1).standard_normal(
        (*shape[:-1], m + pad - (m + 1)))
    return w, d, junk


@pytest.mark.parametrize("side", [False, True])
@pytest.mark.parametrize("n", [256, 512])
def test_irfft_slab_yz(side, n):
    shape = (3, 8, n)
    m = n // 2
    w, d, junk = _spectrum(shape, seed=n + side, pad=8)
    lane0 = w[..., 0] if side else w[..., 0] + 1j * w[..., m]
    packed = np.concatenate([lane0[..., None], w[..., 1:m], junk], -1)
    xr, xi = packed.real.astype(np.float32), packed.imag.astype(np.float32)
    kw = {"scale": 0.5 / (8 * m)}
    if side:
        kw["side_r"] = w[..., m].real.astype(np.float32)
        kw["side_i"] = w[..., m].imag.astype(np.float32)
    port = ff.irfft_slab_yz(t(xr), t(xi), n,
                            **{k: t(v) if k.startswith("side") else v
                               for k, v in kw.items()})
    ref = pf.irfft_slab_yz(xr, xi, n, **kw)
    assert port.shape == shape == np.shape(ref)
    assert rel_err(port.numpy(), ref) < TOL_REF
    assert rel_err(port.numpy(), 0.5 * d) < TOL_NP
    assert ff.counts()["irfft_slab_yz"] == (0, 1)


def test_irfft_slab_yz_checks_its_inputs():
    x = torch.zeros(2, 8, 136)
    with pytest.raises(ValueError):
        ff.irfft_slab_yz(x, x, 256, side_r=torch.zeros(2, 8))
    with pytest.raises(ValueError):
        ff.irfft_slab_yz(x, x, 256, side_r=torch.zeros(2, 4),
                         side_i=torch.zeros(2, 4))
    with pytest.raises(ValueError):
        ff.irfft_slab_yz(x, x, 512)
    with pytest.raises(ValueError):
        ff.rfft_slab_yz(torch.zeros(2, 8, 255))
    with pytest.raises(TypeError):
        ff.rfft_slab_yz(torch.zeros(2, 8, 256, dtype=torch.float64))


def test_assemble_mp1():
    rng = np.random.default_rng(3)
    yr, yi = (rng.standard_normal((2, 3, 8, 16)).astype(np.float32)
              for _ in range(2))
    a = (rng.standard_normal((2, 3, 8))
         + 1j * rng.standard_normal((2, 3, 8))).astype(np.complex64)
    b = (rng.standard_normal((2, 3, 8))
         + 1j * rng.standard_normal((2, 3, 8))).astype(np.complex64)
    port = ff._assemble_mp1(t(yr), t(yi), t(a.real), t(a.imag), t(b.real),
                            t(b.imag))
    ref = pf._assemble_mp1(yr, yi, a, b)
    assert port[0].shape == (2, 3, 8, 17) == np.shape(ref[0])
    assert np.array_equal(port[0].numpy(), np.asarray(ref[0]))
    assert np.array_equal(port[1].numpy(), np.asarray(ref[1]))
    assert ff.counts()["_assemble_mp1"] == (0, 1)


@pytest.mark.parametrize("inv", [False, True])
def test_fft_x_to_padded(inv):
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((16, 32, 129))
         + 1j * rng.standard_normal((16, 32, 129))).astype(np.complex64)
    xr, xi = x.real.copy(), x.imag.copy()
    port = ff.fft_x_to_padded(t(xr), t(xi), zpad=8, inverse=inv,
                              z_true=128, scale=0.5)
    ref = pf.fft_x_to_padded(xr, xi, zpad=8, inverse=inv, z_true=128,
                             scale=0.5)
    assert port[0].shape == (16, 32, 136) == np.shape(ref[0])
    f = np.fft.ifft if inv else np.fft.fft
    want = f(x[..., :128].astype(np.complex128), axis=0)
    want = want * (0.5 * 16 if inv else 0.5)
    got = cplx(port, 128)
    assert rel_err(got, cplx(ref, 128)) < TOL_REF
    assert rel_err(got, want) < TOL_NP
    assert ff.counts()["fft_x_to_padded"] == (0, 1)


def test_pack_unpack_round_trip_and_plane0_split():
    x = real((2, 8, 16, 256), seed=21)
    pr, pi = ff.rfft3d_planar(t(x), packed=True)
    want = np.fft.rfftn(x.astype(np.float64), axes=(-3, -2, -1))
    # the plane-0 split against the reference's, on the same packed data
    a, b = ff._plane0_split(pr, pi)
    ra, rb = pf._plane0_split(pr.numpy(), pi.numpy())
    assert rel_err(a.numpy(), ra) < TOL_REF
    assert rel_err(b.numpy(), rb) < TOL_REF
    ur, ui = ot.unpack_rfft3d(pr, pi)
    assert rel_err(cplx((ur, ui)), want) < TOL_NP
    rur, rui = pf.unpack_rfft3d(pr.numpy(), pi.numpy())
    assert rel_err(cplx((ur, ui)), cplx((rur, rui))) < TOL_REF
    qr, qi = ot.pack_rfft3d(ur, ui)
    assert rel_err(cplx((qr, qi)), cplx((pr, pi))) < TOL_NP
    rqr, rqi = pf.pack_rfft3d(ur.numpy(), ui.numpy())
    assert np.array_equal(qr.numpy(), np.asarray(rqr))
    assert np.array_equal(qi.numpy(), np.asarray(rqi))


def test_meta_tensors_only_shape():
    x = torch.empty(4, 16, 256, device="meta")
    yr, yi = ff.rfft_slab_yz(x, zpad=8)
    assert yr.shape == (4, 16, 136) and yr.device.type == "meta"
    yr, yi = ff.fft_x_to_padded(yr, yi, z_true=128)
    assert yr.shape == (4, 16, 136)
    out = ff.irfft_slab_yz(yr, yi, 256)
    assert out.shape == (4, 16, 256)
    yr, yi = ff.unpack_rfft3d(*ff.fft_x_from_padded(yr, yi, 128))
    assert yr.shape == (4, 16, 129)
    assert all(c == (0, 0) for c in ff.counts().values())


def test_plain_version_matches_wrapper_on_cpu():
    x = t(real((2, 8, 256), seed=5))
    a = ff.rfft_slab_yz(x, zpad=4)
    b = ff.rfft_slab_yz.plain(x, zpad=4)
    assert torch.equal(a[0][..., :128], b[0][..., :128])
    assert ff.rfft_slab_yz.plain_calls == 2


# ---- refusals -------------------------------------------------------------

def test_real_plans_refuse_what_is_not_ported():
    with pytest.raises(ValueError):
        ot.plan((8, 16, 256), "float32", real=True, planar=True,
                in_place=True, device="cpu")
    with pytest.raises(ValueError):     # packed needs the gate
        ot.plan((8, 8, 64), "float32", real=True, planar=True, packed=True,
                device="cpu")
    with pytest.raises(ValueError):     # packed needs real and planar
        ot.plan((8, 16, 256), "float32", real=True, packed=True,
                device="cpu")
    with pytest.raises(ValueError):
        ot.plan((8, 16, 256), "complex64", planar=True, packed=True,
                device="cpu")
    # planar=False and shapes outside the gate take the axis-by-axis
    # route now: held against the reference in test_torch_local_plan.py
    # float64 (the fp64 route) and use_pallas=0 take the unfused engine
    # on the axis-by-axis route (tests/test_torch_stockham.py)
    assert ot.plan((8, 16, 256), "float64", real=True, planar=True,
                   device="cpu").route == "local"
    assert ot.plan((8, 16, 256), "float32", real=True, planar=True,
                   params=ot.PlanParams(use_pallas=0),
                   device="cpu").route == "local"


@pytest.mark.parametrize("kw", [
    {}, {"radix_z": (16, 8)}, {"radix_z": (16, 16)}, {"radix_z": (128,)},
    {"x_tile": (8, 128)}, {"x_tile": (8, 256)}, {"radix_y": (4, 4)}])
def test_real_spec_feasibility_and_defaults_match_reference(kw):
    from offt_tpu.plan import params as ref_params
    from offt_tpu_torch.plan import params
    shape = (8, 16, 256)
    mine = params.infeasible_reason(
        params.ProblemSpec(shape=shape, real=True),
        params.PlanParams(use_pallas=1, **kw))
    theirs = ref_params.infeasible_reason(
        ref_params.ProblemSpec(shape=shape, real=True),
        ref_params.PlanParams(use_pallas=1, **kw))
    assert (mine is None) == (theirs is None), (mine, theirs)
    d = params.default_params(params.ProblemSpec(shape=shape, real=True))
    assert d.use_pallas == 1 and d.precision == "highest"
    # z of a real transform may pass on Nz/2: 32768 is 3-stage, 16384 not;
    # a c2c z of 32768 passes on its four-step split (128, 256), a prime
    # past the 2-stage ceiling on its Bluestein inner length (32768, the
    # four-step kernels), a prime x on nothing
    long_z = (8, 8, 32768)
    assert params.default_params(
        params.ProblemSpec(shape=long_z, real=True)).use_pallas == 1
    assert params.default_params(
        params.ProblemSpec(shape=long_z)).use_pallas == 1
    assert params.default_params(
        params.ProblemSpec(shape=(8, 8, 16411))).use_pallas == 1
    assert params.default_params(
        params.ProblemSpec(shape=(16411, 8, 8))).use_pallas == 0
