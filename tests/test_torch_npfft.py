"""The numpy.fft namespace of the port (offt_tpu_torch.fft), held against
offt_tpu.fft and numpy.fft: the 1-D functions, the helpers, the dtype
and device rules (the 2-D and n-D forms are tests/test_torch_npfft_nd.py,
which shares these helpers).

Case by case after tests/test_npfft.py, on CPU tensors (so the plans run
the kernels' plain versions; the reference runs its Pallas kernels in
interpret mode with x64 on). The reference's ``use_mesh`` cases run on a
world of one gloo rank here (tests/test_torch_npfft_mesh.py holds four
ranks against the reference). Tolerances: 1e-6
relative norm for fp32 results and 1e-12 for fp64, against the reference
and against complex128 numpy; the helpers bit for bit."""

import numpy as np
import pytest
import torch

import offt_tpu_torch.fft as F
from offt_tpu import fft as R

TOL = 1e-6
TOL64 = 1e-12


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _relerr(got, want):
    got = np.asarray(got)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def c64(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def check(name, x, want_np, tol=TOL, **kw):
    """F.<name> on the CPU tensor of ``x`` against R.<name> on ``x`` and
    against numpy's ``want_np`` (computed in complex128 from ``x``)."""
    got = getattr(F, name)(torch.from_numpy(x), **kw)
    assert got.device.type == "cpu"
    got = got.numpy()
    ref = np.asarray(getattr(R, name)(x, **kw))
    assert got.shape == ref.shape == want_np.shape, (got.shape, ref.shape)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    assert _relerr(got, ref) < tol
    assert _relerr(got, want_np) < tol
    return got


def wide(x):
    return x.astype(np.complex128 if np.iscomplexobj(x) else np.float64)


# ---- 1-D ------------------------------------------------------------------

@pytest.mark.parametrize("n_in,n_arg", [(16, None), (16, 16), (16, 9),
                                        (16, 24), (15, None), (13, None),
                                        (1009, None), (131, 200)])
def test_fft_ifft_lengths(rng, n_in, n_arg):
    x = c64(rng, (n_in,))
    check("fft", x, np.fft.fft(wide(x), n=n_arg), n=n_arg)
    check("ifft", x, np.fft.ifft(wide(x), n=n_arg), n=n_arg)


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_fft_axis(rng, axis):
    x = c64(rng, (8, 12, 16))
    check("fft", x, np.fft.fft(wide(x), axis=axis), axis=axis)


@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
def test_fft_norms(rng, norm):
    x = c64(rng, (32,))
    check("fft", x, np.fft.fft(wide(x), norm=norm), norm=norm)
    check("ifft", x, np.fft.ifft(wide(x), norm=norm), norm=norm)


def test_fft_real_input_promotes(rng):
    x = rng.standard_normal(16).astype(np.float32)
    y = check("fft", x, np.fft.fft(wide(x)))
    assert y.dtype == np.complex64


def test_fft_float64_path(rng):
    # float64 and complex128 take the fp64 route (torch.fft's rule, and
    # the reference's under x64)
    x = (rng.standard_normal(16)
         + 1j * rng.standard_normal(16)).astype(np.complex128)
    y = check("fft", x, np.fft.fft(x), tol=TOL64)
    assert y.dtype == np.complex128
    xr = rng.standard_normal(1009)
    assert check("fft", xr, np.fft.fft(xr), tol=TOL64).dtype == \
        np.complex128
    assert check("rfft", xr, np.fft.rfft(xr), tol=TOL64).dtype == \
        np.complex128
    w = np.fft.rfft(xr)
    assert check("irfft", w, np.fft.irfft(w, n=1009), tol=TOL64,
                 n=1009).dtype == np.float64


@pytest.mark.parametrize("n_in,n_arg", [(16, None), (16, 10), (16, 24),
                                        (15, None), (1009, None)])
def test_rfft_lengths(rng, n_in, n_arg):
    x = rng.standard_normal(n_in).astype(np.float32)
    check("rfft", x, np.fft.rfft(wide(x), n=n_arg), n=n_arg)


@pytest.mark.parametrize("n_out", [16, 15, 10, 24])
def test_irfft_lengths(rng, n_out):
    x = c64(rng, (9,))
    check("irfft", x, np.fft.irfft(wide(x), n=n_out), n=n_out)


def test_irfft_discards_the_imaginary_dc_and_nyquist(rng):
    # numpy's 1-D c2r rule: Im of bin 0 (and of the Nyquist bin for an
    # even n) is dropped, so a random spectrum still matches numpy
    x = c64(rng, (3, 9))
    for n in (16, 17):
        got = check("irfft", x, np.fft.irfft(wide(x), n=n), n=n)
        y = x.copy()
        y[..., 0] = y[..., 0].real
        if n % 2 == 0:
            y[..., -1] = y[..., -1].real
        assert _relerr(got, np.fft.irfft(wide(y), n=n)) < TOL


def test_rfft_irfft_axis(rng):
    x = rng.standard_normal((6, 16, 4)).astype(np.float32)
    check("rfft", x, np.fft.rfft(wide(x), axis=1), axis=1)
    y = np.fft.rfft(wide(x), axis=1).astype(np.complex64)
    check("irfft", y, np.fft.irfft(wide(y), n=16, axis=1), n=16, axis=1)


@pytest.mark.parametrize("norm", [None, "backward", "ortho", "forward"])
def test_hfft_ihfft(rng, norm):
    x = c64(rng, (9,))
    check("hfft", x, np.fft.hfft(wide(x), norm=norm), norm=norm)
    xr = rng.standard_normal(16).astype(np.float32)
    check("ihfft", xr, np.fft.ihfft(wide(xr), norm=norm), norm=norm)
    with pytest.raises(ValueError):
        F.hfft(torch.from_numpy(x), norm="bogus")


# ---- helpers --------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 9])
def test_shift_helpers(rng, n):
    x = rng.standard_normal((n, n + 1))
    t = torch.from_numpy(x)
    for fn in ("fftshift", "ifftshift"):
        want = getattr(np.fft, fn)(x)
        assert np.array_equal(getattr(F, fn)(t).numpy(), want)
        assert np.array_equal(np.asarray(getattr(R, fn)(x)), want)
        assert np.array_equal(getattr(F, fn)(t, axes=1).numpy(),
                              getattr(np.fft, fn)(x, axes=1))
    assert np.array_equal(F.ifftshift(F.fftshift(t)).numpy(), x)


@pytest.mark.parametrize("n", [8, 9])
def test_freq_helpers(n):
    got = F.fftfreq(n, d=0.5, device="cpu")
    assert got.dtype == torch.get_default_dtype()
    np.testing.assert_allclose(got.numpy(), np.fft.fftfreq(n, d=0.5),
                               atol=1e-7)
    np.testing.assert_allclose(np.asarray(R.fftfreq(n, d=0.5)),
                               np.fft.fftfreq(n, d=0.5), atol=1e-7)
    got = F.rfftfreq(n, d=2.0, dtype=torch.float64, device="cpu")
    assert got.dtype == torch.float64
    assert np.array_equal(got.numpy(), np.fft.rfftfreq(n, d=2.0))


# ---- dtype and device rules, refusals -------------------------------------

@pytest.mark.parametrize("dtype,want", [
    (torch.float16, torch.complex64), (torch.int32, torch.complex64),
    (torch.float32, torch.complex64), (torch.complex64, torch.complex64),
    (torch.float64, torch.complex128), (torch.complex128, torch.complex128)])
def test_dtype_rules_follow_torch(dtype, want):
    x = torch.arange(12).reshape(3, 4).to(dtype)
    assert F.fft(x).dtype == want == torch.fft.fft(x.to(want)).dtype
    assert F.fftn(x).dtype == want
    real = torch.float64 if want == torch.complex128 else torch.float32
    assert F.rfft(x).dtype == want
    assert F.irfft(F.rfft(x), n=4).dtype == real
    assert F.hfft(F.ihfft(x), n=4).dtype == real


def test_cpu_tensors_stay_on_the_cpu_and_plans_are_cached_per_device(rng):
    x = torch.from_numpy(c64(rng, (4, 16)))
    F._plan_cached.cache_clear()
    assert F.fft(x).device.type == "cpu"
    assert F.fft(x).device.type == "cpu"
    info = F._plan_cached.cache_info()
    assert info.misses == 1 and info.hits == 1
    p = F._plan_cached((1, 1, 16), torch.complex64, False, False, None, 1,
                       torch.device("cpu"))
    assert p.device == torch.device("cpu")


def test_non_tensors_go_to_the_card(rng):
    x = c64(rng, (16,))
    if torch.cuda.is_available():
        assert F.fft(x).device.type == "cuda"
    else:
        for fn in (F.fft, F.rfftn, F.fftshift):
            with pytest.raises(RuntimeError, match="CUDA"):
                fn(x)
        with pytest.raises(RuntimeError, match="CUDA"):
            F.fftfreq(8)


def test_grad_through_npfft_raises():
    # the name is kept from when the port's plans ran forward only: the
    # namespace now differentiates through its plans' adjoints, as the
    # reference's rides its differentiable plans; the gradient of a real
    # loss matches torch.fft's
    x = torch.randn(8, 16, requires_grad=True)
    w = torch.randn(8, 9)
    y = F.rfft(x)
    assert type(y.grad_fn).__name__ != "NoneType" and y.shape == (8, 9)
    g, = torch.autograd.grad((w * y.abs().pow(2)).sum(), x)
    x2 = x.detach().double().requires_grad_()
    g2, = torch.autograd.grad((w.double() * torch.fft.rfft(x2).abs().pow(2))
                              .sum(), x2)
    assert torch.linalg.norm(g - g2) / torch.linalg.norm(g2) < 1e-6
    z = torch.randn(4, 6, 10, dtype=torch.complex128, requires_grad=True)
    g, = torch.autograd.grad(F.irfftn(z, s=(4, 6, 18)).pow(2).sum(), z)
    z2 = z.detach().requires_grad_()
    g2, = torch.autograd.grad(torch.fft.irfftn(z2, s=(4, 6, 18)).pow(2)
                              .sum(), z2)
    assert torch.linalg.norm(g - g2) / torch.linalg.norm(g2) < 1e-12
    with torch.no_grad():
        assert F.rfft(x).shape == (8, 9)


@pytest.fixture
def world1(tmp_path):
    import datetime

    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_use_mesh_routes_distributed(world1, rng):
    # a world of one rank here (tests/test_torch_npfft_mesh.py runs 4
    # ranks against the reference): the block's calls run on the mesh's
    # plans, cached by mesh, and leaving it restores one device
    from offt_tpu_torch.dist import make_mesh

    x = (rng.standard_normal(4096)
         + 1j * rng.standard_normal(4096)).astype(np.complex64)
    c = (rng.standard_normal((16, 16, 16))
         + 1j * rng.standard_normal((16, 16, 16))).astype(np.complex64)
    mesh = make_mesh(1, 1, device_type="cpu")
    cpu = torch.device("cpu")
    with F.use_mesh(mesh):
        p = F._plan_for((1, 1, 4096), torch.complex64, False, False, None,
                        0, cpu)
        assert p.mesh is mesh and p.route == "pencil"
        got1 = F.fft(torch.from_numpy(x)).numpy()
        rt = F.ifft(F.fft(torch.from_numpy(x), norm="ortho"),
                    norm="ortho").numpy()
        got3 = F.fftn(torch.from_numpy(c)).numpy()
    assert _relerr(got1, np.fft.fft(x)) < TOL
    assert _relerr(got1, np.asarray(R.fft(x))) < TOL
    assert _relerr(rt, x) < TOL
    assert _relerr(got3, np.fft.fftn(c)) < TOL
    assert F.current_mesh() is None
    assert F._plan_for((1, 1, 4096), torch.complex64, False, False, None, 0,
                       cpu).mesh is None


def test_use_mesh_sticky_setter(world1):
    from offt_tpu_torch.dist import make_mesh

    mesh = make_mesh(1, 1, device_type="cpu")
    F.use_mesh(mesh)
    try:
        assert F.current_mesh() is mesh
        x = torch.randn(1024, dtype=torch.complex64)
        assert _relerr(F.fft(x).numpy(), np.fft.fft(x.numpy())) < TOL
    finally:
        F.use_mesh(None)
    assert F.current_mesh() is None
    x = torch.randn(32, dtype=torch.complex64)
    assert F.fft(x).device.type == "cpu"
