"""Autodiff through offt_tpu_torch's real plans (r2c, c2r) held against
offt_tpu's, case by case after tests/test_autodiff.py; helpers,
conventions and tolerances from tests/test_torch_autodiff.py.

The numpy layout's c2r untangle differs off the Hermitian manifold
between the c2r implementations: the fused c2r (``irfft3d_planar``)
packs plane 0 := X_0 + i X_M first, ``rfft.irfft_1d`` (the axis-by-axis
route, the fp64 route, a mesh plan's numpy layout) folds conj(X_M) into
its first packed sample. The port transposes each (``c2r_transpose``).
The reference transposes the first on every route, which off the
manifold is the transpose of its fused route only; on its unfused route
its gradients come from its native autodiff at its default point
(``use_pallas=0``), and those are what the port's are held against
there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import offt_tpu
import offt_tpu_torch as ot
from offt_tpu.plan.params import PlanParams as RefParams

from test_torch_autodiff import (TOL, TOL64, check_transpose, rand, randc,
                                 ref_plan, ref_vjp, rel, t)


# ---- gradients of real losses ---------------------------------------------

@pytest.mark.parametrize("norm", ["backward", "ortho"])
def test_grad_rfftn_matches_reference(norm):
    x, w = rand((8, 8, 8), 2), randc((8, 8, 5), 3)
    p = ot.plan((8, 8, 8), "float64", real=True, norm=norm, device="cpu")
    rp = offt_tpu.plan((8, 8, 8), "complex128", real=True, norm=norm)
    xt = t(x, grad=True)
    y = p(xt)
    assert type(y.grad_fn).__name__ == "R2CComplexBackward"
    g, = torch.autograd.grad((y * t(w)).abs().pow(2).sum(), xt)
    gj = jax.grad(lambda z: jnp.sum(jnp.abs(rp(z) * w) ** 2))(
        jnp.asarray(x))
    assert rel(g.numpy(), np.asarray(gj)) < TOL64
    xt2 = t(x, grad=True)
    g2, = torch.autograd.grad(
        (torch.fft.rfftn(xt2, norm=norm) * t(w)).abs().pow(2).sum(), xt2)
    assert rel(g.numpy(), g2.numpy()) < TOL64


def test_grad_irfftn_hermitian_consistent():
    """x -> irfftn(rfftn(x) * filt) with a Hermitian-symmetric filter:
    the spectrum stays on the manifold, where every c2r and its transpose
    agree with numpy's."""
    x, w = rand((8, 8, 8), 4), rand((8, 8, 8), 6)
    filt = np.abs(np.fft.rfftn(rand((8, 8, 8), 5))) ** 2
    pf = ot.plan((8, 8, 8), "float64", real=True, device="cpu")
    pb = ot.plan((8, 8, 8), "float64", real=True, inverse=True, device="cpu")
    rf = offt_tpu.plan((8, 8, 8), "complex128", real=True)
    rb = offt_tpu.plan((8, 8, 8), "complex128", real=True, inverse=True)
    xt = t(x, grad=True)
    g, = torch.autograd.grad((pb(pf(xt) * t(filt)) * t(w)).sum(), xt)
    gj = jax.grad(lambda z: jnp.sum(rb(rf(z) * filt) * w))(jnp.asarray(x))
    assert rel(g.numpy(), np.asarray(gj)) < TOL64
    xt2 = t(x, grad=True)
    g2, = torch.autograd.grad((torch.fft.irfftn(
        torch.fft.rfftn(xt2) * t(filt)) * t(w)).sum(), xt2)
    assert rel(g.numpy(), g2.numpy()) < TOL64


def test_grad_odd_n_c2r_composite_matches_numpy():
    """Odd N on the kernels: rfft -> symmetric filter -> irfft, the
    gradient against torch.fft's end to end (no self-paired Nyquist bin,
    so no manifold caveat)."""
    n, shape = 27, (8, 8, 27)
    x = rand(shape, 43, np.float32)
    fz = np.fft.rfftfreq(n)[None, None, :]
    fx = np.fft.fftfreq(8)[:, None, None]
    fy = np.fft.fftfreq(8)[None, :, None]
    k = np.exp(-10 * (fx ** 2 + fy ** 2 + fz ** 2)).astype(np.float32)
    pf = ot.plan(shape, "float32", real=True, device="cpu")
    pi = ot.plan(shape, "float32", real=True, inverse=True, device="cpu")
    assert pf.params.use_pallas == 1
    xt = t(x, grad=True)
    g, = torch.autograd.grad(pi(pf(xt) * t(k)).pow(2).sum(), xt)
    xt2 = t(x.astype(np.float64), grad=True)
    g2, = torch.autograd.grad(torch.fft.irfftn(
        torch.fft.rfftn(xt2) * t(k.astype(np.float64)), s=shape).pow(2)
        .sum(), xt2)
    assert rel(g.numpy(), g2.numpy()) < TOL


# ---- the transpose identity and the vjp against the reference's -----------

@pytest.mark.parametrize("packed", [False, True])
def test_transpose_rfft_planar(packed):
    shape = (16, 16, 256) if packed else (16, 8, 8)
    p = ot.plan(shape, "float32", real=True, planar=True, packed=packed,
                device="cpu")
    assert p.route == ("rfft3d" if packed else "local")
    args = (rand(shape, 10, np.float32),)
    cts, g = check_transpose(p, args, seed=20, tol=1e-4)
    gr = ref_vjp(ref_plan(p), args, cts, planar=True)
    assert rel(g[0], gr[0]) < TOL


@pytest.mark.parametrize("shape,packed,route", [
    ((16, 8, 8), False, "local"),
    ((16, 16, 256), False, "rfft3d"),
    ((16, 16, 256), True, "rfft3d")])
def test_transpose_irfft_planar(shape, packed, route):
    nf = shape[2] // 2 + (0 if packed else 1)
    p = ot.plan(shape, "float32", real=True, inverse=True, planar=True,
                packed=packed, device="cpu")
    assert p.route == route
    args = (rand(shape[:2] + (nf,), 11, np.float32),
            rand(shape[:2] + (nf,), 12, np.float32))
    cts, g = check_transpose(p, args, seed=30, tol=1e-4)
    # the unfused route's untangle is irfft_1d's: the reference's native
    # autodiff at its default point transposes it exactly
    rp = ref_plan(p, params=None if route == "local" else "same")
    for a, b in zip(g, ref_vjp(rp, args, cts, planar=True)):
        assert rel(a, b) < TOL


def test_transpose_irfft_complex_nonplanar():
    """complex64 c2r with ``planar=False``: the axis-by-axis route (the
    reference's fused local pipeline takes it), in the complex calling
    convention: compared through the conjugate."""
    shape = (16, 16, 256)
    p = ot.plan(shape, "complex64", real=True, inverse=True, device="cpu")
    assert p.route == "local"
    args = (randc((16, 16, 129), 21, np.complex64),)
    cts, g = check_transpose(p, args, seed=40, tol=1e-4)
    assert type(p(t(args[0], True)).grad_fn).__name__ == "C2RComplexBackward"
    gr = ref_vjp(ref_plan(p, params=None), args, cts, planar=False)
    assert rel(g[0], gr[0]) < TOL


def test_transpose_irfft_odd_n():
    p = ot.plan((8, 8, 7), "complex128", real=True, inverse=True,
                device="cpu")
    args = (randc((8, 8, 4), 13),)
    cts, g = check_transpose(p, args, seed=50, tol=1e-9)
    gr = ref_vjp(ref_plan(p, params=None), args, cts, planar=False)
    assert rel(g[0], gr[0]) < TOL64


@pytest.mark.parametrize("shape,nf", [((8, 8, 7), 4), ((16, 16, 27), 14)])
def test_transpose_irfft_odd_n_on_the_kernels(shape, nf):
    """Odd-N complex64 c2r with the kernels on: the Hermitian-extension
    transpose (forward r2c, flipped norm, bin 0 once, every other bin
    twice), against the reference's wrapped rule on the same parameters."""
    p = ot.plan(shape, "complex64", real=True, inverse=True, device="cpu",
                params=ot.PlanParams(use_pallas=1))
    args = (randc(shape[:-1] + (nf,), 41, np.complex64),)
    cts, g = check_transpose(p, args, seed=60, tol=1e-4)
    gr = ref_vjp(ref_plan(p), args, cts, planar=False)
    assert rel(g[0], gr[0]) < TOL


def test_c2r_fold_follows_the_route():
    """Off the Hermitian manifold the fused c2r and irfft_1d are different
    maps (so their transposes differ); on it they agree, and each vjp
    passes the transpose identity on the same data."""
    shape = (16, 16, 256)
    fused = ot.plan(shape, "float32", real=True, inverse=True, planar=True,
                    device="cpu")
    local = ot.plan(shape, "complex64", real=True, inverse=True,
                    device="cpu")
    assert (fused.route, local.route) == ("rfft3d", "local")
    args = (rand((16, 16, 129), 70, np.float32),
            rand((16, 16, 129), 71, np.float32))
    y_f = fused(t(args[0]), t(args[1])).numpy()
    y_l = local(torch.complex(t(args[0]), t(args[1]))).numpy()
    assert rel(y_f, y_l) > 1e-3                     # off the manifold
    w = np.fft.rfftn(rand(shape, 72))
    on = (w.real.astype(np.float32), w.imag.astype(np.float32))
    assert rel(fused(t(on[0]), t(on[1])).numpy(),
               local(torch.complex(t(on[0]), t(on[1]))).numpy()) < 1e-5
    check_transpose(fused, args, seed=80, tol=1e-4)
    check_transpose(local, (args[0] + 1j * args[1],), seed=80, tol=1e-4)


def c2r_edge_rule(x, n: int, fused: bool) -> np.ndarray:
    """A c2r plan's edge rule (``plan()``'s docstring), in numpy: with G_0
    and G_M the z = 0 and n/2 planes inverted along x and y, irfft along z
    of G_0' = Re G_0 - Im G_M and G_M' = Re G_M - Im G_0 (+ Im G_0 on the
    fused route)."""
    g = np.fft.ifftn(x, axes=(-3, -2))
    g0, gm = g[..., 0].copy(), g[..., -1].copy()
    g[..., 0] = g0.real - gm.imag
    g[..., -1] = gm.real + (1.0 if fused else -1.0) * g0.imag
    return np.fft.irfft(g, n=n, axis=-1)


@pytest.mark.parametrize("shape,planar,route", [
    ((16, 16, 256), True, "rfft3d"), ((16, 16, 256), False, "local"),
    ((12, 12, 12), True, "local")])
def test_c2r_off_the_manifold_follows_the_edge_rule(shape, planar, route):
    """Off the half-spectra of real signals a numpy-layout c2r plan
    computes the reference plan's function, the edge rule of
    :func:`c2r_edge_rule`, and not ``numpy.fft.irfftn``'s (which drops
    Im G_0 and Im G_M): an FNO layer that learns its z = 0 plane gets a
    Nyquist plane that the same layer through torch.fft lacks (ROADMAP
    Queue 3)."""
    p = ot.plan(shape, "float32", real=True, inverse=True, planar=planar,
                device="cpu")
    assert p.route == route
    x = randc(shape[:2] + (shape[2] // 2 + 1,), 90, np.complex64)
    if planar:
        y = p(t(x.real.copy()), t(x.imag.copy())).numpy()
        yr = ref_plan(p)((x.real.copy(), x.imag.copy()))
    else:
        y = p(t(x)).numpy()
        yr = ref_plan(p)(x)
    want = c2r_edge_rule(x.astype(np.complex128), shape[2],
                         route == "rfft3d")
    assert rel(y, want) < 1e-6
    assert rel(y, np.asarray(yr)) < TOL
    assert rel(want, np.fft.irfftn(x, s=shape, axes=(0, 1, 2))) > 1e-2


# ---- forward mode ---------------------------------------------------------

def test_jvp_planar_rfft_irfft():
    pr = ot.plan((16, 8, 8), "float32", real=True, planar=True,
                 device="cpu")
    x, tx = rand((16, 8, 8), 57, np.float32), rand((16, 8, 8), 58,
                                                   np.float32)
    _, (tr, ti) = torch.func.jvp(pr, (t(x),), (t(tx),))
    got = tr.numpy() + 1j * ti.numpy()
    assert rel(got, np.fft.rfftn(tx.astype(np.float64))) < TOL
    rp = ref_plan(pr)
    _, (jr, ji) = jax.jvp(rp, (jnp.asarray(x),), (jnp.asarray(tx),))
    assert rel(got, np.asarray(jr) + 1j * np.asarray(ji)) < TOL

    pi = ot.plan((16, 8, 8), "float32", real=True, inverse=True,
                 planar=True, device="cpu")
    fr, fi, tfr, tfi = (rand((16, 8, 5), s, np.float32)
                        for s in range(59, 63))
    _, tv = torch.func.jvp(lambda a, b: pi(a, b), (t(fr), t(fi)),
                           (t(tfr), t(tfi)))
    assert rel(tv.numpy(), pi(t(tfr), t(tfi)).numpy()) < TOL  # linearity
    ri = ref_plan(pi, params=None)
    _, tj = jax.jvp(lambda a, b: ri((a, b)), (fr, fi), (tfr, tfi))
    assert rel(tv.numpy(), np.asarray(tj)) < TOL


# ---- gradcheck on the complex128 route ------------------------------------

@pytest.mark.parametrize("kind,nz", [("c2c", 6), ("r2c", 6), ("r2c", 5),
                                     ("c2r", 6), ("c2r", 5)])
@pytest.mark.parametrize("planar", [False, True])
def test_gradcheck_fp64_route(kind, nz, planar):
    """The rules themselves, checked by finite differences
    (``gradcheck``) and second order (``gradgradcheck``) on the fp64
    route: every input, Hermitian-consistent or not."""
    real, inverse = kind != "c2c", kind == "c2r"
    p = ot.plan((2, 3, nz), "float64" if real else "complex128", real=real,
                inverse=inverse, planar=planar, norm="ortho", device="cpu")
    nf = nz // 2 + 1 if inverse else nz
    if kind == "r2c":
        args = (t(rand((2, 3, nz), 90), True),)
    elif planar:
        args = (t(rand((2, 3, nf), 91), True), t(rand((2, 3, nf), 92), True))
    else:
        args = (t(randc((2, 3, nf), 93), True),)
    assert torch.autograd.gradcheck(p, args)
    assert torch.autograd.gradgradcheck(p, args)
