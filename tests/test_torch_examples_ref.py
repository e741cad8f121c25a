"""The computations of the port's examples 1-4 held against the same
computations through offt_tpu's plans (the reference examples' code, on
its default points: on the CPU its unfused route, its Pallas kernels in
interpret mode for the packed layout), on the same numpy-seeded inputs:

1. grad_spectral: the loss gradient at a random source;
2. jvp_sensitivity: the Jacobian columns (jacfwd);
3. fno_layer: one step's weight gradient (at zero weights, on the
   hidden operator's data);
4. packed_spectral: the low-passed field.

Tolerance 1e-5 relative (TOL): float32 plans, two of them and a gradient
stacked on each path. The mesh example (spectral_poisson) is held
against the reference in tests/test_torch_examples_poisson.py."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

import offt_tpu

from torch_examples import module

TOL = 1e-5


def rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


def ref_pair(shape, batch_dims=0, packed=False):
    fwd = offt_tpu.plan(shape, "complex64", real=True, planar=True,
                        batch_dims=batch_dims, packed=packed)
    inv = offt_tpu.plan(shape, "complex64", real=True, inverse=True,
                        planar=True, batch_dims=batch_dims, packed=packed)
    return fwd, inv


def test_grad_spectral_loss_gradient():
    ex = module("grad_spectral")
    n = 32
    pb = ex.problem(n, torch.device("cpu"))
    s = np.random.default_rng(7).standard_normal((n,) * 3).astype(
        np.float32)
    g = pb.grad(torch.from_numpy(s)).numpy()

    fwd, inv = ref_pair((n,) * 3)
    h = jnp.asarray(pb.h.numpy())
    y_obs = jnp.asarray(pb.y_obs.numpy())

    def loss(s):
        yr, yi = fwd(s)
        r = inv((yr * h, yi * h)) - y_obs
        return jnp.sum(r * r) + ex.LAM * jnp.sum(s * s)
    gj = jax.grad(loss)(jnp.asarray(s))
    assert rel(g, gj) < TOL
    # and the example's h is the reference example's transfer function
    k = [np.fft.fftfreq(n), np.fft.fftfreq(n), np.fft.rfftfreq(n)]
    k2 = (k[0][:, None, None] ** 2 + k[1][None, :, None] ** 2
          + k[2][None, None, :] ** 2)
    assert np.array_equal(pb.h.numpy(),
                          np.exp(-k2 / (2 * 0.25 ** 2)).astype(np.float32))


def test_jvp_sensitivity_jacobian_columns():
    ex = module("jvp_sensitivity")
    n = 16
    dev = torch.device("cpu")
    solve, u0 = ex.solver(n, dev)
    theta = torch.tensor(ex.THETA)
    jac = torch.func.jacfwd(solve)(theta).numpy()

    fwd, inv = ref_pair((n,) * 3)
    k2 = jnp.asarray(ex.wavenumbers(n))
    u0j = jnp.asarray(u0.numpy())

    def solve_j(p):
        g = jnp.exp(-p[0] * k2 * p[1])
        yr, yi = fwd(u0j)
        return inv((yr * g, yi * g))
    jj = np.asarray(jax.jacfwd(solve_j)(jnp.asarray(ex.THETA,
                                                    jnp.float32)))
    assert jac.shape == jj.shape == (n, n, n, 2)
    for col in range(2):
        assert rel(jac[..., col], jj[..., col]) < TOL, col


def test_fno_layer_step_gradient():
    ex = module("fno_layer")
    n, modes = 16, 4
    dev = torch.device("cpu")
    layer, x, y, _ = ex.setup(n, modes, dev)
    loss = ex.loss_of(layer, x, y)
    gr, gi = torch.autograd.grad(loss, (layer.wr, layer.wi))

    fwd, inv = ref_pair((n,) * 3, batch_dims=1)
    pad = [(0, n - modes), (0, n - modes), (0, n // 2 + 1 - modes)]
    xj, yj = jnp.asarray(x.numpy()), jnp.asarray(y.numpy())

    def conv(wr, wi):
        zr, zi = fwd(xj)
        fr, fi = jnp.pad(wr, pad), jnp.pad(wi, pad)
        return inv((zr * fr - zi * fi, zr * fi + zi * fr))

    def loss_j(wr, wi):
        r = conv(wr, wi) - yj
        return jnp.mean(r * r)
    w0 = jnp.zeros((modes,) * 3, jnp.float32)
    gjr, gji = jax.grad(loss_j, argnums=(0, 1))(w0, w0)
    assert rel(gr.numpy(), gjr) < TOL
    assert rel(gi.numpy(), gji) < TOL
    # y_train is the layer at the hidden weights, as the reference's
    (wr, wi), _ = ex.data(n, modes, dev)
    assert rel(y.numpy(), conv(jnp.asarray(wr), jnp.asarray(wi))) < TOL


def test_packed_spectral_filtered_field():
    ex = module("packed_spectral")
    shape = (8, 8, 256)
    got, want, x = ex.filtered(shape, torch.device("cpu"))

    fwd, inv = ref_pair(shape, packed=True)
    m = shape[2] // 2
    g = ex.gains(shape)
    g_body, g0, gm = (jnp.asarray(g[..., 1:m]), jnp.asarray(g[..., 0]),
                      jnp.asarray(g[..., m]))
    pr, pi = fwd(jnp.asarray(x))
    fr = pr.at[..., 1:].multiply(g_body)
    fi = pi.at[..., 1:].multiply(g_body)
    p = jax.lax.complex(pr[..., 0], pi[..., 0])
    rev = jnp.conj(jnp.roll(jnp.flip(p, axis=(-2, -1)), shift=(1, 1),
                            axis=(-2, -1)))
    pp = g0 * (0.5 * (p + rev)) + 1j * (gm * (-0.5j * (p - rev)))
    fr = fr.at[..., 0].set(jnp.real(pp))
    fi = fi.at[..., 0].set(jnp.imag(pp))
    ref = np.asarray(inv((fr, fi)))
    assert rel(got.numpy(), ref) < TOL
    assert rel(got.numpy(), want.numpy()) < TOL
    want_np = np.fft.irfftn(np.fft.rfftn(x.astype(np.float64)) * g,
                            s=shape, axes=(0, 1, 2))
    assert rel(got.numpy(), want_np) < TOL
