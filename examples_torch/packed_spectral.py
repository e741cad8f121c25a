"""Spectral filtering in the packed half-spectrum layout (one card).

The port of examples/packed_spectral.py. The packed half-spectrum
(``plan(..., packed=True)``) keeps the frequency axis at exactly
M = Nz/2 lanes: plane 0 carries X_0 + i X_M. A spectral pipeline
r2c -> multiply -> c2r never needs the numpy (..., M + 1) layout; the
only care point is plane 0, where the two packed planes need different
filter values g(., ., 0) and g(., ., M):

    A = (P + conj(P[-kx, -ky])) / 2        # the spectrum's plane k = 0
    B = (P - conj(P[-kx, -ky])) / 2i       # the spectrum's plane k = M
    P' = g0 * A + i * gM * B               # re-packed, filtered plane 0

Planes 1..M-1 multiply pointwise. On the card the r2c and c2r are the
packed route's kernels (``rfft_slab``, ``irfft_slab``, the strided x
pass).

Run:  python examples_torch/packed_spectral.py           (the card, 8x8x256)
      python examples_torch/packed_spectral.py --device cpu
      python examples_torch/packed_spectral.py --nxy 256   (256^3)
"""

from __future__ import annotations

import numpy as np
import torch

from _common import device, norm2, parser, tensor

SIGMA = 12.0    # the low-pass width, in integer modes


def gains(shape) -> np.ndarray:
    """g(k) = exp(-|k|^2 / (2 sigma^2)) on the (nx, ny, M + 1) numpy
    half-spectrum, k in integer modes."""
    nx, ny, n = shape
    kx = np.fft.fftfreq(nx) * nx
    ky = np.fft.fftfreq(ny) * ny
    kz = np.arange(n // 2 + 1)
    return np.exp(-(kx[:, None, None] ** 2 + ky[None, :, None] ** 2
                    + kz[None, None, :] ** 2)
                  / (2 * SIGMA ** 2)).astype(np.float32)


def lowpass_fn(shape, dev):
    """x -> the low-passed x, never leaving the packed layout."""
    import offt_tpu_torch as ot

    g = gains(shape)
    m = shape[2] // 2
    fwd = ot.plan(shape, "float32", real=True, planar=True, packed=True,
                  device=dev)
    inv = ot.plan(shape, "float32", real=True, inverse=True, planar=True,
                  packed=True, device=dev)
    g_body = tensor(g[..., 1:m], dev)
    g0 = tensor(g[..., 0], dev)
    gm = tensor(g[..., m], dev)

    def lowpass(x):
        pr, pi = fwd(x)
        # planes 1..M-1: pointwise
        fr = torch.cat([pr[..., :1], pr[..., 1:] * g_body], -1)
        fi = torch.cat([pi[..., :1], pi[..., 1:] * g_body], -1)
        # plane 0: unpack, filter with g0 and gM, repack
        p = torch.complex(pr[..., 0], pi[..., 0])
        rev = torch.roll(torch.flip(p, (-2, -1)), (1, 1), (-2, -1)).conj()
        a = 0.5 * (p + rev)
        b = -0.5j * (p - rev)
        pp = g0 * a + 1j * (gm * b)
        fr[..., 0] = pp.real
        fi[..., 0] = pp.imag
        return inv(fr, fi)
    return lowpass


def filtered(shape, dev, seed: int = 0):
    """(the port's low-passed field, the same through float64
    ``torch.fft``, the input as numpy)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    xt = tensor(x, dev)
    got = lowpass_fn(shape, dev)(xt)
    want = torch.fft.irfftn(torch.fft.rfftn(xt.double())
                            * tensor(gains(shape), dev), s=shape)
    return got, want, x


def main(argv=None) -> int:
    ns = parser(__doc__, n=256, nxy=8).parse_args(argv)
    shape = (ns.nxy, ns.nxy, ns.n)
    got, want, _ = filtered(shape, device(ns.device))
    err = (norm2(got - want) / norm2(want)) ** 0.5
    print(f"packed spectral low-pass: shape={shape} rel_err={err:.3e}")
    assert err < 1e-5, err
    print("OK — the half-spectrum never left the packed M-lane layout")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
