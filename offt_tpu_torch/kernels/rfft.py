"""Real-input (r2c) and real-output (c2r) 1-D transforms along the last
axis, as torch ops around an injected inner c2c.

Counterpart of ``offt_tpu/kernels/rfft.py`` on planar data: a length-N
real transform is one length-N/2 complex transform of the packed
samples v[j] = x[2j] + i x[2j+1] plus an O(N) untangle (plain torch ops,
as the reference's are plain JAX). Odd N falls back to a full-length c2c.
The untangle twiddles are ``tables.half_twiddles`` (the reference's
``_half_twiddles``), read from a ``TableSet`` in the data's precision:
float32 pairs for float32 data, float64 pairs for the fp64 route, which
so never reads an f32 table.

``fft_fn(vr, vi, inverse) -> (yr, yi)`` is the inner c2c along the last
axis of planar float32 (or float64) pairs, with numpy fft/ifft semantics
(the plan passes ``dist.pencil.axis_fft``).
"""

from __future__ import annotations

import torch

from . import fused_fft as ff


def _planar(c):
    return c.real.contiguous(), c.imag.contiguous()


def _half(tables, data, n: int, inverse: bool):
    """W^k, k = 0..n/2, as a complex tensor beside ``data``, in its
    precision (complex128 for float64 or complex128 data)."""
    wide = data.dtype in (torch.float64, torch.complex128)
    tab = ff._tables(tables, data.device).get(
        "half", n, inverse, "float64" if wide else "float32")
    return torch.view_as_complex(ff._on(tab, data))


def rfft_1d(x, fft_fn, tables=None):
    """Forward r2c along the last axis: real float32 or float64 (..., N)
    -> planar pair of that type (..., N//2 + 1), matching
    ``numpy.fft.rfft``. Even N runs the
    packed half-length transform and the untangle; odd N a full c2c,
    sliced."""
    n = x.shape[-1]
    if n % 2 or n < 2:
        xr = x.contiguous()
        yr, yi = fft_fn(xr, torch.zeros_like(xr), False)
        m1 = n // 2 + 1
        return yr[..., :m1].contiguous(), yi[..., :m1].contiguous()
    vr, vi = fft_fn(x[..., 0::2].contiguous(), x[..., 1::2].contiguous(),
                    False)
    vf = torch.complex(vr, vi)
    # V[(M - k) mod M] and V[k], k = 0..M (two wrap-around entries)
    vrev = torch.cat([vf[..., :1], vf[..., 1:].flip(-1), vf[..., :1]], -1)
    vf1 = torch.cat([vf, vf[..., :1]], -1)
    xe = 0.5 * (vf1 + vrev.conj())
    xo = -0.5j * (vf1 - vrev.conj())
    return _planar(xe + _half(tables, x, n, False) * xo)


def irfft_1d(xr, xi, n: int | None, fft_fn, tables=None):
    """Inverse c2r along the last axis: planar pair (..., N//2 + 1) ->
    real (..., N) of the pair's type, matching ``numpy.fft.irfft``
    (Hermitian input assumed; scaled by 1/N through the inner inverse)."""
    nf = xr.shape[-1]
    n = n if n is not None else 2 * (nf - 1)
    x = torch.complex(xr, xi)
    if n % 2 or n < 2:
        # rebuild the full spectrum and run a c2c inverse
        tail = x[..., 1:n - nf + 1].flip(-1).conj()
        full = torch.cat([x[..., :nf], tail], -1)
        yr, _ = fft_fn(*_planar(full), True)
        return yr.contiguous()
    if nf != n // 2 + 1:
        raise ValueError(f"expected {n // 2 + 1} frequency bins, got {nf}")
    m = n // 2
    xrev = x.flip(-1).conj()          # conj X[M - k], k = 0..M
    xe = 0.5 * (x + xrev)
    xo = 0.5 * (x - xrev) * _half(tables, x, n, True)
    v = (xe + 1j * xo)[..., :m]
    vr, vi = fft_fn(*_planar(v), True)
    return torch.stack([vr, vi], -1).reshape(*vr.shape[:-1], n)
