"""Mixed-radix 1-D FFT as a chain of dense DFT products, and Bluestein.

Counterpart of ``offt_tpu/kernels/stockham.py``, the unfused engine: it
serves what no kernel expresses (a prime factor above 128, anywhere
Bluestein's chirp-z), the fp64 route (complex128, the 1e-12 bar) and
plans with ``use_pallas=0``. On complex tensors, for N = r * m:

    y[k1, n2]  = sum_n1 F_r[k1, n1] * x[n1 * m + n2]      (one product)
    y[k1, n2] *= W_N^(k1 * n2)                             (twiddle)
    z[k1, k2]  = fft_m(y[k1, :])                           (recurse)
    X[k2 * r + k1] = z[k1, k2]                             (transpose)

The stage products are plain large matrix products, which the reference
leaves to XLA outside any Pallas kernel, so here they are
``torch.einsum`` (cuBLAS on the card). The tables are ``tables.dft_table``,
``stage_twiddle``, ``bluestein_chirp`` and ``bluestein_spectrum``, in the
data's complex type, read from a ``TableSet`` so that a plan holds them as
buffers.

``precision`` is accepted for parity and ignored: the reference pins
"highest" per product because a TPU f32 product defaults to one bf16
pass. Torch has only the process-wide switch: a complex64 product on the
card runs in full f32 while ``torch.backends.cuda.matmul.allow_tf32`` is
False (its default); with TF32 on, the chain misses the 1e-6 bar.
"""

from __future__ import annotations

import torch

from . import dft, fourstep
from . import fused_fft as ff
from . import tables as tb


def _complex_dtype(dtype: torch.dtype) -> torch.dtype:
    """The transform's complex type: complex64 and complex128 stay,
    float64 gives complex128, every other type complex64."""
    if dtype in (torch.complex64, torch.complex128):
        return dtype
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _table(tables, x, kind: str, *args):
    """One complex table of ``kind`` in x's complex type, beside x."""
    name = str(x.dtype).rsplit(".", 1)[-1]
    if kind == "twiddle":
        args = (*args[:2], name, args[2])
    else:
        args = (args[0], name, args[1])
    tab = ff._tables(tables, x.device).get(kind, *args)
    return ff._on(tab, x)


def _fft_last(x, radices: tuple, inverse: bool, tables=None):
    """FFT along the last axis; its length is prod(radices). No 1/N."""
    n = x.shape[-1]
    if n == 1:
        return x
    if len(radices) == 1:
        return torch.einsum("kn,...n->...k",
                            _table(tables, x, "dft", n, inverse), x)
    r, rest = radices[0], radices[1:]
    m = n // r
    x = x.reshape(*x.shape[:-1], r, m)
    y = torch.einsum("kn,...nm->...km", _table(tables, x, "dft", r, inverse),
                     x)
    y = y * _table(tables, x, "twiddle", r, m, inverse)
    z = _fft_last(y, rest, inverse, tables)
    return z.transpose(-1, -2).reshape(*z.shape[:-2], n)   # X[k2 r + k1]


def _inner_kernel(m: int) -> str | None:
    """Which kernel route takes a complex64 length-m inner transform:
    "pallas" (the 2-stage kernels), "four_step", or None."""
    if ff.can_use_pallas(m):
        return "pallas"
    if fourstep.can_use_four_step(m):
        return "four_step"
    return None


def bluestein_rides_kernels(n: int) -> bool:
    """True when a length-n transform takes Bluestein and its inner
    power-of-two length has a kernel route."""
    return (any(r > dft.MAX_RADIX for r in dft.factorize(n))
            and _inner_kernel(tb.bluestein_length(n)) is not None)


def _bluestein_last(x, inverse: bool, precision=None, use_pallas=False,
                    tables=None):
    """Any-length FFT along the last axis by chirp-z (Bluestein): a
    length-m circular convolution, m the least power of two >= 2n - 1.

    For complex64 data on a plan with its kernels on (``use_pallas``) the
    two inner transforms ride the kernels: the 2-stage core
    (``fft_1d_planar``) while m passes ``can_use_pallas``, the four-step
    pair (``fft_four_step_planar``) past it; else the matmul chain. The
    reference keys this on its stacked precision names, which only its
    kernel-enabled plans carry; the port's precision is always
    "highest", so it keys on ``use_pallas`` itself."""
    n = x.shape[-1]
    m = tb.bluestein_length(n)
    a = _table(tables, x, "chirp", n, inverse)
    bf = _table(tables, x, "chirp_fft", n, inverse)
    xa = x.new_zeros((*x.shape[:-1], m))
    xa[..., :n] = x * a
    route = _inner_kernel(m) if use_pallas else None
    if x.dtype == torch.complex64 and route is not None:
        def inner(v, inv):
            vr, vi = v.real.contiguous(), v.imag.contiguous()
            if route == "pallas":     # scale=True: the inverse has its 1/m
                yr, yi = ff.fft_1d_planar(vr, vi, -1, inverse=inv,
                                          precision=precision or "highest",
                                          tables=tables)
            else:
                yr, yi = fourstep.fft_four_step_planar(
                    vr, vi, inverse=inv, precision=precision or "highest",
                    tables=tables)
            return torch.complex(yr, yi)

        y = inner(inner(xa, False) * bf, True)
        return y[..., :n] * a
    rad = dft.factorize(m)
    y = _fft_last(_fft_last(xa, rad, False, tables) * bf, rad, True,
                  tables) / m
    return y[..., :n] * a


def fft_1d(x, axis: int = -1, inverse: bool = False, radices=None,
           precision: str | None = None, use_pallas: bool = False,
           tables=None):
    """1-D FFT along ``axis`` of a tensor, complex out: ``numpy.fft.fft``
    forward, ``numpy.fft.ifft`` (scaled by 1/N) inverse. complex64 and
    complex128 keep their type, float64 gives complex128, other types
    complex64. ``radices`` overrides the stage factorization (their
    product must be N); a length with a factor past 128 takes Bluestein.
    ``use_pallas`` lets Bluestein's inner transforms ride the kernels
    (``_bluestein_last``); ``tables`` is a ``TableSet``."""
    x = x.to(_complex_dtype(x.dtype))
    axis = axis % x.ndim
    n = x.shape[axis]
    if axis != x.ndim - 1:
        x = x.movedim(axis, -1)
    if radices is not None:
        rad = dft.validate_factorization(n, radices)
    else:
        rad = dft.factorize(n)
    if all(r <= dft.MAX_RADIX for r in rad):
        out = _fft_last(x, rad, inverse, tables)
    else:
        out = _bluestein_last(x, inverse, precision, use_pallas, tables)
    if inverse:
        out = out / n
    if axis != x.ndim - 1:
        out = out.movedim(-1, axis)
    return out


def fft(x, axis: int = -1, radices=None):
    return fft_1d(x, axis=axis, inverse=False, radices=radices)


def ifft(x, axis: int = -1, radices=None):
    return fft_1d(x, axis=axis, inverse=True, radices=radices)
