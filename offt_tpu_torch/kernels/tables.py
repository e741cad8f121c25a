"""Radix picks and the f32 constant tables of the kernel core.

Ports from ``offt_tpu/kernels/pallas_fft.py``: ``_fold_complex`` (:104),
the unstacked branch of ``_pick_2stage`` (:268), ``_pick_stages`` (:487)
and the f32 tables of ``_core_tables`` (:394). The stacked bf16 tables of
the reference are MXU emulations and have no counterpart here: every
stage computes in f32.

Table layout (one float32 array of shape ``(n + sum(stages), 2)``, rows
are (re, im) pairs):

- rows ``[0, n)``: the roots ``W_n^m``. The inter-stage twiddle of stage
  ``s`` (remaining length ``L``) is ``W_L^(k j) = root[k * j * (n / L)]``.
- then, for each stage ``s`` of radix ``r``, ``r`` rows ``W_r^m``: the
  stage's dense DFT is ``F[k, i] = W_r^((i k) mod r)``. The last stage's
  rows carry ``scale``, so a norm factor or 1/N costs no extra pass
  (the reference folds it into its twiddle table instead; either way it
  is applied exactly once per element).

The values are built in float64 with the same formula as
``dft.dft_matrix`` and cast once, so ``W_r^m`` equals
``dft.dft_matrix(r)[1, m]`` exactly.

The r2c / c2r path adds two diagonal tables (:func:`rfft_table`,
:func:`crfft_table`). The reference also builds dense (2M, 2M) untangle
matrices and a "dual transform" because Mosaic has no reversal
primitive; a CUDA block reads ``V[(M - k) mod M]`` from shared memory
directly, so the diagonals serve every M.

The axis-by-axis route adds the four-step twiddle
(:func:`fourstep_twiddle`, ``fourstep._twiddle_planar``; the distributed
engine one rank's columns of it, :func:`fourstep_twiddle_chunk`, and of
its real untangle, :func:`untangle_chunk`) and the
half-spectrum twiddles of the unfused r2c/c2r (:func:`half_twiddles`,
``rfft._half_twiddles``), both in the kernels' (re, im) pair layout.

The unfused engine (``stockham.py``) reads complex tables, complex64 or
complex128 by the data: the dense DFT matrices (:func:`dft_table`), the
inter-stage twiddles (:func:`stage_twiddle`) and Bluestein's chirp and
chirp spectrum (:func:`bluestein_chirp`, :func:`bluestein_spectrum`).
"""

from __future__ import annotations

import functools
import math

import numpy as np

from . import dft


def _fold_complex(f: np.ndarray) -> np.ndarray:
    """Real block matrix G = [[Fr, -Fi], [Fi, Fr]], so that
    G @ [re; im] == [Re(F@x); Im(F@x)]: one real matmul per complex stage
    (the plain versions' stage product)."""
    top = np.concatenate([f.real, -f.imag], axis=1)
    bot = np.concatenate([f.imag, f.real], axis=1)
    return np.concatenate([top, bot], axis=0)


def _pick_2stage(n: int, radices=None) -> tuple[int, int] | None:
    """(r1, r2) with both <= MAX_RADIX, or None if not expressible.

    The default is ``dft.factorize``; a 1-stage length comes back as
    (r, 1). Picking radices for Hopper is later work."""
    if radices is not None:
        if len(radices) == 2 and all(r <= dft.MAX_RADIX for r in radices):
            return int(radices[0]), int(radices[1])
        if len(radices) == 1 and radices[0] <= dft.MAX_RADIX:
            return int(radices[0]), 1
        return None
    rad = dft.factorize(n)
    if len(rad) == 1 and rad[0] <= dft.MAX_RADIX:
        return int(rad[0]), 1
    if len(rad) == 2:
        return int(rad[0]), int(rad[1])
    return None


def _pick_stages(n: int, radices=None):
    """Radix stages for the core: an explicit 1-3 stage tuple (3-stage
    requires every radix in [2, LOOP_MAX_RADIX]), else the 2-stage pick."""
    if radices is not None:
        rad = tuple(int(r) for r in radices)
        prod = 1
        for r in rad:
            prod *= r
        if prod != n or len(rad) > 3 or any(r > dft.MAX_RADIX for r in rad):
            return None
        if len(rad) == 3 and (max(rad) > dft.LOOP_MAX_RADIX or min(rad) < 2):
            return None
        return rad
    return _pick_2stage(n, None)


def core_stages(radices) -> tuple[int, ...]:
    """The stages the kernels run: the radices without unit factors (a
    length-1 axis keeps one radix-1 stage, which applies the scale)."""
    return tuple(int(r) for r in radices if int(r) > 1) or (1,)


def core_pos(n: int, stages: tuple) -> np.ndarray:
    """Tile position of each natural output index after the in-place core
    (``core_pos`` in csrc/fft_core.cuh): kn = k1 + r1*k2 + r1*r2*k3 sits
    at (k1*r2 + k2)*r3 + k3."""
    r = tuple(stages) + (1,) * (3 - len(stages))
    kn = np.arange(n)
    k1 = kn % r[0]
    k2 = (kn // r[0]) % r[1]
    k3 = kn // (r[0] * r[1])
    return (k1 * r[1] + k2) * r[2] + k3


def _roots(n: int, inverse: bool) -> np.ndarray:
    """W_n^m for m < n in complex128, the formula of dft.dft_matrix."""
    m = np.arange(n, dtype=np.float64)
    ang = (2.0 * math.pi / n) * m
    return np.cos(ang) + (1j if inverse else -1j) * np.sin(ang)


@functools.lru_cache(maxsize=256)
def core_table(n: int, radices: tuple, inverse: bool,
               scale: float = 1.0) -> np.ndarray:
    """The f32 table of one length-n core (layout in the module doc).
    Read-only: the cached array is shared by every caller."""
    stages = core_stages(radices)
    if math.prod(stages) != n:
        raise ValueError(f"radices {radices} do not factor N={n}")
    parts = [_roots(n, inverse)]
    for s, r in enumerate(stages):
        w = _roots(r, inverse)
        parts.append(w * scale if s == len(stages) - 1 else w)
    c = np.concatenate(parts)
    out = np.stack([c.real, c.imag], axis=-1).astype(np.float32)
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=64)
def rfft_table(n: int) -> np.ndarray:
    """The r2c untangle twiddles ``W_n^k = exp(-2i pi k / n)`` for
    k < M = n/2, as an (M, 2) f32 array of (re, im): the values of the
    reference's ``_rfft_tables`` (pallas_fft.py:1631). Read-only."""
    k = np.arange(n // 2, dtype=np.float64)
    ang = 2.0 * np.pi * k / n
    out = np.stack([np.cos(ang), -np.sin(ang)], axis=-1).astype(np.float32)
    out.flags.writeable = False
    return out


@functools.lru_cache(maxsize=64)
def crfft_table(n: int, scale: float = 1.0) -> np.ndarray:
    """The c2r re-tangle of a packed half-spectrum X (plane 0 carries
    A + iB with A = X[0], B = X[M]) as an (M, 2, 2) f32 array: row k holds
    (alpha'[k], beta'[k]) as (re, im) pairs, each times ``scale``, and

        V[k] = alpha'[k] X[k] + beta'[k] conj(X[(M - k) mod M])

    with alpha' = (1 + i W_n^-k)/2 and beta' = (1 - i W_n^-k)/2. Row 0 is
    alpha' = 0, beta' = (1 + i)/2, which gives the packed rule
    V[0] = s((A + B)/2 + i(A - B)/2). This is the diagonal form of the
    reference's ``_crfft_g_matrix`` (:1839) and ``_crfft_dual_tables``
    (:1779). Read-only."""
    m = n // 2
    th = 2.0 * np.pi * np.arange(m) / n
    ar, ai = (1.0 - np.sin(th)) * 0.5, np.cos(th) * 0.5
    br, bi = (1.0 + np.sin(th)) * 0.5, -np.cos(th) * 0.5
    ar[0], ai[0], br[0], bi[0] = 0.0, 0.0, 0.5, 0.5
    out = np.stack([np.stack([ar, ai], -1), np.stack([br, bi], -1)], 1)
    out = (out * scale).astype(np.float32)
    out.flags.writeable = False
    return out


def _pairs(c: np.ndarray, dtype=np.float32) -> np.ndarray:
    """A complex128 array as read-only (..., 2) (re, im) pairs of
    ``dtype`` (f32 by default), each part cast once."""
    out = np.stack([c.real.astype(dtype), c.imag.astype(dtype)], axis=-1)
    out.flags.writeable = False
    return out


def fourstep_twiddle(n1: int, n2: int, inverse: bool,
                     scale: float = 1.0) -> np.ndarray:
    """The four-step twiddle T[k1, j2] = W_n^(k1 j2) * scale, n = n1 n2,
    as an (n1, n2, 2) f32 array: ``dft.twiddles`` in f64 times the scale,
    cast once, so each part is bit-equal to the reference's
    ``fourstep._twiddle_planar`` pair. Read-only. Not memoised: it is as
    large as the data (128 MB at 2^24), and a plan keeps its device copy."""
    return _pairs(dft.twiddles(n1, n2, np.complex128, inverse) * scale)


def fourstep_twiddle_chunk(n1: int, n2: int, lo: int, hi: int,
                           inverse: bool, scale: float = 1.0,
                           dtype: str = "float32") -> np.ndarray:
    """Columns ``[lo, hi)`` of the four-step twiddle, (n1, hi - lo, 2) of
    ``dtype`` (float64 for the fp64 route): one rank's chunk in the
    distributed engine (``dist/long1d.py``), which never builds the whole
    (n1, n2) table. The float32 chunk equals the same columns of
    :func:`fourstep_twiddle` bit for bit (the same f64 formula on the
    same (k1, j2), cast once)."""
    n = n1 * n2
    k1 = np.arange(n1, dtype=np.float64)
    j2 = np.arange(lo, hi, dtype=np.float64)
    ang = (2.0 * math.pi / n) * np.mod(np.outer(k1, j2), float(n))
    t = np.cos(ang) + (1j if inverse else -1j) * np.sin(ang)
    return _pairs(t * scale, np.dtype(dtype))


@functools.lru_cache(maxsize=64)
def untangle_chunk(n: int, lo: int, hi: int,
                   dtype: str = "float32") -> np.ndarray:
    """W_n^k = exp(-2i pi k / n) for k in ``[lo, hi)`` as (hi - lo, 2)
    pairs of ``dtype``: one rank's chunk of the distributed real
    transform's untangle twiddle (the reference's ``u_host``,
    ``offt_tpu/dist/long1d.py:258-261``, the same expression). Read-only."""
    k = np.arange(lo, hi, dtype=np.float64)
    return _pairs(np.exp(-2j * np.pi * k / n), np.dtype(dtype))


@functools.lru_cache(maxsize=64)
def half_twiddles(n: int, inverse: bool, dtype: str = "float32") -> np.ndarray:
    """W^k = exp(-+2i pi k / n) for k = 0..n/2 as an (n/2 + 1, 2) array of
    ``dtype`` (float32, or float64 for the fp64 route): the reference's
    ``rfft._half_twiddles`` (f64-generated, cast once) in the pair layout.
    Read-only."""
    k = np.arange(n // 2 + 1, dtype=np.float64)
    ang = 2.0 * math.pi * k / n
    return _pairs(np.cos(ang) + (1j if inverse else -1j) * np.sin(ang),
                  np.dtype(dtype))


# ---- the unfused engine's complex tables (kernels/stockham.py) -----------
# complex64 or complex128 by ``dtype``, built in f64 and cast once; each
# the value of the reference's table of the same name, bit for bit.

def _readonly(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


@functools.lru_cache(maxsize=256)
def dft_table(n: int, dtype: str, inverse: bool) -> np.ndarray:
    """The dense (n, n) DFT matrix (``dft.dft_matrix``). Read-only."""
    return _readonly(dft.dft_matrix(n, np.dtype(dtype), inverse))


@functools.lru_cache(maxsize=16)
def stage_twiddle(r: int, m: int, dtype: str, inverse: bool) -> np.ndarray:
    """The (r, m) inter-stage twiddle W_{rm}^(k1 j) (``dft.twiddles``).
    Read-only."""
    return _readonly(dft.twiddles(r, m, np.dtype(dtype), inverse))


def bluestein_length(n: int) -> int:
    """The convolution length of Bluestein's algorithm: the least power
    of two >= 2n - 1."""
    m = 1
    while m < 2 * n - 1:
        m *= 2
    return m


@functools.lru_cache(maxsize=16)
def _bluestein(n: int, dtype: str, inverse: bool) -> tuple:
    """The chirp a_k = exp(-+i pi k^2 / n) and the spectrum of the padded
    conjugate chirp (the reference's ``stockham._bluestein_tables``; the
    spectrum is a constant table, so numpy's f64 FFT builds it)."""
    m = bluestein_length(n)
    k = np.arange(n, dtype=np.float64)
    ang = math.pi * np.mod(k * k, 2.0 * n) / n   # k^2 mod 2n for accuracy
    a = np.cos(ang) + (1.0 if inverse else -1.0) * 1j * np.sin(ang)
    b = np.zeros(m, dtype=np.complex128)
    b[:n] = np.conj(a)
    b[m - n + 1:] = np.conj(a[1:][::-1])
    dt = np.dtype(dtype)
    return _readonly(a.astype(dt)), _readonly(np.fft.fft(b).astype(dt))


def bluestein_chirp(n: int, dtype: str, inverse: bool) -> np.ndarray:
    return _bluestein(n, dtype, inverse)[0]


def bluestein_spectrum(n: int, dtype: str, inverse: bool) -> np.ndarray:
    return _bluestein(n, dtype, inverse)[1]
