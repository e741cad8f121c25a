"""DFT matrices, twiddle factors and radix factorization (numpy, f64-built).

Port of ``offt_tpu/kernels/dft.py``. Every table is generated in float64
and cast once, so fp32 transforms keep ~1e-7 twiddle accuracy. The
functions return the same values as the reference's, bit for bit.
"""

from __future__ import annotations

import functools
import math

import numpy as np

# Largest radix realized as one dense DFT stage.
MAX_RADIX = 128

# Radix ceiling for 3-stage kernel cores (the reference's loop-core bound;
# plan feasibility mirrors it so the same radix tuples are legal in both).
LOOP_MAX_RADIX = 32


def _prime_factors(n: int) -> list[int]:
    """Prime factorization of n (ascending)."""
    fs = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            fs.append(d)
            n //= d
        d += 1 if d == 2 else 2
    if n > 1:
        fs.append(n)
    return fs


@functools.lru_cache(maxsize=None)
def factorize(n: int, max_radix: int = MAX_RADIX) -> tuple[int, ...]:
    """Factor n into radices, each <= max_radix, product == n.

    First minimize the stage count, then balance the radices (largest
    prime first into the smallest bucket that fits): 256 -> (16, 16),
    512 -> (32, 16). Primes above max_radix are left in the list."""
    if n <= 0:
        raise ValueError(f"FFT length must be positive, got {n}")
    if n == 1:
        return (1,)
    primes = _prime_factors(n)
    big = [p for p in primes if p > max_radix]
    rest = [p for p in primes if p <= max_radix]
    if not rest:
        return tuple(sorted(big, reverse=True))
    prod = 1
    for p in rest:
        prod *= p
    k = 1
    while max_radix ** k < prod:
        k += 1
    for _ in range(len(rest)):  # k may be infeasible for awkward primes
        buckets = [1] * k
        ok = True
        for p in sorted(rest, reverse=True):
            cands = [i for i in range(k) if buckets[i] * p <= max_radix]
            if not cands:
                ok = False
                break
            tgt = min(cands, key=lambda i: buckets[i])
            buckets[tgt] *= p
        if ok:
            return tuple(sorted(buckets, reverse=True)) + tuple(
                sorted(big, reverse=True))
        k += 1
    raise AssertionError("unreachable: k == len(primes) always feasible")


def validate_factorization(n: int, radices) -> tuple[int, ...]:
    """Check a user- or tuner-supplied radix list: its product is n.
    (A radix past MAX_RADIX is let through, as in the reference: the
    unfused engine then takes Bluestein.)"""
    prod = 1
    for r in radices:
        prod *= r
    if prod != n:
        raise ValueError(f"radices {radices} do not multiply to {n}")
    return tuple(radices)


def dft_matrix(n: int, dtype, inverse: bool = False) -> np.ndarray:
    """Dense DFT matrix in the requested complex dtype (no 1/n scaling)."""
    k = np.arange(n, dtype=np.float64)
    kj = np.mod(np.outer(k, k), float(n))
    ang = (2.0 * math.pi / n) * kj
    m = np.cos(ang) + (1j if inverse else -1j) * np.sin(ang)
    return m.astype(dtype)


def twiddles(n1: int, n2: int, dtype, inverse: bool = False) -> np.ndarray:
    """Four-step twiddle table T[k1, n2] = exp(-+2i pi k1 n2 / (n1 n2))."""
    n = n1 * n2
    k1 = np.arange(n1, dtype=np.float64)
    j2 = np.arange(n2, dtype=np.float64)
    kj = np.mod(np.outer(k1, j2), float(n))
    ang = (2.0 * math.pi / n) * kj
    t = np.cos(ang) + (1j if inverse else -1j) * np.sin(ang)
    return t.astype(dtype)
