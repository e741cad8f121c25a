"""The register core's pass schedule, replayed with torch ops on the CPU.

``csrc/fft_regs.cuh`` runs a length-n row (n a power of two in
[16, 4096]) as radix-R Stockham passes on P = n / 16 threads of 16
complex values each. No CPU can run that kernel, so the tests hold this
replay of it against numpy and the JAX reference: the same pass radices
and strides (:func:`passes`), the same twiddle indices into the first n
rows of ``tables.core_table`` and the same input gathers and output
scatters (:func:`pass_maps`), and the same shared-memory geometry
(:func:`geometry`, :func:`phys`, with :func:`bank_ways` counting the
exchanges' bank conflicts). The butterflies are the R-point DFT in f32
(the kernel's radix-2 network computes the same function in another
rounding order). What the kernels do around the core only moves values:
``rfft_last`` stages a block's output rows back in the exchange planes to
copy them out whole, and ``fft_last`` moves rows of fewer than 8 threads
(N < 128) in and out through a stage; neither is replayed here. The
package's own routes never call this module: on the CPU the kernel
wrappers run their plain versions.
"""

from __future__ import annotations


import numpy as np
import torch

E = 16          # complex values a thread holds (regs::kE)
THREADS = 256   # threads per block (kThreads)
BANKS = 32      # 4-byte shared-memory banks


def passes(n: int) -> list[tuple[int, int]]:
    """(radix R, stride Ns) of each pass: radix 16 with the remainder
    last (n = 16 ... 16 * R_last), Ns = 16^pass."""
    if not (16 <= n <= 4096 and n & (n - 1) == 0):
        raise ValueError(f"the register core takes powers of two in "
                         f"[16, 4096], not {n}")
    log = n.bit_length() - 1
    npass = (log + 3) // 4
    rads = [16] * (npass - 1) + [1 << (log - 4 * (npass - 1))]
    return [(r, 16 ** p) for p, r in enumerate(rads)]


def phys(a):
    """Position of element a in a row's exchange plane (the pad that keeps
    the exchanges free of bank conflicts)."""
    return a + 4 * (a >> 5) + 16 * (a >> 8)


def geometry(n: int) -> dict:
    """The block geometry of ``regs::Geo``: threads per row P, rows per
    block, a row's floats per plane (SIZE, PITCH) and the block's dynamic
    shared memory in bytes."""
    passes(n)
    p = n // E
    size = phys(n - 1) + 1
    pitch = size
    if p < 32:
        want = max(p, 4)
        pitch = size + ((want - size) % 32 + 32) % 32
    rows = THREADS // p
    return {"P": p, "ROWS": rows, "SIZE": size, "PITCH": pitch,
            "SMEM": 2 * rows * pitch * 4}


def pass_maps(n: int, r: int, ns: int) -> tuple:
    """Index maps of one pass, each (n/R, R) over butterfly j and input or
    output r: the elements read (j + r n/R), the twiddle rows
    (r (j mod Ns) n/(Ns R)) and the elements written
    ((j div Ns) Ns R + j mod Ns + r Ns)."""
    nr = n // r
    j = torch.arange(nr)[:, None]
    k = torch.arange(r)[None, :]
    src = j + k * nr
    tw = k * (j % ns) * (n // (ns * r))
    dst = (j // ns) * ns * r + j % ns + k * ns
    return src, tw, dst


def _dft(r: int, inverse: bool) -> torch.Tensor:
    """F[r, k] = W_R^(r k) in complex64."""
    k = np.arange(r)
    sign = 1.0 if inverse else -1.0
    f = np.exp(sign * 2j * np.pi * np.outer(k, k) / r)
    return torch.from_numpy(f.astype(np.complex64))


def fft_rows(xr, xi, tab, inverse: bool = False, scale: float = 1.0):
    """The kernel's c2c of every (..., n) row of a planar f32 pair: its
    passes on the roots ``tab[:n]`` (a ``core_table`` of n, (re, im)
    rows), ``scale`` at the store."""
    n = xr.shape[-1]
    d = torch.complex(xr, xi).reshape(-1, n)
    w = torch.complex(tab[:n, 0], tab[:n, 1])
    for r, ns in passes(n):
        src, tw, dst = pass_maps(n, r, ns)
        v = d[:, src]
        if ns > 1:
            v = v * w[tw]
        y = v @ _dft(r, inverse)
        d = torch.empty_like(d)
        d[:, dst] = y
    d = (d * scale).reshape(xr.shape)
    return d.real.contiguous(), d.imag.contiguous()


def rfft_rows(x, tab, w, scale: float = 1.0, packed: bool = False):
    """The kernel's r2c of every real (..., 2M) row: the M-point core on
    v[j] = x[2j] + i x[2j+1], then the untangle of V in natural order
    (``w`` = ``tables.rfft_table(2M)``), ``scale`` at the store. The
    numpy (..., M + 1) layout, or the packed (..., M) one."""
    m = x.shape[-1] // 2
    v = x.reshape(*x.shape[:-1], m, 2)
    vr, vi = fft_rows(v[..., 0], v[..., 1], tab)
    k = torch.arange(m)
    mk = (-k) % m
    ar, ai, br, bi = vr, vi, vr[..., mk], vi[..., mk]
    er, ei = ar + br, ai - bi
    o_r, o_i = ar - br, ai + bi
    hs = 0.5 * scale
    yr = (er + w[:, 0] * o_i + w[:, 1] * o_r) * hs
    yi = (ei - w[:, 0] * o_r + w[:, 1] * o_i) * hs
    a, b = vr[..., 0], vi[..., 0]
    if packed:
        yr[..., 0], yi[..., 0] = (a + b) * scale, (a - b) * scale
        return yr, yi
    zero = torch.zeros_like(a)[..., None]
    yr = torch.cat([yr, ((a - b) * scale)[..., None]], -1)
    yi = torch.cat([yi, zero], -1)
    yr[..., 0], yi[..., 0] = (a + b) * scale, 0.0
    return yr, yi


def _ways(groups, banks: int = BANKS) -> int:
    """Shared-memory wavefronts of one warp instruction: over the groups
    of lanes served together, the most distinct addresses on one bank (one
    address read by several lanes is one broadcast)."""
    worst = 1
    for addrs in groups:
        per_bank: dict = {}
        for a in set(addrs):
            per_bank.setdefault(a % banks, set()).add(a)
        worst = max(worst, max(len(s) for s in per_bank.values()))
    return worst


def bank_ways(n: int) -> dict:
    """{(pass, "put" or "get"): the worst wavefronts per warp instruction}
    of the core's exchanges, from the block geometry and :func:`pass_maps`:
    the writes of each pass but the last (16-byte stores on the first
    pass, served by quarter-warps on the 8 groups of 4 banks; scalar by
    whole warps after it) and the reads of each pass but the first. 1
    means free of bank conflicts."""
    g = geometry(n)
    p, pitch = g["P"], g["PITCH"]
    lanes = np.arange(THREADS)
    row, t = lanes // p, lanes % p
    out = {}
    sched = passes(n)
    for i, (r, ns) in enumerate(sched):
        nb = E // r
        if i > 0:
            out[(i, "get")] = max(
                _ways((row * pitch + phys(t + q * p + k * (n // r)))
                      .reshape(-1, 32).tolist())
                for q in range(nb) for k in range(r))
        if i < len(sched) - 1:
            worst = 1
            for q in range(nb):
                j = t + q * p
                d = (j // ns) * ns * r + j % ns
                if ns == 1:
                    for k in range(0, r, 4):
                        chunk = (row * pitch + phys(d + k)) // 4
                        worst = max(worst, _ways(chunk.reshape(-1, 8)
                                                 .tolist(), BANKS // 4))
                else:
                    for k in range(r):
                        a = row * pitch + phys(d + k * ns)
                        worst = max(worst, _ways(a.reshape(-1, 32).tolist()))
            out[(i, "put")] = worst
    return out


def flops(n: int) -> int:
    """f32 operations of the core on one row, from the schedule: each
    radix-R butterfly's network (4 per radix-2 step; a rotation by W^0 or
    -+i costs nothing, by (1 -+ i)/sqrt 2 four, by any other root six)
    and a complex multiply (6) per twiddled input."""
    total = 0
    for r, ns in passes(n):
        net, half = 0, r // 2
        while half >= 1:
            for i in range(half):
                k = i * (8 // half)
                rot = 0 if k in (0, 4) else 4 if k in (2, 6) else 6
                net += (r // (2 * half)) * (4 + rot)
            half //= 2
        total += (n // r) * (net + (6 * (r - 1) if ns > 1 else 0))
    return total
