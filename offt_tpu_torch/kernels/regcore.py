"""The register core's pass schedule, replayed with torch ops on the CPU.

``csrc/fft_regs.cuh`` runs a length-n line (n a power of two in
[16, 4096]) as radix-R Stockham passes on P = n / 16 threads of 16
complex values each, as a contiguous row (``fft_last``, ``rfft_last``,
the slabs' z pass, the c2r rows of ``irfft_slab`` and ``icrfft_last``)
or, in its column variant, along a strided axis (``fft_axis``, the
slabs' y pass); both also run the mixed lengths n = R0 2^k (R0 = 3,
5; ``fused_fft._MIX_LENGTHS``, and 3072 as rows,
``fused_fft._MIX_ROW_LENGTHS``) on P = n / (4 R0) threads of 4 R0
values each (``fused_fft._reg_values``), the last pass of radix 12 or 20
the kernel's Good-Thomas network (:func:`dft_pfa`, replayed with its
constant roots), the rows' exchange planes swizzled (:func:`mix_at`,
:func:`row_mask`; :func:`rows_mix_block` replays a block of them through
the addresses the kernel computes, :func:`fft_last` a batch; the r2c and
c2r rows at those lengths, ``csrc/real_rows_mix.cu``, block by block in
:func:`rfft_rows_mix_block` and :func:`rows_c2r_mix_block`, their
addresses :func:`r2c_mix_addrs`, :func:`c2r_mix_loads`,
:func:`stage_pitch` and the output copy at a pitch :func:`r2c_mix_copy`,
their banks :func:`r2c_mix_ways`); and the smooth lengths R 2^k (R = 9,
15, 25, 45, k >= 3, ``fused_fft._SMOOTH_LENGTHS``; and the second family,
every other R = 3^a 5^b > 1 with k >= 2,
``fused_fft._SMOOTH_MORE_LENGTHS``; ``csrc/fft_smooth.cuh``) on
P = n / 12 or n / 20 threads, not a power of two, a radix-3 or radix-5
pass for each further odd factor (:func:`smooth_schedule`; a radix-5
pass at 12 values and a radix-3 pass at 20 masked); and the third
family, the odd and twice-odd lengths R 2^k, k = 0, 1
(``fused_fft._SMOOTH_ODD_LENGTHS``), on P = n / V0 threads, V0 = 2^k d
(``fused_fft._smooth_odd_values``), the last pass of radix V0 on the
kernel's Good-Thomas or Cooley-Tukey network (:func:`_net_split`); and
the fourth, the lengths R 2^k, k >= 2, with a factor 7
(``fused_fft._SMOOTH7_LENGTHS``, c2c only), V0 = 4 R0 with R0 of 3, 5 or
7 (``fused_fft._smooth7_values``), radix-7 passes on :func:`_dft7` and
the Good-Thomas 7 x 4 network of :func:`dft_pfa` at V0 = 28; a
block of rows or
of columns replayed through its exchange planes
(:func:`smooth_rows_block`, :func:`smooth_cols_block`,
:func:`smooth_addr`, :func:`smooth_geometry`; the rows' pitch
:func:`smooth_row_pitch`, ``SMOOTH_ROW_PITCH`` and
``SMOOTH_ODD_ROW_PITCH``, the columns' pad :func:`smooth_col_pad`), its
banks :func:`smooth_ways` and their cost over a line
:func:`smooth_exchange_cost`; the r2c and c2r rows at the half lengths
of the three families (``csrc/real_rows_smooth.cu``, the first;
``csrc/real_rows_smooth3.cu``, ``real_rows_smooth5.cu``, the second;
``csrc/real_rows_smooth_odd3.cu``, ``real_rows_smooth_odd5.cu``, the
third, whose odd M untangle their last pairs on one masked step)
block by block in :func:`rfft_rows_smooth_block` and
:func:`rows_c2r_smooth_block` (rows of fewer than 6 threads staged
through the planes, in and out, :func:`smooth_stage_addrs`), their
addresses :func:`r2c_smooth_addrs`, :func:`c2r_smooth_loads` and
:func:`stage_pitch` (a pitch of P mod 32, M + 1 at P = 1, where P mod
32 took three wavefronts), their banks
:func:`r2c_smooth_ways` and :func:`smooth_stage_ways`. No CPU can run those kernels, so the tests hold
this replay of them against numpy and the JAX
reference: the same pass radices and strides (:func:`passes`), the same
twiddle indices into the first n rows of ``tables.core_table`` and the
same input gathers and output scatters (:func:`pass_maps`), and the same
shared-memory geometry of rows (:func:`geometry`, :func:`row_at`) and
columns (:func:`col_geometry`, :func:`col_at`), with :func:`bank_ways`
and :func:`col_bank_ways` counting the exchanges' bank conflicts; the
strided-axis kernel's lane tiles (:func:`axis_tile`, :func:`warp_runs`;
the routed one read from ``fused_fft._axis_tile``); and the slab a
cluster of blocks holds in shared memory (:func:`cluster_geometry`,
:func:`cluster_ways`); and the operation count (:func:`flops`). The
power-of-two butterflies are the R-point DFT in f32 (the kernel's
radix-2 network computes the same function in another rounding order).
The kernels on
the column variant are replayed as their grids run: :func:`fft_axis`
(tile by tile on the (B, N, Y, Z) geometry), :func:`fft_slab` (z rows,
then y columns in place), :func:`rfft_slab` (r2c rows at the slab's
pitch, then y columns) and :func:`irfft_slab` (y columns, the side plane
added as lane 0 loads, then the c2r rows, :func:`rows_c2r`, with the
kernel's re-tangle :func:`retangle_pair`), each at a mixed length on its
mixed rows and on the strided-axis kernel's tiles;
and the four-step pair: :func:`step1_twiddle` (the column variant tile
by tile, :func:`step1_tile`, the twiddle at the store) and
:func:`step3_transposed` (rows block by block into the swizzled stage of
:func:`step3_geometry` / :func:`step3_at`, then the transposed runs,
:func:`step3_runs`, its banks counted by :func:`step3_ways`), both also
at the mixed lengths of ``fused_fft._MIX_LENGTHS``
(``csrc/fourstep_mix.cu``: step 1 on the mixed schedule and the lane
tile the strided-axis kernel takes there; step 3's rows through the
mixed rows' swizzled planes, :func:`rows_mix_block`, R a block); and
the register cube (``csrc/fft_cube_regs.cu``): :func:`fft_cube` replays
its phases group by group (:func:`cube_geometry`: G cubes a phase, the
split z of :func:`cube_split`, the barriers).
What the kernels do around the core only moves values: ``rfft_last``
at a power of two stages a block's output rows back in the exchange
planes to copy them out whole, ``fft_last`` moves rows of fewer than 8
threads (N < 128) in and out through a stage, and the cluster layouts
move lines between blocks; none of that is replayed here. The
package's own routes never call this module: on the CPU the kernel
wrappers run their plain
versions.
"""

from __future__ import annotations

import numpy as np
import torch

from . import fused_fft

E = 16          # complex values a thread holds (regs::kE)
THREADS = 256   # threads per block (kThreads)
BANKS = 32      # 4-byte shared-memory banks


def passes(n: int) -> list[tuple[int, int]]:
    """(radix R, stride Ns) of each pass. At a power of two: radix 16 with
    the remainder last (n = 16 ... 16 * R_last), Ns = 16^pass. At a mixed
    length R0 2^k (``MixGeo``): radix 4 over P = n / (4 R0), a radix 2
    last where log2 P is odd, then radix 4 R0 at stride P; at a smooth
    length R 2^k of either family (``SmoothGeo``, :func:`smooth_schedule`):
    radix 4 over 2^(k-2) (a radix 2 last where k is odd), radix 3 or 5 for
    each odd factor of R / R0, then radix V0 = 4 R0 at stride P (at a
    length with a factor 7 also radix 7, and V0 = 28); Ns = the product of
    the radices before."""
    if n in fused_fft._SMOOTH_C2C:
        return [(r, ns) for r, ns, _ in smooth_schedule(n)]
    if n in fused_fft._MIX_ROW_LENGTHS:
        p = n // fused_fft._reg_values(n)
        lp = p.bit_length() - 1
        rads = [4] * (lp // 2) + [2] * (lp % 2) + [fused_fft._reg_values(n)]
    elif 16 <= n <= 4096 and n & (n - 1) == 0:
        log = n.bit_length() - 1
        npass = (log + 3) // 4
        rads = [16] * (npass - 1) + [1 << (log - 4 * (npass - 1))]
    else:
        raise ValueError(f"the register core takes powers of two in "
                         f"[16, 4096], the mixed lengths 3 2^k, 5 2^k "
                         f"(16 <= 2^k <= 512; 3072 as rows) and the smooth "
                         f"ones R 2^k (R = 3^a 5^b; k >= 2), not {n}")
    out, ns = [], 1
    for r in rads:
        out.append((r, ns))
        ns *= r
    return out


def smooth_schedule(n: int, v0: int | None = None
                    ) -> list[tuple[int, int, int]]:
    """(radix R, stride Ns, butterflies B a thread) of each pass of the
    smooth core at n = R_odd 2^k (``regs::SmoothGeo``). At k >= 2: V0 =
    4 R0 (``fused_fft._smooth_values``: R0 = 5 where 25 divides R_odd or
    3 does not, else 3; ``v0`` counts the other choice where R0 = 3 and 5
    both divide R_odd), P = n / V0 threads a line; radix 4 over 2^(k-2)
    (none at k = 2, a radix 2 last where k is odd), then one pass of
    radix R0 for each factor R0 of R_odd / R0, then one of the other
    prime for each of its factors, then V0 at stride P. At k = 0, 1 (the
    odd and twice-odd lengths): V0 = 2^k d (``fused_fft._smooth_odd_values``,
    or ``v0``: any 2^k d with d of 3, 5, 9, 15, 25 dividing R_odd), no
    radix-4 pass, then one pass per prime factor of R_odd / d in the same
    order (R0 = ``regs::smooth_r0``'s first), then V0 at stride P. B =
    ceil(n / (R P)) = ceil(V0 / R): V0 / R but where R does not divide V0
    (a radix-5 pass at V0 = 12, 6, 9, 18; a radix-3 pass at V0 = 20, 5,
    10, 25: the last butterfly masked where t + (B - 1) P >= n / R). At
    the lengths with a factor 7 (the fourth family, k >= 2,
    ``fused_fft._smooth7_values``, or ``v0``: 4 R0 for any R0 of 3, 5, 7
    dividing R_odd) the same, the odd passes R0's first, then the other
    primes' in ascending order (``SmoothGeo``'s PA, PB): a radix-7 pass at
    V0 = 12 or 20, and a radix-3 or radix-5 pass at V0 = 28, masked."""
    if n not in fused_fft._SMOOTH_C2C:
        raise ValueError(f"{n} is not a smooth length of the register core")
    odd = fused_fft._odd_part(n)
    k = (n // odd).bit_length() - 1
    v0 = v0 or fused_fft._smooth_values(n)
    two = 4 if k >= 2 else 1 << k           # V0's power of two
    d = v0 // two
    if v0 != two * d or odd % d or d not in (
            (3, 5, 7) if k >= 2 else (3, 5, 9, 15, 25)):
        raise ValueError(f"no radix {v0} at n = {n}")
    r0 = d if k >= 2 else 5 if odd % 25 == 0 or odd % 3 else 3
    p = n // v0
    rest, odd_passes = odd // d, []
    for r in (r0, *(q for q in (3, 5, 7) if q != r0)):
        while rest % r == 0:
            odd_passes.append(r)
            rest //= r
    rads = ([4] * ((k - 2) // 2) + [2] * ((k - 2) % 2) if k >= 2 else []) \
        + odd_passes + [v0]
    out, ns = [], 1
    for r in rads:
        out.append((r, ns, -(-n // (r * p))))
        ns *= r
    return out


def phys(a):
    """Position of element a in a row's exchange plane (the pad that keeps
    the exchanges free of bank conflicts)."""
    return a + 4 * (a >> 5) + 16 * (a >> 8)


def mix_at(a):
    """The mixed rows' swizzle of element a (``regs::MixRowGeo::at``): bit 5
    of a flips bits 2 and 4 (XOR 20), bit 6 flips bits 3 and 4 (XOR 24).
    It permutes each aligned run of 32 slots and keeps runs of four whole,
    and it is linear over XOR: mix_at(x ^ c) = mix_at(x) ^ mix_at(c), so an
    exchange address is the thread's swizzled base XOR a compile-time
    constant."""
    return a ^ (20 * ((a >> 5) & 1)) ^ (24 * ((a >> 6) & 1))


def row_mask(n: int, g):
    """The XOR that row g of a block adds to its swizzled offsets at a mixed
    length n (``MixRowGeo::row_mask``): none where a row takes a warp or
    more (P >= 32); where W = 32 / P rows share a warp, bit i of g (of
    log2 W) flips the bits of 4 (7 - log2 W + i), the columns (4, 5, 6) of
    the element's bits 5 and 6 and one more: 24 g at P = 16; 20 g0 ^ 24 g1
    at 8; 16 g0 ^ 20 g1 ^ 24 g2 at 4."""
    p = n // fused_fft._reg_values(n)
    m = 0 * g
    if p < 32:
        nb = (32 // p).bit_length() - 1
        for i in range(nb):
            m = m ^ (((g >> i) & 1) * 4 * (7 - nb + i))
    return m


def geometry(n: int) -> dict:
    """The block geometry of the row layout: threads per row P, rows per
    block, a row's floats per plane (SIZE, PITCH), values a thread V and
    the block's dynamic shared memory in bytes. At a power of two
    ``regs::Geo`` (the pad phys, rows sharing a warp P banks apart); at a
    mixed length ``regs::MixRowGeo`` (no pad: the swizzle :func:`mix_at`
    and :func:`row_mask`, rows at a pitch of a multiple of 32)."""
    passes(n)
    v = fused_fft._reg_values(n)
    p = n // v
    rows = THREADS // p
    if n in fused_fft._SMOOTH_C2C:
        return smooth_geometry(n)
    if n in fused_fft._MIX_ROW_LENGTHS:
        pitch = -(-n // 32) * 32
        return {"P": p, "ROWS": rows, "SIZE": n, "PITCH": pitch, "V": v,
                "SMEM": 2 * rows * pitch * 4}
    size = phys(n - 1) + 1
    pitch = size
    if p < 32:
        want = max(p, 4)
        pitch = size + ((want - size) % 32 + 32) % 32
    return {"P": p, "ROWS": rows, "SIZE": size, "PITCH": pitch, "V": v,
            "SMEM": 2 * rows * pitch * 4}


def row_at(n: int, a, g=0):
    """Offset of element a of row g in a block's exchange plane: g PITCH
    plus phys(a) at a power of two, plus mix_at(a) ^ row_mask(g) at a mixed
    length, plus a at a smooth length (no pad: the pitch,
    :func:`smooth_row_pitch`, carries the bank shift)."""
    pitch = geometry(n)["PITCH"]
    if n in fused_fft._SMOOTH_C2C:
        return g * pitch + a
    if n in fused_fft._MIX_ROW_LENGTHS:
        return g * pitch + (mix_at(a) ^ row_mask(n, g))
    return g * pitch + phys(a)


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


# the constant roots of regs::dft3 / dft5 / dft7, in f32
_SIN3 = np.float32(0.86602540378443865)
_C51, _C52 = np.float32(0.30901699437494742), np.float32(-0.80901699437494742)
_S51, _S52 = np.float32(0.95105651629515357), np.float32(0.58778525229247313)
_C7 = [np.float32(np.cos(2 * np.pi * j / 7)) for j in range(4)]
_S7 = [np.float32(np.sin(2 * np.pi * j / 7)) for j in range(4)]


def _mul_i(d, inverse: bool):
    """d times -i (forward) or +i (inverse), as ``regs::mul_i``."""
    return d * (1j if inverse else -1j)


def _dft3(a, b, c, inverse: bool):
    """``regs::dft3``: X1, X2 = a - (b + c)/2 -+ i sin(2 pi/3) (b - c)."""
    s, d = b + c, b - c
    m = a - 0.5 * s
    e = _mul_i(_SIN3 * d, inverse)
    return a + s, m + e, m - e


def _dft5(x0, x1, x2, x3, x4, inverse: bool):
    """``regs::dft5``, on the constant roots of 2 pi/5 and 4 pi/5."""
    t1, t2, t3, t4 = x1 + x4, x2 + x3, x1 - x4, x2 - x3
    a1 = x0 + _C51 * t1 + _C52 * t2
    a2 = x0 + _C52 * t1 + _C51 * t2
    e1 = _mul_i(_S51 * t3 + _S52 * t4, inverse)
    e2 = _mul_i(_S52 * t3 - _S51 * t4, inverse)
    return x0 + t1 + t2, a1 + e1, a2 + e2, a2 - e2, a1 - e1


def _dft7(x0, x1, x2, x3, x4, x5, x6, inverse: bool):
    """``regs::dft7``, on the constant roots of 2 pi j/7 (c_j, s_j): t_j,
    d_j = x_j +- x_(7-j); X_k, X_(7-k) = a_k -+ i b_k (forward), a_k = x0 +
    sum_j cos(2 pi j k/7) t_j, b_k = sum_j sin(2 pi j k/7) d_j."""
    t1, t2, t3 = x1 + x6, x2 + x5, x3 + x4
    d1, d2, d3 = x1 - x6, x2 - x5, x3 - x4
    c1, c2, c3 = _C7[1:]
    s1, s2, s3 = _S7[1:]
    a1 = x0 + c1 * t1 + c2 * t2 + c3 * t3
    a2 = x0 + c2 * t1 + c3 * t2 + c1 * t3
    a3 = x0 + c3 * t1 + c1 * t2 + c2 * t3
    e1 = _mul_i(s1 * d1 + s2 * d2 + s3 * d3, inverse)
    e2 = _mul_i(s2 * d1 - s3 * d2 - s1 * d3, inverse)
    e3 = _mul_i(s3 * d1 - s1 * d2 + s2 * d3, inverse)
    return (x0 + t1 + t2 + t3, a1 + e1, a2 + e2, a3 + e3, a3 - e3, a2 - e2,
            a1 - e1)


# the odd-prime networks by radix
_NETS = {3: _dft3, 5: _dft5, 7: _dft7}


def dft_pfa(v, inverse: bool = False):
    """The R-point DFT along the last axis, R = 4 R0 (12, 20, 28), as
    ``regs::dft_pfa`` (and ``regs::dft28``) composes it (Good-Thomas, no
    twiddles): input n = (4 n1 + R0 n2) mod R; R0-point DFTs along n1,
    then 4-point DFTs along n2 in place; X[k] read where k mod R0 and k
    mod 4 left it."""
    r = v.shape[-1]
    r0 = r // 4
    if r not in (12, 20, 28):
        raise ValueError(f"no Good-Thomas network of radix {r}")
    x = list(v.unbind(-1))
    net = _NETS[r0]
    for n2 in range(4):
        idx = [(r0 * n2 + 4 * n1) % r for n1 in range(r0)]
        for i, o in zip(idx, net(*(x[i] for i in idx), inverse)):
            x[i] = o
    for k1 in range(r0):
        idx = [(4 * k1 + r0 * n2) % r for n2 in range(4)]
        u = torch.stack([x[i] for i in idx], -1) @ _dft(4, inverse)
        for i, o in zip(idx, u.unbind(-1)):
            x[i] = o
    return torch.stack([x[(4 * (k % r0) + r0 * (k % 4)) % r]
                        for k in range(r)], -1)


def _root(m: int, r: int, inverse: bool):
    """W_r^m in the transform's direction, rounded to f32 as the kernel's
    compile-time constant (``regs::root_c``)."""
    a = 2 * np.pi * (m % r) / r
    return complex(np.float32(np.cos(a)),
                   np.float32(np.sin(a) if inverse else -np.sin(a)))


def _net_split(x: list, r: int, inverse: bool) -> list:
    """``regs::dft_smooth``'s network of a composite radix r (6, 9, 10, 15,
    18, 25, 30) on the list x of r tensors: r = a b, a the least prime
    factor; where b is coprime to a Good-Thomas (``dft_gt``: a-point
    networks along n1 at the inputs (b n1 + a n2) mod r, then b-point
    ones, X[k] where k mod a and k mod b left it, no twiddle), else
    Cooley-Tukey (``dft_ct``: a-point networks at b n1 + n2, the
    constant twiddles W_r^(n2 k1), b-point networks at b k1 + n2, X[k1 +
    a k2] at b k1 + k2)."""
    if r in (2, 3, 4, 5):
        if r == 2:
            return [x[0] + x[1], x[0] - x[1]]
        if r == 4:
            return list((torch.stack(x, -1) @ _dft(4, inverse)).unbind(-1))
        return list((_dft3 if r == 3 else _dft5)(*x, inverse))
    a = next(q for q in (2, 3, 5) if r % q == 0)
    b = r // a
    x = list(x)
    if b % a:
        for n2 in range(b):
            idx = [(b * n1 + a * n2) % r for n1 in range(a)]
            for i, o in zip(idx, _net_split([x[i] for i in idx], a,
                                            inverse)):
                x[i] = o
        for k1 in range(a):
            idx = [(b * k1 + a * n2) % r for n2 in range(b)]
            for i, o in zip(idx, _net_split([x[i] for i in idx], b,
                                            inverse)):
                x[i] = o
        return [x[(b * (k % a) + a * (k % b)) % r] for k in range(r)]
    for n2 in range(b):
        idx = [b * n1 + n2 for n1 in range(a)]
        for i, o in zip(idx, _net_split([x[i] for i in idx], a, inverse)):
            x[i] = o
    for k1 in range(1, a):
        for n2 in range(1, b):
            x[b * k1 + n2] = x[b * k1 + n2] * _root(n2 * k1, r, inverse)
    for k1 in range(a):
        idx = [b * k1 + n2 for n2 in range(b)]
        for i, o in zip(idx, _net_split([x[i] for i in idx], b, inverse)):
            x[i] = o
    return [x[b * (k % a) + k // a] for k in range(r)]


def _net(v, r: int, inverse: bool):
    """The kernel's r-point network along the last axis: Good-Thomas at 12,
    20 and 28, ``regs::dft3`` / ``dft5`` / ``dft7`` at 3, 5 and 7
    (constant roots), the composite radices of the odd and twice-odd
    smooth lengths (6, 9, 10, 15, 18, 25, 30) by :func:`_net_split`, the
    DFT in f32 at a power of two."""
    if r in (12, 20, 28):
        return dft_pfa(v, inverse)
    if r in (3, 5, 7):
        return torch.stack(_NETS[r](*v.unbind(-1), inverse), -1)
    if r & (r - 1):
        return torch.stack(_net_split(list(v.unbind(-1)), r, inverse), -1)
    return v @ _dft(r, inverse)


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
        y = _net(v, r, inverse)
        d = torch.empty_like(d)
        d[:, dst] = y
    d = (d * scale).reshape(xr.shape)
    return d.real.contiguous(), d.imag.contiguous()


def _butterflies(v, n: int, r: int, ns: int, t, p: int, w,
                 inverse: bool) -> None:
    """Pass (r, ns) on every thread's butterflies j = t + q P, in place on
    v (threads, V), inputs v[:, q r + k] = element j + k n/r: input k > 0
    times W_n^(k (j mod ns) n/(ns r)) (``w`` the n roots), then the r-point
    network."""
    for q in range(v.shape[1] // r):
        blk = v[:, q * r:(q + 1) * r]
        if ns > 1:
            j = t + q * p
            blk = blk * w[torch.arange(r)[None, :]
                          * ((j % ns) * (n // (ns * r)))[:, None]]
        v[:, q * r:(q + 1) * r] = _net(blk, r, inverse)


def _mix_threads(n: int, threads: int = THREADS) -> tuple:
    """Row g and index t in it of each thread of a block of the mixed rows
    of ``threads`` threads (thread tid: g = tid // P, t = tid % P)."""
    tid = torch.arange(threads)
    p = geometry(n)["P"]
    return tid // p, tid % p


def mix_loads(n: int, threads: int = THREADS):
    """The elements the threads of a block of the mixed rows load, in the
    order of their loads: (threads, V), thread (g, t)'s element e = t +
    q P + k n/R of its row (q < V/R, k < R), R the first pass's radix."""
    p, nv = geometry(n)["P"], geometry(n)["V"]
    r, _ = passes(n)[0]
    _, t = _mix_threads(n, threads)
    return torch.stack([t + q * p + k * (n // r)
                        for q in range(nv // r) for k in range(r)], 1)


def _mix_core(n: int, v0, tab, inverse: bool = False,
              threads: int = THREADS):
    """``regs::core_mix_rows`` on one block of the mixed rows as it runs
    (a block of ``threads`` threads, ``threads`` / P rows, each in its own
    planes at the pitch of :func:`geometry`): thread (g, t) holds ``v0``
    (threads, V) complex64, the elements :func:`mix_loads` gives it, runs
    the first pass, then for each later
    pass puts the outputs into the block's exchange plane and gets the
    inputs back at the addresses the kernel computes: the thread's
    swizzled base mix_at(X) ^ row_mask(g), X the part of the element its t
    sets, XOR mix_at(C) of the compile-time part C (put: X = (t div Ns) Ns
    R + t mod Ns, C = q P R + k Ns; get: X = t, C = P (q + k V/R)).
    Returns v (threads, V): v[:, k] the output element t + k P of the
    thread's row."""
    geo = geometry(n)
    p, pitch, nv = geo["P"], geo["PITCH"], geo["V"]
    sched = passes(n)
    g, t = _mix_threads(n, threads)
    gm = row_mask(n, g)
    w = torch.complex(tab[:n, 0], tab[:n, 1])
    v = v0.to(torch.complex64).clone()
    r, _ = sched[0]
    _butterflies(v, n, r, 1, t, p, w, inverse)
    plane = torch.full((threads // p * pitch,), complex("nan"),
                       dtype=torch.complex64)
    for (rp, nsp), (r, ns) in zip(sched, sched[1:]):
        base = mix_at((t // nsp) * nsp * rp + t % nsp) ^ gm
        for q in range(nv // rp):
            for k in range(rp):
                a = g * pitch + (base ^ mix_at(q * p * rp + k * nsp))
                plane[a] = v[:, q * rp + k]
        base = mix_at(t) ^ gm
        for q in range(nv // r):
            for k in range(r):
                a = g * pitch + (base ^ mix_at(p * (q + k * (nv // r))))
                v[:, q * r + k] = plane[a]
        _butterflies(v, n, r, ns, t, p, w, inverse)
    return v


def rows_mix_block(x, tab, inverse: bool = False):
    """One block of ``regs::rows_mix`` as it runs, at a mixed length n:
    ``x`` the block's rows (rows, n) complex64 (rows past the batch zero;
    ROWS of them in ``rows_mix``'s 256 threads, R in a block of step 3's
    ``rows_transposed_mix``, :func:`step3_geometry`), thread (g, t) =
    (tid // P, tid % P) of row g, the passes of :func:`_mix_core`.
    Returns the (rows, n) output, element t + k P from the last pass's
    v[k]."""
    rows, n = x.shape
    geo = geometry(n)
    threads = rows * geo["P"]
    g, t = _mix_threads(n, threads)
    v = _mix_core(n, x[g[:, None], mix_loads(n, threads)], tab, inverse,
                  threads)
    out = torch.empty(rows, n, dtype=torch.complex64)
    for k in range(geo["V"]):
        out[g, t + k * geo["P"]] = v[:, k]
    return out


def stage_pitch(m: int) -> int:
    """Floats a row of the r2c rows' output stage takes: at a mixed M
    (``regs::rows_r2c_mix``, ``MixRealGeo::SPITCH``) M + 1 (the numpy row)
    where a row takes a warp or more, else the least pitch of at least
    M + 1 that is P mod 32, so rows sharing a warp are P banks apart; at a
    smooth M of any of the three families (``rows_r2c_smooth``,
    ``SmoothRealGeo::SPITCH``, ``regs::smooth_stage_pitch``) the least
    pitch of at least M + 1 that is P mod 32 at every P (rows straddle
    warps wherever 32 does not divide P), but M + 1, the planes' pitch,
    at P = 1 (12, 20, 18, 25, 30: 256 rows a block; P mod 32 = 1 took
    three wavefronts a copy at 12 and a stage of 33 floats a row at 20,
    every M of both earlier families counted by :func:`r2c_smooth_ways`
    at each residue, ``tests/test_torch_regsmoothmorereal.py``)."""
    p = geometry(m)["P"]
    if m in fused_fft._SMOOTH_CORE:
        if p == 1:
            return m + 1
        return m + 1 + (p % 32 - (m + 1)) % 32
    if p >= 32:
        return m + 1
    return m + 1 + (p % 32 - (m + 1)) % 32


def smooth_real_smem(m: int) -> int:
    """Bytes of dynamic shared memory a block of the smooth r2c rows takes
    (``SmoothRealGeo::SMEM``): both planes of every row at the larger of
    the rows' pitch and :func:`stage_pitch`, the output stage overlaying
    the exchange planes once the untangle has read them."""
    g = smooth_geometry(m)
    return 2 * g["ROWS"] * max(g["PITCH"], stage_pitch(m)) * 4


def r2c_mix_addrs(m: int) -> dict:
    """The shared-memory float addresses of ``regs::rows_r2c_mix`` at a
    mixed M after its core, each (256, K) over the block's threads (row g
    at g PITCH in the exchange plane, at g ``stage_pitch`` in the stage):
    ``put`` the natural-order write of element t + r P (r < V), at the
    swizzled base mix_at(t) ^ row_mask(g) XOR mix_at(r P); the untangle's
    reads of the pairs (k, M - k), k = t + i P (i < V/2, ``k``): ``lo``
    V[k] at the base XOR mix_at(i P), ``hi`` V[M - k] at mix_at(M - k) ^
    row_mask(g) (the k = 0 entry unread: thread 0 of a row takes the packed
    lane from V[0] alone); ``mid`` (256,) thread 0's V[M/2]; the stage
    writes ``st_lo`` of X[k] and ``st_hi`` of X[M - k]."""
    geo = geometry(m)
    p, pitch, nv = geo["P"], geo["PITCH"], geo["V"]
    g, t = _mix_threads(m)
    gm = row_mask(m, g)
    row = g * pitch
    xb = mix_at(t) ^ gm
    put = torch.stack([row + (xb ^ mix_at(r * p)) for r in range(nv)], 1)
    i = torch.arange(nv // 2)
    k = t[:, None] + p * i[None, :]
    lo = row[:, None] + (xb[:, None] ^ mix_at(p * i)[None, :])
    hi = row[:, None] + (mix_at((m - k) % m) ^ gm[:, None])
    s = stage_pitch(m)
    return {"put": put, "k": k, "lo": lo, "hi": hi,
            "mid": row + (mix_at(m // 2) ^ gm),
            "st_lo": g[:, None] * s + k, "st_hi": g[:, None] * s + (m - k)}


def _untangle(a, b, wk, wm, hs):
    """``regs::untangle_at`` in its order of f32 operations: X[k] and
    X[M - k] from a = V[k], b = V[M - k], wk = w[k], wm = w[M - k] ((..., 2)
    f32) and hs = scale / 2."""
    ar, ai, br, bi = a.real, a.imag, b.real, b.imag
    er, ei = ar + br, ai - bi
    o_r, o_i = ar - br, ai + bi
    xk = torch.complex((er + wk[..., 0] * o_i + wk[..., 1] * o_r) * hs,
                       (ei - wk[..., 0] * o_r + wk[..., 1] * o_i) * hs)
    xmk = torch.complex((er + wm[..., 0] * o_i - wm[..., 1] * o_r) * hs,
                        (-ei + wm[..., 0] * o_r + wm[..., 1] * o_i) * hs)
    return xk, xmk


def r2c_mix_copy(m: int, lanes: int, opitch: int, rows: int | None = None,
                 block: int = 0) -> tuple:
    """The copy out of the r2c rows' stage at a mixed M
    (``regs::rows_r2c_mix``, ``copy_rows_out``) or a smooth one
    (``rows_r2c_smooth``, ``copy_smooth_rows_out``), in the kernel's
    order: float i of the block's first
    ``rows`` rows (default ROWS) of ``lanes`` lanes each, row r = i div
    lanes, lane c = i mod lanes, read at r ``stage_pitch`` + c and
    written at (row0 + r) ``opitch`` + c of the output, row0 = ``block``
    ROWS. Returns (stage, out) address tensors over i (consecutive threads
    on consecutive i)."""
    rows = geometry(m)["ROWS"] if rows is None else rows
    i = torch.arange(rows * lanes)
    r = i // lanes
    c = i - r * lanes
    row0 = block * geometry(m)["ROWS"]
    return r * stage_pitch(m) + c, (row0 + r) * opitch + c


def rfft_rows_mix_block(x, tab, w, scale: float = 1.0, packed: bool = False,
                        rows: int | None = None, opitch: int | None = None):
    """One block of ``regs::rows_r2c_mix`` as it runs, at a mixed M: ``x``
    the block's ROWS real rows (ROWS, 2M) f32 (rows past the batch zero),
    thread (g, t) of row g. Its core (:func:`_mix_core`) on v[j] =
    x[2j] + i x[2j+1], V put in natural order into the exchange plane, the
    pairs (k, M - k) read back and untangled times ``scale`` (``w`` =
    ``tables.rfft_table(2M)``), staged, and the first ``rows`` rows
    (default all) copied out in the kernel's order, each the numpy
    (M + 1) or packed (M) lanes at ``opitch`` floats a row (default the
    lanes), every address :func:`r2c_mix_addrs`'s and
    :func:`r2c_mix_copy`'s. Returns the planar pair (rows, opitch), the
    lanes past the numpy or packed ones NaN (never written)."""
    m = x.shape[-1] // 2
    g, t = _mix_threads(m)
    e, gr = mix_loads(m), g[:, None]
    v = _mix_core(m, torch.complex(x[gr, 2 * e], x[gr, 2 * e + 1]), tab)
    return _r2c_block(m, v, r2c_mix_addrs(m), g, t, w, scale, packed, rows,
                      opitch)


def _r2c_block(m: int, v, ad: dict, g, t, w, scale: float, packed: bool,
               rows, opitch):
    """The r2c rows' block after its core, at a mixed or a smooth M: V
    (thread (g, t)'s v[:, r] the element t + r P) put into the exchange
    plane, the pairs (k, M - k) read back and untangled times ``scale``,
    staged and the first ``rows`` rows copied out at ``opitch``, every
    address ``ad``'s (:func:`r2c_mix_addrs`, :func:`r2c_smooth_addrs`)
    and :func:`r2c_mix_copy`'s."""
    geo = geometry(m)
    nrows, pitch = geo["ROWS"], geo["PITCH"]
    rows = nrows if rows is None else rows
    plane = torch.full((nrows * pitch,), complex("nan"), dtype=torch.complex64)
    for r in range(ad["put"].shape[1]):
        plane[ad["put"][:, r]] = v[:, r]
    k = ad["k"]
    first = k == 0                       # thread 0 of a row, i = 0
    live = ad.get("live", torch.ones_like(first))
    hs = torch.tensor(0.5 * scale, dtype=torch.float32)
    s32 = torch.tensor(scale, dtype=torch.float32)
    a = plane[ad["lo"]]
    b = plane[torch.where(first, ad["lo"], ad["hi"])]
    lo, hi = _untangle(a, b, w[k], w[(m - k) % m], hs)
    v0r, v0i = a.real, a.imag
    zero = torch.zeros_like(v0r)
    lo0 = torch.complex((v0r + v0i) * s32,
                        (v0r - v0i) * s32 if packed else zero)
    hi0 = torch.complex((v0r - v0i) * s32, zero)
    lo = torch.where(first, lo0, lo)
    hi = torch.where(first, hi0, hi)
    sp = stage_pitch(m)
    st = torch.full((nrows * sp,), complex("nan"), dtype=torch.complex64)
    st[ad["st_lo"][live]] = lo[live]
    keep = (~first if packed else torch.ones_like(first)) & live
    st[ad["st_hi"][keep]] = hi[keep]
    if "mid" in ad:                      # an even M: thread 0's M/2
        am = plane[ad["mid"]]
        _, mid = _untangle(am, am, w[m // 2], w[m // 2], hs)
        st[(g * sp + m // 2)[t == 0]] = mid[t == 0]
    lanes = m if packed else m + 1
    opitch = lanes if opitch is None else opitch
    src, dst = r2c_mix_copy(m, lanes, opitch, rows)
    nan = float("nan")
    out = torch.full((rows * opitch,), complex(nan, nan),
                     dtype=torch.complex64)
    out[dst] = st[src]
    out = out.reshape(rows, opitch)
    return out.real.contiguous(), out.imag.contiguous()


def r2c_mix_ways(m: int) -> dict:
    """The worst wavefronts a warp instruction of ``regs::rows_r2c_mix``
    at a mixed M takes beyond its core's exchanges (:func:`bank_ways`),
    from :func:`r2c_mix_addrs`: the natural-order ``put``, the untangle's
    reads ``lo`` and ``hi`` (the lanes that take them: thread 0 of a row
    reads no ``hi`` at i = 0) and ``mid`` (thread 0 of each row), the
    stage writes ``st_lo`` and ``st_hi``, and the copy out of the stage in
    each layout (``copy numpy``, ``copy packed``: 32 consecutive floats of
    the block's output a warp)."""
    ad = r2c_mix_addrs(m)
    _, t = _mix_threads(m)
    ways = _r2c_ways(ad, t)
    rows, sp = geometry(m)["ROWS"], stage_pitch(m)
    for name, lanes in (("copy numpy", m + 1), ("copy packed", m)):
        i = torch.arange(rows * lanes)
        r = i // lanes
        a = r * sp + (i - r * lanes)
        pad = (-a.numel()) % 32
        a = torch.cat([a, a[:pad]])       # the last warp's idle lanes
        ways[name] = _ways(a.reshape(-1, 32).tolist())
    return ways


def _worst_ways(addr, live=None) -> int:
    """The worst wavefronts of the warp instructions of ``addr`` (threads,
    K): each column one instruction, each warp 32 consecutive threads (the
    last one short where 32 does not divide the block), ``live`` the lanes
    that take it."""
    live = torch.ones_like(addr, dtype=torch.bool) if live is None else live
    out = 1
    for j in range(addr.shape[1]):
        a, ok = addr[:, j], live[:, j]
        out = max(out, _ways([a[w:w + 32][ok[w:w + 32]].tolist()
                              for w in range(0, a.shape[0], 32)]))
    return out


def _r2c_ways(ad: dict, t) -> dict:
    """The wavefronts of an r2c block's natural-order ``put``, untangle
    reads ``lo``, ``hi`` (not thread 0's at k = 0) and ``mid`` (thread 0
    of each row, at an even M) and stage writes, from its addresses
    ``ad``, each over the lanes that take the pair (``live``)."""
    first = ad["k"] == 0
    live = ad.get("live", torch.ones_like(first))
    ways = {"put": _worst_ways(ad["put"])}
    for name in ("lo", "st_lo", "st_hi"):
        ways[name] = _worst_ways(ad[name], live)
    ways["hi"] = _worst_ways(ad["hi"], ~first & live)
    if "mid" in ad:
        ways["mid"] = _worst_ways(ad["mid"][:, None], (t == 0)[:, None])
    return ways


def c2r_mix_loads(m: int) -> tuple:
    """The input lanes ``regs::rows_c2r_mix`` reads at a mixed M, each
    (256, V) over the block's threads in the order of their loads: element
    e of the thread's row (:func:`mix_loads`) and its re-tangle partner
    e ? M - e : 0."""
    e = mix_loads(m)
    return e, torch.where(e == 0, 0, m - e)


def rows_c2r_mix_block(xr, xi, tab, ab):
    """One block of ``regs::rows_c2r_mix`` as it runs, at a mixed M:
    ``(xr, xi)`` the block's ROWS packed planar rows (ROWS, M) (rows past
    the batch zero); each thread re-tangles element e of its row as it
    loads it, from the lanes :func:`c2r_mix_loads` gives (e and
    e ? M - e : 0), with ``ab`` (``tables.crfft_table``, the scale folded
    in) in the kernel's f32 order (:func:`_retangle`), runs the inverse
    core (:func:`_mix_core`) and stores x[2j] + i x[2j+1] = v[j]. Returns
    the real (ROWS, 2M) rows."""
    m = xr.shape[-1]
    geo = geometry(m)
    g, t = _mix_threads(m)
    e, pe = c2r_mix_loads(m)
    gr = g[:, None]
    yr, yi = _retangle(xr[gr, e], xi[gr, e], xr[gr, pe], xi[gr, pe], ab[e])
    v = _mix_core(m, torch.complex(yr, yi), tab, inverse=True)
    out = torch.empty(geo["ROWS"], m, dtype=torch.complex64)
    for k in range(geo["V"]):
        out[g, t + k * geo["P"]] = v[:, k]
    return torch.view_as_real(out).reshape(geo["ROWS"], 2 * m)


# ---- the smooth lengths (csrc/fft_smooth.cuh) ----

# the rows' pitch mod 32 at the second family's lengths of K = 2 where a
# residue other than P mod 32 takes fewer wavefronts over the exchange
# (``regs::smooth_row_pitch``; the least of the sum over the exchanges'
# values of their worst wavefronts, every residue counted by
# :func:`smooth_ways` at the pitch; ``tests/test_torch_regsmoothmore.py``);
# at 12 and 20 (one pass, no exchange: P = 1, the planes only stage the
# rows) the odd pitch n + 1, so the 32 rows of a warp meet 32 banks
SMOOTH_ROW_PITCH = {12: 13, 20: 21, 36: 9, 60: 25, 100: 25, 108: 27,
                    180: 8, 300: 11}
# the same at the third family's lengths (the odd and twice-odd ones): of
# P < 32 where another residue costs less (14 lengths, P = 3-27: every get
# two wavefronts there, every put one or two; the pick of the least cost
# over all 32 residues, ties to P mod 32), and at P = 1 (18, 25, 30: one
# pass, the planes only stage the rows) the odd pitch n | 1
SMOOTH_ODD_ROW_PITCH = {18: 19, 25: 25, 27: 9, 30: 31, 45: 9, 50: 25,
                        54: 9, 75: 25, 81: 27, 90: 9, 125: 25, 135: 27,
                        150: 25, 162: 27, 225: 11, 270: 27, 450: 11}
# the same at the fourth family's (the lengths with a factor 7) by the same
# pick: at P = 7 (84, 140, 196: puts of six wavefronts at P mod 32) and
# 420 (P = 21), and at P = 1 (28) the odd pitch n | 1
SMOOTH7_ROW_PITCH = {28: 29, 84: 17, 140: 17, 196: 4, 420: 2}


def smooth_row_pitch(n: int) -> int:
    """The rows' pitch mod 32 at n: P mod 32 (every get one wavefront),
    but at the lengths of ``SMOOTH_ROW_PITCH``, ``SMOOTH_ODD_ROW_PITCH``
    and ``SMOOTH7_ROW_PITCH``."""
    pick = {**SMOOTH_ROW_PITCH, **SMOOTH_ODD_ROW_PITCH, **SMOOTH7_ROW_PITCH}
    return pick.get(n, n // fused_fft._smooth_values(n) % 32)


def smooth_col_pad(n: int) -> bool:
    """Whether the smooth columns' planes at n take one pad slot per four
    elements (``ColLay<L, 2>``): in the first family and from k = 4, where
    a radix-4 pass writes runs of four; below (k = 2, 3 of the second
    family) they are unpadded (``SmoothFlatColLay``)."""
    return (n in fused_fft._SMOOTH_LENGTHS
            or smooth_schedule(n)[0][0] == 4)


def smooth_geometry(n: int, kind: str = "rows", pitch: int | None = None
                    ) -> dict:
    """The block of the smooth core at n: P threads a line, V the values
    a thread holds at most (VMAX), and for ``kind`` "rows"
    (``regs::SmoothRowGeo``) ROWS = 256 / P rows a block (one from P =
    256), NT = ROWS P threads, a row's planes at PITCH floats (n rounded up
    to :func:`smooth_row_pitch` mod 32, or to ``pitch`` mod 32 where
    given; no pad, SIZE = n); for "cols" (``SmoothColGeo``) L lanes a block
    (32 up to 768 threads, then 16, then 8, to P = 128), NT = L P, W = 32 /
    L row threads a warp, one plane's floats SIZE (one pad slot per four
    elements where :func:`smooth_col_pad`); both with the block's dynamic
    shared memory SMEM in bytes (none for the columns at one pass: 12,
    20). Rows of fewer than 6 threads (12-100 of the second family) STAGE
    through the planes: the block's rows in and out whole
    (:func:`smooth_stage_ways`)."""
    sched = smooth_schedule(n)
    p = n // fused_fft._smooth_values(n)
    vmax = max(r * b for r, _, b in sched)
    planes = len(sched) > 1
    if kind == "rows":
        rows = 1 if p >= THREADS else THREADS // p
        want = smooth_row_pitch(n) if pitch is None else pitch
        pitch = n + ((want % 32 - n) % 32 + 32) % 32
        stage = p < 6
        return {"P": p, "ROWS": rows, "NT": rows * p, "SIZE": n,
                "PITCH": pitch, "V": vmax, "STAGE": stage,
                "SMEM": 2 * rows * pitch * 4 if planes or stage else 0}
    if n not in fused_fft._SMOOTH_COLS:
        raise ValueError(f"no smooth column variant at n = {n}")
    lanes = fused_fft._smooth_col_lanes(p)
    last = n - 1 + ((n - 1) >> 2 if smooth_col_pad(n) else 0)
    size = (last * lanes + lanes + 3) // 4 * 4
    return {"P": p, "L": lanes, "NT": lanes * p, "W": max(1, 32 // lanes),
            "SIZE": size, "V": vmax, "SMEM": 2 * size * 4 if planes else 0}


def smooth_addr(n: int, kind: str, pitch: int | None = None):
    """(t, addr) of a block of the smooth core: each thread's index t in
    its line and ``addr(a)``, each thread's float offset of its line's
    element a in the block's exchange plane. Rows: thread tid of row
    g = tid // P, t = tid % P, element a at g PITCH + a (``pitch``: the
    PITCH of that residue mod 32). Columns: thread (t, l) = (tid // L,
    tid % L), element a of lane l at (a + a div 4) L + l where
    :func:`smooth_col_pad`, else at a L + l."""
    g = smooth_geometry(n, kind, pitch)
    tid = torch.arange(g["NT"])
    if kind == "rows":
        row, t = tid // g["P"], tid % g["P"]
        return t, lambda a: row * g["PITCH"] + a
    lane, t = tid % g["L"], tid // g["L"]
    if smooth_col_pad(n):
        return t, lambda a: (a + (a >> 2)) * g["L"] + lane
    return t, lambda a: a * g["L"] + lane


def _smooth_core(n: int, v0, tab, inverse: bool, kind: str):
    """``regs::core_smooth`` on one block as it runs: thread i holds
    ``v0[i]`` (NT, V0), the first pass's inputs, element t + q P + r n/R
    at v0[:, q R + r]; each later pass puts the outputs of its valid
    butterflies j = t + q P (j < n / R) into the block's plane at
    d + r Ns, d = (t div Ns) Ns R + t mod Ns + q P R, and gets its inputs
    at j + r n/R, through the addresses of :func:`smooth_addr`. Returns
    v (NT, V0): v[:, k] the output element t + k P of the thread's
    line."""
    g = smooth_geometry(n, kind)
    p, nt = g["P"], g["NT"]
    t, addr = smooth_addr(n, kind)
    sched = smooth_schedule(n)
    w = torch.complex(tab[:n, 0], tab[:n, 1])
    v = torch.full((nt, g["V"]), complex("nan"), dtype=torch.complex64)
    v[:, :v0.shape[1]] = v0.to(torch.complex64)
    plane = torch.full((g["SMEM"] // 8 + 64,), complex("nan"),
                       dtype=torch.complex64)

    def valid(r, q):
        return t + q * p < n // r

    def fly(r, ns, b):
        for q in range(b):
            ok = valid(r, q)
            blk = v[ok, q * r:(q + 1) * r]
            if ns > 1:
                base = (t[ok] % ns) * (n // (ns * r))
                blk = blk * w[torch.arange(r)[None, :] * base[:, None]]
            v[ok, q * r:(q + 1) * r] = _net(blk, r, inverse)

    fly(*sched[0])
    for (rp, nsp, bp), (r, ns, b) in zip(sched, sched[1:]):
        x = (t // nsp) * nsp * rp + t % nsp
        for q in range(bp):
            ok = valid(rp, q)
            for k in range(rp):
                plane[addr(x + q * p * rp + k * nsp)[ok]] = v[ok, q * rp + k]
        for q in range(b):
            ok = valid(r, q)
            for k in range(r):
                v[ok, q * r + k] = plane[addr(t + q * p + k * (n // r))[ok]]
        fly(r, ns, b)
    return v[:, :fused_fft._smooth_values(n)]


def _smooth_loads(n: int, t):
    """The elements each thread of the smooth core loads at n, in the order
    of its loads (``core_smooth``): (threads, V0), thread t's element
    t + q P + j n/R (q < B, j < R; R and B the first pass's radix and
    butterflies a thread)."""
    p = n // fused_fft._smooth_values(n)
    r, _, b = smooth_schedule(n)[0]
    return torch.stack([t + q * p + j * (n // r)
                        for q in range(b) for j in range(r)], 1)


def _smooth_block(x, tab, inverse: bool, kind: str):
    """One block of ``regs::rows_smooth`` (``kind`` "rows": ``x`` the
    block's ROWS rows) or ``cols_smooth`` ("cols": ``x`` its L lines), (K,
    n) complex64, lines past the data zero, through :func:`_smooth_core`.
    Returns the (K, n) output."""
    k, n = x.shape
    g = smooth_geometry(n, kind)
    p = g["P"]
    tid = torch.arange(g["NT"])
    line, t = (tid // p, tid % p) if kind == "rows" else \
        (tid % g["L"], tid // g["L"])
    # a masked first pass (60: radix 5 at V0 = 12) loads nothing for its
    # masked butterfly: NaN there, which no later step may read
    e, live = _smooth_first_loads(n, t)
    v0 = x[line[:, None], e]
    v0[~live] = complex("nan")
    v = _smooth_core(n, v0, tab, inverse, kind)
    out = torch.empty(k, n, dtype=torch.complex64)
    for j in range(v.shape[1]):
        out[line, t + j * p] = v[:, j]
    return out


def smooth_rows_block(x, tab, inverse: bool = False):
    """One block of ``regs::rows_smooth`` as it runs, at a smooth n: ``x``
    the block's ROWS rows (ROWS, n) complex64 (rows past the batch zero),
    thread tid of row tid // P. Returns the (ROWS, n) output."""
    return _smooth_block(x, tab, inverse, "rows")


def smooth_cols_block(x, tab, inverse: bool = False):
    """One block of ``regs::cols_smooth`` as it runs, at a smooth column
    length n: ``x`` the tile's L lines (L, n) complex64 (lanes past the
    data zero), thread (t, l) = (tid // L, tid % L). Returns the (L, n)
    output."""
    return _smooth_block(x, tab, inverse, "cols")


def smooth_ways(n: int, kind: str = "rows", pitch: int | None = None
                ) -> dict:
    """{(pass, "put" or "get"): the worst wavefronts a warp instruction
    takes} on the exchanges of the smooth core's block (``kind`` "rows" or
    "cols"; the rows at the pitch of residue ``pitch`` mod 32 where
    given), from :func:`smooth_addr` (:func:`_exchange_ways`; the rows'
    first radix-4 pass stores float4)."""
    t, addr = smooth_addr(n, kind, pitch)
    return _exchange_ways(n, t, addr, kind == "rows")


def smooth_stage_addrs(n: int) -> tuple:
    """The staged rows' copies in and out (``smooth_stage_in`` /
    ``smooth_stage_out``, and the real rows' ``smooth_stage_pairs_in`` /
    ``smooth_stage_pairs_out``) at n, in the kernel's order: float i of
    the block's ROWS n elements (thread tid on i = tid, tid + NT, ...), row
    r = i div n, element e = i mod n, at r PITCH + e of each plane.
    Returns (plane address, r, e) over i."""
    g = smooth_geometry(n)
    i = torch.arange(g["ROWS"] * n)
    r, e = i // n, i % n
    return r * g["PITCH"] + e, r, e


def smooth_stage_ways(n: int) -> dict:
    """The worst wavefronts a warp instruction of the staged rows
    (``SmoothRowGeo::STAGE``, P < 6) takes on the planes: ``in`` and
    ``out``, the block's rows copied in and out whole
    (:func:`smooth_stage_addrs`: the c2c rows move one float of each plane
    an element, the real rows a float2 split between the planes, the r2c's
    input pairs and the c2r's output pairs, and the c2r re-tangles each
    element from its two lanes as it copies it in: the same plane
    addresses), ``load`` the core's loads from the planes (element
    t + q P + j n/R of the thread's row, masked past n / R) and ``store``
    its outputs put back (element t + r P)."""
    g = smooth_geometry(n)
    nt, p = g["NT"], g["P"]
    flat, _, _ = smooth_stage_addrs(n)
    warps = [flat[j + w:min(j + w + 32, j + nt, len(flat))].tolist()
             for j in range(0, len(flat), nt)
             for w in range(0, min(nt, len(flat) - j), 32)]
    t, addr = smooth_addr(n, "rows")
    e, live = _smooth_first_loads(n, t)
    out = torch.stack([addr(t + k * p)
                       for k in range(fused_fft._smooth_values(n))], 1)
    return {"in": _ways(warps), "out": _ways(warps),
            "load": _worst_ways(addr(e.t()).t(), live),
            "store": _worst_ways(out)}


def smooth_exchange_cost(n: int, kind: str = "rows",
                         pitch: int | None = None) -> int:
    """The wavefronts of one thread's exchanges over the whole line, as
    the pitch's pick weighs them: each exchange's worst wavefronts (a put
    of pass i, a get of pass i, :func:`smooth_ways`) times the values a
    thread moves in it (R B of that pass)."""
    sched = smooth_schedule(n)
    return sum(w * sched[i][0] * sched[i][2]
               for (i, _), w in smooth_ways(n, kind, pitch).items())


def _smooth_threads(m: int) -> tuple:
    """Row g and index t in it of each of the NT threads of a block of the
    smooth rows (thread tid: g = tid // P, t = tid % P)."""
    geo = smooth_geometry(m)
    tid = torch.arange(geo["NT"])
    return tid // geo["P"], tid % geo["P"]


def r2c_smooth_addrs(m: int) -> dict:
    """The shared-memory float addresses of ``regs::rows_r2c_smooth`` at a
    smooth M after its core, each (NT, K) over the block's threads (row g
    at g PITCH in the exchange plane, no pad; at g ``stage_pitch`` in the
    stage): ``put`` the natural-order write of element t + r P (r < V0);
    the untangle's reads of the pairs (k, M - k), k = t + i P (i <
    ceil(V0 / 2), ``k``; ``live`` where the thread takes the pair: every
    i < V0 / 2, and at an odd M, whose V0 is odd, the last i where
    k <= (M - 1) / 2): ``lo`` V[k], ``hi`` V[M - k] (the k = 0 entry
    unread: thread 0 of a row takes the packed lane from V[0] alone);
    ``mid`` (NT,) thread 0's V[M/2] at an even M (absent at an odd M: no
    lane pairs with itself); the stage writes ``st_lo`` of X[k] and
    ``st_hi`` of X[M - k]."""
    p, v0 = smooth_geometry(m)["P"], fused_fft._smooth_values(m)
    g, _ = _smooth_threads(m)
    t, addr = smooth_addr(m, "rows")
    put = torch.stack([addr(t + r * p) for r in range(v0)], 1)
    ni = (v0 + 1) // 2
    k = t[:, None] + p * torch.arange(ni)[None, :]
    live = (torch.arange(ni)[None, :] < v0 // 2) | (2 * k < m)
    lo = torch.stack([addr(k[:, i]) for i in range(ni)], 1)
    hi = torch.stack([addr((m - k[:, i]) % m) for i in range(ni)], 1)
    s = stage_pitch(m)
    ad = {"put": put, "k": k, "live": live, "lo": lo, "hi": hi,
          "st_lo": g[:, None] * s + k, "st_hi": g[:, None] * s + (m - k)}
    if m % 2 == 0:
        ad["mid"] = addr(m // 2)
    return ad


def r2c_smooth_ways(m: int) -> dict:
    """The worst wavefronts a warp instruction of ``regs::rows_r2c_smooth``
    at a smooth M takes beyond its core's exchanges (:func:`smooth_ways`),
    from :func:`r2c_smooth_addrs`: the natural-order ``put``, the
    untangle's reads ``lo``, ``hi`` and ``mid``, the stage writes
    ``st_lo`` and ``st_hi``, and the copy out of the stage in each layout
    (``copy numpy``, ``copy packed``), each warp the 32 consecutive
    threads of the block's NT as the loop of ``copy_smooth_rows_out`` runs
    them (i = j NT + tid: where 32 does not divide NT, a warp's floats
    start NT apart from the last pass's)."""
    geo = smooth_geometry(m)
    g, t = _smooth_threads(m)
    ways = _r2c_ways(r2c_smooth_addrs(m), t)
    nt = geo["NT"]
    for name, lanes in (("copy numpy", m + 1), ("copy packed", m)):
        src, _ = r2c_mix_copy(m, lanes, lanes)
        groups = [src[w:min(w + 32, j + nt, len(src))].tolist()
                  for j in range(0, len(src), nt)
                  for w in range(j, min(j + nt, len(src)), 32)]
        ways[name] = _ways(groups)
    return ways


def _smooth_first_loads(m: int, t) -> tuple:
    """The elements the smooth core's first pass loads at m for threads of
    index ``t`` (:func:`_smooth_loads`), clamped into the row, and which of
    them it loads at all (a masked first pass, 60 = 15 4, loads nothing
    for its masked butterfly)."""
    p = m // fused_fft._smooth_values(m)
    r, _, nb = smooth_schedule(m)[0]
    e = _smooth_loads(m, t)
    live = (t[:, None] + p * (torch.arange(nb * r) // r)[None, :]) < m // r
    return e.clamp(max=m - 1), live


def _smooth_staged(m: int, re, im, nvalid: int):
    """The block's exchange plane after the staged copy in (P < 6): rows
    r < ``nvalid`` of ``re + i im`` (ROWS, m) at r PITCH + e, rows past
    them zero (:func:`smooth_stage_addrs`), the pad slots NaN."""
    g = smooth_geometry(m)
    flat, r, e = smooth_stage_addrs(m)
    plane = torch.full((g["ROWS"] * g["PITCH"],), complex("nan"),
                       dtype=torch.complex64)
    plane[flat] = torch.where(r < nvalid, torch.complex(re[r, e], im[r, e]),
                              torch.zeros((), dtype=torch.complex64))
    return plane


def rfft_rows_smooth_block(x, tab, w, scale: float = 1.0,
                           packed: bool = False, rows: int | None = None,
                           opitch: int | None = None):
    """One block of ``regs::rows_r2c_smooth`` as it runs, at a smooth M of
    any of the three families: ``x`` the block's ROWS real rows (ROWS, 2M)
    f32 (rows past the batch zero), thread (g, t) = (tid // P, tid % P) of
    row g.
    Its core (:func:`_smooth_core`) on v[j] = x[2j] + i x[2j+1], read
    from device memory, or, where a row takes fewer than 6 threads
    (``SmoothRowGeo::STAGE``), the block's first ``rows`` rows copied
    whole into the exchange plane as pairs (the rest zero,
    :func:`_smooth_staged`) and read from there; V put in natural order
    into the row's plane, the pairs (k, M - k) read back and untangled
    times ``scale`` (``w`` = ``tables.rfft_table(2M)``), staged at
    :func:`stage_pitch`, and the first ``rows`` rows (default all) copied
    out in the kernel's order, each the numpy (M + 1) or packed (M) lanes
    at ``opitch`` floats a row (default the lanes), every address
    :func:`r2c_smooth_addrs`'s and :func:`r2c_mix_copy`'s. Returns the
    planar pair (rows, opitch), the lanes past the numpy or packed ones NaN
    (never written)."""
    m = x.shape[-1] // 2
    geo = smooth_geometry(m)
    g, t = _smooth_threads(m)
    e, live = _smooth_first_loads(m, t)
    gr = g[:, None]
    if geo["STAGE"]:
        _, addr = smooth_addr(m, "rows")
        plane = _smooth_staged(m, x[:, 0::2], x[:, 1::2],
                               geo["ROWS"] if rows is None else rows)
        v0 = plane[addr(e.t()).t()]
    else:
        v0 = torch.complex(x[gr, 2 * e], x[gr, 2 * e + 1])
    v0[~live] = complex("nan")
    v = _smooth_core(m, v0, tab, False, "rows")
    return _r2c_block(m, v, r2c_smooth_addrs(m), g, t, w, scale, packed,
                      rows, opitch)


def c2r_smooth_loads(m: int) -> tuple:
    """The input lanes ``regs::rows_c2r_smooth`` reads from device memory
    at a smooth M where a row takes 6 threads or more, each (NT, V0) over
    the block's threads in the order of their loads: element e of the
    thread's row (t + q P + j M/R, :func:`_smooth_loads`) and its
    re-tangle partner e ? M - e : 0; where the first pass is masked (60,
    2025) the masked butterfly loads nothing, and its lanes are clamped
    into the row (:func:`_smooth_first_loads`)."""
    _, t = _smooth_threads(m)
    e, _ = _smooth_first_loads(m, t)
    return e, torch.where(e == 0, 0, m - e)


def rows_c2r_smooth_block(xr, xi, tab, ab, rows: int | None = None):
    """One block of ``regs::rows_c2r_smooth`` as it runs, at a smooth M of
    any of the three families: ``(xr, xi)`` the block's ROWS packed planar rows
    (ROWS, M) (rows past the batch zero), its first ``rows`` rows (default
    all) valid. Where a row takes 6 threads or more each thread
    re-tangles element e of its row as it loads it, from the lanes
    :func:`c2r_smooth_loads` gives, with ``ab`` (``tables.crfft_table``,
    the scale folded in) in the kernel's f32 order (:func:`_retangle`),
    runs the inverse core (:func:`_smooth_core`) and stores
    x[2j] + i x[2j+1] = v[j] as one float2. Where a row takes fewer
    (``SmoothRowGeo::STAGE``) the block's valid rows are copied in whole,
    element e of row r re-tangled from lanes e and e ? M - e : 0 as it is
    copied to r PITCH + e of the planes (the rows past ``rows`` zero,
    :func:`smooth_stage_addrs`), the core loads from there, puts v back at
    element t + r P and the valid rows are copied out whole as float2
    pairs. Returns the real (ROWS, 2M) rows, the rows past ``rows`` NaN
    (never written)."""
    m = xr.shape[-1]
    geo = smooth_geometry(m)
    nvalid = geo["ROWS"] if rows is None else rows
    g, t = _smooth_threads(m)
    first, live = _smooth_first_loads(m, t)
    nan = float("nan")
    out = torch.full((geo["ROWS"], m), complex(nan, nan),
                     dtype=torch.complex64)
    if geo["STAGE"]:
        _, addr = smooth_addr(m, "rows")
        vr, vi = retangle_pair(xr, xi, ab)
        plane = _smooth_staged(m, vr, vi, nvalid)
        v0 = plane[addr(first.t()).t()]
        v0[~live] = complex("nan")
        v = _smooth_core(m, v0, tab, True, "rows")
        # the outputs put back into the (fresh) plane, then copied out
        back = torch.full_like(plane, complex("nan"))
        for k in range(v.shape[1]):
            back[addr(t + k * geo["P"])] = v[:, k]
        flat, r, c = smooth_stage_addrs(m)
        ok = r < nvalid
        out[r[ok], c[ok]] = back[flat[ok]]
    else:
        e, pe = c2r_smooth_loads(m)
        gr = g[:, None]
        yr, yi = _retangle(xr[gr, e], xi[gr, e], xr[gr, pe], xi[gr, pe],
                           ab[e])
        v0 = torch.complex(yr, yi)
        v0[~live] = complex("nan")
        v = _smooth_core(m, v0, tab, True, "rows")
        ok = g < nvalid
        for k in range(v.shape[1]):
            out[g[ok], (t + k * geo["P"])[ok]] = v[ok, k]
    return torch.view_as_real(out).reshape(geo["ROWS"], 2 * m)


def _by_blocks(n: int, lead, data, block):
    """Run ``block(chunk, valid)`` over (rows, ...) ``data`` ROWS rows at a
    time as the grid does, the ragged last block padded with zero rows
    and only its valid rows kept; returns the rows concatenated, with the
    leading shape ``lead``."""
    nrows = geometry(n)["ROWS"]
    outs = []
    for b0 in range(0, data[0].shape[0], nrows):
        k = min(nrows, data[0].shape[0] - b0)
        chunk = []
        for d in data:
            c = torch.zeros((nrows, *d.shape[1:]), dtype=d.dtype)
            c[:k] = d[b0:b0 + k]
            chunk.append(c)
        outs.append(block(chunk, k))
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o).reshape(*lead, -1) for o in zip(*outs))
    return torch.cat(outs).reshape(*lead, -1)


def fft_last(xr, xi, tab, inverse: bool = False, scale: float = 1.0,
             alias: bool = False):
    """``fft_last``'s register core on planar (..., n) as its grid runs:
    at a mixed length block by block (:func:`rows_mix_block`, ROWS rows a
    block, the ragged last one masked), at a smooth one likewise
    (:func:`smooth_rows_block`), at a power of two :func:`fft_rows`;
    ``scale`` at the store. ``alias`` writes over the inputs (a block
    reads its rows whole before it writes any)."""
    n = xr.shape[-1]
    if n in fused_fft._MIX_ROW_LENGTHS or n in fused_fft._SMOOTH_C2C:
        blk = (smooth_rows_block if n in fused_fft._SMOOTH_C2C
               else rows_mix_block)
        y = _by_blocks(n, xr.shape[:-1],
                       (torch.complex(xr, xi).reshape(-1, n),),
                       lambda c, k: blk(c[0], tab, inverse)[:k] * scale)
        yr, yi = y.real.contiguous(), y.imag.contiguous()
    else:
        yr, yi = fft_rows(xr, xi, tab, inverse, scale)
    if alias:
        xr.copy_(yr)
        xi.copy_(yi)
        return xr, xi
    return yr, yi


def rfft_rows(x, tab, w, scale: float = 1.0, packed: bool = False,
              opitch: int | None = None):
    """The kernel's r2c of every real (..., 2M) row: the M-point core on
    v[j] = x[2j] + i x[2j+1], then the untangle of V in natural order
    (``w`` = ``tables.rfft_table(2M)``), ``scale`` at the store. The
    numpy (..., M + 1) layout, or the packed (..., M) one; with
    ``opitch`` its rows at that pitch, the lanes past them NaN. At a
    mixed M block by block (:func:`rfft_rows_mix_block`), at a smooth one
    likewise (:func:`rfft_rows_smooth_block`)."""
    m = x.shape[-1] // 2
    if m in fused_fft._MIX_ROW_LENGTHS or m in fused_fft._SMOOTH_CORE:
        blk = (rfft_rows_smooth_block if m in fused_fft._SMOOTH_CORE
               else rfft_rows_mix_block)
        return _by_blocks(m, x.shape[:-1], (x.reshape(-1, 2 * m),),
                          lambda c, k: blk(c[0], tab, w, scale, packed, k,
                                           opitch))
    if opitch is not None:
        yr, yi = rfft_rows(x, tab, w, scale, packed)
        return _pitched(x.shape[:-1], yr.shape[-1],
                        opitch - yr.shape[-1], yr, yi)
    v = x.reshape(*x.shape[:-1], m, 2)
    vr, vi = fft_rows(v[..., 0], v[..., 1], tab)
    mk = (-torch.arange(m)) % m
    y, _ = _untangle(torch.complex(vr, vi), torch.complex(vr, vi)[..., mk],
                     w, w[mk], 0.5 * scale)
    yr, yi = y.real.clone(), y.imag.clone()
    a, b = vr[..., 0], vi[..., 0]
    if packed:
        yr[..., 0], yi[..., 0] = (a + b) * scale, (a - b) * scale
        return yr, yi
    zero = torch.zeros_like(a)[..., None]
    yr = torch.cat([yr, ((a - b) * scale)[..., None]], -1)
    yi = torch.cat([yi, zero], -1)
    yr[..., 0], yi[..., 0] = (a + b) * scale, 0.0
    return yr, yi


def col_at(n: int, a, threads: int = THREADS):
    """Offset, in a column block's exchange plane, of element a of lane 0
    (lane l adds l): the lane is the fastest index, one pad slot per 16
    elements (``ColLay``), per 4 at a mixed or smooth length
    (``MixColGeo``, ``SmoothColGeo``); at
    one lane a block (n = 4096 in 256 threads) a lane is a row, at
    phys."""
    lanes = threads // (n // fused_fft._reg_values(n))
    if lanes == 1:
        return phys(a)
    sh = 2 if (n in fused_fft._MIX_LENGTHS
               or n in fused_fft._SMOOTH_LENGTHS) else 4
    return (a + (a >> sh)) * lanes


def col_geometry(n: int, threads: int = THREADS) -> dict:
    """The block geometry of ``regs::ColGeo`` in a block of ``threads``:
    threads per lane P, lanes per block L (thread (t, l) = (tid // L,
    tid % L)), row threads per warp W, one plane's floats SIZE (a multiple
    of 4) and the block's dynamic shared memory in bytes (none for one
    pass)."""
    sched = passes(n)
    p = n // fused_fft._reg_values(n)
    lanes = threads // p
    if lanes < 1 or lanes * p != threads:
        raise ValueError(f"{threads} threads hold no whole lanes of {n}")
    size = (int(col_at(n, n - 1, threads)) + lanes + 3) // 4 * 4
    return {"P": p, "L": lanes, "W": max(1, 32 // lanes), "SIZE": size,
            "SMEM": 2 * size * 4 if len(sched) > 1 else 0}


def axis_tile(n: int, tile: str | None = None) -> dict:
    """The geometry of a lane tile of the strided-axis kernel at length n
    (``tile`` None: the one its routes launch, ``fused_fft._axis_tile``):
    threads a block, P threads a line, L lanes a block, W row threads a
    warp; "narrow": 256 threads, L = 256 / P (the slabs' y pass); "wide":
    32 P threads up to 1024 (P >= 16: n >= 256, or 192, 320 mixed); at a
    smooth length the one tile of ``SmoothColGeo``
    (:func:`smooth_geometry`), coded "wide"."""
    passes(n)
    tile = tile or fused_fft._axis_tile(n)
    p = n // fused_fft._reg_values(n)
    if n in fused_fft._SMOOTH_C2C:
        if tile != "wide":
            raise ValueError(f"no {tile!r} lane tile at n = {n}")
        g = smooth_geometry(n, "cols")
        return {"tile": tile, "threads": g["NT"], "P": p, "L": g["L"],
                "W": g["W"]}
    if tile == "narrow":
        nt = THREADS
    elif tile == "wide" and p >= 16:
        nt = min(32 * p, 1024)
    else:
        raise ValueError(f"no {tile!r} lane tile at n = {n}")
    g = col_geometry(n, nt)
    return {"tile": tile, "threads": nt, "P": p, "L": g["L"], "W": g["W"]}


def warp_runs(n: int, tile: str | None = None) -> int:
    """The shortest run of consecutive floats along the contiguous axis
    that one warp instruction of the strided-axis kernel loads or stores
    in device memory: W row threads a warp, each on L consecutive
    lanes."""
    lanes = axis_tile(n, tile)["L"]
    return min(32, lanes)


def cluster_geometry(ny: int, nz: int) -> dict:
    """The geometry of ``regs::ClusterSlab`` for a (Y, Z) slab the layout
    takes (``fused_fft._cluster_slab``): elements a block B, blocks a
    cluster C, rows YB and y lanes ZB a block, the slab's row pitch SP,
    the block's dynamic shared memory in bytes and the blocks an SM it
    leaves room for."""
    ly, lz = ny.bit_length() - 1, nz.bit_length() - 1
    if not (lz >= 7 and ly >= 6 and 14 <= ly + lz <= 17 and ny == 1 << ly
            and nz == 1 << lz and ny <= 4096 and nz <= 4096):
        raise ValueError(f"no cluster layout for the slab ({ny}, {nz})")
    b = 4096 if ly + lz <= 15 else 8192
    c = ny * nz // b
    pz, lanes = nz // E, col_geometry(ny)["L"]
    sp = nz + (pz if pz < 32 else lanes if lanes < 32 else 0)
    ex = max(geometry(nz)["SMEM"], col_geometry(ny)["SMEM"])
    smem = 2 * (ny // c) * sp * 4 + ex
    return {"B": b, "C": c, "YB": ny // c, "ZB": nz // c, "SP": sp,
            "SMEM": smem, "MINB": (228 << 10) // (smem + 1024)}


def cluster_ways(ny: int, nz: int) -> dict:
    """Wavefronts per warp instruction on the cluster slab's planes:
    "z put", the row core's output writes of the z rows (P_z threads a
    row, 32 / P_z rows a warp) into the block's slab, and "y get", the
    column variant's first-pass reads of a block's lanes (L lanes of
    32 / L row threads a warp, element y of lane z at (y mod YB) SP + z
    in the block of rank y div YB): the order of ``fft_slab`` and
    ``rfft_slab``. The c2r slab (``irfft_slab``) runs the other way:
    "y put", the column variant's last-pass writes into the blocks that
    keep each row, and "z get", the c2r rows' first-pass reads of element
    e and of (nz - e) mod nz from the block's own rows."""
    g = cluster_geometry(ny, nz)
    lanes = np.arange(THREADS)
    pz = nz // E
    row, t = lanes // pz, lanes % pz
    r, ns = passes(nz)[-1]
    put = max(_ways((row * g["SP"] + t + q * pz + k * (nz // r))
                    .reshape(-1, 32).tolist())
              for q in range(E // r) for k in range(r))
    zget = max(_ways((row * g["SP"] + ((s * (t + k * (nz // E))) % nz))
                     .reshape(-1, 32).tolist())
               for k in range(E) for s in (1, -1))
    cg = col_geometry(ny)
    lane, ty = lanes % cg["L"], lanes // cg["L"]
    ry, _ = passes(ny)[-1]
    # element y of a lane: the first pass's loads (y get) and the last
    # pass's stores (y put)
    reads = [ty + k * cg["P"] for k in range(E)]
    writes = [ty + q * cg["P"] + k * (ny // ry)
              for q in range(E // ry) for k in range(ry)]
    ways = {}
    for name, elems in (("y get", reads), ("y put", writes)):
        worst = 1
        for e in elems:
            rank, at = e // g["YB"], (e % g["YB"]) * g["SP"] + lane
            for w in range(THREADS // 32):
                sel = slice(32 * w, 32 * w + 32)
                # a warp's addresses on each block it reads, banked per block
                for rk in set(rank[sel].tolist()):
                    worst = max(worst,
                                _ways([at[sel][rank[sel] == rk].tolist()]))
        ways[name] = worst
    return {"z put": put, "z get": zget, **ways}


def _ways(groups, banks: int = BANKS) -> int:
    """Shared-memory wavefronts of one warp instruction: over the groups
    of lanes served together, the most distinct addresses on one bank (one
    address read by several lanes is one broadcast)."""
    worst = 1
    for addrs in groups:
        if not addrs:
            continue
        per_bank: dict = {}
        for a in set(addrs):
            per_bank.setdefault(a % banks, set()).add(a)
        worst = max(worst, max(len(s) for s in per_bank.values()))
    return worst


def _exchange_ways(n: int, t, addr, vec4: bool) -> dict:
    """{(pass, "put" or "get"): the worst wavefronts per warp instruction}
    of the core's exchanges for the block's threads (``t``: each one's
    index in its line; ``addr(a)``: each one's float address of its line's
    element a): the writes of each pass but the last (with ``vec4``
    16-byte stores on the first pass, served by quarter-warps on the 8
    groups of 4 banks; else scalar by whole warps) and the reads of each
    pass but the first. 1 means free of bank conflicts."""
    p = n // fused_fft._reg_values(n)
    out = {}
    sched = passes(n)

    def groups(a, ok, size):
        # the valid lanes of each warp (size 32) or quarter-warp (8)
        a, ok = torch.as_tensor(a), torch.as_tensor(ok)
        return [a[i:i + size][ok[i:i + size]].tolist()
                for i in range(0, len(a), size)]

    for i, (r, ns) in enumerate(sched):
        # butterflies a thread: V / R, rounded up and masked past n / R
        nb = -(-n // (r * p))
        if i > 0:
            out[(i, "get")] = max(
                _ways(groups(addr(t + q * p + k * (n // r)),
                             t + q * p < n // r, 32))
                for q in range(nb) for k in range(r))
        if i < len(sched) - 1:
            worst = 1
            for q in range(nb):
                j = t + q * p
                ok = j < n // r
                d = (j // ns) * ns * r + j % ns
                if ns == 1 and vec4 and r % 4 == 0:
                    for k in range(0, r, 4):
                        worst = max(worst, _ways(groups(addr(d + k) // 4, ok,
                                                        8), BANKS // 4))
                else:
                    for k in range(r):
                        worst = max(worst, _ways(groups(addr(d + k * ns), ok,
                                                        32)))
            out[(i, "put")] = worst
    return out


def bank_ways(n: int) -> dict:
    """The row core's exchanges (:func:`_exchange_ways`): a block of
    256 / P rows, row g's element a at :func:`row_at`."""
    p = geometry(n)["P"]
    lanes = np.arange(THREADS)
    row, t = lanes // p, lanes % p
    return _exchange_ways(n, t, lambda a: row_at(n, a, row), True)


def col_bank_ways(n: int, threads: int = THREADS) -> dict:
    """The column variant's exchanges (:func:`_exchange_ways`): a block of
    ``threads``, L lanes, thread (t, l) = (tid // L, tid % L), element a of
    lane l at col_at(a) + l; float4 writes only at one lane a block."""
    g = col_geometry(n, threads)
    lanes = np.arange(threads)
    lane, t = lanes % g["L"], lanes // g["L"]
    return _exchange_ways(n, t, lambda a: col_at(n, a, threads) + lane,
                          g["L"] == 1)


def _net_flops(r: int) -> int:
    """f32 operations of one radix-r network: the radix-2 network of a
    power of two (4 per radix-2 step; a rotation by W^0 or -+i costs
    nothing, by (1 -+ i)/sqrt 2 four, by any other root six); ``dft3``
    16, ``dft5`` 48, ``dft7`` 96 (an FMA counts two); Good-Thomas 4 R0:
    four R0-point and R0 4-point networks; the composite radices of
    :func:`_net_split` likewise, with 6 a twiddle of Cooley-Tukey's."""
    if r in (12, 20, 28):
        return 4 * _net_flops(r // 4) + (r // 4) * _net_flops(4)
    if r in (3, 5, 7):
        return {3: 16, 5: 48, 7: 96}[r]
    if r & (r - 1):
        # the composite radices of :func:`_net_split`: b a-point and a
        # b-point networks, and Cooley-Tukey's (a - 1)(b - 1) twiddles
        a = next(q for q in (2, 3, 5) if r % q == 0)
        b = r // a
        return (b * _net_flops(a) + a * _net_flops(b)
                + (6 * (a - 1) * (b - 1) if b % a == 0 else 0))
    net, half = 0, r // 2
    while half >= 1:
        for i in range(half):
            k = i * (8 // half)
            rot = 0 if k in (0, 4) else 4 if k in (2, 6) else 6
            net += (r // (2 * half)) * (4 + rot)
        half //= 2
    return net


def flops(n: int) -> int:
    """f32 operations of the core on one line, from the schedule: each
    radix-R butterfly's network (:func:`_net_flops`) and a complex
    multiply (6) per twiddled input."""
    return sum((n // r) * (_net_flops(r) + (6 * (r - 1) if ns > 1 else 0))
               for r, ns in passes(n))


def fft_cols(xr, xi, tab, inverse: bool = False, scale: float = 1.0,
             dim: int = -2):
    """The column variant's c2c along ``dim`` of a planar f32 pair: the
    row core's passes on each line, its lanes the other positions."""
    yr, yi = fft_rows(xr.movedim(dim, -1), xi.movedim(dim, -1), tab,
                      inverse, scale)
    return (yr.movedim(-1, dim).contiguous(),
            yi.movedim(-1, dim).contiguous())


def fft_axis(xr, xi, yr, yi, n: int, geom, tab, inverse: bool = False,
             scale: float = 1.0, tile: str | None = None, side_r=None,
             side_i=None) -> None:
    """The strided-axis kernel's register core at length n as its grid
    runs, on flat f32 buffers: ``geom`` = (nb, ny, nz, in strides (b, n,
    y), out strides (b, n, y)) of ``fused_fft._axis_apply``, element
    (b, n, y, z) at b sb + n sn + y sy + z, a line per lane l = y nz + z.
    Tile by tile (L consecutive lanes of one b, :func:`axis_tile`, the
    ragged last one masked) it reads the tile's lines whole, runs the row
    core's passes on each (at a smooth length the block through its
    exchange plane, :func:`smooth_cols_block`), and writes them times
    ``scale``: so (yr, yi)
    may be (xr, xi), in place. Where ``side_r`` is given (flat (nb n,)
    f32, with ``side_i``), lane 0 of each b takes + i side[b n + e] as
    it loads element e (the column variant's SIDE plane, the c2r slab's
    y pass)."""
    nb, ny, nz, (isb, isn, isy), (osb, osn, osy) = geom
    tl = axis_tile(n, tile)["L"]
    lanes = ny * nz
    e = torch.arange(n)
    for b in range(nb):
        for l0 in range(0, lanes, tl):
            lane = torch.arange(l0, min(l0 + tl, lanes))
            y, z = lane // nz, lane % nz
            src = b * isb + e[:, None] * isn + (y * isy + z)[None, :]
            dst = b * osb + e[:, None] * osn + (y * osy + z)[None, :]
            ar, ai = xr[src].t(), xi[src].t()
            if side_r is not None and l0 == 0:
                ar, ai = ar.clone(), ai.clone()
                ar[0] -= side_i[b * n:(b + 1) * n]
                ai[0] += side_r[b * n:(b + 1) * n]
            if n in fused_fft._SMOOTH_COLS:
                x = torch.zeros(tl, n, dtype=torch.complex64)
                x[:len(lane)] = torch.complex(ar, ai)
                v = smooth_cols_block(x, tab, inverse)[:len(lane)] * scale
                vr, vi = v.real, v.imag
            else:
                vr, vi = fft_rows(ar, ai, tab, inverse, scale)
            yr[dst] = vr.t()
            yi[dst] = vi.t()


def _retangle(xr, xi, yr, yi, ab):
    """``regs::retangle_pair`` in its order of f32 operations: V[k] from
    x = X[k], y = X[(M - k) mod M] and ab[k] = (a, b) (..., 2, 2)."""
    ar, ai = ab[..., 0, 0], ab[..., 0, 1]
    br, bi = ab[..., 1, 0], ab[..., 1, 1]
    return (ar * xr - ai * xi + br * yr + bi * yi,
            ar * xi + ai * xr + bi * yr - br * yi)


def retangle_pair(xr, xi, ab):
    """The c2r re-tangle of packed rows (..., M) as the kernel computes it
    (``regs::retangle_pair``): element k of the pair (k, M - k),
    V[k] = a[k] X[k] + b[k] conj X[(M - k) mod M], (a, b) = ``ab[k]`` of
    ``tables.crfft_table`` (the scale folded in), in the kernel's order of
    f32 operations."""
    mk = (-torch.arange(xr.shape[-1])) % xr.shape[-1]
    return _retangle(xr, xi, xr[..., mk], xi[..., mk], ab)


def rows_c2r(xr, xi, tab, ab):
    """The kernel's c2r of packed rows (..., M): the re-tangle, the inverse
    M-point core (``tab``, a ``core_table`` of M), then x[2j] + i x[2j+1]
    = v[j]: real (..., 2M). At a mixed M block by block
    (:func:`rows_c2r_mix_block`), at a smooth one likewise
    (:func:`rows_c2r_smooth_block`)."""
    m = xr.shape[-1]
    if m in fused_fft._SMOOTH_CORE:
        return _by_blocks(m, xr.shape[:-1],
                          (xr.reshape(-1, m), xi.reshape(-1, m)),
                          lambda c, k: rows_c2r_smooth_block(
                              c[0], c[1], tab, ab, k)[:k])
    if m in fused_fft._MIX_ROW_LENGTHS:
        return _by_blocks(m, xr.shape[:-1],
                          (xr.reshape(-1, m), xi.reshape(-1, m)),
                          lambda c, k: rows_c2r_mix_block(c[0], c[1], tab,
                                                          ab)[:k])
    vr, vi = retangle_pair(xr, xi, ab)
    vr, vi = fft_rows(vr, vi, tab, inverse=True)
    return torch.stack([vr, vi], -1).reshape(*xr.shape[:-1], 2 * xr.shape[-1])


def irfft_slab(xr, xi, tabz, taby, ab, side_r=None, side_i=None):
    """The register ``irfft_slab`` on a packed planar (..., Y, M + pad)
    half-spectrum, as both of its layouts run it: the first M lanes' y
    lines on the column variant, inverse and unscaled (lane 0 plus
    i side where the (..., Y) side plane is given), then the c2r rows of
    the (..., Y, M) result (``tabz``: the core table of M; ``ab``:
    ``tables.crfft_table(2M, scale)``, M rows): real (..., Y, 2M). At a
    mixed Y as its two grids run it: the strided-axis kernel's tiles
    (:func:`fft_axis`) from the pitched input into a planar (..., Y, M)
    scratch, the side plane added as lane 0 of each x-row loads; at a
    mixed M the rows block by block (:func:`rows_c2r`)."""
    m = ab.shape[0]
    ny, lanes = xr.shape[-2], xr.shape[-1]
    if ny in fused_fft._MIX_LENGTHS:
        fr, fi = xr.reshape(-1), xi.reshape(-1)
        nb = fr.numel() // (ny * lanes)
        vr = torch.full((*xr.shape[:-1], m), float("nan"))
        vi = torch.full_like(vr, float("nan"))
        sr, si = vr.reshape(-1), vi.reshape(-1)
        fft_axis(fr, fi, sr, si, ny,
                 (nb, 1, m, (ny * lanes, lanes, 0), (ny * m, m, 0)), taby,
                 inverse=True,
                 side_r=None if side_r is None else side_r.reshape(-1),
                 side_i=None if side_i is None else side_i.reshape(-1))
        return rows_c2r(vr, vi, tabz, ab)
    ar, ai = xr[..., :m].clone(), xi[..., :m].clone()
    if side_r is not None:
        ar[..., 0] -= side_i
        ai[..., 0] += side_r
    vr, vi = fft_cols(ar, ai, taby, inverse=True, dim=-2)
    return rows_c2r(vr, vi, tabz, ab)


def _pitched(lead_shape, lanes: int, zpad: int, vr, vi):
    """An output pair of ``lanes + zpad`` lanes whose first ``lanes`` hold
    (vr, vi); the pad lanes, which no grid writes, hold NaN."""
    shp = (*lead_shape, lanes + zpad)
    yr = torch.full(shp, float("nan"))
    yi = torch.full(shp, float("nan"))
    yr[..., :lanes] = vr
    yi[..., :lanes] = vi
    return yr, yi


def fft_slab(xr, xi, tabz, taby, inverse: bool = False, scale: float = 1.0,
             zpad: int = 0, z_true: int = 0, alias: bool = False):
    """The register ``fft_slab``'s two grids on planar (..., Y, Z): the z
    rows of the first ``z_true`` (or Z) input lanes, unscaled, into an
    output of pitch Z + ``zpad`` (:func:`fft_last`: at a mixed Z through
    the swizzled exchange planes, at a smooth one through its block's);
    then the y columns in place on it, ``scale`` at their store (at a
    mixed or smooth Y the strided-axis kernel's tiles,
    :func:`fft_axis`, on the (x-rows, Y, 1, Z lanes) geometry).
    ``alias`` writes over the inputs."""
    ny = xr.shape[-2]
    nz = z_true or xr.shape[-1]
    zr, zi = fft_last(xr[..., :nz].contiguous(), xi[..., :nz].contiguous(),
                      tabz, inverse)
    if ny in fused_fft._MIX_LENGTHS or ny in fused_fft._SMOOTH_COLS:
        st = (ny * nz, nz, 0)
        fr, fi = zr.reshape(-1), zi.reshape(-1)
        fft_axis(fr, fi, fr, fi, ny, (fr.numel() // (ny * nz), 1, nz, st, st),
                 taby, inverse, scale)
        vr, vi = zr, zi
    else:
        vr, vi = fft_cols(zr, zi, taby, inverse, scale, dim=-2)
    if alias:
        xr.copy_(vr)
        xi.copy_(vi)
        return xr, xi
    return _pitched(xr.shape[:-1], nz, zpad, vr, vi)


def rfft_slab(x, tabz, taby, w, zpad: int = 0):
    """The register ``rfft_slab``'s two grids on real (..., Y, 2M): the
    r2c rows into the packed half-spectrum (lane 0 = X[0] + i X[M]) at
    pitch M + ``zpad`` (at a mixed M block by block through the kernel's
    pitched copy, :func:`rfft_rows_mix_block`), then the y columns in
    place on it (at a mixed Y the strided-axis kernel's tiles,
    :func:`fft_axis`, on the (x-rows, 1, M lanes) geometry at that
    pitch). Unscaled; the pad lanes, which no grid writes, hold NaN."""
    ny, m = x.shape[-2], x.shape[-1] // 2
    yr, yi = rfft_rows(x, tabz, w, packed=True, opitch=m + zpad)
    if ny in fused_fft._MIX_LENGTHS:
        fr, fi = yr.reshape(-1), yi.reshape(-1)
        op = m + zpad
        st = (ny * op, op, 0)
        fft_axis(fr, fi, fr, fi, ny, (fr.numel() // (ny * op), 1, m, st, st),
                 taby)
        return yr, yi
    vr, vi = fft_cols(yr[..., :m], yi[..., :m], taby, dim=-2)
    return _pitched(x.shape[:-1], m, zpad, vr, vi)


# ---- the four-step pair (csrc/fourstep.cu) ----

H100_SMS = 132   # the SMs of an H100 SXM, on which step 1's tiles were timed

def step1_tile(n1: int, n2: int, b: int = 1, tile: str | None = None,
               sms: int = H100_SMS) -> dict:
    """The geometry of step 1's lane tile at (b, n1, n2) (``tile`` None:
    the one its route launches on a card of ``sms`` SMs,
    ``fourstep._step1_tile``): the strided-axis kernel's narrow and wide
    tiles (:func:`axis_tile`) and "half", half the wide tile's lanes and
    threads (n1 = 512, 1024); with the grid's blocks."""
    from . import fourstep
    tile = tile or fourstep._step1_tile(n1, n2, b, sms)
    if tile == "half":
        if n1 not in (512, 1024):
            raise ValueError(f"no 'half' lane tile at n1 = {n1}")
        p = n1 // E
        nt = min(32 * p, 1024) // 2
        g = {"tile": tile, "threads": nt, "P": p, "L": nt // p,
             "W": max(1, 32 // (nt // p))}
    else:
        g = axis_tile(n1, tile)
    return {**g, "blocks": b * -(-n2 // g["L"])}


def step1_twiddle(xr, xi, tab, tw, inverse: bool = False,
                  tile: str | None = None, sms: int = H100_SMS):
    """Step 1's register core as its grid runs on planar (B, n1, n2):
    tile by tile (L consecutive lanes j2 of one b, :func:`step1_tile`,
    the ragged last tile masked) it reads the tile's columns whole, runs
    the row core's passes on each (``tab``: the core table of n1,
    unscaled), and stores output (k1, j2) times ``tw[k1, j2]`` (an
    (n1, n2, 2) table of (re, im) pairs) in the kernel's order of f32
    operations. Lanes no tile writes stay NaN."""
    b, n1, n2 = xr.shape
    tl = step1_tile(n1, n2, b, tile, sms)["L"]
    wr, wi = tw[..., 0], tw[..., 1]
    yr = torch.full_like(xr, float("nan"))
    yi = torch.full_like(xi, float("nan"))
    for bb in range(b):
        for l0 in range(0, n2, tl):
            sl = slice(l0, min(l0 + tl, n2))
            vr, vi = fft_rows(xr[bb, :, sl].t(), xi[bb, :, sl].t(), tab,
                              inverse)
            vr, vi = vr.t(), vi.t()
            yr[bb, :, sl] = vr * wr[:, sl] - vi * wi[:, sl]
            yi[bb, :, sl] = vr * wi[:, sl] + vi * wr[:, sl]
    return yr, yi


def step3_geometry(n2: int) -> dict:
    """The block of step 3's register core (``regs::TrGeo``; at a mixed
    length ``MixTrGeo`` of ``csrc/fourstep_mix.cu``) at length n2 in its
    layout (R, C) (``fourstep._step3_layout``): R rows a run, held by a
    cluster of C blocks of RB = R / C rows; P threads a row, V values a
    thread, W rows a warp, the stage's swizzle (RS columns, shift SH) and
    a block's shared memory in bytes (the rows' exchange planes EX or the
    stage ST, the larger)."""
    from . import fourstep
    sched = passes(n2)
    r, c = fourstep._step3_layout(n2)
    v = fused_fft._reg_values(n2)
    p = n2 // v
    rb = r // c
    rs = min(rb, 32)
    ex = 2 * rb * geometry(n2)["PITCH"] * 4 if len(sched) > 1 else 0
    st = 2 * n2 * rb * 4
    return {"P": p, "V": v, "R": r, "C": c, "RB": rb, "threads": rb * p,
            "W": max(1, 32 // p), "RS": rs,
            "SH": (32 // rs).bit_length() - 1, "EX": ex, "ST": st,
            "SMEM": max(ex, st)}


def step3_at(g: dict, k, c):
    """Slot of stage element (k, c) (output k of the block's row c) in a
    block's stage of :func:`step3_geometry` ``g``: k R + c XOR-swizzled
    by k's bits above those that pick the bank group."""
    return k * g["RB"] + (c ^ (((k >> g["SH"]) * g["W"]) & (g["RS"] - 1)))


def _step3_rows(x, tab, inverse: bool):
    """The transforms of one block's rows (R, n2) complex64 as
    step 3's core runs them: at a mixed n2 the block's threads through the
    mixed rows' swizzled exchange planes (:func:`rows_mix_block`), at a
    power of two the row core's passes (:func:`fft_rows`)."""
    n2 = x.shape[-1]
    if n2 in fused_fft._MIX_LENGTHS:
        return rows_mix_block(x, tab, inverse)
    vr, vi = fft_rows(x.real.contiguous(), x.imag.contiguous(), tab,
                      inverse)
    return torch.complex(vr, vi)


def step3_transposed(zr, zi, tab, inverse: bool = False):
    """Step 3's register core as its grid runs on planar (B, n1, n2):
    block by block (R consecutive rows r = b n1 + k1, the ragged last
    block masked, its rows zero) the row core's passes on each row
    (``tab``: the core table of n2; at a mixed n2 the block's threads
    through the mixed rows' exchange planes, :func:`rows_mix_block`),
    output k of the block's row c into the stage at :func:`step3_at`,
    then each k's run of R floats read back from the stage and stored to
    (b n2 + k) n1 + k1, every row finding its own b (a block's rows may
    span two batches); in clusters of C blocks, column c from block
    c // (R / C). Returns (B, n2, n1); elements no block writes stay
    NaN."""
    b, n1, n2 = zr.shape
    g = step3_geometry(n2)
    r, rb = g["R"], g["RB"]
    nrows = b * n1
    x = torch.complex(zr, zi).reshape(nrows, n2)
    yr = torch.full((b * n2 * n1,), float("nan"))
    yi = torch.full_like(yr, float("nan"))
    k = torch.arange(n2)[:, None]
    for row0 in range(0, nrows, r):
        valid = min(r, nrows - row0)
        blk = torch.zeros(r, n2, dtype=torch.complex64)
        blk[:valid] = x[row0:row0 + valid]
        v = _step3_rows(blk, tab, inverse)
        # each block of the cluster writes its stage; the runs read them
        cols = torch.arange(r)[None, :]
        q, cb = cols // rb, cols % rb
        st_r = torch.empty(g["C"], n2 * rb)
        st_i = torch.empty(g["C"], n2 * rb)
        at = step3_at(g, k, cb).expand(n2, r)
        st_r[q.expand(n2, r), at] = v.real.t()
        st_i[q.expand(n2, r), at] = v.imag.t()
        rr = row0 + torch.arange(valid)
        base = (rr // n1) * n2 * n1 + rr % n1
        dst = base[None, :] + k * n1
        yr[dst] = st_r[q[:, :valid].expand(n2, valid), at[:, :valid]]
        yi[dst] = st_i[q[:, :valid].expand(n2, valid), at[:, :valid]]
    return yr.reshape(b, n2, n1), yi.reshape(b, n2, n1)


def step3_ways(n2: int) -> dict:
    """Wavefronts per warp instruction on a block's stage of step 3
    (:func:`step3_geometry`): "put", the row core's output writes (thread
    (g, t) = (tid // P, tid % P) writes element e = t + q P + k n2/R_last
    of row g; at a mixed n2, R_last = V: e = t + k P), and "get", the
    runs' reads (thread tid reads column c = tid mod R of element
    k = tid // R + i NT / R, i < n2 / P, from the stage of block c // RB,
    counted on each block it reads). 1 means free of bank conflicts."""
    g = step3_geometry(n2)
    p, r, rb, nv = g["P"], g["R"], g["RB"], g["V"]
    tid = np.arange(g["threads"])
    row, t = tid // p, tid % p
    rl, _ = passes(n2)[-1]
    put = max(_ways(step3_at(g, t + q * p + kk * (n2 // rl), row)
                    .reshape(-1, 32).tolist())
              for q in range(nv // rl) for kk in range(rl))
    c = tid % r
    get = 1
    for i in range(n2 // p):
        addr = step3_at(g, tid // r + i * (g["threads"] // r), c % rb)
        for w in range(g["threads"] // 32):
            sel = slice(32 * w, 32 * w + 32)
            src = c[sel] // rb
            for blk in set(src.tolist()):
                get = max(get, _ways([addr[sel][src == blk].tolist()]))
    return {"put": put, "get": get}


def step3_runs(n2: int) -> int:
    """The floats of the longest run of consecutive k1 that one warp
    instruction of step 3's stores writes in device memory (rows of one
    batch): R, at most a warp's 32."""
    return min(32, step3_geometry(n2)["R"])


# ---- the cube (csrc/fft_cube_regs.cu) ----

def cube_split(z: int, split=None):
    """(n1, n2) of the register cube's split z, or None where z runs as
    rows: ``split`` as given (both powers of two in [16, 4096], n1 n2 = z:
    a CPU test forces one at a short z), else ``fourstep.pick_split(z)``
    past ``fused_fft._CUBE_ROWS_MAX`` (8192: (64, 128); 16384: (128, 128);
    32768: (128, 256))."""
    if split is None:
        if z <= fused_fft._CUBE_ROWS_MAX:
            return None
        from . import fourstep
        split = fourstep.pick_split(z)
    n1, n2 = split
    if n1 * n2 != z or not (fused_fft._pow2(n1) and fused_fft._pow2(n2)):
        raise ValueError(f"split {split} of z = {z}: two powers of two in "
                         "[16, 4096]")
    return n1, n2


def cube_geometry(b: int, x: int, y: int, z: int, group=None,
                  split=None) -> dict:
    """How the register cube walks b cubes of (X, Y, Z): G cubes a phase
    (``group``, else ``fused_fft._cube_group``), the groups, the z split
    (:func:`cube_split`) and the grid-wide barriers of the call
    (``fused_fft._cube_barriers``)."""
    g = min(group or fused_fft._cube_group(x, y, z), b)
    sp = cube_split(z, split)
    return {"G": g, "groups": -(-b // g), "split": sp,
            "barriers": fused_fft._cube_barriers(b, g, sp is not None)}


def _cube_cols(xr, xi, n: int, ts, inverse: bool, dim: int,
               scale: float = 1.0):
    """One column phase of the cube along ``dim``, ``scale`` at the store:
    the column variant (:func:`fft_cols`), or at a length under 16 the
    kernel's thread a line (``dft_short``): output k sums value j times
    W_N^(j k mod N), read from the first N rows of the core table of N
    (conjugate for the inverse). The kernel runs the radix-2 network at 2,
    4 and 8, the same sums in another order."""
    tab = ts.get("core", n, fused_fft._stages(n, None), inverse, 1.0)
    if n >= 16:
        return fft_cols(xr, xi, tab, inverse, scale, dim=dim)
    k = torch.arange(n)
    w = torch.complex(tab[:n, 0], tab[:n, 1])[k[:, None] * k % n]
    d = torch.complex(xr, xi).movedim(dim, -1) @ w * scale
    d = d.movedim(-1, dim)
    return d.real.contiguous(), d.imag.contiguous()


def fft_cube(xr, xi, tabs, inverse: bool = False, scale: float = 1.0,
             split=None, group=None):
    """The register cube as its cooperative grid runs, on planar
    (..., X, Y, Z): group by group (:func:`cube_geometry`, G cubes a
    phase), each phase over the group's G cubes: z as rows
    (:func:`fft_rows`) or, split (n1, n2) (:func:`cube_split`), step 1 at
    n1 (:func:`step1_twiddle` on the narrow tile, times the four-step
    twiddle) then step 3 at n2 (:func:`step3_transposed`) into the
    output's natural order; then y on the column variant at stride Z and x
    at stride Y Z, ``scale`` at x's store (an axis under 16 a thread a
    line, :func:`_cube_cols`). ``tabs``: a ``fused_fft.TableSet`` on the
    CPU (the kernel's tables: core tables of the default stages, the
    four-step twiddle)."""
    nx, ny, nz = xr.shape[-3:]
    b = xr.numel() // (nx * ny * nz)
    geo = cube_geometry(b, nx, ny, nz, group, split)
    g = geo["G"]
    xr4, xi4 = xr.reshape(b, nx, ny, nz), xi.reshape(b, nx, ny, nz)
    yr, yi = torch.empty_like(xr4), torch.empty_like(xi4)

    def core(n):
        return tabs.get("core", n, fused_fft._stages(n, None), inverse, 1.0)

    for c0 in range(0, b, g):
        cr, ci = xr4[c0:c0 + g], xi4[c0:c0 + g]
        if geo["split"] is None:
            cr, ci = fft_rows(cr, ci, core(nz), inverse)
        else:
            n1, n2 = geo["split"]
            lines = cr.numel() // nz
            zr, zi = step1_twiddle(
                cr.reshape(lines, n1, n2), ci.reshape(lines, n1, n2),
                core(n1), tabs.get("fourstep", n1, n2, inverse, 1.0),
                inverse, tile="narrow")
            cr, ci = step3_transposed(zr, zi, core(n2), inverse)
            cr, ci = cr.reshape(-1, nx, ny, nz), ci.reshape(-1, nx, ny, nz)
        cr, ci = _cube_cols(cr, ci, ny, tabs, inverse, 2)
        cr, ci = _cube_cols(cr, ci, nx, tabs, inverse, 1, scale)
        yr[c0:c0 + g], yi[c0:c0 + g] = cr, ci
    return yr.reshape(xr.shape), yi.reshape(xi.shape)
