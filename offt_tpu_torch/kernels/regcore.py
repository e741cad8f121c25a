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
the addresses the kernel computes, :func:`fft_last` a batch). No CPU can
run that
kernel, so the tests hold this replay of it against numpy and the JAX
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
then y columns in place), :func:`rfft_slab` (r2c rows, then y columns)
and :func:`irfft_slab` (y columns, then the c2r rows,
:func:`rows_c2r`, with the kernel's re-tangle :func:`retangle_pair`);
and the four-step pair: :func:`step1_twiddle` (the column variant tile
by tile, :func:`step1_tile`, the twiddle at the store) and
:func:`step3_transposed` (rows block by block into the swizzled stage of
:func:`step3_geometry` / :func:`step3_at`, then the transposed runs,
:func:`step3_runs`, its banks counted by :func:`step3_ways`).
What the kernels do around the core only moves values: ``rfft_last``
stages a block's output rows back in the exchange planes to copy them
out whole, ``fft_last`` moves rows of fewer than 8 threads (N < 128) in
and out through a stage, and the cluster layouts move lines between
blocks; none of that is replayed here. The package's own routes never
call this module: on the CPU the kernel wrappers run their plain
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
    last where log2 P is odd, then radix 4 R0 at stride P; Ns = the
    product of the radices before."""
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
                         f"[16, 4096] and the mixed lengths 3 2^k, 5 2^k "
                         f"(16 <= 2^k <= 512; 3072 as rows), not {n}")
    out, ns = [], 1
    for r in rads:
        out.append((r, ns))
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
    length."""
    pitch = geometry(n)["PITCH"]
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


# the constant roots of regs::dft3 / dft5, in f32
_SIN3 = np.float32(0.86602540378443865)
_C51, _C52 = np.float32(0.30901699437494742), np.float32(-0.80901699437494742)
_S51, _S52 = np.float32(0.95105651629515357), np.float32(0.58778525229247313)


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


def dft_pfa(v, inverse: bool = False):
    """The R-point DFT along the last axis, R = 4 R0 (12, 20), as
    ``regs::dft_pfa`` composes it (Good-Thomas, no twiddles): input
    n = (4 n1 + R0 n2) mod R; R0-point DFTs along n1, then 4-point DFTs
    along n2 in place; X[k] read where k mod R0 and k mod 4 left it."""
    r = v.shape[-1]
    r0 = r // 4
    if r not in (12, 20):
        raise ValueError(f"no Good-Thomas network of radix {r}")
    x = list(v.unbind(-1))
    net = _dft3 if r0 == 3 else _dft5
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
        y = dft_pfa(v, inverse) if r in (12, 20) else v @ _dft(r, inverse)
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
        v[:, q * r:(q + 1) * r] = (dft_pfa(blk, inverse) if r in (12, 20)
                                   else blk @ _dft(r, inverse))


def rows_mix_block(x, tab, inverse: bool = False):
    """One block of ``regs::rows_mix`` as it runs, at a mixed length n:
    ``x`` the block's ROWS rows (ROWS, n) complex64 (rows past the batch
    zero), thread (g, t) = (tid // P, tid % P) of row g. It loads element
    t + q P + k n/4, runs the first pass, then for each later pass puts
    the outputs into the block's exchange plane and gets the inputs back
    at the addresses the kernel computes: the thread's swizzled base
    mix_at(X) ^ row_mask(g), X the part of the element its t sets, XOR
    mix_at(C) of the compile-time part C (put: X = (t div Ns) Ns R +
    t mod Ns, C = q P R + k Ns; get: X = t, C = P (q + k V/R)). Returns
    the (ROWS, n) output, element t + k P from the last pass's v[k]."""
    n = x.shape[-1]
    geo = geometry(n)
    p, rows, pitch, nv = geo["P"], geo["ROWS"], geo["PITCH"], geo["V"]
    sched = passes(n)
    tid = torch.arange(THREADS)
    g, t = tid // p, tid % p
    gm = row_mask(n, g)
    w = torch.complex(tab[:n, 0], tab[:n, 1])
    v = torch.empty(THREADS, nv, dtype=torch.complex64)
    r, _ = sched[0]
    for q in range(nv // r):
        for k in range(r):
            v[:, q * r + k] = x[g, t + q * p + k * (n // r)]
    _butterflies(v, n, r, 1, t, p, w, inverse)
    plane = torch.full((rows * pitch,), complex("nan"), dtype=torch.complex64)
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
    out = torch.empty(rows, n, dtype=torch.complex64)
    for k in range(nv):
        out[g, t + k * p] = v[:, k]
    return out


def fft_last(xr, xi, tab, inverse: bool = False, scale: float = 1.0,
             alias: bool = False):
    """``fft_last``'s register core on planar (..., n) as its grid runs:
    at a mixed length block by block (:func:`rows_mix_block`, ROWS rows a
    block, the ragged last one masked), at a power of two :func:`fft_rows`;
    ``scale`` at the store. ``alias`` writes over the inputs (a block
    reads its rows whole before it writes any)."""
    n = xr.shape[-1]
    if n in fused_fft._MIX_ROW_LENGTHS:
        rows = geometry(n)["ROWS"]
        x = torch.complex(xr, xi).reshape(-1, n)
        y = torch.empty_like(x)
        for b0 in range(0, x.shape[0], rows):
            k = min(rows, x.shape[0] - b0)
            blk = torch.zeros(rows, n, dtype=torch.complex64)
            blk[:k] = x[b0:b0 + k]
            y[b0:b0 + k] = rows_mix_block(blk, tab, inverse)[:k] * scale
        y = y.reshape(xr.shape)
        yr, yi = y.real.contiguous(), y.imag.contiguous()
    else:
        yr, yi = fft_rows(xr, xi, tab, inverse, scale)
    if alias:
        xr.copy_(yr)
        xi.copy_(yi)
        return xr, xi
    return yr, yi


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


def col_at(n: int, a, threads: int = THREADS):
    """Offset, in a column block's exchange plane, of element a of lane 0
    (lane l adds l): the lane is the fastest index, one pad slot per 16
    elements (``ColLay``), per 4 at a mixed length (``MixColGeo``); at
    one lane a block (n = 4096 in 256 threads) a lane is a row, at
    phys."""
    lanes = threads // (n // fused_fft._reg_values(n))
    if lanes == 1:
        return phys(a)
    sh = 2 if n in fused_fft._MIX_LENGTHS else 4
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
    32 P threads up to 1024 (P >= 16: n >= 256, or 192, 320 mixed)."""
    passes(n)
    tile = tile or fused_fft._axis_tile(n)
    p = n // fused_fft._reg_values(n)
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
    for i, (r, ns) in enumerate(sched):
        nb = fused_fft._reg_values(n) // r
        if i > 0:
            out[(i, "get")] = max(
                _ways(addr(t + q * p + k * (n // r)).reshape(-1, 32).tolist())
                for q in range(nb) for k in range(r))
        if i < len(sched) - 1:
            worst = 1
            for q in range(nb):
                j = t + q * p
                d = (j // ns) * ns * r + j % ns
                if ns == 1 and vec4:
                    for k in range(0, r, 4):
                        chunk = addr(d + k) // 4
                        worst = max(worst, _ways(chunk.reshape(-1, 8)
                                                 .tolist(), BANKS // 4))
                else:
                    for k in range(r):
                        worst = max(worst, _ways(addr(d + k * ns)
                                                 .reshape(-1, 32).tolist()))
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
    16, ``dft5`` 48 (an FMA counts two); Good-Thomas 4 R0: four R0-point
    and R0 4-point networks."""
    if r in (12, 20):
        return 4 * _net_flops(r // 4) + (r // 4) * _net_flops(4)
    if r in (3, 5):
        return {3: 16, 5: 48}[r]
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
             scale: float = 1.0, tile: str | None = None) -> None:
    """The strided-axis kernel's register core at length n as its grid
    runs, on flat f32 buffers: ``geom`` = (nb, ny, nz, in strides (b, n,
    y), out strides (b, n, y)) of ``fused_fft._axis_apply``, element
    (b, n, y, z) at b sb + n sn + y sy + z, a line per lane l = y nz + z.
    Tile by tile (L consecutive lanes of one b, :func:`axis_tile`, the
    ragged last one masked) it reads the tile's lines whole, runs the row
    core's passes on each, and writes them times ``scale``: so (yr, yi)
    may be (xr, xi), in place."""
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
            vr, vi = fft_rows(xr[src].t(), xi[src].t(), tab, inverse, scale)
            yr[dst] = vr.t()
            yi[dst] = vi.t()


def retangle_pair(xr, xi, ab):
    """The c2r re-tangle of packed rows (..., M) as the kernel computes it
    (``regs::retangle_pair``): element k of the pair (k, M - k),
    V[k] = a[k] X[k] + b[k] conj X[(M - k) mod M], (a, b) = ``ab[k]`` of
    ``tables.crfft_table`` (the scale folded in), in the kernel's order of
    f32 operations."""
    m = xr.shape[-1]
    mk = (-torch.arange(m)) % m
    yr, yi = xr[..., mk], xi[..., mk]
    ar, ai, br, bi = ab[:, 0, 0], ab[:, 0, 1], ab[:, 1, 0], ab[:, 1, 1]
    return (ar * xr - ai * xi + br * yr + bi * yi,
            ar * xi + ai * xr + bi * yr - br * yi)


def rows_c2r(xr, xi, tab, ab):
    """The kernel's c2r of packed rows (..., M): the re-tangle, the inverse
    M-point core (``tab``, a ``core_table`` of M), then x[2j] + i x[2j+1]
    = v[j]: real (..., 2M)."""
    vr, vi = retangle_pair(xr, xi, ab)
    vr, vi = fft_rows(vr, vi, tab, inverse=True)
    return torch.stack([vr, vi], -1).reshape(*xr.shape[:-1], 2 * xr.shape[-1])


def irfft_slab(xr, xi, tabz, taby, ab, side_r=None, side_i=None):
    """The register ``irfft_slab`` on a packed planar (..., Y, M + pad)
    half-spectrum, as both of its layouts run it: the first M lanes' y
    lines on the column variant, inverse and unscaled (lane 0 plus
    i side where the (..., Y) side plane is given), then the c2r rows of
    the (..., Y, M) result (``tabz``: the core table of M; ``ab``:
    ``tables.crfft_table(2M, scale)``, M rows): real (..., Y, 2M)."""
    m = ab.shape[0]
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
    the swizzled exchange planes); then the y columns in place on it,
    ``scale`` at their store (at a mixed Y the strided-axis kernel's tiles,
    :func:`fft_axis`, on the (x-rows, Y, 1, Z lanes) geometry).
    ``alias`` writes over the inputs."""
    ny = xr.shape[-2]
    nz = z_true or xr.shape[-1]
    zr, zi = fft_last(xr[..., :nz].contiguous(), xi[..., :nz].contiguous(),
                      tabz, inverse)
    if ny in fused_fft._MIX_LENGTHS:
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
    pitch M + ``zpad``, then the y columns in place on it. Unscaled."""
    m = x.shape[-1] // 2
    zr, zi = rfft_rows(x, tabz, w, packed=True)
    vr, vi = fft_cols(zr, zi, taby, dim=-2)
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
    """The block of step 3's register core (``regs::TrGeo``) at length
    n2 in its layout (R, C) (``fourstep._step3_layout``): R rows a run,
    held by a cluster of C blocks of RB = R / C rows; P threads a row, W
    rows a warp, the stage's swizzle (RS columns, shift SH) and a block's
    shared memory in bytes (the rows' exchange planes EX or the stage ST,
    the larger)."""
    from . import fourstep
    sched = passes(n2)
    r, c = fourstep._step3_layout(n2)
    p = n2 // E
    rb = r // c
    rs = min(rb, 32)
    ex = 2 * rb * geometry(n2)["PITCH"] * 4 if len(sched) > 1 else 0
    st = 2 * n2 * rb * 4
    return {"P": p, "R": r, "C": c, "RB": rb, "threads": rb * p,
            "W": max(1, 32 // p), "RS": rs,
            "SH": (32 // rs).bit_length() - 1, "EX": ex, "ST": st,
            "SMEM": max(ex, st)}


def step3_at(g: dict, k, c):
    """Slot of stage element (k, c) (output k of the block's row c) in a
    block's stage of :func:`step3_geometry` ``g``: k R + c XOR-swizzled
    by k's bits above those that pick the bank group."""
    return k * g["RB"] + (c ^ (((k >> g["SH"]) * g["W"]) & (g["RS"] - 1)))


def step3_transposed(zr, zi, tab, inverse: bool = False):
    """Step 3's register core as its grid runs on planar (B, n1, n2):
    block by block (R consecutive rows r = b n1 + k1, the ragged last
    block masked) the row core's passes on each row (``tab``: the core
    table of n2), output k of the block's row c into the stage at
    :func:`step3_at`, then each k's run of R floats read back from the
    stage and stored to (b n2 + k) n1 + k1, every row finding its own b
    (a block's rows may span two batches); in clusters of C blocks,
    column c from block c // (R / C). Returns (B, n2, n1); elements no
    block writes stay NaN."""
    b, n1, n2 = zr.shape
    g = step3_geometry(n2)
    r, rb = g["R"], g["RB"]
    nrows = b * n1
    xr, xi = zr.reshape(nrows, n2), zi.reshape(nrows, n2)
    yr = torch.full((b * n2 * n1,), float("nan"))
    yi = torch.full_like(yr, float("nan"))
    k = torch.arange(n2)[:, None]
    for row0 in range(0, nrows, r):
        valid = min(r, nrows - row0)
        vr = torch.zeros(r, n2)
        vi = torch.zeros(r, n2)
        vr[:valid], vi[:valid] = fft_rows(xr[row0:row0 + valid],
                                          xi[row0:row0 + valid], tab,
                                          inverse)
        # each block of the cluster writes its stage; the runs read them
        cols = torch.arange(r)[None, :]
        q, cb = cols // rb, cols % rb
        st_r = torch.empty(g["C"], n2 * rb)
        st_i = torch.empty(g["C"], n2 * rb)
        at = step3_at(g, k, cb).expand(n2, r)
        st_r[q.expand(n2, r), at] = vr.t()
        st_i[q.expand(n2, r), at] = vi.t()
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
    of row g), and "get", the runs' reads (thread tid reads column
    c = tid mod R of element k = tid // R + i NT / R, from the stage of
    block c // RB, counted on each block it reads). 1 means free of bank
    conflicts."""
    g = step3_geometry(n2)
    p, r, rb = g["P"], g["R"], g["RB"]
    tid = np.arange(g["threads"])
    row, t = tid // p, tid % p
    rl, _ = passes(n2)[-1]
    put = max(_ways(step3_at(g, t + q * p + kk * (n2 // rl), row)
                    .reshape(-1, 32).tolist())
              for q in range(E // rl) for kk in range(rl))
    c = tid % r
    get = 1
    for i in range(E):
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
