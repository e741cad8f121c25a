"""The register core's pass schedule, replayed with torch ops on the CPU.

``csrc/fft_regs.cuh`` runs a length-n line (n a power of two in
[16, 4096]) as radix-R Stockham passes on P = n / 16 threads of 16
complex values each, as a contiguous row (``fft_last``, ``rfft_last``,
the slabs' z pass, the c2r rows) or, in its column variant, along a
strided axis (``fft_axis``, the slabs' y pass). No CPU can run that
kernel, so the tests hold this replay of it against numpy and the JAX
reference: the same pass radices and strides (:func:`passes`), the same
twiddle indices into the first n rows of ``tables.core_table`` and the
same input gathers and output scatters (:func:`pass_maps`), and the same
shared-memory geometry of rows (:func:`geometry`, :func:`phys`) and
columns (:func:`col_geometry`, :func:`col_at`), with :func:`bank_ways`
and :func:`col_bank_ways` counting the exchanges' bank conflicts; the
strided-axis kernel's lane tiles (:func:`axis_tile`, :func:`warp_runs`;
the routed one read from ``fused_fft._axis_tile``); and the slab a
cluster of blocks holds in shared memory (:func:`cluster_geometry`,
:func:`cluster_ways`). The butterflies are the R-point DFT in f32 (the
kernel's radix-2 network computes the same function in another rounding
order). The kernels on
the column variant are replayed as their grids run: :func:`fft_axis`
(tile by tile on the (B, N, Y, Z) geometry), :func:`fft_slab` (z rows,
then y columns in place), :func:`rfft_slab` (r2c rows, then y columns)
and :func:`irfft_slab` (y columns, then the c2r rows,
:func:`rows_c2r`, with the kernel's re-tangle :func:`retangle_pair`).
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


def col_at(n: int, a, threads: int = THREADS):
    """Offset, in a column block's exchange plane, of element a of lane 0
    (lane l adds l): the lane is the fastest index, one pad slot per 16
    elements; at one lane a block (n = 4096 in 256 threads) a lane is a
    row, at phys."""
    lanes = threads // (n // E)
    if lanes == 1:
        return phys(a)
    return (a + (a >> 4)) * lanes


def col_geometry(n: int, threads: int = THREADS) -> dict:
    """The block geometry of ``regs::ColGeo`` in a block of ``threads``:
    threads per lane P, lanes per block L (thread (t, l) = (tid // L,
    tid % L)), row threads per warp W, one plane's floats SIZE (a multiple
    of 4) and the block's dynamic shared memory in bytes (none for one
    pass)."""
    sched = passes(n)
    p = n // E
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
    32 P threads up to 1024 (n >= 256)."""
    passes(n)
    tile = tile or fused_fft._axis_tile(n)
    p = n // E
    if tile == "narrow":
        nt = THREADS
    elif tile == "wide" and n >= 256:
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
    p = n // E
    out = {}
    sched = passes(n)
    for i, (r, ns) in enumerate(sched):
        nb = E // r
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
    256 / P rows, each in its own planes at pitch PITCH."""
    g = geometry(n)
    p, pitch = g["P"], g["PITCH"]
    lanes = np.arange(THREADS)
    row, t = lanes // p, lanes % p
    return _exchange_ways(n, t, lambda a: row * pitch + phys(a), True)


def col_bank_ways(n: int, threads: int = THREADS) -> dict:
    """The column variant's exchanges (:func:`_exchange_ways`): a block of
    ``threads``, L lanes, thread (t, l) = (tid // L, tid % L), element a of
    lane l at col_at(a) + l; float4 writes only at one lane a block."""
    g = col_geometry(n, threads)
    lanes = np.arange(threads)
    lane, t = lanes % g["L"], lanes // g["L"]
    return _exchange_ways(n, t, lambda a: col_at(n, a, threads) + lane,
                          g["L"] == 1)


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
    output of pitch Z + ``zpad``; then the y columns in place on it,
    ``scale`` at their store. ``alias`` writes over the inputs."""
    nz = z_true or xr.shape[-1]
    zr, zi = fft_rows(xr[..., :nz], xi[..., :nz], tabz, inverse)
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
