"""Long 1-D c2c by the four-step factorization n = n1 * n2, with its CUDA
kernels.

Counterpart of ``offt_tpu/kernels/fourstep.py``. The length-n vector is
viewed as an (n1, n2) matrix and

    step 1: FFT_{n1} along the middle axis,
    step 2: times the twiddle T[k1, j2] = W_n^(k1 j2) (all scaling folded
            in),
    step 3: FFT_{n2} along the last axis,
    step 4: transpose (n1, n2) -> (n2, n1), the natural order
            X[k1 + n1 k2].

When both factors are multiples of 128 (the reference's gate, kept so
that both packages take the same route) steps 1+2 are one kernel
(``_step1_twiddle``) and steps 3+4 another (``_step3_transposed``), both in
``csrc/fourstep.cu``. Each runs the register core where its own length is
a power of two in [16, 4096] (``fused_fft._reg_core``; step 1 on the
column variant, its lane tile from :func:`_step1_tile`; step 3 on the row
core with a transposing store, in the layout of :func:`_step3_layout`),
else
the dense core. Other splits take the reference's 4-pass route: the
strided-axis kernel, a torch twiddle multiply, the last-axis kernel and a
torch transpose. There is no ``OFFT_FOURSTEP_FUSED`` switch: it was a TPU
A/B knob.

``pick_split`` keeps the reference's one measured split, 3 * 2^18 ->
(1024, 768), so that the routes stay equal; whether Hopper wants it is
ROADMAP Queue 1 item 8.
"""

from __future__ import annotations

import functools
import math

import torch

from . import fused_fft as ff
from . import tables as tb

# the reference's split-order wisdom (offt_tpu/kernels/fourstep.py:55),
# measured on a TPU and kept for route parity
_MEASURED_SPLITS = {3 * (1 << 18): (1024, 768)}


def pick_split(n: int, split=None):
    """(n1, n2) with n1 * n2 == n, both 2-stage expressible, or None; an
    explicit ``split`` is validated only. Auto: the measured split first,
    else the most balanced pair, preferring 128-multiple extents (the lane
    side first) and then n1 <= n2: the reference's ranking, candidate for
    candidate. Memoised: the search visits every divisor up to sqrt(n),
    0.3 ms of host time at 2^20, and a plan asks on every call."""
    if split is not None:
        split = (int(split[0]), int(split[1]))
    return _pick_split(int(n), split)


@functools.lru_cache(maxsize=1024)
def _pick_split(n: int, split):
    if n <= 1:
        return None

    def _ok(a, b):
        return (a > 1 and b > 1 and ff.can_use_pallas(a)
                and ff.can_use_pallas(b))

    if split is not None:
        n1, n2 = int(split[0]), int(split[1])
        if n1 * n2 == n and _ok(n1, n2):
            return n1, n2
        return None
    m = _MEASURED_SPLITS.get(n)
    if m is not None and _ok(*m):
        return m
    best = None
    for d in range(2, math.isqrt(n) + 1):
        if n % d:
            continue
        for n1, n2 in ((d, n // d), (n // d, d)):
            if not _ok(n1, n2):
                continue
            key = (0 if n2 % 128 == 0 else 1, 0 if n1 % 128 == 0 else 1,
                   max(n1, n2) / min(n1, n2), 0 if n1 <= n2 else 1)
            if best is None or key < best[0]:
                best = (key, (n1, n2))
    return best[1] if best else None


def can_use_four_step(n: int, split=None) -> bool:
    """True when the four-step route applies and the one 2-stage kernel
    does not."""
    return not ff.can_use_pallas(n) and pick_split(n, split) is not None


def _check_3d(xr3, n1, n2, what):
    if xr3.ndim != 3 or tuple(xr3.shape[1:]) != (n1, n2):
        raise ValueError(f"{what} wants (B, {n1}, {n2}) data, got "
                         f"{tuple(xr3.shape)}")


# the register core's lane tiles of step 1 and their codes in
# csrc/fourstep.cu: the strided-axis kernel's two (fused_fft._AXIS_TILES)
# and "half", half the wide tile's lanes and threads (n1 = 512, 1024)
_STEP1_TILES = {**ff._AXIS_TILES, "half": 2}


# the wide grid's blocks, over the card's SMs, up to which step 1's half
# tile ran faster than the wide one (:func:`_step1_tile`)
_HALF_TILE_UP_TO = {512: 4.0, 1024: 0.5}


def _step1_tile(n1: int, n2: int, b: int, sms: int) -> str:
    """The lane tile step 1's register core launches on (b, n1, n2) on a
    card of ``sms`` streaming multiprocessors, the one place it is
    picked: the strided-axis kernel's (``fused_fft._axis_tile``: narrow
    to n1 = 128, wide from 256), but "half" (half the wide tile's lanes
    and threads) where the wide grid would have at most
    ``_HALF_TILE_UP_TO[n1]`` times as many blocks as the card has SMs.
    On an H100 at 700 W (132 SMs; PERF.md §6,
    ``bench/probe_fourstep.py``; wide / half ms by wide blocks):
    n1 = 1024 (half: 8 lanes, runs of 32 bytes) 64 blocks 0.0143 /
    0.0134, 96 0.0159 / 0.0178, 128 ((1, 1024, 2048)) 0.0241 / 0.0267,
    192 0.0354 / 0.0379, 256 0.0406 / 0.0450, 384 0.0567 / 0.0642, 512
    0.0717 / 0.0827: half only while its grid fits one block an SM.
    n1 = 512 (half: 16 lanes, runs of 64 bytes) 64 blocks 0.0141 /
    0.0109, 128 0.0199 / 0.0178, 256 0.0387 / 0.0361, 512 0.0686 /
    0.0663: half throughout; wider grids were not measured and keep the
    wide tile. At 2048 the half tile would have 4 lanes
    (runs of 16 bytes): 0.0858 against the wide tile's 0.0515 at
    (1, 2048, 2048), so there is none."""
    tile = ff._axis_tile(n1)
    up_to = _HALF_TILE_UP_TO.get(n1)
    if up_to is not None:
        lanes = min(32, 1024 // (n1 // 16))
        if b * -(-n2 // lanes) <= up_to * sms:
            return "half"
    return tile


def _sms(device) -> int:
    """The streaming multiprocessors of the CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _step3_layout(n2: int) -> tuple:
    """(R, C) of step 3's register core at length n2, as ``step3_regs``
    of ``csrc/fourstep.cu`` chooses it (the kernel is passed no layout):
    R consecutive rows stored as runs of R floats, held by a cluster of C
    blocks of R / C rows each (C = 1: one block). The row kernel's 4096 /
    n2 rows in 256
    threads to 512, then 8 (512 threads at 1024, 1024 at 2048); at 4096,
    where 8 rows would need a 256 KB stage, two blocks of 4 in a
    cluster. On an H100 at 700 W (PERF.md §6, ms): (1, 4096, 4096)
    0.1992-0.2003 against 0.3248-0.3346 for one block of 4 rows (runs of
    16 bytes); 16 rows a block at 1024, and 4 rows a block or clusters of
    two at 2048, ran level or slower."""
    return (4096 // n2 if n2 <= 512 else 8), 1 if n2 <= 2048 else 2


@ff._dispatching
def _step1_twiddle(mode, xr3, xi3, n1: int, n2: int, rad1, inverse: bool,
                   precision: str = ff.DEFAULT_PRECISION, scale: float = 1.0,
                   block: int = 0, tw=None, tables=None, tile=None):
    """Steps 1+2 (kernel ``step1_twiddle`` of ``csrc/fourstep.cu``):
    FFT_{n1} along the middle axis of planar (B, n1, n2), each output
    (k1, j2) times T[k1, j2]. T is ``tables.fourstep_twiddle(n1, n2,
    inverse, scale)``, or the caller's ``tw`` in the same (n1, n2, 2)
    float32 layout of (re, im) pairs, which carries all scaling (``scale``
    is then ignored).

    At a power of two n1 in [16, 4096] (``fused_fft._reg_core``) the
    kernel runs the register core's column variant with the twiddle at the
    store, on the lane tile of :func:`_step1_tile`: ``rad1`` is checked
    but does not shape its passes, and ``block`` is ignored. ``tile``, a
    key of ``_STEP1_TILES``, overrides the pick: a probe for
    ``bench/probe_fourstep.py`` on a CUDA device. Other lengths run the
    dense core, ``block`` lanes a CUDA block (a power of two; 0 = as many
    as fit 64 KB). The plain version is the dense core's arithmetic."""
    _check_3d(xr3, n1, n2, "step 1")
    stages = ff._stages(n1, rad1)
    reg = ff._reg_core(n1)
    if tile is not None and (tile not in _STEP1_TILES or mode != "kernel"
                             or not reg):
        raise ValueError(f"tile {tile!r} probes the register-core kernel "
                         f"on a CUDA device, one of {sorted(_STEP1_TILES)}")
    ts = ff._tables(tables, xr3.device)
    tab = ts.get("core", n1, stages, inverse, 1.0)
    if tw is None:
        tw = ts.get("fourstep", n1, n2, inverse, scale)
    if (not isinstance(tw, torch.Tensor) or tuple(tw.shape) != (n1, n2, 2)
            or tw.dtype != torch.float32):
        raise ValueError(f"twiddle table {type(tw).__name__} "
                         f"{tuple(getattr(tw, 'shape', ()))}, want an "
                         f"({n1}, {n2}, 2) float32 tensor")
    yr, yi = torch.empty_like(xr3), torch.empty_like(xi3)
    if mode == "shape":
        return yr, yi
    if mode == "plain":
        _step1_twiddle.plain_calls += 1
        ar, ai = ff._core_plain(xr3.transpose(1, 2), xi3.transpose(1, 2),
                                tab, n1, stages)
        ar, ai = ar.transpose(1, 2), ai.transpose(1, 2)
        wr, wi = tw[..., 0], tw[..., 1]
        yr.copy_(ar * wr - ai * wi)
        yi.copy_(ar * wi + ai * wr)
        return yr, yi
    b = xr3.shape[0]
    if xr3.numel():
        tw = tw.contiguous()
        if reg:
            tile = tile or _step1_tile(n1, n2, b, _sms(xr3.device))
            t, tcode = 0, _STEP1_TILES[tile]
        else:
            t, tcode = ff._cols_tile(n1, block, sum(stages)), 0
        ff._launch("offt_step1_twiddle", (xr3, xi3, yr, yi), (tab, tw),
                   [b, n1, n2, *ff._radix_args(stages), t, int(inverse),
                    int(reg), tcode])
        _step1_twiddle.launches += 1
        _step1_twiddle.reg_launches += reg
    return yr, yi


@ff._dispatching
def _step3_transposed(mode, zr3, zi3, n1: int, n2: int, rad2, inverse: bool,
                      precision: str = ff.DEFAULT_PRECISION, block: int = 0,
                      tables=None):
    """Steps 3+4 (kernel ``step3_transposed`` of ``csrc/fourstep.cu``):
    FFT_{n2} along the last axis of planar (B, n1, n2), written transposed
    into (B, n2, n1), the natural four-step order. No scale: step 1's
    table carries it.

    At a power of two n2 in [16, 4096] (``fused_fft._reg_core``) the
    kernel runs the register row core in the layout of
    :func:`_step3_layout`, R rows staged in shared memory and stored
    transposed in runs of R floats: ``rad2`` is checked but does not shape
    its passes, and ``block`` is ignored. Other lengths run the dense
    core, ``block`` rows a CUDA block (0 = as many as fit 64 KB, at most
    64). The plain version is the dense core's arithmetic."""
    _check_3d(zr3, n1, n2, "step 3")
    stages = ff._stages(n2, rad2)
    reg = ff._reg_core(n2)
    tab = ff._tables(tables, zr3.device).get("core", n2, stages, inverse,
                                             1.0)
    shp = (zr3.shape[0], n2, n1)
    yr = torch.empty(shp, dtype=zr3.dtype, device=zr3.device)
    yi = torch.empty(shp, dtype=zr3.dtype, device=zr3.device)
    if mode == "shape":
        return yr, yi
    if mode == "plain":
        _step3_transposed.plain_calls += 1
        ar, ai = ff._core_plain(zr3, zi3, tab, n2, stages)
        yr.copy_(ar.transpose(1, 2))
        yi.copy_(ai.transpose(1, 2))
        return yr, yi
    nrows = zr3.shape[0] * n1
    if nrows:
        t = 0 if reg else ff._rows_tile(n2, block, sum(stages))
        ff._launch("offt_step3_transposed", (zr3, zi3, yr, yi), (tab,),
                   [nrows, n1, n2, *ff._radix_args(stages), t, int(inverse),
                    int(reg)])
        _step3_transposed.launches += 1
        _step3_transposed.reg_launches += reg
    return yr, yi


def step12_planar(xr3, xi3, rad1, inverse: bool, precision: str, tw,
                  block: int = 0, tables=None):
    """Steps 1+2 of a distributed shard: (B, n1, n2_local) planar data with
    the caller's twiddle chunk ``tw``, an (n1, n2_local, 2) float32 tensor
    of (re, im) pairs (all scaling folded in)."""
    _, n1, n2l = xr3.shape
    return _step1_twiddle(xr3, xi3, n1, n2l, rad1, inverse, precision, 1.0,
                          block, tw=tw, tables=tables)


def step34_planar(zr3, zi3, rad2, inverse: bool, precision: str,
                  block: int = 0, tables=None):
    """Steps 3+4 of a distributed shard: (B, n1_local, n2) planar data
    written transposed into (B, n2, n1_local); no scaling."""
    _, n1l, n2 = zr3.shape
    return _step3_transposed(zr3, zi3, n1l, n2, rad2, inverse, precision,
                             block, tables=tables)


def fft_four_step_planar(xr, xi, inverse: bool = False, split=None,
                         precision: str = ff.DEFAULT_PRECISION,
                         out_scale: float = 1.0, block: int = 0,
                         tables=None):
    """Planar long 1-D FFT along the last axis (numpy fft/ifft semantics;
    leading axes are batch). The inverse 1/n and ``out_scale`` ride the
    four-step twiddle. Both factors 128-multiples: the two fused kernels;
    otherwise the 4-pass route. ``block`` is the reference's
    ``params.block_batch``, passed to each kernel's tile."""
    n = xr.shape[-1]
    sp = pick_split(n, split)
    if sp is None:
        raise ValueError(f"N={n} has no four-step split")
    n1, n2 = sp
    lead = xr.shape[:-1]
    scale = out_scale * ((1.0 / n) if inverse else 1.0)
    rad1, rad2 = tb._pick_stages(n1), tb._pick_stages(n2)
    if n1 % 128 == 0 and n2 % 128 == 0:
        b = math.prod(lead)
        zr, zi = _step1_twiddle(xr.reshape(b, n1, n2), xi.reshape(b, n1, n2),
                                n1, n2, rad1, inverse, precision, scale,
                                block, tables=tables)
        zr, zi = _step3_transposed(zr, zi, n1, n2, rad2, inverse, precision,
                                   block, tables=tables)
        return zr.reshape(*lead, n), zi.reshape(*lead, n)
    xr2, xi2 = xr.reshape(*lead, n1, n2), xi.reshape(*lead, n1, n2)
    yr, yi = ff.fft_sublane(xr2, xi2, xr2.ndim - 2, inverse=inverse,
                            precision=precision, block_lanes=block,
                            tables=tables)
    tw = ff._on(ff._tables(tables, xr.device).get("fourstep", n1, n2,
                                                  inverse, scale), yr)
    wr, wi = tw[..., 0], tw[..., 1]
    zr, zi = yr * wr - yi * wi, yr * wi + yi * wr
    zr, zi = ff.fft_last(zr, zi, inverse=inverse, precision=precision,
                         block_rows=block, tables=tables)
    return (zr.transpose(-1, -2).reshape(*lead, n),
            zi.transpose(-1, -2).reshape(*lead, n))
