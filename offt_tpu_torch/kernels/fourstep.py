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
``csrc/fourstep.cu``. Other splits take the reference's 4-pass route: the
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


@ff._dispatching
def _step1_twiddle(mode, xr3, xi3, n1: int, n2: int, rad1, inverse: bool,
                   precision: str = ff.DEFAULT_PRECISION, scale: float = 1.0,
                   block: int = 0, tw=None, tables=None):
    """Steps 1+2 (kernel ``step1_twiddle`` of ``csrc/fourstep.cu``):
    FFT_{n1} along the middle axis of planar (B, n1, n2), each output
    (k1, j2) times T[k1, j2]. T is ``tables.fourstep_twiddle(n1, n2,
    inverse, scale)``, or the caller's ``tw`` in the same (n1, n2, 2)
    float32 layout of (re, im) pairs, which carries all scaling (``scale``
    is then ignored). ``block`` sets the lanes per CUDA block (a power of
    two; 0 = as many as fit 64 KB)."""
    _check_3d(xr3, n1, n2, "step 1")
    stages = ff._stages(n1, rad1)
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
    if xr3.numel():
        tw = tw.contiguous()
        t = ff._cols_tile(n1, block, sum(stages))
        ff._launch("offt_step1_twiddle", (xr3, xi3, yr, yi), (tab, tw),
                   [xr3.shape[0], n1, n2, *ff._radix_args(stages), t])
        _step1_twiddle.launches += 1
    return yr, yi


@ff._dispatching
def _step3_transposed(mode, zr3, zi3, n1: int, n2: int, rad2, inverse: bool,
                      precision: str = ff.DEFAULT_PRECISION, block: int = 0,
                      tables=None):
    """Steps 3+4 (kernel ``step3_transposed`` of ``csrc/fourstep.cu``):
    FFT_{n2} along the last axis of planar (B, n1, n2), written transposed
    into (B, n2, n1), the natural four-step order. No scale: step 1's
    table carries it. ``block`` sets the rows per CUDA block (0 = as many
    as fit 64 KB, at most 64)."""
    _check_3d(zr3, n1, n2, "step 3")
    stages = ff._stages(n2, rad2)
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
    rows = zr3.shape[0] * n1
    if rows:
        t = ff._rows_tile(n2, block, sum(stages))
        ff._launch("offt_step3_transposed", (zr3, zi3, yr, yi), (tab,),
                   [rows, n1, n2, *ff._radix_args(stages), t])
        _step3_transposed.launches += 1
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
