"""Plan parameters of the port: the fields of ``offt_tpu.plan.params``.

``PlanParams`` and ``ProblemSpec`` keep the reference's fields and
defaults, so cache and tuner entries map one to one
(:func:`from_reference`). The single-device routes read ``radix_x/y/z``,
``use_pallas``, ``precision``, ``block_batch``, ``slab_rows``, ``x_tile``
and ``split_1d``; the pencil engine (``dist/pencil.py``) reads the
distributed knobs as the reference does: ``p1`` (the mesh's row count),
``t1``/``t2`` (chunks per exchange phase), ``w1``/``w2`` (chunk i waits
on the exchange of chunk i - w; 0 = no bound), ``ry`` (tenths of the
middle-axis transform done in phase 1), ``s1``/``s2`` (all-to-all or the
ring of single-hop sends), ``v`` (bit per phase: all-gather and a local
slice) and ``rankorder`` (the rank grid, ``dist/mesh.py``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from ..kernels import dft

# the reference's ceiling on one device's pipeline working set, in
# complex64 elements (32M = 256 MiB; offt.h:51 BUFFER_SIZE_LIMIT)
BUFFER_ELEMS_LIMIT = 32 * 1024 * 1024

TRANSPOSE_ALL_TO_ALL = 0   # one all-to-all per chunk and phase
TRANSPOSE_PPERMUTE = 1     # a ring of size - 1 single-hop exchanges

_PRECISIONS = ("default", "high", "highest", "stack6", "stack3")


@dataclasses.dataclass(frozen=True)
class PlanParams:
    """Tunable execution parameters for one 3-D FFT plan.

    ``precision`` is carried across unchanged because the cache and the
    tuner key on it, but every value computes at f32 FMA on the card:
    ``stack6``, ``stack3`` and ``default`` are bf16 emulations written
    for the TPU's MXU. Mapping them to Hopper tiers (TF32, 3xTF32) is
    ROADMAP Queue 2b (the precision tiers).

    Block-shape knobs: ``block_batch`` sets the rows per CUDA block of
    ``fft_last`` and the lanes per block of the strided-axis kernel
    (0 = auto); ``slab_rows`` is ignored (one block owns one x-row of the
    slab); ``x_tile`` is ignored (the pitched x pass picks its own lane
    tile) beyond its feasibility check. ``split_1d`` pins the four-step
    (n1, n2) of a (1, 1, N) c2c plan.
    """

    p1: int = 1
    t1: int = 1
    t2: int = 1
    w1: int = 1
    w2: int = 1
    ry: int = 10
    s1: int = TRANSPOSE_ALL_TO_ALL
    s2: int = TRANSPOSE_ALL_TO_ALL
    rankorder: int = 0
    v: int = 0
    # per-axis radix factorization override; None -> dft.factorize default
    radix_z: Optional[tuple[int, ...]] = None
    radix_y: Optional[tuple[int, ...]] = None
    radix_x: Optional[tuple[int, ...]] = None
    # the kernels (0 = the unfused engine, kernels/stockham.py)
    use_pallas: int = 0
    block_batch: int = 0
    slab_rows: int = 0
    x_tile: Optional[tuple[int, int]] = None
    split_1d: Optional[tuple[int, int]] = None
    precision: str = "highest"

    def astuple(self) -> tuple:
        return dataclasses.astuple(self)

    def replace(self, **kw) -> "PlanParams":
        return dataclasses.replace(self, **kw)


_TUPLE_FIELDS = ("radix_z", "radix_y", "radix_x", "x_tile", "split_1d")


def from_reference(d: dict) -> PlanParams:
    """The port's PlanParams from ``dataclasses.asdict`` of the reference's
    (plain Python or numpy values). Raises on an unknown field."""
    known = {f.name for f in dataclasses.fields(PlanParams)}
    extra = set(d) - known
    if extra:
        raise TypeError(f"unknown PlanParams fields: {sorted(extra)}")
    out = {}
    for k, v in d.items():
        if k in _TUPLE_FIELDS:
            out[k] = None if v is None else tuple(int(r) for r in v)
        elif k == "precision":
            out[k] = str(v)
        else:
            out[k] = int(v)
    return PlanParams(**out)


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Static problem description a plan is built for."""

    shape: tuple[int, int, int]
    dtype: str = "complex64"
    real: bool = False
    inverse: bool = False
    batch: int = 1
    p: int = 1
    batch_sharded: bool = False

    @property
    def nz_freq(self) -> int:
        """Length of z after the r2c (Nz//2 + 1); Nz for c2c."""
        return self.shape[2] // 2 + 1 if self.real else self.shape[2]


def w_from_reference(W: int, unbounded: bool = False) -> int:
    """A reference W1/W2 window (offt.h:78-79) as the ``w`` knob. The two
    are off by one: W counts the exchanges issued ahead of the chunk being
    completed (W = 0 is the blocking exchange), ``w`` caps the chunk
    exchanges in flight, the completing one included (``w = 0``: no cap).
    So ``w = W + 1``: W = 0 gives 1, the reference paper's W = 2 gives 3,
    ``unbounded`` gives 0."""
    if unbounded:
        return 0
    if W < 0:
        raise ValueError(f"reference W must be >= 0, got {W}")
    return int(W) + 1


def divisors(n: int) -> list[int]:
    ds = [d for d in range(1, int(math.isqrt(n)) + 1) if n % d == 0]
    return sorted(set(ds + [n // d for d in ds]))


def pow2_grid(lo: int, hi: int, include_zero: bool = False) -> list[int]:
    """The reference's power-of-two value ladders, lo to hi with hi always
    in (offt-compute.c:3042-3079)."""
    vals = [0] if include_zero else []
    v = max(lo, 1)
    while v < hi:
        vals.append(v)
        v *= 2
    vals.append(hi)
    return sorted(set(vals))


def p1_candidates(nx: int, ny: int, nz: int, p: int) -> list[int]:
    """Legal grid factors (the reference's ``p1_candidates``): p1 divides
    p, p1 <= min(Nx, Ny) and p2 = p/p1 <= min(Ny, Nz); [p] when none."""
    out = []
    for d in divisors(p):
        p2 = p // d
        if d <= min(nx, ny) and p2 <= min(ny, nz):
            out.append(d)
    return out or [p]


def default_params(spec: ProblemSpec,
                   p1: Optional[int] = None) -> PlanParams:
    """The default point. ``use_pallas`` resolves from the
    config key (-1 auto / 0 off / 1 force): auto enables the kernels when
    x and y pass ``can_use_pallas`` and z passes it, or takes the
    four-step route (the reference's clause, ``params.py:203-216``): z
    of a c2c transform on ``can_use_four_step(nz)``, z of a real one, whose
    inner c2c is half length, on ``can_use_pallas(nz // 2)`` or
    ``can_use_four_step(nz // 2)`` for an even nz. The reference applies
    it on a TPU only; the port on every device, since the kernels (on the
    CPU, their plain versions) are its fast route. The port adds one
    clause: a z that takes Bluestein (a prime factor past 128) whose
    inner power-of-two transform has a kernel route passes too
    (``stockham.bluestein_rides_kernels``: of nz for c2c and odd real nz,
    of nz // 2 for even real nz), so that its inner transforms ride the
    kernels. The reference rides them only on its stacked precisions,
    which its default never gives such a length. ``precision`` "auto"
    resolves to "highest", which is what every value computes at on the
    card.

    For p > 1 devices (the reference's ``params.py:224-246``): ``p1``
    pins the grid factor (a concrete mesh), else the candidate nearest
    sqrt(p); t = min(4, local extent) chunks per phase with w = 0 below
    16 devices, t = 1 from 16 up; t1 and t2 swap for the inverse."""
    from ..kernels.fourstep import can_use_four_step
    from ..kernels.fused_fft import can_use_pallas
    from ..kernels.stockham import bluestein_rides_kernels
    from ..utils import config as _cfg

    nx, ny, nz = spec.shape
    up_cfg = int(_cfg.get("use_pallas"))
    use_pallas = max(up_cfg, 0)
    zok = can_use_pallas(nz)
    if not zok and spec.real and nz % 2 == 0:
        zok = (can_use_pallas(nz // 2) or can_use_four_step(nz // 2)
               or bluestein_rides_kernels(nz // 2))
    elif not zok:
        zok = ((not spec.real and can_use_four_step(nz))
               or bluestein_rides_kernels(nz))
    if (up_cfg < 0 and spec.dtype in ("complex64", "float32") and zok
            and can_use_pallas(nx) and can_use_pallas(ny)):
        use_pallas = 1
    precision = str(_cfg.get("precision"))
    if precision == "auto":
        precision = "highest"
    if spec.p == 1:
        return PlanParams(p1=1, use_pallas=use_pallas, precision=precision)
    if p1 is None:
        cands = p1_candidates(nx, ny, nz, spec.p)
        root = int(math.sqrt(spec.p))
        p1 = min(cands, key=lambda d: (abs(d - root), d))
    p2 = spec.p // p1
    if spec.p >= 16:
        t1 = t2 = 1
    else:
        t1 = min(4, max(1, nx // max(p1, 1)))
        t2 = min(4, max(1, spec.nz_freq // max(p2, 1)))
    if spec.inverse:   # the inverse pipeline chunks z in phase 1, x in 2
        t1, t2 = t2, t1
    return PlanParams(p1=p1, t1=t1, t2=t2, w1=0, w2=0,
                      use_pallas=use_pallas, precision=precision)


def infeasible_reason(spec: ProblemSpec,
                      params: PlanParams) -> Optional[str]:
    """Structural feasibility; a reason or None. Mirrors the reference's
    checks (``params.py:249-351``) but for ``block_batch`` and ``x_tile``,
    which the CUDA kernels read otherwise."""
    nx, ny, nz = spec.shape
    nzf = spec.nz_freq
    p = spec.p
    if p % params.p1 != 0:
        return f"p1={params.p1} does not divide p={p}"
    p2 = p // params.p1
    # the tiles chunk the local extents of their phase: the forward
    # pipeline's phase 1 the x rows, phase 2 the z planes; the inverse
    # the mirror (dist/pencil.py make_pencil_fft3d)
    m1 = -(-nx // params.p1)
    m3 = -(-nzf // p2)
    b1, b2 = (m3, m1) if spec.inverse else (m1, m3)
    if not (1 <= params.t1 <= max(b1, 1)):
        return f"t1={params.t1} outside [1,{b1}]"
    if not (1 <= params.t2 <= max(b2, 1)):
        return f"t2={params.t2} outside [1,{b2}]"
    if not (0 <= params.w1 <= params.t1):
        return f"w1={params.w1} outside [0,t1]"
    if not (0 <= params.w2 <= params.t2):
        return f"w2={params.w2} outside [0,t2]"
    if not (0 <= params.ry <= 10):
        return f"ry={params.ry} outside [0,10]"
    if params.s1 not in (0, 1) or params.s2 not in (0, 1):
        return "s1/s2 outside {0,1}"
    if not (0 <= params.v <= 3):
        return "v outside [0,3]"
    if params.rankorder not in (0, 1, 2):
        return "rankorder outside {0,1,2}"
    if params.slab_rows not in (0, 1, 2, 4, 8, 16):
        return "slab_rows outside {0,1,2,4,8,16}"
    if params.block_batch < 0:
        return f"block_batch={params.block_batch} negative"
    if params.precision not in _PRECISIONS:
        return f"precision {params.precision!r} unknown"
    if params.precision == "high" and params.use_pallas:
        return "precision 'high' unsupported by the kernels"
    if params.precision in ("stack6", "stack3") and not params.use_pallas:
        return f"precision {params.precision!r} requires use_pallas=1"
    if p > 1:
        # one pipelined chunk times its window depth, per device
        per_dev = nx * ny * nzf * max(spec.batch, 1) / p
        for t, w in ((params.t1, params.w1), (params.t2, params.w2)):
            if (max(w, 1) + 1) * (per_dev / max(t, 1)) > BUFFER_ELEMS_LIMIT:
                return "pipeline working set exceeds BUFFER_ELEMS_LIMIT"
    for rad, n in ((params.radix_z, nz // 2 if spec.real else nz),
                   (params.radix_y, ny), (params.radix_x, nx)):
        if rad is None:
            continue
        prod = 1
        for r in rad:
            prod *= r
        if prod != n or any(r > dft.MAX_RADIX for r in rad):
            return f"radices {rad} invalid for N={n}"
        if params.use_pallas:
            if len(rad) > 3:
                return f"radices {rad}: more than 3 kernel stages"
            if len(rad) == 3 and (max(rad) > dft.LOOP_MAX_RADIX
                                  or min(rad) < 2):
                return (f"radices {rad}: 3-stage radices must be in "
                        f"[2, {dft.LOOP_MAX_RADIX}]")
    if params.split_1d is not None:
        from ..kernels.fourstep import pick_split
        if spec.real or (nx, ny) != (1, 1):
            return "split_1d applies only to degenerate (1, 1, N) c2c plans"
        if pick_split(nz, params.split_1d) is None:
            return (f"split_1d {params.split_1d} invalid for N={nz} "
                    "(product or kernel expressibility)")
    if params.x_tile is not None:
        ty, tz = params.x_tile
        lanes = nz // 2 if spec.real else nz
        if ty < 1 or tz < 1 or ny % ty or lanes % tz:
            return f"x_tile {params.x_tile} illegal for ({ny},{lanes})"
    return None


def is_feasible(spec: ProblemSpec, params: PlanParams) -> bool:
    return infeasible_reason(spec, params) is None
