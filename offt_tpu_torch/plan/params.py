"""Plan parameters of the port: the fields of ``offt_tpu.plan.params``.

``PlanParams`` and ``ProblemSpec`` keep the reference's fields and
defaults, so cache and tuner entries map one to one
(:func:`from_reference`). The ported slices read ``radix_x/y/z``,
``use_pallas``, ``precision``, ``block_batch``, ``slab_rows``, ``x_tile``
and ``split_1d``; the distributed knobs (``p1``, ``t1``/``t2``,
``w1``/``w2``, ``ry``, ``s1``/``s2``, ``rankorder``, ``v``) are carried
unread until their slice lands (ROADMAP Queue 1 item 14).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..kernels import dft

TRANSPOSE_ALL_TO_ALL = 0
TRANSPOSE_PPERMUTE = 1

_PRECISIONS = ("default", "high", "highest", "stack6", "stack3")


@dataclasses.dataclass(frozen=True)
class PlanParams:
    """Tunable execution parameters for one 3-D FFT plan.

    ``precision`` is carried across unchanged because the cache and the
    tuner key on it, but every value computes at f32 FMA on the card:
    ``stack6``, ``stack3`` and ``default`` are bf16 emulations written
    for the TPU's MXU. Mapping them to Hopper tiers (TF32, 3xTF32) is
    ROADMAP Queue 1 item 3.

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
    # the fused kernels (0 = the unfused route, not ported yet)
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


def default_params(spec: ProblemSpec) -> PlanParams:
    """The single-device default point. ``use_pallas`` resolves from the
    config key (-1 auto / 0 off / 1 force): auto enables the kernels when
    x and y pass ``can_use_pallas`` and z passes it, or takes the
    four-step route (the reference's clause, ``params.py:203-216``): z
    of a c2c transform on ``can_use_four_step(nz)``, z of a real one, whose
    inner c2c is half length, on ``can_use_pallas(nz // 2)`` or
    ``can_use_four_step(nz // 2)`` for an even nz. The reference applies
    it on a TPU only; the port on every device, since the kernels (on the
    CPU, their plain versions) are its only route. ``precision`` "auto"
    resolves to "highest", which is what every value computes at on the
    card."""
    from ..kernels.fourstep import can_use_four_step
    from ..kernels.fused_fft import can_use_pallas
    from ..utils import config as _cfg

    if spec.p != 1:
        raise NotImplementedError("distributed plans are ROADMAP Queue 1 "
                                  "item 14")
    nx, ny, nz = spec.shape
    up_cfg = int(_cfg.get("use_pallas"))
    use_pallas = max(up_cfg, 0)
    zok = can_use_pallas(nz)
    if not zok and spec.real and nz % 2 == 0:
        zok = can_use_pallas(nz // 2) or can_use_four_step(nz // 2)
    elif not zok and not spec.real:
        zok = can_use_four_step(nz)
    if (up_cfg < 0 and spec.dtype in ("complex64", "float32") and zok
            and can_use_pallas(nx) and can_use_pallas(ny)):
        use_pallas = 1
    precision = str(_cfg.get("precision"))
    if precision == "auto":
        precision = "highest"
    return PlanParams(p1=1, use_pallas=use_pallas, precision=precision)


def infeasible_reason(spec: ProblemSpec,
                      params: PlanParams) -> Optional[str]:
    """Structural feasibility of the fields this slice reads; a reason or
    None. Mirrors the reference's checks of those fields."""
    nx, ny, nz = spec.shape
    if spec.p % params.p1 != 0:
        return f"p1={params.p1} does not divide p={spec.p}"
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

