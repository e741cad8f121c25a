"""Discrete search space over plan parameters.

Mirrors the reference's tuning-space setup: Active Harmony sessions bind 24
int variables V00..V23 that are *indices into per-parameter value grids*
(offt-tuning.c:779-786, grids built by params_range_setup,
offt-compute.c:2998-3093). We keep exactly that shape: a SearchSpace is an
ordered list of named dimensions, each with a static tuple of legal values;
points are index vectors; conversion to/from PlanParams is the analogue of
params_convert (offt-tuning.c:80-136).

Port of ``offt_tpu/tune/space.py``: the constraint evaluator,
``Dimension``, ``SearchSpace``, ``grid_iter`` and ``_radix_candidates``
are the reference's. ``build_space`` keeps the distributed dimensions
as they are and decides the others by what the port's routes read (its
docstring). A space may carry ``base``, the point its dimensions vary:
``to_params`` takes every field outside the dimensions from it (the
reference's takes ``PlanParams()``'s defaults, whose ``use_pallas=0``
would put a tuned plan on the unfused engine). The port's space has no
``use_pallas`` dimension, so a tuned plan keeps its base's kernels.
"""

from __future__ import annotations

import ast
import dataclasses
import itertools
import operator
from typing import Optional, Sequence

from ..kernels import dft
from ..plan.params import (
    PlanParams,
    ProblemSpec,
    infeasible_reason,
    p1_candidates,
    pow2_grid,
)

Point = tuple  # index vector, one int per dimension


# ---- safe constraint expressions ------------------------------------------
# The reference pipes constraint text through the Omega calculator
# (plugins/constraint.c) — a restricted arithmetic language. We mirror that
# restriction with an AST whitelist: comparisons / bool ops / arithmetic /
# names / min|max|abs calls only. eval() with empty __builtins__ is NOT a
# sandbox (escapable via attribute chains), so attribute access, subscripts,
# lambdas etc. are rejected outright.

_BIN_OPS = {
    ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
    ast.Div: operator.truediv, ast.FloorDiv: operator.floordiv,
    ast.Mod: operator.mod, ast.Pow: operator.pow,
}
_CMP_OPS = {
    ast.Lt: operator.lt, ast.LtE: operator.le, ast.Gt: operator.gt,
    ast.GtE: operator.ge, ast.Eq: operator.eq, ast.NotEq: operator.ne,
}
_SAFE_FNS = {"min": min, "max": max, "abs": abs}


def _eval_node(node, env: dict):
    if isinstance(node, ast.Expression):
        return _eval_node(node.body, env)
    if isinstance(node, ast.Constant):
        if isinstance(node.value, (int, float, bool)):
            return node.value
        raise ValueError(f"constant {node.value!r} not allowed")
    if isinstance(node, ast.Name):
        if node.id in env:
            return env[node.id]
        raise ValueError(f"unknown name {node.id!r}")
    if isinstance(node, ast.BoolOp):
        vals = (_eval_node(v, env) for v in node.values)
        return all(vals) if isinstance(node.op, ast.And) else any(vals)
    if isinstance(node, ast.UnaryOp):
        v = _eval_node(node.operand, env)
        if isinstance(node.op, ast.Not):
            return not v
        if isinstance(node.op, ast.USub):
            return -v
        if isinstance(node.op, ast.UAdd):
            return +v
        raise ValueError("unary op not allowed")
    if isinstance(node, ast.BinOp) and type(node.op) in _BIN_OPS:
        return _BIN_OPS[type(node.op)](_eval_node(node.left, env),
                                       _eval_node(node.right, env))
    if isinstance(node, ast.Compare):
        left = _eval_node(node.left, env)
        for op, comp in zip(node.ops, node.comparators):
            if type(op) not in _CMP_OPS:
                raise ValueError("comparison op not allowed")
            right = _eval_node(comp, env)
            if not _CMP_OPS[type(op)](left, right):
                return False
            left = right
        return True
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in _SAFE_FNS and not node.keywords):
        return _SAFE_FNS[node.func.id](*(_eval_node(a, env)
                                         for a in node.args))
    raise ValueError(f"expression node {type(node).__name__} not allowed")


def eval_constraint(expr: str, env: dict) -> bool:
    """Evaluate a constraint expression over dimension values, whitelisted
    to arithmetic/comparison/min|max|abs — safe for untrusted config text."""
    return bool(_eval_node(ast.parse(expr, mode="eval"), env))


@dataclasses.dataclass(frozen=True)
class Dimension:
    name: str
    values: tuple

    def __len__(self):
        return len(self.values)


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    spec: ProblemSpec
    dims: tuple[Dimension, ...]
    # expression constraints over parameter names, e.g. "t1 <= 2 * t2" —
    # the analogue of Active Harmony's Omega constraint plugin
    # (plugins/constraint.c: user constraint text filters candidate points
    # before they reach clients, REJECTing violators back to the strategy)
    constraints: tuple[str, ...] = ()
    # the point whose fields outside ``dims`` every candidate keeps (None:
    # PlanParams()'s defaults, as the reference has it)
    base: Optional[PlanParams] = None

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(d.name for d in self.dims)

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(len(d) for d in self.dims)

    def size(self) -> int:
        s = 1
        for d in self.dims:
            s *= len(d)
        return s

    def clip(self, point: Sequence[float]) -> Point:
        """Snap a real-valued vector onto the index grid (libvertex
        vertex_regrid analogue, libvertex.c:317-366)."""
        out = []
        for v, d in zip(point, self.dims):
            i = int(round(v))
            out.append(max(0, min(len(d) - 1, i)))
        return tuple(out)

    def to_params(self, point: Point) -> PlanParams:
        kw = {}
        for i, d in zip(point, self.dims):
            kw[d.name] = d.values[int(i)]
        if self.base is not None:
            return self.base.replace(**kw)
        return PlanParams(**kw)

    def from_params(self, params: PlanParams) -> Point:
        out = []
        for d in self.dims:
            v = getattr(params, d.name)
            if v in d.values:
                out.append(d.values.index(v))
            else:  # snap to nearest grid value (grid_value_floor analogue)
                numeric = [x for x in d.values if isinstance(x, int)]
                if numeric and isinstance(v, int):
                    nearest = min(numeric, key=lambda x: abs(x - v))
                    out.append(d.values.index(nearest))
                else:
                    out.append(0)
        return tuple(out)

    def infeasible_reason(self, point: Point) -> Optional[str]:
        params = self.to_params(point)
        reason = infeasible_reason(self.spec, params)
        if reason is not None:
            return reason
        if self.constraints:
            env = {d.name: d.values[int(i)]
                   for i, d in zip(point, self.dims)}
            for expr in self.constraints:
                try:
                    ok = eval_constraint(expr, env)
                except Exception as e:
                    return f"constraint {expr!r} errored: {e!r}"
                if not ok:
                    return f"constraint violated: {expr}"
        return None

    def random_point(self, rng) -> Point:
        return tuple(int(rng.integers(0, len(d))) for d in self.dims)


def _radix_candidates(n: int, limit: int = 12) -> tuple:
    """A few good factorizations of n: the balanced default plus greedy
    largest-first and some near-balanced alternates. Both orders of each
    2-factor split are included — stage order matters (under stack6,
    r1=8/r2=32 measured 14% faster than either (16,16) or (32,8) at
    256^3 on v5e: stage A becomes one full-depth MXU pass)."""
    if n <= 1:
        return (None,)
    cands = [None, dft.factorize(n)]  # None = library default
    # greedy largest-first (fewest big stages)
    m, greedy = n, []
    while m > 1:
        r = next((d for d in range(min(dft.MAX_RADIX, m), 1, -1) if m % d == 0), m)
        if r > dft.MAX_RADIX:
            return (None,)  # non-smooth: Bluestein path, no choice
        greedy.append(r)
        m //= r
    cands.append(tuple(sorted(greedy, reverse=True)))
    # all 2-factor splits within radix bound, both stage orders
    for a in range(2, int(n ** 0.5) + 1):
        if n % a == 0 and a <= dft.MAX_RADIX and n // a <= dft.MAX_RADIX:
            cands.append((n // a, a))
            if a != n // a:
                cands.append((a, n // a))
    # near-balanced 3-stage splits (generalized core): fewer MXU passes
    # per stage under stack6 when 2-stage radices exceed ~128/12 depth
    # (512=(8,8,8): 3 passes vs (16,32): 5); all radices must be <=32
    # (loop-core bound) and small-first ordering preferred (stage A is
    # one full-depth pass when 12*r1 >= 128 fails -> keep r1 smallest).
    c = round(n ** (1 / 3))
    for a in sorted({c - 1, c, c + 1, 2, 4, 8}):
        if a < 2 or n % a or a > 32:
            continue
        m = n // a
        for b in range(max(2, round(m ** 0.5) - 2), int(m ** 0.5) + 1):
            if m % b == 0 and b <= 32 and 1 < m // b <= 32:
                cands.append(tuple(sorted((a, b, m // b))))
    uniq = []
    for c in cands:
        if c not in uniq:
            uniq.append(c)
    return tuple(uniq[:limit])


def _split_order(split) -> tuple:
    """Rank of a four-step split on the card: the fused pair first (both
    factors 128-multiples; else the 4-pass route), then the fewer of its
    two kernels off the register core (a power of two in [16, 4096] each,
    ``fused_fft._reg_core``), then the more balanced."""
    from ..kernels import fused_fft as ff

    n1, n2 = split
    fused = n1 % 128 == 0 and n2 % 128 == 0
    dense = (not ff._reg_core(n1)) + (not ff._reg_core(n2))
    return (0 if fused else 1, dense, abs(n2 - n1))


def _split1d_candidates(spec, limit: int = 8) -> tuple:
    """Candidate (n1, n2) four-step splits of a degenerate (1, 1, N) c2c
    spec whose route reads ``split_1d``. None = the auto pick. One device:
    only where the four-step pair takes the line
    (``fourstep.can_use_four_step``): a length that one kernel launch
    takes (``fused_fft.can_use_pallas``; past one block's shared memory
    the wrapper runs the pair on its own stage split, ``_long_last``)
    never reads the knob. Distributed specs (p > 1) only emit
    P-divisible pairs, the ones the long-1-D engine (``dist/long1d.py``)
    takes; any other would put the plan on the pencil engine, a wasted
    trial measuring a different engine. The reference ranks the rest by
    Mosaic's lane rule (``n2 % 128``); the port by :func:`_split_order`."""
    from ..kernels import fourstep

    n = spec.shape[2]
    div = spec.p if spec.p > 1 else 1
    if (spec.real or (div == 1 and not fourstep.can_use_four_step(n))
            or fourstep.pick_split(n, divisor=div) is None):
        return (None,)
    cands = [None]
    for d in range(2, int(n ** 0.5) + 1):
        if n % d:
            continue
        for n1, n2 in ((d, n // d), (n // d, d)):
            sp = fourstep.pick_split(n, (n1, n2), divisor=div)
            if sp is not None and sp not in cands:
                cands.append(sp)
    cands[1:] = sorted(cands[1:], key=_split_order)[:limit - 1]
    return tuple(cands)


def _line_knobs(n: int, last: bool, lanes: tuple = ()) -> tuple:
    """(reads its radices, reads ``block_batch``) of one c2c pass of
    length ``n`` through ``dist.pencil.axis_fft`` with the kernels on, at
    the default radices: the last axis on ``fft_last`` (register rows:
    ``fused_fft._reg_rows``), a strided one on the strided-axis kernel
    (``_reg_axis``), both reading ``block_batch`` on the dense core but
    the pitched x pass (``lanes`` = (Y, Z) of an x pass, where the stride
    gate may fire); a line past one block's shared memory, the four-step
    pair (its stage split from the radices); a long last axis, the
    four-step pair (``split_1d``, no radices; ``block_batch`` where one
    of its kernels runs dense); any other length, the unfused engine
    (radices only)."""
    from ..kernels import fourstep
    from ..kernels import fused_fft as ff
    from ..kernels import tables as tb

    if n <= 1:
        return False, False
    if ff.can_use_pallas(n):
        if not ff._fits_block(n, sum(tb._pick_stages(n, None))):
            return True, False
        if last:
            dense = not ff._reg_rows(n)
            return dense, dense
        dense = not ff._reg_axis(n)
        padded = bool(lanes) and (ff.bank_conflict_stride(*lanes)
                                  and ff.can_use_padded_x(n, *lanes))
        return dense, dense and not padded
    if last and fourstep.can_use_four_step(n):
        return False, _pair_dense(*fourstep.pick_split(n))
    return True, False


def _pair_dense(n1: int, n2: int) -> bool:
    """Whether a kernel of the four-step pair at split (n1, n2) runs the
    dense core, and so reads ``block_batch``."""
    from ..kernels import fused_fft as ff

    if n1 % 128 == 0 and n2 % 128 == 0:
        return not (ff._reg_core(n1) and ff._reg_core(n2))
    return not (ff._reg_axis(n1) and ff._reg_rows(n2))


def kernel_knobs(spec: ProblemSpec) -> set:
    """The names among ``radix_z``, ``radix_y``, ``radix_x`` and
    ``block_batch`` that the route a float32 plan of ``spec`` takes with
    its kernels on (``use_pallas=1``) reads, at the default radices: a
    radix where its axis runs the dense core (``csrc/fft_core.cuh``) or
    the unfused engine, ``block_batch`` where a dense ``fft_last``, a
    dense strided-axis kernel or a dense kernel of the four-step pair
    runs. The register core ignores both, and so do the slab kernels'
    block shape (``slab_rows``) and the r2c / c2r rows (their wrappers
    are passed no block). A complex128 plan runs the unfused engine on
    every axis, which reads the radices alone."""
    from ..kernels import fused_fft as ff

    nx, ny, nz = spec.shape
    m = nz // 2 if spec.real else nz
    names = {"radix_z": False, "radix_y": False, "radix_x": False}
    block = False
    if spec.dtype not in ("complex64", "float32"):
        for k, n in (("radix_z", m), ("radix_y", ny), ("radix_x", nx)):
            names[k] = n > 1
        return {k for k, v in names.items() if v}

    def line(key, n, last, lanes=()):
        nonlocal block
        rad, blk = _line_knobs(n, last, lanes)
        names[key] = names[key] or rad
        block = block or blk

    one = spec.p == 1 and not spec.batch_sharded
    if spec.real and one and ff.can_use_rfft3d(nx, ny, nz):
        # the packed route: the r2c / c2r + y slab, then the pitched x pass
        dense = not ff._reg_rslab(ny, m)
        names["radix_z"] = names["radix_y"] = dense
        names["radix_x"] = not ff._reg_axis(nx)
    elif (not spec.real and one and nx > 1
          and all(ff.can_use_pallas(n) for n in (nx, ny, nz))
          and ff.can_fuse_slab(ny, nz)):
        # the c2c slab, then the x pass (pitched where the stride gate
        # fires)
        dense = not ff._reg_slab(ny, nz)
        names["radix_z"] = names["radix_y"] = dense
        line("radix_x", nx, False, (ny, nz))
    else:
        # axis by axis (the local route, the pencil engine on every rank,
        # the 2-D route); the long-1-D engine on P > 1 runs the pair
        if spec.shape[:2] == (1, 1) and spec.p > 1:
            return set()
        if spec.real and not spec.inverse and ff.can_use_rfft_last(nz):
            names["radix_z"] = not ff._reg_core(m)
        else:
            line("radix_z", m if spec.real and nz % 2 == 0 else nz, True)
        line("radix_y", ny, False)
        # one device: the x pass sees the whole (Y, Z) of its input; a
        # rank's block is smaller, and taken as never pitched
        line("radix_x", nx, False, (ny, spec.nz_freq) if one else ())
    out = {k for k, v in names.items() if v}
    if block:
        out.add("block_batch")
    return out


def build_space(
    spec: ProblemSpec,
    fixed_p1: Optional[int] = None,
    include_radix: bool = True,
    max_tile: int = 32,
    include_pallas: Optional[bool] = None,
    constraints: tuple[str, ...] = (),
    device=None,
) -> SearchSpace:
    """The plan search space (SURVEY.md §2c surviving-knob mapping) of a
    plan of ``spec`` on ``device`` (default: the current CUDA device, as
    ``plan()`` has it). Its ``base`` is the default point
    (``default_params(spec, fixed_p1)``).

    The distributed dimensions (p > 1: ``p1``, ``t1``, ``t2``, ``w1``,
    ``w2``, ``ry``, ``s1``, ``s2``, ``v``, ``rankorder``) are the
    reference's, value for value: the pencil engine reads them all. The
    others are decided by what the port reads; where the reference
    differs, a test states it (``tests/test_torch_tune_space.py``):

    - ``radix_z`` / ``radix_y`` / ``radix_x`` (with ``include_radix``)
      only for an axis whose kernel runs the dense core or the unfused
      engine (:func:`kernel_knobs`), and only with more than one
      candidate: the register core ignores the radices, and a
      one-valued dimension searches nothing;
    - ``split_1d`` (with ``include_radix``) where the four-step route
      reads it (:func:`_split1d_candidates`);
    - the kernel dimension ``block_batch``, for a float32 spec on a
      ``cuda`` device, or where the caller asks (``include_pallas=True``;
      ``False`` leaves it out everywhere): where :func:`kernel_knobs`
      finds a dense kernel that reads it and, beside ``split_1d``, at
      every split searched (else its points time the same kernels).
      ``use_pallas`` is not searched: its 0 is the unfused engine, plain
      PyTorch, and a tuned plan keeps the kernels of its base point.
      ``slab_rows`` and ``x_tile`` are read by no kernel of the port, and
      ``precision`` computes at f32 whatever its value, so none of the
      three is searched either.

    The card's own tile choices (``fused_fft._axis_tile``,
    ``fourstep._step1_tile``, ``fused_fft._cluster_slab``) have no
    override path from a plan, so they are not dimensions."""
    import torch

    from ..plan.params import default_params

    nx, ny, nz = spec.shape
    nzf = spec.nz_freq
    p = spec.p
    dims = []
    if p > 1:
        # distributed-only knobs (pipeline chunking, transpose strategy)
        if fixed_p1 is not None:
            dims.append(Dimension("p1", (fixed_p1,)))
        else:
            dims.append(Dimension("p1", tuple(p1_candidates(nx, ny, nz, p))))
        p2_min = max(1, p // max(d for d in p1_candidates(nx, ny, nz, p)))
        m1 = max(1, nx // max(1, min(p1_candidates(nx, ny, nz, p))))
        m3 = max(1, nzf // max(1, p2_min))
        dims.append(Dimension("t1", tuple(pow2_grid(1, min(max_tile, m1)))))
        dims.append(Dimension("t2", tuple(pow2_grid(1, min(max_tile, m3)))))
        # full reference W grid 0..10 (offt.h:78-79); w > t is pruned by
        # the feasibility predicate, so the extra points are free
        dims.append(Dimension("w1", tuple(range(0, 11))))
        dims.append(Dimension("w2", tuple(range(0, 11))))
        dims.append(Dimension("ry", tuple(range(0, 11))))
        dims.append(Dimension("s1", (0, 1)))
        dims.append(Dimension("s2", (0, 1)))
        dims.append(Dimension("v", (0, 1, 2, 3)))
        # device->grid assignment (ROTATE_RANKORDER analogue): auto
        # (mesh-as-given) vs the two explicit orders
        dims.append(Dimension("rankorder", (0, 1, 2)))
    live = kernel_knobs(spec)
    if include_radix:
        for name, n in (("radix_z", nz // 2 if spec.real else nz),
                        ("radix_y", ny), ("radix_x", nx)):
            cands = _radix_candidates(n)
            if name in live and len(cands) > 1:
                dims.append(Dimension(name, cands))
        # four-step split for long degenerate 1-D c2c plans (the route in
        # kernels/fourstep.py, BASELINE config 1): which (n1, n2) matrix
        # view the length-n vector takes. Reference analogue: FFTW's own
        # sub-plan choice inside setup_p1d (offt-compute.c:329-489).
        s1d = _split1d_candidates(spec) if (nx, ny) == (1, 1) else (None,)
        if len(s1d) > 1:
            dims.append(Dimension("split_1d", s1d))
    if include_pallas is None:
        include_pallas = torch.device(
            "cuda" if device is None else device).type == "cuda"
    if include_pallas and spec.dtype in ("complex64", "float32"):
        splits = next((d.values[1:] for d in dims if d.name == "split_1d"),
                      ())
        if "block_batch" in live and all(_pair_dense(*sp) for sp in splits):
            # the dense kernels' rows or lanes a CUDA block; 0 = as many
            # as fit
            dims.append(Dimension("block_batch", (0, 128, 256, 512, 1024)))
    return SearchSpace(spec=spec, dims=tuple(dims),
                       constraints=tuple(constraints),
                       base=default_params(spec, p1=fixed_p1))


def grid_iter(space: SearchSpace):
    """Odometer walk over the whole grid (brute.c:142-157 vertex_incr)."""
    return itertools.product(*(range(len(d)) for d in space.dims))
