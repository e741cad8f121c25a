"""Search strategies over a discrete SearchSpace.

A copy of ``offt_tpu/tune/strategies.py`` (numpy only): with the same
seed on the same space every strategy generates the same points as the
reference's.

Python re-expression of Active Harmony's strategy plugins
(activeharmony/build/strategies/): the ABI
(strategy.h:49-151 — generate/rejected/analyze/best) becomes a small
Strategy protocol; libvertex's geometric simplex machinery
(libvertex.c:289-366, 450-705) becomes numpy ops on index vectors.

- RandomStrategy  <- random.c (uniform point per fetch, track best)
- BruteStrategy   <- brute.c (odometer walk via vertex_incr)
- NelderMead      <- nm.c (sequential simplex REFLECT/EXPAND/CONTRACT/
                    SHRINK with grid snapping and user-injected initial
                    simplex, the SHSONG_USER_VERTEX_FILE hook nm.c:369-396)
- PROStrategy     <- pro.c (Parallel Rank Ordering: evaluates a whole
                    simplex per round; natural fit for batch trial runs)
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol

import numpy as np

from .space import Point, SearchSpace, grid_iter

INF = float("inf")


class Strategy(Protocol):
    def generate(self) -> Optional[Point]:
        """Next candidate, or None if exhausted/waiting."""

    def analyze(self, point: Point, perf: float) -> None:
        """Report measured objective for a generated point."""

    def rejected(self, point: Point) -> None:
        """Point was infeasible/errored; strategy may produce a retry hint."""

    def best(self) -> Optional[Point]: ...

    def converged(self) -> bool: ...


class _BestTracker:
    def __init__(self):
        self._best: Optional[Point] = None
        self._best_perf = INF

    def observe(self, point: Point, perf: float) -> None:
        if perf < self._best_perf:
            self._best = tuple(point)
            self._best_perf = perf

    def best(self) -> Optional[Point]:
        return self._best

    @property
    def best_perf(self) -> float:
        return self._best_perf


class RandomStrategy(_BestTracker):
    """random.c:87-98 — uniform random point per fetch."""

    def __init__(self, space: SearchSpace, seed: int = 0):
        super().__init__()
        self.space = space
        self.rng = np.random.default_rng(seed)

    def generate(self) -> Optional[Point]:
        return self.space.random_point(self.rng)

    def analyze(self, point, perf):
        self.observe(point, perf)

    def rejected(self, point):
        pass

    def converged(self) -> bool:
        return False


class BruteStrategy(_BestTracker):
    """brute.c — exhaustive odometer walk, one pass."""

    def __init__(self, space: SearchSpace, seed: int = 0):
        super().__init__()
        self.space = space
        self._iter = grid_iter(space)
        self._done = False

    def generate(self) -> Optional[Point]:
        try:
            return next(self._iter)
        except StopIteration:
            self._done = True
            return None

    def analyze(self, point, perf):
        self.observe(point, perf)

    def rejected(self, point):
        pass

    def converged(self) -> bool:
        return self._done


@dataclasses.dataclass
class _Vertex:
    coords: np.ndarray  # real-valued index coordinates
    perf: float = INF


class _SimplexBase(_BestTracker):
    """Shared simplex helpers (libvertex.c analogues)."""

    def __init__(self, space: SearchSpace, seed: int = 0,
                 init_simplex: Optional[list[Point]] = None):
        super().__init__()
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.n = len(space.dims)
        self.init_simplex = init_simplex

    def _initial_simplex(self, size: int) -> list[_Vertex]:
        pts: list[Point] = list(self.init_simplex or [])
        while len(pts) < size:
            pts.append(self.space.random_point(self.rng))
        return [_Vertex(np.asarray(p, float)) for p in pts[:size]]

    def _snap(self, coords: np.ndarray) -> Point:
        return self.space.clip(coords)

    @staticmethod
    def _centroid(vs: list[_Vertex]) -> np.ndarray:
        return np.mean([v.coords for v in vs], axis=0)


class NelderMead(_SimplexBase):
    """nm.c sequential simplex on the index grid.

    States mirror nm.c:53-63; convergence mirrors check_convergence
    (nm.c:696-726): perf variance below tol AND simplex geometrically
    small, or a collapsed (all-same-gridpoint) simplex.
    """

    REFLECT_COEF = 1.0
    EXPAND_COEF = 2.0
    CONTRACT_COEF = 0.5

    def __init__(self, space: SearchSpace, seed: int = 0,
                 init_simplex: Optional[list[Point]] = None,
                 size: Optional[int] = None, tol: float = 1e-4):
        super().__init__(space, seed, init_simplex)
        self.size = size or (self.n + 1)
        self.tol = tol
        self.simplex = self._initial_simplex(self.size)
        self._phase = "init"
        self._init_idx = 0
        self._pending: Optional[tuple[str, np.ndarray]] = None
        self._trial_perf: dict[str, float] = {}
        self._converged = False
        self._reject_streak = 0

    # -- candidate generation ------------------------------------------
    def generate(self) -> Optional[Point]:
        if self._converged:
            return None
        if self._phase == "init":
            return self._snap(self.simplex[self._init_idx].coords)
        if self._pending is not None:
            return self._snap(self._pending[1])
        self._start_reflect()
        return self._snap(self._pending[1])

    def _order(self):
        self.simplex.sort(key=lambda v: v.perf)

    def _start_reflect(self):
        self._order()
        worst = self.simplex[-1].coords
        cen = self._centroid(self.simplex[:-1])
        refl = cen + self.REFLECT_COEF * (cen - worst)
        self._pending = ("reflect", refl)

    def analyze(self, point: Point, perf: float) -> None:
        self.observe(point, perf)
        self._reject_streak = 0
        if self._phase == "init":
            self.simplex[self._init_idx].perf = perf
            self.simplex[self._init_idx].coords = np.asarray(point, float)
            self._init_idx += 1
            if self._init_idx >= self.size:
                self._phase = "search"
            return
        if self._pending is None:
            # stale report: NM hands its current test point to every
            # fetching client; the first report consumed the pending
            # trial, later duplicates only update the point DB
            # (observe above). Session.report gates these off already —
            # this guard keeps the raw-strategy ABI crash-free too.
            return

        kind, coords = self._pending
        self._pending = None
        self._order()
        best, second_worst, worst = (self.simplex[0], self.simplex[-2],
                                     self.simplex[-1])
        cen = self._centroid(self.simplex[:-1])

        if kind == "reflect":
            self._trial_perf["reflect"] = perf
            self._trial_coords = np.asarray(point, float)
            if perf < best.perf:
                exp = cen + self.EXPAND_COEF * (self._trial_coords - cen)
                self._pending = ("expand", exp)
            elif perf < second_worst.perf:
                worst.coords, worst.perf = self._trial_coords, perf
            else:
                con = cen + self.CONTRACT_COEF * (worst.coords - cen)
                self._pending = ("contract", con)
        elif kind == "expand":
            if perf < self._trial_perf["reflect"]:
                worst.coords, worst.perf = np.asarray(point, float), perf
            else:
                worst.coords = self._trial_coords
                worst.perf = self._trial_perf["reflect"]
        elif kind == "contract":
            if perf < worst.perf:
                worst.coords, worst.perf = np.asarray(point, float), perf
            else:  # shrink toward best, re-evaluate lazily
                for v in self.simplex[1:]:
                    v.coords = best.coords + 0.5 * (v.coords - best.coords)
                    v.perf = INF
                self._phase = "init"
                self._init_idx = 1  # keep best, re-time the rest
        elif kind == "retry":
            worst.coords, worst.perf = np.asarray(point, float), perf

        self._check_convergence()

    def rejected(self, point: Point) -> None:
        # out-of-bounds/infeasible: retry with a random perturbation
        # (nm_algorithm retry loop, nm.c:506-524)
        self._reject_streak += 1
        if self._reject_streak > 20:
            self._converged = True
            self._pending = None
            return
        if self._phase == "init":
            self.simplex[self._init_idx].coords = np.asarray(
                self.space.random_point(self.rng), float)
            return
        self._pending = ("retry",
                         np.asarray(self.space.random_point(self.rng), float))

    def _check_convergence(self):
        if self._phase != "search":
            return
        perfs = np.array([v.perf for v in self.simplex if v.perf < INF])
        if len(perfs) < self.size:
            return
        coords = np.array([v.coords for v in self.simplex])
        if np.var(perfs) < self.tol * max(1e-12, np.mean(perfs) ** 2):
            self._converged = True
        # collapsed simplex: every vertex snaps to the same grid point
        snapped = {self._snap(c) for c in coords}
        if len(snapped) == 1:
            self._converged = True

    def converged(self) -> bool:
        return self._converged


class PROStrategy(_SimplexBase):
    """pro.c Parallel Rank Ordering — whole-simplex rounds.

    ``generate`` hands out every not-yet-measured vertex of the working
    simplex (pro.c:326-343); once all are reported, one PRO transition
    runs (reflect around best; expand on improvement; else shrink —
    pro.c:487-604 condensed).
    """

    REFLECT_COEF = 1.0
    EXPAND_COEF = 2.0
    SHRINK_COEF = 0.5

    def __init__(self, space: SearchSpace, seed: int = 0,
                 init_simplex: Optional[list[Point]] = None,
                 size: Optional[int] = None, tol: float = 1e-4):
        super().__init__(space, seed, init_simplex)
        self.size = size or max(self.n + 1, 4)
        self.tol = tol
        self.base = self._initial_simplex(self.size)     # measured simplex
        self._cand = self.base                           # round being measured
        self._state = "measure_base"                     # then reflect/expand
        self._queue = list(range(self.size))
        self._outstanding: dict[Point, int] = {}
        self._reflected: Optional[list[_Vertex]] = None
        self._converged = False

    # -- round plumbing --------------------------------------------------
    def generate(self) -> Optional[Point]:
        if self._converged:
            return None
        if not self._queue:
            return None  # waiting for outstanding reports
        i = self._queue.pop(0)
        pt = self._snap(self._cand[i].coords)
        self._outstanding[pt] = i
        return pt

    def analyze(self, point: Point, perf: float) -> None:
        self.observe(point, perf)
        i = self._outstanding.pop(tuple(point), None)
        if i is None:
            return
        self._cand[i].coords = np.asarray(point, float)
        self._cand[i].perf = perf
        if not self._queue and not self._outstanding:
            self._transition()

    def rejected(self, point: Point) -> None:
        i = self._outstanding.pop(tuple(point), None)
        if i is None:
            return
        self._cand[i].perf = INF
        if not self._queue and not self._outstanding:
            self._transition()

    def _make_round(self, coef: float) -> list[_Vertex]:
        """Transform base simplex through its best vertex (pro.c
        pro_next_simplex: reflect coef=1, expand coef=2)."""
        self.base.sort(key=lambda v: v.perf)
        best = self.base[0]
        out = [_Vertex(best.coords.copy(), best.perf)]
        for v in self.base[1:]:
            out.append(_Vertex(best.coords + coef * (best.coords - v.coords)))
        return out

    def _start_round(self, vs: list[_Vertex], state: str):
        self._cand = vs
        self._state = state
        self._queue = [i for i, v in enumerate(vs) if v.perf == INF]
        if not self._queue:  # nothing to measure (degenerate): recurse
            self._transition()

    def _transition(self):
        self._check_convergence()
        if self._converged:
            return
        if self._state == "measure_base":
            self.base = self._cand
            self._start_round(self._make_round(self.REFLECT_COEF), "reflect")
            return
        base_best = min(v.perf for v in self.base)
        cand_best = min(v.perf for v in self._cand)
        if self._state == "reflect":
            if cand_best < base_best:
                # improvement: test the expanded simplex before committing
                self._reflected = self._cand
                self._start_round(self._make_round(self.EXPAND_COEF), "expand")
            else:
                # no improvement anywhere: shrink toward best and re-measure
                self.base.sort(key=lambda v: v.perf)
                best = self.base[0]
                shrunk = [_Vertex(best.coords.copy(), best.perf)]
                for v in self.base[1:]:
                    shrunk.append(_Vertex(
                        best.coords + self.SHRINK_COEF * (v.coords - best.coords)))
                self._state = "measure_base"
                self._cand = shrunk
                self._queue = list(range(1, self.size))
            return
        if self._state == "expand":
            refl_best = min(v.perf for v in self._reflected)
            exp_best = cand_best
            self.base = self._cand if exp_best < refl_best else self._reflected
            self._reflected = None
            self._start_round(self._make_round(self.REFLECT_COEF), "reflect")

    def _check_convergence(self):
        vs = self._cand
        snapped = {self._snap(v.coords) for v in vs}
        if len(snapped) == 1:
            self._converged = True
        perfs = np.array([v.perf for v in vs if v.perf < INF])
        if len(perfs) == len(vs) and np.var(perfs) < self.tol * max(
                1e-12, float(np.mean(perfs)) ** 2):
            self._converged = True

    def converged(self) -> bool:
        return self._converged


STRATEGIES = {
    "random": RandomStrategy,
    "brute": BruteStrategy,
    "nm": NelderMead,
    "pro": PROStrategy,
}


def make_strategy(name: str, space: SearchSpace, **kw) -> Strategy:
    try:
        cls = STRATEGIES[name]
    except KeyError:
        raise ValueError(f"unknown strategy {name!r}; have {sorted(STRATEGIES)}")
    return cls(space, **kw)
