"""Synthetic objectives with known optima for tuner acceptance tests.

A copy of ``offt_tpu/tune/synth.py``.

Mirrors Active Harmony's example suite: the 6-parameter quadratic with
minimum at (15, 30, 45, 60, 75, 90) over [1, 100]
(activeharmony/example/client_api/example.c:27-47 and
example/synth/) — the framework's own convergence acceptance test.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..plan.params import ProblemSpec
from .space import Dimension, SearchSpace

AH_OPTIMUM = (15, 30, 45, 60, 75, 90)


def ah_quadratic(vals) -> float:
    """f(x) = sum_i (x_i - opt_i)^2 (the example.c objective, reshaped to a
    pure sum of squares; same optimum)."""
    return float(sum((v - o) ** 2 for v, o in zip(vals, AH_OPTIMUM)))


def quadratic_space(lo: int = 1, hi: int = 100) -> SearchSpace:
    dims = tuple(
        Dimension(f"v{i}", tuple(range(lo, hi + 1))) for i in range(6)
    )
    spec = ProblemSpec(shape=(1, 1, 1))
    return _SynthSpace(spec=spec, dims=dims)


@dataclasses.dataclass(frozen=True)
class _SynthSpace(SearchSpace):
    """SearchSpace over free integer dims (no plan feasibility)."""

    def infeasible_reason(self, point):
        return None

    def to_params(self, point):  # returns raw values, not PlanParams
        return tuple(d.values[int(i)] for i, d in zip(point, self.dims))

    def from_params(self, vals):
        return tuple(d.values.index(v) for v, d in zip(vals, self.dims))


def rastrigin(vals, a: float = 10.0) -> float:
    """Multi-modal test fn (minimum 0 at origin) for strategy robustness."""
    v = np.asarray(vals, float)
    return float(a * len(v) + np.sum(v * v - a * np.cos(2 * np.pi * v)))


def _cli_test_obj(a: int, b: int) -> float:
    """Tiny known-optimum objective for offt-tune --pyfn tests."""
    return float((a - 20) ** 2 + (b - 33) ** 2)
