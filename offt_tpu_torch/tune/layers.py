"""Pluggable processing layers around the search strategy.

A copy of ``offt_tpu/tune/layers.py``.

Re-expression of Active Harmony's session-core plugin workflow
(activeharmony/build/session-core.c:334-445): candidate
points travel DOWN a stack of generation hooks before they are released
for evaluation, and reports travel UP the same stack in reverse order.
Each generation hook can ACCEPT the point, REJECT it back to the strategy
(optionally with a replacement hint, like the Omega constraint plugin,
plugins/constraint.c), or REPLACE it (a transform, like the codegen
plugin's variant substitution). Analysis hooks may rewrite the measured
objective (e.g. penalty terms) on the way back to the strategy.

The async fd-callback machinery (session-core.c:891-925) collapses under
Python: a layer that needs to do slow work (compile, remote call) just
does it in ``generate`` — the Tuner already overlaps candidate compilation
with device measurement via its thread pool.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from .space import Point, SearchSpace

ACCEPT = "accept"
REJECT = "reject"
REPLACE = "replace"


class Layer:
    """Base layer: pass-through in both directions. Subclass and override
    ``generate`` (downward) and/or ``analyze`` (upward)."""

    name = "layer"

    def generate(self, space: SearchSpace,
                 point: Point) -> tuple[str, Optional[Point], str]:
        """Return (ACCEPT, point, "") | (REJECT, hint_or_None, reason) |
        (REPLACE, new_point, reason)."""
        return ACCEPT, point, ""

    def analyze(self, space: SearchSpace, point: Point,
                perf: float) -> float:
        """Transform the measured objective on its way to the strategy."""
        return perf


@dataclasses.dataclass
class FilterLayer(Layer):
    """Reject points failing a predicate over parameter values — the
    constraint-plugin shape (plugins/constraint.c) for programmatic
    predicates that don't fit the expression-string constraints."""

    predicate: Callable[..., bool]
    name: str = "filter"

    def generate(self, space, point):
        params = space.to_params(point)
        try:
            ok = bool(self.predicate(params))
        except Exception as e:
            return REJECT, None, f"{self.name} errored: {e!r}"
        if ok:
            return ACCEPT, point, ""
        return REJECT, None, f"{self.name} rejected"


@dataclasses.dataclass
class TransformLayer(Layer):
    """Rewrite candidate points before evaluation (canonicalization — the
    ADJUST_POINT analogue, offt-tuning.c:90-118)."""

    fn: Callable[[SearchSpace, Point], Point]
    name: str = "transform"

    def generate(self, space, point):
        new = tuple(self.fn(space, point))
        if new == tuple(point):
            return ACCEPT, point, ""
        return REPLACE, new, f"{self.name} rewrote point"


@dataclasses.dataclass
class PenaltyLayer(Layer):
    """Add an objective penalty on the analysis (upward) direction."""

    fn: Callable[[SearchSpace, Point, float], float]
    name: str = "penalty"

    def analyze(self, space, point, perf):
        return float(self.fn(space, point, perf))


def run_generation(layers: Sequence[Layer], space: SearchSpace,
                   point: Point) -> tuple[str, Optional[Point], str]:
    """Run a candidate DOWN the stack (session-core workflow, generation
    direction). Stops at the first REJECT."""
    for layer in layers:
        action, point, reason = layer.generate(space, point)
        if action == REJECT:
            return REJECT, point, reason
    return ACCEPT, point, ""


def run_analysis(layers: Sequence[Layer], space: SearchSpace, point: Point,
                 perf: float) -> float:
    """Run a report UP the stack (reverse order)."""
    for layer in reversed(layers):
        perf = layer.analyze(space, point, perf)
    return perf
