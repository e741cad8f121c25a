"""Plans: parameter space, feasibility, the persistent cache (and its
wisdom files), the public plan API and its autodiff rules."""

from . import cache
from .api import (Plan, fft2d, fft3d, from_planar, ifft2d, ifft3d, irfft2d,
                  irfft3d, plan, rfft2d, rfft3d, to_planar)
from .params import (
    PlanParams,
    ProblemSpec,
    default_params,
    infeasible_reason,
    is_feasible,
    p1_candidates,
    pow2_grid,
    w_from_reference,
)

__all__ = [
    "Plan", "PlanParams", "ProblemSpec", "cache", "default_params",
    "fft2d", "fft3d", "from_planar", "ifft2d", "ifft3d", "infeasible_reason",
    "irfft2d", "irfft3d", "is_feasible", "p1_candidates", "plan",
    "pow2_grid", "rfft2d", "rfft3d", "to_planar", "w_from_reference",
]
