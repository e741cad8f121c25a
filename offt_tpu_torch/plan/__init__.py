"""Plans: parameters, the plan cache and the public plan API."""

from .api import Plan, fft3d, from_planar, ifft3d, plan, to_planar
from .params import PlanParams, ProblemSpec, default_params

__all__ = ["Plan", "PlanParams", "ProblemSpec", "default_params", "fft3d",
           "from_planar", "ifft3d", "plan", "to_planar"]
