"""offt_tpu_torch: the PyTorch and CUDA port of offt_tpu for an NVIDIA
H100.

This slice ports the single-device 3-D c2c transform on planar float32
(re, im) pairs: ``plan(shape, "complex64", planar=True)`` runs the fused
(y, z) slab kernel and one x-axis kernel (``kernels/csrc``), built with
nvcc for sm_90a at first use. On the CPU every kernel wrapper runs its
plain PyTorch version instead. The package imports ``torch``, never
``jax``; ``offt_tpu`` is the reference it is tested against.
"""

__version__ = "0.1.0"

from .kernels.fused_fft import fft_last, fft_sublane, fft_slab_yz, fft3d_planar
from .plan.api import Plan, fft3d, from_planar, ifft3d, plan, to_planar
from .plan.params import PlanParams

__all__ = [
    "Plan",
    "PlanParams",
    "fft3d",
    "fft3d_planar",
    "fft_last",
    "fft_slab_yz",
    "fft_sublane",
    "from_planar",
    "ifft3d",
    "plan",
    "to_planar",
    "__version__",
]
