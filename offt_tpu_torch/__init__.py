"""offt_tpu_torch: the PyTorch and CUDA port of offt_tpu for an NVIDIA
H100.

The ported slices are the single-device transforms on planar float32
(re, im) pairs:

- c2c (first slice): ``plan(shape, "complex64", planar=True)`` runs the
  fused (y, z) slab kernel and one x-axis kernel;
- r2c / c2r (second slice): ``plan(shape, "float32", real=True,
  planar=True)`` takes a real tensor to a planar half-spectrum and back,
  in the numpy layout (..., Nz/2 + 1) or with ``packed=True`` the packed
  (..., Nz/2) layout (plane 0 carries X[0] + i X[Nz/2];
  ``unpack_rfft3d`` / ``pack_rfft3d`` convert). The forward runs the r2c +
  y slab kernel and the x kernel (and, for the numpy layout, the assembly
  kernel); the inverse runs the x kernel and the inverse y + c2r slab
  kernel;
- the axis-by-axis route (third slice), which takes every other plan:
  long 1-D c2c, ``plan((1, 1, N), "complex64")`` past the 2-stage
  ceiling, by the four-step kernels (``fft_four_step_planar``); real
  plans with ``planar=False`` or outside the packed kernels' gate, by the
  r2c kernel along z (``rfft_last_planar``) or the unfused r2c/c2r around
  the c2c kernels, then one c2c pass per axis;
- the distributed pencil engine (fourth slice): ``plan(...,
  mesh=make_mesh(p1, p2))`` in a ``torch.distributed`` process group;
- the fifth slice: ``fft3d_cube`` (all three axes of batched cubes of at
  most 2^21 points in one cooperative launch), the unfused engine
  (``kernels/stockham.py``: the matmul chain, Bluestein for any length,
  complex128 / float64 plans and ``use_pallas=0``) and the
  ``numpy.fft``-style namespace ``offt_tpu_torch.fft`` on top of the
  plans (``ot.fft.fftn(x)``, ``ot.fft.rfft(x, n=1009)``);
- differentiable plans (``plan/autodiff.py``): a call runs the
  ``torch.autograd.Function`` of its calling convention, whose backward
  is the adjoint plan on the same kernels, with ``jvp`` and ``vmap``
  rules for ``torch.func``; and the rest of the reference's ``plan/``:
  the one-shots ``rfft3d``, ``irfft3d``, ``fft2d``, ``ifft2d``,
  ``rfft2d``, ``irfft2d``, ``donate=`` and the wisdom files
  (``plan.cache``);
- the tuner (``offt_tpu_torch.tune``): ``tune.tune(shape, ...)`` searches
  the plan parameters on the card (CUDA events; on a mesh every rank in
  step) and caches the winner for ``plan()``; the tuning service, its
  client, the ``tuna``-style CLI and the native C++ engine.

The kernels (``kernels/csrc``) are built with nvcc for sm_90a at first
use. On the CPU every kernel wrapper runs its plain PyTorch version
instead, and a plan needs ``device="cpu"`` there. The package imports
``torch``, never ``jax``; ``offt_tpu`` is the reference it is tested
against.
"""

__version__ = "0.1.0"

from .dist.mesh import (RANKORDER_AUTO, RANKORDER_COL, RANKORDER_ROW,
                        Layout, batch_layout, input_layout, local_block,
                        make_mesh, make_multislice_mesh, output_layout)
from . import fft
from .kernels import fft_1d
from .kernels.fourstep import fft_four_step_planar
from .kernels.fused_fft import (can_fuse_cube, fft3d_cube, fft3d_planar,
                                fft_last, fft_slab_yz, fft_sublane,
                                icrfft_last_planar, irfft3d_planar,
                                pack_rfft3d, rfft3d_planar, rfft_last_planar,
                                unpack_rfft3d)
from .plan.api import (Plan, fft2d, fft3d, from_planar, ifft2d, ifft3d,
                       irfft2d, irfft3d, plan, rfft2d, rfft3d, to_planar)
from .plan.params import PlanParams
from . import tune

__all__ = [
    "Layout",
    "Plan",
    "PlanParams",
    "RANKORDER_AUTO",
    "RANKORDER_COL",
    "RANKORDER_ROW",
    "batch_layout",
    "can_fuse_cube",
    "fft",
    "fft2d",
    "fft3d",
    "fft3d_cube",
    "fft3d_planar",
    "fft_1d",
    "fft_four_step_planar",
    "fft_last",
    "fft_slab_yz",
    "fft_sublane",
    "from_planar",
    "icrfft_last_planar",
    "ifft2d",
    "ifft3d",
    "input_layout",
    "irfft2d",
    "irfft3d",
    "irfft3d_planar",
    "local_block",
    "make_mesh",
    "make_multislice_mesh",
    "output_layout",
    "pack_rfft3d",
    "plan",
    "rfft2d",
    "rfft3d",
    "rfft3d_planar",
    "rfft_last_planar",
    "to_planar",
    "tune",
    "unpack_rfft3d",
    "__version__",
]
