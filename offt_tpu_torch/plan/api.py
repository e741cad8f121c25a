"""Public plan / execute API of the port.

Port of ``offt_tpu/plan/api.py`` for the single-device planar c2c slice:
``plan()`` resolves parameters (cache, then the default point), checks
them, and returns a :class:`Plan`, an ``nn.Module`` whose f32 constant
tables are registered buffers on an explicit device. Calling it runs
``kernels.fused_fft.fft3d_planar`` with the norm scale folded into the
final stage's tables, as the reference's planar fast path does
(``plan/api.py:428-447``). Plans run forward only (autodiff is ROADMAP
Queue 1 item 9).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..kernels import fused_fft
from . import cache
from .params import PlanParams, ProblemSpec, default_params, infeasible_reason


def to_planar(x) -> tuple:
    """Split a complex tensor into the planar (real, imag) float pair."""
    return x.real.contiguous(), x.imag.contiguous()


def from_planar(re, im):
    """Combine a planar pair into a complex tensor."""
    return torch.complex(re, im.to(re.dtype))


def _norm_scale(norm: str, inverse: bool, total: int) -> float:
    """numpy norm conventions: backward (default) scales the inverse by
    1/N; ortho scales both by 1/sqrt(N); forward scales the forward by
    1/N. The pipelines are backward-normalized, so this returns the extra
    output factor to apply (1.0 = none)."""
    if norm in (None, "backward"):
        return 1.0
    if norm == "ortho":
        return math.sqrt(total) if inverse else 1.0 / math.sqrt(total)
    if norm == "forward":
        return float(total) if inverse else 1.0 / total
    raise ValueError(f"norm must be backward|ortho|forward, got {norm!r}")


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    return np.dtype(dtype).name


class Plan(torch.nn.Module):
    """A 3-D c2c plan over the last three axes (forward or inverse).

    ``plan(x)`` takes a complex64 tensor, or with ``planar=True`` a
    (re, im) float32 pair (one tuple or two arguments), of shape
    (*batch, Nx, Ny, Nz) on the plan's device. With ``in_place=True`` the
    planar inputs are overwritten with the result and returned."""

    def __init__(self, spec: ProblemSpec, params: PlanParams, ndim: int,
                 planar: bool, out_scale: float, in_place: bool, device):
        super().__init__()
        self.spec = spec
        self.params = params
        self.ndim = ndim
        self.planar = planar
        self.out_scale = out_scale
        self.in_place = in_place
        # a shape-only run on the meta device walks the route and builds
        # every table it reads, on the plan's device
        tables = fused_fft.TableSet(device)
        shp = (1,) * (ndim - 3) + tuple(spec.shape)
        self._run(torch.empty(shp, device="meta"),
                  torch.empty(shp, device="meta"), tables)
        self._keys = list(tables.tabs)
        for i, t in enumerate(tables.tabs.values()):
            self.register_buffer(f"table{i}", t)
        # carries the device for a plan with no tables (all axes length 1)
        self.register_buffer("anchor", torch.empty(0, device=device),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return self.anchor.device

    def _tables(self) -> fused_fft.TableSet:
        bufs = [getattr(self, f"table{i}") for i in range(len(self._keys))]
        return fused_fft.TableSet(self.device, dict(zip(self._keys, bufs)))

    def _run(self, xr, xi, tables):
        p = self.params
        return fused_fft.fft3d_planar(
            xr, xi, inverse=self.spec.inverse, rad_z=p.radix_z,
            rad_y=p.radix_y, rad_x=p.radix_x, precision=p.precision,
            block=p.block_batch, slab_rows=p.slab_rows,
            out_scale=self.out_scale, x_tile=p.x_tile,
            in_place=self.in_place, tables=tables)

    def _check(self, t, what: str):
        want = tuple(self.spec.shape)
        if t.ndim != self.ndim or tuple(t.shape[-3:]) != want:
            raise ValueError(f"{what} shape {tuple(t.shape)} does not match "
                             f"the plan's (*{self.ndim - 3} batch, "
                             f"{want})")
        if t.device != self.device:
            raise ValueError(f"{what} on {t.device}, plan on {self.device}")
        if torch.is_grad_enabled() and t.requires_grad:
            raise NotImplementedError("plans run forward only; autodiff "
                                      "is ROADMAP Queue 1 item 9")

    def forward(self, x, x_imag=None):
        if self.planar:
            if x_imag is None:
                x, x_imag = x
            self._check(x, "re")
            self._check(x_imag, "im")
            return self._run(x, x_imag, self._tables())
        self._check(x, "input")
        if x.dtype != torch.complex64:
            raise TypeError(f"plan expects complex64, got {x.dtype}")
        yr, yi = self._run(*to_planar(x), self._tables())
        return torch.complex(yr, yi)


def plan(shape, dtype="complex64", *, mesh=None, real: bool = False,
         inverse: bool = False, batch_dims: int = 0,
         params: Optional[PlanParams] = None, use_cache: bool = True,
         planar: bool = False, norm: Optional[str] = None,
         batch_sharded: bool = False, packed: bool = False,
         donate: bool = False, in_place: bool = False,
         device=None) -> Plan:
    """Build a single-device 3-D c2c plan. ``shape`` is (Nx, Ny, Nz);
    ``norm`` follows numpy (backward | ortho | forward); ``device``
    defaults to the current CUDA device, else the CPU (where the kernels'
    plain versions run)."""
    if len(shape) != 3:
        raise ValueError(f"shape must be (Nx, Ny, Nz), got {shape}")
    if real or packed:
        raise NotImplementedError("r2c/c2r and the packed layout are "
                                  "ROADMAP Queue 1 item 5")
    if mesh is not None or batch_sharded:
        raise NotImplementedError("distributed plans are ROADMAP Queue 1 "
                                  "item 14")
    if donate:
        raise NotImplementedError("donate= is ROADMAP Queue 1 item 8 "
                                  "(in_place=True overwrites the inputs)")
    name = _dtype_name(dtype)
    if name == "complex128":
        raise NotImplementedError("complex128 (the fp64 unfused route) is "
                                  "ROADMAP Queue 1 item 7")
    if name != "complex64":
        raise ValueError(f"c2c plans take complex64, got {name}")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    shape = tuple(int(n) for n in shape)
    spec = ProblemSpec(shape=shape, dtype=name, inverse=inverse)
    if params is None and use_cache:
        params = cache.lookup(cache.plan_key(
            shape, name, False, 1, 1, cache.device_kind(device),
            inverse=inverse))
    if params is None:
        params = default_params(spec)
    reason = infeasible_reason(spec, params)
    if reason is not None:
        raise ValueError(f"infeasible plan: {reason}")
    if params.split_1d is not None:
        raise NotImplementedError("split_1d (the four-step route) is "
                                  "ROADMAP Queue 1 item 6")
    radices = (params.radix_x, params.radix_y, params.radix_z)
    if not params.use_pallas or not all(
            fused_fft.can_use_pallas(n, r) for n, r in zip(shape, radices)):
        raise NotImplementedError(
            "only the fused kernel route is ported; the unfused route "
            f"(use_pallas=0, or shape {shape} not kernel-expressible) is "
            "ROADMAP Queue 1 item 7")
    if in_place:
        if not planar:
            raise ValueError("in_place requires planar=True")
        if shape[0] > 1 and not fused_fft.can_fuse_slab(
                shape[1], shape[2], params.radix_y, params.radix_z):
            raise ValueError("in_place needs a fusable (y,z) slab: "
                             f"ny*nz = {shape[1] * shape[2]} exceeds the "
                             "slab ceiling or an axis is not expressible")
    scale = _norm_scale(norm, inverse, shape[0] * shape[1] * shape[2])
    return Plan(spec, params, batch_dims + 3, planar, scale, in_place,
                device)


def fft3d(x, mesh=None, params=None, **kw):
    """3-D c2c over the last three axes of a complex64 tensor."""
    p = plan(tuple(x.shape[-3:]), x.dtype, mesh=mesh, params=params,
             batch_dims=x.ndim - 3, device=x.device, **kw)
    return p(x)


def ifft3d(x, mesh=None, params=None, **kw):
    """Inverse 3-D c2c over the last three axes of a complex64 tensor."""
    p = plan(tuple(x.shape[-3:]), x.dtype, mesh=mesh, params=params,
             inverse=True, batch_dims=x.ndim - 3, device=x.device, **kw)
    return p(x)
