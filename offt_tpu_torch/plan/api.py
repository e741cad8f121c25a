"""Public plan / execute API of the port.

Port of ``offt_tpu/plan/api.py`` for the single-device planar slices:
``plan()`` resolves parameters (cache, then the default point), checks
them, and returns a :class:`Plan`, an ``nn.Module`` whose f32 constant
tables are registered buffers on an explicit device. A c2c plan runs
``kernels.fused_fft.fft3d_planar`` with the norm scale folded into the
final stage's tables, as the reference's planar fast path does
(``plan/api.py:428-447``). A real plan (``real=True, planar=True``) runs
``rfft3d_planar`` / ``irfft3d_planar``, the reference's packed r2c/c2r
fast path (``plan/api.py:399-424``), in the numpy layout (..., Nz/2 + 1)
or with ``packed=True`` the packed (..., Nz/2) layout; the reference
post-multiplies its norm scale, the port folds it into the forward x
pass's tables and the inverse re-tangle table (the same values: the
plane-0 split and the assembly are linear). Plans run forward only
(autodiff is ROADMAP Queue 1 item 9).
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
    """A 3-D plan over the last three axes (forward or inverse).

    A c2c plan takes a complex64 tensor, or with ``planar=True`` a
    (re, im) float32 pair (one tuple or two arguments), of shape
    (*batch, Nx, Ny, Nz) on the plan's device. With ``in_place=True`` the
    planar inputs are overwritten with the result and returned.

    A real forward plan takes one real float32 tensor (*batch, Nx, Ny, Nz)
    and returns a planar pair of shape (*batch, Nx, Ny, L); a real inverse
    plan takes such a pair and returns the real tensor. L is Nz/2 + 1 (the
    numpy rfftn layout) or Nz/2 with ``packed=True`` (plane 0 carries
    X[0] + i X[Nz/2])."""

    def __init__(self, spec: ProblemSpec, params: PlanParams, ndim: int,
                 planar: bool, out_scale: float, in_place: bool, device,
                 packed: bool = False):
        super().__init__()
        self.spec = spec
        self.params = params
        self.ndim = ndim
        self.planar = planar
        self.out_scale = out_scale
        self.in_place = in_place
        self.packed = packed
        # a shape-only run on the meta device walks the route and builds
        # every table it reads, on the plan's device
        tables = fused_fft.TableSet(device)
        shp = (1,) * (ndim - 3) + self.in_shape
        self._run([torch.empty(shp, device="meta")
                   for _ in range(self._n_inputs)], tables)
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

    @property
    def in_shape(self) -> tuple:
        """The trailing three dims of each input."""
        nx, ny, nz = self.spec.shape
        if self.spec.real and self.spec.inverse:
            return (nx, ny, nz // 2 + (0 if self.packed else 1))
        return (nx, ny, nz)

    @property
    def _n_inputs(self) -> int:
        """1 for a real forward plan (one real tensor), else 2 (a pair)."""
        return 1 if self.spec.real and not self.spec.inverse else 2

    def _run(self, xs, tables):
        p = self.params
        kw = {"rad_z": p.radix_z, "rad_y": p.radix_y, "rad_x": p.radix_x,
              "precision": p.precision, "slab_rows": p.slab_rows,
              "out_scale": self.out_scale, "x_tile": p.x_tile,
              "tables": tables}
        if self.spec.real:
            if self.spec.inverse:
                return fused_fft.irfft3d_planar(*xs, self.spec.shape[2],
                                                packed=self.packed, **kw)
            return fused_fft.rfft3d_planar(*xs, packed=self.packed, **kw)
        return fused_fft.fft3d_planar(
            *xs, inverse=self.spec.inverse, block=p.block_batch,
            in_place=self.in_place, **kw)

    def _check(self, t, what: str):
        want = self.in_shape
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
        if self._n_inputs == 1:
            if x_imag is not None:
                raise TypeError("a real forward plan takes one real tensor")
            self._check(x, "input")
            return self._run((x,), self._tables())
        if self.planar:
            if x_imag is None:
                x, x_imag = x
            self._check(x, "re")
            self._check(x_imag, "im")
            return self._run((x, x_imag), self._tables())
        self._check(x, "input")
        if x.dtype != torch.complex64:
            raise TypeError(f"plan expects complex64, got {x.dtype}")
        yr, yi = self._run(to_planar(x), self._tables())
        return torch.complex(yr, yi)


def plan(shape, dtype="complex64", *, mesh=None, real: bool = False,
         inverse: bool = False, batch_dims: int = 0,
         params: Optional[PlanParams] = None, use_cache: bool = True,
         planar: bool = False, norm: Optional[str] = None,
         batch_sharded: bool = False, packed: bool = False,
         donate: bool = False, in_place: bool = False,
         device=None) -> Plan:
    """Build a single-device 3-D plan. ``shape`` is the spatial
    (Nx, Ny, Nz); ``norm`` follows numpy (backward | ortho | forward);
    ``device`` defaults to the current CUDA device, else the CPU (where
    the kernels' plain versions run).

    ``real=True`` (with ``planar=True``) plans r2c forward and c2r
    inverse; ``dtype`` may name the real type ("float32" maps to
    complex64). ``packed=True`` selects the packed (..., Nz/2) layout,
    whose plane 0 carries X[0] + i X[Nz/2]; convert with
    ``fused_fft.unpack_rfft3d`` / ``pack_rfft3d``. A real plan that the
    packed kernels' gate (``can_use_rfft3d``) refuses, or one with
    ``planar=False``, needs the unfused route (ROADMAP Queue 1 item 7)."""
    if len(shape) != 3:
        raise ValueError(f"shape must be (Nx, Ny, Nz), got {shape}")
    if packed and (not real or not planar or batch_sharded):
        raise ValueError("packed layout requires real=True, planar=True "
                         "(and not batch_sharded)")
    if mesh is not None or batch_sharded:
        raise NotImplementedError("distributed plans are ROADMAP Queue 1 "
                                  "item 14")
    if donate:
        raise NotImplementedError("donate= is ROADMAP Queue 1 item 8 "
                                  "(in_place=True overwrites the inputs)")
    name = _dtype_name(dtype)
    if real and name in ("float16", "bfloat16", "float32", "float64"):
        # real transforms name the real type; only float64 maps to the
        # fp64 pipeline, as in the reference (plan/api.py:550-556)
        name = "complex128" if name == "float64" else "complex64"
    if name == "complex128":
        raise NotImplementedError("complex128 (the fp64 unfused route) is "
                                  "ROADMAP Queue 1 item 7")
    if name != "complex64":
        raise ValueError(f"plans take complex64 (real plans float32), got "
                         f"{name}")
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    shape = tuple(int(n) for n in shape)
    spec = ProblemSpec(shape=shape, dtype=name, real=real, inverse=inverse)
    if params is None and use_cache:
        params = cache.lookup(cache.plan_key(
            shape, name, real, 1, 1, cache.device_kind(device),
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
    scale = _norm_scale(norm, inverse, shape[0] * shape[1] * shape[2])
    if real:
        if in_place:
            raise ValueError("in_place requires the single-device planar "
                             "c2c kernel path")
        if packed:
            params = params.replace(use_pallas=1)
        fast = fused_fft.can_use_rfft3d(*shape, *radices)
        if packed and not fast:
            raise ValueError("packed layout needs the r2c kernel path "
                             f"(shape {shape} not eligible)")
        if not (planar and params.use_pallas and fast):
            raise NotImplementedError(
                "only the packed r2c/c2r kernel path is ported; real plans "
                f"with planar=False, use_pallas=0 or shape {shape} outside "
                "can_use_rfft3d take the unfused rfft route, ROADMAP "
                "Queue 1 item 7")
        return Plan(spec, params, batch_dims + 3, planar, scale, False,
                    device, packed=packed)
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
