"""Public plan / execute API of the port.

Port of ``offt_tpu/plan/api.py``: ``plan()`` resolves parameters (cache,
then the default point), checks them, and returns a :class:`Plan`, an
``nn.Module`` whose f32 constant tables are registered buffers on an
explicit device. Its route is the reference's choice (``_build_fn``,
``plan/api.py:396-481``). On one device, in this order:

- ``"rfft3d"``: a complex64 real plan with ``planar=True`` and its
  kernels on (``params.use_pallas``) inside ``can_use_rfft3d`` runs
  ``rfft3d_planar`` / ``irfft3d_planar``, the packed r2c/c2r fast path
  (``plan/api.py:399-424``), in the numpy layout (..., Nz/2 + 1) or with
  ``packed=True`` the packed (..., Nz/2) layout;
- ``"fft3d"``: a complex64 c2c plan with its kernels on whose every axis
  is 2-stage expressible runs ``fft3d_planar`` (``plan/api.py:428-447``);
- ``"local"``: everything else runs ``_local_fft3d``
  (``plan/api.py:109-140``), the axis-by-axis route: the r2c along z
  (``_rfft_z``: the ``rfft_last_planar`` kernel, else ``rfft.rfft_1d``
  around ``axis_fft``) or a c2c along z, then y and x through
  ``dist.pencil.axis_fft`` (2-stage kernels, or the four-step route for
  a long last axis, as ``plan((1, 1, N))`` takes it; else the unfused
  engine, ``kernels/stockham.py``); the inverse in the mirror order,
  ending in ``rfft.irfft_1d``. This is also the fp64 route: a complex128
  plan (a float64 real one) runs on float64 pairs through the unfused
  engine alone, as does a plan with ``use_pallas=0``.

On a mesh (``dist/mesh.py``; every rank builds and calls the same plan
on its own block):

- ``"pencil"``: the distributed pipeline (``dist/pencil.py``,
  ``plan/api.py:254-355``), z-pencils in and the transposed-out layout
  out (the reverse for an inverse plan). A real plan overrides the z
  stage (``real_stage_fns``): the r2c kernel along z forward
  (``rfft_last_planar``, packed or numpy layout), the packed c2r kernel
  (``icrfft_last_planar``) or ``rfft.irfft_1d`` inverse. Uneven shapes
  pad each rank's block to the equal block of the padded global shape
  and slice the result back;
- ``batch_sharded=True``: the first batch dim is split over every rank
  and each rank runs the single-device "fft3d" or "local" route on its
  block, with no collective (``plan/api.py:280-302``).

- ``"long1d"``: a degenerate (1, 1, N) plan on a mesh of P > 1 ranks,
  not ``batch_sharded``, runs the distributed long-1-D engine
  (``dist/long1d.py``, the reference's ``plan/api.py:452-475``) where it
  builds: c2c where a split of N with P | n1 and P | n2 exists, a real
  plan in the packed layout where one of N / 2 does. Input and output are
  in natural order (``Plan.input_layout`` = ``output_layout`` =
  ``mesh.natural_layout``), each rank passing its contiguous chunk. Every
  other (1, 1, N) mesh plan (the numpy-layout real 1-D, a length with no
  such split, any 1 x 1 mesh) takes the pencil engine, as the
  reference's does; on more than one rank that puts all the work on one
  rank, so building it warns (``UserWarning``, with N, P and the reason).

Plans are differentiable (``plan/autodiff.py``): a call that autograd,
forward mode or a ``torch.func`` transform tracks goes through the
``torch.autograd.Function`` of its calling convention, whose backward
applies the adjoint plan, so ``torch.autograd.grad``, ``torch.func.grad``,
``jvp`` and ``vmap`` run the same kernels; any other call runs the
transform alone.

The reference post-multiplies its norm scale on the unfused and
distributed routes; the port folds it into the tables of one pass (the
last stage of the fast paths; the z pass of ``_local_fft3d`` and of the
pencil pipeline), which gives the same values since every pass is
linear.

The one-shot calls, :func:`fft3d` / :func:`ifft3d`, :func:`rfft3d` /
:func:`irfft3d` and the 2-D :func:`fft2d`, :func:`ifft2d`,
:func:`rfft2d`, :func:`irfft2d` (a (1, Y, N) plan, on a ``make_mesh(1,
p)`` mesh the pencil engine with one exchange: the reference's METHOD-ONE
analogue), build their plan on the first call of each signature and keep
it.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..dist import long1d
from ..dist import mesh as meshlib
from ..dist.pencil import _pad_to, _slice_to, axis_fft, make_pencil_fft3d
from ..kernels import fused_fft, rfft
from ..kernels.tables import _pick_2stage
from . import autodiff, cache
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


def _real_fft_fn(params: PlanParams, out_scale: float = 1.0, tables=None):
    """The inner c2c of the unfused r2c/c2r (``rfft_1d`` / ``irfft_1d``):
    ``axis_fft`` with ``radix_z``, dropped when the inner length differs
    (the odd-N full-length fallback). ``out_scale`` rides its tables."""

    def fn(vr, vi, inverse):
        rad = params.radix_z
        if rad is not None and math.prod(rad) != vr.shape[-1]:
            rad = None
        return axis_fft(vr, vi, -1, inverse, rad, params,
                        out_scale=out_scale, tables=tables)

    return fn


def _rfft_z(x, params: PlanParams, nz: int, out_scale: float = 1.0,
            tables=None):
    """Forward r2c along the last axis into the numpy layout: the
    ``rfft_last_planar`` kernel for float32 data on a plan with its
    kernels on when ``can_use_rfft_last``, else ``rfft_1d`` around
    ``axis_fft``."""
    if (params.use_pallas and x.dtype == torch.float32
            and fused_fft.can_use_rfft_last(nz, params.radix_z)):
        return fused_fft.rfft_last_planar(x, radices=params.radix_z,
                                          precision=params.precision,
                                          scale=out_scale, tables=tables)
    return rfft.rfft_1d(x, _real_fft_fn(params, out_scale, tables),
                        tables=tables)


def _local_fft3d(xs, inverse: bool, real: bool, nz: int, params: PlanParams,
                 out_scale: float = 1.0, tables=None):
    """The single-device axis-by-axis route on planar data: z, y, x
    forward (r2c along z for a real plan, taking one real tensor), x, y, z
    inverse (c2r along z for a real plan, giving one real tensor). The
    ``out_scale`` rides the z pass."""
    p = params
    if not inverse:
        if real:
            yr, yi = _rfft_z(xs[0], p, nz, out_scale, tables)
        else:
            yr, yi = axis_fft(*xs, -1, False, p.radix_z, p, out_scale,
                              tables)
        yr, yi = axis_fft(yr, yi, -2, False, p.radix_y, p, tables=tables)
        return axis_fft(yr, yi, -3, False, p.radix_x, p, tables=tables)
    yr, yi = axis_fft(*xs, -3, True, p.radix_x, p, tables=tables)
    yr, yi = axis_fft(yr, yi, -2, True, p.radix_y, p, tables=tables)
    if real:
        return rfft.irfft_1d(yr, yi, nz, _real_fft_fn(p, out_scale, tables),
                             tables=tables)
    return axis_fft(yr, yi, -1, True, p.radix_z, p, out_scale, tables)


def real_stage_fns(params: PlanParams, nz: int, packed: bool,
                   inverse: bool, real: bool = True,
                   out_scale: float = 1.0, adjoint: bool = False) -> tuple:
    """(first_fn, last_fn) that take the pencil pipeline's z stage for a
    real plan, each ``fn(xs, tables) -> tuple`` and carrying
    ``out_scale``: forward the r2c along z (the ``rfft_last_planar``
    kernel; packed, or the numpy layout by ``_rfft_z``), inverse the c2r
    of the half-spectrum after the exchange pad is sliced away (the
    ``icrfft_last_planar`` kernel, or ``rfft.irfft_1d``). (None, None)
    for c2c.

    ``adjoint=True`` gives the stages of a mesh real plan's adjoint
    (``plan/autodiff.py``), z being whole there: inverse, the r2c's
    transpose (zero-pad the half-spectrum, inverse c2c along z, real
    part); forward, the c2r's (r2c along z, then ``c2r_transpose``)."""
    if not real:
        return None, None
    nzf = nz // 2 if packed else nz // 2 + 1
    if adjoint and inverse:
        def last_fn(xs, tables):
            xr, xi = autodiff.zero_pad_z(*_slice_to(xs, -1, nzf), nz, packed)
            yr, _ = axis_fft(xr, xi, -1, True, None, params, out_scale,
                             tables)
            return (yr,)
        return None, last_fn
    if adjoint:
        def first_fn(xs, tables):
            if packed:
                vr, vi = fused_fft.rfft_last_planar(
                    xs[0], radices=params.radix_z,
                    precision=params.precision, packed=True,
                    scale=out_scale, tables=tables)
            else:
                vr, vi = _rfft_z(xs[0], params, nz, out_scale, tables)
            return autodiff.c2r_transpose(vr, vi, nz, packed, False)
        return first_fn, None
    if not inverse:
        if packed:
            def first_fn(xs, tables):
                return fused_fft.rfft_last_planar(
                    xs[0], radices=params.radix_z,
                    precision=params.precision, packed=True,
                    scale=out_scale, tables=tables)
        else:
            def first_fn(xs, tables):
                return _rfft_z(xs[0], params, nz, out_scale, tables)
        return first_fn, None
    if packed:
        def last_fn(xs, tables):
            xr, xi = _slice_to(xs, -1, nzf)
            return (fused_fft.icrfft_last_planar(
                xr, xi, nz, radices=params.radix_z,
                precision=params.precision, scale=out_scale / (nz // 2),
                tables=tables),)
    else:
        def last_fn(xs, tables):
            xr, xi = _slice_to(xs, -1, nzf)
            return (rfft.irfft_1d(xr, xi, nz,
                                  _real_fft_fn(params, out_scale, tables),
                                  tables=tables),)
    return None, last_fn


def _route(spec: ProblemSpec, params: PlanParams, planar: bool) -> str:
    """The reference's route for ``mesh=None``: "rfft3d", "fft3d" or
    "local" (module doc)."""
    radices = (params.radix_x, params.radix_y, params.radix_z)
    if not params.use_pallas or spec.dtype != "complex64":
        return "local"
    if spec.real:
        if planar and fused_fft.can_use_rfft3d(*spec.shape, *radices):
            return "rfft3d"
        return "local"
    if all(fused_fft.can_use_pallas(n, r)
           for n, r in zip(spec.shape, radices)):
        return "fft3d"
    return "local"


class Plan(torch.nn.Module):
    """A 3-D plan over the last three axes (forward or inverse).

    A c2c plan takes a complex64 tensor, or with ``planar=True`` a
    (re, im) float32 pair (one tuple or two arguments), of shape
    (*batch, Nx, Ny, Nz) on the plan's device, and returns the same kind.
    With ``in_place=True`` (or ``donate=True`` on the planar c2c kernel
    route: ``plan.in_place``) the planar inputs are overwritten with the
    result and returned. A complex128 plan (the fp64 route) takes and
    returns complex128, or float64 pairs.

    A real forward plan takes one real float32 tensor (float64 for a
    float64 plan) (*batch, Nx, Ny, Nz) and returns the half-spectrum
    (*batch, Nx, Ny, L): a planar pair with ``planar=True``, else a
    complex tensor. A real inverse plan takes such a half-spectrum and
    returns the real tensor. L is Nz/2 + 1 (the
    numpy rfftn layout) or Nz/2 with ``packed=True`` (plane 0 carries
    X[0] + i X[Nz/2]).

    On a mesh each rank passes its block of the global input and gets its
    block of the global output: ``input_layout`` / ``output_layout`` say
    how the global arrays lie on ``mesh`` (which ``params.rankorder`` may
    have re-gridded), and ``input_block(shape)`` / ``output_block(shape)``
    give this rank's slices of a global shape.

    A call is differentiable: where autograd tracks it, it runs the
    ``torch.autograd.Function`` of its calling convention
    (``plan/autodiff.py``)."""

    def __init__(self, spec: ProblemSpec, params: PlanParams, ndim: int,
                 planar: bool, out_scale: float, in_place: bool, device,
                 packed: bool, route: str, args: dict, mesh=None,
                 z_adjoint: bool = False, engine=None):
        super().__init__()
        self.spec = spec
        self.params = params
        self.ndim = ndim
        self.planar = planar
        self.out_scale = out_scale
        # runs in place: in_place=True, or donate=True where the route has
        # an in-place form
        self.in_place = in_place
        # the plan() arguments it was built from (resolved params), from
        # which autodiff builds its adjoint and batched plans
        self._args = args
        self.norm = args["norm"]
        # the adjoint of a mesh real plan of the other direction
        # (``autodiff._swapped``): its z stage is that plan's transpose
        self.z_adjoint = z_adjoint
        self._rel = {}
        # the real type of the plan's planar data and its complex type
        wide = spec.dtype == "complex128"
        self.real_dtype = torch.float64 if wide else torch.float32
        self.complex_dtype = torch.complex128 if wide else torch.complex64
        self.packed = packed
        self.route = route
        self.mesh = mesh
        self.input_layout = self.output_layout = None
        if mesh is not None:
            self._coord = meshlib.coords(mesh)
            if spec.batch_sharded:
                self.input_layout = meshlib.batch_layout(mesh, ndim)
                self.output_layout = self.input_layout
            else:
                zpen = meshlib.input_layout(mesh, ndim)
                tout = meshlib.output_layout(mesh, ndim)
                self.input_layout, self.output_layout = (
                    (tout, zpen) if spec.inverse else (zpen, tout))
        # the long-1-D engine (dist/long1d.Long1D), natural order both ways
        self._long1d = engine
        if route == "long1d":
            self.input_layout = meshlib.natural_layout(mesh, ndim)
            self.output_layout = self.input_layout
        if route == "pencil":
            nz = spec.shape[2]
            first_fn, last_fn = real_stage_fns(params, nz, packed,
                                               spec.inverse, spec.real,
                                               out_scale, self.z_adjoint)
            self._pencil = make_pencil_fft3d(
                mesh, params, spec.shape, inverse=spec.inverse,
                rad_z=None if spec.real else params.radix_z,
                rad_y=params.radix_y, rad_x=params.radix_x,
                first_fn=first_fn, last_fn=last_fn,
                z_freq_len=self.in_shape[2] if spec.inverse
                else self.out_shape[2], out_scale=out_scale)
        # a shape-only run on the meta device walks the route and builds
        # every table it reads, on the plan's device
        tables = fused_fft.TableSet(device)
        shp = (1,) * (ndim - 3) + self._local(self.input_layout,
                                              self.in_shape)
        self._run([torch.empty(shp, dtype=self.real_dtype, device="meta")
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
        """The trailing three dims of the global input."""
        nx, ny, nz = self.spec.shape
        if self.spec.real and self.spec.inverse:
            return (nx, ny, nz // 2 + (0 if self.packed else 1))
        return (nx, ny, nz)

    @property
    def out_shape(self) -> tuple:
        """The trailing three dims of the global output."""
        nx, ny, nz = self.spec.shape
        if self.spec.real and not self.spec.inverse:
            return (nx, ny, nz // 2 + (0 if self.packed else 1))
        return (nx, ny, nz)

    def _local(self, layout, shape3) -> tuple:
        """This rank's trailing three dims of a global ``shape3``."""
        if layout is None:
            return tuple(shape3)
        trail = meshlib.Layout(layout.dims[-3:], layout.sizes)
        return trail.local_shape(shape3, self._coord)

    def _block(self, layout, shape) -> tuple:
        if layout is None:
            return tuple(slice(0, n) for n in shape)
        return layout.block(shape, self._coord)

    def input_block(self, shape) -> tuple:
        """This rank's slices of a global input of ``shape``."""
        return self._block(self.input_layout, shape)

    def output_block(self, shape) -> tuple:
        """This rank's slices of a global output of ``shape``."""
        return self._block(self.output_layout, shape)

    @property
    def _n_inputs(self) -> int:
        """1 for a real forward plan (one real tensor), else 2 (a pair)."""
        return 1 if self.spec.real and not self.spec.inverse else 2

    def _run_pencil(self, xs, tables):
        """Pad the block to the padded global shape's equal block, run the
        pipeline, slice the result to this rank's block."""
        sizes = dict(self.input_layout.sizes)
        for k, (n, entry) in enumerate(zip(self.in_shape,
                                           self.input_layout.dims[-3:])):
            if entry is not None:
                xs = _pad_to(xs, self.ndim - 3 + k, -(-n // sizes[entry]))
        ys = self._pencil(xs, tables)
        want = self._local(self.output_layout, self.out_shape)
        for k, n in enumerate(want):
            ys = tuple(y.narrow(self.ndim - 3 + k, 0, n) for y in ys)
        ys = tuple(y.contiguous() for y in ys)
        return ys[0] if len(ys) == 1 else ys

    def _run(self, xs, tables):
        p = self.params
        if self.route == "pencil":
            return self._run_pencil(tuple(xs), tables)
        if self.route == "long1d":
            ys = self._long1d(tuple(xs), tables)
            return ys[0] if len(ys) == 1 else ys
        if self.route == "local":
            return _local_fft3d(xs, self.spec.inverse, self.spec.real,
                                self.spec.shape[2], p, self.out_scale,
                                tables)
        kw = {"rad_z": p.radix_z, "rad_y": p.radix_y, "rad_x": p.radix_x,
              "precision": p.precision, "slab_rows": p.slab_rows,
              "out_scale": self.out_scale, "x_tile": p.x_tile,
              "tables": tables}
        if self.route == "rfft3d":
            if self.spec.inverse:
                return fused_fft.irfft3d_planar(*xs, self.spec.shape[2],
                                                packed=self.packed, **kw)
            return fused_fft.rfft3d_planar(*xs, packed=self.packed, **kw)
        return fused_fft.fft3d_planar(
            *xs, inverse=self.spec.inverse, block=p.block_batch,
            in_place=self.in_place, **kw)

    def _check(self, t, what: str, dtype):
        want = self._local(self.input_layout, self.in_shape)
        if t.ndim != self.ndim or tuple(t.shape[-3:]) != want:
            raise ValueError(f"{what} shape {tuple(t.shape)} does not match "
                             f"the plan's (*{self.ndim - 3} batch, "
                             f"{want})")
        if t.device != self.device:
            raise ValueError(f"{what} on {t.device}, plan on {self.device}")
        if t.dtype != dtype:
            raise TypeError(f"{what}: plan expects {dtype}, got {t.dtype}")

    def _related(self, z_adjoint: bool = False, **changes) -> "Plan":
        """The plan of this one's arguments with ``changes`` (an adjoint),
        built on the first request and kept on this plan. It takes this
        plan's params, or the cache and default point where those are
        infeasible for it (the reference's ``_adj_plan``)."""
        key = _frozen((changes, z_adjoint))
        p = self._rel.get(key)
        if p is None:
            args = {**self._args, **changes}
            try:
                p = _build(**args, z_adjoint=z_adjoint)
            except ValueError:
                p = _build(**{**args, "params": None, "use_cache": True},
                           z_adjoint=z_adjoint)
            self._rel[key] = p
        return p

    def _batched(self) -> "Plan":
        """This plan with one more batch dim (``vmap``'s), from the
        one-shot cache; it does not run in place."""
        kw = {k: v for k, v in self._args.items()
              if k not in ("shape", "dtype", "inverse", "batch_dims",
                           "device", "mesh", "params")}
        kw.update(in_place=False, donate=False)
        a = self._args
        return _cached_plan(a["shape"], a["dtype"], a["inverse"],
                            a["batch_dims"] + 1, a["device"], a["mesh"],
                            a["params"], kw, z_adjoint=self.z_adjoint)

    def _execute(self, xs):
        """The transform of the calling convention's inputs ``xs`` (a
        tuple), outside autograd; in place, the input tensors are
        returned."""
        if not self.planar and self._n_inputs == 2:
            xs = to_planar(xs[0])
        y = self._run(tuple(xs), self._tables())
        if self.in_place:
            return tuple(xs)
        if self.planar or (self.spec.real and self.spec.inverse):
            return y
        return torch.complex(*y)

    def forward(self, x, x_imag=None):
        if self._n_inputs == 1:
            if x_imag is not None:
                raise TypeError("a real forward plan takes one real tensor")
            self._check(x, "input", self.real_dtype)
            xs = (x,)
        elif self.planar:
            if x_imag is None:
                x, x_imag = x
            self._check(x, "re", self.real_dtype)
            self._check(x_imag, "im", self.real_dtype)
            xs = (x, x_imag)
        else:
            self._check(x, "input", self.complex_dtype)
            xs = (x,)
        if self.in_place or autodiff.tracked(xs):
            return autodiff.function_of(self).apply(self, *xs)
        return self._execute(xs)


def _mesh_device(mesh, device) -> torch.device:
    """The plan's device on a mesh: the current CUDA device for a "cuda"
    mesh, the CPU for a "cpu" one; a ``device`` of another type raises."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a mesh plan needs the default process group "
                           "that its mesh was made in")
    if mesh.device_type not in ("cuda", "cpu"):
        raise ValueError(f"mesh device type {mesh.device_type!r}")
    want = torch.device(mesh.device_type if device is None else device)
    if want.type != mesh.device_type:
        raise ValueError(f"device {want} on a {mesh.device_type!r} mesh")
    return want


def plan(shape, dtype="complex64", *, mesh=None, real: bool = False,
         inverse: bool = False, batch_dims: int = 0,
         params: Optional[PlanParams] = None, use_cache: bool = True,
         planar: bool = False, norm: Optional[str] = None,
         batch_sharded: bool = False, packed: bool = False,
         donate: bool = False, in_place: bool = False,
         device=None) -> Plan:
    """Build a 3-D plan. ``shape`` is the global spatial (Nx, Ny, Nz);
    ``norm`` follows numpy (backward | ortho | forward). ``device``
    defaults to the current CUDA device and raises when there is none: a
    plan on the CPU, where the kernels' plain versions run, needs
    ``device="cpu"``.

    ``mesh`` (``dist.make_mesh`` / ``make_multislice_mesh``, in an
    initialised process group) distributes the transform: each rank calls
    the plan on its block (``Plan.input_layout``); the plan runs on the
    mesh's device type. ``batch_sharded=True`` (with ``batch_dims >= 1``)
    splits the first batch dim over every rank instead. A (1, 1, N) plan
    on P > 1 ranks is the distributed long-1-D engine where it builds
    (``route == "long1d"``, natural-order chunks in and out; module doc),
    else the pencil engine, with a warning.

    ``real=True`` plans r2c forward and c2r inverse; ``dtype`` may name
    the real type ("float32" maps to complex64). ``packed=True`` (with
    ``planar=True``) selects the packed (..., Nz/2) layout, whose plane 0
    carries X[0] + i X[Nz/2]; convert with ``fused_fft.unpack_rfft3d`` /
    ``pack_rfft3d``. A c2r plan in the numpy layout is exact on the
    half-spectra of real signals. Off them, where the z = 0 or Nz/2 plane
    inverted along x and y (G_0, G_M) is not real, it returns, as the
    reference's plans do, irfft along z of G_0' = Re G_0 - Im G_M and
    G_M' = Re G_M - Im G_0 (+ Im G_0 on the fused ``rfft3d`` route), where
    ``torch.fft.irfftn`` drops Im G_0 and Im G_M: the port is held to the
    reference's plans, and the namespace (``fft.irfftn``) projects onto
    the half-spectra as numpy does. A long last axis
    (``plan((1, 1, N))`` past the 2-stage ceiling) takes the four-step
    route; ``params.split_1d`` pins its (n1, n2). Any other length (a
    prime factor past 128: Bluestein), ``dtype="complex128"``
    (``real=True`` with "float64": the fp64 route, 1e-12) and
    ``params.use_pallas=0`` take the unfused engine
    (``kernels/stockham.py``) on that axis.

    ``donate=True`` gives the plan the caller's input tensors to use as
    its scratch or output, as JAX's ``donate_argnums`` does: the caller
    must not read them after the call. The planar c2c kernel route, which
    has an in-place form, then runs it (as ``in_place=True``, and returns
    the inputs); every other plan accepts ``donate`` and changes nothing.
    ``in_place=True`` demands that form and raises where a plan has none.
    A plan that writes its inputs marks them modified for autograd, which
    refuses a leaf that requires grad."""
    return _build(shape, dtype, mesh=mesh, real=real, inverse=inverse,
                  batch_dims=batch_dims, params=params, use_cache=use_cache,
                  planar=planar, norm=norm, batch_sharded=batch_sharded,
                  packed=packed, donate=donate, in_place=in_place,
                  device=device)


def _build(shape, dtype="complex64", *, mesh=None, real=False,
           inverse=False, batch_dims=0, params=None, use_cache=True,
           planar=False, norm=None, batch_sharded=False, packed=False,
           donate=False, in_place=False, device=None,
           z_adjoint: bool = False, long1d_split=None) -> Plan:
    """:func:`plan`; ``z_adjoint=True`` builds the adjoint of a mesh real
    plan of the other direction (``plan/autodiff.py``), whose z stage is
    that plan's transpose (``real_stage_fns``). ``long1d_split`` pins the
    long-1-D engine's split and builds it on a mesh of one rank too (its
    exchanges and hops then groups of one: the engine's dataflow on one
    card, for ``chip_smoke.py``); the plan's adjoints keep it."""
    if len(shape) != 3:
        raise ValueError(f"shape must be (Nx, Ny, Nz), got {shape}")
    if batch_sharded and (mesh is None or batch_dims < 1):
        raise ValueError("batch_sharded needs a mesh and batch_dims >= 1")
    if packed and (not real or not planar or batch_sharded):
        raise ValueError("packed layout requires real=True, planar=True "
                         "(and not batch_sharded)")
    shape = tuple(int(n) for n in shape)
    name = _dtype_name(dtype)
    if real and name in ("float16", "bfloat16", "float32", "float64"):
        # real transforms name the real type; only float64 maps to the
        # fp64 pipeline, as in the reference (plan/api.py:550-556)
        name = "complex128" if name == "float64" else "complex64"
    if name not in ("complex64", "complex128"):
        raise ValueError(f"plans take complex64 or complex128 (real plans "
                         f"float32 or float64), got {name}")
    given_mesh = mesh
    if mesh is not None:
        device = _mesh_device(mesh, device)
        p1, p2 = meshlib.mesh_shape(mesh)
    else:
        device = torch.device("cuda" if device is None else device)
        p1 = p2 = 1
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass "
                               "device='cpu' for a plan that runs the "
                               "kernels' plain versions on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    spec = ProblemSpec(shape=shape, dtype=name, real=real, inverse=inverse,
                       p=p1 * p2, batch_sharded=batch_sharded)
    if params is None and use_cache:
        params = cache.lookup(cache.plan_key(
            shape, name, real, p1, p2, cache.device_kind(device),
            inverse=inverse, batch_sharded=batch_sharded))
    if params is None:
        params = default_params(spec, p1=None if mesh is None else p1)
    reason = infeasible_reason(spec, params)
    if reason is not None:
        raise ValueError(f"infeasible plan: {reason}")
    if mesh is not None and params.rankorder:
        # re-grid the ranks per the rankorder knob (reference
        # ROTATE_RANKORDER); the plan keeps the re-gridded mesh
        mesh = meshlib.with_rankorder(mesh, params.rankorder)
    scale = _norm_scale(norm, inverse, shape[0] * shape[1] * shape[2])
    if packed:
        params = params.replace(use_pallas=1)
    engine = None
    if mesh is None or batch_sharded:
        # batch_sharded: each rank runs the reference's _local_fft3d, whose
        # fused branch is c2c only
        route = _route(spec, params, planar and not batch_sharded)
    elif shape[:2] == (1, 1):
        engine, why = long1d.engine(mesh, shape[2], real, packed, inverse,
                                    params, name, scale, long1d_split)
        route = "pencil" if engine is None else "long1d"
        if engine is None and p1 * p2 > 1:
            warnings.warn(f"a (1, 1, {shape[2]}) plan on {p1 * p2} ranks "
                          f"takes the pencil engine, which runs it on one "
                          f"rank: {why}", UserWarning, stacklevel=3)
    else:
        route = "pencil"
    if packed:
        if route == "pencil":
            if shape[2] % 2 or _pick_2stage(shape[2] // 2,
                                            params.radix_z) is None:
                raise ValueError("packed layout needs Nz even with Nz/2 "
                                 f"2-stage expressible (got Nz={shape[2]})")
        elif route not in ("rfft3d", "long1d"):
            raise ValueError("packed layout needs the r2c kernel path "
                             f"(shape {shape} not eligible)")
    if in_place:
        if mesh is not None or real or not planar or route != "fft3d":
            raise ValueError("in_place requires the single-device planar "
                             "c2c kernel path")
        if shape[0] > 1 and not fused_fft.can_fuse_slab(
                shape[1], shape[2], params.radix_y, params.radix_z):
            raise ValueError("in_place needs a fusable (y,z) slab: "
                             f"ny*nz = {shape[1] * shape[2]} exceeds the "
                             "slab ceiling or an axis is not expressible")
    if z_adjoint and not (real and route == "pencil"):
        raise ValueError("z_adjoint is the adjoint of a mesh real plan")
    runs_in_place = in_place or (
        donate and mesh is None and planar and route == "fft3d"
        and (shape[0] == 1 or fused_fft.can_fuse_slab(
            shape[1], shape[2], params.radix_y, params.radix_z)))
    args = dict(shape=shape, dtype=name, mesh=given_mesh, real=real,
                inverse=inverse, batch_dims=batch_dims, params=params,
                use_cache=False, planar=planar, norm=norm,
                batch_sharded=batch_sharded, packed=packed, donate=donate,
                in_place=in_place, device=device)
    if long1d_split is not None:
        args["long1d_split"] = long1d_split
    return Plan(spec, params, batch_dims + 3, planar, scale, runs_in_place,
                device, packed=packed, route=route, args=args, mesh=mesh,
                z_adjoint=z_adjoint, engine=engine)


def _global_shape(x, mesh, inverse: bool, shape) -> tuple:
    """The global spatial shape of a one-shot call: ``shape``, else the
    block's trailing dims (times the mesh's row and col counts where the
    layout splits them, which assumes equal blocks)."""
    if shape is not None or mesh is None:
        return tuple(shape if shape is not None else x.shape[-3:])
    p1, p2 = meshlib.mesh_shape(mesh)
    nx, ny, nz = x.shape[-3:]
    return (nx, ny * p1, nz * p2) if inverse else (nx * p1, ny * p2, nz)


class _Same:
    """A cache-key part that matches only the object itself (a mesh). The
    key holds the object, so its id is not reused while the entry lives."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _Same) and other.obj is self.obj


def _frozen(v):
    """A hashable form of a keyword value or a PlanParams."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return (type(v).__name__, _frozen(dataclasses.asdict(v)))
    if isinstance(v, dict):
        return tuple(sorted((k, _frozen(a)) for k, a in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_frozen(a) for a in v)
    return v


# the one-shot calls' plans, least recently used first
_ONE_SHOT: collections.OrderedDict = collections.OrderedDict()
_ONE_SHOT_MAX = 64


def _one_shot_key(shape, dtype, inverse: bool, batch_dims: int, device,
                  mesh, params, kw) -> tuple:
    """The call signature a one-shot plan is cached under: the global
    shape, dtype, direction, batch dims, device, the mesh itself, and the
    params and keywords by value."""
    return (tuple(shape), dtype, bool(inverse), batch_dims,
            torch.device(device), None if mesh is None else _Same(mesh),
            _frozen(params), _frozen(kw))


def _cached_plan(shape, dtype, inverse: bool, batch_dims: int, device,
                 mesh, params, kw, z_adjoint: bool = False) -> Plan:
    """The plan of a call signature (:func:`_one_shot_key`), built on its
    first request and kept, the least recently used dropped past
    ``_ONE_SHOT_MAX``."""
    key = _one_shot_key(shape, dtype, inverse, batch_dims, device, mesh,
                        params, {**kw, "z_adjoint": z_adjoint})
    p = _ONE_SHOT.get(key)
    if p is None:
        p = _build(shape, dtype, mesh=mesh, params=params, inverse=inverse,
                   batch_dims=batch_dims, device=device, z_adjoint=z_adjoint,
                   **kw)
        _ONE_SHOT[key] = p
        if len(_ONE_SHOT) > _ONE_SHOT_MAX:
            _ONE_SHOT.popitem(last=False)
    else:
        _ONE_SHOT.move_to_end(key)
    return p


def _one_shot(x, mesh, params, shape, inverse: bool, kw) -> Plan:
    """The plan of a one-shot call, built once per call signature (the
    reference's one-shot calls are cached the same way, by jit)."""
    shape = _global_shape(x, mesh, inverse, shape)
    return _cached_plan(shape, x.dtype, inverse, x.ndim - 3, x.device, mesh,
                        params, kw)


def fft3d(x, mesh=None, params=None, shape=None, **kw):
    """3-D c2c over the last three axes of a complex64 (or complex128)
    tensor. On a mesh ``x`` is this rank's z-pencil block and ``shape``
    the global (Nx, Ny, Nz) (default: equal blocks); the result is this
    rank's transposed-out block. The plan is built on the first call of
    each signature and cached."""
    return _one_shot(x, mesh, params, shape, False, kw)(x)


def ifft3d(x, mesh=None, params=None, shape=None, **kw):
    """Inverse 3-D c2c over the last three axes of a complex64 (or
    complex128) tensor. On a mesh ``x`` is this rank's transposed-out
    block and ``shape`` the global (Nx, Ny, Nz) (default: equal blocks);
    the result is this rank's z-pencil block. The plan is cached as
    :func:`fft3d`'s."""
    return _one_shot(x, mesh, params, shape, True, kw)(x)


def rfft3d(x, mesh=None, params=None, shape=None, **kw):
    """3-D r2c over the last three axes of a float32 (or float64) tensor:
    the (..., Nx, Ny, Nz // 2 + 1) half-spectrum, complex (a planar pair
    with ``planar=True``). Blocks on a mesh as :func:`fft3d`'s."""
    return _one_shot(x, mesh, params, shape, False, {**kw, "real": True})(x)


def irfft3d(x, nz: Optional[int] = None, mesh=None, params=None,
            shape=None, **kw):
    """3-D c2r over the last three axes of a complex half-spectrum: real
    (..., Nx, Ny, nz), nz by default 2 * (L - 1) for L bins, as the
    reference has it. On a mesh ``x`` is this rank's transposed-out block
    and the global length needs ``nz`` (or ``shape``)."""
    if shape is None:
        shape = _c2r_shape(x, mesh, nz)
    return _one_shot(x, mesh, params, shape, True, {**kw, "real": True})(x)


def _c2r_shape(x, mesh, n) -> tuple:
    """The global (Nx, Ny, n) of a c2r one-shot on the 3-D half-spectrum
    ``x``: ``n`` by default 2 * (L - 1) for L bins, as the reference has
    it; a mesh block does not give L, so there ``n`` is needed."""
    if n is None:
        if mesh is not None:
            raise ValueError("a c2r one-shot on a mesh needs the global "
                             "output length (n, nz or shape)")
        n = 2 * (x.shape[-1] - 1)
    return _global_shape(x, mesh, True, None)[:2] + (n,)


# ---- 2-D transforms: a (1, Y, N) plan, the x axis of length one. On a
# make_mesh(1, p) mesh the pencil engine's row group has one rank, so the
# one exchange is z <-> y over col, and the result comes back z-split
# (the transposed-out layout): the reference's METHOD-ONE analogue
# (offt_tpu/plan/api.py:666-690)

def _lift(x):
    """(..., Y, N) as (..., 1, Y, N)."""
    return x.reshape(x.shape[:-2] + (1,) + x.shape[-2:])


def _drop(y, lead: tuple):
    """(..., 1, Y, N) results (a tensor or a planar pair) as (..., Y, N)."""
    if isinstance(y, tuple):
        return tuple(_drop(t, lead) for t in y)
    return y.reshape(lead + y.shape[-2:])


def _shape3(shape) -> Optional[tuple]:
    return None if shape is None else (1,) + tuple(shape)


def fft2d(x, params=None, mesh=None, shape=None, **kw):
    """2-D c2c over the last two axes; leading axes are batch. Single
    device: the 2-D route of the slab and row kernels. On a
    ``make_mesh(1, p)`` mesh ``x`` is this rank's block of the y-split
    rows and ``shape`` the global (Y, N) (default: equal blocks); the
    result is this rank's block of the z-split (transposed-out) layout."""
    x3 = _lift(x)
    p = _one_shot(x3, mesh, params, _shape3(shape), False, kw)
    return _drop(p(x3), x.shape[:-2])


def ifft2d(x, params=None, mesh=None, shape=None, **kw):
    """Inverse 2-D c2c over the last two axes; on a mesh the mirror of
    :func:`fft2d`: a z-split block in, a y-split block out."""
    x3 = _lift(x)
    p = _one_shot(x3, mesh, params, _shape3(shape), True, kw)
    return _drop(p(x3), x.shape[:-2])


def rfft2d(x, params=None, mesh=None, shape=None, **kw):
    """2-D r2c over the last two axes: real (..., Y, N) to the complex
    (..., Y, N // 2 + 1) numpy rfft2 layout (a planar pair with
    ``planar=True``; ``packed=True`` the (..., Y, N // 2) packed one).
    Distributed as :func:`fft2d`."""
    x3 = _lift(x)
    p = _one_shot(x3, mesh, params, _shape3(shape), False,
                  {**kw, "real": True})
    return _drop(p(x3), x.shape[:-2])


def irfft2d(x, n: Optional[int] = None, params=None, mesh=None, shape=None,
            **kw):
    """2-D c2r over the last two axes, the inverse of :func:`rfft2d`:
    real (..., Y, n), n by default 2 * (L - 1) for L bins. On a mesh the
    global length needs ``n`` (or ``shape``)."""
    x3 = _lift(x)
    shape3 = _c2r_shape(x3, mesh, n) if shape is None else _shape3(shape)
    p = _one_shot(x3, mesh, params, shape3, True, {**kw, "real": True})
    return _drop(p(x3), x.shape[:-2])
