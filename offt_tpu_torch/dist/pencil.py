"""The distributed 3-D FFT over a (p1, p2) mesh: the pencil dataflow.

Counterpart of ``offt_tpu/dist/pencil.py``. Every rank runs
:func:`pencil_pipeline` on its own block, in planar float32 pairs:

    z-pencils (x/p1, y/p2, z)   --fft_z-->
      --[phase 1: exchange over COL, z<->y]-->
    y-pencils (x/p1, y, z/p2)   --fft_y-->
      --[phase 2: exchange over ROW, y<->x]-->
    x-pencils (x, y/p1, z/p2)   --fft_x-->   transposed-out layout

and the inverse runs the mirror. Where the reference's ``shard_map``
names a mesh axis, a rank here exchanges with the process group of that
mesh dim (``DeviceMesh.get_group``), and the knobs keep their meaning:

- each phase is cut into t1 / t2 chunks whose exchanges are started
  asynchronously (``async_op=True``); with w1 / w2 > 0, chunk i waits on
  the exchange of chunk i - w before its compute starts (on NCCL the
  wait orders the current stream after the collective; on gloo it blocks
  the host), w = 0 leaves them unbounded;
- s = 0 exchanges with one ``all_to_all_single``, s = 1 with a ring of
  size - 1 single-hop ``batch_isend_irecv`` steps; the v bit of a phase
  takes ``all_gather`` and a local slice instead;
- ry tenths of the middle-axis transform run in phase 1, the rest in
  phase 2;
- a group of size 1 returns its input untouched.

re and im travel together: each exchange stacks them into one buffer.
Uneven shapes run on padded equal blocks, as the reference's padded
static shards do: ``pad_first``, ``mid_true``, ``mid_pad`` and
``last_true`` are its pad and slice points. A meta-device run (a plan's
shape-only pass) computes the shapes of every exchange and moves nothing.
:func:`make_phase_trials` gives the tuner's FAST_TUNING trial programs:
each phase alone, on its first chunks.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels import fourstep, stockham
from ..kernels import fused_fft as ff
from ..plan.params import TRANSPOSE_PPERMUTE, PlanParams
from .mesh import COL, ROW, coords, mesh_shape


def axis_fft(xr, xi, axis: int, inverse: bool, radices, params,
             out_scale: float = 1.0, tables=None):
    """One planar 1-D c2c along ``axis`` (numpy fft/ifft semantics), with
    the reference's dispatch (``offt_tpu/dist/pencil.py:47-70``): for a
    float32 pair on a plan with its kernels on (``params.use_pallas``),
    the 2-stage kernels (``fft_1d_planar``) when the axis is expressible,
    the four-step route for the last axis with no radices; everything
    else (``use_pallas=0``, a float64 pair, a length no kernel route
    expresses) takes the unfused engine, ``stockham.fft_1d`` on the
    pair's complex view. ``out_scale`` rides the kernels' tables, and
    multiplies the unfused engine's result."""
    axis = axis % xr.ndim
    n = xr.shape[axis]
    if params.use_pallas and xr.dtype == torch.float32:
        if ff.can_use_pallas(n, radices):
            return ff.fft_1d_planar(xr, xi, axis, inverse=inverse,
                                    radices=radices,
                                    precision=params.precision,
                                    block=params.block_batch,
                                    out_scale=out_scale,
                                    x_tile=params.x_tile, tables=tables)
        if (axis == xr.ndim - 1 and radices is None
                and fourstep.can_use_four_step(n, params.split_1d)):
            return fourstep.fft_four_step_planar(
                xr, xi, inverse=inverse, split=params.split_1d,
                precision=params.precision, out_scale=out_scale,
                block=params.block_batch, tables=tables)
    y = stockham.fft_1d(torch.complex(xr, xi), axis, inverse, radices,
                        params.precision, bool(params.use_pallas), tables)
    if out_scale != 1.0:
        y = y * out_scale
    return y.real.contiguous(), y.imag.contiguous()


# --------------------------------------------------------------------------
# the exchanges
# --------------------------------------------------------------------------

_GROUPS: dict = {}


def _names(name) -> tuple:
    return (name,) if isinstance(name, str) else tuple(name)


_SIZES: dict = {}


def _size(mesh, name) -> int:
    """The ranks along the mesh dim ``name``, or along the flattened dims
    of a tuple of names. Kept per mesh: a ``DeviceMesh`` builds its rank
    tensor anew on every read of ``.mesh`` (tens of microseconds of host
    time), and every exchange asks."""
    key = (id(mesh), name)
    hit = _SIZES.get(key)
    if hit is None or hit[0] is not mesh:
        dims = mesh.mesh_dim_names
        hit = _SIZES[key] = (mesh, math.prod(
            mesh.mesh.shape[dims.index(n)] for n in _names(name)))
    return hit[1]


def _flat_group(ranks: list):
    """The process group of ``ranks``: the default group when they are
    all of it, else a new group made by these ranks alone (no other rank
    takes part in making it)."""
    if sorted(ranks) == list(range(dist.get_world_size())):
        return dist.group.WORLD
    return dist.new_group(sorted(ranks), use_local_synchronization=True)


def _group(mesh, name) -> tuple:
    """(group, me, ranks, order) of this rank along the mesh dim ``name``,
    or along the flattened dims of a tuple of names (their linear order,
    the first slowest: the long-1-D engine's exchanges run over (ROW,
    COL)): the process group, this rank's index along it, the global rank
    at each index, and the index of each group rank (a group orders its
    members by global rank, which a rank grid need not)."""
    key = (id(mesh), name)
    if key not in _GROUPS or _GROUPS[key][0] is not mesh:
        names = _names(name)
        dims = mesh.mesh_dim_names
        pos = coords(mesh)
        sel = tuple(slice(None) if n in names else pos[n] for n in dims)
        # the selected dims in the order of ``names``, flattened
        sub = mesh.mesh[sel].permute(
            [[n for n in dims if n in names].index(n) for n in names])
        ranks = sub.flatten().tolist()
        me = ranks.index(dist.get_rank())
        grp = (mesh.get_group(names[0]) if len(names) == 1
               else _flat_group(ranks))
        order = [ranks.index(r) for r in dist.get_process_group_ranks(grp)]
        _GROUPS[key] = (mesh, (grp, me, ranks, order))
    return _GROUPS[key][1]


class _Pending:
    """An exchange in flight: ``wait()`` waits on its work handles once
    and returns the exchanged planar pair. ``keep`` holds the send
    buffers until then."""

    def __init__(self, works=(), finish=None, result=None, keep=()):
        self._works = list(works)
        self._finish = finish
        self._result = result
        self._keep = keep

    def wait(self):
        if self._result is None:
            for w in self._works:
                w.wait()
            self._result = self._finish()
            self._works = self._finish = self._keep = None
        return self._result


def _stack_piece(xs, axis: int, i: int, chunk: int):
    """Piece ``i`` of the pair along ``axis``, re and im stacked into one
    contiguous (2, ...) buffer."""
    return torch.stack([x.narrow(axis, i * chunk, chunk) for x in xs])


def _join(pieces, axis: int) -> tuple:
    """Stacked (2, ...) pieces, concatenated along the data ``axis``, as a
    planar pair of contiguous tensors."""
    y = torch.cat(pieces, dim=axis + 1)
    return y[0], y[1]


def _transpose(xs, mesh, name, split_axis: int, concat_axis: int,
               strategy: int, variant: int = 0) -> _Pending:
    """One pencil exchange of the planar pair ``xs`` over the mesh dim
    ``name`` (or the flattened dims of a tuple of names): the pieces along
    ``split_axis`` go one to each member, in the order of their index
    along the dim, and the received pieces are concatenated along
    ``concat_axis`` in that order. ``strategy`` picks
    ``all_to_all_single`` (0) or the ring (1); ``variant`` takes
    ``all_gather`` and a local slice instead of either. Started
    asynchronously; the result comes from ``wait()``."""
    size = _size(mesh, name)
    if size == 1:
        return _Pending(result=tuple(xs))
    xr = xs[0]
    if xr.shape[split_axis] % size:
        raise ValueError(f"axis {split_axis} of {tuple(xr.shape)} does not "
                         f"split over {size} ranks")
    chunk = xr.shape[split_axis] // size
    if xr.device.type == "meta":
        shp = list(xr.shape)
        shp[split_axis] = chunk
        shp[concat_axis] *= size
        return _Pending(result=tuple(torch.empty(shp, device="meta")
                                     for _ in xs))
    grp, me, ranks, order = _group(mesh, name)
    if variant:
        buf = torch.stack(list(xs))
        outs = [torch.empty_like(buf) for _ in range(size)]
        work = dist.all_gather(outs, buf, group=grp, async_op=True)

        def finish():
            pieces = [None] * size
            for g, o in enumerate(outs):
                pieces[order[g]] = o.narrow(split_axis + 1, me * chunk, chunk)
            return _join(pieces, concat_axis)
        return _Pending([work], finish, keep=buf)
    if strategy == TRANSPOSE_PPERMUTE:
        # step s sends to the member s ahead and receives from the one s
        # behind: size - 1 single-hop exchanges
        pieces = [None] * size
        pieces[me] = _stack_piece(xs, split_axis, me, chunk)
        works, sends = [], []
        for s in range(1, size):
            dst, src = (me + s) % size, (me - s) % size
            sends.append(_stack_piece(xs, split_axis, dst, chunk))
            pieces[src] = torch.empty_like(sends[-1])
            works += dist.batch_isend_irecv([
                dist.P2POp(dist.isend, sends[-1], ranks[dst], grp),
                dist.P2POp(dist.irecv, pieces[src], ranks[src], grp)])
        return _Pending(works, lambda: _join(pieces, concat_axis),
                        keep=sends)
    send = torch.stack([_stack_piece(xs, split_axis, order[g], chunk)
                        for g in range(size)])
    recv = torch.empty_like(send)
    work = dist.all_to_all_single(recv, send, group=grp, async_op=True)

    def finish():
        pieces = [None] * size
        for g in range(size):
            pieces[order[g]] = recv[g]
        return _join(pieces, concat_axis)
    return _Pending([work], finish, keep=send)


# --------------------------------------------------------------------------
# the pipeline
# --------------------------------------------------------------------------

def _chunk_bounds(n: int, t: int) -> list[tuple[int, int]]:
    """Split range(n) into t near-equal contiguous chunks."""
    t = max(1, min(t, n))
    base, rem = divmod(n, t)
    bounds = []
    start = 0
    for i in range(t):
        size = base + (1 if i < rem else 0)
        bounds.append((start, start + size))
        start += size
    return bounds


def _narrow(xs, axis: int, lo: int, hi: int) -> tuple:
    """The [lo, hi) part of each tensor along ``axis``, contiguous (a
    copy unless it is the whole)."""
    return tuple(x.narrow(axis, lo, hi - lo).contiguous() for x in xs)


def _cat(parts, axis: int) -> tuple:
    if len(parts) == 1:
        return parts[0]
    return tuple(torch.cat(ts, dim=axis) for ts in zip(*parts))


def _pad_to(xs, axis: int, target: int) -> tuple:
    """Zero-pad ``axis`` to ``target`` (no-op when 0 or already there)."""
    cur = xs[0].shape[axis]
    if not target or cur >= target:
        return tuple(xs)
    pad = [0, 0] * (xs[0].ndim - 1 - axis) + [0, target - cur]
    return tuple(F.pad(x, pad) for x in xs)


def _slice_to(xs, axis: int, target: int) -> tuple:
    if not target or xs[0].shape[axis] <= target:
        return tuple(xs)
    return _narrow(xs, axis, 0, target)


def _tied(w: int, i: int, t_active: int) -> bool:
    """The w knob (the reference's W1/W2 plus one): whether chunk i's
    compute waits on the exchange of chunk i - w, so that at most w chunk
    exchanges are in flight; w = 0 sets no bound."""
    return 0 < w <= i and w < t_active


def pencil_pipeline(xs, *, mesh, a_first: int, a_mid: int, a_last: int,
                    name1: str, name2: str, params: PlanParams,
                    inverse: bool, tables=None, rad_first=None,
                    rad_mid=None, rad_last=None,
                    first_fn: Optional[Callable] = None,
                    last_fn: Optional[Callable] = None, pad_first: int = 0,
                    mid_true: int = 0, mid_pad: int = 0,
                    last_true: int = 0) -> tuple:
    """The two-phase chunked pipeline on one rank's padded block ``xs`` (a
    tuple: the planar pair, or one real tensor for an r2c). Returns a
    tuple: the planar pair, or one real tensor after a c2r.

    Forward c2c: a_first = z, a_mid = y, a_last = x, name1 = COL,
    name2 = ROW; inverse: a_first = x, a_mid = y, a_last = z, name1 = ROW,
    name2 = COL. ``first_fn(xs, tables)`` / ``last_fn(xs, tables)``
    override the local transform on the first / last axis (the r2c and
    c2r stages and the scaled z pass). Pad and slice points:
    - pad_first: pad a_first to this length after the first transform;
    - mid_true: slice a_mid to this after the phase-1 exchange;
    - mid_pad: pad a_mid to this before the phase-2 exchange;
    - last_true: slice a_last to this before the last transform."""
    do_first = first_fn or (lambda c, tabs: axis_fft(
        *c, a_first, inverse, rad_first, params, tables=tabs))
    do_last = last_fn or (lambda c, tabs: axis_fft(
        *c, a_last, inverse, rad_last, params, tables=tabs))

    def do_mid(c, tabs):
        return axis_fft(*c, a_mid, inverse, rad_mid, params, tables=tabs)

    mid, rx, n_rows = _phase1(
        xs, mesh=mesh, do_first=do_first, do_mid=do_mid, a_first=a_first,
        a_mid=a_mid, a_last=a_last, name1=name1, params=params,
        tables=tables, pad_first=pad_first, mid_true=mid_true)
    return _phase2(
        mid, mesh=mesh, do_mid=do_mid, do_last=do_last, a_first=a_first,
        a_mid=a_mid, a_last=a_last, name2=name2, params=params,
        tables=tables, mid_pad=mid_pad, last_true=last_true, rx=rx,
        n_rows=n_rows)


def _phase1(xs, *, mesh, do_first, do_mid, a_first, a_mid, a_last, name1,
            params, tables, pad_first, mid_true, max_chunks: int = 0):
    """Chunk along a_last; transform a_first and exchange a_first <->
    a_mid per chunk; then the ry head of the a_mid transform.
    ``max_chunks`` > 0 runs the first that many chunks alone (a
    FAST_TUNING trial): the output holds only their rows."""
    bounds = _chunk_bounds(xs[0].shape[a_last], params.t1)
    if max_chunks:
        bounds = bounds[:max_chunks]
    pending = []
    for i, (lo, hi) in enumerate(bounds):
        if _tied(params.w1, i, len(bounds)):
            pending[i - params.w1].wait()
        c = do_first(_narrow(xs, a_last, lo, hi), tables)
        c = _pad_to(c, a_first, pad_first)
        pending.append(_transpose(c, mesh, name1, a_first, a_mid,
                                  params.s1, params.v & 1))
    mid = _cat([p.wait() for p in pending], a_last)
    mid = _slice_to(mid, a_mid, mid_true)
    # the middle-axis transform split between the phases (reference Ry):
    # the first ry/10 of the a_last rows take it here
    n_rows = mid[0].shape[a_last]
    rx = (n_rows * params.ry + 9) // 10 if params.ry < 10 else n_rows
    if rx > 0:
        head = do_mid(_narrow(mid, a_last, 0, rx), tables)
        mid = head if rx == n_rows else _cat(
            [head, _narrow(mid, a_last, rx, n_rows)], a_last)
    return mid, rx, n_rows


def _phase2(mid, *, mesh, do_mid, do_last, a_first, a_mid, a_last, name2,
            params, tables, mid_pad, last_true, rx, n_rows,
            max_chunks: int = 0):
    """Chunk along a_first; finish the a_mid transform of the pending
    rows, exchange a_mid <-> a_last, transform a_last. A chunk's last
    transform runs when its exchange is waited on: by the window before a
    later chunk's compute, else after every exchange is started.
    ``max_chunks`` truncates as in :func:`_phase1`."""
    bounds = _chunk_bounds(mid[0].shape[a_first], params.t2)
    if max_chunks:
        bounds = bounds[:max_chunks]
    pending, out = [], [None] * len(bounds)

    def complete(j):
        if out[j] is None:
            c = _slice_to(pending[j].wait(), a_last, last_true)
            out[j] = do_last(c, tables)

    for i, (lo, hi) in enumerate(bounds):
        if _tied(params.w2, i, len(bounds)):
            complete(i - params.w2)
        c = _narrow(mid, a_first, lo, hi)
        if rx < n_rows:
            pend = do_mid(_narrow(c, a_last, rx, n_rows), tables)
            c = _cat([_narrow(c, a_last, 0, rx), pend], a_last)
        c = _pad_to(c, a_mid, mid_pad)
        pending.append(_transpose(c, mesh, name2, a_mid, a_last, params.s2,
                                  (params.v >> 1) & 1))
    for j in range(len(bounds)):
        complete(j)
    return _cat(out, a_first)


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def make_pencil_fft3d(mesh, params: PlanParams, shape: tuple,
                      inverse: bool = False, rad_z=None, rad_y=None,
                      rad_x=None, first_fn: Optional[Callable] = None,
                      last_fn: Optional[Callable] = None,
                      z_freq_len: int = 0, out_scale: float = 1.0):
    """The distributed transform of one rank's padded block:
    ``fn(xs, tables) -> tuple`` over the last three axes.

    ``shape`` is the true global (Nx, Ny, Nz); the caller pads its block
    to the equal block of the padded global shape and slices the result
    (plan/api.py). ``z_freq_len`` is the z length after ``first_fn``
    (r2c: the half-spectrum's). Forward maps z-pencils to the
    transposed-out layout, inverse the reverse. ``out_scale`` rides the
    z pass, the first stage forward and the last inverse, unless a
    ``first_fn`` / ``last_fn`` takes that stage (and its scale)."""
    p1, p2 = mesh_shape(mesh)
    nx, ny, nz = shape
    nzt = z_freq_len or nz

    def fn(xs, tables=None):
        ax, ay, az = xs[0].ndim - 3, xs[0].ndim - 2, xs[0].ndim - 1
        if not inverse:
            first = first_fn or (lambda c, tabs: axis_fft(
                *c, az, False, rad_z, params, out_scale, tabs))
            return pencil_pipeline(
                xs, mesh=mesh, a_first=az, a_mid=ay, a_last=ax,
                name1=COL, name2=ROW, params=params, inverse=False,
                tables=tables, rad_mid=rad_y, rad_last=rad_x,
                first_fn=first, last_fn=last_fn,
                pad_first=_ceil_to(nzt, p2), mid_true=ny,
                mid_pad=_ceil_to(ny, p1), last_true=nx)
        last = last_fn or (lambda c, tabs: axis_fft(
            *c, az, True, rad_z, params, out_scale, tabs))
        return pencil_pipeline(
            xs, mesh=mesh, a_first=ax, a_mid=ay, a_last=az,
            name1=ROW, name2=COL, params=params, inverse=True,
            tables=tables, rad_first=rad_x, rad_mid=rad_y,
            first_fn=first_fn, last_fn=last,
            pad_first=_ceil_to(nx, p1), mid_true=ny,
            mid_pad=_ceil_to(ny, p2),
            # the c2r stage slices the padded frequency axis itself
            last_true=0 if last_fn is not None else nz)

    return fn


def make_phase_trials(mesh, ndim: int, params: PlanParams, shape: tuple,
                      inverse: bool = False, rad_z=None, rad_y=None,
                      rad_x=None, k: int = 2,
                      first_fn: Optional[Callable] = None,
                      last_fn: Optional[Callable] = None,
                      z_freq_len: int = 0) -> tuple:
    """FAST_TUNING trial programs (the reference's ``make_phase_trials``,
    offt-compute.c:3538-3548; run-fft.c:219, its -A option): for this rank,
    two callables ``fn(xs, tables) -> tuple`` that run only the first
    min(k, t) chunks of pipeline phase 1 and of phase 2, with their
    extrapolation weights t / k. The tuner times both and estimates the
    whole transform as w1 * t_trial1 + w2 * t_trial2: a trial costs about
    k / t of the transform and keeps its cost per chunk, since each chunk
    runs the same kernels and exchanges on the same block shapes as in
    the plan. The outputs mean nothing; only the time does.

    ``first_fn`` / ``last_fn`` / ``z_freq_len`` are
    :func:`make_pencil_fft3d`'s real z stages: a real forward trial 1
    takes the real z-pencil block and runs the r2c per chunk; a c2r trial
    takes the half-spectrum.

    Returns ((fn1, block1, w1), (fn2, block2, w2)), ``block`` the shape of
    this rank's (padded, equal) input block of each trial, where the
    reference returns a global shape and its PartitionSpec."""
    p1, p2 = mesh_shape(mesh)
    nx, ny, nz = shape
    nzt = z_freq_len or nz
    ax, ay, az = ndim - 3, ndim - 2, ndim - 1
    if not inverse:
        a_first, a_mid, a_last = az, ay, ax
        name1, name2 = COL, ROW
        pad_first, mid_true = _ceil_to(nzt, p2), ny
        mid_pad, last_true = _ceil_to(ny, p1), nx
        rad_first, rad_mid, rad_last = rad_z, rad_y, rad_x
        block1 = (-(-nx // p1), -(-ny // p2), nz)
        block2 = (-(-nx // p1), ny, pad_first // p2)
    else:
        a_first, a_mid, a_last = ax, ay, az
        name1, name2 = ROW, COL
        pad_first, mid_true = _ceil_to(nx, p1), ny
        mid_pad = _ceil_to(ny, p2)
        # the c2r stage slices the padded frequency axis itself
        last_true = 0 if last_fn is not None else nz
        rad_first, rad_mid, rad_last = rad_x, rad_y, rad_z
        block1 = (nx, -(-ny // p1), -(-nzt // p2))
        block2 = (pad_first // p1, ny, -(-nzt // p2))
    lead = (1,) * (ndim - 3)
    k1 = max(1, min(k, params.t1))
    k2 = max(1, min(k, params.t2))
    do_first = first_fn or (lambda c, tabs: axis_fft(
        *c, a_first, inverse, rad_first, params, tables=tabs))
    do_last = last_fn or (lambda c, tabs: axis_fft(
        *c, a_last, inverse, rad_last, params, tables=tabs))

    def do_mid(c, tabs):
        return axis_fft(*c, a_mid, inverse, rad_mid, params, tables=tabs)

    def fn1(xs, tables=None):
        mid, _, _ = _phase1(
            tuple(xs), mesh=mesh, do_first=do_first, do_mid=do_mid,
            a_first=a_first, a_mid=a_mid, a_last=a_last, name1=name1,
            params=params, tables=tables, pad_first=pad_first,
            mid_true=mid_true, max_chunks=k1)
        return mid

    def fn2(ms, tables=None):
        n_rows = ms[0].shape[a_last]
        rx = (n_rows * params.ry + 9) // 10 if params.ry < 10 else n_rows
        return _phase2(
            tuple(ms), mesh=mesh, do_mid=do_mid, do_last=do_last,
            a_first=a_first, a_mid=a_mid, a_last=a_last, name2=name2,
            params=params, tables=tables, mid_pad=mid_pad,
            last_true=last_true, rx=rx, n_rows=n_rows, max_chunks=k2)

    return ((fn1, lead + block1, params.t1 / k1),
            (fn2, lead + block2, params.t2 / k2))
