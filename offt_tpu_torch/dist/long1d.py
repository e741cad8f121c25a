"""The distributed long-1-D FFT: the four-step factorization over a mesh.

Counterpart of ``offt_tpu/dist/long1d.py``. The length-n vector is an
(n1, n2) matrix split over all P = p1 * p2 ranks of the mesh in the
linear (row, col) order, and every rank runs the four-step pair of
``kernels/fourstep.py`` on its shard between three exchanges over that
flattened group:

    natural rows   (n1/P, n2)            [flat x, contiguous chunks]
      --exchange #1 (split n2, concat n1)-->  (n1, n2/P)
    steps 1+2: FFT_n1 down the columns, times the rank's twiddle chunk
      --exchange #2 (split n1, concat n2)-->  (n1/P, n2)
    steps 3+4: FFT_n2 along the rows, stored transposed: (n2, n1/P)
      --exchange #3 (split n2, concat n1)-->  (n2/P, n1)
    ravel = the natural-order spectrum   [flat X, contiguous chunks]

(with j = j1 n2 + j2 and k = k1 + n1 k2 the (n2, n1) output read row by
row is X in natural order, so a rank's rows are its chunk of X). Each
exchange is ``pencil._transpose`` over (ROW, COL), so the s (all-to-all
or ring) and v (all-gather and slice) knobs keep their meaning: #1 and
#2 read the phase-1 knobs (s1, v bit 0), #3 the phase-2 ones (s2, v bit
1). Each rank builds only its columns of the table T[k1, j2] = W_n^(k1
j2) (``tables.fourstep_twiddle_chunk``): no rank holds the (n1, n2)
table, 128 MiB at 2^24.

Both sides are in natural order (``mesh.natural_layout``): rank i of the
linear order holds the i-th contiguous 1/P of the vector, in and out.

The real transform (:func:`make_dist_rfft1d`) rides the half-length c2c:
z[j] = x[2j] + i x[2j+1] (a local pairing on natural chunks), the same
core at M = n / 2, then the untangle X[k] = E[k] + W_n^k O[k] with
E = (Z[k] + conj Z[M-k]) / 2 and O = -i (Z[k] - conj Z[M-k]) / 2, where
conj Z[M-k] is a global mirror (:func:`_mirror`: a local reverse, one
hop to the mirror rank, a one-slot rotate of the boundary element). The
half-spectrum stays in the packed layout (M bins, bin 0 = DC + i
Nyquist), so it stays natural-chunked. The inverse is the mirror image.

Where no engine applies (:func:`dist1d_split` is None, a numpy-layout
real transform, odd n), ``plan()`` sends a (1, 1, n) plan on to the
pencil engine as the reference does; there all the work lands on one
rank, so on more than one rank ``plan()`` warns (``plan/api.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ..kernels import fourstep
from ..kernels import fused_fft as ff
from ..kernels import tables as tb
from ..plan.params import PlanParams
from .mesh import COL, ROW, SLICE, linear_index, mesh_shape
from .pencil import _group, _transpose, axis_fft

NAMES = (ROW, COL)


def dist1d_split(mesh, n: int, params: PlanParams) -> Optional[tuple]:
    """The (n1, n2) split a distributed 1-D plan would use on ``mesh``,
    or None when there is none: a multi-slice mesh, a single rank, or no
    split with P | n1 and P | n2 (``params.split_1d`` pins the split)."""
    if mesh is None or SLICE in mesh.mesh_dim_names:
        return None
    p1, p2 = mesh_shape(mesh)
    if p1 * p2 <= 1:
        return None
    return fourstep.pick_split(n, params.split_1d, divisor=p1 * p2)


class _Core:
    """The c2c core on one rank: :meth:`run` maps the rank's natural row
    chunk, planar (B, n1/P, n2), to its natural output chunk, planar
    (B, n2/P, n1).

    ``fused``: the four-step pair of kernels (``step12_planar``,
    ``step34_planar``) on every float32 split with the kernels on
    (``params.use_pallas``). Both kernels take every split that
    ``pick_split`` returns: step 1 any lane count n2/P (its lane tile
    masks a partial block), step 3 any row count n1/P (its layout masks
    a partial block of rows), each on the register core where its own
    length (n1, n2) is a power of two in [16, 4096]. The unfused
    alternative runs the same strided-axis column variant and row core,
    plus a twiddle pass and a transpose copy, so it is never the faster
    one. The reference's gate, 128-multiples on n1, n2/P and n1/P, is
    Mosaic's lane and sublane tiling. The unfused branch (the reference's
    too) serves float64 data and ``use_pallas=0``: ``axis_fft`` along
    n1, the twiddle as a torch multiply, ``axis_fft`` along n2, a
    transpose. Both give the same values.

    Scale: the fused kernels are scale-free, so the inverse's 1/m and any
    ``out_scale`` fold into the twiddle chunk; the unfused passes apply
    numpy's 1/n1 and 1/n2 themselves, so there the chunk carries
    ``out_scale`` alone (the reference's convention, ``long1d.py:115-123``).
    """

    def __init__(self, mesh, m: int, split: tuple, params: PlanParams,
                 inverse: bool, wide: bool, out_scale: float, me: int):
        self.mesh, self.params, self.inverse = mesh, params, inverse
        p1, p2 = mesh_shape(mesh)
        self.ptot = p1 * p2
        self.n1, self.n2 = split
        self.fused = bool(params.use_pallas) and not wide
        self.rdt = "float64" if wide else "float32"
        self.rad1 = tb._pick_stages(self.n1)
        self.rad2 = tb._pick_stages(self.n2)
        scale = out_scale / m if self.fused and inverse else out_scale
        w = self.n2 // self.ptot
        self.twiddle = ("fourstep_chunk", self.n1, self.n2, me * w,
                        (me + 1) * w, inverse, scale, self.rdt)

    def _exchange(self, xs, split_axis, concat_axis, phase2=False):
        p = self.params
        if phase2:
            s, v = p.s2, (p.v >> 1) & 1
        else:
            s, v = p.s1, p.v & 1
        return _transpose(xs, self.mesh, NAMES, split_axis, concat_axis, s,
                          v).wait()

    def run(self, xr, xi, tables):
        p, n1, n2 = self.params, self.n1, self.n2
        b, ptot = xr.shape[0], self.ptot
        tw = ff._tables(tables, xr.device).get(*self.twiddle)
        xr, xi = self._exchange((xr, xi), 2, 1)              # (B, n1, n2/P)
        if self.fused:
            zr, zi = fourstep.step12_planar(xr, xi, self.rad1, self.inverse,
                                            p.precision, tw,
                                            block=p.block_batch,
                                            tables=tables)
        else:
            ar, ai = axis_fft(xr, xi, 1, self.inverse, None, p,
                              tables=tables)
            tw = ff._on(tw, ar)
            wr, wi = tw[..., 0], tw[..., 1]
            zr, zi = ar * wr - ai * wi, ar * wi + ai * wr
        zr, zi = self._exchange((zr, zi), 1, 2)              # (B, n1/P, n2)
        if self.fused:
            yr, yi = fourstep.step34_planar(zr, zi, self.rad2, self.inverse,
                                            p.precision, block=p.block_batch,
                                            tables=tables)
        else:
            ar, ai = axis_fft(zr, zi, 2, self.inverse, None, p,
                              tables=tables)
            yr = ar.transpose(1, 2).contiguous()
            yi = ai.transpose(1, 2).contiguous()
        yr, yi = self._exchange((yr, yi), 1, 2, phase2=True)  # (B, n2/P, n1)
        return (yr.reshape(b, n2 // ptot * n1),
                yi.reshape(b, n2 // ptot * n1))


class Long1D:
    """One rank's distributed long-1-D transform of a plan: ``fn(xs,
    tables) -> tuple`` on the rank's natural chunks, planar pairs (B...,
    1, 1, L) (one real tensor for a real forward, which gives the packed
    pair; a real inverse gives one real tensor). Built by
    :func:`make_dist_fft1d` / :func:`make_dist_rfft1d`."""

    def __init__(self, mesh, n: int, real: bool, inverse: bool,
                 core: _Core, me: int):
        self.mesh, self.real, self.inverse = mesh, real, inverse
        self.core, self.me = core, me
        self.split = (core.n1, core.n2)
        self.fused = core.fused
        m = n // 2 if real else n
        self.mloc = m // core.ptot
        self.untangle = ("untangle", n, me * self.mloc,
                         (me + 1) * self.mloc, core.rdt)

    def __call__(self, xs, tables=None):
        lead = xs[0].shape[:-3]
        b = math.prod(lead)
        if not self.real:
            y = self.core.run(*(self._rows(t.reshape(b, -1)) for t in xs),
                              tables)
        elif not self.inverse:
            y = self._r2c(xs[0].reshape(b, self.mloc, 2), tables)
        else:
            y = (self._c2r(*(t.reshape(b, self.mloc) for t in xs), tables),)
        return tuple(t.reshape(lead + (1, 1, -1)) for t in y)

    def _rows(self, t):
        c = self.core
        return t.reshape(t.shape[0], c.n1 // c.ptot, c.n2)

    def _bin0(self, like):
        """True at global bin 0: slot 0 of the first rank's chunk."""
        mask = torch.zeros(like.shape[-1], dtype=torch.bool,
                           device=like.device)
        if self.me == 0:
            mask[0] = True
        return mask

    def _r2c(self, x, tables):
        # the even/odd pairing is local on natural chunks (P | M)
        zr, zi = (x[..., 0].contiguous(), x[..., 1].contiguous())
        yr, yi = self.core.run(self._rows(zr), self._rows(zi), tables)
        cr, ci = _mirror(yr, yi, self.mesh, self.core.ptot)
        ci = -ci                                       # conj Z[M - k]
        er, ei = (yr + cr) * 0.5, (yi + ci) * 0.5
        # O = -i/2 (Z - conj Z[M-k]) = ((b + d)/2, -(a - c)/2)
        or_, oi = (yi - ci) * 0.5, (cr - yr) * 0.5
        u = ff._on(ff._tables(tables, yr.device).get(*self.untangle), yr)
        ur, ui = u[..., 0], u[..., 1]
        xr, xi = er + ur * or_ - ui * oi, ei + ur * oi + ui * or_
        # packed bin 0: DC + i Nyquist = (E0 + O0) + i (E0 - O0), E0 and O0
        # real; the mirror is the identity there
        m0 = self._bin0(xr)
        xr = torch.where(m0, er + or_, xr)
        xi = torch.where(m0, er - or_, xi)
        return xr, xi

    def _c2r(self, xr, xi, tables):
        # packed bin 0 holds DC + i Nyquist: X[0] is its real part alone
        m0 = self._bin0(xr)
        tr, ti = xr, torch.where(m0, torch.zeros_like(xi), xi)
        cr, ci = _mirror(tr, ti, self.mesh, self.core.ptot)
        ci = -ci                             # conj X[(M - k) mod M]
        # at k = 0 that is conj X[M], the Nyquist bin, real
        cr = torch.where(m0, xi, cr)
        ci = torch.where(m0, torch.zeros_like(ci), ci)
        er, ei = (tr + cr) * 0.5, (ti + ci) * 0.5
        dr, di = (tr - cr) * 0.5, (ti - ci) * 0.5
        u = ff._on(ff._tables(tables, xr.device).get(*self.untangle), xr)
        ur, ui = u[..., 0], -u[..., 1]       # conj W_n^k
        or_, oi = ur * dr - ui * di, ur * di + ui * dr
        # z = E + i O
        zr, zi = er - oi, ei + or_
        yr, yi = self.core.run(self._rows(zr.contiguous()),
                               self._rows(zi.contiguous()), tables)
        # de-interleave: x[2j] = Re z[j], x[2j+1] = Im z[j], local
        return torch.stack([yr, yi], -1).reshape(yr.shape[0], -1)


def _hop(t, mesh, pairs_to, ptot: int):
    """Every rank sends ``t`` to rank ``pairs_to(me)`` of the linear order
    and receives the tensor sent to it, by ``batch_isend_irecv`` over the
    flattened group; a send to itself is a copy."""
    if ptot == 1 or t.device.type == "meta":
        return t
    grp, me, ranks, _ = _group(mesh, NAMES)
    dst = pairs_to(me)
    src = [s for s in range(ptot) if pairs_to(s) == me][0]
    if dst == me:
        return t.clone()
    t = t.contiguous()
    out = torch.empty_like(t)
    for w in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, t, ranks[dst], grp),
            dist.P2POp(dist.irecv, out, ranks[src], grp)]):
        w.wait()
    return out


def _mirror(zr, zi, mesh, ptot: int) -> tuple:
    """zr[k] = Z[(M - k) mod M] on natural chunks (B, L), the pair
    travelling as one buffer: a local reverse, one hop to the mirror rank
    (P - 1 - s), then the (M - k) mod M wrap as a one-slot rotate, one
    more hop of the boundary element to rank s + 1 (the reference's two
    ``ppermute`` s, ``long1d.py:205-220``). At P = 1 neither hop runs."""
    rev = torch.stack([zr, zi]).flip(-1)
    rev = _hop(rev, mesh, lambda s: ptot - 1 - s, ptot)
    last = _hop(rev[..., -1:], mesh, lambda s: (s + 1) % ptot, ptot)
    out = torch.cat([last, rev[..., :-1]], -1)
    return out[0], out[1]


def _core(mesh, m: int, params: PlanParams, inverse: bool, dtype: str,
          out_scale: float, split=None):
    if split is None:
        split = dist1d_split(mesh, m, params)
    if split is None:
        return None, None
    me = linear_index(mesh)
    return _Core(mesh, m, split, params, inverse, dtype == "complex128",
                 out_scale, me), me


def make_dist_fft1d(mesh, n: int, params: PlanParams, inverse: bool,
                    dtype: str = "complex64", out_scale: float = 1.0,
                    _split=None) -> Optional[Long1D]:
    """This rank's natural-order distributed 1-D c2c (numpy fft / ifft
    semantics, the inverse's 1/n included), or None where
    :func:`dist1d_split` is None. ``_split`` pins the split and skips only
    the rule that needs more than one rank, so that the engine's own
    dataflow runs on a world of one (its exchanges and hops groups of
    one); ``plan()`` never passes it."""
    core, me = _core(mesh, n, params, inverse, dtype, out_scale, _split)
    return None if core is None else Long1D(mesh, n, False, inverse, core,
                                            me)


def make_dist_rfft1d(mesh, n: int, params: PlanParams, inverse: bool,
                     dtype: str = "complex64", out_scale: float = 1.0,
                     _split=None) -> Optional[Long1D]:
    """This rank's distributed 1-D real transform in the packed layout:
    forward, real (..., 1, 1, n) to the (..., 1, 1, M = n/2) packed
    half-spectrum (bin 0 = DC + i Nyquist, bins 1..M-1 numpy's rfft
    bins); inverse, back (numpy irfft semantics, 1/n included). None for
    an odd n, where :func:`dist1d_split` of M is None, or where P does
    not divide M. ``out_scale`` rides the inner c2c's twiddle (the
    untangle is linear). ``_split`` as for :func:`make_dist_fft1d`."""
    if n % 2:
        return None
    m = n // 2
    core, me = _core(mesh, m, params, inverse, dtype, out_scale, _split)
    if core is None or m % core.ptot:
        return None
    return Long1D(mesh, n, True, inverse, core, me)


def engine(mesh, n: int, real: bool, packed: bool, inverse: bool,
           params: PlanParams, dtype: str, out_scale: float,
           split=None) -> tuple:
    """(the engine of a (1, 1, n) plan on ``mesh``, None) or (None, why
    it does not apply): ``plan()``'s dispatch (the reference's
    ``plan/api.py:452-475``). ``split`` is the engines' ``_split``."""
    p1, p2 = mesh_shape(mesh)
    ptot = p1 * p2
    if SLICE in mesh.mesh_dim_names:
        return None, "a multi-slice mesh"
    if ptot == 1 and split is None:
        return None, "one rank"
    if real and not packed:
        return None, ("a real transform in the numpy layout (the engine's "
                      "real transforms are packed)")
    if real and n % 2:
        return None, "an odd real length"
    make = make_dist_rfft1d if real else make_dist_fft1d
    built = make(mesh, n, params, inverse, dtype, out_scale, split)
    if built is None:
        m = n // 2 if real else n
        return None, (f"no split of {m} = n1 * n2 with {ptot} | n1 and "
                      f"{ptot} | n2 (both 2-stage expressible"
                      + (", split_1d pinned)" if params.split_1d else ")"))
    return built, None
