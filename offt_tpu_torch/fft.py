"""A ``numpy.fft``-style namespace on offt_tpu_torch plans.

Counterpart of ``offt_tpu/fft.py``: ``fft``, ``ifft``, ``rfft``,
``irfft``, ``hfft``, ``ihfft``, their 2-D and n-D forms, ``fftshift``,
``ifftshift``, ``fftfreq`` and ``rfftfreq``, with numpy's ``n`` / ``s`` /
``axes`` / ``norm`` rules, on torch tensors:

    import offt_tpu_torch as ot
    X = ot.fft.fftn(x)            # x a CUDA tensor: runs on its card
    y = ot.fft.irfft(Y, n=1009)   # any length (Bluestein past radix 128)

Each call runs cached plans (:func:`offt_tpu_torch.plan`): 1-D and 2-D
calls as degenerate ``(1, 1, n)`` / ``(1, ny, nz)`` 3-D plans, n-D calls
as one 3-D plan over the trailing three transform axes and further groups
of three for the rest (norms compose exactly across groups: each scales
by its own axes' product). So each call takes the plans' routes: the
kernels where an axis has one, the unfused engine (``kernels/stockham``)
for any other length and for complex128.

Devices: a call runs where its input tensor lies; a tensor on the CPU
runs the kernels' plain versions there, as ``torch.fft`` would. Anything
that is not a tensor (a numpy array, a list) goes to the current CUDA
device and raises without one. The plan cache is keyed by device and by
mesh too.

Dtypes follow ``torch.fft``: float64 and complex128 inputs give
complex128 results (the fp64 route, 1e-12), every other type complex64
(real results float64 or float32). The reference follows JAX, whose
64-bit types need x64 on.

Autodiff: every call differentiates through its plans
(``plan/autodiff.py``: each plan's backward is its adjoint plan) and the
torch ops around them, so ``torch.autograd.grad`` of a loss through
``ot.fft.rfftn`` runs the kernels again on the card.

On a mesh (:class:`use_mesh`) a call is a collective of the mesh's
ranks: each passes the same global tensor and gets the same global
result, as a JAX global array is one array. Each rank transforms its
block (the plan's ``input_block``) and the output blocks are gathered
over the mesh; under autograd the gather's backward takes the rank's
block of the gradient and the block's backward gathers the blocks' input
gradients, so every rank holds the whole gradient.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from .dist.mesh import COL, ROW, SLICE
from .dist.pencil import _group, _size
from .kernels.stockham import _complex_dtype as _cdtype
from .plan import api as _api

__all__ = [
    "fft", "ifft", "rfft", "irfft", "hfft", "ihfft",
    "fft2", "ifft2", "rfft2", "irfft2",
    "fftn", "ifftn", "rfftn", "irfftn",
    "fftshift", "ifftshift", "fftfreq", "rfftfreq",
    "use_mesh",
]


# the open use_mesh layers, oldest first: the namespace runs on the mesh of
# the newest (none open: one device)
_LAYERS: list = []


class use_mesh:
    """Route the namespace's transforms through a mesh
    (``dist.make_mesh``), as a ``with`` block or as a sticky setter::

        with offt_tpu_torch.fft.use_mesh(make_mesh(2, 2)):
            X = offt_tpu_torch.fft.fft(x)   # the long-1-D engine
        offt_tpu_torch.fft.use_mesh(mesh)   # until use_mesh(None)

    Every rank of the mesh makes the same calls (module doc). 1-D c2c
    calls ride the distributed long-1-D engine (``dist/long1d.py``) where
    a split with P | n1 and P | n2 exists; 2-D and 3-D groups ride the
    pencil engine (prefer ``make_mesh(1, p)`` for 2-D: a leading axis of
    one on p1 > 1 rows pads). Real transforms in the numpy layout on
    (1, 1, n) take the pencil engine's degenerate path, on one rank (its
    plan warns); ``plan(real=True, packed=True)`` is the distributed
    real 1-D engine. The plan cache is keyed by the mesh. A multi-slice
    mesh is refused: the namespace shards no batch dim.

    Each call opens a layer, and the namespace runs on the mesh of the
    newest layer still open (``mesh=None``: one device). Leaving a
    ``with`` block, or calling ``__exit__``, closes that call's layer
    wherever it lies, so exits need not nest: after ``a =
    use_mesh(m); b = use_mesh(None); a.__exit__(); b.__exit__()`` no
    layer is open and calls run on one device. The reference restores
    the mesh each instance replaced, which leaves ``m`` set there
    (``offt_tpu/fft.py:73-82``). A bare call's layer stays open: a later
    ``use_mesh(None)`` opens a one-device layer over it."""

    def __init__(self, mesh):
        if mesh is not None and SLICE in mesh.mesh_dim_names:
            raise ValueError("use_mesh takes a (row, col) mesh, not a "
                             "multi-slice one")
        self.mesh = mesh
        _LAYERS.append(self)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for i in range(len(_LAYERS) - 1, -1, -1):
            if _LAYERS[i] is self:
                del _LAYERS[i]
                break
        return False


def current_mesh():
    """The mesh the namespace's calls run on now, or None (one device)."""
    return _LAYERS[-1].mesh if _LAYERS else None


# ---- devices, dtypes and the plan cache -----------------------------------

def _cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: pass a tensor on the "
                           "CPU to run the namespace there")
    return torch.device("cuda", torch.cuda.current_device())


def _tensor(a) -> torch.Tensor:
    """``a`` itself when it is a tensor, else ``a`` on the current CUDA
    device."""
    if isinstance(a, torch.Tensor):
        return a
    return torch.as_tensor(a, device=_cuda())


def _rdtype(cdt: torch.dtype) -> torch.dtype:
    return torch.float64 if cdt == torch.complex128 else torch.float32


def _as_complex(a: torch.Tensor) -> torch.Tensor:
    return a.to(_cdtype(a.dtype))


def _as_real(a: torch.Tensor) -> torch.Tensor:
    if a.is_complex():
        a = a.real
    return a.to(_rdtype(_cdtype(a.dtype)))


@functools.lru_cache(maxsize=256)
def _plan_cached(shape3, dtype, real, inverse, norm, batch_dims, device,
                 mesh=None):
    """The plan of a call signature; ``mesh`` an ``api._Same`` of the
    mesh (the key is the mesh itself) or None."""
    name = str(dtype).rsplit(".", 1)[-1]
    return _api.plan(shape3, name, real=real, inverse=inverse, norm=norm,
                     batch_dims=batch_dims, device=device,
                     mesh=None if mesh is None else mesh.obj)


def _plan_for(shape3, dtype, real, inverse, norm, batch_dims, device):
    """The cached plan of a call on the current mesh."""
    mesh = current_mesh()
    return _plan_cached(shape3, dtype, real, inverse, norm, batch_dims,
                        device, None if mesh is None else _api._Same(mesh))


# ---- global tensors on a mesh ----------------------------------------------

def _gather(t, mesh, layout, shape):
    """The global tensor of ``shape`` from every mesh rank's block ``t``
    (``layout``'s blocks): each rank pads its block to the largest, one
    ``all_gather`` over the mesh's ranks, each block put in its place."""
    grp, _, ranks, order = _group(mesh, (ROW, COL))
    p2 = dict(layout.sizes)[COL]
    blocks = [layout.block(shape, {ROW: i // p2, COL: i % p2})
              for i in range(len(ranks))]
    big = [max(b[d].stop - b[d].start for b in blocks)
           for d in range(len(shape))]
    pad = t.new_zeros(big)
    pad[tuple(slice(0, n) for n in t.shape)] = t
    flat = torch.view_as_real(pad) if pad.is_complex() else pad
    outs = [torch.empty_like(flat) for _ in ranks]
    dist.all_gather(outs, flat.contiguous(), group=grp)
    out = t.new_zeros(shape)
    for g, o in enumerate(outs):
        b = blocks[order[g]]
        o = torch.view_as_complex(o) if t.is_complex() else o
        out[b] = o[tuple(slice(0, s.stop - s.start) for s in b)]
    return out


class _Scatter(torch.autograd.Function):
    """This rank's block of a global input; backward: the whole gradient,
    every rank's block of it gathered."""

    @staticmethod
    def forward(ctx, x, plan):
        ctx.plan, ctx.shape = plan, tuple(x.shape)
        return x[plan.input_block(x.shape)].contiguous()

    @staticmethod
    def backward(ctx, g):
        p = ctx.plan
        return _gather(g.contiguous(), p.mesh, p.input_layout,
                       ctx.shape), None


class _Gather(torch.autograd.Function):
    """The global output from every rank's block; backward: this rank's
    block of the gradient."""

    @staticmethod
    def forward(ctx, y, plan, shape):
        ctx.plan, ctx.shape = plan, shape
        return _gather(y, plan.mesh, plan.output_layout, shape)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.plan.output_block(ctx.shape)].contiguous(), None, None


def _apply(p, x):
    """``p`` on ``x``; on a mesh of more than one rank, ``x`` global: the
    rank's block in, the gathered global output out."""
    if p.mesh is None or _size(p.mesh, (ROW, COL)) == 1:
        return p(x)
    shape = tuple(x.shape[:-3]) + p.out_shape
    return _Gather.apply(p(_Scatter.apply(x, p)), p, shape)


def _fix_len(a, axis: int, n: int):
    """numpy's input-length rule: crop to the first ``n`` elements or
    zero-pad at the end."""
    axis = axis % a.ndim
    cur = a.shape[axis]
    if cur > n:
        return a.narrow(axis, 0, n)
    if cur < n:
        shp = list(a.shape)
        shp[axis] = n - cur
        return torch.cat([a, a.new_zeros(shp)], axis)
    return a


# ---- trailing-group plan application --------------------------------------

def _tail_c2c(a, m: int, norm, inverse: bool):
    """c2c over the LAST ``m`` (1..3) axes through one plan."""
    lead = tuple(a.shape[:a.ndim - m])
    tail = tuple(a.shape[a.ndim - m:])
    shape3 = (1,) * (3 - m) + tail
    p = _plan_for(shape3, a.dtype, False, inverse, norm, len(lead),
                  a.device)
    return _apply(p, a.reshape(lead + shape3)).reshape(lead + tail)


def _tail_real_fwd(a, m: int, norm):
    """r2c over the last axis and c2c over the other ``m - 1`` tail axes."""
    lead = tuple(a.shape[:a.ndim - m])
    tail = tuple(a.shape[a.ndim - m:])
    shape3 = (1,) * (3 - m) + tail
    p = _plan_for(shape3, a.dtype, True, False, norm, len(lead), a.device)
    y = _apply(p, a.reshape(lead + shape3).contiguous())
    return y.reshape(lead + tail[:-1] + (tail[-1] // 2 + 1,))


def _hermitian_edges(a, m: int, n_out: int):
    """numpy's c2r rule for the planes of the last axis that a real
    output forces real, 0 and (``n_out`` even) ``n_out // 2``: numpy runs
    the inverse c2c over the other ``m - 1`` tail axes first and then
    keeps the real part of those planes, which is the inverse transform
    of their Hermitian part over those axes, (P(k) + conj P(-k)) / 2 (at
    ``m == 1`` the real part itself). Those planes are replaced by it, so
    the result agrees with numpy on any input, Hermitian-consistent or
    not."""
    planes = [0] + ([a.shape[-1] - 1] if n_out % 2 == 0 < n_out else [])
    dims = tuple(range(a.ndim - m, a.ndim - 1))
    a = a.clone()
    for i in planes:
        p = a[..., i]
        q = p
        for d in dims:      # P(-k): k -> (n - k) mod n along each axis
            q = torch.roll(torch.flip(q, (d,)), 1, d)
        a[..., i] = (p + q.conj()) / 2
    return a


def _tail_real_inv(a, m: int, n_out: int, norm):
    """c2r (output length ``n_out``) over the last axis and the inverse
    c2c over the other ``m - 1`` tail axes; the input's last axis is
    already ``n_out // 2 + 1``. The planes a real output forces real take
    numpy's rule first (:func:`_hermitian_edges`). The reference keeps
    that rule to one axis and feeds a multi-axis group's planes to its
    c2r as they are (``offt_tpu/fft.py:149-174``), so on input that is
    not Hermitian along the other axes it disagrees with numpy; on
    Hermitian-consistent input (any ``rfftn`` output) the two agree."""
    a = _hermitian_edges(a, m, n_out)
    lead = tuple(a.shape[:a.ndim - m])
    tail = tuple(a.shape[a.ndim - m:])
    shape3 = (1,) * (3 - m) + tail[:-1] + (n_out,)
    p = _plan_for(shape3, _rdtype(a.dtype), True, True, norm, len(lead),
                  a.device)
    y = _apply(p, a.reshape(lead + (1,) * (3 - m) + tail).contiguous())
    return y.reshape(lead + tail[:-1] + (n_out,))


def _grouped_c2c(a, k: int, norm, inverse: bool):
    """c2c over the last ``k`` axes, three at a time (each group one plan;
    the axes' transforms commute, so grouping is free)."""
    if k == 0:
        return a
    m = 3 if k >= 3 else k
    a = _tail_c2c(a, m, norm, inverse)
    if k > m:
        nd = a.ndim
        # park the m done axes at the front of the k-axis tail block, so
        # the k - m untransformed axes become the new tail
        done = tuple(range(nd - m, nd))
        front = tuple(range(nd - k, nd - k + m))
        a = _grouped_c2c(a.movedim(done, front), k - m, norm, inverse)
        a = a.movedim(front, done)
    return a


def _on_axes(a, axes, fn):
    """Move ``axes`` (in order) to the end, apply ``fn``, move them back."""
    rest = [i for i in range(a.ndim) if i not in axes]
    order = rest + list(axes)
    a = fn(a.permute(order))
    inv = [0] * a.ndim
    for i, ax in enumerate(order):
        inv[ax] = i
    return a.permute(inv)


def _resolve(a, s, axes):
    """numpy's ``s`` / ``axes`` rules: no axes means all of them, or the
    last ``len(s)`` when ``s`` is given."""
    if axes is None:
        axes = (list(range(a.ndim)) if s is None
                else list(range(a.ndim - len(s), a.ndim)))
    axes = [ax % a.ndim for ax in axes]
    if s is None:
        s = [a.shape[ax] for ax in axes]
    if len(s) != len(axes):
        raise ValueError("s and axes must have the same length")
    return list(s), axes


# ---- 1-D ------------------------------------------------------------------

def fft(a, n=None, axis=-1, norm=None):
    """1-D c2c along ``axis`` (``numpy.fft.fft``)."""
    return _fft1(a, n, axis, norm, inverse=False)


def ifft(a, n=None, axis=-1, norm=None):
    """1-D inverse c2c along ``axis`` (``numpy.fft.ifft``)."""
    return _fft1(a, n, axis, norm, inverse=True)


def _fft1(a, n, axis, norm, inverse):
    a = _as_complex(_tensor(a))
    axis = axis % a.ndim
    if n is not None:
        a = _fix_len(a, axis, n)
    if axis != a.ndim - 1:
        return _on_axes(a, [axis], lambda t: _tail_c2c(t, 1, norm, inverse))
    return _tail_c2c(a, 1, norm, inverse)


def rfft(a, n=None, axis=-1, norm=None):
    """1-D r2c along ``axis``: the ``n // 2 + 1`` bins of
    ``numpy.fft.rfft`` (a complex input's imaginary part is dropped)."""
    a = _as_real(_tensor(a))
    axis = axis % a.ndim
    if n is not None:
        a = _fix_len(a, axis, n)
    if axis != a.ndim - 1:
        return _on_axes(a, [axis], lambda t: _tail_real_fwd(t, 1, norm))
    return _tail_real_fwd(a, 1, norm)


def irfft(a, n=None, axis=-1, norm=None):
    """1-D c2r along ``axis``: a real result of length ``n`` (default
    ``2 * (m - 1)``), ``numpy.fft.irfft``."""
    a = _as_complex(_tensor(a))
    axis = axis % a.ndim
    if n is None:
        n = 2 * (a.shape[axis] - 1)
    a = _fix_len(a, axis, n // 2 + 1)
    if axis != a.ndim - 1:
        return _on_axes(a, [axis], lambda t: _tail_real_inv(t, 1, n, norm))
    return _tail_real_inv(a, 1, n, norm)


_SWAP = {None: "forward", "backward": "forward",
         "forward": "backward", "ortho": "ortho"}


def hfft(a, n=None, axis=-1, norm=None):
    """The FFT of a Hermitian-symmetric signal: a real result of length
    ``n`` (default ``2 * (m - 1)``), ``irfft(conj(a), n)`` under the
    swapped norm, as in numpy."""
    if norm not in _SWAP:
        raise ValueError(f"norm must be backward|ortho|forward, got {norm!r}")
    return irfft(_as_complex(_tensor(a)).conj_physical(), n, axis,
                 norm=_SWAP[norm])


def ihfft(a, n=None, axis=-1, norm=None):
    """The inverse of :func:`hfft`: the conjugate ``rfft`` under the
    swapped norm."""
    if norm not in _SWAP:
        raise ValueError(f"norm must be backward|ortho|forward, got {norm!r}")
    return rfft(a, n, axis, norm=_SWAP[norm]).conj_physical()


# ---- 2-D / n-D ------------------------------------------------------------

def fft2(a, s=None, axes=(-2, -1), norm=None):
    return fftn(a, s, axes, norm)


def ifft2(a, s=None, axes=(-2, -1), norm=None):
    return ifftn(a, s, axes, norm)


def rfft2(a, s=None, axes=(-2, -1), norm=None):
    return rfftn(a, s, axes, norm)


def irfft2(a, s=None, axes=(-2, -1), norm=None):
    return irfftn(a, s, axes, norm)


def fftn(a, s=None, axes=None, norm=None):
    """n-D c2c over ``axes`` (default: all), ``numpy.fft.fftn``."""
    return _fftn(a, s, axes, norm, inverse=False)


def ifftn(a, s=None, axes=None, norm=None):
    return _fftn(a, s, axes, norm, inverse=True)


def _fftn(a, s, axes, norm, inverse):
    a = _as_complex(_tensor(a))
    s, axes = _resolve(a, s, axes)
    for ax, n in zip(axes, s):
        a = _fix_len(a, ax, n)
    if not axes:
        return a
    if len(set(axes)) != len(axes):
        # numpy allows repeated axes (the transform applied again); peel
        # them one at a time
        for ax in axes:
            a = _fft1(a, None, ax, norm, inverse)
        return a
    return _on_axes(a, axes,
                    lambda t: _grouped_c2c(t, len(axes), norm, inverse))


def rfftn(a, s=None, axes=None, norm=None):
    """n-D real FFT: r2c over ``axes[-1]``, c2c over the rest."""
    a = _as_real(_tensor(a))
    s, axes = _resolve(a, s, axes)
    if not axes:
        raise ValueError("rfftn requires at least one transform axis")
    if len(set(axes)) != len(axes):
        raise ValueError("rfftn does not support repeated axes")
    for ax, n in zip(axes, s):
        a = _fix_len(a, ax, n)
    k = len(axes)
    m = 3 if k >= 3 else k
    # the real group: the last m axes of `axes`, the r2c axis among them
    a = _on_axes(a, axes[k - m:], lambda t: _tail_real_fwd(t, m, norm))
    if k > m:
        a = _fftn(a, None, axes[:k - m], norm, inverse=False)
    return a


def irfftn(a, s=None, axes=None, norm=None):
    """n-D inverse real FFT: inverse c2c over ``axes[:-1]``, c2r over
    ``axes[-1]`` with output length ``s[-1]`` (default ``2 * (m - 1)``)."""
    a = _as_complex(_tensor(a))
    want_s = s
    s, axes = _resolve(a, s, axes)
    if not axes:
        raise ValueError("irfftn requires at least one transform axis")
    if len(set(axes)) != len(axes):
        raise ValueError("irfftn does not support repeated axes")
    if want_s is None:
        s[-1] = 2 * (a.shape[axes[-1]] - 1)
    for ax, n in zip(axes[:-1], s[:-1]):
        a = _fix_len(a, ax, n)
    n_out = s[-1]
    a = _fix_len(a, axes[-1], n_out // 2 + 1)
    k = len(axes)
    m = 3 if k >= 3 else k
    if k > m:
        a = _fftn(a, None, axes[:k - m], norm, inverse=True)
    return _on_axes(a, axes[k - m:],
                    lambda t: _tail_real_inv(t, m, n_out, norm))


# ---- helpers --------------------------------------------------------------

def _shift_axes(x, axes):
    if axes is None:
        return tuple(range(x.ndim))
    if isinstance(axes, int):
        return (axes,)
    return tuple(axes)


def fftshift(x, axes=None):
    """The zero-frequency bin to the centre (``numpy.fft.fftshift``)."""
    x = _tensor(x)
    axes = _shift_axes(x, axes)
    return torch.roll(x, [x.shape[ax] // 2 for ax in axes], axes)


def ifftshift(x, axes=None):
    """The inverse of :func:`fftshift`."""
    x = _tensor(x)
    axes = _shift_axes(x, axes)
    return torch.roll(x, [-(x.shape[ax] // 2) for ax in axes], axes)


def fftfreq(n, d=1.0, *, dtype=None, device=None):
    """The sample frequencies of an ``n``-point FFT, ``numpy.fft.fftfreq``,
    in ``dtype`` (torch's default float type) on ``device`` (the current
    CUDA device unless given)."""
    dev = _cuda() if device is None else torch.device(device)
    k = torch.cat([torch.arange(0, (n - 1) // 2 + 1, device=dev),
                   torch.arange(-(n // 2), 0, device=dev)])
    return k.to(dtype or torch.get_default_dtype()) / (n * d)


def rfftfreq(n, d=1.0, *, dtype=None, device=None):
    """The sample frequencies of :func:`rfft`, ``numpy.fft.rfftfreq``."""
    dev = _cuda() if device is None else torch.device(device)
    k = torch.arange(0, n // 2 + 1, device=dev)
    return k.to(dtype or torch.get_default_dtype()) / (n * d)
