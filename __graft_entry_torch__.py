"""The entry points of the PyTorch / CUDA port (``offt_tpu_torch``): a
one-card forward step and a multi-rank dry run, the counterparts of
``__graft_entry__.py``.

``entry()`` returns the flagship transform, the forward planar 3-D c2c
plan at 128^3 (a ``torch.nn.Module``), and its inputs.

``dryrun_multichip(n)`` runs one step of every mesh feature on an
n-rank world, at tiny shapes: the c2c round trip, r2c and c2r, the rank
order, the ring and gather exchanges, a gradient, an uneven shape, the
distributed long-1-D engine, the mesh tuner and a multi-slice mesh. It
runs in the process group it is called in, or, where none is started,
spawns one: gloo ranks on the CPU for ``device="cpu"``, else NCCL ranks
with one card each.

    python __graft_entry_torch__.py            # entry(), then the dry run
"""

from __future__ import annotations

import numpy as np

TOL = 1e-5          # the mesh paths' round trips and comparisons
TOL_SLICES = 1e-4   # the multi-slice mesh against numpy


def entry(device=None, n: int = 128):
    """(fn, args): the forward planar c2c plan of (n, n, n) on ``device``
    (default: the current CUDA device; without one it raises) and its
    (re, im) float32 inputs, drawn from numpy seed 0."""
    import torch

    import offt_tpu_torch as ot

    p = ot.plan((n, n, n), "complex64", planar=True, device=device)
    rng = np.random.default_rng(0)
    re = rng.standard_normal((n, n, n)).astype(np.float32)
    im = rng.standard_normal((n, n, n)).astype(np.float32)
    return p, (torch.from_numpy(re).to(p.device),
               torch.from_numpy(im).to(p.device))


def _check(ok: bool, what: str) -> None:
    """Raise where a check of the dry run fails (kept under ``-O``)."""
    if not ok:
        raise AssertionError(what)


def _rel(num: float, den: float) -> float:
    return (num / max(den, 1e-300)) ** 0.5


def _grid(p: int) -> tuple:
    p1 = int(np.sqrt(p))
    while p % p1:
        p1 -= 1
    return p1, p // p1


def _dryrun(device_type: str) -> None:
    """Every step of the reference's dry run on this rank of the world."""
    import math

    import torch
    import torch.distributed as dist

    import offt_tpu_torch as ot
    from offt_tpu_torch.dist import make_mesh, make_multislice_mesh
    from offt_tpu_torch.dist import mesh as meshlib
    from offt_tpu_torch.plan.params import PlanParams
    from offt_tpu_torch.tune import tune

    dev = torch.device(device_type)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def total(x: float) -> float:
        v = torch.tensor([x], dtype=torch.float64, device=dev)
        dist.all_reduce(v)
        return float(v.item())

    def sq(a) -> float:
        a = a.to(torch.complex128) if a.is_complex() else a.double()
        return float(torch.linalg.vector_norm(a) ** 2)

    def err(got, want) -> float:
        """||got - want|| / ||want|| over every rank's block."""
        return _rel(total(sq(got - want)), total(sq(want)))

    def whole(plan, y, shape):
        """The global output from each rank's block (disjoint blocks
        summed into zeros: exact)."""
        g = torch.zeros(shape, dtype=y.dtype, device=dev)
        g[plan.output_block(shape)] = y
        dist.all_reduce(g)
        return g

    ptot = dist.get_world_size()
    p1, p2 = _grid(ptot)
    mesh = make_mesh(p1, p2, device_type=dev.type)

    n = 16
    ny = max(n, int(np.lcm(ptot, 4)))
    shape = (max(n, 2 * p1), ny, max(n, 2 * p2))
    # the reference's knobs, with the kernels on (its explicit params
    # leave use_pallas at 0, the unfused engine)
    params = PlanParams(p1=p1, t1=2, t2=2, w1=1, w2=1, ry=5, use_pallas=1)

    def c2c(params, inverse=False, shp=shape):
        return ot.plan(shp, "complex64", mesh=mesh, params=params,
                       inverse=inverse, planar=True, device=dev)

    def r2c(inverse=False, shp=shape, params=params):
        return ot.plan(shp, "float32", mesh=mesh, real=True,
                       inverse=inverse, params=params, planar=True,
                       device=dev)

    rng = np.random.default_rng(0)
    re = rng.standard_normal(shape).astype(np.float32)
    im = rng.standard_normal(shape).astype(np.float32)

    # the c2c round trip
    fwd, inv = c2c(params), c2c(params, inverse=True)
    blk = fwd.input_block(shape)
    xr, xi = t(re[blk]), t(im[blk])
    yr, yi = fwd(xr, xi)
    br, bi = inv(yr, yi)
    e = err(torch.complex(br, bi), torch.complex(xr, xi))
    _check(e < TOL, f"multichip roundtrip rel err {e}")

    # r2c, then c2r back to the real field
    pr, pc2r = r2c(), r2c(inverse=True)
    zr, zi = pr(xr)
    back = pc2r(zr, zi)
    e = err(back, xr)
    _check(e < TOL, f"distributed c2r roundtrip mismatch {e}")

    # the rank order (the reference's ROTATE_RANKORDER): the same
    # transform on a re-gridded mesh, bit-identical to the default order
    y_all = whole(fwd, torch.complex(yr, yi), shape)
    rot = c2c(params.replace(rankorder=2))
    rblk = rot.input_block(shape)
    rr, ri = rot(t(re[rblk]), t(im[rblk]))
    _check(torch.equal(whole(rot, torch.complex(rr, ri), shape), y_all),
           "rankorder changed results")

    # the ring of single-hop sends and the all-gather exchange against
    # the all-to-all
    for what, knobs in (("ring", {"s1": 1, "s2": 1}), ("allgather",
                                                       {"v": 3})):
        cr, ci = c2c(params.replace(**knobs))(xr, xi)
        e = err(torch.complex(cr, ci), torch.complex(yr, yi))
        _check(e < TOL, f"{what} vs all_to_all mismatch {e}")

    # autodiff on the mesh: the gradient of a spectral loss (the adjoint
    # runs the direction-flipped distributed plan)
    gin = [xr.clone().requires_grad_(), xi.clone().requires_grad_()]
    grads = torch.autograd.grad((fwd(*gin)[0] ** 2).sum(), gin)
    _check(all(bool(torch.isfinite(g).all()) for g in grads),
           "multichip grad not finite")

    # a non-divisible shape: every axis pads to a mesh-axis multiple and
    # slices back (nx % p1, ny % p2 and the r2c extent (nz//2+1) % p2 are
    # all nonzero)
    odd = (max(3 * p1 - 1, 5), max(4 * p2 + 2, 6), 10)
    xo = rng.standard_normal(odd).astype(np.float32)
    yo = rng.standard_normal(odd).astype(np.float32)
    pf_o = c2c(None, shp=odd)
    pi_o = c2c(None, inverse=True, shp=odd)
    oblk = pf_o.input_block(odd)
    a, b = t(xo[oblk]), t(yo[oblk])
    e = err(torch.complex(*pi_o(*pf_o(a, b))), torch.complex(a, b))
    _check(e < TOL, f"uneven-shape roundtrip rel err {e}")
    pr_o, pcr_o = r2c(shp=odd, params=None), r2c(True, odd, None)
    e = err(pcr_o(*pr_o(a)), a)
    _check(e < TOL, f"uneven r2c/c2r roundtrip rel err {e}")

    # the distributed long-1-D engine over every rank (a 1 x 1 mesh has
    # nothing to distribute: the engine declines)
    if ptot > 1:
        n1d = 64 * ptot * ptot   # a P-divisible (n1, n2) split exists
        x1 = (rng.standard_normal(n1d) + 1j * rng.standard_normal(n1d)
              ).astype(np.complex64).reshape(1, 1, n1d)
        f1 = ot.plan((1, 1, n1d), "complex64", mesh=mesh, device=dev)
        i1 = ot.plan((1, 1, n1d), "complex64", mesh=mesh, inverse=True,
                     device=dev)
        _check(f1.route == "long1d", "dist-1d engine did not engage")
        b1 = f1.input_block(x1.shape)
        y1 = f1(t(x1[b1]))
        want = t(np.fft.fft(x1.astype(np.complex128))[
            f1.output_block(x1.shape)])
        e = err(y1, want)
        _check(e < TOL, f"dist-1d spectrum rel err {e}")
        e = err(i1(y1), t(x1[b1]))
        _check(e < TOL, f"dist-1d roundtrip rel err {e}")

        # the real 1-D transforms (a half-length c2c and the distributed
        # untangle, packed layout): the spectrum and the c2r round trip
        xr1 = rng.standard_normal(2 * n1d).astype(np.float32).reshape(
            1, 1, 2 * n1d)
        rf1 = ot.plan((1, 1, 2 * n1d), "float32", mesh=mesh, real=True,
                      planar=True, packed=True, device=dev)
        ri1 = ot.plan((1, 1, 2 * n1d), "float32", mesh=mesh, real=True,
                      inverse=True, planar=True, packed=True, device=dev)
        _check(rf1.route == "long1d", "dist-1d r2c did not engage")
        rb = rf1.input_block(xr1.shape)
        hr, hi = rf1(t(xr1[rb]))
        w = np.fft.rfft(xr1.astype(np.float64))
        packed = w[..., :n1d].copy()
        packed[..., 0] = w[..., 0].real + 1j * w[..., n1d].real
        want = t(packed[rf1.output_block((1, 1, n1d))])
        e = err(torch.complex(hr, hi).to(torch.complex128), want)
        _check(e < TOL, f"dist-1d r2c rel err {e}")
        e = err(ri1(hr, hi), t(xr1[rb]))
        _check(e < TOL, f"dist-1d c2r roundtrip rel err {e}")

    # the tuner on the mesh: a 4-trial FAST_TUNING search (trials time the
    # first fast_trial pipeline chunks of each phase)
    res = tune(shape, "complex64", mesh=mesh, max_trials=4, fast_trial=2,
               save=False, device=dev)
    _check(math.isfinite(res.best_perf), "mesh tune smoke returned no perf")

    # a multi-slice mesh: the batch split over the slice dim, the pencil
    # exchanges within each slice's (p1', p2') mesh
    if ptot % 2 == 0 and ptot >= 4:
        ms = make_multislice_mesh(2, max(p1 // 2, 1), device_type=dev.type)
        xb = rng.standard_normal((2,) + shape).astype(np.float32)
        sblk = meshlib.local_block(ms, meshlib.input_layout(ms, 4),
                                   xb.shape)
        yb = ot.fft3d(t(xb[sblk]).to(torch.complex64), mesh=ms, shape=shape)
        want = np.fft.fftn(xb, axes=(-3, -2, -1))
        want = t(want[meshlib.local_block(ms, meshlib.output_layout(ms, 4),
                                          want.shape)])
        e = err(yb.to(torch.complex128), want)
        _check(e < TOL_SLICES, f"multislice mismatch {e}")
    dist.barrier()


def _rank_main(rank: int, world: int, device_type: str, store: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    if device_type == "cuda":
        torch.cuda.set_device(rank)
    torch.set_num_threads(1)
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    try:
        _dryrun(device_type)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One step of every mesh feature on ``n_devices`` ranks (module doc):
    in the process group this call runs in, which must hold
    ``n_devices`` ranks, else on a world it spawns and joins (gloo for
    ``device="cpu"``, else NCCL, one card a rank). Raises where a check
    fails."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist

    device_type = torch.device("cuda" if device is None else device).type
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"the process group holds "
                             f"{dist.get_world_size()} ranks, not "
                             f"{n_devices}")
        _dryrun(device_type)
        return
    if device_type == "cuda":
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs "
                               f"{n_devices} CUDA cards, "
                               f"{torch.cuda.device_count()} visible")
        from offt_tpu_torch.kernels import _build
        _build.build()          # once, before the ranks load it
    with tempfile.TemporaryDirectory() as d:
        store = "file://" + os.path.join(d, "store")
        torch.multiprocessing.spawn(_rank_main,
                                    args=(n_devices, device_type, store),
                                    nprocs=n_devices, join=True)


if __name__ == "__main__":
    import torch

    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry OK", [tuple(o.shape) for o in out])
    dryrun_multichip(torch.cuda.device_count())
    print("dryrun_multichip OK")
