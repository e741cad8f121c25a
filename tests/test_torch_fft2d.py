"""The 2-D one-shots of offt_tpu_torch (``fft2d``, ``ifft2d``,
``rfft2d``, ``irfft2d``) held against offt_tpu's, case by case after
tests/test_fft2d.py: a (1, Y, N) plan on one device; on a
``make_mesh(1, 4)`` mesh the pencil engine with its one exchange (the
row group has one rank), y-split rows in and z-split columns out (the
reference's METHOD-ONE analogue).

The distributed cases run on one spawned gloo world of 4 CPU ranks
(tests/torch_world.py): each rank passes its block, the parent gathers
the blocks and holds them against the reference's one-shot on a (1, 4)
mesh over ``jax.devices()[:4]`` and against numpy. Tolerance: 1e-5
relative (tests/test_fft2d.py's), complex64 on both sides."""

import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import offt_tpu_torch as ot
import torch_world as tw

TOL = 1e-5


def _relerr(got, want):
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def c64(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def test_fft2d_single(rng):
    import offt_tpu
    x = c64(rng, (64, 64))
    y = ot.fft2d(torch.from_numpy(x))
    assert y.shape == (64, 64) and y.dtype == torch.complex64
    assert _relerr(y.numpy(), np.fft.fft2(x)) < TOL
    assert _relerr(y.numpy(), np.asarray(offt_tpu.fft2d(x))) < TOL
    back = ot.ifft2d(y)
    assert _relerr(back.numpy(), x) < TOL
    assert ot.plan((1, 64, 64), "complex64", device="cpu").route == "fft3d"


def test_fft2d_batched(rng):
    import offt_tpu
    x = c64(rng, (3, 32, 32))
    y = ot.fft2d(torch.from_numpy(x))
    assert _relerr(y.numpy(), np.fft.fft2(x, axes=(-2, -1))) < TOL
    assert _relerr(y.numpy(), np.asarray(offt_tpu.fft2d(x))) < TOL


def test_rfft2d_roundtrip(rng):
    import offt_tpu
    x = rng.standard_normal((64, 64)).astype(np.float32)
    y = ot.rfft2d(torch.from_numpy(x))
    assert y.shape == (64, 33)
    assert _relerr(y.numpy(), np.fft.rfft2(x)) < TOL
    assert _relerr(y.numpy(), np.asarray(offt_tpu.rfft2d(x))) < TOL
    back = ot.irfft2d(y)
    assert back.shape == (64, 64)
    assert _relerr(back.numpy(), x) < TOL
    assert _relerr(ot.irfft2d(y, n=64).numpy(), x) < TOL
    yr, yi = ot.rfft2d(torch.from_numpy(x), planar=True)
    assert yr.shape == (64, 33)
    assert _relerr(yr.numpy() + 1j * yi.numpy(), np.fft.rfft2(x)) < TOL


def test_fft2d_in_place():
    """The 2-D in-place route (nx = 1 through the 3-D pipeline): the row
    kernels aliased; with donate=True the planar c2c plan takes it too."""
    rng = np.random.default_rng(5)
    x = c64(rng, (256, 256))
    want = np.fft.fft2(x)
    for kw in ({"in_place": True}, {"donate": True}):
        p = ot.plan((1, 256, 256), "complex64", planar=True, device="cpu",
                    params=ot.PlanParams(use_pallas=1, precision="stack6"),
                    **kw)
        xr = torch.from_numpy(x.real.copy().reshape(1, 256, 256))
        xi = torch.from_numpy(x.imag.copy().reshape(1, 256, 256))
        yr, yi = p((xr, xi))
        assert yr is xr and yi is xi
        got = (yr.numpy() + 1j * yi.numpy()).reshape(256, 256)
        assert _relerr(got, want) < TOL


def test_fft2d_gradient_matches_torch_fft(rng):
    """A real loss through the 2-D one-shots: their plans' adjoints."""
    x = torch.from_numpy(c64(rng, (2, 32, 64))).requires_grad_()
    w = torch.from_numpy(rng.standard_normal((2, 32, 64)))
    g, = torch.autograd.grad((w * ot.fft2d(x).abs().pow(2)).sum(), x)
    x2 = x.detach().to(torch.complex128).requires_grad_()
    g2, = torch.autograd.grad((w * torch.fft.fft2(x2).abs().pow(2)).sum(),
                              x2)
    assert _relerr(g.numpy(), g2.numpy()) < TOL
    xr = torch.from_numpy(rng.standard_normal((32, 64))).float()
    xr.requires_grad_()
    k = torch.from_numpy(np.exp(-np.add.outer(np.fft.fftfreq(32) ** 2,
                                              np.fft.rfftfreq(64) ** 2)))
    g, = torch.autograd.grad(ot.irfft2d(ot.rfft2d(xr) * k.float())
                             .pow(2).sum(), xr)
    xd = xr.detach().double().requires_grad_()
    g2, = torch.autograd.grad(torch.fft.irfft2(torch.fft.rfft2(xd) * k)
                              .pow(2).sum(), xd)
    assert _relerr(g.numpy(), g2.numpy()) < TOL


# ---- distributed on make_mesh(1, 4) ----------------------------------------

# (label, kind, global (Y, N), seed)
DIST = [("even", "c2c", (64, 64), 1),
        ("uneven", "c2c", (70, 64), 2),
        ("real", "r2c", (64, 64), 3)]


def _data(kind, shape, seed):
    rng = np.random.default_rng(seed)
    if kind == "c2c":
        return c64(rng, shape)
    return rng.standard_normal(shape).astype(np.float32)


def _worker(rank, outdir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(outdir, 'store')}",
        rank=rank, world_size=tw.WORLD,
        timeout=datetime.timedelta(seconds=120))
    try:
        mesh = ot.make_mesh(1, 4, device_type="cpu")
        for label, kind, shape, seed in DIST:
            x = _data(kind, shape, seed)
            rows = ot.local_block(mesh, ot.input_layout(mesh), (1,) + shape)
            xb = torch.from_numpy(x[rows[1:]].copy())
            if kind == "c2c":
                y = ot.fft2d(xb, mesh=mesh, shape=shape)
                back = ot.ifft2d(y, mesh=mesh, shape=shape)
                out_shape = shape
            else:
                y = ot.rfft2d(xb, mesh=mesh, shape=shape)
                back = ot.irfft2d(y, shape[1], mesh=mesh)
                out_shape = (shape[0], shape[1] // 2 + 1)
            cols = ot.local_block(mesh, ot.output_layout(mesh),
                                  (1,) + out_shape)
            assert tuple(y.shape) == tuple(s.stop - s.start
                                           for s in cols[1:])
            np.savez(os.path.join(outdir, f"{label}_{rank}.npz"),
                     y=y.numpy(), back=back.numpy(),
                     cols=np.array([[s.start, s.stop] for s in cols[1:]]),
                     rows=np.array([[s.start, s.stop] for s in rows[1:]]))
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("fft2d")
    tw.spawn(_worker, out)
    return out


def _gather(world, label, key, blk, shape, dtype):
    out = np.zeros(shape, dtype)
    seen = np.zeros(shape, bool)
    for rank in range(tw.WORLD):
        d = np.load(os.path.join(world, f"{label}_{rank}.npz"))
        s = tuple(slice(a, b) for a, b in d[blk])
        out[s] = d[key]
        seen[s] = True
    assert seen.all()
    return out


@pytest.mark.parametrize("label,kind,shape,seed", DIST,
                         ids=[d[0] for d in DIST])
def test_fft2d_distributed(world, label, kind, shape, seed):
    import jax

    import offt_tpu
    from offt_tpu.dist import make_mesh
    x = _data(kind, shape, seed)
    rmesh = make_mesh(1, 4, devices=jax.devices()[:4])
    if kind == "c2c":
        want, ref = np.fft.fft2(x), offt_tpu.fft2d(x, mesh=rmesh)
        ydt = np.complex64
    else:
        want, ref = np.fft.rfft2(x), offt_tpu.rfft2d(x, mesh=rmesh)
        ydt = np.complex64
    y = _gather(world, label, "y", "cols", want.shape, ydt)
    assert _relerr(y, want) < TOL
    assert _relerr(y, np.asarray(ref)) < TOL
    back = _gather(world, label, "back", "rows", shape, x.dtype)
    assert _relerr(back, x) < TOL
