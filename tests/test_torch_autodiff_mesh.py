"""Autodiff through offt_tpu_torch's distributed (pencil) plans, held
against offt_tpu's: the distributed cases of tests/test_autodiff.py.

One spawned gloo world of 4 CPU ranks (tests/torch_world.py) runs every
case on its blocks: each rank passes its block of the global input and
its block of the global cotangent (or tangent) and keeps its block of the
gradient. The backward's exchanges are collectives, so every rank runs
its backward. The parent gathers the blocks and holds them against
``jax.vjp`` / ``jax.jvp`` / ``jax.grad`` of the reference plan on a mesh
of the same shape over ``jax.devices()[:4]``, the complex conventions
through the conjugate (tests/test_torch_autodiff.py), and checks the
transpose identity over the gathered arrays. Tolerances: 1e-5 relative at
complex64, 1e-9 on the fp64 route.

A mesh real plan's adjoint is a pencil plan of the other direction whose
z stage is the 1-D rule (``z_adjoint``): the cotangent arrives in the
transposed-out layout, which splits z, and z-pencils hold it whole. The
numpy layout's c2r stage there is ``rfft.irfft_1d``, whose untangle the
reference's wrapped rule does not transpose off the Hermitian manifold;
those cases compare with the reference at its default point, where its
autodiff is native (tests/test_torch_autodiff_real.py)."""

import datetime
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_world as tw

TOL = 1e-5
TOL64 = 1e-9


def case(kind, mesh=(2, 2), shape=(16, 16, 16), planar=False, packed=False,
         fp64=False, norm=None, mode="vjp", ref="default"):
    return dict(kind=kind, mesh=mesh, shape=shape, planar=planar,
                packed=packed, fp64=fp64, norm=norm, mode=mode, ref=ref)


CASES = [
    # test_grad_distributed_c2c_matches_local
    case("c2c", fp64=True, mode="loss"),
    case("c2c", mesh=(1, 4), planar=True, norm="ortho"),
    # test_transpose_distributed_rfft
    case("r2c", fp64=True),
    case("r2c", mesh=(1, 4), planar=True, packed=True, ref="same"),
    # test_grad_distributed_irfft_native
    case("c2r", fp64=True, mode="loss"),
    # test_transpose_distributed_irfft_c64
    case("c2r"),
    # test_grad_distributed_c2r_composite_c64
    case("r2c", mode="composite"),
    # test_transpose_distributed_irfft_planar_c64, both layouts
    case("c2r", planar=True),
    case("c2r", planar=True, packed=True, ref="same"),
    case("c2r", mesh=(1, 4), planar=True, packed=True, norm="forward",
         ref="same"),
    # test_transpose_distributed_irfft_odd_n_c64
    case("c2r", shape=(16, 16, 27)),
    # test_jvp_wrapped_distributed_planar
    case("c2c", planar=True, mode="jvp"),
]


def _ids(c):
    return "-".join([c["kind"], "x".join(map(str, c["mesh"])),
                     "x".join(map(str, c["shape"])), c["mode"]]
                    + ["planar"] * c["planar"] + ["packed"] * c["packed"]
                    + ["fp64"] * c["fp64"] + ([c["norm"]] if c["norm"]
                                              else []))


def _leaves(a, planar: bool) -> list:
    """Numpy leaves of a calling convention's value: a planar pair's two
    halves, or the array itself."""
    if planar and np.iscomplexobj(a):
        return [a.real.copy(), a.imag.copy()]
    return [a]


def _globals(c, i):
    """(input, cotangent or tangent, k) global numpy arrays of case i."""
    rng = np.random.default_rng(i)
    nx, ny, nz = c["shape"]
    nf = nz // 2 + (0 if c["packed"] else 1)
    cdt = np.complex128 if c["fp64"] else np.complex64
    rdt = np.float64 if c["fp64"] else np.float32

    def cplx(shp):
        return (rng.standard_normal(shp)
                + 1j * rng.standard_normal(shp)).astype(cdt)
    if c["kind"] == "c2c":
        x = cplx(c["shape"])
        ct = cplx(c["shape"])
    elif c["kind"] == "r2c":
        x = rng.standard_normal(c["shape"]).astype(rdt)
        ct = cplx((nx, ny, nf))
    else:
        x = cplx((nx, ny, nf))
        ct = rng.standard_normal(c["shape"]).astype(rdt)
    fx = np.fft.fftfreq(nx)[:, None, None]
    fy = np.fft.fftfreq(ny)[None, :, None]
    fz = np.fft.rfftfreq(nz)[None, None, :]
    k = np.exp(-40.0 * (fx ** 2 + fy ** 2 + fz ** 2)).astype(rdt)
    return x, ct, k


def _plan(c, mesh, kind=None):
    import offt_tpu_torch as ot
    kind = kind or c["kind"]
    real = kind != "c2c"
    if c["fp64"]:
        dtype = "float64" if real else "complex128"
    else:
        dtype = "float32" if real else "complex64"
    return ot.plan(c["shape"], dtype, mesh=mesh, real=real,
                   inverse=kind == "c2r", planar=c["planar"],
                   packed=c["packed"], norm=c["norm"], use_cache=False,
                   device="cpu")


def _run_case(c, i, mesh, outdir, rank):
    p = _plan(c, mesh)
    x, ct, k = _globals(c, i)
    planar = c["planar"]
    xs = [torch.from_numpy(a[p.input_block(a.shape)].copy())
          for a in _leaves(x, planar)]
    save = {}
    if c["mode"] == "jvp":
        ts = [torch.from_numpy(a[p.input_block(a.shape)].copy())
              for a in _leaves(ct, planar)]
        ys, outs = torch.func.jvp(lambda *a: p(*a), tuple(xs), tuple(ts))
        blk = p.output_block(c["shape"])
        save.update(o0=outs[0].numpy(), o1=outs[1].numpy(),
                    blk=np.array([[s.start, s.stop] for s in blk]))
    else:
        for a in xs:
            a.requires_grad_()
        if c["mode"] == "composite":
            pi = _plan(c, mesh, "c2r")
            y = pi(p(*xs) * torch.from_numpy(
                k[p.output_block(k.shape)].copy()))
            loss = y.pow(2).sum()
        elif c["mode"] == "loss":
            y = p(*xs)
            w = torch.from_numpy(ct[p.output_block(ct.shape)].copy())
            loss = (w * y).real.sum() if c["kind"] == "c2r" else \
                (y * w).abs().pow(2).sum()
        else:
            y = p(*xs)
            ys = y if isinstance(y, tuple) else (y,)
            ctl = _leaves(ct, planar)
            cts = [torch.from_numpy(a[p.output_block(a.shape)].copy())
                   for a in ctl]
            save.update({f"y{j}": v.detach().numpy()
                         for j, v in enumerate(ys)})
            save["yblk"] = np.array([[s.start, s.stop] for s in
                                     p.output_block(ctl[0].shape)])
            loss = None
        if loss is not None:
            gs = torch.autograd.grad(loss, xs)
        else:
            gs = torch.autograd.grad(ys, xs, cts)
        save.update({f"g{j}": g.numpy() for j, g in enumerate(gs)})
        save["blk"] = np.array([[s.start, s.stop] for s in
                                p.input_block(x.shape)])
        save["fn"] = np.array(type(
            (y if isinstance(y, torch.Tensor) else y[0]).grad_fn).__name__)
    import dataclasses
    import json
    save["params"] = np.array(json.dumps(dataclasses.asdict(p.params)))
    np.savez(os.path.join(outdir, f"{i}_{rank}.npz"), **save)


def _worker(rank, outdir):
    import offt_tpu_torch as ot
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(outdir, 'store')}",
        rank=rank, world_size=tw.WORLD,
        timeout=datetime.timedelta(seconds=120))
    try:
        meshes = {}
        for i, c in enumerate(CASES):
            if c["mesh"] not in meshes:
                meshes[c["mesh"]] = ot.make_mesh(*c["mesh"],
                                                 device_type="cpu")
            _run_case(c, i, meshes[c["mesh"]], outdir, rank)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("autodiff_mesh")
    tw.spawn(_worker, out)
    return out


def _gather(world, i, keys, blk_key, shape, dtype):
    outs = [np.zeros(shape, dtype) for _ in keys]
    seen = np.zeros(shape, bool)
    for rank in range(tw.WORLD):
        d = np.load(os.path.join(world, f"{i}_{rank}.npz"))
        blk = tuple(slice(a, b) for a, b in d[blk_key])
        for o, k in zip(outs, keys):
            o[blk] = d[k]
        seen[blk] = True
    assert seen.all()
    return outs


def _ref(c, i, world, kind=None):
    import json

    import jax

    import offt_tpu
    from offt_tpu.dist import mesh as rmesh
    from offt_tpu.plan.params import PlanParams
    kind = kind or c["kind"]
    d = np.load(os.path.join(world, f"{i}_0.npz"))
    params = None
    if c["ref"] == "same":
        params = PlanParams(**{k: tuple(v) if isinstance(v, list) else v
                               for k, v in json.loads(str(d["params"]))
                               .items()})
    mesh = rmesh.make_mesh(*c["mesh"], devices=jax.devices()[:4])
    return offt_tpu.plan(c["shape"],
                         "complex128" if c["fp64"] else "complex64",
                         mesh=mesh, real=kind != "c2c",
                         inverse=kind == "c2r", planar=c["planar"],
                         packed=c["packed"], norm=c["norm"], params=params,
                         use_cache=False)


def _join(leaves):
    return leaves[0] if len(leaves) == 1 else leaves[0] + 1j * leaves[1]


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_ids(c) for c in CASES])
def test_distributed_autodiff_matches_reference(world, i):
    import jax
    import jax.numpy as jnp

    from test_torch_autodiff import ref_vjp, rel
    c = CASES[i]
    x, ct, k = _globals(c, i)
    tol = TOL64 if c["fp64"] else TOL
    rp = _ref(c, i, world)
    xl = _leaves(x, c["planar"])
    if c["mode"] == "jvp":
        got = _join(_gather(world, i, ["o0", "o1"], "blk", c["shape"],
                            xl[0].dtype))
        tl = _leaves(ct, True)
        _, (jr, ji) = jax.jvp(lambda a, b: rp((a, b)), tuple(xl), tuple(tl))
        assert rel(got, np.asarray(jr) + 1j * np.asarray(ji)) < tol
        assert rel(got, np.fft.fftn(ct.astype(np.complex128))) < tol
        return
    gkeys = [f"g{j}" for j in range(len(xl))]
    g = _gather(world, i, gkeys, "blk", x.shape, xl[0].dtype)
    fn = str(np.load(os.path.join(world, f"{i}_0.npz"))["fn"])
    last = "c2r" if c["mode"] == "composite" else c["kind"]
    conv = {"c2c": "C2C", "r2c": "R2C", "c2r": "C2R"}[last]
    assert fn == conv + ("Planar" if c["planar"] else "Complex") + "Backward"
    if c["mode"] == "composite":
        pi = _ref(c, i, world, "c2r")
        gj = jax.grad(lambda v: jnp.sum(pi(rp(v) * k) ** 2))(jnp.asarray(x))
        assert rel(g[0], np.asarray(gj)) < tol
        xt = torch.from_numpy(x.astype(np.float64)).requires_grad_()
        y = torch.fft.irfftn(torch.fft.rfftn(xt) * torch.from_numpy(
            k.astype(np.float64)), s=c["shape"])
        g2, = torch.autograd.grad(y.pow(2).sum(), xt)
        assert rel(g[0], g2.numpy()) < tol
        return
    if c["mode"] == "loss":
        if c["kind"] == "c2r":
            gj = jax.grad(lambda z: jnp.sum(rp(z) * ct).real)(jnp.asarray(x))
        else:
            gj = jax.grad(lambda z: jnp.sum(jnp.abs(rp(z) * ct) ** 2))(
                jnp.asarray(x))
        assert rel(g[0], np.conj(np.asarray(gj))) < tol
        return
    ctl = _leaves(ct, c["planar"])
    y = _gather(world, i, [f"y{j}" for j in range(len(ctl))], "yblk",
                ctl[0].shape, ctl[0].dtype)
    # the transpose identity over the gathered arrays
    lhs = sum(float(np.real(np.vdot(a, b))) for a, b in zip(ctl, y))
    rhs = sum(float(np.real(np.vdot(a, b))) for a, b in zip(g, xl))
    assert abs(lhs - rhs) <= (1e-9 if c["fp64"] else 1e-4) * abs(lhs)
    gr = ref_vjp(rp, xl, ctl, planar=c["planar"])
    for a, b in zip(g, gr):
        assert rel(a, b) < tol
