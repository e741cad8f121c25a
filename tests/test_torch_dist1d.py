"""offt_tpu_torch's distributed long-1-D engine (dist/long1d.py) held
against offt_tpu's: the cases of tests/test_dist1d.py on 4 ranks.

One spawned gloo world of 4 CPU ranks (tests/torch_world.py) runs every
(1, 1, n) plan of CASES on its natural chunks; the parent gathers them
and holds each against offt_tpu on a mesh of the same shape over
``jax.devices()[:4]`` (the port's resolved parameters, Pallas kernels in
interpret mode) and against numpy, at the reference tests' bars: 1e-6
for float32, 1e-12 for float64. Every case states its route (the
engine, fused or unfused, or the pencil engine with its warning). The
gradient cases (c2c, the packed r2c's Parseval gradient, the packed
c2r's transpose identity) are held to their exact values at 1e-5. In
process: ``pick_split``'s ``divisor`` against the reference's picks,
``dist1d_split`` at P = 4 against the reference's, and each rank's
twiddle and untangle chunks against the matching columns of the whole
tables. JAX is imported only inside the tests' functions, so the spawned
ranks never load it."""

import datetime
import json
import os
import types
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_world as tw


def case(mesh=(2, 2), n=4096, batch=(), inverse=False, real=False,
         norm=None, knobs=None, fp64=False, route="fused", data="normal",
         grad=None, roundtrip=False):
    return dict(mesh=tuple(mesh), shape=(1, 1, n), batch=tuple(batch),
                inverse=inverse, real=real, packed=real, norm=norm,
                batch_sharded=False, knobs=knobs, fp64=fp64, route=route,
                data=data, grad=grad, roundtrip=roundtrip)


CASES = [
    case(),
    case(mesh=(1, 4)),
    case(mesh=(4, 1)),
    case(inverse=True),
    case(inverse=True, norm="ortho"),
    case(inverse=True, norm="forward"),
    case(roundtrip=True),
    case(roundtrip=True, norm="ortho"),
    case(mesh=(1, 4), roundtrip=True, norm="forward"),
    case(knobs=dict(s1=1, s2=1)),
    case(knobs=dict(v=1)),
    case(mesh=(1, 4), inverse=True, knobs=dict(v=2, s1=1)),
    case(mesh=(4, 1), knobs=dict(v=3)),
    case(knobs=dict(rankorder=2, s2=1)),
    case(n=3 * 2 ** 16),
    case(fp64=True, route="unfused"),
    case(fp64=True, inverse=True, norm="ortho", route="unfused"),
    case(batch=(3,)),
    case(knobs=dict(use_pallas=0), route="unfused"),
    case(n=2 ** 18),                    # n1 / P = n2 / P = 128
    case(mesh=(1, 2)),                  # two ranks of the world's four
    case(n=2 * 1949, route="pencil"),   # no P-divisible split
    case(data="arange"),                # the golden DC bin
    case(n=8192, real=True),
    case(mesh=(1, 4), n=8192, real=True),
    case(n=8192, real=True, inverse=True),
    case(n=8192, real=True, inverse=True, norm="ortho"),
    case(mesh=(4, 1), n=8192, real=True, inverse=True, norm="forward",
         knobs=dict(s1=1, v=2)),
    case(fp64=True, n=8192, real=True, route="unfused"),
    case(grad="c2c", norm="ortho"),
    case(grad="c2c", mesh=(1, 4), inverse=True),
    case(grad="r2c", real=True),
    case(grad="r2c", mesh=(4, 1), real=True, norm="ortho"),
    case(grad="c2r", real=True, inverse=True),
    case(grad="c2r", mesh=(1, 4), real=True, inverse=True, norm="forward"),
]


def _id(c) -> str:
    parts = [tw.case_id(c), c["route"]]
    if c["data"] != "normal":
        parts.append(c["data"])
    if c["roundtrip"]:
        parts.append("roundtrip")
    if c["grad"]:
        parts.append("grad")
    return "-".join(parts)


def _inputs(c, i) -> np.ndarray:
    if c["data"] == "arange":
        n = c["shape"][2]
        return np.arange(n, dtype=np.float64).astype(
            np.complex64).reshape(c["batch"] + c["shape"])
    return tw.inputs(c, seed=i)


def _weights(c, shape) -> np.ndarray:
    """The loss's weights on the output (c2c) or the cotangent (c2r)."""
    return np.random.default_rng(99).uniform(0.5, 1.5, shape)


def _pair(a):
    return (torch.from_numpy(np.ascontiguousarray(a.real)),
            torch.from_numpy(np.ascontiguousarray(a.imag)))


def _grad(c, p, blk_in, x, oblk):
    """This rank's gradient block: c2c, of sum(w |y|^2) on the output;
    r2c, of sum(|y|^2) (packed: the Parseval loss); c2r, of sum(w * y)."""
    if c["grad"] == "r2c":
        xr = torch.from_numpy(x[blk_in].copy()).requires_grad_()
        yr, yi = p(xr)
        (g,) = torch.autograd.grad((yr ** 2 + yi ** 2).sum(), (xr,))
        return g.numpy()
    xr, xi = (t.requires_grad_() for t in _pair(x[blk_in]))
    y = p(xr, xi)
    if c["grad"] == "c2c":
        w = torch.from_numpy(_weights(c, tw.out_shape(c))[oblk])
        loss = (w * (y[0] ** 2 + y[1] ** 2)).sum()
    else:
        w = torch.from_numpy(_weights(c, tw.out_shape(c))[oblk])
        loss = (w * y).sum()
    gr, gi = torch.autograd.grad(loss, (xr, xi))
    return gr.numpy() + 1j * gi.numpy()


def _plan(c, mesh):
    import offt_tpu_torch as ot
    from offt_tpu_torch.plan.params import PlanParams

    params = None
    if c["knobs"]:
        params = PlanParams(p1=c["mesh"][0], **{"use_pallas": 1,
                                                **c["knobs"]})
    dtype = ("float64" if c["real"] else "complex128") if c["fp64"] else \
        ("float32" if c["real"] else "complex64")
    return ot.plan(c["shape"], dtype, mesh=mesh, real=c["real"],
                   inverse=c["inverse"], batch_dims=len(c["batch"]),
                   params=params, use_cache=False, planar=True,
                   norm=c["norm"], packed=c["packed"], device="cpu")


def _run(rank, outdir, i, c, mesh):
    from offt_tpu_torch.dist import local_block

    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        p = _plan(c, mesh)
    warned = [str(w.message) for w in seen if w.category is UserWarning]
    x = _inputs(c, i)
    blk = p.input_block(x.shape)
    assert local_block(p.mesh, p.input_layout, x.shape) == blk
    oblk = p.output_block(tw.out_shape(c))
    if c["grad"]:
        y = _grad(c, p, blk, x, oblk)
        oblk = blk
    elif c["roundtrip"]:     # the inverse plan of the forward's output
        y = _plan(dict(c, inverse=True), mesh)(*p(*_pair(x[blk])))
    elif c["real"] and not c["inverse"]:
        y = p(torch.from_numpy(x[blk].copy()))
    else:
        y = p(*_pair(x[blk]))
    if isinstance(y, tuple):
        y = y[0].numpy() + 1j * y[1].numpy()
    elif isinstance(y, torch.Tensor):
        y = y.numpy()
    eng = p._long1d
    meta = dict(route=p.route, fused=None if eng is None else eng.fused,
                split=None if eng is None else list(eng.split),
                warned=warned, rankorder_regrid=p.mesh is not mesh,
                layout=[list(d) if isinstance(d, tuple) else d
                        for d in p.input_layout.dims])
    np.savez(os.path.join(outdir, f"{i}_{rank}.npz"), y=y,
             blk=np.array([[s.start, s.stop] for s in oblk]),
             params=json.dumps(__import__("dataclasses").asdict(p.params)),
             ran=json.dumps([]), meta=json.dumps(meta))


def _worker(rank, outdir):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(outdir, 'store')}",
        rank=rank, world_size=tw.WORLD,
        timeout=datetime.timedelta(seconds=120))
    try:
        meshes = {}
        for i, c in enumerate(CASES):
            if c["mesh"] not in meshes:
                meshes[c["mesh"]] = tw._mesh(c["mesh"])
            if rank < tw._ranks(c):
                _run(rank, outdir, i, c, meshes[c["mesh"]])
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("dist1d")
    tw.spawn(_worker, out)
    return out


def _gather(world, i, c):
    if c["grad"]:       # the gradient has the input's shape
        c = dict(c, inverse=not c["inverse"])
    got, params, _ = tw.gather(world, i, c)
    d = np.load(os.path.join(world, f"{i}_0.npz"))
    return got, params, json.loads(str(d["meta"]))


def _unpack(p, n):
    """Packed (..., M) as numpy's (..., M + 1) half-spectrum."""
    return np.concatenate([p[..., :1].real, p[..., 1:], p[..., :1].imag],
                          -1)


def _truth(c, x):
    n = c["shape"][2]
    if c["roundtrip"]:
        return x.astype(np.complex128)
    if not c["real"]:
        f = np.fft.ifft if c["inverse"] else np.fft.fft
        return f(x.astype(np.complex128), norm=c["norm"])
    if not c["inverse"]:
        return tw.half_spectrum(c, x.astype(np.float64))
    return np.fft.irfft(_unpack(x.astype(np.complex128), n), n,
                        norm=c["norm"])


def _check_route(c, meta, params):
    if c["route"] == "pencil":
        assert meta["route"] == "pencil"
        assert len(meta["warned"]) == 1
        assert f"(1, 1, {c['shape'][2]})" in meta["warned"][0]
        assert "4 ranks" in meta["warned"][0] and "split" in \
            meta["warned"][0]
        return
    assert meta["route"] == "long1d" and not meta["warned"]
    assert meta["fused"] == (c["route"] == "fused")
    assert meta["layout"][:-1] == [None] * (len(c["batch"]) + 2)
    assert meta["layout"][-1] == ["row", "col"]
    if c["knobs"]:
        assert {k: params[k] for k in c["knobs"]} == c["knobs"]
    assert meta["rankorder_regrid"] == bool((c["knobs"] or {}).get(
        "rankorder"))


@pytest.mark.parametrize("i", [i for i, c in enumerate(CASES)
                               if not c["grad"]],
                         ids=[_id(c) for c in CASES if not c["grad"]])
def test_dist1d_matches_reference(world, i):
    c = CASES[i]
    got, params, meta = _gather(world, i, c)
    _check_route(c, meta, params)
    x = _inputs(c, i)
    want = _truth(c, x)
    bar = 1e-12 if c["fp64"] else 1e-6
    if c["roundtrip"]:
        assert tw.rel_err(got, want) < bar
        return
    ref = tw.reference(c, x, params)
    if c["real"] and c["inverse"]:
        ref = ref.real
    assert tw.rel_err(got, want) < bar
    assert tw.rel_err(got, ref) < bar
    assert tw.rel_err(ref, want) < bar
    if c["data"] == "arange":
        # the golden DC bin: the exact sum of the inputs
        s = x.sum()
        assert abs(got[..., 0] - s) / abs(s) < 1e-6
    if c["real"] and not c["inverse"]:
        # packed bin 0 = DC + i Nyquist, exact: sum(x), sum(x (-1)^j)
        v = x.reshape(-1).astype(np.float64)
        dc, ny = v.sum(), (v * (-1.0) ** np.arange(v.size)).sum()
        g0 = got.reshape(-1)[0]
        assert abs(g0.real - dc) / abs(dc) < 1e-5
        assert abs(g0.imag - ny) / max(abs(ny), 1e-6) < 1e-4


@pytest.mark.parametrize("i", [i for i, c in enumerate(CASES)
                               if c["grad"]],
                         ids=[_id(c) for c in CASES if c["grad"]])
def test_dist1d_gradients(world, i):
    """c2c: the gradient of sum(w |y|^2), planar, is 2 F^H (w y), F^H
    the adjoint of the normed DFT. r2c packed: the exact Parseval
    gradient of sum |X_packed|^2, n x + S + (-1)^j A times the norm's
    square (S = sum x, A = sum (-1)^j x). c2r packed: the gradient of
    sum(w * y) is C^T w, held by the transpose identity <C X, w> =
    <X, C^T w> over the planar pairs."""
    c = CASES[i]
    got, _, meta = _gather(world, i, c)
    assert meta["route"] == "long1d" and meta["fused"]
    x = _inputs(c, i)
    n = c["shape"][2]
    norm = c["norm"]
    if c["grad"] == "c2c":
        f = np.fft.ifft if c["inverse"] else np.fft.fft
        y = f(x.astype(np.complex128), norm=norm)
        wy = _weights(c, y.shape) * y
        # F^H: the other direction under the complementary norm
        flip = {None: "forward", "ortho": "ortho", "forward": None}[norm]
        g = np.fft.fft if c["inverse"] else np.fft.ifft
        want = 2 * g(wy, norm=flip)
    elif c["grad"] == "r2c":
        s2 = {None: 1.0, "ortho": 1.0 / n, "forward": 1.0 / n ** 2}[norm]
        x64 = x.astype(np.float64)
        sgn = (-1.0) ** np.arange(n)
        want = s2 * (n * x64 + x64.sum(-1, keepdims=True)
                     + sgn * (x64 * sgn).sum(-1, keepdims=True))
    else:
        w = _weights(c, tw.out_shape(dict(c, inverse=True, real=True)))
        cx = np.fft.irfft(_unpack(x.astype(np.complex128), n), n, norm=norm)
        lhs = (cx * w).sum()
        rhs = (got.real * x.real + got.imag * x.imag).sum()
        assert abs(lhs - rhs) / np.linalg.norm(cx) / np.linalg.norm(w) \
            < 1e-5
        return
    assert tw.rel_err(got, want) < 1e-5


# ---- in process ------------------------------------------------------------

def test_pick_split_divisor_matches_the_reference():
    from offt_tpu.kernels import fourstep as rfs

    from offt_tpu_torch.kernels import fourstep as fs

    for n in (4096, 2 ** 18, 2 ** 20, 3 * 2 ** 16, 3 * 2 ** 18, 2 * 1949,
              2 ** 24, 10 ** 6, 5 * 2 ** 17):
        for d in (1, 2, 4, 8, 16):
            assert fs.pick_split(n, divisor=d) == \
                rfs.pick_split(n, divisor=d), (n, d)
    assert fs.pick_split(4096, divisor=8) == (32, 128)
    assert fs.pick_split(4096, (4, 1024), divisor=8) is None
    assert fs.pick_split(4096, (64, 64), divisor=8) == (64, 64)
    # the divisor is part of the memo key
    assert fs.pick_split(2 ** 18) == (512, 512)
    assert fs.pick_split(2 ** 18, divisor=1024) is None
    assert fs.pick_split(2 ** 18) == (512, 512)


def test_dist1d_split_matches_the_reference():
    import jax

    from offt_tpu.dist import make_mesh as rmake_mesh
    from offt_tpu.dist.long1d import dist1d_split as rsplit
    from offt_tpu.plan.params import PlanParams as RParams

    from offt_tpu_torch.dist import dist1d_split
    from offt_tpu_torch.plan.params import PlanParams

    def fake(p1, p2):       # what dist1d_split reads of a DeviceMesh
        return types.SimpleNamespace(mesh=torch.zeros(p1, p2),
                                     mesh_dim_names=("row", "col"))

    for p1, p2 in ((2, 2), (1, 4), (4, 1), (1, 1)):
        rmesh = rmake_mesh(p1, p2, devices=jax.devices()[:p1 * p2])
        for n in (4096, 2 ** 18, 3 * 2 ** 16, 2 * 1949, 4097, 2 ** 22):
            for split in (None, (4, 1024), (64, 64), (16, 256)):
                got = dist1d_split(fake(p1, p2), n, PlanParams(
                    split_1d=split))
                assert got == rsplit(rmesh, n, RParams(split_1d=split)), \
                    (p1, p2, n, split)
    assert dist1d_split(fake(2, 2), 4096, PlanParams()) == (32, 128)
    assert dist1d_split(fake(2, 2), 2 * 1949, PlanParams()) is None
    assert dist1d_split(fake(1, 1), 4096, PlanParams()) is None
    assert dist1d_split(None, 4096, PlanParams()) is None


@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_chunks_are_the_tables_columns(inverse):
    from offt_tpu_torch.kernels import tables as tb

    n1, n2, ptot = 64, 256, 4
    whole = tb.fourstep_twiddle(n1, n2, inverse, 0.25)
    w = n2 // ptot
    for r in range(ptot):
        chunk = tb.fourstep_twiddle_chunk(n1, n2, r * w, (r + 1) * w,
                                          inverse, 0.25)
        assert chunk.shape == (n1, w, 2) and chunk.dtype == np.float32
        assert np.array_equal(chunk, whole[:, r * w:(r + 1) * w])
        c64 = tb.fourstep_twiddle_chunk(n1, n2, r * w, (r + 1) * w,
                                        inverse, 0.25, "float64")
        assert np.allclose(c64, whole[:, r * w:(r + 1) * w], atol=1e-7)
    # the untangle chunks, against the reference's u_host expression
    n, m = 8192, 4096
    k = np.arange(m, dtype=np.float64)
    u = np.exp(-2j * np.pi * k / n)
    for r in range(ptot):
        lo, hi = r * m // ptot, (r + 1) * m // ptot
        ch = tb.untangle_chunk(n, lo, hi)
        assert np.array_equal(ch[:, 0], u.real.astype(np.float32)[lo:hi])
        assert np.array_equal(ch[:, 1], u.imag.astype(np.float32)[lo:hi])


def test_natural_layout_follows_the_linear_order():
    from offt_tpu_torch.dist.mesh import natural_layout

    sizes = {"row": 2, "col": 2}
    lay = natural_layout(sizes, 4)
    assert lay.dims == (None, None, None, ("row", "col"))
    chunks = [lay.block((3, 1, 1, 64), {"row": r, "col": q})[-1]
              for r in range(2) for q in range(2)]
    assert chunks == [slice(16 * i, 16 * (i + 1)) for i in range(4)]


@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_one_rank_engine_through_split(world1):
    """At P = 1 no plan() call reaches the engine (``dist1d_split`` is
    None, as in the reference); ``_split=`` runs its own dataflow there,
    its exchanges and mirror hops groups of one: c2c both ways, the
    packed r2c and c2r, and through ``api._build(long1d_split=)`` a plan
    whose adjoints (autodiff's long-1-D rules) hold the transpose
    identity."""
    from offt_tpu_torch.dist import long1d, make_mesh
    from offt_tpu_torch.kernels import fourstep as fs
    from offt_tpu_torch.kernels import fused_fft as ff
    from offt_tpu_torch.plan import api
    from offt_tpu_torch.plan.params import PlanParams

    mesh = make_mesh(1, 1, device_type="cpu")
    n = 4096
    prm = PlanParams(p1=1, use_pallas=1)
    assert long1d.make_dist_fft1d(mesh, n, prm, False) is None
    rng = np.random.default_rng(5)
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    xs = tuple(torch.from_numpy(t.astype(np.float32).reshape(1, 1, n))
               for t in (x.real, x.imag))
    for inverse in (False, True):
        e = long1d.make_dist_fft1d(mesh, n, prm, inverse,
                                   _split=fs.pick_split(n))
        assert e.fused and e.split == (32, 128)
        ff.reset_counts()
        yr, yi = e(xs)
        assert ff.counts()["_step1_twiddle"] == (0, 1)
        want = (np.fft.ifft if inverse else np.fft.fft)(x)
        assert tw.rel_err((yr + 1j * yi).numpy().ravel(), want) < 1e-6
    r = rng.standard_normal(n)
    rt = torch.from_numpy(r.astype(np.float32).reshape(1, 1, n))
    e = long1d.make_dist_rfft1d(mesh, n, prm, False,
                                _split=fs.pick_split(n // 2))
    pr, pi = e((rt,))
    w = np.fft.rfft(r)
    got = _unpack((pr + 1j * pi).numpy().ravel(), n)
    assert tw.rel_err(got, w) < 1e-6
    back = long1d.make_dist_rfft1d(mesh, n, prm, True,
                                   _split=fs.pick_split(n // 2))((pr, pi))
    assert tw.rel_err(back[0].numpy().ravel(), r) < 1e-6
    assert long1d.make_dist_rfft1d(mesh, n + 1, prm, False,
                                   _split=(64, 64)) is None

    # plans on the engine at P = 1, and their adjoints
    for real in (False, True):
        m = n // 2 if real else n
        p = api._build((1, 1, n), "float32" if real else "complex64",
                       mesh=mesh, real=real, packed=real, planar=True,
                       norm="ortho", device="cpu",
                       long1d_split=fs.pick_split(m))
        assert p.route == "long1d"
        assert p.input_layout.dims[-1] == ("row", "col")
        if real:
            a = rt.clone().requires_grad_()
            y = p(a)
            ins = (a,)
        else:
            ins = tuple(t.clone().requires_grad_() for t in xs)
            y = p(*ins)
        g = tuple(torch.from_numpy(rng.standard_normal(t.shape)
                                   .astype(np.float32)) for t in y)
        adj = torch.autograd.grad(y, ins, g)
        lhs = float(sum((u.detach() * v).sum() for u, v in zip(y, g)))
        rhs = float(sum((u.detach() * v).sum() for u, v in zip(ins, adj)))
        assert abs(lhs - rhs) / abs(lhs) < 1e-5
        assert p._related(inverse=True, norm="ortho", planar=True
                          ).route == "long1d"
    # donate is accepted and changes nothing on the engine's route
    q = api._build((1, 1, n), "complex64", mesh=mesh, planar=True,
                   donate=True, device="cpu", long1d_split=fs.pick_split(n))
    assert q.route == "long1d" and not q.in_place
    yr, yi = q(*(t.clone() for t in xs))
    assert tw.rel_err((yr + 1j * yi).numpy().ravel(), np.fft.fft(x)) < 1e-6
