"""offt_tpu_torch's distributed c2c pencil engine held against offt_tpu's.

One spawned gloo world of 4 CPU ranks runs every case of CASES on its
blocks (tests/torch_world.py); each case's gathered output is held
against offt_tpu on a mesh of the same shape (Pallas kernels in
interpret mode, the port's resolved parameters) and against numpy
complex128, both within 1e-6 relative norm (f32 on both sides; the
repo's fp32 bar). The cases cover the (2, 2), (1, 4) and (4, 1) meshes,
forward and inverse, every knob (t, w, ry, s = 1 ring, v = 1, 2, 3,
rankorder), an uneven shape, batch dims, ``batch_sharded``, a norm and a
(2, 1, 2) multi-slice mesh. In-process cases (a world of one rank): the
1 x 1 mesh plan equals the single-device route bit for bit, a (1, 1, N)
plan there takes the pencil engine as the reference's does, and the
refusals. JAX is imported only inside the tests' functions, so the
spawned ranks never load it."""

import datetime
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_world as tw

C = tw.case
CASES = [
    C(),
    C(inverse=True),
    C(mesh=(1, 4), knobs=dict(t1=2, t2=2, w1=1, w2=1, ry=5)),
    C(mesh=(4, 1), inverse=True, knobs=dict(t1=2, t2=2, w1=1, ry=0)),
    C(knobs=dict(s1=1, s2=1, t1=2, t2=2, w1=0, w2=0)),
    C(mesh=(1, 4), inverse=True, knobs=dict(s1=1, s2=1, ry=5)),
    C(knobs=dict(v=1, t1=2, t2=1, w1=1)),
    C(inverse=True, knobs=dict(v=2, t1=1, t2=2, w2=1)),
    C(mesh=(4, 1), knobs=dict(v=3, ry=10)),
    C(shape=(10, 12, 16), knobs=dict(t1=2, t2=2, w1=1, w2=1, ry=5, s1=1)),
    C(shape=(10, 12, 16), inverse=True, knobs=dict(v=3, t1=2, t2=2)),
    C(mesh=(1, 4), shape=(5, 6, 14)),
    C(mesh=(4, 1), shape=(9, 7, 16), inverse=True),
    C(batch=(2,), knobs=dict(t1=2, t2=2, ry=5, rankorder=2)),
    C(norm="ortho", inverse=True, knobs=dict(rankorder=1, s2=1)),
    C(batch=(4,), batch_sharded=True),
    C(batch=(4,), batch_sharded=True, inverse=True, norm="forward"),
    C(mesh=(2, 1, 2), batch=(4,)),
    C(mesh=(2, 1, 2), batch=(4,), inverse=True, knobs=dict(t1=2, ry=5)),
]


def _worker(rank, outdir):
    tw.run_cases(rank, outdir, CASES)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("pencil")
    tw.spawn(_worker, out)
    return out


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[tw.case_id(c) for c in CASES])
def test_pencil_matches_reference(world, i):
    c = CASES[i]
    got, params, ran = tw.gather(world, i, c)
    assert got.dtype == np.complex64
    ref = tw.reference(c, tw.inputs(c, i), params)
    want = tw.truth(c, i)
    assert tw.rel_err(got, ref) < 1e-6
    assert tw.rel_err(got, want) < 1e-6
    assert tw.rel_err(ref, want) < 1e-6
    if c["knobs"] is not None:
        assert {k: params[k] for k in c["knobs"]} == c["knobs"]
    # each rank of a batch_sharded plan runs the single-device fused route
    assert ("fft_slab_yz" if c["batch_sharded"] else "fft_last") in ran


# ---- a world of one rank, in this process ---------------------------------

@pytest.fixture
def world1(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape)
                                  .astype(np.float32)) for _ in range(2))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("norm", [None, "ortho"])
def test_one_rank_mesh_equals_the_local_route(world1, inverse, norm):
    import offt_tpu_torch as ot
    from offt_tpu_torch.dist import make_mesh
    from offt_tpu_torch.kernels import fused_fft as ff
    from offt_tpu_torch.plan.api import _local_fft3d, _norm_scale, plan
    from offt_tpu_torch.plan.params import PlanParams

    shape = (8, 16, 32)
    mesh = make_mesh(1, 1, device_type="cpu")
    p = plan(shape, "complex64", mesh=mesh, planar=True, inverse=inverse,
             norm=norm, use_cache=False, device="cpu")
    assert p.route == "pencil" and p.params.p1 == 1
    assert p.params == PlanParams(p1=1, use_pallas=1)
    x = _pair(shape, seed=1)
    ff.reset_counts()
    yr, yi = p(x)
    assert ff.counts()["fft_last"] == (0, 1)
    wr, wi = _local_fft3d(x, inverse, False, shape[2], p.params,
                          _norm_scale(norm, inverse, 8 * 16 * 32))
    assert torch.equal(yr, wr) and torch.equal(yi, wi)
    # the one-shot call takes the block's shape as the global one
    f = ot.ifft3d if inverse else ot.fft3d
    y = f(torch.complex(*x), mesh=mesh, norm=norm, use_cache=False)
    assert torch.equal(y, torch.complex(wr, wi))


@pytest.mark.parametrize("inverse", [False, True])
def test_one_rank_real_mesh_equals_the_single_device_plan(world1, inverse):
    from offt_tpu_torch.dist import make_mesh
    from offt_tpu_torch.plan.api import plan

    shape = (4, 8, 30)              # Nz = 30: the unfused rfft_1d / irfft_1d
    mesh = make_mesh(1, 1, device_type="cpu")
    kw = dict(real=True, inverse=inverse, norm="ortho", use_cache=False,
              device="cpu")
    p = plan(shape, "float32", mesh=mesh, **kw)
    q = plan(shape, "float32", **kw)
    assert q.route == "local"
    if inverse:
        x = torch.complex(*_pair((4, 8, 16), seed=2))
        x = torch.fft.rfftn(torch.fft.irfftn(x, s=shape))
    else:
        x = _pair(shape, seed=2)[0]
    assert torch.equal(p(x), q(x))


def test_mesh_plan_refusals(world1):
    from offt_tpu_torch.dist import make_mesh
    from offt_tpu_torch.plan.api import plan

    mesh = make_mesh(1, 1, device_type="cpu")
    with pytest.raises(ValueError):          # gloo does not serve cuda
        make_mesh(1, 1, device_type="cuda")
    with pytest.raises(ValueError):          # a cuda plan on a cpu mesh
        plan((8, 8, 8), "complex64", mesh=mesh, device="cuda")
    # a (1, 1, N) plan on a 1 x 1 mesh takes the pencil engine, as the
    # reference's does (the long-1-D engine needs P > 1), and warns not
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        q = plan((1, 1, 64), "complex64", mesh=mesh, planar=True,
                 device="cpu")
        r = plan((1, 1, 64), "float32", mesh=mesh, real=True, planar=True,
                 packed=True, device="cpu")
    assert q.route == r.route == "pencil"
    x = _pair((1, 1, 64), seed=3)
    want = plan((1, 1, 64), "complex64", planar=True, device="cpu")(*x)
    assert all(torch.allclose(a, b, rtol=0, atol=1e-5)
               for a, b in zip(q(*x), want))
    w = torch.fft.rfft(x[0].double())
    want = torch.cat([torch.complex(w[..., :1].real, w[..., 32:].real),
                      w[..., 1:32]], -1)
    got = torch.complex(*r(x[0])).to(torch.complex128)
    assert torch.allclose(got, want, rtol=0, atol=1e-5)
    with pytest.raises(ValueError):          # in_place is single-device
        plan((8, 8, 8), "complex64", mesh=mesh, planar=True, in_place=True,
             device="cpu")
    with pytest.raises(ValueError):          # packed needs Nz/2 2-stage
        plan((8, 8, 2 ** 16), "float32", mesh=mesh, real=True, planar=True,
             packed=True, device="cpu")
    with pytest.raises(ValueError, match="batch"):
        plan((8, 8, 8), "complex64", mesh=mesh, batch_sharded=True,
             device="cpu")
    p = plan((8, 8, 8), "complex64", mesh=mesh, planar=True, device="cpu")
    with pytest.raises(ValueError):          # a block of the wrong shape
        p(*_pair((8, 8, 4), seed=0))
    with pytest.raises(ValueError):          # data on another device
        p(*(t.to("meta") for t in _pair((8, 8, 8), seed=0)))


def test_mesh_needs_a_process_group():
    from offt_tpu_torch.dist import make_mesh
    from offt_tpu_torch.plan.api import plan

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1, 1, device_type="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        plan((8, 8, 8), "complex64", mesh=object(), device="cpu")
