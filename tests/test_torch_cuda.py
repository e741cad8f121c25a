"""Each CUDA kernel of offt_tpu_torch against its plain version, on the
card. Marked ``cuda``: they skip without a GPU. The file imports no JAX,
so it also runs on a machine that has only the port's dependencies:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

import offt_tpu_torch as ot
from offt_tpu_torch.kernels import fourstep as fs
from offt_tpu_torch.kernels import fused_fft as ff

REG_LENGTHS = [1 << k for k in range(4, 13)]
MIX_ROW_LENGTHS = sorted(ff._MIX_ROW_LENGTHS)


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pair(shape, dev, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape)
                                  .astype(np.float32)).to(dev)
                 for _ in range(2))


def _card_check(fn, call, shape, dev, lanes=None):
    """One launch of ``fn`` against its plain version on the same inputs:
    max |kernel - plain| / max |plain| <= 1e-6 (f32 on both sides; the
    sums run in other orders). A single-tensor result counts as one."""
    x = _pair(shape, dev)
    ff.reset_counts()
    got = call(fn, x)
    want = call(fn.plain, x)
    torch.cuda.synchronize()
    assert sum(c[0] for c in ff.counts().values()) == 1
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        if lanes:
            g, w = g[..., :lanes], w[..., :lanes]
        assert torch.isfinite(g).all()
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n", [8, 320, 1024, 16384])
def test_cuda_fft_last(cuda_dev, n):
    _card_check(ff.fft_last, lambda f, x: f(*x, scale=0.5), (33, n),
                cuda_dev)


@pytest.mark.cuda
def test_cuda_fft_last_three_stages_in_place(cuda_dev):
    _card_check(ff.fft_last, lambda f, x: f(x[0].clone(), x[1].clone(),
                                            radices=(4, 4, 4), alias=True),
                (7, 64), cuda_dev)


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_cuda_fft_sublane(cuda_dev, axis):
    _card_check(ff.fft_sublane, lambda f, x: f(*x, axis), (16, 32, 128),
                cuda_dev)


@pytest.mark.cuda
def test_cuda_fft_slab_yz(cuda_dev):
    _card_check(ff.fft_slab_yz, lambda f, x: f(*x, zpad=8, scale=0.5),
                (4, 32, 128), cuda_dev, lanes=128)


@pytest.mark.cuda
def test_cuda_fft_slab_yz_in_place(cuda_dev):
    _card_check(ff.fft_slab_yz, lambda f, x: f(x[0].clone(), x[1].clone(),
                                               inverse=True, alias=True),
                (3, 20, 48), cuda_dev)


@pytest.mark.cuda
def test_cuda_fft_x_from_padded(cuda_dev):
    _card_check(ff.fft_x_from_padded, lambda f, x: f(*x, 128),
                (16, 32, 136), cuda_dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 128, 128), (16, 32, 128),
                                   (32, 32, 32), (2, 1, 32, 64)])
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_plan_against_fftn(cuda_dev, shape, inverse):
    x = _pair(shape, cuda_dev, seed=1)
    bd = len(shape) - 3
    p = ot.plan(shape[bd:], "complex64", planar=True, inverse=inverse,
                batch_dims=bd, norm="ortho", device=cuda_dev)
    ff.reset_counts()
    yr, yi = p(x)
    assert sum(c[1] for c in ff.counts().values()) == 0
    assert sum(c[0] for c in ff.counts().values()) >= 2
    c = torch.complex(x[0].double(), x[1].double())
    f = torch.fft.ifftn if inverse else torch.fft.fftn
    ref = f(c, dim=(-3, -2, -1), norm="ortho")
    y = torch.complex(yr.double(), yi.double())
    assert (torch.linalg.vector_norm(y - ref)
            / torch.linalg.vector_norm(ref)).item() < 1e-6


# ---- the packed r2c / c2r slice -------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 16, 256), (2, 8, 512)])
def test_cuda_rfft_slab_yz(cuda_dev, shape):
    _card_check(ff.rfft_slab_yz, lambda f, x: f(x[0], zpad=8), shape,
                cuda_dev, lanes=shape[-1] // 2)


@pytest.mark.cuda
@pytest.mark.parametrize("side", [False, True])
@pytest.mark.parametrize("shape", [(4, 16, 136), (2, 8, 264)])
def test_cuda_irfft_slab_yz(cuda_dev, shape, side):
    n = 2 * (shape[-1] - 8)
    s = _pair(shape[:-1], cuda_dev, seed=2) if side else (None, None)
    _card_check(ff.irfft_slab_yz,
                lambda f, x: f(*x, n, scale=1.0 / (shape[1] * n // 2),
                               side_r=s[0], side_i=s[1]),
                shape, cuda_dev)


@pytest.mark.cuda
def test_cuda_assemble_mp1(cuda_dev):
    a = _pair((4, 16), cuda_dev, seed=3) + _pair((4, 16), cuda_dev, seed=4)
    _card_check(ff._assemble_mp1, lambda f, x: f(*x, *a), (4, 16, 128),
                cuda_dev)


@pytest.mark.cuda
def test_cuda_fft_x_to_padded(cuda_dev):
    _card_check(ff.fft_x_to_padded,
                lambda f, x: f(*x, z_true=128, inverse=True), (16, 32, 129),
                cuda_dev, lanes=128)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 16, 256), (4, 8, 512),
                                   (2, 8, 16, 256)])
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_real_plan_against_rfftn(cuda_dev, shape, packed):
    bd = len(shape) - 3
    dims = (-3, -2, -1)
    kw = {"real": True, "planar": True, "packed": packed, "norm": "ortho",
          "batch_dims": bd, "device": cuda_dev}
    x = _pair(shape, cuda_dev, seed=5)[0]
    fwd = ot.plan(shape[bd:], "float32", **kw)
    inv = ot.plan(shape[bd:], "float32", inverse=True, **kw)
    ref = torch.fft.rfftn(x.double(), dim=dims, norm="ortho")
    ff.reset_counts()
    yr, yi = fwd(x)
    back = inv(yr, yi)
    launched = {k for k, c in ff.counts().items() if c[0]}
    assert sum(c[1] for c in ff.counts().values()) == 0
    assert {"rfft_slab_yz", "fft_x_from_padded", "fft_x_to_padded",
            "irfft_slab_yz"} <= launched
    assert ("_assemble_mp1" in launched) == (not packed)
    assert back.shape == shape
    spec = ot.unpack_rfft3d(yr, yi) if packed else (yr, yi)
    y = torch.complex(spec[0].double(), spec[1].double())
    assert (torch.linalg.vector_norm(y - ref)
            / torch.linalg.vector_norm(ref)).item() < 1e-6
    # the inverse of the exact spectrum, against irfftn
    w = ref.to(torch.complex64)
    wr, wi = w.real.contiguous(), w.imag.contiguous()
    if packed:
        wr, wi = (t.contiguous() for t in ot.pack_rfft3d(wr, wi))
    back = inv(wr, wi)
    want = torch.fft.irfftn(w.to(torch.complex128), s=shape[bd:], dim=dims,
                            norm="ortho")
    assert (torch.linalg.vector_norm(back.double() - want)
            / torch.linalg.vector_norm(want)).item() < 1e-6


# ---- the axis-by-axis route: four-step and r2c kernels --------------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 128, 256), (1, 1024, 1024),
                                   (2, 1024, 768)])
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_step1_twiddle(cuda_dev, shape, inverse):
    _, n1, n2 = shape
    _card_check(fs._step1_twiddle,
                lambda f, x: f(*x, n1, n2, None, inverse, scale=0.5),
                shape, cuda_dev)


@pytest.mark.cuda
def test_cuda_step1_twiddle_caller_table(cuda_dev):
    tw = torch.stack(_pair((128, 384), cuda_dev, seed=6), -1)
    _card_check(fs._step1_twiddle,
                lambda f, x: f(*x, 128, 384, None, False, tw=tw),
                (3, 128, 384), cuda_dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 128, 256), (1, 1024, 1024),
                                   (2, 1024, 768)])
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_step3_transposed(cuda_dev, shape, inverse):
    # at n2 = 768 a block holds 10 rows, so blocks straddle the batches
    _, n1, n2 = shape
    _card_check(fs._step3_transposed,
                lambda f, x: f(*x, n1, n2, None, inverse), shape, cuda_dev)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(37, 256), (5, 512), (1000, 192),
                                   (3, 7, 4)])
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_rfft_last(cuda_dev, shape, packed):
    _card_check(ff.rfft_last_planar, lambda f, x: f(x[0], packed=packed),
                shape, cuda_dev)


def _rel(y, ref):
    return (torch.linalg.vector_norm(y - ref)
            / torch.linalg.vector_norm(ref)).item()


@pytest.mark.cuda
@pytest.mark.parametrize("n,bd", [(2 ** 20, 0), (10 ** 6, 0), (2 ** 15, 1),
                                  (3 * 2 ** 18, 0)])
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_long_1d_plan_against_fft(cuda_dev, n, bd, inverse):
    shape = (3,) * bd + (1, 1, n)
    x = _pair(shape, cuda_dev, seed=7)
    p = ot.plan((1, 1, n), "complex64", planar=True, inverse=inverse,
                batch_dims=bd, norm="ortho", device=cuda_dev)
    ff.reset_counts()
    yr, yi = p(x)
    assert sum(c[1] for c in ff.counts().values()) == 0
    fused = all(s % 128 == 0 for s in fs.pick_split(n))
    want = {"_step1_twiddle", "_step3_transposed"} if fused else \
        {"fft_sublane", "fft_last"}
    assert {k for k, c in ff.counts().items() if c[0]} == want
    f = torch.fft.ifft if inverse else torch.fft.fft
    ref = f(torch.complex(x[0].double(), x[1].double()), dim=-1,
            norm="ortho")
    assert _rel(torch.complex(yr.double(), yi.double()), ref) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("shape,planar", [((8, 16, 256), False),
                                          ((16, 12, 96), True),
                                          ((4, 6, 255), True),
                                          ((1, 1, 2 ** 17), False)])
def test_cuda_local_real_plan_against_rfftn(cuda_dev, shape, planar):
    dims = (-3, -2, -1)
    kw = {"real": True, "planar": planar, "norm": "ortho",
          "device": cuda_dev}
    x = _pair(shape, cuda_dev, seed=8)[0]
    fwd = ot.plan(shape, "float32", **kw)
    inv = ot.plan(shape, "float32", inverse=True, **kw)
    assert fwd.route == inv.route == "local"
    ref = torch.fft.rfftn(x.double(), dim=dims, norm="ortho")
    ff.reset_counts()
    y = fwd(x)
    y = torch.complex(*y) if planar else y
    w = ref.to(torch.complex64)
    back = inv(w.real.contiguous(), w.imag.contiguous()) if planar \
        else inv(w)
    assert sum(c[1] for c in ff.counts().values()) == 0
    launched = {k for k, c in ff.counts().items() if c[0]}
    assert ("rfft_last_planar" in launched) == ff.can_use_rfft_last(shape[2])
    assert _rel(y.to(torch.complex128), ref) < 1e-6
    want = torch.fft.irfftn(w.to(torch.complex128), s=shape, dim=dims,
                            norm="ortho")
    assert _rel(back.double(), want) < 1e-6


@pytest.mark.cuda
def test_cuda_plan_defaults_to_the_card(cuda_dev):
    p = ot.plan((8, 8, 8), "complex64", planar=True)
    assert p.device.type == "cuda"


# ---- the pencil engine: the packed c2r kernel and a 1 x 1 mesh -------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 64), (37, 96), (3, 7, 128),
                                   (65, 256), (5, 512)])
def test_cuda_icrfft_last(cuda_dev, shape):
    _card_check(ff.icrfft_last_planar, lambda f, x: f(*x), shape, cuda_dev)


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("rows", [1, 300])      # one row; a ragged block
@pytest.mark.parametrize("m", REG_LENGTHS + MIX_ROW_LENGTHS + [72, 144])
def test_cuda_icrfft_last_cores(cuda_dev, monkeypatch, m, rows, dense):
    # the register core's c2r rows at every power of two M in [16, 4096]
    # (rows of 1 and 2 threads store through a stage) and every mixed M
    # of the rows (real_rows_mix.cu), the dense core beside it and at the
    # lengths it keeps
    if dense:
        monkeypatch.setattr(ff, "_reg_real_rows", lambda n: False)
    _card_check(ff.icrfft_last_planar, lambda f, x: f(*x, scale=0.5 / m),
                (rows, m), cuda_dev)
    assert ff.icrfft_last_planar.reg_launches == int(
        ff._reg_real_rows(m) and not dense)


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("shape", [(65536, 128), (36864, 96)])
def test_cuda_icrfft_last_main_shape(cuda_dev, monkeypatch, shape, dense):
    # the 1 x 1 mesh's packed c2r stage at 256^3, (65536, 128), and at
    # 192^3, (36864, 96) on the mixed rows
    if dense:
        monkeypatch.setattr(ff, "_reg_real_rows", lambda n: False)
    _card_check(ff.icrfft_last_planar, lambda f, x: f(*x), shape, cuda_dev)
    assert ff.icrfft_last_planar.reg_launches == int(not dense)


@pytest.mark.cuda
def test_cuda_icrfft_last_scale_and_radices(cuda_dev):
    _card_check(ff.icrfft_last_planar,
                lambda f, x: f(*x, radices=(16, 16), scale=0.5 / 256),
                (70, 256), cuda_dev)


@pytest.fixture
def nccl_world(cuda_dev):
    import torch.distributed as dist
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield cuda_dev
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 32, 256), (8, 8, 512)])
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_one_rank_mesh_real_plan(nccl_world, shape, packed):
    dims = (-3, -2, -1)
    mesh = ot.make_mesh(1, 1)
    kw = {"real": True, "planar": True, "packed": packed, "mesh": mesh,
          "params": ot.PlanParams(p1=1, t1=2, t2=2, w1=1, ry=5,
                                  use_pallas=1)}
    fwd = ot.plan(shape, "float32", **kw)
    inv = ot.plan(shape, "float32", inverse=True, **kw)
    assert fwd.route == inv.route == "pencil"
    x = _pair(shape, nccl_world, seed=9)[0]
    ref = torch.fft.rfftn(x.double(), dim=dims)
    w = ref.to(torch.complex64)
    wr, wi = w.real.contiguous(), w.imag.contiguous()
    if packed:
        wr, wi = (t.contiguous() for t in ot.pack_rfft3d(wr, wi))
    ff.reset_counts()
    yr, yi = fwd(x)
    back = inv(wr, wi)
    assert sum(c[1] for c in ff.counts().values()) == 0
    launched = {k for k, c in ff.counts().items() if c[0]}
    assert "rfft_last_planar" in launched
    assert ("icrfft_last_planar" in launched) == packed
    spec = ot.unpack_rfft3d(yr, yi) if packed else (yr, yi)
    assert _rel(torch.complex(spec[0].double(), spec[1].double()), ref) \
        < 1e-6
    want = torch.fft.irfftn(w.to(torch.complex128), s=shape, dim=dims)
    assert _rel(back.double(), want) < 1e-6


@pytest.mark.cuda
def test_cuda_one_rank_mesh_c2c_and_refusals(nccl_world):
    mesh = ot.make_mesh(1, 1)
    x = _pair((16, 32, 64), nccl_world, seed=10)
    p = ot.plan((16, 32, 64), "complex64", mesh=mesh, planar=True)
    assert p.route == "pencil" and p.device.type == "cuda"
    yr, yi = p(x)
    ref = torch.fft.fftn(torch.complex(x[0].double(), x[1].double()))
    assert _rel(torch.complex(yr.double(), yi.double()), ref) < 1e-6
    with pytest.raises(ValueError):          # a CPU block on a cuda mesh
        p(*(t.cpu() for t in x))
    with pytest.raises(ValueError):          # nccl does not serve cpu
        ot.make_mesh(1, 1, device_type="cpu")


# ---- the cube kernel, the unfused engine and the namespace ----------------

@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", [
    ((2, 32, 32, 128), {}),
    ((16, 8, 128), {"inverse": True, "out_scale": 0.5}),
    ((3, 8, 16, 512), {"precision": "stack6"}),
    ((2, 8, 128), {"rad_z": (4, 4, 8), "rad_y": (2, 4)}),
    ((1, 8, 32768), {"rad_z": (32, 32, 32)}),          # the split z phase
    ((2, 8, 8, 32768), {"rad_z": (32, 32, 32), "inverse": True}),
    ((2, 128, 128, 128), {})])
def test_cuda_fft3d_cube(cuda_dev, shape, kw):
    _card_check(ff.fft3d_cube, lambda f, x: f(*x, **kw), shape, cuda_dev)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_fft3d_cube_against_fftn(cuda_dev, inverse):
    x = _pair((4, 64, 64, 128), cuda_dev, seed=11)
    ff.reset_counts()
    yr, yi = ot.fft3d_cube(*x, inverse=inverse, out_scale=2.0)
    assert ff.fft3d_cube.launches == 1 and ff.fft3d_cube.plain_calls == 0
    f = torch.fft.ifftn if inverse else torch.fft.fftn
    ref = 2.0 * f(torch.complex(x[0].double(), x[1].double()),
                  dim=(-3, -2, -1))
    assert _rel(torch.complex(yr.double(), yi.double()), ref) < 1e-6
    with pytest.raises(ValueError, match="not fusable"):
        ot.fft3d_cube(*_pair((256, 256, 256), cuda_dev))


# the shapes of test_cuda_fft3d_cube, 8 x 128^3 inverse with out_scale,
# and x of 3, 12 and 5 (a thread a line on the table's roots; 5 beside
# the split z), forward and inverse with out_scale
CUBE_SHAPES = [
    ((2, 32, 32, 128), {}),
    ((16, 8, 128), {"inverse": True, "out_scale": 0.5}),
    ((3, 8, 16, 512), {"precision": "stack6"}),
    ((2, 8, 128), {"rad_z": (4, 4, 8), "rad_y": (2, 4)}),
    ((1, 8, 32768), {"rad_z": (32, 32, 32)}),
    ((2, 8, 8, 32768), {"rad_z": (32, 32, 32), "inverse": True}),
    ((2, 128, 128, 128), {}),
    ((8, 128, 128, 128), {"inverse": True, "out_scale": 2.0}),
    ((2, 3, 16, 128), {"out_scale": 0.5}),
    ((2, 3, 16, 128), {"inverse": True, "out_scale": 2.0}),
    ((1, 12, 8, 256), {"out_scale": 2.0}),
    ((1, 12, 8, 256), {"inverse": True, "out_scale": 0.5}),
    ((3, 5, 8, 8192), {"out_scale": 0.5}),
    ((3, 5, 8, 8192), {"inverse": True, "out_scale": 2.0})]


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("shape,kw", CUBE_SHAPES)
def test_cuda_fft3d_cube_cores(cuda_dev, monkeypatch, shape, kw, dense):
    # the register cube (csrc/fft_cube_regs.cu) where _reg_cube holds,
    # and the dense kernel with the predicate patched off, each against
    # the plain version and complex128 fftn
    if dense:
        monkeypatch.setattr(ff, "_reg_cube", lambda nx, ny, nz: False)
    reg = ff._reg_cube(*shape[-3:])
    assert reg == (not dense)
    x = _pair(shape, cuda_dev, seed=12)
    ff.reset_counts()
    yr, yi = ff.fft3d_cube(*x, **kw)
    torch.cuda.synchronize()
    assert ff.fft3d_cube.launches == 1 and ff.fft3d_cube.plain_calls == 0
    assert ff.fft3d_cube.reg_launches == int(reg)
    pr, pi = ff.fft3d_cube.plain(*x, **kw)
    for g, w in ((yr, pr), (yi, pi)):
        assert torch.isfinite(g).all()
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-6
    f = torch.fft.ifftn if kw.get("inverse") else torch.fft.fftn
    ref = kw.get("out_scale", 1.0) * f(
        torch.complex(x[0].double(), x[1].double()), dim=(-3, -2, -1))
    assert _rel(torch.complex(yr.double(), yi.double()), ref) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", range(1, 16))
def test_cuda_fft3d_cube_short_x(cuda_dev, n, inverse):
    # every x under 16 on the register cube (dft_short: the radix-2
    # network at 2, 4, 8, else the sums on the core table's roots),
    # against the plain version and complex128 fftn
    assert ff._reg_cube(n, 8, 128)
    x = _pair((2, n, 8, 128), cuda_dev, seed=14 + n)
    ff.reset_counts()
    yr, yi = ff.fft3d_cube(*x, inverse=inverse, out_scale=3.0)
    torch.cuda.synchronize()
    assert ff.fft3d_cube.reg_launches == 1
    pr, pi = ff.fft3d_cube.plain(*x, inverse=inverse, out_scale=3.0)
    for g, w in ((yr, pr), (yi, pi)):
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-6
    f = torch.fft.ifftn if inverse else torch.fft.fftn
    ref = 3.0 * f(torch.complex(x[0].double(), x[1].double()),
                  dim=(-3, -2, -1))
    assert _rel(torch.complex(yr.double(), yi.double()), ref) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 16, 24, 128), (8, 8, 384),
                                   (4, 40, 8, 128)])
def test_cuda_fft3d_cube_mixed_lengths_stay_dense(cuda_dev, shape):
    assert not ff._reg_cube(*shape[-3:])
    _card_check(ff.fft3d_cube, lambda f, x: f(*x), shape, cuda_dev)
    assert ff.fft3d_cube.reg_launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(9, 16, 16, 128), (3, 8, 8, 8192)])
def test_cuda_fft3d_cube_groups(cuda_dev, monkeypatch, shape):
    # G cubes a phase walks the batch: every G gives the same bits
    x = _pair(shape, cuda_dev, seed=13)
    want = ff.fft3d_cube(*x, inverse=True)
    for g in (1, 2, 4):
        monkeypatch.setattr(ff, "_cube_group", lambda *n, g=g: g)
        got = ff.fft3d_cube(*x, inverse=True)
        assert ff.fft3d_cube.last["group"] == min(g, shape[0])
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("n,launched", [
    (1009, {"fft_last"}), (8209, {"_step1_twiddle", "_step3_transposed"})])
def test_cuda_namespace_prime_length(cuda_dev, n, launched):
    # Bluestein's inner transforms (2048: the 2-stage core; 32768: the
    # four-step pair) ride the kernels
    x = torch.complex(*_pair((3, n), cuda_dev, seed=12))
    ff.reset_counts()
    y = ot.fft.fft(x)
    back = ot.fft.ifft(y)
    assert y.device == x.device and y.dtype == torch.complex64
    assert sum(c[1] for c in ff.counts().values()) == 0
    assert {k for k, c in ff.counts().items() if c[0]} == launched
    ref = torch.fft.fft(x.to(torch.complex128))
    assert _rel(y.to(torch.complex128), ref) < 1e-6
    assert _rel(back.to(torch.complex128), x.to(torch.complex128)) < 1e-6


@pytest.mark.cuda
def test_cuda_namespace_fp64_and_real(cuda_dev):
    g = torch.Generator(device="cuda")
    g.manual_seed(13)
    x = torch.randn((16, 24, 40), dtype=torch.complex128, generator=g,
                    device=cuda_dev)
    y = ot.fft.fftn(x)
    assert y.dtype == torch.complex128
    assert _rel(y, torch.fft.fftn(x)) < 1e-12
    r = torch.randn((6, 10, 1009), dtype=torch.float64, generator=g,
                    device=cuda_dev)
    w = ot.fft.rfftn(r, axes=(1, 2))
    assert _rel(w, torch.fft.rfftn(r, dim=(1, 2))) < 1e-12
    back = ot.fft.irfftn(w, s=(10, 1009), axes=(1, 2))
    assert back.dtype == torch.float64 and _rel(back, r) < 1e-12
    r32 = r.float()
    assert _rel(ot.fft.rfft(r32).to(torch.complex128),
                torch.fft.rfft(r)) < 1e-6
    # a numpy input goes to the current CUDA device
    a = np.random.default_rng(14).standard_normal(64)
    assert ot.fft.fft(a).device.type == "cuda"


@pytest.mark.cuda
def test_cuda_use_pallas_0_plan(cuda_dev):
    # the matmul chain on cuBLAS: full f32 with TF32 off (the fixture)
    x = _pair((16, 24, 40), cuda_dev, seed=15)
    p = ot.plan((16, 24, 40), "complex64", planar=True, device=cuda_dev,
                params=ot.PlanParams(use_pallas=0))
    ff.reset_counts()
    yr, yi = p(x)
    assert not any(any(c) for c in ff.counts().values())
    ref = torch.fft.fftn(torch.complex(x[0].double(), x[1].double()))
    assert _rel(torch.complex(yr.double(), yi.double()), ref) < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("name,call,shape,lanes", [
    ("fft_last", lambda f, x: f(*x, radices=(32, 32, 32), scale=0.5),
     (3, 32768), None),
    ("fft_sublane", lambda f, x: f(*x, 0, radices=(32, 32, 32)),
     (32768, 2, 4), None),
    ("fft_slab_yz", lambda f, x: f(*x, rad_z=(32, 32, 32), zpad=8),
     (2, 8, 32768), 32768)])
def test_cuda_long_three_stage_lines(cuda_dev, name, call, shape, lanes):
    # a line past one block's shared memory runs as the four-step pair
    fn = getattr(ff, name)
    x = _pair(shape, cuda_dev, seed=16)
    ff.reset_counts()
    got = call(fn, x)
    torch.cuda.synchronize()
    assert fs._step1_twiddle.launches == fs._step3_transposed.launches == 1
    assert sum(c[1] for c in ff.counts().values()) == 0
    want = call(fn.plain, x)
    for g, w in zip(got, want):
        if lanes:
            g, w = g[..., :lanes], w[..., :lanes]
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-6


@pytest.mark.cuda
def test_cuda_long_three_stage_plan(cuda_dev):
    x = _pair((8, 8, 32768), cuda_dev, seed=17)
    p = ot.plan((8, 8, 32768), "complex64", planar=True, device=cuda_dev,
                params=ot.PlanParams(use_pallas=1, radix_z=(32, 32, 32)))
    yr, yi = p(x)
    ref = torch.fft.fftn(torch.complex(x[0].double(), x[1].double()))
    assert _rel(torch.complex(yr.double(), yi.double()), ref) < 1e-6


# ---- the two row kernels' cores: register (fft_regs.cuh) and dense ---------


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 300])      # one row; a ragged block
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", REG_LENGTHS + [8, 96, 320])
def test_cuda_fft_last_cores(cuda_dev, n, inverse, rows):
    _card_check(ff.fft_last, lambda f, x: f(*x, inverse=inverse,
                                            scale=0.375), (rows, n), cuda_dev)
    assert ff.fft_last.reg_launches == int(ff._reg_rows(n))


MIX_ROWS = sorted(ff._MIX_ROW_LENGTHS)


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("rows", [1, 300])      # one row; a ragged block
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", MIX_ROWS)
def test_cuda_fft_last_mixed_rows(cuda_dev, monkeypatch, n, inverse, rows,
                                  dense):
    # the register core's rows at every mixed length (fft_last_mix.cu),
    # and the dense core on the same lengths
    if dense:
        monkeypatch.setattr(ff, "_reg_rows", lambda n: False)
    _card_check(ff.fft_last, lambda f, x: f(*x, inverse=inverse,
                                            scale=0.375), (rows, n), cuda_dev)
    assert ff.fft_last.reg_launches == int(not dense)


@pytest.mark.cuda
@pytest.mark.parametrize("n", MIX_ROWS)
def test_cuda_fft_last_mixed_rows_in_place(cuda_dev, n):
    x = _pair((37, n), cuda_dev, seed=n)
    want = ff.fft_last.plain(*x, inverse=True, scale=1.0 / n)
    xr, xi = x[0].clone(), x[1].clone()
    ff.reset_counts()
    yr, yi = ff.fft_last(xr, xi, inverse=True, scale=1.0 / n, alias=True)
    torch.cuda.synchronize()
    assert yr is xr and yi is xi and ff.fft_last.reg_launches == 1
    for g, w in zip((yr, yi), want):
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("n", REG_LENGTHS + [320])
def test_cuda_fft_last_cores_in_place(cuda_dev, n):
    x = _pair((37, n), cuda_dev, seed=n)
    want = ff.fft_last.plain(*x, inverse=True, scale=1.0 / n)
    xr, xi = x[0].clone(), x[1].clone()
    yr, yi = ff.fft_last(xr, xi, inverse=True, scale=1.0 / n, alias=True)
    torch.cuda.synchronize()
    assert yr is xr and yi is xi
    for g, w in zip((yr, yi), want):
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 300])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", REG_LENGTHS + MIX_ROW_LENGTHS + [72, 129])
def test_cuda_rfft_last_cores(cuda_dev, m, packed, rows):
    _card_check(ff.rfft_last_planar,
                lambda f, x: f(x[0], packed=packed, scale=0.25),
                (rows, 2 * m), cuda_dev)
    assert ff.rfft_last_planar.reg_launches == int(ff._reg_real_rows(m))


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("packed", [False, True])
def test_cuda_rfft_last_mixed_main_shape(cuda_dev, monkeypatch, packed,
                                         dense):
    # 192^3's z rows on the unfused real route, (36864, 192): M = 96 on
    # the mixed rows, and on the dense core
    if dense:
        monkeypatch.setattr(ff, "_reg_real_rows", lambda n: False)
    _card_check(ff.rfft_last_planar, lambda f, x: f(x[0], packed=packed),
                (36864, 192), cuda_dev)
    assert ff.rfft_last_planar.reg_launches == int(not dense)


@pytest.mark.cuda
def test_cuda_register_core_ignores_radices(cuda_dev):
    # it reads the first n table rows and the scale: every valid pick and
    # block_rows gives the same bits
    ff.reset_counts()
    x = _pair((33, 1024), cuda_dev, seed=3)
    outs = [ff.fft_last(*x, radices=p, block_rows=b, scale=0.5)
            for p, b in ((None, 0), ((32, 32), 7), ((8, 128), 0),
                         ((8, 8, 16), 3))]
    r = _pair((33, 512), cuda_dev, seed=4)[0]
    routs = [ff.rfft_last_planar(r, radices=p, block_rows=b)
             for p, b in ((None, 0), ((16, 16), 5), ((128, 2), 0))]
    for group in (outs, routs):
        for o in group[1:]:
            assert torch.equal(o[0], group[0][0])
            assert torch.equal(o[1], group[0][1])
    assert ff.fft_last.reg_launches == 4
    assert ff.rfft_last_planar.reg_launches == 3


# ---- the two slab kernels' cores: register (z rows, y columns) and dense --

def _slab_core(monkeypatch, dense):
    if dense:
        monkeypatch.setattr(ff, "_reg_slab", lambda ny, nz: False)
        monkeypatch.setattr(ff, "_reg_rslab", lambda ny, m: False)


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("shape,kw,lanes", [
    ((4, 32, 128), {"zpad": 8, "scale": 0.5}, 128),
    # a ragged row block (16 rows of 256 a block) and column tile
    ((3, 16, 16), {"inverse": True, "scale": 0.25}, None),
    ((2, 32, 136), {"z_true": 128, "zpad": 8, "inverse": True,
                    "scale": 1 / 4096}, 128),
    ((2, 4096, 16), {"zpad": 8}, 16),           # one y lane a block
    ((2, 64, 4096), {}, None),                 # one z row a block
    ((2, 1024, 1024), {"inverse": True}, None),
    ((4, 512, 512), {"zpad": 8}, 512),         # the 512^3 slab: two grids
    ((256, 256, 256), {"zpad": 8}, 256),       # the 256^3 main path
    # the cluster layout: 4, 8 and 16 blocks, z_true, inverse
    ((3, 64, 256), {"scale": 0.5}, None),
    ((2, 256, 136), {"z_true": 128, "zpad": 8, "inverse": True,
                     "scale": 1 / 32768}, 128),
    ((4, 512, 256), {"inverse": True}, None),
    ((3, 20, 48), {"inverse": True}, None),    # dense on both
    ((2, 40, 320), {"scale": 0.5}, None)])
def test_cuda_fft_slab_cores(cuda_dev, monkeypatch, shape, kw, lanes, dense):
    _slab_core(monkeypatch, dense)
    _card_check(ff.fft_slab_yz, lambda f, x: f(*x, **kw), shape, cuda_dev,
                lanes=lanes)
    nz = kw.get("z_true") or shape[-1]
    reg = ff._reg_slab(shape[-2], nz)
    assert ff.fft_slab_yz.reg_launches == int(reg)


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("shape,kw,lanes", [
    ((4, 320, 320), {"zpad": 8}, 320),         # the 320^3 slab's x-rows
    ((2, 192, 320), {"inverse": True, "scale": 1 / 61440}, None),
    ((2, 320, 96), {"scale": 0.5}, None),
    ((3, 48, 80), {"inverse": True}, None),     # rows of 4 threads
    ((2, 2560, 48), {"zpad": 8}, 48),           # mixed y, wide tile
    ((2, 96, 3072), {}, None),                  # one z row a block
    ((2, 64, 328), {"z_true": 320, "zpad": 8}, 320),
    ((2, 320, 128), {"scale": 0.25}, None),     # power-of-two z
    ((2, 128, 192), {"inverse": True}, None)])  # power-of-two y
def test_cuda_fft_slab_mixed(cuda_dev, monkeypatch, shape, kw, lanes, dense):
    # the register slab at mixed lengths: two grids, z on the mixed rows
    # (fft_last_mix.cu), y on the mixed columns (fft_axis_mix.cu)
    _slab_core(monkeypatch, dense)
    _card_check(ff.fft_slab_yz, lambda f, x: f(*x, **kw), shape, cuda_dev,
                lanes=lanes)
    assert ff.fft_slab_yz.reg_launches == int(not dense)
    assert not ff._cluster_slab(shape[-2], kw.get("z_true") or shape[-1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 320, 320), (2, 96, 160)])
def test_cuda_fft_slab_mixed_in_place(cuda_dev, shape):
    x = _pair(shape, cuda_dev, seed=shape[-1])
    want = ff.fft_slab_yz.plain(*x, inverse=True, scale=0.5)
    xr, xi = x[0].clone(), x[1].clone()
    ff.reset_counts()
    yr, yi = ff.fft_slab_yz(xr, xi, inverse=True, scale=0.5, alias=True)
    torch.cuda.synchronize()
    assert yr is xr and yi is xi and ff.fft_slab_yz.reg_launches == 1
    for g, w in zip((yr, yi), want):
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("shape", [(2, 64, 64), (3, 256, 16), (2, 16, 512),
                                   (4, 128, 128), (64, 256, 256)])
def test_cuda_fft_slab_cores_in_place(cuda_dev, monkeypatch, shape, dense):
    _slab_core(monkeypatch, dense)
    x = _pair(shape, cuda_dev, seed=shape[-1])
    want = ff.fft_slab_yz.plain(*x, inverse=True, scale=0.5)
    xr, xi = x[0].clone(), x[1].clone()
    ff.reset_counts()
    yr, yi = ff.fft_slab_yz(xr, xi, inverse=True, scale=0.5, alias=True)
    torch.cuda.synchronize()
    assert yr is xr and yi is xi
    assert ff.fft_slab_yz.reg_launches == int(not dense)
    for g, w in zip((yr, yi), want):
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("shape,zpad", [
    ((4, 16, 256), 8), ((3, 16, 32), 0), ((2, 4096, 32), 8),
    ((1, 16, 8192), 0), ((4, 512, 512), 8), ((256, 256, 256), 8),
    ((2, 64, 512), 8), ((2, 1024, 256), 0), ((2, 40, 640), 0)])
def test_cuda_rfft_slab_cores(cuda_dev, monkeypatch, shape, zpad, dense):
    _slab_core(monkeypatch, dense)
    _card_check(ff.rfft_slab_yz, lambda f, x: f(x[0], zpad=zpad), shape,
                cuda_dev, lanes=shape[-1] // 2)
    reg = ff._reg_rslab(shape[-2], shape[-1] // 2)
    assert ff.rfft_slab_yz.reg_launches == int(reg)


@pytest.mark.cuda
def test_cuda_rfft_slab_needs_aligned_input(cuda_dev):
    buf = torch.zeros(1 + 2 * 16 * 64, device=cuda_dev)
    with pytest.raises(ValueError, match="aligned"):
        ff.rfft_slab_yz(buf[1:].view(2, 16, 64))


@pytest.mark.cuda
def test_cuda_register_slab_ignores_radices(cuda_dev):
    x = _pair((4, 256, 256), cuda_dev, seed=21)
    outs = [ff.fft_slab_yz(*x, rad_y=ry, rad_z=rz, zpad=8)
            for ry, rz in ((None, None), ((16, 16), (64, 4)),
                           ((4, 4, 16), (128, 2)))]
    r = _pair((4, 512, 512), cuda_dev, seed=22)[0]
    routs = [ff.rfft_slab_yz(r, rad_y=ry, rad_z=rz)
             for ry, rz in ((None, None), ((32, 16), (16, 16)))]
    for group in (outs, routs):
        for o in group[1:]:
            assert torch.equal(o[0][..., :256], group[0][0][..., :256])
            assert torch.equal(o[1][..., :256], group[0][1][..., :256])


@pytest.mark.cuda
def test_cuda_slab_probe_phases(cuda_dev):
    """The cost probes compute what they leave in: zonly = the z rows,
    yonly = the y lines, copy = the input, fused and grids = the kernel
    (other layouts); noy = the packed r2c rows, copy = the float2 pairs,
    nount = the 2-D c2c of those pairs (the M-point core and y, no
    untangle), grids = the kernel."""
    x = _pair((4, 256, 256), cuda_dev, seed=23)
    full = ff.fft_slab_yz.plain(*x, zpad=8)
    for phases, want in (("full", full), ("fused", full), ("grids", full),
                         ("zonly", ff.fft_last.plain(*x)),
                         ("yonly", ff.fft_sublane.plain(*x, 1)),
                         ("copy", x)):
        got = ff.fft_slab_yz(*x, zpad=8, phases=phases)
        for g, w in zip(got, want):
            g, w = g[..., :256], w[..., :256]
            assert ((g - w).abs().max() / w.abs().max()).item() < 1e-6
    r = _pair((2, 512, 512), cuda_dev, seed=24)[0]
    pairs = (r[..., 0::2].contiguous(), r[..., 1::2].contiguous())
    for phases, want in (
            ("noy", ff.rfft_last_planar.plain(r, packed=True)),
            ("copy", pairs), ("nount", ff.fft_slab_yz.plain(*pairs)),
            ("grids", ff.rfft_slab_yz.plain(r))):
        got = ff.rfft_slab_yz(r, zpad=8, phases=phases)
        for g, w in zip(got, want):
            g = g[..., :256]
            assert ((g - w).abs().max() / w.abs().max()).item() < 1e-6
    with pytest.raises(RuntimeError):      # the probes' one shape
        ff.fft_slab_yz(*_pair((2, 128, 128), cuda_dev), phases="copy")


@pytest.mark.cuda
def test_cuda_plans_launch_the_register_slabs(cuda_dev):
    x = _pair((16, 64, 128), cuda_dev, seed=25)
    ff.reset_counts()
    p = ot.plan((16, 64, 128), "complex64", planar=True, device=cuda_dev)
    yr, yi = p(x)
    q = ot.plan((16, 64, 256), "float32", real=True, planar=True,
                packed=True, device=cuda_dev)
    q(_pair((16, 64, 256), cuda_dev, seed=26)[0])
    assert ff.fft_slab_yz.launches == ff.fft_slab_yz.reg_launches == 1
    assert ff.rfft_slab_yz.launches == ff.rfft_slab_yz.reg_launches == 1
    ref = torch.fft.fftn(torch.complex(x[0].double(), x[1].double()))
    assert _rel(torch.complex(yr.double(), yi.double()), ref) < 1e-6


# ---- the strided-axis kernel's cores: the column variant and dense -------

def _axis_core(monkeypatch, dense):
    if dense:
        monkeypatch.setattr(ff, "_reg_axis", lambda n: False)


# each geometry of fft_axis.cu's (B, N, Y, Z): (wrapper, call, shape of
# the input at length n, lanes compared)
AXIS_GEOMETRIES = {
    "flat": (ff.fft_sublane, lambda f, x: f(*x, 1, scale=0.5),
             lambda n: (2, n, 24), None),
    "pitched in": (ff.fft_x_from_padded,
                   lambda f, x: f(*x, 24, inverse=True, scale=0.25),
                   lambda n: (n, 3, 32), None),
    "pitched out": (ff.fft_x_to_padded,
                    lambda f, x: f(*x, z_true=24, inverse=True),
                    lambda n: (n, 3, 25), 24),
    "nd": (ff.fft_sublane, lambda f, x: f(*x, 1), lambda n: (2, n, 2, 128),
           None),
    "alias": (ff.fft_sublane,
              lambda f, x: f(x[0].clone(), x[1].clone(), 1, inverse=True,
                             alias=True), lambda n: (2, n, 24), None),
}


MIX_LENGTHS = sorted(ff._MIX_LENGTHS)


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("geometry", sorted(AXIS_GEOMETRIES))
@pytest.mark.parametrize("n", REG_LENGTHS + MIX_LENGTHS + [3072, 360])
def test_cuda_fft_axis_cores(cuda_dev, monkeypatch, n, geometry, dense):
    _axis_core(monkeypatch, dense)
    fn, call, shape, lanes = AXIS_GEOMETRIES[geometry]
    _card_check(fn, call, shape(n), cuda_dev, lanes=lanes)
    owner = ff._sublane_nd if geometry == "nd" else fn
    assert owner.launches == 1
    assert owner.reg_launches == int(ff._reg_axis(n) and not dense)


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("shape,axis", [
    ((320, 320, 320), 0), ((192, 192, 192), 0), ((192, 192, 192), 1),
    ((8, 768, 768), 1), ((2560, 4, 130), 0), ((3, 1536, 40), 1)])
def test_cuda_fft_axis_mixed_main_shapes(cuda_dev, monkeypatch, shape, axis,
                                         dense):
    # the mixed lengths at the main paths' shapes (the 320^3 c2c x pass,
    # 192^3's axes, a 768 column) and the longest of each family over a
    # ragged tile, inverse and in place beside forward
    _axis_core(monkeypatch, dense)
    _card_check(ff.fft_sublane, lambda f, x: f(*x, axis, scale=0.5), shape,
                cuda_dev)
    assert ff.kernel_launches("fft_axis", reg=True) == int(not dense)
    x = _pair(shape, cuda_dev, seed=7)
    want = ff.fft_sublane.plain(*x, axis, inverse=True)
    xr, xi = x[0].clone(), x[1].clone()
    yr, yi = ff.fft_sublane(xr, xi, axis, inverse=True, alias=True)
    torch.cuda.synchronize()
    assert yr is xr and yi is xi
    for g, w in zip((yr, yi), want):
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("tile,lengths", [
    ("narrow", [16, 32, 64, 128, 256, 1024]),
    ("wide", [256, 512, 1024, 2048, 4096])])
@pytest.mark.parametrize("shape", [(3, 0, 40), (2, 0, 2, 128)])
def test_cuda_fft_axis_lane_tiles(cuda_dev, tile, lengths, shape):
    # each lane tile of the column variant where the kernel has it (the
    # narrow probe forward at 256 and 1024), a ragged last tile (40 lanes)
    # and a (y, z) split (the nd route), each against the plain version
    for n in lengths:
        shp = tuple(n if s == 0 else s for s in shape)
        _card_check(ff.fft_sublane,
                    lambda f, x: f(*x, 1, scale=0.5,
                                   **({} if f is ff.fft_sublane.plain
                                      else {"tile": tile})),
                    shp, cuda_dev)


@pytest.mark.cuda
def test_cuda_fft_axis_tile_refusals(cuda_dev):
    x = _pair((2, 128, 8), cuda_dev)
    with pytest.raises(RuntimeError):          # no wide tile at 128
        ff.fft_sublane(*x, 1, tile="wide")
    with pytest.raises(RuntimeError):          # the narrow probe: forward
        ff.fft_sublane(*_pair((2, 256, 8), cuda_dev), 1, inverse=True,
                       tile="narrow")
    with pytest.raises(ValueError, match="tile"):
        ff.fft_sublane(*_pair((2, 320, 8), cuda_dev), 1, tile="narrow")


# ---- irfft_slab's cores: the register slab (clusters, two grids), dense --

@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("side", [False, True])
@pytest.mark.parametrize("shape", [
    (2, 256, 136),      # the 256^3 slab: clusters of 8
    (2, 512, 264),      # the 512^3 slab: two grids
    (2, 64, 264),       # clusters of 4
    (2, 64, 520),       # clusters of 8, (Y, M) = (64, 512)
    (2, 128, 520),      # two grids: the cluster kernel would spill here
    (3, 64, 136),       # two grids
    (4, 16, 24),        # two grids, rows of one thread (M = 16)
    (3, 32, 40),        # two grids, rows of two threads (M = 32)
    (2, 16, 4104),      # two grids, one row a block (M = 4096)
    (2, 4096, 24),      # two grids, one y lane a block
    (2, 40, 328)])      # dense on both
def test_cuda_irfft_slab_cores(cuda_dev, monkeypatch, shape, side, dense):
    _slab_core(monkeypatch, dense)
    n = 2 * (shape[-1] - 8)
    s = _pair(shape[:-1], cuda_dev, seed=2) if side else (None, None)
    _card_check(ff.irfft_slab_yz,
                lambda f, x: f(*x, n, scale=1.0 / (shape[1] * n // 2),
                               side_r=s[0], side_i=s[1]),
                shape, cuda_dev)
    reg = ff._reg_rslab(shape[1], n // 2)
    assert ff.irfft_slab_yz.reg_launches == int(reg)
    # clusters at 2^14 and 2^15 elements
    want = not dense and shape[1] * n // 2 in (1 << 14, 1 << 15)
    assert ff._cluster_irslab(shape[1], n // 2) == want


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 32, 64), (16, 256, 256),
                                   (16, 512, 512), (16, 64, 1024)])
def test_cuda_register_c2r_inverts_the_r2c(cuda_dev, shape):
    # the packed r2c slab and x pass, then the c2r: both on the register
    # core, back to the input
    x = _pair(shape, cuda_dev, seed=27)[0]
    ff.reset_counts()
    yr, yi = ff.rfft3d_planar(x, packed=True)
    back = ff.irfft3d_planar(yr, yi, packed=True)
    assert ff.irfft_slab_yz.reg_launches == ff.irfft_slab_yz.launches == 1
    assert ff.fft_x_to_padded.reg_launches == 1
    assert _rel(back.double(), x.double()) < 1e-6


# ---- the four-step pair's cores: register (columns + twiddle store; rows +
# transposing store) and dense ----------------------------------------------

def _pair_core(monkeypatch, dense):
    if dense:
        monkeypatch.setattr(ff, "_reg_core", lambda n: False)


# (B, n1, n2): the small case, the main path's splits (2^20, 8 x 2^20,
# 2^22, 2^24 on the 4096 column and step 3's clusters, and the inner 2^21
# of 3g's prime on step 1's half tile), few lanes at n1 = 4096, few rows
# at n2 = 4096, the mixed splits of 3 * 2^18
PAIR_SHAPES = [(3, 128, 256), (1, 1024, 1024), (8, 1024, 1024),
               (1, 2048, 2048), (1, 4096, 4096), (1, 1024, 2048),
               (1, 4096, 40), (3, 12, 4096), (1, 1024, 768), (1, 768, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", PAIR_SHAPES)
def test_cuda_step1_twiddle_cores(cuda_dev, monkeypatch, shape, inverse,
                                  dense):
    _pair_core(monkeypatch, dense)
    _, n1, n2 = shape
    _card_check(fs._step1_twiddle,
                lambda f, x: f(*x, n1, n2, None, inverse, scale=0.5),
                shape, cuda_dev)
    assert fs._step1_twiddle.reg_launches == int(ff._reg_core(n1))


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", PAIR_SHAPES)
def test_cuda_step3_transposed_cores(cuda_dev, monkeypatch, shape, inverse,
                                     dense):
    _pair_core(monkeypatch, dense)
    _, n1, n2 = shape
    _card_check(fs._step3_transposed,
                lambda f, x: f(*x, n1, n2, None, inverse), shape, cuda_dev)
    assert fs._step3_transposed.reg_launches == int(ff._reg_core(n2))


@pytest.mark.cuda
@pytest.mark.parametrize("dense", [False, True])
def test_cuda_step1_caller_table_cores(cuda_dev, monkeypatch, dense):
    # step12_planar's chunk of a distributed table: all scaling in it
    _pair_core(monkeypatch, dense)
    tw = torch.stack(_pair((1024, 200), cuda_dev, seed=8), -1)
    _card_check(fs._step1_twiddle,
                lambda f, x: f(*x, 1024, 200, None, True, tw=tw),
                (2, 1024, 200), cuda_dev)
    assert fs._step1_twiddle.reg_launches == int(not dense)


@pytest.mark.cuda
@pytest.mark.parametrize("n", REG_LENGTHS + [96, 320])
def test_cuda_pair_every_length(cuda_dev, n):
    # each register length on each side: step 1 over a ragged lane tile
    # (40 lanes), step 3 over 15 rows (R need not divide n1 = 5: a
    # block's rows span batches)
    _card_check(fs._step1_twiddle,
                lambda f, x: f(*x, n, 40, None, False, scale=0.25),
                (2, n, 40), cuda_dev)
    assert fs._step1_twiddle.reg_launches == int(ff._reg_core(n))
    _card_check(fs._step3_transposed,
                lambda f, x: f(*x, 5, n, None, True), (3, 5, n), cuda_dev)
    assert fs._step3_transposed.reg_launches == int(ff._reg_core(n))


@pytest.mark.cuda
@pytest.mark.parametrize("tile,lengths", [
    ("narrow", [16, 64, 128]), ("wide", [256, 512, 1024, 2048, 4096]),
    ("half", [512, 1024])])
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_step1_lane_tiles(cuda_dev, tile, lengths, inverse):
    for n in lengths:
        _card_check(fs._step1_twiddle,
                    lambda f, x: f(*x, n, 72, None, inverse,
                                   **({} if f is fs._step1_twiddle.plain
                                      else {"tile": tile})),
                    (2, n, 72), cuda_dev)


@pytest.mark.cuda
def test_cuda_pair_probe_refusals(cuda_dev):
    x = _pair((2, 1024, 64), cuda_dev)
    with pytest.raises(ValueError, match="tile"):
        fs._step1_twiddle(*x, 1024, 64, None, False, tile="square")
    for n in (256, 2048):                      # no half tile there
        with pytest.raises(RuntimeError):
            fs._step1_twiddle(*_pair((2, n, 64), cuda_dev), n, 64, None,
                              False, tile="half")


@pytest.mark.cuda
@pytest.mark.parametrize("n,radices", [(32768, (32, 32, 32)),
                                       (30720, (30, 32, 32)),
                                       (30720, (32, 30, 32))])
def test_cuda_long_lines_route_by_length(cuda_dev, n, radices):
    # a line past one block (three stages past about 29k points) runs the
    # pair on (rows, r0, n / r0), each kernel on the core its own length
    # takes: r0 = 30 runs step 1 dense, n / r0 = 960 step 3
    x = _pair((3, n), cuda_dev, seed=18)
    ff.reset_counts()
    got = ff.fft_last(*x, radices=radices, scale=0.5)
    torch.cuda.synchronize()
    r0 = radices[0]
    assert fs._step1_twiddle.launches == fs._step3_transposed.launches == 1
    assert fs._step1_twiddle.reg_launches == int(ff._reg_core(r0))
    assert fs._step3_transposed.reg_launches == int(ff._reg_core(n // r0))
    want = ff.fft_last.plain(*x, radices=radices, scale=0.5)
    for g, w in zip(got, want):
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-6


# ---- gradients through the plans: the backward path ------------------------

GRAD_PLANS = [
    # (shape, dtype, plan keywords)
    ((16, 32, 128), "complex64", {"planar": True, "norm": "ortho"}),
    ((16, 32, 128), "complex64", {"inverse": True}),
    ((1, 1, 2 ** 15), "complex64", {"planar": True}),
    ((8, 16, 256), "float32", {"real": True, "planar": True}),
    ((8, 16, 256), "float32", {"real": True, "planar": True,
                               "packed": True}),
    ((8, 16, 256), "float32", {"real": True, "planar": True,
                               "inverse": True}),
    ((8, 16, 256), "float32", {"real": True, "planar": True,
                               "inverse": True, "packed": True}),
    ((8, 8, 96), "float32", {"real": True, "inverse": True}),
    ((8, 8, 27), "float32", {"real": True, "inverse": True}),
]


def _grad_inputs(p, dev, seed):
    """Random inputs of a plan's calling convention on ``dev`` (a c2r's
    need not be Hermitian: its vjp is exact on every input)."""
    shp = p.in_shape
    if p.spec.real and not p.spec.inverse:
        return [_pair(shp, dev, seed)[0]]
    xs = list(_pair(shp, dev, seed))
    return xs if p.planar else [torch.complex(*xs)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,dtype,kw", GRAD_PLANS)
def test_cuda_plan_gradient_matches_the_cpu_plan(cuda_dev, shape, dtype, kw):
    """The vjp of a random cotangent through a plan on the card, against
    the same plan on the CPU (the kernels' plain versions, the same
    rules): the backward ran kernels only."""
    grads = []
    for dev in (cuda_dev, torch.device("cpu")):
        p = ot.plan(shape, dtype, device=dev, **kw)
        xs = [t.to(dev).requires_grad_() for t in _grad_inputs(p, cuda_dev,
                                                                 11)]
        y = p(*xs)
        ys = y if isinstance(y, tuple) else (y,)
        cts = [torch.randn(t.shape, dtype=t.dtype,
                           generator=torch.Generator().manual_seed(12 + i))
               .to(dev) for i, t in enumerate(ys)]
        ff.reset_counts()
        g = torch.autograd.grad(ys, xs, cts)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert sum(c[1] for c in ff.counts().values()) == 0
            assert sum(c[0] for c in ff.counts().values()) > 0
        grads.append([t.cpu() for t in g])
    for a, b in zip(*grads):
        assert _rel(a.to(b.dtype), b) < 1e-6


@pytest.mark.cuda
def test_cuda_jvp_vmap_and_grad_of_grad(cuda_dev):
    p = ot.plan((16, 32, 128), "complex64", planar=True, device=cuda_dev)
    x = _pair((16, 32, 128), cuda_dev, 13)
    t = _pair((16, 32, 128), cuda_dev, 14)
    _, (tr, ti) = torch.func.jvp(lambda a, b: p(a, b), x, t)
    want = torch.fft.fftn(torch.complex(t[0].double(), t[1].double()))
    assert _rel(torch.complex(tr.double(), ti.double()), want) < 1e-6
    xb = _pair((3, 16, 32, 128), cuda_dev, 15)
    yr, yi = torch.func.vmap(lambda a, b: p(a, b))(*xb)
    want = torch.fft.fftn(torch.complex(xb[0].double(), xb[1].double()),
                          dim=(-3, -2, -1))
    assert _rel(torch.complex(yr.double(), yi.double()), want) < 1e-6
    pc = ot.plan((16, 32, 128), "complex64", device=cuda_dev)
    z = torch.complex(*x).requires_grad_()
    g, = torch.autograd.grad(pc(z).abs().pow(2).sum(), z, create_graph=True)
    h, = torch.autograd.grad(g.abs().pow(2).sum(), z)
    z2 = z.detach().to(torch.complex128).requires_grad_()
    g2, = torch.autograd.grad(torch.fft.fftn(z2).abs().pow(2).sum(), z2,
                              create_graph=True)
    h2, = torch.autograd.grad(g2.abs().pow(2).sum(), z2)
    assert _rel(h.to(torch.complex128), h2) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("how", ["in_place", "donate"])
def test_cuda_in_place_under_autograd(cuda_dev, how):
    p = ot.plan((16, 32, 128), "complex64", planar=True, device=cuda_dev,
                **{how: True})
    a, b = (t.requires_grad_() for t in _pair((16, 32, 128), cuda_dev, 16))
    with pytest.raises(RuntimeError, match="leaf Variable"):
        p(a, b)
    a2, b2 = a * 1.0, b * 1.0
    yr, yi = p(a2, b2)
    assert yr is a2
    ga, gb = torch.autograd.grad(yr.pow(2).sum() + yi.sum(), (a, b))
    z = torch.complex(a.detach().double(), b.detach().double())
    z.requires_grad_()
    y = torch.fft.fftn(z)
    gz, = torch.autograd.grad(y.real.pow(2).sum() + y.imag.sum(), z)
    assert _rel(torch.complex(ga.double(), gb.double()), gz) < 1e-6


@pytest.mark.cuda
def test_cuda_one_rank_mesh_gradients(nccl_world):
    mesh = ot.make_mesh(1, 1)
    shape = (16, 32, 256)
    pf = ot.plan(shape, "float32", mesh=mesh, real=True, planar=True,
                 packed=True)
    pi = ot.plan(shape, "float32", mesh=mesh, real=True, inverse=True,
                 planar=True, packed=True)
    x = _pair(shape, nccl_world, 17)[0].requires_grad_()
    ff.reset_counts()
    yr, yi = pf(x)
    out = pi(yr, yi)
    g, = torch.autograd.grad(out.pow(2).sum(), x)
    torch.cuda.synchronize()
    assert sum(c[1] for c in ff.counts().values()) == 0
    assert _rel(g.double(), 2 * x.detach().double()) < 1e-6  # c2r(r2c) = I


# ---- the distributed long-1-D engine and the breakdowns ---------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2,p,rank", [(4096, 4096, 4, 1),
                                          (1024, 1024, 4, 1),
                                          (512, 512, 4, 3),
                                          (32, 128, 4, 2)])
@pytest.mark.parametrize("inverse", [False, True])
def test_cuda_fourstep_pair_at_shard_shapes(cuda_dev, n1, n2, p, rank,
                                            inverse):
    """The pair at the shapes one rank of a P-rank mesh computes: step 1
    on (1, n1, n2/P) with the rank's twiddle chunk, step 3 on (1, n1/P,
    n2), each against its plain version."""
    from offt_tpu_torch.kernels import tables as tb

    w = n2 // p
    tw = torch.from_numpy(tb.fourstep_twiddle_chunk(
        n1, n2, rank * w, (rank + 1) * w, inverse,
        1 / (n1 * n2) if inverse else 1.0).copy()).to(cuda_dev)
    _card_check(fs._step1_twiddle,
                lambda f, x: f(*x, n1, w, None, inverse, tw=tw),
                (1, n1, w), cuda_dev)
    _card_check(fs._step3_transposed,
                lambda f, x: f(*x, n1 // p, n2, None, inverse),
                (1, n1 // p, n2), cuda_dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 2 ** 20])
@pytest.mark.parametrize("real", [False, True])
def test_cuda_one_rank_long1d_engine(nccl_world, n, real):
    """The engine at P = 1 through ``_split=`` (its exchanges and hops
    groups of one) against complex128 torch.fft, both directions, the
    pair on the card and no plain version; a plan on the engine
    (``api._build(long1d_split=)``) and its adjoint by the transpose
    identity."""
    from offt_tpu_torch.dist import long1d
    from offt_tpu_torch.plan import api
    from offt_tpu_torch.plan.params import PlanParams

    mesh = ot.make_mesh(1, 1)
    prm = PlanParams(p1=1, use_pallas=1)
    m = n // 2 if real else n
    split = fs.pick_split(m)
    make = long1d.make_dist_rfft1d if real else long1d.make_dist_fft1d
    x = _pair((1, 1, n), nccl_world, 21)
    ff.reset_counts()
    if real:
        pr, pi = make(mesh, n, prm, False, _split=split)((x[0],))
        back = make(mesh, n, prm, True, _split=split)((pr, pi))[0]
        w = torch.fft.rfft(x[0].double())
        got = torch.complex(pr, pi).to(torch.complex128)
        edge = torch.zeros_like(got[..., :1])
        full = torch.cat([edge + got[..., :1].real, got[..., 1:],
                          edge + got[..., :1].imag], -1)
        assert _rel(full, w) < 1e-6
        assert _rel(back.double(), x[0].double()) < 1e-6
    else:
        for inverse in (False, True):
            yr, yi = make(mesh, n, prm, inverse, _split=split)(x)
            z = torch.complex(*x).to(torch.complex128)
            want = (torch.fft.ifft if inverse else torch.fft.fft)(z)
            assert _rel(torch.complex(yr, yi).to(torch.complex128),
                        want) < 1e-6
    torch.cuda.synchronize()
    counts = ff.counts()
    assert counts["_step1_twiddle"] == (2, 0)
    assert counts["_step3_transposed"] == (2, 0)
    assert sum(c[1] for c in counts.values()) == 0
    p = api._build((1, 1, n), "float32" if real else "complex64", mesh=mesh,
                   real=real, packed=real, planar=True, long1d_split=split)
    assert p.route == "long1d" and p._long1d.fused
    ins = (x[0].clone().requires_grad_(),) if real else tuple(
        t.clone().requires_grad_() for t in x)
    y = p(*ins)
    g = _pair(tuple(y[0].shape), nccl_world, 22)
    adj = torch.autograd.grad(y, ins, g)
    lhs = sum((u.detach().double() * v.double()).sum() for u, v in zip(y, g))
    rhs = sum((u.detach().double() * v.double()).sum()
              for u, v in zip(ins, adj))
    assert abs(float(lhs - rhs)) / float(abs(lhs)) < 1e-5


@pytest.mark.cuda
def test_cuda_namespace_on_a_one_rank_mesh(nccl_world):
    mesh = ot.make_mesh(1, 1)
    x = torch.complex(*_pair((1 << 16,), nccl_world, 23))
    c = torch.complex(*_pair((32, 32, 64), nccl_world, 24))
    with ot.fft.use_mesh(mesh):
        got = ot.fft.fft(x)
        got3 = ot.fft.fftn(c)
        r = ot.fft.irfftn(ot.fft.rfftn(c.real))
    assert ot.fft.current_mesh() is None
    assert _rel(got.to(torch.complex128),
                torch.fft.fft(x.to(torch.complex128))) < 1e-6
    assert _rel(got3.to(torch.complex128),
                torch.fft.fftn(c.to(torch.complex128))) < 1e-6
    assert _rel(r.double(), c.real.double()) < 1e-6


@pytest.mark.cuda
def test_cuda_breakdowns(nccl_world):
    from offt_tpu_torch.obs.profile import fft3d_breakdown, pencil_breakdown

    bd = fft3d_breakdown((32, 32, 64))
    assert set(bd) == {"fft_z", "fft_y", "fft_x", "total_fused",
                       "stage_sum", "fusion_gain"}
    assert all(v > 0 for k, v in bd.items() if k != "fusion_gain")
    pb = pencil_breakdown((32, 32, 64), ot.make_mesh(1, 1))
    assert all(pb[k] > 0 for k in ("fft_z", "exchange_1", "fft_y",
                                   "exchange_2", "fft_x", "total_fused"))
    assert abs(pb["stage_sum"] - pb["overlap_gain"] - pb["total_fused"]) \
        < 1e-12


@pytest.mark.cuda
def test_cuda_tune_split_1d(cuda_dev, tmp_path, monkeypatch):
    """A brute-force tune of (1, 1, 2^20) over split_1d on the card, timed by CUDA events: the winner, refined with the
    default point, is cached under plan()'s key, read back by plan() with
    no params, and within 1e-6 of complex128 torch.fft."""
    monkeypatch.setenv("OFFT_TPU_TORCH_CACHE_DIR", str(tmp_path))
    from offt_tpu_torch.tune import build_space
    from offt_tpu_torch.plan.params import ProblemSpec

    n = 2 ** 20
    space = build_space(ProblemSpec(shape=(1, 1, n)), device=cuda_dev)
    assert space.names == ("split_1d",)
    res = ot.tune.tune((1, 1, n), "complex64", strategy="brute",
                       max_trials=space.size(), device=cuda_dev,
                       log_path=str(tmp_path / "log.jsonl"))
    assert len([t for t in res.trials if t.status == "ok"]) == space.size()
    assert 0 < res.best_perf <= res.default_perf
    p = ot.plan((1, 1, n), "complex64", planar=True)
    assert p.params == res.best_params and p.params.use_pallas == 1
    xr, xi = _pair((1, 1, n), cuda_dev)
    yr, yi = p(xr, xi)
    want = torch.fft.fft(torch.complex(xr, xi).to(torch.complex128))
    got = torch.complex(yr, yi).to(torch.complex128)
    assert (torch.linalg.vector_norm(got - want)
            / torch.linalg.vector_norm(want)).item() < 1e-6


# ---- the probes of bench/: probe_mma and the r2c slab's wider tiles -------

# probe_mma against its plain version at R = 1 on the same inputs
# (max |k - p| / max |p|): the tensor cores sum each mma's products at
# their own alignment and the k-steps in their order, the plain matmul in
# another; fma's FMA chain against cuBLAS's SGEMM. TOL_MMA at c = 0.25,
# TOL_MMA_DFT on a 128-point DFT stage's products at c = 0, from the
# card's readings (chip_smoke.py states the same)
TOL_MMA = {"stack6": 1e-6, "stack6-six": 1e-6, "3xtf32": 1e-6,
           "tf32": 1e-6, "fma": 1e-6}
TOL_MMA_DFT = {"stack6": 2.5e-6, "stack6-six": 5e-7, "3xtf32": 2.5e-6,
               "tf32": 1.5e-6, "fma": 1e-6}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(TOL_MMA))
@pytest.mark.parametrize("lanes", [128, 1024])
def test_cuda_probe_mma(cuda_dev, variant, lanes):
    from offt_tpu_torch.bench import probe_mxuwidth as pm
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    x, g = pm.inputs(variant, sms, lanes, "cuda", seed=lanes)
    pm.reset_counts()
    got = pm.probe_mma(x, g, 1, variant)
    torch.cuda.synchronize()
    assert pm.probe_mma.launches[variant] == 1
    assert pm.probe_mma.plain_calls == 0
    want = pm.probe_mma.plain(x, g, 1, variant)
    assert torch.isfinite(got).all()
    assert ((got - want).abs().max() / want.abs().max()).item() \
        < TOL_MMA[variant]
    # R = 0 copies; a CUDA tensor never takes the plain version
    assert torch.equal(pm.probe_mma(x, g, 0, variant), x)
    assert pm.probe_mma.plain_calls == 0


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(TOL_MMA))
def test_cuda_probe_mma_dft_products(cuda_dev, variant):
    """At c = 0 on a 128-point DFT stage's four real products, where the
    low-order products are a larger share of the output, the kernel
    within TOL_MMA_DFT of its plain version."""
    from offt_tpu_torch.bench import probe_mxuwidth as pm
    for lanes in (128, 1024):
        draw = pm.dft_draw(lanes, lanes)
        for g, a in pm.dft_products(variant, draw, "cuda"):
            got = pm.probe_mma(a, g, 1, variant, 0.0)
            want = pm.probe_mma.plain(a, g, 1, variant, 0.0)
            assert ((got - want).abs().max() / want.abs().max()).item() \
                < TOL_MMA_DFT[variant]


@pytest.mark.cuda
def test_cuda_probe_mma_accuracy_rows(cuda_dev):
    """The error of a 128-point DFT stage by tier on the card, the largest
    of the draws: every variant within its ceiling, chained stack6 and
    3xtf32 included; fma and the six-accumulator stack6 within the 1e-6
    bar, tf32 far outside it."""
    from offt_tpu_torch.bench import probe_mxuwidth as pm
    rows = {r["variant"]: r["rel_err"] for r in pm.accuracy_rows("cuda")}
    for v in pm.VARIANTS:
        assert rows[v] <= pm.CEILING[v], (v, rows[v])
    assert rows["fma"] < 1e-6 and rows["stack6-six"] < 1e-6
    assert rows["tf32"] > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("code", ["y16", "y32", "grids_wide"])
def test_cuda_rslab_wide_tile_codes(cuda_dev, code):
    """The r2c slab's wider-tile cost probes write what the kernel writes,
    at 512^3's slab shape (Y = 512, M = 256), and refuse another."""
    x = _pair((3, 512, 512), cuda_dev, seed=31)[0]
    full = ff.rfft_slab_yz(x, zpad=8)
    got = ff.rfft_slab_yz(x, zpad=8, phases=code)
    for g, w in zip(got, full):
        g, w = g[..., :256], w[..., :256]
        assert ((g - w).abs().max() / w.abs().max()).item() < 1e-6
    with pytest.raises(RuntimeError):
        ff.rfft_slab_yz(_pair((2, 256, 256), cuda_dev)[0], phases=code)
