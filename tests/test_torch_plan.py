"""The slice through offt_tpu_torch.plan held against offt_tpu.plan.

Both packages get the same inputs and the same explicit radices; the
reference runs its Pallas kernels in interpret mode. The routes are held
against each other too: each package's kernel-wrapper calls are counted
and must agree."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import offt_tpu
import offt_tpu_torch as ot
from offt_tpu.kernels import pallas_fft as pf
from offt_tpu.plan.params import PlanParams as RefParams
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.plan import cache
from offt_tpu_torch.plan.params import PlanParams, from_reference

TOL_REF = 1e-5
TOL_NP = 1e-6

# shape -> (radix_x, radix_y, radix_z), given to both packages. Slab
# axes stay 1-stage in 3-D shapes: the reference's interpret-mode slab
# with a 2-stage y costs seconds per call (2-stage cores are covered by
# the x axes, the 2-D route and tests/test_torch_kernels.py).
SHAPES = {
    (16, 128, 128): ((4, 4), (128,), (128,)),     # stride gate: padded x
    (16, 32, 128): ((4, 4), (32,), (128,)),       # _sublane_nd x route
    (32, 32, 32): ((4, 8), (32,), (32,)),         # flattened sublane x
    (1, 32, 64): (None, (8, 4), (8, 8)),          # 2-D route
}
ROUTED = ("fft_last", "fft_sublane", "_sublane_nd", "fft_slab_yz",
          "fft_x_from_padded", "fft_x_to_padded", "rfft_slab_yz",
          "irfft_slab_yz", "_assemble_mp1")


def rel_err(a, b):
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def rand_c64(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture
def ref_routes(monkeypatch):
    """Counts the reference's kernel-wrapper calls while it traces."""
    calls = dict.fromkeys(ROUTED, 0)
    for name in ROUTED:
        orig = getattr(pf, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(pf, name, counted)
    return calls


def _launch_view(calls):
    """A reference fft_sublane that hands over to _sublane_nd is one
    kernel call, counted once, as the port counts it."""
    out = dict(calls)
    out["fft_sublane"] -= out["_sublane_nd"]
    return out


def _params(shape, pkg_params):
    rx, ry, rz = SHAPES[shape]
    return pkg_params(use_pallas=1, precision="highest", radix_x=rx,
                      radix_y=ry, radix_z=rz)


def _run_both(shape, x, routes, inverse=False, norm=None, in_place=False):
    rp = offt_tpu.plan(shape, "complex64", planar=True, inverse=inverse,
                       norm=norm, params=_params(shape, RefParams),
                       in_place=in_place)
    rr, ri = rp((x.real.copy(), x.imag.copy()))
    ref = np.asarray(rr) + 1j * np.asarray(ri)
    p = ot.plan(shape, "complex64", planar=True, inverse=inverse,
                norm=norm, params=_params(shape, PlanParams),
                in_place=in_place, device="cpu")
    xr = torch.from_numpy(x.real.copy())
    xi = torch.from_numpy(x.imag.copy())
    ff.reset_counts()
    yr, yi = p((xr, xi))
    # the wrappers of later slices join only if they ran
    port_calls = {k: v[1] for k, v in ff.counts().items()
                  if k in ROUTED or v[1]}
    assert all(v[0] == 0 for v in ff.counts().values())
    if in_place:
        assert yr is xr and yi is xi
    got = yr.numpy().astype(np.float64) + 1j * yi.numpy()
    assert port_calls == _launch_view(routes), (port_calls, routes)
    return got, ref


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("inverse", [False, True])
def test_plan_matches_reference(shape, inverse, ref_routes):
    x = rand_c64(shape, seed=sum(shape) + inverse)
    got, ref = _run_both(shape, x, ref_routes, inverse=inverse)
    f = np.fft.ifftn if inverse else np.fft.fftn
    assert rel_err(got, ref) < TOL_REF
    assert rel_err(got, f(x.astype(np.complex128))) < TOL_NP


@pytest.mark.parametrize("shape,norm", [((16, 128, 128), "ortho"),
                                        ((1, 32, 64), "forward")])
@pytest.mark.parametrize("inverse", [False, True])
def test_plan_norms(shape, norm, inverse, ref_routes):
    x = rand_c64(shape, seed=7)
    got, ref = _run_both(shape, x, ref_routes, inverse=inverse, norm=norm)
    f = np.fft.ifftn if inverse else np.fft.fftn
    assert rel_err(got, ref) < TOL_REF
    assert rel_err(got, f(x.astype(np.complex128), norm=norm)) < TOL_NP


@pytest.mark.parametrize("shape,inverse", [((16, 128, 128), False),
                                           ((32, 32, 32), True)])
def test_plan_in_place(shape, inverse, ref_routes):
    x = rand_c64(shape, seed=3)
    got, ref = _run_both(shape, x, ref_routes, inverse=inverse,
                         in_place=True)
    f = np.fft.ifftn if inverse else np.fft.fftn
    assert rel_err(got, ref) < TOL_REF
    assert rel_err(got, f(x.astype(np.complex128))) < TOL_NP


@pytest.mark.parametrize("inverse", [False, True])
def test_plan_in_place_2d(inverse):
    # the reference refuses this one: its aliased fft_last needs a batch
    # that is a multiple of its 128-row block; the port masks the edge
    x = rand_c64((1, 32, 64), seed=5)
    p = ot.plan((1, 32, 64), "complex64", planar=True, inverse=inverse,
                in_place=True, norm="ortho", device="cpu")
    xr, xi = torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy())
    yr, yi = p(xr, xi)
    assert yr is xr
    f = np.fft.ifftn if inverse else np.fft.fftn
    got = yr.numpy() + 1j * yi.numpy()
    assert rel_err(got, f(x.astype(np.complex128), norm="ortho")) < TOL_NP


def test_batched_complex_api():
    x = rand_c64((2, 3, 8, 16, 16), seed=21)
    y = ot.fft3d(torch.from_numpy(x))
    assert y.dtype == torch.complex64 and y.shape == x.shape
    want = np.fft.fftn(x.astype(np.complex128), axes=(-3, -2, -1))
    assert rel_err(y.numpy(), want) < TOL_NP
    back = ot.ifft3d(y)
    assert rel_err(back.numpy(), x) < TOL_NP
    re, im = ot.to_planar(torch.from_numpy(x))
    assert torch.equal(ot.from_planar(re, im), torch.from_numpy(x))


def test_plan_is_a_module_with_table_buffers():
    p = ot.plan((16, 32, 128), "complex64", planar=True, device="cpu")
    assert isinstance(p, torch.nn.Module)
    bufs = dict(p.named_buffers())
    tabs = [k for k in bufs if k.startswith("table")]
    assert len(tabs) == 3           # z, y (the slab) and x
    assert all(bufs[k].dtype == torch.float32 for k in tabs)
    assert set(tabs) <= set(p.state_dict())
    assert p.device == torch.device("cpu")
    with pytest.raises(ValueError):
        p((torch.zeros(16, 32, 64), torch.zeros(16, 32, 64)))
    # a tensor that requires grad runs the plan's autograd Function (it
    # raised while plans ran forward only; tests/test_torch_autodiff.py)
    yr, yi = p(torch.zeros(16, 32, 128, requires_grad=True),
               torch.zeros(16, 32, 128))
    assert type(yr.grad_fn).__name__ == "C2CPlanarBackward"


def test_plan_refuses_what_is_not_ported():
    # real=True and split_1d are ported: the axis-by-axis route
    # (tests/test_torch_local_plan.py); split_1d fits (1, 1, N) c2c only.
    # A mesh is ported (tests/test_torch_pencil*.py): it needs a process
    # group, and batch_sharded needs a mesh. use_pallas=0, complex128 and
    # a prime past 128 take the unfused engine on the axis-by-axis route
    # (tests/test_torch_stockham.py)
    # donate=True is accepted (it raised before): a plan without an
    # in-place form changes nothing; the planar c2c kernel route runs in
    # place (tests/test_torch_autodiff.py)
    assert not ot.plan((8, 8, 8), "complex64", device="cpu",
                       donate=True).in_place
    assert ot.plan((8, 8, 8), "complex64", device="cpu", planar=True,
                   donate=True).in_place
    assert ot.plan((8, 8, 8), "complex64", device="cpu",
                   params=PlanParams(use_pallas=0)).route == "local"
    with pytest.raises(RuntimeError, match="process group"):
        ot.plan((8, 8, 8), "complex64", device="cpu", mesh=object())
    with pytest.raises(ValueError, match="batch_sharded"):
        ot.plan((8, 8, 8), "complex64", device="cpu", batch_sharded=True,
                batch_dims=1)
    assert ot.plan((8, 8, 8), "complex64", real=True,
                   device="cpu").route == "local"
    with pytest.raises(ValueError):
        ot.plan((8, 8, 8), "complex64", device="cpu",
                params=PlanParams(use_pallas=1, split_1d=(8, 8)))
    assert ot.plan((8, 8, 8), "complex128", device="cpu").route == "local"
    assert ot.plan((131, 8, 8), "complex64", device="cpu").route == "local"
    with pytest.raises(ValueError):
        ot.plan((8, 8, 8), "float16", device="cpu")
    with pytest.raises(ValueError):
        ot.plan((8, 8, 8), "complex64", norm="bogus", device="cpu")
    with pytest.raises(ValueError):
        ot.plan((8, 8, 8), "complex64", device="cpu",
                params=PlanParams(use_pallas=1, radix_x=(4, 4)))
    with pytest.raises(ValueError):
        ot.plan((8, 8, 8), "complex64", in_place=True, device="cpu")
    with pytest.raises(ValueError):     # packed is a layout of real plans
        ot.plan((8, 8, 8), "complex64", packed=True, device="cpu")


def test_plan_reads_the_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("OFFT_TPU_TORCH_CACHE_DIR", str(tmp_path))
    ref = RefParams(use_pallas=1, radix_x=(2, 8), radix_y=(4, 4),
                    radix_z=(16,), precision="stack6")
    mine = from_reference(dataclasses.asdict(ref))
    key = cache.plan_key((16, 16, 16), "complex64", False, 1, 1, "cpu")
    cache.store(key, mine)
    p = ot.plan((16, 16, 16), "complex64", planar=True, device="cpu")
    assert p.params == mine
    x = rand_c64((16, 16, 16), seed=2)
    yr, yi = p((torch.from_numpy(x.real.copy()),
                torch.from_numpy(x.imag.copy())))
    got = yr.numpy() + 1j * yi.numpy()
    assert rel_err(got, np.fft.fftn(x.astype(np.complex128))) < TOL_NP
    q = ot.plan((16, 16, 16), "complex64", device="cpu", use_cache=False)
    assert q.params != mine and q.params.use_pallas == 1


@pytest.mark.parametrize("shape,dtype,kw", [
    ((16, 32, 128), "complex64", {"planar": True, "norm": "ortho"}),
    ((16, 32, 128), "complex64", {"planar": True, "inverse": True}),
    ((8, 16, 256), "float32", {"real": True, "planar": True}),
    ((8, 16, 256), "float32", {"real": True, "planar": True,
                               "inverse": True, "norm": "ortho"}),
    ((8, 16, 256), "float32", {"real": True, "planar": True, "packed": True,
                               "inverse": True}),
    ((4, 6, 1009), "complex64", {"norm": "forward"}),
    ((4, 6, 9), "float64", {"real": True, "inverse": True}),
    ((8, 8, 32768), "complex64", {"planar": True, "inverse": True,
                                  "params": PlanParams(
                                      use_pallas=1, radix_z=(32, 32, 32))}),
])
def test_dry_run_registers_every_table(shape, dtype, kw):
    # the meta-device dry run must build every table the real run reads,
    # so that all of them are buffers and none is rebuilt per call
    p = ot.plan(shape, dtype, device="cpu", **kw)
    rdt = torch.float64 if dtype == "float64" else torch.float32
    xs = [torch.zeros(p.in_shape, dtype=rdt)
          for _ in range(p._n_inputs)]
    ts = p._tables()
    p._run(xs, ts)
    assert set(ts.tabs) == set(p._keys)


@pytest.fixture
def plan_builds(monkeypatch):
    """The one-shot cache emptied, and a list that records every plan
    the one-shot entry points build (through ``api._build``, plan()'s
    body)."""
    from offt_tpu_torch.plan import api
    monkeypatch.setattr(api, "_ONE_SHOT", type(api._ONE_SHOT)())
    calls = []
    build = api._build

    def counting(shape, dtype, **kw):
        calls.append((tuple(shape), kw.get("norm"), kw["device"]))
        return build(shape, dtype, **kw)
    monkeypatch.setattr(api, "_build", counting)
    return calls


def test_one_shot_calls_reuse_their_plan(plan_builds):
    x = torch.from_numpy(rand_c64((2, 8, 16, 16), seed=31))
    want = np.fft.fftn(x.numpy().astype(np.complex128), axes=(-3, -2, -1))
    y1 = ot.fft3d(x)
    assert len(plan_builds) == 1
    y2 = ot.fft3d(x.clone())
    assert len(plan_builds) == 1      # the same signature: no new plan
    assert torch.equal(y1, y2) and rel_err(y1.numpy(), want) < TOL_NP
    back = ot.ifft3d(y1)
    assert len(plan_builds) == 2      # the inverse is a signature of its own
    ot.ifft3d(y2)
    assert len(plan_builds) == 2
    assert rel_err(back.numpy(), x.numpy()) < TOL_NP


def test_one_shot_signatures_do_not_share_plans(plan_builds):
    x = torch.from_numpy(rand_c64((8, 16, 16), seed=32))
    ref = x.numpy().astype(np.complex128)
    for norm in (None, "ortho", "forward"):
        y = ot.fft3d(x, norm=norm)
        assert rel_err(y.numpy(), np.fft.fftn(ref, norm=norm)) < TOL_NP
    assert [c[1] for c in plan_builds] == [None, "ortho", "forward"]
    ot.fft3d(x, norm="ortho")
    ot.fft3d(x.reshape(1, 8, 16, 16))                  # batch dims differ
    ot.fft3d(x.to(torch.complex128))                   # dtype differs
    ot.fft3d(x, params=PlanParams(use_pallas=0))       # params differ
    ot.fft3d(x, params=PlanParams(use_pallas=0))
    assert len(plan_builds) == 6
    from offt_tpu_torch.plan import api
    key = functools.partial(api._one_shot_key, (8, 16, 16), torch.complex64,
                            False, 0)
    cpu, card = key("cpu", None, None, {}), key("cuda:0", None, None, {})
    assert cpu != card and hash(cpu) != hash(card)
    assert key("cpu", None, None, {}) == cpu
    assert key("cpu", None, None, {"norm": "ortho"}) != cpu
    mesh_a, mesh_b = object(), object()
    assert key("cpu", mesh_a, None, {}) == key("cpu", mesh_a, None, {})
    assert key("cpu", mesh_a, None, {}) != key("cpu", mesh_b, None, {})
    assert (key("cpu", None, PlanParams(radix_z=(4, 4)), {})
            == key("cpu", None, PlanParams(radix_z=[4, 4]), {}))
