"""offt_tpu_torch.fft on a mesh (``use_mesh``) held against offt_tpu.fft
on a mesh of the same shape, and numpy.

One spawned gloo world of 4 CPU ranks (tests/torch_world.py): every rank
makes the same namespace calls on the same global tensors, under a
``with use_mesh(make_mesh(2, 2))`` block and under the bare sticky setter
on a (1, 4) mesh, and saves the global results; the parent checks that
every rank got the same result and holds it against ``offt_tpu.fft``
under ``use_mesh`` on ``jax.devices()[:4]`` and against numpy (1e-6;
gradients 1e-5). In process: the rule for exits that do not nest
(ADVICE.md's interleaved sequence), where the reference differs. JAX is
imported only inside the tests' functions, so the spawned ranks never
load it."""

import datetime
import os
import types
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_world as tw


def _data():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(4096)
         + 1j * rng.standard_normal(4096)).astype(np.complex64)
    c = (rng.standard_normal((16, 16, 16))
         + 1j * rng.standard_normal((16, 16, 16))).astype(np.complex64)
    r = rng.standard_normal((16, 16, 16)).astype(np.float32)
    s = rng.standard_normal(4096).astype(np.float32)
    b = (rng.standard_normal((3, 8, 32))
         + 1j * rng.standard_normal((3, 8, 32))).astype(np.complex64)
    w = rng.uniform(0.5, 1.5, 4096)
    return dict(x=x, c=c, r=r, s=s, b=b, w=w)


# label: (mesh, the call on the namespace module F and the data d)
CALLS = {
    "fft 4096": ((2, 2), lambda F, d: F.fft(d["x"])),
    "ifft ortho round trip": ((2, 2), lambda F, d: F.ifft(
        F.fft(d["x"], norm="ortho"), norm="ortho")),
    "ifft 4096": ((2, 2), lambda F, d: F.ifft(d["x"])),
    "fftn 16^3": ((2, 2), lambda F, d: F.fftn(d["c"])),
    "ifftn 16^3 forward": ((2, 2), lambda F, d: F.ifftn(d["c"],
                                                        norm="forward")),
    "rfftn 16^3": ((2, 2), lambda F, d: F.rfftn(d["r"])),
    "irfftn 16^3": ((2, 2), lambda F, d: F.irfftn(F.rfftn(d["r"]))),
    "rfft 4096 (pencil)": ((2, 2), lambda F, d: F.rfft(d["s"])),
    "fft2 (3, 8, 32)": ((2, 2), lambda F, d: F.fft2(d["b"])),
    "fft 4096 sticky": ((1, 4), lambda F, d: F.fft(d["x"])),
    "fft2 (3, 8, 32) sticky": ((1, 4), lambda F, d: F.fft2(d["b"])),
}

NUMPY = {
    "fft 4096": lambda d: np.fft.fft(d["x"]),
    "ifft ortho round trip": lambda d: d["x"],
    "ifft 4096": lambda d: np.fft.ifft(d["x"]),
    "fftn 16^3": lambda d: np.fft.fftn(d["c"]),
    "ifftn 16^3 forward": lambda d: np.fft.ifftn(d["c"], norm="forward"),
    "rfftn 16^3": lambda d: np.fft.rfftn(d["r"]),
    "irfftn 16^3": lambda d: d["r"],
    "rfft 4096 (pencil)": lambda d: np.fft.rfft(d["s"]),
    "fft2 (3, 8, 32)": lambda d: np.fft.fft2(d["b"]),
    "fft 4096 sticky": lambda d: np.fft.fft(d["x"]),
    "fft2 (3, 8, 32) sticky": lambda d: np.fft.fft2(d["b"]),
}


def _worker(rank, outdir):
    import offt_tpu_torch.fft as F
    from offt_tpu_torch.dist import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(outdir, 'store')}",
        rank=rank, world_size=tw.WORLD,
        timeout=datetime.timedelta(seconds=120))
    try:
        d = {k: torch.from_numpy(v) for k, v in _data().items()}
        out, info = {}, {}
        m22 = make_mesh(2, 2, device_type="cpu")
        m14 = make_mesh(1, 4, device_type="cpu")
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            with F.use_mesh(m22):
                for label, (mesh, call) in CALLS.items():
                    if mesh == (2, 2):
                        out[label] = call(F, d).numpy()
                p = F._plan_for((1, 1, 4096), torch.complex64, False, False,
                                None, 0, torch.device("cpu"))
                info["route"] = p.route
                info["mesh_is"] = p.mesh is m22
                # the gradient of sum(w |fft(x)|^2) on every rank
                xr = d["x"].real.clone().requires_grad_()
                xi = d["x"].imag.clone().requires_grad_()
                y = F.fft(torch.complex(xr, xi))
                loss = (d["w"] * y.abs() ** 2).sum()
                gr, gi = torch.autograd.grad(loss, (xr, xi))
                out["grad"] = gr.numpy() + 1j * gi.numpy()
            info["after_with"] = F.current_mesh() is None
            info["plan_after"] = F._plan_for(
                (1, 1, 4096), torch.complex64, False, False, None, 0,
                torch.device("cpu")).mesh is None
        info["warned"] = sorted({str(w.message) for w in seen
                                 if w.category is UserWarning})
        F.use_mesh(m14)                     # the sticky setter
        try:
            info["sticky"] = F.current_mesh() is m14
            for label, (mesh, call) in CALLS.items():
                if mesh == (1, 4):
                    out[label] = call(F, d).numpy()
        finally:
            F.use_mesh(None)
        info["after_setter"] = F.current_mesh() is None
        np.savez(os.path.join(outdir, f"{rank}.npz"), info=np.array(
            [repr(sorted(info.items()))]), **{
                k.replace(" ", "_"): v for k, v in out.items()})
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("npfft_mesh")
    tw.spawn(_worker, out)
    return [dict(np.load(os.path.join(out, f"{r}.npz")))
            for r in range(tw.WORLD)]


def _reference(label):
    """offt_tpu.fft's result of the call under its use_mesh on a mesh of
    the same shape over jax.devices()[:4]."""
    import jax

    import offt_tpu.fft as RF
    from offt_tpu.dist import make_mesh

    mesh, call = CALLS[label]
    m = make_mesh(*mesh, devices=jax.devices()[:4])
    d = _data()
    if "sticky" in label:
        RF.use_mesh(m)
        try:
            return np.asarray(call(RF, d))
        finally:
            RF.use_mesh(None)
    with RF.use_mesh(m):
        return np.asarray(call(RF, d))


@pytest.mark.parametrize("label", list(CALLS))
def test_namespace_on_a_mesh_matches_the_reference(world, label):
    key = label.replace(" ", "_")
    got = world[0][key]
    for r in range(1, tw.WORLD):        # every rank holds the same result
        assert np.array_equal(world[r][key], got)
    want = NUMPY[label](_data())
    ref = _reference(label)
    assert got.shape == want.shape == ref.shape
    assert tw.rel_err(got, want) < 1e-6
    assert tw.rel_err(got, ref) < 1e-6


def test_use_mesh_routes_and_restores(world):
    info = dict(eval(str(world[0]["info"][0])))
    assert info == dict(eval(str(world[1]["info"][0])))
    # the 1-D c2c plan in the block rides the long-1-D engine on the mesh
    # itself; the numpy-layout rfft takes the pencil engine and says so
    assert info["route"] == "long1d" and info["mesh_is"]
    assert info["after_with"] and info["plan_after"]
    assert info["sticky"] and info["after_setter"]
    assert len(info["warned"]) == 1
    assert "(1, 1, 4096)" in info["warned"][0]
    assert "numpy layout" in info["warned"][0]


def test_gradient_on_a_mesh(world):
    d = _data()
    x = d["x"].astype(np.complex128)
    want = 2 * len(x) * np.fft.ifft(d["w"] * np.fft.fft(x))
    for r in range(tw.WORLD):
        assert tw.rel_err(world[r]["grad"], want) < 1e-5


def test_exits_that_do_not_nest():
    """a = use_mesh(m); b = use_mesh(None); a.__exit__(); b.__exit__()
    leaves no mesh in the port: each exit closes its own layer. The
    reference restores the mesh each instance replaced, so the same
    sequence leaves m set there (ADVICE.md; its ``_MESH``)."""
    import offt_tpu.fft as RF

    import offt_tpu_torch.fft as F

    m = types.SimpleNamespace(mesh_dim_names=("row", "col"))
    kept = F._LAYERS[:]         # layers another test's setter left open
    F._LAYERS.clear()
    a = F.use_mesh(m)
    assert F.current_mesh() is m
    b = F.use_mesh(None)
    assert F.current_mesh() is None
    a.__exit__(None, None, None)
    assert F.current_mesh() is None
    b.__exit__(None, None, None)
    assert F.current_mesh() is None and not F._LAYERS
    # nested blocks restore in order; the sticky setter stays under them
    F.use_mesh(m)
    with F.use_mesh(None):
        assert F.current_mesh() is None
    assert F.current_mesh() is m
    F.use_mesh(None)
    assert F.current_mesh() is None
    F._LAYERS[:] = kept

    ra = RF.use_mesh(m)
    rb = RF.use_mesh(None)
    ra.__exit__(None, None, None)
    rb.__exit__(None, None, None)
    try:
        assert RF._MESH is m            # the reference's stale mesh
    finally:
        RF._MESH = None
    with pytest.raises(ValueError, match="multi-slice"):
        F.use_mesh(types.SimpleNamespace(
            mesh_dim_names=("slice", "row", "col")))
