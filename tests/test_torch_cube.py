"""fused_fft.fft3d_cube (all three axes of batched planar cubes in one
launch) held against offt_tpu's pallas_fft.fft3d_cube and numpy.

On the CPU the wrapper runs its plain version (the kernel's own tables,
x, y then z); the reference runs its Pallas kernel in interpret mode.
Tolerance: 1e-6 relative norm against the reference (f32 on both sides,
the sums in other orders) and against complex128 numpy. The CUDA kernel
itself is held against the plain version in tests/test_torch_cuda.py.

The long-z cube (1, 8, 32768), whose three-stage z line does not fit one
block's shared memory and takes the kernel's split z phase on the card,
is held against numpy only: the reference's interpret-mode compile of a
three-stage z of 32768 takes over ten minutes on a CPU. A three-stage z
of 128 is held against the reference instead."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.kernels import fused_fft as ff

TOL = 1e-6


def rel_err(a, b):
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def _c64(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def _port(x, **kw):
    yr, yi = ff.fft3d_cube(torch.from_numpy(x.real.copy()),
                           torch.from_numpy(x.imag.copy()), **kw)
    return yr.numpy() + 1j * yi.numpy().astype(np.float64)


def _ref(x, **kw):
    yr, yi = pf.fft3d_cube(jnp.asarray(x.real), jnp.asarray(x.imag), **kw)
    return np.asarray(yr) + 1j * np.asarray(yi).astype(np.float64)


def _numpy(x, inverse, scale):
    f = np.fft.ifftn if inverse else np.fft.fftn
    return scale * f(x.astype(np.complex128), axes=(-3, -2, -1))


@pytest.mark.parametrize("precision", ["highest", "stack6"])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(2, 32, 32, 128), (16, 8, 128),
                                   (4, 8, 256)])
def test_cube_matches_reference(shape, inverse, precision):
    x = _c64(shape, sum(shape) + inverse)
    kw = {"inverse": inverse, "precision": precision, "out_scale": 0.5}
    ff.reset_counts()
    got = _port(x, **kw)
    assert ff.fft3d_cube.plain_calls == 1 and ff.fft3d_cube.launches == 0
    assert got.shape == shape
    assert rel_err(got, _ref(x, **kw)) < TOL
    assert rel_err(got, _numpy(x, inverse, 0.5)) < TOL


@pytest.mark.parametrize("inverse", [False, True])
def test_cube_three_stage_z_matches_reference(inverse):
    x = _c64((2, 8, 128), 3)
    kw = {"inverse": inverse, "rad_z": (4, 4, 8), "rad_y": (2, 4),
          "rad_x": (2,)}
    got = _port(x, **kw)
    assert rel_err(got, _ref(x, **kw)) < TOL
    assert rel_err(got, _numpy(x, inverse, 1.0)) < TOL


@pytest.mark.parametrize("inverse", [False, True])
def test_cube_long_z(inverse):
    # the largest z the gate admits: three stages of at most 32
    assert ff.can_fuse_cube(1, 8, 32768, rad_z=(32, 32, 32))
    x = _c64((1, 8, 32768), 4 + inverse)
    got = _port(x, inverse=inverse, rad_z=(32, 32, 32), out_scale=2.0)
    assert rel_err(got, _numpy(x, inverse, 2.0)) < TOL


def test_cube_round_trip_and_batch_dims():
    x = _c64((2, 3, 8, 8, 128), 6)
    y = _port(x)
    assert rel_err(y, _numpy(x, False, 1.0)) < TOL
    back = _port(y.astype(np.complex64), inverse=True)
    assert rel_err(back, x.astype(np.complex128)) < TOL


SHAPES = [(128, 128, 128), (256, 256, 256), (1, 8, 128), (2, 8, 128),
          (8, 8, 100), (8, 4, 128), (16, 128, 1024), (1, 8, 32768),
          (1, 8, 262144), (131, 8, 128), (4, 16, 16384), (8, 8, 128)]
RADICES = [(None, None, None), ((32, 32, 32), None, None),
           ((128,), (8,), (2, 4)), ((4, 4, 8), (2, 2, 2, 2), None),
           ((64, 2), (2, 4), (4, 2))]


@pytest.mark.parametrize("precision", ["highest", "stack6"])
@pytest.mark.parametrize("radices", RADICES)
def test_gate_matches_reference(radices, precision):
    rz, ry, rx = radices
    for shape in SHAPES:
        mine = ff.can_fuse_cube(*shape, rad_x=rx, rad_y=ry, rad_z=rz,
                                precision=precision)
        theirs = pf.can_fuse_cube(*shape, rad_x=rx, rad_y=ry, rad_z=rz,
                                  precision=precision)
        assert mine == theirs, (shape, radices, precision)


@pytest.mark.parametrize("shape,kw", [((32, 256, 512), {}),
                                      ((8, 8, 100), {}),
                                      ((8, 8, 128), {"rad_z": (4, 4, 4)})])
def test_refused_shapes_raise_in_both(shape, kw):
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match="not fusable"):
        ff.fft3d_cube(torch.from_numpy(x), torch.from_numpy(x), **kw)
    with pytest.raises(ValueError, match="not fusable"):
        pf.fft3d_cube(jnp.asarray(x), jnp.asarray(x), **kw)


def test_cube_meta_shapes_and_tables():
    # the shape-only run of a plan: outputs allocated, nothing computed;
    # the tables are built on the table set's device, a split z adds the
    # second sub-phase's core
    ts = ff.TableSet("cpu")
    xr = torch.empty((3, 1, 8, 32768), device="meta")
    yr, yi = ff.fft3d_cube(xr, xr, rad_z=(32, 32, 32), tables=ts)
    assert yr.shape == xr.shape and yr.device.type == "meta"
    cores = sorted(k[1] for k in ts.tabs if k[0] == "core")
    assert cores == [1, 8, 1024, 32768]
    assert ff.KERNELS["fft_cube"]["wrappers"] == ("fft3d_cube",)
    assert ff.KERNELS["fft_cube"]["replaces"].endswith("pallas_fft.py:1156")
