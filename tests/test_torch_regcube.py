"""The register cube (``csrc/fft_cube_regs.cu``, ``fused_fft.fft3d_cube``
where ``fused_fft._reg_cube`` holds), on the CPU.

No CPU runs that kernel, so :func:`regcore.fft_cube` replays it as its
cooperative grid runs: G cubes a phase (``fused_fft._cube_group``), z
first as rows or, past 4096 (or forced by ``split=``), step 1 of the
four-step pair at n1 and step 3 at n2 written transposed, then y on the
column variant at stride Z and x at stride Y Z with the scale at its
store (an axis under 16 a thread a line).
These tests hold the replay against complex128 ``numpy.fft.fftn`` and
against the reference's ``pallas_fft.fft3d_cube`` in interpret mode, on
inputs made by numpy from a seed. Tolerance: 1e-6, the norm of the
difference over the reference's (f32 on both sides, the sums in other
orders). They also pin the routing predicate over the gate's shapes, the
group and barrier arithmetic, and the C call the wrapper makes (read with
``fused_fft._launch`` monkeypatched). The kernel against its plain
version on the card is ``tests/test_torch_cuda.py``'s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.kernels import regcore as rc

TOL = 1e-6
TABLES = ff.TableSet("cpu")


def rel_err(a, b):
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def c128(shape, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


def replay(x, inverse=False, out_scale=1.0, **kw):
    nx, ny, nz = x.shape[-3:]
    scale = out_scale * ((1.0 / (nx * ny * nz)) if inverse else 1.0)
    yr, yi = rc.fft_cube(torch.from_numpy(x.real.astype(np.float32)),
                         torch.from_numpy(x.imag.astype(np.float32)), TABLES,
                         inverse, scale, **kw)
    return yr.numpy() + 1j * yi.numpy().astype(np.float64)


def numpy_cube(x, inverse, out_scale=1.0):
    f = np.fft.ifftn if inverse else np.fft.fftn
    return out_scale * f(x, axes=(-3, -2, -1))


@pytest.mark.parametrize("inverse,out_scale", [(False, 1.0), (True, 1.0),
                                               (False, 0.5), (True, 2.0)])
@pytest.mark.parametrize("shape", [(2, 16, 16, 128), (3, 8, 16, 256),
                                   (2, 3, 16, 128), (1, 12, 8, 256)])
def test_replay_matches_numpy(shape, inverse, out_scale):
    # x of 8, 3 and 12 (and y of 8): a thread a line
    x = c128(shape, sum(shape) + inverse)
    got = replay(x, inverse, out_scale)
    assert got.shape == shape
    assert rel_err(got, numpy_cube(x, inverse, out_scale)) < TOL


@pytest.mark.parametrize("shape,split,inverse", [
    ((1, 8, 16, 4096), (64, 64), False),     # forced at a short z
    ((1, 8, 16, 4096), (16, 256), True),
    ((2, 16, 8, 4096), (128, 32), False),
    ((1, 8, 8, 8192), None, True),           # the route's own: (64, 128)
    ((3, 5, 8, 4096), (64, 64), True)])      # x of 5, a thread a line
def test_replay_split_z_matches_numpy(shape, split, inverse):
    x = c128(shape, 7)
    got = replay(x, inverse, 0.5, split=split)
    assert rel_err(got, numpy_cube(x, inverse, 0.5)) < TOL


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", range(1, 16))
def test_replay_short_x_matches_numpy(n, inverse):
    # every x under 16 the register cube takes: one thread a line, its
    # sums on the first n rows of the core table of n (W_n^(j k mod n))
    x = c128((2, n, 8, 128), 40 + n)
    got = replay(x, inverse, 3.0)
    assert rel_err(got, numpy_cube(x, inverse, 3.0)) < TOL


def test_replay_groups_do_not_change_values():
    # a group is a walk of the batch: G = 1, 2 or all cubes a phase
    x = c128((3, 16, 8, 128), 5)
    want = replay(x, True)
    for g in (1, 2):
        assert np.array_equal(replay(x, True, group=g), want)


@pytest.mark.parametrize("inverse", [False, True])
def test_replay_matches_reference(inverse):
    x = c128((2, 16, 16, 128), 11).astype(np.complex64)
    yr, yi = pf.fft3d_cube(jnp.asarray(x.real), jnp.asarray(x.imag),
                           inverse=inverse, out_scale=0.5)
    ref = np.asarray(yr) + 1j * np.asarray(yi).astype(np.float64)
    assert rel_err(replay(x.astype(np.complex128), inverse, 0.5), ref) < TOL


# (X, Y, Z, extra gate radices, register cube?)
GATE = [
    ((128, 128, 128), None, True),
    ((64, 64, 128), None, True),
    ((16, 8, 128), None, True),          # y under 16: a thread a line
    ((3, 8, 256), None, True),           # x under 16
    ((1, 8, 128), None, True),
    ((8, 8, 32768), (32, 32, 32), True),  # the split z
    ((16, 8, 16384), None, True),
    ((8, 16, 8192), None, True),
    ((2, 1024, 1024), None, True),
    ((16, 24, 128), None, False),        # mixed lengths keep the dense kernel
    ((16, 40, 128), None, False),
    ((16, 96, 128), None, False),
    ((8, 8, 384), None, False),
    ((8, 8, 640), None, False),
    ((24, 16, 128), None, False),
    ((16, 16, 6144), None, False),
    ((2, 8192, 128), None, False),       # y past 4096
]


@pytest.mark.parametrize("dims,rad_z,reg", GATE)
def test_reg_cube_routes(dims, rad_z, reg):
    assert ff.can_fuse_cube(*dims, rad_z=rad_z)
    assert ff._reg_cube(*dims) == reg


@pytest.mark.parametrize("b,dims,g,split,barriers", [
    (8, (128, 128, 128), 1, None, 16),        # 16 MiB a cube
    (1, (8, 8, 32768), 1, (128, 256), 3),     # one cube of 2^21
    (4, (64, 64, 128), 4, None, 2),           # 4 MiB a cube: G = 4
    (64, (16, 16, 128), 64, None, 2),         # G = 64
    (8, (8, 16, 8192), 2, (64, 128), 12),     # 8 MiB a cube: G = 2
    (5, (8, 16, 16384), 1, (128, 128), 15),
    (9, (32, 32, 1024), 2, None, 10),         # 8 MiB a cube: G = 2, given
])
def test_cube_group_and_barriers(b, dims, g, split, barriers):
    geo = rc.cube_geometry(b, *dims, group=2 if b == 9 else None)
    assert geo["G"] == g and geo["split"] == split
    assert geo["barriers"] == barriers
    assert geo["groups"] == -(-b // g)


def test_cube_group_arithmetic():
    budget = ff._CUBE_L2_BUDGET
    assert budget == 16 << 20
    assert ff._cube_group(128, 128, 128) == 1
    assert ff._cube_group(64, 64, 128) == budget // (8 << 19) == 4
    assert ff._cube_group(32, 32, 128) == 16
    assert ff._cube_group(16, 16, 128) == 64
    assert ff._cube_group(128, 128, 128, budget=64 << 20) == 4
    assert ff._cube_group(128, 128, 128, budget=1) == 1
    # two a group, three with the split; none between groups
    assert ff._cube_barriers(8, 1, False) == 16
    assert ff._cube_barriers(8, 1, True) == 24
    assert ff._cube_barriers(8, 3, True) == 9
    assert ff._cube_barriers(1, 1, True) == 3


def test_cube_split_rejects_bad_splits():
    assert rc.cube_split(4096) is None
    assert rc.cube_split(32768) == (128, 256)
    for sp in ((64, 32), (8, 512), (4096 * 2, 1)):
        with pytest.raises(ValueError, match="split"):
            rc.cube_split(4096, sp)


# ---- the wrapper's C call ------------------------------------------------

def _launches(monkeypatch):
    """Record each C entry point's name, tables and arguments instead of
    calling it, so the kernel route runs on CPU tensors."""
    calls = []
    monkeypatch.setattr(ff, "_launch", lambda entry, tensors, tabs, args:
                        calls.append((entry, tensors, tabs, args)))
    return calls


@pytest.mark.parametrize("shape,kw,group,split", [
    ((8, 128, 128, 128), {}, 1, None),
    ((2, 16, 8, 128), {"inverse": True, "out_scale": 0.5}, 2, None),
    ((8, 8, 32768), {"rad_z": (32, 32, 32)}, 1, (128, 256)),
    ((3, 16, 8, 16384), {"inverse": True}, 1, (128, 128)),
    ((4, 5, 32, 4096), {}, 3, None)])        # 5 MiB a cube: G = 3
def test_wrapper_launches_the_register_cube(monkeypatch, shape, kw, group,
                                            split):
    calls = _launches(monkeypatch)
    x = torch.zeros(shape)
    ff.reset_counts()
    ff.fft3d_cube.impl("kernel", x, x, **kw)
    (entry, tensors, tabs, args), = calls
    nx, ny, nz = shape[-3:]
    b = x.numel() // (nx * ny * nz)
    assert entry == "offt_fft_cube_regs"
    assert ff.fft3d_cube.reg_launches == ff.fft3d_cube.launches == 1
    assert args[:7] == [b, nx, ny, nz, *(split or (0, 0)), group]
    inverse = kw.get("inverse", False)
    scale = kw.get("out_scale", 1.0) / (nx * ny * nz if inverse else 1)
    assert args[7] == int(inverse) and args[8] == pytest.approx(scale)
    sr, si = tensors[4:]
    if split:
        n1, n2 = split
        assert sr.numel() == si.numel() == group * nx * ny * nz
        assert tuple(tabs[4].shape) == (n1, n2, 2)
        want = ff.TableSet("cpu").get("fourstep", n1, n2, inverse, 1.0)
        assert torch.equal(tabs[4], want)
    else:
        assert sr is None and tabs[3] is None and tabs[4] is None
        assert tabs[2].shape[0] >= nz
    last = ff.fft3d_cube.last
    assert last["group"] == group and last["split"] == split
    assert last["barriers"] == ff._cube_barriers(b, group, bool(split))


@pytest.mark.parametrize("shape", [(2, 16, 24, 128), (8, 8, 384),
                                   (2, 2, 8192, 128)])
def test_wrapper_keeps_the_dense_kernel_for_mixed_lengths(monkeypatch,
                                                          shape):
    calls = _launches(monkeypatch)
    x = torch.zeros(shape)
    ff.reset_counts()
    ff.fft3d_cube.impl("kernel", x, x)
    (entry, *_), = calls
    assert entry == "offt_fft_cube"
    assert ff.fft3d_cube.launches == 1 and ff.fft3d_cube.reg_launches == 0


def test_wrapper_rejects_a_bad_group_and_probes_off_the_card(monkeypatch):
    calls = _launches(monkeypatch)
    x = torch.zeros((2, 16, 16, 128))
    # G is the wrapper's own (_cube_group), not an option
    with pytest.raises(TypeError, match="group"):
        ff.fft3d_cube(x, x, group=2)
    # the phase probes run the register cube on a CUDA device only
    with pytest.raises(ValueError, match="phases"):
        ff.fft3d_cube(x, x, phases="z")
    y = torch.zeros((2, 16, 24, 128))
    with pytest.raises(ValueError, match="phases"):
        ff.fft3d_cube.impl("kernel", y, y, phases="zy")
    # named phases only; step 1 alone only where z is split
    for bad in (2, "zonly"):
        with pytest.raises(ValueError, match="phases"):
            ff.fft3d_cube.impl("kernel", x, x, phases=bad)
    with pytest.raises(ValueError, match="step1"):
        ff.fft3d_cube.impl("kernel", x, x, phases="step1")
    assert not calls


def test_wrapper_passes_the_phase_probe(monkeypatch):
    # the C codes of csrc/fft_cube_regs.cu
    calls = _launches(monkeypatch)
    for shape, phases, code in (((2, 16, 16, 128), "full", 0),
                                ((2, 16, 16, 128), "z", 2),
                                ((2, 16, 16, 128), "zy", 3),
                                ((1, 8, 8, 8192), "step1", 1),
                                ((1, 8, 8, 8192), "z", 2)):
        x = torch.zeros(shape)
        ff.fft3d_cube.impl("kernel", x, x, phases=phases)
        entry, _, _, args = calls.pop()
        assert entry == "offt_fft_cube_regs" and args[9] == code
