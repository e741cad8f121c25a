"""The register core's c2r slab kernel (``csrc/irfft_slab.cu`` on Y and
M = N/2 powers of two in [16, 4096]) on the CPU.

No CPU runs that kernel, so :func:`offt_tpu_torch.kernels.regcore.irfft_slab`
replays it as both of its layouts (a cluster holding the slab in shared
memory, or two grids through a scratch) compute it: the inverse y lines on
the column variant, the Nyquist side plane added to lane 0, then the c2r
rows (``rows_c2r``: the re-tangle of each pair (k, M - k) as the M-point
core loads, the inverse core, the interleave). These tests hold the replay
against numpy's ``irfft2`` (the input made by numpy from a seed as the
half-spectrum of real data) over (Y, M) pairs of the cluster layout and of
the two grids, with and without the side plane, and against the
reference's ``pallas_fft.irfft_slab_yz`` in interpret mode. Tolerance:
1e-6 of max |reference|, max-abs (f32 on both sides, sums in other
orders). They also hold the kernel's re-tangle formula against the plain
version's, and pin the cluster layout's geometry and the bank conflicts
of its y writes and row reads. The kernel against its plain version on
the card is ``tests/test_torch_cuda.py``'s."""

import numpy as np
import pytest
import torch

from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.kernels import regcore as rc
from offt_tpu_torch.kernels import tables as tb

TOL = 1e-6
PAD = 8
# (Y, M): the cluster layout (the 256^3 slab, clusters of 4 and 8) and
# the two grids (rows of 1 and 2 threads, one row a block, one y lane a
# block, and slabs of 2^16 and 2^17 elements, the 512^3 one among them)
CLUSTER = [(256, 128), (64, 256), (128, 128), (64, 512)]
GRIDS = [(64, 128), (16, 16), (32, 32), (16, 4096), (4096, 16), (128, 512),
         (256, 512), (512, 256)]


def max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def core_tab(n, inverse):
    stages = tb.core_stages(tb._pick_stages(n))
    return torch.from_numpy(tb.core_table(n, stages, inverse).copy())


def spectrum(shape, seed, side):
    """Real data x of ``shape`` (..., Y, 2M) and its half-spectrum as the
    c2r slab takes it: planar (..., Y, M + PAD), NaN in the pad lanes,
    lane 0 = X[0] + i X[M] packed, or X[0] with X[M] as the side plane."""
    x = np.random.default_rng(seed).standard_normal(shape)
    w = np.fft.rfft2(x).astype(np.complex64)
    m = shape[-1] // 2
    lane0 = w[..., 0] if side else w[..., 0] + 1j * w[..., m]
    packed = np.concatenate([lane0[..., None], w[..., 1:m]], -1)
    xr = np.full((*shape[:-1], m + PAD), np.nan, np.float32)
    xi = np.full_like(xr, np.nan)
    xr[..., :m], xi[..., :m] = packed.real, packed.imag
    s = (w[..., m].real.copy(), w[..., m].imag.copy()) if side else None
    return x, xr, xi, s


def replay(xr, xi, n, scale, s=None):
    m = n // 2
    ab = torch.from_numpy(tb.crfft_table(n, scale).copy())
    t = torch.from_numpy
    out = rc.irfft_slab(t(xr), t(xi), core_tab(m, True),
                        core_tab(xr.shape[-2], True), ab,
                        *((t(s[0]), t(s[1])) if s else ()))
    return out.numpy()


@pytest.mark.parametrize("side", [False, True])
@pytest.mark.parametrize("ny,m", CLUSTER + GRIDS)
def test_irslab_replay_matches_numpy(ny, m, side):
    x, xr, xi, s = spectrum((2, ny, 2 * m), ny + m + side, side)
    got = replay(xr, xi, 2 * m, 1.0 / (ny * m), s)
    assert got.shape == x.shape and np.isfinite(got).all()
    assert max_rel(got, x) < TOL


@pytest.mark.parametrize("side", [False, True])
@pytest.mark.parametrize("shape", [(2, 16, 256), (2, 32, 512)])
def test_irslab_replay_matches_reference(shape, side):
    x, xr, xi, s = spectrum(shape, sum(shape) + side, side)
    xr, xi = np.nan_to_num(xr), np.nan_to_num(xi)
    scale = 0.5 / (shape[1] * shape[2] // 2)
    kw = {"side_r": s[0], "side_i": s[1]} if side else {}
    ref = np.asarray(pf.irfft_slab_yz(xr, xi, shape[-1], scale=scale, **kw))
    got = replay(xr, xi, shape[-1], scale, s)
    assert max_rel(got, ref) < TOL
    assert max_rel(got, 0.5 * x) < TOL


@pytest.mark.parametrize("m", [16, 128, 4096])
def test_retangle_pair_matches_the_plain_version(m):
    """The kernel's re-tangle (element k of each pair (k, M - k), row 0's
    packed rule from the table's a = 0) and the plain version's compute
    the same V."""
    rng = np.random.default_rng(m)
    xr, xi = (torch.from_numpy(rng.standard_normal((3, m))
                               .astype(np.float32)) for _ in range(2))
    ab = torch.from_numpy(tb.crfft_table(2 * m, 0.25).copy())
    got = rc.retangle_pair(xr, xi, ab)
    want = ff._retangle_plain(xr, xi, ab)
    for g, w in zip(got, want):
        assert max_rel(g.numpy(), w.numpy()) < TOL
    # row 0: V[0] = s ((A + B) + i (A - B)) / 2 from X[0] = A + i B
    a, b = xr[:, 0], xi[:, 0]
    assert torch.allclose(got[0][:, 0], 0.125 * (a + b), atol=1e-7)
    assert torch.allclose(got[1][:, 0], 0.125 * (a - b), atol=1e-7)


@pytest.mark.parametrize("ny,m", [(32, 128), (256, 128), (16, 16)])
def test_plain_version_agrees_with_the_replay(ny, m):
    """The wrapper's plain version (the dense core's arithmetic on the
    CPU) and the register slab's replay compute the same function."""
    x, xr, xi, s = spectrum((2, ny, 2 * m), ny * m, True)
    t = torch.from_numpy
    xr, xi = np.nan_to_num(xr), np.nan_to_num(xi)
    plain = ff.irfft_slab_yz(t(xr), t(xi), 2 * m, scale=1.0 / (ny * m),
                             side_r=t(s[0]), side_i=t(s[1]))
    got = replay(xr, xi, 2 * m, 1.0 / (ny * m), s)
    assert max_rel(plain.numpy(), got) < TOL


@pytest.mark.parametrize("ny,m", CLUSTER + GRIDS + [(320, 160), (40, 128)])
def test_irslab_layout_predicates(ny, m):
    """The c2r slab takes the register core on the slabs the r2c does
    (:func:`fused_fft._reg_rslab` of (Y, M)), in clusters where
    ``_cluster_irslab`` holds (the shapes of ``_cluster_slab`` of 2^14 to
    2^15 elements, the 256^3 slab among them), else two grids (the 512^3
    slab among them, and the 320^3 one on the mixed columns and rows);
    Y = 40 keeps the dense core."""
    reg = (ny, m) in CLUSTER + GRIDS + [(320, 160)]
    assert ff._reg_rslab(ny, m) is reg
    assert ff._cluster_irslab(ny, m) is ((ny, m) in CLUSTER)
    if ff._cluster_irslab(ny, m):
        assert ff._cluster_slab(ny, m)


@pytest.mark.parametrize("ny,m", CLUSTER)
def test_irslab_cluster_geometry(ny, m):
    """A block keeps YB rows (whole row groups of the c2r rows) and runs
    ZB y lanes (whole lane groups of the column variant); the cluster
    holds the slab once; a block holds 4096 elements."""
    g = rc.cluster_geometry(ny, m)
    assert g["C"] == ny * m // 4096
    assert g["YB"] % rc.geometry(m)["ROWS"] == 0
    assert g["ZB"] % rc.col_geometry(ny)["L"] == 0
    assert g["YB"] * g["C"] == ny and g["ZB"] * g["C"] == m


@pytest.mark.parametrize("ny,m", CLUSTER)
def test_irslab_cluster_banks(ny, m):
    """The c2r rows' reads of elements e and M - e from the block's slab
    rows take one wavefront; the y pass's writes into the slab take one
    where the pitch serves them, two where a warp holds several rows of P
    threads in the rows and several rows of L lanes in y, P != L (the
    256^3 slab): the rows want the pitch P banks apart, the y writes L."""
    ways = rc.cluster_ways(ny, m)
    pz, lanes = m // 16, rc.col_geometry(ny)["L"]
    assert ways["z get"] == 1
    assert ways["y put"] == (2 if pz < 32 and lanes < 32 and pz != lanes
                             else 1)


def test_reset_counts_zeroes_the_irslab_register_count():
    ff.irfft_slab_yz.reg_launches = 2
    ff.reset_counts()
    assert ff.irfft_slab_yz.reg_launches == 0
