"""The register core's two slab kernels (``csrc/fft_slab.cu``,
``csrc/rfft_slab.cu`` on Y and Z, or Y and M = N/2, powers of two in
[16, 4096]) on the CPU.

No CPU runs those kernels, so :mod:`offt_tpu_torch.kernels.regcore`
replays them as their grids run: the z rows on the row core, then the y
lines in place on its column variant (lanes, not rows, per thread
group), with ``zpad``, ``z_true``, alias and the scale at the y store;
and for the r2c the float2 pair read, the M-point core, the untangle and
y. These tests hold the replay against complex128 numpy over
power-of-two (Y, Z) pairs inside the reference's 2^20 slab gate, and
against the reference's ``pallas_fft.fft_slab_yz`` / ``rfft_slab_yz``
in interpret mode on inputs made by numpy from a seed. Tolerance: 1e-6
of max |reference|, max-abs (f32 on both sides, sums in other orders).
They also pin the column variant's geometry, its exchanges free of bank
conflicts, the geometry and bank conflicts of the slab a cluster of
blocks holds in shared memory, the routing predicates (``_reg_slab``,
``_cluster_slab``) and that the probe phases refuse a plain version. The
kernels against their plain versions on the card are
``tests/test_torch_cuda.py``'s."""

import numpy as np
import pytest
import torch

from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.kernels import regcore as rc
from offt_tpu_torch.kernels import tables as tb

TOL = 1e-6
LENGTHS = [1 << k for k in range(4, 13)]
# (Y, Z) slabs inside the 2^20 gate: the extremes and the main paths'
SLABS = [(16, 16), (16, 4096), (4096, 16), (32, 1024), (1024, 64),
         (128, 256), (256, 256), (512, 512), (2048, 32)]


def max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def core_tab(n, inverse, scale=1.0):
    stages = tb.core_stages(tb._pick_stages(n))
    return torch.from_numpy(tb.core_table(n, stages, inverse, scale).copy())


def replay(xr, xi, inverse=False, scale=1.0, zpad=0, z_true=0):
    ny, nz = xr.shape[-2], z_true or xr.shape[-1]
    yr, yi = rc.fft_slab(torch.from_numpy(xr), torch.from_numpy(xi),
                         core_tab(nz, inverse), core_tab(ny, inverse),
                         inverse, scale, zpad, z_true)
    return yr.numpy(), yi.numpy()


def replay_r2c(x, zpad=0):
    ny, m = x.shape[-2], x.shape[-1] // 2
    w = torch.from_numpy(tb.rfft_table(2 * m).copy())
    yr, yi = rc.rfft_slab(torch.from_numpy(x), core_tab(m, False),
                          core_tab(ny, False), w, zpad)
    return yr.numpy(), yi.numpy()


def cplx(yr, yi, lanes):
    return yr[..., :lanes].astype(np.float64) + 1j * yi[..., :lanes]


def packed_truth(x):
    """numpy's r2c along z, then c2c along y, in the packed layout:
    lane 0 = X[0] + i X[M] (both complex after the y transform)."""
    w = np.fft.fft(np.fft.rfft(x.astype(np.float64), axis=-1), axis=-2)
    m = x.shape[-1] // 2
    out = w[..., :m].copy()
    out[..., 0] = w[..., 0] + 1j * w[..., m]
    return out


@pytest.mark.parametrize("ny,nz", [(256, 256), (16, 4096), (4096, 16),
                                   (512, 512), (320, 320), (256, 320),
                                   (8, 256), (256, 8192), (1024, 1024),
                                   (96, 128)])
def test_reg_slab_predicate(ny, nz):
    """Both axes powers of two in [16, 4096] or mixed lengths take the
    register slab (z on the rows, ``_reg_rows``; y on the column variant,
    ``_reg_axis``; 320^3's slab among them); the rest keep the dense core.
    The r2c and c2r slabs (``_reg_rslab``) take y on the column variant and
    M on the real rows (``_reg_real_rows``) but at a smooth M, which only
    ``rfft_last_planar`` and ``icrfft_last_planar`` take there."""
    mixed = ff._MIX_LENGTHS
    want = (ny in LENGTHS or ny in mixed) and (nz in LENGTHS or nz in mixed)
    assert ff._reg_slab(ny, nz) is want
    assert ff._reg_slab(ny, nz) == (ff._reg_axis(ny) and ff._reg_rows(nz))
    assert ff._reg_rslab(ny, nz) == (ff._reg_axis(ny)
                                     and ff._reg_real_rows(nz)
                                     and nz not in ff._SMOOTH_ROWS)


def test_main_path_slabs_route_to_the_register_core():
    """The c2c slabs of 256^3, 512^3 and 320^3 (two grids, the mixed
    rows and columns), the r2c slabs of 256^3 and 512^3 (Y, M = N/2) and
    the 4x128x128x256 r2c's."""
    assert ff._reg_slab(256, 256) and ff._reg_slab(512, 512)
    assert ff._reg_rslab(256, 128) and ff._reg_rslab(512, 256)
    assert ff._reg_rslab(128, 128)
    assert ff._reg_slab(320, 320) and not ff._cluster_slab(320, 320)


@pytest.mark.parametrize("n", LENGTHS)
def test_column_geometry(n):
    """L lanes of P threads fill a 256-thread block; a warp's loads and
    stores move runs of L consecutive floats, whole 32-byte sectors up to
    N = 512 (8 lanes); each lane's elements sit one-to-one inside the
    plane, and three blocks' planes fit an SM."""
    g = rc.col_geometry(n)
    assert g["P"] * g["L"] == rc.THREADS
    if n <= 512:
        assert 4 * g["L"] >= 32
    pos = np.asarray(rc.col_at(n, np.arange(n)))
    lanes = (pos[:, None] + np.arange(g["L"])[None, :]).ravel()
    assert len(set(lanes.tolist())) == n * g["L"]
    assert lanes.max() < g["SIZE"] and g["SIZE"] % 4 == 0
    assert 3 * g["SMEM"] <= 227 * 1024


@pytest.mark.parametrize("n", LENGTHS)
def test_column_exchanges_are_free_of_bank_conflicts(n):
    """Every write and read of the column variant's exchanges is one
    wavefront a warp instruction, at every length (the row core's
    shortest rows, which share warps, take two)."""
    ways = rc.col_bank_ways(n)
    assert len(ways) == 2 * (len(rc.passes(n)) - 1)
    assert max(ways.values(), default=1) == 1


@pytest.mark.parametrize("n", LENGTHS)
def test_column_map_splits_over_the_exchange_addresses(n):
    """As for rows: the kernel addresses an exchange element as the
    thread's base plus a compile-time constant, so the column map must
    split over every such sum."""
    for r, ns in rc.passes(n):
        src, _, dst = rc.pass_maps(n, r, ns)
        j = torch.arange(n // r)[:, None]
        k = torch.arange(r)[None, :]
        d = (j // ns) * ns * r + j % ns
        assert torch.equal(rc.col_at(n, src),
                           rc.col_at(n, j) + rc.col_at(n, k * (n // r)))
        assert torch.equal(rc.col_at(n, dst),
                           rc.col_at(n, d) + rc.col_at(n, k * ns))


@pytest.mark.parametrize("ny,nz", SLABS)
@pytest.mark.parametrize("inverse", [False, True])
def test_slab_replay_matches_numpy(ny, nz, inverse):
    xr, xi = pair((1, ny, nz), ny * 7 + nz + inverse)
    yr, yi = replay(xr, xi, inverse, 0.375, zpad=8)
    x = xr.astype(np.float64) + 1j * xi
    f = np.fft.ifft2 if inverse else np.fft.fft2
    want = 0.375 * f(x) * (ny * nz if inverse else 1)
    assert yr.shape == (1, ny, nz + 8)
    assert np.isnan(yr[..., nz:]).all() and np.isnan(yi[..., nz:]).all()
    assert max_rel(cplx(yr, yi, nz), want) < TOL


@pytest.mark.parametrize("ny,m", SLABS)
def test_rslab_replay_matches_numpy(ny, m):
    if ny * m > 1 << 19:
        m //= 2       # the real input holds 2M lanes
    x = pair((1, ny, 2 * m), ny + m)[0]
    yr, yi = replay_r2c(x, zpad=8)
    assert yr.shape == (1, ny, m + 8) and np.isnan(yr[..., m:]).all()
    assert max_rel(cplx(yr, yi, m), packed_truth(x)) < TOL


@pytest.mark.parametrize("kw,shape", [
    ({"zpad": 8, "scale": 0.5}, (2, 32, 128)),
    ({"inverse": True, "scale": 0.25}, (2, 32, 128)),
    ({"z_true": 128, "zpad": 8, "inverse": True, "scale": 1 / 4096},
     (2, 32, 136))])
def test_slab_replay_matches_reference(kw, shape):
    xr, xi = pair(shape, sum(shape))
    ref = pf.fft_slab_yz(xr, xi, **kw)
    got = replay(xr, xi, **kw)
    nz = kw.get("z_true") or shape[-1]
    assert got[0].shape == ref[0].shape
    want = cplx(np.asarray(ref[0]), np.asarray(ref[1]), nz)
    assert max_rel(cplx(*got, nz), want) < TOL


def test_rslab_replay_matches_reference():
    x = pair((2, 16, 256), 11)[0]
    ref = pf.rfft_slab_yz(x, zpad=8)
    got = replay_r2c(x, zpad=8)
    assert got[0].shape == ref[0].shape == (2, 16, 136)
    want = cplx(np.asarray(ref[0]), np.asarray(ref[1]), 128)
    assert max_rel(cplx(*got, 128), want) < TOL


def test_slab_replay_in_place():
    """alias: the z grid over the input, then the y grid over it again."""
    xr, xi = pair((2, 64, 32), 5)
    want = replay(xr, xi, True, 1 / 2048)
    ar, ai = torch.from_numpy(xr.copy()), torch.from_numpy(xi.copy())
    yr, yi = rc.fft_slab(ar, ai, core_tab(32, True), core_tab(64, True),
                         True, 1 / 2048, alias=True)
    assert yr is ar and yi is ai
    assert max_rel(cplx(yr.numpy(), yi.numpy(), 32), cplx(*want, 32)) < TOL


@pytest.mark.parametrize("ny,nz", [(32, 128), (256, 256), (16, 512)])
def test_plain_versions_agree_with_the_replay(ny, nz):
    """The wrappers' plain versions (the dense core's arithmetic on the
    CPU) and the register slab's replay compute the same function."""
    xr, xi = pair((2, ny, nz), ny + nz)
    pr, pi = ff.fft_slab_yz(torch.from_numpy(xr), torch.from_numpy(xi),
                            zpad=8, scale=0.5)
    want = replay(xr, xi, False, 0.5, zpad=8)
    assert max_rel(cplx(pr.numpy(), pi.numpy(), nz), cplx(*want, nz)) < TOL
    x = pair((2, ny, nz), ny)[0]
    pr, pi = ff.rfft_slab_yz(torch.from_numpy(x), zpad=8)
    want = replay_r2c(x, zpad=8)
    m = nz // 2
    assert max_rel(cplx(pr.numpy(), pi.numpy(), m), cplx(*want, m)) < TOL


@pytest.mark.parametrize("fn,phases", [
    (ff.fft_slab_yz, "zonly"), (ff.fft_slab_yz, "copy"),
    (ff.fft_slab_yz, "fused"), (ff.rfft_slab_yz, "noy"),
    (ff.rfft_slab_yz, "nount"), (ff.fft_slab_yz, "nount")])
def test_probe_phases_refuse_the_plain_version(fn, phases):
    """The cost probes exist only in the register-core kernel: a CPU
    tensor (the plain version) raises, and so does a phase the kernel
    does not have."""
    x = torch.zeros((1, 256, 256))
    args = (x, x) if fn is ff.fft_slab_yz else (torch.zeros((1, 512, 512)),)
    with pytest.raises(ValueError, match="phases"):
        fn(*args, phases=phases)


def test_reset_counts_zeroes_the_slab_register_counts():
    ff.fft_slab_yz.reg_launches = ff.rfft_slab_yz.reg_launches = 2
    ff.reset_counts()
    assert ff.fft_slab_yz.reg_launches == ff.rfft_slab_yz.reg_launches == 0


CLUSTER = [(64, 256), (64, 512), (64, 1024), (128, 128), (128, 256),
           (128, 512), (256, 128), (256, 256), (512, 128), (64, 2048),
           (128, 1024), (256, 512), (512, 256), (1024, 128)]


@pytest.mark.parametrize("ny,nz", [(256, 256), (256, 128), (128, 128),
                                   (64, 1024), (512, 512), (512, 256),
                                   (32, 512), (256, 64), (1024, 64),
                                   (320, 320), (2048, 128), (128, 2048)])
def test_cluster_slab_predicate(ny, nz):
    """The cluster layout takes register slabs of 2^14 to 2^17 elements
    with Z >= 128 and Y >= 64 (the 256^3 c2c and r2c slabs and the 512^3
    r2c slab, (512, 256), among them); the 512^3 c2c slab runs two
    grids."""
    assert ff._cluster_slab(ny, nz) is ((ny, nz) in CLUSTER)


@pytest.mark.parametrize("ny,nz", CLUSTER)
def test_cluster_geometry(ny, nz):
    """Each block of a cluster of at most 8 (the portable size; 16 at
    2^17 elements) keeps YB rows, whole row groups of the row core, and
    runs ZB y lanes, whole lane groups of the column variant; the cluster
    holds the slab once; at least two blocks fit an SM's 228 KB of shared
    memory."""
    g = rc.cluster_geometry(ny, nz)
    assert g["C"] <= (16 if ny * nz == 1 << 17 else 8)
    assert g["C"] * g["B"] == ny * nz
    assert g["YB"] % rc.geometry(nz)["ROWS"] == 0
    assert g["ZB"] % rc.col_geometry(ny)["L"] == 0
    assert g["YB"] * nz == g["B"] and g["SP"] >= nz
    assert 2 <= g["MINB"] and g["MINB"] * (g["SMEM"] + 1024) <= 228 << 10


@pytest.mark.parametrize("ny,nz", CLUSTER)
def test_cluster_slab_banks(ny, nz):
    """The z rows' writes into the slab take one wavefront; the y pass's
    reads too, but where a warp holds several z rows of P threads and
    reads several y rows of L lanes, P != L (the 256^3 and 512^3 r2c
    slabs among them): the writes want the row pitch P banks apart, the
    reads L, and the reads take two."""
    ways = rc.cluster_ways(ny, nz)
    pz, lanes = nz // 16, rc.col_geometry(ny)["L"]
    assert ways["z put"] == 1
    assert ways["y get"] == (2 if pz < 32 and lanes < 32 and pz != lanes
                             else 1)
