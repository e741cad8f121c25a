"""The strided-axis kernel (``csrc/fft_axis.cu``: ``fft_sublane``,
``_sublane_nd``, ``fft_x_from_padded``, ``fft_x_to_padded``) on the
register core's column variant, on the CPU.

No CPU runs that kernel, so :func:`offt_tpu_torch.kernels.regcore.fft_axis`
replays it as its grid runs: tile by tile (the lanes a block takes),
each line read whole on the (B, N, Y, Z) geometry the wrappers
pass, the row core's passes, the scale at the store. These tests hold the
replay against complex128 numpy at every power of two from 16 to 4096
over four geometries (pitched reads, pitched writes, the (B, N, MID,
last) route and in place), and against the reference's
``pallas_fft.fft_x_from_padded``, ``fft_x_to_padded`` and
``fft_sublane`` in interpret mode on inputs made by numpy from a seed.
Tolerance: 1e-6 of max |reference|, max-abs (f32 on both sides, sums in
other orders). They also pin ``_reg_axis``, ``_axis_tile``, the lane
tiles' geometry, the runs of floats a warp moves (eight or more to 2048,
four at 4096), and that the tiles' exchanges take one wavefront a warp
instruction.
The kernel against its plain version on the card is
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


def replay(xr, xi, n, geom, out_shape, inverse=False, scale=1.0,
           tile=None, alias=False):
    """The replay on numpy inputs; the output buffers start as NaN, so a
    lane no tile writes shows."""
    ar = torch.from_numpy(xr.copy()).reshape(-1)
    ai = torch.from_numpy(xi.copy()).reshape(-1)
    if alias:
        yr, yi = ar, ai
    else:
        yr = torch.full((int(np.prod(out_shape)),), float("nan"))
        yi = torch.full_like(yr, float("nan"))
    rc.fft_axis(ar, ai, yr, yi, n, geom, core_tab(n, inverse), inverse,
                scale, tile)
    return (yr.reshape(out_shape).numpy().astype(np.float64)
            + 1j * yi.reshape(out_shape).numpy())


def geometry(kind, n):
    """(input shape, geom, output shape, transform axis, lanes compared)
    of the four geometries the wrappers pass."""
    if kind == "pitched in":        # fft_x_from_padded: 24 of 32 lanes
        return ((n, 3, 32), (1, 3, 24, (n * 96, 96, 32), (n * 72, 72, 24)),
                (n, 3, 24), 0, 24)
    if kind == "pitched out":       # fft_x_to_padded: 24 of 25, pitch 32
        return ((n, 3, 25), (1, 3, 24, (n * 75, 75, 25), (n * 96, 96, 32)),
                (n, 3, 32), 0, 24)
    if kind == "nd":                # _sublane_nd: (B, N, MID, last)
        st = (n * 32, 32, 16)
        return (2, n, 2, 16), (2, 2, 16, st, st), (2, n, 2, 16), 1, 16
    st = (n * 24, 24, 24)           # fft_sublane flattened, in place
    return (2, n, 24), (2, 1, 24, st, st), (2, n, 24), 1, 24


GEOMETRIES = ["pitched in", "pitched out", "nd", "alias"]


@pytest.mark.parametrize("n", [16, 4096, 8, 96, 320, 8192, 256, 512, 1024,
                               2048, 192])
def test_reg_axis_predicate(n):
    """Powers of two in [16, 4096] and the mixed lengths 3 2^k, 5 2^k
    (the 320^3 and 192^3 x passes among them) take the column variant;
    the rest keep the dense core. The four-step pair's predicate takes
    the same lengths."""
    assert ff._reg_axis(n) is (n in LENGTHS or n in (96, 320, 192))
    assert ff._reg_core(n) is (n in LENGTHS or n in (96, 320, 192))


def test_main_path_x_passes_route_to_the_register_core():
    """The x passes of 256^3, 512^3 and 320^3 (c2c and the c2r's
    fft_x_to_padded), 192^3's axes and the 64 x 1024^2 y pass."""
    assert ff._reg_axis(256) and ff._reg_axis(512) and ff._reg_axis(1024)
    assert ff._reg_axis(320) and ff._reg_axis(192)


@pytest.mark.parametrize("kind", GEOMETRIES)
@pytest.mark.parametrize("n", LENGTHS)
def test_axis_replay_matches_numpy(n, kind):
    shape, geom, oshape, axis, lanes = geometry(kind, n)
    xr, xi = pair(shape, n + len(kind))
    inverse = kind in ("pitched out", "alias")
    got = replay(xr, xi, n, geom, oshape, inverse, 0.375,
                 alias=kind == "alias")
    x = (xr.astype(np.float64) + 1j * xi)[..., :lanes]
    want = 0.375 * (np.fft.ifft(x, axis=axis) * n if inverse
                    else np.fft.fft(x, axis=axis))
    assert max_rel(got[..., :lanes], want) < TOL
    if kind == "pitched out":       # the pad lanes are never written
        assert np.isnan(got[..., lanes:]).all()


@pytest.mark.parametrize("tile,n", [
    ("narrow", 16), ("narrow", 256), ("narrow", 1024), ("wide", 256),
    ("wide", 1024), ("wide", 2048), ("wide", 4096)])
def test_every_lane_tile_replays_the_same_transform(tile, n):
    """Each tile in place over a ragged last tile (40 lanes) and a (y, z)
    split (the nd geometry): the tiles group lanes differently and compute
    the same function."""
    for kind in ("alias", "nd"):
        shape, geom, oshape, axis, lanes = geometry(kind, n)
        if kind == "alias":
            shape = oshape = (2, n, 40)
            st = (n * 40, 40, 40)
            geom, lanes = (2, 1, 40, st, st), 40
        xr, xi = pair(shape, n)
        got = replay(xr, xi, n, geom, oshape, tile=tile,
                     alias=kind == "alias")
        want = np.fft.fft(xr.astype(np.float64) + 1j * xi, axis=axis)
        assert max_rel(got, want) < TOL


@pytest.mark.parametrize("inverse", [False, True])
def test_replay_matches_reference_x_from_padded(inverse):
    xr, xi = pair((16, 32, 136), 31 + inverse)
    scale = 1.0 / 16 if inverse else 2.0
    ref = pf.fft_x_from_padded(xr, xi, 128, inverse=inverse, scale=scale)
    geom = (1, 32, 128, (16 * 32 * 136, 32 * 136, 136),
            (16 * 32 * 128, 32 * 128, 128))
    got = replay(xr, xi, 16, geom, (16, 32, 128), inverse, scale)
    want = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
    assert max_rel(got, want) < TOL


@pytest.mark.parametrize("inverse", [False, True])
def test_replay_matches_reference_x_to_padded(inverse):
    xr, xi = pair((16, 32, 129), 33 + inverse)
    ref = pf.fft_x_to_padded(xr, xi, zpad=8, inverse=inverse, z_true=128,
                             scale=0.5)
    geom = (1, 32, 128, (16 * 32 * 129, 32 * 129, 129),
            (16 * 32 * 136, 32 * 136, 136))
    got = replay(xr, xi, 16, geom, (16, 32, 136), inverse, 0.5)
    want = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
    assert max_rel(got[..., :128], want[..., :128]) < TOL


@pytest.mark.parametrize("axis", [0, 1])
def test_replay_matches_reference_sublane(axis):
    xr, xi = pair((16, 32, 128), 35 + axis)
    ref = pf.fft_sublane(xr, xi, axis, scale=0.5)
    n = (16, 32)[axis]
    pre, lanes = (1, 32 * 128) if axis == 0 else (16, 128)
    st = (n * lanes, lanes, lanes)
    got = replay(xr, xi, n, (pre, 1, lanes, st, st), (16, 32, 128),
                 scale=0.5)
    want = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
    assert max_rel(got, want) < TOL


@pytest.mark.parametrize("n", [16, 256, 1024])
def test_plain_version_agrees_with_the_replay(n):
    """The wrappers' plain version (the dense core's arithmetic on the
    CPU) and the column variant's replay compute the same function."""
    xr, xi = pair((2, n, 24), n)
    pr, pi = ff.fft_sublane(torch.from_numpy(xr), torch.from_numpy(xi), 1,
                            scale=0.5)
    st = (n * 24, 24, 24)
    got = replay(xr, xi, n, (2, 1, 24, st, st), (2, n, 24), scale=0.5)
    assert max_rel(pr.numpy() + 1j * pi.numpy(), got) < TOL


@pytest.mark.parametrize("n", [16, 128, 256, 320, 4096])
def test_axis_tile_is_picked_once(n):
    """Narrow to 128 (32 lanes or more a block of 256 threads), wide from
    256; the replay's geometry reads the same pick."""
    want = "narrow" if n <= 128 else "wide"
    assert ff._axis_tile(n) == want
    if ff._reg_axis(n):
        assert rc.axis_tile(n)["tile"] == want
    assert sorted(ff._AXIS_TILES) == ["narrow", "wide"]


@pytest.mark.parametrize("n", LENGTHS)
def test_lane_tile_runs_are_whole_sectors(n):
    """What the routes launch moves runs of at least eight consecutive
    floats (a 32-byte sector) a warp instruction to 2048 and four at 4096
    (the wide block of 1024 threads holds 4 lanes there); the narrow tile
    (256 / P lanes a block) falls to 4, 2 and 1 floats from 1024 on; the
    wide block (32 lanes up to 1024 threads) to 16, 8 and 4."""
    assert rc.warp_runs(n) >= 8 if n <= 2048 else rc.warp_runs(n) == 4
    narrow = rc.warp_runs(n, "narrow")
    assert narrow == min(32, 256 // (n // 16))
    assert (narrow >= 8) == (n <= 512)
    if n >= 256:
        assert rc.warp_runs(n, "wide") == min(32, 1024 // (n // 16))


@pytest.mark.parametrize("n", LENGTHS)
def test_lane_tile_geometry(n):
    """Whole lanes a block, at most 1024 threads; the shared memory of the
    blocks an SM is asked to hold (three of 256 threads, 1024 threads of
    larger ones) fits its 228 KB."""
    for tile in ff._AXIS_TILES:
        try:
            g = rc.axis_tile(n, tile)
        except ValueError:
            assert tile == "wide" and n < 256
            continue
        assert g["P"] * g["L"] == g["threads"] <= 1024
        cg = rc.col_geometry(n, g["threads"])
        blocks = 3 if g["threads"] == 256 else 1024 // g["threads"]
        assert blocks * (cg["SMEM"] + 1024) <= 228 << 10
    assert rc.axis_tile(n)["tile"] == ff._axis_tile(n)


@pytest.mark.parametrize("n", LENGTHS)
def test_lane_tile_exchanges_are_one_wavefront(n):
    """The launched tile's exchanges, and the narrow tile's, take one
    wavefront a warp instruction."""
    for tile in (None, "narrow"):
        threads = rc.axis_tile(n, tile)["threads"]
        assert max(rc.col_bank_ways(n, threads).values(), default=1) == 1


def test_lane_tiles_refuse_the_plain_version():
    """``tile`` probes the register-core kernel: a CPU tensor (the plain
    version) raises, and so does a tile the kernel does not have."""
    x = torch.zeros((2, 1024, 8))
    with pytest.raises(ValueError, match="tile"):
        ff.fft_sublane(x, x, 1, tile="narrow")
    with pytest.raises(ValueError, match="tile"):
        ff.fft_sublane(x, x, 1, tile="square")
    with pytest.raises(ValueError, match="no 'wide'"):
        rc.axis_tile(128, "wide")


def test_reset_counts_zeroes_the_axis_register_counts():
    for w in ff.KERNELS["fft_axis"]["wrappers"]:
        ff.WRAPPERS[w].reg_launches = 3
    assert ff.kernel_launches("fft_axis", reg=True) == 12
    ff.reset_counts()
    assert ff.kernel_launches("fft_axis", reg=True) == 0
