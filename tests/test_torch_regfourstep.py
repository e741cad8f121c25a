"""The four-step pair (``csrc/fourstep.cu``: ``_step1_twiddle``,
``_step3_transposed``) on the register core, on the CPU.

No CPU runs those kernels, so :mod:`offt_tpu_torch.kernels.regcore`
replays them as their grids run: :func:`regcore.step1_twiddle` tile by
tile (the L consecutive lanes j2 a block takes on the column variant),
each column read whole, the row core's passes, the twiddle multiply at
the store; :func:`regcore.step3_transposed` block by block (the R
consecutive rows a block takes), the row core's passes, the outputs
written into the block's swizzled stage and read back as the transposed
runs of R floats, each row finding its own batch. These tests hold the
replays against complex128 numpy at every power of two from 16 to 4096
on each side, and against the reference's
``offt_tpu.kernels.fourstep._step1_twiddle`` and ``_step3_transposed``
in interpret mode (forward and inverse, a caller's twiddle, a batch
whose rows span two batches in a block of step 3), and the two composed
against its ``fft_four_step_planar`` at 2^14 (128 x 128), on inputs made
by numpy from a seed. Tolerance: 1e-6 of max |reference|, max-abs (f32 on
both sides, sums in other orders). They also pin which core each kernel
routes to, the lane tile step 1's picker takes, that step 3's stage
takes one wavefront a warp instruction on both sides, and the runs of
floats its stores move. The kernels against their plain versions on the
card are ``tests/test_torch_cuda.py``'s."""

import numpy as np
import pytest
import torch

from offt_tpu.kernels import fourstep as rfs
from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.kernels import fourstep as fs
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


def t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def cplx(pr):
    return np.asarray(pr[0]).astype(np.float64) + 1j * np.asarray(pr[1])


def core_tab(n, inverse):
    stages = tb.core_stages(tb._pick_stages(n))
    return torch.from_numpy(tb.core_table(n, stages, inverse, 1.0).copy())


def step1(xr, xi, inverse=False, scale=1.0, tw=None, tile=None):
    """The step-1 replay on numpy inputs; ``tw`` an (n1, n2, 2) table, by
    default the four-step twiddle times ``scale``."""
    _, n1, n2 = xr.shape
    if tw is None:
        tw = tb.fourstep_twiddle(n1, n2, inverse, scale)
    return rc.step1_twiddle(t(xr), t(xi), core_tab(n1, inverse), t(tw),
                            inverse, tile)


def step3(zr, zi, inverse=False):
    n2 = zr.shape[-1]
    return rc.step3_transposed(t(zr), t(zi), core_tab(n2, inverse),
                               inverse)


def np_step1(x, inverse, scale):
    _, n1, n2 = x.shape
    f = np.fft.ifft(x, axis=1) * n1 if inverse else np.fft.fft(x, axis=1)
    k = np.arange(n1)[:, None] * np.arange(n2)[None, :]
    sign = 1 if inverse else -1
    return f * np.exp(sign * 2j * np.pi * k / (n1 * n2)) * scale


def np_step3(z, inverse):
    n2 = z.shape[-1]
    f = np.fft.ifft(z, axis=2) * n2 if inverse else np.fft.fft(z, axis=2)
    return f.transpose(0, 2, 1)


# ---- the replays against numpy, every register length ----------------------

@pytest.mark.parametrize("n1", LENGTHS)
def test_step1_replay_matches_numpy(n1):
    """Two batches of 40 lanes: a ragged last tile at every tile width;
    inverse at the odd lengths' exponents."""
    inverse = n1.bit_length() % 2 == 0
    xr, xi = pair((2, n1, 40), n1)
    got = step1(xr, xi, inverse, 0.375)
    assert max_rel(cplx(got), np_step1(cplx((xr, xi)), inverse, 0.375)) \
        < TOL


@pytest.mark.parametrize("n2", LENGTHS)
def test_step3_replay_matches_numpy(n2):
    """15 rows of n1 = 5: blocks of R rows (256 at 16 down to 8 from 512
    on; at 4096 clusters of two blocks of 4) start mid-batch and span two
    batches; the last is ragged."""
    inverse = n2.bit_length() % 2 == 1
    zr, zi = pair((3, 5, n2), n2 + 1)
    got = step3(zr, zi, inverse)
    assert not np.isnan(got[0].numpy()).any()
    assert max_rel(cplx(got), np_step3(cplx((zr, zi)), inverse)) < TOL


@pytest.mark.parametrize("tile,n1", [("narrow", 16), ("narrow", 128),
                                     ("wide", 256), ("wide", 1024),
                                     ("wide", 4096), ("half", 512),
                                     ("half", 1024)])
def test_every_step1_tile_replays_the_same_transform(tile, n1):
    xr, xi = pair((2, n1, 24), n1 + 3)
    got = step1(xr, xi, False, 0.5, tile=tile)
    assert max_rel(cplx(got), np_step1(cplx((xr, xi)), False, 0.5)) < TOL


# ---- the replays against the reference in interpret mode -------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("caller_tw", [False, True])
def test_step1_replay_matches_reference(inverse, caller_tw):
    b, n1, n2 = 2, 128, 256
    xr, xi = pair((b, n1, n2), 40 + 2 * inverse + caller_tw)
    kw, tw = {}, None
    if caller_tw:
        # a column chunk of a larger table, as the distributed engine
        # passes it, with its own scale
        twr, twi = rfs._twiddle_planar(n1, 2 * n2, inverse, 0.5)
        twr, twi = twr[:, n2:].copy(), twi[:, n2:].copy()
        kw["tw"] = (twr, twi)
        tw = np.stack([twr, twi], -1)
    ref = rfs._step1_twiddle(xr, xi, n1, n2, pf._pick_stages(n1), inverse,
                             "highest", 0.25, 0, **kw)
    got = step1(xr, xi, inverse, 0.25, tw)
    assert max_rel(cplx(got), cplx(ref)) < TOL


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("shape", [(2, 128, 256), (3, 128, 16)])
def test_step3_replay_matches_reference(inverse, shape):
    """(3, 128, 16): blocks of 256 rows over n1 = 128, so the first block
    spans batches 0 and 1 and the last is half empty."""
    b, n1, n2 = shape
    zr, zi = pair(shape, 50 + n2 + inverse)
    ref = rfs._step3_transposed(zr, zi, n1, n2, pf._pick_stages(n2),
                                inverse, "highest", 0)
    got = step3(zr, zi, inverse)
    assert got[0].shape == (b, n2, n1)
    assert max_rel(cplx(got), cplx(ref)) < TOL


@pytest.mark.parametrize("inverse", [False, True])
def test_replays_compose_to_the_reference_four_step(inverse):
    n1 = n2 = 128
    n = n1 * n2
    xr, xi = pair((2, n), 60 + inverse)
    scale = 1.0 / n if inverse else 1.0
    ref = rfs.fft_four_step_planar(xr, xi, inverse=inverse)
    zr, zi = step1(xr.reshape(2, n1, n2), xi.reshape(2, n1, n2), inverse,
                   scale)
    yr, yi = step3(zr.numpy(), zi.numpy(), inverse)
    got = (yr.reshape(2, n), yi.reshape(2, n))
    assert max_rel(cplx(got), cplx(ref)) < TOL
    f = np.fft.ifft if inverse else np.fft.fft
    assert max_rel(cplx(got), f(cplx((xr, xi)), axis=-1)) < TOL


@pytest.mark.parametrize("n1,n2", [(128, 256), (1024, 16), (16, 1024)])
def test_plain_versions_agree_with_the_replays(n1, n2):
    """The wrappers' plain versions (the dense core's arithmetic on the
    CPU) and the register replays compute the same functions."""
    xr, xi = pair((2, n1, n2), n1 + n2)
    pr = fs._step1_twiddle(t(xr), t(xi), n1, n2, None, True, scale=0.5)
    assert max_rel(cplx(pr), cplx(step1(xr, xi, True, 0.5))) < TOL
    p3 = fs._step3_transposed(t(xr), t(xi), n1, n2, None, False)
    assert max_rel(cplx(p3), cplx(step3(xr, xi))) < TOL


# ---- routing, the tile picker, the stage -------------------------------------

@pytest.mark.parametrize("n1,n2,cores", [
    (1024, 1024, (True, True)), (1024, 768, (True, True)),
    (768, 1024, (True, True)), (4096, 4096, (True, True)),
    (128, 256, (True, True))])
def test_each_kernel_routes_on_its_own_length(n1, n2, cores):
    """3 * 2^18 splits as (1024, 768): step 1 on the register core at a
    power of two, step 3 on its mixed instances; the other order the
    other way round."""
    assert (ff._reg_core(n1), ff._reg_core(n2)) == cores


@pytest.mark.parametrize("n,radices,cores", [
    (32768, (32, 32, 32), (True, True)),
    (30720, (30, 32, 32), (False, True)),
    (30720, (32, 30, 32), (True, False))])
def test_long_lines_split_where_the_cores_route(n, radices, cores,
                                                monkeypatch):
    """A line past one block's shared memory runs the pair on (rows, r0,
    n / r0): each kernel takes the core of its own length."""
    stages = ff._stages(n, radices)
    assert not ff._fits_block(n, sum(stages))
    seen = []
    check = fs._check_3d
    monkeypatch.setattr(fs, "_check_3d", lambda x, n1, n2, what: (
        seen.append((what, n1, n2)), check(x, n1, n2, what)))
    xr, xi = pair((2, n), 7)
    ff.fft_last(t(xr), t(xi), radices=radices)
    r0 = radices[0]
    assert seen == [("step 1", r0, n // r0), ("step 3", r0, n // r0)]
    assert (ff._reg_core(r0), ff._reg_core(n // r0)) == cores


@pytest.mark.parametrize("shape,tile", [
    ((1, 1024, 1024), "half"), ((8, 1024, 1024), "wide"),
    ((1, 2048, 2048), "wide"), ((1, 4096, 4096), "wide"),
    ((1, 1024, 768), "half"), ((1, 1024, 2048), "wide"),
    ((1, 32, 1024), "narrow"), ((4, 512, 2048), "half"),
    ((8, 512, 2048), "half"), ((64, 512, 512), "wide")])
def test_step1_tile_picker(shape, tile):
    """On 132 SMs: 2^20 (64 wide blocks, at most half the SMs) and
    3 * 2^18's (1024, 768): half; 3g's inner 2^21 (128 wide blocks), 8 x
    2^20, 2^22, 2^24: wide; n1 = 512 half up to 528 wide blocks;
    _long_last's r0 = 32: narrow."""
    b, n1, n2 = shape
    assert fs._step1_tile(n1, n2, b, 132) == tile
    assert rc.step1_tile(n1, n2, b)["tile"] == tile
    assert sorted(fs._STEP1_TILES) == ["half", "narrow", "wide"]


@pytest.mark.parametrize("sms,tile", [(64, "wide"), (128, "half"),
                                      (132, "half"), (256, "half")])
def test_step1_tile_follows_the_sms(sms, tile):
    """The half tile at n1 = 1024 while the wide grid's blocks (64 at
    2^20) fill at most half the card's SMs."""
    assert fs._step1_tile(1024, 1024, 1, sms) == tile
    assert rc.step1_tile(1024, 1024, 1, sms=sms)["tile"] == tile


@pytest.mark.parametrize("n1", LENGTHS)
def test_step1_tiles_move_whole_sectors(n1):
    """What step 1's route launches: runs of at least 8 floats a warp
    instruction to n1 = 2048 (4 at 4096), one wavefront an exchange, and
    the blocks an SM is asked to hold fit its 228 KB."""
    for shape in ((1, n1, 1024), (8, n1, 1024)):
        g = rc.step1_tile(*[shape[1], shape[2], shape[0]])
        runs = min(32, g["L"])
        assert runs >= 8 if n1 <= 2048 else runs == 4
        assert max(rc.col_bank_ways(n1, g["threads"]).values(),
                   default=1) == 1
        cg = rc.col_geometry(n1, g["threads"])
        blocks = 3 if g["threads"] == 256 else 1024 // g["threads"]
        assert blocks * (cg["SMEM"] + 1024) <= 228 << 10


@pytest.mark.parametrize("n2", LENGTHS)
def test_step3_stage_is_one_wavefront(n2):
    """The outputs' writes into the stage and the runs' reads back (at
    4096 from both blocks of the cluster, counted on each) take one
    wavefront a warp instruction."""
    assert rc.step3_ways(n2) == {"put": 1, "get": 1}


@pytest.mark.parametrize("n2", LENGTHS)
def test_step3_runs_and_shared_memory(n2):
    """Runs of 8 floats or more (whole 32-byte sectors) at every length
    (at 4096 from a cluster of two blocks of 4 rows: 8 rows in one block
    would need a 256 KB stage); the stage fits in the rows' exchange
    planes where there are any, and the blocks an SM is asked to hold fit
    its 228 KB."""
    g = rc.step3_geometry(n2)
    assert rc.step3_runs(n2) >= 8
    assert (g["R"], g["C"]) == fs._step3_layout(n2)
    assert (g["C"] == 2) == (n2 == 4096)
    assert g["threads"] == max(256, min(8 * g["P"] // g["C"], 1024))
    assert g["ST"] <= g["EX"] or n2 == 16
    blocks = 3 if g["threads"] == 256 else 1024 // g["threads"]
    assert blocks * (g["SMEM"] + 1024) <= 228 << 10


def test_pair_probes_refuse_the_plain_version():
    x = torch.zeros((2, 1024, 64))
    with pytest.raises(ValueError, match="tile"):
        fs._step1_twiddle(x, x, 1024, 64, None, False, tile="half")
    with pytest.raises(ValueError, match="tile"):
        fs._step1_twiddle(x, x, 1024, 64, None, False, tile="square")
    with pytest.raises(ValueError, match="no 'half'"):
        rc.step1_tile(2048, 64, 1, "half")


def test_reset_counts_zeroes_the_pair_register_counts():
    fs._step1_twiddle.reg_launches = fs._step3_transposed.reg_launches = 2
    assert ff.kernel_launches("step1_twiddle", reg=True) == 2
    assert ff.kernel_launches("step3_transposed", reg=True) == 2
    ff.reset_counts()
    assert ff.kernel_launches("step1_twiddle", reg=True) == 0
    assert ff.kernel_launches("step3_transposed", reg=True) == 0
