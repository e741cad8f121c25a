"""The four-step pair at the mixed lengths 3 * 2^k and 5 * 2^k
(``csrc/fourstep_mix.cu``: ``_step1_twiddle`` on
``regs::cols_twiddle_mix``, ``_step3_transposed`` on
``regs::rows_transposed_mix``), on the CPU.

No CPU runs those kernels, so :mod:`offt_tpu_torch.kernels.regcore`
replays them as their grids run: :func:`regcore.step1_twiddle` tile by
tile (the lane tile ``fused_fft._axis_tile`` picks at the mixed n1), each
column read whole, the mixed schedule (radix-4 passes, a radix 2 where
log2 P is odd, then one Good-Thomas pass of radix 12 or 20), the twiddle
at the store; :func:`regcore.step3_transposed` block by block (R rows a
block, :func:`fourstep._step3_layout`), each row through the mixed rows'
swizzled exchange planes at the addresses the kernel computes
(:func:`regcore.rows_mix_block`), the outputs written into the block's
swizzled stage and read back as the transposed runs of R floats, each row
finding its own batch. These tests hold the replays against complex128
numpy at every length of ``fused_fft._MIX_LENGTHS`` on each side, forward
and inverse; against the reference's ``offt_tpu.kernels.fourstep``
``_step1_twiddle`` and ``_step3_transposed`` in interpret mode at (2,
384, 128) and (2, 128, 640) (a caller's twiddle chunk; a step-3 block
spanning two batches, its rows' transforms taken from the reference on
the same rows laid out as one batch of 128, the only n1 its block takes);
and the two steps composed against its ``fft_four_step_planar`` at
3 * 2^14 and 5 * 2^14, on inputs made by numpy from a seed. Tolerance:
1e-6 of max |reference|, max-abs (f32 on both sides, sums in other
orders). They also pin step 3's layout at every mixed length, one
wavefront a warp instruction on both sides of its stage, its runs of
whole 32-byte sectors from R = 8, the lane tile step 1 takes, and the
routing through the C call's arguments (``fused_fft._launch``
monkeypatched): every mixed length launches the register core, 3072 and
144 the dense one. The kernels against their plain versions on the card
are ``tests/test_torch_cuda.py``'s."""

import numpy as np
import pytest
import torch

from offt_tpu.kernels import fourstep as rfs
from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.kernels import fourstep as fs
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.kernels import regcore as rc
from test_torch_regfourstep import (TOL, cplx, max_rel, np_step1, np_step3,
                                    pair, step1, step3, t)

MIX = sorted(ff._MIX_LENGTHS)


# ---- the replays against numpy, every mixed length -------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n1", MIX)
def test_step1_mixed_replay_matches_numpy(n1, inverse):
    """Two batches of 40 lanes: a ragged last tile on both tiles (32 lanes
    wide to P = 32; 64, 32 narrow; 16 and 8 at 768-2560)."""
    xr, xi = pair((2, n1, 40), n1 + inverse)
    got = step1(xr, xi, inverse, 0.375)
    assert not np.isnan(got[0].numpy()).any()
    assert max_rel(cplx(got), np_step1(cplx((xr, xi)), inverse, 0.375)) \
        < TOL


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n2", MIX)
def test_step3_mixed_replay_matches_numpy(n2, inverse):
    """15 rows of n1 = 5: blocks of R rows (64 at 48 and 80 down to 8 from
    384) span batches; the last is ragged."""
    zr, zi = pair((3, 5, n2), n2 + 7 + inverse)
    got = step3(zr, zi, inverse)
    assert got[0].shape == (3, n2, 5)
    assert not np.isnan(got[0].numpy()).any()
    assert max_rel(cplx(got), np_step3(cplx((zr, zi)), inverse)) < TOL


# ---- the replays against the reference in interpret mode -------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("caller_tw", [False, True])
def test_step1_mixed_replay_matches_reference(inverse, caller_tw):
    b, n1, n2 = 2, 384, 128
    xr, xi = pair((b, n1, n2), 70 + 2 * inverse + caller_tw)
    kw, tw = {}, None
    if caller_tw:
        # columns [128, 256) of a (384, 256) table with its own scale, as
        # the distributed engine passes a rank's chunk
        twr, twi = rfs._twiddle_planar(n1, 2 * n2, inverse, 0.5)
        twr, twi = twr[:, n2:].copy(), twi[:, n2:].copy()
        kw["tw"] = (twr, twi)
        tw = np.stack([twr, twi], -1)
    ref = rfs._step1_twiddle(xr, xi, n1, n2, pf._pick_stages(n1), inverse,
                             "highest", 0.25, 0, **kw)
    got = step1(xr, xi, inverse, 0.25, tw)
    assert max_rel(cplx(got), cplx(ref)) < TOL


@pytest.mark.parametrize("inverse", [False, True])
def test_step3_mixed_replay_matches_reference(inverse):
    b, n1, n2 = 2, 128, 640
    zr, zi = pair((b, n1, n2), 80 + inverse)
    ref = rfs._step3_transposed(zr, zi, n1, n2, pf._pick_stages(n2),
                                inverse, "highest", 0)
    got = step3(zr, zi, inverse)
    assert got[0].shape == (b, n2, n1)
    assert max_rel(cplx(got), cplx(ref)) < TOL


def test_step3_block_spanning_batches_matches_reference():
    """(3, 40, 48): 120 rows in blocks of 64, so the first block holds
    batch 0, batch 1 and 24 rows of batch 2. The reference's block takes
    n1 = 128 alone, so it transforms the same 120 rows (and 8 of zeros)
    as one batch of 128; batch b's output is its columns [40 b, 40 b +
    40)."""
    b, n1, n2 = 3, 40, 48
    zr, zi = pair((b, n1, n2), 90)
    rows = (np.zeros((1, 128, n2), np.float32),
            np.zeros((1, 128, n2), np.float32))
    rows[0][0, :b * n1], rows[1][0, :b * n1] = (zr.reshape(-1, n2),
                                                zi.reshape(-1, n2))
    ref = rfs._step3_transposed(*rows, 128, n2, pf._pick_stages(n2), False,
                                "highest", 0)
    want = cplx(ref)[0, :, :b * n1].reshape(n2, b, n1).transpose(1, 0, 2)
    assert fs._step3_layout(n2) == (64, 1)
    got = step3(zr, zi)
    assert max_rel(cplx(got), want) < TOL


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", [3 * 2 ** 14, 5 * 2 ** 14])
def test_mixed_replays_compose_to_the_reference_four_step(n, inverse):
    """3 * 2^14 splits as (128, 384), 5 * 2^14 as (128, 640): step 1 at a
    power of two, step 3 on the mixed rows."""
    n1, n2 = fs.pick_split(n)
    assert n2 in ff._MIX_LENGTHS and (n1, n2) == rfs.pick_split(n)
    xr, xi = pair((2, n), 100 + n2 + inverse)
    scale = 1.0 / n if inverse else 1.0
    ref = rfs.fft_four_step_planar(xr, xi, inverse=inverse)
    zr, zi = step1(xr.reshape(2, n1, n2), xi.reshape(2, n1, n2), inverse,
                   scale)
    yr, yi = step3(zr.numpy(), zi.numpy(), inverse)
    got = (yr.reshape(2, n), yi.reshape(2, n))
    assert max_rel(cplx(got), cplx(ref)) < TOL
    f = np.fft.ifft if inverse else np.fft.fft
    assert max_rel(cplx(got), f(cplx((xr, xi)), axis=-1)) < TOL


@pytest.mark.parametrize("n1,n2", [(384, 128), (128, 640), (1536, 48),
                                   (80, 2560)])
def test_plain_versions_agree_with_the_mixed_replays(n1, n2):
    """The wrappers' plain versions (the dense core's arithmetic on the
    CPU) and the mixed replays compute the same functions."""
    xr, xi = pair((2, n1, n2), n1 + n2 + 1)
    pr = fs._step1_twiddle(t(xr), t(xi), n1, n2, None, True, scale=0.5)
    assert max_rel(cplx(pr), cplx(step1(xr, xi, True, 0.5))) < TOL
    p3 = fs._step3_transposed(t(xr), t(xi), n1, n2, None, False)
    assert max_rel(cplx(p3), cplx(step3(xr, xi))) < TOL


# ---- the layout, the stage, the tile ---------------------------------------

# (R, threads) of step 3 at each mixed length: 256 / P rows in 256 threads
# to P = 32, then 8 rows in 8 P threads
LAYOUTS = {48: (64, 256), 80: (64, 256), 96: (32, 256), 160: (32, 256),
           192: (16, 256), 320: (16, 256), 384: (8, 256), 640: (8, 256),
           768: (8, 512), 1280: (8, 512), 1536: (8, 1024),
           2560: (8, 1024)}


@pytest.mark.parametrize("n2", MIX)
def test_step3_mixed_layout(n2):
    """One block a run (no cluster) at every mixed length, in the threads
    of LAYOUTS; the stage (2 n2 R floats) fits in the rows' exchange
    planes, and the blocks an SM is asked to hold fit its 228 KB: 160 KB
    at 2560 leaves one an SM, 80 KB at 1280 two."""
    r, threads = LAYOUTS[n2]
    g = rc.step3_geometry(n2)
    assert fs._step3_layout(n2) == (r, 1) == (g["R"], g["C"])
    assert g["threads"] == threads and g["P"] * g["V"] == n2
    assert g["ST"] == 2 * n2 * r * 4 <= g["EX"]
    blocks = 3 if threads == 256 else 1024 // threads
    assert blocks * (g["SMEM"] + 1024) <= 228 << 10
    assert g["SMEM"] <= 227 << 10
    if n2 == 2560:
        assert g["SMEM"] == 160 << 10 and blocks == 1


@pytest.mark.parametrize("n2", MIX)
def test_step3_mixed_stage_is_one_wavefront(n2):
    """The outputs' writes into the stage (element t + k P of each row)
    and the runs' reads back take one wavefront a warp instruction; so do
    the rows' own exchanges."""
    assert rc.step3_ways(n2) == {"put": 1, "get": 1}
    assert max(rc.bank_ways(n2).values()) == 1


@pytest.mark.parametrize("n2", MIX)
def test_step3_mixed_runs_are_whole_sectors(n2):
    """Runs of R >= 8 floats (whole 32-byte sectors) at every mixed
    length."""
    assert rc.step3_runs(n2) == min(32, LAYOUTS[n2][0]) >= 8


@pytest.mark.parametrize("n1", MIX)
def test_step1_mixed_tile(n1):
    """Step 1 takes the strided-axis kernel's tile at the same P (no half
    tile off 512 and 1024): narrow to P = 8, wide above; its exchanges
    take one wavefront, its warps move runs of at least 8 floats, and
    its blocks fit an SM's shared memory."""
    p = n1 // ff._reg_values(n1)
    want = "narrow" if p <= 8 else "wide"
    for b, n2 in ((1, 2048), (8, 1024)):
        assert fs._step1_tile(n1, n2, b, 132) == want
        g = rc.step1_tile(n1, n2, b)
        assert g["tile"] == want and g["threads"] == (
            256 if p <= 8 else min(32 * p, 1024))
    assert max(rc.col_bank_ways(n1, g["threads"]).values()) == 1
    assert min(32, g["L"]) >= 8
    cg = rc.col_geometry(n1, g["threads"])
    blocks = 3 if g["threads"] == 256 else 1024 // g["threads"]
    assert blocks * (cg["SMEM"] + 1024) <= 228 << 10


# ---- routing -----------------------------------------------------------------

def _launches(monkeypatch):
    calls = []
    monkeypatch.setattr(ff, "_launch", lambda entry, tensors, tabs, args:
                        calls.append((entry, args)))
    return calls


@pytest.mark.parametrize("n", MIX + [3072, 144, 4096, 6144])
def test_pair_routes_the_mixed_lengths(monkeypatch, n):
    """``_reg_core``: the mixed lengths (and powers of two) pass reg = 1
    to both C entry points, with no tile of the dense core and step 1's
    routed tile code; 3072, 144 (3^2 16) and 6144 pass reg = 0."""
    calls = _launches(monkeypatch)
    monkeypatch.setattr(fs, "_sms", lambda device: 132)
    reg = n in ff._MIX_LENGTHS or n == 4096
    assert ff._reg_core(n) is reg
    ff.reset_counts()
    z = torch.zeros((1, n, 8))
    fs._step1_twiddle.impl("kernel", z, z, n, 8, None, False)
    z = torch.zeros((1, 4, n))
    fs._step3_transposed.impl("kernel", z, z, 4, n, None, False)
    (e1, a1), (e3, a3) = calls
    assert (e1, e3) == ("offt_step1_twiddle", "offt_step3_transposed")
    assert a1[-2] == a3[-1] == int(reg)
    if reg:
        tile = fs._STEP1_TILES[fs._step1_tile(n, 8, 1, 132)]
        assert a1[-4] == a3[-3] == 0 and a1[-1] == tile
    else:
        assert a1[-4] > 0 and a3[-3] > 0 and a1[-1] == 0
    assert fs._step1_twiddle.reg_launches == int(reg)
    assert fs._step3_transposed.reg_launches == int(reg)


@pytest.mark.parametrize("n,split", [
    (3 * 2 ** 18, (1024, 768)), (3 * 2 ** 20, (1536, 2048)),
    (5 * 2 ** 20, (2048, 2560)), (5 * 2 ** 21, (2560, 4096)),
    (3 * 2 ** 16, (384, 512)), (5 * 2 ** 14, (128, 640)),
    (3 * 2 ** 21, (2048, 3072))])
def test_mixed_splits_take_the_register_core(n, split):
    """Every default split of 3 * 2^k and 5 * 2^k that reaches the pair
    has a mixed side, now on the register core; 3 * 2^21's 3072 side
    stays dense."""
    assert fs.pick_split(n) == split
    n1, n2 = split
    assert ff._reg_core(n1) and ff._reg_core(n2) is (n2 != 3072)
