"""The real rows at the smooth core's third family of half lengths M (the
odd and twice-odd 5-smooth M = R * 2^k, k = 0, 1, R = 3^a 5^b > 1, in [16,
4096]: ``fused_fft._SMOOTH_ODD_LENGTHS``, 18-4050;
``csrc/real_rows_smooth_odd3.cu`` and ``real_rows_smooth_odd5.cu`` on the
kernels of ``csrc/real_rows_smooth.cuh``): ``rfft_last_planar`` and
``icrfft_last_planar`` on the register core's smooth rows, on the CPU.

No CPU runs those kernels, so :mod:`offt_tpu_torch.kernels.regcore`
replays them block by block (:func:`regcore.rfft_rows_smooth_block`,
:func:`regcore.rows_c2r_smooth_block`) on the third family's rows: V0 =
2^k d values a thread, P = M / V0 threads a row. An odd M has an odd V0
and P: the untangle's pairs (k, M - k), k = t + i P, i < V0 / 2, stop
short of (M - 1) / 2, so one more i, masked to 2k < M, takes the last
(P + 1) / 2 pairs, and there is no middle lane
(:func:`regcore.r2c_smooth_addrs`, ``live``). These tests pin the gate at
every length 8-8192 and the other gates at their values, the stage pitch,
the geometry and the wavefronts (two at most), that every lane of a numpy
or packed row is written once (the test an odd M's untangle needs), hold
the replays against complex128 numpy at every M, both layouts, scaled,
with a ragged last block (1e-6 of max |reference|, max-abs), the wrappers'
plain versions against the replays and both against the reference's
``pallas_fft.rfft_last_planar`` / ``icrfft_last_planar`` in interpret mode
(2e-6), and two local real plans against ``offt_tpu.plan`` (2e-6).
Through the C call's arguments (``fused_fft._launch`` monkeypatched) they
pin the core each wrapper launches. The kernels against their plain
versions on the card are ``tests/test_torch_cuda.py``'s.
"""

import numpy as np
import pytest
import torch

import offt_tpu
import offt_tpu_torch as ot
from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.kernels import regcore as rc
from offt_tpu_torch.kernels import tables as tb
from test_torch_regaxis import TOL, core_tab, max_rel
from test_torch_regmixed import packed_spectrum
from test_torch_regmixreal import c2r_replay, numpy_r2c, real_rows, \
    rfft_replay
from test_torch_regmixrows import _launches, cplx
from test_torch_regsmoothmorereal import mix, odd_twice, odd_twice_col, \
    pow2, seven, seven_col, smooth_rows, v0

ROWS = sorted(ff._SMOOTH_ODD_LENGTHS)
ODD = [m for m in ROWS if m % 2]
TWICE = [m for m in ROWS if m % 2 == 0]
# P < 6: the block's rows staged through the planes
STAGED = (18, 25, 27, 30, 45, 50, 54, 75, 90, 125, 150)
# one row a block (P > 128): every put, read and copy one wavefront
ONE_ROW = (2187, 3375, 3645, 4050)
TOL_REF = 2e-6      # against the reference's kernels and plans
# the reference's radices where its own pick, (25, 10) at 250 and (25, 15)
# at 375, takes three to five seconds a call in interpret mode; the radices
# do not change the function it computes
REF_RADICES = {250: (50, 5), 375: (75, 5)}


# ---- the gates ------------------------------------------------------------

def test_the_third_family_of_half_lengths():
    """The 42 M, 18-4050, 20 twice-odd and 22 odd: N = 2M from 36 to 8100
    (100^3-900^3 r2c among them); each takes the register core's real rows
    now, none did before."""
    assert len(ROWS) == 42 and ROWS[0] == 18 and ROWS[-1] == 4050
    assert len(TWICE) == 20 and len(ODD) == 22
    assert {50, 250, 375, 225, 450} <= set(ROWS)
    for m in ROWS:
        assert ff._reg_real_rows(m) and odd_twice(m)
        assert not (pow2(m) or m in ff._MIX_ROW_LENGTHS
                    or m in ff._SMOOTH_ROWS)


def test_real_rows_gate_and_the_others_over_every_length():
    """``_reg_real_rows`` at every M in 8-8192 is the parent's (powers of
    two, the mixed rows, both earlier smooth families) plus the 42, which
    is ``_reg_rows`` but at the fourth family's lengths (a factor 7, c2c
    only: ``test_torch_regsmooth7.py``); ``_reg_rows``, ``_reg_axis``,
    ``_reg_core``,
    ``_reg_slab``, ``_reg_rslab`` and ``_reg_cube`` keep their values, each
    written out from the lengths alone."""
    def cols(n):
        return (pow2(n) or (smooth_rows(n) and n // v0(n) <= 128)
                or odd_twice_col(n) or seven_col(n))

    for n in range(8, 8193):
        parent = pow2(n) or smooth_rows(n)
        assert ff._reg_real_rows(n) == (parent or odd_twice(n)), n
        assert ff._reg_real_rows(n) == (ff._reg_rows(n)
                                        and not seven(n)), n
        assert ff._reg_rows(n) == (parent or odd_twice(n) or seven(n)), n
        assert ff._reg_axis(n) == cols(n), n
        assert ff._reg_core(n) == (pow2(n) or mix(n)), n
        for ny, nz in ((n, n), (n, 250), (128, n)):
            assert ff._reg_slab(ny, nz) == (cols(ny) and ff._reg_rows(nz))
            assert ff._reg_rslab(ny, nz) == (
                (pow2(ny) or mix(ny))
                and (pow2(nz) or nz in ff._MIX_ROW_LENGTHS)), (ny, nz)
        for x, y, z in ((n, n, n), (8, 8, n)):
            assert ff._reg_cube(x, y, z) == (
                (x < 16 or pow2(x)) and (y < 16 or pow2(y))
                and z & (z - 1) == 0 and 128 <= z <= 32768), (x, y, z)


def test_the_tuner_reads_the_new_routes():
    """A real plan reads ``radix_z`` only where its rfft_last runs dense:
    (160, 160, 500), M = 250, reads none now; (176, 176, 352), M = 176 =
    11 16, reads radix_z, radix_y, radix_x and block_batch (the trial
    chip_smoke.py's tuning phase runs); (112, 112, 224), M = 112 = 7 16,
    reads radix_z alone: its axes of 112 run the fourth smooth family's
    register columns, its real rows the dense core."""
    from offt_tpu_torch.plan.params import ProblemSpec
    from offt_tpu_torch.tune.space import kernel_knobs

    assert kernel_knobs(ProblemSpec(shape=(160, 160, 500), real=True)) \
        == set()
    assert kernel_knobs(ProblemSpec(shape=(176, 176, 352), real=True)) == {
        "radix_z", "radix_y", "radix_x", "block_batch"}
    assert kernel_knobs(ProblemSpec(shape=(112, 112, 224), real=True)) == {
        "radix_z"}


# ---- the geometry, the stage pitch and the wavefronts ------------------------

@pytest.mark.parametrize("m", ROWS)
def test_r2c_stage_geometry(m):
    """The stage holds a numpy row (M + 1 lanes) a row at a pitch that is
    P mod 32 (M + 1 at P = 1: 18, 25, 30), overlays the planes (the block
    takes the larger pitch) and with them fits the blocks an SM the
    launch bounds ask for (228 KB, 1 KB a block reserved; 128 registers a
    thread past 21 values); the rows of fewer than 6 threads stage, and
    the c2r's planes fit too."""
    g = rc.smooth_geometry(m)
    sp = rc.stage_pitch(m)
    assert m + 1 <= sp < m + 33
    assert sp % 32 == ((m + 1) % 32 if g["P"] == 1 else g["P"] % 32)
    assert g["PITCH"] % 32 == rc.smooth_row_pitch(m) % 32
    smem = rc.smooth_real_smem(m)
    assert smem == 2 * g["ROWS"] * max(sp, g["PITCH"]) * 4
    regs = 128 if g["V"] > 21 else 96 if g["V"] > 15 else 80
    minb = max(1, 65536 // (g["NT"] * regs))
    assert minb * (smem + 1024) <= 228 << 10
    assert minb * (g["SMEM"] + 1024) <= 228 << 10
    assert g["STAGE"] == (m in STAGED)
    assert (g["ROWS"] == 1) == (m in ONE_ROW)


@pytest.mark.parametrize("m", ROWS)
def test_r2c_bank_ways(m):
    """Every put, read and copy of the r2c rows beyond the core takes two
    wavefronts at most (the worst over the 42: two, on the V[M - k] reads
    and stage writes and the copy out at every M of more than one row a
    block); one at the rows of one row a block; thread 0's V[M/2] (even M
    only) one, and the V[k] stage writes but at 25 (P = 1: the stage's
    even pitch M + 1 = 26 puts rows g and g + 16 of a warp on one bank);
    the staged copies two at most."""
    ways = rc.r2c_smooth_ways(m)
    assert max(ways.values()) <= 2, ways
    assert ways["st_lo"] == (2 if m == 25 else 1)
    assert ("mid" in ways) == (m % 2 == 0)
    if m % 2 == 0:
        assert ways["mid"] == 1
    assert (max(ways.values()) == 1) == (m in ONE_ROW), ways
    if m in STAGED:
        assert max(rc.smooth_stage_ways(m).values()) <= 2


def test_the_worst_wavefronts():
    """Over the 42 M the worst of any put, read or copy is two; the
    V[M - k] reads take two at 35 of them, one at the rows of P = 1 (18,
    25, 30) and of one row a block."""
    ways = {m: rc.r2c_smooth_ways(m) for m in ROWS}
    assert max(max(w.values()) for w in ways.values()) == 2
    assert [m for m, w in ways.items() if w["hi"] == 1] == [
        18, 25, 30, *ONE_ROW]


# ---- the maps: every lane once -----------------------------------------------

@pytest.mark.parametrize("m", ROWS)
def test_r2c_reads_cover_each_element_once(m):
    """V's natural-order put writes each element of each row once; the
    untangle's live reads take V[k] for k <= (M - 1) / 2, V[M - k] for
    0 < k and thread 0 V[M/2] at an even M: each element of each row
    once."""
    geo = rc.smooth_geometry(m)
    ad = rc.r2c_smooth_addrs(m)
    tid = torch.arange(geo["NT"])
    t = tid % geo["P"]
    k, live = ad["k"], ad["live"]
    reads = [ad["lo"][live], ad["hi"][live & (k > 0)]]
    if m % 2 == 0:
        reads.append(ad["mid"][t == 0])
    slots = (torch.arange(geo["ROWS"])[:, None] * geo["PITCH"]
             + torch.arange(m)[None, :]).reshape(-1)
    assert sorted(torch.cat(reads).tolist()) == sorted(slots.tolist())
    assert sorted(ad["put"].reshape(-1).tolist()) == sorted(slots.tolist())


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", ROWS)
def test_every_output_lane_is_written_once(m, packed):
    """The stage takes lane k and lane M - k of each live pair (packed:
    no lane M) and, at an even M, thread 0's lane M/2: lanes 0..M of a
    numpy row, 0..M - 1 of a packed one, each once, at g stage_pitch +
    lane; the copy out reads each once and writes each output lane once.
    At an odd M the pairs of i < V0 / 2 alone would leave the last
    (P + 1) / 2 pairs and their 2 (P + 1) / 2 lanes unwritten."""
    geo = rc.smooth_geometry(m)
    ad = rc.r2c_smooth_addrs(m)
    p = geo["P"]
    t = torch.arange(geo["NT"]) % p
    g = torch.arange(geo["NT"]) // p
    sp = rc.stage_pitch(m)
    k, live = ad["k"], ad["live"]
    hi = live & (k > 0) if packed else live
    got = [ad["st_lo"][live], ad["st_hi"][hi]]
    if m % 2 == 0:
        got.append((g * sp + m // 2)[t == 0])
    got = torch.cat(got)
    lanes = m if packed else m + 1
    want = (torch.arange(geo["ROWS"])[:, None] * sp
            + torch.arange(lanes)[None, :]).reshape(-1)
    assert sorted(got.tolist()) == sorted(want.tolist())
    src, dst = rc.r2c_mix_copy(m, lanes, lanes)
    assert sorted(src.tolist()) == sorted(want.tolist())
    assert torch.equal(dst, torch.arange(geo["ROWS"] * lanes))
    v = ff._smooth_values(m)
    short = ~live
    if m % 2:
        assert int(short.sum()) == geo["ROWS"] * (p - 1) // 2
        pairs = live[:, :v // 2]
        assert int(pairs.sum()) == geo["ROWS"] * (m - p) // 2
    else:
        assert not short.any() and live.shape[1] == v // 2


@pytest.mark.parametrize("m", ROWS)
def test_c2r_loads_are_one_to_one(m):
    """Each thread loads element e of its row and the partner e ? M - e : 0
    (from the planes where the rows are staged): over a row's threads
    each lane once as e and once as the partner; at an odd M no lane is
    its own partner."""
    geo = rc.smooth_geometry(m)
    e, pe = rc.c2r_smooth_loads(m)
    _, live = rc._smooth_first_loads(m, torch.arange(geo["NT"]) % geo["P"])
    g = torch.arange(geo["NT"]) // geo["P"]
    for row in range(geo["ROWS"]):
        ok = live[g == row]
        assert sorted(e[g == row][ok].tolist()) == list(range(m))
        assert sorted(pe[g == row][ok].tolist()) == list(range(m))
    assert torch.equal(pe[live], ((m - e) % m)[live])
    if m % 2:
        assert not ((pe == e) & (e > 0))[live].any()


# ---- the replays against numpy ----------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", ROWS)
def test_rfft_smooth_odd_replay_matches_numpy(m, packed):
    """A ragged batch (one block and three rows more), scaled."""
    rows = rc.smooth_geometry(m)["ROWS"] + 3
    x = real_rows((rows, 2 * m), m + packed + 26)
    got = rfft_replay(x, 0.375, packed)
    want = 0.375 * numpy_r2c(x, packed)
    assert got.shape == want.shape
    assert max_rel(got, want) < TOL


@pytest.mark.parametrize("m", ROWS)
def test_c2r_smooth_odd_replay_matches_numpy(m):
    """A ragged batch, the scale 0.25 / M folded into the re-tangle."""
    rows = rc.smooth_geometry(m)["ROWS"] + 3
    x, re, im = packed_spectrum((rows,), 2 * m, seed=m + 26)
    got = c2r_replay(re, im, 0.25 / m)
    assert got.shape == x.shape
    assert max_rel(got, 0.25 * x) < TOL


@pytest.mark.parametrize("m", [25, 50, 375, 4050])
def test_rows_past_the_batch_are_never_read(m):
    """A block's rows past ``rows`` (NaN here) reach no valid row: the
    staged rows (25, 50) copy zeros in for them and write nothing out; the
    others load per row. The c2r block leaves them unwritten."""
    geo = rc.smooth_geometry(m)
    k = geo["ROWS"] - 1 if geo["ROWS"] > 1 else 1
    x = torch.from_numpy(real_rows((geo["ROWS"], 2 * m), m))
    x[k:] = float("nan")
    w = torch.from_numpy(tb.rfft_table(2 * m).copy())
    yr, yi = rc.rfft_rows_smooth_block(x, core_tab(m, False), w, rows=k)
    assert yr.shape == (k, m + 1) and torch.isfinite(yr).all()
    assert torch.isfinite(yi).all()
    _, re, im = packed_spectrum((geo["ROWS"],), 2 * m, seed=m)
    re, im = torch.from_numpy(re), torch.from_numpy(im)
    re[k:] = float("nan")
    ab = torch.from_numpy(tb.crfft_table(2 * m, 1.0 / m).copy())
    out = rc.rows_c2r_smooth_block(re, im, core_tab(m, True), ab, k)
    assert torch.isfinite(out[:k]).all() and torch.isnan(out[k:]).all()


# ---- the plain versions and the reference's kernels --------------------------

@pytest.mark.parametrize("m", [25, 50, 225, 250, 2025, 4050])
def test_plain_versions_agree_with_the_smooth_odd_rows(m):
    """The wrappers' plain versions (the dense core's arithmetic) and the
    replays of the kernels they launch at these M (staged odd and
    twice-odd, odd and twice-odd of P = 15 and 25, 2025's masked radix-3
    passes at V0 = 25, one row a block)."""
    x = real_rows((7, 2 * m), m)
    for packed in (False, True):
        pr, pi = ff.rfft_last_planar(torch.from_numpy(x), packed=packed,
                                     scale=0.5)
        assert max_rel(cplx(pr, pi), rfft_replay(x, 0.5, packed)) < TOL
    _, re, im = packed_spectrum((7,), 2 * m, seed=m)
    out = ff.icrfft_last_planar(torch.from_numpy(re), torch.from_numpy(im))
    assert max_rel(out.numpy(), c2r_replay(re, im, 1.0 / m)) < TOL


# staged odd (25, 125), odd (375), staged twice-odd (50), twice-odd (250)
REF_ROWS = [25, 50, 125, 250, 375]


@pytest.mark.parametrize("m", REF_ROWS)
def test_rfft_last_matches_the_reference(m):
    """``rfft_last_planar`` of the port (its plain version) and the replay
    of the kernel it launches against ``pallas_fft.rfft_last_planar`` in
    interpret mode, both layouts, on the same rows."""
    x = real_rows((2, 3, 2 * m), 5 * m)
    for packed in (False, True):
        ref = cplx(*pf.rfft_last_planar(x, radices=REF_RADICES.get(m),
                                        packed=packed))
        pr, pi = ff.rfft_last_planar(torch.from_numpy(x), packed=packed)
        assert max_rel(cplx(pr, pi), ref) < TOL_REF
        assert max_rel(rfft_replay(x, 1.0, packed), ref) < TOL_REF


@pytest.mark.parametrize("m", REF_ROWS)
def test_icrfft_last_matches_the_reference(m):
    """``icrfft_last_planar`` of the port and the replay against
    ``pallas_fft.icrfft_last_planar`` in interpret mode, scaled."""
    _, re, im = packed_spectrum((5,), 2 * m, seed=7 * m)
    ref = np.asarray(pf.icrfft_last_planar(
        re, im, 2 * m, radices=REF_RADICES.get(m), scale=0.5 / m))
    out = ff.icrfft_last_planar(torch.from_numpy(re), torch.from_numpy(im),
                                scale=0.5 / m)
    assert max_rel(out.numpy(), ref) < TOL_REF
    assert max_rel(c2r_replay(re, im, 0.5 / m), ref) < TOL_REF


@pytest.mark.parametrize("shape", [(4, 8, 100), (4, 8, 250)])
def test_local_real_plan_matches_the_reference(shape):
    """A real plan off the packed gate (M = 50, twice-odd; 125, odd) takes
    the local route, rfft_last then y and x; its output against
    ``offt_tpu.plan``'s on the same input."""
    d = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    rp = offt_tpu.plan(shape, "float32", real=True, planar=True,
                       use_cache=False)
    pp = ot.plan(shape, "float32", real=True, planar=True, use_cache=False,
                 device="cpu")
    assert pp.route == "local"
    ref = cplx(*rp(d))
    ff.reset_counts()
    got = cplx(*pp(torch.from_numpy(d)))
    assert got.shape == ref.shape == (*shape[:-1], shape[-1] // 2 + 1)
    assert ff.rfft_last_planar.plain_calls == 1
    assert max_rel(got, ref) < TOL_REF
    assert max_rel(got, np.fft.rfftn(d.astype(np.float64))) < TOL_REF


# ---- routing ----------------------------------------------------------------

@pytest.mark.parametrize("m", ROWS)
def test_real_wrappers_route_the_smooth_odd_rows(monkeypatch, m):
    """Both layouts of ``rfft_last_planar`` and ``icrfft_last_planar``
    pass reg = 1 and no rows a block at every M of the third family;
    ``reg_launches`` counts them."""
    calls = _launches(monkeypatch)
    ff.reset_counts()
    for packed in (False, True):
        ff.rfft_last_planar.impl("kernel", torch.zeros((3, 2 * m)),
                                 packed=packed)
    x = torch.zeros((3, m))
    ff.icrfft_last_planar.impl("kernel", x, x)
    assert [entry for entry, _ in calls] == ["offt_rfft_last"] * 2 + [
        "offt_icrfft_last"]
    for _, args in calls[:2]:
        assert args[-1] == 1 and args[-4] == 0
    assert calls[2][1][-1] == 1 and calls[2][1][-2] == 0
    assert ff.rfft_last_planar.reg_launches == 2
    assert ff.icrfft_last_planar.reg_launches == 1
