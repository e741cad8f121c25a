"""The real rows at the smooth half lengths M = R * 2^k, R = 9, 15, 25, 45
(``csrc/real_rows_smooth.cu``:
``rfft_last_planar`` and ``icrfft_last_planar`` on the register core's
smooth rows), on the CPU.

No CPU runs those kernels, so :mod:`offt_tpu_torch.kernels.regcore`
replays them block by block: :func:`regcore.rfft_rows_smooth_block` (the
smooth core on v[j] = x[2j] + i x[2j+1], V put in natural order into the
row's plane, the pairs (k, M - k) read back and untangled, the output rows
staged at :func:`regcore.stage_pitch` and copied out) and
:func:`regcore.rows_c2r_smooth_block` (the re-tangle as the core loads,
the partner lane e ? M - e : 0, the inverse core, float2 stores), every
shared-memory address the one the kernel computes
(:func:`regcore.r2c_smooth_addrs`, :func:`regcore.c2r_smooth_loads`).
These tests pin those maps (one-to-one, the stage pitch, the wavefronts of
:func:`regcore.r2c_smooth_ways`), hold the replays against complex128
numpy at every M of ``fused_fft._SMOOTH_LENGTHS``, both layouts, scaled,
with a ragged last block (1e-6 of max |reference|, max-abs: f32 on both
sides, sums in other orders), hold the wrappers' plain versions against
the replays and, with the replays, against the reference's
``pallas_fft.rfft_last_planar`` / ``icrfft_last_planar`` in interpret mode
(2e-6), and two local real plans against ``offt_tpu.plan`` (2e-6).
Through the C call's arguments (``fused_fft._launch`` monkeypatched) they
pin the core each wrapper launches, and the real slabs' routes that keep
theirs. The kernels against their plain versions on the card are
``tests/test_torch_cuda.py``'s."""

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

ROWS = sorted(ff._SMOOTH_LENGTHS)
TOL_REF = 2e-6      # against the reference's kernels and plans
# the reference's radices where its own pick, (20, 10) at 200 and (20, 18)
# at 360, takes three to five seconds a call in interpret mode; the radices
# do not change the function it computes
REF_RADICES = {200: (25, 8), 360: (40, 9)}


# ---- the geometry and the addresses -----------------------------------------

def test_smooth_half_lengths():
    """The 21 smooth M, 72-3840: N = 2M from 144 (the 144^3 r2c cube) to
    7680; each takes the register core's real rows, none the real slabs'
    rows at their pitch."""
    assert len(ROWS) == 21 and ROWS[0] == 72 and ROWS[-1] == 3840
    assert all(ff._reg_real_rows(m) for m in ROWS)


@pytest.mark.parametrize("m", ROWS)
def test_r2c_stage_geometry(m):
    """The stage holds a numpy row (M + 1 lanes) a row at a pitch that is
    P mod 32 (rows straddling a warp P banks apart, as in the exchange
    planes), at least the planes' pitch, and with them fits the blocks an
    SM the launch bounds ask for (228 KB, 1 KB a block reserved)."""
    g = rc.smooth_geometry(m)
    sp = rc.stage_pitch(m)
    assert m + 1 <= sp < m + 33 and sp >= g["PITCH"]
    assert sp % 32 == g["P"] % 32
    smem = 2 * g["ROWS"] * sp * 4
    regs = 96 if g["V"] > 15 else 80
    minb = max(1, 65536 // (g["NT"] * regs))
    assert minb * (smem + 1024) <= 228 << 10


@pytest.mark.parametrize("m", ROWS)
def test_r2c_addresses_are_the_row_map(m):
    """V's natural-order put writes each element of each row once, at
    g PITCH + e (no pad, no swizzle); the untangle's reads take V[k] for
    k < M/2, V[M - k] for 0 < k < M/2 and thread 0 V[M/2], each element of
    each row once."""
    geo = rc.smooth_geometry(m)
    p = geo["P"]
    v0 = ff._smooth_values(m)
    ad = rc.r2c_smooth_addrs(m)
    tid = torch.arange(geo["NT"])
    g, t = tid // p, tid % p
    e = t[:, None] + p * torch.arange(v0)[None, :]
    assert torch.equal(ad["put"], g[:, None] * geo["PITCH"] + e)
    k = ad["k"]
    assert torch.equal(k, e[:, :v0 // 2])
    live = k > 0
    reads = torch.cat([ad["lo"].reshape(-1), ad["hi"][live],
                       ad["mid"][t == 0]])
    slots = (torch.arange(geo["ROWS"])[:, None] * geo["PITCH"]
             + torch.arange(m)[None, :]).reshape(-1)
    assert sorted(reads.tolist()) == sorted(slots.tolist())
    assert sorted(ad["put"].reshape(-1).tolist()) == sorted(slots.tolist())


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", ROWS)
def test_r2c_stage_writes_are_one_to_one(m, packed):
    """The stage takes lane k and lane M - k of each pair (the packed
    layout: no lane M) and thread 0's lane M/2: each of a row's M + 1 (or
    M) lanes once, at g stage_pitch + lane; the copy out reads each once."""
    geo = rc.smooth_geometry(m)
    ad = rc.r2c_smooth_addrs(m)
    tid = torch.arange(geo["NT"])
    g, t = tid // geo["P"], tid % geo["P"]
    sp = rc.stage_pitch(m)
    hi = ad["st_hi"][ad["k"] > 0] if packed else ad["st_hi"].reshape(-1)
    got = torch.cat([ad["st_lo"].reshape(-1), hi,
                     (g * sp + m // 2)[t == 0]])
    lanes = m if packed else m + 1
    want = (torch.arange(geo["ROWS"])[:, None] * sp
            + torch.arange(lanes)[None, :]).reshape(-1)
    assert sorted(got.tolist()) == sorted(want.tolist())
    src, dst = rc.r2c_mix_copy(m, lanes, lanes)
    assert sorted(src.tolist()) == sorted(want.tolist())
    assert torch.equal(dst, torch.arange(geo["ROWS"] * lanes))


@pytest.mark.parametrize("m", ROWS)
def test_c2r_loads_are_one_to_one(m):
    """Each thread loads element e of its row and the re-tangle's partner
    e ? M - e : 0 (not the power of two's (M - e) & (M - 1)): over a row's
    threads each lane once as e and once as the partner."""
    geo = rc.smooth_geometry(m)
    e, pe = rc.c2r_smooth_loads(m)
    g = torch.arange(geo["NT"]) // geo["P"]
    for row in range(geo["ROWS"]):
        assert sorted(e[g == row].reshape(-1).tolist()) == list(range(m))
        assert sorted(pe[g == row].reshape(-1).tolist()) == list(range(m))
    assert torch.equal(pe, (m - e) % m)


@pytest.mark.parametrize("m", ROWS)
def test_r2c_bank_ways(m):
    """The put of V, the V[k] reads, the V[k] stage writes and thread 0's
    V[M/2] take one wavefront (consecutive slots of consecutive rows at a
    pitch of P mod 32); the V[M - k] reads and stage writes at most two
    (slots g P - t mod 32 meet twice where a warp starts inside a row); so
    does the copy out of the stage, a warp's 32 floats crossing a row
    whose pitch is not its lanes mod 32. One wavefront wherever a row
    takes whole warps (P a multiple of 32)."""
    ways = rc.r2c_smooth_ways(m)
    for name in ("put", "lo", "st_lo", "mid"):
        assert ways[name] == 1, (name, ways)
    assert max(ways.values()) <= 2, ways
    if rc.smooth_geometry(m)["P"] % 32 == 0:
        assert ways["hi"] == ways["st_hi"] == 1


# ---- the replays against numpy ----------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", ROWS)
def test_rfft_smooth_replay_matches_numpy(m, packed):
    """A ragged batch (one block and three rows more), scaled."""
    rows = rc.smooth_geometry(m)["ROWS"] + 3
    x = real_rows((rows, 2 * m), m + packed)
    got = rfft_replay(x, 0.375, packed)
    want = 0.375 * numpy_r2c(x, packed)
    assert got.shape == want.shape
    assert max_rel(got, want) < TOL


@pytest.mark.parametrize("m", ROWS)
def test_c2r_smooth_replay_matches_numpy(m):
    """A ragged batch, the scale 0.25 / M folded into the re-tangle."""
    rows = rc.smooth_geometry(m)["ROWS"] + 3
    x, re, im = packed_spectrum((rows,), 2 * m, seed=m)
    got = c2r_replay(re, im, 0.25 / m)
    assert got.shape == x.shape
    assert max_rel(got, 0.25 * x) < TOL


def test_r2c_replay_at_a_slab_pitch():
    """The copy out at an output pitch past the lanes (the argument the C
    launcher takes, for the real slabs of a later kernel): each row's lanes
    where the contiguous layout puts them, the pad lanes never written."""
    m, zpad = 240, 8
    x = real_rows((rc.smooth_geometry(m)["ROWS"] + 1, 2 * m), 7)
    w = torch.from_numpy(tb.rfft_table(2 * m).copy())
    yr, yi = rc.rfft_rows(torch.from_numpy(x), core_tab(m, False), w,
                          packed=True, opitch=m + zpad)
    assert yr.shape == (x.shape[0], m + zpad)
    assert torch.isnan(yr[:, m:]).all() and torch.isnan(yi[:, m:]).all()
    assert max_rel(cplx(yr[:, :m], yi[:, :m]), rfft_replay(x, 1.0, True)) \
        == 0


# ---- the plain versions and the reference's kernels --------------------------

@pytest.mark.parametrize("m", [72, 200, 1440, 3840])
def test_plain_versions_agree_with_the_smooth_rows(m):
    """The wrappers' plain versions (the dense core's arithmetic) and the
    replays of the kernels they launch at these M (odd parts 9, 25, 45
    and 15)."""
    x = real_rows((7, 2 * m), m)
    for packed in (False, True):
        pr, pi = ff.rfft_last_planar(torch.from_numpy(x), packed=packed,
                                     scale=0.5)
        assert max_rel(cplx(pr, pi), rfft_replay(x, 0.5, packed)) < TOL
    _, re, im = packed_spectrum((7,), 2 * m, seed=m)
    out = ff.icrfft_last_planar(torch.from_numpy(re), torch.from_numpy(im))
    assert max_rel(out.numpy(), c2r_replay(re, im, 1.0 / m)) < TOL


@pytest.mark.parametrize("m", [72, 200, 240, 360])
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


@pytest.mark.parametrize("m", [72, 200, 240, 360])
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


@pytest.mark.parametrize("shape", [(4, 8, 144), (4, 8, 720)])
def test_local_real_plan_matches_the_reference(shape):
    """A real plan off the packed gate (M = 72, 360: not a multiple of
    128) takes the local route, rfft_last then y and x; its output against
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
def test_real_wrappers_route_the_smooth_rows(monkeypatch, m):
    """Both layouts of ``rfft_last_planar`` and ``icrfft_last_planar``
    pass reg = 1 and no rows a block at every smooth M;
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


@pytest.mark.parametrize("m", [*ROWS, 100, 180, 1800, 256, 384])
def test_real_slabs_keep_their_rows(m):
    """``_reg_rslab`` routes every (Y, M) as before the smooth real rows:
    the real slabs write their rows at the pitch M + zpad, which only the
    power-of-two and mixed instances take, so a smooth M keeps the slabs on
    the dense core at every Y, as do the other 5-smooth M; a power of two
    or a mixed M keeps its route."""
    pow2 = {1 << k for k in range(4, 13)}
    for ny in sorted(pow2 | ff._MIX_ROW_LENGTHS | ff._SMOOTH_LENGTHS
                     | {8, 24, 40, 100, 180, 6144}):
        parent = ((ny in pow2 or ny in ff._MIX_LENGTHS)
                  and (m in pow2 or m in ff._MIX_ROW_LENGTHS))
        assert ff._reg_rslab(ny, m) is parent, ny
        if m in ff._SMOOTH_LENGTHS:
            assert not parent
