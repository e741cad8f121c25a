"""The real rows at the smooth core's second family of half lengths M
(every 5-smooth M = R * 2^k, k >= 2, R = 3^a 5^b > 1, up to 4096, that
neither the first smooth family nor the mixed rows take:
``fused_fft._SMOOTH_MORE_LENGTHS``, 12-4000; ``csrc/real_rows_smooth3.cu``
and ``real_rows_smooth5.cu`` on the kernels of
``csrc/real_rows_smooth.cuh``): ``rfft_last_planar`` and
``icrfft_last_planar`` on the register core's smooth rows, on the CPU.

No CPU runs those kernels, so :mod:`offt_tpu_torch.kernels.regcore`
replays them block by block: :func:`regcore.rfft_rows_smooth_block` (the
smooth core on v[j] = x[2j] + i x[2j+1], V put in natural order into the
row's plane, the pairs (k, M - k) read back and untangled, the output rows
staged at :func:`regcore.stage_pitch` and copied out) and
:func:`regcore.rows_c2r_smooth_block` (the re-tangle, the inverse core,
float2 stores); rows of fewer than 6 threads (12-100) move through the
planes whole, in and out (:func:`regcore.smooth_stage_addrs`), the c2r
re-tangling each element as it copies it in. These tests pin the gate at
every length 8-8192 and the other gates at their values, the stage pitch
and the wavefronts of every put, read and copy (at most two), the maps
(one-to-one), hold the replays against complex128 numpy at every M, both
layouts, scaled, with a ragged last block (1e-6 of max |reference|,
max-abs: f32 on both sides, sums in other orders), hold the wrappers'
plain versions against the replays and, with the replays, against the
reference's ``pallas_fft.rfft_last_planar`` / ``icrfft_last_planar`` in
interpret mode (2e-6), and two local real plans against ``offt_tpu.plan``
(2e-6). Through the C call's arguments (``fused_fft._launch``
monkeypatched) they pin the core each wrapper launches. The kernels
against their plain versions on the card are ``tests/test_torch_cuda.py``'s.
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

ROWS = sorted(ff._SMOOTH_MORE_LENGTHS)
STAGED = (12, 20, 24, 36, 40, 60, 100)     # P < 6
TOL_REF = 2e-6      # against the reference's kernels and plans
# the reference's radices where its own pick, (18, 10) at 180 and (20, 25)
# at 500, takes two and five seconds a call in interpret mode; the radices
# do not change the function it computes
REF_RADICES = {180: (36, 5), 500: (100, 5)}


def odd_part(n):
    while n % 2 == 0:
        n //= 2
    return n


def smooth5(n):
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def pow2(n):
    return 16 <= n <= 4096 and n & (n - 1) == 0


def smooth_rows(n):
    """Every 5-smooth R 2^k, k >= 2, R > 1, to 4096: the mixed rows and
    both smooth families, the lengths the c2c rows take beside the powers
    of two."""
    return n <= 4096 and n % 4 == 0 and smooth5(n) and odd_part(n) > 1


def v0(n):
    return 20 if n % 25 == 0 or n % 3 else 12


def mix(n):
    return odd_part(n) in (3, 5) and 16 <= n // odd_part(n) <= 512


def odd_twice(n):
    """The odd and twice-odd 5-smooth R 2^k, k = 0, 1, R > 1, in [16,
    4096]: the c2c rows' third family, and the real rows' since it has
    instances of its own (``test_torch_regsmoothoddreal.py``)."""
    return (16 <= n <= 4096 and n % 4 and smooth5(n) and odd_part(n) > 1)


def odd_twice_col(n):
    """Those the column variant takes: all but 2187, 3375, 3645, 4050
    (P > 128) and 3750 (its planes past a block's shared memory)."""
    return odd_twice(n) and n not in (2187, 3375, 3645, 3750, 4050)


def seven(n):
    """The 7-smooth R 2^k, k >= 2, with a factor 7, to 4096: the c2c rows'
    fourth family (``test_torch_regsmooth7.py``); the real rows keep the
    dense core there."""
    r = odd_part(n)
    while r % 7 == 0:
        r //= 7
    return (n <= 4096 and n % 4 == 0 and odd_part(n) % 7 == 0
            and smooth5(r))


def seven_col(n):
    """Those the column variant takes: all but 3780, 3920, 4032 (P > 128)
    and 3024, 3136, 3360, 3584 (padded planes past a block's shared
    memory, four wavefronts unpadded)."""
    return seven(n) and n not in (3024, 3136, 3360, 3584, 3780, 3920, 4032)


# ---- the gates ------------------------------------------------------------

def test_the_second_family_of_half_lengths():
    """The 42 M, 12-4000: N = 2M from 24 to 8000 (200^3-2000^3 r2c among
    them, 360^3 and 432^3 too); each takes the register core's real rows
    now, none did before (the first smooth family, the mixed rows and the
    powers of two did)."""
    assert len(ROWS) == 42 and ROWS[0] == 12 and ROWS[-1] == 4000
    assert {100, 180, 216, 500, 1000} <= set(ROWS)
    for m in ROWS:
        assert ff._reg_real_rows(m) and smooth_rows(m)
        assert not (pow2(m) or m in ff._MIX_ROW_LENGTHS
                    or m in ff._SMOOTH_LENGTHS)


def test_real_rows_gate_over_every_length():
    """``_reg_real_rows`` at every M in 8-8192: the powers of two, the
    mixed rows, the first smooth family, the second family and the third
    family's odd and twice-odd M (``test_torch_regsmoothoddreal.py``); so
    the real rows take every length the c2c rows take but the fourth
    family's, the lengths with a factor 7."""
    for m in range(8, 8193):
        parent = (pow2(m) or m in ff._MIX_ROW_LENGTHS
                  or m in ff._SMOOTH_LENGTHS)
        assert ff._reg_real_rows(m) == (parent or m in ROWS
                                        or odd_twice(m)), m
        assert ff._reg_real_rows(m) == (pow2(m) or smooth_rows(m)
                                        or odd_twice(m)), m
        assert ff._reg_real_rows(m) == (ff._reg_rows(m)
                                        and not seven(m)), m


def test_other_gates_unchanged_over_every_length():
    """``_reg_rows``, ``_reg_axis``, ``_reg_core``, ``_reg_slab``,
    ``_reg_rslab`` and ``_reg_cube`` at every length 8-8192 (the slabs and
    the cube on the diagonal and against fixed second lengths), each
    against its definition written out from the lengths alone: the real
    rows' widening moves no other kernel's route (the c2c rows, columns
    and slab take the third family beside, ``test_torch_regsmoothodd.py``,
    and the fourth, ``test_torch_regsmooth7.py``)."""
    def cols(n):
        return (pow2(n) or (smooth_rows(n) and n // v0(n) <= 128)
                or odd_twice_col(n) or seven_col(n))

    for n in range(8, 8193):
        rows = pow2(n) or smooth_rows(n) or odd_twice(n) or seven(n)
        core = pow2(n) or mix(n)
        assert ff._reg_rows(n) == rows, n
        assert ff._reg_axis(n) == cols(n), n
        assert ff._reg_core(n) == core, n
        for ny, nz in ((n, n), (n, 128), (n, 100), (256, n), (360, n)):
            assert ff._reg_slab(ny, nz) == (
                cols(ny) and (pow2(nz) or smooth_rows(nz)
                              or odd_twice(nz) or seven(nz))), (ny, nz)
            assert ff._reg_rslab(ny, nz) == (
                (pow2(ny) or mix(ny))
                and (pow2(nz) or nz in ff._MIX_ROW_LENGTHS)), (ny, nz)
        for x, y, z in ((n, n, n), (8, 8, n), (n, 16, 128), (16, n, 256)):
            assert ff._reg_cube(x, y, z) == (
                (x < 16 or pow2(x)) and (y < 16 or pow2(y))
                and z & (z - 1) == 0 and 128 <= z <= 32768), (x, y, z)


# ---- the geometry, the stage pitch and the wavefronts ------------------------

@pytest.mark.parametrize("m", ROWS)
def test_r2c_stage_geometry(m):
    """The stage holds a numpy row (M + 1 lanes) a row at a pitch that is
    P mod 32 (M + 1 at P = 1), overlays the planes (the block takes the
    larger pitch) and with them fits the blocks an SM the launch bounds
    ask for (228 KB, 1 KB a block reserved); rows of fewer than 6 threads
    stage."""
    g = rc.smooth_geometry(m)
    sp = rc.stage_pitch(m)
    assert m + 1 <= sp < m + 33
    assert sp % 32 == ((m + 1) % 32 if g["P"] == 1 else g["P"] % 32)
    smem = rc.smooth_real_smem(m)
    assert smem == 2 * g["ROWS"] * max(sp, g["PITCH"]) * 4
    regs = 96 if g["V"] > 15 else 80
    minb = max(1, 65536 // (g["NT"] * regs))
    assert minb * (smem + 1024) <= 228 << 10
    assert g["STAGE"] == (m in STAGED)
    assert 3 * (g["SMEM"] + 1024) <= 228 << 10


def test_the_choice_of_stage_pitch():
    """P mod 32 keeps every put, read and copy of the r2c rows at two
    wavefronts at most at every M of both families but 12, whose copy out
    would take three; M + 1, the planes' pitch at P = 1, takes two there,
    and at 20 it cuts the stage from 33 floats a row to 21."""
    def ways_at(m, res):
        keep = rc.stage_pitch
        try:
            rc.stage_pitch = lambda mm: mm + 1 + (res - (mm + 1)) % 32
            return rc.r2c_smooth_ways(m)
        finally:
            rc.stage_pitch = keep

    ones = [m for m in ff._SMOOTH_ROWS if rc.smooth_geometry(m)["P"] == 1]
    assert sorted(ones) == [12, 20]
    assert all(rc.stage_pitch(m) == m + 1 for m in ones)
    assert max(ways_at(12, 1).values()) == 3
    assert max(ways_at(12, 13).values()) == 2
    assert ways_at(20, 1)["copy packed"] == 2
    assert rc.stage_pitch(20) == 21 and rc.stage_pitch(12) == 13
    for m in sorted(ff._SMOOTH_ROWS - {12, 20}):
        assert rc.stage_pitch(m) % 32 == rc.smooth_geometry(m)["P"] % 32


@pytest.mark.parametrize("m", ROWS)
def test_r2c_bank_ways(m):
    """Every put, read and copy of the r2c rows beyond the core takes two
    wavefronts at most: one wherever a block holds one row (P >= 128 but
    2000, 2400, 2500); the V[M - k] reads and stage writes and the copy
    take two at the others; the put and the V[k] reads too where the rows'
    pitch is not P mod 32 (the six of ``SMOOTH_ROW_PITCH`` at k = 2);
    thread 0's V[M/2] and the V[k] stage writes one."""
    ways = rc.r2c_smooth_ways(m)
    assert max(ways.values()) <= 2, ways
    assert ways["mid"] == ways["st_lo"] == 1
    geo = rc.smooth_geometry(m)
    assert (max(ways.values()) == 1) == (geo["ROWS"] == 1)
    special = m in rc.SMOOTH_ROW_PITCH and geo["P"] > 1
    assert (ways["put"] == ways["lo"] == 2) == special, ways


@pytest.mark.parametrize("m", STAGED)
def test_staged_rows_maps_and_ways(m):
    """The staged rows' copies in and out take each element of each of
    the block's rows once, at r PITCH + e, consecutive threads on
    consecutive elements (float2 runs of the block's contiguous rows in
    device memory); every copy, load and store of the planes two
    wavefronts at most."""
    g = rc.smooth_geometry(m)
    flat, r, e = rc.smooth_stage_addrs(m)
    assert torch.equal(r * m + e, torch.arange(g["ROWS"] * m))
    want = (torch.arange(g["ROWS"])[:, None] * g["PITCH"]
            + torch.arange(m)[None, :]).reshape(-1)
    assert torch.equal(flat, want)
    ways = rc.smooth_stage_ways(m)
    assert set(ways) == {"in", "out", "load", "store"}
    assert max(ways.values()) <= 2, ways


@pytest.mark.parametrize("m", ROWS)
def test_r2c_addresses_are_the_row_map(m):
    """V's natural-order put writes each element of each row once, at
    g PITCH + e; the untangle's reads take V[k] for k < M/2, V[M - k] for
    0 < k < M/2 and thread 0 V[M/2], each element of each row once."""
    geo = rc.smooth_geometry(m)
    p = geo["P"]
    ad = rc.r2c_smooth_addrs(m)
    tid = torch.arange(geo["NT"])
    g, t = tid // p, tid % p
    e = t[:, None] + p * torch.arange(ff._smooth_values(m))[None, :]
    assert torch.equal(ad["put"], g[:, None] * geo["PITCH"] + e)
    k = ad["k"]
    reads = torch.cat([ad["lo"].reshape(-1), ad["hi"][k > 0],
                       ad["mid"][t == 0]])
    slots = (torch.arange(geo["ROWS"])[:, None] * geo["PITCH"]
             + torch.arange(m)[None, :]).reshape(-1)
    assert sorted(reads.tolist()) == sorted(slots.tolist())
    assert sorted(ad["put"].reshape(-1).tolist()) == sorted(slots.tolist())


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", ROWS)
def test_r2c_stage_writes_are_one_to_one(m, packed):
    """The stage takes lane k and lane M - k of each pair (packed: no
    lane M) and thread 0's lane M/2: each of a row's lanes once, at
    g stage_pitch + lane; the copy out reads each once."""
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
    """Each thread loads element e of its row and the partner e ? M - e : 0
    (from the planes where the rows are staged): over a row's threads each
    lane once as e and once as the partner, but where the first pass is
    masked (60), whose masked butterfly loads nothing."""
    geo = rc.smooth_geometry(m)
    e, pe = rc.c2r_smooth_loads(m)
    _, live = rc._smooth_first_loads(m, torch.arange(geo["NT"]) % geo["P"])
    g = torch.arange(geo["NT"]) // geo["P"]
    for row in range(geo["ROWS"]):
        ok = live[g == row]
        assert sorted(e[g == row][ok].tolist()) == list(range(m))
        assert sorted(pe[g == row][ok].tolist()) == list(range(m))
    assert torch.equal(pe[live], ((m - e) % m)[live])
    assert bool(live.all()) == (m != 60)


# ---- the replays against numpy ----------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", ROWS)
def test_rfft_smooth_more_replay_matches_numpy(m, packed):
    """A ragged batch (one block and three rows more), scaled."""
    rows = rc.smooth_geometry(m)["ROWS"] + 3
    x = real_rows((rows, 2 * m), m + packed)
    got = rfft_replay(x, 0.375, packed)
    want = 0.375 * numpy_r2c(x, packed)
    assert got.shape == want.shape
    assert max_rel(got, want) < TOL


@pytest.mark.parametrize("m", ROWS)
def test_c2r_smooth_more_replay_matches_numpy(m):
    """A ragged batch, the scale 0.25 / M folded into the re-tangle."""
    rows = rc.smooth_geometry(m)["ROWS"] + 3
    x, re, im = packed_spectrum((rows,), 2 * m, seed=m)
    got = c2r_replay(re, im, 0.25 / m)
    assert got.shape == x.shape
    assert max_rel(got, 0.25 * x) < TOL


@pytest.mark.parametrize("m", [12, 60, 100, 108, 2000])
def test_rows_past_the_batch_are_never_read(m):
    """A block's rows past ``rows`` (NaN here) reach no valid row: the
    staged rows (12, 60, 100) copy zeros in for them and write nothing
    out; the others load per row. The c2r block leaves them unwritten."""
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

@pytest.mark.parametrize("m", [12, 100, 108, 500, 2700, 4000])
def test_plain_versions_agree_with_the_smooth_more_rows(m):
    """The wrappers' plain versions (the dense core's arithmetic) and the
    replays of the kernels they launch at these M (staged, K = 2 of each
    R0, a masked radix-3 pass at V0 = 20, one row a block)."""
    x = real_rows((7, 2 * m), m)
    for packed in (False, True):
        pr, pi = ff.rfft_last_planar(torch.from_numpy(x), packed=packed,
                                     scale=0.5)
        assert max_rel(cplx(pr, pi), rfft_replay(x, 0.5, packed)) < TOL
    _, re, im = packed_spectrum((7,), 2 * m, seed=m)
    out = ff.icrfft_last_planar(torch.from_numpy(re), torch.from_numpy(im))
    assert max_rel(out.numpy(), c2r_replay(re, im, 1.0 / m)) < TOL


# staged (12, 100), K = 2 at an odd P of each R0 (108, 180; 500), and the
# 1000^3 cube's M
REF_ROWS = [12, 100, 108, 180, 500, 1000]


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


@pytest.mark.parametrize("shape", [(4, 8, 200), (4, 8, 360)])
def test_local_real_plan_matches_the_reference(shape):
    """A real plan off the packed gate (M = 100, 180: not a multiple of
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
def test_real_wrappers_route_the_smooth_more_rows(monkeypatch, m):
    """Both layouts of ``rfft_last_planar`` and ``icrfft_last_planar``
    pass reg = 1 and no rows a block at every M of the second family;
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
