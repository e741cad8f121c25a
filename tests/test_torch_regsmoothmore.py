"""The register core at the 5-smooth lengths left on the dense core by the
first smooth family (``csrc/fft_smooth.cuh``'s second family: every
5-smooth R 2^k, k >= 2, R = 3^a 5^b > 1, up to 4096, that no other row
core takes; ``fused_fft._SMOOTH_MORE_LENGTHS``), c2c only: the rows of
``fft_last`` and of the c2c slab's z pass (``csrc/fft_last_smooth3.cu``,
``fft_last_smooth5.cu``), the column variant of the strided-axis kernel
and of the slab's y pass at most 128 threads a line
(``csrc/fft_axis_smooth3.cu``, ``fft_axis_smooth5.cu``), on the CPU.

No CPU runs those kernels, so :mod:`offt_tpu_torch.kernels.regcore`
replays them block by block (:func:`regcore.smooth_rows_block`,
:func:`regcore.smooth_cols_block`): V0 = 12 values a thread (20 where 25
divides the odd part or 3 does not), P = n / V0 threads a line; radix-4
passes (none at k = 2, a radix 2 where k is odd), one radix-R0 pass per
factor R0 of R / R0, one pass of the other odd prime per factor of it (a
radix-5 pass at V0 = 12 three butterflies a thread, a radix-3 pass at
V0 = 20 seven, the last masked), then one Good-Thomas pass of radix V0;
every exchange through the block's planes at the addresses the kernel
computes (the rows' pitch of ``regcore.smooth_row_pitch``, the columns
unpadded below k = 4). These tests pin the schedule, the choice of V0
and of the pitch, the maps (one-to-one, the bank ways of
``regcore.smooth_ways``), hold the replay against complex128 numpy at
every new length, forward and inverse, scaled, ragged and in place, and
against the reference's ``pallas_fft.fft_last``, ``fft_sublane`` and
``fft_slab_yz`` in interpret mode, on inputs made by numpy from a seed
(tolerance 1e-6 of max |reference|, max-abs, as
``test_torch_regmixrows.py`` states it); through the C call's arguments
(``fused_fft._launch`` monkeypatched) they pin the core each wrapper
launches, the real rows' and the other kernels' gates at their parent
values, and one c2c plan against ``offt_tpu.plan``. The kernels against
their plain versions on the card are ``tests/test_torch_cuda.py``'s."""

import numpy as np
import pytest
import torch

import offt_tpu
import offt_tpu_torch as ot
from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.kernels import regcore as rc
from test_torch_regaxis import TOL, core_tab, max_rel, pair
from test_torch_regsmooth import axis_replay, cplx, dft, slab_replay

ROWS = sorted(ff._SMOOTH_MORE_LENGTHS)
COLS = sorted(ff._SMOOTH_MORE_COL_LENGTHS)
ROWS_ONLY = (1620, 1728, 1944, 2160, 2592, 2700, 2916, 3000, 3240, 3456,
             3600, 3888, 4000)


def odd_part(n):
    while n % 2 == 0:
        n //= 2
    return n


def smooth5(n):
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


# ---- the lengths and the gates ----------------------------------------------

def test_admitted_lengths():
    """The 42 lengths with a factor 4 that the parent left dense as rows,
    the 29 of them with P <= 128 as columns; the slab follows both."""
    want = {n for n in range(8, 4097) if smooth5(n) and n % 4 == 0
            and odd_part(n) > 1 and n not in ff._SMOOTH_LENGTHS
            and n not in ff._MIX_ROW_LENGTHS}
    assert ff._SMOOTH_MORE_LENGTHS == want and len(want) == 42
    assert set(COLS) == want - set(ROWS_ONLY) and len(COLS) == 29
    for n in ROWS:
        assert ff._reg_rows(n)
        assert ff._reg_axis(n) == (n in COLS)
        assert ff._reg_slab(n, n) == (n in COLS)
        assert ff._reg_values(n) == ff._smooth_values(n)
    assert ff._reg_slab(1080, 1920) and ff._reg_slab(100, 216)
    assert not ff._reg_slab(1728, 1728) and ff._reg_slab(216, 1728)
    # the lengths that stay dense: under 16, a prime factor of 11 or more,
    # a factor 7 at a twice-odd length, and past 4096 (R 2^k, k >= 2, with
    # a factor 7: the fourth family, test_torch_regsmooth7.py)
    for n in (9, 10, 15, 126, 176, 352, 704, 1232, 2464, 4320, 5000):
        assert not ff._reg_rows(n) and not ff._reg_axis(n)


def _parent_real_rows(m):
    odd = odd_part(m)
    return (ff._pow2(m) or m in ff._MIX_ROW_LENGTHS
            or (odd in (9, 15, 25, 45) and m // odd >= 8 and m <= 4096))


def _parent_axis_pow2_mix(n):
    return ff._pow2(n) or n in ff._MIX_LENGTHS


def _parent_cube_cols(n):
    return n < 16 or ff._pow2(n)


def test_other_gates_keep_the_parents_values():
    """``_reg_real_rows``, ``_reg_rslab``, ``_reg_core`` and ``_reg_cube``
    at every length 8-8192 (the slabs and the cube on the diagonal and
    against a fixed second length) equal the definitions before the second
    family: c2c rows and columns, and the real rows at its half lengths
    (``test_torch_regsmoothmorereal.py``) and at the third family's
    (``test_torch_regsmoothoddreal.py``), nothing else."""
    for n in range(8, 8193):
        assert ff._reg_real_rows(n) == (_parent_real_rows(n)
                                        or n in ff._SMOOTH_MORE_LENGTHS
                                        or n in ff._SMOOTH_ODD_LENGTHS), n
        assert ff._reg_core(n) == _parent_axis_pow2_mix(n), n
        for ny, m in ((n, n), (n, 128), (n, 100), (256, n), (360, n)):
            assert ff._reg_rslab(ny, m) == (
                _parent_axis_pow2_mix(ny)
                and (ff._pow2(m) or m in ff._MIX_ROW_LENGTHS)), (ny, m)
        for shape in ((n, n, n), (8, 8, n), (n, 16, 128), (16, n, 256)):
            x, y, z = shape
            assert ff._reg_cube(*shape) == (
                _parent_cube_cols(x) and _parent_cube_cols(y)
                and z & (z - 1) == 0 and 128 <= z <= 32768), shape


# ---- the schedule -------------------------------------------------------------

# some schedules in full: (radix, stride, butterflies a thread)
SCHEDULES = {
    12: [(12, 1, 1)],
    20: [(20, 1, 1)],
    60: [(5, 1, 3), (12, 5, 1)],
    100: [(5, 1, 4), (20, 5, 1)],
    432: [(4, 1, 3), (3, 4, 4), (3, 12, 4), (12, 36, 1)],
    1000: [(2, 1, 10), (5, 2, 4), (5, 10, 4), (20, 50, 1)],
    1080: [(2, 1, 6), (3, 2, 4), (3, 6, 4), (5, 18, 3), (12, 90, 1)],
    2700: [(5, 1, 4), (3, 5, 7), (3, 15, 7), (3, 45, 7), (20, 135, 1)],
}


@pytest.mark.parametrize("n", ROWS)
def test_smooth_more_schedule(n):
    """The radices multiply to n; the last is V0 at stride P; every stride
    but the last divides P; only a radix-5 pass at V0 = 12 (three
    butterflies, 15 values) and a radix-3 pass at V0 = 20 (seven, 21
    values) are masked; the R0 passes come first."""
    sched = rc.smooth_schedule(n)
    odd = odd_part(n)
    v0 = 20 if odd % 25 == 0 or odd % 3 else 12
    p = n // v0
    assert ff._smooth_values(n) == v0
    assert np.prod([r for r, _, _ in sched]) == n
    assert sched[-1] == (v0, p, 1)
    odd_r = [r for r, _, _ in sched[:-1] if r in (3, 5)]
    assert odd_r == sorted(odd_r, key=lambda r: r != v0 // 4)
    for r, ns, b in sched[:-1]:
        assert p % ns == 0
        assert b == v0 // r or (r, b, v0) in ((5, 3, 12), (3, 7, 20))
    assert rc.passes(n) == [(r, ns) for r, ns, _ in sched]
    masked = {r for r, _, b in sched if r * b > v0}
    vmax = {frozenset(): v0, frozenset({5}): 15, frozenset({3}): 21}
    assert rc.smooth_geometry(n)["V"] == vmax[frozenset(masked)]
    if n in SCHEDULES:
        assert sched == SCHEDULES[n]


def _work(n, v0):
    p = n // v0
    return p * sum(b * (rc._net_flops(r) + (6 * (r - 1) if ns > 1 else 0))
                   for r, ns, b in rc.smooth_schedule(n, v0))


@pytest.mark.parametrize("n", [n for n in sorted(ff._SMOOTH_ROWS)
                               if odd_part(n) % 15 == 0])
def test_the_choice_of_v0(n):
    """Where 3 and 5 both divide the odd part, both V0 have a schedule:
    V0 = 20 where 25 divides it (one masked radix-3 pass per factor 3, 21
    values, fewer operations a line than V0 = 12's masked radix-5
    passes), V0 = 12 where it does not (one masked radix-5 pass, 15
    values, as the first family)."""
    s12, s20 = rc.smooth_schedule(n, 12), rc.smooth_schedule(n, 20)
    assert max(r * b for r, _, b in s12) == 15
    assert max(r * b for r, _, b in s20) == 21
    assert _work(n, 20) < _work(n, 12)
    assert ff._smooth_values(n) == (20 if odd_part(n) % 25 == 0 else 12)
    with pytest.raises(ValueError, match="no radix"):
        rc.smooth_schedule(100, 12)


# ---- the geometry, the maps and the banks -------------------------------------

@pytest.mark.parametrize("n", ROWS)
def test_smooth_more_row_geometry(n):
    """256 / P rows a block (one from P = 256; a short last warp at odd
    P), the pitch at :func:`regcore.smooth_row_pitch` mod 32; rows of
    fewer than 6 threads staged through the planes (12-100, the planes
    there at one pass too); three blocks fit an SM."""
    g = rc.geometry(n)
    p = g["P"]
    assert g["ROWS"] == max(1, 256 // p) and g["NT"] == g["ROWS"] * p <= max(
        256, p)
    assert g["PITCH"] % 32 == rc.smooth_row_pitch(n) % 32
    assert n <= g["PITCH"] < n + 32
    assert g["STAGE"] == (p < 6) == (n <= 100)
    assert g["SMEM"] == 2 * g["ROWS"] * g["PITCH"] * 4
    assert 3 * (g["SMEM"] + 1024) <= 228 << 10


def test_the_choice_of_pitch():
    """The rows' pitch mod 32 is P mod 32 but at six lengths of k = 2,
    where another residue takes fewer exchange wavefronts a line
    (:func:`regcore.smooth_exchange_cost`), and at 12 and 20 (P = 1, no
    exchange), where the odd n + 1 puts a warp's 32 staged rows on 32
    banks; at each of the six and at the other lengths of P < 32 the pick
    is the least over all 32 residues."""
    assert set(rc.SMOOTH_ROW_PITCH) == {12, 20, 36, 60, 100, 108, 180, 300}
    for n in (12, 20):
        assert rc.geometry(n)["PITCH"] == n + 1
        assert rc.smooth_ways(n) == {}
        assert rc.smooth_stage_ways(n)["load"] == 1
    for n in (24, 36, 40, 60, 100, 108, 180, 216, 300, 500):
        costs = [rc.smooth_exchange_cost(n, pitch=r) for r in range(32)]
        assert costs[rc.smooth_row_pitch(n)] == min(costs), n
        p = n // ff._smooth_values(n)
        if n in rc.SMOOTH_ROW_PITCH:
            assert costs[rc.smooth_row_pitch(n)] < costs[p % 32]
        else:
            assert rc.smooth_row_pitch(n) == p % 32


def test_rows_only_lengths_stay_dense_as_columns():
    """The 13 lengths of P > 128 keep the dense core as columns: a column
    block there would hold 4 lanes (runs of 16 bytes a row thread, eight
    row threads a warp), its exchanges at two wavefronts, three at 1620
    and 2916 (the layout of ``SmoothColGeo`` counted at L = 4), and
    3240, 3456 and 3888 would need more than 1024 threads a block."""
    ways, big = {}, set()
    for n in ROWS_ONLY:
        p = n // ff._smooth_values(n)
        tid = torch.arange(4 * p)
        lane, t = tid % 4, tid // 4
        pad = rc.smooth_col_pad(n)
        w = rc._exchange_ways(n, t, lambda a: (a + (a >> 2 if pad else 0))
                              * 4 + lane, False)
        ways[n] = max(w.values())
        if 4 * p > 1024:
            big.add(n)
        assert not ff._reg_axis(n) and p > 128
    assert {n for n, w in ways.items() if w == 3} == {1620, 2916}
    assert set(ways.values()) == {2, 3} and big == {3240, 3456, 3888}


@pytest.mark.parametrize("n", [12, 20, 24, 36, 40, 60, 100])
def test_smooth_more_stage_ways(n):
    """The staged rows: the copies in and out, the core's loads from the
    planes and its stores back, two wavefronts at most."""
    ways = rc.smooth_stage_ways(n)
    assert set(ways) == {"in", "out", "load", "store"}
    assert max(ways.values()) <= 2


@pytest.mark.parametrize("n", COLS)
def test_smooth_more_col_geometry(n):
    """L = 32 lanes to 768 threads, then 16, then 8: at most four row
    threads a warp; the planes padded from k = 4 (a radix-4 pass first);
    the routed tile is the wide code."""
    g = rc.smooth_geometry(n, "cols")
    assert g["L"] in (8, 16, 32) and g["NT"] == g["L"] * g["P"] <= 1024
    assert g["W"] <= 4 and ff._axis_tile(n) == "wide"
    assert rc.axis_tile(n)["L"] == g["L"] == rc.warp_runs(n)
    assert rc.smooth_col_pad(n) == ((n // odd_part(n)) >= 16)
    assert (g["SMEM"] == 0) == (n in (12, 20))


@pytest.mark.parametrize("kind", ["rows", "cols"])
@pytest.mark.parametrize("n", ROWS)
def test_smooth_more_maps_are_one_to_one(n, kind):
    """Each exchange's puts fill n distinct slots a line, and its gets
    read exactly the slots the puts wrote."""
    if kind == "cols" and n not in ff._SMOOTH_MORE_COL_LENGTHS:
        return
    t, addr = rc.smooth_addr(n, kind)
    p = rc.smooth_geometry(n, kind)["P"]
    sched = rc.smooth_schedule(n)
    nt = len(t)
    for (r, ns, b), (r2, _, b2) in zip(sched, sched[1:]):
        put, get = [], []
        x = (t // ns) * ns * r + t % ns
        for q in range(b):
            ok = t + q * p < n // r
            for k in range(r):
                put.append(addr(x + q * p * r + k * ns)[ok])
        for q in range(b2):
            ok = t + q * p < n // r2
            for k in range(r2):
                get.append(addr(t + q * p + k * (n // r2))[ok])
        put, get = torch.cat(put), torch.cat(get)
        assert len(put) == len(set(put.tolist())) == nt // p * n
        assert set(put.tolist()) == set(get.tolist())


@pytest.mark.parametrize("n", ROWS)
def test_smooth_more_bank_ways(n):
    """Rows: every get one wavefront at the pitch P mod 32 and two at the
    six of ``SMOOTH_ROW_PITCH``, where the puts take two too; the puts up
    to four elsewhere (the first family's bound). Columns: every put and
    get two wavefronts at most, one where a warp holds one row thread
    (L = 32)."""
    rows = rc.smooth_ways(n)
    gets = [v for (_, k), v in rows.items() if k == "get"]
    if n in (12, 20):
        assert rows == {}               # one pass, no exchange
    elif n in rc.SMOOTH_ROW_PITCH:
        assert max(rows.values()) == 2
    else:
        assert all(v == 1 for v in gets)
        assert max(rows.values() or [1]) <= 4
    if n in ff._SMOOTH_MORE_COL_LENGTHS:
        cols = rc.smooth_ways(n, "cols")
        assert len(cols) == 2 * (len(rc.passes(n)) - 1)
        assert max(cols.values() or [1]) <= (
            1 if rc.smooth_geometry(n, "cols")["L"] == 32 else 2)


# ---- the replay against numpy -----------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", ROWS)
def test_smooth_more_rows_replay_matches_numpy(n, inverse):
    """A ragged batch (one block and three rows more), scaled."""
    rows = rc.geometry(n)["ROWS"] + 3
    xr, xi = pair((rows, n), 2 * n + inverse)
    yr, yi = rc.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         core_tab(n, inverse), inverse, 0.375)
    want = 0.375 * dft(xr + 1j * xi.astype(np.float64), inverse)
    assert max_rel(cplx(yr, yi), want) < TOL


@pytest.mark.parametrize("n", [12, 60, 100, 1000, 2700, 4000])
def test_smooth_more_rows_replay_in_place(n):
    xr, xi = pair((2, 3, n), n + 1)
    ar, ai = torch.from_numpy(xr.copy()), torch.from_numpy(xi.copy())
    yr, yi = rc.fft_last(ar, ai, core_tab(n, True), True, 1.0 / n,
                         alias=True)
    assert yr is ar and yi is ai
    want = np.fft.ifft(xr + 1j * xi.astype(np.float64))
    assert max_rel(cplx(yr, yi), want) < TOL


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", COLS)
def test_smooth_more_cols_replay_matches_numpy(n, inverse):
    """(2, n, 1, L + 5) along n: a ragged last tile; the inverse in
    place."""
    z = rc.smooth_geometry(n, "cols")["L"] + 5
    xr, xi = pair((2, n, 1, z), 7 * n + inverse)
    got = axis_replay(xr, xi, n, inverse, 0.5, alias=inverse)
    want = 0.5 * dft(xr + 1j * xi.astype(np.float64), inverse, axis=1)
    assert max_rel(got, want) < TOL


# ---- the replay against the reference in interpret mode ---------------------

@pytest.mark.parametrize("shape,kw", [
    ((8, 100), {}), ((8, 216), {"inverse": True, "scale": 1 / 216}),
    ((4, 1000), {"scale": 0.5})])
def test_smooth_more_rows_match_reference_fft_last(shape, kw):
    xr, xi = pair(shape, sum(shape) + 23)
    ref = pf.fft_last(xr, xi, **kw)
    inv = kw.get("inverse", False)
    yr, yi = rc.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         core_tab(shape[-1], inv), inv, kw.get("scale", 1.0))
    assert max_rel(cplx(yr, yi), cplx(*ref)) < TOL


@pytest.mark.parametrize("n,axis,kw", [
    (108, 0, {}), (108, 1, {"inverse": True, "scale": 0.5}),
    (500, 0, {"scale": 2.0}), (500, 1, {})])
def test_smooth_more_cols_match_reference_fft_sublane(n, axis, kw):
    shape = (n, 3, 8) if axis == 0 else (2, n, 8)
    xr, xi = pair(shape, n + axis + 23)
    ref = pf.fft_sublane(xr, xi, axis, **kw)
    pre, lanes = (1, 24) if axis == 0 else (2, 8)
    st = (n * lanes, lanes, lanes)
    inv = kw.get("inverse", False)
    ar, ai = torch.from_numpy(xr).reshape(-1), torch.from_numpy(xi).reshape(-1)
    yr, yi = torch.empty_like(ar), torch.empty_like(ai)
    rc.fft_axis(ar, ai, yr, yi, n, (pre, 1, lanes, st, st), core_tab(n, inv),
                inv, kw.get("scale", 1.0))
    assert max_rel(cplx(yr.reshape(shape), yi.reshape(shape)),
                   cplx(*ref)) < TOL


@pytest.mark.parametrize("shape,kw", [
    ((1, 100, 216), {}),
    ((2, 100, 216), {"inverse": True, "scale": 1 / 21600, "zpad": 8})])
def test_smooth_more_slab_matches_reference(shape, kw):
    xr, xi = pair(shape, sum(shape) + 23)
    ref = pf.fft_slab_yz(xr, xi, **kw)
    got = slab_replay(xr, xi, **kw)
    nz = shape[-1]
    assert got[0].shape == ref[0].shape
    assert max_rel(cplx(*got, nz), cplx(*ref, nz)) < TOL


def test_plain_versions_agree_with_the_smooth_more_replay():
    xr, xi = pair((4, 1080), 5)
    pr, pi = ff.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         inverse=True, scale=0.5)
    yr, yi = rc.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         core_tab(1080, True), True, 0.5)
    assert max_rel(cplx(pr, pi), cplx(yr, yi)) < TOL
    xr, xi = pair((1, 300, 432), 6)
    pr, pi = ff.fft_slab_yz(torch.from_numpy(xr), torch.from_numpy(xi))
    assert max_rel(cplx(pr, pi), cplx(*slab_replay(xr, xi))) < TOL


# ---- routing: the C call's arguments ----------------------------------------

def _launches(monkeypatch):
    calls = []
    monkeypatch.setattr(ff, "_launch", lambda entry, tensors, tabs, args:
                        calls.append((entry, args)))
    return calls


@pytest.mark.parametrize("n", [12, 20, 60, 100, 216, 1000, 1080, 4000, 112,
                               176])
def test_fft_last_routes_the_smooth_more_rows(monkeypatch, n):
    """176 (a factor 11) stays on the dense core; 112 (7 16) is the fourth
    family's."""
    calls = _launches(monkeypatch)
    x = torch.zeros((3, n))
    ff.reset_counts()
    ff.fft_last.impl("kernel", x, x)
    (entry, args), = calls
    assert entry == "offt_fft_last" and args[-1] == int(n != 176)
    assert ff.fft_last.reg_launches == int(n != 176)


@pytest.mark.parametrize("n", [12, 36, 100, 432, 1000, 1080, 2500, 1620,
                               1728, 4000])
def test_fft_axis_routes_the_smooth_more_columns(monkeypatch, n):
    """The column lengths launch the register core on the wide tile's
    code; 1620, 1728 and 4000 (P > 128) stay dense."""
    calls = _launches(monkeypatch)
    x = torch.zeros((2, n, 8))
    ff.fft_sublane.impl("kernel", x, x, 1)
    (entry, args), = calls
    reg, code = args[-2:]
    assert reg == int(n in COLS)
    if reg:
        assert code == ff._AXIS_TILES["wide"]


@pytest.mark.parametrize("ny,nz,reg", [
    (100, 100, 1), (1000, 1000, 1), (216, 432, 1), (1080, 1728, 1),
    (1728, 128, 0), (112, 100, 1), (176, 100, 0)])
def test_fft_slab_routes_the_smooth_more_slabs(monkeypatch, ny, nz, reg):
    """Two grids (no cluster) on the smooth rows and columns."""
    calls = _launches(monkeypatch)
    x = torch.zeros((2, ny, nz))
    ff.fft_slab_yz.impl("kernel", x, x)
    (entry, args), = calls
    assert args[-3:-1] == [reg, 0]


@pytest.mark.parametrize("m", [90, 250, 270, 1350])
def test_real_rows_stay_dense(monkeypatch, m):
    """The real slabs' rows at the twice-odd 5-smooth half lengths keep the
    dense core (``_reg_rslab`` keeps its sets): the r2c and c2r slabs
    (``rfft_slab_yz``, ``irfft_slab_yz``) at (Y, M) = (128, m) launch
    reg = 0. ``rfft_last_planar`` and ``icrfft_last_planar`` take these M
    on the third family's real rows (``test_torch_regsmoothoddreal.py``)."""
    calls = _launches(monkeypatch)
    ff.reset_counts()
    ff.rfft_slab_yz.impl("kernel", torch.zeros((3, 128, 2 * m)))
    ff.irfft_slab_yz.impl("kernel", torch.zeros((3, 128, m + 8)),
                          torch.zeros((3, 128, m + 8)), 2 * m)
    assert [e for e, _ in calls] == ["offt_rfft_slab", "offt_irfft_slab"]
    assert calls[0][1][-3] == 0 and calls[1][1][-2] == 0
    assert not ff._reg_rslab(128, m) and ff._reg_real_rows(m)
    assert ff.rfft_slab_yz.reg_launches == 0
    assert ff.irfft_slab_yz.reg_launches == 0


def test_c2c_plan_routes_and_matches_the_reference(monkeypatch):
    """(12, 36, 100) c2c: the slab (36, 100) and the x pass of 12, its
    values against ``offt_tpu.plan`` on the same input (1e-6 of max
    |reference|); on the kernel route the slab and the x pass launch the
    register core."""
    rng = np.random.default_rng(23)
    shape = (12, 36, 100)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
         ).astype(np.complex64)
    rp = offt_tpu.plan(shape, "complex64", planar=True)
    rr, ri = rp((x.real.copy(), x.imag.copy()))
    p = ot.plan(shape, "complex64", planar=True, device="cpu")
    ff.reset_counts()
    yr, yi = p((torch.from_numpy(x.real.copy()),
                torch.from_numpy(x.imag.copy())))
    assert max_rel(cplx(yr, yi), cplx(rr, ri)) < TOL
    assert max_rel(cplx(yr, yi), np.fft.fftn(x.astype(np.complex128))) < TOL
    ran = {k for k, (launches, plain) in ff.counts().items() if plain}
    assert ran == {"fft_slab_yz", "fft_sublane"}, ran
    calls = _launches(monkeypatch)
    ff.reset_counts()
    xr = torch.zeros(shape)
    ff.fft_slab_yz.impl("kernel", xr, xr)
    ff.fft_sublane.impl("kernel", xr, xr, 0)
    assert [e for e, _ in calls] == ["offt_fft_slab", "offt_fft_axis"]
    assert ff.fft_slab_yz.reg_launches == 1
    assert ff.fft_sublane.reg_launches == 1
