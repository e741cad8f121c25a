"""The register core at the odd and twice-odd 5-smooth lengths
(``csrc/fft_smooth.cuh``'s third family: R 2^k, k = 0 or 1, R = 3^a 5^b
> 1, in [16, 4096]; ``fused_fft._SMOOTH_ODD_LENGTHS``), c2c only: the
rows of ``fft_last`` and of the c2c slab's z pass
(``csrc/fft_last_smooth_odd3.cu``, ``fft_last_smooth_odd5.cu``), the
column variant of the strided-axis kernel and of the slab's y pass at
most 128 threads a line (``csrc/fft_axis_smooth_odd3.cu``,
``fft_axis_smooth_odd5.cu``), on the CPU.

No CPU runs those kernels, so :mod:`offt_tpu_torch.kernels.regcore`
replays them block by block (:func:`regcore.smooth_rows_block`,
:func:`regcore.smooth_cols_block`): V0 = 2^k d values a thread
(``fused_fft._smooth_odd_values``: d of 3, 5, 9, 15, 25 dividing R,
V0 <= 30), P = n / V0 threads a line, odd; no radix-4 pass: one radix-3
or radix-5 pass per prime factor of R / d (masked where it does not
divide V0), then one pass of radix V0, the kernel's Good-Thomas or
Cooley-Tukey network (``regcore._net_split``); every exchange through the
block's planes at the addresses the kernel computes (the rows' pitch of
``regcore.smooth_row_pitch``, the columns unpadded). These tests pin the
admitted sets and every gate at 8-8192, the schedule and the choice of
V0, the pitch, the maps (one-to-one, the bank ways of
``regcore.smooth_ways``), hold the replay against complex128 numpy at
every new length, forward and inverse, scaled, ragged and in place, and
against the reference's ``pallas_fft.fft_last``, ``fft_sublane`` and
``fft_slab_yz`` in interpret mode, on inputs made by numpy from a seed
(tolerance 1e-6 of max |reference| against numpy, 2e-6 against the
reference, max-abs); through the C call's arguments
(``fused_fft._launch`` monkeypatched) they pin the core each wrapper
launches, and one c2c plan against ``offt_tpu.plan``. The kernels
against their plain versions on the card are
``tests/test_torch_cuda.py``'s."""

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

ROWS = sorted(ff._SMOOTH_ODD_LENGTHS)
COLS = sorted(ff._SMOOTH_ODD_COL_LENGTHS)
ROWS_ONLY = (2187, 3375, 3645, 3750, 4050)
# the tolerance against the reference's interpret-mode kernels
REF_TOL = 2e-6
# V0 at each length (the last pass's radix; P = n / V0)
V0 = {18: 18, 25: 25, 27: 9, 30: 30, 45: 15, 50: 10, 54: 18, 75: 15, 81: 9,
      90: 30, 125: 25, 135: 15, 150: 30, 162: 18, 225: 15, 243: 9, 250: 10,
      270: 30, 375: 15, 405: 15, 450: 30, 486: 18, 625: 25, 675: 15,
      729: 9, 750: 30, 810: 30, 1125: 15, 1215: 15, 1250: 10, 1350: 30,
      1458: 18, 1875: 15, 2025: 25, 2187: 9, 2250: 30, 2430: 30, 3125: 25,
      3375: 15, 3645: 15, 3750: 30, 4050: 30}
STAGED = (18, 25, 27, 30, 45, 50, 54, 75, 90, 125, 150)


def odd_part(n):
    while n % 2 == 0:
        n //= 2
    return n


def smooth35(n):
    for p in (3, 5):
        while n % p == 0:
            n //= p
    return n == 1


# ---- the lengths and the gates ----------------------------------------------

def test_admitted_lengths():
    """The 42 odd and twice-odd 5-smooth lengths of [16, 4096] as rows, the
    37 of them with P <= 128 and planes that fit a block as columns; the
    slab follows both; the real rows take all 42 as half lengths
    (``test_torch_regsmoothoddreal.py``); none is in another family's
    set."""
    want = {n for n in range(16, 4097) if n % 4 and odd_part(n) > 1
            and smooth35(odd_part(n))}
    assert ff._SMOOTH_ODD_LENGTHS == want and len(want) == 42
    assert set(COLS) == want - set(ROWS_ONLY) and len(COLS) == 37
    assert not want & (ff._SMOOTH_ROWS | ff._MIX_ROW_LENGTHS)
    for n in ROWS:
        assert ff._reg_rows(n)
        assert ff._reg_axis(n) == (n in COLS)
        assert ff._reg_slab(n, n) == (n in COLS)
        assert ff._reg_values(n) == ff._smooth_values(n) == V0[n]
        assert ff._reg_real_rows(n)
    for ny, nz in ((250, 250), (450, 750), (135, 270), (750, 4050),
                   (18, 90), (675, 2187)):
        assert ff._reg_slab(ny, nz)
    assert not ff._reg_slab(4050, 750) and not ff._reg_slab(250, 176)


def _parent_rows(n):
    return ff._pow2(n) or n in ff._MIX_ROW_LENGTHS or n in ff._SMOOTH_ROWS


def _parent_axis(n):
    return (ff._pow2(n) or n in ff._MIX_LENGTHS
            or n in ff._SMOOTH_COL_LENGTHS or n in ff._SMOOTH_MORE_COL_LENGTHS)


def _parent_real_rows(m):
    return ff._pow2(m) or m in ff._MIX_ROW_LENGTHS or m in ff._SMOOTH_ROWS


def _parent_cube_cols(n):
    return n < 16 or ff._pow2(n)


def test_every_gate_at_every_length():
    """At every n in 8-8192: ``_reg_rows`` and ``_reg_axis`` are the
    parent's plus the new sets (and the fourth family's, the lengths with
    a factor 7, ``test_torch_regsmooth7.py``); ``_reg_real_rows`` the
    parent's plus the
    same 42 as half lengths (``test_torch_regsmoothoddreal.py``);
    ``_reg_rslab``, ``_reg_core`` and ``_reg_cube`` (on the diagonal and
    against fixed second lengths) keep the parent's values."""
    for n in range(8, 8193):
        assert ff._reg_rows(n) == (_parent_rows(n)
                                   or n in ff._SMOOTH_ODD_LENGTHS
                                   or n in ff._SMOOTH7_LENGTHS), n
        assert ff._reg_axis(n) == (_parent_axis(n)
                                   or n in ff._SMOOTH_ODD_COL_LENGTHS
                                   or n in ff._SMOOTH7_COL_LENGTHS), n
        assert ff._reg_real_rows(n) == (_parent_real_rows(n)
                                        or n in ff._SMOOTH_ODD_LENGTHS), n
        assert ff._reg_core(n) == (ff._pow2(n) or n in ff._MIX_LENGTHS), n
        for ny, m in ((n, n), (n, 250), (250, n)):
            assert ff._reg_rslab(ny, m) == (
                (ff._pow2(ny) or ny in ff._MIX_LENGTHS)
                and (ff._pow2(m) or m in ff._MIX_ROW_LENGTHS)), (ny, m)
        for shape in ((n, n, n), (n, 16, 128), (16, n, 256), (8, 8, n)):
            x, y, z = shape
            assert ff._reg_cube(*shape) == (
                _parent_cube_cols(x) and _parent_cube_cols(y)
                and z & (z - 1) == 0 and 128 <= z <= 32768), shape


def test_lengths_that_stay_dense():
    """Under 16 (9, 10, 15), an odd or twice-odd length with a factor 7
    (21, 63, 126, 875), a prime factor of 11 or more (176), past 4096:
    dense rows and columns; the five rows-only lengths dense as columns
    alone: P > 128, or (3750) two planes of 8 lanes past the 227 KB of a
    block."""
    for n in (9, 10, 15, 21, 63, 126, 176, 875, 4374, 5000):
        assert not ff._reg_rows(n) and not ff._reg_axis(n), n
    for n in ROWS_ONLY:
        assert ff._reg_rows(n) and not ff._reg_axis(n)
        assert (n // V0[n] > 128) == (n != 3750)
    assert 2 * 3750 * 8 * 4 > 227 << 10 > 2 * 3125 * 8 * 4


# ---- the schedule and the choice of V0 --------------------------------------

def _cost(n, v0):
    """(passes before the last, masked butterfly slots a thread) of the
    schedule at V0 = v0."""
    sched = rc.smooth_schedule(n, v0)
    return len(sched) - 1, sum(r * b - v0 for r, _, b in sched[:-1])


@pytest.mark.parametrize("n", ROWS)
def test_smooth_odd_schedule(n):
    """The radices multiply to n; the last is V0 at stride P; no radix 4
    or 2 before it; every stride but the last divides P; a pass of radix
    r takes ceil(V0 / r) butterflies, masked exactly where r does not
    divide V0; R0's passes first (``regs::smooth_r0``); the values a
    thread holds are V0 or a masked pass's r B."""
    sched = rc.smooth_schedule(n)
    v0 = V0[n]
    p = n // v0
    assert np.prod([r for r, _, _ in sched]) == n
    assert sched[-1] == (v0, p, 1)
    r0 = 5 if odd_part(n) % 25 == 0 or odd_part(n) % 3 else 3
    odd_r = [r for r, _, _ in sched[:-1]]
    assert set(odd_r) <= {3, 5}
    assert odd_r == sorted(odd_r, key=lambda r: r != r0)
    for r, ns, b in sched[:-1]:
        assert p % ns == 0
        assert b == -(-v0 // r)
    assert rc.passes(n) == [(r, ns) for r, ns, _ in sched]
    vmax = max([v0] + [r * b for r, _, b in sched])
    assert rc.smooth_geometry(n)["V"] == vmax <= 30


@pytest.mark.parametrize("n", ROWS)
def test_the_choice_of_v0(n):
    """V0 = 2^k d, d of 3, 5, 9, 15, 25 dividing R, V0 <= 30: the least by
    (P > 128, the passes, the masked slots, V0) over every candidate's
    own schedule; P <= 1024 at every length, <= 128 but at the four
    rows-only ones (3750: P = 125). A V0 of another kind has no
    schedule."""
    two = n // odd_part(n)
    cands = [two * d for d in (3, 5, 9, 15, 25)
             if odd_part(n) % d == 0 and two * d <= 30]
    best = min(cands, key=lambda v: (n // v > 128, *_cost(n, v), v))
    assert ff._smooth_odd_values(n) == best == V0[n]
    assert n // V0[n] <= (128 if n in COLS or n == 3750 else 1024)
    with pytest.raises(ValueError, match="no radix"):
        rc.smooth_schedule(n, 7 * two)


def test_the_choice_in_words():
    """d = 15 wherever 15 divides R (no pass masked); else 9 at a power
    of 3 and 25 (k = 0) or 5 (k = 1, V0 = 50 past the budget) at a power
    of 5; but 2025, whose d = 15 leaves P = 135, takes d = 25 (P = 81)."""
    for n in ROWS:
        odd, two = odd_part(n), n // odd_part(n)
        d = (25 if n == 2025 else 15 if odd % 15 == 0
             else 9 if odd % 3 == 0 else 25 if two == 1 else 5)
        assert V0[n] == two * d, n


# ---- the geometry, the pitch, the maps and the banks ------------------------

@pytest.mark.parametrize("n", ROWS)
def test_smooth_odd_row_geometry(n):
    """256 / P rows a block (P odd: a short last warp), the pitch at
    :func:`regcore.smooth_row_pitch` mod 32; rows of fewer than 6
    threads staged; two blocks fit an SM."""
    g = rc.geometry(n)
    p = g["P"]
    assert p % 2 == 1 and p == n // V0[n]
    assert g["ROWS"] == max(1, 256 // p) and g["NT"] == g["ROWS"] * p
    assert g["PITCH"] % 32 == rc.smooth_row_pitch(n) % 32
    assert n <= g["PITCH"] < n + 32
    assert g["STAGE"] == (p < 6) == (n in STAGED)
    assert g["SMEM"] == 2 * g["ROWS"] * g["PITCH"] * 4
    assert 2 * (g["SMEM"] + 1024) <= 228 << 10


def test_the_choice_of_pitch():
    """The rows' pitch mod 32 is P mod 32 but at the 17 lengths of
    ``SMOOTH_ODD_ROW_PITCH``: at P = 1 (18, 25, 30) the odd n | 1, no
    exchange; at the others the least exchange cost over all 32 residues
    (:func:`regcore.smooth_exchange_cost`), ties to P mod 32, and that
    least is P mod 32 itself at 243 and 405 (P = 27)."""
    assert set(rc.SMOOTH_ODD_ROW_PITCH) == {
        18, 25, 30, 27, 45, 50, 54, 75, 81, 90, 125, 135, 150, 162, 225,
        270, 450}
    for n in (18, 25, 30):
        assert rc.geometry(n)["PITCH"] == n | 1
        assert rc.smooth_ways(n) == {}
    for n in ROWS:
        p = n // V0[n]
        if p == 1 or p >= 32:
            assert n in (18, 25, 30) or n not in rc.SMOOTH_ODD_ROW_PITCH
            continue
        if n not in rc.SMOOTH_ODD_ROW_PITCH and n not in (243, 405):
            # the other lengths of P < 32 at P mod 32 (the scan at two of
            # them, 243 and 405)
            assert rc.smooth_row_pitch(n) == p % 32
            continue
        costs = [rc.smooth_exchange_cost(n, pitch=r) for r in range(32)]
        best = min(range(32), key=lambda r: (costs[r], r != p % 32, r))
        assert rc.smooth_row_pitch(n) == best, n
        assert (n in rc.SMOOTH_ODD_ROW_PITCH) == (best != p % 32), n


@pytest.mark.parametrize("n", STAGED)
def test_smooth_odd_stage_ways(n):
    """The staged rows: the copies in and out, the core's loads from the
    planes and its stores back, two wavefronts at most."""
    ways = rc.smooth_stage_ways(n)
    assert set(ways) == {"in", "out", "load", "store"}
    assert max(ways.values()) <= 2


@pytest.mark.parametrize("n", COLS)
def test_smooth_odd_col_geometry(n):
    """L = 32 lanes to 768 threads, then 16, then 8: at most four row
    threads a warp; the planes unpadded; the routed tile the wide code."""
    g = rc.smooth_geometry(n, "cols")
    assert g["L"] in (8, 16, 32) and g["NT"] == g["L"] * g["P"] <= 1024
    assert g["W"] <= 4 and ff._axis_tile(n) == "wide"
    assert rc.axis_tile(n)["L"] == g["L"] == rc.warp_runs(n)
    assert not rc.smooth_col_pad(n)
    assert (g["SMEM"] == 0) == (n in (18, 25, 30))


@pytest.mark.parametrize("kind", ["rows", "cols"])
@pytest.mark.parametrize("n", ROWS)
def test_smooth_odd_maps_are_one_to_one(n, kind):
    """Each exchange's puts fill n distinct slots a line, and its gets
    read exactly the slots the puts wrote."""
    if kind == "cols" and n not in COLS:
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


# the rows' puts that take more than two wavefronts at every pitch residue
# (the strided passes' runs of NS elements NS R apart; 3 at twelve
# lengths, 4 at 675 and 1350)
PUTS4 = (675, 1350)
PUTS3 = (243, 405, 486, 810, 1125, 1250, 1875, 2250, 3125, 3375, 3750,
         4050)


@pytest.mark.parametrize("n", ROWS)
def test_smooth_odd_bank_ways(n):
    """Rows: every get one wavefront at the pitch P mod 32, two at the
    lengths of ``SMOOTH_ODD_ROW_PITCH`` (puts one or two there); the puts
    two at most but three at ``PUTS3`` and four at ``PUTS4``. Columns:
    every put and get two wavefronts at most, one where a warp holds one
    row thread (L = 32)."""
    rows = rc.smooth_ways(n)
    gets = [v for (_, k), v in rows.items() if k == "get"]
    puts = [v for (_, k), v in rows.items() if k == "put"]
    if n in (18, 25, 30):
        assert rows == {}
    elif n in rc.SMOOTH_ODD_ROW_PITCH:
        assert max(gets) == 2 and max(puts) <= 2
    else:
        assert all(v == 1 for v in gets)
        assert max(puts) == (4 if n in PUTS4 else 3 if n in PUTS3 else
                             max(puts)) and max(puts) <= 4
        assert (max(puts) > 2) == (n in PUTS3 + PUTS4)
    if n in COLS:
        cols = rc.smooth_ways(n, "cols")
        assert len(cols) == 2 * (len(rc.passes(n)) - 1)
        assert max(cols.values() or [1]) <= (
            1 if rc.smooth_geometry(n, "cols")["L"] == 32 else 2)


# ---- the networks -------------------------------------------------------------

@pytest.mark.parametrize("r", [6, 9, 10, 15, 18, 25, 30])
@pytest.mark.parametrize("inverse", [False, True])
def test_composite_networks(r, inverse):
    """The last pass's networks (Good-Thomas at 6, 10, 15, 18, 30,
    Cooley-Tukey at 9 and 25, nested) against complex128 numpy, and
    their operation counts."""
    xr, xi = pair((16, r), r + inverse)
    got = rc._net(torch.complex(torch.from_numpy(xr), torch.from_numpy(xi)),
                  r, inverse)
    want = dft(xr + 1j * xi.astype(np.float64), inverse)
    assert max_rel(got.numpy(), want) < TOL
    flops = {6: 44, 9: 120, 10: 116, 15: 224, 18: 276, 25: 576, 30: 508}
    assert rc._net_flops(r) == flops[r]


# ---- the replay against numpy -----------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", ROWS)
def test_smooth_odd_rows_replay_matches_numpy(n, inverse):
    """Scaled: forward a ragged batch (one block and three rows more),
    inverse one whole block."""
    rows = rc.geometry(n)["ROWS"] + (0 if inverse else 3)
    xr, xi = pair((rows, n), 2 * n + inverse)
    yr, yi = rc.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         core_tab(n, inverse), inverse, 0.375)
    want = 0.375 * dft(xr + 1j * xi.astype(np.float64), inverse)
    assert max_rel(cplx(yr, yi), want) < TOL


@pytest.mark.parametrize("n", [18, 125, 250, 675, 2187, 4050])
def test_smooth_odd_rows_replay_in_place(n):
    xr, xi = pair((2, 3, n), n + 1)
    ar, ai = torch.from_numpy(xr.copy()), torch.from_numpy(xi.copy())
    yr, yi = rc.fft_last(ar, ai, core_tab(n, True), True, 1.0 / n,
                         alias=True)
    assert yr is ar and yi is ai
    want = np.fft.ifft(xr + 1j * xi.astype(np.float64))
    assert max_rel(cplx(yr, yi), want) < TOL


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", COLS)
def test_smooth_odd_cols_replay_matches_numpy(n, inverse):
    """(1, n, 1, L + 5) along n forward: a ragged last tile; the inverse
    in place on one whole tile (1, n, 1, L)."""
    z = rc.smooth_geometry(n, "cols")["L"] + (0 if inverse else 5)
    xr, xi = pair((1, n, 1, z), 7 * n + inverse)
    got = axis_replay(xr, xi, n, inverse, 0.5, alias=inverse)
    want = 0.5 * dft(xr + 1j * xi.astype(np.float64), inverse, axis=1)
    assert max_rel(got, want) < TOL


# ---- the replay against the reference in interpret mode ---------------------

@pytest.mark.parametrize("shape,kw", [
    ((8, 18), {}), ((4, 125), {"inverse": True, "scale": 1 / 125}),
    ((4, 250), {"scale": 0.5}), ((4, 270), {}), ((4, 675), {}),
    ((2, 4050), {"inverse": True})])
def test_smooth_odd_rows_match_reference_fft_last(shape, kw):
    """A staged length (18), K = 0 and K = 1 of each R0 (125, 675; 250,
    270) and the largest (4050)."""
    xr, xi = pair(shape, sum(shape) + 25)
    ref = pf.fft_last(xr, xi, **kw)
    inv = kw.get("inverse", False)
    yr, yi = rc.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         core_tab(shape[-1], inv), inv, kw.get("scale", 1.0))
    assert max_rel(cplx(yr, yi), cplx(*ref)) < REF_TOL


@pytest.mark.parametrize("n,axis,kw", [
    (250, 0, {}), (675, 1, {"inverse": True, "scale": 0.5}),
    (18, 0, {"scale": 2.0})])
def test_smooth_odd_cols_match_reference_fft_sublane(n, axis, kw):
    shape = (n, 3, 8) if axis == 0 else (2, n, 8)
    xr, xi = pair(shape, n + axis + 25)
    ref = pf.fft_sublane(xr, xi, axis, **kw)
    pre, lanes = (1, 24) if axis == 0 else (2, 8)
    st = (n * lanes, lanes, lanes)
    inv = kw.get("inverse", False)
    ar, ai = torch.from_numpy(xr).reshape(-1), torch.from_numpy(xi).reshape(-1)
    yr, yi = torch.empty_like(ar), torch.empty_like(ai)
    rc.fft_axis(ar, ai, yr, yi, n, (pre, 1, lanes, st, st), core_tab(n, inv),
                inv, kw.get("scale", 1.0))
    assert max_rel(cplx(yr.reshape(shape), yi.reshape(shape)),
                   cplx(*ref)) < REF_TOL


@pytest.mark.parametrize("shape,kw", [
    ((1, 125, 270), {}),
    ((2, 50, 90), {"inverse": True, "scale": 1 / 4500, "zpad": 8})])
def test_smooth_odd_slab_matches_reference(shape, kw):
    xr, xi = pair(shape, sum(shape) + 25)
    ref = pf.fft_slab_yz(xr, xi, **kw)
    got = slab_replay(xr, xi, **kw)
    nz = shape[-1]
    assert got[0].shape == ref[0].shape
    assert max_rel(cplx(*got, nz), cplx(*ref, nz)) < REF_TOL


def test_plain_versions_agree_with_the_smooth_odd_replay():
    xr, xi = pair((4, 750), 5)
    pr, pi = ff.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         inverse=True, scale=0.5)
    yr, yi = rc.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         core_tab(750, True), True, 0.5)
    assert max_rel(cplx(pr, pi), cplx(yr, yi)) < TOL
    xr, xi = pair((1, 54, 150), 6)
    pr, pi = ff.fft_slab_yz(torch.from_numpy(xr), torch.from_numpy(xi))
    assert max_rel(cplx(pr, pi), cplx(*slab_replay(xr, xi))) < TOL
    xr, xi = pair((675, 2, 8), 7)
    pr, pi = ff.fft_sublane(torch.from_numpy(xr), torch.from_numpy(xi), 0)
    ar, ai = torch.from_numpy(xr).reshape(-1), torch.from_numpy(xi).reshape(-1)
    yr, yi = torch.empty_like(ar), torch.empty_like(ai)
    st = (675 * 16, 16, 16)
    rc.fft_axis(ar, ai, yr, yi, 675, (1, 1, 16, st, st), core_tab(675, False))
    assert max_rel(cplx(pr, pi), cplx(yr.reshape(675, 2, 8),
                                      yi.reshape(675, 2, 8))) < TOL


# ---- routing: the C call's arguments ----------------------------------------

def _launches(monkeypatch):
    calls = []
    monkeypatch.setattr(ff, "_launch", lambda entry, tensors, tabs, args:
                        calls.append((entry, args)))
    return calls


@pytest.mark.parametrize("n", [18, 25, 125, 250, 270, 750, 3645, 4050, 112,
                               126])
def test_fft_last_routes_the_smooth_odd_rows(monkeypatch, n):
    """126 (twice-odd, 63 2) stays dense; 112 (7 16) is the fourth
    family's."""
    calls = _launches(monkeypatch)
    x = torch.zeros((3, n))
    ff.reset_counts()
    ff.fft_last.impl("kernel", x, x)
    (entry, args), = calls
    assert entry == "offt_fft_last" and args[-1] == int(n != 126)
    assert ff.fft_last.reg_launches == int(n != 126)


@pytest.mark.parametrize("n", [18, 125, 250, 675, 750, 3750, 2187, 4050,
                               224, 126])
def test_fft_axis_routes_the_smooth_odd_columns(monkeypatch, n):
    """The column lengths launch the register core on the wide tile's
    code; 2187 and 4050 (P > 128), 3750 (its planes) and 126 stay dense;
    224 (7 32) is the fourth family's."""
    calls = _launches(monkeypatch)
    x = torch.zeros((2, n, 8))
    ff.fft_sublane.impl("kernel", x, x, 1)
    (entry, args), = calls
    reg, code = args[-2:]
    assert reg == int(n in COLS or n == 224)
    if reg:
        assert code == ff._AXIS_TILES["wide"]


@pytest.mark.parametrize("ny,nz,reg", [
    (250, 250, 1), (450, 750, 1), (135, 270, 1), (125, 3645, 1),
    (4050, 250, 0), (250, 112, 1), (250, 126, 0)])
def test_fft_slab_routes_the_smooth_odd_slabs(monkeypatch, ny, nz, reg):
    """Two grids (no cluster) on the smooth rows and columns."""
    calls = _launches(monkeypatch)
    x = torch.zeros((2, ny, nz))
    ff.fft_slab_yz.impl("kernel", x, x)
    (entry, args), = calls
    assert args[-3:-1] == [reg, 0]


def test_x_passes_route_the_smooth_odd_columns(monkeypatch):
    """The padded x passes at 250 and 675 launch the register core; at
    4050 the dense core."""
    calls = _launches(monkeypatch)
    for n in (250, 675, 4050):
        x = torch.zeros((n, 2, 136))
        ff.fft_x_from_padded.impl("kernel", x, x, 128)
        ff.fft_x_to_padded.impl("kernel", x[..., :128], x[..., :128])
    assert [args[-2] for _, args in calls] == [1, 1, 1, 1, 0, 0]


def test_c2c_plan_routes_and_matches_the_reference(monkeypatch):
    """(6, 30, 90) c2c: the slab (30, 90) and the x pass of 6 (dense,
    under 16), its values against ``offt_tpu.plan`` on the same input
    (2e-6 of max |reference|) and numpy (1e-6); on the kernel route the
    slab launches the register core."""
    rng = np.random.default_rng(25)
    shape = (6, 30, 90)
    x = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
         ).astype(np.complex64)
    rp = offt_tpu.plan(shape, "complex64", planar=True)
    rr, ri = rp((x.real.copy(), x.imag.copy()))
    p = ot.plan(shape, "complex64", planar=True, device="cpu")
    ff.reset_counts()
    yr, yi = p((torch.from_numpy(x.real.copy()),
                torch.from_numpy(x.imag.copy())))
    assert max_rel(cplx(yr, yi), cplx(rr, ri)) < REF_TOL
    assert max_rel(cplx(yr, yi), np.fft.fftn(x.astype(np.complex128))) < TOL
    ran = {k for k, (launches, plain) in ff.counts().items() if plain}
    assert "fft_slab_yz" in ran, ran
    calls = _launches(monkeypatch)
    ff.reset_counts()
    xr = torch.zeros(shape)
    ff.fft_slab_yz.impl("kernel", xr, xr)
    assert [e for e, _ in calls] == ["offt_fft_slab"]
    assert ff.fft_slab_yz.reg_launches == 1
