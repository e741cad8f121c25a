"""The register core at the lengths with a factor 7
(``csrc/fft_smooth.cuh``'s fourth family: R 2^k, k >= 2, R = 3^a 5^b 7^c
with c >= 1, up to 4096; ``fused_fft._SMOOTH7_LENGTHS``), c2c only: the
rows of ``fft_last`` and of the c2c slab's z pass
(``csrc/fft_last_smooth7.cu``, ``fft_last_smooth7x3.cu``,
``fft_last_smooth7x5.cu``), the column variant of the strided-axis kernel
and of the slab's y pass at most 128 threads a line with planes that fit a
block (``csrc/fft_axis_smooth7*.cu``), on the CPU.

No CPU runs those kernels, so :mod:`offt_tpu_torch.kernels.regcore`
replays them block by block (:func:`regcore.smooth_rows_block`,
:func:`regcore.smooth_cols_block`): V0 = 4 R0 values a thread
(``fused_fft._smooth7_values``: R0 of 3, 5, 7 dividing R), P = n / V0
threads a line; radix-4 passes over 2^(k-2) (a radix 2 last where k is
odd), one pass per further odd prime factor, R0's first, then the others
in ascending order (masked where the radix does not divide V0), then one
pass of radix V0, the Good-Thomas 3 x 4, 5 x 4 or 7 x 4 network
(``regcore.dft_pfa``; the 7-point network ``regcore._dft7``); every
exchange through the block's planes at the addresses the kernel computes
(the rows' pitch of ``regcore.smooth_row_pitch``, the columns padded from
k = 4). These tests pin the admitted sets and every gate at 8-8192 (the
real rows, the real slabs, the four-step pair and the cube keep the
parent's values), the schedule and the choice of R0, the pitch, the maps
(one-to-one, the bank ways of ``regcore.smooth_ways``), hold the replay
against complex128 numpy at every new length, forward and inverse, scaled,
ragged and in place, and against the reference's ``pallas_fft.fft_last``,
``fft_sublane`` and ``fft_slab_yz`` in interpret mode, on inputs made by
numpy from a seed (tolerance 1e-6 of max |reference|, max-abs, against
both); through the C call's arguments (``fused_fft._launch``
monkeypatched) they pin the core each wrapper launches, and one c2c plan
against ``offt_tpu.plan``. The kernels against their plain versions on the
card are ``tests/test_torch_cuda.py``'s (``-k smooth7``)."""

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

ROWS = sorted(ff._SMOOTH7_LENGTHS)
COLS = sorted(ff._SMOOTH7_COL_LENGTHS)
# rows only: P > 128 (3780, 3920, 4032) or padded planes past a block's
# shared memory (3024, 3136, 3360, 3584; unpadded, four wavefronts)
ROWS_ONLY = (3024, 3136, 3360, 3584, 3780, 3920, 4032)
# V0 at each length (the last pass's radix; P = n / V0)
V0 = {28: 28, 56: 28, 84: 12, 112: 28, 140: 20, 168: 12, 196: 28, 224: 28,
      252: 12, 280: 20, 336: 12, 392: 28, 420: 20, 448: 28, 504: 12,
      560: 20, 588: 28, 672: 12, 700: 20, 756: 12, 784: 28, 840: 20,
      896: 28, 980: 20, 1008: 12, 1120: 20, 1176: 28, 1260: 20, 1344: 12,
      1372: 28, 1400: 20, 1512: 12, 1568: 28, 1680: 20, 1764: 28, 1792: 28,
      1960: 20, 2016: 28, 2100: 20, 2240: 20, 2268: 28, 2352: 28, 2520: 20,
      2688: 28, 2744: 28, 2800: 28, 2940: 28, 3024: 28, 3136: 28, 3360: 28,
      3500: 28, 3528: 28, 3584: 28, 3780: 20, 3920: 20, 4032: 12}
STAGED = (28, 56, 112)
# the rows' worst put of a length, where it passes two wavefronts (the
# strided passes' runs of NS elements NS R apart, as the earlier families')
PUTS = {n: 4 for n in (252, 448, 756, 896, 1260, 1344, 1792, 2240, 2688,
                       3136, 3584, 4032)}
PUTS.update({n: 3 for n in (168, 280, 392, 420, 504, 588, 672, 700, 840,
                            980, 1120, 1176, 1372, 1400, 1512, 1568, 1960,
                            2016, 2100, 2520, 2744, 2940, 3024, 3360, 3500,
                            3528)})


def odd_part(n):
    while n % 2 == 0:
        n //= 2
    return n


def smooth357(n):
    for p in (3, 5, 7):
        while n % p == 0:
            n //= p
    return n == 1


# ---- the lengths and the gates ----------------------------------------------

def test_admitted_lengths():
    """The 56 lengths R 2^k of [28, 4032] with k >= 2 and a 7-smooth odd
    part that 7 divides as rows, the 49 of them with P <= 128 and planes
    that fit a block as columns; the slab follows both; the real rows keep
    the dense core at all 56; none is in another family's set."""
    want = {n for n in range(16, 4097) if n % 4 == 0
            and odd_part(n) % 7 == 0 and smooth357(odd_part(n))}
    assert ff._SMOOTH7_LENGTHS == want and len(want) == 56
    assert set(COLS) == want - set(ROWS_ONLY) and len(COLS) == 49
    assert not want & (ff._SMOOTH_CORE | ff._MIX_ROW_LENGTHS)
    for n in ROWS:
        assert ff._reg_rows(n)
        assert ff._reg_axis(n) == (n in COLS)
        assert ff._reg_slab(n, n) == (n in COLS)
        assert ff._reg_values(n) == ff._smooth_values(n) == V0[n]
        assert not ff._reg_real_rows(n)
    for ny, nz in ((224, 224), (784, 896), (336, 168), (28, 56),
                   (3528, 4032), (1008, 1008)):
        assert ff._reg_slab(ny, nz)
    assert not ff._reg_slab(4032, 224) and not ff._reg_slab(224, 176)


def _parent_rows(n):
    return ff._pow2(n) or n in ff._MIX_ROW_LENGTHS or n in ff._SMOOTH_CORE


def _parent_axis(n):
    return (ff._pow2(n) or n in ff._MIX_LENGTHS
            or n in ff._SMOOTH_COL_LENGTHS or n in ff._SMOOTH_MORE_COL_LENGTHS
            or n in ff._SMOOTH_ODD_COL_LENGTHS)


def test_every_gate_at_every_length():
    """At every n in 8-8192: ``_reg_rows`` and ``_reg_axis`` are the
    parent's plus the new sets; ``_reg_real_rows``, ``_reg_rslab``,
    ``_reg_core`` and ``_reg_cube`` (on the diagonal and against fixed
    second lengths) keep the parent's values."""
    for n in range(8, 8193):
        assert ff._reg_rows(n) == (_parent_rows(n)
                                   or n in ff._SMOOTH7_LENGTHS), n
        assert ff._reg_axis(n) == (_parent_axis(n)
                                   or n in ff._SMOOTH7_COL_LENGTHS), n
        assert ff._reg_real_rows(n) == _parent_rows(n), n
        assert ff._reg_core(n) == (ff._pow2(n) or n in ff._MIX_LENGTHS), n
        for ny, m in ((n, n), (n, 112), (224, n)):
            assert ff._reg_rslab(ny, m) == (
                (ff._pow2(ny) or ny in ff._MIX_LENGTHS)
                and (ff._pow2(m) or m in ff._MIX_ROW_LENGTHS)), (ny, m)
        for shape in ((n, n, n), (n, 16, 128), (16, n, 256), (8, 8, n)):
            x, y, z = shape
            assert ff._reg_cube(*shape) == (
                (x < 16 or ff._pow2(x)) and (y < 16 or ff._pow2(y))
                and z & (z - 1) == 0 and 128 <= z <= 32768), shape


def test_lengths_that_stay_dense():
    """An odd or twice-odd length with a factor 7 (21, 63, 126, 3969), a
    prime factor of 11 or more (176, 352, 1232), past 4096: dense rows and
    columns; the seven rows-only lengths dense as columns alone: P > 128,
    or padded planes of 8 lanes past the 227 KB of a block (unpadded,
    four wavefronts a put and a get: :func:`test_the_columns_left_dense`)."""
    for n in (21, 63, 126, 3969, 176, 352, 1232, 4116, 5488):
        assert not ff._reg_rows(n) and not ff._reg_axis(n), n
    for n in ROWS_ONLY:
        assert ff._reg_rows(n) and not ff._reg_axis(n)
        p = n // V0[n]
        assert (p > 128) == (n in (3780, 3920, 4032))
        assert (ff._smooth_col_bytes(n, V0[n], True) > ff._SMEM_MAX
                or p > 128)


def test_the_columns_left_dense(monkeypatch):
    """3024, 3136, 3360 and 3584 at 8 lanes: padded, planes of 236-280 KB;
    unpadded they fit, but a put or a get takes four wavefronts."""
    monkeypatch.setattr(ff, "_SMOOTH_COLS", ff._SMOOTH_COLS | {
        3024, 3136, 3360, 3584})
    kb = []
    for n in (3024, 3136, 3360, 3584):
        assert rc.smooth_geometry(n, "cols")["SMEM"] > ff._SMEM_MAX
        kb.append(ff._smooth_col_bytes(n, V0[n], True) >> 10)
        monkeypatch.setattr(rc, "smooth_col_pad", lambda n: False)
        g = rc.smooth_geometry(n, "cols")
        assert g["L"] == 8 and g["SMEM"] <= ff._SMEM_MAX
        assert max(rc.smooth_ways(n, "cols").values()) == 4
        monkeypatch.undo()
        monkeypatch.setattr(ff, "_SMOOTH_COLS", ff._SMOOTH_COLS | {
            3024, 3136, 3360, 3584})
    assert kb == [236, 244, 262, 279]


# ---- the schedule and the choice of R0 --------------------------------------

def _cost(n, v0):
    """(passes before the last, masked butterfly slots a thread) of the
    schedule at V0 = v0, counted over its odd passes."""
    sched = rc.smooth_schedule(n, v0)
    odd = [(r, b) for r, _, b in sched[:-1] if r not in (2, 4)]
    return len(odd), sum(r * b - v0 for r, b in odd)


@pytest.mark.parametrize("n", ROWS)
def test_smooth7_schedule_and_the_choice_of_r0(n):
    """The radices multiply to n; radix 4 over 2^(k-2) (a radix 2 last
    where k is odd); the odd passes R0's first, then the other primes'
    ascending; the last V0 at stride P; every stride but the last divides
    P; a pass of radix r takes ceil(V0 / r) butterflies; the values a
    thread holds are V0 or a masked pass's r B, at most 30. V0 = 4 R0 is
    the least by (P > 128, the passes, the masked slots, V0) over each
    prime R0 of R; an R0 that does not divide R has no schedule."""
    sched = rc.smooth_schedule(n)
    v0 = V0[n]
    p = n // v0
    k = (n // odd_part(n)).bit_length() - 1
    assert np.prod([r for r, _, _ in sched]) == n
    assert sched[-1] == (v0, p, 1)
    pows = [r for r, _, _ in sched[:-1] if r in (2, 4)]
    assert pows == [4] * ((k - 2) // 2) + [2] * (k % 2)
    odd_r = [r for r, _, _ in sched[len(pows):-1]]
    r0 = v0 // 4
    assert odd_r == sorted(odd_r, key=lambda r: (r != r0, r))
    for r, ns, b in sched[:-1]:
        assert p % ns == 0
        assert b == -(-v0 // r)
    assert rc.passes(n) == [(r, ns) for r, ns, _ in sched]
    vmax = max([v0] + [r * b for r, _, b in sched])
    assert rc.smooth_geometry(n)["V"] == vmax <= 30
    cands = [4 * q for q in (3, 5, 7) if odd_part(n) % q == 0]
    best = min(cands, key=lambda v: (n // v > 128, *_cost(n, v), v))
    assert ff._smooth7_values(n) == best == v0
    for q in (3, 5, 7):
        if odd_part(n) % q:
            with pytest.raises(ValueError, match="no radix"):
                rc.smooth_schedule(n, 4 * q)


def test_the_choice_in_words():
    """V0 = 28 at the powers of 7, at R = 147, 441 and 567, and where a
    smaller V0 leaves P > 128 (2016-3500); 12 at R = 21, 63, 189 below
    that and at 4032 (P > 128 at every V0); 20 at R with a factor 5 below
    that, 3780 and 3920."""
    for n in ROWS:
        r = odd_part(n)
        if r in (7, 49, 343, 147, 441, 567) or n in (
                2016, 2688, 2800, 2940, 3024, 3360, 3500):
            want = 28
        elif r % 5 == 0:
            want = 20
        else:
            want = 12
        assert V0[n] == want, n


@pytest.mark.parametrize("n,sched", [
    (28, [(28, 1, 1)]),
    (56, [(2, 1, 14), (28, 2, 1)]),
    (84, [(7, 1, 2), (12, 7, 1)]),
    (224, [(4, 1, 7), (2, 4, 14), (28, 8, 1)]),
    (336, [(4, 1, 3), (7, 4, 2), (12, 28, 1)]),
    (588, [(7, 1, 4), (3, 7, 10), (28, 21, 1)]),
    (1008, [(4, 1, 3), (3, 4, 4), (7, 12, 2), (12, 84, 1)]),
    (2940, [(7, 1, 4), (3, 7, 10), (5, 21, 6), (28, 105, 1)])])
def test_schedules_pinned(n, sched):
    """A length of each kind: P = 1 (one pass), k = 3 (a radix 2), R0 = 3
    with a masked radix-7 pass (84, 336, and 1008 after a whole radix-3
    pass), V0 = 28 with a masked radix-3 pass, and two masked passes
    (2940: radix 3 then 5 after R0 = 7)."""
    assert [tuple(s) for s in rc.smooth_schedule(n)] == sched


# ---- the geometry, the pitch, the maps and the banks ------------------------

def test_the_choice_of_pitch():
    """The rows' pitch mod 32 is P mod 32 but at the five lengths of
    ``SMOOTH7_ROW_PITCH``: at P = 1 (28) the odd n | 1, no exchange; at the
    others the least exchange cost over all 32 residues
    (:func:`regcore.smooth_exchange_cost`), ties to P mod 32, scanned here
    at those four and at three of the twelve lengths of 1 < P < 32 left at
    P mod 32 (56, 168, 336)."""
    assert rc.SMOOTH7_ROW_PITCH == {28: 29, 84: 17, 140: 17, 196: 4,
                                    420: 2}
    assert rc.geometry(28)["PITCH"] == 29 and rc.smooth_ways(28) == {}
    short = [n for n in ROWS if 1 < n // V0[n] < 32]
    assert len(short) == 16
    for n in ROWS:
        if n not in short:
            assert n == 28 or n not in rc.SMOOTH7_ROW_PITCH
            continue
        p = n // V0[n]
        if n not in (84, 140, 196, 420, 56, 168, 336):
            assert rc.smooth_row_pitch(n) == p % 32
            continue
        costs = [rc.smooth_exchange_cost(n, pitch=r) for r in range(32)]
        best = min(range(32), key=lambda r: (costs[r], r != p % 32, r))
        assert rc.smooth_row_pitch(n) == best, n
        assert (n in rc.SMOOTH7_ROW_PITCH) == (best != p % 32), n
    # at P = 7 the picks cut the cost to 0.52-0.57 of P mod 32's
    for n in (84, 140, 196):
        assert rc.smooth_exchange_cost(n) < 0.6 * rc.smooth_exchange_cost(
            n, pitch=7)


@pytest.mark.parametrize("n", ROWS)
def test_smooth7_geometry_and_bank_ways(n):
    """Rows: 256 / P rows a block (one from P = 256), the pitch at
    :func:`regcore.smooth_row_pitch` mod 32, rows of fewer than 6 threads
    staged (their copies and loads two wavefronts at most), two blocks an
    SM; every get one wavefront at P mod 32 (two or three at the picked
    pitches), the puts at most ``PUTS`` (two elsewhere). Columns: L = 32
    lanes to 768 threads, then 16, then 8; at most four row threads a
    warp; padded from k = 4; the routed tile the wide code; every put and
    get two wavefronts at most, one where L = 32."""
    g = rc.geometry(n)
    p = g["P"]
    assert p == n // V0[n]
    assert g["ROWS"] == max(1, 256 // p) and g["NT"] == g["ROWS"] * p
    assert g["PITCH"] % 32 == rc.smooth_row_pitch(n) % 32
    assert n <= g["PITCH"] < n + 32
    assert g["STAGE"] == (p < 6) == (n in STAGED)
    assert g["SMEM"] == 2 * g["ROWS"] * g["PITCH"] * 4
    assert 2 * (g["SMEM"] + 1024) <= 228 << 10
    if g["STAGE"]:
        assert max(rc.smooth_stage_ways(n).values()) <= 2
    rows = rc.smooth_ways(n)
    gets = [v for (_, k), v in rows.items() if k == "get"]
    puts = [v for (_, k), v in rows.items() if k == "put"]
    if n == 28:
        assert rows == {}
    elif n in rc.SMOOTH7_ROW_PITCH:
        assert 2 <= max(gets) <= 3 and max(puts) <= 3
    else:
        assert all(v == 1 for v in gets)
        assert max(puts) == PUTS.get(n, 2)
    if n not in COLS:
        return
    c = rc.smooth_geometry(n, "cols")
    assert c["L"] in (8, 16, 32) and c["NT"] == c["L"] * c["P"] <= 1024
    assert c["W"] <= 4 and ff._axis_tile(n) == "wide"
    assert rc.axis_tile(n)["L"] == c["L"] == rc.warp_runs(n)
    assert rc.smooth_col_pad(n) == (n % 16 == 0)
    assert (c["SMEM"] == 0) == (n == 28) and c["SMEM"] <= ff._SMEM_MAX
    cols = rc.smooth_ways(n, "cols")
    assert len(cols) == 2 * (len(rc.passes(n)) - 1)
    assert max(cols.values() or [1]) <= (1 if c["L"] == 32 else 2)


@pytest.mark.parametrize("n", ROWS)
def test_smooth7_maps_are_one_to_one(n):
    """Each exchange's puts fill n distinct slots a line, and its gets
    read exactly the slots the puts wrote, as rows and as columns."""
    for kind in ("rows", "cols") if n in COLS else ("rows",):
        t, addr = rc.smooth_addr(n, kind)
        p = rc.smooth_geometry(n, kind)["P"]
        sched = rc.smooth_schedule(n)
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
            assert len(put) == len(set(put.tolist())) == len(t) // p * n
            assert set(put.tolist()) == set(get.tolist())


# ---- the networks ------------------------------------------------------------

@pytest.mark.parametrize("r", [7, 28])
@pytest.mark.parametrize("inverse", [False, True])
def test_the_7_and_28_point_networks(r, inverse):
    """``regs::dft7`` and the Good-Thomas 7 x 4 network against complex128
    numpy, and their operation counts (96 and 4 96 + 7 16)."""
    xr, xi = pair((16, r), r + inverse)
    got = rc._net(torch.complex(torch.from_numpy(xr), torch.from_numpy(xi)),
                  r, inverse)
    want = dft(xr + 1j * xi.astype(np.float64), inverse)
    assert max_rel(got.numpy(), want) < TOL
    assert rc._net_flops(r) == {7: 96, 28: 496}[r]
    if r == 28:
        assert max_rel(rc.dft_pfa(torch.complex(
            torch.from_numpy(xr), torch.from_numpy(xi)), inverse).numpy(),
            want) < TOL


# ---- the replay against numpy -----------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", ROWS)
def test_smooth7_rows_replay_matches_numpy(n, inverse):
    """Scaled: forward a ragged batch (one block and three rows more),
    inverse one whole block."""
    rows = rc.geometry(n)["ROWS"] + (0 if inverse else 3)
    xr, xi = pair((rows, n), 3 * n + inverse)
    yr, yi = rc.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         core_tab(n, inverse), inverse, 0.375)
    want = 0.375 * dft(xr + 1j * xi.astype(np.float64), inverse)
    assert max_rel(cplx(yr, yi), want) < TOL


@pytest.mark.parametrize("n", [28, 112, 336, 588, 2940, 4032])
def test_smooth7_rows_replay_in_place(n):
    xr, xi = pair((2, 3, n), n + 7)
    ar, ai = torch.from_numpy(xr.copy()), torch.from_numpy(xi.copy())
    yr, yi = rc.fft_last(ar, ai, core_tab(n, True), True, 1.0 / n,
                         alias=True)
    assert yr is ar and yi is ai
    want = np.fft.ifft(xr + 1j * xi.astype(np.float64))
    assert max_rel(cplx(yr, yi), want) < TOL


@pytest.mark.parametrize("n", COLS)
def test_smooth7_cols_replay_matches_numpy(n):
    """(1, n, 1, L + 5) along n forward: a ragged last tile; the inverse
    in place on one whole tile (1, n, 1, L)."""
    lanes = rc.smooth_geometry(n, "cols")["L"]
    for inverse in (False, True):
        z = lanes + (0 if inverse else 5)
        xr, xi = pair((1, n, 1, z), 11 * n + inverse)
        got = axis_replay(xr, xi, n, inverse, 0.5, alias=inverse)
        want = 0.5 * dft(xr + 1j * xi.astype(np.float64), inverse, axis=1)
        assert max_rel(got, want) < TOL


# ---- the replay against the reference in interpret mode ---------------------

@pytest.mark.parametrize("shape,kw", [
    ((8, 224), {}), ((4, 336), {"inverse": True, "scale": 1 / 336}),
    ((8, 28), {"scale": 0.5})])
def test_smooth7_rows_match_reference_fft_last(shape, kw):
    """R0 = 7 (224), R0 = 3 with a masked radix-7 pass (336), one pass
    (28, staged)."""
    xr, xi = pair(shape, sum(shape) + 27)
    ref = pf.fft_last(xr, xi, **kw)
    inv = kw.get("inverse", False)
    yr, yi = rc.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         core_tab(shape[-1], inv), inv, kw.get("scale", 1.0))
    assert max_rel(cplx(yr, yi), cplx(*ref)) < TOL


@pytest.mark.parametrize("n,axis,kw", [
    (112, 0, {}), (112, 1, {"inverse": True, "scale": 0.5}),
    (196, 0, {"scale": 2.0}), (196, 1, {})])
def test_smooth7_cols_match_reference_fft_sublane(n, axis, kw):
    shape = (n, 3, 8) if axis == 0 else (2, n, 8)
    xr, xi = pair(shape, n + axis + 27)
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
    ((1, 224, 112), {}),
    ((2, 28, 56), {"inverse": True, "scale": 1 / 1568, "zpad": 8})])
def test_smooth7_slab_matches_reference(shape, kw):
    xr, xi = pair(shape, sum(shape) + 27)
    ref = pf.fft_slab_yz(xr, xi, **kw)
    got = slab_replay(xr, xi, **kw)
    nz = shape[-1]
    assert got[0].shape == ref[0].shape
    assert max_rel(cplx(*got, nz), cplx(*ref, nz)) < TOL


def test_plain_versions_agree_with_the_smooth7_replay():
    xr, xi = pair((4, 1008), 5)
    pr, pi = ff.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         inverse=True, scale=0.5)
    yr, yi = rc.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         core_tab(1008, True), True, 0.5)
    assert max_rel(cplx(pr, pi), cplx(yr, yi)) < TOL
    xr, xi = pair((1, 56, 140), 6)
    pr, pi = ff.fft_slab_yz(torch.from_numpy(xr), torch.from_numpy(xi))
    assert max_rel(cplx(pr, pi), cplx(*slab_replay(xr, xi))) < TOL
    xr, xi = pair((588, 2, 8), 7)
    pr, pi = ff.fft_sublane(torch.from_numpy(xr), torch.from_numpy(xi), 0)
    ar, ai = torch.from_numpy(xr).reshape(-1), torch.from_numpy(xi).reshape(-1)
    yr, yi = torch.empty_like(ar), torch.empty_like(ai)
    st = (588 * 16, 16, 16)
    rc.fft_axis(ar, ai, yr, yi, 588, (1, 1, 16, st, st), core_tab(588, False))
    assert max_rel(cplx(pr, pi), cplx(yr.reshape(588, 2, 8),
                                      yi.reshape(588, 2, 8))) < TOL


# ---- routing: the C call's arguments ----------------------------------------

def _launches(monkeypatch):
    calls = []
    monkeypatch.setattr(ff, "_launch", lambda entry, tensors, tabs, args:
                        calls.append((entry, args)))
    return calls


@pytest.mark.parametrize("n", [28, 112, 224, 336, 1008, 3584, 4032, 176,
                               126])
def test_fft_last_routes_the_smooth7_rows(monkeypatch, n):
    """176 (11 16) and 126 (twice-odd) stay dense."""
    calls = _launches(monkeypatch)
    x = torch.zeros((3, n))
    ff.reset_counts()
    ff.fft_last.impl("kernel", x, x)
    (entry, args), = calls
    reg = int(n not in (176, 126))
    assert entry == "offt_fft_last" and args[-1] == reg
    assert ff.fft_last.reg_launches == reg


@pytest.mark.parametrize("n", [28, 112, 224, 1008, 3500, 3528, 3024, 3584,
                               4032, 176])
def test_fft_axis_routes_the_smooth7_columns(monkeypatch, n):
    """The column lengths launch the register core on the wide tile's
    code; 3024 and 3584 (their planes), 4032 (P > 128) and 176 stay
    dense."""
    calls = _launches(monkeypatch)
    x = torch.zeros((2, n, 8))
    ff.fft_sublane.impl("kernel", x, x, 1)
    (entry, args), = calls
    reg, code = args[-2:]
    assert reg == int(n in COLS)
    if reg:
        assert code == ff._AXIS_TILES["wide"]


@pytest.mark.parametrize("ny,nz,reg", [
    (224, 224, 1), (784, 896, 1), (336, 168, 1), (28, 56, 1),
    (1372, 3584, 1), (4032, 224, 0), (224, 176, 0)])
def test_fft_slab_routes_the_smooth7_slabs(monkeypatch, ny, nz, reg):
    """Two grids (no cluster) on the smooth rows and columns."""
    calls = _launches(monkeypatch)
    x = torch.zeros((2, ny, nz))
    ff.fft_slab_yz.impl("kernel", x, x)
    (entry, args), = calls
    assert args[-3:-1] == [reg, 0]


def test_x_passes_route_the_smooth7_columns(monkeypatch):
    """The padded x passes at 224 and 1008 launch the register core; at
    4032 the dense core."""
    calls = _launches(monkeypatch)
    for n in (224, 1008, 4032):
        x = torch.zeros((n, 2, 136))
        ff.fft_x_from_padded.impl("kernel", x, x, 128)
        ff.fft_x_to_padded.impl("kernel", x[..., :128], x[..., :128])
    assert [args[-2] for _, args in calls] == [1, 1, 1, 1, 0, 0]


@pytest.mark.parametrize("m", [112, 224, 1008])
def test_real_rows_stay_dense_at_the_new_lengths(monkeypatch, m):
    """``rfft_last_planar`` and ``icrfft_last_planar`` at M = 112, 224 and
    1008 (224^3, 448^3, 2016^3 r2c) keep the dense core: the real rows
    have no instance with a factor 7."""
    calls = _launches(monkeypatch)
    ff.rfft_last_planar.impl("kernel", torch.zeros((3, 2 * m)))
    ff.icrfft_last_planar.impl("kernel", torch.zeros((3, m)),
                               torch.zeros((3, m)))
    assert [e for e, _ in calls] == ["offt_rfft_last", "offt_icrfft_last"]
    assert [args[-1] for _, args in calls] == [0, 0]


def test_c2c_plan_routes_and_matches_the_reference(monkeypatch):
    """(28, 56, 224) c2c: the slab (56, 224) and the x pass of 28, its
    values against ``offt_tpu.plan`` on the same input and numpy (1e-6
    of max |reference|); on the kernel route the slab launches the
    register core."""
    rng = np.random.default_rng(27)
    shape = (28, 56, 224)
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
    assert {"fft_slab_yz", "fft_sublane"} <= ran, ran
    calls = _launches(monkeypatch)
    ff.reset_counts()
    xr = torch.zeros(shape)
    ff.fft_slab_yz.impl("kernel", xr, xr)
    assert [e for e, _ in calls] == ["offt_fft_slab"]
    assert ff.fft_slab_yz.reg_launches == 1
