"""The register core at the 5-smooth lengths with an odd part of 9, 15, 25
or 45 (``csrc/fft_smooth.cuh``: the rows of ``fft_last`` and of the c2c
slab's z pass, ``csrc/fft_last_smooth.cu``; the column variant of the
strided-axis kernel and of the slab's y pass, ``csrc/fft_axis_smooth.cu``),
on the CPU.

No CPU runs those kernels, so :mod:`offt_tpu_torch.kernels.regcore`
replays them block by block (:func:`regcore.smooth_rows_block`,
:func:`regcore.smooth_cols_block`): P = n / 12 threads a line (n / 20 at
an odd part 25), not a power of two; radix-4 passes (a radix 2 where k is
odd), one radix-3 or radix-5 pass per further odd factor (the radix-5
pass of an odd part 15 or 45 three butterflies a thread, the third
masked), then one Good-Thomas pass of radix 12 or 20; every exchange
through the block's planes at the addresses the kernel computes. These
tests pin the schedule and the maps (one-to-one, the bank ways of
``regcore.smooth_ways``), hold the replay against complex128 numpy at
every admitted length, forward and inverse, scaled, ragged and in place,
and against the reference's ``pallas_fft.fft_last``, ``fft_sublane`` and
``fft_slab_yz`` in interpret mode, on inputs made by numpy from a seed
(tolerance 1e-6 of max |reference|, max-abs, as
``test_torch_regmixrows.py`` states it); through the C call's arguments
(``fused_fft._launch`` monkeypatched) they pin the core each wrapper
launches, and the routes that keep theirs; and one c2c plan against
``offt_tpu.plan``. The kernels against their plain versions on the card
are ``tests/test_torch_cuda.py``'s."""

import numpy as np
import pytest
import torch

import offt_tpu
import offt_tpu_torch as ot
from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.kernels import fourstep as fs
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.kernels import regcore as rc
from test_torch_regaxis import TOL, core_tab, max_rel, pair

ROWS = sorted(ff._SMOOTH_LENGTHS)
COLS = sorted(ff._SMOOTH_COL_LENGTHS)
REQUIRED = (144, 240, 288, 360, 400, 480, 576, 720, 800, 960)


def cplx(yr, yi, lanes=None):
    yr, yi = np.asarray(yr), np.asarray(yi)
    if lanes is not None:
        yr, yi = yr[..., :lanes], yi[..., :lanes]
    return yr.astype(np.float64) + 1j * yi


def dft(x, inverse, axis=-1):
    n = x.shape[axis]
    x = x.astype(np.complex128)
    return np.fft.ifft(x, axis=axis) * n if inverse else np.fft.fft(x,
                                                                   axis=axis)


# ---- the lengths and the schedule -------------------------------------------

def test_admitted_lengths():
    """Every 5-smooth length R 2^k of [16, 4096] with R in {9, 15, 25, 45}
    and k >= 3 as rows; those of P <= 128 as columns; the required ones
    of both kinds."""
    want = {r << k for r in (9, 15, 25, 45) for k in range(3, 12)
            if r << k <= 4096}
    assert ff._SMOOTH_LENGTHS == want and len(want) == 21
    assert set(COLS) == want - {1920, 2304, 2880, 3200, 3840}
    for n in REQUIRED:
        assert ff._reg_rows(n) and ff._reg_axis(n) and ff._reg_slab(n, n)
    for n in (1152, 1440, 1600, 1920, 2304, 2880, 3200, 3840, 72, 120, 200):
        assert ff._reg_rows(n)
    # the lengths that stay dense: a prime factor of 11 or more, a factor
    # 7 at a twice-odd length, past 4096 (the lengths R 2^k, k >= 2, with
    # a factor 7 are the fourth family's, test_torch_regsmooth7.py)
    for n in (126, 176, 352, 704, 1232, 4320, 5000):
        assert not ff._reg_rows(n) and not ff._reg_axis(n)


@pytest.mark.parametrize("n", ROWS)
def test_smooth_schedule(n):
    """The radices multiply to n; the last is V0 = 12 (20 at an odd part
    25) at stride P; every stride but the last divides P (a thread's
    butterflies share their twiddles); only a radix-5 pass at V0 = 12 is
    masked, three butterflies a thread, 15 values."""
    sched = rc.smooth_schedule(n)
    v0 = 20 if n % 25 == 0 else 12
    p = n // v0
    assert np.prod([r for r, _, _ in sched]) == n
    assert sched[-1] == (v0, p, 1)
    for r, ns, b in sched[:-1]:
        assert p % ns == 0
        assert b == v0 // r or (r, b, v0) == (5, 3, 12)
    assert rc.passes(n) == [(r, ns) for r, ns, _ in sched]
    assert rc.smooth_geometry(n)["V"] == (15 if v0 == 12 and n % 5 == 0
                                          else v0)
    assert ff._reg_values(n) == v0


@pytest.mark.parametrize("n", ROWS)
def test_smooth_row_geometry(n):
    """256 / P rows a block (one from P = 256), the pitch n rounded up to
    P mod 32 (so consecutive threads of a warp meet consecutive banks
    whatever rows they lie in); three blocks fit an SM."""
    g = rc.geometry(n)
    assert g["P"] * g["ROWS"] == g["NT"] <= max(256, g["P"])
    assert g["PITCH"] % 32 == g["P"] % 32 and n <= g["PITCH"] < n + 32
    assert 3 * (g["SMEM"] + 1024) <= 228 << 10


@pytest.mark.parametrize("n", COLS)
def test_smooth_col_geometry(n):
    """L = 32 lanes to 768 threads, then 16, then 8: runs of L floats, at
    most four row threads a warp; the routed tile is the wide code."""
    g = rc.smooth_geometry(n, "cols")
    assert g["L"] in (8, 16, 32) and g["NT"] == g["L"] * g["P"] <= 1024
    assert g["W"] <= 4 and ff._axis_tile(n) == "wide"
    assert rc.axis_tile(n)["L"] == g["L"] == rc.warp_runs(n)


@pytest.mark.parametrize("kind", ["rows", "cols"])
@pytest.mark.parametrize("n", ROWS)
def test_smooth_exchange_maps_are_one_to_one(n, kind):
    """Each exchange's puts fill n distinct slots a line, and its gets
    read exactly the slots the puts wrote."""
    if kind == "cols" and n not in ff._SMOOTH_COL_LENGTHS:
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
def test_smooth_bank_ways(n):
    """Columns: every put and get one wavefront (at 360, whose 16 lanes
    put two row threads of a warp on the first radix-2 pass's even
    slots, that put two). Rows: every get one wavefront; the puts of the
    strided passes up to four, the float4 puts of the first radix-4 pass
    one or two."""
    rows = rc.smooth_ways(n)
    assert all(v == 1 for (i, k), v in rows.items() if k == "get")
    assert max(rows.values()) <= 4
    if rc.smooth_schedule(n)[0][0] == 4:
        assert rows[(0, "put")] <= 2
    if n in ff._SMOOTH_COL_LENGTHS:
        cols = rc.smooth_ways(n, "cols")
        assert len(cols) == 2 * (len(rc.passes(n)) - 1)
        want = {k: 1 for k in cols}
        if n == 360:
            want[(0, "put")] = 2
        assert cols == want


# ---- the replay against numpy -----------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", ROWS)
def test_smooth_rows_replay_matches_numpy(n, inverse):
    """A ragged batch (one block and three rows more), scaled."""
    rows = rc.geometry(n)["ROWS"] + 3
    xr, xi = pair((rows, n), n + inverse)
    yr, yi = rc.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         core_tab(n, inverse), inverse, 0.375)
    want = 0.375 * dft(xr + 1j * xi.astype(np.float64), inverse)
    assert max_rel(cplx(yr, yi), want) < TOL


@pytest.mark.parametrize("n", [72, 360, 3840])
def test_smooth_rows_replay_in_place(n):
    xr, xi = pair((2, 3, n), n)
    ar, ai = torch.from_numpy(xr.copy()), torch.from_numpy(xi.copy())
    yr, yi = rc.fft_last(ar, ai, core_tab(n, True), True, 1.0 / n,
                         alias=True)
    assert yr is ar and yi is ai
    want = np.fft.ifft(xr + 1j * xi.astype(np.float64))
    assert max_rel(cplx(yr, yi), want) < TOL


def axis_replay(xr, xi, n, inverse, scale, alias=False):
    """The strided-axis kernel on (B, n, Y, Z) along n (the callers' Z:
    the tile's lanes plus 5, a ragged last tile), in place or into NaN
    buffers."""
    nb, _, y, z = xr.shape
    st = (n * y * z, y * z, z)
    ar = torch.from_numpy(xr.copy()).reshape(-1)
    ai = torch.from_numpy(xi.copy()).reshape(-1)
    if alias:
        yr, yi = ar, ai
    else:
        yr = torch.full_like(ar, float("nan"))
        yi = torch.full_like(ai, float("nan"))
    rc.fft_axis(ar, ai, yr, yi, n, (nb, y, z, st, st), core_tab(n, inverse),
                inverse, scale)
    return cplx(yr.reshape(xr.shape), yi.reshape(xr.shape))


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", COLS)
def test_smooth_cols_replay_matches_numpy(n, inverse):
    z = rc.smooth_geometry(n, "cols")["L"] + 5
    xr, xi = pair((2, n, 1, z), 5 * n + inverse)
    got = axis_replay(xr, xi, n, inverse, 0.5, alias=inverse)
    want = 0.5 * dft(xr + 1j * xi.astype(np.float64), inverse, axis=1)
    assert max_rel(got, want) < TOL


# ---- the replay against the reference in interpret mode ---------------------

@pytest.mark.parametrize("shape,kw", [
    ((8, 144), {}), ((6, 360), {"inverse": True, "scale": 1 / 360}),
    ((4, 400), {"scale": 0.5}), ((3, 960), {})])
def test_smooth_rows_match_reference_fft_last(shape, kw):
    xr, xi = pair(shape, sum(shape))
    ref = pf.fft_last(xr, xi, **kw)
    inv = kw.get("inverse", False)
    yr, yi = rc.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         core_tab(shape[-1], inv), inv, kw.get("scale", 1.0))
    assert max_rel(cplx(yr, yi), cplx(*ref)) < TOL


@pytest.mark.parametrize("n,axis,kw", [
    (144, 0, {}), (360, 1, {"inverse": True, "scale": 0.5}),
    (240, 0, {"scale": 2.0})])
def test_smooth_cols_match_reference_fft_sublane(n, axis, kw):
    shape = (n, 3, 8) if axis == 0 else (2, n, 8)
    xr, xi = pair(shape, n + axis)
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


def slab_replay(xr, xi, inverse=False, scale=1.0, zpad=0):
    ny, nz = xr.shape[-2:]
    return rc.fft_slab(torch.from_numpy(xr), torch.from_numpy(xi),
                       core_tab(nz, inverse), core_tab(ny, inverse),
                       inverse, scale, zpad)


@pytest.mark.parametrize("shape,kw", [
    ((2, 144, 144), {"zpad": 8}),
    ((1, 360, 240), {"inverse": True, "scale": 1 / 86400}),
    ((1, 80, 720), {})])
def test_smooth_slab_matches_reference(shape, kw):
    xr, xi = pair(shape, sum(shape) + 7)
    ref = pf.fft_slab_yz(xr, xi, **kw)
    got = slab_replay(xr, xi, **kw)
    nz = shape[-1]
    assert got[0].shape == ref[0].shape
    assert max_rel(cplx(*got, nz), cplx(*ref, nz)) < TOL


def test_plain_versions_agree_with_the_smooth_replay():
    xr, xi = pair((4, 576), 3)
    pr, pi = ff.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         inverse=True, scale=0.5)
    yr, yi = rc.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         core_tab(576, True), True, 0.5)
    assert max_rel(cplx(pr, pi), cplx(yr, yi)) < TOL
    xr, xi = pair((1, 200, 800), 4)
    pr, pi = ff.fft_slab_yz(torch.from_numpy(xr), torch.from_numpy(xi))
    assert max_rel(cplx(pr, pi), cplx(*slab_replay(xr, xi))) < TOL


# ---- routing: the C call's arguments ----------------------------------------

def _launches(monkeypatch):
    calls = []
    monkeypatch.setattr(ff, "_launch", lambda entry, tensors, tabs, args:
                        calls.append((entry, args)))
    return calls


@pytest.mark.parametrize("n", [144, 360, 960, 3840, 112, 176])
def test_fft_last_routes_the_smooth_rows(monkeypatch, n):
    """176 = 11 16 stays dense (112 = 7 16 is the fourth family's)."""
    calls = _launches(monkeypatch)
    x = torch.zeros((3, n))
    ff.reset_counts()
    ff.fft_last.impl("kernel", x, x)
    (entry, args), = calls
    assert entry == "offt_fft_last" and args[-1] == int(n != 176)
    assert ff.fft_last.reg_launches == int(n != 176)


@pytest.mark.parametrize("n", [144, 360, 720, 1440, 1920, 112, 176])
def test_fft_axis_routes_the_smooth_columns(monkeypatch, n):
    """The column lengths launch the register core on the wide tile's
    code; 1920 (eight row threads a warp) and 176 = 11 16 stay dense (112
    = 7 16 is the fourth family's)."""
    calls = _launches(monkeypatch)
    x = torch.zeros((2, n, 8))
    ff.fft_sublane.impl("kernel", x, x, 1)
    (entry, args), = calls
    reg, code = args[-2:]
    assert reg == int(n not in (1920, 176))
    if reg:
        assert code == ff._AXIS_TILES["wide"]
        with pytest.raises(ValueError, match="power of two"):
            ff.fft_sublane.impl("kernel", x, x, 1, tile="narrow")


@pytest.mark.parametrize("ny,nz,reg", [
    (144, 144, 1), (360, 360, 1), (960, 960, 1), (720, 256, 1),
    (256, 3840, 1), (1920, 128, 0), (112, 360, 1), (176, 360, 0)])
def test_fft_slab_routes_the_smooth_slabs(monkeypatch, ny, nz, reg):
    """Two grids (no cluster) on the smooth rows and columns."""
    calls = _launches(monkeypatch)
    x = torch.zeros((2, ny, nz))
    ff.fft_slab_yz.impl("kernel", x, x)
    (entry, args), = calls
    assert args[-3:-1] == [reg, 0]


def test_other_routes_keep_their_cores(monkeypatch):
    """The real slabs at (Y = 360, M = 128) and (144, 72), the real rows
    at M = 112 (7 16: no row core's length; at a smooth M of any family
    they take the smooth real rows, ``test_torch_regsmoothreal.py``,
    ``test_torch_regsmoothmorereal.py``,
    ``test_torch_regsmoothoddreal.py``), the four-step pair
    at a smooth side, and the cube at a smooth side keep the dense core."""
    calls = _launches(monkeypatch)
    assert ff.can_use_rfft3d(360, 360, 256)
    ff.rfft_slab_yz.impl("kernel", torch.zeros((2, 360, 256)))
    ff.irfft_slab_yz.impl("kernel", torch.zeros((2, 360, 136)),
                          torch.zeros((2, 360, 136)), 256)
    ff.rfft_slab_yz.impl("kernel", torch.zeros((2, 144, 144)))
    ff.rfft_last_planar.impl("kernel", torch.zeros((3, 224)))
    ff.icrfft_last_planar.impl("kernel", torch.zeros((3, 112)),
                               torch.zeros((3, 112)))
    z = torch.zeros((1, 1440, 2048))
    fs._step1_twiddle.impl("kernel", z, z, 1440, 2048, None, False)
    z = torch.zeros((1, 2048, 1440))
    fs._step3_transposed.impl("kernel", z, z, 2048, 1440, None, False)
    c = torch.zeros((1, 16, 144, 128))
    ff.fft3d_cube.impl("kernel", c, c)
    regs = [(entry, args[-1] if entry in ("offt_rfft_last",
                                          "offt_icrfft_last")
             else args) for entry, args in calls]
    assert [e for e, _ in regs] == [
        "offt_rfft_slab", "offt_irfft_slab", "offt_rfft_slab",
        "offt_rfft_last", "offt_icrfft_last", "offt_step1_twiddle",
        "offt_step3_transposed", "offt_fft_cube"]
    assert ff.rfft_slab_yz.reg_launches == ff.irfft_slab_yz.reg_launches == 0
    assert ff.rfft_last_planar.reg_launches == 0
    assert ff.icrfft_last_planar.reg_launches == 0
    assert fs._step1_twiddle.reg_launches == 0
    assert fs._step3_transposed.reg_launches == 0
    assert ff.fft3d_cube.reg_launches == 0
    assert not ff._reg_rslab(360, 128) and not ff._reg_core(1440)
    assert not ff._reg_cube(16, 144, 128)


def test_c2c_plan_routes_and_matches_the_reference(monkeypatch):
    """(8, 144, 360) c2c: the slab (144, 360) and the x pass of 8, its
    values against ``offt_tpu.plan`` on the same input; on the kernel
    route the slab launches the register core."""
    rng = np.random.default_rng(21)
    shape = (8, 144, 360)
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
    # the slab on the smooth rows and columns; x = 8 under 16 stays dense
    assert ff.fft_slab_yz.reg_launches == 1
    assert ff.fft_sublane.reg_launches == 0 and not ff._reg_axis(8)
