"""The register core's rows at the mixed lengths 3 * 2^k and 5 * 2^k
(``csrc/fft_last_mix.cu``: ``fft_last`` and the z rows of the c2c slab
``fft_slab``), on the CPU.

No CPU runs that kernel, so :mod:`offt_tpu_torch.kernels.regcore`
replays it block by block (:func:`regcore.rows_mix_block`): 256 / P rows
a block of P = n / (4 R0) threads, the mixed schedule (radix-4 passes, a
radix 2 where log2 P is odd, then one Good-Thomas pass of radix 12 or
20), and every exchange through the block's planes at the addresses the
kernel computes: the swizzle ``regcore.mix_at`` of the thread's part of
the element, XOR ``row_mask`` of its row, XOR the swizzle of the
compile-time part. These tests pin that map (one-to-one, the XOR split,
one wavefront for every put and get by ``regcore.bank_ways``, and why
the power-of-two pad would not do), and hold the replay against
complex128 numpy at every routed mixed length, forward and inverse,
scaled, ragged and in place, and against the reference's
``pallas_fft.fft_last`` and ``fft_slab_yz`` in interpret mode, on inputs
made by numpy from a seed. Tolerance: 1e-6 of max |reference|, max-abs
(f32 on both sides, sums in other orders), as ``test_torch_regmixed.py``
states it. Through the C call's arguments (``fused_fft._launch``
monkeypatched) they pin the core each wrapper launches. The kernels
against their plain versions on the card are
``tests/test_torch_cuda.py``'s."""

import numpy as np
import pytest
import torch

from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.kernels import fourstep as fs
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.kernels import regcore as rc
from test_torch_regaxis import TOL, core_tab, max_rel, pair

ROWS = sorted(ff._MIX_ROW_LENGTHS)


def cplx(yr, yi, lanes=None):
    yr, yi = np.asarray(yr), np.asarray(yi)
    if lanes is not None:
        yr, yi = yr[..., :lanes], yi[..., :lanes]
    return yr.astype(np.float64) + 1j * yi


def rows_replay(xr, xi, inverse=False, scale=1.0):
    n = xr.shape[-1]
    yr, yi = rc.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         core_tab(n, inverse), inverse, scale)
    return cplx(yr, yi)


# ---- the row geometry and its map -------------------------------------------

@pytest.mark.parametrize("n", ROWS)
def test_mixed_row_geometry(n):
    """V = 4 R0 values a thread, P = n / V threads a row (a power of two,
    4 to 256), 256 / P rows a block at a pitch of a multiple of 32 floats;
    three blocks' planes fit an SM's 228 KB."""
    g = rc.geometry(n)
    r0 = 3 if n % 3 == 0 else 5
    assert g["V"] == 4 * r0 == ff._reg_values(n)
    assert g["P"] * g["V"] == n and g["P"] & (g["P"] - 1) == 0
    assert 4 <= g["P"] <= 256 and g["P"] * g["ROWS"] == rc.THREADS
    assert g["PITCH"] % 32 == 0 and n <= g["PITCH"] < n + 32
    assert 3 * (g["SMEM"] + 1024) <= 228 << 10


@pytest.mark.parametrize("n", ROWS)
def test_mixed_row_map_is_one_to_one(n):
    """Row g's element a at g PITCH + (mix_at(a) ^ row_mask(g)): each row
    a permutation of its own slots, runs of four kept whole and 16-byte
    aligned (the first pass's float4 stores)."""
    g = rc.geometry(n)
    a = np.arange(n)
    rows = np.arange(g["ROWS"])
    pos = rc.row_at(n, a[None, :], rows[:, None])
    assert len(set(pos.ravel().tolist())) == pos.size
    assert (pos // g["PITCH"] == rows[:, None]).all()
    quad = rc.row_at(n, 4 * (a[::4] // 4)[None, :], rows[:, None])
    assert (quad % 4 == 0).all()
    for k in range(4):
        assert (rc.row_at(n, a[k::4][None, :], rows[:, None])
                == quad + k).all()


@pytest.mark.parametrize("n", ROWS)
def test_mixed_row_addresses_split_over_xor(n):
    """The kernel's address of an exchange element is the thread's
    swizzled base XOR the swizzle of a compile-time part (the bits of the
    two parts disjoint), and that XOR is the base with the constant's low
    five bits flipped plus its higher bits (``xor_off``): for every put
    and get of the schedule, the address is the map's."""
    g = rc.geometry(n)
    p, v = g["P"], g["V"]
    tid = np.arange(rc.THREADS)
    row, t = tid // p, tid % p
    gm = rc.row_mask(n, row)
    sched = rc.passes(n)
    for i, (r, ns) in enumerate(sched):
        if i < len(sched) - 1:                       # put
            x = rc.mix_at((t // ns) * ns * r + t % ns) ^ gm
            for q in range(v // r):
                for k in range(r):
                    j = t + q * p
                    e = (j // ns) * ns * r + j % ns + k * ns
                    c = rc.mix_at(q * p * r + k * ns)
                    assert ((x >> 5) & (c >> 5) == 0).all()
                    got = row * g["PITCH"] + (x ^ (c & 31)) + (c & ~31)
                    assert (got == rc.row_at(n, e, row)).all()
        if i > 0:                                    # get
            x = rc.mix_at(t) ^ gm
            for q in range(v // r):
                for k in range(r):
                    e = t + q * p + k * (n // r)
                    c = rc.mix_at(p * (q + k * (v // r)))
                    got = row * g["PITCH"] + (x ^ (c & 31)) + (c & ~31)
                    assert (got == rc.row_at(n, e, row)).all()


@pytest.mark.parametrize("n", ROWS)
def test_mixed_row_exchanges_are_one_wavefront(n):
    """Every put (the first as float4, by quarter-warps) and every get of
    every pass takes one wavefront a warp instruction, rows of P < 32
    sharing a warp; 3072 (P = 256) too."""
    ways = rc.bank_ways(n)
    assert len(ways) == 2 * (len(rc.passes(n)) - 1)
    assert max(ways.values()) == 1


@pytest.mark.parametrize("n,worst", [(320, (1, "put")), (768, (2, "put")),
                                     (384, (2, "put"))])
def test_power_of_two_pad_would_conflict_at_mixed_lengths(monkeypatch, n,
                                                           worst):
    """Why the mixed rows have a map of their own: the power-of-two rows'
    pad phys (rows sharing a warp P banks apart) puts two of a warp's
    stores on one bank at the pass of stride 4 of 320 (runs of four, two
    rows a warp) and at the pass of stride 16 of 768 and 384 (runs of 16,
    64 or 32 apart)."""
    def phys_rows(n, a, g=0):
        size = rc.phys(n - 1) + 1
        p = n // ff._reg_values(n)
        pitch = size if p >= 32 else size + ((max(p, 4) - size) % 32 + 32) % 32
        return g * pitch + rc.phys(a)
    monkeypatch.setattr(rc, "row_at", phys_rows)
    ways = rc.bank_ways(n)
    assert ways[worst] == 2


def test_row_mask_columns():
    """Rows sharing a warp XOR 24 g at P = 16; 20 g0 ^ 24 g1 at P = 8;
    16 g0 ^ 20 g1 ^ 24 g2 at P = 4; nothing from P = 32."""
    g = np.arange(8)
    assert (rc.row_mask(320, g) == 24 * (g & 1)).all()
    assert (rc.row_mask(96, g) == (20 * (g & 1) ^ 24 * ((g >> 1) & 1))).all()
    assert (rc.row_mask(48, g) == (16 * (g & 1) ^ 20 * ((g >> 1) & 1)
                                   ^ 24 * ((g >> 2) & 1))).all()
    assert (rc.row_mask(384, g) == 0).all()


# ---- the row replay against numpy and the reference -------------------------

@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n", ROWS)
def test_mixed_rows_replay_matches_numpy(n, inverse):
    """A ragged batch (one block and three rows more), scaled."""
    rows = rc.geometry(n)["ROWS"] + 3
    xr, xi = pair((rows, n), n + inverse)
    got = rows_replay(xr, xi, inverse, 0.375)
    x = xr.astype(np.float64) + 1j * xi
    want = 0.375 * (np.fft.ifft(x) * n if inverse else np.fft.fft(x))
    assert max_rel(got, want) < TOL


@pytest.mark.parametrize("n", [48, 320, 3072])
def test_mixed_rows_replay_in_place(n):
    xr, xi = pair((2, 3, n), n)
    want = rows_replay(xr, xi, True, 1.0 / n)
    ar, ai = torch.from_numpy(xr.copy()), torch.from_numpy(xi.copy())
    yr, yi = rc.fft_last(ar, ai, core_tab(n, True), True, 1.0 / n,
                         alias=True)
    assert yr is ar and yi is ai
    assert max_rel(cplx(yr, yi), want) < TOL
    assert max_rel(want, np.fft.ifft(xr + 1j * xi.astype(np.float64))) < TOL


@pytest.mark.parametrize("shape,kw", [
    ((8, 320), {}), ((8, 192), {"inverse": True, "scale": 1 / 192}),
    ((4, 1536), {"scale": 0.5})])
def test_mixed_rows_replay_matches_reference_fft_last(shape, kw):
    xr, xi = pair(shape, sum(shape))
    ref = pf.fft_last(xr, xi, **kw)
    got = rows_replay(xr, xi, kw.get("inverse", False), kw.get("scale", 1.0))
    assert max_rel(got, cplx(*ref)) < TOL


@pytest.mark.parametrize("n", [96, 320, 2560, 3072])
def test_plain_version_agrees_with_the_mixed_rows(n):
    xr, xi = pair((5, n), 3 * n)
    pr, pi = ff.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                         inverse=True, scale=0.5)
    assert max_rel(cplx(pr, pi), rows_replay(xr, xi, True, 0.5)) < TOL


# ---- the slab: z on the mixed rows, y on the mixed columns ------------------

def slab_replay(xr, xi, inverse=False, scale=1.0, zpad=0, z_true=0):
    ny, nz = xr.shape[-2], z_true or xr.shape[-1]
    return rc.fft_slab(torch.from_numpy(xr), torch.from_numpy(xi),
                       core_tab(nz, inverse), core_tab(ny, inverse),
                       inverse, scale, zpad, z_true)


@pytest.mark.parametrize("ny,nz", [(48, 320), (320, 96), (160, 192),
                                   (64, 320), (320, 64), (96, 3072),
                                   (2560, 16)])
@pytest.mark.parametrize("inverse", [False, True])
def test_mixed_slab_replay_matches_numpy(ny, nz, inverse):
    """z on the mixed rows or the power-of-two ones, y on the mixed
    columns (the strided-axis kernel's tiles) or the power-of-two ones;
    the pad lanes never written."""
    xr, xi = pair((1, ny, nz), ny + 3 * nz + inverse)
    yr, yi = slab_replay(xr, xi, inverse, 0.375, zpad=8)
    x = xr.astype(np.float64) + 1j * xi
    f = np.fft.ifft2 if inverse else np.fft.fft2
    want = 0.375 * f(x) * (ny * nz if inverse else 1)
    assert yr.shape == (1, ny, nz + 8) and np.isnan(yr[..., nz:]).all()
    assert max_rel(cplx(yr, yi, nz), want) < TOL


@pytest.mark.parametrize("shape,kw", [
    ((2, 48, 320), {}),
    ((2, 320, 96), {"inverse": True, "scale": 1 / 30720}),
    ((1, 160, 192), {"zpad": 8, "scale": 0.5})])
def test_mixed_slab_replay_matches_reference(shape, kw):
    xr, xi = pair(shape, sum(shape) + 1)
    ref = pf.fft_slab_yz(xr, xi, **kw)
    got = slab_replay(xr, xi, **kw)
    nz = shape[-1]
    assert got[0].shape == ref[0].shape
    assert max_rel(cplx(*got, nz), cplx(*ref, nz)) < TOL


def test_mixed_slab_replay_in_place_with_z_true():
    xr, xi = pair((2, 48, 96), 9)
    want = slab_replay(xr, xi, True, 1 / 4608)
    ar, ai = torch.from_numpy(xr.copy()), torch.from_numpy(xi.copy())
    yr, yi = rc.fft_slab(ar, ai, core_tab(96, True), core_tab(48, True),
                         True, 1 / 4608, alias=True)
    assert yr is ar and max_rel(cplx(yr, yi), cplx(*want)) < TOL
    pr, pi = pair((2, 48, 104), 9)
    got = slab_replay(pr, pi, z_true=96)
    x = pr[..., :96].astype(np.float64) + 1j * pi[..., :96]
    assert max_rel(cplx(*got, 96), np.fft.fft2(x)) < TOL


def test_plain_version_agrees_with_the_mixed_slab():
    xr, xi = pair((2, 320, 48), 13)
    pr, pi = ff.fft_slab_yz(torch.from_numpy(xr), torch.from_numpy(xi),
                            scale=0.25, zpad=8)
    got = slab_replay(xr, xi, scale=0.25, zpad=8)
    assert max_rel(cplx(pr, pi, 48), cplx(*got, 48)) < TOL


# ---- routing: the C call's arguments ----------------------------------------

def _launches(monkeypatch):
    """Record each C entry point's name and arguments instead of calling
    it, so the kernel route runs on CPU tensors."""
    calls = []
    monkeypatch.setattr(ff, "_launch", lambda entry, tensors, tabs, args:
                        calls.append((entry, args)))
    return calls


@pytest.mark.parametrize("n", [48, 80, 320, 1536, 2560, 3072, 1024, 112,
                               6144, 176])
def test_fft_last_routes_the_mixed_rows(monkeypatch, n):
    """``_reg_rows``: powers of two and the mixed row lengths (3072
    among them) launch the register core (reg = 1, no rows a block), and
    so does 112 (7 16, the smooth core's fourth family); 176 (11: no
    network) and 6144 keep the dense core."""
    calls = _launches(monkeypatch)
    x = torch.zeros((3, n))
    ff.reset_counts()
    ff.fft_last.impl("kernel", x, x)
    (entry, args), = calls
    assert entry == "offt_fft_last"
    reg, t = args[-1], args[-4]
    assert reg == int(ff._reg_rows(n)) == int(n not in (176, 6144))
    assert (t == 0) == bool(reg)
    assert ff.fft_last.reg_launches == reg


@pytest.mark.parametrize("ny,nz,reg,cluster", [
    (320, 320, 1, 0), (256, 256, 1, 1), (192, 192, 1, 0), (320, 3072, 1, 0),
    (256, 320, 1, 0), (320, 256, 1, 0), (3072, 320, 0, 0), (112, 320, 1, 0),
    (320, 112, 1, 0), (176, 320, 0, 0), (320, 176, 0, 0)])
def test_fft_slab_routes_the_mixed_slabs(monkeypatch, ny, nz, reg, cluster):
    """The 320^3 slab launches the register core in two grids (clusters
    stay at powers of two), and so do slabs with a side of 112 (the smooth
    core's fourth family); a y the column variant lacks (3072, 176) or a z
    the rows lack (176) keeps the dense core."""
    calls = _launches(monkeypatch)
    x = torch.zeros((2, ny, nz))
    ff.reset_counts()
    ff.fft_slab_yz.impl("kernel", x, x)
    (entry, args), = calls
    assert entry == "offt_fft_slab"
    assert args[-3:-1] == [reg, cluster]
    assert ff.fft_slab_yz.reg_launches == reg


def test_kernels_without_mixed_rows_stay_dense(monkeypatch):
    """Kernels with no mixed instance keep the dense core: the r2c and c2r
    rows at M = 112 (7 16; the mixed real rows take 3 2^k and 5 2^k, the
    smooth ones every other 5-smooth length, the odd and twice-odd ones
    too), the
    r2c and c2r slabs at (320, 72) (at (320, 160) both halves have mixed
    instances, and they take the register core) and step 3 on 3 * 2^21's
    3072 side (``_reg_core``, the four-step pair's: the transposing store
    has no instance at P = 256), step 1 at 1024 the register one."""
    calls = _launches(monkeypatch)
    ff.rfft_last_planar.impl("kernel", torch.zeros((3, 224)))
    ff.icrfft_last_planar.impl("kernel", torch.zeros((3, 112)),
                               torch.zeros((3, 112)))
    ff.rfft_slab_yz.impl("kernel", torch.zeros((2, 320, 144)))
    ff.irfft_slab_yz.impl("kernel", torch.zeros((2, 320, 80)),
                          torch.zeros((2, 320, 80)), 144)
    z = torch.zeros((1, 1024, 3072))
    fs._step1_twiddle.impl("kernel", z, z, 1024, 3072, None, False,
                           tile="wide")
    fs._step3_transposed.impl("kernel", z, z, 1024, 3072, None, False)
    regs = {entry: args for entry, args in calls}
    assert regs["offt_rfft_last"][-1] == 0
    assert regs["offt_icrfft_last"][-1] == 0
    assert regs["offt_rfft_slab"][-3] == 0
    assert regs["offt_irfft_slab"][-2] == 0
    assert regs["offt_step1_twiddle"][-2] == 1
    assert regs["offt_step3_transposed"][-1] == 0
    assert not ff._reg_rslab(320, 72) and ff._reg_rslab(320, 160)
