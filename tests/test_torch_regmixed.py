"""The register core at the mixed lengths 3 * 2^k and 5 * 2^k (the
strided-axis kernel ``csrc/fft_axis_mix.cu``), and ``icrfft_last`` on
the register core's c2r rows, on the CPU.

No CPU runs those kernels, so :mod:`offt_tpu_torch.kernels.regcore`
replays them: the mixed schedule (radix-4 passes, a radix 2 where
log2 P is odd, then one pass of radix 12 or 20 through the kernel's
Good-Thomas network of constant-root 3- and 5-point DFTs), the column
variant's tiles and exchange layout (one pad slot per four elements),
and the c2r rows (the re-tangle as the core loads, then the inverse
M-point core). These tests hold the replays against complex128 numpy
at every routed mixed length over the wrappers' four geometries, and
against the reference's ``pallas_fft.fft_sublane``,
``fft_x_from_padded``, ``fft_x_to_padded`` and ``icrfft_last_planar``
in interpret mode, on inputs made by numpy from a seed. Tolerance: 1e-6
of max |reference|, max-abs (f32 on both sides, sums in other orders).
They also pin the schedule, the layout's splitting and bank conflicts,
the operation count, ``_reg_axis`` / ``_axis_tile`` and, through the C
call's arguments, the core each wrapper launches. The kernels against
their plain versions on the card are ``tests/test_torch_cuda.py``'s."""

import math

import numpy as np
import pytest
import torch

from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.kernels import regcore as rc
from offt_tpu_torch.kernels import tables as tb
from test_torch_regaxis import (GEOMETRIES, TOL, core_tab, geometry, max_rel,
                                pair, replay)

MIXED = sorted(ff._MIX_LENGTHS)


# ---- the schedule, the network and the operation count --------------------

@pytest.mark.parametrize("n", MIXED)
def test_mixed_pass_schedule(n):
    """Radix-4 passes over P = n / (4 R0), a radix 2 last of them where
    log2 P is odd, then radix 4 R0 at stride P (regs::MixGeo); strides the
    products of the radices before; each pass a permutation on both
    sides, twiddle rows inside [0, n); the last pass writes natural
    order."""
    r0 = 3 if n % 3 == 0 else 5
    v = ff._reg_values(n)
    p = n // v
    assert v == 4 * r0 and p & (p - 1) == 0 and p >= 4
    sched = rc.passes(n)
    rads = [r for r, _ in sched]
    lp = p.bit_length() - 1
    assert rads == [4] * (lp // 2) + [2] * (lp % 2) + [v]
    assert math.prod(rads) == n
    assert [ns for _, ns in sched] == [math.prod(rads[:i])
                                       for i in range(len(rads))]
    assert sched[-1] == (v, p)
    for r, ns in sched:
        assert v % r == 0               # whole butterflies a thread
        src, tw, dst = rc.pass_maps(n, r, ns)
        assert sorted(src.flatten().tolist()) == list(range(n))
        assert sorted(dst.flatten().tolist()) == list(range(n))
        assert 0 <= tw.min() and tw.max() < n
    src, _, dst = rc.pass_maps(n, *sched[-1])
    assert torch.equal(src, dst)


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("r", [12, 20])
def test_good_thomas_network_is_the_dft(r, inverse):
    """``regs::dft_pfa`` as the replay composes it: the R0-point networks
    with their constant roots, the 4-point ones, the CRT output order."""
    rng = np.random.default_rng(r + inverse)
    x = rng.standard_normal((64, r)) + 1j * rng.standard_normal((64, r))
    got = rc.dft_pfa(torch.from_numpy(x.astype(np.complex64)), inverse)
    want = np.fft.ifft(x, axis=-1) * r if inverse else np.fft.fft(x, axis=-1)
    assert max_rel(got.numpy(), want) < TOL


@pytest.mark.parametrize("n", MIXED)
def test_mixed_operation_count(n):
    """Fewer f32 operations than the 5 n log2(n) convention; the radix-12
    and radix-20 networks cost 112 and 272 (four R0-point networks of 16
    or 48, R0 4-point ones of 16)."""
    assert rc._net_flops(12) == 112 and rc._net_flops(20) == 272
    assert rc.flops(n) <= 5 * n * math.log2(n)


# ---- the column layout: tiles, splitting, banks ----------------------------

@pytest.mark.parametrize("n", MIXED)
def test_mixed_axis_tile(n):
    """The routed tile by P: narrow (256 threads) to P = 8, wide (32
    lanes up to 1024 threads) from P = 16; whole lanes; the blocks an SM
    is asked to hold fit its 228 KB; warp runs of 8 floats or more."""
    p = n // ff._reg_values(n)
    g = rc.axis_tile(n)
    assert g["tile"] == ff._axis_tile(n) == ("narrow" if p <= 8 else "wide")
    want = 256 if p <= 8 else min(32 * p, 1024)
    assert g["threads"] == want and g["P"] * g["L"] == want
    assert g["L"] >= 8 and rc.warp_runs(n) >= 8
    cg = rc.col_geometry(n, want)
    blocks = 3 if want == 256 else 1024 // want
    assert blocks * (cg["SMEM"] + 1024) <= 228 << 10


@pytest.mark.parametrize("n", MIXED)
def test_mixed_layout_is_one_to_one_and_splits(n):
    """Element a of lane l at col_at(a) + l: one slot each inside the
    plane; and every exchange address is the thread's base plus a
    compile-time offset, so the pad (one slot per four) splits over
    j + r n/R (reads) and d + r Ns (writes)."""
    g = rc.axis_tile(n)
    cg = rc.col_geometry(n, g["threads"])
    a = np.arange(n)
    pos = (rc.col_at(n, a, g["threads"])[:, None]
           + np.arange(cg["L"])[None, :]).ravel()
    assert len(set(pos.tolist())) == pos.size and pos.max() < cg["SIZE"]
    at = lambda x: rc.col_at(n, x, g["threads"])  # noqa: E731
    for r, ns in rc.passes(n):
        src, _, dst = rc.pass_maps(n, r, ns)
        j = torch.arange(n // r)[:, None]
        k = torch.arange(r)[None, :]
        d = (j // ns) * ns * r + j % ns
        assert torch.equal(at(src), at(j) + at(k * (n // r)))
        assert torch.equal(at(dst), at(d) + at(k * ns))


@pytest.mark.parametrize("n", MIXED)
def test_mixed_exchanges_are_one_wavefront(n):
    """Every put and get of the routed tile takes one wavefront a warp
    instruction (W = 32 / L row threads a warp: 1 to 640, 2 at 768 and
    1280, 4 at 1536 and 2560)."""
    g = rc.axis_tile(n)
    ways = rc.col_bank_ways(n, g["threads"])
    assert len(ways) == 2 * (len(rc.passes(n)) - 1)
    assert max(ways.values()) == 1


def test_pad_per_sixteen_would_conflict_at_mixed_lengths(monkeypatch):
    """Why the mixed layout pads one slot per four: with the power-of-two
    layout's one per 16, the first put (runs of four, a = 4 t + r) puts
    two row threads of a warp on one bank at 768 (W = 2)."""
    def pad16(n, a, threads=256):
        return (a + (a >> 4)) * (threads // (n // ff._reg_values(n)))
    monkeypatch.setattr(rc, "col_at", pad16)
    ways = rc.col_bank_ways(768, 1024)
    assert ways[(0, "put")] == 2


# ---- the replay against numpy and the reference ----------------------------

@pytest.mark.parametrize("kind", GEOMETRIES)
@pytest.mark.parametrize("n", MIXED)
def test_mixed_axis_replay_matches_numpy(n, kind):
    shape, geom, oshape, axis, lanes = geometry(kind, n)
    xr, xi = pair(shape, n + len(kind))
    inverse = kind in ("pitched out", "alias")
    got = replay(xr, xi, n, geom, oshape, inverse, 0.375,
                 alias=kind == "alias")
    x = (xr.astype(np.float64) + 1j * xi)[..., :lanes]
    want = 0.375 * (np.fft.ifft(x, axis=axis) * n if inverse
                    else np.fft.fft(x, axis=axis))
    assert max_rel(got[..., :lanes], want) < TOL
    if kind == "pitched out":       # the pad lanes are never written
        assert np.isnan(got[..., lanes:]).all()


@pytest.mark.parametrize("axis", [0, 1])
def test_replay_matches_reference_sublane_192(axis):
    xr, xi = pair((192, 192, 8), 41 + axis)
    ref = pf.fft_sublane(xr, xi, axis, scale=0.5)
    pre, lanes = (1, 192 * 8) if axis == 0 else (192, 8)
    st = (192 * lanes, lanes, lanes)
    got = replay(xr, xi, 192, (pre, 1, lanes, st, st), (192, 192, 8),
                 scale=0.5)
    want = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
    assert max_rel(got, want) < TOL


def test_replay_matches_reference_sublane_320():
    xr, xi = pair((320, 4, 8), 43)
    ref = pf.fft_sublane(xr, xi, 0, inverse=True, scale=1.0 / 320)
    st = (320 * 32, 32, 32)
    got = replay(xr, xi, 320, (1, 1, 32, st, st), (320, 4, 8), True,
                 1.0 / 320)
    want = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
    assert max_rel(got, want) < TOL


def test_replay_matches_reference_x_from_padded_96():
    xr, xi = pair((96, 8, 136), 45)
    ref = pf.fft_x_from_padded(xr, xi, 128, scale=2.0)
    geom = (1, 8, 128, (96 * 8 * 136, 8 * 136, 136),
            (96 * 8 * 128, 8 * 128, 128))
    got = replay(xr, xi, 96, geom, (96, 8, 128), scale=2.0)
    want = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
    assert max_rel(got, want) < TOL


def test_replay_matches_reference_x_to_padded_320():
    xr, xi = pair((320, 8, 129), 47)
    ref = pf.fft_x_to_padded(xr, xi, zpad=8, inverse=True, z_true=128,
                             scale=0.5)
    geom = (1, 8, 128, (320 * 8 * 129, 8 * 129, 129),
            (320 * 8 * 136, 8 * 136, 136))
    got = replay(xr, xi, 320, geom, (320, 8, 136), True, 0.5)
    want = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
    assert max_rel(got[..., :128], want[..., :128]) < TOL


@pytest.mark.parametrize("n", [96, 320, 768])
def test_plain_version_agrees_with_the_mixed_replay(n):
    xr, xi = pair((2, n, 24), n)
    pr, pi = ff.fft_sublane(torch.from_numpy(xr), torch.from_numpy(xi), 1,
                            scale=0.5)
    st = (n * 24, 24, 24)
    got = replay(xr, xi, n, (2, 1, 24, st, st), (2, n, 24), scale=0.5)
    assert max_rel(pr.numpy() + 1j * pi.numpy(), got) < TOL


# ---- routing: the C call's arguments ----------------------------------------

def _launches(monkeypatch):
    """Record each C entry point's name and arguments instead of calling
    it, so the kernel route runs on CPU tensors."""
    calls = []
    monkeypatch.setattr(ff, "_launch", lambda entry, tensors, tabs, args:
                        calls.append((entry, args)))
    return calls


@pytest.mark.parametrize("n", [48, 96, 160, 192, 320, 384, 640, 768, 1280,
                               1536, 2560, 3072, 360, 256])
def test_reg_axis_routes_the_mixed_lengths(monkeypatch, n):
    """The mixed lengths launch the register core (reg = 1) with the tile
    code of ``_axis_tile``; 3072 (two wavefronts) and 360 (3^2) take the
    dense core; the narrow probe stays at powers of two."""
    calls = _launches(monkeypatch)
    x = torch.zeros((2, n, 8))
    ff.fft_sublane.impl("kernel", x, x, 1)
    (entry, args), = calls
    assert entry == "offt_fft_axis"
    reg, code = args[-2:]
    assert reg == int(n in ff._MIX_LENGTHS or n == 256)
    if reg:
        assert code == ff._AXIS_TILES[ff._axis_tile(n)]
    if n in ff._MIX_LENGTHS:
        with pytest.raises(ValueError, match="power of two"):
            ff.fft_sublane.impl("kernel", x, x, 1, tile="narrow")


@pytest.mark.parametrize("m", [16, 128, 4096, 96, 192])
def test_icrfft_last_routes_to_the_register_core(monkeypatch, m):
    """``_reg_core(M)`` sends the packed c2r to the register core's c2r
    rows (reg = 1, no rows per block); other M keep the dense core."""
    calls = _launches(monkeypatch)
    x = torch.zeros((3, m))
    ff.reset_counts()
    ff.icrfft_last_planar.impl("kernel", x, x)
    (entry, args), = calls
    assert entry == "offt_icrfft_last"
    reg, t = args[-1], args[-2]
    assert reg == int(ff._reg_core(m)) == int(m in (16, 128, 4096))
    assert (t == 0) == bool(reg)
    assert ff.icrfft_last_planar.reg_launches == reg


# ---- icrfft_last: the c2r rows replay against the reference ---------------

def packed_spectrum(lead, n, seed):
    """Real rows x (lead, n) in float64 and the packed planar
    half-spectrum of them (lane 0 = X[0] + i X[M]) in float32."""
    x = np.random.default_rng(seed).standard_normal((*lead, n))
    w = np.fft.rfft(x, axis=-1)
    m = n // 2
    p = w[..., :m].copy()
    p[..., 0] = w[..., 0].real + 1j * w[..., m].real
    return x, p.real.astype(np.float32), p.imag.astype(np.float32)


@pytest.mark.parametrize("scale", [None, 0.25])
@pytest.mark.parametrize("lead", [(37,), (3, 5)])
@pytest.mark.parametrize("m", [16, 32, 64, 128, 256])
def test_rows_c2r_replay_matches_reference_icrfft_last(m, lead, scale):
    """``regcore.rows_c2r`` (the kernel ``icrfft_last_planar`` launches at
    these M) against ``pallas_fft.icrfft_last_planar`` over a ragged batch
    (37 rows; 3 x 5), at the default scale 1/M and an explicit one."""
    x, re, im = packed_spectrum(lead, 2 * m, seed=m + len(lead))
    s = scale / m if scale else 1.0 / m
    ab = torch.from_numpy(tb.crfft_table(2 * m, s).copy())
    got = rc.rows_c2r(torch.from_numpy(re), torch.from_numpy(im),
                      core_tab(m, True), ab).numpy()
    ref = np.asarray(pf.icrfft_last_planar(re, im, 2 * m,
                                           **({"scale": s} if scale
                                              else {})))
    assert got.shape == ref.shape == (*lead, 2 * m)
    assert max_rel(got, ref) < TOL
    assert max_rel(got, x * (scale or 1.0)) < TOL
