"""The register core of the two last-axis row kernels
(``csrc/fft_regs.cuh``: ``fft_last`` on N, ``rfft_last_planar`` on
M = N/2, for powers of two in [16, 4096]) on the CPU.

No CPU runs the kernel, so :mod:`offt_tpu_torch.kernels.regcore` replays
its pass schedule (radices, strides, twiddle indices, gathers and
scatters, shared-memory layout) with torch ops, and these tests hold that
replay against complex128 numpy at every length (norm-relative 1e-6, the
repo's fp32 bar) and against the JAX reference's Pallas kernels in
interpret mode at 128 and 1024 (max-abs relative 1e-5: f32 on both sides,
sums in other orders). They also pin the routing predicate, that the
register core reads nothing the radices change, its shared-memory
geometry and bank conflicts, and its operation count. The kernel against
its plain version on the card is ``tests/test_torch_cuda.py``'s."""

import math

import numpy as np
import pytest
import torch

from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.kernels import regcore as rc
from offt_tpu_torch.kernels import tables as tb

TOL_NP = 1e-6
TOL_REF = 1e-5
LENGTHS = [1 << k for k in range(4, 13)]


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / np.abs(b).max()


def pair(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def core_tab(n, inverse, scale=1.0, radices=None):
    stages = tb.core_stages(tb._pick_stages(n, radices))
    return torch.from_numpy(tb.core_table(n, stages, inverse, scale).copy())


def emulate(xr, xi, inverse, scale):
    n = xr.shape[-1]
    yr, yi = rc.fft_rows(torch.from_numpy(xr), torch.from_numpy(xi),
                         core_tab(n, inverse), inverse, scale)
    return yr.numpy().astype(np.float64) + 1j * yi.numpy()


def emulate_r2c(x, packed, scale):
    n = x.shape[-1]
    w = torch.from_numpy(tb.rfft_table(n).copy())
    yr, yi = rc.rfft_rows(torch.from_numpy(x), core_tab(n // 2, False), w,
                          scale, packed)
    return yr.numpy().astype(np.float64) + 1j * yi.numpy()


def packed_truth(x):
    """numpy's half-spectrum in the packed layout: lane 0 = X0 + i XM."""
    w = np.fft.rfft(x.astype(np.float64))
    m = x.shape[-1] // 2
    out = w[..., :m].copy()
    out[..., 0] = w[..., 0].real + 1j * w[..., m].real
    return out


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256, 512, 1024, 2048, 4096,
                               8, 320, 129, 96, 8192, 0, 48, 4095])
def test_reg_core_predicate(n):
    """``_reg_core`` (the r2c and c2r rows, the four-step pair) takes
    powers of two in [16, 4096]; the replay's schedule also has the mixed
    lengths (320, 96, 48: radix 4 first), whose row layout is the mixed
    rows' (``fft_last`` and the c2c slab's z rows, ``_reg_rows``), and no
    other."""
    want = n in LENGTHS
    assert ff._reg_core(n) is want
    if want:
        assert rc.passes(n)[0] == (16, 1)
    elif n in ff._MIX_LENGTHS:
        assert rc.passes(n)[0] == (4, 1)
        assert ff._reg_rows(n)
        g = rc.geometry(n)
        assert g["P"] * g["V"] == n and g["P"] * g["ROWS"] == rc.THREADS
    else:
        with pytest.raises(ValueError):
            rc.passes(n)


@pytest.mark.parametrize("n", LENGTHS)
def test_pass_schedule(n):
    """Radix-16 passes with the remainder last, strides 16^p, each pass a
    permutation of the row on both sides, twiddle rows inside [0, n)."""
    sched = rc.passes(n)
    assert math.prod(r for r, _ in sched) == n
    assert [ns for _, ns in sched] == [16 ** p for p in range(len(sched))]
    assert all(r == 16 for r, _ in sched[:-1])
    for r, ns in sched:
        src, tw, dst = rc.pass_maps(n, r, ns)
        assert sorted(src.flatten().tolist()) == list(range(n))
        assert sorted(dst.flatten().tolist()) == list(range(n))
        assert 0 <= tw.min() and tw.max() < n
    # the last pass writes natural order: output r of butterfly j at
    # j + r n/R, the address it read
    r, ns = sched[-1]
    src, _, dst = rc.pass_maps(n, r, ns)
    assert torch.equal(src, dst)


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("inverse", [False, True])
def test_emulation_matches_numpy(n, inverse):
    xr, xi = pair((5, n), n + inverse)
    got = emulate(xr, xi, inverse, 0.375)
    x = xr.astype(np.float64) + 1j * xi
    want = 0.375 * (np.fft.ifft(x) * n if inverse else np.fft.fft(x))
    assert rel_err(got, want) < TOL_NP


@pytest.mark.parametrize("m", LENGTHS)
@pytest.mark.parametrize("packed", [False, True])
def test_r2c_emulation_matches_numpy(m, packed):
    x = pair((3, 2 * m), m)[0]
    got = emulate_r2c(x, packed, 0.5)
    want = 0.5 * (packed_truth(x) if packed
                  else np.fft.rfft(x.astype(np.float64)))
    assert got.shape == want.shape == (3, m + (0 if packed else 1))
    assert rel_err(got, want) < TOL_NP


@pytest.mark.parametrize("n", [128, 1024])
@pytest.mark.parametrize("inverse", [False, True])
def test_emulation_matches_reference_fft_last(n, inverse):
    xr, xi = pair((8, n), 7 * n + inverse)
    ref = pf.fft_last(xr, xi, inverse=inverse, scale=0.5)
    want = np.asarray(ref[0]).astype(np.float64) + 1j * np.asarray(ref[1])
    assert max_rel(emulate(xr, xi, inverse, 0.5), want) < TOL_REF


@pytest.mark.parametrize("n", [256, 1024])
@pytest.mark.parametrize("packed", [False, True])
def test_emulation_matches_reference_rfft_last(n, packed):
    x = pair((8, n), n)[0]
    ref = pf.rfft_last_planar(x, packed=packed)
    want = np.asarray(ref[0]).astype(np.float64) + 1j * np.asarray(ref[1])
    assert max_rel(emulate_r2c(x, packed, 1.0), want) < TOL_REF


@pytest.mark.parametrize("n,picks", [
    (1024, [None, (32, 32), (8, 128), (16, 64), (8, 8, 16)]),
    (256, [None, (128, 2), (16, 16), (4, 4, 16)]),
    (4096, [None, (64, 64), (16, 16, 16)]),
])
@pytest.mark.parametrize("inverse", [False, True])
def test_radices_do_not_change_the_register_core(n, picks, inverse):
    """The register core reads only the first n rows of the core table and
    the scale argument: those rows are bit-equal for every valid pick and
    scale, so its output is too. The plain version, on the CPU, follows
    the pick's stages and agrees to rounding."""
    tabs = [core_tab(n, inverse, s, p) for p in picks for s in (1.0, 0.25)]
    for t in tabs[1:]:
        assert torch.equal(t[:n], tabs[0][:n])
    xr, xi = pair((4, n), n)
    outs = [rc.fft_rows(torch.from_numpy(xr), torch.from_numpy(xi), t,
                        inverse) for t in tabs]
    for o in outs[1:]:
        assert torch.equal(o[0], outs[0][0]) and torch.equal(o[1],
                                                             outs[0][1])
    want = outs[0][0].numpy() + 1j * outs[0][1].numpy()
    for p in picks:
        pr, pi = ff.fft_last(torch.from_numpy(xr), torch.from_numpy(xi),
                             inverse=inverse, radices=p)
        assert max_rel(pr.numpy() + 1j * pi.numpy(), want) < TOL_REF


@pytest.mark.parametrize("n", LENGTHS)
def test_shared_geometry(n):
    """Each row's exchange plane holds the row one-to-one inside its pitch,
    16-byte aligned for the float4 writes, rows that share a warp start
    P banks apart, and a block's planes fit its shared memory."""
    g = rc.geometry(n)
    pos = rc.phys(np.arange(n))
    assert len(set(pos.tolist())) == n and pos.max() < g["SIZE"] <= g["PITCH"]
    assert g["PITCH"] % 4 == 0 and rc.phys(0) == 0
    assert g["P"] * g["ROWS"] == rc.THREADS
    if 4 <= g["P"] < 32:
        assert g["PITCH"] % 32 == g["P"]
    assert g["SMEM"] == 2 * g["ROWS"] * g["PITCH"] * 4 <= 3 * (1 << 15)


@pytest.mark.parametrize("n", LENGTHS)
def test_exchanges_are_free_of_bank_conflicts(n):
    """The first pass's float4 writes, the later passes' scalar writes and
    every pass's reads take one wavefront per warp instruction from
    N = 128 (P >= 8 threads a row); the shorter rows share a warp with
    several others and take at most two."""
    ways = rc.bank_ways(n)
    assert len(ways) == 2 * (len(rc.passes(n)) - 1)
    assert max(ways.values(), default=1) <= (1 if n >= 128 else 2)


@pytest.mark.parametrize("n", LENGTHS)
def test_operation_count(n):
    """The core does fewer f32 operations than the 5 n log2(n) convention
    (a radix-16 butterfly's network costs 176 of its 5 * 16 * 4 = 320),
    where the dense core did 8 sum(r) + 6 (stages - 1) per element."""
    flops = rc.flops(n) / n
    assert flops <= 5 * math.log2(n)
    stages = tb.core_stages(tb._pick_stages(n))
    dense = 8 * sum(stages) + 6 * (len(stages) - 1)
    assert flops < dense / 4


def test_reset_counts_zeroes_the_register_core_count():
    ff.fft_last.reg_launches = ff.rfft_last_planar.reg_launches = 3
    ff.reset_counts()
    assert ff.fft_last.reg_launches == ff.rfft_last_planar.reg_launches == 0
    assert all(f.reg_launches == 0 for f in ff.WRAPPERS.values())


@pytest.mark.parametrize("n", LENGTHS)
def test_pad_map_splits_over_the_exchange_addresses(n):
    """The kernel addresses element j + r n/R (reads) and d + r Ns
    (writes, d = (j div Ns) Ns R + j mod Ns) of an exchange plane as the
    thread's phys(j) or phys(d) plus the constant phys(r n/R) or
    phys(r Ns): the pad map must split over every such sum."""
    for r, ns in rc.passes(n):
        src, _, dst = rc.pass_maps(n, r, ns)
        j = torch.arange(n // r)[:, None]
        k = torch.arange(r)[None, :]
        d = (j // ns) * ns * r + j % ns
        assert torch.equal(rc.phys(src), rc.phys(j) + rc.phys(k * (n // r)))
        assert torch.equal(rc.phys(dst), rc.phys(d) + rc.phys(k * ns))
