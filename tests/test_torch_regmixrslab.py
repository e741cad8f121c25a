"""The r2c and c2r slab kernels (``csrc/rfft_slab.cu``,
``csrc/irfft_slab.cu``) on the register core at a mixed (Y, M), on the
CPU: Y on the column variant (a power of two in [16, 4096] or a mixed
length of ``fused_fft._MIX_LENGTHS``), M = N/2 on the real rows (those
and 3072, ``_MIX_ROW_LENGTHS``), at least one of them mixed, in two
grids.

No CPU runs those kernels, so :mod:`offt_tpu_torch.kernels.regcore`
replays their two grids: :func:`regcore.rfft_slab` the r2c rows block by
block into the packed rows at the slab's pitch M + zpad through the
kernel's pitched copy (:func:`regcore.r2c_mix_copy`), then the y lines
tile by tile in place on it (:func:`regcore.fft_axis`);
:func:`regcore.irfft_slab` the inverse y lines from the pitched input
into a planar scratch, the Nyquist side plane added as lane 0 loads,
then the c2r rows. These tests hold the replays against complex128 numpy
and against the reference's ``pallas_fft.rfft_slab_yz`` /
``irfft_slab_yz`` in interpret mode, with and without the side plane,
and the packed plan at (8, 48, 768) against ``offt_tpu.plan``, both
layouts, r2c and c2r, on inputs made by numpy from a seed. Tolerance:
1e-6 of max |reference|, max-abs, as ``test_torch_regmixrows.py`` states
it (f32 on both sides, sums in other orders); the plans 1e-5 of the
reference and 1e-6 of numpy by norm, as ``test_torch_real_plan.py``
states it. They pin the routing predicate ``_reg_rslab`` at each class of
(Y, M), the cluster predicates (powers of two alone, unchanged on every
shape), the whole-sector stores of the pitched copy, and, through the C
call's arguments (``fused_fft._launch`` monkeypatched), the core, the
layout, the pitch and the scratch each wrapper launches with. The
kernels against their plain versions on the card are
``tests/test_torch_cuda.py``'s."""

import numpy as np
import pytest
import torch

from offt_tpu.kernels import pallas_fft as pf
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.kernels import regcore as rc
from offt_tpu_torch.kernels import tables as tb
from test_torch_real_plan import (TOL_NP, TOL_REF, _run_both, ref_routes,
                                  rel_err)
from test_torch_regirslab import replay as c2r_replay
from test_torch_regirslab import spectrum
from test_torch_regslab import (TOL, core_tab, cplx, max_rel, packed_truth,
                                pair, replay_r2c)

__all__ = ["ref_routes"]

POW2 = [1 << k for k in range(4, 13)]
MIXED = sorted(ff._MIX_LENGTHS)
# (P, Y, N): Y mixed with M a power of two, Y a power of two with M mixed,
# both mixed (M = 48 and 80: rows of 4 threads; 3072: one row a block; Y
# = 1536: eight lanes a block on the wide tile)
SLABS = [(2, 48, 256), (2, 16, 768), (2, 48, 768), (3, 96, 160),
         (2, 320, 96), (1, 48, 6144), (1, 1536, 96), (2, 2560, 32)]
# the reference's shapes (its interpret-mode kernels take 0.3-1.5 s each)
REF_SLABS = [(2, 48, 256), (2, 16, 768), (2, 48, 768)]
# every length the predicates could see: the register core's and the
# dense core's (24, 40, 72, 144, 360, 6144)
ALL = sorted(set(POW2 + MIXED) | {8, 24, 40, 72, 144, 360, 3072, 6144})


def _parent_cluster_slab(ny, nz):
    """The cluster predicate as it stood before the mixed real slabs:
    both powers of two in [16, 4096], nz >= 128, ny >= 64, 2^14 to 2^17
    elements."""
    p2 = ny in POW2 and nz in POW2
    return p2 and nz >= 128 and ny >= 64 and 1 << 14 <= ny * nz <= 1 << 17


# ---- the predicates ---------------------------------------------------------

@pytest.mark.parametrize("ny,m,reg", [
    (256, 128, True), (512, 256, True),         # powers of two
    (48, 128, True), (768, 256, True),          # Y mixed
    (16, 384, True), (256, 3072, True),         # M mixed (3072 as rows)
    (768, 384, True), (1280, 640, True),        # both: 768^3, 1280^3
    (48, 48, True), (2560, 2560, True),
    (40, 640, False), (24, 128, False),         # Y without a network
    (3072, 128, False), (256, 72, False),       # 3072 as columns; 3^2 8
    (256, 144, False), (8, 128, False), (128, 6144, False)])
def test_reg_rslab_at_each_class(ny, m, reg):
    """``_reg_rslab`` is ``_reg_axis(Y) and _reg_real_rows(M)`` without
    the smooth Y of either family (the real slabs' y passes have no smooth
    instance; Y = 24 and 40 are the second family's columns) and
    without the smooth M of either family (``rfft_last_planar`` and
    ``icrfft_last_planar`` take them on the smooth real rows, which the
    slabs do not launch at
    their pitch): the r2c and c2r slabs take the register core wherever
    each half has its instances, mixed or not, and the dense core
    elsewhere (Y = 24, 40, 3072 or smooth; M = 72, 144, smooth, both on
    the real rows)."""
    assert ff._reg_rslab(ny, m) is reg
    assert reg == (ff._reg_axis(ny) and ny not in ff._SMOOTH_ROWS
                   and ff._reg_real_rows(m) and m not in ff._SMOOTH_ROWS)
    if m in (72, 144):
        assert ff._reg_real_rows(m)


def test_reg_rslab_over_every_length():
    for ny in ALL:
        for m in ALL:
            assert ff._reg_rslab(ny, m) == (
                ff._reg_axis(ny) and ny not in ff._SMOOTH_ROWS
                and ff._reg_real_rows(m) and m not in ff._SMOOTH_ROWS)


def test_cluster_predicates_unchanged_on_every_shape():
    """Widening ``_reg_rslab`` moves no slab into or out of the cluster
    layouts: ``_cluster_slab`` and ``_cluster_irslab`` choose exactly the
    power-of-two shapes they chose before, c2c, r2c and c2r."""
    for ny in ALL:
        for nz in ALL:
            want = _parent_cluster_slab(ny, nz)
            assert ff._cluster_slab(ny, nz) is want, (ny, nz)
            assert ff._cluster_irslab(ny, nz) is (
                want and ny * nz <= 1 << 15), (ny, nz)


@pytest.mark.parametrize("ny,nz,want", [
    (320, 320, False), (96, 256, False), (768, 384, False),
    (256, 128, True), (512, 256, True), (64, 256, True)])
def test_cluster_predicates_at_the_named_shapes(ny, nz, want):
    """The 320^2 c2c slab (102,400 elements, inside 2^14-2^17) and the
    mixed real slabs stay off the cluster layouts, whose ``by_log``
    dispatch takes powers of two only; the 256^3 and 512^3 slabs keep
    them."""
    assert ff._cluster_slab(ny, nz) is want
    assert ff._cluster_irslab(ny, nz) is (want and ny * nz <= 1 << 15)


# ---- the pitched copy of the mixed r2c rows ---------------------------------

@pytest.mark.parametrize("m", sorted(ff._MIX_ROW_LENGTHS))
def test_pitched_copy_is_one_to_one(m):
    """At the slab's pitch M + 8 the copy writes each packed lane of each
    row once, at (row0 + r)(M + 8) + c, and no pad lane; each read of the
    stage is its own."""
    rows = rc.geometry(m)["ROWS"]
    src, dst = rc.r2c_mix_copy(m, m, m + 8, block=1)
    assert src.unique().numel() == dst.unique().numel() == rows * m
    r, c = dst // (m + 8) - rows, dst % (m + 8)
    assert (c < m).all() and (r >= 0).all() and (r < rows).all()
    assert torch.equal(src, r * rc.stage_pitch(m) + c)


@pytest.mark.parametrize("m", sorted(ff._MIX_ROW_LENGTHS))
def test_pitched_copy_stores_whole_sectors(m):
    """Each warp instruction of the copy (32 consecutive floats of the
    block's rows) writes whole 32-byte sectors of the output at the
    slab's pitch M + 8: every row starts 32-byte aligned and M is a
    multiple of 16, so a warp crossing a row's end writes two runs of
    whole sectors and skips the pad lanes between them."""
    for block in (0, 1, 5):
        _, dst = rc.r2c_mix_copy(m, m, m + 8, block=block)
        pad = (-dst.numel()) % 32
        for warp in torch.cat([dst, dst[:pad]]).reshape(-1, 32):
            _, counts = torch.unique(warp // 8, return_counts=True)
            assert (counts == 8).all(), (block, warp.tolist())


@pytest.mark.parametrize("m", sorted(ff._MIX_ROW_LENGTHS))
@pytest.mark.parametrize("packed", [False, True])
def test_rfft_last_copy_stays_contiguous(m, packed):
    """At ``rfft_last``'s layouts (the pitch its lanes, M or M + 1) the
    copy writes float i of the block's rows at row0 L + i: the block's
    rows one contiguous run, as before the rows took a pitch."""
    lanes = m if packed else m + 1
    rows = rc.geometry(m)["ROWS"]
    for block in (0, 3):
        src, dst = rc.r2c_mix_copy(m, lanes, lanes, block=block)
        assert torch.equal(dst, block * rows * lanes
                           + torch.arange(rows * lanes))
        r = torch.arange(rows * lanes) // lanes
        assert torch.equal(src, r * rc.stage_pitch(m)
                           + torch.arange(rows * lanes) - r * lanes)


@pytest.mark.parametrize("m", [48, 96, 384, 640, 3072])
def test_pitched_rows_match_the_contiguous_ones(m):
    """The pitched copy writes the values the contiguous packed copy
    writes, lane for lane; the pad lanes stay unwritten (NaN)."""
    x = torch.from_numpy(pair((5, 2 * m), m)[0])
    w = torch.from_numpy(tb.rfft_table(2 * m).copy())
    tab = core_tab(m, False)
    yr, yi = rc.rfft_rows(x, tab, w, packed=True)
    pr, pi = rc.rfft_rows(x, tab, w, packed=True, opitch=m + 8)
    assert pr.shape == (5, m + 8)
    assert torch.equal(pr[:, :m], yr) and torch.equal(pi[:, :m], yi)
    assert pr[:, m:].isnan().all() and pi[:, m:].isnan().all()


# ---- the replays against numpy and the reference ----------------------------

@pytest.mark.parametrize("shape", SLABS)
def test_mixed_rslab_replay_matches_numpy(shape):
    x = pair(shape, sum(shape))[0]
    m = shape[-1] // 2
    yr, yi = replay_r2c(x, zpad=8)
    assert yr.shape == (*shape[:-1], m + 8)
    assert np.isnan(yr[..., m:]).all() and np.isnan(yi[..., m:]).all()
    assert max_rel(cplx(yr, yi, m), packed_truth(x)) < TOL


@pytest.mark.parametrize("side", [False, True])
@pytest.mark.parametrize("shape", SLABS)
def test_mixed_irslab_replay_matches_numpy(shape, side):
    ny, m = shape[1], shape[-1] // 2
    x, xr, xi, s = spectrum(shape, sum(shape) + side, side)
    got = c2r_replay(xr, xi, 2 * m, 1.0 / (ny * m), s)
    assert got.shape == x.shape and np.isfinite(got).all()
    assert max_rel(got, x) < TOL


def test_irslab_replay_reads_only_the_first_m_lanes():
    """NaN pad lanes of the input and an unscaled re-tangle: the scratch
    takes lanes 0..M-1 alone, and the unscaled result is Y M times the
    real data."""
    shape = (2, 48, 768)
    x, xr, xi, _ = spectrum(shape, 4, False)
    got = c2r_replay(xr, xi, 768, 1.0)
    assert max_rel(got, 48 * 384 * x) < TOL


@pytest.mark.parametrize("shape", REF_SLABS)
def test_mixed_rslab_replay_matches_reference(shape):
    x = pair(shape, sum(shape) + 1)[0]
    m = shape[-1] // 2
    ref = pf.rfft_slab_yz(x, zpad=8)
    got = replay_r2c(x, zpad=8)
    assert got[0].shape == ref[0].shape == (*shape[:-1], m + 8)
    want = cplx(np.asarray(ref[0]), np.asarray(ref[1]), m)
    assert max_rel(cplx(*got, m), want) < TOL


@pytest.mark.parametrize("side", [False, True])
@pytest.mark.parametrize("shape", REF_SLABS)
def test_mixed_irslab_replay_matches_reference(shape, side):
    ny, m = shape[1], shape[-1] // 2
    _, xr, xi, s = spectrum(shape, sum(shape) + 2 + side, side)
    scale = 1.0 / (ny * m)
    kw = {"side_r": s[0], "side_i": s[1]} if side else {}
    ref = np.asarray(pf.irfft_slab_yz(np.nan_to_num(xr), np.nan_to_num(xi),
                                      2 * m, scale=scale, **kw))
    got = c2r_replay(xr, xi, 2 * m, scale, s)
    assert got.shape == ref.shape
    assert max_rel(got, ref) < TOL


@pytest.mark.parametrize("shape", [(2, 48, 256), (2, 16, 768)])
def test_plain_versions_agree_with_the_replays(shape):
    """The wrappers' plain versions (the dense core's arithmetic, on the
    CPU) and the register slabs' replays compute the same functions."""
    ny, m = shape[1], shape[-1] // 2
    x = pair(shape, 9)[0]
    pr, pi = ff.rfft_slab_yz(torch.from_numpy(x), zpad=8)
    want = replay_r2c(x, zpad=8)
    assert max_rel(cplx(pr.numpy(), pi.numpy(), m), cplx(*want, m)) < TOL
    _, xr, xi, s = spectrum(shape, 10, True)
    t = torch.from_numpy
    plain = ff.irfft_slab_yz(t(np.nan_to_num(xr)), t(np.nan_to_num(xi)),
                             2 * m, scale=1.0 / (ny * m), side_r=t(s[0]),
                             side_i=t(s[1]))
    got = c2r_replay(xr, xi, 2 * m, 1.0 / (ny * m), s)
    assert max_rel(plain.numpy(), got) < TOL


# ---- the plan at (8, 48, 768) against the reference plan -------------------

@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
def test_mixed_real_plan_matches_reference(inverse, packed, ref_routes):
    """The packed route at a mixed Y and M (Y = 48 = 3 16, M = 384 =
    3 128): the slab (``rfft_slab_yz`` / ``irfft_slab_yz``) and the
    pitched x pass, called as the reference calls its kernels, against
    ``offt_tpu.plan`` and numpy."""
    assert ff.can_use_rfft3d(8, 48, 768) and ff._reg_rslab(48, 384)
    got, ref, want = _run_both((8, 48, 768), inverse, packed, None,
                               ref_routes)
    assert rel_err(got, ref) < TOL_REF
    assert rel_err(got, want) < TOL_NP


# ---- the C call's arguments -------------------------------------------------

def _launches(monkeypatch):
    """Record each C entry point's name, tensors and arguments instead of
    calling it, so the kernel route runs on CPU tensors."""
    calls = []
    monkeypatch.setattr(ff, "_launch", lambda entry, tensors, tabs, args:
                        calls.append((entry, tensors, args)))
    return calls


@pytest.mark.parametrize("ny,n,reg,cluster", [
    (768, 768, 1, 0), (1280, 1280, 1, 0), (96, 512, 1, 0), (48, 192, 1, 0),
    (16, 768, 1, 0), (256, 256, 1, 1), (512, 512, 1, 1), (40, 640, 0, 0),
    (256, 144, 0, 0)])
def test_real_slabs_route_the_mixed_slabs(monkeypatch, ny, n, reg, cluster):
    """``reg = 1, cluster = 0`` at the mixed slabs (two grids), the rows'
    pitch M + zpad, and the c2r's scratch (P, Y, M) allocated; the 256^3
    slabs keep their clusters, the 512^3 r2c its clusters and its c2r two
    grids; Y = 40 and M = 72 keep the dense core (its
    tiles set, no scratch)."""
    calls = _launches(monkeypatch)
    m = n // 2
    ff.reset_counts()
    ff.rfft_slab_yz.impl("kernel", torch.zeros((2, ny, n)), zpad=8)
    ff.irfft_slab_yz.impl("kernel", torch.zeros((2, ny, m + 8)),
                          torch.zeros((2, ny, m + 8)), n,
                          side_r=torch.zeros((2, ny)),
                          side_i=torch.zeros((2, ny)))
    (r_entry, _, r_args), (i_entry, i_tensors, i_args) = calls
    assert (r_entry, i_entry) == ("offt_rfft_slab", "offt_irfft_slab")
    assert r_args[:4] == [2, ny, m, m + 8]
    assert r_args[-3:] == [reg, cluster, 0]
    assert (r_args[-5] == 0) == bool(reg)       # no dense tile
    assert i_args[:4] == [2, ny, m, m + 8]
    icluster = int(cluster and ny * m <= 1 << 15)
    assert i_args[-2:] == [reg, icluster]
    scratch = i_tensors[5:7]
    if reg and not icluster:
        assert all(t.shape == (2, ny, m) for t in scratch)
    else:
        assert scratch == (None, None)
    assert ff.rfft_slab_yz.reg_launches == ff.irfft_slab_yz.reg_launches \
        == reg


def test_dense_core_patch_keeps_the_cluster_slabs_dense(monkeypatch):
    """With ``_reg_rslab`` patched off (the dense-core comparison of
    ``chip_smoke.py`` and ``bench/dense_core.py``) the 256^3 slab, whose
    shape the cluster predicate still admits, launches the dense core and
    no cluster: the cluster flag follows the register core."""
    calls = _launches(monkeypatch)
    monkeypatch.setattr(ff, "_reg_rslab", lambda ny, m: False)
    ff.rfft_slab_yz.impl("kernel", torch.zeros((2, 256, 256)), zpad=8)
    ff.irfft_slab_yz.impl("kernel", torch.zeros((2, 256, 136)),
                          torch.zeros((2, 256, 136)), 256)
    assert ff._cluster_slab(256, 128)
    (_, _, r_args), (_, i_tensors, i_args) = calls
    assert r_args[-3:-1] == [0, 0] and i_args[-2:] == [0, 0]
    assert i_tensors[5:7] == (None, None)
