"""The real rows at the mixed half lengths M = 3 * 2^k and 5 * 2^k
(``csrc/real_rows_mix.cu``: ``rfft_last_planar`` and
``icrfft_last_planar`` on the register core's mixed rows), on the CPU.

No CPU runs those kernels, so :mod:`offt_tpu_torch.kernels.regcore`
replays them block by block: :func:`regcore.rfft_rows_mix_block` (the
mixed core on v[j] = x[2j] + i x[2j+1], V put in natural order into the
swizzled exchange planes, the pairs (k, M - k) read back and untangled,
the output rows staged and copied out) and
:func:`regcore.rows_c2r_mix_block` (the re-tangle as the core loads,
the partner lane e ? M - e : 0, the inverse core, float2 stores), every
shared-memory address the one the kernel computes
(:func:`regcore.r2c_mix_addrs`, :func:`regcore.c2r_mix_loads`). These
tests pin those maps (one-to-one, the stage pitch, the bank ways by
``regcore.bank_ways``) and hold the replays against complex128 numpy at
every routed mixed M, both layouts, scaled, with a ragged last block
(1e-6 of max |reference|, max-abs: f32 on both sides, sums in other
orders, as ``test_torch_regmixrows.py`` states it); against the
reference's Pallas kernels in ``test_torch_regmixreal_ref.py``. Through
the C call's arguments (``fused_fft._launch`` monkeypatched) they pin
the core each wrapper launches. The kernels against their plain versions
on the card are ``tests/test_torch_cuda.py``'s."""

import numpy as np
import pytest
import torch

from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.kernels import regcore as rc
from offt_tpu_torch.kernels import tables as tb
from test_torch_regaxis import TOL, core_tab, max_rel
from test_torch_regmixed import packed_spectrum
from test_torch_regmixrows import _launches, cplx

ROWS = sorted(ff._MIX_ROW_LENGTHS)


def real_rows(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def rfft_replay(x, scale=1.0, packed=False):
    m = x.shape[-1] // 2
    w = torch.from_numpy(tb.rfft_table(2 * m).copy())
    return cplx(*rc.rfft_rows(torch.from_numpy(x), core_tab(m, False), w,
                              scale, packed))


def c2r_replay(re, im, scale):
    m = re.shape[-1]
    ab = torch.from_numpy(tb.crfft_table(2 * m, scale).copy())
    return rc.rows_c2r(torch.from_numpy(re), torch.from_numpy(im),
                       core_tab(m, True), ab).numpy()


def numpy_r2c(x, packed):
    """complex128 rfft of the rows in the kernel's layout: numpy (M + 1
    lanes), or packed (M lanes, lane 0 = X[0] + i X[M])."""
    w = np.fft.rfft(x.astype(np.float64), axis=-1)
    if not packed:
        return w
    m = x.shape[-1] // 2
    p = w[..., :m].copy()
    p[..., 0] = w[..., 0].real + 1j * w[..., m].real
    return p


# ---- the addresses ----------------------------------------------------------

@pytest.mark.parametrize("m", ROWS)
def test_r2c_stage_geometry(m):
    """The output stage holds a numpy row (M + 1 lanes) a row, rows sharing
    a warp P banks apart; stage and exchange planes fit three blocks an
    SM (228 KB, 1 KB a block reserved)."""
    g = rc.geometry(m)
    sp = rc.stage_pitch(m)
    assert m + 1 <= sp < m + 33
    if g["P"] < 32:
        assert sp % 32 == g["P"]
    smem = max(g["SMEM"], 2 * g["ROWS"] * sp * 4)
    assert 3 * (smem + 1024) <= 228 << 10


@pytest.mark.parametrize("m", ROWS)
def test_r2c_addresses_are_the_row_map(m):
    """V's natural-order put and the untangle's pair reads go through the
    mixed rows' map (``row_at``: the swizzle XOR the row mask, not the
    power-of-two pad): the put writes each element of each row once; the
    reads take V[k] for k < M/2, V[M - k] for 0 < k < M/2 and thread 0
    V[M/2], each element of each row once."""
    geo = rc.geometry(m)
    p, v = geo["P"], geo["V"]
    ad = rc.r2c_mix_addrs(m)
    tid = torch.arange(rc.THREADS)
    g, t = tid // p, tid % p
    e = t[:, None] + p * torch.arange(v)[None, :]
    assert torch.equal(ad["put"], rc.row_at(m, e, g[:, None]))
    assert torch.equal(ad["k"], e[:, :v // 2])
    k = ad["k"]
    assert torch.equal(ad["lo"], rc.row_at(m, k, g[:, None]))
    live = k > 0
    assert torch.equal(ad["hi"][live],
                       rc.row_at(m, m - k, g[:, None].expand_as(k))[live])
    assert torch.equal(ad["mid"], rc.row_at(m, m // 2, g))
    reads = torch.cat([ad["lo"].reshape(-1), ad["hi"][live],
                       ad["mid"][t == 0]])
    slots = rc.row_at(m, torch.arange(m)[None, :],
                      torch.arange(geo["ROWS"])[:, None])
    assert sorted(reads.tolist()) == sorted(slots.reshape(-1).tolist())
    assert sorted(ad["put"].reshape(-1).tolist()) == \
        sorted(slots.reshape(-1).tolist())


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", ROWS)
def test_r2c_stage_writes_are_one_to_one(m, packed):
    """The stage takes lane k and lane M - k of each pair (the packed
    layout: no lane M) and thread 0's lane M/2: each of a row's M + 1 (or
    M) lanes once, at g stage_pitch + lane."""
    geo = rc.geometry(m)
    ad = rc.r2c_mix_addrs(m)
    t = torch.arange(rc.THREADS) % geo["P"]
    g = torch.arange(rc.THREADS) // geo["P"]
    hi = ad["st_hi"][ad["k"] > 0] if packed else ad["st_hi"].reshape(-1)
    got = torch.cat([ad["st_lo"].reshape(-1), hi,
                     (g * rc.stage_pitch(m) + m // 2)[t == 0]])
    lanes = m if packed else m + 1
    want = (torch.arange(geo["ROWS"])[:, None] * rc.stage_pitch(m)
            + torch.arange(lanes)[None, :])
    assert sorted(got.tolist()) == sorted(want.reshape(-1).tolist())


@pytest.mark.parametrize("m", ROWS)
def test_c2r_loads_are_one_to_one(m):
    """Each thread loads element e of its row and the re-tangle's partner
    e ? M - e : 0 (not the power of two's (M - e) & (M - 1)): over a row's
    threads each lane once as e and once as the partner."""
    geo = rc.geometry(m)
    e, pe = rc.c2r_mix_loads(m)
    g = torch.arange(rc.THREADS) // geo["P"]
    for row in range(geo["ROWS"]):
        assert sorted(e[g == row].reshape(-1).tolist()) == list(range(m))
        assert sorted(pe[g == row].reshape(-1).tolist()) == list(range(m))
    assert torch.equal(pe, (m - e) % m)


@pytest.mark.parametrize("m", ROWS)
def test_r2c_bank_ways(m):
    """The core's exchanges take one wavefront (``bank_ways``); so do V's
    put, the V[k] reads, the stage writes and thread 0's V[M/2]. The V[M - k]
    reads take two from P = 8: a warp's run of M - k crosses an aligned
    run of 32 slots, whose swizzle differs (one at P = 4, whose runs stay
    within one). The copy out of the stage takes two where a warp's 32
    floats cross a row whose pitch is not its lanes mod 32."""
    assert max(rc.bank_ways(m).values()) == 1
    ways = rc.r2c_mix_ways(m)
    p = rc.geometry(m)["P"]
    for name in ("put", "lo", "st_lo", "st_hi", "mid"):
        assert ways[name] == 1, name
    assert ways["hi"] == (1 if p == 4 else 2)
    assert ways["copy numpy"] == 2
    assert ways["copy packed"] == (2 if p == 4 else 1)


# ---- the replays against numpy ----------------------------------------------

@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", ROWS)
def test_rfft_mix_replay_matches_numpy(m, packed):
    """A ragged batch (one block and three rows more), scaled."""
    rows = rc.geometry(m)["ROWS"] + 3
    x = real_rows((rows, 2 * m), m + packed)
    got = rfft_replay(x, 0.375, packed)
    want = 0.375 * numpy_r2c(x, packed)
    assert got.shape == want.shape
    assert max_rel(got, want) < TOL


@pytest.mark.parametrize("m", ROWS)
def test_c2r_mix_replay_matches_numpy(m):
    """A ragged batch, the scale 0.25 / M folded into the re-tangle."""
    rows = rc.geometry(m)["ROWS"] + 3
    x, re, im = packed_spectrum((rows,), 2 * m, seed=m)
    got = c2r_replay(re, im, 0.25 / m)
    assert got.shape == x.shape
    assert max_rel(got, 0.25 * x) < TOL


@pytest.mark.parametrize("m", [48, 320, 3072])
def test_plain_versions_agree_with_the_mixed_rows(m):
    """The wrappers' plain versions (the dense core's arithmetic) and the
    replays of the kernels they launch at these M."""
    x = real_rows((7, 2 * m), m)
    for packed in (False, True):
        pr, pi = ff.rfft_last_planar(torch.from_numpy(x), packed=packed,
                                     scale=0.5)
        assert max_rel(cplx(pr, pi), rfft_replay(x, 0.5, packed)) < TOL
    _, re, im = packed_spectrum((7,), 2 * m, seed=m)
    out = ff.icrfft_last_planar(torch.from_numpy(re), torch.from_numpy(im))
    assert max_rel(out.numpy(), c2r_replay(re, im, 1.0 / m)) < TOL


# ---- routing ----------------------------------------------------------------

@pytest.mark.parametrize("m", [*ROWS, 16, 4096, 72, 144, 360, 6144])
def test_real_rows_predicate(m):
    """``_reg_real_rows``: the powers of two in [16, 4096] and the mixed
    row lengths; 72, 144, 360 (factors 3^2, 15) and 6144 stay dense.
    ``_reg_core`` keeps the four-step pair's powers of two alone."""
    pow2 = m & (m - 1) == 0 and 16 <= m <= 4096
    assert ff._reg_real_rows(m) is (pow2 or m in ff._MIX_ROW_LENGTHS)
    assert ff._reg_core(m) is pow2


@pytest.mark.parametrize("m", [*ROWS, 72, 256])
def test_real_wrappers_route_the_mixed_rows(monkeypatch, m):
    """Both layouts of ``rfft_last_planar`` and ``icrfft_last_planar``
    pass reg = 1 and no rows a block at the mixed M (and 256), reg = 0
    and a tile at M = 72; ``reg_launches`` counts the register ones."""
    calls = _launches(monkeypatch)
    ff.reset_counts()
    for packed in (False, True):
        ff.rfft_last_planar.impl("kernel", torch.zeros((3, 2 * m)),
                                 packed=packed)
    x = torch.zeros((3, m))
    ff.icrfft_last_planar.impl("kernel", x, x)
    reg = int(m != 72)
    assert [entry for entry, _ in calls] == ["offt_rfft_last"] * 2 + [
        "offt_icrfft_last"]
    for entry, args in calls[:2]:
        assert args[-1] == reg and (args[-4] == 0) == bool(reg)
    assert calls[2][1][-1] == reg and (calls[2][1][-2] == 0) == bool(reg)
    assert ff.rfft_last_planar.reg_launches == 2 * reg
    assert ff.icrfft_last_planar.reg_launches == reg
