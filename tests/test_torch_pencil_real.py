"""offt_tpu_torch's distributed r2c / c2r pencil engine held against
offt_tpu's.

As tests/test_torch_pencil.py, on one spawned gloo world of 4 CPU ranks:
each case's gathered output against offt_tpu on a mesh of the same shape
(Pallas kernels in interpret mode, the port's resolved parameters) and
against numpy complex128 (r2c: ``rfftn``, in the packed layout with lane
0 = X[0] + i X[M]; c2r: the real data whose spectrum is the input), all
within 1e-6 relative norm. The packed c2r cases run the
``icrfft_last_planar`` kernel's plain version as the last z stage at
M = 16 and 64 (the reference's dense G re-tangle) and M = 256 (its dual
transform); the numpy-layout cases run ``rfft_last_planar`` /
``rfft.irfft_1d``, odd Nz included. Meshes (2, 2), (1, 4), (4, 1) and a
(2, 1, 2) multi-slice one; every knob; uneven shapes; batch dims;
``batch_sharded``; norms."""

import numpy as np
import pytest

import torch_world as tw

C = tw.case
R = dict(real=True)
P = dict(real=True, packed=True)
CASES = [
    C(shape=(8, 8, 32), **P),
    C(shape=(8, 8, 32), inverse=True, **P),
    C(mesh=(1, 4), shape=(10, 12, 32), knobs=dict(t1=2, t2=2, ry=5), **P),
    C(mesh=(4, 1), shape=(10, 12, 32), inverse=True,
      knobs=dict(s1=1, s2=1, t1=2, w1=1), **P),
    C(shape=(4, 4, 512), inverse=True, knobs=dict(v=3, t1=2, t2=2), **P),
    C(shape=(8, 8, 128), inverse=True, norm="ortho",
      knobs=dict(rankorder=2, ry=0), **P),
    C(batch=(2,), shape=(8, 8, 32), inverse=True,
      knobs=dict(t1=2, t2=2, w1=1, w2=1), **P),
    C(knobs=dict(v=1, t1=2, t2=2, w2=1), **R),
    C(inverse=True, knobs=dict(t1=2, t2=2, ry=5, s2=1), **R),
    C(mesh=(1, 4), shape=(10, 12, 15), norm="forward", **R),
    C(mesh=(4, 1), shape=(10, 12, 15), inverse=True, knobs=dict(v=2), **R),
    C(batch=(4,), batch_sharded=True, **R),
    C(batch=(4,), batch_sharded=True, inverse=True, **R),
    C(mesh=(2, 1, 2), batch=(4,), shape=(8, 8, 32), **P),
    C(mesh=(2, 1, 2), batch=(4,), shape=(8, 8, 32), inverse=True, **P),
]


def _worker(rank, outdir):
    tw.run_cases(rank, outdir, CASES)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("pencil_real")
    tw.spawn(_worker, out)
    return out


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[tw.case_id(c) for c in CASES])
def test_real_pencil_matches_reference(world, i):
    c = CASES[i]
    got, params, ran = tw.gather(world, i, c)
    assert got.dtype == (np.float32 if c["inverse"] else np.complex64)
    ref = tw.reference(c, tw.inputs(c, i), params)
    want = tw.truth(c, i)
    assert got.shape == ref.shape == want.shape == tw.out_shape(c)
    assert tw.rel_err(got, ref) < 1e-6
    assert tw.rel_err(got, want) < 1e-6
    assert tw.rel_err(ref, want) < 1e-6
    # the z stage's kernel (its plain version on the CPU)
    if c["batch_sharded"]:
        assert "icrfft_last_planar" not in ran
    elif c["packed"]:
        assert params["use_pallas"] == 1
        assert ("icrfft_last_planar" if c["inverse"]
                else "rfft_last_planar") in ran
    elif not c["inverse"] and c["shape"][2] % 2 == 0:
        assert "rfft_last_planar" in ran
