"""The real rows at the mixed half lengths (``csrc/real_rows_mix.cu``)
against the reference: :func:`regcore.rfft_rows` and
:func:`regcore.rows_c2r`, which replay ``regs::rows_r2c_mix`` and
``rows_c2r_mix`` block by block at every M of
``fused_fft._MIX_ROW_LENGTHS`` (``test_torch_regmixreal.py``), against
``pallas_fft.rfft_last_planar`` (both layouts) and
``icrfft_last_planar`` in interpret mode, on inputs made by numpy from a
seed. Tolerance: 1e-5 relative, as ``test_torch_rfft_last.py`` states it
(f32 on both sides, sums in other orders)."""

import numpy as np
import pytest

from offt_tpu.kernels import pallas_fft as pf
from test_torch_regmixed import packed_spectrum
from test_torch_regmixreal import ROWS, c2r_replay, real_rows, rfft_replay
from test_torch_regmixrows import cplx
from test_torch_rfft_last import TOL_REF, rel_err

# the reference's radices where its own pick, (32, 20) at 640 and
# (32, 24) at 768, takes about ten seconds a call in interpret mode; the
# radices do not change the function it computes
REF_RADICES = {640: (16, 40), 768: (16, 48)}


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("m", ROWS)
def test_rfft_mix_replay_matches_reference(m, packed):
    x = real_rows((2, 3, 2 * m), 3 * m + packed)
    ref = pf.rfft_last_planar(x, radices=REF_RADICES.get(m),
                              packed=packed)
    got = rfft_replay(x, 1.0, packed)
    assert got.shape == np.shape(ref[0])
    assert rel_err(got, cplx(*ref)) < TOL_REF


@pytest.mark.parametrize("m", ROWS)
def test_c2r_mix_replay_matches_reference(m):
    x, re, im = packed_spectrum((5,), 2 * m, seed=5 * m)
    ref = np.asarray(pf.icrfft_last_planar(
        re, im, 2 * m, radices=REF_RADICES.get(m), scale=0.5 / m))
    got = c2r_replay(re, im, 0.5 / m)
    assert got.shape == ref.shape
    assert rel_err(got, ref) < TOL_REF
