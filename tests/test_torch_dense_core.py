"""``bench/dense_core.py`` on the CPU, where every wrapper runs its plain
version: the cases at small shapes go through the dense-core patch and
read no error, and the patch restores the register-core predicates."""

import pytest

from offt_tpu_torch.bench import dense_core as dc
from offt_tpu_torch.kernels import fused_fft as ff

SMALL = {"fft_cube": (1, 8, 8, 128), "fft_cube inverse": (1, 4, 8, 128),
         "fft_slab": (4, 32, 32), "fft_axis": (16, 8, 8),
         "rfft_last": (5, 192), "icrfft_last": (5, 96),
         "step1_twiddle": (1, 64, 64), "step3_transposed": (1, 64, 64)}


@pytest.mark.parametrize("case", dc.CASES, ids=lambda c: c[0] + "-"
                         + "x".join(map(str, c[3])))
def test_case_runs_on_the_cpu(case):
    name, fn, call, _, planes = case
    rows = dc.run("cpu", cases=[(name, fn, call, SMALL[name], planes)],
                  draws=2)
    assert rows[0]["ms"] is None
    assert rows[0]["errs"] == [0.0, 0.0]


def test_dense_core_restores_the_predicates():
    keep = {k: getattr(ff, k) for k in dc.REG_PREDICATES}
    with dc.dense_core():
        assert not any(getattr(ff, k)(256) for k in dc.REG_PREDICATES
                       if k not in ("_reg_slab", "_reg_rslab", "_reg_cube"))
    assert all(getattr(ff, k) is f for k, f in keep.items())
