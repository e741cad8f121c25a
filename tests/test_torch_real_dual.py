"""The packed r2c/c2r plans of offt_tpu_torch at M = Nz/2 = 256, held
against offt_tpu.plan and numpy. Past M = 128 the reference untangles
with its dual-transform route (a second half-length transform) instead of
a dense matrix; the port's one diagonal untangle must match both. Shares
its helpers with tests/test_torch_real_plan.py."""

import pytest

from test_torch_real_plan import (TOL_NP, TOL_REF, _run_both, ref_routes,
                                  rel_err)

__all__ = ["ref_routes"]


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
def test_real_plan_dual_regime(packed, inverse, ref_routes):
    got, ref, want = _run_both((4, 8, 512), inverse, packed, None,
                               ref_routes)
    assert rel_err(got, ref) < TOL_REF
    assert rel_err(got, want) < TOL_NP
