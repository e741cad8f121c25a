"""The packed r2c/c2r plans of offt_tpu_torch under every norm, held
against offt_tpu.plan (which post-multiplies the norm scale, where the
port folds it into the x pass's and the re-tangle's tables) and numpy.
Shares its helpers with tests/test_torch_real_plan.py."""

import numpy as np
import pytest
import torch

import offt_tpu_torch as ot
from offt_tpu_torch.kernels import fused_fft as ff

from test_torch_real_plan import (TOL_NP, TOL_REF, _run_both, ref_routes,
                                  rel_err)

__all__ = ["ref_routes"]


# backward is the default of tests/test_torch_real_plan.py
@pytest.mark.parametrize("norm", ["ortho", "forward"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("inverse", [False, True])
def test_real_plan_norms(norm, packed, inverse, ref_routes):
    got, ref, want = _run_both((8, 16, 256), inverse, packed, norm,
                               ref_routes)
    assert rel_err(got, ref) < TOL_REF
    assert rel_err(got, want) < TOL_NP


@pytest.mark.parametrize("norm", ["backward", "ortho", "forward"])
@pytest.mark.parametrize("packed", [False, True])
def test_real_round_trip(norm, packed):
    shape = (2, 8, 16, 256)
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    kw = {"real": True, "planar": True, "packed": packed, "norm": norm,
          "batch_dims": 1, "device": "cpu"}
    fwd = ot.plan(shape[1:], "float32", **kw)
    inv = ot.plan(shape[1:], "float32", inverse=True, **kw)
    back = inv(fwd(torch.from_numpy(x)))
    assert back.dtype == torch.float32 and back.shape == shape
    assert rel_err(back.numpy(), x) < TOL_NP


def test_real_plan_is_a_module_with_table_buffers():
    p = ot.plan((8, 16, 256), "float32", real=True, planar=True,
                device="cpu")
    q = ot.plan((8, 16, 256), torch.float32, real=True, planar=True,
                inverse=True, device="cpu")
    assert isinstance(p, torch.nn.Module) and p.spec.dtype == "complex64"
    # z (M-point), y and x cores plus the untangle twiddles; the inverse
    # shares one x table between the side path and the x pass
    tabs = [k for k in dict(p.named_buffers()) if k.startswith("table")]
    assert len(tabs) == 4
    tabs = [k for k in dict(q.named_buffers()) if k.startswith("table")]
    assert len(tabs) == 4
    assert q.in_shape == (8, 16, 129)
    with pytest.raises(ValueError):
        p(torch.zeros(8, 16, 128))
    with pytest.raises(TypeError):
        p(torch.zeros(8, 16, 256), torch.zeros(8, 16, 256))
    with pytest.raises(ValueError):
        q((torch.zeros(8, 16, 128), torch.zeros(8, 16, 128)))
    ff.reset_counts()
    out = q(torch.zeros(8, 16, 129), torch.zeros(8, 16, 129))
    assert out.shape == (8, 16, 256) and not out.abs().max()
