"""The single-device axis-by-axis route through offt_tpu_torch.plan held
against offt_tpu.plan: long 1-D c2c by the four-step kernels (real plans
off the packed fast path are tests/test_torch_local_real.py, which shares
these helpers).

Both packages get the same inputs (numpy seeds) and the same
``PlanParams``; the reference runs its Pallas kernels in interpret mode.
The routes are held against each other too: each package's kernel
wrapper calls are counted and must agree. Tolerances: 1e-5 relative
against the reference (f32 on both sides), 1e-6 against complex128
numpy. c2r inputs are spectra of real data (Hermitian-consistent)."""

import numpy as np
import pytest
import torch

import offt_tpu
import offt_tpu_torch as ot
from offt_tpu.kernels import fourstep as rfs
from offt_tpu.kernels import pallas_fft as pf
from offt_tpu.plan.params import PlanParams as RefParams
from offt_tpu_torch.kernels import fused_fft as ff
from offt_tpu_torch.plan.params import PlanParams

TOL_REF = 1e-5
TOL_NP = 1e-6
ROUTED = {pf: ("fft_last", "fft_sublane", "_sublane_nd", "fft_slab_yz",
               "fft_x_from_padded", "fft_x_to_padded", "rfft_slab_yz",
               "irfft_slab_yz", "_assemble_mp1", "rfft_last_planar"),
          rfs: ("_step1_twiddle", "_step3_transposed")}


def rel_err(a, b):
    return np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel())


def _norm_factor(norm, inverse, total):
    if norm == "ortho":
        return total ** 0.5 if inverse else total ** -0.5
    if norm == "forward":
        return float(total) if inverse else 1.0 / total
    return 1.0


@pytest.fixture
def ref_routes(monkeypatch):
    """Counts the reference's kernel-wrapper calls while it runs."""
    calls = {}
    for mod, names in ROUTED.items():
        for name in names:
            calls[name] = 0
            orig = getattr(mod, name)

            def counted(*a, _orig=orig, _name=name, **k):
                calls[_name] += 1
                return _orig(*a, **k)
            monkeypatch.setattr(mod, name, counted)
    return calls


def _check_routes(routes):
    """Every port wrapper ran its plain version as often as the reference
    called its kernel (a reference fft_sublane that hands over to
    _sublane_nd is one kernel call), and nothing launched."""
    want = dict(routes)
    want["fft_sublane"] -= want["_sublane_nd"]
    assert all(v[0] == 0 for v in ff.counts().values())
    got = {k: v[1] for k, v in ff.counts().items() if v[1]}
    assert got == {k: v for k, v in want.items() if v}, (got, routes)


def _both(shape, kw, split=None):
    """(reference plan, port plan) with the same parameters."""
    p = {"use_pallas": 1, "precision": "highest", "split_1d": split}
    bd = kw.get("batch_dims", 0)
    rp = offt_tpu.plan(shape[bd:], "complex64", use_cache=False,
                       params=RefParams(**p), **kw)
    pp = ot.plan(shape[bd:], "float32" if kw.get("real") else "complex64",
                 device="cpu", params=PlanParams(**p), **kw)
    assert pp.route == "local"
    return rp, pp


def _c2c(shape, inverse, routes, planar=True, norm=None, split=None):
    bd = len(shape) - 3
    rng = np.random.default_rng(sum(shape) + inverse)
    x = (rng.standard_normal(shape)
         + 1j * rng.standard_normal(shape)).astype(np.complex64)
    rp, pp = _both(shape, {"inverse": inverse, "planar": planar,
                           "norm": norm, "batch_dims": bd}, split)
    ff.reset_counts()
    if planar:
        ref = rp((x.real.copy(), x.imag.copy()))
        ref = np.asarray(ref[0]) + 1j * np.asarray(ref[1])
        yr, yi = pp((torch.from_numpy(x.real.copy()),
                     torch.from_numpy(x.imag.copy())))
        got = yr.numpy() + 1j * yi.numpy().astype(np.float64)
    else:
        ref = np.asarray(rp(x))
        y = pp(torch.from_numpy(x))
        assert y.dtype == torch.complex64
        got = y.numpy().astype(np.complex128)
    _check_routes(routes)
    f = np.fft.ifft if inverse else np.fft.fft
    want = f(x.astype(np.complex128), axis=-1, norm=norm)
    assert got.shape == shape
    assert rel_err(got, ref) < TOL_REF
    assert rel_err(got, want) < TOL_NP


# ---- long 1-D c2c: (1, 1, N) past the 2-stage ceiling ---------------------

@pytest.mark.parametrize("norm", [None, "ortho", "forward"])
@pytest.mark.parametrize("inverse", [False, True])
def test_long_1d_plan_norms(norm, inverse, ref_routes):
    _c2c((1, 1, 2 ** 15), inverse, ref_routes, norm=norm)


@pytest.mark.parametrize("inverse", [False, True])
def test_long_1d_plan_batched(inverse, ref_routes):
    _c2c((3, 1, 1, 2 ** 15), inverse, ref_routes)


@pytest.mark.parametrize("split", [(256, 128), (192, 128)])
def test_long_1d_plan_explicit_split(split, ref_routes):
    n = split[0] * split[1]
    _c2c((1, 1, n), False, ref_routes, split=split)


@pytest.mark.parametrize("inverse", [False, True])
def test_long_1d_plan_complex_boundary(inverse, ref_routes):
    _c2c((1, 1, 20480), inverse, ref_routes, planar=False, norm="ortho")


# ---- plan-level behaviour ----------------------------------------------------

def test_local_plan_tables_and_meta_dry_run():
    p = ot.plan((1, 1, 2 ** 15), "complex64", planar=True, device="cpu")
    tabs = [k for k in dict(p.named_buffers()) if k.startswith("table")]
    assert len(tabs) == 3      # the two cores and the four-step twiddle
    q = ot.plan((4, 6, 96), "float32", real=True, device="cpu",
                inverse=True)
    assert q.route == "local" and q.in_shape == (4, 6, 49)
    ff.reset_counts()
    out = q(torch.zeros(4, 6, 49, dtype=torch.complex64))
    assert out.shape == (4, 6, 96) and not out.abs().max()
    with pytest.raises(TypeError):
        q(torch.zeros(4, 6, 49))
    with pytest.raises(ValueError):     # in_place needs the fused c2c
        ot.plan((1, 1, 2 ** 15), "complex64", planar=True, in_place=True,
                device="cpu")
    # a prime past the ceiling takes Bluestein; the four-step route is
    # z-only, so a long x takes the unfused engine
    # (tests/test_torch_stockham.py holds both against the reference)
    assert ot.plan((1, 1, 16411), "complex64", device="cpu").route == "local"
    assert ot.plan((2 ** 15, 1, 1), "complex64", device="cpu").route == \
        "local"


def test_plan_without_a_device_is_on_the_card():
    # no CPU fallback: off the card a plan needs device="cpu"
    if torch.cuda.is_available():
        assert ot.plan((8, 8, 8), "complex64").device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ot.plan((8, 8, 8), "complex64")
        with pytest.raises(RuntimeError):
            ot.plan((1, 1, 2 ** 15), "float32", real=True, device="cuda")


@pytest.mark.parametrize("kw", [{"split_1d": (128, 256)},
                                {"split_1d": (100, 327)},
                                {"split_1d": (128, 128)}])
@pytest.mark.parametrize("shape,real", [((1, 1, 2 ** 15), False),
                                        ((2, 1, 2 ** 15), False),
                                        ((1, 1, 2 ** 15), True)])
def test_split_feasibility_matches_reference(kw, shape, real):
    from offt_tpu.plan import params as ref_params
    from offt_tpu_torch.plan import params
    mine = params.infeasible_reason(
        params.ProblemSpec(shape=shape, real=real),
        params.PlanParams(use_pallas=1, **kw))
    theirs = ref_params.infeasible_reason(
        ref_params.ProblemSpec(shape=shape, real=real),
        ref_params.PlanParams(use_pallas=1, **kw))
    assert mine == theirs


@pytest.mark.parametrize("shape,real,want", [
    ((1, 1, 2 ** 20), False, 1), ((1, 1, 2 ** 21), True, 1),
    ((8, 8, 2 ** 15), False, 1), ((1, 1, 16411), False, 1),
    ((1, 1, 16411), True, 1), ((131, 1, 2 ** 15), False, 0)])
def test_default_params_take_the_four_step_clause(shape, real, want):
    from offt_tpu_torch.plan import params
    d = params.default_params(params.ProblemSpec(shape=shape, real=real))
    assert d.use_pallas == want
