"""The rest of offt_tpu_torch.plan held against offt_tpu.plan, case by
case after tests/test_plan.py: ``pow2_grid``, ``w_from_reference`` and
``is_feasible`` (plan/params.py), the layered config and its
``snapshot`` (utils/config.py), the wisdom files and the cache's command
line (plan/cache.py), and the 3-D real one-shots ``rfft3d`` /
``irfft3d``."""

import json

import numpy as np
import pytest
import torch

import offt_tpu
import offt_tpu_torch as ot
from offt_tpu.plan import cache as ref_cache
from offt_tpu.plan import params as ref_params
from offt_tpu_torch.plan import cache
from offt_tpu_torch.plan.params import (PlanParams, ProblemSpec,
                                        default_params, infeasible_reason,
                                        is_feasible, p1_candidates,
                                        pow2_grid, w_from_reference)


@pytest.mark.parametrize("lo,hi,zero", [(1, 16, False), (1, 10, False),
                                        (1, 4, True), (3, 40, True),
                                        (0, 1, False)])
def test_pow2_grid(lo, hi, zero):
    assert pow2_grid(lo, hi, include_zero=zero) == \
        ref_params.pow2_grid(lo, hi, include_zero=zero)
    assert pow2_grid(1, 16) == [1, 2, 4, 8, 16]
    assert pow2_grid(1, 10) == [1, 2, 4, 8, 10]
    assert 0 in pow2_grid(1, 4, include_zero=True)


def test_w_from_reference_mapping():
    # the reference's W (exchanges issued ahead; 0 = blocking) against
    # the w knob (a cap on the chunk exchanges in flight; 0 = no cap)
    assert w_from_reference(0) == 1
    assert w_from_reference(2) == 3
    assert w_from_reference(0, unbounded=True) == 0
    for w in range(5):
        assert w_from_reference(w) == ref_params.w_from_reference(w)
    with pytest.raises(ValueError):
        w_from_reference(-1)
    spec = ProblemSpec(shape=(64, 64, 64), p=8)
    p = default_params(spec).replace(t1=4, w1=w_from_reference(2))
    assert infeasible_reason(spec, p) is None and is_feasible(spec, p)
    assert not is_feasible(spec, p.replace(p1=3))


def test_plan_exports_what_the_reference_exports():
    import importlib
    # the packages' ``plan`` attribute is the function: import the modules
    ref_plan_pkg = importlib.import_module("offt_tpu.plan")
    plan_pkg = importlib.import_module("offt_tpu_torch.plan")
    assert set(ref_plan_pkg.__all__) <= set(plan_pkg.__all__)
    import offt_tpu_torch
    for name in ("fft2d", "ifft2d", "rfft2d", "irfft2d", "rfft3d",
                 "irfft3d", "fft3d", "ifft3d", "plan", "Plan"):
        assert name in offt_tpu_torch.__all__
        assert name in offt_tpu.__all__
    assert plan_pkg.p1_candidates is p1_candidates
    assert p1_candidates(64, 64, 64, 8) == ref_params.p1_candidates(
        64, 64, 64, 8)


def test_config_layers(tmp_path, monkeypatch):
    """tests/test_plan.py's case on the port's keys (the plan's and the
    tuner's): file beats default, env beats file, a keyword beats env, an
    int default coerces its env value; and ``snapshot`` resolves every
    key of the reference's as the reference's does."""
    from offt_tpu_torch.utils import config

    cfg = tmp_path / "config.json"
    cfg.write_text('{"precision": "high", "use_pallas": 0}')
    monkeypatch.setenv("OFFT_TPU_TORCH_CONFIG", str(cfg))
    monkeypatch.delenv("OFFT_TPU_TORCH_CACHE_DIR", raising=False)
    assert config.get("precision") == "high"         # file beats default
    assert config.get("use_pallas") == 0
    monkeypatch.setenv("OFFT_TPU_TORCH_PRECISION", "highest")
    assert config.get("precision") == "highest"      # env beats file
    assert config.get("precision", precision="default") == "default"
    assert config.get("cache_dir") == ""             # default
    monkeypatch.setenv("OFFT_TPU_TORCH_USE_PALLAS", "1")
    assert config.get("use_pallas") == 1             # int coercion
    snap = config.snapshot()
    assert snap == {"precision": "highest", "use_pallas": 1, "cache_dir": "",
                    "strategy": "nm", "max_trials": 30, "simplex_size": 0,
                    "prefetch_count": 4, "server_host": "127.0.0.1",
                    "server_port": 1979}
    from offt_tpu.utils import config as ref_config
    assert set(snap) == set(ref_config.DEFAULTS)
    monkeypatch.setenv("OFFT_TPU_CONFIG", str(cfg))
    monkeypatch.delenv("OFFT_TPU_CACHE_DIR", raising=False)
    monkeypatch.setenv("OFFT_TPU_PRECISION", "highest")
    monkeypatch.setenv("OFFT_TPU_USE_PALLAS", "1")
    ref = ref_config.snapshot()
    assert {k: ref[k] for k in snap} == snap


def test_wisdom_export_import(tmp_path, monkeypatch, capsys):
    """Export the local cache, import it into a fresh cache directory, the
    better measured time winning per key; and the command line."""
    monkeypatch.setenv("OFFT_TPU_TORCH_CACHE_DIR", str(tmp_path / "a"))
    key = cache.plan_key((64, 64, 64), "complex64", False, 1, 1, "cpu")
    cache.store(key, PlanParams(ry=7), perf=2e-3)
    wf = tmp_path / "wisdom.json"
    assert cache.export_wisdom(wf) == 1
    assert set(json.loads(wf.read_text())) == {key}

    monkeypatch.setenv("OFFT_TPU_TORCH_CACHE_DIR", str(tmp_path / "b"))
    assert cache.lookup(key) is None
    assert cache.import_wisdom(wf) == 1
    assert cache.lookup(key).ry == 7
    cache.store(key, PlanParams(ry=9), perf=1e-3)
    assert cache.import_wisdom(wf) == 0     # 2e-3 must not overwrite 1e-3
    assert cache.lookup(key).ry == 9
    cache.main(["list"])
    out = capsys.readouterr().out
    assert key in out and "1.000 ms" in out
    assert cache.main(["export", str(tmp_path / "w2.json")]) == 0
    cache.main(["clear"])
    assert cache.lookup(key) is None
    cache.main(["import", str(tmp_path / "w2.json")])
    assert cache.lookup(key).ry == 9
    cache.clear()
    cache.clear()                            # no file: nothing to do


def test_reference_wisdom_imports_and_never_matches(tmp_path, monkeypatch):
    """A wisdom file the reference exports (its keys name TPU kinds)
    imports as it is, and no plan on the host or a card finds it."""
    monkeypatch.setenv("OFFT_TPU_CACHE_DIR", str(tmp_path / "ref"))
    rkey = ref_cache.plan_key((16, 16, 16), "complex64", False, 1, 1,
                              "TPU v5 lite")
    ref_cache.store(rkey, ref_params.PlanParams(radix_z=(4, 4), ry=3),
                    perf=1e-4)
    wf = tmp_path / "tpu_wisdom.json"
    assert ref_cache.export_wisdom(wf) == 1
    monkeypatch.setenv("OFFT_TPU_TORCH_CACHE_DIR", str(tmp_path / "port"))
    assert cache.import_wisdom(wf) == 1
    got = cache.lookup(rkey)
    assert got.radix_z == (4, 4) and got.ry == 3
    p = ot.plan((16, 16, 16), "complex64", device="cpu")
    assert p.params.ry != 3
    assert cache.plan_key((16, 16, 16), "complex64", False, 1, 1,
                          cache.device_kind("cpu")) != rkey
    with open(wf) as fh:        # an entry that does not parse is skipped
        db = json.load(fh)
    db["bad"] = {"perf": 1.0}
    wf.write_text(json.dumps(db))
    assert cache.import_wisdom(wf) == 0


# ---- the 3-D real one-shots -----------------------------------------------

@pytest.mark.parametrize("shape", [(8, 8, 16), (2, 8, 8, 16), (4, 6, 10)])
def test_rfft3d_irfft3d_one_shots(shape, monkeypatch):
    from offt_tpu_torch.plan import api
    monkeypatch.setattr(api, "_ONE_SHOT", type(api._ONE_SHOT)())
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(
        np.float32)
    y = ot.rfft3d(torch.from_numpy(x))
    ref = np.asarray(offt_tpu.rfft3d(x))
    want = np.fft.rfftn(x.astype(np.float64), axes=(-3, -2, -1))
    assert y.dtype == torch.complex64 and y.shape == want.shape
    assert np.linalg.norm(y.numpy() - want) / np.linalg.norm(want) < 1e-6
    assert np.linalg.norm(y.numpy() - ref) / np.linalg.norm(ref) < 1e-5
    back = ot.irfft3d(y)
    assert back.shape == x.shape and back.dtype == torch.float32
    assert np.linalg.norm(back.numpy() - x) / np.linalg.norm(x) < 1e-6
    rb = np.asarray(offt_tpu.irfft3d(np.asarray(y.numpy())))
    assert np.linalg.norm(back.numpy() - rb) / np.linalg.norm(rb) < 1e-5
    assert len(api._ONE_SHOT) == 2
    ot.rfft3d(torch.from_numpy(x))
    assert len(api._ONE_SHOT) == 2          # cached per signature
    # an odd length needs nz (the default is 2 * (L - 1))
    xo = x[..., :7].copy()
    yo = ot.rfft3d(torch.from_numpy(xo))
    bo = ot.irfft3d(yo, nz=7)
    assert np.linalg.norm(bo.numpy() - xo) / np.linalg.norm(xo) < 1e-6
