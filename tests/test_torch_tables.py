"""offt_tpu_torch's tables, radix picks, parameters, cache and config,
held against offt_tpu's (bit for bit where both build the same values)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from offt_tpu.kernels import dft as ref_dft
from offt_tpu.kernels import pallas_fft as pf
from offt_tpu.plan import cache as ref_cache
from offt_tpu.plan import params as ref_params
from offt_tpu_torch.kernels import _build
from offt_tpu_torch.kernels import dft, fused_fft, tables
from offt_tpu_torch.plan import cache, params

SIZES = [8, 12, 16, 20, 64, 256, 320, 512]


def _radix_cases(n):
    """Explicit radices for n: valid 1/2/3-stage ones and invalid ones."""
    cands = [None, dft.factorize(n), (n,), (n, 1), (2, n // 2),
             (n // 2, 2), (2, 2, n // 4), (4, 4, 4), (2, 2, 2, n // 8),
             (n + 1,), (n, 2), (1, n), (2, 2, n // 4, 1)]
    if n % 64 == 0:
        cands.append((64, 2, n // 128) if n >= 128 else (64,))
    return cands


@pytest.mark.parametrize("n", SIZES)
def test_factorize_dft_twiddles_bit_equal(n):
    assert dft.factorize(n) == ref_dft.factorize(n)
    assert dft.factorize(n, 16) == ref_dft.factorize(n, 16)
    for dt in (np.complex64, np.complex128):
        for inv in (False, True):
            assert np.array_equal(dft.dft_matrix(n, dt, inv),
                                  ref_dft.dft_matrix(n, dt, inv))
            r1 = dft.factorize(n)[0]
            assert np.array_equal(dft.twiddles(r1, n // r1, dt, inv),
                                  ref_dft.twiddles(r1, n // r1, dt, inv))
    assert dft.MAX_RADIX == ref_dft.MAX_RADIX
    assert dft.LOOP_MAX_RADIX == ref_dft.LOOP_MAX_RADIX


@pytest.mark.parametrize("n", SIZES)
def test_pick_stages_matches_reference(n):
    for rad in _radix_cases(n):
        assert tables._pick_stages(n, rad) == pf._pick_stages(n, rad), rad
        assert tables._pick_2stage(n, rad) == pf._pick_2stage(n, rad), rad
        assert (fused_fft.can_use_pallas(n, rad)
                == pf.can_use_pallas(n, rad)), rad


def test_fold_complex_and_gates_match_reference():
    f = ref_dft.dft_matrix(12, np.complex128, True)
    assert np.array_equal(tables._fold_complex(f), pf._fold_complex(f))
    for ny, nz in [(256, 256), (768, 768), (320, 320), (32, 128),
                   (1024, 1024), (2048, 1024), (12, 20)]:
        assert (fused_fft.bank_conflict_stride(ny, nz)
                == pf.bank_conflict_stride(ny, nz))
        assert fused_fft.can_fuse_slab(ny, nz) == pf.can_fuse_slab(ny, nz)
        for n in (16, 256, 320, 2048, 131):
            assert (fused_fft.can_use_padded_x(n, ny, nz)
                    == pf.can_use_padded_x(n, ny, nz))


def _stage_matrix(tab, n, stages, s):
    """Folded f32 matrix of stage s rebuilt from the port's table."""
    off = n + sum(stages[:s])
    r = stages[s]
    w = tab[off:off + r]
    idx = (np.arange(r)[:, None] * np.arange(r)[None, :]) % r
    top = np.concatenate([w[idx, 0], -w[idx, 1]], axis=1)
    bot = np.concatenate([w[idx, 1], w[idx, 0]], axis=1)
    return np.concatenate([top, bot], axis=0)


@pytest.mark.parametrize("n,rad", [(8, (8,)), (20, (20,)), (64, (64,)),
                                   (64, (8, 8)), (12, (3, 4)), (20, (4, 5)),
                                   (256, (16, 16)), (320, (20, 16)),
                                   (512, (32, 16)), (64, (4, 4, 4))])
@pytest.mark.parametrize("inv", [False, True])
def test_core_table_bit_equal_to_reference(n, rad, inv):
    """The port's stage matrices and first twiddles carry the reference's
    f32 values bit for bit; a 1-stage table carries its folded scale."""
    scale = 0.125 if len(rad) == 1 else 1.0
    tab = tables.core_table(n, rad, inv, scale)
    assert tab.dtype == np.float32 and tab.shape == (n + sum(rad), 2)
    if len(rad) == 1:
        (g,) = pf._core_tables(n, rad, inv, scale)
        assert np.array_equal(_stage_matrix(tab, n, rad, 0), g)
        return
    r1 = rad[0]
    t = pf._tables(n, r1, inv)
    assert np.array_equal(_stage_matrix(tab, n, rad, 0), t["g1"])
    tw = tab[(np.arange(r1)[:, None] * np.arange(n // r1)[None, :])]
    assert np.array_equal(tw[..., 0], t["twr"])
    assert np.array_equal(tw[..., 1], t["twi"])
    for s in range(1, len(rad)):
        f = pf._fold_complex(ref_dft.dft_matrix(rad[s], np.complex128, inv))
        assert np.array_equal(_stage_matrix(tab, n, rad, s),
                              f.astype(np.float32))


def test_core_pos_is_a_permutation():
    for n, st in [(256, (16, 16)), (64, (4, 4, 4)), (20, (20,)), (1, (1,))]:
        pos = tables.core_pos(n, st)
        assert sorted(pos.tolist()) == list(range(n))
    assert tables.core_stages((16, 1)) == (16,)
    assert tables.core_stages((1, 1)) == (1,)
    with pytest.raises(ValueError):
        tables.core_table(64, (8, 4), False)


def _ref_point():
    return ref_params.PlanParams(
        p1=2, t1=4, t2=3, w1=0, w2=2, ry=7, s1=1, s2=0, rankorder=2, v=3,
        radix_z=(32, 16), radix_y=(4, 4, 4), radix_x=None, use_pallas=1,
        block_batch=128, slab_rows=4, x_tile=(8, 128), split_1d=(1024, 512),
        precision="stack6")


@pytest.mark.parametrize("numpy_values", [False, True])
def test_from_reference_round_trips_field_by_field(numpy_values):
    ref = _ref_point()
    d = dataclasses.asdict(ref)
    if numpy_values:
        d = {k: (np.int64(v) if isinstance(v, int) else
                 (np.asarray(v) if isinstance(v, tuple) else v))
             for k, v in d.items()}
    got = params.from_reference(d)
    assert ([f.name for f in dataclasses.fields(got)]
            == [f.name for f in dataclasses.fields(ref)])
    for f in dataclasses.fields(ref):
        mine, theirs = getattr(got, f.name), getattr(ref, f.name)
        assert mine == theirs and type(mine) is type(theirs), f.name
    back = ref_params.PlanParams(**dataclasses.asdict(got))
    assert back == ref
    assert params.from_reference(dataclasses.asdict(
        ref_params.PlanParams())) == params.PlanParams()
    with pytest.raises(TypeError):
        params.from_reference({**dataclasses.asdict(ref), "bogus": 1})


def test_problem_spec_and_defaults_mirror_reference():
    assert ([(f.name, f.default) for f in dataclasses.fields(
        params.ProblemSpec)] == [(f.name, f.default) for f in
                                 dataclasses.fields(ref_params.ProblemSpec)])
    assert ([(f.name, f.default) for f in dataclasses.fields(
        params.PlanParams)] == [(f.name, f.default) for f in
                                dataclasses.fields(ref_params.PlanParams)])
    spec = params.ProblemSpec(shape=(256, 256, 256))
    d = params.default_params(spec)
    assert d.use_pallas == 1 and d.precision == "highest" and d.p1 == 1
    assert params.default_params(
        params.ProblemSpec(shape=(131, 8, 8))).use_pallas == 0
    # the distributed point (tests/test_torch_mesh.py holds the grid)
    d4 = params.default_params(params.ProblemSpec(shape=(8, 8, 8), p=4))
    r4 = ref_params.default_params(ref_params.ProblemSpec(shape=(8, 8, 8),
                                                          p=4))
    assert d4 == params.from_reference(dataclasses.asdict(r4.replace(
        use_pallas=1)))
    assert (d4.p1, d4.t1, d4.t2, d4.w1, d4.w2) == (2, 4, 4, 0, 0)


@pytest.mark.parametrize("kw", [
    {}, {"radix_z": (16, 16)}, {"radix_z": (16, 8)},
    {"radix_x": (2, 2, 4, 16)},
    {"radix_y": (4, 64)}, {"radix_y": (2, 128)}, {"radix_y": (256,)},
    {"radix_x": (4, 4, 16)}, {"radix_x": (64, 2, 2)},
    {"precision": "high"}, {"precision": "fast"}, {"precision": "stack3"},
    {"slab_rows": 3}, {"slab_rows": 16}, {"x_tile": (8, 128)},
    {"x_tile": (7, 128)}, {"x_tile": (8, 100)}])
@pytest.mark.parametrize("use_pallas", [0, 1])
def test_infeasible_reason_agrees_with_reference(kw, use_pallas):
    spec = params.ProblemSpec(shape=(256, 256, 256))
    rspec = ref_params.ProblemSpec(shape=(256, 256, 256))
    mine = params.infeasible_reason(
        spec, params.PlanParams(use_pallas=use_pallas, **kw))
    theirs = ref_params.infeasible_reason(
        rspec, ref_params.PlanParams(use_pallas=use_pallas, **kw))
    assert (mine is None) == (theirs is None), (mine, theirs)


def test_cache_key_format_and_round_trip(tmp_path, monkeypatch):
    monkeypatch.setenv("OFFT_TPU_TORCH_CACHE_DIR", str(tmp_path))
    args = ((256, 256, 256), "complex64", False, 1, 1, "NVIDIA H100")
    assert (cache.plan_key(*args, inverse=True)
            == ref_cache.plan_key(*args, inverse=True))
    assert cache.plan_key(*args) == ref_cache.plan_key(*args)
    key = cache.plan_key(*args)
    assert cache.lookup(key) is None
    p = params.PlanParams(use_pallas=1, radix_z=(32, 8), x_tile=(8, 128))
    cache.store(key, p, perf=2.0)
    assert cache.lookup(key) == p
    cache.store(key, params.PlanParams(), perf=3.0)   # worse: kept out
    assert cache.lookup(key) == p
    rec = json.loads((tmp_path / "plan_cache.json").read_text())
    assert ref_cache._params_from_json(rec[key]["params"]) == \
        ref_params.PlanParams(use_pallas=1, radix_z=(32, 8), x_tile=(8, 128))
    # the reference's bundled TPU entries never answer for the port
    bundled = next(iter(ref_cache._bundled()))
    assert cache.lookup(bundled) is None
    assert cache.device_kind("cpu") == "cpu"


def test_config_layers(tmp_path, monkeypatch):
    from offt_tpu_torch.utils import config
    f = tmp_path / "c.json"
    f.write_text(json.dumps({"Precision": "stack6", "use_pallas": 0}))
    monkeypatch.setenv("OFFT_TPU_TORCH_CONFIG", str(f))
    monkeypatch.delenv("OFFT_TPU_TORCH_USE_PALLAS", raising=False)
    assert config.get("precision") == "stack6"
    assert config.get("use_pallas") == 0
    monkeypatch.setenv("OFFT_TPU_TORCH_USE_PALLAS", "1")
    assert config.get("use_pallas") == 1
    assert config.get("precision", precision="highest") == "highest"
    assert set(config.DEFAULTS) == {"precision", "use_pallas", "cache_dir",
                                    "strategy", "max_trials",
                                    "simplex_size", "prefetch_count",
                                    "server_host", "server_port"}


def test_import_pulls_no_jax():
    # every module of the package, and chip_smoke.py; neither JAX nor
    # the reference package may load
    code = ("import sys, pkgutil, importlib, offt_tpu_torch, chip_smoke; "
            "[importlib.import_module(m.name) for m in "
            "pkgutil.walk_packages(offt_tpu_torch.__path__, "
            "'offt_tpu_torch.')]; "
            "import offt_tpu_torch.dist.pencil; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'offt_tpu')))")
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, check=True, timeout=120)
    assert out.stdout.strip() == "[]"


def test_kernel_sources_are_listed():
    names = {f.name for f in _build.sources()}
    assert names == {"fft_core.cuh", "fft_regs.cuh", "regs_kernels.cuh",
                     "fft_last.cu", "fft_last_mix.cu", "real_rows_mix.cu",
                     "fft_axis.cu", "fft_axis_mix.cu", "fft_slab.cu",
                     "rfft_slab.cu",
                     "irfft_slab.cu", "assemble_mp1.cu", "rfft_last.cu",
                     "fourstep.cu", "icrfft_last.cu", "fft_cube.cu",
                     "fft_cube_regs.cu", "probe_mma.cu"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for info in fused_fft.KERNELS.values():
        assert os.path.exists(os.path.join(root, info["source"]))
        for w in info["wrappers"]:
            assert hasattr(fused_fft.WRAPPERS[w], "plain")
