"""offt_tpu_torch.tune against offt_tpu.tune on the CPU: with the same
seed on the same space every strategy generates the reference's points,
scores and best; the reference's tests/test_tuner.py cases on the port
(synthetic convergence, memoization, +inf scoring that carries on,
expression constraints and their sandbox, layers, the trivial space, the
inverse spec bounds, the hybrid initial simplex); and tune() end to end
on one CPU device: the cache written under plan()'s key and read back,
the event log, the refinement pass, an out-of-memory error."""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

STRATEGIES = ("random", "nm", "pro", "brute")


def _trials(tuner):
    return [(tuple(int(i) for i in t.point), t.perf, t.status)
            for t in tuner.trials]


@pytest.mark.parametrize("name", STRATEGIES)
@pytest.mark.parametrize("seed", [1, 3])
def test_strategies_generate_the_references_points(name, seed):
    """The quadratic acceptance space (Active Harmony's example): the
    port's Tuner and strategy generate the reference's trials, point by
    point, with the same scores and the same best."""
    from offt_tpu.tune.synth import (ah_quadratic as r_quad,
                                     quadratic_space as r_space)
    from offt_tpu.tune.tuner import Tuner as RTuner

    from offt_tpu_torch.tune import Tuner
    from offt_tpu_torch.tune.synth import ah_quadratic, quadratic_space

    budget = 200 if name == "brute" else 300
    ref = RTuner(r_space(), objective=r_quad, strategy=name,
                 max_trials=budget, seed=seed)
    r_best = ref.run()
    got = Tuner(quadratic_space(), objective=ah_quadratic, strategy=name,
                max_trials=budget, seed=seed)
    best = got.run()
    assert _trials(got) == _trials(ref)
    assert best == r_best
    assert got.strategy.best() == ref.strategy.best()
    assert got.strategy.converged() == ref.strategy.converged()


@pytest.mark.parametrize("name", ["nm", "pro"])
def test_simplex_strategies_from_a_user_simplex(name):
    """NM and PRO seeded with the hybrid initial simplex of a plan space
    (p = 8, distributed dimensions only) generate the reference's points
    under the same scores."""
    from offt_tpu.plan.params import ProblemSpec as RSpec
    from offt_tpu.tune.simplex import hybrid_initial_simplex as r_simplex
    from offt_tpu.tune.space import build_space as r_build
    from offt_tpu.tune.strategies import make_strategy as r_make

    from offt_tpu_torch.plan.params import ProblemSpec
    from offt_tpu_torch.tune import build_space, make_strategy
    from offt_tpu_torch.tune.simplex import hybrid_initial_simplex

    r_sp = r_build(RSpec(shape=(32, 16, 64), p=8), include_radix=False,
                   include_pallas=False)
    sp = build_space(ProblemSpec(shape=(32, 16, 64), p=8),
                     include_radix=False, device="cpu")
    assert sp.names == r_sp.names and sp.sizes == r_sp.sizes
    init = hybrid_initial_simplex(sp, seed=5)
    assert init == r_simplex(r_sp, seed=5)
    ours = make_strategy(name, sp, seed=5, init_simplex=init)
    theirs = r_make(name, r_sp, seed=5, init_simplex=init)
    rng = np.random.default_rng(0)
    for _ in range(60):
        a, b = ours.generate(), theirs.generate()
        assert a == b
        if a is None:
            break
        if sp.infeasible_reason(a) is not None:
            assert r_sp.infeasible_reason(b) is not None
            ours.rejected(a)
            theirs.rejected(b)
            continue
        perf = float(rng.random())
        ours.analyze(a, perf)
        theirs.analyze(b, perf)
    assert ours.best() == theirs.best()


def run_synthetic(strategy_name, max_trials=400, seed=1):
    from offt_tpu_torch.tune import Tuner
    from offt_tpu_torch.tune.synth import ah_quadratic, quadratic_space

    tuner = Tuner(quadratic_space(), objective=ah_quadratic,
                  strategy=strategy_name, max_trials=max_trials, seed=seed)
    best, perf = tuner.run()
    return best, perf, tuner


def test_random_improves():
    from offt_tpu_torch.tune.synth import ah_quadratic

    best, perf, _ = run_synthetic("random", max_trials=300)
    rng = np.random.default_rng(0)
    base = ah_quadratic([int(rng.integers(1, 101)) for _ in range(6)])
    assert perf < base
    assert perf < 6 * 50 ** 2


def test_nm_converges_to_optimum():
    best, perf, _ = run_synthetic("nm", max_trials=500, seed=3)
    assert perf <= 30, f"nm best {best} perf {perf}"


def test_pro_converges():
    best, perf, tuner = run_synthetic("pro", max_trials=500, seed=3)
    assert perf <= 150, f"pro best {best} perf {perf}"
    assert tuner.strategy.converged()


def test_brute_exhaustive_tiny():
    from offt_tpu_torch.plan.params import ProblemSpec
    from offt_tpu_torch.tune import Dimension, Tuner
    from offt_tpu_torch.tune.synth import _SynthSpace

    space = _SynthSpace(spec=ProblemSpec(shape=(1, 1, 1)), dims=tuple(
        Dimension(f"v{i}", tuple(range(10, 21))) for i in range(2)))
    tuner = Tuner(space, objective=lambda v: (v[0] - 15) ** 2
                  + (v[1] - 17) ** 2, strategy="brute", max_trials=10_000)
    assert tuner.run() == ((15, 17), 0)


def test_memoization():
    from offt_tpu_torch.tune import Tuner, make_strategy
    from offt_tpu_torch.tune.synth import ah_quadratic, quadratic_space

    space = quadratic_space()
    calls = []

    def obj(vals):
        calls.append(vals)
        return ah_quadratic(vals)

    tuner = Tuner(space, objective=obj,
                  strategy=make_strategy("random", space, seed=0),
                  max_trials=50)
    tuner.run()
    assert len(calls) == len({tuple(c) for c in calls})


def test_error_scores_inf_and_continues():
    from offt_tpu_torch.tune import Tuner
    from offt_tpu_torch.tune.synth import ah_quadratic, quadratic_space

    n_calls = [0]

    def obj(vals):
        n_calls[0] += 1
        if n_calls[0] % 3 == 0:
            raise RuntimeError("simulated build failure")
        return ah_quadratic(vals)

    tuner = Tuner(quadratic_space(), objective=obj, strategy="random",
                  max_trials=30)
    best, perf = tuner.run()
    assert perf < float("inf")
    errs = [t for t in tuner.trials if t.status == "error"]
    assert errs and all(t.perf == float("inf") for t in errs)


def test_out_of_memory_scores_inf_and_frees_the_cache(monkeypatch):
    """A CUDA out-of-memory error in a build or a measurement scores +inf
    like any error, and empties the allocator's cache after it."""
    from offt_tpu_torch.tune import Tuner
    from offt_tpu_torch.tune.synth import ah_quadratic, quadratic_space

    freed = []
    monkeypatch.setattr(torch.cuda, "empty_cache",
                        lambda: freed.append(True))

    def build(vals):
        if vals[0] % 2:
            raise torch.cuda.OutOfMemoryError("simulated")
        return vals

    def measure(vals):
        if vals[1] % 3 == 0:
            raise torch.cuda.OutOfMemoryError("simulated")
        if vals[1] % 3 == 1:
            raise RuntimeError("not memory")
        return ah_quadratic(vals)

    space = quadratic_space()
    tuner = Tuner(space, objective=None, strategy="random", max_trials=40,
                  compile_fn=build, measure_fn=measure, batch=4)
    best, perf = tuner.run()
    oom = [t for t in tuner.trials
           if t.status == "error" and (t.params[0] % 2
                                       or t.params[1] % 3 == 0)]
    other = [t for t in tuner.trials
             if t.status == "error" and not (t.params[0] % 2
                                             or t.params[1] % 3 == 0)]
    assert oom and other and len(freed) == len(oom)
    assert all(t.perf == float("inf") for t in oom + other)
    assert perf < float("inf")


def test_fft_space_feasibility_filter():
    from offt_tpu_torch.plan.params import ProblemSpec
    from offt_tpu_torch.tune import build_space

    space = build_space(ProblemSpec(shape=(16, 16, 16), p=8), device="cpu")
    assert all(len(d) >= 1 for d in space.dims)
    for p1 in space.dims[space.names.index("p1")].values:
        assert 8 % p1 == 0
    names = space.names
    pt = list(space.from_params(space.to_params(tuple(0 for _ in names))))
    pt[names.index("t1")] = 0
    iw1 = names.index("w1")
    pt[iw1] = len(space.dims[iw1].values) - 1
    assert space.infeasible_reason(tuple(pt)) is not None


def test_expression_constraints():
    from offt_tpu_torch.plan.params import ProblemSpec
    from offt_tpu_torch.tune import build_space

    spec = ProblemSpec(shape=(64, 64, 64), p=8)
    space = build_space(spec, include_radix=False, device="cpu",
                        constraints=("t1 <= t2", "w1 + w2 <= 4"))
    names = space.names
    pt = list(space.from_params(space.to_params((0,) * len(names))))
    pt[names.index("t1")] = 2
    pt[names.index("t2")] = 0
    assert "constraint violated" in space.infeasible_reason(tuple(pt))
    pt[names.index("t2")] = 2
    assert space.infeasible_reason(tuple(pt)) is None
    bad = build_space(spec, include_radix=False, device="cpu",
                      constraints=("nonsense ===",))
    assert "errored" in bad.infeasible_reason(tuple(0 for _ in bad.dims))


@pytest.mark.parametrize("expr", ["().__class__", "t1.__class__", "[1][0]",
                                  "(lambda: 1)()", "__import__('os')"])
def test_constraint_eval_is_sandboxed(expr):
    from offt_tpu_torch.tune.space import eval_constraint

    assert eval_constraint("min(t1, 3) + 1 <= t2 * 2", {"t1": 4, "t2": 2})
    assert not eval_constraint("t1 < 2", {"t1": 4})
    with pytest.raises(Exception):
        eval_constraint(expr, {"t1": 1})


def test_inverse_tune_spec_bounds():
    from offt_tpu_torch.plan.params import (PlanParams, ProblemSpec,
                                            infeasible_reason)

    fwd = ProblemSpec(shape=(32, 8, 64), p=8)
    inv = ProblemSpec(shape=(32, 8, 64), p=8, inverse=True)
    p = PlanParams(p1=4, t1=16, t2=1)
    assert infeasible_reason(fwd, p) is not None
    assert infeasible_reason(inv, p) is None
    q = PlanParams(p1=4, t1=1, t2=16)
    assert infeasible_reason(fwd, q) is None
    assert infeasible_reason(inv, q) is not None


def test_hybrid_initial_simplex():
    from offt_tpu_torch.plan.params import ProblemSpec, default_params
    from offt_tpu_torch.tune import build_space
    from offt_tpu_torch.tune.simplex import hybrid_initial_simplex

    spec = ProblemSpec(shape=(16, 16, 16), p=8)
    space = build_space(spec, device="cpu")
    pts = hybrid_initial_simplex(space, seed=3)
    assert len(pts) == max(len(space.dims) + 1, 4)
    assert len(set(pts)) == len(pts)
    assert pts[0] == space.from_params(default_params(spec))
    assert space.to_params(pts[0]) == default_params(spec)
    i_p1 = space.names.index("p1")
    assert {1, 8} <= {space.dims[i_p1].values[pt[i_p1]] for pt in pts}


def test_layer_stack_filter_and_penalty():
    from offt_tpu_torch.plan.params import ProblemSpec
    from offt_tpu_torch.tune import Dimension, FilterLayer, PenaltyLayer, Tuner
    from offt_tpu_torch.tune.synth import _SynthSpace

    space = _SynthSpace(spec=ProblemSpec(shape=(1, 1, 1)),
                        dims=(Dimension("a", tuple(range(10))),))
    flt = FilterLayer(lambda vals: vals[0] % 2 == 0, name="even-only")
    pen = PenaltyLayer(lambda space, pt, perf: perf + 100.0)
    tuner = Tuner(space, lambda v: float(v[0]), strategy="brute",
                  max_trials=10, layers=[flt, pen])
    best, perf = tuner.run()
    assert len([t for t in tuner.trials if t.status == "rejected"]) == 5
    assert space.to_params(best) == (0,)
    assert perf == 100.0


def test_layer_stack_transform():
    from offt_tpu_torch.plan.params import ProblemSpec
    from offt_tpu_torch.tune import Dimension, TransformLayer, Tuner
    from offt_tpu_torch.tune.synth import _SynthSpace

    space = _SynthSpace(spec=ProblemSpec(shape=(1, 1, 1)),
                        dims=(Dimension("a", tuple(range(8))),))
    seen = []

    def objective(vals):
        seen.append(vals[0])
        return float(vals[0])

    tl = TransformLayer(lambda sp, pt: (pt[0] - pt[0] % 2,))
    Tuner(space, objective, strategy="brute", max_trials=8,
          layers=[tl]).run()
    assert seen and all(v % 2 == 0 for v in seen)


def test_tune_trivial_space_returns_default(tmp_path, monkeypatch):
    """Nothing to search: the default point is timed, returned and (unlike
    the reference, which caches nothing there) cached under plan()'s key."""
    monkeypatch.setenv("OFFT_TPU_TORCH_CACHE_DIR", str(tmp_path))
    from offt_tpu_torch.plan import cache
    from offt_tpu_torch.plan.params import ProblemSpec, default_params
    from offt_tpu_torch.tune import tune

    res = tune((16, 16, 16), "complex64", strategy="nm", max_trials=5,
               timer=lambda plan: 0.123, device="cpu")
    spec = ProblemSpec(shape=(16, 16, 16))
    assert res.converged and res.trials == []
    assert res.best_perf == res.default_perf == 0.123
    assert res.best_params == default_params(spec)
    key = cache.plan_key((16, 16, 16), "complex64", False, 1, 1, "cpu")
    assert cache.lookup(key) == res.best_params


def test_tune_single_device_end_to_end(tmp_path, monkeypatch):
    """tune() over real plans on the CPU with the default timer (host
    clock): the trials build and time the port's plans, the refinement
    pass re-measures the finalists and the default point, the winner is
    cached under the key plan() looks up with no params, its plan matches
    numpy, and the event log reads back."""
    monkeypatch.setenv("OFFT_TPU_TORCH_CACHE_DIR", str(tmp_path))
    import offt_tpu_torch as ot
    from offt_tpu_torch.obs.log import read_events
    from offt_tpu_torch.plan import cache
    from offt_tpu_torch.plan.params import ProblemSpec, is_feasible

    shape = (8, 12, 24)
    log = tmp_path / "trials.jsonl"
    res = ot.tune.tune(shape, "float32", real=True, strategy="nm",
                       max_trials=6, device="cpu", include_pallas=True,
                       seed=1, log_path=str(log))
    spec = ProblemSpec(shape=shape, real=True)
    assert is_feasible(spec, res.best_params)
    assert 0 < res.best_perf <= res.default_perf < float("inf")
    assert res.speedup_vs_default >= 1.0
    evs = read_events(str(log))
    kinds = [e["kind"] for e in evs]
    assert "trial" in kinds and "refine" in kinds
    assert kinds[-1] == "tune_done"
    assert evs[-1]["best"] == json.loads(json.dumps(
        dataclasses.asdict(res.best_params)))
    key = cache.plan_key(shape, "complex64", True, 1, 1, "cpu")
    assert cache.lookup(key) == res.best_params
    p = ot.plan(shape, "float32", real=True, planar=True, device="cpu")
    assert p.params == res.best_params
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    yr, yi = p(torch.from_numpy(x))
    want = np.fft.rfftn(x.astype(np.float64))
    got = yr.numpy() + 1j * yi.numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
    # a second run resumes its point database from the log
    res2 = ot.tune.tune(shape, "float32", real=True, strategy="nm",
                        max_trials=6, device="cpu", include_pallas=True,
                        seed=1, log_path=str(log), save=False)
    evs = read_events(str(log))
    assert any(e["kind"] == "resume" and e["memoized"] > 0 for e in evs)
    assert res2.best_perf <= res2.default_perf


def test_tune_reads_the_config_layers(tmp_path, monkeypatch):
    """strategy, max_trials and prefetch_count resolve through the port's
    config layers (OFFT_TPU_TORCH_<KEY>)."""
    monkeypatch.setenv("OFFT_TPU_TORCH_CACHE_DIR", str(tmp_path))
    from offt_tpu_torch.tune import tune
    from offt_tpu_torch.utils import config

    snap = config.snapshot()
    for key, val in (("strategy", "nm"), ("max_trials", 30),
                     ("simplex_size", 0), ("prefetch_count", 4),
                     ("server_host", "127.0.0.1"), ("server_port", 1979)):
        assert snap[key] == val
    monkeypatch.setenv("OFFT_TPU_TORCH_STRATEGY", "brute")
    monkeypatch.setenv("OFFT_TPU_TORCH_MAX_TRIALS", "3")
    monkeypatch.setenv("OFFT_TPU_TORCH_SERVER_PORT", "2024")
    assert config.get("server_port") == 2024
    res = tune((8, 8, 8), "complex64", timer=lambda p: 1.0 + p.params
               .block_batch, device="cpu", include_pallas=True,
               include_radix=False)
    # brute over block_batch's five values, cut to three trials
    assert [t.point for t in res.trials] == [(0,), (1,), (2,)]
    assert res.best_params.block_batch == 0


def test_tune_keeps_the_kernels_when_a_kernel_fails(tmp_path, monkeypatch):
    """The card's space has no use_pallas dimension, so every point runs
    the kernels: a kernel wrapper that fails at the default split (1024,
    1024) of (1, 1, 2^20) scores those points +inf, and the winner is
    another split with use_pallas=1, never the unfused engine. Where the
    wrapper fails at every split, nothing could be timed and tune()
    raises."""
    monkeypatch.setenv("OFFT_TPU_TORCH_CACHE_DIR", str(tmp_path))
    from offt_tpu_torch.kernels import fourstep
    from offt_tpu_torch.plan.params import ProblemSpec
    from offt_tpu_torch.tune import build_space, tune

    shape = (1, 1, 2 ** 20)
    space = build_space(ProblemSpec(shape=shape), device="cuda")
    assert space.names == ("split_1d",)
    kernel = fourstep._step1_twiddle
    failing = [{(1024, 1024)}]

    @functools.wraps(kernel)
    def planted(xr3, xi3, n1, n2, *a, **k):
        if failing[0] == "all" or (n1, n2) in failing[0]:
            raise RuntimeError(f"step1_twiddle ({n1}, {n2}): launch failed")
        return kernel(xr3, xi3, n1, n2, *a, **k)

    monkeypatch.setattr(fourstep, "_step1_twiddle", planted)
    rng = np.random.default_rng(0)
    x = tuple(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              for _ in range(2))

    def timer(p):
        p(*x)
        return 1.0 + space.dims[0].values.index(p.params.split_1d)

    res = tune(shape, "complex64", strategy="brute", max_trials=space.size(),
               timer=timer, device="cpu", include_pallas=True)
    failed = [t for t in res.trials if t.status == "error"]
    assert [t.params.split_1d for t in failed] == [None, (1024, 1024)]
    assert all(t.perf == float("inf") for t in failed)
    assert all(t.params.use_pallas == 1 for t in res.trials)
    assert res.best_params.split_1d == space.dims[0].values[2]
    assert res.best_params.use_pallas == 1
    failing[0] = "all"
    with pytest.raises(RuntimeError, match="no point of the space"):
        tune(shape, "complex64", strategy="brute", max_trials=space.size(),
             timer=timer, device="cpu", include_pallas=True)
