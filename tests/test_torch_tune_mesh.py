"""offt_tpu_torch.tune on a mesh: one spawned 4-rank gloo world of the CPU
(tests/torch_world.py), every rank running tune() on a 2 x 2 "cpu" mesh,
held against offt_tpu.tune.tune on a 2 x 2 mesh of four virtual CPU
devices.

- tune() with the reference's fake timer (keyed on t1, t2, ry; no radix
  dimensions) gives the reference's trials and best parameters, on
  every rank; rank 0 alone writes the plan cache, once, and plan() with
  no params reads the winner back on every rank;
- tune(fast_trial=2) on c2c, r2c and c2r (the FAST_TUNING phase trials,
  then the refinement pass on whole plans): feasible parameters, the
  same result on every rank, and the tuned plan within 1e-5 of numpy
  (the reference's tolerance);
- make_phase_trials truncates each phase to its first k chunks (the
  reference's test_phase_trials_truncate_work on a 2 x 2 mesh): the
  weights t / k, the blocks, the values of the reference's trial
  programs on the same inputs, and the kernels of the whole plan.
"""

import dataclasses
import datetime
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_world as tw

SHAPE = (16, 16, 16)
TRIAL_SHAPE = (32, 32, 32)
TRIAL_KNOBS = dict(p1=2, t1=8, t2=8, w1=2, w2=2)
# (label, real, inverse, strategy, max_trials) of the fast_trial cases
FAST = [("c2c", False, False, "random", 4), ("r2c", True, False, "random", 3),
        ("c2r", True, True, "random", 3)]


def fake_timer(plan):
    """The reference's test timer: bigger tiles faster, ry a penalty."""
    pp = plan.params
    return 1.0 / (pp.t1 + pp.t2) + 0.01 * pp.ry


def _result(res) -> dict:
    return {"best": dataclasses.asdict(res.best_params),
            "best_perf": res.best_perf, "default_perf": res.default_perf,
            "converged": res.converged,
            "trials": [[list(map(int, t.point)), t.perf, t.status]
                       for t in res.trials]}


def _global(label, seed):
    """The global input of a fast_trial case: complex data, real data, or
    the half-spectrum of real data."""
    rng = np.random.default_rng(seed)
    if label == "c2c":
        return (rng.standard_normal(SHAPE)
                + 1j * rng.standard_normal(SHAPE)).astype(np.complex64)
    x = rng.standard_normal(SHAPE)
    if label == "r2c":
        return x.astype(np.float32)
    return np.fft.rfftn(x).astype(np.complex64)


def _worker(rank, outdir):
    os.environ["OFFT_TPU_TORCH_CACHE_DIR"] = os.path.join(outdir, "cache")
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(outdir, 'store')}",
        rank=rank, world_size=tw.WORLD,
        timeout=datetime.timedelta(seconds=120))
    try:
        _cases(rank, outdir)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _cases(rank, outdir):
    import offt_tpu_torch as ot
    from offt_tpu_torch.dist import make_mesh
    from offt_tpu_torch.dist import mesh as meshlib
    from offt_tpu_torch.dist.pencil import make_phase_trials
    from offt_tpu_torch.kernels import fused_fft as ff
    from offt_tpu_torch.plan import cache
    from offt_tpu_torch.plan.params import PlanParams

    mesh = make_mesh(2, 2, device_type="cpu")
    out = {}

    # the fake timer: the reference's trials; one cache write
    stores = []
    keep = cache.store
    cache.store = lambda key, *a, **k: (stores.append(key),
                                        keep(key, *a, **k))
    try:
        res = ot.tune.tune(SHAPE, "complex64", mesh=mesh, strategy="nm",
                           max_trials=40, timer=fake_timer,
                           include_radix=False, seed=2,
                           log_path=os.path.join(outdir, "fake.jsonl"))
    finally:
        cache.store = keep
    out["fake"] = _result(res)
    out["fake_stores"] = stores
    p = ot.plan(SHAPE, "complex64", mesh=mesh, planar=True)
    out["fake_plan"] = dataclasses.asdict(p.params)

    # fast_trial: the phase trials, then whole plans
    for i, (label, real, inverse, strategy, budget) in enumerate(FAST):
        res = ot.tune.tune(SHAPE, "complex64", mesh=mesh, real=real,
                           inverse=inverse, strategy=strategy,
                           max_trials=budget, include_radix=False,
                           fast_trial=2, seed=i, save=False,
                           log_path=os.path.join(outdir, f"{label}.jsonl"))
        out[label] = _result(res)
        p = ot.plan(SHAPE, "complex64", mesh=mesh, real=real,
                    inverse=inverse, params=res.best_params, planar=True,
                    use_cache=False)
        x = _global(label, seed=i)
        blk = x[p.input_block(x.shape)]
        if label == "r2c":
            y = p(torch.from_numpy(blk.copy()))
        else:
            y = p(torch.from_numpy(blk.real.copy()),
                  torch.from_numpy(blk.imag.copy()))
        y = y.numpy() if isinstance(y, torch.Tensor) else \
            y[0].numpy() + 1j * y[1].numpy()
        oshape = SHAPE[:2] + (SHAPE[2] // 2 + 1,) if label == "r2c" \
            else SHAPE
        np.savez(os.path.join(outdir, f"{label}_{rank}.npz"), y=y,
                 blk=np.array([[s.start, s.stop]
                               for s in p.output_block(oshape)]))

    # the phase trials against the whole plan
    params = PlanParams(**TRIAL_KNOBS, use_pallas=1)
    (fn1, b1, w1), (fn2, b2, w2) = make_phase_trials(mesh, 3, params,
                                                     TRIAL_SHAPE, k=2)
    c = meshlib.coords(mesh)
    r, q = c["row"], c["col"]
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(TRIAL_SHAPE)
         + 1j * rng.standard_normal(TRIAL_SHAPE)).astype(np.complex64)
    m = (rng.standard_normal(TRIAL_SHAPE)
         + 1j * rng.standard_normal(TRIAL_SHAPE)).astype(np.complex64)
    xb = x[r * 16:(r + 1) * 16, q * 16:(q + 1) * 16]
    mb = m[r * 16:(r + 1) * 16, :, q * 16:(q + 1) * 16]
    planar = lambda a: (torch.from_numpy(a.real.copy()),  # noqa: E731
                        torch.from_numpy(a.imag.copy()))
    ff.reset_counts()
    mid = fn1(planar(xb))
    out_ = fn2(planar(mb))
    trial_ran = sorted(k for k, v in ff.counts().items() if v[1])
    full = ot.plan(TRIAL_SHAPE, "complex64", mesh=mesh, params=params,
                   planar=True, use_cache=False)
    ff.reset_counts()
    full(*planar(xb))
    plan_ran = sorted(k for k, v in ff.counts().items() if v[1])
    np.savez(os.path.join(outdir, f"trials_{rank}.npz"),
             mid=mid[0].numpy() + 1j * mid[1].numpy(),
             out=out_[0].numpy() + 1j * out_[1].numpy(),
             b1=np.array(b1), b2=np.array(b2), w=np.array([w1, w2]),
             rq=np.array([r, q]))
    out["trial_ran"], out["plan_ran"] = trial_ran, plan_ran
    with open(os.path.join(outdir, f"{rank}.json"), "w") as fh:
        json.dump(out, fh)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    outdir = tmp_path_factory.mktemp("tune_mesh")
    tw.spawn(_worker, outdir)
    res = []
    for r in range(tw.WORLD):
        with open(os.path.join(outdir, f"{r}.json")) as fh:
            res.append(json.load(fh))
    return outdir, res


def _ref_mesh():
    import jax

    from offt_tpu.dist import mesh as rmesh

    return rmesh.make_mesh(2, 2, devices=jax.devices()[:4])


def test_fake_timer_matches_the_reference(world, tmp_path, monkeypatch):
    monkeypatch.setenv("OFFT_TPU_CACHE_DIR", str(tmp_path))
    from offt_tpu.tune import tune as r_tune

    from offt_tpu_torch.plan.params import default_params, ProblemSpec

    outdir, res = world
    ref = r_tune(SHAPE, "complex64", mesh=_ref_mesh(), strategy="nm",
                 max_trials=40, timer=fake_timer, include_radix=False,
                 seed=2)
    got = res[0]["fake"]
    assert got["trials"] == [[list(map(int, t.point)), t.perf, t.status]
                             for t in ref.trials]
    assert got["best_perf"] == ref.best_perf
    assert got["default_perf"] == ref.default_perf
    assert got["converged"] == ref.converged
    # the searched fields are the reference's; the rest come from the
    # port's default point (use_pallas=1, where PlanParams() has 0)
    base = dataclasses.asdict(default_params(ProblemSpec(shape=SHAPE, p=4),
                                             p1=2))
    want = dataclasses.asdict(ref.best_params)
    for k in ("p1", "t1", "t2", "w1", "w2", "ry", "s1", "s2", "v",
              "rankorder"):
        assert got["best"][k] == want[k], k
    for k in ("use_pallas", "precision", "radix_z", "split_1d"):
        assert got["best"][k] == base[k], k
    assert ref.best_perf <= ref.default_perf


def test_every_rank_returns_the_same_result(world):
    _, res = world
    for key in ("fake",) + tuple(f[0] for f in FAST):
        for r in range(1, tw.WORLD):
            assert res[r][key] == res[0][key], (key, r)


def test_the_cache_is_written_once_and_read_back(world):
    outdir, res = world
    assert [len(r["fake_stores"]) for r in res] == [1, 0, 0, 0]
    key = res[0]["fake_stores"][0]
    assert key == "16x16x16|complex64|c2c|2x2|cpu|b1"
    with open(os.path.join(outdir, "cache", "plan_cache.json")) as fh:
        db = json.load(fh)
    assert list(db) == [key]
    for r in res:
        assert r["fake_plan"] == r["fake"]["best"]
    # rank 0 alone logs
    from offt_tpu_torch.obs.log import read_events
    evs = read_events(os.path.join(outdir, "fake.jsonl"))
    assert sum(e["kind"] == "tune_done" for e in evs) == 1


@pytest.mark.parametrize("case", FAST, ids=[f[0] for f in FAST])
def test_fast_trial_tunes_and_the_plan_is_right(world, case):
    from offt_tpu_torch.obs.log import read_events
    from offt_tpu_torch.plan.params import (PlanParams, ProblemSpec,
                                            is_feasible)

    outdir, res = world
    i = FAST.index(case)
    label, real, inverse, _, budget = case
    got = res[0][label]
    spec = ProblemSpec(shape=SHAPE, p=4, real=real, inverse=inverse)
    best = PlanParams(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in got["best"].items()})
    assert is_feasible(spec, best)
    assert 0 < got["best_perf"] <= got["default_perf"] < float("inf")
    assert 0 < len([t for t in got["trials"] if t[2] == "ok"]) <= budget
    kinds = [e["kind"] for e in read_events(
        os.path.join(outdir, f"{label}.jsonl"))]
    assert "refine" in kinds and kinds[-1] == "tune_done"
    oshape = SHAPE[:2] + (SHAPE[2] // 2 + 1,) if label == "r2c" else SHAPE
    y = np.zeros(oshape, np.complex128)
    for r in range(tw.WORLD):
        d = np.load(os.path.join(outdir, f"{label}_{r}.npz"))
        y[tuple(slice(a, b) for a, b in d["blk"])] = d["y"]
    x = _global(label, seed=i).astype(np.complex128)
    if label == "c2c":
        want = np.fft.fftn(x)
    elif label == "r2c":
        want = np.fft.rfftn(x.real)
    else:
        want = np.fft.irfftn(x, s=SHAPE, axes=(0, 1, 2))
        y = y.real
    assert np.linalg.norm(y - want) / np.linalg.norm(want) < 1e-5


def test_phase_trials_truncate_work(world):
    """Phase 1 chunks the local x rows (32 / 2 = 16 a rank, 8 chunks of
    2): k = 2 chunks give 4 local rows, a global x extent of 8; phase 2
    chunks the local z (16, 8 chunks of 2): 4 local planes, a global 8.
    The values are those of the reference's trial programs on the same
    inputs, and the trials run the kernels of the whole plan."""
    import jax
    from jax.sharding import NamedSharding

    from offt_tpu.dist.pencil import make_phase_trials as r_trials
    from offt_tpu.plan.params import PlanParams as RParams

    outdir, res = world
    mesh = _ref_mesh()
    (f1, s1, shp1, w1), (f2, s2, shp2, w2) = r_trials(
        mesh, 3, RParams(**TRIAL_KNOBS), TRIAL_SHAPE, k=2)
    rng = np.random.default_rng(7)
    x = (rng.standard_normal(TRIAL_SHAPE)
         + 1j * rng.standard_normal(TRIAL_SHAPE)).astype(np.complex64)
    m = (rng.standard_normal(TRIAL_SHAPE)
         + 1j * rng.standard_normal(TRIAL_SHAPE)).astype(np.complex64)
    mid = np.asarray(f1(jax.device_put(x, NamedSharding(mesh, s1))))
    out = np.asarray(f2(jax.device_put(m, NamedSharding(mesh, s2))))
    assert mid.shape == (8, 32, 32) and out.shape == (32, 32, 8)
    for rank in range(tw.WORLD):
        d = np.load(os.path.join(outdir, f"trials_{rank}.npz"))
        r, q = d["rq"]
        assert tuple(d["b1"]) == (16, 16, 32) and tuple(d["b2"]) == (16, 32,
                                                                     16)
        assert list(d["w"]) == [w1, w2] == [4.0, 4.0]
        assert d["mid"].shape == (4, 32, 16) and d["out"].shape == (32, 16,
                                                                    4)
        for got, want in ((d["mid"], mid[r * 4:(r + 1) * 4, :,
                                          q * 16:(q + 1) * 16]),
                          (d["out"], out[:, r * 16:(r + 1) * 16,
                                         q * 4:(q + 1) * 4])):
            assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5
    for r in res:
        assert r["trial_ran"] == r["plan_ran"] and r["plan_ran"]
