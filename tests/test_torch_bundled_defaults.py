"""The tuned defaults shipped with the port
(offt_tpu_torch/plan/tuned_defaults.json, ``cache._bundled``): the
counterparts of tests/test_plan.py's bundled cases and
tests/test_dist_defaults.py's mesh-keyed ones. The file holds H100 keys
only, so the host's lookups never hit it: the tests that need a hit
monkeypatch ``cache.device_kind`` to the card's name and build on
``device="cpu"``. Every entry must be what
``bench/saturation.ship`` writes from the receipt
(receipts_torch/saturation_h100.jsonl). The file holds one key, 256^3
c2c on 2 x 2: the one-card key it held, 192^3 r2c at radix_z (3, 32),
was re-swept `saturated` once ``rfft_last`` ran 192^3's M = 96 on the
register core, which reads no radix. The one-card lookups read that
record from the bundled store, put in place by ``on_h100``."""

import datetime
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import offt_tpu_torch as ot
from offt_tpu_torch.bench import saturation
from offt_tpu_torch.plan import cache
from offt_tpu_torch.plan.params import (PlanParams, ProblemSpec,
                                        default_params, infeasible_reason)

H100 = "NVIDIA H100 80GB HBM3"
R192 = cache.plan_key((192,) * 3, "complex64", True, 1, 1, H100)
M256 = cache.plan_key((256,) * 3, "complex64", False, 2, 2, H100)
FILE = pathlib.Path(cache.__file__).parent / "tuned_defaults.json"
TOL = 1e-6


def _spec_of(key: str) -> ProblemSpec:
    parts = key.split("|")
    shape = tuple(int(v) for v in parts[0].split("x"))
    p1, p2 = (int(v) for v in parts[3].split("x"))
    return ProblemSpec(shape=shape, dtype=parts[1], real=parts[2] == "r2c",
                       inverse=parts[-1] == "inv", p=p1 * p2)


# the one-card record the file shipped for 192^3 r2c until its re-sweep
ONE_CARD = {R192: {"params": cache._params_to_json(
    default_params(ProblemSpec(shape=(192,) * 3, real=True)).replace(
        radix_z=(3, 32))), "perf": 2.0731200277805328e-4}}


@pytest.fixture
def on_h100(monkeypatch, tmp_path):
    """An empty local cache, every plan keyed as on the card, and the
    bundled store the file's entries and the one-card record."""
    monkeypatch.setenv("OFFT_TPU_TORCH_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(cache, "device_kind", lambda device: H100)
    monkeypatch.setattr(cache, "_BUNDLED_DB", {**cache._bundled(),
                                               **ONE_CARD})


def test_bundled_fallback_and_local_precedence(on_h100):
    got = cache.lookup(R192)
    assert got is not None and got.radix_z == (3, 32) and got.use_pallas == 1
    override = got.replace(radix_z=(96,))
    cache.store(R192, override, perf=1e-9)
    assert cache.lookup(R192).radix_z == (96,)
    cache.clear()
    assert cache.lookup(R192).radix_z == (3, 32)


def test_plan_reads_bundled_entry(on_h100):
    p = ot.plan((192,) * 3, "float32", real=True, planar=True, device="cpu")
    assert p.params == cache.lookup(R192)
    assert p.params != default_params(ProblemSpec(shape=(192,) * 3,
                                                  real=True))


def test_use_cache_false_and_explicit_params_skip_bundled(on_h100):
    dflt = default_params(ProblemSpec(shape=(192,) * 3, real=True))
    p = ot.plan((192,) * 3, "float32", real=True, planar=True, device="cpu",
                use_cache=False)
    assert p.params == dflt
    mine = PlanParams(use_pallas=1, radix_z=(16, 6))
    p = ot.plan((192,) * 3, "float32", real=True, planar=True, device="cpu",
                params=mine)
    assert p.params == mine


def test_host_and_other_directions_never_hit(monkeypatch, tmp_path):
    monkeypatch.setenv("OFFT_TPU_TORCH_CACHE_DIR", str(tmp_path))
    p = ot.plan((192,) * 3, "float32", real=True, planar=True, device="cpu")
    assert p.params == default_params(ProblemSpec(shape=(192,) * 3,
                                                  real=True))
    inv = cache.plan_key((192,) * 3, "complex64", True, 1, 1, H100,
                         inverse=True)
    assert cache.lookup(inv) is None


def test_every_entry_parses_and_is_feasible():
    db = json.loads(FILE.read_text())
    assert db and db == cache._bundled()
    for key, rec in db.items():
        params = cache._params_from_json(rec["params"])
        assert infeasible_reason(_spec_of(key), params) is None, key
        assert rec["perf"] > 0, key
        assert key.split("|")[4] == H100, key
        assert "cpu" not in key.split("|") and "TPU" not in key, key
        assert key.split("|")[5] == "b1", key


def test_every_entry_backed_by_receipt():
    """The file is exactly what the receipt ships: each key's confirmed
    verdict is win or headroom and its three rechecks hold (the best
    point's slowest median under the default's fastest)."""
    assert saturation.shippable() == json.loads(FILE.read_text())
    rows = saturation.rows(saturation.OUT)
    for key in json.loads(FILE.read_text()):
        spec = _spec_of(key)
        mine = [r for r in rows if r.get("stage") == "confirmed"
                and tuple(r["shape"]) == spec.shape
                and r["real"] == spec.real and r["inverse"] == spec.inverse
                and r["mesh"][0] * r["mesh"][1] == spec.p]
        assert mine and mine[-1]["verdict"] in ("win", "headroom"), key
        checks = [r for r in rows if r.get("stage") == "recheck"
                  and r["key"] == mine[-1]["key"]]
        assert len(checks) >= 3, key
        assert (max(r["best_ms"] for r in checks)
                < min(r["default_ms"] for r in checks)), key


def test_saturated_keys_ship_nothing():
    rows = saturation.rows(saturation.OUT)
    shipped = json.loads(FILE.read_text())
    for r in rows:
        if r.get("stage") != "confirmed" or r["verdict"] != "saturated":
            continue
        p1, p2 = r["mesh"]
        key = cache.plan_key(tuple(r["shape"]), "complex64", r["real"], p1,
                             p2, r["device_kind"], inverse=r["inverse"])
        assert key not in shipped, key


def test_export_is_local_only(on_h100, tmp_path):
    key = cache.plan_key((64,) * 3, "complex64", False, 1, 1, H100)
    cache.store(key, PlanParams(ry=7), perf=2e-3)
    wf = tmp_path / "wisdom.json"
    assert cache.export_wisdom(wf) == 1
    assert set(json.loads(wf.read_text())) == {key}


def test_cache_cli_lists_bundled_and_local(tmp_path):
    env = dict(os.environ, OFFT_TPU_TORCH_CACHE_DIR=str(tmp_path))
    out = subprocess.run([sys.executable, "-m", "offt_tpu_torch.plan.cache",
                          "list"], capture_output=True, text=True, env=env,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n = len(cache._bundled())
    assert f"# {n} bundled, 0 local" in out.stdout
    assert f"bundled  {M256}" in out.stdout


def test_bundled_plan_values_match_numpy(on_h100):
    """The one-card record, 192^3 r2c at its point, read by ``plan()`` on
    the CPU (the kernels' plain versions), against numpy.fft."""
    x = np.random.default_rng(0).standard_normal((192,) * 3).astype(
        np.float32)
    p = ot.plan((192,) * 3, "float32", real=True, planar=True, device="cpu")
    assert p.params.radix_z == (3, 32)
    yr, yi = p(torch.from_numpy(x))
    got = yr.numpy() + 1j * yi.numpy()
    want = np.fft.rfftn(x.astype(np.float64))
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < TOL


def _mesh_worker(rank: int, outdir: str) -> None:
    from offt_tpu_torch.dist import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(outdir, 'store')}",
        rank=rank, world_size=4, timeout=datetime.timedelta(seconds=120))
    try:
        os.environ["OFFT_TPU_TORCH_CACHE_DIR"] = os.path.join(outdir, "c")
        cache.device_kind = lambda device: H100
        mesh = make_mesh(2, 2, device_type="cpu")
        picked = ot.plan((256,) * 3, "complex64", mesh=mesh, planar=True,
                         device="cpu").params
        skipped = ot.plan((256,) * 3, "complex64", mesh=mesh, planar=True,
                          device="cpu", use_cache=False).params
        mine = PlanParams(p1=2, t1=2, t2=2)
        explicit = ot.plan((256,) * 3, "complex64", mesh=mesh, planar=True,
                           device="cpu", params=mine).params
        # the shipped point's numerics at a small shape: each rank's block
        # against numpy.fft.fftn of one global input
        shape = (32, 32, 32)
        at = ot.plan(shape, "complex64", mesh=mesh, planar=True,
                     device="cpu", params=picked)
        rng = np.random.default_rng(5)
        x = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
        blk = at.input_block(shape)
        yr, yi = at(torch.from_numpy(np.ascontiguousarray(x.real[blk])),
                    torch.from_numpy(np.ascontiguousarray(x.imag[blk])))
        want = np.fft.fftn(x.astype(np.complex128))[at.output_block(shape)]
        got = yr.numpy() + 1j * yi.numpy()
        err = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        with open(os.path.join(outdir, f"{rank}.json"), "w") as fh:
            json.dump([cache._params_to_json(p)
                       for p in (picked, skipped, explicit)] + [err], fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def test_mesh_plan_picks_bundled_wisdom(tmp_path):
    """plan(mesh=...) with no params reads the 2 x 2 entry the four-card
    sweep confirmed (the counterpart of test_dist_defaults.py); with
    use_cache=False or explicit params it does not. A plan at that point
    (p1 2, rankorder 1, v 2, one chunk a phase) at 32^3 agrees with
    numpy.fft.fftn on every rank's block within 1e-6."""
    torch.multiprocessing.spawn(_mesh_worker, args=(str(tmp_path),),
                                nprocs=4, join=True)
    want = cache._params_from_json(cache._bundled()[M256]["params"])
    dflt = default_params(ProblemSpec(shape=(256,) * 3, p=4), p1=2)
    for rank in range(4):
        *got, err = json.loads((tmp_path / f"{rank}.json").read_text())
        picked, skipped, explicit = (cache._params_from_json(d)
                                     for d in got)
        assert err < TOL, (rank, err)
        assert picked == want and picked != dflt
        assert skipped == dflt
        assert explicit == PlanParams(p1=2, t1=2, t2=2)
