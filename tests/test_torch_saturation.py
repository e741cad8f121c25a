"""The saturation receipts (offt_tpu_torch/bench/saturation.py, the
port of docs/receipts/run_saturation.py) rehearsed on the CPU at small
shapes: the verdict rules, the expert subset, a sweep with its confirm,
three rechecks in fresh processes, the ship filter (host rows never
ship) and the 2 x 2 sweep on a 4-rank gloo world."""

import datetime
import json
import os

import pytest
import torch
import torch.distributed as dist

from offt_tpu_torch.bench import saturation as sat
from offt_tpu_torch.plan import cache
from offt_tpu_torch.plan.params import ProblemSpec, default_params


@pytest.mark.parametrize("speedup,spread,verdict", [
    (1.2, 0.0, "win"), (2.0, 0.5, "win"), (1.03, 0.0, "saturated"),
    (1.05, 0.06, "saturated"), (1.0, 0.0, "saturated"),
    (1.1, 0.02, "headroom"), (1.19, 0.1, "headroom")])
def test_verdict_rules(speedup, spread, verdict):
    assert sat.verdict_of(speedup, spread) == verdict


def test_expert_points_follow_the_space():
    # rfft_last at M = 72 on the dense core, the axes of 160 on the
    # register core: the radices of z alone
    pts = sat.expert_points((160, 160, 144), real=True, device="cuda")
    dflt = default_params(ProblemSpec(shape=(160, 160, 144), real=True))
    assert dflt in pts and len(pts) == 6
    assert {None, (72,)} <= {p.radix_z for p in pts}
    # every axis on the register core (192^3 r2c: rfft_last at M = 96 on
    # the mixed real rows): nothing to vary
    for shape, real in (((256,) * 3, False), ((192,) * 3, True)):
        assert sat.expert_points(shape, real=real, device="cuda") == [
            default_params(ProblemSpec(shape=shape, real=real))]
    split = sat.expert_points((1, 1, 3 << 18), device="cuda")
    # 3 block sizes x 4 splits (radix_z is not searched there)
    assert len(split) == 12 and len({p.split_1d for p in split}) == 4


def test_shapes_in_sweep_order():
    keys = list(sat.SHAPES)
    assert keys[:3] == ["r192", "1d_np2", "slab"]
    assert keys.index("1d20") > keys.index("r512inv")
    assert list(sat.MESH_SHAPES) == ["m256_2x2"]


def test_sweep_confirm_recheck_ship(tmp_path, monkeypatch):
    """The CLI on the CPU over two tiny keys: every stage's rows, three
    recheck processes for a confirmed win, and nothing shipped from the
    host."""
    monkeypatch.setattr(sat, "SHAPES", {
        "t16": ((16, 16, 16), True, False, 4, 3),
        "t1d": ((1, 1, 1 << 14), False, False, 4, 3)})
    out = tmp_path / "s.jsonl"
    bundle = tmp_path / "b.json"
    assert sat.main(["--device", "cpu", "--out", str(out), "--bundle",
                     str(bundle)]) == 0
    rows = sat.rows(str(out))
    for key in ("t16", "t1d"):
        stages = [r["stage"] for r in rows if r.get("key") == key]
        assert stages[0] == "default" and "verdict" in stages
        assert "confirmed" in stages and stages.index("confirmed") > \
            stages.index("verdict")
    for r in rows:
        if r.get("stage") == "confirmed" and r["verdict"] != "saturated":
            n = sum(1 for q in rows if q.get("stage") == "recheck"
                    and q["key"] == r["key"])
            assert n == sat.RECHECKS, r["key"]
    assert not bundle.exists()
    assert sat.shippable(str(out)) == {}
    # resumable: a second run sweeps nothing again
    n_before = len(rows)
    assert sat.main(["--device", "cpu", "--out", str(out), "--bundle",
                     str(bundle)]) == 0
    assert len(sat.rows(str(out))) == n_before


def test_ship_writes_checked_keys(tmp_path):
    """A confirmed win ships when its rechecks hold and not when one
    recheck's best is slower than another's default; saturated never;
    host rows never."""
    out = tmp_path / "s.jsonl"
    h100 = "NVIDIA H100 80GB HBM3"
    base = {"shape": [16, 16, 16], "real": False, "inverse": False,
            "mesh": [1, 1], "device_kind": h100}
    best = cache._params_to_json(
        default_params(ProblemSpec(shape=(16,) * 3)).replace(block_batch=128))
    rows = [
        {**base, "key": "a", "stage": "confirmed", "verdict": "win",
         "best_params": best},
        *({"key": "a", "stage": "recheck", "default_ms": d, "best_ms": b}
          for d, b in ((2.0, 1.0), (2.1, 1.1), (1.9, 1.2))),
        {**base, "shape": [8, 8, 8], "key": "b", "stage": "confirmed",
         "verdict": "headroom", "best_params": best},
        *({"key": "b", "stage": "recheck", "default_ms": d, "best_ms": b}
          for d, b in ((2.0, 1.0), (2.1, 2.05), (1.9, 1.2))),
        {**base, "shape": [4, 4, 4], "key": "c", "stage": "confirmed",
         "verdict": "saturated", "best_params": best},
        {**base, "shape": [8, 8, 16], "device_kind": "cpu", "key": "d",
         "stage": "confirmed", "verdict": "win", "best_params": best},
        *({"key": "d", "stage": "recheck", "default_ms": d, "best_ms": b}
          for d, b in ((2.0, 1.0), (2.1, 1.1), (1.9, 1.2))),
    ]
    out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    db = sat.ship(str(out), str(tmp_path / "b.json"))
    key = cache.plan_key((16,) * 3, "complex64", False, 1, 1, h100)
    assert list(db) == [key]
    assert db[key]["perf"] == pytest.approx(1.1e-3)
    assert json.loads((tmp_path / "b.json").read_text()) == db
    assert sat.shippable(str(out)) == db


def test_cli_needs_a_card_unless_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert sat.main(["--out", str(tmp_path / "s.jsonl")]) == 2


def _mesh_worker(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=4, timeout=datetime.timedelta(seconds=120))
    sat.MESH_SHAPES = {"m16_2x2": ((16, 16, 16), False, False, 4, 3)}
    # main() sweeps in this world and destroys it at the end
    assert sat.main(["--mesh", "--device", "cpu", "--out",
                     os.path.join(tmp, "s.jsonl")]) == 0


def test_mesh_sweep_on_a_gloo_world(tmp_path):
    """--mesh on four gloo ranks at 16^3 on 2 x 2 (MESH_SHAPES patched in
    each rank): rank 0 alone writes the rows, every stage of the sweep
    and its confirm, on the 2 x 2 mesh; nothing ships."""
    torch.multiprocessing.spawn(_mesh_worker, args=(str(tmp_path),),
                                nprocs=4, join=True)
    rows = sat.rows(str(tmp_path / "s.jsonl"))
    stages = [r["stage"] for r in rows]
    assert stages[:3] == ["default", "nm", "random"]
    assert stages.count("verdict") == stages.count("confirmed") == 1
    assert stages.index("confirmed") > stages.index("verdict")
    assert {r["key"] for r in rows} == {"m16_2x2"}
    verdict = next(r for r in rows if r["stage"] == "verdict")
    assert verdict["mesh"] == [2, 2] and verdict["device_kind"] == "cpu"
    # the expert corner on a mesh: the chunk counts t1 x t2 in {1, 2, 4}
    brute = [r["params"] for r in rows if r["stage"] == "brute"]
    assert verdict["brute_points"] == len(brute) > 0
    assert {(p["t1"], p["t2"]) for p in brute} <= {
        (a, b) for a in (1, 2, 4) for b in (1, 2, 4)}
    assert sat.shippable(str(tmp_path / "s.jsonl")) == {}
