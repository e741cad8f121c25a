"""offt_tpu_torch.obs: the event log and its viewer against offt_tpu's on
the same file, and the per-stage breakdowns on the CPU: fft3d_breakdown
on one device, pencil_breakdown (and fft3d_breakdown's mesh form) on a
spawned 4-rank gloo world of "cpu" meshes (tests/torch_world.py), and
the four-card script ``bench/mesh4.py`` rehearsed on four gloo ranks.
The breakdowns' times are host-clock seconds of synchronous calls there:
the tests hold their keys, their signs and their sums, not their
values."""

import datetime
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_world as tw

STAGES = ("fft_z", "exchange_1", "fft_y", "exchange_2", "fft_x")


def _log(path, EventLog):
    with EventLog(str(path)) as log:
        log.emit("trial", point=[0, 1], perf=0.002, status="ok")
        log.emit("trial", point=[1, 1], perf=0.001, status="ok")
        log.emit("trial", point=[0, 1], perf=0.002, status="duplicate")
        log.emit("trial", point=[9, 9], status="infeasible", reason="x")
        log.emit("trial_error", point=[2, 2], error="boom")
        log.emit("tune_done", best_perf=0.001, default_perf=0.002)


def test_event_log_round_trip(tmp_path):
    from offt_tpu_torch.obs import EventLog, read_events

    p = tmp_path / "sub" / "ev.jsonl"
    with EventLog(str(p), echo=False) as log:
        rec = log.emit("trial", point=[1, 2], perf=0.5)
        log.emit("tune_done", best_perf=0.5, shape=(1, 2))
    assert rec["kind"] == "trial" and rec["point"] == [1, 2]
    with open(p, "a") as fh:
        fh.write("not json\n\n")
    evs = read_events(str(p))
    assert [e["kind"] for e in evs] == ["trial", "tune_done"]
    assert evs[0]["point"] == [1, 2] and evs[1]["shape"] == [1, 2]


def test_summarize_matches_the_reference(tmp_path, capsys):
    from offt_tpu.obs.log import read_events as rread
    from offt_tpu.obs.view import summarize as rsummarize

    from offt_tpu_torch.obs import EventLog, read_events
    from offt_tpu_torch.obs.view import main, summarize

    p = tmp_path / "t.jsonl"
    _log(p, EventLog)
    assert read_events(str(p)) == rread(str(p))
    s = summarize(str(p))
    assert s == rsummarize(str(p))
    assert s["trials"] == 4 and s["ok"] == 2 and s["errors"] == 1
    assert s["best"][0]["point"] == [1, 1]
    assert main([str(p), "--top", "1"]) == 0
    assert "top 1 measured points" in capsys.readouterr().out
    assert main([str(p), "--json"]) == 0
    assert json.loads(capsys.readouterr().out) == json.loads(
        json.dumps(rsummarize(str(p), 5)))
    # the python -m entry point
    out = subprocess.run([sys.executable, "-m", "offt_tpu_torch.obs.view",
                          str(p), "--json"], capture_output=True, text=True,
                         check=True, cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__)))).stdout
    assert json.loads(out)["trials"] == 4


def test_fft3d_breakdown_on_the_cpu():
    from offt_tpu_torch.obs.profile import fft3d_breakdown

    bd = fft3d_breakdown((8, 16, 32), device="cpu")
    assert set(bd) == {"fft_z", "fft_y", "fft_x", "total_fused",
                       "stage_sum", "fusion_gain"}
    assert all(v > 0 for k, v in bd.items() if k != "fusion_gain")
    assert bd["stage_sum"] == bd["fft_z"] + bd["fft_y"] + bd["fft_x"]
    assert abs(bd["stage_sum"] - bd["fusion_gain"] - bd["total_fused"]) \
        < 1e-12


def test_breakdowns_need_their_device():
    from offt_tpu_torch.obs.profile import _seconds, time_cuda

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            time_cuda(lambda: None)
    with pytest.raises(ValueError):
        _seconds(torch.device("meta"))


def _worker(rank, outdir):
    from offt_tpu_torch.dist import make_mesh
    from offt_tpu_torch.obs.profile import fft3d_breakdown, pencil_breakdown

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(outdir, 'store')}",
        rank=rank, world_size=tw.WORLD,
        timeout=datetime.timedelta(seconds=120))
    try:
        out = {}
        for dims in ((2, 2), (1, 4)):
            mesh = make_mesh(*dims, device_type="cpu")
            out["pencil %dx%d" % dims] = pencil_breakdown((8, 16, 16), mesh)
            out["fft3d %dx%d" % dims] = fft3d_breakdown((8, 16, 16),
                                                        mesh=mesh)
        try:
            pencil_breakdown((6, 16, 16), make_mesh(4, 1, device_type="cpu"))
            out["refused"] = False
        except ValueError:
            out["refused"] = True
        with open(os.path.join(outdir, f"{rank}.json"), "w") as fh:
            json.dump(out, fh)
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("obs")
    tw.spawn(_worker, out)
    res = []
    for r in range(tw.WORLD):
        with open(os.path.join(out, f"{r}.json")) as fh:
            res.append(json.load(fh))
    return res


@pytest.mark.parametrize("dims", ["2x2", "1x4"])
def test_pencil_breakdown_on_a_cpu_mesh(world, dims):
    for res in world:
        bd = res["pencil " + dims]
        assert set(bd) == set(STAGES) | {"total_fused", "stage_sum",
                                         "overlap_gain"}
        assert all(bd[k] > 0 for k in STAGES + ("total_fused",))
        assert np.isclose(bd["stage_sum"], sum(bd[k] for k in STAGES),
                          rtol=1e-12)
        assert abs(bd["stage_sum"] - bd["overlap_gain"]
                   - bd["total_fused"]) < 1e-12
        assert list(res["fft3d " + dims]) == ["total_fused"]
        assert res["fft3d " + dims]["total_fused"] > 0
        assert res["refused"]


def test_mesh4_rehearses_on_a_gloo_world():
    """bench/mesh4.py's checks on four gloo ranks of the CPU at a small
    size (its card timings need CUDA): the long-1-D engine on a 2 x 2
    mesh against torch.fft on every rank, and the pencil breakdown; a
    failed check raises in its rank."""
    from offt_tpu_torch.bench import mesh4

    mesh4.run("gloo", "cpu", lengths=(4096,), cube=(8, 16, 16))
