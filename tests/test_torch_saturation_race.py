"""The 2 x 2 saturation sweep keeps its ranks in step when rank 0's
receipt writes lag (offt_tpu_torch/bench/saturation.py).

Rank 0 alone appends the receipt rows; what the world does next (which
keys to sweep, which verdict to confirm, whether confirm re-times) must
come from rank 0 to every rank, not from each rank reading the file. The
worker delays rank 0's verdict write and turns its verdict into one whose
best point is not the default point, so that rank 0's confirm re-times
both plans: collectives on the mesh. A rank that decided from the file
would find no verdict row yet, skip its confirm, and leave rank 0 alone
in those collectives until the world's 30 s timeout."""

import datetime
import os
import time

import torch
import torch.distributed as dist

from offt_tpu_torch.bench import saturation as sat
from offt_tpu_torch.plan import cache

LAG_S = 3.0


def _lagging_log(orig):
    def log(row, out):
        if row.get("stage") == "verdict":
            dflt = cache._params_from_json(row["default_params"])
            best = dflt.replace(t1=1 if dflt.t1 != 1 else 2)
            row = {**row, "best_is_default": False,
                   "best_params": cache._params_to_json(best)}
            time.sleep(LAG_S)
        orig(row, out)
    return log


def _race_worker(rank: int, tmp: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(tmp, 'store')}",
        rank=rank, world_size=4, timeout=datetime.timedelta(seconds=30))
    sat.MESH_SHAPES = {"m16_2x2": ((16, 16, 16), False, False, 3, 2)}
    if rank == 0:
        sat.log = _lagging_log(sat.log)
    assert sat.main(["--mesh", "--device", "cpu", "--out",
                     os.path.join(tmp, "s.jsonl")]) == 0


def test_mesh_sweep_ranks_wait_for_rank0_verdict(tmp_path):
    """Every rank confirms rank 0's (lagging) verdict: the confirm row
    holds the interleaved draws of both plans, timed on the whole mesh."""
    torch.multiprocessing.spawn(_race_worker, args=(str(tmp_path),),
                                nprocs=4, join=True)
    rows = sat.rows(str(tmp_path / "s.jsonl"))
    verdict = next(r for r in rows if r["stage"] == "verdict")
    assert verdict["best_is_default"] is False
    conf = [r for r in rows if r["stage"] == "confirmed"]
    assert len(conf) == 1 and conf[0]["key"] == "m16_2x2"
    assert len(conf[0]["default_ms_draws"]) == 3
    assert len(conf[0]["best_ms_draws"]) == 3
    assert conf[0]["best_params"] == verdict["best_params"]
