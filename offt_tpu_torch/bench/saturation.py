"""Tuning-target saturation receipts on the card, and the bundled tuned
defaults they back: the port of ``docs/receipts/run_saturation.py``.

Per shape it asks whether the tuner beats the default point
(``plan/params.default_params``) by a margin the run-to-run jitter cannot
explain. It writes one JSONL row per stage to
``receipts_torch/saturation_h100.jsonl`` and ends with a verdict row:

  {key, shape, real, inverse, mesh, device_kind, default_ms, best_ms,
   spread, speedup, nm_best_ms, rand_best_ms, brute_best_ms,
   brute_points, space_size, best_params, verdict}

The verdict rules are the reference's: a speedup of 1.2 or more is a
``win``; a best within (1 + band) of the default, band = max(spread,
0.03), is ``saturated``; anything between is ``headroom``. Every trial is
timed by ``tune.tuner._default_timer`` (CUDA events, the median of 10
after 2 warm-up calls, on random inputs of the plan's block; the host
clock on the CPU), the searches by ``tune.tune`` (Nelder-Mead and
random), and the expert subset by the same timer over the corner of the
space that the default heuristic decides: the radices, ``block_batch``
and ``split_1d`` where the route reads them (``tune/space.py``; the
reference enumerates three block sizes everywhere, which the port's
register-core kernels do not read), and on a mesh the chunk counts
``t1`` x ``t2``.

Then three checks before anything ships:

1. ``confirm``: the best point against the default point in one
   process, interleaved (d, b, d, b, d, b; median of each); its verdict
   by the same rules. A best point equal to the default point is
   ``saturated`` by construction and is not re-timed.
2. ``recheck``: in a fresh process, the default point's plan and the
   best point's plan, each timed by the median of 20 CUDA-event calls
   after 3 warm-up calls. The sweep spawns three such processes a key
   whose confirmed verdict is ``win`` or ``headroom``.
3. ``ship``: writes ``offt_tpu_torch/plan/tuned_defaults.json`` with
   every key whose confirmed verdict is ``win`` or ``headroom`` and
   whose rechecks (three or more processes) hold: the best point's
   slowest median beats the default's fastest. Its ``perf`` is the
   median of the best point's medians, in seconds; its key is
   ``plan/cache.plan_key`` with the device kind the rows were measured
   on. A ``saturated`` key ships nothing.

The file is resumable as the reference's is: a key with a verdict row is
skipped unless ``--redo``. Run from the repository root on a card:

    python -m offt_tpu_torch.bench.saturation              # every 1 x 1 key
    python -m offt_tpu_torch.bench.saturation --only r192,1d_np2
    python -m offt_tpu_torch.bench.saturation --ship       # rewrite the JSON

and on four cards (NCCL; the three rechecks are three worlds):

    torchrun --nproc_per_node 4 -m offt_tpu_torch.bench.saturation --mesh
    for i in 1 2 3; do torchrun --nproc_per_node 4 \\
        -m offt_tpu_torch.bench.saturation --mesh --recheck m256_2x2; done
    python -m offt_tpu_torch.bench.saturation --ship

``--device cpu`` runs the same on the host (gloo under ``torchrun``),
for a rehearsal; it ships nothing, since host ("cpu") rows never ship.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
OUT = os.path.join(REPO, "receipts_torch", "saturation_h100.jsonl")
BUNDLE = os.path.join(REPO, "offt_tpu_torch", "plan", "tuned_defaults.json")

# key: (shape, real, inverse, NM trials, random trials), in sweep order
SHAPES = {
    "r192": ((192, 192, 192), True, False, 30, 24),
    "1d_np2": ((1, 1, 3 * (1 << 18)), False, False, 24, 16),
    "slab": ((64, 1024, 1024), False, False, 24, 16),
    "256": ((256, 256, 256), False, False, 30, 24),
    "256inv": ((256, 256, 256), False, True, 30, 24),
    "320": ((320, 320, 320), False, False, 30, 24),
    "320inv": ((320, 320, 320), False, True, 30, 24),
    "512": ((512, 512, 512), False, False, 24, 16),
    "512inv": ((512, 512, 512), False, True, 24, 16),
    "r256": ((256, 256, 256), True, False, 30, 24),
    "r256inv": ((256, 256, 256), True, True, 30, 24),
    "r512": ((512, 512, 512), True, False, 24, 16),
    "r512inv": ((512, 512, 512), True, True, 24, 16),
    "1d20": ((1, 1, 1 << 20), False, False, 30, 24),
    "r1024": ((1024, 1024, 1024), True, False, 8, 8),
    "r1024inv": ((1024, 1024, 1024), True, True, 8, 8),
    "768": ((768, 768, 768), False, False, 8, 8),
    "128x512x512": ((128, 512, 512), False, False, 24, 16),
    "512x256x256": ((512, 256, 256), False, False, 24, 16),
    "256x256x512": ((256, 256, 512), False, False, 24, 16),
}
# swept on a 2 x 2 mesh of four cards under torchrun (--mesh)
MESH_SHAPES = {
    "m256_2x2": ((256, 256, 256), False, False, 30, 24),
}
MESH = (2, 2)
RECHECKS = 3          # fresh processes a shipped key is re-timed in
RECHECK_REPS = 20     # CUDA-event calls a process, the median kept
WIN, BAND_FLOOR = 1.2, 0.03


def _rank0() -> bool:
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _decide(make):
    """Rank 0's ``make()``, the same object on every rank of the world
    (``make()`` alone without one). Only rank 0 writes the receipt file,
    so only rank 0 reads it back to decide what the world does next: a
    rank that read it itself could run ahead of rank 0's append and leave
    rank 0 alone in a collective."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return make()
    box = [make() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def log(row: dict, out: str) -> None:
    """Append ``row`` to ``out`` (rank 0 alone) and print it."""
    if not _rank0():
        return
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "a") as fh:
        fh.write(json.dumps(row) + "\n")
    print(json.dumps(row), flush=True)


def rows(out: str) -> list:
    if not os.path.exists(out):
        return []
    got = []
    with open(out) as fh:
        for ln in fh:
            try:
                got.append(json.loads(ln))
            except ValueError:
                continue
    return got


def done_keys(out: str) -> set:
    return {r.get("key") for r in rows(out) if r.get("stage") == "verdict"}


def verdict_of(speedup: float, spread: float) -> str:
    """The reference's rules: win at 1.2x or more; saturated within
    (1 + band) of the default, band = max(spread, 3%); else headroom."""
    if speedup >= WIN:
        return "win"
    if speedup <= 1.0 + max(spread, BAND_FLOOR):
        return "saturated"
    return "headroom"


def _spec(shape, real, inverse, p=1):
    from ..plan.params import ProblemSpec
    return ProblemSpec(shape=tuple(shape), dtype="complex64", real=real,
                       inverse=inverse, p=p)


def expert_points(shape, real=False, inverse=False, mesh=None,
                  device=None) -> list:
    """The corner of the space the default heuristic decides, everything
    else at the default point: on one device the radices of each axis the
    route reads them on x ``block_batch`` x ``split_1d`` (each from the
    space, the default's value where the space has none); on a mesh the
    chunk counts t1 x t2 in {1, 2, 4}. At most 18 feasible points."""
    from ..dist import mesh as meshlib
    from ..plan.params import infeasible_reason
    from ..tune.space import build_space

    p1 = p = 1
    if mesh is not None:
        p1, p2 = meshlib.mesh_shape(mesh)
        p = p1 * p2
    spec = _spec(shape, real, inverse, p)
    space = build_space(spec, fixed_p1=p1 if mesh is not None else None,
                        include_pallas=True, device=device)
    dflt = space.base
    by_name = {d.name: d.values for d in space.dims}
    pts = []
    if mesh is not None:
        for t1 in (1, 2, 4):
            for t2 in (1, 2, 4):
                pts.append(dflt.replace(t1=t1, t2=t2))
    else:
        for rz in by_name.get("radix_z", (dflt.radix_z,))[:6]:
            for blk in by_name.get("block_batch", (dflt.block_batch,))[:3]:
                for s1d in by_name.get("split_1d", (dflt.split_1d,))[:4]:
                    pts.append(dflt.replace(radix_z=rz, block_batch=blk,
                                            split_1d=s1d))
    out = []
    for q in pts:
        if infeasible_reason(spec, q) is None and q not in out:
            out.append(q)
    return out[:18]


def _max_ranks(x: float) -> float:
    """The largest of ``x`` over the ranks of the world (``x`` alone
    without one): a mesh transform's time."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return x
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([x], dtype=torch.float64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _build(shape, real, inverse, params, mesh, device):
    from ..plan.api import plan
    return plan(shape, "complex64", mesh=mesh, real=real, inverse=inverse,
                params=params, use_cache=False, planar=True, device=device)


def _params_json(p) -> dict:
    from ..plan.cache import _params_to_json
    return _params_to_json(p)


def run_shape(key, shape, real, inverse, nm_trials, rand_trials, *,
              out=OUT, mesh=None, device=None, logdir=None) -> dict:
    """Sweep one shape and append its rows; returns the verdict row."""
    from ..dist import mesh as meshlib
    from ..plan import cache
    from ..plan.api import _mesh_device
    from ..tune.space import build_space
    from ..tune.tuner import _default_timer, tune

    t0 = time.time()
    if mesh is not None:
        dev = _mesh_device(mesh, device)
        p1, p2 = meshlib.mesh_shape(mesh)
    else:
        dev = torch.device("cuda" if device is None else device)
        p1 = p2 = 1
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    timer = _default_timer()

    def timed(pl) -> float:
        return _max_ranks(timer(pl))

    spec = _spec(shape, real, inverse, p1 * p2)
    space = build_space(spec, fixed_p1=p1 if mesh is not None else None,
                        include_pallas=True, device=dev)
    dflt = space.base
    kind = cache.device_kind(dev)
    base = {"key": key, "shape": list(shape), "real": real,
            "inverse": inverse, "mesh": [p1, p2], "device_kind": kind}

    # two independent draws of the default point: the jitter band (after
    # one discarded draw, which pays the process's first-call costs)
    dpl = _build(shape, real, inverse, dflt, mesh, dev)
    timed(dpl)
    d1, d2 = timed(dpl), timed(dpl)
    del dpl
    spread = abs(d1 - d2) / max(min(d1, d2), 1e-12)
    log({**base, "stage": "default", "ms": [d1 * 1e3, d2 * 1e3],
         "spread": spread, "space_size": space.size(),
         "t": time.strftime("%Y-%m-%dT%H:%M:%S")}, out)

    def search(strategy, trials, seed):
        lp = None
        if logdir:
            lp = os.path.join(logdir, f"sat_{key}_{strategy}.jsonl")
        return tune(shape, "complex64", mesh=mesh, real=real,
                    inverse=inverse, strategy=strategy, max_trials=trials,
                    save=False, seed=seed, log_path=lp, device=dev,
                    include_pallas=True)

    res_nm = search("nm", nm_trials, 0)
    log({**base, "stage": "nm", "best_ms": res_nm.best_perf * 1e3,
         "default_ms": res_nm.default_perf * 1e3,
         "trials": len(res_nm.trials),
         "best_params": _params_json(res_nm.best_params)}, out)
    res_rd = search("random", rand_trials, 5)
    log({**base, "stage": "random", "best_ms": res_rd.best_perf * 1e3,
         "trials": len(res_rd.trials),
         "best_params": _params_json(res_rd.best_params)}, out)

    brute_best, brute_pt, brute_n = math.inf, None, 0
    for q in expert_points(shape, real, inverse, mesh, dev):
        try:
            pl = _build(shape, real, inverse, q, mesh, dev)
            sec = timed(pl)
            del pl
        except Exception as e:      # an infeasible build or launch: noted
            log({**base, "stage": "brute_err", "params": _params_json(q),
                 "error": repr(e)[:200]}, out)
            continue
        brute_n += 1
        if sec < brute_best:
            brute_best, brute_pt = sec, q
        log({**base, "stage": "brute", "ms": sec * 1e3,
             "params": _params_json(q)}, out)

    default_s = min(d1, d2, res_nm.default_perf)
    cands = [(res_nm.best_perf, res_nm.best_params),
             (res_rd.best_perf, res_rd.best_params)]
    if brute_pt is not None:
        cands.append((brute_best, brute_pt))
    best_s, best_p = min(cands, key=lambda c: c[0])
    if best_s >= default_s:
        best_s, best_p = default_s, dflt
    speedup = default_s / best_s if best_s > 0 else 0.0
    row = {**base, "stage": "verdict", "verdict": verdict_of(speedup, spread),
           "speedup": round(speedup, 4), "default_ms": default_s * 1e3,
           "best_ms": best_s * 1e3, "spread": round(spread, 4),
           "nm_best_ms": res_nm.best_perf * 1e3,
           "rand_best_ms": res_rd.best_perf * 1e3,
           "brute_best_ms": brute_best * 1e3 if brute_n else None,
           "brute_points": brute_n, "space_size": space.size(),
           "best_params": _params_json(best_p),
           "best_is_default": best_p == dflt,
           "default_params": _params_json(dflt),
           "wall_s": round(time.time() - t0, 1),
           "t": time.strftime("%Y-%m-%dT%H:%M:%S")}
    log(row, out)
    return row


def _latest(out: str, key: str, stage: str):
    got = [r for r in rows(out) if r.get("key") == key
           and r.get("stage") == stage]
    return got[-1] if got else None


def _plans_of(verdict: dict, mesh, device):
    from ..plan.cache import _params_from_json
    shape, real, inv = (tuple(verdict["shape"]), verdict["real"],
                        verdict["inverse"])
    dflt = _params_from_json(verdict["default_params"])
    best = _params_from_json(verdict["best_params"])
    return (_build(shape, real, inv, dflt, mesh, device),
            _build(shape, real, inv, best, mesh, device))


def confirm(keys, *, out=OUT, mesh=None, device=None) -> list:
    """Re-time each key's best point against its default point in this
    process, interleaved; one ``confirmed`` row a key."""
    from ..tune.tuner import _default_timer

    timer = _default_timer()
    done = []
    for key in keys:
        v = _decide(lambda: _latest(out, key, "verdict"))
        if v is None:
            print(f"# {key}: no verdict row", flush=True)
            continue
        base = {k: v[k] for k in ("key", "shape", "real", "inverse", "mesh",
                                  "device_kind")}
        if v["best_is_default"]:
            row = {**base, "stage": "confirmed", "verdict": "saturated",
                   "speedup": 1.0, "raw_verdict": v["verdict"],
                   "best_params": v["best_params"],
                   "note": "best point == default point; not re-timed"}
        else:
            dpl, bpl = _plans_of(v, mesh, device)
            ds, bs = [], []
            for _ in range(3):
                ds.append(_max_ranks(timer(dpl)))
                bs.append(_max_ranks(timer(bpl)))
            del dpl, bpl
            dm, bm = statistics.median(ds), statistics.median(bs)
            speedup = dm / bm if bm > 0 else 0.0
            spread = (max(ds) - min(ds)) / max(min(ds), 1e-12)
            row = {**base, "stage": "confirmed",
                   "verdict": verdict_of(speedup, spread),
                   "speedup": round(speedup, 4),
                   "default_ms_draws": [d * 1e3 for d in ds],
                   "best_ms_draws": [b * 1e3 for b in bs],
                   "default_ms": dm * 1e3, "best_ms": bm * 1e3,
                   "spread": round(spread, 4), "raw_verdict": v["verdict"],
                   "best_params": v["best_params"]}
        row["t"] = time.strftime("%Y-%m-%dT%H:%M:%S")
        log(row, out)
        done.append(row)
    return done


def _median_s(pl, device) -> float:
    from ..obs.profile import time_cuda, time_host
    from ..tune.tuner import plan_inputs
    args = plan_inputs(pl)
    if device.type == "cuda":
        sec = time_cuda(pl, args, warmup=3,
                        reps=RECHECK_REPS)["median_ms"] / 1e3
    else:
        sec = time_host(pl, args, warmup=1, reps=RECHECK_REPS)
    return _max_ranks(sec)


def recheck(key, *, out=OUT, mesh=None, device=None) -> dict:
    """Time the key's default point and best point in this (fresh)
    process, each the median of 20 calls; one ``recheck`` row."""
    v = _decide(lambda: _latest(out, key, "verdict"))
    if v is None:
        raise SystemExit(f"{key}: no verdict row in {out}")
    dpl, bpl = _plans_of(v, mesh, device)
    dev = dpl.device
    order = []
    for name, pl in (("default", dpl), ("best", bpl), ("default", dpl),
                     ("best", bpl)):
        order.append((name, _median_s(pl, dev)))
    # the second draw of each: both plans warm, their kernels loaded
    d = order[2][1]
    b = order[3][1]
    row = {"key": key, "stage": "recheck", "pid": os.getpid(),
           "device_kind": v["device_kind"], "default_ms": d * 1e3,
           "best_ms": b * 1e3, "reps": RECHECK_REPS,
           "t": time.strftime("%Y-%m-%dT%H:%M:%S")}
    log(row, out)
    return row


def shippable(out=OUT) -> dict:
    """{plan key: bundled record} of every key whose confirmed verdict is
    win or headroom and whose rechecks hold (module doc); rows measured
    on the host ("cpu") never ship."""
    from ..plan.cache import plan_key
    db = {}
    for key in dict.fromkeys(r.get("key") for r in rows(out)):
        c = _latest(out, key, "confirmed")
        if c is None or c["verdict"] not in ("win", "headroom"):
            continue
        if c["device_kind"] == "cpu":
            continue
        got = [r for r in rows(out) if r.get("key") == key
               and r.get("stage") == "recheck"]
        if len(got) < RECHECKS:
            continue
        if (max(r["best_ms"] for r in got)
                >= min(r["default_ms"] for r in got)):
            continue
        p1, p2 = c["mesh"]
        k = plan_key(tuple(c["shape"]), "complex64", c["real"], p1, p2,
                     c["device_kind"], inverse=c["inverse"])
        db[k] = {"params": c["best_params"],
                 "perf": statistics.median(r["best_ms"] for r in got) / 1e3}
    return db


def ship(out=OUT, bundle=BUNDLE) -> dict:
    """Write ``bundle`` from :func:`shippable`; returns it."""
    db = shippable(out)
    with open(bundle, "w") as fh:
        json.dump(db, fh, indent=1, sort_keys=True)
        fh.write("\n")
    print(f"shipped {len(db)} entries -> {bundle}", flush=True)
    return db


def _mesh_world(device_type: str):
    """The 2 x 2 mesh in torchrun's world (initialised here)."""
    import torch.distributed as dist

    from ..dist import make_mesh
    if not dist.is_initialized():
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                init_method="env://")
    return make_mesh(*MESH, device_type=device_type)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m offt_tpu_torch.bench.saturation",
        description="tuning saturation receipts and the bundled defaults")
    ap.add_argument("--only", help="comma-separated keys")
    ap.add_argument("--redo", action="store_true",
                    help="sweep keys that already have a verdict")
    ap.add_argument("--mesh", action="store_true",
                    help="the 2 x 2 keys, under torchrun (four ranks)")
    ap.add_argument("--confirm", action="store_true",
                    help="only confirm the keys' verdicts")
    ap.add_argument("--recheck", metavar="KEY",
                    help="time KEY's default and best point in this "
                         "process")
    ap.add_argument("--ship", action="store_true",
                    help="only write the bundled defaults")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--bundle", default=BUNDLE)
    ns = ap.parse_args(argv)
    if ns.ship:
        ship(ns.out, ns.bundle)
        return 0
    if ns.device == "cuda" and not torch.cuda.is_available():
        print("saturation needs a CUDA device (or --device cpu)",
              file=sys.stderr)
        return 2
    device = torch.device(ns.device)
    mesh = _mesh_world(device.type) if ns.mesh else None
    try:
        return _sweep(ns, device, mesh)
    finally:
        if mesh is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def _sweep(ns, device, mesh) -> int:
    """The CLI's run after its world is up (module doc)."""
    table = MESH_SHAPES if ns.mesh else SHAPES
    keys = [k for k in table if not ns.only or k in ns.only.split(",")]
    if _rank0():
        from .runfft import device_label
        print(f"# {device_label(device)}", flush=True)
    if device.type == "cuda":
        from ..kernels import _build
        _build.library()
    if ns.recheck:
        recheck(ns.recheck, out=ns.out, mesh=mesh, device=device)
        return 0
    if not ns.confirm:
        skip = set() if ns.redo else _decide(lambda: done_keys(ns.out))
        for key in keys:
            if key in skip:
                if _rank0():
                    print(f"# {key}: already receipted, skipping",
                          flush=True)
                continue
            shape, real, inv, nm_n, rd_n = table[key]
            run_shape(key, shape, real, inv, nm_n, rd_n, out=ns.out,
                      mesh=mesh, device=device,
                      logdir=os.path.dirname(ns.out))
            if device.type == "cuda":
                torch.cuda.empty_cache()
    if not (ns.confirm or ns.redo):
        have = _decide(lambda: {r["key"] for r in rows(ns.out)
                                if r["stage"] == "confirmed"})
        keys = [k for k in keys if k not in have]
    confirmed = confirm(keys, out=ns.out, mesh=mesh, device=device)
    if ns.mesh:
        if _rank0():
            print("SATURATION DONE (recheck each shippable key in three "
                  "fresh worlds: --mesh --recheck KEY)", flush=True)
        return 0
    for row in confirmed:
        if row["verdict"] not in ("win", "headroom"):
            continue
        for _ in range(RECHECKS):
            subprocess.run([sys.executable, "-m",
                            "offt_tpu_torch.bench.saturation", "--recheck",
                            row["key"], "--device", ns.device, "--out",
                            ns.out], check=True, cwd=REPO)
    if device.type == "cuda":
        ship(ns.out, ns.bundle)
    print("SATURATION DONE", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
