"""Host wall time of the port's forward calls, where the host paces them.

A plan call that nothing differentiates runs its transform alone; one
that autograd tracks goes through the ``torch.autograd.Function`` of its
calling convention (``plan/autodiff.py``), whose dispatch is host time.
This times, on the card, each forward path whose device time is short
against its host time, and a device-bound control: the long 1-D plans
(2^20, 8 x 2^20, 2^22), the 256^3 planar c2c, the 1 x 1 mesh's 256^3 c2c
and packed c2r (a world of one rank on NCCL), the ``numpy.fft``
namespace's prime ``fft`` (1,000,003), ``fftn`` and ``irfftn`` of 256^3,
and the first and second one-shot ``fft3d`` of 256^3 (the first builds the
plan). Every row is the host wall per call of back-to-back calls,
synchronised at the end of each batch: median, quartiles, min and max
over ``ROUNDS`` batches of ``CALLS`` calls. A plan row has three variants
where the tree has them: ``call`` (the call as shipped), ``function``
(forced through the Function) and ``execute`` (the transform alone,
``Plan._execute``, without the call's checks); a path's variants take
their batches in turn, round by round, so that the host's drift falls on
each alike.

``--root`` names the checkout whose ``offt_tpu_torch`` is timed, so that
two trees compare on one card in processes that take turns (parent,
change, change, parent, ...)::

    python offt_tpu_torch/bench/call_overhead.py [--root DIR] [--tag NAME]

One JSON line a row; the card's name and power limit come first.
``--summary FILE`` reads such lines, tags ``tree:run``, and prints for
each path and variant each tree's median of its runs' medians, the
spread between its runs (the distance between their quartiles) and the
run medians themselves.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

CALLS = 40
ROUNDS = 15
ONE_SHOT_REPS = 5


def summary(v) -> dict:
    q = statistics.quantiles(v, n=4)
    return {"median_ms": statistics.median(v), "q1_ms": q[0], "q3_ms": q[2],
            "min_ms": min(v), "max_ms": max(v), "n": len(v)}


def walls(fns: dict) -> dict:
    """Host wall ms per call of each ``fns[name]()``, in batches of
    back-to-back calls, each batch synchronised at its end, the names
    taking their batches in turn."""
    import torch
    for fn in fns.values():
        for _ in range(5):
            fn()
    torch.cuda.synchronize()
    per = {name: [] for name in fns}
    for _ in range(ROUNDS):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
            per[name].append((time.perf_counter() - t0) / CALLS * 1e3)
    return {name: summary(v) for name, v in per.items()}


def summarize(path: str) -> None:
    """Each tree's runs of each path and variant (``--summary``)."""
    runs: dict = {}
    for line in open(path):
        if line.startswith("{"):
            r = json.loads(line)
            key = (r["path"], r["variant"], r["tree"].split(":")[0])
            runs.setdefault(key, []).append(r["median_ms"])
    for (p, variant, tree), v in sorted(runs.items()):
        q = statistics.quantiles(v, n=4) if len(v) > 1 else (v[0],) * 3
        print(f"{p} | {variant} | {tree}: median {statistics.median(v):.4f}"
              f" ms, spread {q[2] - q[0]:.4f}, runs "
              + " ".join(f"{x:.4f}" for x in v))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    ap.add_argument("--tag", default="")
    ap.add_argument("--summary", metavar="FILE")
    args = ap.parse_args(argv)
    if args.summary:
        summarize(args.summary)
        return 0
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.distributed as dist
    if not torch.cuda.is_available():
        print("call_overhead needs a CUDA device", file=sys.stderr)
        return 2
    import offt_tpu_torch as ot
    from offt_tpu_torch.plan import api
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(card, flush=True)
    autodiff = getattr(api, "autodiff", None)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, dtype=dtype, generator=gen, device="cuda")

    def row(path, variant, r):
        print(json.dumps({"tree": args.tag, "path": path,
                          "variant": variant, **r, "card": card}),
              flush=True)

    def rows(path, fns):
        for variant, r in walls(fns).items():
            row(path, variant, r)

    def plan_rows(path, p, xs):
        fns = {"call": lambda: p(*xs)}
        if autodiff is not None:
            fn = autodiff.function_of(p)
            fns["function"] = lambda: fn.apply(p, *xs)
            fns["execute"] = lambda: p._execute(tuple(xs))
        rows(path, fns)

    cube = (256, 256, 256)
    for label, batch in (("2^20", ()), ("8x2^20", (8,)), ("2^22", ())):
        n = 2 ** 22 if label == "2^22" else 2 ** 20
        p = ot.plan((1, 1, n), "complex64", planar=True,
                    batch_dims=len(batch))
        plan_rows(f"plan {label}", p,
                  (rnd(batch + (1, 1, n)), rnd(batch + (1, 1, n))))
        del p
    p = ot.plan(cube, "complex64", planar=True)
    plan_rows("plan 256^3 c2c", p, (rnd(cube), rnd(cube)))
    del p
    z = rnd((1000003,), torch.complex64)
    rows("namespace fft 1000003", {"call": lambda: ot.fft.fft(z)})
    z = rnd(cube, torch.complex64)
    rows("namespace fftn 256^3", {"call": lambda: ot.fft.fftn(z)})
    zh = torch.fft.rfftn(rnd(cube))
    rows("namespace irfftn 256^3",
         {"call": lambda: ot.fft.irfftn(zh, s=cube)})
    first, second = [], []
    for _ in range(ONE_SHOT_REPS):
        api._ONE_SHOT.clear()
        for out in (first, second):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ot.fft3d(z)
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t0) * 1e3)
    for name, v in (("first", first), ("second", second)):
        row(f"one-shot fft3d 256^3 {name}", "call", summary(v))
    del z, zh
    # a world of one rank on NCCL, as chip_smoke.py's phase 3e makes it
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = ot.make_mesh(1, 1)
        p = ot.plan(cube, "complex64", mesh=mesh, planar=True)
        plan_rows("mesh 1x1 c2c 256^3", p, (rnd(cube), rnd(cube)))
        p = ot.plan(cube, "float32", mesh=mesh, real=True, inverse=True,
                    planar=True, packed=True)
        plan_rows("mesh 1x1 packed c2r 256^3", p,
                  (rnd(p.in_shape), rnd(p.in_shape)))
        del p
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
