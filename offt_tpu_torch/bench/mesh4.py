"""The distributed engines over NCCL on four cards of one host.

Run from the repository root on a machine with at least four CUDA cards:

    python -m offt_tpu_torch.bench.mesh4

It spawns one process per card, joins them in an NCCL group
(``tcp://localhost``, a free port) and on a 2 x 2 mesh:

- runs the long-1-D engine (``plan((1, 1, N), mesh=...)``, route
  ``"long1d"``) at 2^20 and 2^24, c2c forward and the packed r2c / c2r,
  each rank on its natural chunk of one global input made from a seed,
  and holds each rank's chunk against complex128 ``torch.fft`` of the
  whole input (1e-6);
- times the c2c engine per rank by CUDA events, beside one card's
  single-device plan of the whole transform and ``torch.fft.fft``, and
  splits it stage by stage: the three exchanges and the four-step pair
  on the rank's shard, each alone;
- runs ``obs/profile.pencil_breakdown`` of 256^3 c2c (each pass and
  each exchange alone, and the mesh plan);
- tunes the 256^3 c2c pencil plan on the 2 x 2 mesh
  (``tune.tune(..., fast_trial=2, strategy="nm")``, 20 trials: the
  FAST_TUNING phase trials, then the refinement pass on whole plans),
  and times the default point's plan and the winner's on each rank; it
  prints the winner's knobs, the search's and the refinement's seconds
  and each refined point's trial estimate beside its exact time (rank
  0's event log).

Every rank prints its rows; the script prints the card's name and power
limit first and exits 0 when every check held. Without four cards it
exits 2.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time

import torch
import torch.distributed as dist

WORLD = 4
TOL = 1e-6
LENGTHS = (2 ** 20, 2 ** 24)
CUBE = (256, 256, 256)
TUNE_TRIALS = 20


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _global(n: int, device, seed: int, real: bool = False):
    """The same global input on every rank, from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if real:
        return torch.randn((1, 1, n), generator=gen, device=device)
    return tuple(torch.randn((1, 1, n), generator=gen, device=device)
                 for _ in range(2))


def _stages(p, xs, time_cuda) -> dict:
    """ms of each stage of the engine's c2c alone on this rank's shard:
    the three exchanges and the four-step pair."""
    from ..kernels import fourstep as fs
    from ..kernels import fused_fft as ff

    core = p._long1d.core
    n1, n2, ptot = core.n1, core.n2, core.ptot
    ex = core._exchange
    a = tuple(t.reshape(1, n1 // ptot, n2) for t in xs)
    b = ex(a, 2, 1)
    tw = ff._tables(None, b[0].device).get(*core.twiddle)
    c = fs.step12_planar(*b, core.rad1, False, "highest", tw)
    d = ex(c, 1, 2)
    e = fs.step34_planar(*d, core.rad2, False, "highest")
    ms = {}
    for name, fn, args in (
            ("exchange_1", lambda x: ex(x, 2, 1), (a,)),
            ("step12", lambda x: fs.step12_planar(*x, core.rad1, False,
                                                  "highest", tw), (b,)),
            ("exchange_2", lambda x: ex(x, 1, 2), (c,)),
            ("step34", lambda x: fs.step34_planar(*x, core.rad2, False,
                                                  "highest"), (d,)),
            ("exchange_3", lambda x: ex(x, 1, 2, True), (e,))):
        dist.barrier()
        ms[name] = time_cuda(fn, args)["median_ms"]
    return ms


def _ms(sec) -> str:
    return "-" if sec is None else f"{sec * 1e3:.4f} ms"


def _tune(mesh, cube, dev, tag: str, logdir: str) -> None:
    """Tune the cube's c2c pencil plan on ``mesh`` (every rank calls it),
    then time the default point's plan and the winner's on this rank."""
    import dataclasses

    import offt_tpu_torch as ot
    from ..obs.log import read_events
    from ..obs.profile import time_cuda, time_host
    from ..plan.params import ProblemSpec, default_params
    from ..tune.tuner import plan_inputs

    log = os.path.join(logdir, "tune.jsonl")
    t0 = time.perf_counter()
    res = ot.tune.tune(cube, "complex64", mesh=mesh, fast_trial=2,
                       strategy="nm", max_trials=TUNE_TRIALS, save=False,
                       log_path=log, device=dev)
    secs = time.perf_counter() - t0
    dflt = default_params(ProblemSpec(shape=tuple(cube), p=4), p1=2)
    won = {k: v for k, v in dataclasses.asdict(res.best_params).items()
           if v != getattr(dflt, k)}
    n_ok = sum(t.status == "ok" for t in res.trials)
    print(f"{tag} tune {tuple(cube)} on 2x2: {n_ok} trials run "
          f"({len(res.trials)} with duplicates and infeasible) in "
          f"{secs:.1f} s; over the ranks (max): default "
          f"{res.default_perf * 1e3:.4f} ms, best {res.best_perf * 1e3:.4f}"
          f" ms, speedup_vs_default {res.speedup_vs_default:.3f}; winner "
          f"{won or 'the default point'}", flush=True)
    ms = {}
    for name, prm in (("default", dflt), ("winner", res.best_params)):
        p = ot.plan(cube, "complex64", mesh=mesh, params=prm, planar=True,
                    use_cache=False, device=dev)
        args = plan_inputs(p)
        dist.barrier()
        ms[name] = (time_cuda(p, args)["median_ms"] if dev.type == "cuda"
                    else time_host(p, args) * 1e3)
    print(f"{tag} tune {tuple(cube)} on 2x2, this rank: default point "
          f"{ms['default']:.4f} ms, winner {ms['winner']:.4f} ms "
          f"({ms['default'] / ms['winner']:.3f}x)", flush=True)
    if dist.get_rank() == 0:
        evs = read_events(log)
        trials = [e for e in evs if e["kind"] == "trial"]
        refine = [e for e in evs if e["kind"] == "refine"]
        done = evs[-1]
        t_search = trials[-1]["t"] - (done["t"] - done["wall"])
        t_refine = done["t"] - trials[-1]["t"]
        rows = "; ".join(f"{e['point']}: trial {_ms(e['coarse'])}, exact "
                         f"{_ms(e['perf'])}" for e in refine)
        print(f"{tag} tune {tuple(cube)}: search {t_search:.1f} s, "
              f"refinement {t_refine:.1f} s; refined points (over the "
              f"ranks): {rows}", flush=True)


def _worker(rank: int, port: int, backend: str, device_type: str,
            lengths, cube, logdir) -> None:
    import offt_tpu_torch as ot
    from offt_tpu_torch.obs.profile import pencil_breakdown, time_cuda

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(f"cuda:{rank}" if device_type == "cuda" else "cpu")
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = ot.make_mesh(2, 2, device_type=device_type)
        tag = f"rank {rank}"
        for n in lengths:
            xs = _global(n, dev, seed=1)
            z = torch.complex(*xs).to(torch.complex128)
            p = ot.plan((1, 1, n), "complex64", mesh=mesh, planar=True,
                        device=dev)
            if p.route != "long1d" or not p._long1d.fused:
                raise AssertionError(f"(1, 1, {n}): route {p.route}")
            blk = p.input_block((1, 1, n))
            mine = tuple(t[blk].contiguous() for t in xs)
            yr, yi = p(*mine)
            err = _rel(torch.complex(yr, yi).to(torch.complex128),
                       torch.fft.fft(z)[p.output_block((1, 1, n))])
            print(f"{tag} long1d c2c {n} split {p._long1d.split}: rel err "
                  f"{err:.3e} (tol {TOL:g})", flush=True)
            if err > TOL:
                raise AssertionError(f"c2c {n}: {err:.3e}")
            r = _global(n, dev, seed=2, real=True)
            pr = ot.plan((1, 1, n), "float32", mesh=mesh, real=True,
                         planar=True, packed=True, device=dev)
            pi = ot.plan((1, 1, n), "float32", mesh=mesh, real=True,
                         inverse=True, planar=True, packed=True, device=dev)
            if not pr.route == pi.route == "long1d":
                raise AssertionError(f"real {n}: {pr.route}, {pi.route}")
            hr, hi = pr(r[pr.input_block(r.shape)].contiguous())
            w = torch.fft.rfft(r.double())
            m = n // 2
            want = torch.cat([torch.complex(w[..., :1].real,
                                            w[..., m:].real),
                              w[..., 1:m]], -1)[pr.output_block((1, 1, m))]
            err_r = _rel(torch.complex(hr, hi).to(torch.complex128), want)
            back = pi(hr, hi)
            err_c = _rel(back.double(), r[pi.output_block(r.shape)].double())
            print(f"{tag} long1d packed r2c {n}: rel err {err_r:.3e}, c2r "
                  f"round trip {err_c:.3e} (tol {TOL:g})", flush=True)
            if max(err_r, err_c) > TOL:
                raise AssertionError(f"real {n}: {err_r:.3e}, {err_c:.3e}")
            if device_type != "cuda":
                continue
            dist.barrier()
            ms = time_cuda(p, mine)["median_ms"]
            one = ot.plan((1, 1, n), "complex64", planar=True, device=dev)
            ms_one = time_cuda(one, xs)["median_ms"]
            xc = torch.complex(*xs)
            ms_fft = time_cuda(torch.fft.fft, (xc,))["median_ms"]
            st = _stages(p, mine, time_cuda)
            parts = ", ".join(f"{k} {v:.4f}" for k, v in st.items())
            print(f"{tag} time long1d c2c {n} on 2x2: {ms:.4f} ms; one "
                  f"card's plan of the whole {ms_one:.4f} ms, torch.fft.fft "
                  f"{ms_fft:.4f} ms; stages alone, ms: {parts}; their sum "
                  f"{sum(st.values()):.4f}", flush=True)
            del xs, z, mine, r, w, want, back, one, xc
            torch.cuda.empty_cache()
        dist.barrier()
        bd = pencil_breakdown(cube, mesh)
        parts = ", ".join(f"{k} {v * 1e3:.4f}" for k, v in bd.items())
        print(f"{tag} pencil_breakdown {cube} on 2x2, ms: {parts}",
              flush=True)
        dist.barrier()
        _tune(mesh, cube, dev, tag, logdir)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(backend="nccl", device_type="cuda", lengths=LENGTHS,
        cube=CUBE) -> None:
    with tempfile.TemporaryDirectory() as logdir:
        torch.multiprocessing.spawn(
            _worker, args=(_free_port(), backend, device_type, lengths,
                           cube, logdir),
            nprocs=WORLD, join=True)


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        print(f"mesh4 needs {WORLD} CUDA cards", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    from ..kernels import _build
    _build.build()          # once, before the ranks load it
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
