"""The port's run-fft driver: ``python -m offt_tpu_torch.bench.runfft``
(``offt-torch-bench``), after ``offt_tpu/bench/runfft.py``.

Like the reference (itself the re-expression of run-fft.c), it takes
-N / --nx / --ny / --nz sizes, -b a leading batch, -R r2c (with -i: c2r),
--packed, -a the algorithm, -r reps, the tuning flags (--tune, -s, -l,
-A, --log) and one flag per plan knob; fills a seeded input, times the
transform and prints human lines on stderr and one JSON summary line on
stdout (the reference's keys: algo, shape, kind, t_ms, gflops, t_init_s;
and ``device``, the card's name and power limit as ``nvidia-smi`` gives
them, or "cpu"; ``bound_ms`` / ``bound_by``, the least time of the
transform, ``bench.roofline.kernel_bound``).

Algorithms: ``offt`` (this library's plans), ``torch`` (``torch.fft`` on
the same device: cuFFT on a card; it takes the place of the reference's
``xla`` and benches the same transform, -i and -R -i included; on a mesh
it runs an x-slab decomposition of its own, ``torch.fft`` on each rank
and one ``all_to_all_single``, as ``fftn@mesh``) and ``numpy`` (the
host). The reference's ``jaxdecomp`` has no counterpart: it is a JAX
package, and the port imports no JAX; argparse refuses it.

Everything runs on ``--device`` (default ``cuda``, which raises without a
card: pass ``--device cpu`` for the plain versions on the host). Times:
CUDA events on a card with the host enqueueing ahead
(``obs/profile.time_cuda(ahead=True)``: each call's device time, not the
host's pace), the host clock on the CPU (``time_host``); the median of
``-r`` calls after warm-up. ``-a torch`` times the ``torch.fft`` call
alone: its complex input is built before the clock starts. ``--p1`` /
``--p2`` / ``--mesh`` run inside a ``torch.distributed`` world the
caller started (``torchrun``: NCCL on cards, gloo on the CPU), each rank
on its block, the slowest rank's time reported by rank 0; without a
world they raise. ``--verify`` checks the plan against ``numpy.fft`` on
two inputs: the reference's seeded one and the golden separable
f = z + 10 y + 100 x of run-fft.c (bar 1e-5; rel_err lines on stderr).
``--breakdown`` prints ``obs/profile.fft3d_breakdown`` (or
``pencil_breakdown`` on a mesh); ``--in-place`` is ``donate=True``. The
knobs ``slab_rows`` and ``x_tile`` are accepted and ignored by the port's
kernels (``plan/params.py``), which a ``#`` line says.

    python -m offt_tpu_torch.bench.runfft -N 256 --verify
    python -m offt_tpu_torch.bench.runfft -N 16 --device cpu -a torch -i
    torchrun --nproc_per_node 4 -m offt_tpu_torch.bench.runfft -N 16 \\
        --device cpu --p1 2 --p2 2 --breakdown
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

KNOBS = ("t1", "t2", "w1", "w2", "ry", "s1", "s2", "v", "block_batch",
         "slab_rows")
TUPLE_KNOBS = ("radix_z", "radix_y", "radix_x", "x_tile", "split_1d")
# knobs the port's routes accept and do not read (plan/params.py)
IGNORED = {"slab_rows": "one block owns one x-row of the slab",
           "x_tile": "the pitched x pass picks its own lane tile"}
VERIFY_TOL = 1e-5


def _parse_args(argv=None):
    p = argparse.ArgumentParser(prog="offt-torch-bench",
                                description="offt_tpu_torch benchmark "
                                            "driver")
    p.add_argument("-N", type=int, default=256, help="cube size (Nx=Ny=Nz)")
    p.add_argument("--nx", type=int, default=0)
    p.add_argument("--ny", type=int, default=0)
    p.add_argument("--nz", type=int, default=0)
    p.add_argument("-a", "--algo", default="offt",
                   choices=["offt", "torch", "numpy"])
    p.add_argument("-R", "--r2c", action="store_true")
    p.add_argument("--packed", action="store_true",
                   help="r2c/c2r in the packed half-spectrum layout "
                        "(plane 0 carries X[0] + i X[Nz/2])")
    p.add_argument("-b", "--batch", type=int, default=0,
                   help="leading batch dim (BASELINE config 5 style)")
    p.add_argument("-i", "--inverse", action="store_true")
    p.add_argument("-r", "--reps", type=int, default=5)
    p.add_argument("--p1", type=int, default=0, help="mesh rows (0=auto)")
    p.add_argument("--p2", type=int, default=0, help="mesh cols (0=auto)")
    p.add_argument("--mesh", action="store_true",
                   help="distribute over every rank of the world")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--tune", action="store_true")
    p.add_argument("-s", "--strategy", default="nm",
                   help="tuning strategy: nm|pro|random|brute")
    p.add_argument("-l", "--max-trials", type=int, default=30)
    p.add_argument("-A", "--fast-trial", type=int, default=0,
                   help="FAST_TUNING: time only the first K chunks per "
                        "phase during the search; finalists re-timed "
                        "exactly")
    p.add_argument("--log", default="", help="JSONL trial/event log path")
    for knob in KNOBS:
        p.add_argument(f"--{knob.replace('_', '-')}", type=int, default=None)
    p.add_argument("--radix-z", default=None, help="e.g. 16,16")
    p.add_argument("--radix-y", default=None)
    p.add_argument("--radix-x", default=None)
    p.add_argument("--x-tile", default=None,
                   help="accepted and ignored by the port, e.g. 8,128")
    p.add_argument("--split-1d", default=None,
                   help="four-step (n1,n2) split of a (1, 1, N) plan, "
                        "e.g. 1024,1024")
    p.add_argument("--verify", action="store_true",
                   help="check the output against numpy (seeded and "
                        "golden inputs)")
    p.add_argument("--breakdown", action="store_true",
                   help="per-stage timing table")
    p.add_argument("--in-place", action="store_true",
                   help="donate=True: the planar c2c kernels in place")
    return p.parse_args(argv)


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: offt-torch-bench runs on the "
                           "card by default; pass --device cpu for the "
                           "host")
    return dev


def device_label(dev: torch.device) -> str:
    """The card's name and power limit (nvidia-smi), or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def _world(dev: torch.device):
    """The torch.distributed world the caller started (torchrun's
    environment), initialised here if it is not yet; None without one."""
    import torch.distributed as dist
    if not dist.is_available():
        return None
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            return None
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method="env://")
    return dist


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def _timer(dev: torch.device, reps: int):
    """Seconds per call on ``dev``: CUDA events or the host clock; on a
    world the slowest rank's."""
    from ..obs.profile import time_cuda, time_host

    def run(fn, args):
        if dev.type == "cuda":
            t = time_cuda(fn, args, warmup=2, reps=max(reps, 3),
                          ahead=True)["median_ms"] / 1e3
        else:
            t = time_host(fn, args, reps=max(reps, 1))
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            v = torch.tensor([t], dtype=torch.float64,
                             device=dev if dev.type == "cuda" else "cpu")
            dist.all_reduce(v, op=dist.ReduceOp.MAX)
            t = v.item()
        return t
    return run


def _shape(ns) -> tuple:
    shape = (ns.nx or ns.N, ns.ny or ns.N, ns.nz or ns.N)
    return ((ns.batch,) if ns.batch else ()) + shape


def _overrides(ns) -> dict:
    out = {k: getattr(ns, k) for k in KNOBS if getattr(ns, k) is not None}
    for key in TUPLE_KNOBS:
        v = getattr(ns, key)
        if v:
            out[key] = tuple(int(t) for t in v.split(","))
    return out


def _kind(ns) -> str:
    return ("c2r" if ns.inverse else "r2c") if ns.r2c else "c2c"


def main(argv=None) -> int:
    """Run the driver; a world this call initialised is destroyed on the
    way out."""
    import torch.distributed as dist
    ns = _parse_args(argv)
    ours = dist.is_available() and not dist.is_initialized()
    try:
        rc = _main(ns)
        if ours:
            from ..dist import quiesce
            quiesce()
        return rc
    finally:
        if ours and dist.is_initialized():
            dist.destroy_process_group()


def _main(ns) -> int:
    shape = _shape(ns)
    from .roofline import kernel_bound, kernel_work
    flops = kernel_work(_kind(ns), shape)[1]
    bound = kernel_bound(_kind(ns), shape)
    rng = np.random.default_rng(0)
    t_init0 = time.time()

    if ns.algo == "numpy":
        x = (rng.standard_normal(shape)
             + 1j * rng.standard_normal(shape)).astype(np.complex64)
        fn = np.fft.rfftn if ns.r2c else np.fft.fftn
        arg = x.real.copy() if ns.r2c else x
        fn(arg)
        t = min(_host_once(fn, arg) for _ in range(max(ns.reps, 1)))
        _summary(ns, shape, flops, t, time.time() - t_init0, "host", bound)
        return 0

    dev = _device(ns.device)
    mesh = None
    if ns.mesh or ns.p1 or ns.p2:
        dist = _world(dev)
        if dist is None:
            raise RuntimeError(
                "--p1/--p2/--mesh run inside a torch.distributed world: "
                "launch with torchrun --nproc_per_node N (NCCL on cards, "
                "gloo with --device cpu)")
        from ..dist import make_mesh
        world = dist.get_world_size()
        p1 = ns.p1 or 1
        p2 = ns.p2 or world // p1
        mesh = make_mesh(p1, p2, dev.type)
    label = device_label(dev)
    timer = _timer(dev, ns.reps)

    if ns.algo == "torch":
        return _run_torch(ns, shape, flops, bound, dev, mesh, rng, t_init0,
                          label, timer)

    import offt_tpu_torch as ot

    overrides = _overrides(ns)
    for key in overrides:
        if key in IGNORED and _rank() == 0:
            print(f"# {key}={overrides[key]} is accepted and ignored by the "
                  f"port: {IGNORED[key]}", file=sys.stderr)
    params = None
    if ns.tune:
        from ..tune import tune
        res = tune(shape[-3:], "complex64", mesh=mesh, real=ns.r2c,
                   strategy=ns.strategy, max_trials=ns.max_trials,
                   log_path=ns.log or None, inverse=ns.inverse,
                   fast_trial=ns.fast_trial, device=dev)
        params = res.best_params
        if _rank() == 0:
            print(f"# tuned: best={params} perf={res.best_perf * 1e3:.3f} "
                  f"ms default={res.default_perf * 1e3:.3f} ms "
                  f"speedup={res.speedup_vs_default:.2f}x", file=sys.stderr)
    if overrides:
        base = params or ot.plan(shape[-3:], "complex64", mesh=mesh,
                                 real=ns.r2c, batch_dims=len(shape) - 3,
                                 device=dev).params
        params = base.replace(**overrides)

    p = ot.plan(shape[-3:], "complex64", mesh=mesh, real=ns.r2c,
                inverse=ns.inverse, params=params, planar=True,
                batch_dims=len(shape) - 3, packed=ns.packed and ns.r2c,
                in_place=ns.in_place, donate=ns.in_place, device=dev)
    in_shape = _in_shape(ns, shape)
    args = _block(p, _draw(rng, in_shape, ns.r2c and not ns.inverse), dev,
                  in_shape, p.input_block)
    t_init = time.time() - t_init0
    t = timer(p, args)
    if ns.verify:
        _verify(p, shape, ns, dev)
    if ns.breakdown and not ns.r2c and not ns.batch:
        from ..obs.profile import fft3d_breakdown, pencil_breakdown
        bd = (fft3d_breakdown(shape, params=params, device=dev)
              if mesh is None else pencil_breakdown(shape, mesh,
                                                    params=params))
        if _rank() == 0:
            for k, v in bd.items():
                print(f"# {k}: {v * 1e3:.3f} ms", file=sys.stderr)
    _summary(ns, shape, flops, t, t_init, label, bound)
    return 0


def _host_once(fn, arg) -> float:
    t0 = time.perf_counter()
    fn(arg)
    return time.perf_counter() - t0


def _in_shape(ns, shape) -> tuple:
    if ns.r2c and ns.inverse:       # c2r input: the half spectrum
        m = shape[-1] // 2
        return shape[:-1] + ((m,) if ns.packed else (m + 1,))
    return shape


def _draw(rng, in_shape, real: bool) -> tuple:
    re = rng.standard_normal(in_shape).astype(np.float32)
    if real:
        return (re,)
    return re, rng.standard_normal(in_shape).astype(np.float32)


def _block(p, arrays, dev, shape, block_of) -> tuple:
    """This rank's block of each global array, on ``dev``."""
    sl = block_of(tuple(shape))
    return tuple(torch.from_numpy(np.ascontiguousarray(a[sl])).to(dev)
                 for a in arrays)


def golden(shape) -> np.ndarray:
    """run-fft.c's deterministic input f(x, y, z) = z + 10 y + 100 x over
    the last three axes of ``shape`` (float64)."""
    nx, ny, nz = shape[-3:]
    x, y, z = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    return np.broadcast_to(z + 10.0 * y + 100.0 * x, shape).copy()


def _verify(p, shape, ns, dev) -> None:
    """The plan on the reference's seeded input (rng(1)) and on the golden
    input against numpy.fft, in the plan's own output layout, each rank
    on its block (the norms summed over the world); exits 1 past the bar."""
    from ..kernels.fused_fft import pack_rfft3d
    axes = (-3, -2, -1)
    rng = np.random.default_rng(1)
    for name in ("seeded", "golden"):
        if name == "seeded":
            real = rng.standard_normal(shape)
            imag = rng.standard_normal(shape)
        else:
            real, imag = golden(shape), np.zeros(shape)
        real = real.astype(np.float32).astype(np.float64)
        imag = imag.astype(np.float32).astype(np.float64)
        if ns.r2c and not ns.inverse:
            ins = (real,)
            w = np.fft.rfftn(real, axes=axes)
            want = (w.real, w.imag)
            if ns.packed:
                want = tuple(t.numpy() for t in pack_rfft3d(
                    *(torch.from_numpy(np.ascontiguousarray(v))
                      for v in want)))
        elif ns.r2c:        # c2r of the half-spectrum of a real signal
            s = np.fft.rfftn(real, axes=axes)
            ins = (s.real, s.imag)
            if ns.packed:
                ins = tuple(t.numpy() for t in pack_rfft3d(
                    *(torch.from_numpy(np.ascontiguousarray(v))
                      for v in ins)))
            want = (np.fft.irfftn(s, s=shape[-3:], axes=axes),)
        else:
            x = real + 1j * imag
            w = np.fft.ifftn(x, axes=axes) if ns.inverse \
                else np.fft.fftn(x, axes=axes)
            ins, want = (real, imag), (w.real, w.imag)
        args = _block(p, [a.astype(np.float32) for a in ins], dev,
                      ins[0].shape, p.input_block)
        got = p(*args)
        got = (got,) if isinstance(got, torch.Tensor) else tuple(got)
        sl = p.output_block(tuple(want[0].shape))
        diff = ref = 0.0
        for g, w in zip(got, want):
            w = torch.from_numpy(np.ascontiguousarray(w[sl]))
            diff += float(((g.double().cpu() - w) ** 2).sum())
            ref += float((w ** 2).sum())
        err = _world_norm(diff, ref, dev)
        if _rank() == 0:
            tag = "" if name == "seeded" else " golden"
            print(f"# verify{tag} rel_err = {err:.3e}", file=sys.stderr)
        if err > VERIFY_TOL:
            print("# VERIFY FAILED", file=sys.stderr)
            sys.exit(1)


def _world_norm(diff: float, ref: float, dev) -> float:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        v = torch.tensor([diff, ref], dtype=torch.float64,
                         device=dev if dev.type == "cuda" else "cpu")
        dist.all_reduce(v)
        diff, ref = v.tolist()
    return (diff / ref) ** 0.5 if ref else 0.0


def _run_torch(ns, shape, flops, bound, dev, mesh, rng, t_init0, label,
               timer) -> int:
    """``torch.fft`` of the same transform on the same device."""
    if ns.packed:
        # the packed layout is offt's own; torch.fft has no analogue
        if _rank() == 0:
            print(json.dumps({"algo": "torch", "shape": list(shape),
                              "error": "packed layout has no torch.fft "
                                       "analogue"}))
        return 2
    dims = (-3, -2, -1)
    in_shape = _in_shape(ns, shape)
    if mesh is not None:
        if ns.r2c or len(shape) != 3:
            if _rank() == 0:
                print(json.dumps({"algo": "torch", "shape": list(shape),
                                  "error": "fftn@mesh is 3-D c2c only"}))
            return 2
        import torch.distributed as dist
        world, me = dist.get_world_size(), dist.get_rank()
        if shape[0] % world or shape[1] % world:
            raise ValueError(f"fftn@mesh needs X and Y divisible by the "
                             f"world's {world} ranks, got {shape}")
        xb = shape[0] // world
        rows = slice(me * xb, (me + 1) * xb)
        args = (torch.complex(*(torch.from_numpy(a[rows].copy()).to(dev)
                                for a in _draw(rng, in_shape, False))),)

        def fn(c, inverse=ns.inverse):
            return _slab_fft(c, world, inverse)
        torch_fn = ("ifftn" if ns.inverse else "fftn") + "@mesh"
    else:
        args = tuple(torch.from_numpy(a).to(dev)
                     for a in _draw(rng, in_shape, ns.r2c and not
                                    ns.inverse))
        if len(args) == 2:
            args = (torch.complex(*args),)
        if ns.r2c and ns.inverse:
            torch_fn = "irfftn"

            def fn(c):
                return torch.fft.irfftn(c, s=shape[-3:], dim=dims)
        elif ns.r2c:
            torch_fn = "rfftn"

            def fn(r):
                return torch.fft.rfftn(r, dim=dims)
        else:
            torch_fn = "ifftn" if ns.inverse else "fftn"
            op = torch.fft.ifftn if ns.inverse else torch.fft.fftn

            def fn(c):
                return op(c, dim=dims)
    t_init = time.time() - t_init0
    t = timer(fn, args)
    _summary(ns, shape, flops, t, t_init, label, bound, torch_fn=torch_fn)
    return 0


def _slab_fft(c, world: int, inverse: bool):
    """An x-slab distributed 3-D c2c with torch.fft on each rank: fft2 over
    (y, z) of this rank's (X/P, Y, Z) rows, one all_to_all_single to the
    (X, Y/P, Z) y-slab, fft over x. Independent of offt's pencil engine."""
    import torch.distributed as dist
    ffts = (torch.fft.ifft2, torch.fft.ifft) if inverse else \
        (torch.fft.fft2, torch.fft.fft)
    y = ffts[0](c, dim=(-2, -1))
    xb, ny, nz = y.shape
    send = torch.view_as_real(y.reshape(xb, world, ny // world, nz)
                              .transpose(0, 1).contiguous())
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send)
    z = torch.view_as_complex(recv).reshape(world * xb, ny // world, nz)
    return ffts[1](z, dim=0)


def _summary(ns, shape, flops, t, t_init, label, bound, **extra) -> None:
    if _rank() != 0:
        return
    gflops = flops / t / 1e9
    rec = {"algo": ns.algo, "shape": list(shape),
           "kind": "r2c" if ns.r2c else "c2c",
           # four significant figures, not two decimals: a small mesh
           # transform on a loaded host runs under 0.005 GFLOP/s
           "t_ms": round(t * 1e3, 4), "gflops": float(f"{gflops:.4g}"),
           "t_init_s": round(t_init, 3), "device": label,
           "bound_ms": bound[0], "bound_by": bound[1], **extra}
    print(f"# {ns.algo} {shape} {rec['kind']} t_min={t * 1e3:.3f} ms "
          f"t_init={t_init:.2f} s {gflops:.1f} GFLOP/s [{label}]",
          file=sys.stderr)
    print(json.dumps(rec))


if __name__ == "__main__":
    sys.exit(main())
