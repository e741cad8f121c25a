"""BASELINE.json's five configurations on the port, one JSONL record each:
``python -m offt_tpu_torch.bench.baseline_suite`` (after
``offt_tpu/bench/baseline_suite.py``).

At the sizes BASELINE.json names wherever one 80 GB card holds them:

1. 1-D c2c N = 2^20 float32 (``plan((1, 1, N))``, the four-step pair);
2. 3-D c2c 256^3 on one device;
3. 3-D c2c 512^3 on a pencil mesh over every rank of the
   ``torch.distributed`` world the caller started (``torchrun``; 2 x 2 on
   four cards); without a world of more than one rank, the reference's
   ``skipped`` line;
4. 3-D r2c 1024^3 and its c2r (about 4 GiB in, 4.1 GiB of packed output;
   one record, the c2r's numbers under ``c2r_``);
5. batched 3-D c2c 64 x 256^3 (8 GiB in and out as planar pairs).

``--fast`` keeps the reference's small sizes (2^18; 64^3; 32^3 on the
mesh; 64^3 r2c and c2r, in the numpy layout; 2 x 32^3), for the CPU
tests. Every record carries
``rel_err`` against complex128 ``torch.fft`` on the same device (the
numpy answer, computed where the data lies; batch by batch for config 5),
``pass`` at 1e-6 (1e-5 on the mesh, as the reference), ``t_ms`` (the
median of 20 calls by CUDA events on a card, the host enqueueing ahead:
device time; the host clock on the CPU), ``gflops`` (5 n log2(n)
c2c, 2.5 n log2(n) r2c / c2r) and the transform's least time
``bound_ms`` / ``bound_by`` (``roofline.kernel_bound``), and ``device``.
A configuration that fails (out of memory, a kernel's error) writes its
record with ``error`` and ``pass`` false, and the suite goes on; the
exit code is 1 if any record failed.

    python -m offt_tpu_torch.bench.baseline_suite            # on the card
    python -m offt_tpu_torch.bench.baseline_suite --fast --device cpu
    torchrun --nproc_per_node 4 -m offt_tpu_torch.bench.baseline_suite
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

TOL = 1e-6
TOL_MESH = 1e-5


def _emit(rec: dict, out) -> None:
    print(json.dumps(rec), file=out, flush=True)


def _norms(got, want, step: int = 64) -> tuple:
    """(||got - want||^2, ||want||^2) in float64, a slab of ``step`` along
    the first axis at a time (``got``: a planar pair or one real tensor;
    ``want``: complex128 or float64), so that no whole float64 copy of a
    large output is made."""
    d = r = 0.0
    for i in range(0, want.shape[0], step):
        w = want[i:i + step]
        g = got[i:i + step].double() if isinstance(got, torch.Tensor) \
            else torch.complex(got[0][i:i + step].double(),
                               got[1][i:i + step].double())
        d += float(torch.linalg.vector_norm(g - w) ** 2)
        r += float(torch.linalg.vector_norm(w) ** 2)
    return d, r


def _seconds(dev):
    from ..obs.profile import time_cuda, time_host
    if dev.type == "cuda":
        return lambda fn, args: time_cuda(fn, args, warmup=2, reps=20,
                                          ahead=True)["median_ms"] / 1e3
    return lambda fn, args: time_host(fn, args, reps=2)


def _record(config, desc, kind, shape, err, tol, t, dev, label) -> dict:
    from .roofline import kernel_bound, kernel_work
    bms, by = kernel_bound(kind, shape)
    return {"config": config, "desc": desc, "rel_err": err,
            "pass": bool(err < tol), "t_ms": t * 1e3,
            "gflops": kernel_work(kind, shape)[1] / t / 1e9,
            "bound_ms": bms, "bound_by": by, "device": label}


def _gen(dev, seed: int = 0):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


def config1(dev, label, fast: bool) -> dict:
    import offt_tpu_torch as ot
    n = 1 << (18 if fast else 20)
    g = _gen(dev)
    x = (torch.randn(n, generator=g, device=dev),
         torch.randn(n, generator=g, device=dev))
    p = ot.plan((1, 1, n), "complex64", planar=True, device=dev)
    args = tuple(t.view(1, 1, n) for t in x)
    yr, yi = p(*args)
    want = torch.fft.fft(torch.complex(x[0].double(), x[1].double()))
    d, r = _norms((yr.view(-1), yi.view(-1)), want)
    err = math.sqrt(d / r)
    t = _seconds(dev)(p, args)
    return _record(1, f"1D c2c N=2^{n.bit_length() - 1} fp32", "c2c", (n,),
                   err, TOL, t, dev, label)


def _c2c(config, desc, shape, dev, label, batch=0, mesh=None) -> dict:
    """A planar 3-D c2c plan (``batch`` leading cubes; on ``mesh`` each
    rank its block) against complex128 torch.fft, cube by cube."""
    import offt_tpu_torch as ot
    full = ((batch,) if batch else ()) + shape
    g = _gen(dev)
    x = (torch.randn(full, generator=g, device=dev),
         torch.randn(full, generator=g, device=dev))
    p = ot.plan(shape, "complex64", planar=True, mesh=mesh,
                batch_dims=1 if batch else 0, device=dev)
    if mesh is not None:
        sl = p.input_block(full)
        args = tuple(t[sl].contiguous() for t in x)
    else:
        args = x
    yr, yi = p(*args)
    osl = p.output_block(full) if mesh is not None else \
        tuple(slice(None) for _ in full)
    d = r = 0.0
    for b in range(max(batch, 1)):
        pick = (b,) if batch else ()
        want = torch.fft.fftn(torch.complex(x[0][pick].double(),
                                            x[1][pick].double()))
        w = want[osl[1:]] if batch else want[osl]
        db, rb = _norms((yr[pick], yi[pick]), w)
        d, r = d + db, r + rb
        del want, w
    err = _world_rel(d, r, dev, mesh)
    del yr, yi
    t = _seconds(dev)(p, args)
    return _record(config, desc, "c2c", full, err,
                   TOL if mesh is None else TOL_MESH, t, dev, label)


def _world_rel(d: float, r: float, dev, mesh) -> float:
    """sqrt(d / r), the sums taken over the mesh's ranks."""
    if mesh is not None:
        import torch.distributed as dist
        v = torch.tensor([d, r], dtype=torch.float64,
                         device=dev if dev.type == "cuda" else "cpu")
        dist.all_reduce(v)
        d, r = v.tolist()
    return math.sqrt(d / r)


def config4(dev, label, fast: bool) -> dict:
    """r2c of a real n^3, then the c2r of that spectrum, each against
    complex128 torch.fft, in one record (the c2r's numbers under
    ``c2r_``; ``pass`` both): in the packed layout at 1024^3, in the numpy
    layout at --fast's 64^3 (outside the packed route's gate)."""
    import offt_tpu_torch as ot
    from ..kernels.fused_fft import unpack_rfft3d
    n = 64 if fast else 1024
    packed = not fast
    shape = (n,) * 3
    layout = "packed" if packed else "numpy layout"
    g = _gen(dev)
    x = torch.randn(shape, generator=g, device=dev)
    fwd = ot.plan(shape, "float32", real=True, planar=True, packed=packed,
                  device=dev)
    yr, yi = fwd(x)
    want = torch.fft.rfftn(x.double())
    got = unpack_rfft3d(yr, yi) if packed else (yr, yi)
    err = _world_rel(*_norms(got, want), dev, None)
    del got
    t = _seconds(dev)(fwd, (x,))
    del x
    rec = _record(4, f"3D r2c/c2r {n}^3 {layout}", "r2c", shape, err, TOL,
                  t, dev, label)
    inv = ot.plan(shape, "float32", real=True, inverse=True, planar=True,
                  packed=packed, device=dev)
    back = inv(yr, yi)
    ref = torch.fft.irfftn(want, s=shape)
    del want
    err = _world_rel(*_norms(back, ref), dev, None)
    del back, ref
    t = _seconds(dev)(inv, (yr, yi))
    c2r = _record(4, "", "c2r", shape, err, TOL, t, dev, label)
    rec.update({f"c2r_{k}": c2r[k] for k in
                ("rel_err", "t_ms", "gflops", "bound_ms", "bound_by")})
    rec["pass"] = rec["pass"] and c2r["pass"]
    return rec


def _guard(config, desc, fn, *args):
    """[the record of ``fn(*args)``], or one failed record with its error
    (the card's memory released)."""
    try:
        out = fn(*args)
    except (RuntimeError, ValueError) as e:
        out = {"config": config, "desc": desc, "pass": False,
               "error": f"{type(e).__name__}: {str(e)[:300]}"}
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return [out]


def main(argv=None, out=None) -> int:
    ap = argparse.ArgumentParser(prog="offt-torch-baseline")
    ap.add_argument("--fast", action="store_true",
                    help="the reference's small sizes (CPU tests)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ns = ap.parse_args(argv)
    out = out or sys.stdout
    from .runfft import _device, _world, device_label
    dev = _device(ns.device)
    label = device_label(dev)
    fast = ns.fast
    import torch.distributed as tdist
    ours = tdist.is_available() and not tdist.is_initialized()
    dist = _world(dev)
    world = dist.get_world_size() if dist is not None else 1
    rank = dist.get_rank() if dist is not None else 0
    recs = []
    recs += _guard(1, "1D c2c", config1, dev, label, fast)
    n2 = 64 if fast else 256
    recs += _guard(2, f"3D c2c {n2}^3", _c2c, 2,
                   f"3D c2c {n2}^3 single-device", (n2,) * 3, dev, label)
    if world > 1:
        from ..dist import make_mesh
        p1 = math.isqrt(world)
        while world % p1:
            p1 -= 1
        mesh = make_mesh(p1, world // p1, dev.type)
        n3 = 32 if fast else 512
        desc = f"3D c2c {n3}^3 pencil {p1}x{world // p1}"
        recs += _guard(3, desc, _c2c, 3, desc, (n3,) * 3, dev, label, 0,
                       mesh)
    else:
        recs.append({"config": 3, "desc": "pencil (needs >1 device)",
                     "skipped": True})
    recs += _guard(4, "3D r2c/c2r", config4, dev, label, fast)
    nb, n5 = (2, 32) if fast else (64, 256)
    recs += _guard(5, f"batched {nb}x{n5}^3 c2c", _c2c, 5,
                   f"batched {nb}x{n5}^3 c2c", (n5,) * 3, dev, label, nb)
    if rank == 0:
        for rec in recs:
            _emit(rec, out)
    ok = all(r.get("pass", True) for r in recs)
    if ours and dist is not None:
        dist.destroy_process_group()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
