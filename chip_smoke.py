#!/usr/bin/env python3
"""Drive offt_tpu_torch's main path once on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card's name and power limit; the kernels built from ``csrc/``
   with nvcc, timed;
2. each CUDA kernel against its plain PyTorch version on the card, at a
   small shape and at the main-path shape (max |kernel - plain| /
   max |plain| <= 1e-6, pad lanes excluded, float32 matmuls pinned to
   full precision);
3. the two main paths through ``offt_tpu_torch.plan`` on the card: the
   planar c2c path, each result against a complex128 ``torch.fft.fftn``,
   and the packed r2c/c2r path (``real=True``, numpy and packed layouts),
   each result against a complex128 ``torch.fft.rfftn`` / ``irfftn``
   (||y - ref|| / ||ref|| <= 1e-6). Each path runs with the launch
   counters zeroed just before it and read just after;
4. the launch counters: every kernel of a path ran in that path's run, no
   plain version did;
5. CUDA-event times: the port against cuFFT (``torch.fft.fftn``,
   ``rfftn``, ``irfftn``) at 256^3 and 512^3, each kernel against its
   plain version, the two x routes at 256^3, and the slab kernel against
   the unfused z + y passes.

The line before the last is one JSON object with each kernel's numbers;
the last is ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import torch

TOL_KERNEL = 1e-6   # kernel vs plain, max-abs relative
TOL_PATH = 1e-6     # plan vs complex128 fftn, norm relative (fp32 bar)


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[torch.cuda.current_device()].strip()


def _pair(shape, gen):
    return (torch.randn(shape, generator=gen, device="cuda"),
            torch.randn(shape, generator=gen, device="cuda"))


def _max_err(got, want, lanes=None):
    """(max |got - want| / max |want|, max |got - want|) over a planar pair
    or one tensor; ``lanes`` keeps only the first lanes of the last axis
    (pad lanes are never compared)."""
    if isinstance(got, torch.Tensor):
        got, want = (got,), (want,)
    d = m = 0.0
    for g, w in zip(got, want):
        if lanes is not None:
            g, w = g[..., :lanes], w[..., :lanes]
        if not torch.isfinite(g).all():
            raise AssertionError("non-finite kernel output")
        d = max(d, (g - w).abs().max().item())
        m = max(m, w.abs().max().item())
    return d / m, d


def _rel_err(yr, yi, ref) -> float:
    """||y - ref|| / ||ref|| of a planar pair, or of a real tensor when
    ``yi`` is None."""
    y = yr.double() if yi is None else torch.complex(yr.double(),
                                                      yi.double())
    if not torch.isfinite(y).all():
        raise AssertionError("non-finite transform output")
    return (torch.linalg.vector_norm(y - ref)
            / torch.linalg.vector_norm(ref)).item()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import offt_tpu_torch as ot
    from offt_tpu_torch.kernels import _build
    from offt_tpu_torch.kernels import fused_fft as ff
    from offt_tpu_torch.obs.profile import time_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = _card()
    tag = f"[{card}]"
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    # ---- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"build: nvcc {_build.build_seconds:.2f} s, load "
          f"{time.perf_counter() - t0:.2f} s {tag}", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    # ---- 2. each kernel against its plain version -------------------------
    # (name, kernel, wrapper, call, input shape, lanes compared)
    def xpad(z, **kw):
        return lambda f, x: f(*x, z, **kw)

    def irfft(n, side_shape, **kw):
        side = _pair(side_shape, gen) if side_shape else (None, None)
        return lambda f, x: f(*x, n, side_r=side[0], side_i=side[1], **kw)

    def assemble(planes):
        ab = _pair(planes, gen) + _pair(planes, gen)
        return lambda f, x: f(*x, *ab)
    # the last check of each kernel is at its main-path shape and is the
    # one timed in phase 5
    checks = [
        ("fft_last", ff.fft_last, lambda f, x: f(*x, scale=0.5), (37, 320),
         None),
        ("fft_last", ff.fft_last, lambda f, x: f(*x), (64 * 1024, 1024),
         None),
        ("fft_axis", ff.fft_sublane, lambda f, x: f(*x, 1), (16, 32, 128),
         None),
        ("fft_axis", ff.fft_sublane, lambda f, x: f(*x, 0), (320, 320, 320),
         None),
        ("fft_axis", ff.fft_x_to_padded,
         lambda f, x: f(*x, z_true=128, inverse=True), (16, 32, 129), 128),
        ("fft_axis", ff.fft_x_to_padded,
         lambda f, x: f(*x, z_true=128, inverse=True), (256, 256, 129), 128),
        ("fft_axis", ff.fft_x_from_padded, xpad(128, scale=0.25),
         (16, 32, 136), None),
        ("fft_axis", ff.fft_x_from_padded, xpad(256), (256, 256, 264), None),
        ("fft_slab", ff.fft_slab_yz, lambda f, x: f(*x, zpad=8, scale=0.5),
         (4, 32, 128), 128),
        ("fft_slab", ff.fft_slab_yz, lambda f, x: f(*x, zpad=8),
         (256, 256, 256), 256),
        ("rfft_slab", ff.rfft_slab_yz, lambda f, x: f(x[0], zpad=8),
         (4, 16, 256), 128),
        ("rfft_slab", ff.rfft_slab_yz, lambda f, x: f(x[0], zpad=8),
         (256, 256, 256), 128),
        ("irfft_slab", ff.irfft_slab_yz, irfft(256, None, scale=1 / 2048),
         (4, 16, 136), None),
        ("irfft_slab", ff.irfft_slab_yz,
         irfft(256, (4, 16), scale=1 / 2048), (4, 16, 136), None),
        ("irfft_slab", ff.irfft_slab_yz,
         irfft(256, (256, 256), scale=1 / 256 ** 3 * 2), (256, 256, 136),
         None),
        ("assemble_mp1", ff._assemble_mp1, assemble((4, 16)), (4, 16, 128),
         None),
        ("assemble_mp1", ff._assemble_mp1, assemble((256, 256)),
         (256, 256, 128), None),
    ]
    per_kernel = {}
    for name, fn, call, shape, lanes in checks:
        x = _pair(shape, gen)
        got = call(fn, x)
        want = call(fn.plain, x)
        torch.cuda.synchronize()
        rel, absd = _max_err(got, want, lanes)
        print(f"check {name} via {fn.__name__} {shape}: max rel err "
              f"{rel:.3e}, max abs err {absd:.3e} (tol {TOL_KERNEL:g}) {tag}",
              flush=True)
        if rel > TOL_KERNEL:
            raise AssertionError(f"{name} disagrees with its plain version")
        info = per_kernel.setdefault(name, {"max_abs_err": 0.0})
        info["max_abs_err"] = max(info["max_abs_err"], absd)
        info["shape"] = shape
        info["call"] = (fn, call)
        del x, got, want

    # ---- 3a. the c2c main path through plan() ----------------------------
    cases = [
        # (label, shape, batch_dims, inverse, norm, in_place)
        ("256^3 fwd ortho", (256, 256, 256), 0, False, "ortho", False),
        ("256^3 inv ortho", (256, 256, 256), 0, True, "ortho", False),
        ("512^3 fwd", (512, 512, 512), 0, False, None, False),
        ("320^3 fwd", (320, 320, 320), 0, False, None, False),
        ("256^3 fwd in_place", (256, 256, 256), 0, False, None, True),
        ("256^3 inv in_place", (256, 256, 256), 0, True, None, True),
        ("64x1x1024^2 fwd", (64, 1, 1024, 1024), 1, False, None, False),
    ]
    inputs = {}
    for label, shape, bd, inv, norm, inp in cases:
        inputs[label] = _pair(shape, gen)
    results = {}
    ff.reset_counts()
    for label, shape, bd, inv, norm, inp in cases:
        xr, xi = inputs[label]
        if inp:
            xr, xi = xr.clone(), xi.clone()
        p = ot.plan(shape[bd:], "complex64", planar=True, inverse=inv,
                    norm=norm, batch_dims=bd, in_place=inp)
        results[label] = p((xr, xi))
    # round trip: the ortho inverse of the ortho forward
    pinv = ot.plan((256, 256, 256), "complex64", planar=True, inverse=True,
                   norm="ortho")
    results["256^3 round trip"] = pinv(results["256^3 fwd ortho"])
    torch.cuda.synchronize()
    runs = {"c2c": (ff.counts(),
                    {k: ff.kernel_launches(k) for k in ff.KERNELS})}
    print(f"c2c path counts (launches, plain calls): {runs['c2c'][0]}")

    for label, shape, bd, inv, norm, inp in cases + [
            ("256^3 round trip", (256, 256, 256), 0, None, None, False)]:
        if inv is None:
            src = inputs["256^3 fwd ortho"]
            ref = torch.complex(src[0].double(), src[1].double())
        else:
            src = inputs[label]
            x = torch.complex(src[0].double(), src[1].double())
            dims = tuple(range(len(shape) - 3, len(shape)))
            f = torch.fft.ifftn if inv else torch.fft.fftn
            ref = f(x, dim=dims, norm=norm)
            del x
        yr, yi = results[label]
        if tuple(yr.shape) != shape:
            raise AssertionError(f"{label}: shape {tuple(yr.shape)}")
        err = _rel_err(yr, yi, ref)
        print(f"path {label}: rel err vs complex128 fftn {err:.3e} "
              f"(tol {TOL_PATH:g}) {tag}", flush=True)
        if err > TOL_PATH:
            raise AssertionError(f"{label}: error {err:.3e}")
        del ref
    del results, inputs
    torch.cuda.empty_cache()

    # ---- 3b. the r2c / c2r main path through plan(real=True) --------------
    real_cases = [
        # (label, shape, batch_dims, inverse, packed, norm)
        ("256^3 r2c", (256, 256, 256), 0, False, False, None),
        ("256^3 r2c packed", (256, 256, 256), 0, False, True, None),
        ("256^3 c2r", (256, 256, 256), 0, True, False, None),
        ("256^3 c2r packed", (256, 256, 256), 0, True, True, None),
        ("256^3 r2c ortho", (256, 256, 256), 0, False, False, "ortho"),
        ("512^3 r2c", (512, 512, 512), 0, False, False, None),
        ("4x128x128x256 r2c", (4, 128, 128, 256), 1, False, False, None),
    ]
    inputs = {}
    for label, shape, bd, inv, packed, norm in real_cases:
        x = torch.randn(shape, generator=gen, device="cuda")
        if inv:
            # a Hermitian-consistent spectrum: rfftn of real data
            w = torch.fft.rfftn(x.double(), dim=(-3, -2, -1)).to(
                torch.complex64)
            x = (w.real.contiguous(), w.imag.contiguous())
            if packed:
                x = tuple(t.contiguous() for t in ot.pack_rfft3d(*x))
            inputs[label] = (x, w)
        else:
            inputs[label] = ((x,), x)
    results = {}
    ff.reset_counts()
    for label, shape, bd, inv, packed, norm in real_cases:
        p = ot.plan(shape[bd:], "float32", real=True, planar=True,
                    inverse=inv, packed=packed, norm=norm, batch_dims=bd)
        results[label] = p(*inputs[label][0])
    # round trip: the ortho c2r of the ortho r2c
    pinv = ot.plan((256, 256, 256), "float32", real=True, planar=True,
                   inverse=True, norm="ortho")
    results["256^3 r2c/c2r round trip"] = pinv(results["256^3 r2c ortho"])
    torch.cuda.synchronize()
    runs["r2c"] = (ff.counts(),
                   {k: ff.kernel_launches(k) for k in ff.KERNELS})
    print(f"r2c/c2r path counts (launches, plain calls): {runs['r2c'][0]}")

    for label, shape, bd, inv, packed, norm in real_cases + [
            ("256^3 r2c/c2r round trip", (256, 256, 256), 0, None, False,
             None)]:
        dims = (-3, -2, -1)
        if inv is None:
            ref = inputs["256^3 r2c ortho"][1].double()
            what = "the input"
        elif inv:
            ref = torch.fft.irfftn(inputs[label][1].to(torch.complex128),
                                   s=shape[bd:], dim=dims, norm=norm)
            what = "complex128 irfftn"
        else:
            ref = torch.fft.rfftn(inputs[label][1].double(), dim=dims,
                                  norm=norm)
            what = "complex128 rfftn"
        got = results[label]
        if inv is False:
            lanes = shape[-1] // 2 + (0 if packed else 1)
            if tuple(got[0].shape) != (*shape[:-1], lanes):
                raise AssertionError(f"{label}: shape {tuple(got[0].shape)}")
            if packed:
                got = ot.unpack_rfft3d(*got)
            err = _rel_err(*got, ref)
        else:
            if tuple(got.shape) != shape:
                raise AssertionError(f"{label}: shape {tuple(got.shape)}")
            err = _rel_err(got, None, ref)
        print(f"path {label}: rel err vs {what} {err:.3e} "
              f"(tol {TOL_PATH:g}) {tag}", flush=True)
        if err > TOL_PATH:
            raise AssertionError(f"{label}: error {err:.3e}")
        del ref, got
    del results, inputs
    torch.cuda.empty_cache()

    # ---- 4. the counters -----------------------------------------------
    path_kernels = {"c2c": ("fft_last", "fft_axis", "fft_slab"),
                    "r2c": ("fft_axis", "rfft_slab", "irfft_slab",
                            "assemble_mp1")}
    for path, (counts, launched) in runs.items():
        for name in path_kernels[path]:
            if launched[name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     f"{path} path")
        plain = {k: v[1] for k, v in counts.items() if v[1]}
        if plain:
            raise AssertionError(f"plain versions ran on the {path} path: "
                                 f"{plain}")
        print(f"{path} path launches per kernel: {launched}; plain calls: 0")
    launches = {k: sum(r[1][k] for r in runs.values()) for k in ff.KERNELS}

    # ---- 5. times --------------------------------------------------------
    def show(label, r, extra=""):
        print(f"time {label}: median {r['median_ms']:.4f} ms, min "
              f"{r['min_ms']:.4f}, max {r['max_ms']:.4f}, spread "
              f"{r['spread']:.3f} over {r['reps']}{extra} {tag}", flush=True)

    for n in (256, 512):
        shape = (n, n, n)
        xr, xi = _pair(shape, gen)
        pf = ot.plan(shape, "complex64", planar=True)
        xc = torch.complex(xr, xi)
        flops = 5 * n ** 3 * math.log2(n ** 3)
        r_port = time_cuda(pf, ((xr, xi),))
        r_cufft = time_cuda(torch.fft.fftn, (xc,))
        show(f"port fwd {n}^3", r_port,
             f", {flops / r_port['median_ms'] / 1e6:.1f} GFLOP/s")
        show(f"torch.fft.fftn (cuFFT) c64 {n}^3", r_cufft,
             f", {flops / r_cufft['median_ms'] / 1e6:.1f} GFLOP/s")
        if n == 256:
            pi = ot.plan(shape, "complex64", planar=True, inverse=True)
            show("port inv 256^3", time_cuda(pi, ((xr, xi),)))
            # the two x routes, called directly
            def padded():
                a = ff.fft_slab_yz(xr, xi, zpad=8)
                return ff.fft_x_from_padded(*a, n)

            def sublane():
                a = ff.fft_slab_yz(xr, xi)
                return ff.fft_sublane(*a, 0)
            show("x route padded (slab zpad + fft_x_from_padded) 256^3",
                 time_cuda(padded))
            show("x route sublane (slab + fft_sublane) 256^3",
                 time_cuda(sublane))
        # the slab against the unfused z + y passes (its L2 read-back)
        def unfused():
            a = ff.fft_last(xr, xi)
            return ff.fft_sublane(*a, 1)
        r_slab = time_cuda(ff.fft_slab_yz, (xr, xi))
        r_two = time_cuda(unfused)
        bytes_ = 16 * n ** 3
        show(f"slab {n}^3 (one launch)", r_slab,
             f", {bytes_ / r_slab['median_ms'] / 1e6:.1f} GB/s per "
             "read+write")
        show(f"unfused z+y (fft_last + fft_sublane) {n}^3", r_two,
             f", {2 * bytes_ / r_two['median_ms'] / 1e6:.1f} GB/s")
        del xr, xi, xc
        torch.cuda.empty_cache()

    # r2c / c2r: the port in both layouts against cuFFT; 2.5 N log2 N
    # flops, half of the c2c convention
    for n in (256, 512):
        shape = (n, n, n)
        x = torch.randn(shape, generator=gen, device="cuda")
        w = torch.fft.rfftn(x)
        flops = 2.5 * n ** 3 * math.log2(n ** 3)
        rate = ", {:.1f} GFLOP/s"
        r = time_cuda(torch.fft.rfftn, (x,))
        show(f"torch.fft.rfftn (cuFFT) f32 {n}^3", r,
             rate.format(flops / r["median_ms"] / 1e6))
        r = time_cuda(lambda: torch.fft.irfftn(w, s=shape))
        show(f"torch.fft.irfftn (cuFFT) c64 {n}^3", r,
             rate.format(flops / r["median_ms"] / 1e6))
        for packed in (False, True):
            kw = {"real": True, "planar": True, "packed": packed}
            layout = "packed" if packed else "numpy"
            p_fwd = ot.plan(shape, "float32", **kw)
            r = time_cuda(p_fwd, (x,))
            show(f"port r2c {layout} {n}^3", r,
                 rate.format(flops / r["median_ms"] / 1e6))
            spec = p_fwd(x)
            p_inv = ot.plan(shape, "float32", inverse=True, **kw)
            r = time_cuda(p_inv, spec)
            show(f"port c2r {layout} {n}^3", r,
                 rate.format(flops / r["median_ms"] / 1e6))
            del spec
        del x, w
        torch.cuda.empty_cache()

    report = []
    for name, info in ff.KERNELS.items():
        fn, call = per_kernel[name]["call"]
        x = _pair(per_kernel[name]["shape"], gen)
        r_k = time_cuda(call, (fn, x))
        r_p = time_cuda(call, (fn.plain, x), warmup=1, reps=5)
        show(f"kernel {name} via {fn.__name__} "
             f"{per_kernel[name]['shape']}", r_k)
        show(f"plain {name} via {fn.__name__} "
             f"{per_kernel[name]['shape']}", r_p)
        if name == "fft_axis":
            # the c2r x pass rides the same kernel
            xt = _pair((256, 256, 129), gen)

            def to_padded(f):
                return f(*xt, z_true=128, inverse=True)
            show("kernel fft_axis via fft_x_to_padded (256, 256, 129)",
                 time_cuda(to_padded, (ff.fft_x_to_padded,)))
            show("plain fft_axis via fft_x_to_padded (256, 256, 129)",
                 time_cuda(to_padded, (ff.fft_x_to_padded.plain,), warmup=1,
                           reps=5))
            del xt
        report.append({"name": name, "route": "cuda",
                       "source": info["source"],
                       "replaces": info["replaces"],
                       "launches": launches[name],
                       "max_abs_err": per_kernel[name]["max_abs_err"],
                       "ms": r_k["median_ms"], "plain_ms": r_p["median_ms"]})
        del x
    print(card)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
