"""The dense core (``csrc/fft_core.cuh``) under each kernel that runs it:
every register-core predicate of ``fused_fft`` patched off, each kernel
at a shape of the main path, its time by CUDA events (median of 20) and
its largest error against its plain version over three draws (max |got
- want| / max |want|, the measure of ``chip_smoke.py``'s phase 2).

The cases: the dense cube at (8, 128, 128, 128) and the inverse
(4, 64, 64, 128) (stages of 64 and 128 terms), the c2c slab at 256^3
(16, 16) and 320^3, the strided axis at 256^3, ``rfft_last`` at
(36864, 192) and ``icrfft_last`` at (36864, 96) (one stage of 96), and
the four-step pair at 4096 x 4096.

    python -m offt_tpu_torch.bench.dense_core   # one JSON line, the card's
                                                # name and power limit first

A tree's package is the one imported, so two trees (a parent checkout
and the change) compare in one call on one card by running the file
with each tree's root first on the path:

    PYTHONPATH=<tree> python offt_tpu_torch/bench/dense_core.py
"""

from __future__ import annotations

import contextlib
import json

import torch

from offt_tpu_torch.kernels import fourstep as fs
from offt_tpu_torch.kernels import fused_fft as ff

# the register-core predicates of fused_fft (chip_smoke.py's _dense_core)
REG_PREDICATES = ("_reg_core", "_reg_real_rows", "_reg_rows", "_reg_axis",
                  "_reg_slab", "_reg_rslab", "_reg_cube")

# (name, wrapper, call, input shape, planes in)
CASES = (
    ("fft_cube", ff.fft3d_cube, lambda f, x: f(*x), (8, 128, 128, 128), 2),
    ("fft_cube inverse", ff.fft3d_cube,
     lambda f, x: f(*x, inverse=True), (4, 64, 64, 128), 2),
    ("fft_slab", ff.fft_slab_yz, lambda f, x: f(*x), (256, 256, 256), 2),
    ("fft_slab", ff.fft_slab_yz, lambda f, x: f(*x), (320, 320, 320), 2),
    ("fft_axis", ff.fft_sublane, lambda f, x: f(*x, 0), (256, 256, 256), 2),
    ("rfft_last", ff.rfft_last_planar,
     lambda f, x: f(x[0], packed=False), (36864, 192), 1),
    ("icrfft_last", ff.icrfft_last_planar, lambda f, x: f(*x),
     (36864, 96), 2),
    ("step1_twiddle", fs._step1_twiddle,
     lambda f, x: f(*x, x[0].shape[1], x[0].shape[2], None, False),
     (1, 4096, 4096), 2),
    ("step3_transposed", fs._step3_transposed,
     lambda f, x: f(*x, x[0].shape[1], x[0].shape[2], None, False),
     (1, 4096, 4096), 2),
)


@contextlib.contextmanager
def dense_core():
    """Every length routed to the dense core while inside (a predicate
    that an older tree lacks is set, then taken away)."""
    keep = [getattr(ff, k, None) for k in REG_PREDICATES]
    for k in REG_PREDICATES:
        setattr(ff, k, lambda *n: False)
    try:
        yield
    finally:
        for k, f in zip(REG_PREDICATES, keep):
            if f is None:
                delattr(ff, k)
            else:
                setattr(ff, k, f)


def rel_err(got, want) -> float:
    """max |got - want| over max |want|, over every plane."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    d = max((g - w).abs().max().item() for g, w in zip(got, want))
    return d / max(w.abs().max().item() for w in want)


def _median_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return sorted(ts)[len(ts) // 2]


def run(device: str = "cuda", cases=CASES, draws: int = 3, reps: int = 20,
        seed: int = 0) -> list:
    """One row a case: name, shape, ``ms`` (None on the CPU, where the
    wrappers run their plain versions) and ``errs``, one a draw."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    rows = []
    with dense_core():
        for name, fn, call, shape, planes in cases:
            errs = []
            for _ in range(draws):
                x = tuple(torch.randn(shape, generator=gen, device=device)
                          for _ in range(planes))
                errs.append(rel_err(call(fn, x), call(fn.plain, x)))
            ms = None
            if device != "cpu":
                ms = _median_ms(lambda: call(fn, x), reps)
            rows.append({"name": name, "shape": list(shape), "ms": ms,
                         "errs": errs})
            del x
            if device != "cpu":
                torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("dense_core times the kernels on a CUDA card")
    from offt_tpu_torch.bench.runfft import device_label
    from offt_tpu_torch.kernels import _build
    _build.library()
    print(json.dumps({"device": device_label(torch.device("cuda")),
                      "rows": run()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
