"""The stage product's rate and error by precision tier on the card: the
H100 counterpart of the reference's v5e probe
``docs/receipts/probe_mxuwidth.py``.

The TPU probe timed the stack6 stacked-dot construct (the inner loop of
every reference kernel) against the MXU's lane width L. Its function, R
dependent iterations of

    acc <- sum_k G_k w_k(acc) + c acc,   c = 0.25

on a (128, L) f32 operand, runs here as the CUDA kernel
``kernels/csrc/probe_mma.cu`` (wrapper :func:`probe_mma`) at five
variants:

- ``stack6``: G (128, 768) bf16, w = (x0, x1, x2, x0, x1, x0) the 3-word
  bf16 split of acc, one accumulator over K = 768 (the reference's
  ``concat``); ``stack6-six``: six K = 128 products, summed (``six``);
- ``3xtf32``: G (128, 128) f32 split into TF32 hi and lo, acc likewise,
  gl ah + gh al + gh ah on the tensor cores;
- ``tf32``: one TF32 product;
- ``fma``: the f32 product on the CUDA cores, as the dense core's MAC loop
  (``fft_core.cuh``) runs it.

TF32 here keeps the top 10 mantissa bits (``tf32``: the bits masked, a
value the tensor cores take exactly). The kernel runs B operands, one a
block, B the card's SM count, so a rate is the card's. A block holds 128
lanes in its warps' registers; a wider operand runs as chunks of 128
lanes in turn (the lanes are independent), so on the H100 L sets only
how many chunks a block walks: the width that matters is the mma tile's.

:func:`ledger` prints one row per (variant, L) at the reference's cases
(L, R) = (1024, 512), (512, 1024), (256, 2048), (128, 4096) (``six`` at
(1024, 512) alone, as there): microseconds a call, TFLOP/s (2 x the MACs
of the variant's products), the share of its tier's peak
(``roofline.CHIPS``) and the yardstick, one ``torch.matmul`` of one
iteration's product over the B operands at the tier's precision (bf16;
TF32 with ``allow_tf32``; f32), timed only. :func:`accuracy_rows` gives
each variant's relative error on one stage product of a 128-point DFT
(G the cos and sin blocks, a complex product as four real ones) against
float64, the largest over :data:`SEEDS` x :data:`WIDTHS` draws, beside
the repo's 1e-6 bar and the variant's :data:`CEILING` on the card: which
Hopper tier may stand for the reference's ``stack6`` / ``stack3`` /
``default``.

    python -m offt_tpu_torch.bench.probe_mxuwidth          # on the card
    python -m offt_tpu_torch.bench.probe_mxuwidth --device cpu --accuracy
"""

from __future__ import annotations

import argparse
import json
import math

import torch

ROWS = 128                 # rows of acc: each product's K
LANES = 128                # lanes a block holds at once (the kernel's)
C = 0.25                   # the reference's feedback factor
VARIANTS = ("stack6", "stack6-six", "3xtf32", "tf32", "fma")
_CODES = {"stack6": 0, "stack6-six": 1, "3xtf32": 2, "tf32": 3, "fma": 4}
# the reference's (L, R): MACs a call level across L
CASES = ((1024, 512), (512, 1024), (256, 2048), (128, 4096))
BAR = 1e-6                 # the repo's f32 accuracy bar
SEEDS = (0, 1, 2)          # the accuracy rows' draws: each seed at
WIDTHS = (128, 256, 512, 1024)  # each width L
LEDGER_REPS = 5
# each variant's DFT-stage error on the card (:func:`accuracy_rows`, the
# largest of the draws) may not exceed these: the H100's readings (9.2e-7,
# 1.15e-7, 1.17e-6, 6.6e-4, 2.04e-7; within 1.5% across the draws) with
# a margin below what one dropped or garbled low-order product adds
# (stack6's x2 or g2 block, about 1.4e-6; a 3xtf32 correction, 5e-4)
CEILING = {"stack6": 1.0e-6, "stack6-six": 1.5e-7, "3xtf32": 1.3e-6,
           "tf32": 7e-4, "fma": 2.5e-7}


def tier(variant: str) -> str:
    """The precision tier of a variant (its ``roofline.MMA_TIERS`` key)."""
    return variant.split("-")[0]


def tf32(a: torch.Tensor) -> torch.Tensor:
    """``a`` with the low 13 mantissa bits cleared: a TF32 value."""
    return (a.contiguous().view(torch.int32) & -8192).view(torch.float32)


def split3(a: torch.Tensor) -> tuple:
    """The 3-word bf16 split of f32 ``a``, as f32 values (the reference's
    ``split3``): x0 = bf16(a), x1 = bf16(a - x0), x2 = bf16(a - x0 - x1)."""
    x0 = a.to(torch.bfloat16).float()
    r = a - x0
    x1 = r.to(torch.bfloat16).float()
    x2 = (r - x1).to(torch.bfloat16).float()
    return x0, x1, x2


def stack_table(t: torch.Tensor) -> torch.Tensor:
    """The (128, 768) bf16 stack6 table of a (128, 128) f32 one: its words
    (g0, g0, g0, g1, g1, g2), so that against w = (x0, x1, x2, x0, x1, x0)
    the product is the six significant terms of t x."""
    g0, g1, g2 = split3(t.float())
    return torch.cat([g0, g0, g0, g1, g1, g2], dim=1).to(torch.bfloat16)


def _step(variant: str, g: torch.Tensor, a: torch.Tensor,
          c: float) -> torch.Tensor:
    if variant in ("stack6", "stack6-six"):
        x0, x1, x2 = split3(a)
        ws = (x0, x1, x2, x0, x1, x0)
        gf = g.float()
        if variant == "stack6":
            y = gf @ torch.cat(ws, dim=-2)
        else:
            y = None
            for k, w in enumerate(ws):
                p = gf[:, ROWS * k:ROWS * (k + 1)] @ w
                y = p if y is None else y + p
    elif variant == "3xtf32":
        gh, ah = tf32(g), tf32(a)
        gl, al = tf32(g - gh), tf32(a - ah)
        y = (gl @ ah + gh @ al) + gh @ ah
    elif variant == "tf32":
        y = tf32(g) @ tf32(a)
    else:
        y = g @ a
    return y + c * a


def _plain(x, g, reps: int, variant: str = "stack6", c: float = C):
    """The plain PyTorch version of :func:`probe_mma`: the same split words
    (bf16 by ``.to(torch.bfloat16)``, TF32 by :func:`tf32`) through f32
    matmuls: exact products of bf16 or TF32 values, summed in f32 in
    another order than the tensor cores'. It models what the split words
    cost, not the tensor cores' running accumulator, which truncates the
    small terms at its alignment: its error against float64 is a lower
    bound on the kernel's, not a model of it."""
    _check(x, g, variant, reps)
    a = x
    for _ in range(reps):
        a = _step(variant, g, a, c)
    return a.clone() if reps == 0 else a


def _check(x, g, variant, reps) -> None:
    if variant not in _CODES:
        raise ValueError(f"variant {variant!r}: one of {VARIANTS}")
    if x.dtype != torch.float32 or x.dim() != 3 or x.shape[1] != ROWS:
        raise ValueError(f"x must be float32 (B, {ROWS}, L), got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.shape[2] < LANES or x.shape[2] % LANES:
        raise ValueError(f"L must be a multiple of {LANES}, got "
                         f"{x.shape[2]}")
    want = ((ROWS, 6 * ROWS), torch.bfloat16) if tier(variant) == \
        "stack6" else ((ROWS, ROWS), torch.float32)
    if tuple(g.shape) != want[0] or g.dtype != want[1]:
        raise ValueError(f"{variant} takes G {want[1]} {want[0]}, got "
                         f"{g.dtype} {tuple(g.shape)}")
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("x and G must be contiguous")
    if g.device != x.device:
        raise ValueError(f"G on {g.device}, x on {x.device}")
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")


def probe_mma(x: torch.Tensor, g: torch.Tensor, reps: int,
              variant: str = "stack6", c: float = C) -> torch.Tensor:
    """``reps`` iterations of acc <- G w(acc) + c acc on each of the B
    (128, L) f32 operands of ``x`` (kernel ``csrc/probe_mma.cu``): a new
    tensor. ``g`` is the (128, 768) bf16 stacked table for ``stack6`` /
    ``stack6-six`` (:func:`stack_table`), else (128, 128) f32. A CUDA
    tensor launches the kernel; a CPU one runs the plain version."""
    _check(x, g, variant, reps)
    if x.device.type == "cpu":
        probe_mma.plain_calls += 1
        return _plain(x, g, reps, variant, c)
    from ..kernels import _build
    from ..kernels.fused_fft import _launch
    y = torch.empty_like(x)
    _launch("offt_probe_mma", (x, y, g), (),
            [x.shape[0], x.shape[2], reps, _build._F(c), _CODES[variant]])
    probe_mma.launches[variant] += 1
    return y


probe_mma.plain = _plain
probe_mma.launches = dict.fromkeys(VARIANTS, 0)
probe_mma.plain_calls = 0


def reset_counts() -> None:
    probe_mma.launches = dict.fromkeys(VARIANTS, 0)
    probe_mma.plain_calls = 0


def table(variant: str, t: torch.Tensor) -> torch.Tensor:
    """The G a variant takes for the (128, 128) f32 table ``t``."""
    return stack_table(t) if tier(variant) == "stack6" else t.float()


def inputs(variant: str, b: int, lanes: int, device, seed: int = 0):
    """(x, G) of a timing row: x ~ N(0, 1), G ~ 2e-3 N(0, 1), the
    reference's scales (its stack6 G drawn bf16 directly)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((b, ROWS, lanes), generator=gen, device=device)
    if tier(variant) == "stack6":
        g = (2e-3 * torch.randn((ROWS, 6 * ROWS), generator=gen,
                                device=device)).to(torch.bfloat16)
    else:
        g = 2e-3 * torch.randn((ROWS, ROWS), generator=gen, device=device)
    return x, g


def dft_draw(seed: int, lanes: int) -> tuple:
    """(cos, sin, xr, xi, Y64) of one accuracy draw, float64 on the CPU:
    the cos and sin of 2 pi j k / 128, a complex (1, 128, ``lanes``)
    operand X = xr + i xi, and Y64 = F X, F = cos - i sin."""
    k = torch.arange(ROWS, dtype=torch.float64)
    ang = 2 * math.pi * torch.outer(k, k) / ROWS
    cos, sin = torch.cos(ang), torch.sin(ang)
    gen = torch.Generator()
    gen.manual_seed(seed)
    xr = torch.randn((1, ROWS, lanes), generator=gen, dtype=torch.float64)
    xi = torch.randn((1, ROWS, lanes), generator=gen, dtype=torch.float64)
    return cos, sin, xr, xi, torch.complex(cos @ xr + sin @ xi,
                                           cos @ xi - sin @ xr)


def dft_products(variant: str, draw, device) -> list:
    """[(G, A)] of a draw's four real products, Re Y = C Xr + S Xi and
    Im Y = C Xi - S Xr, as ``variant`` takes them on ``device``."""
    cos, sin, xr, xi, _ = draw
    gc, gs = (table(variant, t.float().to(device)) for t in (cos, sin))
    ar, ai = (t.float().to(device) for t in (xr, xi))
    return [(gc, ar), (gs, ai), (gc, ai), (gs, ar)]


def accuracy_rows(device="cuda") -> list[dict]:
    """Each variant's relative error ||Y - Y64|| / ||Y64|| on one stage
    product of a 128-point DFT (:func:`dft_draw`), the four real products
    through :func:`probe_mma` (on the CPU its plain version: a lower
    bound on the card's error) at R = 1, c = 0, the sums of two in f32:
    the largest over the :data:`SEEDS` x :data:`WIDTHS` draws, with the
    draw it came from."""
    draws = {(s, n): dft_draw(s, n) for s in SEEDS for n in WIDTHS}
    rows = []
    for variant in VARIANTS:
        worst = (-1.0, None)
        for key, draw in draws.items():
            p = [probe_mma(a, g, 1, variant, 0.0)
                 for g, a in dft_products(variant, draw, device)]
            got = torch.complex((p[0] + p[1]).double(),
                                (p[2] - p[3]).double()).cpu()
            err = (torch.linalg.vector_norm(got - draw[4])
                   / torch.linalg.vector_norm(draw[4])).item()
            worst = max(worst, (err, key))
        err, (seed, lanes) = worst
        rows.append({"probe": "mxuwidth accuracy", "variant": variant,
                     "rel_err": err, "seed": seed, "L": lanes,
                     "draws": len(draws), "bar": BAR, "meets_bar": err <= BAR,
                     "ceiling": CEILING[variant]})
    return rows


def _matmul_call(variant: str, b: int, lanes: int, gen):
    """(fn, ops) of the yardstick: one torch.matmul of one iteration's
    product over the b operands at the variant's precision."""
    k = 6 * ROWS if tier(variant) == "stack6" else ROWS
    dt = torch.bfloat16 if tier(variant) == "stack6" else torch.float32
    g = torch.randn((ROWS, k), generator=gen, device="cuda").to(dt)
    w = torch.randn((b, k, lanes), generator=gen, device="cuda").to(dt)
    use_tf32 = tier(variant) in ("3xtf32", "tf32")

    def call():
        keep = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = use_tf32
        try:
            return torch.matmul(g, w)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = keep
    return call, 2 * b * ROWS * k * lanes


def ledger() -> list[dict]:
    """One row per (variant, L): the kernel's time and rate over B = the
    card's SM count operands, its share of the tier's peak, and the
    yardstick's."""
    from ..obs.profile import time_cuda
    from .roofline import CHIPS, MMA_TIERS, kernel_work
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for variant in VARIANTS:
        peak = CHIPS["h100"].peak_flops(MMA_TIERS[tier(variant)][1])
        for lanes, r in CASES:
            if variant == "stack6-six" and (lanes, r) != CASES[0]:
                continue
            x, g = inputs(variant, sms, lanes, "cuda")
            ms = time_cuda(probe_mma, (x, g, r, variant), warmup=1,
                           reps=LEDGER_REPS)["median_ms"]
            flops = kernel_work(f"probe_mma:{tier(variant)}",
                                (sms, lanes, r))[1]
            call, mflops = _matmul_call(variant, sms, lanes, gen)
            mm_ms = time_cuda(call, ahead=True)["median_ms"]
            rows.append({"probe": "mxuwidth", "variant": variant,
                         "L": lanes, "R": r, "B": sms,
                         "us_per_call": ms * 1e3,
                         "tflops": flops / ms / 1e9,
                         "of_peak": flops / ms / 1e-3 / peak,
                         "matmul_us": mm_ms * 1e3,
                         "matmul_tflops": mflops / mm_ms / 1e9})
            del x, g
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="probe_mxuwidth")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--accuracy", action="store_true",
                    help="only the accuracy rows")
    ns = ap.parse_args(argv)
    rows = accuracy_rows(ns.device)
    if not ns.accuracy:
        rows += ledger()
    for row in rows:
        print(json.dumps(row))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
