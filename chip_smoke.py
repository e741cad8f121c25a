#!/usr/bin/env python3
"""Drive offt_tpu_torch's main paths once on one NVIDIA GPU and check them.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. the card's name and power limit; the kernels built from ``csrc/``
   with nvcc, timed;
2. each CUDA kernel against its plain PyTorch version on the card, at a
   small shape and at the main-path shape (max |kernel - plain| /
   max |plain| <= 1e-6, pad lanes excluded, float32 matmuls pinned to
   full precision); the two row kernels (``fft_last``, ``rfft_last``) on
   a length of each core, register (``csrc/fft_regs.cuh``) and dense,
   ``fft_last`` also on the mixed rows ((102400, 320), the 320^3 slab's z
   rows as a batch, and (65536, 192)) on both cores,
   ``rfft_last`` and the packed c2r rows (``icrfft_last``: (65536, 128)
   among them) also on the mixed real rows (``csrc/real_rows_mix.cu``:
   ``rfft_last`` (36864, 192) in both layouts, (300, 96), (37, 6144);
   ``icrfft_last`` (36864, 96), (300, 48), (37, 3072); the dense core at
   M = 72), and the three slab kernels (``fft_slab``, ``rfft_slab``,
   ``irfft_slab``), the strided-axis kernel (``fft_axis``: its four
   wrappers, in place, the 64 x 1024^2 y pass, columns of 2048 and 4096,
   and the mixed lengths: the 320^3 x pass, 192^3's axes, a 768 column)
   and the four-step pair (``step1_twiddle``, ``step3_transposed``: the
   long 1-D splits of 2^20, 8 x 2^20, 2^22 and 2^24, the inner 2^21 of
   3g's prime, one rank's shard of 2^24 and of 2^20 on a 2 x 2 mesh
   (step 1 on (1, n1, n2/4) with the rank's twiddle chunk, step 3 on
   (1, n1/4, n2)), few lanes at n1 = 4096,
   few rows at n2 = 4096, inverse, a caller's table, the mixed splits of
   3 * 2^18) and the cube (``fft_cube``: 8 x 128^3, 4 x 64^2 x 128, a
   short x (3 x 8 x 16 x 256; x of 3 and 12, on the table's roots; x of
   5 beside the split z), the split z at 8 x 8 x 32768 and
   3 x 16 x 8 x 16384, a mixed y that keeps the dense kernel) at each
   shape on both cores (the register predicates patched off for the dense
   one), with the core, the register layout (two grids or one of
   clusters, ``fused_fft._cluster_slab``, ``_cluster_irslab`` for the
   c2r), the lane tile (``fused_fft._axis_tile``) and the cube's G, split,
   barriers and cooperative grid printed; and the probes' kernels:
   ``probe_mma`` (``bench/probe_mxuwidth.py``) at each variant (stack6
   chained and as six products, 3xtf32, tf32, fma) on the ledger's
   operands (B = the SM count, L = 128-1024) at R = 1 against its plain
   version (1e-6; the tensor cores' sums run in their own order and
   alignment) and on the four real products of a 128-point DFT stage at
   c = 0 (``TOL_MMA_DFT``, 5e-7 to 2.5e-6), each variant's error on that
   stage against float64 (the largest of 12 draws) within its ceiling
   (``probe_mxuwidth.CEILING``), and the r2c slab's wider-tile codes
   (``bench/probe_ryconcat.py``: y16, y32, grids_wide) against its full
   kernel at 512^3 (1e-6);
3. the paths through ``offt_tpu_torch.plan`` on the card, each
   result against complex128 ``torch.fft`` (||y - ref|| / ||ref|| <=
   1e-6), each path run with the launch counters zeroed just before it
   and read just after:
   a. the planar c2c path (``fftn``; 320^3 forward and inverse);
   b. the packed r2c/c2r path (``real=True``, numpy and packed layouts,
      256^3 and 512^3; ``rfftn`` / ``irfftn``);
   c. long 1-D c2c, ``plan((1, 1, N))`` by the four-step kernels, at
      2^20 (forward, inverse, an ortho round trip), 8 x 2^20, 2^22, 2^24,
      3 * 2^18 (the measured split), 10^6 (the 4-pass route) and one
      complex64 (``planar=False``) case (``fft`` / ``ifft``);
   d. the unfused real route: 256^3 with ``planar=False``, 192^3 and
      320^3 outside the packed gate (``rfft_last`` at M = 96 and 160 on
      the mixed real rows) and a long real 1-D (1, 1, 2^21) (``rfftn`` /
      ``irfftn``);
   e. the distributed pencil engine, ``plan(..., mesh=make_mesh(1, 1))``
      in a world of one rank on NCCL (its exchanges have a group of one
      and are skipped, as in the reference; the chunks, the ry split, the
      pad and slice points and the real z stages run): 256^3 c2c with the
      default knobs and with t = 4, w = 1, ry = 5; 256^3 r2c / c2r packed
      (the c2r stage is ``icrfft_last``) and in the numpy layout; 512^3
      and 192^3 (``icrfft_last`` at M = 96) packed r2c / c2r; a
      ``batch_sharded`` 4 x 128^3 c2c;
   f. the cube kernel through ``fft3d_cube``: 8 x 128^3 forward and
      inverse, and the longest z the gate admits, 8 x 8 x 32768 (the
      register cube's split z: the four-step pair's bodies);
   g. the ``numpy.fft`` namespace ``offt_tpu_torch.fft`` at full size:
      ``fftn`` of 256^3 complex64, ``rfftn`` / ``irfftn`` of 256^3,
      ``fft`` of the prime 1,000,003 (Bluestein, its inner 2^21 on the
      four-step kernels), ``fftn`` over a 4-D (8, 64, 64, 64) field, and
      complex128 ``fftn`` of 128^3 against the fp64 bar (1e-12);
   h. the backward path (``plan/autodiff.py``): the gradient of
      sum(w |y|^2) through 256^3 planar c2c (forward and inverse, norms
      backward and ortho), 256^3 complex c2c, 256^3 r2c and r2c -> c2r
      (numpy and packed layouts; the c2r's through a low-pass, real and
      symmetric in the packed layout, with a random phase a bin in the
      numpy layout, whose twin takes the plan's edge rule), 192^3 r2c ->
      c2r on the unfused real route, the (1, 1, 2^22) long 1-D c2c,
      ``fft2d`` of 64 x 1024^2 and the 1 x 1 mesh's 256^3 c2c and packed
      r2c -> c2r, each against ``torch.autograd.grad`` of the same loss
      through complex128 ``torch.fft`` (1e-6); ``torch.func.jvp`` through
      the 256^3 planar c2c (1e-6) and a grad of grad through the 256^3
      complex c2c (1e-5: four transforms on its path); and 5 SGD steps of
      the FNO spectral convolution of examples/fno_layer.py at 4 x 128^3
      with 16 modes a side, bins 0..15 as the example takes them (the
      loss falls at every step; the step-0 weight gradient within 1e-5
      of its complex128 twin, whose c2r states the plan's edge rule off
      the half-spectra of real signals, ``_c2r_edges``). Each backward
      runs with the launch counters zeroed just before and read just
      after;
   i. the distributed long-1-D engine (``dist/long1d.py``) in 3e's world
      of one rank: through ``_split=`` (at P = 1 no ``plan()`` reaches
      it; its exchanges and mirror hops are groups of one) c2c 2^24
      forward and inverse, an ortho round trip at 2^20, the packed r2c
      and c2r of a real 2^24; the adjoints autodiff builds for its route
      at 2^24 (c2c, packed r2c), held by the transpose identity
      <F x, y> = <x, F^H y> (1e-6 of |F x| |y|); ``plan((1, 1, 2^24),
      mesh=...)`` on the pencil route, as the reference routes it; and
      the namespace under ``use_mesh(make_mesh(1, 1))``: ``fft`` of
      2^22, ``fftn``, ``rfftn``, ``irfftn`` of 256^3;
   j. the tuner (``offt_tpu_torch.tune``) at full size, its trials timed
      by CUDA events, the plan cache in a temporary directory: a brute
      force over every point of (1, 1, 3 * 2^18) c2c's space (split_1d,
      block_batch), Nelder-Mead over 144^3 r2c's (the radices and
      block_batch of the dense rfft_last at M = 72 and of the dense axes
      of 144; 12 trials), and 256^3 c2c, whose space is
      empty (nothing to search: the default point timed); each with its
      space, trials, default and best time, speedup and winner, best <=
      default after the refinement pass, the winner read back from the
      cache by a plan built with no params and keeping the kernels
      (``use_pallas=1``), that plan against complex128 ``torch.fft``
      (1e-6), and the event log read back;
   k. the bench layer (``offt_tpu_torch.bench``) through its entry points:
      ``runfft.main`` at 256^3 c2c with ``--verify`` (``-a offt``; ``-a
      torch``, cuFFT), r2c ``--packed --verify``, r2c ``--verify`` (the
      numpy layout) and c2r ``-i --verify`` (each --verify rel_err,
      seeded and golden input, within 1e-6; 20 calls each), then
      ``baseline_suite.main()``: configs 1 (2^20 c2c), 2 (256^3), 4
      (1024^3 r2c and c2r, packed) and 5 (64 x 256^3), each against
      complex128 ``torch.fft`` (1e-6), config 3 its skipped line (one
      card); each in a counter window of its own;
   l. the probes through their entry points: ``probe_mma`` at each
      variant over the ledger's cases, each r2c slab code at 512^3, each
      in a counter window of its own;
   m. the port's examples (``examples_torch/``) 1-7 at their card sizes
      through their ``main``, each in a counter window of its own, where
      each asserts its own checks (the reference example's) and must
      launch at least one kernel, no plain version and no stage of the
      unfused engine (``stockham._fft_last`` counted): the deconvolution
      gradient at 256^3, jacfwd and jvp at 256^3, 5 SGD steps of the FNO
      layer at 4 x 128^3 (16 modes; its first step's weight gradient also
      against complex128 ``torch.fft`` autograd, 1e-5, outside the
      window), the packed low-pass at 256^3, and in
      3e's world of one the Poisson solve and the pencil round trip at
      256^3 and the tone pick of 2^24 samples; each one's time beside its
      ``torch.fft`` twin (the iterative ones whole by the host clock, the
      others' transform step by CUDA events; the twins are built here,
      the examples hold one path); then ``entry()``
      (``__graft_entry_torch__.py``) at 128^3 against complex128
      ``fftn`` (1e-6) and ``dryrun_multichip(1)`` in the world of one;
      then each bundled one-card entry of this card
      (``offt_tpu_torch/plan/tuned_defaults.json``; where it holds none,
      ``one_card_record`` put in the bundled store for the step, so that
      the lookup runs on the card): a ``plan()`` with no
      params must read it (an empty local cache), its output against
      complex128 ``torch.fft`` (1e-6), its time beside the default
      point's (median of 20, three runs each);
4. the launch counters: every kernel of a path ran in that path's run, no
   plain version did; the register core ran ``fft_last`` on 3a (its one
   length there, N = 1024) and ``rfft_last`` on every r2c of 3d (N = 256,
   192 and 320) and of 3e, ``fft_slab`` on every case of 3a (the
   320^3 slab on the mixed rows and columns, two grids), ``rfft_slab`` on every
   slab of 3b, ``fft_axis`` on every x pass of 3a (256^3, 512^3, 320^3
   on the mixed-radix column variant, in place, the 64 x 1024^2 y pass),
   of 3b (the c2r's ``fft_x_to_padded`` among them) and every axis pass
   of 3d (192^3's and 320^3's among them), ``irfft_slab`` on 3b's 256^3
   and 512^3 c2r, ``icrfft_last`` on every packed c2r of 3e (192^3's
   among them), and ``step1_twiddle``
   / ``step3_transposed`` on every power-of-two split of 3c (step 3
   dense on the 768 side of 3 * 2^18) and throughout 3d and 3g, and the
   register cube on every cube of 3f; every backward of 3h ran the
   kernels of its adjoint route and no plain version, those at 256^3 on
   the register core (``fft_slab``, ``rfft_slab``, ``fft_axis``); every
   engine call of 3i (six forward, two adjoints) ran the four-step pair
   once on the register core, and 3i's namespace and pencil cases their
   kernels; 3j's tunings the kernels of their routes (the four-step pair,
   ``rfft_last``, ``fft_axis``, ``fft_slab``), and each tuned plan, in a
   window of its own, those of its route; 3k's runfft window the slab
   route's kernels (``fft_slab``, ``fft_axis``, ``rfft_slab``,
   ``irfft_slab``), its suite window those and the four-step pair; each
   of 3l's windows its variant's launches or one ``rfft_slab`` launch on
   the register core;
5. CUDA-event times: the port against cuFFT (c2c, r2c, c2r at 256^3 and
   512^3; ``fft`` at 2^20, 8 x 2^20, 2^22, 2^24, there each kernel of the
   four-step pair on both cores with its bound and TB/s, and the pair's
   sum against ``torch.fft.fft``; ``rfft`` at 2^21;
   ``rfftn`` against the 256^3 ``planar=False`` plan and the packed
   route), both split orders at 3 * 2^18, the 1 x 1 mesh plans (256^3
   c2c, 256^3 and 512^3 packed c2r) against cuFFT and the single-device
   plans (the pencil pipeline's own overhead), and each kernel against
   its plain version and the one PyTorch call that computes its
   function (``fft_last`` (102400, 320) and ``fft_slab`` (320, 320, 320)
   also, with their TB/s, beside ``torch.fft.fft(dim=-1)`` and ``fft2``;
   the 320^3 path beside ``torch.fft.fftn``); the cube at 8 x 128^3,
   8 x 8 x 32768 and 4 x 64^2 x 128 on the register cube (with its G,
   barriers, cooperative grid and blocks an SM, its bound and its ratios)
   and on the dense kernel, against ``fft3d_planar`` on the same data and
   ``torch.fft.fftn``; the
   namespace calls against their ``torch.fft`` twins; ``torch.profiler``
   breakdowns of the long 1-D, unfused real and 1 x 1 mesh c2r plans,
   the cube and the prime-length ``fft``
   (device time by op, busy share of the host wall); the paths of the
   register-core kernels (64 x 1024^2 c2c, the 256^3 ``planar=False``
   r2c, namespace ``rfftn`` 256^3; 256^3, 512^3 and 320^3 c2c, 192^3
   and 320^3 r2c and c2r (the unfused real route, beside cuFFT's
   ``rfftn`` / ``irfftn``), 256^3 packed and numpy r2c,
   512^3 packed r2c, namespace ``fftn`` 256^3; 256^3 packed and numpy
   c2r, 512^3 packed c2r, namespace ``irfftn`` 256^3; the 1 x 1 mesh's
   packed c2r 256^3) and the nine register-core kernels at their
   main-path shapes, each with the
   register core and with every length routed to the dense core
   (``fused_fft._reg_core``, ``_reg_real_rows``, ``_reg_rows``,
   ``_reg_slab``, ``_reg_rslab``, ``_reg_axis`` and ``_reg_cube``
   patched off), both row
   kernels so at
   every register-core length 16-4096 (``fft_last`` also at every mixed
   length of its rows, beside ``torch.fft.fft``; ``rfft_last`` and
   ``icrfft_last`` at every mixed M of theirs, beside ``torch.fft.rfft``
   and ``irfft``, with their bounds), both slab kernels so
   at 512^3,
   ``fft_axis`` on each of its main-path shapes (with its achieved TB/s)
   and ``irfft_slab`` at 512^3 (two grids), and ``irfft_slab`` in
   clusters against two grids (``_cluster_irslab`` patched off) at 256^3;
   the slabs' phase ledgers
   (``offt_tpu_torch.bench.probe_slabparts`` at 256^3, ``probe_rslab512``
   at 512^3), the strided pass's lane tiles (``probe_yconcat`` at
   N = 256 and 1024) and the four-step pair's tiles and layouts
   (``probe_fourstep`` at 2^20, 8 x 2^20, 2^22, 2^24, and step 1's two
   tiles from 64 to 384 wide blocks), the cube's phases and groups
   (``probe_cube`` at 8 x 128^3, 8 x 8 x 32768 and 64 x 32^2 x 128); the
   first
   and the
   second one-shot ``fft3d`` of
   256^3 (the second reuses the cached plan); the backward path: forward,
   backward alone and both of 3h's loss at 256^3 c2c, r2c and c2r and the
   FNO step at 4 x 128^3, each beside the same through ``torch.fft``
   autograd on complex64 (cuFFT), and the ``torch.profiler`` breakdown
   of one 256^3 c2c backward; the long-1-D engine at P = 1 against the
   single-device plan and ``torch.fft.fft`` at 2^20 and 2^24 (with its
   ``torch.profiler`` busy share), the pair at a 2 x 2 rank's shard
   shapes with their bounds and TB/s, and the per-stage breakdowns
   ``obs/profile.fft3d_breakdown`` and ``pencil_breakdown`` (on the
   1 x 1 mesh) of 256^3 c2c; the probes' ledgers: ``probe_ryconcat``
   (the r2c slab's codes beside full, grids, the dense core and rfft2 at
   512^3, with bytes and TB/s) and ``probe_mxuwidth`` (each variant's
   rate, its share of its tier's peak and one ``torch.matmul`` at its
   precision at (L, R) = (1024, 512), (512, 1024), (256, 2048),
   (128, 4096)).

The line before the last is one JSON object with each kernel's numbers:
its launches on the main paths, its error, its time and the library
call's (device times, the host enqueueing ahead: ``time_cuda(ahead=True)``),
its plain version's time, and its bound (the larger of its bytes at
3.35 TB/s and its f32 operations at 67 TFLOP/s, from the shapes of this
run; ``roofline.CHIPS["h100"]``), and for the two row kernels, the three
slab kernels, ``fft_axis``, the four-step pair and the cube ``dense_ms``,
the dense core's time at the same shape (the pair's two rows also
``pair_library_factor``: their sum over
``torch.fft.fft`` of the whole transform, which computes the pair;
``fft_last``, ``fft_slab``, ``rfft_last`` and ``icrfft_last`` also
``mixed``: the same numbers at their mixed-length shape, (102400, 320),
(320, 320, 320), (36864, 192) (numpy layout; ``mixed_packed`` the packed
one) and (36864, 96); ``fft_cube`` also
``shapes``: its numbers at the three shapes of phase 5); then the probes'
kernels: ``probe_mma:<variant>`` at one iteration of (SMs, 128, 1024)
(bound at the tier's peak: bf16 989, TF32 495, f32 67 TFLOP/s; library:
one ``torch.matmul`` of the product at the tier's precision) and
``rfft_slab:<code>`` at 512^3 (library ``rfft2``), their launches from
3l. Every bound is ``offt_tpu_torch.bench.roofline.kernel_bound``. The
last line is ``{"ok": true, "device": {...}}``.
Without a CUDA device, or without the ``offt_tpu_torch`` package beside
it, the script exits non-zero (2 and 1) and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time

import torch
import torch.distributed as dist

TOL_KERNEL = 1e-6   # kernel vs plain, max-abs relative
TOL_PATH = 1e-6     # plan vs complex128 torch.fft, norm relative (fp32 bar)
TOL_PATH64 = 1e-12  # the same for the fp64 route


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
    """||y - ref|| / ||ref|| of a planar pair, or of one tensor (real or
    complex) when ``yi`` is None."""
    y = yr.to(ref.dtype) if yi is None else torch.complex(yr.double(),
                                                          yi.double())
    if not torch.isfinite(y).all():
        raise AssertionError("non-finite transform output")
    return (torch.linalg.vector_norm(y - ref)
            / torch.linalg.vector_norm(ref)).item()


def _library(name: str, shape, gen):
    """(label, fn, args) of the one PyTorch call that computes a kernel's
    function at its timed shape, or None. Timed only; the port never
    calls it."""
    fft = torch.fft
    if name == "fft_last":
        return "fft(dim=-1)", fft.fft, (torch.complex(*_pair(shape, gen)),
                                        None, -1)
    if name == "fft_axis":
        x, y, zp = shape
        return "fft(dim=0)", fft.fft, (
            torch.complex(*_pair((x, y, zp - 8), gen)), None, 0)
    if name == "fft_slab":
        return "fft2", fft.fft2, (torch.complex(*_pair(shape, gen)),)
    if name == "rfft_slab":
        return "rfft2", fft.rfft2, (torch.randn(shape, generator=gen,
                                                device="cuda"),)
    if name == "irfft_slab":
        p, y, mp = shape
        m = mp - 8
        w = fft.rfft2(torch.randn((p, y, 2 * m), generator=gen,
                                  device="cuda"))
        return "irfft2", fft.irfft2, (w, (y, 2 * m))
    if name == "rfft_last":
        return "rfft", fft.rfft, (torch.randn(shape, generator=gen,
                                              device="cuda"),)
    if name == "icrfft_last":
        # the same rows unpacked: (B, M + 1) complex64
        b, m = shape
        w = fft.rfft(torch.randn((b, 2 * m), generator=gen, device="cuda"))
        return "irfft(dim=-1)", fft.irfft, (w,)
    if name == "fft_cube":
        return "fftn(dim=(-3, -2, -1))", fft.fftn, (
            torch.complex(*_pair(shape, gen)), None, (-3, -2, -1))
    if name in ("step1_twiddle", "step3_transposed"):
        # the four-step pair computes the whole 1-D transform
        return "fft of the whole 1-D", fft.fft, (
            torch.complex(*_pair((math.prod(shape),), gen)),)
    return None


def _short(op: str) -> str:
    """A device op's name without its C++ signature: the port's kernel,
    or the innermost functor that names a PyTorch elementwise kernel."""
    if op.startswith("offt::"):
        return op.split("(")[0]
    names = re.findall(r"\w*Functor\w*|\w+_kernel_cuda|CatArray\w*", op)
    return names[-1] if names else op[:48]


# the kernels whose wrappers count their register-core launches
REG_CORE = ("fft_last", "rfft_last", "fft_slab", "rfft_slab", "fft_axis",
            "irfft_slab", "step1_twiddle", "step3_transposed",
            "icrfft_last", "fft_cube")
# the kernels checked at each shape on both cores (``rfft_last`` runs
# the core its length takes)
BOTH_CORES = ("fft_last", "fft_slab", "rfft_slab", "fft_axis", "irfft_slab",
              "step1_twiddle", "step3_transposed", "icrfft_last", "fft_cube")
# the slab kernels, whose register core runs clusters or two grids
SLABS = ("fft_slab", "rfft_slab", "irfft_slab")
# the mixed-length shapes timed beside the main-path ones, each kernel's
# under the keys of its JSON row: the 320^3 slab's z rows as one batch,
# the 320^3 slab, 192^3's z rows on the unfused real route (r2c, both
# layouts) and 192^3's packed c2r z stage on a 1 x 1 mesh
MIXED_SHAPES = {
    "fft_last": {"mixed": ((102400, 320), lambda f, x: f(*x))},
    "fft_slab": {"mixed": ((320, 320, 320), lambda f, x: f(*x))},
    "rfft_last": {"mixed": ((36864, 192), lambda f, x: f(x[0])),
                  "mixed_packed": ((36864, 192),
                                   lambda f, x: f(x[0], packed=True))},
    "icrfft_last": {"mixed": ((36864, 96), lambda f, x: f(*x))}}


def _window(ff, run) -> tuple:
    """Zero the counters, run one path, synchronise, read the counters:
    ({wrapper: (launches, plain calls)}, {kernel: launches},
    {register-core kernel: register-core launches})."""
    ff.reset_counts()
    out = run()
    torch.cuda.synchronize()
    return out, (ff.counts(), {k: ff.kernel_launches(k) for k in ff.KERNELS},
                 {k: ff.kernel_launches(k, reg=True) for k in REG_CORE})


@contextlib.contextmanager
def _dense_core(ff):
    """Every length routed to the dense core (the predicates
    ``fused_fft._reg_core`` (the four-step pair), ``_reg_real_rows`` (the
    r2c and c2r rows), ``_reg_rows`` (``fft_last``), ``_reg_slab``,
    ``_reg_rslab``, ``_reg_axis`` and ``_reg_cube`` patched off): the
    earlier kernels on the same data, for comparison."""
    names = ("_reg_core", "_reg_real_rows", "_reg_rows", "_reg_axis",
             "_reg_slab", "_reg_rslab", "_reg_cube")
    keep = [getattr(ff, k) for k in names]
    for k in names:
        setattr(ff, k, lambda *n: False)
    try:
        yield
    finally:
        for k, f in zip(names, keep):
            setattr(ff, k, f)


# ---- 3h: gradients through the plans (the backward path) -------------------

TOL_GRAD2 = 1e-5    # four transforms on the path: grad of grad, the FNO step
# the shapes of phase 3h: the c2c / packed-route cube, the unfused real
# route's cube, the long 1-D length, fft2d's (batch, Y, N) and the FNO's
# (n, modes, batch)
GRAD_SHAPES = {"cube": (256, 256, 256), "small": (192, 192, 192),
               "long": 2 ** 22, "2d": (64, 1024, 1024), "fno": (128, 16, 4)}


def _sq(y, w):
    """sum(w * |y|^2) of a planar pair, a complex or a real tensor."""
    if isinstance(y, tuple):
        return (w * (y[0] * y[0] + y[1] * y[1])).sum()
    if y.is_complex():
        return (w * (y.real * y.real + y.imag * y.imag)).sum()
    return (w * y * y).sum()


def _rel_leaves(got, want) -> float:
    """||got - want|| / ||want|| over lists of tensors, in float64."""
    num = sum(torch.linalg.vector_norm(g.to(w.dtype) - w) ** 2
              for g, w in zip(got, want))
    den = sum(torch.linalg.vector_norm(w) ** 2 for w in want)
    for g in got:
        if not torch.isfinite(g).all():
            raise AssertionError("non-finite gradient")
    return (num / den).sqrt().item()


def _wide(t):
    return t.to(torch.complex128) if t.is_complex() else t.double()


def _pack(w, m: int):
    """The packed (..., M) layout of a numpy-layout half-spectrum: plane 0
    carries X[0] + i X[M] (torch ops, differentiable)."""
    return torch.cat([(w[..., 0] + 1j * w[..., m])[..., None], w[..., 1:m]],
                     -1)


def _lowpass(shape, dev, dtype=torch.float32):
    """exp(-40 |f|^2) on the rfftn grid of ``shape``: real and symmetric
    in (x, y), so it keeps a half-spectrum Hermitian-consistent."""
    nx, ny, nz = shape
    fx = torch.fft.fftfreq(nx, device=dev, dtype=torch.float64)
    fy = torch.fft.fftfreq(ny, device=dev, dtype=torch.float64)
    fz = torch.fft.rfftfreq(nz, device=dev, dtype=torch.float64)
    f2 = fx[:, None, None] ** 2 + fy[None, :, None] ** 2 + fz ** 2
    return torch.exp(-40.0 * f2).to(dtype)


def _mul(y, k):
    return (y[0] * k, y[1] * k) if isinstance(y, tuple) else y * k


def _cmul(y, kr, ki):
    """A planar pair times the complex multiplier kr + i ki."""
    return y[0] * kr - y[1] * ki, y[0] * ki + y[1] * kr


def grad_cases(ot, gen, mesh) -> list:
    """The gradient cases of phase 3h: (label, port fn, complex128 twin,
    inputs (fp32 leaves), the kernels its backward must run)."""
    dev = gen.device
    cube = GRAD_SHAPES["cube"]

    def real(shape):
        return torch.randn(shape, generator=gen, device=dev)

    def pair(shape):
        return real(shape), real(shape)
    cases = []
    for inv, norm in ((False, None), (False, "ortho"), (True, None),
                      (True, "ortho")):
        p = ot.plan(cube, "complex64", planar=True, inverse=inv, norm=norm,
                    device=dev)
        f = torch.fft.ifftn if inv else torch.fft.fftn
        cases.append((f"c2c {'inv' if inv else 'fwd'} {norm or 'backward'}",
                      lambda a, b, p=p: p(a, b),
                      lambda a, b, f=f, norm=norm: f(torch.complex(a, b),
                                                     norm=norm),
                      pair(cube), ("fft_slab", "fft_axis")))
    pc = ot.plan(cube, "complex64", device=dev)
    cases.append(("c2c complex", pc, torch.fft.fftn,
                  (torch.complex(*pair(cube)),), ("fft_slab", "fft_axis")))
    m = cube[2] // 2
    k = _lowpass(cube, dev)
    kp = k[..., :m].contiguous()
    kfull = k.clone()
    kfull[..., m] = k[..., 0]       # the packed plane 0 scales X[M] by k[0]
    # the numpy layout's multiplier also turns each bin's phase, so its
    # z = 0 and N/2 planes leave the half-spectra of real signals: the
    # twin's c2r states the plan's edge rule there (_c2r_edges)
    theta = 2 * math.pi * torch.rand(k.shape, generator=gen, device=dev)
    kr, ki = k * torch.cos(theta), k * torch.sin(theta)
    for packed in (False, True):
        pf = ot.plan(cube, "float32", real=True, planar=True, packed=packed,
                     device=dev)
        pi = ot.plan(cube, "float32", real=True, inverse=True, planar=True,
                     packed=packed, device=dev)
        lay = "packed" if packed else "numpy"
        twin_r2c = ((lambda x: _pack(torch.fft.rfftn(x), m)) if packed
                    else torch.fft.rfftn)
        cases.append((f"r2c {lay}", lambda x, pf=pf: pf(x), twin_r2c,
                      (real(cube),), ("fft_slab", "fft_axis")))
        if packed:
            def port(x, pf=pf, pi=pi):
                return pi(*_mul(pf(x), kp))

            def twin(x):
                return torch.fft.irfftn(torch.fft.rfftn(x) * kfull.double(),
                                        s=cube)
        else:
            def port(x, pf=pf, pi=pi):
                return pi(*_cmul(pf(x), kr, ki))

            def twin(x, fused=pi.route == "rfft3d"):
                kc = torch.complex(kr.double(), ki.double())
                return _c2r_edges(torch.fft.rfftn(x) * kc, cube[2], fused)
        cases.append((
            f"r2c -> c2r {lay}", port, twin, (real(cube),),
            ("rfft_slab", "fft_axis", "fft_slab")
            + (() if packed else ("assemble_mp1",))))
    small = GRAD_SHAPES["small"]
    # 192^3's r2c runs rfft_last at M = 96 on the mixed real rows
    ks = _lowpass(small, dev)
    pf = ot.plan(small, "float32", real=True, device=dev)
    pi = ot.plan(small, "float32", real=True, inverse=True, device=dev)
    if (pf.route, pi.route) != ("local", "local"):
        raise AssertionError(f"{small} routes {pf.route}, {pi.route}")
    cases.append(("r2c -> c2r, the unfused real route",
                  lambda x: pi(pf(x) * ks),
                  lambda x: torch.fft.irfftn(torch.fft.rfftn(x)
                                             * ks.double(), s=small),
                  (real(small),), ("rfft_last", "fft_axis")))
    n = GRAD_SHAPES["long"]
    pl = ot.plan((1, 1, n), "complex64", planar=True, device=dev)
    cases.append(("long 1-D c2c", lambda a, b: pl(a, b),
                  lambda a, b: torch.fft.fft(torch.complex(a, b)),
                  pair((1, 1, n)), ("step1_twiddle", "step3_transposed")))
    cases.append(("fft2d", ot.fft2d, torch.fft.fft2,
                  (torch.complex(*pair(GRAD_SHAPES["2d"])),),
                  ("fft_last", "fft_axis")))
    pm = ot.plan(cube, "complex64", mesh=mesh, planar=True)
    cases.append(("mesh 1x1 c2c", lambda a, b: pm(a, b),
                  lambda a, b: torch.fft.fftn(torch.complex(a, b)),
                  pair(cube), ("fft_last", "fft_axis")))
    pfm = ot.plan(cube, "float32", mesh=mesh, real=True, planar=True,
                  packed=True)
    pim = ot.plan(cube, "float32", mesh=mesh, real=True, inverse=True,
                  planar=True, packed=True)
    cases.append(("mesh 1x1 r2c -> c2r packed",
                  lambda x: pim(*_mul(pfm(x), kp)),
                  lambda x: torch.fft.irfftn(torch.fft.rfftn(x)
                                             * kfull.double(), s=cube),
                  (real(cube),), ("rfft_last", "fft_axis", "fft_last")))
    return cases


def _c2r_edges(y, n: int, fused: bool):
    """irfftn of the half-spectrum ``y`` (even ``n``) by a plan c2r's
    edge rule (``plan()``'s docstring), in torch ops: with G_0 and G_M the
    z = 0 and n/2 planes inverted along x and y, irfft along z of G_0' =
    Re G_0 - Im G_M and G_M' = Re G_M - Im G_0 (+ Im G_0 on the fused
    route). ``torch.fft.irfftn`` drops Im G_0 and Im G_M instead; the two
    agree where G_0 and G_M are real (the half-spectra of real
    signals)."""
    g = torch.fft.ifftn(y, dim=(-3, -2))
    g0, gm = g[..., :1], g[..., -1:]
    sign = 1.0 if fused else -1.0
    edges = (torch.complex(g0.real - gm.imag, torch.zeros_like(g0.real)),
             torch.complex(gm.real + sign * g0.imag,
                           torch.zeros_like(gm.real)))
    g = torch.cat([edges[0], g[..., 1:-1], edges[1]], -1)
    return torch.fft.irfft(g, n=n, dim=-1)


def fno_model(ot, dev, n: int, modes: int, batch: int):
    """The FNO spectral convolution of examples/fno_layer.py on the
    port's planar r2c / c2r plans, and its complex128 torch.fft twin: r2c,
    the (modes, modes, modes) low corner (bins 0..modes - 1 of each axis,
    the example's) times learned complex weights, c2r. The learned z = 0
    plane is not Hermitian, so the c2r reads it off the half-spectra of
    real signals: the twin's c2r states the plan's edge rule
    (:func:`_c2r_edges`), which differs there from ``torch.fft.irfftn``
    (ROADMAP Queue 3)."""
    nf = n // 2 + 1
    fwd = ot.plan((n,) * 3, "float32", real=True, planar=True, batch_dims=1,
                  device=dev)
    inv = ot.plan((n,) * 3, "float32", real=True, inverse=True, planar=True,
                  batch_dims=1, device=dev)
    pad = (0, nf - modes, 0, n - modes, 0, n - modes)

    def conv(wr, wi, x):
        yr, yi = fwd(x)
        fr = torch.nn.functional.pad(wr, pad)
        fi = torch.nn.functional.pad(wi, pad)
        return inv(yr * fr - yi * fi, yr * fi + yi * fr)

    def twin(wr, wi, x, edges=True):
        # edges=False: the layer as a torch.fft user writes it (irfftn)
        w = torch.nn.functional.pad(torch.complex(wr, wi), pad)
        y = torch.fft.rfftn(x, dim=(-3, -2, -1)) * w
        if edges:
            return _c2r_edges(y, n, inv.route == "rfft3d")
        return torch.fft.irfftn(y, s=(n,) * 3, dim=(-3, -2, -1))
    return conv, twin, (fwd.route, inv.route)


def fno_train(ot, gen, n: int, modes: int, batch: int, steps: int,
              window=None) -> dict:
    """``steps`` SGD steps of the FNO layer fitting a hidden spectral
    multiplier (examples/fno_layer.py's task and learning rate): the
    losses (one more after the last step), the step-0 weight gradient
    against the complex128 twin's, and ``window``'s reading of the step-0
    backward."""
    dev = gen.device
    conv, twin, routes = fno_model(ot, dev, n, modes, batch)
    wshape = (modes,) * 3
    w_true = [torch.randn(wshape, generator=gen, device=dev)
              for _ in range(2)]
    x = torch.randn((batch, n, n, n), generator=gen, device=dev)
    with torch.no_grad():
        y = conv(*w_true, x)
    wr = torch.zeros(wshape, device=dev, requires_grad=True)
    wi = torch.zeros(wshape, device=dev, requires_grad=True)
    lr = 2e-2 * n ** 3
    losses, out = [], {"routes": routes}
    for step in range(steps + 1):
        r = conv(wr, wi, x) - y
        loss = (r * r).mean()
        losses.append(loss.item())
        if step == steps:
            break
        if step == 0 and window is not None:
            (gr, gi), out["counts"] = window(
                lambda: torch.autograd.grad(loss, (wr, wi)))
        else:
            gr, gi = torch.autograd.grad(loss, (wr, wi))
        if step == 0:
            w64 = [torch.zeros(wshape, dtype=torch.float64, device=dev,
                               requires_grad=True) for _ in range(2)]
            r64 = twin(*w64, x.double()) - y.double()
            g64 = torch.autograd.grad((r64 * r64).mean(), w64)
            out["err0"] = _rel_leaves([gr, gi], list(g64))
            del r64, g64
        with torch.no_grad():
            wr = (wr - lr * gr).requires_grad_()
            wi = (wi - lr * gi).requires_grad_()
    out["losses"] = losses
    out["w_err"] = _rel_leaves([wr.detach(), wi.detach()],
                               [w.double() for w in w_true])
    return out


def grad_phase(ot, ff, gen, mesh, window, tag) -> dict:
    """Phase 3h on the device of ``gen``: each case's gradient of a real
    loss against complex128 torch.fft autograd (1e-6), jvp, grad of grad
    and the FNO loop. ``window(fn)`` runs ``fn`` with the launch counters
    zeroed before and read after: each backward alone. Returns {run label:
    (reading, the kernels it must have run)}."""
    dev = gen.device
    readings = {}
    for label, fn, twin, leaves, kernels in grad_cases(ot, gen, mesh):
        xs = [t.detach().requires_grad_() for t in leaves]
        y = fn(*xs)
        w = torch.rand(_shape_of(y), generator=gen, device=dev)
        loss = _sq(y, w)
        del y
        gs, counts = window(lambda: torch.autograd.grad(loss, xs))
        readings[f"grad {label}"] = (counts, kernels)
        del loss
        x64 = [_wide(t.detach()).requires_grad_() for t in leaves]
        g64 = torch.autograd.grad(_sq(twin(*x64), w.double()), x64)
        err = _rel_leaves(list(gs), list(g64))
        print(f"grad {label} {_shape_of(leaves[0])}: rel err vs complex128 torch.fft autograd "
              f"{err:.3e} (tol {TOL_PATH:g}) {tag}", flush=True)
        if err > TOL_PATH:
            raise AssertionError(f"grad {label}: error {err:.3e}")
        del xs, x64, gs, g64, w
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    # forward mode: the jvp of a linear map is the map
    cube = GRAD_SHAPES["cube"]
    p = ot.plan(cube, "complex64", planar=True, device=dev)
    x = [torch.randn(cube, generator=gen, device=dev) for _ in range(2)]
    tv = [torch.randn(cube, generator=gen, device=dev) for _ in range(2)]
    (_, (jr, ji)), counts = window(
        lambda: torch.func.jvp(lambda a, b: p(a, b), tuple(x), tuple(tv)))
    readings["jvp c2c"] = (counts, ("fft_slab", "fft_axis"))
    err = _rel_err(jr, ji, torch.fft.fftn(torch.complex(*tv).to(
        torch.complex128)))
    print(f"jvp c2c {cube}: tangent rel err vs complex128 fftn of the "
          f"tangent {err:.3e} (tol {TOL_PATH:g}) {tag}", flush=True)
    if err > TOL_PATH:
        raise AssertionError(f"jvp: error {err:.3e}")
    del x, tv, jr, ji
    # grad of grad through the complex c2c
    pc = ot.plan(cube, "complex64", device=dev)
    z = torch.randn(cube, dtype=torch.complex64, generator=gen, device=dev)
    w = torch.rand(cube, generator=gen, device=dev)

    def hess(f, v, w):
        v = v.detach().requires_grad_()
        g, = torch.autograd.grad(_sq(f(v), w), v, create_graph=True)
        return torch.autograd.grad(_sq(g, w), v)[0]
    h, counts = window(lambda: hess(pc, z, w))
    readings["grad of grad c2c complex"] = (counts, ("fft_slab", "fft_axis"))
    h64 = hess(torch.fft.fftn, z.to(torch.complex128), w.double())
    err = _rel_leaves([h], [h64])
    print(f"grad of grad c2c complex {cube}: rel err vs complex128 "
          f"torch.fft {err:.3e} (tol {TOL_GRAD2:g}) {tag}", flush=True)
    if err > TOL_GRAD2:
        raise AssertionError(f"grad of grad: error {err:.3e}")
    del z, w, h, h64
    # the training loop: the FNO layer at batch 4 x 128^3, 16 modes a side
    n, modes, batch = GRAD_SHAPES["fno"]
    fno = fno_train(ot, gen, n, modes, batch, 5, window)
    # 128^3 is outside the packed gate: the r2c and c2r take the
    # axis-by-axis route, so the c2r's adjoint runs rfft_last; the input
    # is data, so the r2c's adjoint does not run
    readings["FNO step 0 backward"] = (fno["counts"],
                                       ("rfft_last", "fft_axis"))
    ls = fno["losses"]
    print(f"FNO {batch} x {n}^3, {modes} modes (routes {fno['routes']}): losses "
          + " -> ".join(f"{v:.6e}" for v in ls)
          + f"; step-0 weight gradient rel err vs its complex128 twin "
          f"{fno['err0']:.3e} (tol {TOL_GRAD2:g}); weights rel err "
          f"{fno['w_err']:.4f} {tag}", flush=True)
    if not all(b < a for a, b in zip(ls, ls[1:])):
        raise AssertionError(f"FNO loss did not fall at every step: {ls}")
    if fno["err0"] > TOL_GRAD2:
        raise AssertionError(f"FNO step-0 gradient: error {fno['err0']:.3e}")
    if fno["routes"] != ("local", "local"):
        raise AssertionError(f"FNO routes {fno['routes']}")
    return readings


def _shape_of(y):
    return tuple((y[0] if isinstance(y, tuple) else y).shape)


def grad_times(ot, gen, show, show_breakdown, time_cuda) -> None:
    """Phase 5's backward path: forward, backward and both of sum(w
    |y|^2) at 256^3 (c2c, r2c, c2r, planar and numpy layout) and of the
    FNO step at 4 x 128^3, each beside the same through torch.fft
    autograd on complex64 (cuFFT; the FNO layer with ``irfftn``); and the
    torch.profiler breakdown of one 256^3 c2c backward."""
    dev = gen.device
    cube = GRAD_SHAPES["cube"]
    m = cube[2] // 2 + 1

    def rnd(shape, dtype=torch.float32):
        return torch.randn(shape, dtype=dtype, generator=gen, device=dev)
    cases = [
        # (label, port fn, its leaves, torch.fft fn, its leaves)
        ("c2c", ot.plan(cube, "complex64", planar=True),
         (rnd(cube), rnd(cube)), torch.fft.fftn,
         (rnd(cube, torch.complex64),)),
        ("r2c", ot.plan(cube, "float32", real=True, planar=True),
         (rnd(cube),), torch.fft.rfftn, (rnd(cube),)),
        ("c2r", ot.plan(cube, "float32", real=True, inverse=True,
                        planar=True),
         (rnd(cube[:2] + (m,)), rnd(cube[:2] + (m,))),
         lambda z: torch.fft.irfftn(z, s=cube),
         (rnd(cube[:2] + (m,), torch.complex64),)),
    ]
    for label, fn, xs, twin, zs in cases:
        rows = []
        for who, f, leaves in (("port", fn, xs), ("torch.fft", twin, zs)):
            leaves = [t.requires_grad_() for t in leaves]
            y = f(*leaves)
            w = torch.rand(_shape_of(y), generator=gen, device=dev)
            loss = _sq(y, w)
            r_f = time_cuda(lambda: _sq(f(*leaves), w))
            r_b = time_cuda(lambda: torch.autograd.grad(
                loss, leaves, retain_graph=True))
            r_fb = time_cuda(lambda: torch.autograd.grad(
                _sq(f(*leaves), w), leaves))
            rows.append(r_fb["median_ms"])
            show(f"grad {who} {label} {cube}: forward (+ loss)", r_f)
            show(f"grad {who} {label} {cube}: backward alone", r_b,
                 f", {r_b['median_ms'] / r_f['median_ms']:.2f}x the "
                 "forward")
            show(f"grad {who} {label} {cube}: forward + backward", r_fb)
            if who == "port" and label == "c2c":
                show_breakdown(f"port 256^3 c2c backward {cube}",
                               lambda: torch.autograd.grad(
                                   loss, leaves, retain_graph=True))
            del y, loss, w
        print(f"grad {label} {cube}: port forward + backward "
              f"{rows[0]:.4f} ms, torch.fft autograd {rows[1]:.4f} ms "
              f"({rows[0] / rows[1]:.2f}x)", flush=True)
        torch.cuda.empty_cache()
    n, modes, batch = GRAD_SHAPES["fno"]
    x = torch.randn((batch, n, n, n), generator=gen, device=dev)
    y = torch.randn((batch, n, n, n), generator=gen, device=dev)
    conv, twin, _ = fno_model(ot, dev, n, modes, batch)
    wshape = (modes,) * 3
    rows = []
    for who, f in (("port", conv),
                   ("torch.fft", lambda *a: twin(*a, edges=False))):
        w = [torch.randn(wshape, generator=gen, device=dev)
             .requires_grad_() for _ in range(2)]

        def step(f=f, w=w):
            r = f(*w, x) - y
            return torch.autograd.grad((r * r).mean(), w)
        r = time_cuda(step)
        rows.append(r["median_ms"])
        show(f"FNO step (forward + backward) {who} {batch} x {n}^3, "
             f"{modes} modes", r)
    print(f"FNO step: port {rows[0]:.4f} ms, torch.fft autograd "
          f"{rows[1]:.4f} ms ({rows[0] / rows[1]:.2f}x)", flush=True)


# ---- 3i: the long-1-D engine and the namespace on a mesh ------------------

# the lengths of phase 3i: the engine's full size and its round trip's
LONG1D_N = (2 ** 24, 2 ** 20)
ENGINE_CALLS = 6    # engine calls in 3i's engine window, each one pair


def _ip(a, b) -> float:
    """<a, b> over planar leaves (a tuple of tensors), in float64."""
    return float(sum((u.double() * v.double()).sum() for u, v in zip(a, b)))


def _norm(a) -> float:
    return math.sqrt(sum(float((u.double() ** 2).sum()) for u in a))


def long1d_phase(ot, ff, fs, long1d, plan_api, gen, mesh, window,
                 tag) -> dict:
    """Phase 3i in the world of one NCCL rank that 3e made: the
    distributed long-1-D engine at P = 1 through ``_split=`` (its three
    exchanges and the mirror's hops groups of one, the rest of its
    dataflow as on P ranks): c2c 2^24 forward and inverse, an ortho round
    trip at 2^20, the packed r2c and c2r of a real 2^24; the adjoints
    autodiff builds for the "long1d" route (a plan on the engine through
    ``api._build(long1d_split=)``: the c2c's flipped plan, the packed
    r2c's packed c2r) at 2^24, held by the transpose identity; then
    ``plan((1, 1, 2^24), mesh=...)``, which takes the pencil engine on
    one rank as the reference's does, and the namespace under
    ``use_mesh(mesh)``: ``fft`` of 2^22, ``fftn``, ``rfftn`` and
    ``irfftn`` of 256^3. Each result against complex128 ``torch.fft``
    (1e-6). Returns the three counter windows."""
    big, small = LONG1D_N
    prm = ot.PlanParams(p1=1, use_pallas=1)

    def engine(n, real, inverse, norm=None):
        make = long1d.make_dist_rfft1d if real else long1d.make_dist_fft1d
        e = make(mesh, n, prm, inverse,
                 out_scale=plan_api._norm_scale(norm, inverse, n),
                 _split=fs.pick_split(n // 2 if real else n))
        if e is None or not e.fused:
            raise AssertionError(f"no fused engine at n = {n}")
        return e
    e_f, e_i = engine(big, False, False), engine(big, False, True)
    e_fo, e_io = engine(small, False, False, "ortho"), \
        engine(small, False, True, "ortho")
    e_r, e_c = engine(big, True, False), engine(big, True, True)
    x24 = _pair((1, 1, big), gen)
    x20 = _pair((1, 1, small), gen)
    r24 = torch.randn((1, 1, big), generator=gen, device="cuda")

    def run_engine():
        out = {"c2c 2^24 fwd": e_f(x24), "c2c 2^24 inv": e_i(x24),
               "c2c 2^20 fwd ortho": e_fo(x20)}
        out["c2c 2^20 ortho round trip"] = e_io(out["c2c 2^20 fwd ortho"])
        out["r2c 2^24 packed"] = e_r((r24,))
        out["c2r 2^24 packed"] = e_c(out["r2c 2^24 packed"])
        return out
    res, run_e = window(run_engine)
    print(f"long-1-D engine counts (launches, plain calls): {run_e[0]}")
    z24 = torch.complex(x24[0].double(), x24[1].double())
    z20 = torch.complex(x20[0].double(), x20[1].double())
    w = torch.fft.rfft(r24.double())
    m = big // 2
    want = {"c2c 2^24 fwd": torch.fft.fft(z24),
            "c2c 2^24 inv": torch.fft.ifft(z24),
            "c2c 2^20 fwd ortho": torch.fft.fft(z20, norm="ortho"),
            "c2c 2^20 ortho round trip": z20,
            # packed bin 0 = DC + i Nyquist
            "r2c 2^24 packed": torch.cat([torch.complex(
                w[..., :1].real, w[..., m:].real), w[..., 1:m]], -1),
            "c2r 2^24 packed": r24.double()}
    for label, ref in want.items():
        y = res[label]
        err = _rel_err(*y, ref) if len(y) == 2 else _rel_err(y[0], None,
                                                             ref)
        split = (e_r if "packed" in label else
                 e_f if "2^24" in label else e_fo).split
        print(f"path long-1-D engine P=1 {label} (split {split}): rel err "
              f"vs complex128 torch.fft {err:.3e} (tol {TOL_PATH:g}) {tag}",
              flush=True)
        if err > TOL_PATH:
            raise AssertionError(f"engine {label}: error {err:.3e}")
    del res, want, z24, z20, w

    # the adjoints of plans on the engine: each backward in its window
    pc = plan_api._build((1, 1, big), "complex64", mesh=mesh, planar=True,
                         long1d_split=fs.pick_split(big))
    pr = plan_api._build((1, 1, big), "float32", mesh=mesh, real=True,
                         packed=True, planar=True,
                         long1d_split=fs.pick_split(m))
    if not pc.route == pr.route == "long1d":
        raise AssertionError(f"routes {pc.route}, {pr.route}")
    ins_c = tuple(t.clone().requires_grad_() for t in x24)
    ins_r = (r24.clone().requires_grad_(),)
    y_c, y_r = pc(*ins_c), pr(*ins_r)
    g_c, g_r = _pair((1, 1, big), gen), _pair((1, 1, m), gen)

    def run_adjoint():
        return (torch.autograd.grad(y_c, ins_c, g_c),
                torch.autograd.grad(y_r, ins_r, g_r))
    (a_c, a_r), run_a = window(run_adjoint)
    print(f"long-1-D adjoint counts (launches, plain calls): {run_a[0]} "
          f"(grad_fn {type(y_c[0].grad_fn).__name__}, "
          f"{type(y_r[0].grad_fn).__name__})")
    for label, y, g, x, a in (("c2c 2^24", y_c, g_c, ins_c, a_c),
                              ("packed r2c 2^24", y_r, g_r, ins_r, a_r)):
        y = tuple(t.detach() for t in y)
        x = tuple(t.detach() for t in x)
        lhs, rhs = _ip(y, g), _ip(x, a)
        err = abs(lhs - rhs) / (_norm(y) * _norm(g))
        print(f"path long-1-D adjoint P=1 {label}: <F x, y> {lhs:.6e}, "
              f"<x, F^H y> {rhs:.6e}, difference over |F x| |y| "
              f"{err:.3e} (tol {TOL_PATH:g}) {tag}", flush=True)
        if err > TOL_PATH:
            raise AssertionError(f"adjoint {label}: error {err:.3e}")
    del ins_c, ins_r, y_c, y_r, g_c, g_r, a_c, a_r, pc, pr
    torch.cuda.empty_cache()

    # the pencil route of a (1, 1, N) plan on one rank, and the namespace
    p24 = ot.plan((1, 1, big), "complex64", mesh=mesh, planar=True)
    print(f"plan((1, 1, 2^24), mesh=make_mesh(1, 1)): route {p24.route}")
    if p24.route != "pencil":
        raise AssertionError(f"(1, 1, 2^24) on one rank: {p24.route}")
    ns = {"fft 2^22": torch.complex(*_pair((2 ** 22,), gen)),
          "fftn 256^3": torch.complex(*_pair((256,) * 3, gen)),
          "rfftn 256^3": torch.randn((256,) * 3, generator=gen,
                                     device="cuda")}
    ns["irfftn 256^3"] = torch.fft.rfftn(ns["rfftn 256^3"].double()).to(
        torch.complex64)
    calls = {"fft 2^22": (ot.fft.fft, torch.fft.fft),
             "fftn 256^3": (ot.fft.fftn, torch.fft.fftn),
             "rfftn 256^3": (ot.fft.rfftn, torch.fft.rfftn),
             "irfftn 256^3": (ot.fft.irfftn, torch.fft.irfftn)}

    def run_mesh_ns():
        out = {"plan (1, 1, 2^24) pencil": p24(*x24)}
        with ot.fft.use_mesh(mesh):
            for label, (fn, _) in calls.items():
                out[label] = fn(ns[label])
        return out
    res, run_m = window(run_mesh_ns)
    if ot.fft.current_mesh() is not None:
        raise AssertionError("use_mesh left a mesh behind")
    print(f"namespace on the mesh counts (launches, plain calls): "
          f"{run_m[0]}")
    err = _rel_err(*res.pop("plan (1, 1, 2^24) pencil"),
                   torch.fft.fft(torch.complex(x24[0].double(),
                                               x24[1].double())))
    print(f"path mesh 1x1 plan (1, 1, 2^24) (pencil): rel err vs complex128 "
          f"fft {err:.3e} (tol {TOL_PATH:g}) {tag}", flush=True)
    if err > TOL_PATH:
        raise AssertionError(f"(1, 1, 2^24) pencil: error {err:.3e}")
    for label, (fn, twin) in calls.items():
        x = ns[label]
        ref = twin(x.double() if not x.is_complex()
                   else x.to(torch.complex128))
        got = res[label]
        if tuple(got.shape) != tuple(ref.shape):
            raise AssertionError(f"use_mesh {label}: {tuple(got.shape)}")
        err = _rel_err(got, None, ref)
        print(f"path use_mesh(make_mesh(1, 1)) {label}: rel err vs "
              f"complex128 torch.fft {err:.3e} (tol {TOL_PATH:g}) {tag}",
              flush=True)
        if err > TOL_PATH:
            raise AssertionError(f"use_mesh {label}: error {err:.3e}")
    return {"long1d_engine": run_e, "long1d_adjoint": run_a,
            "mesh_namespace": run_m}


def long1d_times(ot, fs, tb, long1d, gen, mesh, show, show_breakdown,
                 time_cuda, fft3d_breakdown, pencil_breakdown, tag) -> None:
    """Phase 5's long-1-D part: the engine at P = 1 against the
    single-device plan and torch.fft.fft (the difference is the engine's
    own glue: the reshapes, the exchanges' stacking, the chunked table),
    with its busy share; the pair at the shard shapes of a 2 x 2 mesh
    (what one rank of four computes), each with its bound and TB/s; and
    the per-stage breakdowns of 256^3 on one device and on the 1 x 1
    mesh."""
    from offt_tpu_torch.bench.roofline import kernel_bound, kernel_work
    prm = ot.PlanParams(p1=1, use_pallas=1)
    for n in LONG1D_N[::-1]:
        label = f"2^{n.bit_length() - 1}"
        x = _pair((1, 1, n), gen)
        xc = torch.complex(*x)
        e = long1d.make_dist_fft1d(mesh, n, prm, False,
                                   _split=fs.pick_split(n))
        p1d = ot.plan((1, 1, n), "complex64", planar=True)
        r_e = time_cuda(e, (x,))
        r_p = time_cuda(p1d, (x,))
        r_c = time_cuda(torch.fft.fft, (xc,))
        show(f"long-1-D engine P=1 fft {label}", r_e,
             f", {r_e['median_ms'] / r_p['median_ms']:.2f}x the "
             f"single-device plan, {r_e['median_ms'] / r_c['median_ms']:.2f}"
             "x torch.fft.fft")
        show(f"single-device plan fft {label} (route {p1d.route})", r_p)
        show(f"torch.fft.fft (cuFFT) c64 {label}", r_c)
        show_breakdown(f"long-1-D engine P=1 fft {label}", e, (x,))
        del x, xc, e, p1d
        torch.cuda.empty_cache()
    # the pair at one rank's shard of a 2 x 2 mesh (rank 1's columns)
    for n1, n2 in ((4096, 4096), (1024, 1024)):
        ptot = 4
        w = n2 // ptot
        tw = torch.from_numpy(tb.fourstep_twiddle_chunk(
            n1, n2, w, 2 * w, False).copy()).cuda()
        x1 = _pair((1, n1, w), gen)
        x3 = _pair((1, n1 // ptot, n2), gen)
        for what, fn, args, shape in (
                ("step1_twiddle", fs.step12_planar,
                 (*x1, None, False, "highest", tw), (1, n1, w)),
                ("step3_transposed", fs.step34_planar,
                 (*x3, None, False, "highest"), (1, n1 // ptot, n2))):
            r = time_cuda(fn, args, ahead=True)
            ms = r["median_ms"]
            bms, by = kernel_bound(what, shape)
            nbytes = kernel_work(what, shape)[0]
            show(f"kernel {what} at the 2x2 shard of {n1}*{n2} {shape}", r,
                 f", {nbytes / ms / 1e9:.3f} TB/s, {bms / ms:.3f} of its "
                 f"bound {bms:.4f} ms ({by})")
        del tw, x1, x3
    # where 256^3 c2c's time goes: each axis pass and exchange alone
    for label, bd in (
            ("fft3d_breakdown 256^3 (one device)",
             fft3d_breakdown((256,) * 3)),
            ("pencil_breakdown 256^3 (mesh 1x1)",
             pencil_breakdown((256,) * 3, mesh))):
        parts = ", ".join(f"{k} {v * 1e3:.4f}" for k, v in bd.items())
        print(f"{label}, ms: {parts} {tag}", flush=True)
    torch.cuda.empty_cache()


# ---- 3j: the tuner ---------------------------------------------------------

# the tunings of phase 3j: (label, shape, real, strategy, max_trials (None:
# every point of the space), include_pallas (None: the card's default),
# the kernels the tuned plan's route launches)
TUNE_CASES = (
    # the split order ROADMAP item 8 measured 7% apart; every point of
    # split_1d x block_batch (a side of 3 * 2^k runs dense at every split)
    ("a", (1, 1, 3 * 2 ** 18), False, "brute", None, None,
     ("step1_twiddle", "step3_transposed")),
    # a real route whose rfft_last runs the dense core (M = 72, 3^2 8: no
    # mixed real rows) and its axes (144) too, so that radix_z, radix_y,
    # radix_x and block_batch are searched
    ("b", (144, 144, 144), True, "nm", 12, None, ("rfft_last", "fft_axis")),
    # every kernel on the register core: the card's space is empty, and
    # the default point is timed
    ("c", (256, 256, 256), False, "nm", None, None,
     ("fft_slab", "fft_axis")),
)
# the kernels the tunings' trials launch between them
TUNING_KERNELS = ("step1_twiddle", "step3_transposed", "rfft_last",
                  "fft_axis", "fft_slab")


def tune_phase(ot, window, tag, cases=TUNE_CASES, device="cuda",
               tol=TOL_PATH) -> dict:
    """Phase 3j: ``ot.tune.tune`` of each case at full size on the card
    (CUDA events), the plan cache in a temporary directory; then a plan
    built with no params, which must read the tuned point from the cache,
    on a seeded input. Prints each case's space, trials, default and best
    time, speedup, winner and seconds; checks best <= default, the cache
    read, that the tuned plan keeps the kernels (``use_pallas=1``), the
    plan's output against complex128 ``torch.fft`` and the event log read
    back. Returns {path: (counter reading, kernels it must show)}: the
    tunings in one window ("tuning"), each tuned plan's call in a window
    of its own ("tuned_<label>")."""
    import dataclasses
    import shutil
    import tempfile

    from offt_tpu_torch.obs.log import read_events
    from offt_tpu_torch.plan import cache
    from offt_tpu_torch.plan.params import ProblemSpec, default_params
    from offt_tpu_torch.tune import build_space

    keep = os.environ.get("OFFT_TPU_TORCH_CACHE_DIR")
    tmp = tempfile.mkdtemp(prefix="offt_tune_")
    os.environ["OFFT_TPU_TORCH_CACHE_DIR"] = tmp
    gen = torch.Generator(device=device)
    gen.manual_seed(3)
    try:
        def run():
            out = {}
            for label, shape, real, strategy, budget, pallas, _ in cases:
                spec = ProblemSpec(shape=shape, real=real)
                space = build_space(spec, device=device,
                                    include_pallas=pallas)
                dtype = "float32" if real else "complex64"
                log = os.path.join(tmp, f"{label}.jsonl")
                t0 = time.perf_counter()
                res = ot.tune.tune(shape, dtype, real=real,
                                   strategy=strategy,
                                   max_trials=budget or max(space.size(), 1),
                                   include_pallas=pallas, log_path=log,
                                   device=device)
                secs = time.perf_counter() - t0
                out[label] = (spec, space, res, secs, log)
            return out
        results, reading = window(run)
        runs = {"tuning": (reading, TUNING_KERNELS)}
        for label, shape, real, strategy, _, pallas, kernels in cases:
            spec, space, res, secs, log = results[label]
            dtype = "float32" if real else "complex64"
            p = ot.plan(shape, dtype, real=real, planar=True, device=device)
            if real:
                x = (torch.randn(shape, generator=gen, device=device),)
            else:
                x = tuple(torch.randn(shape, generator=gen, device=device)
                          for _ in range(2))
            y, tuned = window(lambda: p(*x))
            runs[f"tuned_{label}"] = (tuned, kernels)
            dflt = dataclasses.asdict(default_params(spec))
            won = {k: v for k, v in dataclasses.asdict(
                res.best_params).items() if v != dflt[k]}
            n_ok = sum(t.status == "ok" for t in res.trials)
            kind = "r2c" if real else "c2c"
            dims = ", ".join(f"{d.name}({len(d)})" for d in space.dims)
            print(f"tune 3j-{label} {shape} {kind}: space [{dims or 'empty'}]"
                  f" ({space.size() if space.dims else 0} points), "
                  f"{strategy}, {n_ok} trials run ({len(res.trials)} with "
                  f"duplicates and infeasible), default "
                  f"{res.default_perf * 1e3:.4f} ms, best "
                  f"{res.best_perf * 1e3:.4f} ms, speedup_vs_default "
                  f"{res.speedup_vs_default:.3f}, winner "
                  f"{won or 'the default point'}, {secs:.1f} s {tag}",
                  flush=True)
            if not res.best_perf <= res.default_perf:
                raise AssertionError(f"3j-{label}: best {res.best_perf} > "
                                     f"default {res.default_perf}")
            key = cache.plan_key(shape, "complex64", real, 1, 1,
                                 cache.device_kind(p.device))
            if not (cache.lookup(key) == p.params == res.best_params):
                raise AssertionError(f"3j-{label}: the plan read "
                                     f"{p.params}, the cache "
                                     f"{cache.lookup(key)}")
            if p.params.use_pallas != 1:
                raise AssertionError(f"3j-{label}: the tuned plan is off "
                                     f"the kernels: {p.params}")
            if real:
                ref = torch.fft.rfftn(x[0].double())
            else:
                ref = torch.fft.fftn(torch.complex(*x).to(torch.complex128))
            err = _rel_err(*y, ref)
            evs = read_events(log)
            print(f"path tuned plan 3j-{label} (route {p.route}): rel err "
                  f"vs complex128 torch.fft {err:.3e} (tol {tol:g}); "
                  f"event log {len(evs)} events, last {evs[-1]['kind']} "
                  f"{tag}", flush=True)
            if err > tol:
                raise AssertionError(f"3j-{label}: error {err:.3e}")
            if evs[-1]["kind"] != "tune_done" or (
                    evs[-1]["best_perf"] != res.best_perf):
                raise AssertionError(f"3j-{label}: event log {evs[-1]}")
        return runs
    finally:
        if keep is None:
            os.environ.pop("OFFT_TPU_TORCH_CACHE_DIR", None)
        else:
            os.environ["OFFT_TPU_TORCH_CACHE_DIR"] = keep
        shutil.rmtree(tmp, ignore_errors=True)


# ---- 3k: the bench layer; 3l: the probes ----------------------------------

# runfft's cases on the card (its own --verify on the seeded and golden
# inputs; `-a torch` is cuFFT through torch.fft, the driver's yardstick)
RUNFFT_CASES = (
    ("256^3 c2c offt", ["-N", "256", "-a", "offt", "--verify", "-r",
                        "20"]),
    ("256^3 c2c torch", ["-N", "256", "-a", "torch", "-r", "20"]),
    ("256^3 r2c packed", ["-N", "256", "-R", "--packed", "--verify", "-r",
                          "20"]),
    ("256^3 r2c", ["-N", "256", "-R", "--verify", "-r", "20"]),
    ("256^3 c2r", ["-N", "256", "-R", "-i", "--verify", "-r", "20"]),
)
RUNFFT_KERNELS = ("fft_slab", "fft_axis", "rfft_slab", "irfft_slab")
BASELINE_KERNELS = RUNFFT_KERNELS + ("step1_twiddle", "step3_transposed")
# probe_mma against its plain version at R = 1 on the same inputs
# (max |kernel - plain| / max |plain|): the tensor cores sum each mma's
# 8-16 products at their own alignment and the k-steps in their order,
# the plain version's matmul in another; the f32 tier's FMA chain against
# cuBLAS's SGEMM. TOL_MMA on the timing operands (c = 0.25; the card read
# at most 3.1e-7), TOL_MMA_DFT on the 128-point DFT stage's products
# (c = 0, where the low-order products are a larger share of the output;
# the card read 1.7e-6, 3.5e-7, 1.8e-6, 8.9e-7 and 0). A dropped or
# garbled low-order product shows in the stage's error against float64,
# held to probe_mxuwidth.CEILING.
TOL_MMA = {"stack6": 1e-6, "stack6-six": 1e-6, "3xtf32": 1e-6,
           "tf32": 1e-6, "fma": TOL_KERNEL}
TOL_MMA_DFT = {"stack6": 2.5e-6, "stack6-six": 5e-7, "3xtf32": 2.5e-6,
               "tf32": 1.5e-6, "fma": TOL_KERNEL}


def _captured(fn, argv):
    """(exit code, stdout, stderr) of a command-line ``fn(argv)`` run in
    this process."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = fn(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue(), err.getvalue()


def bench_phase(window, tag, cases=RUNFFT_CASES, suite_argv=(),
                device="cuda", tol=TOL_PATH) -> dict:
    """Path 3k: ``runfft.main`` on ``cases``, then ``baseline_suite.main``,
    each in a counter window of its own; every run exits 0, every
    ``--verify`` rel_err within ``tol``, every suite record passes (config
    3 skipped on one card). {window label: (reading, kernels)}."""
    from offt_tpu_torch.bench import baseline_suite, runfft

    def run_cli():
        return [(label, *_captured(runfft.main, [*argv, "--device", device]))
                for label, argv in cases]
    res, cli = window(run_cli)
    for label, rc, so, se in res:
        errs = [float(e) for e in
                re.findall(r"verify(?: golden)? rel_err = (\S+)", se)]
        rec = json.loads(so.strip().splitlines()[-1]) if so.strip() else {}
        print(f"runfft {label}: rc {rc}, {rec}, verify rel_err {errs} "
              f"(tol {tol:g}) {tag}", flush=True)
        if rc != 0 or "t_ms" not in rec or any(e > tol for e in errs) or (
                "--verify" in dict(cases)[label] and len(errs) != 2):
            raise AssertionError(f"runfft {label}: rc {rc}, {se[-800:]}")
    (rc, so, se), suite = window(
        lambda: _captured(baseline_suite.main, [*suite_argv, "--device",
                                                device]))
    recs = [json.loads(ln) for ln in so.splitlines() if ln.startswith("{")]
    for rec in recs:
        print(f"baseline {json.dumps(rec)} {tag}", flush=True)
    got = sorted(r["config"] for r in recs)
    if rc != 0 or got != [1, 2, 3, 4, 5] or not all(
            r.get("pass") or r.get("skipped") for r in recs):
        raise AssertionError(f"baseline suite: rc {rc}, configs {got}, "
                             f"{se[-800:]}")
    return {"runfft": (cli, RUNFFT_KERNELS),
            "baseline": (suite, BASELINE_KERNELS)}


def probe_checks(ff, pm, pr, sms, tag) -> dict:
    """Phase 2 for the probes: ``probe_mma`` at every variant against its
    plain version at R = 1 on the ledger's inputs (B = the SM count, every
    case's L) and on the products of the accuracy rows' 128-point DFT
    draws (c = 0); each variant's DFT-stage error against float64 within
    its ceiling (``probe_mxuwidth.CEILING``); the r2c slab's wider-tile
    codes against its full kernel (1e-6). {kernel-line name: max abs
    err}."""
    errs = {}

    def hold(v, got, want, tol, what):
        rel, absd = _max_err(got, want)
        if rel > tol:
            raise AssertionError(f"probe_mma {v} disagrees with its plain "
                                 f"version on {what}: {rel:.3e} > {tol:g}")
        errs[f"probe_mma:{v}"] = max(errs.get(f"probe_mma:{v}", 0.0), absd)
        return rel
    for v in pm.VARIANTS:
        for lanes, _ in pm.CASES:
            x, g = pm.inputs(v, sms, lanes, "cuda", seed=1)
            rel = hold(v, pm.probe_mma(x, g, 1, v),
                       pm.probe_mma.plain(x, g, 1, v), TOL_MMA[v],
                       f"({sms}, 128, {lanes})")
            print(f"check probe_mma:{v} ({sms}, 128, {lanes}), R = 1: max "
                  f"rel err {rel:.3e} (tol {TOL_MMA[v]:g}) {tag}", flush=True)
            del x, g
        worst = 0.0
        for seed in pm.SEEDS:
            for lanes in pm.WIDTHS:
                draw = pm.dft_draw(seed, lanes)
                for g, a in pm.dft_products(v, draw, "cuda"):
                    worst = max(worst, hold(
                        v, pm.probe_mma(a, g, 1, v, 0.0),
                        pm.probe_mma.plain(a, g, 1, v, 0.0), TOL_MMA_DFT[v],
                        f"DFT draw ({seed}, {lanes})"))
        print(f"check probe_mma:{v} on the DFT stage's products, c = 0, "
              f"{len(pm.SEEDS) * len(pm.WIDTHS)} draws: max rel err "
              f"{worst:.3e} (tol {TOL_MMA_DFT[v]:g}) {tag}", flush=True)
    for row in pm.accuracy_rows("cuda"):
        print(f"probe mxuwidth accuracy {row['variant']}: rel err "
              f"{row['rel_err']:.3e} on a 128-point DFT stage, the largest "
              f"of {row['draws']} draws (seed {row['seed']}, L {row['L']}); "
              f"ceiling {row['ceiling']:g}, bar {row['bar']:g}: "
              f"{'meets' if row['meets_bar'] else 'misses'} {tag}",
              flush=True)
        if row["rel_err"] > row["ceiling"]:
            raise AssertionError(f"probe_mma {row['variant']}: DFT-stage "
                                 f"error {row['rel_err']:.3e} over its "
                                 f"ceiling {row['ceiling']:g}")
    for code, (rel, absd) in pr.check().items():
        print(f"check rfft_slab phases={code} (512, 512, 512) against "
              f"phases=full: max rel err {rel:.3e}, max abs err {absd:.3e} "
              f"(tol {TOL_KERNEL:g}) {tag}", flush=True)
        if rel > TOL_KERNEL:
            raise AssertionError(f"rfft_slab {code} disagrees with full")
        errs[f"rfft_slab:{code}"] = absd
    torch.cuda.empty_cache()
    return errs


def probe_phase(ff, pm, pr, sms, window, tag) -> tuple:
    """Path 3l: each probe variant through its entry point in a counter
    window of its own: ``probe_mma`` at the ledger's cases (R = 1), each
    r2c slab code at 512^3. ({variant: launches}, {window: reading})."""
    mma = {}
    for v in pm.VARIANTS:
        def run(v=v):
            pm.reset_counts()
            for lanes, _ in pm.CASES:
                x, g = pm.inputs(v, sms, lanes, "cuda")
                pm.probe_mma(x, g, 1, v)
            return dict(pm.probe_mma.launches), pm.probe_mma.plain_calls
        (launched, plain), _ = window(run)
        others = {k: n for k, n in launched.items() if k != v and n}
        print(f"probe window probe_mma:{v}: launches {launched[v]}, plain "
              f"calls {plain} {tag}", flush=True)
        if launched[v] != len(pm.CASES) or plain or others:
            raise AssertionError(f"probe_mma {v}: {launched}, plain {plain}")
        mma[v] = launched[v]
    x = pr._input()
    readings = {}
    for code in pr.CODES:
        _, readings[f"ryconcat:{code}"] = window(
            lambda code=code: ff.rfft_slab_yz(x, zpad=pr.ZPAD, phases=code))
    del x
    torch.cuda.empty_cache()
    return mma, readings


# ---- 3m: the examples, the entry point, the bundled tuned defaults --------

def one_card_record(kind: str) -> dict:
    """A bundled record of a one-card key of this card, as
    ``bench/saturation.ship`` writes one: 192^3 r2c at radix_z (3, 32), the
    point the file shipped for that key before ``rfft_last`` ran its
    M = 96 on the register core (``tests/test_torch_bundled_defaults.py``
    holds the same record)."""
    from offt_tpu_torch.plan import cache
    from offt_tpu_torch.plan.params import ProblemSpec, default_params
    spec = ProblemSpec(shape=(192,) * 3, real=True)
    key = cache.plan_key(spec.shape, "complex64", True, 1, 1, kind)
    point = default_params(spec).replace(radix_z=(3, 32))
    return {key: {"params": cache._params_to_json(point), "perf": None}}


# the examples at their card sizes (the arguments of each one's main)
EXAMPLES = (
    ("grad_spectral", ["--n", "256"]),
    ("jvp_sensitivity", ["--n", "256"]),
    ("fno_layer", ["--n", "128", "--modes", "16", "--steps", "5"]),
    ("packed_spectral", ["--nxy", "256"]),
    ("spectral_poisson", ["--n", "256"]),
    ("distributed_fft", ["--n", "256"]),
    ("dist1d_signal", ["--log2n", "24"]),
)
ENTRY_N = 128


@contextlib.contextmanager
def _unfused_count():
    """Count the unfused engine's dense stages (``stockham._fft_last``,
    which every unfused transform and Bluestein run) while in the block:
    yields a one-element list."""
    from offt_tpu_torch.kernels import stockham
    keep, box = stockham._fft_last, [0]

    def counted(*a, **kw):
        box[0] += 1
        return keep(*a, **kw)
    stockham._fft_last = counted
    try:
        yield box
    finally:
        stockham._fft_last = keep


def _fft_pair(n: int, dev, batch_dims: int = 0):
    """The torch.fft counterpart of examples_torch/_common.real_pair:
    (fwd, inv) of the real n^3 transform over the last three dims."""
    dims, s = (-3, -2, -1), (n,) * 3

    def fwd(x):
        y = torch.fft.rfftn(x, dim=dims)
        return y.real, y.imag

    def inv(yr, yi):
        return torch.fft.irfftn(torch.complex(yr, yi), s=s, dim=dims)
    return fwd, inv


@contextlib.contextmanager
def _on_torch_fft(ex, pair=_fft_pair):
    """The example module ``ex`` with its ``real_pair`` swapped for
    ``pair`` while in the block: what it builds there is its torch.fft
    twin."""
    keep = ex.real_pair
    ex.real_pair = pair
    try:
        yield
    finally:
        ex.real_pair = keep


def fno_step0_err(ex, dev) -> float:
    """The FNO example at its card size (4 x 128^3, 16 modes): the first
    SGD step's weight gradient (zero weights, the example's data) through
    the port's plans against the same through complex128 torch.fft
    autograd, whose c2r states the plan's edge rule (:func:`fno_model`);
    the larger relative error of d/d wr and d/d wi."""
    n, modes = 128, 16
    layer, x, y, _ = ex.setup(n, modes, dev)
    g = torch.autograd.grad(ex.loss_of(layer, x, y), (layer.wr, layer.wi))
    fused = layer.inv.route == "rfft3d"

    def edge_pair(n, dev, batch_dims=0):
        return (_fft_pair(n, dev)[0],
                lambda yr, yi: _c2r_edges(torch.complex(yr, yi), n, fused))
    with _on_torch_fft(ex, edge_pair):
        twin = ex.SpectralConv3d(n, modes, dev).double()
    g64 = torch.autograd.grad(ex.loss_of(twin, x.double(), y.double()),
                              (twin.wr, twin.wi))
    return max(_rel_err(a, None, b) for a, b in zip(g, g64))


def _wall_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def example_steps(name, ex, dev, mesh) -> tuple:
    """(what is timed, the port's call, its torch.fft twin's, timer): an
    iterative example's loop (its data made first) by the host clock
    around one call (after one warm-up call), a one-shot example's
    transform step by CUDA events with the host enqueueing ahead (device
    time, the median of 20)."""
    from offt_tpu_torch.obs.profile import time_cuda

    def host(fn):
        fn()
        return _wall_ms(fn)

    def events(fn):
        return time_cuda(fn, ahead=True)["median_ms"]

    if name == "grad_spectral":
        pb = ex.problem(256, dev)
        with _on_torch_fft(ex):
            tw = ex.problem(256, dev)
        return ("150 gradient steps at 256^3", lambda: ex.descend(pb),
                lambda: ex.descend(tw), host)
    if name == "jvp_sensitivity":
        port = ex.solver(256, dev)[0]
        with _on_torch_fft(ex):
            twin = ex.solver(256, dev)[0]
        return ("jacfwd, 4 solves and a jvp at 256^3",
                lambda: ex.derivatives(port, dev),
                lambda: ex.derivatives(twin, dev), host)
    if name == "fno_layer":
        port = ex.setup(128, 16, dev)
        with _on_torch_fft(ex):
            twin = ex.setup(128, 16, dev)
        return ("5 SGD steps at 4 x 128^3, 16 modes",
                lambda: ex.fit(*port[:3], port[3][0], steps=5),
                lambda: ex.fit(*twin[:3], twin[3][0], steps=5), host)
    if name == "packed_spectral":
        shape = (256, 256, 256)
        x = torch.randn(shape, device=dev)
        port = ex.lowpass_fn(shape, dev)
        g = torch.from_numpy(ex.gains(shape)).to(dev)
        return ("the low-pass at 256^3", lambda: port(x),
                lambda: torch.fft.irfftn(torch.fft.rfftn(x) * g, s=shape),
                events)
    if name == "spectral_poisson":
        _, f = ex.manufactured(256)
        port, blk = ex.solver(256, mesh, dev)
        g = torch.from_numpy(ex.inverse_laplacian(256)).to(dev)
        ft = torch.from_numpy(f).to(dev)
        fb = ft[blk].contiguous()
        return ("the solve at 256^3", lambda: port(fb),
                lambda: torch.fft.irfftn(torch.fft.rfftn(ft) * g,
                                         s=(256,) * 3),
                events)
    if name == "distributed_fft":
        fwd, inv = ex.plans(256, mesh, dev)
        x = ex.global_input(256, dev)
        xb = x[fwd.input_block(x.shape)].contiguous()
        return ("forward and inverse at 256^3", lambda: inv(fwd(xb)),
                lambda: torch.fft.ifftn(torch.fft.fftn(x)), events)
    n = 1 << 24
    fwd, inv = ex.plans(n, mesh, dev)
    sig, _ = ex.record(n, dev)
    xb = sig[fwd.input_block(sig.shape)].contiguous()
    fft = (lambda z: torch.fft.fft(z, norm="ortho"),
           lambda z: torch.fft.ifft(z, norm="ortho"))
    return ("the denoise of 2^24 samples",
            lambda: ex.denoise(xb, fwd, inv, n),
            lambda: ex.denoise(sig, *fft, n), events)


def examples_phase(ot, ff, window, tag, dev, mesh) -> dict:
    """Phase 3m: examples 1-7 at their card sizes, each one's main in a
    counter window of its own (its checks assert; the kernels it
    launched printed, at least one, no plain version, no unfused-engine
    stage; the FNO's first gradient against complex128 torch.fft), then
    its time beside its torch.fft twin's; ``entry()`` at
    128^3 against complex128 torch.fft and ``dryrun_multichip(1)`` in
    this world of one; each bundled 1 x 1 entry of this card (where the
    file holds none, :func:`one_card_record` in the bundled store for the
    step) read by a plan() with no params, its output checked and its time
    beside the default point's (median of 20, three runs); it raises
    where no such entry ran. Returns {window: reading}
    of the examples and the entry."""
    import dataclasses
    import importlib
    import shutil
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(root, "examples_torch"))
    sys.path.insert(0, root)
    import __graft_entry_torch__ as graft
    from offt_tpu_torch.obs.profile import time_cuda
    from offt_tpu_torch.plan import cache
    from offt_tpu_torch.plan.params import ProblemSpec, default_params

    readings = {}

    def checked(label, run):
        with _unfused_count() as unfused:
            out, reading = window(run)
        counts, launched, _ = reading
        ran = {k: v for k, v in launched.items() if v}
        plain = {k: v[1] for k, v in counts.items() if v[1]}
        print(f"{label} window launches per kernel: {ran}; plain calls "
              f"{plain or 0}; unfused-engine stages {unfused[0]} {tag}",
              flush=True)
        if not ran or plain or unfused[0]:
            raise AssertionError(f"{label}: kernels {ran}, plain {plain}, "
                                 f"unfused stages {unfused[0]}")
        readings[label] = reading
        return out

    for name, argv in EXAMPLES:
        ex = importlib.import_module(name)
        t0 = time.perf_counter()
        rc = checked(f"example {name}",
                     lambda: ex.main(argv + ["--device", "cuda"]))
        if rc != 0:
            raise AssertionError(f"example {name} returned {rc}")
        if name == "fno_layer":
            # its 5 steps assert only that the loss falls: hold the first
            # step's gradient, as phase 3h holds its own FNO's
            err = fno_step0_err(ex, dev)
            print(f"example fno_layer step-0 weight gradient rel err vs "
                  f"complex128 torch.fft autograd {err:.3e} (tol "
                  f"{TOL_GRAD2:g}) {tag}", flush=True)
            if err > TOL_GRAD2:
                raise AssertionError(f"fno_layer step 0: error {err:.3e}")
        what, port, twin, timer = example_steps(name, ex, dev, mesh)
        ms, ms_twin = timer(port), timer(twin)
        print(f"time example {name}, {what}: port {ms:.4f} ms, torch.fft "
              f"twin {ms_twin:.4f} ms ({ms / ms_twin:.3f}x); example run "
              f"{time.perf_counter() - t0:.1f} s {tag}", flush=True)
        torch.cuda.empty_cache()

    # the entry point: the forward planar c2c plan at 128^3
    fn, args = graft.entry(n=ENTRY_N)
    yr, yi = checked("entry", lambda: fn(*args))
    err = _rel_err(yr, yi, torch.fft.fftn(torch.complex(*args).to(
        torch.complex128)))
    print(f"path entry() {ENTRY_N}^3 (route {fn.route}): rel err vs "
          f"complex128 fftn {err:.3e} (tol {TOL_PATH:g}) {tag}", flush=True)
    if err > TOL_PATH:
        raise AssertionError(f"entry: error {err:.3e}")
    del fn, args, yr, yi
    t0 = time.perf_counter()
    graft.dryrun_multichip(1)
    print(f"dryrun_multichip(1) on a world of one: every check held, "
          f"{time.perf_counter() - t0:.1f} s {tag}", flush=True)

    # the bundled defaults: plan() with no params reads each entry of this
    # card (an empty local cache, so that no local entry shadows one).
    # Where the file holds no one-card key of this card, the bundled store
    # holds ONE_CARD_RECORD for this step, so that the lookup still runs
    keep = os.environ.get("OFFT_TPU_TORCH_CACHE_DIR")
    tmp = tempfile.mkdtemp(prefix="offt_bundled_")
    os.environ["OFFT_TPU_TORCH_CACHE_DIR"] = tmp
    kind = cache.device_kind(dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    keep_db = cache._bundled()
    store = dict(keep_db)
    if not any(k.split("|")[3] == "1x1" and k.split("|")[4] == kind
               for k in store):
        store.update(one_card_record(kind))
    cache._BUNDLED_DB = store
    checked = 0
    try:
        for key, rec in sorted(store.items()):
            parts = key.split("|")
            if parts[3] != "1x1" or parts[4] != kind:
                print(f"bundled {key}: not a one-card key of {kind}, "
                      f"skipped", flush=True)
                continue
            shape = tuple(int(v) for v in parts[0].split("x"))
            real, inverse = parts[2] == "r2c", parts[-1] == "inv"
            dtype = "float32" if real else "complex64"
            kw = dict(real=real, inverse=inverse, planar=True)
            p = ot.plan(shape, dtype, **kw)
            want = cache._params_from_json(rec["params"])
            if p.params != want:
                raise AssertionError(f"bundled {key}: plan() read "
                                     f"{p.params}, the file {want}")
            spec = ProblemSpec(shape=shape, real=real, inverse=inverse)
            pd = ot.plan(shape, dtype, params=default_params(spec),
                         use_cache=False, **kw)
            if real and inverse:
                w = torch.fft.rfftn(torch.randn(shape, generator=gen,
                                                device=dev))
                x = (w.real.contiguous(), w.imag.contiguous())
                ref = torch.fft.irfftn(w.to(torch.complex128), s=shape)
            elif real:
                x = (torch.randn(shape, generator=gen, device=dev),)
                ref = torch.fft.rfftn(x[0].double())
            else:
                x = tuple(torch.randn(shape, generator=gen, device=dev)
                          for _ in range(2))
                f = torch.fft.ifftn if inverse else torch.fft.fftn
                ref = f(torch.complex(*x).to(torch.complex128))
            y = p(*x)
            err = _rel_err(*y, ref) if isinstance(y, tuple) else \
                _rel_err(y, None, ref)
            if err > TOL_PATH:
                raise AssertionError(f"bundled {key}: error {err:.3e}")
            # as the sweep's rechecks time them (the tuner's CUDA events,
            # the host pacing included), and their device time alone
            tb, td, db, dd = [], [], [], []
            for _ in range(3):
                tb.append(time_cuda(p, x)["median_ms"])
                td.append(time_cuda(pd, x)["median_ms"])
                db.append(time_cuda(p, x, ahead=True)["median_ms"])
                dd.append(time_cuda(pd, x, ahead=True)["median_ms"])
            dflt = dataclasses.asdict(default_params(spec))
            won = {k: v for k, v in dataclasses.asdict(want).items()
                   if v != dflt[k]}
            print(f"bundled {key}: plan() reads the file's point {won}, "
                  f"rel err {err:.3e}; median of 20, three runs: bundled "
                  + ", ".join(f"{v:.4f}" for v in tb) + " ms, default "
                  + ", ".join(f"{v:.4f}" for v in td) + " ms; device time"
                  " alone: bundled " + ", ".join(f"{v:.4f}" for v in db)
                  + " ms, default " + ", ".join(f"{v:.4f}" for v in dd)
                  + f" ms (median of the ratios "
                  f"{sorted(d / b for d, b in zip(dd, db))[1]:.3f}x) {tag}",
                  flush=True)
            del p, pd, x, y, ref
            checked += 1
        if not checked:
            raise AssertionError(f"no bundled one-card key of {kind} ran")
    finally:
        cache._BUNDLED_DB = keep_db
        if keep is None:
            os.environ.pop("OFFT_TPU_TORCH_CACHE_DIR", None)
        else:
            os.environ["OFFT_TPU_TORCH_CACHE_DIR"] = keep
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return readings


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is visible",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import offt_tpu_torch as ot
    except ModuleNotFoundError as e:
        # the script alone, without the package it drives
        print(f"chip_smoke.py needs the offt_tpu_torch package beside it: "
              f"{e}", file=sys.stderr)
        return 1
    from offt_tpu_torch.bench import probe_mxuwidth as pm
    from offt_tpu_torch.bench import probe_ryconcat as pr
    from offt_tpu_torch.bench.roofline import (fft_flops, kernel_bound,
                                               kernel_work, roofline_ms,
                                               table_bytes)
    from offt_tpu_torch.dist import long1d
    from offt_tpu_torch.kernels import _build
    from offt_tpu_torch.kernels import fourstep as fs
    from offt_tpu_torch.kernels import fused_fft as ff
    from offt_tpu_torch.kernels import tables as tb
    from offt_tpu_torch.obs.profile import (device_breakdown, fft3d_breakdown,
                                            pencil_breakdown, time_cuda)
    from offt_tpu_torch.plan import api as plan_api

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card = _card()
    tag = f"[{card}]"
    print(card)
    sms = fs._sms(torch.device("cuda"))
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}, {sms} SMs")

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

    def step1(n1, n2, inverse=False, tw=False, **kw):
        if tw:      # a caller's table (step12_planar's chunk), its own scale
            kw["tw"] = torch.stack(_pair((n1, n2), gen), -1)
        return lambda f, x: f(*x, n1, n2, None, inverse, **kw)

    def step3(n1, n2, inverse=False):
        return lambda f, x: f(*x, n1, n2, None, inverse)

    def step1_shard(n1, n2, p, rank):
        # one rank's step 1 on a p-rank mesh: (1, n1, n2 / p) with the
        # rank's columns of the twiddle (dist/long1d.py)
        w = n2 // p
        tw = torch.from_numpy(tb.fourstep_twiddle_chunk(
            n1, n2, rank * w, (rank + 1) * w, False).copy()).cuda()
        return lambda f, x: f(*x, n1, w, None, False, tw=tw)

    def rlast(packed):
        return lambda f, x: f(x[0], packed=packed)
    # the last check of each kernel is at its main-path shape and is the
    # one timed in phase 5
    checks = [
        ("fft_last", ff.fft_last, lambda f, x: f(*x, scale=0.5), (37, 320),
         None),
        ("fft_last", ff.fft_last,
         lambda f, x: f(*x, inverse=True, scale=1 / 64), (37, 64), None),
        ("fft_last", ff.fft_last, lambda f, x: f(*x), (102400, 320), None),
        ("fft_last", ff.fft_last,
         lambda f, x: f(*x, inverse=True, scale=1 / 192), (65536, 192),
         None),
        ("fft_last", ff.fft_last, lambda f, x: f(*x), (64 * 1024, 1024),
         None),
        ("fft_axis", ff.fft_sublane, lambda f, x: f(*x, 1), (16, 32, 128),
         None),
        ("fft_axis", ff.fft_sublane, lambda f, x: f(*x, 0), (320, 320, 320),
         None),
        ("fft_axis", ff.fft_sublane, lambda f, x: f(*x, 0), (192, 192, 192),
         None),
        ("fft_axis", ff.fft_sublane,
         lambda f, x: f(*x, 1, inverse=True, scale=0.5), (192, 192, 192),
         None),
        ("fft_axis", ff.fft_sublane, lambda f, x: f(*x, 1), (8, 768, 768),
         None),
        ("fft_axis", ff.fft_sublane,
         lambda f, x: f(x[0].clone(), x[1].clone(), 1, inverse=True,
                        scale=0.5, alias=True), (8, 256, 136), None),
        ("fft_axis", ff.fft_sublane, lambda f, x: f(*x, 1),
         (64, 1024, 1024), None),
        ("fft_axis", ff.fft_sublane, lambda f, x: f(*x, 1, scale=0.5),
         (4, 2048, 520), None),
        ("fft_axis", ff.fft_sublane, lambda f, x: f(*x, 1, inverse=True),
         (2, 4096, 520), None),
        ("fft_axis", ff.fft_x_to_padded,
         lambda f, x: f(*x, z_true=128, inverse=True), (16, 32, 129), 128),
        ("fft_axis", ff.fft_x_to_padded,
         lambda f, x: f(*x, z_true=128, inverse=True), (256, 256, 129), 128),
        ("fft_axis", ff.fft_x_from_padded, xpad(128, scale=0.25),
         (16, 32, 136), None),
        ("fft_axis", ff.fft_x_from_padded, xpad(512), (512, 512, 520), None),
        ("fft_axis", ff.fft_x_from_padded, xpad(256), (256, 256, 264), None),
        ("fft_slab", ff.fft_slab_yz, lambda f, x: f(*x, zpad=8, scale=0.5),
         (4, 32, 128), 128),
        ("fft_slab", ff.fft_slab_yz,
         lambda f, x: f(*x, z_true=128, zpad=8, inverse=True,
                        scale=1 / 4096), (2, 32, 136), 128),
        ("fft_slab", ff.fft_slab_yz,
         lambda f, x: f(*x, z_true=128, zpad=8, inverse=True,
                        scale=1 / 32768), (4, 256, 136), 128),
        ("fft_slab", ff.fft_slab_yz,
         lambda f, x: f(x[0].clone(), x[1].clone(), inverse=True,
                        scale=0.5, alias=True), (8, 128, 128), None),
        ("fft_slab", ff.fft_slab_yz, lambda f, x: f(*x, scale=0.5),
         (2, 40, 320), None),
        ("fft_slab", ff.fft_slab_yz, lambda f, x: f(*x, zpad=8),
         (8, 512, 512), 512),
        ("fft_slab", ff.fft_slab_yz, lambda f, x: f(*x), (320, 320, 320),
         None),
        ("fft_slab", ff.fft_slab_yz,
         lambda f, x: f(*x, inverse=True, scale=1 / 102400),
         (320, 320, 320), None),
        ("fft_slab", ff.fft_slab_yz, lambda f, x: f(*x, zpad=8),
         (256, 256, 256), 256),
        ("rfft_slab", ff.rfft_slab_yz, lambda f, x: f(x[0], zpad=8),
         (4, 16, 256), 128),
        ("rfft_slab", ff.rfft_slab_yz, lambda f, x: f(x[0], zpad=8),
         (4, 512, 512), 256),
        ("rfft_slab", ff.rfft_slab_yz, lambda f, x: f(x[0]),
         (2, 40, 640), 320),
        ("rfft_slab", ff.rfft_slab_yz, lambda f, x: f(x[0], zpad=8),
         (256, 256, 256), 128),
        ("irfft_slab", ff.irfft_slab_yz, irfft(256, None, scale=1 / 2048),
         (4, 16, 136), None),
        ("irfft_slab", ff.irfft_slab_yz,
         irfft(256, (4, 16), scale=1 / 2048), (4, 16, 136), None),
        ("irfft_slab", ff.irfft_slab_yz,
         irfft(512, (512, 512), scale=1 / 512 ** 3 * 2), (512, 512, 264),
         None),
        ("irfft_slab", ff.irfft_slab_yz,
         irfft(256, (256, 256), scale=1 / 256 ** 3 * 2), (256, 256, 136),
         None),
        ("assemble_mp1", ff._assemble_mp1, assemble((4, 16)), (4, 16, 128),
         None),
        ("assemble_mp1", ff._assemble_mp1, assemble((256, 256)),
         (256, 256, 128), None),
        ("rfft_last", ff.rfft_last_planar, rlast(True), (37, 256), None),
        ("rfft_last", ff.rfft_last_planar, rlast(False), (37, 256), None),
        ("rfft_last", ff.rfft_last_planar, rlast(True), (37, 258), None),
        ("rfft_last", ff.rfft_last_planar, rlast(False), (37, 258), None),
        # the mixed real rows (M = 48, 3072; 192^3's M = 96) and the dense
        # core at M = 72
        ("rfft_last", ff.rfft_last_planar, rlast(False), (300, 96), None),
        ("rfft_last", ff.rfft_last_planar, rlast(True), (37, 6144), None),
        ("rfft_last", ff.rfft_last_planar, rlast(True), (37, 144), None),
        ("rfft_last", ff.rfft_last_planar, rlast(True), (36864, 192), None),
        ("rfft_last", ff.rfft_last_planar, rlast(False), (36864, 192),
         None),
        ("rfft_last", ff.rfft_last_planar, rlast(True), (65536, 256), None),
        ("rfft_last", ff.rfft_last_planar, rlast(False), (65536, 256), None),
        ("icrfft_last", ff.icrfft_last_planar, lambda f, x: f(*x),
         (300, 64), None),
        ("icrfft_last", ff.icrfft_last_planar, lambda f, x: f(*x),
         (300, 48), None),
        ("icrfft_last", ff.icrfft_last_planar,
         lambda f, x: f(*x, scale=0.5 / 3072), (37, 3072), None),
        ("icrfft_last", ff.icrfft_last_planar, lambda f, x: f(*x),
         (37, 72), None),
        ("icrfft_last", ff.icrfft_last_planar, lambda f, x: f(*x),
         (36864, 96), None),
        ("icrfft_last", ff.icrfft_last_planar,
         lambda f, x: f(*x, scale=0.25 / 256), (65536, 256), None),
        ("icrfft_last", ff.icrfft_last_planar, lambda f, x: f(*x),
         (65536, 128), None),
        ("step1_twiddle", fs._step1_twiddle, step1(128, 256, scale=0.5),
         (3, 128, 256), None),
        ("step1_twiddle", fs._step1_twiddle,
         step1(1024, 1024, inverse=True, scale=2 ** -20), (8, 1024, 1024),
         None),
        ("step1_twiddle", fs._step1_twiddle, step1(2048, 2048),
         (1, 2048, 2048), None),
        ("step1_twiddle", fs._step1_twiddle, step1(4096, 4096),
         (1, 4096, 4096), None),
        ("step1_twiddle", fs._step1_twiddle, step1(1024, 2048),
         (1, 1024, 2048), None),
        ("step1_twiddle", fs._step1_twiddle, step1(4096, 40), (1, 4096, 40),
         None),
        ("step1_twiddle", fs._step1_twiddle, step1(12, 4096), (3, 12, 4096),
         None),
        ("step1_twiddle", fs._step1_twiddle, step1(1024, 200, tw=True),
         (2, 1024, 200), None),
        ("step1_twiddle", fs._step1_twiddle, step1(1024, 768),
         (1, 1024, 768), None),
        ("step1_twiddle", fs._step1_twiddle, step1(768, 1024),
         (1, 768, 1024), None),
        # the shards of 2^24 and 2^20 on a 2 x 2 mesh, rank 1's columns
        ("step1_twiddle", fs._step1_twiddle, step1_shard(4096, 4096, 4, 1),
         (1, 4096, 1024), None),
        ("step1_twiddle", fs._step1_twiddle, step1_shard(1024, 1024, 4, 1),
         (1, 1024, 256), None),
        ("step1_twiddle", fs._step1_twiddle, step1(1024, 1024),
         (1, 1024, 1024), None),
        ("step3_transposed", fs._step3_transposed, step3(128, 256),
         (3, 128, 256), None),
        ("step3_transposed", fs._step3_transposed,
         step3(1024, 1024, inverse=True), (8, 1024, 1024), None),
        ("step3_transposed", fs._step3_transposed, step3(2048, 2048),
         (1, 2048, 2048), None),
        ("step3_transposed", fs._step3_transposed, step3(4096, 4096),
         (1, 4096, 4096), None),
        ("step3_transposed", fs._step3_transposed, step3(1024, 2048),
         (1, 1024, 2048), None),
        ("step3_transposed", fs._step3_transposed, step3(4096, 40),
         (1, 4096, 40), None),
        ("step3_transposed", fs._step3_transposed, step3(12, 4096),
         (3, 12, 4096), None),
        ("step3_transposed", fs._step3_transposed, step3(1024, 768),
         (1, 1024, 768), None),
        ("step3_transposed", fs._step3_transposed, step3(768, 1024),
         (1, 768, 1024), None),
        ("step3_transposed", fs._step3_transposed, step3(1024, 4096),
         (1, 1024, 4096), None),
        ("step3_transposed", fs._step3_transposed, step3(256, 1024),
         (1, 256, 1024), None),
        ("step3_transposed", fs._step3_transposed, step3(1024, 1024),
         (1, 1024, 1024), None),
        ("fft_cube", ff.fft3d_cube, lambda f, x: f(*x, out_scale=0.5),
         (2, 32, 32, 128), None),
        ("fft_cube", ff.fft3d_cube,
         lambda f, x: f(*x, inverse=True, out_scale=2.0), (3, 8, 16, 256),
         None),
        ("fft_cube", ff.fft3d_cube,
         lambda f, x: f(*x, inverse=True, out_scale=0.5), (2, 3, 16, 128),
         None),
        ("fft_cube", ff.fft3d_cube, lambda f, x: f(*x, out_scale=2.0),
         (1, 12, 8, 256), None),
        ("fft_cube", ff.fft3d_cube,
         lambda f, x: f(*x, inverse=True, out_scale=0.5), (3, 5, 8, 8192),
         None),
        ("fft_cube", ff.fft3d_cube, lambda f, x: f(*x), (2, 16, 24, 128),
         None),
        ("fft_cube", ff.fft3d_cube, lambda f, x: f(*x, inverse=True),
         (4, 64, 64, 128), None),
        ("fft_cube", ff.fft3d_cube,
         lambda f, x: f(*x, rad_z=(32, 32, 32), inverse=True),
         (8, 8, 32768), None),
        ("fft_cube", ff.fft3d_cube, lambda f, x: f(*x), (3, 16, 8, 16384),
         None),
        ("fft_cube", ff.fft3d_cube, lambda f, x: f(*x), (8, 128, 128, 128),
         None),
    ]
    per_kernel = {}
    for name, fn, call, shape, lanes in checks:
        x = _pair(shape, gen)
        want = call(fn.plain, x)
        # the slabs, the strided-axis kernel and the four-step pair on both
        # cores; a row kernel or a shape the register core does not take
        # on the core its length takes
        for dense in (False, True) if name in BOTH_CORES else (False,):
            ff.reset_counts()
            with _dense_core(ff) if dense else contextlib.nullcontext():
                got = call(fn, x)
            torch.cuda.synchronize()
            reg = ff.kernel_launches(name, reg=True)
            rel, absd = _max_err(got, want, lanes)
            core = ""
            if name in REG_CORE:
                core = " [register core]" if reg else " [dense core]"
            if name in SLABS and reg:
                # the transform's (Y, z lanes): M for the r2c and c2r,
                # z_true if set
                ny, nz = shape[-2], lanes or shape[-1]
                if name == "irfft_slab":
                    nz = shape[-1] - 8
                clu = (ff._cluster_irslab if name == "irfft_slab"
                       else ff._cluster_slab)
                core = core[:-1] + (", clusters]" if clu(ny, nz)
                                    else ", two grids]")
            if name == "fft_axis" and reg:
                n = shape[0] if fn is not ff.fft_sublane else shape[1]
                core = core[:-1] + f", {ff._axis_tile(n)} tile]"
            if name == "step1_twiddle" and reg:
                tile = fs._step1_tile(*shape[1:], shape[0], sms)
                core = core[:-1] + f", {tile} tile]"
            if name == "step3_transposed" and reg:
                r, c = fs._step3_layout(shape[2])
                core = core[:-1] + f", {r} rows, {c} block(s) a run]"
            if name == "fft_cube" and reg:
                last = ff.fft3d_cube.last
                core = core[:-1] + (
                    f", G {last['group']}, split {last['split']}, "
                    f"{last['barriers']} barriers, grid {last['grid']}, "
                    f"{last['per_sm']} an SM, {last['smem']} B]")
            print(f"check {name} via {fn.__name__} {shape}{core}: max rel "
                  f"err {rel:.3e}, max abs err {absd:.3e} (tol "
                  f"{TOL_KERNEL:g}) {tag}", flush=True)
            if rel > TOL_KERNEL:
                raise AssertionError(f"{name} disagrees with its plain "
                                     "version")
            info = per_kernel.setdefault(name, {"max_abs_err": 0.0})
            info["max_abs_err"] = max(info["max_abs_err"], absd)
            del got
            if not reg:
                break       # a shape the register core does not take
        info["shape"] = shape
        info["call"] = (fn, call)
        del x, want
    missing = set(ff.KERNELS) - set(per_kernel)
    if missing:
        raise AssertionError(f"kernels without a check: {sorted(missing)}")
    # the probes: probe_mma's variants, the r2c slab's wider-tile codes
    probe_errs = probe_checks(ff, pm, pr, sms, tag)

    # ---- 3a. the c2c main path through plan() ----------------------------
    cases = [
        # (label, shape, batch_dims, inverse, norm, in_place)
        ("256^3 fwd ortho", (256, 256, 256), 0, False, "ortho", False),
        ("256^3 inv ortho", (256, 256, 256), 0, True, "ortho", False),
        ("512^3 fwd", (512, 512, 512), 0, False, None, False),
        ("320^3 fwd", (320, 320, 320), 0, False, None, False),
        ("320^3 inv", (320, 320, 320), 0, True, None, False),
        ("256^3 fwd in_place", (256, 256, 256), 0, False, None, True),
        ("256^3 inv in_place", (256, 256, 256), 0, True, None, True),
        ("64x1x1024^2 fwd", (64, 1, 1024, 1024), 1, False, None, False),
    ]
    inputs = {}
    for label, shape, bd, inv, norm, inp in cases:
        inputs[label] = _pair(shape, gen)

    def run_c2c():
        out = {}
        for label, shape, bd, inv, norm, inp in cases:
            xr, xi = inputs[label]
            if inp:
                xr, xi = xr.clone(), xi.clone()
            p = ot.plan(shape[bd:], "complex64", planar=True, inverse=inv,
                        norm=norm, batch_dims=bd, in_place=inp)
            out[label] = p((xr, xi))
        # round trip: the ortho inverse of the ortho forward
        pinv = ot.plan((256, 256, 256), "complex64", planar=True,
                       inverse=True, norm="ortho")
        out["256^3 round trip"] = pinv(out["256^3 fwd ortho"])
        return out
    results, runs = {}, {}
    results, runs["c2c"] = _window(ff, run_c2c)
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
        ("512^3 c2r packed", (512, 512, 512), 0, True, True, None),
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

    def run_r2c():
        out = {}
        for label, shape, bd, inv, packed, norm in real_cases:
            p = ot.plan(shape[bd:], "float32", real=True, planar=True,
                        inverse=inv, packed=packed, norm=norm, batch_dims=bd)
            out[label] = p(*inputs[label][0])
        # round trip: the ortho c2r of the ortho r2c
        pinv = ot.plan((256, 256, 256), "float32", real=True, planar=True,
                       inverse=True, norm="ortho")
        out["256^3 r2c/c2r round trip"] = pinv(*out["256^3 r2c ortho"])
        return out
    results, runs["r2c"] = _window(ff, run_r2c)
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

    # ---- 3c. long 1-D c2c through plan((1, 1, N)): the four-step route -----
    long_cases = [
        # (label, N, batch, inverse, norm, planar)
        ("2^20 fwd", 2 ** 20, 0, False, None, True),
        ("2^20 inv", 2 ** 20, 0, True, None, True),
        ("2^20 fwd ortho", 2 ** 20, 0, False, "ortho", True),
        ("8x2^20 fwd", 2 ** 20, 8, False, None, True),
        ("2^22 fwd", 2 ** 22, 0, False, None, True),
        ("2^24 fwd", 2 ** 24, 0, False, None, True),
        ("3*2^18 fwd (measured split)", 3 * 2 ** 18, 0, False, None, True),
        ("10^6 fwd (4-pass route)", 10 ** 6, 0, False, None, True),
        ("2^20 inv complex64", 2 ** 20, 0, True, "ortho", False),
    ]
    inputs = {}
    for label, n, b, inv, norm, planar in long_cases:
        inputs[label] = _pair(((b,) if b else ()) + (1, 1, n), gen)

    def run_long():
        out = {}
        for label, n, b, inv, norm, planar in long_cases:
            p = ot.plan((1, 1, n), "complex64", planar=planar, inverse=inv,
                        norm=norm, batch_dims=1 if b else 0)
            if p.route != "local":
                raise AssertionError(f"{label}: route {p.route}")
            x = inputs[label]
            out[label] = p(x) if planar else p(torch.complex(*x))
        pinv = ot.plan((1, 1, 2 ** 20), "complex64", planar=True,
                       inverse=True, norm="ortho")
        out["2^20 ortho round trip"] = pinv(out["2^20 fwd ortho"])
        return out
    results, runs["long1d"] = _window(ff, run_long)
    print(f"long 1-D path counts (launches, plain calls): "
          f"{runs['long1d'][0]}")
    for label, n, b, inv, norm, planar in long_cases + [
            ("2^20 ortho round trip", 2 ** 20, 0, None, None, True)]:
        if inv is None:
            src = inputs["2^20 fwd ortho"]
            ref = torch.complex(src[0].double(), src[1].double())
        else:
            src = inputs[label]
            x = torch.complex(src[0].double(), src[1].double())
            f = torch.fft.ifft if inv else torch.fft.fft
            ref = f(x, dim=-1, norm=norm)
            del x
        got = results[label]
        y = got if planar else (got.real, got.imag)
        if tuple(y[0].shape) != tuple(src[0].shape):
            raise AssertionError(f"{label}: shape {tuple(y[0].shape)}")
        if not planar and got.dtype != torch.complex64:
            raise AssertionError(f"{label}: dtype {got.dtype}")
        err = _rel_err(*y, ref)
        print(f"path {label} (split {fs.pick_split(n)}): rel err vs "
              f"complex128 fft {err:.3e} (tol {TOL_PATH:g}) {tag}",
              flush=True)
        if err > TOL_PATH:
            raise AssertionError(f"{label}: error {err:.3e}")
        del ref, got, y
    del results, inputs
    torch.cuda.empty_cache()

    # ---- 3d. the unfused real route through plan(real=True) ---------------
    # the r2c's rfft_last at M = 128 (256^3), 96 (192^3) and 160 (320^3),
    # all on the register core's real rows (the mixed ones of
    # csrc/real_rows_mix.cu); the c2r's around fft_last's rows
    local_cases = [
        # (label, shape, inverse, planar)
        ("256^3 r2c planar=False", (256, 256, 256), False, False),
        ("256^3 c2r planar=False", (256, 256, 256), True, False),
        ("192^3 r2c (outside the packed gate)", (192, 192, 192), False,
         True),
        ("192^3 c2r (outside the packed gate)", (192, 192, 192), True, True),
        ("320^3 r2c (outside the packed gate)", (320, 320, 320), False,
         True),
        ("320^3 c2r (outside the packed gate)", (320, 320, 320), True, True),
        ("(1,1,2^21) r2c", (1, 1, 2 ** 21), False, True),
        ("(1,1,2^21) c2r", (1, 1, 2 ** 21), True, True),
    ]
    inputs = {}
    for label, shape, inv, planar in local_cases:
        x = torch.randn(shape, generator=gen, device="cuda")
        if inv:
            w = torch.fft.rfftn(x.double()).to(torch.complex64)
            arg = (w.real.contiguous(), w.imag.contiguous()) if planar \
                else (w,)
            inputs[label] = (arg, w)
        else:
            inputs[label] = ((x,), x)

    def run_local():
        out = {}
        for label, shape, inv, planar in local_cases:
            p = ot.plan(shape, "float32", real=True, planar=planar,
                        inverse=inv)
            if p.route != "local":
                raise AssertionError(f"{label}: route {p.route}")
            out[label] = p(*inputs[label][0])
        return out
    results, runs["local_real"] = _window(ff, run_local)
    print(f"unfused real path counts (launches, plain calls): "
          f"{runs['local_real'][0]}")
    for label, shape, inv, planar in local_cases:
        got = results[label]
        if inv:
            ref = torch.fft.irfftn(inputs[label][1].to(torch.complex128),
                                   s=shape)
            if tuple(got.shape) != shape or got.dtype != torch.float32:
                raise AssertionError(f"{label}: {tuple(got.shape)} "
                                     f"{got.dtype}")
            err = _rel_err(got, None, ref)
            what = "irfftn"
        else:
            ref = torch.fft.rfftn(inputs[label][1].double())
            y = got if planar else (got.real, got.imag)
            want = (*shape[:-1], shape[-1] // 2 + 1)
            if tuple(y[0].shape) != want:
                raise AssertionError(f"{label}: shape {tuple(y[0].shape)}")
            if not planar and got.dtype != torch.complex64:
                raise AssertionError(f"{label}: dtype {got.dtype}")
            err = _rel_err(*y, ref)
            what = "rfftn"
        print(f"path {label}: rel err vs complex128 {what} {err:.3e} "
              f"(tol {TOL_PATH:g}) {tag}", flush=True)
        if err > TOL_PATH:
            raise AssertionError(f"{label}: error {err:.3e}")
        del ref, got
    del results, inputs
    torch.cuda.empty_cache()

    # ---- 3e. the pencil engine through plan(mesh=make_mesh(1, 1)) ---------
    # a world of one rank on NCCL; its exchanges have groups of one
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    probe = torch.ones(4, device="cuda")
    dist.all_reduce(probe)
    torch.cuda.synchronize()
    if probe.tolist() != [1.0] * 4:
        raise AssertionError(f"NCCL all_reduce gave {probe.tolist()}")
    mesh = ot.make_mesh(1, 1)
    knobs = ot.PlanParams(p1=1, t1=4, t2=4, w1=1, w2=1, ry=5, use_pallas=1)
    cube = (256, 256, 256)
    mesh_cases = [
        # (label, shape, batch_dims, inverse, real, packed, params,
        #  batch_sharded)
        ("256^3 c2c fwd", cube, 0, False, False, False, None, False),
        ("256^3 c2c inv", cube, 0, True, False, False, None, False),
        ("256^3 c2c fwd t=4 w=1 ry=5", cube, 0, False, False, False, knobs,
         False),
        ("256^3 c2c inv t=4 w=1 ry=5", cube, 0, True, False, False, knobs,
         False),
        ("256^3 r2c packed", cube, 0, False, True, True, None, False),
        ("256^3 c2r packed", cube, 0, True, True, True, None, False),
        ("256^3 r2c numpy", cube, 0, False, True, False, None, False),
        ("256^3 c2r numpy", cube, 0, True, True, False, None, False),
        ("512^3 r2c packed", (512,) * 3, 0, False, True, True, None, False),
        ("512^3 c2r packed", (512,) * 3, 0, True, True, True, None, False),
        # rfft_last and icrfft_last at M = 96 on the mixed real rows
        ("192^3 r2c packed", (192,) * 3, 0, False, True, True, None, False),
        ("192^3 c2r packed", (192,) * 3, 0, True, True, True, None, False),
        ("4x128^3 c2c batch_sharded", (4, 128, 128, 128), 1, False, False,
         False, None, True),
    ]
    inputs = {}
    for label, shape, bd, inv, real, packed, prm, bs in mesh_cases:
        if not real:
            inputs[label] = _pair(shape, gen)
            continue
        x = torch.randn(shape, generator=gen, device="cuda")
        if inv:
            w = torch.fft.rfftn(x.double(), dim=(-3, -2, -1)).to(
                torch.complex64)
            arg = (w.real.contiguous(), w.imag.contiguous())
            if packed:
                arg = tuple(t.contiguous() for t in ot.pack_rfft3d(*arg))
            inputs[label] = arg + (w,)
        else:
            inputs[label] = (x,)
        del x

    def run_mesh():
        out = {}
        for label, shape, bd, inv, real, packed, prm, bs in mesh_cases:
            p = ot.plan(shape[bd:], "float32" if real else "complex64",
                        mesh=mesh, real=real, inverse=inv, planar=True,
                        packed=packed, params=prm, batch_dims=bd,
                        batch_sharded=bs)
            if p.route != ("fft3d" if bs else "pencil"):
                raise AssertionError(f"{label}: route {p.route}")
            args = inputs[label][:1 if real and not inv else 2]
            blk = p.input_block(args[0].shape)
            out[label] = p(*(a[blk] for a in args))
        return out
    results, runs["mesh"] = _window(ff, run_mesh)
    print(f"mesh path counts (launches, plain calls): {runs['mesh'][0]}")
    for label, shape, bd, inv, real, packed, prm, bs in mesh_cases:
        got = results[label]
        dims = (-3, -2, -1)
        if not real:
            x = torch.complex(inputs[label][0].double(),
                              inputs[label][1].double())
            ref = (torch.fft.ifftn if inv else torch.fft.fftn)(x, dim=dims)
            what = "complex128 ifftn" if inv else "complex128 fftn"
            del x
        elif inv:
            ref = torch.fft.irfftn(inputs[label][-1].to(torch.complex128),
                                   s=shape, dim=dims)
            what = "complex128 irfftn"
        else:
            ref = torch.fft.rfftn(inputs[label][0].double(), dim=dims)
            what = "complex128 rfftn"
        if real and inv:
            if tuple(got.shape) != shape:
                raise AssertionError(f"{label}: shape {tuple(got.shape)}")
            err = _rel_err(got, None, ref)
        else:
            if real:
                lanes = shape[-1] // 2 + (0 if packed else 1)
                want = (*shape[:-1], lanes)
            else:
                want = shape
            if tuple(got[0].shape) != want:
                raise AssertionError(f"{label}: shape {tuple(got[0].shape)}")
            if packed:
                got = ot.unpack_rfft3d(*got)
            err = _rel_err(*got, ref)
        print(f"path mesh 1x1 {label}: rel err vs {what} {err:.3e} "
              f"(tol {TOL_PATH:g}) {tag}", flush=True)
        if err > TOL_PATH:
            raise AssertionError(f"{label}: error {err:.3e}")
        del ref, got
    del results, inputs
    torch.cuda.empty_cache()

    # ---- 3f. the cube kernel through fft3d_cube ----------------------------
    cube_cases = [
        # (label, shape, kwargs)
        ("8x128^3 fwd", (8, 128, 128, 128), {}),
        ("8x128^3 inv", (8, 128, 128, 128), {"inverse": True}),
        ("8x8x32768 fwd (split z)", (8, 8, 32768), {"rad_z": (32, 32, 32)}),
    ]
    inputs = {label: _pair(shape, gen) for label, shape, _ in cube_cases}

    def run_cube():
        return {label: ot.fft3d_cube(*inputs[label], **kw)
                for label, _, kw in cube_cases}
    results, runs["cube"] = _window(ff, run_cube)
    print(f"cube path counts (launches, plain calls): {runs['cube'][0]}")
    for label, shape, kw in cube_cases:
        x = torch.complex(inputs[label][0].double(),
                          inputs[label][1].double())
        f = torch.fft.ifftn if kw.get("inverse") else torch.fft.fftn
        ref = f(x, dim=(-3, -2, -1))
        yr, yi = results[label]
        if tuple(yr.shape) != shape:
            raise AssertionError(f"{label}: shape {tuple(yr.shape)}")
        err = _rel_err(yr, yi, ref)
        print(f"path cube {label}: rel err vs complex128 fftn {err:.3e} "
              f"(tol {TOL_PATH:g}) {tag}", flush=True)
        if err > TOL_PATH:
            raise AssertionError(f"cube {label}: error {err:.3e}")
        del x, ref
    del results, inputs
    torch.cuda.empty_cache()

    # ---- 3g. the numpy.fft namespace at full size -------------------------
    def cplx(shape, dtype=torch.complex64):
        return torch.randn(shape, dtype=dtype, generator=gen, device="cuda")
    prime = 1000003
    ns = {"fftn 256^3": cplx((256, 256, 256)),
          "rfftn 256^3": torch.randn((256, 256, 256), generator=gen,
                                     device="cuda"),
          f"fft {prime}": cplx((prime,)),
          "fftn (8,64,64,64)": cplx((8, 64, 64, 64)),
          "fftn 128^3 complex128": cplx((128, 128, 128), torch.complex128)}
    ns["irfftn 256^3"] = torch.fft.rfftn(ns["rfftn 256^3"].double()).to(
        torch.complex64)
    ns_calls = {
        # label: (the namespace call, its complex128 torch.fft twin, bar)
        "fftn 256^3": (ot.fft.fftn, torch.fft.fftn, TOL_PATH),
        "rfftn 256^3": (ot.fft.rfftn, torch.fft.rfftn, TOL_PATH),
        "irfftn 256^3": (ot.fft.irfftn, torch.fft.irfftn, TOL_PATH),
        f"fft {prime}": (ot.fft.fft, torch.fft.fft, TOL_PATH),
        "fftn (8,64,64,64)": (ot.fft.fftn, torch.fft.fftn, TOL_PATH),
        "fftn 128^3 complex128": (ot.fft.fftn, torch.fft.fftn, TOL_PATH64),
    }

    def run_ns():
        return {label: fn(ns[label]) for label, (fn, _, _) in
                ns_calls.items()}
    results, runs["namespace"] = _window(ff, run_ns)
    print(f"namespace path counts (launches, plain calls): "
          f"{runs['namespace'][0]}")
    for label, (fn, twin, bar) in ns_calls.items():
        x = ns[label]
        wide = x.double() if not x.is_complex() else x.to(torch.complex128)
        ref = twin(wide)
        got = results[label]
        want_dtype = (torch.complex128 if x.dtype == torch.complex128
                      else torch.float32 if fn is ot.fft.irfftn
                      else torch.complex64)
        if tuple(got.shape) != tuple(ref.shape) or got.dtype != want_dtype:
            raise AssertionError(f"{label}: {tuple(got.shape)} {got.dtype}")
        err = _rel_err(got, None, ref)
        print(f"path namespace {label}: rel err vs complex128 torch.fft "
              f"{err:.3e} (tol {bar:g}) {tag}", flush=True)
        if err > bar:
            raise AssertionError(f"namespace {label}: error {err:.3e}")
        del ref, got, wide
    del results
    torch.cuda.empty_cache()

    # ---- 3h. gradients through the plans: the backward path --------------
    # each backward with the counters zeroed just before and read just
    # after (the forward it differentiates runs outside the window)
    t0 = time.perf_counter()
    grad_runs = grad_phase(ot, ff, gen, mesh, lambda fn: _window(ff, fn),
                           tag)
    print(f"phase 3h: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # ---- 3i. the long-1-D engine and the namespace on the 1 x 1 mesh ------
    t0 = time.perf_counter()
    runs.update(long1d_phase(ot, ff, fs, long1d, plan_api, gen, mesh,
                             lambda fn: _window(ff, fn), tag))
    print(f"phase 3i: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # ---- 3j. the tuner: three tunings, their winners read back ------------
    t0 = time.perf_counter()
    tune_runs = tune_phase(ot, lambda fn: _window(ff, fn), tag)
    print(f"phase 3j: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # ---- 3k. the bench layer: runfft and the BASELINE suite ---------------
    t0 = time.perf_counter()
    bench_runs = bench_phase(lambda fn: _window(ff, fn), tag)
    print(f"phase 3k: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.cuda.empty_cache()

    # ---- 3l. the probes through their entry points -----------------------
    t0 = time.perf_counter()
    mma_launches, probe_runs = probe_phase(ff, pm, pr, sms,
                                           lambda fn: _window(ff, fn), tag)
    print(f"phase 3l: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 3m. the examples, the entry point, the bundled defaults ---------
    t0 = time.perf_counter()
    example_runs = examples_phase(ot, ff, lambda fn: _window(ff, fn), tag,
                                  torch.device("cuda",
                                               torch.cuda.current_device()),
                                  mesh)
    print(f"phase 3m: {time.perf_counter() - t0:.1f} s", flush=True)

    # ---- 4. the counters -----------------------------------------------
    path_kernels = {"c2c": ("fft_last", "fft_axis", "fft_slab"),
                    "r2c": ("fft_axis", "rfft_slab", "irfft_slab",
                            "assemble_mp1"),
                    "long1d": ("step1_twiddle", "step3_transposed",
                               "fft_axis", "fft_last"),
                    "local_real": ("rfft_last", "fft_axis", "fft_last",
                                   "step1_twiddle", "step3_transposed"),
                    "mesh": ("icrfft_last", "rfft_last", "fft_last",
                             "fft_axis", "fft_slab"),
                    "cube": ("fft_cube",),
                    "namespace": ("fft_slab", "fft_axis", "fft_last",
                                  "rfft_last", "step1_twiddle",
                                  "step3_transposed"),
                    "long1d_engine": ("step1_twiddle", "step3_transposed"),
                    "long1d_adjoint": ("step1_twiddle", "step3_transposed"),
                    "mesh_namespace": ("step1_twiddle", "step3_transposed",
                                       "fft_last", "fft_axis", "rfft_last")}
    for label, (reading, kernels) in {**grad_runs, **tune_runs,
                                      **bench_runs}.items():
        runs[label] = reading
        path_kernels[label] = kernels
    for path, (counts, launched, regs) in runs.items():
        for name in path_kernels[path]:
            if launched[name] <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     f"{path} path")
        plain = {k: v[1] for k, v in counts.items() if v[1]}
        if plain:
            raise AssertionError(f"plain versions ran on the {path} path: "
                                 f"{plain}")
        cores = {k: f"{regs[k]} register, {launched[k] - regs[k]} dense"
                 for k in REG_CORE if launched[k]}
        print(f"{path} path launches per kernel: {launched}; row-kernel "
              f"cores: {cores}; plain calls: 0")
    # 3l: each r2c slab code's window launched rfft_slab once, on the
    # register core, and no plain version
    for label, (counts, launched, regs) in probe_runs.items():
        plain = {k: v[1] for k, v in counts.items() if v[1]}
        ran = {k: n for k, n in launched.items() if n}
        if ran != {"rfft_slab": 1} or regs["rfft_slab"] != 1 or plain:
            raise AssertionError(f"probe window {label}: {ran}, register "
                                 f"{regs['rfft_slab']}, plain {plain}")
        print(f"{label} window launches per kernel: {ran}; register core; "
              "plain calls: 0")
    # the one fft_last length of 3a is N = 1024 (the 64 x 1024^2 case);
    # 3d runs rfft_last at N = 256 (256^3), 192 (192^3) and 320 (320^3),
    # all on the register core (M = 96 and 160 on the mixed real rows)
    c2c_last = runs["c2c"][1]["fft_last"]
    if not 0 < runs["c2c"][2]["fft_last"] == c2c_last:
        raise AssertionError("fft_last at N = 1024 did not run the register "
                             f"core: {runs['c2c'][2]} of {c2c_last}")
    real_last = runs["local_real"][1]["rfft_last"]
    if not 3 <= runs["local_real"][2]["rfft_last"] == real_last:
        raise AssertionError("rfft_last did not run the register core "
                             f"throughout 3d: {runs['local_real'][2]} of "
                             f"{real_last}")
    print(f"register core: fft_last at N = 1024 on 3a ({c2c_last} of "
          f"{c2c_last}); rfft_last on 3d "
          f"({runs['local_real'][2]['rfft_last']} of {real_last}: N = 256, "
          "192 and 320)")
    # 3a's slabs: 256^3 (five calls), 512^3 and 320^3 (forward and
    # inverse, the mixed rows and columns) all on the register core; 3b's
    # r2c slabs (256^3, 512^3, 128 x 256) all register
    c2c_slab, c2c_slab_reg = runs["c2c"][1]["fft_slab"], \
        runs["c2c"][2]["fft_slab"]
    if not (c2c_slab >= 8 and c2c_slab_reg == c2c_slab):
        raise AssertionError("fft_slab on 3a: want 256^3, 512^3 and 320^3 "
                             f"on the register core: {c2c_slab_reg} "
                             f"register of {c2c_slab}")
    r_slab, r_slab_reg = runs["r2c"][1]["rfft_slab"], \
        runs["r2c"][2]["rfft_slab"]
    if not 0 < r_slab_reg == r_slab:
        raise AssertionError("rfft_slab on 3b did not run the register core "
                             f"throughout: {r_slab_reg} of {r_slab}")
    print(f"register core: fft_slab on 3a ({c2c_slab_reg} of {c2c_slab}: "
          f"256^3, 512^3 and the 320^3 slab (two grids: the mixed rows, "
          f"then the mixed columns)); rfft_slab on 3b "
          f"({r_slab_reg} of {r_slab})")
    # the strided-axis kernel on 3a: every x pass on the register core,
    # 256^3 and 512^3 (fft_x_from_padded, five calls), 320^3 (the mixed
    # radix-20 column variant), in place and the 64 x 1024^2 y pass
    # (fft_sublane); on 3b the c2r's x pass (fft_x_to_padded) and the
    # r2c's; on 3d the axis passes of 256^3, 192^3 (radix 12) and 320^3
    # (radix 20);
    # irfft_slab on 3b's 256^3 and 512^3 c2r (five calls)
    ax_c2c, ax_c2c_reg = runs["c2c"][1]["fft_axis"], \
        runs["c2c"][2]["fft_axis"]
    if runs["c2c"][0]["fft_x_from_padded"][0] < 4 or ax_c2c_reg != ax_c2c:
        raise AssertionError("fft_axis on 3a: want every x pass on the "
                             f"register core: {ax_c2c_reg} of {ax_c2c}")
    ax_r, ax_r_reg = runs["r2c"][1]["fft_axis"], runs["r2c"][2]["fft_axis"]
    ir, ir_reg = runs["r2c"][1]["irfft_slab"], runs["r2c"][2]["irfft_slab"]
    if not (0 < ax_r_reg == ax_r and ir >= 4 and ir_reg == ir):
        raise AssertionError("3b: want every x pass and every irfft_slab on "
                             f"the register core: fft_axis {ax_r_reg} of "
                             f"{ax_r}, irfft_slab {ir_reg} of {ir}")
    ax_l, ax_l_reg = runs["local_real"][1]["fft_axis"], \
        runs["local_real"][2]["fft_axis"]
    if not 0 < ax_l_reg == ax_l:
        raise AssertionError("3d: want every axis pass (256^3, 192^3, "
                             "320^3) on the register core: "
                             f"{ax_l_reg} of {ax_l}")
    print(f"register core: fft_axis on 3a ({ax_c2c_reg} of {ax_c2c}: the x "
          "passes of 256^3, 512^3 and 320^3, in place and the 64 x 1024^2 "
          f"y pass), on 3b ({ax_r_reg} of {ax_r}) and on 3d ({ax_l_reg} of "
          f"{ax_l}: 256^3, 192^3 and 320^3); irfft_slab on 3b ({ir_reg} "
          f"of {ir}: 256^3 and 512^3)")
    # the 1 x 1 mesh's packed c2r stages (256^3, 512^3, 192^3: M = 128,
    # 256, 96) on the register core's c2r rows, and its r2c z stages
    # (rfft_last at the same M) on its r2c rows
    ic, ic_reg = runs["mesh"][1]["icrfft_last"], \
        runs["mesh"][2]["icrfft_last"]
    rl, rl_reg = runs["mesh"][1]["rfft_last"], runs["mesh"][2]["rfft_last"]
    if not (0 < ic_reg == ic and 0 < rl_reg == rl):
        raise AssertionError("3e: want icrfft_last and rfft_last on the "
                             f"register core throughout: icrfft_last "
                             f"{ic_reg} of {ic}, rfft_last {rl_reg} of {rl}")
    print(f"register core: icrfft_last on 3e ({ic_reg} of {ic}: M = 128, "
          f"256 and 96), rfft_last on 3e ({rl_reg} of {rl})")
    # the four-step pair, each kernel on the core of its own length: on 3c
    # every power-of-two split (2^20 four times, 8 x 2^20, 2^22, 2^24) and
    # 3 * 2^18's (1024, 768) take the register core, but for step 3 at 768
    # (dense; 10^6 takes the 4-pass route); 3d's long real record and 3g's
    # prime (their inner 2^20 and 2^21) run it throughout
    for path, dense3 in (("long1d", 1), ("local_real", 0), ("namespace", 0)):
        s1, s1r = runs[path][1]["step1_twiddle"], \
            runs[path][2]["step1_twiddle"]
        s3, s3r = runs[path][1]["step3_transposed"], \
            runs[path][2]["step3_transposed"]
        if not (0 < s1r == s1 and s3 > 0 and s3 - s3r == dense3):
            raise AssertionError(f"the four-step pair on {path}: step1 "
                                 f"{s1r} register of {s1}, step3 {s3r} of "
                                 f"{s3} (want {dense3} dense)")
        print(f"register core: step1_twiddle on {path} ({s1r} of {s1}), "
              f"step3_transposed ({s3r} of {s3}"
              + ("; 3*2^18's 768 side dense)" if dense3 else ")"))
    # 3i: every engine call (six forward, two adjoints) ran the pair once,
    # both kernels on the register core (the splits of 2^24, 2^23, 2^20)
    for path, calls in (("long1d_engine", ENGINE_CALLS),
                        ("long1d_adjoint", 2)):
        got = {k: (runs[path][1][k], runs[path][2][k])
               for k in ("step1_twiddle", "step3_transposed")}
        if any(v != (calls, calls) for v in got.values()):
            raise AssertionError(f"3i {path}: want {calls} register-core "
                                 f"launches of each kernel of the pair "
                                 f"(launches, register): {got}")
        print(f"register core: the four-step pair on 3i's {path} "
              f"({calls} of {calls} each)")
    # 3f's cubes (8 x 128^3 forward and inverse, 8 x 8 x 32768) all on the
    # register cube
    cu, cu_reg = runs["cube"][1]["fft_cube"], runs["cube"][2]["fft_cube"]
    if not 0 < cu_reg == cu:
        raise AssertionError("fft_cube on 3f: want the register cube "
                             f"throughout: {cu_reg} of {cu}")
    print(f"register core: fft_cube on 3f ({cu_reg} of {cu})")
    # 3h at the 256^3 cube: every slab and strided-axis launch of each
    # backward (and of the jvp and the grad of grad) on the register core
    for label in grad_runs:
        if any(k in label for k in ("unfused", "long", "fft2d", "FNO")):
            continue
        launched, regs = runs[label][1], runs[label][2]
        off = {k: (regs[k], launched[k]) for k in
               ("fft_slab", "rfft_slab", "fft_axis")
               if regs[k] != launched[k]}
        if off:
            raise AssertionError(f"{label}: not on the register core "
                                 f"(register, launches): {off}")
    print("register core: fft_slab, rfft_slab and fft_axis throughout the "
          "256^3 backwards of 3h")
    # the kernels line counts every path's windows, 3m's among them
    launches = {k: sum(r[1][k] for r in [*runs.values(),
                                          *example_runs.values()])
                for k in ff.KERNELS}
    in_3m = {k: n for k in ff.KERNELS
             if (n := sum(r[1][k] for r in example_runs.values()))}
    print(f"phase 3m windows' launches per kernel (within the kernels "
          f"line's): {in_3m}", flush=True)

    # ---- 5. times --------------------------------------------------------
    def show(label, r, extra=""):
        print(f"time {label}: median {r['median_ms']:.4f} ms, min "
              f"{r['min_ms']:.4f}, max {r['max_ms']:.4f}, spread "
              f"{r['spread']:.3f} over {r['reps']}{extra} {tag}", flush=True)

    def show_breakdown(label, fn, args=()):
        b = device_breakdown(fn, args)
        ops = "; ".join(f"{_short(k)} {ms:.4f} ms x{c:g}"
                        for k, ms, c in b["top"])
        print(f"profile {label}: wall {b['wall_ms']:.4f} ms per call, "
              f"device {b['device_ms']:.4f} ms, busy share "
              f"{b['busy_share']:.3f}; top: {ops} {tag}", flush=True)

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
        # the slab kernel against the unfused z + y passes (fft_last, then
        # the dense strided-axis kernel)
        def unfused():
            a = ff.fft_last(xr, xi)
            return ff.fft_sublane(*a, 1)
        r_slab = time_cuda(ff.fft_slab_yz, (xr, xi))
        r_two = time_cuda(unfused)
        bytes_ = 16 * n ** 3
        show(f"slab {n}^3 (fft_slab_yz)", r_slab,
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
        if n == 256:
            # the unfused real route against the packed one and cuFFT
            for inv, arg in ((False, x), (True, w)):
                p = ot.plan(shape, "float32", real=True, inverse=inv)
                r = time_cuda(p, (arg,))
                show(f"port {'c2r' if inv else 'r2c'} planar=False "
                     "(unfused route) 256^3", r,
                     rate.format(flops / r["median_ms"] / 1e6))
        del x, w
        torch.cuda.empty_cache()

    # long 1-D: the port (plan) against cuFFT (torch.fft.fft on complex64),
    # 5 N log2 N flops per transform, and each of its passes alone
    for label, n, b in (("2^20", 2 ** 20, 1), ("8x2^20", 2 ** 20, 8),
                        ("2^22", 2 ** 22, 1), ("2^24", 2 ** 24, 1),
                        ("10^6 (4-pass route)", 10 ** 6, 1)):
        xr, xi = _pair((b, 1, 1, n), gen)
        xc = torch.complex(xr, xi)
        p = ot.plan((1, 1, n), "complex64", planar=True, batch_dims=1)
        flops = 5 * b * n * math.log2(n)
        r_port = time_cuda(p, ((xr, xi),))
        r_cufft = time_cuda(torch.fft.fft, (xc,))
        show(f"port fft {label}", r_port,
             f", {flops / r_port['median_ms'] / 1e6:.1f} GFLOP/s, "
             f"{r_port['median_ms'] / r_cufft['median_ms']:.2f}x cuFFT")
        show(f"torch.fft.fft (cuFFT) c64 {label}", r_cufft,
             f", {flops / r_cufft['median_ms'] / 1e6:.1f} GFLOP/s")
        n1, n2 = fs.pick_split(n)
        if n1 % 128 or n2 % 128:     # not the fused pair
            del xr, xi, xc
            continue
        # each kernel of the pair alone on each core, and their sum against
        # cuFFT's fft of the whole transform (device times, ahead)
        x3 = (xr.reshape(b, n1, n2), xi.reshape(b, n1, n2))
        z3 = fs._step1_twiddle(*x3, n1, n2, None, False)
        r_lib = time_cuda(torch.fft.fft, (xc,), ahead=True)["median_ms"]
        pair_ms = 0.0
        for what, fn, args, n_k in (
                ("step1_twiddle", fs._step1_twiddle,
                 (*x3, n1, n2, None, False), n1),
                ("step3_transposed", fs._step3_transposed,
                 (*z3, n1, n2, None, False), n2)):
            r = time_cuda(fn, args, ahead=True)
            with _dense_core(ff):
                r_d = time_cuda(fn, args, ahead=True)["median_ms"]
            ms = r["median_ms"]
            pair_ms += ms
            bms, by = kernel_bound(what, (b, n1, n2))
            nbytes = kernel_work(what, (b, n1, n2))[0]
            core = "register" if ff._reg_core(n_k) else "dense"
            show(f"kernel {what} ({b}, {n1}, {n2}), {core} core", r,
                 f", {nbytes / ms / 1e9:.3f} TB/s, {bms / ms:.3f} of its "
                 f"bound {bms:.4f} ms ({by}); dense core {r_d:.4f} ms "
                 f"({r_d / ms:.2f}x)")
        print(f"pair {label}: step1 + step3 {pair_ms:.4f} ms, torch.fft.fft "
              f"{r_lib:.4f} ms, {pair_ms / r_lib:.2f}x {tag}", flush=True)
        del xr, xi, xc, x3, z3
        torch.cuda.empty_cache()
    # r2c along a long 1-D: the unfused real route against cuFFT's rfft
    n = 2 ** 21
    x = torch.randn((1, 1, n), generator=gen, device="cuda")
    p = ot.plan((1, 1, n), "float32", real=True, planar=True)
    r_port = time_cuda(p, (x,))
    r_cufft = time_cuda(torch.fft.rfft, (x,))
    show("port rfft (1, 1, 2^21)", r_port,
         f", {r_port['median_ms'] / r_cufft['median_ms']:.2f}x cuFFT")
    show("torch.fft.rfft (cuFFT) f32 2^21", r_cufft)
    del x
    # where the new routes' time goes (torch.profiler, 10 back-to-back calls)
    for b, n in ((1, 2 ** 20), (8, 2 ** 20), (1, 2 ** 22), (1, 2 ** 24),
                 (1, 10 ** 6)):
        xr, xi = _pair((b, 1, 1, n), gen)
        show_breakdown(f"port fft ({b}, 1, 1, {n})",
                       ot.plan((1, 1, n), "complex64", planar=True,
                               batch_dims=1), ((xr, xi),))
        del xr, xi
    x = torch.randn((256, 256, 256), generator=gen, device="cuda")
    w = torch.fft.rfftn(x)
    for inv, arg in ((False, x), (True, w)):
        show_breakdown(f"port {'c2r' if inv else 'r2c'} planar=False 256^3",
                       ot.plan((256, 256, 256), "float32", real=True,
                               inverse=inv), (arg,))
    # the unfused real route at 192^3 and 320^3 (rfft_last at M = 96 and
    # 160 on the mixed real rows)
    for n in (192, 320):
        x = torch.randn((n, n, n), generator=gen, device="cuda")
        p = ot.plan((n, n, n), "float32", real=True, planar=True)
        show_breakdown(f"port r2c {n}^3 (local)", p, (x,))
        show_breakdown(f"port c2r {n}^3 (local)",
                       ot.plan((n, n, n), "float32", real=True, planar=True,
                               inverse=True), p(x))
    x = torch.randn((1, 1, 2 ** 21), generator=gen, device="cuda")
    p = ot.plan((1, 1, 2 ** 21), "float32", real=True, planar=True)
    show_breakdown("port rfft (1, 1, 2^21)", p, (x,))
    show_breakdown("port irfft (1, 1, 2^21)",
                   ot.plan((1, 1, 2 ** 21), "float32", real=True,
                           planar=True, inverse=True), p(x))
    del x, w
    torch.cuda.empty_cache()
    # both split orders at 3 * 2^18 (the reference's one measured split)
    n = 3 * 2 ** 18
    xr, xi = _pair((n,), gen)
    for split in ((1024, 768), (768, 1024)):
        show(f"four-step 3*2^18 split {split}",
             time_cuda(lambda s=split: fs.fft_four_step_planar(xr, xi,
                                                               split=s)))
    del xr, xi
    torch.cuda.empty_cache()

    # the pencil engine on the 1 x 1 mesh against cuFFT and against the
    # single-device plan of the same transform: the pipeline's own cost
    for n, real in ((256, False), (256, True), (512, True)):
        shape = (n, n, n)
        if real:
            x = torch.randn(shape, generator=gen, device="cuda")
            w = torch.fft.rfftn(x)
            args = tuple(t.contiguous() for t in ot.pack_rfft3d(
                w.real.contiguous(), w.imag.contiguous()))
            kw = {"real": True, "inverse": True, "planar": True,
                  "packed": True}
            dtype, label = "float32", f"packed c2r {n}^3"
            r_c = time_cuda(lambda: torch.fft.irfftn(w, s=shape))
            del x
        else:
            args = _pair(shape, gen)
            w = torch.complex(*args)
            kw = {"planar": True}
            dtype, label = "complex64", f"c2c fwd {n}^3"
            r_c = time_cuda(torch.fft.fftn, (w,))
        p_mesh = ot.plan(shape, dtype, mesh=mesh, **kw)
        p_one = ot.plan(shape, dtype, **kw)
        r_m = time_cuda(p_mesh, args)
        r_o = time_cuda(p_one, args)
        show(f"port mesh 1x1 {label}", r_m,
             f", {r_m['median_ms'] / r_o['median_ms']:.2f}x the "
             f"single-device plan, {r_m['median_ms'] / r_c['median_ms']:.2f}"
             "x cuFFT")
        show(f"port single-device {label} (route {p_one.route})", r_o)
        show(f"torch.fft (cuFFT) {label}", r_c)
        if real and n == 256:
            with _dense_core(ff):
                r_d = time_cuda(p_mesh, args)
            show(f"port mesh 1x1 {label}, dense core", r_d,
                 f", {r_d['median_ms'] / r_m['median_ms']:.2f}x the "
                 "register core")
            show_breakdown(f"port mesh 1x1 {label}", p_mesh, args)
            # four chunks a phase, a window of one and the ry split: the
            # pipeline's chunk copies and concatenations
            p_knob = ot.plan(shape, dtype, mesh=mesh, params=knobs, **kw)
            r_k = time_cuda(p_knob, args)
            show(f"port mesh 1x1 {label} t=4 w=1 ry=5", r_k,
                 f", {r_k['median_ms'] / r_m['median_ms']:.2f}x the "
                 "default point")
            show_breakdown(f"port mesh 1x1 {label} t=4 w=1 ry=5", p_knob,
                           args)
            del p_knob
        del args, w, p_mesh, p_one
        torch.cuda.empty_cache()
    # the long-1-D engine at P = 1, the pair at a rank's shard shapes, and
    # the per-stage breakdowns (the mesh's one)
    long1d_times(ot, fs, tb, long1d, gen, mesh, show, show_breakdown,
                 time_cuda, fft3d_breakdown, pencil_breakdown, tag)
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    # the cube (one launch) on the register core and on the dense core (at
    # the reference's radix picks: 128 is one radix-128 stage), against
    # fft3d_planar (the slab and the x pass) on the same data and cuFFT;
    # G, the barriers, the cooperative grid and its blocks an SM (each
    # shape's numbers also go into the kernels line)
    cube_rows = []
    for shape, kw in (((8, 128, 128, 128), {}),
                      ((8, 8, 32768), {"rad_z": (32, 32, 32)}),
                      ((4, 64, 64, 128), {})):
        xr, xi = _pair(shape, gen)
        r_c = time_cuda(lambda: ff.fft3d_cube(xr, xi, **kw), ahead=True)
        last = ff.fft3d_cube.last
        with _dense_core(ff):
            r_d = time_cuda(lambda: ff.fft3d_cube(xr, xi, **kw), ahead=True)
        r_p = time_cuda(lambda: ff.fft3d_planar(xr, xi, **kw), ahead=True)
        r_lib = time_cuda(torch.fft.fftn, (torch.complex(xr, xi), None,
                                           (-3, -2, -1)), ahead=True)
        bms, by = kernel_bound("fft_cube", shape if len(shape) == 4
                         else (1, *shape))
        c, p, lib = r_c["median_ms"], r_p["median_ms"], r_lib["median_ms"]
        cube_rows.append({"shape": list(shape), "ms": c,
                          "dense_ms": r_d["median_ms"], "planar_ms": p,
                          "library_ms": lib, "bound_ms": bms, "bound_by": by,
                          **{k: last[k] for k in ("group", "barriers", "grid",
                                                  "per_sm")}})
        show(f"cube {shape} register (fft3d_cube, one launch)", r_c,
             f", {c / p:.2f}x fft3d_planar, {c / lib:.2f}x cuFFT, "
             f"{bms / c:.3f} of its {bms:.4f} ms bound, "
             f"{r_d['median_ms'] / c:.2f}x faster than the dense core; G "
             f"{last['group']}, split {last['split']}, {last['barriers']} "
             f"barriers, grid {last['grid']} ({last['per_sm']} an SM), "
             f"{last['smem']} B shared")
        show(f"cube {shape} dense core (reference picks)", r_d)
        show(f"fft3d_planar {shape} (slab + x pass)", r_p)
        show(f"torch.fft.fftn (cuFFT) c64 {shape}", r_lib)
        if shape[-1] == 128 and shape[0] == 8:
            show_breakdown("cube 8x128^3", ff.fft3d_cube, (xr, xi))
            show_breakdown("fft3d_planar 8x128^3", ff.fft3d_planar, (xr, xi))
        del xr, xi
    torch.cuda.empty_cache()
    # the namespace calls against their torch.fft twins on the same input
    for label, (fn, twin, _) in ns_calls.items():
        r_n = time_cuda(fn, (ns[label],))
        r_t = time_cuda(twin, (ns[label],))
        show(f"namespace {label}", r_n,
             f", {r_n['median_ms'] / r_t['median_ms']:.2f}x torch.fft")
        show(f"torch.fft twin {label}", r_t)
    show_breakdown(f"namespace fft {prime}", ot.fft.fft,
                   (ns[f"fft {prime}"],))
    show_breakdown("namespace fftn 128^3 complex128", ot.fft.fftn,
                   (ns["fftn 128^3 complex128"],))
    del ns
    torch.cuda.empty_cache()

    # the row kernels' paths, each with the register core and with the
    # dense core on the same data and plan
    xr, xi = _pair((64, 1, 1024, 1024), gen)
    x3 = torch.randn((256, 256, 256), generator=gen, device="cuda")
    c3 = _pair((256, 256, 256), gen)
    x5 = torch.randn((512, 512, 512), generator=gen, device="cuda")
    c5 = _pair((512, 512, 512), gen)
    c320 = _pair((320, 320, 320), gen)
    x192 = torch.randn((192, 192, 192), generator=gen, device="cuda")
    x320 = torch.randn((320, 320, 320), generator=gen, device="cuda")
    real = {"real": True, "planar": True}
    paths = (
        ("c2c 64x1024^2 (plan, 2-D route)",
         ot.plan((1, 1024, 1024), "complex64", planar=True, batch_dims=1),
         ((xr, xi),)),
        ("r2c 256^3 planar=False (plan)",
         ot.plan((256, 256, 256), "float32", real=True), (x3,)),
        ("namespace rfftn 256^3", ot.fft.rfftn, (x3,)),
        ("c2c 256^3 (plan, slab + x)",
         ot.plan((256, 256, 256), "complex64", planar=True), (c3,)),
        ("c2c 512^3 (plan, slab + x)",
         ot.plan((512, 512, 512), "complex64", planar=True), (c5,)),
        ("c2c 320^3 (plan, slab + x)",
         ot.plan((320, 320, 320), "complex64", planar=True), (c320,)),
        # rfft_last at M = 96 and 160 on the mixed real rows
        ("r2c 192^3 (plan, local)",
         ot.plan((192, 192, 192), "float32", **real), (x192,)),
        ("c2r 192^3 (plan, local)",
         ot.plan((192, 192, 192), "float32", inverse=True, **real),
         ot.plan((192, 192, 192), "float32", **real)(x192)),
        ("r2c 320^3 (plan, local)",
         ot.plan((320, 320, 320), "float32", **real), (x320,)),
        ("c2r 320^3 (plan, local)",
         ot.plan((320, 320, 320), "float32", inverse=True, **real),
         ot.plan((320, 320, 320), "float32", **real)(x320)),
        ("r2c 256^3 packed (plan)",
         ot.plan((256, 256, 256), "float32", packed=True, **real), (x3,)),
        ("r2c 256^3 numpy (plan)",
         ot.plan((256, 256, 256), "float32", **real), (x3,)),
        ("r2c 512^3 packed (plan)",
         ot.plan((512, 512, 512), "float32", packed=True, **real), (x5,)),
        ("namespace fftn 256^3", ot.fft.fftn, (torch.complex(*c3),)),
        ("c2r 256^3 packed (plan)",
         ot.plan((256, 256, 256), "float32", packed=True, inverse=True,
                 **real),
         ot.plan((256, 256, 256), "float32", packed=True, **real)(x3)),
        ("c2r 256^3 numpy (plan)",
         ot.plan((256, 256, 256), "float32", inverse=True, **real),
         ot.plan((256, 256, 256), "float32", **real)(x3)),
        ("c2r 512^3 packed (plan)",
         ot.plan((512, 512, 512), "float32", packed=True, inverse=True,
                 **real),
         ot.plan((512, 512, 512), "float32", packed=True, **real)(x5)),
        ("namespace irfftn 256^3", ot.fft.irfftn,
         (torch.fft.rfftn(x3),)))
    for label, fn, args in paths:
        r_reg = time_cuda(fn, args)
        with _dense_core(ff):
            r_dense = time_cuda(fn, args)
        show(f"path {label}, register core", r_reg,
             f", {r_dense['median_ms'] / r_reg['median_ms']:.2f}x faster "
             "than the dense core")
        show(f"path {label}, dense core", r_dense)
        if "local" in label:
            # the unfused real route's device time alone (the host ahead)
            d_reg = time_cuda(fn, args, ahead=True)["median_ms"]
            with _dense_core(ff):
                d_dense = time_cuda(fn, args, ahead=True)["median_ms"]
            print(f"path {label}, device time: register core {d_reg:.4f} "
                  f"ms, dense core {d_dense:.4f} ms "
                  f"({d_dense / d_reg:.2f}x) {tag}", flush=True)
    # the 320^3 path beside its bound (one read and one write of the
    # cube) and the bytes its three passes move (z rows, y, x: each
    # reads and writes the cube), and beside cuFFT
    fn320, args320 = next((f, a) for label, f, a in paths
                          if label.startswith("c2c 320^3"))
    p320 = time_cuda(fn320, args320)["median_ms"]
    f320 = time_cuda(torch.fft.fftn, (torch.complex(*c320),))["median_ms"]
    e320 = 320 ** 3
    b320, _ = roofline_ms(16 * e320, 3 * e320 * fft_flops(320))
    print(f"path c2c 320^3 (plan): {p320:.4f} ms, "
          f"{3 * 16 * e320 / p320 / 1e9:.3f} TB/s over its three passes' "
          f"{3 * 16 * e320} bytes, {b320 / p320:.3f} of its {b320:.4f} ms "
          f"bound; torch.fft.fftn (cuFFT) c64 320^3 {f320:.4f} ms "
          f"({p320 / f320:.2f}x) {tag}", flush=True)
    show("torch.fft.fft2 (cuFFT) c64 64x1024^2",
         time_cuda(torch.fft.fft2, (torch.complex(xr, xi),)))
    # the unfused real route's cubes beside cuFFT (device time alone)
    for n, x in ((192, x192), (320, x320)):
        w = torch.fft.rfftn(x)
        show(f"torch.fft.rfftn (cuFFT) f32 {n}^3, device time",
             time_cuda(torch.fft.rfftn, (x,), ahead=True))
        show(f"torch.fft.irfftn (cuFFT) c64 {n}^3, device time",
             time_cuda(lambda: torch.fft.irfftn(w, s=x.shape), ahead=True))
        del w
    for n, x in ((256, x3), (512, x5)):
        w = torch.fft.rfftn(x)
        show(f"torch.fft.irfftn (cuFFT) c64 {n}^3",
             time_cuda(lambda: torch.fft.irfftn(w, s=x.shape)))
        del w
    # the two slab kernels at 512^3 (zpad 8), each core and the library
    for label, fn, args, lib in (
            ("fft_slab 512^3", ff.fft_slab_yz, c5,
             ("fft2", torch.fft.fft2, torch.complex(*c5))),
            ("rfft_slab 512^3", ff.rfft_slab_yz, (x5,),
             ("rfft2", torch.fft.rfft2, x5))):
        r_reg = time_cuda(lambda: fn(*args, zpad=8), ahead=True)
        with _dense_core(ff):
            r_dense = time_cuda(lambda: fn(*args, zpad=8), ahead=True)
        r_lib = time_cuda(lib[1], lib[2:], ahead=True)
        show(f"kernel {label}, register core", r_reg,
             f", {r_reg['median_ms'] / r_lib['median_ms']:.2f}x the "
             f"library, {r_dense['median_ms'] / r_reg['median_ms']:.2f}x "
             "faster than the dense core")
        show(f"kernel {label}, dense core", r_dense)
        show(f"library {label} (torch.fft.{lib[0]})", r_lib)
        del lib
    del xr, xi, x3, c3, x5, c5, c320, x192, x320, paths
    torch.cuda.empty_cache()
    # the slabs' phase ledgers, the strided pass's lane tiles, the
    # four-step pair's variants and the cube's phases and groups
    # (offt_tpu_torch.bench)
    from offt_tpu_torch.bench import (probe_cube, probe_fourstep,
                                      probe_rslab512, probe_slabparts,
                                      probe_yconcat)
    for probe in (probe_slabparts, probe_rslab512, probe_yconcat,
                  probe_fourstep, probe_cube, pr):
        for row in probe.ledger():
            rate = (f", {row['tb_s']:.3f} TB/s over {row['bytes']} bytes"
                    if row["bytes"] else "")
            print(f"probe {row['probe']} {row['phase']}: {row['ms']:.4f} ms, "
                  f"{row['of_full']:.3f} of full{rate} {tag}", flush=True)
        torch.cuda.empty_cache()
    # the stage product by precision tier (probe_mxuwidth): each variant's
    # rate at the reference's (L, R) cases beside one torch.matmul at its
    # precision (its error on a DFT stage is phase 2's)
    for row in pm.ledger():
        print(f"probe mxuwidth {row['variant']} L={row['L']} R={row['R']} "
              f"B={row['B']}: {row['us_per_call']:.1f} us a call, "
              f"{row['tflops']:.2f} TFLOP/s, {row['of_peak']:.3f} of the "
              f"tier's peak; torch.matmul {row['matmul_us']:.1f} us, "
              f"{row['matmul_tflops']:.2f} TFLOP/s {tag}", flush=True)
    torch.cuda.empty_cache()
    # both row kernels at every register-core length n (fft_last at
    # N = n on 2^24 complex elements, rfft_last at M = n on 2^25 real
    # inputs, numpy layout), on the register core and on the dense core:
    # device time and the bytes each moves over it
    xr, xi = _pair((1 << 24,), gen)
    xx = torch.cat([xr, xi])
    for n in (1 << k for k in range(4, 13)):
        for name, fn, args, nbytes in (
                ("fft_last N", ff.fft_last,
                 (xr.view(-1, n), xi.view(-1, n)), 16 << 24),
                ("rfft_last M", ff.rfft_last_planar, (xx.view(-1, 2 * n),),
                 (4 << 25) + 8 * ((1 << 24) // n) * (n + 1))):
            r_reg = time_cuda(fn, args, ahead=True)
            with _dense_core(ff):
                r_dense = time_cuda(fn, args, ahead=True)
            print(f"sweep {name}={n} rows={args[0].shape[0]}: register "
                  f"{r_reg['median_ms']:.4f} ms "
                  f"({nbytes / r_reg['median_ms'] / 1e9:.2f} TB/s), dense "
                  f"{r_dense['median_ms']:.4f} ms "
                  f"({nbytes / r_dense['median_ms'] / 1e9:.2f} TB/s) {tag}",
                  flush=True)
    # fft_last at every mixed length of its rows (``_MIX_ROW_LENGTHS``),
    # as many whole rows as 2^24 elements hold, each core and the library
    for n in sorted(ff._MIX_ROW_LENGTHS):
        rows = (1 << 24) // n
        args = (xr[:rows * n].view(rows, n), xi[:rows * n].view(rows, n))
        r_reg = time_cuda(ff.fft_last, args, ahead=True)["median_ms"]
        with _dense_core(ff):
            r_dense = time_cuda(ff.fft_last, args, ahead=True)["median_ms"]
        r_lib = time_cuda(torch.fft.fft, (torch.complex(*args), None, -1),
                          ahead=True)["median_ms"]
        nbytes = 16 * rows * n
        print(f"sweep fft_last N={n} rows={rows} (mixed): register "
              f"{r_reg:.4f} ms ({nbytes / r_reg / 1e9:.2f} TB/s), dense "
              f"{r_dense:.4f} ms, fft(dim=-1) {r_lib:.4f} ms "
              f"({r_reg / r_lib:.2f}x) {tag}", flush=True)
    # rfft_last (numpy layout) and icrfft_last at every mixed M of the
    # real rows (``_MIX_ROW_LENGTHS``), as many whole rows as 2^24 real
    # samples hold, each core, the library call and the bound
    for m in sorted(ff._MIX_ROW_LENGTHS):
        rows = (1 << 23) // m
        spec = torch.complex(xr[:rows * (m + 1)].view(rows, m + 1),
                             xi[:rows * (m + 1)].view(rows, m + 1))
        for name, fn, args, lib, shp in (
                ("rfft_last", ff.rfft_last_planar,
                 (xx[:rows * 2 * m].view(rows, 2 * m),), torch.fft.rfft,
                 (rows, 2 * m)),
                ("icrfft_last", ff.icrfft_last_planar,
                 (xr[:rows * m].view(rows, m), xi[:rows * m].view(rows, m)),
                 torch.fft.irfft, (rows, m))):
            r_reg = time_cuda(fn, args, ahead=True)["median_ms"]
            with _dense_core(ff):
                r_dense = time_cuda(fn, args, ahead=True)["median_ms"]
            lib_args = args if name == "rfft_last" else (spec,)
            r_lib = time_cuda(lib, lib_args, ahead=True)["median_ms"]
            bms, _ = kernel_bound(name, shp)
            print(f"sweep {name} M={m} rows={rows} (mixed): register "
                  f"{r_reg:.4f} ms ({bms / r_reg:.3f} of its bound "
                  f"{bms:.4f} ms), dense {r_dense:.4f} ms, "
                  f"{lib.__name__} {r_lib:.4f} ms ({r_reg / r_lib:.2f}x) "
                  f"{tag}", flush=True)
        del spec
    del xr, xi, xx
    # the one-shot call: the first builds its plan, the second reuses it
    xc = torch.complex(*_pair((256, 256, 256), gen))
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        ot.fft3d(xc)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    print(f"time one-shot fft3d 256^3 c64 (host wall, synchronised): first "
          f"call {walls[0]:.4f} ms (builds the plan), second {walls[1]:.4f}, "
          f"third {walls[2]:.4f} ms (the cached plan) {tag}", flush=True)
    del xc
    torch.cuda.empty_cache()

    grad_times(ot, gen, show, show_breakdown, time_cuda)
    torch.cuda.empty_cache()

    report = []
    for name, info in ff.KERNELS.items():
        fn, call = per_kernel[name]["call"]
        shape = per_kernel[name]["shape"]
        x = _pair(shape, gen)
        # device time: the host enqueues ahead (a kernel shorter than its
        # wrapper's host overhead would else be host-paced)
        r_k = time_cuda(call, (fn, x), ahead=True)
        r_p = time_cuda(call, (fn.plain, x), warmup=1, reps=5)
        show(f"kernel {name} via {fn.__name__} {shape}", r_k)
        show(f"plain {name} via {fn.__name__} {shape}", r_p)
        lib = _library(name, shape, gen)
        lib_ms = None
        if lib is not None:
            r_l = time_cuda(*lib[1:], ahead=True)
            lib_ms = r_l["median_ms"]
            show(f"library {name} (torch.fft.{lib[0]}) {shape}", r_l)
        bms, by = kernel_bound(name, shape)
        nbytes = kernel_work(name, shape)[0]
        print(f"bound {name} {shape}: {bms:.4f} ms ({by}); kernel at "
              f"{bms / r_k['median_ms']:.3f} of it, "
              f"{nbytes / r_k['median_ms'] / 1e9:.3f} TB/s {tag}")
        extra = {}
        if name in REG_CORE:
            with _dense_core(ff):
                r_d = time_cuda(call, (fn, x), ahead=True)
            extra["dense_ms"] = r_d["median_ms"]
            show(f"kernel {name} via {fn.__name__} {shape}, dense core", r_d,
                 f", {r_d['median_ms'] / r_k['median_ms']:.2f}x the "
                 "register core")
        for what, (shp, call_m) in MIXED_SHAPES.get(name, {}).items():
            # the kernel at a mixed length (MIXED_SHAPES)
            xm = _pair(shp, gen)
            m_k = time_cuda(call_m, (fn, xm), ahead=True)["median_ms"]
            with _dense_core(ff):
                m_d = time_cuda(call_m, (fn, xm), ahead=True)["median_ms"]
            m_p = time_cuda(call_m, (fn.plain, xm), warmup=1,
                            reps=3)["median_ms"]
            lib_m = _library(name, shp, gen)
            m_l = time_cuda(*lib_m[1:], ahead=True)["median_ms"]
            mb, mby = kernel_bound(name, shp)
            nbytes = kernel_work(name, shp)[0]
            print(f"kernel {name} {shp} ({what}): register core "
                  f"{m_k:.4f} ms ({nbytes / m_k / 1e9:.3f} TB/s, "
                  f"{mb / m_k:.3f} of its "
                  f"bound), dense core {m_d:.4f} ms, plain {m_p:.4f} ms, "
                  f"library {lib_m[0]} {m_l:.4f} ms ({m_k / m_l:.2f}x), "
                  f"bound {mb:.4f} ms ({mby}) {tag}", flush=True)
            extra[what] = {"shape": list(shp), "ms": m_k, "dense_ms": m_d,
                           "plain_ms": m_p, "library_ms": m_l,
                           "bound_ms": mb, "bound_by": mby}
            if name == "fft_slab":
                # its two grids alone: the z rows (fft_last on the
                # slab's rows) and the y lines (the strided-axis kernel)
                z_ms = time_cuda(ff.fft_last, tuple(
                    t.view(-1, shp[-1]) for t in xm), ahead=True)
                y_ms = time_cuda(ff.fft_sublane, (*xm, 1), ahead=True)
                print(f"kernel fft_slab {shp} (mixed), its grids alone: z "
                      f"rows (fft_last) {z_ms['median_ms']:.4f} ms, y lines "
                      f"(fft_sublane axis 1) {y_ms['median_ms']:.4f} ms "
                      f"{tag}", flush=True)
            del xm, lib_m
        if name == "fft_cube":
            extra["shapes"] = cube_rows
        if name == "fft_axis":
            # the kernel's other wrappers and shapes of the main paths, on
            # the register core (its lane tile), the dense core and as the
            # library call: the c2r x pass (z_true 128 of 129 lanes), the
            # 512^3 x pass, the 64 x 1024^2 y pass, a column at 2048 and
            # at 4096, and the mixed lengths: the 320^3 x pass, 192^3's
            # axes 0 and 1, a 768 column
            for what, shp, lanes, ax, call_x in (
                    ("fft_x_to_padded", (256, 256, 129), 128, 0,
                     lambda f, x: f(*x, z_true=128, inverse=True)),
                    ("fft_x_from_padded", (512, 512, 520), 512, 0,
                     lambda f, x: f(*x, 512)),
                    ("fft_sublane", (64, 1024, 1024), 1024, 1,
                     lambda f, x: f(*x, 1)),
                    ("fft_sublane", (4, 2048, 520), 520, 1,
                     lambda f, x: f(*x, 1)),
                    ("fft_sublane", (2, 4096, 520), 520, 1,
                     lambda f, x: f(*x, 1)),
                    ("fft_sublane", (320, 320, 320), 320, 0,
                     lambda f, x: f(*x, 0)),
                    ("fft_sublane", (192, 192, 192), 192, 0,
                     lambda f, x: f(*x, 0)),
                    ("fft_sublane", (192, 192, 192), 192, 1,
                     lambda f, x: f(*x, 1)),
                    ("fft_sublane", (8, 768, 768), 768, 1,
                     lambda f, x: f(*x, 1))):
                fx = getattr(ff, what)
                xt = _pair(shp, gen)
                n = shp[ax]
                e = math.prod(shp[:-1]) * lanes
                r_r = time_cuda(call_x, (fx, xt), ahead=True)["median_ms"]
                with _dense_core(ff):
                    r_d = time_cuda(call_x, (fx, xt), ahead=True)["median_ms"]
                r_p = time_cuda(call_x, (fx.plain, xt), warmup=1, reps=3)
                xc = torch.complex(xt[0][..., :lanes], xt[1][..., :lanes])
                r_l = time_cuda(torch.fft.fft, (xc, None, ax),
                                ahead=True)["median_ms"]
                xb, xby = roofline_ms(16 * e + table_bytes(n),
                                      e * fft_flops(n))
                core = (f"register core ({ff._axis_tile(n)} tile)"
                        if ff._reg_axis(n) else "dense core")
                print(f"kernel fft_axis via {what} {shp} axis {ax}: {core} "
                      f"{r_r:.4f} ms ({16 * e / r_r / 1e9:.3f} TB/s, "
                      f"{xb / r_r:.3f} of its bound), dense core "
                      f"{r_d:.4f} ms, plain {r_p['median_ms']:.4f} ms, "
                      f"library fft(dim={ax}) {r_l:.4f} ms "
                      f"({r_r / r_l:.2f}x), bound {xb:.4f} ms ({xby}) {tag}",
                      flush=True)
                del xt, xc
        if name == "irfft_slab":
            # the register core at 256^3 in clusters and in two grids (the
            # cluster gate patched off); at 512^3 (two grids) and the dense
            # core and irfft2
            for p, y, m in ((256, 256, 128), (512, 512, 256)):
                xt = _pair((p, y, m + 8), gen)
                side = _pair((p, y), gen)

                def c2r(fn=fn, xt=xt, side=side, p=p, y=y, m=m):
                    return fn(*xt, 2 * m, scale=1 / (p * y * m),
                              side_r=side[0], side_i=side[1])
                r_r = time_cuda(c2r, ahead=True)["median_ms"]
                xb, xby = kernel_bound("irfft_slab", (p, y, m + 8))
                if ff._cluster_irslab(y, m):
                    keep = ff._cluster_irslab
                    ff._cluster_irslab = lambda ny, nm: False
                    try:
                        r_g = time_cuda(c2r, ahead=True)["median_ms"]
                    finally:
                        ff._cluster_irslab = keep
                    more = f"(clusters) {r_r:.4f} ms, two grids {r_g:.4f} ms"
                else:
                    with _dense_core(ff):
                        r_d = time_cuda(c2r, ahead=True)["median_ms"]
                    w = torch.fft.rfft2(torch.randn(
                        (p, y, 2 * m), generator=gen, device="cuda"))
                    r_l = time_cuda(lambda: torch.fft.irfft2(w, (y, 2 * m)),
                                    ahead=True)["median_ms"]
                    more = (f"(two grids) {r_r:.4f} ms, dense core "
                            f"{r_d:.4f} ms, library irfft2 {r_l:.4f} ms "
                            f"({r_r / r_l:.2f}x)")
                    del w
                print(f"kernel irfft_slab {(p, y, m + 8)}, side plane: "
                      f"register core {more} ({xb / r_r:.3f} of its bound), "
                      f"bound {xb:.4f} ms ({xby}) {tag}", flush=True)
                del xt, side
        report.append({"name": name, "route": "cuda",
                       "source": info["source"],
                       "replaces": info["replaces"],
                       "launches": launches[name],
                       "max_abs_err": per_kernel[name]["max_abs_err"],
                       "ms": r_k["median_ms"], "plain_ms": r_p["median_ms"],
                       "bound_ms": bms, "bound_by": by,
                       "library_ms": lib_ms, **extra})
        del x, lib
    # the probes: probe_mma at every variant, one iteration (R = 1) of
    # (SMs, 128, 1024) operands, beside its plain version and one
    # torch.matmul of the same product at its precision; the r2c slab's
    # wider-tile codes at 512^3 beside the plain version and rfft2
    for v in pm.VARIANTS:
        shape = (sms, 1024, 1)
        x, g = pm.inputs(v, sms, 1024, "cuda")
        r_k = time_cuda(pm.probe_mma, (x, g, 1, v), ahead=True)
        r_p = time_cuda(pm.probe_mma.plain, (x, g, 1, v), warmup=1, reps=5)
        call, _ = pm._matmul_call(v, sms, 1024, gen)
        r_l = time_cuda(call, ahead=True)
        bms, by = kernel_bound(f"probe_mma:{pm.tier(v)}", shape)
        show(f"kernel probe_mma:{v} (B, L, R) {shape}", r_k,
             f", {bms / r_k['median_ms']:.3f} of its bound")
        show(f"plain probe_mma:{v} {shape}", r_p)
        show(f"library torch.matmul at the {pm.tier(v)} tier's precision "
             f"{shape}", r_l)
        report.append({"name": f"probe_mma:{v}", "route": "cuda",
                       "source": "offt_tpu_torch/kernels/csrc/probe_mma.cu",
                       "replaces": "docs/receipts/probe_mxuwidth.py:50",
                       "launches": mma_launches[v],
                       "max_abs_err": probe_errs[f"probe_mma:{v}"],
                       "tol": TOL_MMA[v], "shape": list(shape),
                       "ms": r_k["median_ms"], "plain_ms": r_p["median_ms"],
                       "bound_ms": bms, "bound_by": by,
                       "library_ms": r_l["median_ms"]})
        del x, g, call
    x = pr._input()
    r_p = time_cuda(lambda: ff.rfft_slab_yz.plain(x, zpad=pr.ZPAD),
                    warmup=1, reps=3)
    r_l = time_cuda(torch.fft.rfft2, (x,), ahead=True)
    bms, by = kernel_bound("rfft_slab", tuple(x.shape))
    for code in pr.CODES:
        r_k = time_cuda(lambda code=code: ff.rfft_slab_yz(
            x, zpad=pr.ZPAD, phases=code), ahead=True)
        show(f"kernel rfft_slab phases={code} {tuple(x.shape)}", r_k,
             f", {bms / r_k['median_ms']:.3f} of its bound")
        reading = probe_runs[f"ryconcat:{code}"]
        report.append({"name": f"rfft_slab:{code}", "route": "cuda",
                       "source": "offt_tpu_torch/kernels/csrc/rfft_slab.cu",
                       "replaces": "docs/receipts/probe_ryconcat.py:50",
                       "launches": reading[1]["rfft_slab"],
                       "max_abs_err": probe_errs[f"rfft_slab:{code}"],
                       "tol": TOL_KERNEL, "shape": list(x.shape),
                       "ms": r_k["median_ms"], "plain_ms": r_p["median_ms"],
                       "bound_ms": bms, "bound_by": by,
                       "library_ms": r_l["median_ms"]})
    show(f"plain rfft_slab {tuple(x.shape)}", r_p)
    show(f"library rfft_slab (torch.fft.rfft2) {tuple(x.shape)}", r_l)
    del x
    # the pair computes what one fft of the whole transform computes
    rows = {r["name"]: r for r in report}
    pair_ms = rows["step1_twiddle"]["ms"] + rows["step3_transposed"]["ms"]
    for name in ("step1_twiddle", "step3_transposed"):
        rows[name]["pair_library_factor"] = pair_ms / rows[name]["library_ms"]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": report}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _run() -> int:
    try:
        return main()
    finally:
        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    sys.exit(_run())
