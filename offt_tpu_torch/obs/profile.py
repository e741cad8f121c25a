"""Device timing of one call: warm-up, then repeated CUDA-event timings;
and where a call's device time goes, by ``torch.profiler``.

Port of the timing part of ``offt_tpu/obs/profile.py``. Each repetition
is bracketed by its own pair of CUDA events on the current stream, so the
result is device time per call, not host enqueue time; a call shorter
than its own host overhead is paced by the host unless the timing runs
the host ahead (``ahead=True``). A measurement needs a CUDA device:
there is no CPU fallback.
"""

from __future__ import annotations

import statistics
import time
from typing import Callable

import torch


# cycles the card spins per timed call while the host runs ahead: 200 us
# of host time a call at 2 GHz
AHEAD_CYCLES = 400_000


def time_cuda(fn: Callable, args: tuple = (), warmup: int = 3,
              reps: int = 20, ahead: bool = False) -> dict:
    """Milliseconds per ``fn(*args)`` on the card: median, min, max and
    spread ((max - min) / median) over ``reps`` event-timed calls. With
    ``ahead=True`` the card first spins (``torch.cuda._sleep``) while the
    host enqueues every timed call, so each call's events bracket its
    device work alone: a kernel's time, even one shorter than its
    wrapper's host overhead."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    if ahead:
        torch.cuda._sleep(AHEAD_CYCLES * reps)
    for start, end in events:
        start.record()
        fn(*args)
        end.record()
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in events)
    med = statistics.median(ms)
    return {"median_ms": med, "min_ms": ms[0], "max_ms": ms[-1],
            "spread": (ms[-1] - ms[0]) / med if med else 0.0, "reps": reps}


def device_breakdown(fn: Callable, args: tuple = (), warmup: int = 3,
                     reps: int = 10, top: int = 6) -> dict:
    """Where ``reps`` back-to-back calls of ``fn(*args)`` spend the card's
    time, by ``torch.profiler`` (CUDA activity): the host wall per call
    (ms, synchronised at the end), the device time per call summed over
    every kernel and copy, their ratio (the busy share; the rest is the
    card idle between launches), and the ``top`` device ops by time per
    call, as (name, ms, launches per call)."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_breakdown needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(*args)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    ops = [(e.key, e.self_device_time_total / 1e3 / reps, e.count / reps)
           for e in prof.key_averages() if e.self_device_time_total > 0]
    ops.sort(key=lambda o: -o[1])
    busy = sum(o[1] for o in ops)
    return {"wall_ms": wall, "device_ms": busy,
            "busy_share": busy / wall if wall else 0.0, "top": ops[:top]}
