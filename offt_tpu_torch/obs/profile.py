"""Device timing of one call: warm-up, then repeated CUDA-event timings.

Port of the timing part of ``offt_tpu/obs/profile.py``. Each repetition
is bracketed by its own pair of CUDA events on the current stream, so the
result is device time per call, not host enqueue time. A measurement
needs a CUDA device: there is no CPU fallback.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch


def time_cuda(fn: Callable, args: tuple = (), warmup: int = 3,
              reps: int = 20) -> dict:
    """Milliseconds per ``fn(*args)`` on the card: median, min, max and
    spread ((max - min) / median) over ``reps`` event-timed calls."""
    if not torch.cuda.is_available():
        raise RuntimeError("time_cuda needs a CUDA device")
    for _ in range(warmup):
        fn(*args)
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        start.record()
        fn(*args)
        end.record()
    torch.cuda.synchronize()
    ms = sorted(s.elapsed_time(e) for s, e in events)
    med = statistics.median(ms)
    return {"median_ms": med, "min_ms": ms[0], "max_ms": ms[-1],
            "spread": (ms[-1] - ms[0]) / med if med else 0.0, "reps": reps}
