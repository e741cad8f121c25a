"""Probes of the port's kernels on the card.

``probe_slabparts`` and ``probe_rslab512`` are the H100 phase ledgers of
the two register-core slab kernels, the counterparts of the reference's
v5e probes ``docs/receipts/probe_slabparts.py`` and
``probe_rslab512.py``. Each times the kernel's cost probes (the
``phases`` argument of ``fused_fft.fft_slab_yz`` / ``rfft_slab_yz``)
beside the full kernel, the dense core and the library call, and needs a
CUDA device. ``probe_yconcat`` (after ``docs/receipts/probe_yconcat.py``)
times the narrow lane tile of the strided-axis kernel's register core
(the ``tile`` argument of ``fused_fft.fft_sublane``) against the routed
one at N = 256 and 1024. ``ptxas_spills`` prints each kernel's registers
and spills as ptxas reports them (needs nvcc, not a card).
"""

from __future__ import annotations


def phase_rows(probe: str, phases) -> list[dict]:
    """One row per (phase, fn, bytes) of ``phases``: the median device
    time of ``fn()`` by CUDA events with the host enqueueing ahead, the
    bytes its grids address in device memory (data loads and stores, as
    designed; None where unknown), their rate and the share of the first
    phase's time."""
    from ..obs.profile import time_cuda
    rows = []
    for name, fn, nbytes in phases:
        ms = time_cuda(fn, ahead=True)["median_ms"]
        rows.append({"probe": probe, "phase": name, "ms": ms,
                     "bytes": nbytes,
                     "tb_s": nbytes / ms / 1e9 if nbytes else None})
    for r in rows:
        r["of_full"] = r["ms"] / rows[0]["ms"]
    return rows
