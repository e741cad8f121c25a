"""The port's benchmark drivers, roofline and probes of its kernels.

``runfft`` is the run-fft driver (``offt-torch-bench``; port of
``offt_tpu/bench/runfft.py``), ``baseline_suite`` runs BASELINE.json's
five configurations, and ``roofline`` holds the H100's published peaks
(``CHIPS``, ``ChipSpec``), the 3-D transform's bound (``Roofline``,
``fft3d_roofline``, the reference's public names) and the one count of
each kernel's bytes and operations (``kernel_work``, ``kernel_bound``).

``probe_slabparts`` and ``probe_rslab512`` are the H100 phase ledgers of
the two register-core slab kernels, the counterparts of the reference's
v5e probes ``docs/receipts/probe_slabparts.py`` and
``probe_rslab512.py``. Each times the kernel's cost probes (the
``phases`` argument of ``fused_fft.fft_slab_yz`` / ``rfft_slab_yz``)
beside the full kernel, the dense core and the library call, and needs a
CUDA device. ``probe_yconcat`` (after ``docs/receipts/probe_yconcat.py``)
times the narrow lane tile of the strided-axis kernel's register core
(the ``tile`` argument of ``fused_fft.fft_sublane``) against the routed
one at N = 256 and 1024. ``probe_fourstep`` times the four-step pair's
lane tiles (``tile`` of ``fourstep._step1_twiddle``) and layout against
the dense core and ``torch.fft.fft`` at the long 1-D splits, and step
1's two tiles across grid sizes. ``probe_cube`` times the register
cube's phases (``phases`` of ``fused_fft.fft3d_cube``) and its groups
(``fused_fft._cube_group`` patched) beside the dense kernel,
``fft3d_planar`` and ``torch.fft.fftn``. ``ptxas_spills`` prints each
kernel's registers and spills as ptxas reports them (needs nvcc, not a
card). ``call_overhead`` times the host wall of the forward calls that
the host paces, with and without the autograd Function, against another
checkout's (``--root``). ``mesh4`` runs the distributed engines over
NCCL on four cards of one host: the long-1-D engine on a 2 x 2 mesh
against ``torch.fft`` and one card's plan, stage by stage, and the
pencil breakdown. ``probe_mxuwidth`` (after
``docs/receipts/probe_mxuwidth.py``) times the stage product by
precision tier on its own kernel (``csrc/probe_mma.cu``) and
``probe_ryconcat`` (after ``docs/receipts/probe_ryconcat.py``) the r2c
slab's y pass on wider lane tiles (``phases`` of
``fused_fft.rfft_slab_yz``).
"""

from __future__ import annotations

from .roofline import CHIPS, ChipSpec, Roofline, fft3d_roofline

__all__ = ["CHIPS", "ChipSpec", "Roofline", "fft3d_roofline", "phase_rows"]


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
