"""Phase ledger of the register-core r2c slab kernel (``csrc/rfft_slab.cu``)
at 512^3 on the card: the H100 counterpart of the reference's v5e probe
``docs/receipts/probe_rslab512.py``.

Every phase is one call of ``fused_fft.rfft_slab_yz`` on the same real
(512, 512, 512) input with zpad 8, the main path's call (Y = 512,
M = 256). The kernel holds each x-row's 512 x 256 packed slab (1 MB) in
the shared memory of a cluster of 16 blocks (``ClusterSlab``): the r2c
rows (float2 pairs, the M-point core, the untangle) into the slab, then
the y lines out of it.

- full: the kernel; it reads the input and writes the output once;
- noy: the y transform compiled out (the z rows, moved through the slab);
- nount: the untangle compiled out (V itself goes on to y);
- copy: the transforms and the untangle compiled out: the layout's
  traffic alone;
- grids: the two-grid layout (the r2c rows to the output, then the y
  lines in place on it);
- dense: the dense-core kernel on the same call (``_reg_rslab`` off);
- rfft2: ``torch.fft.rfft2`` of the same input.

The reference's ``nodual`` skipped its second half-length transform, the
TPU's way to untangle without a reversal; here one O(M) untangle reads
V[M - k] from shared memory, so it has no counterpart.

    python -m offt_tpu_torch.bench.probe_rslab512   # one JSON line a phase
"""

from __future__ import annotations

import json

import torch

from . import phase_rows

N = 512
ZPAD = 8


def ledger(seed: int = 0) -> list[dict]:
    from ..kernels import fused_fft as ff
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = torch.randn((N,) * 3, generator=gen, device="cuda")
    e = N * N * (N // 2)          # output lanes; 8 bytes a pass each way

    def slab(phases="full"):
        return lambda: ff.rfft_slab_yz(x, zpad=ZPAD, phases=phases)

    def dense():
        keep = ff._reg_rslab
        ff._reg_rslab = lambda ny, m: False
        try:
            return ff.rfft_slab_yz(x, zpad=ZPAD)
        finally:
            ff._reg_rslab = keep

    return phase_rows("rslab512", [
        ("full", slab(), 16 * e), ("noy", slab("noy"), 16 * e),
        ("nount", slab("nount"), 16 * e), ("copy", slab("copy"), 16 * e),
        ("grids", slab("grids"), 32 * e), ("dense", dense, 32 * e),
        ("rfft2", lambda: torch.fft.rfft2(x), None)])


if __name__ == "__main__":
    for row in ledger():
        print(json.dumps(row))
