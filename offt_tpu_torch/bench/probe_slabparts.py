"""Phase ledger of the register-core c2c slab kernel (``csrc/fft_slab.cu``)
at 256^3 on the card: the H100 counterpart of the reference's v5e probe
``docs/receipts/probe_slabparts.py``.

Every phase is one call of ``fused_fft.fft_slab_yz`` on the same
(256, 256, 256) planar pair with zpad 8, the main path's call. The
kernel holds each x-row's slab in the shared memory of a cluster of 8
blocks (``ClusterSlab``): the z rows from device memory into the slab,
then the y lines out of it.

- full: the kernel; it reads and writes the slab once;
- zonly, yonly: the cluster with the y, or the z, transform compiled
  out; copy: with both out (the layout's traffic alone);
- grids: the two-grid layout (z rows to the output, then the y lines in
  place on it: the slab read and written twice);
- fused: one block per x-row running its z rows and then its y lines
  read back from the output (read and written twice, one grid);
- dense: the dense-core kernel on the same call (``_reg_slab`` off);
- fft2: ``torch.fft.fft2`` of the same data as complex64.

The reference's ``tpose`` (the z stage's relayout on the TPU) and
``ybatch`` (the y stage as one lane-concatenated MXU product) measured a
TPU's relayouts and matrix width; the CUDA kernel has neither, so they
have no counterpart here.

    python -m offt_tpu_torch.bench.probe_slabparts   # one JSON line a phase
"""

from __future__ import annotations

import json

import torch

from . import phase_rows

N = 256
ZPAD = 8


def ledger(seed: int = 0) -> list[dict]:
    from ..kernels import fused_fft as ff
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    x = tuple(torch.randn((N,) * 3, generator=gen, device="cuda")
              for _ in range(2))
    xc = torch.complex(*x)
    e = N ** 3                    # complex elements; 8 bytes a pass each way

    def slab(phases="full"):
        return lambda: ff.fft_slab_yz(*x, zpad=ZPAD, phases=phases)

    def dense():
        keep = ff._reg_slab
        ff._reg_slab = lambda ny, nz: False
        try:
            return ff.fft_slab_yz(*x, zpad=ZPAD)
        finally:
            ff._reg_slab = keep

    return phase_rows("slabparts", [
        ("full", slab(), 16 * e), ("zonly", slab("zonly"), 16 * e),
        ("yonly", slab("yonly"), 16 * e), ("copy", slab("copy"), 16 * e),
        ("grids", slab("grids"), 32 * e), ("fused", slab("fused"), 32 * e),
        ("dense", dense, 32 * e),
        ("fft2", lambda: torch.fft.fft2(xc), None)])


if __name__ == "__main__":
    for row in ledger():
        print(json.dumps(row))
