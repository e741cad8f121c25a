"""The strided pass's lane tile on the card: the H100 counterpart of the
reference's v5e probe ``docs/receipts/probe_yconcat.py``.

The TPU probe asked whether the c2c slab's y stage ran faster per x-row or
as one wide lane tile (the rows' lanes concatenated into one matrix
product). On the H100 the strided pass runs on the register core's column
variant (``csrc/fft_axis.cu``), and the question is how many consecutive
lanes a warp moves in device memory: the slabs' y-pass layout gives a
block of 256 threads L = 256 / P lanes (P = N / 16 threads a line), so
16 lanes at N = 256 but 4 at N = 1024, half a 32-byte sector.

Every row is one call of ``fused_fft.fft_sublane`` (its ``tile``, a key
of ``fused_fft._AXIS_TILES``, or the tile the routes launch), at
N = 256, the x pass of 256^3 (axis 0 of (256, 256, 256)), and N = 1024,
the y pass of 64 x 1024^2 (axis 1 of (64, 1024, 1024)): narrow (the
slabs' 256 / P lanes a block: 16 lanes at 256, 4 at 1024) against the
routed tile (``fused_fft._axis_tile``: wide, 32 lines a block up to 1024
threads, 32 lanes at 256, 16 at 1024); at each, dense (the dense core,
``_reg_axis`` off) and the library call ``torch.fft.fft`` along the axis,
as complex64.

Bytes: one read and one write of the planar pair, 16 a complex element.

    python -m offt_tpu_torch.bench.probe_yconcat   # one JSON line a row
"""

from __future__ import annotations

import json

import torch

from . import phase_rows

CASES = (
    # (N, shape, axis)
    (256, (256, 256, 256), 0),
    (1024, (64, 1024, 1024), 1),
)


def ledger(seed: int = 0) -> list[dict]:
    from ..kernels import fused_fft as ff
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rows = []
    for n, shape, axis in CASES:
        x = tuple(torch.randn(shape, generator=gen, device="cuda")
                  for _ in range(2))
        nbytes = 16 * x[0].numel()

        def run(tile=None, x=x, axis=axis):
            return lambda: ff.fft_sublane(*x, axis, tile=tile)

        def dense(x=x, axis=axis):
            keep = ff._reg_axis
            ff._reg_axis = lambda n: False
            try:
                return ff.fft_sublane(*x, axis)
            finally:
                ff._reg_axis = keep

        xc = torch.complex(*x)
        rows += phase_rows(f"yconcat N={n}", [
            ("narrow", run("narrow"), nbytes),
            (f"routed ({ff._axis_tile(n)})", run(), nbytes),
            ("dense", dense, nbytes),
            (f"fft(dim={axis})",
             lambda xc=xc, axis=axis: torch.fft.fft(xc, dim=axis), None)])
        del x, xc
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    for row in ledger():
        print(json.dumps(row))
