"""The r2c slab's y pass on wider lane tiles at 512^3: the H100
counterpart of the reference's v5e probe ``docs/receipts/probe_ryconcat.py``.

The TPU probe fed the r2c slab's y stage, which ran per x-row on
M = 256 lanes, as one lane-concatenated (Y, tb M) call of the core, to
reach the MXU's wider tiles. On the H100 the concatenation has no point
(a row's 256 lanes already exceed any block's lane tile); what carries
over is the width of the y pass's lane tile. The register slab
(``csrc/rfft_slab.cu``) reads, in its cluster layout (``ClusterSlab<9,
8>``: 16 blocks of 256 threads, 16 lanes each), 8 lanes a wavefront,
so its y reads from the slab take two wavefronts; the two-grid layout's
y grid reads 8 lanes a block of 256 threads.

Every row is one call of ``fused_fft.rfft_slab_yz`` on the same real
(512, 512, 512) input with zpad 8 (Y = 512, M = 256), or the library's:

- full: the kernel as the routes launch it (clusters of 16);
- y16, y32: the cluster layout in blocks of 512 and 1024 threads, the y
  pass on 16 and 32 lanes a block (one wavefront a read; at 32 the ranks
  8-15 run no y lanes);
- grids: the two-grid layout (the r2c rows to the output, then the y
  lines in place, 8 lanes a block);
- grids_wide: the same with the y grid on the wide tile (32 lanes);
- dense: the dense-core kernel (``_reg_rslab`` off);
- rfft2: ``torch.fft.rfft2`` of the same input.

The codes other than full are cost probes (``phases=``): no main path sets
them, and the plain version refuses them. Each writes what full writes
(:func:`check`). Bytes: the input read and the output written once (16
an output lane), twice that for the two-grid layouts and the dense core,
which go through the output between their passes.

    python -m offt_tpu_torch.bench.probe_ryconcat   # one JSON line a row
"""

from __future__ import annotations

import json

import torch

from . import phase_rows

N = 512
ZPAD = 8
CODES = ("y16", "y32", "grids_wide")


def _input():
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return torch.randn((N,) * 3, generator=gen, device="cuda")


def check() -> dict:
    """{code: (max |code - full| / max |full|, max |code - full|)} over the
    M output lanes, on the card."""
    from ..kernels import fused_fft as ff
    x = _input()
    m = x.shape[-1] // 2
    full = ff.rfft_slab_yz(x, zpad=ZPAD)
    top = max(f[..., :m].abs().max().item() for f in full)
    out = {}
    for code in CODES:
        got = ff.rfft_slab_yz(x, zpad=ZPAD, phases=code)
        d = max((g[..., :m] - f[..., :m]).abs().max().item()
                for g, f in zip(got, full))
        out[code] = (d / top, d)
        del got
    return out


def interior_error(x, out) -> float:
    """||out - want|| / ||want|| over the interior bins k = 1 .. M - 1 of
    an r2c slab's packed output ``out`` (a planar pair, lanes past M
    ignored): want = fft along y of rfft along z of ``x``, as the
    reference probe checks (bin 0 packs X[0] + i X[M])."""
    m = x.shape[-1] // 2
    xd = x.double()
    want = torch.fft.fft(torch.fft.rfft(xd, dim=-1), dim=-2)[..., 1:m]
    got = torch.complex(out[0][..., 1:m].double(), out[1][..., 1:m].double())
    return (torch.linalg.vector_norm(got - want)
            / torch.linalg.vector_norm(want)).item()


def ledger() -> list[dict]:
    from ..kernels import fused_fft as ff
    x = _input()
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

    return phase_rows("ryconcat", [
        ("full", slab(), 16 * e), ("y16", slab("y16"), 16 * e),
        ("y32", slab("y32"), 16 * e), ("grids", slab("grids"), 32 * e),
        ("grids_wide", slab("grids_wide"), 32 * e), ("dense", dense, 32 * e),
        ("rfft2", lambda: torch.fft.rfft2(x), None)])


if __name__ == "__main__":
    print(json.dumps({"check": check()}))
    for row in ledger():
        print(json.dumps(row))
