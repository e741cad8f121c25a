"""The four-step pair's register-core variants on the card.

Step 1 (``fourstep._step1_twiddle``) runs the column variant, whose lane
tile sets how many blocks a grid has and how long a warp's runs are; step
3 (``fourstep._step3_transposed``) runs the row core with a transposing
store, whose rows a block set the runs of its stores. Every row is one
call at the long 1-D splits of the main path, (B, n1, n2) = (1, 1024,
1024) (2^20), (8, 1024, 1024), (1, 2048, 2048) (2^22) and (1, 4096,
4096) (2^24), and at two with a mixed side, (1, 1536, 2048) (3 * 2^20:
step 1 on ``csrc/fourstep_mix.cu``) and (1, 2048, 2560) (5 * 2^20: step
3 there): step 1 on the routed tile (``fourstep._step1_tile``), on
the other tile the kernel has at n1 (``tile``: wide, or half at 512 and
1024) and on the dense core (``fused_fft._reg_core`` off), and its
transform without the twiddle (``fused_fft.fft_sublane`` on axis 1);
step 3 on its layout (``fourstep._step3_layout``: R rows a run, held by
C blocks) and on the dense core, its transform stored in place
(``fused_fft.fft_last``) and its transpose alone (torch); then the pair
as the route runs it and the library call that computes the pair's
function, ``torch.fft.fft`` of the whole transform. Then step 1's wide
and half tiles at n1 = 1024 and 512 across the wide grid's block counts
between those of the splits (``TILES``: 128 at 3g's inner 2^21, (1,
1024, 2048)), which set where ``_step1_tile`` switches.

Bytes: one read and one write of the planar pair (16 a complex element);
step 1 also reads the 8-byte twiddle once.

    python -m offt_tpu_torch.bench.probe_fourstep   # one JSON line a row
"""

from __future__ import annotations

import contextlib
import json

import torch

from . import phase_rows

SHAPES = ((1, 1024, 1024), (8, 1024, 1024), (1, 2048, 2048),
          (1, 4096, 4096), (1, 1536, 2048), (1, 2048, 2560))
# (B, n1, n2) of step 1's tile rows: 96, 128, 192, 256, 384 wide blocks
# at n1 = 1024; 64, 128, 256, 512 at 512
TILES = ((3, 1024, 512), (1, 1024, 2048), (3, 1024, 1024), (4, 1024, 1024),
         (6, 1024, 1024), (1, 512, 2048), (2, 512, 2048), (4, 512, 2048),
         (8, 512, 2048))


def ledger(seed: int = 0, shapes=SHAPES, tiles=TILES) -> list[dict]:
    from ..kernels import fourstep as fs
    from ..kernels import fused_fft as ff
    from ..kernels import regcore as rc

    @contextlib.contextmanager
    def dense():
        keep = ff._reg_core
        ff._reg_core = lambda n: False
        try:
            yield
        finally:
            ff._reg_core = keep

    def on_dense(fn):
        def run():
            with dense():
                return fn()
        return run

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    sms = fs._sms(torch.device("cuda"))
    rows = []

    def data(b, n1, n2):
        return tuple(torch.randn((b, n1, n2), generator=gen, device="cuda")
                     for _ in range(2))

    def step1(x, n1, n2, tile=None):
        return lambda: fs._step1_twiddle(*x, n1, n2, None, False, tile=tile)

    for b, n1, n2 in shapes:
        x = data(b, n1, n2)
        e = b * n1 * n2
        b1, b3 = 16 * e + 8 * n1 * n2, 16 * e

        def step3(x=x, n1=n1, n2=n2):
            return fs._step3_transposed(*x, n1, n2, None, False)

        def pair(x=x, n1=n1, n2=n2):
            z = fs._step1_twiddle(*x, n1, n2, None, False)
            return fs._step3_transposed(*z, n1, n2, None, False)

        routed = fs._step1_tile(n1, n2, b, sms)
        phases = [(f"step1 routed ({routed})", step1(x, n1, n2), b1)]
        for tile in ("wide", "half"):
            if tile != routed and (tile == "wide" or n1 in (512, 1024)):
                phases.append((f"step1 {tile}", step1(x, n1, n2, tile), b1))
        phases.append(("step1 dense", on_dense(step1(x, n1, n2)), b1))
        phases.append(("step1's transform alone (fft_sublane, axis 1)",
                       lambda x=x: ff.fft_sublane(*x, 1), b3))
        phases.append((f"step3 (R, C) = {fs._step3_layout(n2)}", step3,
                       b3))
        phases.append(("step3 dense", on_dense(step3), b3))
        phases.append(("step3's transform alone (fft_last, rows in place)",
                       lambda x=x: ff.fft_last(*x), b3))
        phases.append(("step3's transpose alone (torch, both planes)",
                       lambda x=x: [v.transpose(1, 2).contiguous()
                                    for v in x], b3))
        phases.append(("pair", pair, b1 + b3))
        xc = torch.complex(*x).reshape(b, n1 * n2)
        phases.append(("fft (the pair's function)",
                       lambda xc=xc: torch.fft.fft(xc), None))
        rows += phase_rows(f"fourstep {(b, n1, n2)}", phases)
        del x, xc
        torch.cuda.empty_cache()
    for b, n1, n2 in tiles:
        x = data(b, n1, n2)
        nbytes = 16 * b * n1 * n2 + 8 * n1 * n2
        blocks = rc.step1_tile(n1, n2, b, "wide")["blocks"]
        rows += phase_rows(
            f"step1 tiles {(b, n1, n2)}, {blocks} wide blocks on {sms} SMs, "
            f"routed {fs._step1_tile(n1, n2, b, sms)}",
            [(tile, step1(x, n1, n2, tile), nbytes)
             for tile in ("wide", "half")])
        del x
    torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    for row in ledger():
        print(json.dumps(row))
