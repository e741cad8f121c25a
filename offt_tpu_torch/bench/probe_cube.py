"""The register cube's phases and groups on the card.

The register cube (``fused_fft.fft3d_cube`` where ``fused_fft._reg_cube``
holds, ``csrc/fft_cube_regs.cu``) runs each group of G cubes through z
(or step 1 and step 3 of the four-step pair past z = 4096), y and x in
one cooperative grid, its phases parted by grid-wide barriers. Every row
is one call: the whole kernel, then its cost probes (``phases``: each
group stops after step 1 of the split z, after z, or after z and y, with
their barriers), so that the difference of two rows is one phase and its
barrier; then G from one cube a group to the whole batch
(``fused_fft._cube_group`` patched), which sets the barriers and how
much of the L2 a phase's work buffer fills; then the dense kernel
(``fused_fft._reg_cube`` off), ``fused_fft.fft3d_planar`` (the slab and
the x pass, two grids through device memory) and ``torch.fft.fftn``, on
the same data.

Bytes: one read of the input and one write of the output (16 a complex
element), what the cube must move to device memory; its later phases
read the work buffer back from L2.

    python -m offt_tpu_torch.bench.probe_cube   # one JSON line a row
"""

from __future__ import annotations

import contextlib
import json

import torch

from . import phase_rows

# (shape, kwargs, the G to sweep): 8 x 128^3 (16 MiB of work a cube: the
# budget's G is 1), one cube of 8 x 8 x 32768 (the split z), 64 cubes of
# 32 x 32 x 128 (1 MiB: G = 16)
SHAPES = (((8, 128, 128, 128), {}, (2, 4, 8)),
          ((8, 8, 32768), {"rad_z": (32, 32, 32)}, ()),
          ((64, 32, 32, 128), {}, (1, 4, 25, 64)))


def ledger(seed: int = 0, shapes=SHAPES) -> list[dict]:
    from ..kernels import fused_fft as ff

    @contextlib.contextmanager
    def patched(name, value):
        keep = getattr(ff, name)
        setattr(ff, name, lambda *n: value)
        try:
            yield
        finally:
            setattr(ff, name, keep)

    def cube(x, kw, **more):
        return lambda: ff.fft3d_cube(*x, **kw, **more)

    def under(name, value, fn):
        def run():
            with patched(name, value):
                return fn()
        return run

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    rows = []
    for shape, kw, groups in shapes:
        x = tuple(torch.randn(shape, generator=gen, device="cuda")
                  for _ in range(2))
        nbytes = 16 * x[0].numel()
        b = x[0].numel() // (shape[-3] * shape[-2] * shape[-1])
        cube(x, kw)()
        last = ff.fft3d_cube.last
        split = last["split"] is not None
        names = ((("z1", "step1"), ("z1, z2", "z"), ("z1, z2, y", "zy"))
                 if split else (("z", "z"), ("z, y", "zy")))
        phases = [(f"full (G {last['group']}, {last['barriers']} barriers, "
                   f"grid {last['grid']}, {last['per_sm']} an SM)",
                   cube(x, kw), nbytes)]
        for label, name in names:
            phases.append((f"phases {label}", cube(x, kw, phases=name),
                           nbytes))
        for g in groups:
            phases.append((f"G {g} ({ff._cube_barriers(b, g, split)} "
                           "barriers)", under("_cube_group", g, cube(x, kw)),
                           nbytes))
        phases.append(("dense kernel",
                       under("_reg_cube", False, cube(x, kw)), nbytes))
        phases.append(("fft3d_planar (slab + x pass)",
                       lambda x=x: ff.fft3d_planar(*x, **kw), 2 * nbytes))
        xc = torch.complex(*x)
        phases.append(("fftn (the cube's function)",
                       lambda xc=xc: torch.fft.fftn(xc, dim=(-3, -2, -1)),
                       None))
        rows += phase_rows(f"cube {shape}", phases)
        del x, xc
        torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    for row in ledger():
        print(json.dumps(row))
