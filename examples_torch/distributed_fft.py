"""A distributed pencil FFT on a (p1, p2) mesh: forward and round trip.

The port of examples/distributed_fft.py. Every rank makes the same
global complex input from a seed, passes its block (``input_block``) to
a c2c plan on the mesh with the reference example's knobs
(t1 = t2 = 2 chunks a phase, ry = 5; and ``use_pallas=1``, which the
reference's explicit params leave at 0, the unfused engine: here every
pass runs the port's kernels), and holds its output block
(``output_block``, the transposed-out layout) against complex128
``torch.fft.fftn``; the inverse plan brings the block back.

Run under torchrun, one rank a card (NCCL) or a CPU process (gloo);
alone, it is a world of one:

    torchrun --nproc_per_node 4 examples_torch/distributed_fft.py --device cpu
    python examples_torch/distributed_fft.py --n 256         (one card)
"""

from __future__ import annotations

import torch

from _common import device, grid, norm2, parser, say, total, world

TOL = 1e-5


def global_input(n: int, dev, seed: int = 0) -> torch.Tensor:
    """The same complex64 n^3 field on every rank, from ``seed``."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    re, im = (torch.randn((n,) * 3, generator=gen, device=dev)
              for _ in range(2))
    return torch.complex(re, im)


def plans(n: int, mesh, dev):
    import offt_tpu_torch as ot
    from offt_tpu_torch.dist import mesh as meshlib
    from offt_tpu_torch.plan.params import PlanParams

    p1, _ = meshlib.mesh_shape(mesh)
    params = PlanParams(p1=p1, t1=2, t2=2, ry=5, use_pallas=1)
    fwd = ot.plan((n,) * 3, "complex64", mesh=mesh, params=params,
                  device=dev)
    inv = ot.plan((n,) * 3, "complex64", mesh=mesh, params=params,
                  inverse=True, device=dev)
    return fwd, inv


def roundtrip(n: int, mesh, dev) -> dict:
    """The forward's error against complex128 fftn and the round trip's
    against the input, over every rank's block."""
    fwd, inv = plans(n, mesh, dev)
    x = global_input(n, dev)
    blk = x[fwd.input_block(x.shape)].contiguous()
    y = fwd(blk)
    want = torch.fft.fftn(x.to(torch.complex128))[fwd.output_block(x.shape)]
    err = (total(norm2(y - want)) / total(norm2(want))) ** 0.5
    back = inv(y)
    rt = (total(norm2(back - blk)) / total(norm2(blk))) ** 0.5
    return {"fwd": err, "roundtrip": rt, "in": fwd.input_layout,
            "out": fwd.output_layout}


def main(argv=None) -> int:
    import torch.distributed as dist

    from offt_tpu_torch.dist import make_mesh

    ns = parser(__doc__, n=32).parse_args(argv)
    device(ns.device)
    dev, owned = world(ns.device)
    try:
        p1, p2 = grid(dist.get_world_size())
        mesh = make_mesh(p1, p2, device_type=dev.type)
        say(f"mesh: {p1} x {p2} on {dev.type}")
        r = roundtrip(ns.n, mesh, dev)
        say(f"input layout {r['in'].dims}, output layout {r['out'].dims}")
        say(f"rel err vs complex128 fftn: {r['fwd']:.2e}")
        say(f"roundtrip err: {r['roundtrip']:.2e}")
        assert r["fwd"] < TOL and r["roundtrip"] < TOL, r
        say("OK")
    finally:
        if owned:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
