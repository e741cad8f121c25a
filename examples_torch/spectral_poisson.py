"""A spectral Poisson solver on a distributed mesh: the "spectral
solvers" use case of BASELINE config 5.

The port of examples/spectral_poisson.py. Solves lap(u) = f with
periodic boundaries by dividing by -|k|^2 in frequency space, with a
forward r2c plan and an inverse c2r plan on a (p1, p2) pencil mesh. Each
rank holds its block of f; the division happens on the forward plan's
output block (the transposed-out layout), which is the inverse plan's
input block, so nothing is re-sharded between the two.

Run under torchrun, one rank a card (NCCL) or a CPU process (gloo);
alone, it is a world of one:

    torchrun --nproc_per_node 4 examples_torch/spectral_poisson.py --device cpu
    python examples_torch/spectral_poisson.py --n 256        (one card)
"""

from __future__ import annotations

import numpy as np

from _common import device, grid, norm2, parser, say, tensor, total, world


def inverse_laplacian(n: int) -> np.ndarray:
    """-1 / |k|^2 on the (n, n, n/2 + 1) half-spectrum, integer modes,
    0 at k = 0."""
    kx = np.fft.fftfreq(n) * n
    kz = np.fft.rfftfreq(n) * n
    k2 = (kx[:, None, None] ** 2 + kx[None, :, None] ** 2
          + kz[None, None, :] ** 2).astype(np.float32)
    return np.where(k2 > 0, -1.0 / np.maximum(k2, 1e-30),
                    0.0).astype(np.float32)


def manufactured(n: int):
    """(u, f = lap(u)): u = sin(2 pi x / n) cos(4 pi y / n), whose modes
    1 and 2 give lap(u) = -(1^2 + 2^2) u in integer modes."""
    i = np.arange(n)
    u = (np.sin(2 * np.pi * i / n)[:, None, None]
         * np.cos(4 * np.pi * i / n)[None, :, None]
         * np.ones((1, 1, n))).astype(np.float32)
    return u, (-5.0 * u).astype(np.float32)


def solver(n: int, mesh, dev):
    """(solve, in_block): solve(f block) is this rank's block of u."""
    import offt_tpu_torch as ot

    g = inverse_laplacian(n)
    fwd = ot.plan((n,) * 3, "float32", mesh=mesh, real=True, device=dev)
    inv = ot.plan((n,) * 3, "float32", mesh=mesh, real=True, inverse=True,
                  device=dev)
    g_blk = tensor(g[fwd.output_block(g.shape)], dev)

    def solve(f):
        return inv(fwd(f) * g_blk)
    return solve, fwd.input_block((n,) * 3)


def poisson(n: int, mesh, dev) -> float:
    """The solve's relative error against the manufactured solution,
    over every rank's block."""
    u_true, f = manufactured(n)
    solve, blk = solver(n, mesh, dev)
    u = solve(tensor(f[blk], dev))
    want = tensor(u_true[blk], dev)
    return (total(norm2(u - want)) / total(norm2(want))) ** 0.5


def main(argv=None) -> int:
    import torch.distributed as dist

    from offt_tpu_torch.dist import make_mesh

    ns = parser(__doc__, n=32).parse_args(argv)
    device(ns.device)
    dev, owned = world(ns.device)
    try:
        p1, p2 = grid(dist.get_world_size())
        mesh = make_mesh(p1, p2, device_type=dev.type)
        err = poisson(ns.n, mesh, dev)
        say(f"Poisson solve {ns.n}^3 on a {p1} x {p2} mesh ({dev.type}): "
            f"rel err {err:.2e}")
        assert err < 1e-5, err
        say("OK")
    finally:
        if owned:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
