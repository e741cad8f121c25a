"""A distributed long-1-D FFT: tone pick and denoise of a sharded record.

The port of examples/dist1d_signal.py. One long 1-D record, four-step
sharded over every rank of the mesh (offt_tpu_torch/dist/long1d.py:
natural-order chunks in and out, the four-step pair on each rank's
shard, three exchanges). The use case: picking tones out of a very long
record (radio astronomy channelisation, pulsar search, long audio) that
is produced already sharded: each rank holds a contiguous chunk, the
spectrum comes back in the same layout, and peak picking is a local
top-k a rank plus one small gather, so no rank ever holds the record.

On a world of more than one rank the plan must take the engine
(``plan.route == "long1d"``); a world of one has nothing to distribute,
and the (1, 1, N) plan takes the pencil route on its one rank, as the
reference's does.

Run under torchrun, one rank a card (NCCL) or a CPU process (gloo);
alone, it is a world of one:

    torchrun --nproc_per_node 4 examples_torch/dist1d_signal.py --device cpu
    python examples_torch/dist1d_signal.py --log2n 24        (one card)
"""

from __future__ import annotations

import math

import torch

from _common import device, grid, norm2, parser, say, total, world

TONES = (1234, 77777, 131072 - 9)
NOISE = 0.01
TOL = 2e-2      # the denoised record against the pure tones


def record(n: int, dev, seed: int = 0):
    """(noisy record, pure tones), complex64 (1, 1, n), the same on every
    rank: the three tones plus complex Gaussian noise from ``seed``."""
    t = torch.arange(n, dtype=torch.float64, device=dev)
    pure = sum(torch.exp(2j * math.pi * k * t / n) for k in TONES)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    noise = torch.complex(*(torch.randn(n, generator=gen, device=dev,
                                        dtype=torch.float64)
                            for _ in range(2)))
    sig = (pure + NOISE * noise).to(torch.complex64).reshape(1, 1, n)
    return sig, pure.to(torch.complex64).reshape(1, 1, n)


def plans(n: int, mesh, dev):
    import offt_tpu_torch as ot
    fwd = ot.plan((1, 1, n), "complex64", mesh=mesh, norm="ortho",
                  device=dev)
    inv = ot.plan((1, 1, n), "complex64", mesh=mesh, norm="ortho",
                  inverse=True, device=dev)
    return fwd, inv


def top_bins(spec, start: int, k: int = 3) -> list:
    """The global bins of the ``k`` largest magnitudes: this rank's top
    ``k`` (its chunk starts at bin ``start``), gathered over the world."""
    import torch.distributed as dist
    mag = spec.abs().reshape(-1)
    val, idx = torch.topk(mag, min(k, mag.numel()))
    mine = [(float(v), int(i) + start) for v, i in zip(val, idx)]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    best = sorted((c for cs in every for c in cs), reverse=True)[:k]
    return sorted(i for _, i in best)


def denoise(x, fwd, inv, n: int):
    """Zero every bin below a tenth of a tone's magnitude (sqrt(n) under
    the ortho norm), then the inverse."""
    s = fwd(x)
    s = torch.where(s.abs() > 0.1 * math.sqrt(n), s, torch.zeros_like(s))
    return inv(s)


def signal(n: int, mesh, dev) -> dict:
    """The tones found and the denoised record's error, over every
    rank's chunk."""
    fwd, inv = plans(n, mesh, dev)
    sig, pure = record(n, dev)
    blk = fwd.input_block(sig.shape)
    x = sig[blk].contiguous()
    found = top_bins(fwd(x), blk[-1].start)
    clean = denoise(x, fwd, inv, n)
    want = pure[fwd.output_block(sig.shape)]
    err = (total(norm2(clean - want)) / total(norm2(want))) ** 0.5
    return {"route": fwd.route, "found": found, "err": err}


def main(argv=None) -> int:
    import torch.distributed as dist

    from offt_tpu_torch.dist import make_mesh, quiesce

    ns = parser(__doc__, log2n=18).parse_args(argv)
    device(ns.device)
    dev, owned = world(ns.device)
    try:
        ranks = dist.get_world_size()
        p1, p2 = grid(ranks)
        mesh = make_mesh(p1, p2, device_type=dev.type)
        n = 1 << ns.log2n
        r = signal(n, mesh, dev)
        say(f"mesh: {p1} x {p2} on {dev.type}; a {n}-sample record in "
            f"contiguous 1/{ranks} chunks; route {r['route']}")
        if ranks > 1:
            assert r["route"] == "long1d", "dist-1d engine did not engage"
        say(f"tones injected: {sorted(TONES)}  found: {r['found']}")
        assert r["found"] == sorted(TONES), r["found"]
        say(f"denoised rel err vs pure tones: {r['err']:.2e}")
        assert r["err"] < TOL, r["err"]
        say("OK")
        if owned:
            quiesce()
    finally:
        if owned:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
