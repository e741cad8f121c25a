"""The port's mesh Poisson example (examples_torch/spectral_poisson.py)
held against the same solve through offt_tpu's plans on a 2 x 2 mesh:
one spawned 4-rank gloo world runs the example's solver on each rank's
block of two right-hand sides (the example's manufactured one and a
random one from numpy seed 1) and saves its block of the solution; the
parent gathers the blocks and compares with the reference example's
solve on ``jax.devices()[:4]`` (JAX is imported only in the parent).
Tolerance 1e-5 relative (TOL): two float32 plans on the path."""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from torch_examples import WORLD, module

N = 32
TOL = 1e-5


def rhs() -> list:
    ex = module("spectral_poisson")
    _, f = ex.manufactured(N)
    g = np.random.default_rng(1).standard_normal((N,) * 3).astype(
        np.float32)
    return [f, g - g.mean()]


def _worker(rank: int, outdir: str) -> None:
    from offt_tpu_torch.dist import make_mesh

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(outdir, 'store')}",
        rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=120))
    try:
        ex = module("spectral_poisson")
        mesh = make_mesh(2, 2, device_type="cpu")
        solve, blk = ex.solver(N, mesh, torch.device("cpu"))
        for i, f in enumerate(rhs()):
            u = solve(torch.from_numpy(np.ascontiguousarray(f[blk])))
            np.savez(os.path.join(outdir, f"{i}_{rank}.npz"), u=u.numpy(),
                     blk=np.array([[s.start, s.stop] for s in blk]))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def test_poisson_solution_matches_reference(tmp_path):
    import jax
    import jax.numpy as jnp

    import offt_tpu
    from offt_tpu.dist import make_mesh

    torch.multiprocessing.spawn(_worker, args=(str(tmp_path),),
                                nprocs=WORLD, join=True)
    ex = module("spectral_poisson")
    mesh = make_mesh(2, 2, devices=jax.devices()[:WORLD])
    fwd = offt_tpu.plan((N,) * 3, "complex64", mesh=mesh, real=True)
    inv = offt_tpu.plan((N,) * 3, "complex64", mesh=mesh, real=True,
                        inverse=True)
    g = jnp.asarray(ex.inverse_laplacian(N))
    for i, f in enumerate(rhs()):
        got = np.zeros((N,) * 3, np.float32)
        seen = np.zeros((N,) * 3, bool)
        for rank in range(WORLD):
            d = np.load(tmp_path / f"{i}_{rank}.npz")
            blk = tuple(slice(a, b) for a, b in d["blk"])
            got[blk] = d["u"]
            seen[blk] = True
        assert seen.all()
        want = np.asarray(inv(fwd(f) * g))
        err = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert err < TOL, (i, err)
    u_true, _ = ex.manufactured(N)
    d0 = np.zeros((N,) * 3, np.float32)
    for rank in range(WORLD):
        d = np.load(tmp_path / f"0_{rank}.npz")
        d0[tuple(slice(a, b) for a, b in d["blk"])] = d["u"]
    assert np.linalg.norm(d0 - u_true) / np.linalg.norm(u_true) < TOL
