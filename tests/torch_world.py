"""Helpers of the tests that run offt_tpu_torch's pencil engine on a
spawned gloo world of 4 ranks on the CPU (tests/test_torch_pencil*.py).

A test file lists its cases, spawns the world once (:func:`spawn`), and
each rank runs every case on its blocks (:func:`run_cases`) and saves
them under the test's temporary directory. The parent gathers the blocks
into global arrays (:func:`gather`) and holds them against offt_tpu on a
mesh of the same shape built from ``jax.devices()[:4]``
(:func:`reference`, which alone imports JAX, inside the function: the
spawned ranks never load it).

A case is a dict: ``mesh`` ((p1, p2), or (slices, p1, p2) for a
multi-slice mesh), ``shape`` (global Nx, Ny, Nz), ``batch`` (leading
dims), ``inverse``, ``real``, ``packed``, ``norm``, ``batch_sharded``,
``knobs`` (PlanParams fields; None takes the default point) and ``fp64``
(complex128 / float64 data and plans, the fp64 route). A mesh of fewer
ranks than the world takes the first ones; the others make the mesh (a
collective call) and skip the case.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import math
import os

import numpy as np
import torch
import torch.distributed as dist

WORLD = 4


def case(mesh=(2, 2), shape=(8, 8, 16), batch=(), inverse=False,
         real=False, packed=False, norm=None, batch_sharded=False,
         knobs=None, fp64=False) -> dict:
    return dict(mesh=tuple(mesh), shape=tuple(shape), batch=tuple(batch),
                inverse=inverse, real=real, packed=packed, norm=norm,
                batch_sharded=batch_sharded, knobs=knobs, fp64=fp64)


def case_id(c) -> str:
    kind = ("c2r" if c["inverse"] else "r2c") if c["real"] else \
        ("inv" if c["inverse"] else "fwd")
    parts = ["x".join(map(str, c["mesh"])), kind,
             "x".join(map(str, c["batch"] + c["shape"]))]
    if c["packed"]:
        parts.append("packed")
    if c["batch_sharded"]:
        parts.append("bs")
    if c["norm"]:
        parts.append(c["norm"])
    if c.get("fp64"):
        parts.append("fp64")
    for k, v in (c["knobs"] or {"default": ""}).items():
        parts.append(f"{k}{v}")
    return "-".join(parts)


def inputs(c, seed: int) -> np.ndarray:
    """The global input: complex64 for c2c, float32 real data for r2c, the
    complex64 half-spectrum of real data for c2r (packed: M lanes, lane 0
    = X[0] + i X[M]); complex128 and float64 for an fp64 case."""
    rng = np.random.default_rng(seed)
    shp = c["batch"] + c["shape"]
    cdt, rdt = ((np.complex128, np.float64) if c.get("fp64")
                else (np.complex64, np.float32))
    if not c["real"]:
        return (rng.standard_normal(shp)
                + 1j * rng.standard_normal(shp)).astype(cdt)
    x = rng.standard_normal(shp)
    if not c["inverse"]:
        return x.astype(rdt)
    return half_spectrum(c, x).astype(cdt)


def half_spectrum(c, x) -> np.ndarray:
    w = np.fft.rfftn(x, axes=(-3, -2, -1), norm=c["norm"])
    if not c["packed"]:
        return w
    m = c["shape"][2] // 2
    p = w[..., :m].copy()
    p[..., 0] = w[..., 0] + 1j * w[..., m]
    return p


def truth(c, seed: int) -> np.ndarray:
    """numpy complex128 / float64 result of the case on its input: for a
    c2r, the real data whose spectrum the input is."""
    x = inputs(c, seed)
    if not c["real"]:
        f = np.fft.ifftn if c["inverse"] else np.fft.fftn
        return f(x.astype(np.complex128), axes=(-3, -2, -1), norm=c["norm"])
    if not c["inverse"]:
        return half_spectrum(c, x.astype(np.float64))
    return np.random.default_rng(seed).standard_normal(c["batch"]
                                                       + c["shape"])


def out_shape(c) -> tuple:
    nx, ny, nz = c["shape"]
    if c["real"] and not c["inverse"]:
        nz = nz // 2 + (0 if c["packed"] else 1)
    return c["batch"] + (nx, ny, nz)


def spawn(worker, outdir) -> None:
    """Run ``worker(rank, outdir)`` on WORLD spawned ranks and wait."""
    torch.multiprocessing.spawn(worker, args=(str(outdir),), nprocs=WORLD,
                                join=True)


def _mesh(dims):
    from offt_tpu_torch.dist import make_mesh, make_multislice_mesh
    if len(dims) == 3:
        return make_multislice_mesh(*dims, device_type="cpu")
    return make_mesh(*dims, device_type="cpu")


def _params(c):
    from offt_tpu_torch.plan.params import PlanParams
    if c["knobs"] is None:
        return None
    return PlanParams(p1=c["mesh"][-2], use_pallas=1, **c["knobs"])


def _plan(c, mesh):
    import offt_tpu_torch as ot
    if c.get("fp64"):
        dtype = "float64" if c["real"] else "complex128"
    else:
        dtype = "float32" if c["real"] else "complex64"
    return ot.plan(c["shape"], dtype, mesh=mesh, real=c["real"],
                   inverse=c["inverse"], batch_dims=len(c["batch"]), params=_params(c),
                   use_cache=False, planar=True, norm=c["norm"],
                   batch_sharded=c["batch_sharded"], packed=c["packed"],
                   device="cpu")


def run_cases(rank: int, outdir: str, cases) -> None:
    """One rank's part: join the world (a file store in ``outdir``), run
    every case on this rank's block of its input, save the output block
    and its slices, leave the world."""
    from offt_tpu_torch.dist import local_block
    from offt_tpu_torch.kernels import fused_fft as ff

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{os.path.join(outdir, 'store')}",
        rank=rank, world_size=WORLD,
        timeout=datetime.timedelta(seconds=120))
    try:
        meshes = {}
        for i, c in enumerate(cases):
            if c["mesh"] not in meshes:
                meshes[c["mesh"]] = _mesh(c["mesh"])
            if rank >= _ranks(c):
                continue
            p = _plan(c, meshes[c["mesh"]])
            x = inputs(c, seed=i)
            assert local_block(p.mesh, p.input_layout, x.shape) == \
                p.input_block(x.shape)
            ff.reset_counts()
            blk = x[p.input_block(x.shape)]
            if c["real"] and not c["inverse"]:
                y = p(torch.from_numpy(blk.copy()))
            else:
                y = p(torch.from_numpy(blk.real.copy()),
                      torch.from_numpy(blk.imag.copy()))
            y = y.numpy() if isinstance(y, torch.Tensor) else \
                y[0].numpy() + 1j * y[1].numpy()
            ran = sorted(k for k, v in ff.counts().items() if v[1])
            oblk = p.output_block(out_shape(c))
            np.savez(os.path.join(outdir, f"{i}_{rank}.npz"), y=y,
                     blk=np.array([[s.start, s.stop] for s in oblk]),
                     params=json.dumps(dataclasses.asdict(p.params)),
                     ran=json.dumps(ran))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _ranks(c) -> int:
    """The ranks of the case's mesh: the first ones of the world."""
    return math.prod(c["mesh"])


def gather(outdir, i: int, c) -> tuple:
    """(global output, the port's resolved PlanParams as a dict, the
    kernel wrappers whose plain versions ran on rank 0) of case ``i`` from
    the ranks' blocks; every element must be covered."""
    shp = out_shape(c)
    out, seen, params, ran = None, np.zeros(shp, bool), None, None
    for rank in range(_ranks(c)):
        d = np.load(os.path.join(outdir, f"{i}_{rank}.npz"))
        if out is None:
            out = np.zeros(shp, d["y"].dtype)
        blk = tuple(slice(a, b) for a, b in d["blk"])
        assert d["y"].shape == out[blk].shape
        out[blk] = d["y"]
        seen[blk] = True
        params = json.loads(str(d["params"]))
        ran = ran or set(json.loads(str(d["ran"])))
    assert seen.all()
    return out, params, ran


def reference(c, x, params: dict) -> np.ndarray:
    """offt_tpu's result of the case on a 4-device mesh of the same shape,
    with the port's resolved parameters (the Pallas kernels in interpret
    mode)."""
    import jax

    import offt_tpu
    from offt_tpu.dist import mesh as rmesh
    from offt_tpu.plan.params import PlanParams

    devs = jax.devices()[:_ranks(c)]
    if len(c["mesh"]) == 3:
        mesh = rmesh.make_multislice_mesh(*c["mesh"], devices=devs)
    else:
        mesh = rmesh.make_mesh(*c["mesh"], devices=devs)
    p = offt_tpu.plan(c["shape"],
                      "complex128" if c.get("fp64") else "complex64",
                      mesh=mesh, real=c["real"],
                      inverse=c["inverse"], batch_dims=len(c["batch"]),
                      params=PlanParams(**{
                          k: tuple(v) if isinstance(v, list) else v
                          for k, v in params.items()}), use_cache=False,
                      planar=True, norm=c["norm"],
                      batch_sharded=c["batch_sharded"], packed=c["packed"])
    if c["real"] and not c["inverse"]:
        y = p(x)
    else:
        y = p((x.real.copy(), x.imag.copy()))
    if isinstance(y, tuple):
        return np.asarray(y[0]).astype(np.float64) + 1j * np.asarray(y[1])
    return np.asarray(y)


def rel_err(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm((a - b).ravel())
                 / np.linalg.norm(b.ravel()))
