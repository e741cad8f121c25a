"""What the examples share: the repository on ``sys.path``, the device
argument, and the torch.distributed world of the mesh examples.

Not an example itself: ``tests/test_torch_examples*.py`` and
``chip_smoke.py`` run the files that do not start with an underscore.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402


def parser(doc: str, **sizes) -> argparse.ArgumentParser:
    """An argument parser with ``--device`` (default ``cuda``) and one
    integer option per ``sizes`` entry (name=default)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the card; fails without one) "
                         "or cpu (the kernels' plain versions)")
    for name, default in sizes.items():
        ap.add_argument(f"--{name.replace('_', '-')}", type=int,
                        default=default)
    return ap


def device(name: str) -> torch.device:
    """The device an example runs on; a CUDA device must be visible (an
    example never carries on on the CPU by itself)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device is visible: pass --device cpu "
                             "to run the example on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise SystemExit(f"--device cuda or cpu, not {name}")
    return dev


def world(name: str) -> tuple:
    """(device, whether this call started the world) for a mesh example:
    the world already started in this process, else torchrun's (its
    environment; gloo on the CPU, NCCL on cards with one card a rank),
    else a world of one rank."""
    import torch.distributed as dist

    dev = torch.device(name)
    if dist.is_initialized():
        return device(name), False
    if dev.type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dev = device(name)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dev, True


def grid(p: int) -> tuple:
    """The near-square (p1, p2) of ``p`` ranks, p1 <= p2."""
    p1 = int(p ** 0.5)
    while p % p1:
        p1 -= 1
    return p1, p // p1


def say(*args) -> None:
    """Print on rank 0 (everywhere without a world)."""
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(*args, flush=True)


def total(x: float) -> float:
    """The sum of ``x`` over the world's ranks (``x`` without a world)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        return x
    dev = "cuda" if dist.get_backend() == "nccl" else "cpu"
    t = torch.tensor([x], dtype=torch.float64, device=dev)
    dist.all_reduce(t)
    return float(t.item())


def norm2(t) -> float:
    """The squared 2-norm of ``t`` (real or complex), in float64."""
    t = t.to(torch.complex128) if t.is_complex() else t.double()
    return float(torch.linalg.vector_norm(t) ** 2)


def real_pair(n: int, dev, batch_dims: int = 0):
    """(fwd, inv) of the real n^3 transform on ``dev``: the port's planar
    r2c plan (a real tensor in, a (re, im) pair of the half-spectrum
    out) and c2r plan (the pair in, the real tensor out)."""
    import offt_tpu_torch as ot
    fwd = ot.plan((n,) * 3, "float32", real=True, planar=True,
                  batch_dims=batch_dims, device=dev)
    inv = ot.plan((n,) * 3, "float32", real=True, inverse=True, planar=True,
                  batch_dims=batch_dims, device=dev)
    return fwd, inv


def tensor(a, dev) -> torch.Tensor:
    """A numpy array as a tensor on ``dev``."""
    import numpy as np
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)
