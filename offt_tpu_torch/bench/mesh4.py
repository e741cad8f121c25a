"""The distributed engines over NCCL on four cards of one host.

Run from the repository root on a machine with at least four CUDA cards:

    python -m offt_tpu_torch.bench.mesh4

It spawns one process per card, joins them in an NCCL group
(``tcp://localhost``, a free port) and on a 2 x 2 mesh:

- runs the long-1-D engine (``plan((1, 1, N), mesh=...)``, route
  ``"long1d"``) at 2^20 and 2^24, c2c forward and the packed r2c / c2r,
  each rank on its natural chunk of one global input made from a seed,
  and holds each rank's chunk against complex128 ``torch.fft`` of the
  whole input (1e-6);
- times the c2c engine per rank by CUDA events, beside one card's
  single-device plan of the whole transform and ``torch.fft.fft``, and
  splits it stage by stage: the three exchanges and the four-step pair
  on the rank's shard, each alone;
- runs ``obs/profile.pencil_breakdown`` of 256^3 c2c (each pass and
  each exchange alone, and the mesh plan).

Every rank prints its rows; the script prints the card's name and power
limit first and exits 0 when every check held. Without four cards it
exits 2.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys

import torch
import torch.distributed as dist

WORLD = 4
TOL = 1e-6
LENGTHS = (2 ** 20, 2 ** 24)
CUBE = (256, 256, 256)


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def _global(n: int, device, seed: int, real: bool = False):
    """The same global input on every rank, from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if real:
        return torch.randn((1, 1, n), generator=gen, device=device)
    return tuple(torch.randn((1, 1, n), generator=gen, device=device)
                 for _ in range(2))


def _stages(p, xs, time_cuda) -> dict:
    """ms of each stage of the engine's c2c alone on this rank's shard:
    the three exchanges and the four-step pair."""
    from ..kernels import fourstep as fs
    from ..kernels import fused_fft as ff

    core = p._long1d.core
    n1, n2, ptot = core.n1, core.n2, core.ptot
    ex = core._exchange
    a = tuple(t.reshape(1, n1 // ptot, n2) for t in xs)
    b = ex(a, 2, 1)
    tw = ff._tables(None, b[0].device).get(*core.twiddle)
    c = fs.step12_planar(*b, core.rad1, False, "highest", tw)
    d = ex(c, 1, 2)
    e = fs.step34_planar(*d, core.rad2, False, "highest")
    ms = {}
    for name, fn, args in (
            ("exchange_1", lambda x: ex(x, 2, 1), (a,)),
            ("step12", lambda x: fs.step12_planar(*x, core.rad1, False,
                                                  "highest", tw), (b,)),
            ("exchange_2", lambda x: ex(x, 1, 2), (c,)),
            ("step34", lambda x: fs.step34_planar(*x, core.rad2, False,
                                                  "highest"), (d,)),
            ("exchange_3", lambda x: ex(x, 1, 2, True), (e,))):
        dist.barrier()
        ms[name] = time_cuda(fn, args)["median_ms"]
    return ms


def _worker(rank: int, port: int, backend: str, device_type: str,
            lengths, cube) -> None:
    import offt_tpu_torch as ot
    from offt_tpu_torch.obs.profile import pencil_breakdown, time_cuda

    if device_type == "cuda":
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(f"cuda:{rank}" if device_type == "cuda" else "cpu")
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = ot.make_mesh(2, 2, device_type=device_type)
        tag = f"rank {rank}"
        for n in lengths:
            xs = _global(n, dev, seed=1)
            z = torch.complex(*xs).to(torch.complex128)
            p = ot.plan((1, 1, n), "complex64", mesh=mesh, planar=True,
                        device=dev)
            if p.route != "long1d" or not p._long1d.fused:
                raise AssertionError(f"(1, 1, {n}): route {p.route}")
            blk = p.input_block((1, 1, n))
            mine = tuple(t[blk].contiguous() for t in xs)
            yr, yi = p(*mine)
            err = _rel(torch.complex(yr, yi).to(torch.complex128),
                       torch.fft.fft(z)[p.output_block((1, 1, n))])
            print(f"{tag} long1d c2c {n} split {p._long1d.split}: rel err "
                  f"{err:.3e} (tol {TOL:g})", flush=True)
            if err > TOL:
                raise AssertionError(f"c2c {n}: {err:.3e}")
            r = _global(n, dev, seed=2, real=True)
            pr = ot.plan((1, 1, n), "float32", mesh=mesh, real=True,
                         planar=True, packed=True, device=dev)
            pi = ot.plan((1, 1, n), "float32", mesh=mesh, real=True,
                         inverse=True, planar=True, packed=True, device=dev)
            if not pr.route == pi.route == "long1d":
                raise AssertionError(f"real {n}: {pr.route}, {pi.route}")
            hr, hi = pr(r[pr.input_block(r.shape)].contiguous())
            w = torch.fft.rfft(r.double())
            m = n // 2
            want = torch.cat([torch.complex(w[..., :1].real,
                                            w[..., m:].real),
                              w[..., 1:m]], -1)[pr.output_block((1, 1, m))]
            err_r = _rel(torch.complex(hr, hi).to(torch.complex128), want)
            back = pi(hr, hi)
            err_c = _rel(back.double(), r[pi.output_block(r.shape)].double())
            print(f"{tag} long1d packed r2c {n}: rel err {err_r:.3e}, c2r "
                  f"round trip {err_c:.3e} (tol {TOL:g})", flush=True)
            if max(err_r, err_c) > TOL:
                raise AssertionError(f"real {n}: {err_r:.3e}, {err_c:.3e}")
            if device_type != "cuda":
                continue
            dist.barrier()
            ms = time_cuda(p, mine)["median_ms"]
            one = ot.plan((1, 1, n), "complex64", planar=True, device=dev)
            ms_one = time_cuda(one, xs)["median_ms"]
            xc = torch.complex(*xs)
            ms_fft = time_cuda(torch.fft.fft, (xc,))["median_ms"]
            st = _stages(p, mine, time_cuda)
            parts = ", ".join(f"{k} {v:.4f}" for k, v in st.items())
            print(f"{tag} time long1d c2c {n} on 2x2: {ms:.4f} ms; one "
                  f"card's plan of the whole {ms_one:.4f} ms, torch.fft.fft "
                  f"{ms_fft:.4f} ms; stages alone, ms: {parts}; their sum "
                  f"{sum(st.values()):.4f}", flush=True)
            del xs, z, mine, r, w, want, back, one, xc
            torch.cuda.empty_cache()
        dist.barrier()
        bd = pencil_breakdown(cube, mesh)
        parts = ", ".join(f"{k} {v * 1e3:.4f}" for k, v in bd.items())
        print(f"{tag} pencil_breakdown {cube} on 2x2, ms: {parts}",
              flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(backend="nccl", device_type="cuda", lengths=LENGTHS,
        cube=CUBE) -> None:
    torch.multiprocessing.spawn(
        _worker, args=(_free_port(), backend, device_type, lengths, cube),
        nprocs=WORLD, join=True)


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        print(f"mesh4 needs {WORLD} CUDA cards", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
    from ..kernels import _build
    _build.build()          # once, before the ranks load it
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
