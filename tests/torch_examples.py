"""Helpers of the tests of the port's examples (examples_torch/,
tests/test_torch_examples*.py): the example files, a run of one in a
fresh process (alone, or as a 4-rank gloo world under torchrun), and its
import as a module, for the tests that hold its computation against the
same through offt_tpu's plans."""

from __future__ import annotations

import importlib
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = REPO / "examples_torch"
SINGLE = ("grad_spectral", "jvp_sensitivity", "fno_layer", "packed_spectral",
          "steered_tuning", "tune_quadratic")
MESH = ("spectral_poisson", "distributed_fft", "dist1d_signal")
ALL = SINGLE + MESH
WORLD = 4


def files() -> list:
    """Every example: the files of examples_torch/ but the helpers."""
    return sorted(p.stem for p in EXAMPLES.glob("*.py")
                  if not p.stem.startswith("_"))


def run(name: str, *args, world: int = 0, timeout: int = 300):
    """``examples_torch/<name>.py args`` in a fresh process; under
    torchrun as ``world`` ranks on one host (its rendezvous on a free
    localhost port) where ``world`` > 0."""
    cmd = [sys.executable]
    if world:
        cmd += ["-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", str(world)]
    cmd += [str(EXAMPLES / f"{name}.py"), *args]
    env = dict(os.environ)
    env.pop("CUDA_VISIBLE_DEVICES", None)
    return subprocess.run(cmd, capture_output=True, text=True,
                          cwd=str(REPO), env=env, timeout=timeout)


def module(name: str):
    """The example as a module (its directory on ``sys.path``)."""
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    return importlib.import_module(name)


def stress(name: str, at_once: int = 12, runs: int = 48) -> list:
    """``runs`` runs of the mesh example ``name`` under torchrun (4 ranks,
    ``--device cpu``), ``at_once`` worlds at a time: a load under which
    an unsteady teardown shows. Returns the failures as (returncode, the
    end of stderr)."""
    import concurrent.futures as cf

    def one(_):
        out = run(name, "--device", "cpu", world=WORLD)
        ok = (out.returncode == 0
              and out.stdout.splitlines().count("OK") == 1)
        return None if ok else (out.returncode, out.stderr[-3000:])

    with cf.ThreadPoolExecutor(at_once) as ex:
        return [f for f in ex.map(one, range(runs)) if f is not None]


if __name__ == "__main__":
    # python tests/torch_examples.py dist1d_signal [at_once] [runs]
    fails = stress(sys.argv[1], *map(int, sys.argv[2:4]))
    for rc, err in fails:
        print(f"rc {rc}:\n{err}")
    print(f"{len(fails)} failed")
