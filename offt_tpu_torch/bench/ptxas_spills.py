"""Registers and spills of each kernel of the CUDA sources, as ptxas
reports them.

Compiles each named source of ``kernels/csrc`` (or another directory)
with the flags of ``kernels/_build.py`` plus ``-Xptxas -v``, all at once,
and prints one JSON line a kernel: the source, the demangled kernel name,
its registers, its stack frame and its spill stores and loads in bytes.
Needs nvcc, not a card.

    python -m offt_tpu_torch.bench.ptxas_spills irfft_slab.cu fft_axis.cu
    python -m offt_tpu_torch.bench.ptxas_spills --src DIR irfft_slab.cu
"""

from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import tempfile

from ..kernels import _build

_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_FRAME = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_REGS = re.compile(r"Used (\d+) registers")


def report(names: list[str], src: pathlib.Path = _build.SRC_DIR) -> list:
    nvcc = _build._nvcc()
    work = pathlib.Path(tempfile.mkdtemp())
    try:
        procs = [(name, subprocess.Popen(
            [nvcc, "-gencode", _build.ARCH, "-std=c++17", "-O3", "-c",
             "-Xptxas", "-v", "-I", str(src), "-o",
             str(work / f"{pathlib.Path(name).stem}.o"), str(src / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            for name in names]
        rows = []
        for name, p in procs:
            out = p.communicate()[0]
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{out}")
            row = None
            for line in out.splitlines():
                if m := _ENTRY.search(line):
                    row = {"source": name, "kernel": m.group(1)}
                    rows.append(row)
                elif row is not None and (m := _FRAME.search(line)):
                    row.update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
                elif row is not None and (m := _REGS.search(line)):
                    row["registers"] = int(m.group(1))
        filt = pathlib.Path(nvcc).with_name("cu++filt")
        if filt.exists() and rows:
            names_out = subprocess.run(
                [str(filt)], input="\n".join(r["kernel"] for r in rows),
                capture_output=True, text=True).stdout.splitlines()
            if len(names_out) == len(rows):
                for r, k in zip(rows, names_out):
                    r["kernel"] = k
        return rows
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+")
    ap.add_argument("--src", type=pathlib.Path, default=_build.SRC_DIR)
    args = ap.parse_args()
    for r in report(args.sources, args.src):
        print(json.dumps(r))
