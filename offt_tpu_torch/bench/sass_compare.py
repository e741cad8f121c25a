"""Compare the SASS of each kernel between two trees of CUDA sources.

Compiles each named source of ``kernels/csrc`` and of another directory
(an earlier commit's ``csrc``, unpacked with ``git archive``) to a cubin
with the flags of ``kernels/_build.py``, all at once, disassembles them
with ``cuobjdump -sass`` and prints one JSON line: how many kernels of
the other tree have byte-identical SASS here, how many differ or are
missing (their names), and how many kernels only this tree has. Needs
nvcc and cuobjdump, not a card.

    python -m offt_tpu_torch.bench.sass_compare OLD_CSRC fft_last.cu ...
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import json
import pathlib
import re
import subprocess
import tempfile

from ..kernels import _build


def sass(src: pathlib.Path, name: str, cub: pathlib.Path) -> dict:
    """{kernel: its SASS lines} of one source, compiled to ``cub``."""
    nvcc = _build._nvcc()
    subprocess.run([nvcc, "-gencode", _build.ARCH, "-std=c++17", "-O3",
                    "-cubin", "-I", str(src), "-o", str(cub), str(src / name)],
                   check=True, capture_output=True, text=True)
    out = subprocess.run([str(pathlib.Path(nvcc).with_name("cuobjdump")),
                          "-sass", str(cub)], check=True, capture_output=True,
                         text=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        if m := re.match(r"\s*Function : (\S+)", line):
            cur = m.group(1)
            funcs[cur] = []
        elif cur:
            funcs[cur].append(line)
    return funcs


def compare(old: pathlib.Path, names: list[str],
            new: pathlib.Path = _build.SRC_DIR) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        work = pathlib.Path(tmp)
        with cf.ThreadPoolExecutor(8) as ex:
            jobs = {(tree, n): ex.submit(sass, src, n,
                                         work / f"{tree}_{n}.cubin")
                    for tree, src in (("old", old), ("new", new))
                    for n in names}
            got = {k: f.result() for k, f in jobs.items()}
    same, diffs, only_new = 0, [], 0
    for n in names:
        a, b = got[("old", n)], got[("new", n)]
        for k in a:
            if k not in b:
                diffs.append(["missing", n, k])
            elif a[k] == b[k]:
                same += 1
            else:
                diffs.append(["differs", n, k])
        only_new += sum(k not in a for k in b)
    return {"sass_same": same, "sass_differ_or_missing": len(diffs),
            "diffs": diffs, "only_in_new": only_new}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("old", type=pathlib.Path,
                    help="the other tree's csrc directory")
    ap.add_argument("names", nargs="+", help="sources, e.g. fft_last.cu")
    args = ap.parse_args(argv)
    print(json.dumps(compare(args.old, args.names)))


if __name__ == "__main__":
    main()
