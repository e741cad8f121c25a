"""Build the CUDA kernels with nvcc and load them with ctypes.

The sources under ``csrc/`` compile into one shared library with a plain
C interface: one ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c
-Xcompiler -fPIC`` per ``*.cu``, all started together, then one
``nvcc -shared`` link. It is built at first use into ``kernels/build/``
(listed in ``.gitignore``), under a name keyed by a hash of the sources,
so an edited source builds anew and an unchanged one loads at once.
Every pointer and the stream pass as ``c_void_p``, a scale as
``c_float``; every C entry point returns ``cudaGetLastError()`` and
:func:`check` raises when it is not 0. The headers (``fft_core.cuh``, the
dense core; ``fft_regs.cuh``, the register core; ``regs_kernels.cuh``,
the kernels on it) are part of the digest.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

_HERE = pathlib.Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "build"
ARCH = "arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry points and their argument types (see csrc/*.cu).
_SIGNATURES = {
    "offt_fft_last": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I, _F,
                      _I, _P],
    "offt_fft_axis": [_P, _P, _P, _P, _P, _L, _I, _L, _L, _L, _L, _L, _L,
                      _L, _L, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    "offt_fft_slab": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _L, _L, _I, _I,
                      _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _I,
                      _P],
    "offt_rfft_slab": [_P, _P, _P, _P, _P, _P, _L, _I, _I, _L, _I, _I, _I,
                       _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "offt_irfft_slab": [_P] * 10 + [_L, _I, _I, _L] + [_I] * 12 + [_P],
    "offt_assemble_mp1": [_P, _P, _P, _P, _P, _P, _P, _P, _L, _I, _P],
    "offt_rfft_last": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                       _F, _I, _P],
    "offt_step1_twiddle": [_P] * 6 + [_L, _I, _L] + [_I] * 8 + [_P],
    "offt_step3_transposed": [_P] * 5 + [_L] + [_I] * 9 + [_P],
    "offt_icrfft_last": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _I, _I, _I, _I,
                         _P],
    "offt_fft_cube": [_P] * 10 + [_L] + [_I] * 21 + [_P],
}

_LIB = None
# seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0


def sources() -> list[pathlib.Path]:
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [shutil.which("nvcc"),
             os.path.join(home, "bin", "nvcc") if home else None,
             "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME)")


def _digest() -> str:
    h = hashlib.sha256(ARCH.encode())
    for f in sources():
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the sources if this digest has no library yet; returns the
    library path. Raises with nvcc's output when the build fails."""
    global build_seconds
    so = BUILD_DIR / f"liboffttorch_{_digest()}.so"
    if so.exists():
        build_seconds = 0.0
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cus = sorted(SRC_DIR.glob("*.cu"))
    work = pathlib.Path(tempfile.mkdtemp(dir=BUILD_DIR))
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        procs = [subprocess.Popen(
            [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-c", "-Xcompiler",
             "-fPIC", "-I", str(SRC_DIR), "-o", str(work / f"{f.stem}.o"),
             str(f)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for f in cus]
        outs = [(f.name, p.communicate()[0], p.returncode)
                for f, p in zip(cus, procs)]
        failed = [o for o in outs if o[2] != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({rc}):\n{out}" for name, out, rc in failed))
        tmp = work / "lib.so"
        proc = subprocess.run(
            [nvcc, "-gencode", ARCH, "-shared", "-o", str(tmp),
             *(str(work / f"{f.stem}.o") for f in cus)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        build_seconds = time.perf_counter() - t0
        os.replace(tmp, so)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.offt_error_string.argtypes = [ctypes.c_int]
        lib.offt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check(code: int, what: str) -> None:
    """Raise when a C entry point reported a CUDA error."""
    if code != 0:
        msg = library().offt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
