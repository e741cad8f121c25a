"""ctypes binding to the native C++ tuning engine (native/offt_tune_engine.cpp).

Port of ``offt_tpu/tune/engine_cpp.py``. Implements the same Strategy
protocol as strategies.py, backed by the compiled engine — the parity
answer to Active Harmony's native client/search core (hclient.c +
session-core.c + strategies/*.so, which the reference dlopen's at
runtime; we compile once and ctypes-load).

The repository's ``native/offt_tune_engine.cpp`` (the shared library) and
``native/offt_tune_server.cpp`` (the server) are built on demand with
g++ into ``offt_tpu_torch/tune/build/`` (listed in ``.gitignore``): each
build writes a name of its own and renames it into place, so processes
that build at once (test workers) never load or run a torn file. If no
toolchain is available the caller should fall back to the pure-Python
strategies (make_strategy).
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_NATIVE_DIR = pathlib.Path(__file__).resolve().parents[2] / "native"
_BUILD_DIR = pathlib.Path(__file__).resolve().parent / "build"
_LIB_PATH = _BUILD_DIR / "liboffttune.so"
_SRC = _NATIVE_DIR / "offt_tune_engine.cpp"

_lock = threading.Lock()
_lib = None


def _compile(out: pathlib.Path, flags: list, src: pathlib.Path) -> None:
    """g++ ``src`` into ``out`` through a temporary name in the same
    directory, renamed into place."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, prefix=out.name + ".")
    os.close(fd)
    try:
        subprocess.run(["g++", "-O2", "-std=c++17", *flags, "-o", tmp,
                        str(src)], check=True, capture_output=True)
        os.chmod(tmp, 0o755)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def build_library(force: bool = False) -> pathlib.Path:
    """Compile the engine if needed; returns the .so path."""
    if _LIB_PATH.exists() and not force:
        newest = max(_SRC.stat().st_mtime,
                     (_NATIVE_DIR / "engine.hpp").stat().st_mtime)
        if _LIB_PATH.stat().st_mtime >= newest:
            return _LIB_PATH
    _compile(_LIB_PATH, ["-shared", "-fPIC"], _SRC)
    return _LIB_PATH


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build_library()))
        lib.ote_create.restype = ctypes.c_void_p
        lib.ote_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
            ctypes.c_uint, ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
        lib.ote_generate.restype = ctypes.c_int
        lib.ote_generate.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int)]
        lib.ote_analyze.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_int),
                                    ctypes.c_double]
        lib.ote_rejected.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_int)]
        lib.ote_best.restype = ctypes.c_int
        lib.ote_best.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
        lib.ote_best_perf.restype = ctypes.c_double
        lib.ote_best_perf.argtypes = [ctypes.c_void_p]
        lib.ote_converged.restype = ctypes.c_int
        lib.ote_converged.argtypes = [ctypes.c_void_p]
        lib.ote_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, subprocess.CalledProcessError, FileNotFoundError):
        return False


class NativeStrategy:
    """Strategy-protocol wrapper over the C++ engine."""

    def __init__(self, name: str, space, seed: int = 0,
                 init_simplex: Optional[list] = None, size: int = 0, **_):
        lib = _load()
        self._lib = lib
        self.space = space
        self.n = len(space.dims)
        sizes = (ctypes.c_int * self.n)(*[len(d) for d in space.dims])
        init_ptr = None
        if init_simplex:
            size = size or max(len(init_simplex), self.n + 1)
            flat = []
            pts = list(init_simplex)
            rng = np.random.default_rng(seed)
            while len(pts) < size:
                pts.append(space.random_point(rng))
            for p in pts[:size]:
                flat.extend(float(v) for v in p)
            init_ptr = (ctypes.c_double * len(flat))(*flat)
        self._h = lib.ote_create(name.encode(), self.n, sizes,
                                 ctypes.c_uint(seed), size, init_ptr)
        self._buf = (ctypes.c_int * self.n)()

    def generate(self):
        if self._lib.ote_generate(self._h, self._buf):
            return tuple(self._buf[i] for i in range(self.n))
        return None

    def analyze(self, point, perf: float) -> None:
        buf = (ctypes.c_int * self.n)(*point)
        self._lib.ote_analyze(self._h, buf, ctypes.c_double(perf))

    def rejected(self, point) -> None:
        buf = (ctypes.c_int * self.n)(*point)
        self._lib.ote_rejected(self._h, buf)

    def best(self):
        if self._lib.ote_best(self._h, self._buf):
            return tuple(self._buf[i] for i in range(self.n))
        return None

    def converged(self) -> bool:
        return bool(self._lib.ote_converged(self._h))

    def __del__(self):
        try:
            self._lib.ote_destroy(self._h)
        except Exception:
            pass


def make_native_strategy(name: str, space, **kw) -> NativeStrategy:
    if name not in ("nm", "pro", "random", "brute"):
        raise ValueError(f"native engine has no strategy {name!r}")
    return NativeStrategy(name, space, **kw)


# ---------------------------------------------------------------------------
# native tuning server (hserver parity: native/offt_tune_server.cpp)
# ---------------------------------------------------------------------------

_SERVER_SRC = _NATIVE_DIR / "offt_tune_server.cpp"
_SERVER_BIN = _BUILD_DIR / "offt-tune-server"


def build_server(force: bool = False) -> pathlib.Path:
    """Compile the native tuning server if needed; returns the binary path."""
    if _SERVER_BIN.exists() and not force:
        newest = max(_SERVER_SRC.stat().st_mtime,
                     (_NATIVE_DIR / "engine.hpp").stat().st_mtime)
        if _SERVER_BIN.stat().st_mtime >= newest:
            return _SERVER_BIN
    _compile(_SERVER_BIN, ["-pthread"], _SERVER_SRC)
    return _SERVER_BIN


def spawn_server(port: int = 0, host: str = "127.0.0.1"):
    """Launch the native server (auto-spawn parity with tuna.c:164-197 /
    offt-tuning.c:798-837 launch_silent). Returns (Popen, actual_port)."""
    binpath = build_server()
    proc = subprocess.Popen(
        [str(binpath), "--host", host, "--port", str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    line = proc.stdout.readline()  # "offt-tpu native tuning server on h:p"
    try:
        actual = int(line.rsplit(":", 1)[1])
    except (ValueError, IndexError):
        proc.kill()
        raise RuntimeError(f"native server failed to start: {line!r}")
    return proc, actual
