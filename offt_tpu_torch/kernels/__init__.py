"""Kernels: the f32 tables (``dft``, ``tables``), the CUDA kernels and
their wrappers (``fused_fft``; the four-step pair in ``fourstep``), the
unfused r2c/c2r around them (``rfft``), the unfused engine (``stockham``:
the matmul chain, Bluestein, fp64) and the nvcc build (``_build``)."""

from . import dft
from .stockham import fft, fft_1d, ifft

__all__ = ["dft", "fft", "fft_1d", "ifft"]
