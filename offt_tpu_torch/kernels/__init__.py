"""Kernels: the f32 tables (``dft``, ``tables``), the CUDA kernels and
their wrappers (``fused_fft``; the four-step pair in ``fourstep``), the
unfused r2c/c2r around them (``rfft``), and the nvcc build
(``_build``)."""
