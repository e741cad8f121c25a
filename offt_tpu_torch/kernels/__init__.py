"""Kernels: the f32 tables (``dft``, ``tables``), the CUDA kernels and
their wrappers (``fused_fft``), and the nvcc build (``_build``)."""
