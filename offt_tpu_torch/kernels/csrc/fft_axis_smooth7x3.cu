// fft_axis_smooth7x3.cu: the strided-axis kernel of fft_axis.cu at the
// fourth family of fft_smooth.cuh, the lengths R 2^K with a factor 7,
// K >= 2, at R = 3^a 7^c (a, c >= 1: 21, 63, 147, 189, 441, 567; R0 = 3,
// V0 = 12, or R0 = 7, V0 = 28, by regs::smooth7_r0) and at most 128 threads
// a line with planes that fit a block (regs::smooth7_col): 84-2688, 18
// lengths; 3024 (padded planes of 236 KB) and 4032 (P = 336) stay on the
// dense core, on the register core's column variant of fft_smooth.cuh
// (regs::cols_smooth).
//
// Replaces, at those lengths, the dense core of the same four Pallas kernels
// (offt_tpu/kernels/pallas_fft.py fft_sublane :900, _sublane_nd :993,
// fft_x_from_padded :1509, fft_x_to_padded :1574) behind the C entry point
// of fft_axis.cu, and the y pass of fft_slab_yz (:1404; fft_slab.cu, two
// grids). A source of its own for these odd parts, as the rows'.
//
// What bounds it on Hopper: as fft_axis.cu, one read and one write of the
// planar pair. Design (fft_smooth.cuh): the passes of the rows
// (fft_last_smooth7x3.cu) on P = N / V0 threads a line; one lane tile,
// L = 32 lanes a block up to 768 threads, 16 above, 8 above 1536 (the wide
// tile's code, 1: fused_fft._axis_tile); the planes padded one slot per four
// elements from K = 4, unpadded below, every put and get at most two
// wavefronts (regcore.smooth_ways). The scale is applied at the store.

#include "fft_smooth.cuh"
#include "regs_kernels.cuh"

namespace offt {

cudaError_t axis_smooth7x3(const float* xr, const float* xi, float* yr,
                           float* yi, const float2* tab, const AxisGeom& g,
                           int n, int inverse, float scale, int tile,
                           cudaStream_t s) {
  return regs::axis_smooth7_parts<21, 63, 147, 189, 441, 567>(
      xr, xi, yr, yi, tab, g, n, inverse, scale, tile, s);
}

}  // namespace offt
