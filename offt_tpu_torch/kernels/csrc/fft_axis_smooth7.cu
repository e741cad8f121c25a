// fft_axis_smooth7.cu: the strided-axis kernel of fft_axis.cu at the fourth
// family of fft_smooth.cuh, the lengths R 2^K with a factor 7, K >= 2, at
// the powers of 7 (R = 7, 49, 343; R0 = 7, V0 = 28 values a thread) and at
// most 128 threads a line with planes that fit a block (regs::smooth7_col):
// 28, 56, 112, 196, 224, 392, 448, 784, 896, 1372, 1568, 1792, 2744; 3136
// and 3584 stay on the dense core: their padded planes of 245 and 280 KB
// pass a block's shared memory, and unpadded they take four wavefronts an
// exchange, on the register core's column variant of fft_smooth.cuh
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
// (fft_last_smooth7.cu) on P = N / V0 threads a line; one lane tile, L = 32
// lanes a block up to 768 threads, 16 above, 8 above 1536 (the wide tile's
// code, 1: fused_fft._axis_tile); the planes padded one slot per four
// elements from K = 4, unpadded below, every put and get at most two
// wavefronts (regcore.smooth_ways). The scale is applied at the store.

#include "fft_smooth.cuh"
#include "regs_kernels.cuh"

namespace offt {

cudaError_t axis_smooth7(const float* xr, const float* xi, float* yr, float* yi,
                         const float2* tab, const AxisGeom& g, int n,
                         int inverse, float scale, int tile, cudaStream_t s) {
  return regs::axis_smooth7_parts<7, 49, 343>(
      xr, xi, yr, yi, tab, g, n, inverse, scale, tile, s);
}

}  // namespace offt
