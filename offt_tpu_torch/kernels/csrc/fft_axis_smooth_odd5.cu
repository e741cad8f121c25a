// fft_axis_smooth_odd5.cu: the strided-axis kernel of fft_axis.cu at the
// third family of fft_smooth.cuh, the odd and twice-odd 5-smooth lengths R
// 2^K (K = 0, 1), with R0 = 5 and at most 128 threads a line (25, 50, 75,
// 125, 150, 225, 250, 375, 450, 625, 675, 750, 1125, 1250, 1350, 1875, 2025,
// 2250, 3125; 3375, 3750, 4050 stay on the dense core), on the register
// core's column variant of fft_smooth.cuh (regs::cols_smooth).
//
// Replaces, at those lengths, the dense core of the same four Pallas kernels
// (offt_tpu/kernels/pallas_fft.py fft_sublane :900, _sublane_nd :993,
// fft_x_from_padded :1509, fft_x_to_padded :1574) behind the C entry point
// of fft_axis.cu, and the y pass of fft_slab_yz (:1404; fft_slab.cu, two
// grids). A source of its own (and one for R0 = 3) so that nvcc builds these
// instances beside the others.
//
// What bounds it on Hopper: as fft_axis.cu, one read and one write of the
// planar pair. Design (fft_smooth.cuh): the passes of the rows
// (fft_last_smooth_odd5.cu) on P = N / V0 threads a line; one lane tile, L =
// 32 lanes a block up to 768 threads, 16 above, 8 above 1536 (the wide
// tile's code, 1: fused_fft._axis_tile); the planes unpadded (no radix-4
// pass), every put and get one wavefront at L = 32, two at most at L = 16
// and 8 (regcore.smooth_ways). The scale is applied at the store.

#include "fft_smooth.cuh"
#include "regs_kernels.cuh"

namespace offt {

cudaError_t axis_smooth_odd5(const float* xr, const float* xi, float* yr,
                             float* yi, const float2* tab, const AxisGeom& g,
                             int n, int inverse, float scale, int tile,
                             cudaStream_t s) {
  // the one tile: fft_axis.cu's AxisTile kWide, or -1 (the routed one)
  if (tile >= 0 && tile != 1) return cudaErrorInvalidValue;
  auto run = [&](auto nc) {
    constexpr int N = decltype(nc)::value;
    return inverse ? regs::launch_cols_smooth<N, true>(xr, xi, yr, yi, tab, g,
                                                       scale, s)
                   : regs::launch_cols_smooth<N, false>(xr, xi, yr, yi, tab,
                                                        g, scale, s);
  };
  // the column lengths: at most 128 threads a line, the planes within a
  // block's shared memory (regs::smooth_odd_col)
  switch (regs::odd_part(n)) {
    case 25:
      return regs::by_smooth_odd_twice<25, true>(n, run);
    case 75:
      return regs::by_smooth_odd_twice<75, true>(n, run);
    case 125:
      return regs::by_smooth_odd_twice<125, true>(n, run);
    case 225:
      return regs::by_smooth_odd_twice<225, true>(n, run);
    case 375:
      return regs::by_smooth_odd_twice<375, true>(n, run);
    case 625:
      return regs::by_smooth_odd_twice<625, true>(n, run);
    case 675:
      return regs::by_smooth_odd_twice<675, true>(n, run);
    case 1125:
      return regs::by_smooth_odd_twice<1125, true>(n, run);
    case 1875:
      return regs::by_smooth_odd_twice<1875, true>(n, run);
    case 2025:
      return regs::by_smooth_odd_twice<2025, true>(n, run);
    case 3125:
      return regs::by_smooth_odd_twice<3125, true>(n, run);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace offt
