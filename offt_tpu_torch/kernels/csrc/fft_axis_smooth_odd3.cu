// fft_axis_smooth_odd3.cu: the strided-axis kernel of fft_axis.cu at the
// third family of fft_smooth.cuh, the odd and twice-odd 5-smooth lengths R
// 2^K (K = 0, 1), with R0 = 3 and at most 128 threads a line (18, 27, 30,
// 45, 54, 81, 90, 135, 162, 243, 270, 405, 486, 729, 810, 1215, 1458, 2430;
// 2187, 3645 stay on the dense core), on the register core's column variant
// of fft_smooth.cuh (regs::cols_smooth).
//
// Replaces, at those lengths, the dense core of the same four Pallas kernels
// (offt_tpu/kernels/pallas_fft.py fft_sublane :900, _sublane_nd :993,
// fft_x_from_padded :1509, fft_x_to_padded :1574) behind the C entry point
// of fft_axis.cu, and the y pass of fft_slab_yz (:1404; fft_slab.cu, two
// grids). A source of its own (and one for R0 = 5) so that nvcc builds these
// instances beside the others.
//
// What bounds it on Hopper: as fft_axis.cu, one read and one write of the
// planar pair. Design (fft_smooth.cuh): the passes of the rows
// (fft_last_smooth_odd3.cu) on P = N / V0 threads a line; one lane tile, L =
// 32 lanes a block up to 768 threads, 16 above, 8 above 1536 (the wide
// tile's code, 1: fused_fft._axis_tile); the planes unpadded (no radix-4
// pass), every put and get one wavefront at L = 32, two at most at L = 16
// and 8 (regcore.smooth_ways). The scale is applied at the store.

#include "fft_smooth.cuh"
#include "regs_kernels.cuh"

namespace offt {

cudaError_t axis_smooth_odd3(const float* xr, const float* xi, float* yr,
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
    case 9:
      return regs::by_smooth_odd_twice<9, true>(n, run);
    case 15:
      return regs::by_smooth_odd_twice<15, true>(n, run);
    case 27:
      return regs::by_smooth_odd_twice<27, true>(n, run);
    case 45:
      return regs::by_smooth_odd_twice<45, true>(n, run);
    case 81:
      return regs::by_smooth_odd_twice<81, true>(n, run);
    case 135:
      return regs::by_smooth_odd_twice<135, true>(n, run);
    case 243:
      return regs::by_smooth_odd_twice<243, true>(n, run);
    case 405:
      return regs::by_smooth_odd_twice<405, true>(n, run);
    case 729:
      return regs::by_smooth_odd_twice<729, true>(n, run);
    case 1215:
      return regs::by_smooth_odd_twice<1215, true>(n, run);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace offt
