// fft_axis_smooth3.cu: the strided-axis kernel of fft_axis.cu at the
// second family of fft_smooth.cuh with R0 = 3 (V0 = 12 values a thread)
// and at most 128 threads a line (12-1296; 1620, 1728, 1944, 2160, 2592,
// 2916, 3240, 3456 and 3888 stay on the dense core), on the register
// core's column variant of fft_smooth.cuh (regs::cols_smooth).
//
// Replaces, at those lengths, the dense core of the same four Pallas
// kernels (offt_tpu/kernels/pallas_fft.py fft_sublane :900, _sublane_nd
// :993, fft_x_from_padded :1509, fft_x_to_padded :1574) behind the C entry
// point of fft_axis.cu, and the y pass of fft_slab_yz (:1404; fft_slab.cu,
// two grids). A source of its own (and one for R0 = 5) so that nvcc
// builds these instances beside the others.
//
// What bounds it on Hopper: as fft_axis.cu, one read and one write of the
// planar pair. Design (fft_smooth.cuh, as fft_axis_smooth.cu): the passes
// of the rows (fft_last_smooth3.cu) on P = N / 12 threads a line; one lane
// tile, L = 32 lanes a block up to 768 threads, 16 above, 8 above 1536
// (the wide tile's code, 1: fused_fft._axis_tile); the planes padded one
// slot per four elements from K = 4, unpadded below, every put and get at
// most two wavefronts (regcore.smooth_ways). The scale is applied at the
// store.

#include "fft_smooth.cuh"
#include "regs_kernels.cuh"

namespace offt {

cudaError_t axis_smooth3(const float* xr, const float* xi, float* yr,
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
  // the column lengths: at most 128 threads a line (SmoothColGeo)
  switch (regs::odd_part(n)) {
    case 3:
      return regs::by_smooth_more_odd<3, 128>(n, run);
    case 9:
      return regs::by_smooth_more_odd<9, 128>(n, run);
    case 15:
      return regs::by_smooth_more_odd<15, 128>(n, run);
    case 27:
      return regs::by_smooth_more_odd<27, 128>(n, run);
    case 45:
      return regs::by_smooth_more_odd<45, 128>(n, run);
    case 81:
      return regs::by_smooth_more_odd<81, 128>(n, run);
    case 135:
      return regs::by_smooth_more_odd<135, 128>(n, run);
    case 243:
      return regs::by_smooth_more_odd<243, 128>(n, run);
    case 405:
      return regs::by_smooth_more_odd<405, 128>(n, run);
    case 729:
      return regs::by_smooth_more_odd<729, 128>(n, run);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace offt
