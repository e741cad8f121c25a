// fft_axis_smooth.cu: the strided-axis kernel of fft_axis.cu at the
// 5-smooth lengths N = R 2^K with an odd part R of 9, 15, 25 or 45 and at
// most 128 threads a line (72-1152, 120-960, 200-1600, 360-1440), on the
// register core's column variant of fft_smooth.cuh (regs::cols_smooth).
//
// Replaces, at those lengths, the dense core of the same four Pallas
// kernels (offt_tpu/kernels/pallas_fft.py fft_sublane :900, _sublane_nd
// :993, fft_x_from_padded :1509, fft_x_to_padded :1574) behind the C entry
// point of fft_axis.cu, and the y pass of fft_slab_yz (:1404; fft_slab.cu,
// two grids). A source of its own so that nvcc builds these instances
// beside the others.
//
// What bounds it on Hopper: as fft_axis.cu, one read and one write of the
// planar pair. Design (fft_smooth.cuh): the passes of the rows
// (fft_last_smooth.cu) on P = N / V0 threads a line; one lane tile, L = 32
// lanes a block up to 768 threads, 16 above, 8 above 1536 (the wide tile's
// code, 1: fused_fft._axis_tile), so a warp moves runs of L consecutive
// floats (32 or 64 bytes) and holds at most four row threads; the planes
// padded one slot per four elements, every put and get one wavefront
// (regcore.smooth_ways). Lengths of more than 128 threads a line (1920,
// 2304, 2880, 3200, 3840: 4 lanes, eight row threads a warp) would take two
// wavefronts and stay on the dense core. The scale is applied at the
// store.

#include "fft_smooth.cuh"
#include "regs_kernels.cuh"

namespace offt {

cudaError_t axis_smooth(const float* xr, const float* xi, float* yr,
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
    case 9:
      return regs::by_smooth_odd<9, 1152>(n, run);
    case 15:
      return regs::by_smooth_odd<15, 960>(n, run);
    case 25:
      return regs::by_smooth_odd<25, 1600>(n, run);
    case 45:
      return regs::by_smooth_odd<45, 1440>(n, run);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace offt
