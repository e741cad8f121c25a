// fft_last_smooth_odd5.cu: the row kernel of fft_last.cu at the third family
// of fft_smooth.cuh, the odd and twice-odd 5-smooth lengths R 2^K (K = 0,
// 1), with R0 = 5 (25, 50, 75, 125, 150, 225, 250, 375, 450, 625, 675, 750,
// 1125, 1250, 1350, 1875, 2025, 2250, 3125, 3375, 3750, 4050; 22 lengths),
// on the register core of fft_smooth.cuh (regs::rows_smooth).
//
// Replaces, at those lengths, the dense core of two Pallas kernels' ports
// behind their C entry points: offt_tpu/kernels/pallas_fft.py fft_last
// (:819; fft_last.cu) and the z pass of fft_slab_yz (:1404; fft_slab.cu, two
// grids). A source of its own (and one for R0 = 3) so that nvcc builds these
// instances beside the others.
//
// What bounds it on Hopper: one read and one write of the rows, 16 bytes a
// complex element. Design (fft_smooth.cuh): V0 = 2^K d values a thread
// (regs::smooth_odd_v0: d of 3, 5, 9, 15, 25 dividing R, V0 <= 30), P = N /
// V0 threads a row (1-243, odd), 256 / P rows a block; no radix-4 pass: one
// radix-3 or radix-5 pass per prime factor of R / d (masked where it does
// not divide V0), then one of radix V0 (3, 5, 9, 15, 25, 6, 10, 18, 30:
// regs::dft_split's Good-Thomas or Cooley-Tukey network) leaving element t +
// r P in natural order, stored coalesced; the rows' planes at the pitch of
// regs::smooth_row_pitch (every get one wavefront at P mod 32, two at the 14
// lengths of P = 3-27 where another residue costs less; the puts one to
// four, four at 675 and 1350: no pitch holds them to two,
// regcore.smooth_ways); rows of fewer than 6 threads (25, 50, 75, 125, 150)
// staged through the planes, in and out whole (SmoothRowGeo::STAGE). The
// scale is applied at the store.

#include "fft_smooth.cuh"
#include "regs_kernels.cuh"

namespace offt {

cudaError_t last_smooth_odd5(const float* xr, const float* xi, float* yr,
                             float* yi, const float2* tab, long long rows,
                             int n, long long ipitch, long long opitch,
                             int inverse, float scale, cudaStream_t s) {
  auto run = [&](auto nc) {
    constexpr int N = decltype(nc)::value;
    return inverse ? regs::launch_rows_smooth<N, true>(
                         xr, xi, yr, yi, tab, rows, ipitch, opitch, scale, s)
                   : regs::launch_rows_smooth<N, false>(
                         xr, xi, yr, yi, tab, rows, ipitch, opitch, scale, s);
  };
  switch (regs::odd_part(n)) {
    case 25:
      return regs::by_smooth_odd_twice<25>(n, run);
    case 75:
      return regs::by_smooth_odd_twice<75>(n, run);
    case 125:
      return regs::by_smooth_odd_twice<125>(n, run);
    case 225:
      return regs::by_smooth_odd_twice<225>(n, run);
    case 375:
      return regs::by_smooth_odd_twice<375>(n, run);
    case 625:
      return regs::by_smooth_odd_twice<625>(n, run);
    case 675:
      return regs::by_smooth_odd_twice<675>(n, run);
    case 1125:
      return regs::by_smooth_odd_twice<1125>(n, run);
    case 1875:
      return regs::by_smooth_odd_twice<1875>(n, run);
    case 2025:
      return regs::by_smooth_odd_twice<2025>(n, run);
    case 3125:
      return regs::by_smooth_odd_twice<3125>(n, run);
    case 3375:
      return regs::by_smooth_odd_twice<3375>(n, run);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace offt
