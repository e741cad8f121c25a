// fft_last_smooth_odd3.cu: the row kernel of fft_last.cu at the third family
// of fft_smooth.cuh, the odd and twice-odd 5-smooth lengths R 2^K (K = 0,
// 1), with R0 = 3 (18, 27, 30, 45, 54, 81, 90, 135, 162, 243, 270, 405, 486,
// 729, 810, 1215, 1458, 2187, 2430, 3645; 20 lengths), on the register core
// of fft_smooth.cuh (regs::rows_smooth).
//
// Replaces, at those lengths, the dense core of two Pallas kernels' ports
// behind their C entry points: offt_tpu/kernels/pallas_fft.py fft_last
// (:819; fft_last.cu) and the z pass of fft_slab_yz (:1404; fft_slab.cu, two
// grids). A source of its own (and one for R0 = 5) so that nvcc builds these
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
// regcore.smooth_ways); rows of fewer than 6 threads (18, 27, 30, 45, 54,
// 90) staged through the planes, in and out whole (SmoothRowGeo::STAGE). The
// scale is applied at the store.

#include "fft_smooth.cuh"
#include "regs_kernels.cuh"

namespace offt {

cudaError_t last_smooth_odd3(const float* xr, const float* xi, float* yr,
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
    case 9:
      return regs::by_smooth_odd_twice<9>(n, run);
    case 15:
      return regs::by_smooth_odd_twice<15>(n, run);
    case 27:
      return regs::by_smooth_odd_twice<27>(n, run);
    case 45:
      return regs::by_smooth_odd_twice<45>(n, run);
    case 81:
      return regs::by_smooth_odd_twice<81>(n, run);
    case 135:
      return regs::by_smooth_odd_twice<135>(n, run);
    case 243:
      return regs::by_smooth_odd_twice<243>(n, run);
    case 405:
      return regs::by_smooth_odd_twice<405>(n, run);
    case 729:
      return regs::by_smooth_odd_twice<729>(n, run);
    case 1215:
      return regs::by_smooth_odd_twice<1215>(n, run);
    case 2187:
      return regs::by_smooth_odd_twice<2187>(n, run);
    case 3645:
      return regs::by_smooth_odd_twice<3645>(n, run);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace offt
