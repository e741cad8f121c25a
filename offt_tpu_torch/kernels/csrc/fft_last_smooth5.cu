// fft_last_smooth5.cu: the row kernel of fft_last.cu at the second family
// of fft_smooth.cuh with R0 = 5 (V0 = 20 values a thread): 20, 40, 100 and
// the odd parts 75, 125, 225, 375, 625 and 675 (300-4000; 18 lengths), on
// the register core of fft_smooth.cuh (regs::rows_smooth).
//
// Replaces, at those lengths, the dense core of two Pallas kernels' ports
// behind their C entry points: offt_tpu/kernels/pallas_fft.py fft_last
// (:819; fft_last.cu) and the z pass of fft_slab_yz (:1404; fft_slab.cu,
// two grids). A source of its own (and one for R0 = 3) so that nvcc
// builds these instances beside the others.
//
// What bounds it on Hopper: one read and one write of the rows, 16 bytes
// a complex element. Design (fft_smooth.cuh, as fft_last_smooth.cu): P =
// N / 20 threads a row, 256 / P rows a block; radix-4 passes (none at K
// = 2, one radix 2 where K is odd), one radix-3 or radix-5 pass per
// further odd factor (masked where the radix does not divide 20), then one
// of radix 20 leaving element t + r P in natural order, stored coalesced;
// the rows' planes at the pitch of regs::smooth_row_pitch; rows of fewer
// than 6 threads (12-100) staged through the planes, in and out whole
// (SmoothRowGeo::STAGE). The scale is applied at the store.

#include "fft_smooth.cuh"
#include "regs_kernels.cuh"

namespace offt {

cudaError_t last_smooth5(const float* xr, const float* xi, float* yr,
                         float* yi, const float2* tab, long long rows, int n,
                         long long ipitch, long long opitch, int inverse,
                         float scale, cudaStream_t s) {
  auto run = [&](auto nc) {
    constexpr int N = decltype(nc)::value;
    return inverse ? regs::launch_rows_smooth<N, true>(
                         xr, xi, yr, yi, tab, rows, ipitch, opitch, scale, s)
                   : regs::launch_rows_smooth<N, false>(
                         xr, xi, yr, yi, tab, rows, ipitch, opitch, scale, s);
  };
  switch (regs::odd_part(n)) {
    case 5:
      return regs::by_smooth_more_odd<5>(n, run);
    case 25:
      return regs::by_smooth_more_odd<25>(n, run);
    case 75:
      return regs::by_smooth_more_odd<75>(n, run);
    case 125:
      return regs::by_smooth_more_odd<125>(n, run);
    case 225:
      return regs::by_smooth_more_odd<225>(n, run);
    case 375:
      return regs::by_smooth_more_odd<375>(n, run);
    case 625:
      return regs::by_smooth_more_odd<625>(n, run);
    case 675:
      return regs::by_smooth_more_odd<675>(n, run);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace offt
