// fft_last_smooth3.cu: the row kernel of fft_last.cu at the second family
// of fft_smooth.cuh with R0 = 3 (V0 = 12 values a thread): 12, 24, 36, 60,
// 180 and the odd parts 27, 81, 135, 243, 405 and 729 (108-3888; 24
// lengths), on the register core of fft_smooth.cuh (regs::rows_smooth).
//
// Replaces, at those lengths, the dense core of two Pallas kernels' ports
// behind their C entry points: offt_tpu/kernels/pallas_fft.py fft_last
// (:819; fft_last.cu) and the z pass of fft_slab_yz (:1404; fft_slab.cu,
// two grids). A source of its own (and one for R0 = 5) so that nvcc
// builds these instances beside the others.
//
// What bounds it on Hopper: one read and one write of the rows, 16 bytes
// a complex element. Design (fft_smooth.cuh, as fft_last_smooth.cu): P =
// N / 12 threads a row, 256 / P rows a block; radix-4 passes (none at K
// = 2, one radix 2 where K is odd), one radix-3 or radix-5 pass per
// further odd factor (masked where the radix does not divide 12), then one
// of radix 12 leaving element t + r P in natural order, stored coalesced;
// the rows' planes at the pitch of regs::smooth_row_pitch; rows of fewer
// than 6 threads (12-100) staged through the planes, in and out whole
// (SmoothRowGeo::STAGE). The scale is applied at the store.

#include "fft_smooth.cuh"
#include "regs_kernels.cuh"

namespace offt {

cudaError_t last_smooth3(const float* xr, const float* xi, float* yr,
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
    case 3:
      return regs::by_smooth_more_odd<3>(n, run);
    case 9:
      return regs::by_smooth_more_odd<9>(n, run);
    case 15:
      return regs::by_smooth_more_odd<15>(n, run);
    case 27:
      return regs::by_smooth_more_odd<27>(n, run);
    case 45:
      return regs::by_smooth_more_odd<45>(n, run);
    case 81:
      return regs::by_smooth_more_odd<81>(n, run);
    case 135:
      return regs::by_smooth_more_odd<135>(n, run);
    case 243:
      return regs::by_smooth_more_odd<243>(n, run);
    case 405:
      return regs::by_smooth_more_odd<405>(n, run);
    case 729:
      return regs::by_smooth_more_odd<729>(n, run);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace offt
