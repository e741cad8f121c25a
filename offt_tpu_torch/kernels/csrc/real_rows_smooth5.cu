// real_rows_smooth5.cu: the real rows of rfft_last.cu and icrfft_last.cu
// at the second family's smooth half lengths M with R0 = 5 (V0 = 20 values
// a thread): 20, 40, 100 and the odd parts 75, 125, 225, 375, 625 and 675
// (300-4000; 18 half lengths): the instances of real_rows_smooth.cuh's
// rows_r2c_smooth and rows_c2r_smooth there, reached through
// rfft_smooth5 and icrfft_smooth5 (regs_kernels.cuh's rfft_smooth_more
// and icrfft_smooth_more pick the source by R0).
//
// Replaces, at those M, the dense core of two Pallas kernels' ports
// behind their C entry points: offt_tpu/kernels/pallas_fft.py
// rfft_last_planar (:1685; rfft_last.cu) and icrfft_last_planar (:2308;
// icrfft_last.cu). A source of its own (and one for R0 = 3) so that
// nvcc builds these instances beside the others. What bounds them and
// their design: real_rows_smooth.cuh (rows of fewer than 6 threads staged
// through the planes).

#include "real_rows_smooth.cuh"

namespace offt {
namespace {

// f(std::integral_constant<int, M>) at an M of this source; an error at
// any other
template <typename F>
cudaError_t by_smooth5(int m, F&& f) {
  switch (regs::odd_part(m)) {
    case 5:
      return regs::by_smooth_more_odd<5>(m, f);
    case 25:
      return regs::by_smooth_more_odd<25>(m, f);
    case 75:
      return regs::by_smooth_more_odd<75>(m, f);
    case 125:
      return regs::by_smooth_more_odd<125>(m, f);
    case 225:
      return regs::by_smooth_more_odd<225>(m, f);
    case 375:
      return regs::by_smooth_more_odd<375>(m, f);
    case 625:
      return regs::by_smooth_more_odd<625>(m, f);
    case 675:
      return regs::by_smooth_more_odd<675>(m, f);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t rfft_smooth5(const float* x, float* yr, float* yi,
                         const float2* tab, const float2* w, long long rows,
                         int m, float scale, int packed, long long opitch,
                         cudaStream_t s) {
  if (opitch < m + !packed) return cudaErrorInvalidValue;
  return by_smooth5(m, [&](auto mc) {
    return regs::launch_rows_r2c_smooth<decltype(mc)::value>(
        x, yr, yi, tab, w, rows, scale, packed, opitch, s);
  });
}

cudaError_t icrfft_smooth5(const float* xr, const float* xi, float* out,
                           const float2* tab, const float2* ab,
                           long long rows, int m, cudaStream_t s) {
  return by_smooth5(m, [&](auto mc) {
    return regs::launch_rows_c2r_smooth<decltype(mc)::value>(
        xr, xi, out, tab, ab, rows, s);
  });
}

}  // namespace offt
