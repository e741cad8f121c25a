// real_rows_smooth3.cu: the real rows of rfft_last.cu and icrfft_last.cu
// at the second family's smooth half lengths M with R0 = 3 (V0 = 12 values
// a thread): 12, 24, 36, 60, 180 and the odd parts 27, 81, 135, 243, 405
// and 729 (108-3888; 24 half lengths): the instances of
// real_rows_smooth.cuh's rows_r2c_smooth and rows_c2r_smooth there,
// reached through rfft_smooth3 and icrfft_smooth3 (regs_kernels.cuh's
// rfft_smooth_more and icrfft_smooth_more pick the source by R0).
//
// Replaces, at those M, the dense core of two Pallas kernels' ports
// behind their C entry points: offt_tpu/kernels/pallas_fft.py
// rfft_last_planar (:1685; rfft_last.cu) and icrfft_last_planar (:2308;
// icrfft_last.cu). A source of its own (and one for R0 = 5) so that
// nvcc builds these instances beside the others. What bounds them and
// their design: real_rows_smooth.cuh (rows of fewer than 6 threads staged
// through the planes).

#include "real_rows_smooth.cuh"

namespace offt {
namespace {

// f(std::integral_constant<int, M>) at an M of this source; an error at
// any other
template <typename F>
cudaError_t by_smooth3(int m, F&& f) {
  switch (regs::odd_part(m)) {
    case 3:
      return regs::by_smooth_more_odd<3>(m, f);
    case 9:
      return regs::by_smooth_more_odd<9>(m, f);
    case 15:
      return regs::by_smooth_more_odd<15>(m, f);
    case 27:
      return regs::by_smooth_more_odd<27>(m, f);
    case 45:
      return regs::by_smooth_more_odd<45>(m, f);
    case 81:
      return regs::by_smooth_more_odd<81>(m, f);
    case 135:
      return regs::by_smooth_more_odd<135>(m, f);
    case 243:
      return regs::by_smooth_more_odd<243>(m, f);
    case 405:
      return regs::by_smooth_more_odd<405>(m, f);
    case 729:
      return regs::by_smooth_more_odd<729>(m, f);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t rfft_smooth3(const float* x, float* yr, float* yi,
                         const float2* tab, const float2* w, long long rows,
                         int m, float scale, int packed, long long opitch,
                         cudaStream_t s) {
  if (opitch < m + !packed) return cudaErrorInvalidValue;
  return by_smooth3(m, [&](auto mc) {
    return regs::launch_rows_r2c_smooth<decltype(mc)::value>(
        x, yr, yi, tab, w, rows, scale, packed, opitch, s);
  });
}

cudaError_t icrfft_smooth3(const float* xr, const float* xi, float* out,
                           const float2* tab, const float2* ab,
                           long long rows, int m, cudaStream_t s) {
  return by_smooth3(m, [&](auto mc) {
    return regs::launch_rows_c2r_smooth<decltype(mc)::value>(
        xr, xi, out, tab, ab, rows, s);
  });
}

}  // namespace offt
