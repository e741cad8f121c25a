// real_rows_smooth_odd3.cu: the real rows of rfft_last.cu and icrfft_last.cu
// at the third family's half lengths M (the odd and twice-odd 5-smooth M =
// R 2^K, K = 0, 1, fft_smooth.cuh's smooth_odd_length) with R0 = 3: 18,
// 27, 30, 45, 54, 81, 90, 135, 162, 243, 270, 405, 486, 729, 810, 1215,
// 1458, 2187, 2430, 3645 (20 half lengths): the instances of
// real_rows_smooth.cuh's rows_r2c_smooth and rows_c2r_smooth there, reached
// through rfft_smooth_odd3 and icrfft_smooth_odd3 (regs_kernels.cuh's
// rfft_smooth_odd and icrfft_smooth_odd pick the source by R0).
//
// Replaces, at those M, the dense core of two Pallas kernels' ports
// behind their C entry points: offt_tpu/kernels/pallas_fft.py
// rfft_last_planar (:1685; rfft_last.cu) and icrfft_last_planar (:2308;
// icrfft_last.cu). A source of its own (and one for R0 = 5) so that
// nvcc builds these instances beside the others. What bounds them and
// their design: real_rows_smooth.cuh (V0 = 2^K d values a thread,
// regs::smooth_odd_v0; at an odd M the untangle's last pairs on one masked
// step; rows of fewer than 6 threads, 18-90 here, staged through the
// planes).

#include "real_rows_smooth.cuh"

namespace offt {
namespace {

// f(std::integral_constant<int, M>) at an M of this source; an error at
// any other
template <typename F>
cudaError_t by_smooth_odd3(int m, F&& f) {
  switch (regs::odd_part(m)) {
    case 9:
      return regs::by_smooth_odd_twice<9>(m, f);
    case 15:
      return regs::by_smooth_odd_twice<15>(m, f);
    case 27:
      return regs::by_smooth_odd_twice<27>(m, f);
    case 45:
      return regs::by_smooth_odd_twice<45>(m, f);
    case 81:
      return regs::by_smooth_odd_twice<81>(m, f);
    case 135:
      return regs::by_smooth_odd_twice<135>(m, f);
    case 243:
      return regs::by_smooth_odd_twice<243>(m, f);
    case 405:
      return regs::by_smooth_odd_twice<405>(m, f);
    case 729:
      return regs::by_smooth_odd_twice<729>(m, f);
    case 1215:
      return regs::by_smooth_odd_twice<1215>(m, f);
    case 2187:
      return regs::by_smooth_odd_twice<2187>(m, f);
    case 3645:
      return regs::by_smooth_odd_twice<3645>(m, f);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t rfft_smooth_odd3(const float* x, float* yr, float* yi,
                             const float2* tab, const float2* w,
                             long long rows, int m, float scale, int packed,
                             long long opitch, cudaStream_t s) {
  if (opitch < m + !packed) return cudaErrorInvalidValue;
  return by_smooth_odd3(m, [&](auto mc) {
    return regs::launch_rows_r2c_smooth<decltype(mc)::value>(
        x, yr, yi, tab, w, rows, scale, packed, opitch, s);
  });
}

cudaError_t icrfft_smooth_odd3(const float* xr, const float* xi, float* out,
                               const float2* tab, const float2* ab,
                               long long rows, int m, cudaStream_t s) {
  return by_smooth_odd3(m, [&](auto mc) {
    return regs::launch_rows_c2r_smooth<decltype(mc)::value>(
        xr, xi, out, tab, ab, rows, s);
  });
}

}  // namespace offt
