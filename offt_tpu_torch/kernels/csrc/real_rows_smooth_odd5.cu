// real_rows_smooth_odd5.cu: the real rows of rfft_last.cu and icrfft_last.cu
// at the third family's half lengths M (the odd and twice-odd 5-smooth M =
// R 2^K, K = 0, 1, fft_smooth.cuh's smooth_odd_length) with R0 = 5: 25,
// 50, 75, 125, 150, 225, 250, 375, 450, 625, 675, 750, 1125, 1250, 1350,
// 1875, 2025, 2250, 3125, 3375, 3750, 4050 (22 half lengths): the instances of
// real_rows_smooth.cuh's rows_r2c_smooth and rows_c2r_smooth there, reached
// through rfft_smooth_odd5 and icrfft_smooth_odd5 (regs_kernels.cuh's
// rfft_smooth_odd and icrfft_smooth_odd pick the source by R0).
//
// Replaces, at those M, the dense core of two Pallas kernels' ports
// behind their C entry points: offt_tpu/kernels/pallas_fft.py
// rfft_last_planar (:1685; rfft_last.cu) and icrfft_last_planar (:2308;
// icrfft_last.cu). A source of its own (and one for R0 = 3) so that
// nvcc builds these instances beside the others. What bounds them and
// their design: real_rows_smooth.cuh (V0 = 2^K d values a thread,
// regs::smooth_odd_v0; at an odd M the untangle's last pairs on one masked
// step; rows of fewer than 6 threads, 25-150 here, staged through the
// planes).

#include "real_rows_smooth.cuh"

namespace offt {
namespace {

// f(std::integral_constant<int, M>) at an M of this source; an error at
// any other
template <typename F>
cudaError_t by_smooth_odd5(int m, F&& f) {
  switch (regs::odd_part(m)) {
    case 25:
      return regs::by_smooth_odd_twice<25>(m, f);
    case 75:
      return regs::by_smooth_odd_twice<75>(m, f);
    case 125:
      return regs::by_smooth_odd_twice<125>(m, f);
    case 225:
      return regs::by_smooth_odd_twice<225>(m, f);
    case 375:
      return regs::by_smooth_odd_twice<375>(m, f);
    case 625:
      return regs::by_smooth_odd_twice<625>(m, f);
    case 675:
      return regs::by_smooth_odd_twice<675>(m, f);
    case 1125:
      return regs::by_smooth_odd_twice<1125>(m, f);
    case 1875:
      return regs::by_smooth_odd_twice<1875>(m, f);
    case 2025:
      return regs::by_smooth_odd_twice<2025>(m, f);
    case 3125:
      return regs::by_smooth_odd_twice<3125>(m, f);
    case 3375:
      return regs::by_smooth_odd_twice<3375>(m, f);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

cudaError_t rfft_smooth_odd5(const float* x, float* yr, float* yi,
                             const float2* tab, const float2* w,
                             long long rows, int m, float scale, int packed,
                             long long opitch, cudaStream_t s) {
  if (opitch < m + !packed) return cudaErrorInvalidValue;
  return by_smooth_odd5(m, [&](auto mc) {
    return regs::launch_rows_r2c_smooth<decltype(mc)::value>(
        x, yr, yi, tab, w, rows, scale, packed, opitch, s);
  });
}

cudaError_t icrfft_smooth_odd5(const float* xr, const float* xi, float* out,
                               const float2* tab, const float2* ab,
                               long long rows, int m, cudaStream_t s) {
  return by_smooth_odd5(m, [&](auto mc) {
    return regs::launch_rows_c2r_smooth<decltype(mc)::value>(
        xr, xi, out, tab, ab, rows, s);
  });
}

}  // namespace offt
