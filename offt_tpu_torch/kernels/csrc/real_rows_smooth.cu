// real_rows_smooth.cu: the real rows of rfft_last.cu and icrfft_last.cu at
// the first family's smooth half lengths M = R 2^K, odd part R of 9, 15,
// 25 or 45 (K >= 3, M <= 4096: 72-2304, 120-3840, 200-3200, 360-2880):
// the instances of real_rows_smooth.cuh's rows_r2c_smooth and
// rows_c2r_smooth there (P = M / 12 or M / 20 >= 6 threads a row: no
// stage), reached through rfft_smooth and icrfft_smooth. The second
// family's are real_rows_smooth3.cu's and real_rows_smooth5.cu's.
//
// Replaces, at those M, the dense core of two Pallas kernels' ports
// behind their C entry points: offt_tpu/kernels/pallas_fft.py
// rfft_last_planar (:1685; rfft_last.cu) and icrfft_last_planar (:2308;
// icrfft_last.cu). A source of its own so that nvcc builds these
// instances beside the others. What bounds them and their design:
// real_rows_smooth.cuh.

#include "real_rows_smooth.cuh"

namespace offt {

cudaError_t rfft_smooth(const float* x, float* yr, float* yi,
                        const float2* tab, const float2* w, long long rows,
                        int m, float scale, int packed, long long opitch,
                        cudaStream_t s) {
  if (opitch < m + !packed) return cudaErrorInvalidValue;
  return regs::by_smooth(m, [&](auto mc) {
    return regs::launch_rows_r2c_smooth<decltype(mc)::value>(
        x, yr, yi, tab, w, rows, scale, packed, opitch, s);
  });
}

cudaError_t icrfft_smooth(const float* xr, const float* xi, float* out,
                          const float2* tab, const float2* ab, long long rows,
                          int m, cudaStream_t s) {
  return regs::by_smooth(m, [&](auto mc) {
    return regs::launch_rows_c2r_smooth<decltype(mc)::value>(
        xr, xi, out, tab, ab, rows, s);
  });
}

}  // namespace offt
