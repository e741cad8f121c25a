// real_slab_mix.cu: the y pass of irfft_slab.cu's two grids at a mixed
// Y = R0 2^k, R0 = 3 or 5, 16 <= 2^k <= 512 (48-1536 and 80-2560): the
// inverse column variant at the mixed lengths (regs::cols_mix) with the
// c2r's Nyquist side plane, from the pitched packed input (P, Y, M + pad)
// into the wrapper's planar (P, Y, M) scratch, unscaled.
//
// Replaces, at those Y, the dense core's y pass of the port of
// offt_tpu/kernels/pallas_fft.py irfft_slab_yz (:2160, _crfft_slab_kernel
// :2092), behind irfft_slab.cu's C entry point. A source of its own so
// that nvcc builds these instances beside the others; the r2c slab's y
// pass at a mixed Y is axis_mix (fft_axis_mix.cu) itself, and the rows of
// both slabs at a mixed M are those of real_rows_mix.cu.
//
// What bounds it on Hopper: one read of the input's first M lanes and one
// write of the scratch, 8 bytes each a complex element. Design: cols_mix
// as the strided-axis kernel runs it (fft_axis_mix.cu: V = 4 R0 values a
// thread, radix-4 passes then one of radix 12 or 20), on the lane tile it
// routes (mix_col_threads), the input and output strides of AxisGeom
// apart; where side_r is not null, lane 0 of each x-row takes
// + i (side_r + i side_i)[b Y + e] as it loads element e, as cols_c2c does
// at a power of two.

#include "regs_kernels.cuh"

namespace offt {

cudaError_t axis_mix_side(const float* xr, const float* xi, float* yr,
                          float* yi, const float2* tab, const AxisGeom& g,
                          int n, const float* side_r, const float* side_i,
                          cudaStream_t s) {
  auto run = [&](auto nc) {
    constexpr int N = decltype(nc)::value;
    constexpr int NT = regs::mix_col_threads(regs::MixGeo<N>::P);
    return regs::launch_cols_mix<N, true, NT, true>(xr, xi, yr, yi, tab, g,
                                                     1.f, s, side_r, side_i);
  };
  return n % 3 == 0 ? regs::by_mixed<3>(n, run) : regs::by_mixed<5>(n, run);
}

}  // namespace offt
