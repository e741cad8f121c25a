// fft_last_mix.cu: the row kernel of fft_last.cu at the mixed lengths
// N = R0 2^k, R0 = 3 or 5: 3 2^k in [48, 1536] and 3072, 5 2^k in
// [80, 2560], on the register core's rows (regs::rows_mix).
//
// Replaces, at those lengths, the dense core of two Pallas kernels'
// ports behind their C entry points: offt_tpu/kernels/pallas_fft.py
// fft_last (:819; fft_last.cu) and the z pass of fft_slab_yz (:1404;
// fft_slab.cu, two grids). A source of its own so that nvcc builds these
// instances beside the others.
//
// What bounds it on Hopper: one read and one write of the rows, 16 bytes
// a complex element. Design (fft_regs.cuh, MixRowGeo): V = 4 R0 values a
// thread, P = N / V threads a row, 256 / P rows a block (the ragged last
// block masked); radix-4 passes (one radix 2 where log2 P is odd) and a
// last pass of radix V (a Good-Thomas 3 x 4 or 5 x 4 network with
// constant roots) leaving element t + r P in natural order, stored
// coalesced; loads of element t + q P + r N/4, a warp on consecutive
// floats. The exchange planes are swizzled (MixRowGeo::at, row_mask):
// one wavefront for every put and get, at 3072 too (P = 256, one row a
// block), where the column variant's pad would take two. The scale is
// applied at the store. Rows of P = 4 (48, 80) load and store runs of 16
// bytes a row: no stage, as the power-of-two rows of fewer than 8 threads
// have.

#include "regs_kernels.cuh"

namespace offt {

cudaError_t last_mix(const float* xr, const float* xi, float* yr, float* yi,
                     const float2* tab, long long rows, int n,
                     long long ipitch, long long opitch, int inverse,
                     float scale, cudaStream_t s) {
  auto run = [&](auto nc) {
    constexpr int N = decltype(nc)::value;
    return inverse ? regs::launch_rows_mix<N, true>(xr, xi, yr, yi, tab, rows,
                                                    ipitch, opitch, scale, s)
                   : regs::launch_rows_mix<N, false>(xr, xi, yr, yi, tab,
                                                     rows, ipitch, opitch,
                                                     scale, s);
  };
  return n % 3 == 0 ? regs::by_mixed<3, 48, 3072>(n, run)
                    : regs::by_mixed<5>(n, run);
}

}  // namespace offt
