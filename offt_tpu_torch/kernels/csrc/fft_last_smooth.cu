// fft_last_smooth.cu: the row kernel of fft_last.cu at the 5-smooth
// lengths N = R 2^K with an odd part R of 9, 15, 25 or 45 (K >= 3, N <=
// 4096: 72-2304, 120-3840, 200-3200, 360-2880), on the register core of
// fft_smooth.cuh (regs::rows_smooth).
//
// Replaces, at those lengths, the dense core of two Pallas kernels' ports
// behind their C entry points: offt_tpu/kernels/pallas_fft.py fft_last
// (:819; fft_last.cu) and the z pass of fft_slab_yz (:1404; fft_slab.cu,
// two grids). A source of its own so that nvcc builds these instances
// beside the others.
//
// What bounds it on Hopper: one read and one write of the rows, 16 bytes
// a complex element. Design (fft_smooth.cuh): V0 = 12 values a thread (20
// at an odd part 25), P = N / V0 threads a row, not a power of two, and
// 256 / P rows a block (one row from P = 256: 3840, 320 threads); radix-4
// passes (one radix 2 where K is odd), one radix-3 or radix-5 pass per
// further odd factor (the radix-5 pass at V0 = 12 three butterflies a
// thread, the third masked: 15 values at most), then one of radix V0
// leaving element t + r P in natural order, stored coalesced; loads of
// element t + q P + r N / R, a warp on consecutive floats of its rows. The
// rows' planes are unpadded at a pitch of P mod 32 floats: every get takes
// one wavefront, the strided puts up to four (regcore.smooth_ways). The
// scale is applied at the store.

#include "fft_smooth.cuh"
#include "regs_kernels.cuh"

namespace offt {

cudaError_t last_smooth(const float* xr, const float* xi, float* yr,
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
  return regs::by_smooth(n, run);
}

}  // namespace offt
