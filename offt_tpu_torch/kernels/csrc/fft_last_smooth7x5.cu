// fft_last_smooth7x5.cu: the row kernel of fft_last.cu at the fourth family
// of fft_smooth.cuh, the lengths R 2^K with a factor 7, K >= 2, at R = 3^a
// 5^b 7^c (b, c >= 1: 35, 105, 175, 245, 315, 525, 735, 875, 945; R0 = 5,
// V0 = 20, or R0 = 7, V0 = 28, by regs::smooth7_r0): 140-3920, 21 lengths,
// on the register core of fft_smooth.cuh (regs::rows_smooth).
//
// Replaces, at those lengths, the dense core of two Pallas kernels' ports
// behind their C entry points: offt_tpu/kernels/pallas_fft.py fft_last
// (:819; fft_last.cu) and the z pass of fft_slab_yz (:1404; fft_slab.cu, two
// grids). The fourth family's instances lie in three sources (this one, and
// those of the other odd parts), no more instances in one than the heaviest
// earlier smooth source's, so that nvcc builds them beside the others.
//
// What bounds it on Hopper: one read and one write of the rows, 16 bytes a
// complex element. Design (fft_smooth.cuh, as fft_last_smooth3.cu): P = N /
// V0 threads a row, 256 / P rows a block; radix-4 passes (none at K = 2, one
// radix 2 where K is odd), one radix-R0 pass per further factor R0, then one
// per factor of each other odd prime (masked where the radix does not divide
// V0), then one of radix V0 (the Good-Thomas 3 x 4, 5 x 4 or 7 x 4 network)
// leaving element t + r P in natural order, stored coalesced; the rows'
// planes at the pitch of regs::smooth_row_pitch (no row here is staged:
// each takes 7 threads or more). The scale is applied at the store.

#include "fft_smooth.cuh"
#include "regs_kernels.cuh"

namespace offt {

cudaError_t last_smooth7x5(const float* xr, const float* xi, float* yr,
                           float* yi, const float2* tab, long long rows, int n,
                           long long ipitch, long long opitch, int inverse,
                           float scale, cudaStream_t s) {
  return regs::last_smooth7_parts<35, 105, 175, 245, 315, 525, 735, 875, 945>(
      xr, xi, yr, yi, tab, rows, n, ipitch, opitch, inverse, scale, s);
}

}  // namespace offt
