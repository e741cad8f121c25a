// fft_axis_mix.cu: the strided-axis kernel of fft_axis.cu at the mixed
// lengths N = R0 2^k, R0 = 3 or 5, 16 <= 2^k <= 512 (48-1536 and
// 80-2560), on the register core's column variant (regs::cols_mix).
//
// Replaces, at those lengths, the dense core of the same four Pallas
// kernels (offt_tpu/kernels/pallas_fft.py fft_sublane :900, _sublane_nd
// :993, fft_x_from_padded :1509, fft_x_to_padded :1574), behind the C
// entry point of fft_axis.cu. A source of its own so that nvcc builds
// these instances beside the power-of-two ones, not after them.
//
// What bounds it on Hopper: as fft_axis.cu, one read and one write of the
// planar pair. Design (fft_regs.cuh, MixGeo): V = 4 R0 values a thread,
// P = N / V threads a line, radix-4 passes (one radix 2 where log2 P is
// odd) and a last pass of radix V (a Good-Thomas 3 x 4 or 5 x 4 network
// with constant roots), the exchange planes padded one slot per four
// elements; lane tiles as at powers of two, picked by P
// (fused_fft._axis_tile): narrow, 256 threads, to P = 8 (96, 160: 32
// lanes; 48, 80: 64); wide, 32 lanes a block up to 1024 threads, from
// P = 16 (192, 320: 512 threads; 384, 640: 1024; 768, 1280: 16 lanes;
// 1536, 2560: 8 lanes). The scale is applied at the store. At 320 (20
// values a thread, 512 threads, 64 registers) ptxas spills 8 bytes; the
// two spill-free layouts, one block an SM at 105 registers and the narrow
// tile at 80, ran the 320^3 x pass 9% and 7% slower on an H100
// (PERF.md), so the wide tile stays.

#include "regs_kernels.cuh"

namespace offt {
namespace {

template <int N, bool INV>
cudaError_t axis_mix_n(const float* xr, const float* xi, float* yr,
                       float* yi, const float2* tab, const AxisGeom& g,
                       float scale, int tile, cudaStream_t s) {
  using namespace regs;
  constexpr int P = MixGeo<N>::P;
  // the tile codes of fft_axis.cu's AxisTile: 0 narrow, 1 wide
  constexpr int kTile = P <= 8 ? 0 : 1;
  constexpr int NT = P <= 8 ? kThreads : 32 * P < 1024 ? 32 * P : 1024;
  if (tile >= 0 && tile != kTile) return cudaErrorInvalidValue;
  return launch_cols_mix<N, INV, NT>(xr, xi, yr, yi, tab, g, scale, s);
}

}  // namespace

// The register core at a mixed length n (fft_axis.cu's reg branch, the
// y pass of fft_slab.cu): the first n table rows, `inverse`, `scale` and
// `tile` are read.
cudaError_t axis_mix(const float* xr, const float* xi, float* yr, float* yi,
                     const float2* tab, const AxisGeom& g, int n,
                     int inverse, float scale, int tile, cudaStream_t s) {
  auto run = [&](auto nc) {
    constexpr int N = decltype(nc)::value;
    return inverse ? axis_mix_n<N, true>(xr, xi, yr, yi, tab, g, scale,
                                         tile, s)
                   : axis_mix_n<N, false>(xr, xi, yr, yi, tab, g, scale,
                                          tile, s);
  };
  return n % 3 == 0 ? regs::by_mixed<3>(n, run) : regs::by_mixed<5>(n, run);
}

}  // namespace offt
