// fft_axis.cu: c2c along a strided (non-last) axis of planar f32.
//
// Replaces four Pallas kernels of offt_tpu/kernels/pallas_fft.py:
// fft_sublane (:900), _sublane_nd (:993), fft_x_from_padded (:1509) and
// fft_x_to_padded (:1574).
//
// The array is seen as (B, N, Y, Z): batch b, transform index n, and a
// lane l = y * Z + z over the Y * Z positions each transform runs at.
// Element (b, n, y, z) lies at b*sb + n*sn + y*sy + z, with separate
// strides for input and output. So one kernel reads the Z-padded
// intermediate of the slab kernel (sy = Z + pad) and writes the unpadded
// result, writes pitched rows (dropping the c2r's Nyquist lane), runs with
// equal layouts, or runs aliased (in place): every layout reads all of a
// line before it writes any of it, and no two blocks share a line.
//
// What bounds it on Hopper: one read and one write of the planar pair
// (16 bytes per complex element), if a warp's loads and stores move whole
// 32-byte sectors. Two cores, chosen by the wrapper
// (fused_fft._reg_axis):
// - a power-of-two N in [16, 4096] runs the register core's column
//   variant (regs_kernels.cuh): P = N / 16 threads a line hold it in
//   registers, a warp spans consecutive lanes, consecutive blocks take
//   consecutive lanes (one wave of blocks reads whole (y, z) planes), and
//   `scale` is applied at the store. Its lane tile (`tile`, resolved by
//   fused_fft._axis_tile, the one place that picks it):
//   - narrow: a block of 256 threads, L = 256 / P lanes, the layout of
//     the slabs' y pass: 32 lanes or more to N = 128, where the routes
//     launch it; at N = 256 and 1024 (16 and 4 lanes) also a probe
//     (offt_tpu_torch/bench/probe_yconcat.py), forward only;
//   - wide: a block of 32 P threads up to 1024 (N >= 256): 32 lanes to
//     N = 512, 16 at 1024, 8 at 2048, 4 at 4096 (runs of 16 bytes there;
//     a tile of 8 lanes staged through a cluster's shared memory ran
//     level with it and was dropped, PERF.md).
// - the mixed lengths N = R0 2^k, R0 = 3 or 5, 16 <= 2^k <= 512, run the
//   same column variant with 4 R0 values a thread and a last pass of
//   radix 12 or 20 (fft_axis_mix.cu, a source of its own);
// - the 5-smooth lengths with an odd part of 9, 15, 25 or 45 and at most
//   128 threads a line (72-1152, 120-960, 200-1600, 360-1440) run the
//   column variant of fft_smooth.cuh, its one lane tile the wide tile's
//   code (fft_axis_smooth.cu, a source of its own); so do the other
//   5-smooth lengths R 2^k, k >= 2, of at most 128 threads a line (12-2500,
//   fused_fft._SMOOTH_MORE_COL_LENGTHS: fft_axis_smooth3.cu,
//   fft_axis_smooth5.cu), and the odd and twice-odd ones R 2^k, k = 0, 1,
//   of at most 128 threads a line (18-3750, fused_fft.
//   _SMOOTH_ODD_COL_LENGTHS: fft_axis_smooth_odd3.cu,
//   fft_axis_smooth_odd5.cu), and the 7-smooth ones R 2^k, k >= 2, with a
//   factor 7, of at most 128 threads a line and planes that fit a block
//   (28-3528, fused_fft._SMOOTH7_COL_LENGTHS: fft_axis_smooth7.cu,
//   fft_axis_smooth7x3.cu, fft_axis_smooth7x5.cu);
// - every other length runs the dense core of fft_core.cuh: a block owns
//   an (N x T) tile of T consecutive lanes, read column-wise into shared
//   memory; a ragged last tile is masked; the scale rides the table.

#include "fft_core.cuh"
#include "fft_smooth.cuh"
#include "regs_kernels.cuh"

namespace offt {

__global__ void __launch_bounds__(kThreads)
fft_axis_kernel(const float* xr, const float* xi, float* yr, float* yi,
                const float2* __restrict__ tab, AxisGeom g, Core c, int T,
                long long tiles) {
  extern __shared__ float smem[];
  const int n = c.n;
  float* re = smem;
  float* im = smem + (size_t)n * T;
  float2* sroot = reinterpret_cast<float2*>(im + (size_t)n * T);
  load_roots(c, tab, sroot);
  const long long b = blockIdx.x / tiles;
  const long long l = (blockIdx.x - b * tiles) * T + threadIdx.x % T;
  const bool valid = l < g.ny * g.nz;
  const long long y = l / g.nz;
  const long long z = l - y * g.nz;
  load_cols(xr, xi, g.isn, b * g.isb + y * g.isy + z, valid, n, T, re, im);
  core_run(re, im, T, T, c, tab, sroot);
  store_cols(yr, yi, g.osn, b * g.osb + y * g.osy + z, valid, c, T, re, im);
}

// the register core's lane tiles (fused_fft._AXIS_TILES)
enum AxisTile { kNarrow = 0, kWide = 1 };

template <int LOG, bool INV>
static cudaError_t axis_regs(const float* xr, const float* xi, float* yr,
                             float* yi, const float2* tab, const AxisGeom& g,
                             float scale, int tile, cudaStream_t s) {
  using namespace regs;
  // narrow where the routes launch it, and the probe's two lengths
  constexpr bool kNarrowOk = LOG <= 7 || (!INV && (LOG == 8 || LOG == 10));
  if constexpr (kNarrowOk) {
    if (tile == kNarrow)
      return launch_cols<LOG, INV>(xr, xi, yr, yi, tab, g, scale, s);
  }
  if constexpr (LOG >= 8) {
    // 32 lanes a block, at most 1024 threads
    constexpr int P = ColGeo<LOG>::P;
    constexpr int NT = 32 * P < 1024 ? 32 * P : 1024;
    if (tile == kWide)
      return launch_cols<LOG, INV, NT>(xr, xi, yr, yi, tab, g, scale, s);
  }
  return cudaErrorInvalidValue;
}

cudaError_t axis_smooth_family(const float* xr, const float* xi, float* yr,
                               float* yi, const float2* tab,
                               const AxisGeom& g, int n, int inverse,
                               float scale, int tile, cudaStream_t s) {
  using namespace regs;
  const int odd = odd_part(n);
  auto source = smooth_length(n)        ? axis_smooth
                : smooth_more_length(n) ? (odd % 3 == 0 && odd % 25
                                               ? axis_smooth3
                                               : axis_smooth5)
                : smooth_odd_length(n)  ? (odd % 3 == 0 && odd % 25
                                               ? axis_smooth_odd3
                                               : axis_smooth_odd5)
                : odd % 5 == 0          ? axis_smooth7x5
                : odd % 3 == 0          ? axis_smooth7x3
                                        : axis_smooth7;
  return source(xr, xi, yr, yi, tab, g, n, inverse, scale, tile, s);
}

}  // namespace offt

// reg != 0: the register core (n a power of two in [16, 4096], a mixed
// length of fft_axis_mix.cu or a smooth one of fft_axis_smooth*.cu; the
// first n table rows, `inverse`, `scale` and `tile`, an AxisTile, are
// read, the radices and T are not); else the dense core (radices, T; the
// scale is in the table; `tile` must be 0).
extern "C" int offt_fft_axis(const void* xr, const void* xi, void* yr,
                             void* yi, const void* tab, long long nb, int n,
                             long long ny, long long nz, long long isb,
                             long long isn, long long isy, long long osb,
                             long long osn, long long osy, int ns, int r0,
                             int r1, int r2, int T, int inverse, float scale,
                             int reg, int tile, void* stream) {
  using namespace offt;
  AxisGeom g{nb, ny, nz, isb, isn, isy, osb, osn, osy};
  if (reg) {
    const float* ar = (const float*)xr;
    const float* ai = (const float*)xi;
    const float2* tb = (const float2*)tab;
    cudaStream_t s = (cudaStream_t)stream;
    if (regs::smooth_family_length(n))
      return (int)axis_smooth_family(ar, ai, (float*)yr, (float*)yi, tb, g, n,
                                     inverse, scale, tile, s);
    if (n & (n - 1))
      return (int)axis_mix(ar, ai, (float*)yr, (float*)yi, tb, g, n, inverse,
                           scale, tile, s);
    return (int)regs::by_log(n, [&](auto lg) {
      constexpr int LOG = decltype(lg)::value;
      return inverse ? axis_regs<LOG, true>(ar, ai, (float*)yr, (float*)yi,
                                            tb, g, scale, tile, s)
                     : axis_regs<LOG, false>(ar, ai, (float*)yr, (float*)yi,
                                             tb, g, scale, tile, s);
    });
  }
  if (tile != 0 || T < 1 || kThreads % T != 0)
    return (int)cudaErrorInvalidValue;
  Core c = make_core(n, ns, r0, r1, r2);
  const size_t smem = core_smem((size_t)n * T, c.nroot);
  cudaError_t err = allow_smem(fft_axis_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (ny * nz + T - 1) / T;
  fft_axis_kernel<<<(unsigned)(tiles * nb), kThreads, smem,
                    (cudaStream_t)stream>>>(
      (const float*)xr, (const float*)xi, (float*)yr, (float*)yi,
      (const float2*)tab, g, c, T, tiles);
  return (int)cudaGetLastError();
}
