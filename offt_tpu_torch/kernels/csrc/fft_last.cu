// fft_last.cu: batched c2c along the contiguous last axis of planar f32.
//
// Replaces: offt_tpu/kernels/pallas_fft.py fft_last (:819, _last_kernel
// :792). The TPU wrapper pads the batch to a block multiple with a copy;
// here the ragged last block is masked instead, so alias (in place) works
// for any batch.
//
// What bounds it on Hopper: one read and one write of the (B, N) planar
// pair, 16 bytes per complex element in all.
// Design, two cores chosen by the wrapper (fused_fft._reg_rows):
// - a power-of-two N in [16, 4096] runs the register core of fft_regs.cuh
//   (regs::rows_c2c in regs_kernels.cuh, rows at pitch N):
//   P = N/16 threads a row load it straight from device memory (a warp on
//   consecutive addresses), run its radix-16/8/4/2 Stockham passes in
//   registers with shared memory only for the exchanges, and store natural
//   order straight back, times `scale` (rows shorter than 128, fewer than
//   8 threads, move in and out through a shared stage instead, the
//   block's rows as one contiguous run). It ignores the radices: any
//   valid pick gives the same values.
// - the mixed lengths 3 2^k in [48, 1536] and 3072, 5 2^k in [80, 2560]
//   run the same core's rows with 4 R0 values a thread and a last pass of
//   radix 12 or 20, their exchange planes swizzled (fft_last_mix.cu, a
//   source of its own);
// - every other length runs the dense core of fft_core.cuh: a block owns T
//   whole rows, reads them row-major into a column-wise tile (pencil
//   stride TP = T | 1, odd, so the transposing store does not hit one
//   shared-memory bank), runs the core's 1-3 dense stages and writes the
//   rows back in natural order. Its scale rides the table's last stage.
// Both read a block's whole tile before writing any of it and no two
// blocks share a row, so the kernel may run in place (x == y).

#include "fft_core.cuh"
#include "regs_kernels.cuh"

namespace offt {

__global__ void __launch_bounds__(kThreads)
fft_last_kernel(const float* xr, const float* xi, float* yr, float* yi,
                const float2* __restrict__ tab, long long rows, Core c,
                int T) {
  extern __shared__ float smem[];
  const int TP = T | 1;
  const int n = c.n;
  float* re = smem;
  float* im = smem + (size_t)n * TP;
  float2* sroot = reinterpret_cast<float2*>(im + (size_t)n * TP);
  load_roots(c, tab, sroot);
  const long long row0 = (long long)blockIdx.x * T;
  const long long left = rows - row0;
  const int valid = left < T ? (int)left : T;
  load_rows(xr + row0 * n, xi + row0 * n, n, n, T, TP, valid, re, im);
  core_run(re, im, T, TP, c, tab, sroot);
  store_rows(yr + row0 * n, yi + row0 * n, n, c, T, TP, valid, re, im);
}

}  // namespace offt

// reg != 0: the register core (n a power of two in [16, 4096], or a mixed
// length of fft_last_mix.cu; the first n table rows, `inverse` and `scale`
// are read, the radices and T are not); else the dense core (radices, T;
// the scale is in the table).
extern "C" int offt_fft_last(const void* xr, const void* xi, void* yr,
                             void* yi, const void* tab, long long rows, int n,
                             int ns, int r0, int r1, int r2, int T,
                             int inverse, float scale, int reg,
                             void* stream) {
  using namespace offt;
  if (reg) {
    const float* ar = (const float*)xr;
    const float* ai = (const float*)xi;
    const float2* tb = (const float2*)tab;
    cudaStream_t s = (cudaStream_t)stream;
    if (n & (n - 1))
      return (int)last_mix(ar, ai, (float*)yr, (float*)yi, tb, rows, n, n, n,
                           inverse, scale, s);
    return (int)regs::by_log(n, [&](auto lg) {
      constexpr int LOG = decltype(lg)::value;
      return inverse ? regs::launch_rows<LOG, true>(ar, ai, (float*)yr,
                                                    (float*)yi, tb, rows, n,
                                                    n, scale, s)
                     : regs::launch_rows<LOG, false>(ar, ai, (float*)yr,
                                                     (float*)yi, tb, rows, n,
                                                     n, scale, s);
    });
  }
  Core c = make_core(n, ns, r0, r1, r2);
  const int TP = T | 1;
  const size_t smem = core_smem((size_t)n * TP, c.nroot);
  cudaError_t err = allow_smem(fft_last_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rows + T - 1) / T;
  fft_last_kernel<<<(unsigned)blocks, kThreads, smem,
                    (cudaStream_t)stream>>>(
      (const float*)xr, (const float*)xi, (float*)yr, (float*)yi,
      (const float2*)tab, rows, c, T);
  return (int)cudaGetLastError();
}

extern "C" const char* offt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
