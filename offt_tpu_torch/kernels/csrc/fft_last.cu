// fft_last.cu: batched c2c along the contiguous last axis of planar f32.
//
// Replaces: offt_tpu/kernels/pallas_fft.py fft_last (:819, _last_kernel
// :792). The TPU wrapper pads the batch to a block multiple with a copy;
// here the ragged last block is masked instead, so alias (in place) works
// for any batch.
//
// What bounds it on Hopper: one read and one write of the (B, N) planar
// pair (16 bytes per complex element in all), against the dense stages'
// r1 + r2 complex MACs per element (see fft_core.cuh).
// Design: a block owns T whole rows. It reads them row-major, so each
// warp reads consecutive addresses, and stores them transposed into the
// column-wise tile the core wants (pencil stride TP = T | 1, odd, so the
// transposing store does not hit one shared-memory bank). After the core
// it writes the rows back in natural order, again row-major. The block
// reads its whole tile before it writes any of it and no two blocks share
// a row, so the kernel may run in place (x == y).

#include "fft_core.cuh"

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

extern "C" int offt_fft_last(const void* xr, const void* xi, void* yr,
                             void* yi, const void* tab, long long rows, int n,
                             int ns, int r0, int r1, int r2, int T,
                             void* stream) {
  using namespace offt;
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
