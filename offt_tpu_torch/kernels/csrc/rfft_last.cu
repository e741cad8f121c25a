// rfft_last.cu: r2c along the contiguous last axis of real (B, N) f32;
// the planar numpy layout (B, M + 1), M = N/2, or the packed (B, M)
// layout whose lane 0 carries X[0] + i X[M].
//
// Replaces: offt_tpu/kernels/pallas_fft.py rfft_last_planar (:1685,
// _rfft_last_kernel :1642). The TPU wrapper splits the even and odd
// samples with a strided-slice pass before its kernel, and the kernel
// untangles with a second half-length transform of the conjugated input
// (Mosaic has no reversal). Here the block reads the pairs (x[2j],
// x[2j+1]) as one float2 (load_real_rows), so the split pass disappears,
// and reads V[(M - k) mod M] from shared memory, so one O(M) untangle
// (r2c_untangle) replaces the second transform.
//
// What bounds it on Hopper: 8 bytes read (one sample pair) and 8 written
// (one planar complex value) per output lane, against the M-point core's
// r1 + r2 complex MACs per lane (the dense stages, fft_core.cuh).
// Design: a block owns T whole rows, read as float2 pairs with
// consecutive threads on consecutive pairs and stored column-wise
// (pencil stride TP = T | 1, odd, so the transposing store spreads over
// banks); the core and the untangle run in place; the store walks each
// output row in order. The untangle leaves lane 0 packed as (X0, XM) in
// (re, im): the packed layout stores it as it is, the numpy layout
// splits it on the store into lane 0 = (X0, 0) and lane M = (XM, 0).
// The numpy row pitch M + 1 is odd, so its stores are scalar.

#include "fft_core.cuh"

namespace offt {

__global__ void __launch_bounds__(kThreads)
rfft_last_kernel(const float* x, float* yr, float* yi,
                 const float2* __restrict__ tab,
                 const float2* __restrict__ w, long long rows, Core c, int T,
                 int packed) {
  extern __shared__ float smem[];
  const int TP = T | 1;
  const int m = c.n;
  float* re = smem;
  float* im = smem + (size_t)m * TP;
  float2* sroot = reinterpret_cast<float2*>(im + (size_t)m * TP);
  load_roots(c, tab, sroot);
  const long long row0 = (long long)blockIdx.x * T;
  const long long left = rows - row0;
  const int valid = left < T ? (int)left : T;
  load_real_rows(x + row0 * 2LL * m, 2LL * m, m, T, TP, valid, re, im);
  core_run(re, im, T, TP, c, tab, sroot);
  r2c_untangle(re, im, T, TP, c, w);
  if (packed) {
    store_rows(yr + row0 * m, yi + row0 * m, m, c, T, TP, valid, re, im);
    return;
  }
  const int mo = m + 1;
  const int tot = mo * T;
  for (int e = threadIdx.x; e < tot; e += blockDim.x) {
    const int t = e / mo;
    const int k = e - t * mo;
    if (t < valid) {
      float a, b = 0.f;
      if (k == 0) {
        a = re[t];  // core_pos(0) == 0
      } else if (k == m) {
        a = im[t];
      } else {
        const int p = core_pos(c, k) * TP + t;
        a = re[p];
        b = im[p];
      }
      const long long o = (row0 + t) * mo + k;
      yr[o] = a;
      yi[o] = b;
    }
  }
}

}  // namespace offt

extern "C" int offt_rfft_last(const void* x, void* yr, void* yi,
                              const void* tab, const void* w, long long rows,
                              int m, int ns, int r0, int r1, int r2, int T,
                              int packed, void* stream) {
  using namespace offt;
  if (T < 1) return (int)cudaErrorInvalidValue;
  Core c = make_core(m, ns, r0, r1, r2);
  const size_t smem = core_smem((size_t)m * (T | 1), c.nroot);
  cudaError_t err = allow_smem(rfft_last_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rows + T - 1) / T;
  rfft_last_kernel<<<(unsigned)blocks, kThreads, smem,
                     (cudaStream_t)stream>>>(
      (const float*)x, (float*)yr, (float*)yi, (const float2*)tab,
      (const float2*)w, rows, c, T, packed);
  return (int)cudaGetLastError();
}
