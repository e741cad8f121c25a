// fourstep.cu: the two kernels of the four-step long 1-D c2c, n = n1 * n2,
// on planar f32 data viewed as (B, n1, n2).
//
// Replaces: offt_tpu/kernels/fourstep.py _step1_twiddle (:166,
// _step1tw_kernel :132) and _step3_transposed (:213, _step3t_kernel :145).
//
// step1_twiddle: FFT_{n1} along the middle axis, each output (k1, j2)
// times T[k1, j2] (the four-step twiddle with all scaling folded in,
// tables.fourstep_twiddle, or a caller's table of the same layout).
// step3_transposed: FFT_{n2} along the last axis, written transposed into
// (B, n2, n1): (k1, k2) lands at k2 * n1 + k1, which is X[k1 + n1 * k2],
// the natural order. No scale: step 1's table carries it.
//
// What bounds them on Hopper: each moves the planar pair once each way
// (16 bytes per complex element; step 1 also reads the 8-byte twiddle,
// a fifth of its traffic), against the core's r1 + r2 complex MACs per
// element (see fft_core.cuh). The tile rule of 64 KB leaves T = 8 at
// n1 = 1024 and T = 2 at 4096, so step 1 reads, and step 3 writes, runs
// of only T consecutive floats: far from the bound at 2^24. Correct and
// simple first; a transposing second pass through shared memory, a
// larger T, or another split is later work.
// Design: step 1 is the strided-axis tile of fft_axis.cu (T consecutive
// lanes j2, each column read as the core wants it) with the twiddle folded
// into the store: natural index k1 sits at core_pos(k1), and table row k1
// is read at the same T lanes, so its reads coalesce like the data's.
// Step 3 is the row tile of fft_last.cu (T consecutive rows k1, pencil
// stride TP = T | 1) whose store walks k1 fastest: neighbouring threads
// write neighbouring k1 of one k2, a run of T floats, read from shared
// memory at core_pos(k2) * TP + t without bank conflicts. A block's rows
// may span two batches (T need not divide n1): each row finds its own.

#include "fft_core.cuh"

namespace offt {

__global__ void __launch_bounds__(kThreads)
step1_twiddle_kernel(const float* xr, const float* xi, float* yr, float* yi,
                     const float2* __restrict__ tab,
                     const float2* __restrict__ tw, long long n2, Core c,
                     int T, long long tiles) {
  extern __shared__ float smem[];
  const int n = c.n;
  float* re = smem;
  float* im = smem + (size_t)n * T;
  float2* sroot = reinterpret_cast<float2*>(im + (size_t)n * T);
  load_roots(c, tab, sroot);
  const long long b = blockIdx.x / tiles;
  const int t = threadIdx.x % T;
  const long long j = (blockIdx.x - b * tiles) * T + t;
  const bool valid = j < n2;
  const long long base = b * n * n2 + j;
  load_cols(xr, xi, n2, base, valid, n, T, re, im);
  core_run(re, im, T, T, c, tab, sroot);
  const int step = blockDim.x / T;
  for (int k = threadIdx.x / T; k < n; k += step) {
    if (valid) {
      const int p = core_pos(c, k) * T + t;
      const float2 w = __ldg(tw + k * n2 + j);
      const float a = re[p], bv = im[p];
      yr[base + k * n2] = a * w.x - bv * w.y;
      yi[base + k * n2] = a * w.y + bv * w.x;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
step3_transposed_kernel(const float* xr, const float* xi, float* yr,
                        float* yi, const float2* __restrict__ tab,
                        long long rows, int n1, Core c, int T) {
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
  const int tot = n * T;
  for (int e = threadIdx.x; e < tot; e += blockDim.x) {
    const int k = e / T;
    const int t = e - k * T;
    if (t < valid) {
      const long long r = row0 + t;  // b * n1 + k1
      const long long b = r / n1;
      const long long o = (b * n + k) * n1 + (r - b * n1);
      const int p = core_pos(c, k) * TP + t;
      yr[o] = re[p];
      yi[o] = im[p];
    }
  }
}

}  // namespace offt

extern "C" int offt_step1_twiddle(const void* xr, const void* xi, void* yr,
                                  void* yi, const void* tab, const void* tw,
                                  long long nb, int n1, long long n2, int ns,
                                  int r0, int r1, int r2, int T,
                                  void* stream) {
  using namespace offt;
  if (T < 1 || kThreads % T != 0) return (int)cudaErrorInvalidValue;
  Core c = make_core(n1, ns, r0, r1, r2);
  const size_t smem = core_smem((size_t)n1 * T, c.nroot);
  cudaError_t err = allow_smem(step1_twiddle_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (n2 + T - 1) / T;
  step1_twiddle_kernel<<<(unsigned)(tiles * nb), kThreads, smem,
                         (cudaStream_t)stream>>>(
      (const float*)xr, (const float*)xi, (float*)yr, (float*)yi,
      (const float2*)tab, (const float2*)tw, n2, c, T, tiles);
  return (int)cudaGetLastError();
}

extern "C" int offt_step3_transposed(const void* xr, const void* xi,
                                     void* yr, void* yi, const void* tab,
                                     long long rows, int n1, int n2, int ns,
                                     int r0, int r1, int r2, int T,
                                     void* stream) {
  using namespace offt;
  if (T < 1) return (int)cudaErrorInvalidValue;
  Core c = make_core(n2, ns, r0, r1, r2);
  const size_t smem = core_smem((size_t)n2 * (T | 1), c.nroot);
  cudaError_t err = allow_smem(step3_transposed_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rows + T - 1) / T;
  step3_transposed_kernel<<<(unsigned)blocks, kThreads, smem,
                            (cudaStream_t)stream>>>(
      (const float*)xr, (const float*)xi, (float*)yr, (float*)yi,
      (const float2*)tab, rows, n1, c, T);
  return (int)cudaGetLastError();
}
