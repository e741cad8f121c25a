// icrfft_last.cu: packed c2r along the contiguous last axis: a planar
// (B, M) half-spectrum whose lane 0 carries X[0] + i X[M] to real
// (B, N) f32, N = 2M.
//
// Replaces: offt_tpu/kernels/pallas_fft.py icrfft_last_planar (:2308,
// _icrfft_last_kernel :2272). The TPU kernel re-tangled with a dense
// (2M, 2M) matrix for M <= 128 and, above that, with two inverse
// half-length transforms of diagonally scaled inputs (Mosaic has no
// reversal), and padded the batch to a multiple of its block. Here the
// block reads X[(M - k) mod M] from shared memory, so one O(M) re-tangle
// (c2r_retangle in fft_core.cuh) serves every M, and the ragged last
// block is masked instead of padded.
//
// What bounds it on Hopper: 8 bytes read (one planar complex value) and
// 8 written (two real samples) per input lane, against the M-point core's
// r1 + r2 complex MACs per lane; the dense core's instruction rate sets
// the pace, as in rfft_last.cu, whose mirror this is. Design: a block
// owns T whole rows, read in order with consecutive threads on
// consecutive lanes and stored column-wise (pencil stride TP = T | 1,
// odd, so the transposing store spreads over banks); the re-tangle (scale
// folded into its table, row 0 the packed rule) and the inverse core run
// in place; the store walks each output row in order and writes
// x[2j] = Re v[j], x[2j+1] = Im v[j] as one float2, reading v[j] at its
// digit-reversed position core_pos(j).

#include "fft_core.cuh"

namespace offt {

__global__ void __launch_bounds__(kThreads)
icrfft_last_kernel(const float* xr, const float* xi, float* out,
                   const float2* __restrict__ tab,
                   const float2* __restrict__ ab, long long rows, Core c,
                   int T) {
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
  load_rows(xr + row0 * m, xi + row0 * m, m, m, T, TP, valid, re, im);
  c2r_retangle(re, im, T, TP, m, ab);
  core_run(re, im, T, TP, c, tab, sroot);
  store_real_rows(out + row0 * 2LL * m, 2LL * m, c, T, TP, valid, re, im);
}

}  // namespace offt

extern "C" int offt_icrfft_last(const void* xr, const void* xi, void* out,
                                const void* tab, const void* ab,
                                long long rows, int m, int ns, int r0,
                                int r1, int r2, int T, void* stream) {
  using namespace offt;
  if (T < 1) return (int)cudaErrorInvalidValue;
  Core c = make_core(m, ns, r0, r1, r2);
  const size_t smem = core_smem((size_t)m * (T | 1), c.nroot);
  cudaError_t err = allow_smem(icrfft_last_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rows + T - 1) / T;
  icrfft_last_kernel<<<(unsigned)blocks, kThreads, smem,
                       (cudaStream_t)stream>>>(
      (const float*)xr, (const float*)xi, (float*)out, (const float2*)tab,
      (const float2*)ab, rows, c, T);
  return (int)cudaGetLastError();
}
