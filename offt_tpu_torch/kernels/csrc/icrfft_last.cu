// icrfft_last.cu: packed c2r along the contiguous last axis: a planar
// (B, M) half-spectrum whose lane 0 carries X[0] + i X[M] to real
// (B, N) f32, N = 2M.
//
// Replaces: offt_tpu/kernels/pallas_fft.py icrfft_last_planar (:2308,
// _icrfft_last_kernel :2272). The TPU kernel re-tangled with a dense
// (2M, 2M) matrix for M <= 128 and, above that, with two inverse
// half-length transforms of diagonally scaled inputs (Mosaic has no
// reversal), and padded the batch to a multiple of its block. Here one
// O(M) re-tangle (scale folded into its table, row 0 the packed rule)
// serves every M, and the ragged last block is masked instead of padded.
//
// What bounds it on Hopper: the rows' bytes, 8 read (one planar complex
// value) and 8 written (two real samples) per input lane. Two cores,
// chosen by the wrapper (fused_fft._reg_core):
// - a power-of-two M in [16, 4096] runs regs::rows_c2r of
//   regs_kernels.cuh, the kernel of irfft_slab.cu's c2r rows (the rows at
//   pitch M): P = M / 16 threads a row read lanes e and (M - e) mod M
//   straight from device memory and re-tangle them as the register core
//   loads, run the inverse M-point core in registers, and store
//   x[2j], x[2j + 1] = v[j] as one float2, a warp on consecutive float2
//   (rows of 1-2 threads, M = 16 and 32, store through a shared stage).
//   It ignores the radices and the rows per block;
// - every other M runs the dense core of fft_core.cuh: a block owns T
//   whole rows, read in order with consecutive threads on consecutive
//   lanes and stored column-wise (pencil stride TP = T | 1, odd, so the
//   transposing store spreads over banks); the re-tangle reads
//   X[(M - k) mod M] from shared memory (c2r_retangle), the inverse core
//   runs in place, and the store walks each output row in order, reading
//   v[j] at its digit-reversed position core_pos(j). Its instruction rate
//   set the pace: 0.064 of the byte bound at (65536, 128) (PERF.md).

#include "fft_core.cuh"
#include "regs_kernels.cuh"

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

// reg != 0: the register core (m a power of two in [16, 4096]; the first
// m rows of the inverse core table and `ab` are read, the radices and T
// are not); else the dense core (radices, T).
extern "C" int offt_icrfft_last(const void* xr, const void* xi, void* out,
                                const void* tab, const void* ab,
                                long long rows, int m, int ns, int r0,
                                int r1, int r2, int T, int reg,
                                void* stream) {
  using namespace offt;
  if (reg) {
    return (int)regs::by_log(m, [&](auto lg) {
      return regs::launch_rows_c2r<decltype(lg)::value>(
          (const float*)xr, (const float*)xi, (float*)out,
          (const float2*)tab, (const float2*)ab, rows, m,
          (cudaStream_t)stream);
    });
  }
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
