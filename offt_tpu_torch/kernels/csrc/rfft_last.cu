// rfft_last.cu: r2c along the contiguous last axis of real (B, N) f32;
// the planar numpy layout (B, M + 1), M = N/2, or the packed (B, M)
// layout whose lane 0 carries X[0] + i X[M].
//
// Replaces: offt_tpu/kernels/pallas_fft.py rfft_last_planar (:1685,
// _rfft_last_kernel :1642). The TPU wrapper splits the even and odd
// samples with a strided-slice pass before its kernel, and the kernel
// untangles with a second half-length transform of the conjugated input
// (Mosaic has no reversal). Here the pairs (x[2j], x[2j+1]) are read as
// one float2 v[j], so the split pass disappears, and V[(M - k) mod M] is
// read from shared memory, so one O(M) untangle replaces the second
// transform: X[k] = E - i W^k O with E, O = (V[k] +- conj V[M-k]) / 2,
// W^k = w[k] (tables.rfft_table), and the packed X[0] + i X[M] =
// (Re V0 + Im V0) + i (Re V0 - Im V0).
//
// What bounds it on Hopper: 8 bytes read (one sample pair) and 8 written
// (one planar complex value) per output lane.
// Design, two cores chosen by the wrapper (fused_fft._reg_real_rows(M)):
// - M a power of two in [16, 4096]: the register core of fft_regs.cuh
//   (regs::rows_r2c in regs_kernels.cuh, packed rows at pitch M).
//   Its first pass reads the float2 pairs straight into registers (a warp
//   on consecutive pairs); its last pass writes V in natural order to the
//   row's shared planes; after one barrier each thread owns pairs
//   (k, M - k) and untangles them from shared memory into registers,
//   times `scale`. The block's output rows lie contiguous in device
//   memory: staged back in the shared planes, they are copied out with
//   consecutive threads on consecutive floats, whole sectors, although a
//   numpy row (M + 1 floats) is odd;
// - the mixed M = 3 2^k in [48, 1536] and 3072, 5 2^k in [80, 2560]: the
//   same design on the mixed rows (regs::rows_r2c_mix, real_rows_mix.cu,
//   a source of its own);
// - every other M: the dense core of fft_core.cuh on a column-wise tile of
//   T rows (pencil stride TP = T | 1), the untangle in place on the tile
//   (r2c_untangle), then a row-major store. Its scale rides the table.
// The numpy row pitch M + 1 is odd, so the stores are scalar. The input
// must be 8-byte aligned (the wrapper checks).

#include "fft_core.cuh"
#include "regs_kernels.cuh"

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

// reg != 0: the register core (m a power of two in [16, 4096], or a mixed
// M of real_rows_mix.cu; the first m rows of `tab` and `scale` are read,
// the radices and T are not); else the dense core (radices, T; the scale
// is in the table).
extern "C" int offt_rfft_last(const void* x, void* yr, void* yi,
                              const void* tab, const void* w, long long rows,
                              int m, int ns, int r0, int r1, int r2, int T,
                              int packed, float scale, int reg,
                              void* stream) {
  using namespace offt;
  const float* xf = (const float*)x;
  const float2* tb = (const float2*)tab;
  const float2* wt = (const float2*)w;
  float* o_r = (float*)yr;
  float* o_i = (float*)yi;
  cudaStream_t s = (cudaStream_t)stream;
  if (reg) {
    if (m & (m - 1))
      return (int)rfft_mix(xf, o_r, o_i, tb, wt, rows, m, scale, packed, s);
    return (int)regs::by_log(m, [&](auto lg) {
      return regs::launch_rows_r2c<decltype(lg)::value>(
          xf, o_r, o_i, tb, wt, rows, m, scale, packed, s);
    });
  }
  if (T < 1) return (int)cudaErrorInvalidValue;
  Core c = make_core(m, ns, r0, r1, r2);
  const size_t smem = core_smem((size_t)m * (T | 1), c.nroot);
  cudaError_t err = allow_smem(rfft_last_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (rows + T - 1) / T;
  rfft_last_kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
      xf, o_r, o_i, tb, wt, rows, c, T, packed);
  return (int)cudaGetLastError();
}
