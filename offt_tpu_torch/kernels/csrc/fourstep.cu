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
// (16 bytes per complex element; step 1 also reads the 8-byte twiddle).
// Two cores, each kernel routing on its own length (fused_fft._reg_core:
// a power of two in [16, 4096]):
// - the register core (regs_kernels.cuh). Step 1 is the strided-axis
//   kernel's column variant (cols_twiddle: P = n1 / 16 threads a line
//   hold it in registers, a warp on consecutive lanes j2, consecutive
//   blocks on consecutive lanes) with the twiddle multiply at the store,
//   table row k1 read at the lanes the data has. Its lane tile (`tile`,
//   picked only by fourstep._step1_tile): narrow (256 threads) to
//   n1 = 128, wide (32 lanes up to 1024 threads) from 256, and half (half
//   the wide tile's lanes and threads; n1 = 512, 1024) where the wide grid
//   is small against the card's SMs (2^20: 64 wide blocks). Step 3 is the
//   row core (rows_transposed): a block holds R consecutive rows (b, k1),
//   writes their outputs into a shared stage [k2][k1 - k1_0] (XOR-swizzled:
//   one wavefront a warp both ways) and stores each k2's run of R floats:
//   R = 4096 / n2 rows in 256 threads to n2 = 512, 8 in 512 and 1024
//   threads at 1024 and 2048; at 4096 (8 rows would need a 256 KB stage)
//   a cluster of two blocks of 4 rows, each storing half of the k2 of all
//   8 (the other block's stage read through distributed shared memory),
//   1.7x faster than one block of 4 rows (runs of 16 bytes). Rows of a
//   block may span two batches (R need not divide n1): each row finds its
//   own. The layout is chosen here (step3_regs; fourstep._step3_layout
//   describes it). The radices, T and `block` are not read. (16 rows a
//   block at 1024, 4 rows or clusters of two at 2048 and clusters of
//   four at 4096 ran level or slower, PERF.md.)
// - every other length runs the dense core of fft_core.cuh, one MAC a
//   root read from shared memory (about 0.1 of the bound). Step 1 is the
//   strided-axis tile of fft_axis.cu (T consecutive lanes j2) with the
//   twiddle folded into the store: natural index k1 sits at core_pos(k1),
//   and table row k1 is read at the same T lanes. Step 3 is the row tile
//   of fft_last.cu (T consecutive rows k1, pencil stride TP = T | 1)
//   whose store walks k1 fastest, read from shared memory at
//   core_pos(k2) * TP + t. The tile rule of 64 KB leaves T = 8 at 1024.

#include "fft_core.cuh"
#include "regs_kernels.cuh"

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

// the register core's tiles of step 1 (fourstep._STEP1_TILES)
enum Step1Tile { kNarrow = 0, kWide = 1, kHalf = 2 };

template <int LOG, bool INV>
static cudaError_t step1_regs(const float* xr, const float* xi, float* yr,
                              float* yi, const float2* tab, const float2* tw,
                              const AxisGeom& g, int tile, cudaStream_t s) {
  using namespace regs;
  if constexpr (LOG <= 7) {
    if (tile == kNarrow)
      return launch_cols_twiddle<LOG, INV, kThreads>(xr, xi, yr, yi, tab, tw,
                                                     g, s);
  } else {
    // 32 lanes a block, at most 1024 threads; half of that
    constexpr int P = ColGeo<LOG>::P;
    constexpr int NT = 32 * P < 1024 ? 32 * P : 1024;
    if (tile == kWide)
      return launch_cols_twiddle<LOG, INV, NT>(xr, xi, yr, yi, tab, tw, g,
                                               s);
    if constexpr (LOG == 9 || LOG == 10) {
      if (tile == kHalf)
        return launch_cols_twiddle<LOG, INV, NT / 2>(xr, xi, yr, yi, tab, tw,
                                                     g, s);
    }
  }
  return cudaErrorInvalidValue;
}

// the layout of step 3's register core, chosen here alone
// (fourstep._step3_layout describes it): R rows a block in tr_threads
// threads, but at 4096 a cluster of C = 2 blocks of 4 rows (R = 8)
template <int LOG, bool INV>
static cudaError_t step3_regs(const float* xr, const float* xi, float* yr,
                              float* yi, const float2* tab, long long rows,
                              long long n1, cudaStream_t s) {
  using namespace regs;
  constexpr int CL = LOG < 12 ? 1 : 2;
  return launch_rows_transposed<LOG, INV, tr_threads<LOG>(), CL>(
      xr, xi, yr, yi, tab, rows, n1, s);
}

}  // namespace offt

// reg != 0: the register core (n1 a power of two in [16, 4096]; the first
// n1 table rows, `inverse` and `tile`, a Step1Tile, are read, the radices
// and T are not); else the dense core (radices, T; `tile` must be 0).
extern "C" int offt_step1_twiddle(const void* xr, const void* xi, void* yr,
                                  void* yi, const void* tab, const void* tw,
                                  long long nb, int n1, long long n2, int ns,
                                  int r0, int r1, int r2, int T, int inverse,
                                  int reg, int tile, void* stream) {
  using namespace offt;
  if (reg) {
    const AxisGeom g{nb, 1, n2, n1 * n2, n2, n1 * n2, n1 * n2, n2, n1 * n2};
    const float* ar = (const float*)xr;
    const float* ai = (const float*)xi;
    const float2* tb = (const float2*)tab;
    const float2* w = (const float2*)tw;
    cudaStream_t s = (cudaStream_t)stream;
    return (int)regs::by_log(n1, [&](auto lg) {
      constexpr int LOG = decltype(lg)::value;
      return inverse ? step1_regs<LOG, true>(ar, ai, (float*)yr, (float*)yi,
                                             tb, w, g, tile, s)
                     : step1_regs<LOG, false>(ar, ai, (float*)yr, (float*)yi,
                                              tb, w, g, tile, s);
    });
  }
  if (tile != 0 || T < 1 || kThreads % T != 0)
    return (int)cudaErrorInvalidValue;
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

// reg != 0: the register core (n2 a power of two in [16, 4096]; the first
// n2 table rows and `inverse` are read, the radices and T are not); else
// the dense core (radices, T).
extern "C" int offt_step3_transposed(const void* xr, const void* xi,
                                     void* yr, void* yi, const void* tab,
                                     long long rows, int n1, int n2, int ns,
                                     int r0, int r1, int r2, int T,
                                     int inverse, int reg, void* stream) {
  using namespace offt;
  if (reg) {
    const float* ar = (const float*)xr;
    const float* ai = (const float*)xi;
    const float2* tb = (const float2*)tab;
    cudaStream_t s = (cudaStream_t)stream;
    return (int)regs::by_log(n2, [&](auto lg) {
      constexpr int LOG = decltype(lg)::value;
      return inverse ? step3_regs<LOG, true>(ar, ai, (float*)yr, (float*)yi,
                                             tb, rows, n1, s)
                     : step3_regs<LOG, false>(ar, ai, (float*)yr, (float*)yi,
                                              tb, rows, n1, s);
    });
  }
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
