// fft_last.cu: batched c2c along the contiguous last axis of planar f32.
//
// Replaces: offt_tpu/kernels/pallas_fft.py fft_last (:819, _last_kernel
// :792). The TPU wrapper pads the batch to a block multiple with a copy;
// here the ragged last block is masked instead, so alias (in place) works
// for any batch.
//
// What bounds it on Hopper: one read and one write of the (B, N) planar
// pair, 16 bytes per complex element in all.
// Design, two cores chosen by the wrapper (fused_fft._reg_core):
// - a power-of-two N in [16, 4096] runs the register core of fft_regs.cuh:
//   P = N/16 threads a row load it straight from device memory (a warp on
//   consecutive addresses), run its radix-16/8/4/2 Stockham passes in
//   registers with shared memory only for the exchanges, and store natural
//   order straight back, times `scale` (rows shorter than 128, fewer than
//   8 threads, move in and out through a shared stage instead, the
//   block's rows as one contiguous run). It ignores the radices: any
//   valid pick gives the same values.
// - every other length runs the dense core of fft_core.cuh: a block owns T
//   whole rows, reads them row-major into a column-wise tile (pencil
//   stride TP = T | 1, odd, so the transposing store does not hit one
//   shared-memory bank), runs the core's 1-3 dense stages and writes the
//   rows back in natural order. Its scale rides the table's last stage.
// Both read a block's whole tile before writing any of it and no two
// blocks share a row, so the kernel may run in place (x == y).

#include "fft_core.cuh"
#include "fft_regs.cuh"

namespace offt {

// rows of fewer threads than this (N < 128) move through a shared stage
constexpr int kStagedBelow = 8;

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

template <int LOG, bool INV>
__global__ void __launch_bounds__(kThreads, regs::kMinBlocks)
fft_last_regs(const float* xr, const float* xi, float* yr, float* yi,
              const float2* __restrict__ tab, long long rows, float scale) {
  using G = regs::Geo<LOG>;
  constexpr int N = G::N;
  extern __shared__ __align__(16) float rsmem[];
  const int g = threadIdx.x / G::P;
  const int t = threadIdx.x % G::P;
  const long long row = (long long)blockIdx.x * G::ROWS + g;
  const bool valid = row < rows;
  float* sre = rsmem + g * G::PITCH;
  float* sim = rsmem + (G::ROWS + g) * G::PITCH;
  float2 v[regs::kE];
  if constexpr (G::P >= kStagedBelow) {
    const long long off = row * N;
    regs::core<LOG, INV>(v, sre, sim, t, tab, [&](int e) {
      return valid ? make_float2(xr[off + e], xi[off + e])
                   : make_float2(0.f, 0.f);
    });
    if (!valid) return;
    regs::outputs<LOG>(v, t, [&](int e, float2 y) {
      yr[off + e] = y.x * scale;
      yi[off + e] = y.y * scale;
    });
  } else {
    // rows of so few threads would read and write device memory a whole
    // row apart: the block's rows, contiguous in device memory, move
    // through a stage (both planes, row pitch N + 1) with consecutive
    // threads on consecutive floats
    constexpr int S = N + 1;
    float* st = rsmem + (G::NPASS > 1 ? 2 * G::ROWS * G::PITCH : 0);
    const long long base = (long long)blockIdx.x * G::ROWS * N;
    const long long left = rows - (long long)blockIdx.x * G::ROWS;
    const int tot = (left < G::ROWS ? (int)left : G::ROWS) * N;
    for (int i = threadIdx.x; i < tot; i += kThreads) {
      const int a = (i >> LOG) * S + (i & (N - 1));
      st[a] = xr[base + i];
      st[G::ROWS * S + a] = xi[base + i];
    }
    __syncthreads();
    const float* pr = st + g * S;
    const float* pi = st + G::ROWS * S + g * S;
    regs::core<LOG, INV>(v, sre, sim, t, tab, [&](int e) {
      return make_float2(pr[e], pi[e]);
    });
    __syncthreads();  // every row has read its stage
    regs::outputs<LOG>(v, t, [&](int e, float2 y) {
      st[g * S + e] = y.x * scale;
      st[G::ROWS * S + g * S + e] = y.y * scale;
    });
    __syncthreads();
    for (int i = threadIdx.x; i < tot; i += kThreads) {
      const int a = (i >> LOG) * S + (i & (N - 1));
      yr[base + i] = st[a];
      yi[base + i] = st[G::ROWS * S + a];
    }
  }
}

template <int LOG, bool INV>
static cudaError_t launch_regs(const float* xr, const float* xi, float* yr,
                               float* yi, const float2* tab, long long rows,
                               float scale, cudaStream_t stream) {
  using G = regs::Geo<LOG>;
  // a single pass (N = 16) exchanges nothing; short rows add the stage
  const size_t smem =
      (G::NPASS > 1 ? G::SMEM : 0) +
      (G::P < kStagedBelow ? 2 * G::ROWS * (G::N + 1) * sizeof(float) : 0);
  cudaError_t err = allow_smem(fft_last_regs<LOG, INV>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + G::ROWS - 1) / G::ROWS;
  fft_last_regs<LOG, INV><<<(unsigned)blocks, kThreads, smem, stream>>>(
      xr, xi, yr, yi, tab, rows, scale);
  return cudaGetLastError();
}

template <bool INV>
static cudaError_t dispatch_regs(int n, const float* xr, const float* xi,
                                 float* yr, float* yi, const float2* tab,
                                 long long rows, float scale,
                                 cudaStream_t s) {
  switch (n) {
    case 16: return launch_regs<4, INV>(xr, xi, yr, yi, tab, rows, scale, s);
    case 32: return launch_regs<5, INV>(xr, xi, yr, yi, tab, rows, scale, s);
    case 64: return launch_regs<6, INV>(xr, xi, yr, yi, tab, rows, scale, s);
    case 128: return launch_regs<7, INV>(xr, xi, yr, yi, tab, rows, scale, s);
    case 256: return launch_regs<8, INV>(xr, xi, yr, yi, tab, rows, scale, s);
    case 512: return launch_regs<9, INV>(xr, xi, yr, yi, tab, rows, scale, s);
    case 1024:
      return launch_regs<10, INV>(xr, xi, yr, yi, tab, rows, scale, s);
    case 2048:
      return launch_regs<11, INV>(xr, xi, yr, yi, tab, rows, scale, s);
    case 4096:
      return launch_regs<12, INV>(xr, xi, yr, yi, tab, rows, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace offt

// reg != 0: the register core (n a power of two in [16, 4096]; the first
// n table rows, `inverse` and `scale` are read, the radices and T are
// not); else the dense core (radices, T; the scale is in the table).
extern "C" int offt_fft_last(const void* xr, const void* xi, void* yr,
                             void* yi, const void* tab, long long rows, int n,
                             int ns, int r0, int r1, int r2, int T,
                             int inverse, float scale, int reg,
                             void* stream) {
  using namespace offt;
  if (reg) {
    auto f = inverse ? dispatch_regs<true> : dispatch_regs<false>;
    return (int)f(n, (const float*)xr, (const float*)xi, (float*)yr,
                  (float*)yi, (const float2*)tab, rows, scale,
                  (cudaStream_t)stream);
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
