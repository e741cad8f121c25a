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
// Design, two cores chosen by the wrapper (fused_fft._reg_core(M)):
// - M a power of two in [16, 4096]: the register core of fft_regs.cuh.
//   Its first pass reads the float2 pairs straight into registers (a warp
//   on consecutive pairs); its last pass writes V in natural order to the
//   row's shared planes; after one barrier each thread owns pairs
//   (k, M - k) and untangles them from shared memory into registers,
//   times `scale`. The block's output rows lie contiguous in device
//   memory: staged back in the shared planes, they are copied out with
//   consecutive threads on consecutive floats, whole sectors, although a
//   numpy row (M + 1 floats) is odd;
// - every other M: the dense core of fft_core.cuh on a column-wise tile of
//   T rows (pencil stride TP = T | 1), the untangle in place on the tile
//   (r2c_untangle), then a row-major store. Its scale rides the table.
// The numpy row pitch M + 1 is odd, so the stores are scalar. The input
// must be 8-byte aligned (the wrapper checks).

#include "fft_core.cuh"
#include "fft_regs.cuh"

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

template <int LOG>
__global__ void __launch_bounds__(kThreads, regs::kMinBlocks)
rfft_last_regs(const float* x, float* yr, float* yi,
               const float2* __restrict__ tab,
               const float2* __restrict__ w, long long rows, float scale,
               int packed) {
  using G = regs::Geo<LOG>;
  constexpr int M = G::N;
  static_assert(G::PITCH >= M + 1, "staged rows fit the exchange planes");
  extern __shared__ __align__(16) float rsmem[];
  const int g = threadIdx.x / G::P;
  const int t = threadIdx.x % G::P;
  const long long row = (long long)blockIdx.x * G::ROWS + g;
  const bool valid = row < rows;
  float* sre = rsmem + g * G::PITCH;
  float* sim = rsmem + (G::ROWS + g) * G::PITCH;
  const float2* xrow = reinterpret_cast<const float2*>(x) + row * M;
  float2 v[regs::kE];
  regs::core<LOG, false>(v, sre, sim, t, tab, [&](int e) {
    return valid ? xrow[e] : make_float2(0.f, 0.f);
  });
  regs::row_sync<M>();
  regs::outputs<LOG>(v, t, [&](int e, float2 y) {
    const int a = regs::phys(e);
    sre[a] = y.x;
    sim[a] = y.y;
  });
  regs::row_sync<M>();
  // untangle the pairs (k, M - k), k = t + i P over [0, M/2), into
  // registers: lo = X[k], hi = X[M - k] (for k = 0: X[0] + i X[M] packed,
  // else X[0] and X[M]); thread 0 also takes X[M/2]
  const float hs = 0.5f * scale;
  float2 lo[regs::kE / 2], hi[regs::kE / 2], mid;
  auto untangle = [&](int k, float2& xk, float2& xmk) {
    const int pa = regs::phys(k), pb = regs::phys(M - k);
    const float ar = sre[pa], ai = sim[pa];  // V[k]
    const float br = sre[pb], bi = sim[pb];  // V[M-k]
    // 2E and 2O; hs = scale / 2 restores the halves
    const float er = ar + br, ei = ai - bi;
    const float o_r = ar - br, o_i = ai + bi;
    const float2 wk = __ldg(w + k), wm = __ldg(w + (M - k));
    xk = make_float2((er + wk.x * o_i + wk.y * o_r) * hs,
                     (ei - wk.x * o_r + wk.y * o_i) * hs);
    xmk = make_float2((er + wm.x * o_i - wm.y * o_r) * hs,
                      (-ei + wm.x * o_r + wm.y * o_i) * hs);
  };
  regs::unroll<0, regs::kE / 2>([&](auto ic) {
    constexpr int I = decltype(ic)::value;
    const int k = t + I * G::P;
    if (k == 0) {
      const float a = sre[0], b = sim[0];  // phys(0) == 0
      lo[I] = make_float2((a + b) * scale, packed ? (a - b) * scale : 0.f);
      hi[I] = make_float2((a - b) * scale, 0.f);
    } else {
      untangle(k, lo[I], hi[I]);
    }
  });
  if (t == 0) untangle(M / 2, mid, mid);
  // stage the block's rows at the odd pitch M + 1 (every row's V has been
  // read), then copy out the L = M or M + 1 lanes of each: the rows lie
  // contiguous in device memory, so the block writes whole sectors
  // although a numpy row (M + 1 floats) is odd
  const int L = packed ? M : M + 1;
  float* st_r = rsmem + g * (M + 1);
  float* st_i = rsmem + G::ROWS * G::PITCH + g * (M + 1);
  __syncthreads();
  regs::unroll<0, regs::kE / 2>([&](auto ic) {
    constexpr int I = decltype(ic)::value;
    const int k = t + I * G::P;
    st_r[k] = lo[I].x;
    st_i[k] = lo[I].y;
    if (k != 0 || !packed) {
      st_r[M - k] = hi[I].x;  // k = 0: X[M] at lane M of a numpy row
      st_i[M - k] = hi[I].y;
    }
  });
  if (t == 0) {
    st_r[M / 2] = mid.x;
    st_i[M / 2] = mid.y;
  }
  __syncthreads();
  const long long row0 = (long long)blockIdx.x * G::ROWS;
  const long long left = rows - row0;
  const int tot = (left < G::ROWS ? (int)left : G::ROWS) * L;
  float* outr = yr + row0 * L;
  float* outi = yi + row0 * L;
  const float* sr = rsmem;
  const float* si = rsmem + G::ROWS * G::PITCH;
  for (int i = threadIdx.x; i < tot; i += kThreads) {
    const int a = packed ? (i >> LOG) * (M + 1) + (i & (M - 1)) : i;
    outr[i] = sr[a];
    outi[i] = si[a];
  }
}

template <int LOG>
static cudaError_t launch_regs(const float* x, float* yr, float* yi,
                               const float2* tab, const float2* w,
                               long long rows, float scale, int packed,
                               cudaStream_t stream) {
  using G = regs::Geo<LOG>;
  cudaError_t err = allow_smem(rfft_last_regs<LOG>, G::SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + G::ROWS - 1) / G::ROWS;
  rfft_last_regs<LOG><<<(unsigned)blocks, kThreads, G::SMEM, stream>>>(
      x, yr, yi, tab, w, rows, scale, packed);
  return cudaGetLastError();
}

}  // namespace offt

// reg != 0: the register core (m a power of two in [16, 4096]; the first
// m rows of `tab` and `scale` are read, the radices and T are not); else
// the dense core (radices, T; the scale is in the table).
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
    switch (m) {
      case 16: return (int)launch_regs<4>(xf, o_r, o_i, tb, wt, rows, scale, packed, s);
      case 32: return (int)launch_regs<5>(xf, o_r, o_i, tb, wt, rows, scale, packed, s);
      case 64: return (int)launch_regs<6>(xf, o_r, o_i, tb, wt, rows, scale, packed, s);
      case 128: return (int)launch_regs<7>(xf, o_r, o_i, tb, wt, rows, scale, packed, s);
      case 256: return (int)launch_regs<8>(xf, o_r, o_i, tb, wt, rows, scale, packed, s);
      case 512: return (int)launch_regs<9>(xf, o_r, o_i, tb, wt, rows, scale, packed, s);
      case 1024: return (int)launch_regs<10>(xf, o_r, o_i, tb, wt, rows, scale, packed, s);
      case 2048: return (int)launch_regs<11>(xf, o_r, o_i, tb, wt, rows, scale, packed, s);
      case 4096: return (int)launch_regs<12>(xf, o_r, o_i, tb, wt, rows, scale, packed, s);
      default: return (int)cudaErrorInvalidValue;
    }
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
