// regs_kernels.cuh: the kernels built on the register core of fft_regs.cuh,
// and their launchers, for power-of-two lengths 16 <= N <= 4096 (and the
// column variant's mixed lengths):
// - rows_c2c: c2c of contiguous rows (fft_last.cu; the z pass of
//   fft_slab.cu), rows at their own input and output pitch;
// - rows_r2c: r2c of real rows read as float2 pairs, the M-point core and
//   the O(M) untangle (rfft_last.cu; the z pass of rfft_slab.cu);
// - rows_c2r: c2r of packed half-spectrum rows, the re-tangle as the core
//   loads, the inverse M-point core, float2 stores (irfft_slab.cu,
//   icrfft_last.cu); rows_r2c and rows_c2r at the mixed M of the rows
//   (MixRowGeo) are rows_r2c_mix and rows_c2r_mix, in real_rows_mix.cu;
// - cols_c2c: the column variant, c2c along a strided axis (fft_axis.cu;
//   the y pass of the slabs), on the (B, N, Y, Z) geometry of fft_axis.cu,
//   in blocks of 256 threads or of 32 lines up to 1024 threads;
// - cols_mix: cols_c2c at the mixed lengths N = R0 2^k (MixGeo;
//   fft_axis_mix.cu);
// - rows_mix: rows_c2c at the mixed lengths (MixRowGeo; fft_last_mix.cu,
//   also the z pass of fft_slab.cu);
// - cols_twiddle: the column variant times a twiddle table at its store
//   (the four-step step 1, fourstep.cu);
// - rows_transposed: c2c of contiguous rows written transposed through a
//   shared stage, R rows a block or a cluster of C blocks (the four-step
//   step 3, fourstep.cu);
// - ClusterSlab, cluster_cols: a slab of Y x Z held by a cluster of C
//   blocks in shared memory, and its y pass (fft_slab.cu, rfft_slab.cu;
//   irfft_slab.cu runs y first, into the slab).
// Each reads all of its line before it writes any of it, and no two
// blocks share an element, so each may run in place. rows_c2c,
// cols_c2c, cols_twiddle and rows_transposed are each a __global__
// wrapper around a device body of one block (rows_block, cols_block,
// cols_twiddle_block, rows_transposed_block), which the register cube
// (fft_cube_regs.cu) runs as the phases of one cooperative grid.
// CORE = false in cluster_cols compiles a cost probe of the slab kernels:
// the same loads and stores with the transform left out. No main path
// launches one.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

#include "fft_core.cuh"
#include "fft_regs.cuh"

namespace offt {
namespace regs {

// rows of fewer threads than this (N < 128) move through a shared stage
constexpr int kStagedBelow = 8;

// f(std::integral_constant<int, LOG>) for n = 2^LOG in [16, 4096]; an
// error for any other n
template <int LOG = 4, typename F>
static cudaError_t by_log(int n, F&& f) {
  if constexpr (LOG > 12) {
    return cudaErrorInvalidValue;
  } else {
    if (n == (1 << LOG)) return f(std::integral_constant<int, LOG>());
    return by_log<LOG + 1>(n, std::forward<F>(f));
  }
}

// f(std::integral_constant<int, N>) for n = R0 2^k, 16 R0 <= n <= LAST;
// an error for any other n
template <int R0, int N = 16 * R0, int LAST = 512 * R0, typename F>
static cudaError_t by_mixed(int n, F&& f) {
  if constexpr (N > LAST) {
    return cudaErrorInvalidValue;
  } else {
    if (n == N) return f(std::integral_constant<int, N>());
    return by_mixed<R0, 2 * N, LAST>(n, std::forward<F>(f));
  }
}

// The kernels' bodies take their block's index `blk` and the thread's
// index `tid` (blockIdx.x and threadIdx.x in their own kernel): the cube
// kernel (fft_cube_regs.cu) runs them as the phases of one cooperative
// grid, each block walking many, its tid opaque to the compiler so that
// no body's thread-invariant values are hoisted out of its phase.

// rows_c2c's block blk
template <int LOG, bool INV>
static __device__ __forceinline__ void rows_block(
    const float* xr, const float* xi, float* yr, float* yi,
    const float2* __restrict__ tab, long long rows, long long ipitch,
    long long opitch, float scale, unsigned blk, unsigned tid) {
  using G = Geo<LOG>;
  constexpr int N = G::N;
  extern __shared__ __align__(16) float rsmem[];
  const int g = tid / G::P;
  const int t = tid % G::P;
  const long long row = (long long)blk * G::ROWS + g;
  const bool valid = row < rows;
  float* sre = rsmem + g * G::PITCH;
  float* sim = rsmem + (G::ROWS + g) * G::PITCH;
  float2 v[kE];
  if constexpr (G::P >= kStagedBelow) {
    const long long in = row * ipitch, out = row * opitch;
    core<LOG, INV>(v, sre, sim, t, tab, [&](int e) {
      return valid ? make_float2(xr[in + e], xi[in + e])
                   : make_float2(0.f, 0.f);
    });
    if (!valid) return;
    outputs<LOG>(v, t, [&](int e, float2 y) {
      yr[out + e] = y.x * scale;
      yi[out + e] = y.y * scale;
    });
  } else {
    // rows of so few threads would read and write device memory a whole
    // row apart: the block's rows move through a stage (both planes, row
    // pitch N + 1) with consecutive threads on consecutive floats of a row
    constexpr int S = N + 1;
    float* st = rsmem + (G::NPASS > 1 ? 2 * G::ROWS * G::PITCH : 0);
    const long long row0 = (long long)blk * G::ROWS;
    const long long left = rows - row0;
    const int tot = (left < G::ROWS ? (int)left : G::ROWS) * N;
    for (int i = tid; i < tot; i += kThreads) {
      const int a = (i >> LOG) * S + (i & (N - 1));
      const long long o = (row0 + (i >> LOG)) * ipitch + (i & (N - 1));
      st[a] = xr[o];
      st[G::ROWS * S + a] = xi[o];
    }
    __syncthreads();
    const float* pr = st + g * S;
    const float* pi = st + G::ROWS * S + g * S;
    core<LOG, INV>(v, sre, sim, t, tab, [&](int e) {
      return make_float2(pr[e], pi[e]);
    });
    __syncthreads();  // every row has read its stage
    outputs<LOG>(v, t, [&](int e, float2 y) {
      st[g * S + e] = y.x * scale;
      st[G::ROWS * S + g * S + e] = y.y * scale;
    });
    __syncthreads();
    for (int i = tid; i < tot; i += kThreads) {
      const int a = (i >> LOG) * S + (i & (N - 1));
      const long long o = (row0 + (i >> LOG)) * opitch + (i & (N - 1));
      yr[o] = st[a];
      yi[o] = st[G::ROWS * S + a];
    }
  }
}

template <int LOG, bool INV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rows_c2c(const float* xr, const float* xi, float* yr, float* yi,
         const float2* __restrict__ tab, long long rows, long long ipitch,
         long long opitch, float scale) {
  rows_block<LOG, INV>(xr, xi, yr, yi, tab, rows, ipitch, opitch, scale,
                       blockIdx.x, threadIdx.x);
}

// The r2c untangle of the pair (k, M - k), 0 < k < M, from V = DFT_M(v)
// in natural order in a row's planes, V[k] at pa and V[M - k] at pb:
// X[k] = E - i W^k O and X[M - k], E, O = (V[k] +- conj V[M-k]) / 2,
// W^k = w[k]; hs = scale / 2.
template <int M>
static __device__ __forceinline__ void untangle_at(
    const float* sre, const float* sim, const float2* __restrict__ w, int k,
    int pa, int pb, float hs, float2& xk, float2& xmk) {
  const float ar = sre[pa], ai = sim[pa];  // V[k]
  const float br = sre[pb], bi = sim[pb];  // V[M-k]
  // 2E and 2O; hs restores the halves
  const float er = ar + br, ei = ai - bi;
  const float o_r = ar - br, o_i = ai + bi;
  const float2 wk = __ldg(w + k), wm = __ldg(w + (M - k));
  xk = make_float2((er + wk.x * o_i + wk.y * o_r) * hs,
                   (ei - wk.x * o_r + wk.y * o_i) * hs);
  xmk = make_float2((er + wm.x * o_i - wm.y * o_r) * hs,
                    (-ei + wm.x * o_r + wm.y * o_i) * hs);
}

// untangle_at with V at the power-of-two rows' pad map phys
template <int M>
static __device__ __forceinline__ void untangle_pair(
    const float* sre, const float* sim, const float2* __restrict__ w, int k,
    float hs, float2& xk, float2& xmk) {
  untangle_at<M>(sre, sim, w, k, phys(k), phys(M - k), hs, xk, xmk);
}

// r2c of real rows of 2M floats: v[j] = x[2j] + i x[2j+1] (one float2,
// so the input must be 8-byte aligned), the M-point core, then the
// untangle X[k] = E - i W^k O, E, O = (V[k] +- conj V[M-k]) / 2, W^k =
// w[k], from V in natural order in the row's planes; times `scale`.
// packed: M lanes a row at `opitch`, lane 0 = X[0] + i X[M]; else the
// numpy layout, M + 1 lanes, rows contiguous.
template <int LOG>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rows_r2c(const float* x, float* yr, float* yi, const float2* __restrict__ tab,
         const float2* __restrict__ w, long long rows, long long opitch,
         float scale, int packed) {
  using G = Geo<LOG>;
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
  float2 v[kE];
  core<LOG, false>(v, sre, sim, t, tab, [&](int e) {
    return valid ? xrow[e] : make_float2(0.f, 0.f);
  });
  row_sync<M>();
  outputs<LOG>(v, t, [&](int e, float2 y) {  // V in natural order
    const int a = phys(e);
    sre[a] = y.x;
    sim[a] = y.y;
  });
  row_sync<M>();
  // untangle the pairs (k, M - k), k = t + i P over [0, M/2), into
  // registers: lo = X[k], hi = X[M - k] (for k = 0: X[0] + i X[M] packed,
  // else X[0] and X[M]); thread 0 also takes X[M/2]
  const float hs = 0.5f * scale;
  float2 lo[kE / 2], hi[kE / 2], mid;
  unroll<0, kE / 2>([&](auto ic) {
    constexpr int I = decltype(ic)::value;
    const int k = t + I * G::P;
    if (k == 0) {
      const float a = sre[0], b = sim[0];  // phys(0) == 0
      lo[I] = make_float2((a + b) * scale, packed ? (a - b) * scale : 0.f);
      hi[I] = make_float2((a - b) * scale, 0.f);
    } else {
      untangle_pair<M>(sre, sim, w, k, hs, lo[I], hi[I]);
    }
  });
  if (t == 0) untangle_pair<M>(sre, sim, w, M / 2, hs, mid, mid);
  // stage the block's rows at the odd pitch M + 1 (every row's V has been
  // read), then copy out the L = M or M + 1 lanes of each: consecutive
  // threads on consecutive floats of a row, so the block writes whole
  // sectors although a numpy row (M + 1 floats) is odd
  const int L = packed ? M : M + 1;
  float* st_r = rsmem + g * (M + 1);
  float* st_i = rsmem + G::ROWS * G::PITCH + g * (M + 1);
  __syncthreads();
  unroll<0, kE / 2>([&](auto ic) {
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
  const float* sr = rsmem;
  const float* si = rsmem + G::ROWS * G::PITCH;
  for (int i = threadIdx.x; i < tot; i += kThreads) {
    long long o;
    int a;
    if (packed) {
      a = (i >> LOG) * (M + 1) + (i & (M - 1));
      o = (row0 + (i >> LOG)) * opitch + (i & (M - 1));
    } else {
      a = i;
      o = row0 * L + i;
    }
    yr[o] = sr[a];
    yi[o] = si[a];
  }
}

// The c2r re-tangle, element k of the pair (k, M - k) of a packed
// half-spectrum row X (lane 0 = X[0] + i X[M]): V[k] = a[k] X[k] + b[k]
// conj X[(M - k) mod M] from x = X[k], y = X[(M - k) mod M] and
// (a, b) = (ab[2k], ab[2k + 1]) (tables.crfft_table, the scale folded in;
// row 0's a = 0, b = s (1 + i) / 2 is the packed rule V[0] = s ((A + B)
// + i (A - B)) / 2). The thread that loads element M - k calls it with
// x and y swapped, so each element of the pair is one thread's.
static __device__ __forceinline__ float2 retangle_pair(
    float2 x, float2 y, const float2* __restrict__ ab, int k) {
  const float2 a = __ldg(ab + 2 * k), b = __ldg(ab + 2 * k + 1);
  return make_float2(a.x * x.x - a.y * x.y + b.x * y.x + b.y * y.y,
                     a.x * x.y + a.y * x.x + b.y * y.x - b.x * y.y);
}

// The inverse M-point core of a re-tangled packed row, M = 2^LOG: x(e)
// gives X[e] (read twice, as e and as M - e); v, sre, sim, t as in core.
template <int LOG, typename Lay = RowLay, typename X>
static __device__ __forceinline__ void c2r_core(float2* v, float* sre,
                                                float* sim, int t,
                                                const float2* tab,
                                                const float2* ab, X x) {
  constexpr int M = 1 << LOG;
  core<LOG, true, Lay>(v, sre, sim, t, tab, [&](int e) {
    return retangle_pair(x(e), x((M - e) & (M - 1)), ab, e);
  });
}

// c2r of packed planar rows of M lanes at `ipitch` into real rows of 2M
// floats: the re-tangle as the core loads (c2r_core), the inverse M-point
// core, then x[2j], x[2j + 1] = v[j] as one float2 (the output must be
// 8-byte aligned), a warp on consecutive float2: whole sectors from M = 64
// (rows of 4 threads). Rows of 1-2 threads (M = 16, 32) store through a
// stage after the exchange planes: the block's rows are one contiguous run
// of the output. The scale rides ab; the core is unscaled.
template <int LOG>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rows_c2r(const float* xr, const float* xi, float* out,
         const float2* __restrict__ tab, const float2* __restrict__ ab,
         long long rows, long long ipitch) {
  using G = Geo<LOG>;
  constexpr int M = G::N;
  extern __shared__ __align__(16) float rsmem[];
  const int g = threadIdx.x / G::P;
  const int t = threadIdx.x % G::P;
  const long long row = (long long)blockIdx.x * G::ROWS + g;
  const bool valid = row < rows;
  float* sre = rsmem + g * G::PITCH;
  float* sim = rsmem + (G::ROWS + g) * G::PITCH;
  const long long in = row * ipitch;
  float2 v[kE];
  c2r_core<LOG>(v, sre, sim, t, tab, ab, [&](int e) {
    return valid ? make_float2(xr[in + e], xi[in + e])
                 : make_float2(0.f, 0.f);
  });
  if constexpr (G::P >= 4) {
    if (!valid) return;
    float2* o = reinterpret_cast<float2*>(out) + row * M;
    outputs<LOG>(v, t, [&](int e, float2 y) { o[e] = y; });
  } else {
    float2* st = reinterpret_cast<float2*>(
        rsmem + (G::NPASS > 1 ? 2 * G::ROWS * G::PITCH : 0));
    outputs<LOG>(v, t, [&](int e, float2 y) { st[g * M + e] = y; });
    __syncthreads();
    const long long row0 = (long long)blockIdx.x * G::ROWS;
    const long long left = rows - row0;
    const int tot = (left < G::ROWS ? (int)left : G::ROWS) * M;
    float2* o = reinterpret_cast<float2*>(out) + row0 * M;
    for (int i = threadIdx.x; i < tot; i += kThreads) o[i] = st[i];
  }
}

// Blocks an SM the column variant's launch bounds ask for: three of 256
// threads at 80 registers; 1024 threads at 64 registers in larger blocks
// (no spill at N = 256 to 2048).
__host__ __device__ constexpr int col_min_blocks(int nt) {
  return nt == kThreads ? kMinBlocks : 1024 / nt;
}

// The column variant: c2c along the n axis of (B, N, Y, Z), element
// (b, n, y, z) at b sb + n sn + y sy + z (g: separate input and output
// strides), one line per lane l = y Z + z; a block of NT threads takes
// L = NT / P consecutive lanes of one b (ColGeo), consecutive blocks
// consecutive tiles, the ragged last tile masked. Times `scale`. SIDE:
// where side_r is not null, lane 0 of each b takes + i side[b N + n] as
// it loads (the c2r y pass's Nyquist plane).
template <int LOG, bool INV, int NT = kThreads, bool SIDE = false>
static __device__ __forceinline__ void cols_block(
    const float* xr, const float* xi, float* yr, float* yi,
    const float2* __restrict__ tab, const AxisGeom& g, long long tiles,
    float scale, const float* __restrict__ side_r,
    const float* __restrict__ side_i, unsigned blk, unsigned tid) {
  using C = ColGeo<LOG, NT>;
  extern __shared__ __align__(16) float csmem[];
  const int l = tid % C::L;
  const int t = tid / C::L;
  const long long b = blk / tiles;
  const long long lane = (blk - b * tiles) * C::L + l;
  const bool valid = lane < g.ny * g.nz;
  const long long y = valid ? lane / g.nz : 0;
  const long long z = valid ? lane - y * g.nz : 0;
  const long long in = b * g.isb + y * g.isy + z;
  const long long out = b * g.osb + y * g.osy + z;
  float* sre = csmem + l;
  float* sim = csmem + C::SIZE + l;
  float2 v[kE];
  core<LOG, INV, typename C::Lay>(v, sre, sim, t, tab, [&](int e) {
    const long long o = in + e * g.isn;
    float2 x = valid ? make_float2(xr[o], xi[o]) : make_float2(0.f, 0.f);
    if constexpr (SIDE) {
      if (side_r != nullptr && lane == 0) {  // + i (side_r + i side_i)
        x.x -= side_i[b * C::N + e];
        x.y += side_r[b * C::N + e];
      }
    }
    return x;
  });
  if (!valid) return;
  outputs<LOG>(v, t, [&](int e, float2 w) {
    const long long o = out + e * g.osn;
    yr[o] = w.x * scale;
    yi[o] = w.y * scale;
  });
}

template <int LOG, bool INV, int NT = kThreads, bool SIDE = false>
__global__ void __launch_bounds__(NT, col_min_blocks(NT))
cols_c2c(const float* xr, const float* xi, float* yr, float* yi,
         const float2* __restrict__ tab, AxisGeom g, long long tiles,
         float scale, const float* __restrict__ side_r,
         const float* __restrict__ side_i) {
  cols_block<LOG, INV, NT, SIDE>(xr, xi, yr, yi, tab, g, tiles, scale,
                                 side_r, side_i, blockIdx.x, threadIdx.x);
}

// The column variant at a mixed length N = R0 2^K (MixGeo): the lines,
// tiles and scale of cols_c2c (no side plane), V = 4 R0 values a thread,
// L = NT / P lanes a block, the exchange planes padded one slot per four
// elements (ColLay<L, 2>: the first put writes runs of four, so a pad per
// 16 would put two row threads of a warp on one bank from W = 2).
template <int N, int NT>
struct MixColGeo {
  static constexpr int P = MixGeo<N>::P;
  static constexpr int L = NT / P;  // lanes per block
  static_assert(L >= 2 && L * P == NT, "whole lanes a block");
  using Lay = ColLay<L, 2>;
  static constexpr int SIZE = (Lay::at(N - 1) + L + 3) / 4 * 4;
  static constexpr size_t SMEM = (size_t)2 * SIZE * sizeof(float);
};

template <int N, bool INV, int NT>
__global__ void __launch_bounds__(NT, col_min_blocks(NT))
cols_mix(const float* xr, const float* xi, float* yr, float* yi,
         const float2* __restrict__ tab, AxisGeom g, long long tiles,
         float scale) {
  using C = MixColGeo<N, NT>;
  extern __shared__ __align__(16) float csmem[];
  const int l = threadIdx.x % C::L;
  const int t = threadIdx.x / C::L;
  const long long b = blockIdx.x / tiles;
  const long long lane = (blockIdx.x - b * tiles) * C::L + l;
  const bool valid = lane < g.ny * g.nz;
  const long long y = valid ? lane / g.nz : 0;
  const long long z = valid ? lane - y * g.nz : 0;
  const long long in = b * g.isb + y * g.isy + z;
  const long long out = b * g.osb + y * g.osy + z;
  float2 v[MixGeo<N>::V];
  core_mix<N, INV, typename C::Lay>(
      v, csmem + l, csmem + C::SIZE + l, t, tab, [&](int e) {
        const long long o = in + e * g.isn;
        return valid ? make_float2(xr[o], xi[o]) : make_float2(0.f, 0.f);
      });
  if (!valid) return;
  outputs_mix<N>(v, t, [&](int e, float2 w) {
    const long long o = out + e * g.osn;
    yr[o] = w.x * scale;
    yi[o] = w.y * scale;
  });
}

// rows_c2c at a mixed length N = R0 2^K (MixRowGeo): ROWS = 256 / P rows
// a block at their own input and output pitch, the ragged last block
// masked, V = 4 R0 values a thread, loads of element t + q P + r N/4 and
// natural-order stores of element t + r P (a warp on consecutive floats
// of a row), times `scale`. Every thread of a row reads the whole input
// before any writes, so it may run in place.
template <int N, bool INV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rows_mix(const float* xr, const float* xi, float* yr, float* yi,
         const float2* __restrict__ tab, long long rows, long long ipitch,
         long long opitch, float scale) {
  using G = MixRowGeo<N>;
  extern __shared__ __align__(16) float rsmem[];
  const int g = threadIdx.x / G::P;
  const int t = threadIdx.x % G::P;
  const long long row = (long long)blockIdx.x * G::ROWS + g;
  const bool valid = row < rows;
  const long long in = row * ipitch, out = row * opitch;
  float2 v[G::V];
  core_mix_rows<N, INV>(v, rsmem + g * G::PITCH,
                        rsmem + (G::ROWS + g) * G::PITCH, t,
                        G::row_mask(g), tab, [&](int e) {
                          return valid ? make_float2(xr[in + e], xi[in + e])
                                       : make_float2(0.f, 0.f);
                        });
  if (!valid) return;
  outputs_mix<N>(v, t, [&](int e, float2 y) {
    yr[out + e] = y.x * scale;
    yi[out + e] = y.y * scale;
  });
}

// Step 1 of the four-step FFT on the column variant: cols_c2c's lines on
// the (B, N, Y, Z) geometry, unscaled, and output n of lane l stored
// times tw[n * lanes + l] (lanes = Y Z; the table carries every scale).
// Lane l of a warp reads table row n at the lane its data has, so the
// table's loads coalesce as the data's do.
template <int LOG, bool INV, int NT>
static __device__ __forceinline__ void cols_twiddle_block(
    const float* xr, const float* xi, float* yr, float* yi,
    const float2* __restrict__ tab, const float2* __restrict__ tw,
    const AxisGeom& g, long long tiles, unsigned blk, unsigned tid) {
  using C = ColGeo<LOG, NT>;
  extern __shared__ __align__(16) float csmem[];
  const int l = tid % C::L;
  const int t = tid / C::L;
  const long long b = blk / tiles;
  const long long lanes = g.ny * g.nz;
  const long long lane = (blk - b * tiles) * C::L + l;
  const bool valid = lane < lanes;
  const long long y = valid ? lane / g.nz : 0;
  const long long z = valid ? lane - y * g.nz : 0;
  const long long in = b * g.isb + y * g.isy + z;
  const long long out = b * g.osb + y * g.osy + z;
  float2 v[kE];
  auto load = [&](int e) {
    const long long o = in + e * g.isn;
    return valid ? make_float2(xr[o], xi[o]) : make_float2(0.f, 0.f);
  };
  // (all table loads first, then the stores, ran 12% slower and spilled)
  auto store = [&](int e, float2 w) {
    const float2 m = __ldg(tw + e * lanes + lane);
    const long long o = out + e * g.osn;
    yr[o] = w.x * m.x - w.y * m.y;
    yi[o] = w.x * m.y + w.y * m.x;
  };
  core<LOG, INV, typename C::Lay>(v, csmem + l, csmem + C::SIZE + l, t, tab,
                                  load);
  if (valid) outputs<LOG>(v, t, store);
}

template <int LOG, bool INV, int NT>
__global__ void __launch_bounds__(NT, col_min_blocks(NT))
cols_twiddle(const float* xr, const float* xi, float* yr, float* yi,
             const float2* __restrict__ tab, const float2* __restrict__ tw,
             AxisGeom g, long long tiles) {
  cols_twiddle_block<LOG, INV, NT>(xr, xi, yr, yi, tab, tw, g, tiles,
                                   blockIdx.x, threadIdx.x);
}

// Distributed shared memory through 32-bit addresses (a generic pointer
// per element costs two registers): the float at shared-memory address
// `a` (a 32-bit shared window offset) of the cluster's block `rank`,
// loaded or stored (mapa maps it into that block's window).
static __device__ __forceinline__ unsigned cluster_addr(unsigned a,
                                                        unsigned rank) {
  unsigned r;
  asm("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

static __device__ __forceinline__ float ld_cluster(unsigned a,
                                                   unsigned rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];"
               : "=f"(v)
               : "r"(cluster_addr(a, rank)));
  return v;
}

static __device__ __forceinline__ void st_cluster(unsigned a, unsigned rank,
                                                  float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;"
               :
               : "r"(cluster_addr(a, rank)), "f"(v)
               : "memory");
}

// ---- rows written transposed (step 3 of the four-step FFT) ----
// The row kernel on rows (b, k1) of a (B, n1, N) array, output (k1, k)
// written to (b N + k) n1 + k1. A block of NT threads holds R = NT / P
// consecutive rows. After the core each row writes its outputs into a
// stage of both planes, [k][c] for the block's row c at slot at(k, c),
// and the block then stores each k's run of R floats (a thread per row c,
// consecutive threads on consecutive k1): whole 32-byte sectors from
// R = 8. The stage's columns are XOR-swizzled (`at`) so that both the
// outputs' writes (a warp: W = 32 / P rows of P threads on consecutive
// k, or one row) and the runs' reads (a warp: 32 / R whole rows of the
// stage) take one wavefront. The stage reuses the rows' exchange planes
// (each row has read its own before the block writes the stage).
template <int LOG, int NT>
struct TrGeo {
  using G = Geo<LOG>;
  static constexpr int N = G::N, P = G::P;
  static constexpr int R = NT / P;  // rows a block
  static_assert(R >= 1 && R * P == NT && NT >= 32, "whole rows, a warp");
  static constexpr int W = P < 32 ? 32 / P : 1;  // rows a warp
  static constexpr int RS = R < 32 ? R : 32;     // swizzled columns
  static constexpr int SH = ilog2(32 / RS);
  // slot of stage element (k, c): the bank bits that k mod (32 / RS)
  // leaves free take k's next bits, above the W rows a warp writes
  static __host__ __device__ constexpr int at(int k, int c) {
    return k * R + (c ^ (((k >> SH) * W) & (RS - 1)));
  }
  static constexpr size_t EX =
      G::NPASS > 1 ? (size_t)2 * R * G::PITCH * sizeof(float) : 0;
  static constexpr size_t ST = (size_t)2 * N * R * sizeof(float);
  static constexpr size_t SMEM = EX > ST ? EX : ST;
};

// the block of the transposing row kernel at N = 2^LOG: 256 threads to
// N = 512 (R = 4096 / N rows), then 8 rows up to 1024 threads (4 at 4096,
// where two blocks make a cluster)
template <int LOG>
__host__ __device__ constexpr int tr_threads() {
  return Geo<LOG>::P * 8 <= kThreads ? kThreads
         : Geo<LOG>::P * 8 < 1024    ? Geo<LOG>::P * 8
                                     : 1024;
}

// the core of a transposing row block: the rows' transforms, then the
// stage written (both planes, at `at`); `valid` masks the rows past `rows`
template <int LOG, bool INV, int NT>
static __device__ __forceinline__ void rows_to_stage(
    const float* xr, const float* xi, const float2* tab, float* smem,
    long long row0, long long rows, unsigned tid) {
  using T = TrGeo<LOG, NT>;
  const int g = tid / T::P;
  const int t = tid % T::P;
  const long long row = row0 + g;
  const bool valid = row < rows;
  const long long in = row * T::N;
  float2 v[kE];
  auto load = [&](int e) {
    return valid ? make_float2(xr[in + e], xi[in + e])
                 : make_float2(0.f, 0.f);
  };
  core<LOG, INV>(v, smem + g * T::G::PITCH, smem + (T::R + g) * T::G::PITCH,
                 t, tab, load);
  __syncthreads();  // every row has read its exchange planes
  auto put = [&](int e, float2 y) {
    const int a = T::at(e, g);
    smem[a] = y.x;
    smem[T::N * T::R + a] = y.y;
  };
  outputs<LOG>(v, t, put);
}

// (b N + 0) n1 + k1 for row r = b n1 + k1: rows of one block may span
// two batches, so each finds its own
static __device__ __forceinline__ long long tr_base(long long r, long long n,
                                                    long long n1) {
  const long long b = r / n1;
  return b * n * n1 + (r - b * n1);
}

// The kernel: clusters of C blocks (C = 1: one block) hold RC = C R
// consecutive rows, and block q of a cluster stores the outputs
// [q N / C, (q + 1) N / C) of all of them, in runs of RC floats, column c
// read from the stage of block c / R (through 32-bit mapa /
// ld.shared::cluster where C > 1).
template <int LOG, bool INV, int NT, int C>
static __device__ __forceinline__ void rows_transposed_block(
    const float* __restrict__ xr, const float* __restrict__ xi,
    float* __restrict__ yr, float* __restrict__ yi,
    const float2* __restrict__ tab, long long rows, long long n1,
    unsigned blk, unsigned tid) {
  using T = TrGeo<LOG, NT>;
  constexpr int RC = C * T::R;
  static_assert(NT % RC == 0, "whole runs a block");
  extern __shared__ __align__(16) float tsmem[];
  namespace cg = cooperative_groups;
  int q = 0;
  if constexpr (C > 1) q = (int)cg::this_cluster().block_rank();
  const long long row0 = (long long)(blk / C) * RC;
  rows_to_stage<LOG, INV, NT>(xr, xi, tab, tsmem, row0 + q * T::R, rows,
                              tid);
  if constexpr (C > 1)
    cg::this_cluster().sync();  // every stage of the cluster is whole
  else
    __syncthreads();
  const int c = tid % RC;
  const long long r = row0 + c;
  if (r < rows) {
    const long long base = tr_base(r, T::N, n1);
    const int cb = c % T::R;
    const unsigned src = (unsigned)(c / T::R);
    const unsigned re0 = (unsigned)__cvta_generic_to_shared(tsmem);
    const unsigned im0 = re0 + 4u * T::N * T::R;
    unroll<0, kE>([&](auto ic) {
      // NT / RC threads a k, so kE passes cover the block's N / C outputs
      const int k = q * (T::N / C) + tid / RC +
                    decltype(ic)::value * (NT / RC);
      const int a = T::at(k, cb);
      if constexpr (C > 1) {
        yr[base + k * n1] = ld_cluster(re0 + 4u * a, src);
        yi[base + k * n1] = ld_cluster(im0 + 4u * a, src);
      } else {
        yr[base + k * n1] = tsmem[a];
        yi[base + k * n1] = tsmem[T::N * T::R + a];
      }
    });
  }
  if constexpr (C > 1)
    cg::this_cluster().sync();  // no block leaves while another reads it
}

template <int LOG, bool INV, int NT, int C>
__global__ void __launch_bounds__(NT, col_min_blocks(NT))
rows_transposed(const float* __restrict__ xr, const float* __restrict__ xi,
                float* __restrict__ yr, float* __restrict__ yi,
                const float2* __restrict__ tab, long long rows,
                long long n1) {
  rows_transposed_block<LOG, INV, NT, C>(xr, xi, yr, yi, tab, rows, n1,
                                         blockIdx.x, threadIdx.x);
}

// ---- a slab in a cluster's shared memory ----
// The (Y, Z) slab of one x-row, Y = 2^LY, Z = 2^LZ, held by a cluster of C
// blocks: block rank b keeps rows [b YB, (b + 1) YB) at pitch SP in its
// shared memory (both planes), B = YB * Z elements, after the z pass has
// written them there. Its y pass (cluster_cols) then takes the lanes
// [b ZB, (b + 1) ZB), reading each line's elements from the blocks that
// hold them (distributed shared memory), so the slab is read from device
// memory once and written once. B = 4096 (one row group of the row core,
// one lane group of the column variant) up to Y Z = 2^15, else 8192 (two
// of each): C = 8 at 2^16, the portable cluster size (clusters of 16 at
// B = 4096 were slower at 256^2), and 16 at 2^17 (the 512^3 r2c slab;
// non-portable, faster than two grids). The row pitch SP = Z + P where a
// warp of the z pass holds 32 / P rows of P threads (P = Z / 16 < 32), so
// its row writes fall on distinct banks; else Z + L where a warp of the y
// pass reads 32 / L rows of L lanes (L < 32). Where both hold and P != L
// (Y, Z = (256, 128), (512, 256), (1024, 128)) the y reads take two
// wavefronts.
template <int LY, int LZ, int NT_ = kThreads>
struct ClusterSlab {
  static constexpr int NT = NT_;  // threads a block
  static constexpr int Y = 1 << LY, Z = 1 << LZ;
  // the shapes the layout takes (fused_fft._cluster_slab): z rows of at
  // least 8 threads, y lanes at most 64 a block, 2^14 to 2^17 elements
  static constexpr bool OK =
      LZ >= 7 && LY >= 6 && LY + LZ >= 14 && LY + LZ <= 17;
  static constexpr int B = LY + LZ <= 15 ? 4096 : 8192;
  static constexpr int C = OK ? (Y * Z) / B : 1;
  static constexpr int YB = Y / C;
  static constexpr int ZB = Z / C;
  static constexpr int SP = Z + (Geo<LZ>::P < 32   ? Geo<LZ>::P
                                 : ColGeo<LY>::L < 32 ? ColGeo<LY>::L
                                                      : 0);
  static constexpr int PLANE = YB * SP;  // floats of one plane
  // NT != kThreads (the r2c slab's cost probes of wider y reads): blocks
  // of NT threads, the z rows RZ at a time (the threads past the block's
  // YB rows idle), the y lanes on ColGeo<LY, NT>; the slab's layout (SP)
  // is kThreads'
  static constexpr int RZ =
      NT == kThreads ? Geo<LZ>::ROWS
                     : (NT / Geo<LZ>::P < YB ? NT / Geo<LZ>::P : YB);
  static constexpr size_t EXZ =
      NT == kThreads ? Geo<LZ>::SMEM
                     : (size_t)2 * RZ * Geo<LZ>::PITCH * sizeof(float);
  static constexpr size_t EX = EXZ > ColGeo<LY, NT>::SMEM
                                   ? EXZ
                                   : ColGeo<LY, NT>::SMEM;
  // dynamic shared memory of a block: the slab's planes, then the
  // exchange planes of the row core and, after it, of the column variant
  static constexpr size_t SMEM = 2 * PLANE * sizeof(float) + EX;
  // blocks an SM its 228 KB of shared memory hold (1 KB a block reserved);
  // the launch bounds' register budget follows
  static constexpr int MINB = (int)((228 << 10) / (SMEM + 1024));
};

// The y pass of a slab held in a cluster (ClusterSlab): the block of rank
// `rank` runs lanes [rank ZB, (rank + 1) ZB) of the Y lines, ColGeo L at a
// time, on the column variant, reading element y of a line from the block
// that holds row y and writing the output to (yr, yi) + y * opitch + z,
// times `scale`. `ex`: the block's exchange planes. The caller syncs the
// cluster before (the slab is whole) and after (no block leaves while
// another reads its slab).
template <int LY, int LZ, bool INV, bool CORE, int NT = kThreads>
static __device__ __forceinline__ void cluster_cols(
    float* slab_re, float* slab_im, float* ex, const float2* tab, float* yr,
    float* yi, long long opitch, float scale, int rank) {
  using S = ClusterSlab<LY, LZ, NT>;
  using C = ColGeo<LY, NT>;
  // lanes a block: ZB, or a tile's L where the tile is wider (the cost
  // probes: the ranks past Z / L run no y lanes)
  constexpr int W = C::L > S::ZB ? C::L : S::ZB;
  if constexpr (W > S::ZB) {
    if (rank * W >= S::Z) return;
  }
  const int l = threadIdx.x % C::L;
  const int t = threadIdx.x / C::L;
  float* sre = ex + l;
  float* sim = ex + C::SIZE + l;
  float2 v[kE];
  const unsigned re0 = (unsigned)__cvta_generic_to_shared(slab_re);
  const unsigned im0 = (unsigned)__cvta_generic_to_shared(slab_im);
  for (int z0 = rank * W; z0 < (rank + 1) * W; z0 += C::L) {
    const int z = z0 + l;
    auto load = [&](int e) {
      const unsigned at = 4u * ((e % S::YB) * S::SP + z);
      return make_float2(ld_cluster(re0 + at, e / S::YB),
                         ld_cluster(im0 + at, e / S::YB));
    };
    auto store = [&](int e, float2& w) {
      yr[e * opitch + z] = w.x * scale;
      yi[e * opitch + z] = w.y * scale;
    };
    if constexpr (CORE) {
      core<LY, INV, typename C::Lay>(v, sre, sim, t, tab, load);
      outputs<LY>(v, t, store);
    } else {
      each<C::N, kE>(v, t, [&](int e, float2& x) { x = load(e); });
      each<C::N, kE>(v, t, store);
    }
    __syncthreads();  // every lane has read the exchange planes
  }
}

// Launch a cluster-slab kernel: `rows` x-rows, C blocks each.
template <typename S, typename K, typename... Args>
static cudaError_t launch_cluster(K kernel, long long rows,
                                  cudaStream_t stream, Args... args) {
  cudaError_t err = allow_smem(kernel, S::SMEM);
  if (err != cudaSuccess) return err;
  if (S::C > 8) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(rows * S::C));
  cfg.blockDim = dim3(S::NT);
  cfg.dynamicSmemBytes = S::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S::C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---- launchers (dynamic shared memory raised past 48 KB where needed) ----

template <int LOG, bool INV>
static cudaError_t launch_rows(const float* xr, const float* xi, float* yr,
                               float* yi, const float2* tab, long long rows,
                               long long ipitch, long long opitch,
                               float scale, cudaStream_t stream) {
  using G = Geo<LOG>;
  // a single pass (N = 16) exchanges nothing; short rows add the stage
  const size_t smem =
      (G::NPASS > 1 ? G::SMEM : 0) +
      (G::P < kStagedBelow ? 2 * G::ROWS * (G::N + 1) * sizeof(float) : 0);
  cudaError_t err = allow_smem(rows_c2c<LOG, INV>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + G::ROWS - 1) / G::ROWS;
  rows_c2c<LOG, INV><<<(unsigned)blocks, kThreads, smem, stream>>>(
      xr, xi, yr, yi, tab, rows, ipitch, opitch, scale);
  return cudaGetLastError();
}

template <int LOG>
static cudaError_t launch_rows_r2c(const float* x, float* yr, float* yi,
                                   const float2* tab, const float2* w,
                                   long long rows, long long opitch,
                                   float scale, int packed,
                                   cudaStream_t stream) {
  using G = Geo<LOG>;
  cudaError_t err = allow_smem(rows_r2c<LOG>, G::SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + G::ROWS - 1) / G::ROWS;
  rows_r2c<LOG><<<(unsigned)blocks, kThreads, G::SMEM, stream>>>(
      x, yr, yi, tab, w, rows, opitch, scale, packed);
  return cudaGetLastError();
}

template <int LOG>
static cudaError_t launch_rows_c2r(const float* xr, const float* xi,
                                   float* out, const float2* tab,
                                   const float2* ab, long long rows,
                                   long long ipitch, cudaStream_t stream) {
  using G = Geo<LOG>;
  const size_t smem = (G::NPASS > 1 ? G::SMEM : 0) +
                      (G::P < 4 ? G::ROWS * G::N * sizeof(float2) : 0);
  cudaError_t err = allow_smem(rows_c2r<LOG>, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + G::ROWS - 1) / G::ROWS;
  rows_c2r<LOG><<<(unsigned)blocks, kThreads, smem, stream>>>(
      xr, xi, out, tab, ab, rows, ipitch);
  return cudaGetLastError();
}

template <int LOG, bool INV, int NT = kThreads, bool SIDE = false>
static cudaError_t launch_cols(const float* xr, const float* xi, float* yr,
                               float* yi, const float2* tab,
                               const AxisGeom& g, float scale,
                               cudaStream_t stream,
                               const float* side_r = nullptr,
                               const float* side_i = nullptr) {
  using C = ColGeo<LOG, NT>;
  cudaError_t err = allow_smem(cols_c2c<LOG, INV, NT, SIDE>, C::SMEM);
  if (err != cudaSuccess) return err;
  const long long tiles = (g.ny * g.nz + C::L - 1) / C::L;
  cols_c2c<LOG, INV, NT, SIDE><<<(unsigned)(tiles * g.nb), NT, C::SMEM,
                                 stream>>>(xr, xi, yr, yi, tab, g, tiles,
                                           scale, side_r, side_i);
  return cudaGetLastError();
}

template <int N, bool INV, int NT>
static cudaError_t launch_cols_mix(const float* xr, const float* xi,
                                   float* yr, float* yi, const float2* tab,
                                   const AxisGeom& g, float scale,
                                   cudaStream_t stream) {
  using C = MixColGeo<N, NT>;
  auto kernel = cols_mix<N, INV, NT>;
  cudaError_t err = allow_smem(kernel, C::SMEM);
  if (err != cudaSuccess) return err;
  const long long tiles = (g.ny * g.nz + C::L - 1) / C::L;
  kernel<<<(unsigned)(tiles * g.nb), NT, C::SMEM, stream>>>(
      xr, xi, yr, yi, tab, g, tiles, scale);
  return cudaGetLastError();
}

template <int N, bool INV>
static cudaError_t launch_rows_mix(const float* xr, const float* xi,
                                   float* yr, float* yi, const float2* tab,
                                   long long rows, long long ipitch,
                                   long long opitch, float scale,
                                   cudaStream_t stream) {
  using G = MixRowGeo<N>;
  auto kernel = rows_mix<N, INV>;
  cudaError_t err = allow_smem(kernel, G::SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + G::ROWS - 1) / G::ROWS;
  kernel<<<(unsigned)blocks, kThreads, G::SMEM, stream>>>(
      xr, xi, yr, yi, tab, rows, ipitch, opitch, scale);
  return cudaGetLastError();
}

template <int LOG, bool INV, int NT>
static cudaError_t launch_cols_twiddle(const float* xr, const float* xi,
                                       float* yr, float* yi,
                                       const float2* tab, const float2* tw,
                                       const AxisGeom& g,
                                       cudaStream_t stream) {
  using C = ColGeo<LOG, NT>;
  auto kernel = cols_twiddle<LOG, INV, NT>;
  cudaError_t err = allow_smem(kernel, C::SMEM);
  if (err != cudaSuccess) return err;
  const long long tiles = (g.ny * g.nz + C::L - 1) / C::L;
  kernel<<<(unsigned)(tiles * g.nb), NT, C::SMEM, stream>>>(
      xr, xi, yr, yi, tab, tw, g, tiles);
  return cudaGetLastError();
}

template <int LOG, bool INV, int NT, int C>
static cudaError_t launch_rows_transposed(const float* xr, const float* xi,
                                          float* yr, float* yi,
                                          const float2* tab, long long rows,
                                          long long n1, cudaStream_t stream) {
  using T = TrGeo<LOG, NT>;
  auto kernel = rows_transposed<LOG, INV, NT, C>;
  cudaError_t err = allow_smem(kernel, T::SMEM);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows + C * T::R - 1) / (C * T::R) * C));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = T::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, xr, xi, yr, yi, tab, rows, n1);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace regs

// The launchers of the mixed lengths, each in a source of its own so that
// nvcc builds their instances beside the others.
// The column variant along the n axis of g (fft_axis_mix.cu): n =
// R0 2^k, 16 <= 2^k <= 512; `tile` the lane tile's code (fft_axis.cu's
// AxisTile), or -1 for the one fused_fft._axis_tile routes.
cudaError_t axis_mix(const float* xr, const float* xi, float* yr, float* yi,
                     const float2* tab, const AxisGeom& g, int n,
                     int inverse, float scale, int tile, cudaStream_t s);
// `rows` rows of length n = R0 2^k (16 <= 2^k <= 512, or 3072) at pitches
// ipitch and opitch, times `scale` (fft_last_mix.cu).
cudaError_t last_mix(const float* xr, const float* xi, float* yr, float* yi,
                     const float2* tab, long long rows, int n,
                     long long ipitch, long long opitch, int inverse,
                     float scale, cudaStream_t s);
// r2c of `rows` real rows of 2m floats, m = R0 2^k (16 <= 2^k <= 512, or
// 3072), into the numpy (m + 1 lanes) or packed (m lanes) planar rows,
// contiguous, times `scale` (real_rows_mix.cu).
cudaError_t rfft_mix(const float* x, float* yr, float* yi, const float2* tab,
                     const float2* w, long long rows, int m, float scale,
                     int packed, cudaStream_t s);
// c2r of `rows` packed planar rows of m lanes (m as rfft_mix), contiguous,
// into real rows of 2m floats; the scale rides ab (real_rows_mix.cu).
cudaError_t icrfft_mix(const float* xr, const float* xi, float* out,
                       const float2* tab, const float2* ab, long long rows,
                       int m, cudaStream_t s);

}  // namespace offt
