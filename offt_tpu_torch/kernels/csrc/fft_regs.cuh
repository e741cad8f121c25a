// fft_regs.cuh: the register-resident Stockham core for lines of
// power-of-two length N, 16 <= N <= 4096: contiguous rows (fft_last.cu,
// rfft_last.cu, the z pass of the slabs, the c2r rows of irfft_slab.cu)
// and, in its column variant, strided axes (fft_axis.cu; the y pass of
// the three slabs). The kernels built on it are in regs_kernels.cuh.
//
// Replaces, on those lengths: the dense shared-memory core of fft_core.cuh
// (itself the port of offt_tpu/kernels/pallas_fft.py _core_apply :428).
// It computes the same function: the length-N DFT in f32 FMA, forward or
// inverse. The scale is the caller's, applied once at its final store.
//
// What bounds it on Hopper: the rows' bytes (8 read and 8 written per
// complex element of a planar c2c). The dense core spends r complex MACs
// and r shared-memory root reads per element and stage (8 * sum(r) flops
// where the transform needs 5 log2 N), and so ran at 0.07-0.11 of the byte
// bound. Design:
// - a row gets P = N / 16 threads, each holding 16 complex values in
//   registers; a 256-thread block holds 256 / P rows (a compile-time
//   function of N), the ragged last block masked by its caller;
// - each pass is a radix-R Stockham autosort pass (R in {2, 4, 8, 16};
//   N = 16 ... 16 * R_last): the thread's butterfly j loads element
//   j + r N/R (r < R), twiddles it by W_N^(r (j mod Ns) N/(Ns R)) read
//   through __ldg from the first N rows of tables.core_table (no sincos),
//   runs a hard-coded radix-2 network with constant roots (+-i,
//   (1 -+ i)/sqrt 2, cos/sin pi/8) and writes output r to
//   (j div Ns) Ns R + (j mod Ns) + r Ns, Ns = 16^pass. About 5 log2 N
//   flops per element;
// - the first pass loads element j + r N/16 (a warp on consecutive
//   addresses) and the last pass leaves element j + r N/R in natural order,
//   so the caller stores it straight to device memory, coalesced in the
//   same way: no digit-reversal map on the store;
// - between passes the values cross the row's threads through shared
//   memory, separate re and im planes, element a at phys(a) = a + 4 (a div
//   32) + 16 (a div 256). That pad makes both exchange patterns free of
//   bank conflicts: the first pass's float4 writes (a = 16 j + 4 i: a
//   quarter-warp's eight 16-byte chunks on distinct bank groups), the
//   second pass's runs (a = 256 (j div 16) + j mod 16 + 16 r: the two
//   half-warps 16 banks apart) and the reads (32 consecutive a). Rows that
//   share a warp (P < 32) start P banks apart (Geo::PITCH). Shared memory
//   holds only that buffer, N * 8 bytes a row plus the pad;
// - rows of P <= 32 threads lie in one warp and exchange under
//   __syncwarp; longer rows under __syncthreads. Every thread of a row
//   reads the whole input before any thread writes the output, so the
//   callers may run in place;
// - every loop that indexes the register array is a compile-time
//   recursion (unroll, dif), so no index is computed at run time and the
//   array never leaves registers; an exchange address is the thread's
//   base plus a constant (the pad map splits over the sums, see put);
//   at N = 1024 the forward kernel is 872 SASS instructions, about 55%
//   of them the butterflies' f32 adds and multiplies;
// - 80 registers a thread (__launch_bounds__ with kMinBlocks = 3: no
//   spills) hold three 256-thread blocks an SM.
//
// The column variant (ColGeo, ColLay) runs the same passes on a line
// whose element e lies at base + e * pitch + lane: the P threads of one
// line span lanes, not a row. A 256-thread block holds L = 256 / P lanes;
// thread (t, l) = (tid / L, tid % L), so a warp takes L consecutive lanes
// of W = 32 / L row threads and every global load and store of a warp
// moves W runs of L consecutive floats: whole 32-byte sectors while
// L >= 8 (N <= 512; at N = 512, 8 lanes of one sector), 16, 8 and 4
// bytes at N = 1024, 2048, 4096. fft_axis.cu launches blocks of up to
// 1024 threads from N = 256 (ColGeo's NT: 32 lanes to N = 512, 16 at
// 1024, 8 at 2048, 4 at 4096). The exchanges put the lane fastest:
// element a of lane l at (a + (a div 16)) * L + l. A warp's W row
// threads access elements a stride 1 or 16 apart (t, or 16 t + r in the
// first put), so the pad of one slot per 16 elements puts them on
// distinct groups of L banks: one wavefront each. At L = 1 (N = 4096 in
// 256 threads) a lane is a row and the row map phys, with its float4
// writes, serves it.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "fft_core.cuh"

namespace offt {
namespace regs {

constexpr int kE = 16;  // complex values a thread holds
// blocks an SM holds: the kernels' register budget (80 a thread)
constexpr int kMinBlocks = 3;

__host__ __device__ constexpr int phys(int a) {
  return a + 4 * (a >> 5) + 16 * (a >> 8);
}

// the least q >= size with q = want (mod 32)
__host__ __device__ constexpr int pitch_to(int size, int want) {
  return size + (((want - size) % 32) + 32) % 32;
}

// compile-time geometry of the length N = 2^LOG
template <int LOG>
struct Geo {
  static_assert(LOG >= 4 && LOG <= 12, "register core: 16 <= N <= 4096");
  static constexpr int N = 1 << LOG;
  static constexpr int P = N / kE;            // threads per row
  static constexpr int ROWS = kThreads / P;   // rows per block
  static constexpr int SIZE = phys(N - 1) + 1;
  // floats of one row in one plane: rows sharing a warp start P banks
  // apart (at least 4, for the 16-byte alignment of the float4 writes)
  static constexpr int PITCH =
      P >= 32 ? SIZE : pitch_to(SIZE, P < 4 ? 4 : P);
  static constexpr int NPASS = (LOG + 3) / 4;
  static constexpr int RLAST = 1 << (LOG - 4 * (NPASS - 1));
  static constexpr int R1 = NPASS == 2 ? RLAST : 16;  // radix of pass 1
  // dynamic shared memory of a block: both planes of every row
  static constexpr size_t SMEM = (size_t)2 * ROWS * PITCH * sizeof(float);
};

// f(I) for I = BEGIN .. END-1 as std::integral_constant: every index into
// a register array below is a constant expression, so no array is left
// in local memory.
template <int BEGIN, int END, typename F>
static __device__ __forceinline__ void unroll(F&& f) {
  if constexpr (BEGIN < END) {
    f(std::integral_constant<int, BEGIN>());
    unroll<BEGIN + 1, END>(f);
  }
}

// ---- complex helpers ----

static __device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
static __device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
static __device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(fmaf(a.x, w.x, -a.y * w.y), fmaf(a.x, w.y, a.y * w.x));
}

// d * W_16^k, k in [0, 8), W in the transform's direction. k is a
// constant once the butterfly loops are unrolled, so every branch folds.
template <bool INV>
static __device__ __forceinline__ float2 rot16(float2 d, int k) {
  constexpr float h = 0.70710678118654752f;   // cos pi/4
  constexpr float c1 = 0.92387953251128674f;  // cos pi/8
  constexpr float s1 = 0.38268343236508978f;  // sin pi/8
  // forward W = exp(-i theta): (x, y) * (c, -s); inverse (c, +s)
  const float sg = INV ? 1.f : -1.f;
  switch (k) {
    case 0:
      return d;
    case 2:  // theta = pi/4
      return INV ? make_float2(h * (d.x - d.y), h * (d.x + d.y))
                 : make_float2(h * (d.x + d.y), h * (d.y - d.x));
    case 4:  // theta = pi/2: times -+i
      return INV ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
    case 6:  // theta = 3 pi/4
      return INV ? make_float2(-h * (d.x + d.y), h * (d.x - d.y))
                 : make_float2(h * (d.y - d.x), -h * (d.x + d.y));
    default: {
      // theta = k pi/8, k odd
      const float c = k == 1 ? c1 : k == 3 ? s1 : k == 5 ? -s1 : -c1;
      const float s = (k == 1 || k == 7) ? s1 : c1;
      return cmul(d, make_float2(c, sg * s));
    }
  }
}

static __host__ __device__ constexpr int brev(int k, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((k >> b) & 1) << (bits - 1 - b);
  return r;
}

// One radix-2 step of width 2 HALF over all of v[0..R), then the next:
// the stages of a decimation-in-frequency network, a template recursion
// so that every loop has a constant trip count and unrolls, and every
// root below is a constant.
template <int R, int HALF, bool INV>
static __device__ __forceinline__ void dif(float2* v) {
  unroll<0, R / (2 * HALF)>([&](auto blk) {
    unroll<0, HALF>([&](auto i) {
      constexpr int A = decltype(blk)::value * 2 * HALF + decltype(i)::value;
      const float2 a = v[A];
      const float2 b = v[A + HALF];
      v[A] = cadd(a, b);
      // W_{2 HALF}^i = W_16^(i * 8 / HALF)
      v[A + HALF] = rot16<INV>(csub(a, b), decltype(i)::value * (8 / HALF));
    });
  });
  if constexpr (HALF > 1) dif<R, HALF / 2, INV>(v);
}

// The R-point DFT of v[0..R) in place, natural order in and out: the
// radix-2 network, then its digit reversal (a renaming of registers).
template <int R, bool INV>
static __device__ __forceinline__ void dft(float2* v) {
  constexpr int BITS = R == 2 ? 1 : R == 4 ? 2 : R == 8 ? 3 : 4;
  static_assert(R == (1 << BITS), "radix 2, 4, 8 or 16");
  dif<R, R / 2, INV>(v);
  float2 t[R];
  unroll<0, R>([&](auto k) {
    constexpr int K = decltype(k)::value;
    t[K] = v[brev(K, BITS)];
  });
  unroll<0, R>([&](auto k) { v[decltype(k)::value] = t[decltype(k)::value]; });
}

// Rows of P <= 32 threads lie in one warp.
template <int N>
static __device__ __forceinline__ void row_sync() {
  if (N / kE > 32)
    __syncthreads();
  else
    __syncwarp();
}

// Where a line's exchange planes keep its element a, and how its threads
// meet. Rows: the row's own planes at phys(a), synchronised by warp when
// the row fits one. Columns of L lanes: the lane is the fastest index
// (the caller's plane pointers carry the lane), and the P threads of a
// lane lie in P different warps.
struct RowLay {
  static constexpr bool kVec4 = true;  // float4 writes in the first pass
  static __host__ __device__ constexpr int at(int a) { return phys(a); }
  template <int N>
  static __device__ __forceinline__ void sync() { row_sync<N>(); }
};

template <int L>
struct ColLay {
  static constexpr bool kVec4 = L == 1;
  static __host__ __device__ constexpr int at(int a) {
    return L == 1 ? phys(a) : (a + (a >> 4)) * L;
  }
  template <int N>
  static __device__ __forceinline__ void sync() { __syncthreads(); }
};

// compile-time geometry of the column variant at N = 2^LOG in a block of
// NT threads
template <int LOG, int NT = kThreads>
struct ColGeo {
  static constexpr int N = 1 << LOG;
  static constexpr int P = N / kE;           // threads per lane
  static constexpr int L = NT / P;           // lanes per block
  static_assert(L >= 1 && L * P == NT, "whole lanes a block");
  using Lay = ColLay<L>;
  // floats of one plane (all L lanes), a multiple of 4 for float4
  static constexpr int SIZE = (Lay::at(N - 1) + L + 3) / 4 * 4;
  static constexpr int NPASS = Geo<LOG>::NPASS;
  // dynamic shared memory of a block: both planes (none for one pass)
  static constexpr size_t SMEM =
      NPASS > 1 ? (size_t)2 * SIZE * sizeof(float) : 0;
};

// Pass of radix R at stride NS: twiddle and butterfly the thread's
// kE / R butterflies j = t + q P (inputs v[q R + r] = element j + r N/R).
template <int N, int R, int NS, bool INV>
static __device__ __forceinline__ void butterflies(float2* v, int t,
                                                   const float2* tab) {
  constexpr int P = N / kE;
  unroll<0, kE / R>([&](auto qc) {
    constexpr int Q = decltype(qc)::value * R;
    if constexpr (NS > 1) {
      const int j = t + decltype(qc)::value * P;
      const int base = (j % NS) * (N / (NS * R));
      unroll<1, R>([&](auto r) {
        constexpr int K = decltype(r)::value;
        v[Q + K] = cmul(v[Q + K], __ldg(tab + K * base));
      });
    }
    dft<R, INV>(v + Q);
  });
}

// Write the pass outputs to the row's exchange planes: output r of
// butterfly j to d + r NS, d = (j div NS) NS R + (j mod NS). The pad map
// splits over these sums (phys(x + c) = phys(x) + phys(c) when c is a
// multiple of a power of two above x), so each store is the thread's
// base phys(d) plus a compile-time offset.
template <int N, int R, int NS, typename Lay>
static __device__ __forceinline__ void put(float* sre, float* sim,
                                           const float2* v, int t) {
  constexpr int P = N / kE;
  unroll<0, kE / R>([&](auto qc) {
    constexpr int Q = decltype(qc)::value * R;
    const int j = t + decltype(qc)::value * P;
    const int d = Lay::at((j / NS) * NS * R + (j % NS));
    if constexpr (NS == 1 && R % 4 == 0 && Lay::kVec4) {
      // R consecutive elements from d (a multiple of 4): float4 stores
      unroll<0, R / 4>([&](auto c) {
        constexpr int K = Q + 4 * decltype(c)::value;
        constexpr int OFF = Lay::at(4 * decltype(c)::value);
        *reinterpret_cast<float4*>(sre + d + OFF) =
            make_float4(v[K].x, v[K + 1].x, v[K + 2].x, v[K + 3].x);
        *reinterpret_cast<float4*>(sim + d + OFF) =
            make_float4(v[K].y, v[K + 1].y, v[K + 2].y, v[K + 3].y);
      });
    } else {
      unroll<0, R>([&](auto r) {
        constexpr int OFF = Lay::at(decltype(r)::value * NS);
        sre[d + OFF] = v[Q + decltype(r)::value].x;
        sim[d + OFF] = v[Q + decltype(r)::value].y;
      });
    }
  });
}

// Read the inputs of a radix-R pass: v[q R + r] = element j + r N/R,
// at the thread's base phys(j) plus a compile-time offset (see put).
template <int N, int R, typename Lay>
static __device__ __forceinline__ void get(const float* sre, const float* sim,
                                           float2* v, int t) {
  constexpr int P = N / kE;
  unroll<0, kE / R>([&](auto qc) {
    constexpr int Q = decltype(qc)::value * R;
    const int b = Lay::at(t + decltype(qc)::value * P);
    unroll<0, R>([&](auto r) {
      constexpr int OFF = Lay::at(decltype(r)::value * (N / R));
      v[Q + decltype(r)::value] = make_float2(sre[b + OFF], sim[b + OFF]);
    });
  });
}

// Call f(e, v[q R + r]) for element e = j + r N/R of a radix-R pass, in
// the order of the loads.
template <int N, int R, typename F>
static __device__ __forceinline__ void each(float2* v, int t, F f) {
  constexpr int P = N / kE;
  unroll<0, kE / R>([&](auto qc) {
    unroll<0, R>([&](auto r) {
      constexpr int Q = decltype(qc)::value, K = decltype(r)::value;
      f(t + Q * P + K * (N / R), v[Q * R + K]);
    });
  });
}

// The length-2^LOG DFT of one line held by its P threads; t is the
// thread's index in the line, (sre, sim) the line's exchange planes laid
// out by Lay (RowLay: a row's own planes; ColLay: the block's planes
// offset by the lane). load(e) gives input element e (each exactly once).
// On return v holds the output, element j + r N/R in v[q R + r] with
// R = Geo<LOG>::RLAST, j = t + q P (walk it with `outputs`). The line's
// threads may still be reading the exchange planes: synchronise
// (Lay::sync) before writing them again.
template <int LOG, bool INV, typename Lay = RowLay, typename Load>
static __device__ __forceinline__ void core(float2* v, float* sre, float* sim,
                                            int t, const float2* tab,
                                            Load load) {
  using G = Geo<LOG>;
  constexpr int N = G::N;
  each<N, 16>(v, t, [&](int e, float2& x) { x = load(e); });
  butterflies<N, 16, 1, INV>(v, t, tab);
  if constexpr (G::NPASS > 1) {
    put<N, 16, 1, Lay>(sre, sim, v, t);
    Lay::template sync<N>();
    get<N, G::R1, Lay>(sre, sim, v, t);
    butterflies<N, G::R1, 16, INV>(v, t, tab);
  }
  if constexpr (G::NPASS > 2) {
    Lay::template sync<N>();
    put<N, 16, 16, Lay>(sre, sim, v, t);
    Lay::template sync<N>();
    get<N, G::RLAST, Lay>(sre, sim, v, t);
    butterflies<N, G::RLAST, 256, INV>(v, t, tab);
  }
}

// Call f(e, value) for each output element the thread holds after core.
template <int LOG, typename F>
static __device__ __forceinline__ void outputs(float2* v, int t, F f) {
  each<Geo<LOG>::N, Geo<LOG>::RLAST>(v, t, [&](int e, float2& x) { f(e, x); });
}

}  // namespace regs
}  // namespace offt
