// fft_regs.cuh: the register-resident Stockham core for lines of
// power-of-two length N, 16 <= N <= 4096: contiguous rows (fft_last.cu,
// rfft_last.cu, the z pass of the slabs, the c2r rows of irfft_slab.cu
// and icrfft_last.cu) and, in its column variant, strided axes
// (fft_axis.cu; the y pass of the three slabs); and the mixed lengths
// N = R0 2^k, R0 = 3 or 5 (MixGeo), in the column variant
// (fft_axis_mix.cu) and as rows (MixRowGeo: fft_last_mix.cu, the z pass
// of the c2c slab; the r2c and c2r rows of real_rows_mix.cu). The kernels
// built on it are in regs_kernels.cuh.
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
//
// Mixed lengths (MixGeo, core_mix), the decision: a thread holds V = 4 R0
// values (12 or 20), so P = N / V is a power of two and the column
// variant's whole-lanes rule and lane tiles keep their form. The power
// of two runs first, in radix-4 passes (a radix 2 last where log2 P is
// odd), and one pass of radix V runs last, at stride P: every exchange
// stride is then a power of two, so put and get keep their base-plus-
// constant addresses, and the last pass leaves element t + r P in
// natural order for a coalesced store. (The other order, radix V first,
// makes the strides 12 or 20 times a power of two, which no additive pad
// splits over.) The radix-V butterfly is Good-Thomas (3 x 4 or 5 x 4,
// coprime, so no inner twiddles): hard-coded 3- and 5-point networks on
// the constant roots of 2 pi/3, 2 pi/5 and 4 pi/5, then the radix-4
// network, then a renaming of registers; the inter-pass twiddles are
// W_N^(r (j mod Ns) N/(Ns R)) from the first N rows of the core table,
// as at powers of two. The exchange planes are padded one slot per four
// elements (ColLay<L, 2>): the first pass writes runs of four, so with
// W = 32 / L = 2 or 4 row threads a warp (N >= 768) a pad per 16 would
// put two of them on one bank; one per four keeps every put and get at
// one wavefront for W <= 4 (N <= 1536 and 2560; 3072, W = 8, stays on
// the dense core) at 1.25 N slots a lane.

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

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

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

// The R-point DFT of v[0..R) in place, natural order in and out, R a
// power of two: the radix-2 network, then its digit reversal (a renaming
// of registers).
template <int R, bool INV>
static __device__ __forceinline__ void dft2k(float2* v) {
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

// d times -i (forward) or +i (inverse): the sign of W = exp(-+ 2 pi i/R)
template <bool INV>
static __device__ __forceinline__ float2 mul_i(float2 d) {
  return INV ? make_float2(-d.y, d.x) : make_float2(d.y, -d.x);
}

// The 3-point DFT of (a, b, c) in place: X1, X2 = a - (b + c)/2 -+ i
// sin(2 pi/3) (b - c) (forward), 16 flops.
template <bool INV>
static __device__ __forceinline__ void dft3(float2& a, float2& b, float2& c) {
  constexpr float h = 0.86602540378443865f;  // sin 2 pi/3
  const float2 s = cadd(b, c), d = csub(b, c);
  const float2 m = make_float2(fmaf(-0.5f, s.x, a.x), fmaf(-0.5f, s.y, a.y));
  const float2 e = mul_i<INV>(make_float2(h * d.x, h * d.y));
  a = cadd(a, s);
  b = cadd(m, e);
  c = csub(m, e);
}

// The 5-point DFT of (x0 .. x4) in place, with the constant roots of 2 pi/5
// and 4 pi/5: X1, X4 = x0 + c1 t1 + c2 t2 -+ i (s1 t3 + s2 t4) and X2, X3 =
// x0 + c2 t1 + c1 t2 -+ i (s2 t3 - s1 t4) (forward), t1, t3 = x1 +- x4,
// t2, t4 = x2 +- x3; 48 flops.
template <bool INV>
static __device__ __forceinline__ void dft5(float2& x0, float2& x1,
                                            float2& x2, float2& x3,
                                            float2& x4) {
  constexpr float c1 = 0.30901699437494742f;   // cos 2 pi/5
  constexpr float c2 = -0.80901699437494742f;  // cos 4 pi/5
  constexpr float s1 = 0.95105651629515357f;   // sin 2 pi/5
  constexpr float s2 = 0.58778525229247313f;   // sin 4 pi/5
  const float2 t1 = cadd(x1, x4), t2 = cadd(x2, x3);
  const float2 t3 = csub(x1, x4), t4 = csub(x2, x3);
  const float2 a1 = make_float2(fmaf(c2, t2.x, fmaf(c1, t1.x, x0.x)),
                                fmaf(c2, t2.y, fmaf(c1, t1.y, x0.y)));
  const float2 a2 = make_float2(fmaf(c1, t2.x, fmaf(c2, t1.x, x0.x)),
                                fmaf(c1, t2.y, fmaf(c2, t1.y, x0.y)));
  const float2 e1 = mul_i<INV>(make_float2(fmaf(s2, t4.x, s1 * t3.x),
                                           fmaf(s2, t4.y, s1 * t3.y)));
  const float2 e2 = mul_i<INV>(make_float2(fmaf(-s1, t4.x, s2 * t3.x),
                                           fmaf(-s1, t4.y, s2 * t3.y)));
  x0 = cadd(cadd(x0, t1), t2);
  x1 = cadd(a1, e1);
  x4 = csub(a1, e1);
  x2 = cadd(a2, e2);
  x3 = csub(a2, e2);
}

// The R-point DFT of v[0..R) in place, R = 4 R0 (R0 = 3 or 5, coprime to
// 4), by Good-Thomas, with no twiddles: input n = (4 n1 + R0 n2) mod R;
// R0-point DFTs along n1 (for each n2), then 4-point DFTs along n2 (for
// each k1), leaving X[k] where k1 = k mod R0, k2 = k mod 4 put it (a
// renaming of registers).
template <int R, bool INV>
static __device__ __forceinline__ void dft_pfa(float2* v) {
  constexpr int R0 = R / 4;
  static_assert(R == 12 || R == 20, "radix 12 or 20");
  unroll<0, 4>([&](auto n2c) {
    constexpr int B = R0 * decltype(n2c)::value;
    if constexpr (R0 == 3)
      dft3<INV>(v[B % R], v[(B + 4) % R], v[(B + 8) % R]);
    else
      dft5<INV>(v[B % R], v[(B + 4) % R], v[(B + 8) % R], v[(B + 12) % R],
                v[(B + 16) % R]);
  });
  unroll<0, R0>([&](auto k1c) {
    constexpr int B = 4 * decltype(k1c)::value;
    float2 u[4];
    unroll<0, 4>([&](auto n) {
      u[decltype(n)::value] = v[(B + R0 * decltype(n)::value) % R];
    });
    dft2k<4, INV>(u);
    unroll<0, 4>([&](auto n) {
      v[(B + R0 * decltype(n)::value) % R] = u[decltype(n)::value];
    });
  });
  float2 t[R];
  unroll<0, R>([&](auto kc) {
    constexpr int K = decltype(kc)::value;
    t[K] = v[(4 * (K % R0) + R0 * (K % 4)) % R];
  });
  unroll<0, R>([&](auto k) { v[decltype(k)::value] = t[decltype(k)::value]; });
}

// The R-point DFT of a pass: radix 2-16, or 12 and 20 (the last pass of a
// mixed length, MixGeo).
template <int R, bool INV>
static __device__ __forceinline__ void dft(float2* v) {
  if constexpr (R == 12 || R == 20)
    dft_pfa<R, INV>(v);
  else
    dft2k<R, INV>(v);
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

template <int L, int SH = 4>
struct ColLay {
  static constexpr bool kVec4 = L == 1;
  static __host__ __device__ constexpr int at(int a) {
    return L == 1 ? phys(a) : (a + (a >> SH)) * L;
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
// V / R butterflies j = t + q P, P = N / V (inputs v[q R + r] = element
// j + r N/R).
template <int N, int R, int NS, bool INV, int V = kE>
static __device__ __forceinline__ void butterflies(float2* v, int t,
                                                   const float2* tab) {
  constexpr int P = N / V;
  unroll<0, V / R>([&](auto qc) {
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
template <int N, int R, int NS, typename Lay, int V = kE>
static __device__ __forceinline__ void put(float* sre, float* sim,
                                           const float2* v, int t) {
  constexpr int P = N / V;
  unroll<0, V / R>([&](auto qc) {
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
template <int N, int R, typename Lay, int V = kE>
static __device__ __forceinline__ void get(const float* sre, const float* sim,
                                           float2* v, int t) {
  constexpr int P = N / V;
  unroll<0, V / R>([&](auto qc) {
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
template <int N, int R, int V = kE, typename F>
static __device__ __forceinline__ void each(float2* v, int t, F f) {
  constexpr int P = N / V;
  unroll<0, V / R>([&](auto qc) {
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

// ---- mixed lengths N = R0 2^K, R0 = 3 or 5 (the column variant) ----
// Each thread holds V = 4 R0 values (12 or 20), so a line takes P = N / V
// threads, a power of two. The passes run the power of two first, radix
// 4 (radix 2 last where log2 P is odd), then one pass of radix V at
// stride P: every exchange then has a power-of-two stride and keeps the
// base-plus-constant addresses of put and get, and the last pass leaves
// element t + r P in natural order for the store. (48, 80: (4, V); 96,
// 160: (4, 2, V); 192, 320: (4, 4, V); 384, 640: (4, 4, 2, V); 768,
// 1280: (4, 4, 4, V); 1536, 2560: (4, 4, 4, 2, V).)
template <int N>
struct MixGeo {
  static constexpr int R0 = N % 3 == 0 ? 3 : 5;
  static constexpr int V = 4 * R0;  // complex values a thread holds
  static constexpr int P = N / V;   // threads a line
  static constexpr int LP = ilog2(P);
  static_assert(N % V == 0 && P >= 4 && P == 1 << LP,
                "mixed length: N = R0 2^K, R0 = 3 or 5, N >= 16 R0");
  static constexpr int NPASS = (LP + 1) / 2 + 1;
  __host__ __device__ static constexpr int radix(int p) {
    return p == NPASS - 1 ? V : (p == NPASS - 2 && LP % 2) ? 2 : 4;
  }
  __host__ __device__ static constexpr int stride(int p) {
    return p == 0 ? 1 : stride(p - 1) * radix(p - 1);
  }
};

// Passes PASS .. NPASS - 1 of a mixed length: the exchange of pass
// PASS - 1's outputs, then pass PASS's loads and butterflies.
template <int N, int PASS, bool INV, typename Lay>
static __device__ __forceinline__ void mix_passes(float2* v, float* sre,
                                                  float* sim, int t,
                                                  const float2* tab) {
  using M = MixGeo<N>;
  if constexpr (PASS < M::NPASS) {
    constexpr int R = M::radix(PASS), RP = M::radix(PASS - 1);
    if constexpr (PASS > 1) Lay::template sync<N>();
    put<N, RP, M::stride(PASS - 1), Lay, M::V>(sre, sim, v, t);
    Lay::template sync<N>();
    get<N, R, Lay, M::V>(sre, sim, v, t);
    butterflies<N, R, M::stride(PASS), INV, M::V>(v, t, tab);
    mix_passes<N, PASS + 1, INV, Lay>(v, sre, sim, t, tab);
  }
}

// The length-N DFT of one line at a mixed length, as core does at a power
// of two (the same arguments; v holds V = MixGeo<N>::V values). On
// return v holds output element t + r P in v[r] (walk it with
// outputs_mix); synchronise before writing the exchange planes again.
template <int N, bool INV, typename Lay, typename Load>
static __device__ __forceinline__ void core_mix(float2* v, float* sre,
                                                float* sim, int t,
                                                const float2* tab,
                                                Load load) {
  using M = MixGeo<N>;
  constexpr int R = M::radix(0);
  each<N, R, M::V>(v, t, [&](int e, float2& x) { x = load(e); });
  butterflies<N, R, 1, INV, M::V>(v, t, tab);
  mix_passes<N, 1, INV, Lay>(v, sre, sim, t, tab);
}

// Call f(e, value) for each output element the thread holds after core_mix.
template <int N, typename F>
static __device__ __forceinline__ void outputs_mix(float2* v, int t, F f) {
  constexpr int V = MixGeo<N>::V;
  each<N, V, V>(v, t, [&](int e, float2& x) { f(e, x); });
}

// ---- mixed lengths as rows (MixRowGeo, core_mix_rows) ----
// The rows of fft_last.cu and the c2c slab's z pass at N = R0 2^K
// (fft_last_mix.cu): MixGeo's values, threads and passes, in a 256-thread
// block of ROWS = 256 / P rows (one row at 3072, P = 256), each in its own
// planes at a pitch of a multiple of 32 floats. No additive pad serves
// here: a warp's gets read aligned runs of 32 (or of P) elements, so only
// a pad on element bits 5 and up keeps them whole, and the puts of the
// radix-4 pass at stride 4 (runs of four, 16 apart) and of the pass at
// stride 16 (runs of 16, 32 or 64 apart) then ask of those bits more than
// a sum can give (at P = 32 they contradict). The row map is a swizzle:
// element a sits at at(a) = a ^ 20 (a bit 5) ^ 24 (a bit 6), a permutation
// of each aligned run of 32 floats that keeps runs of four whole (so the
// first pass's float4 stores stay), and rows sharing a warp (P < 32) XOR
// row_mask(g) on top. Every put and get then takes one wavefront
// (regcore.bank_ways). The swizzle is linear over XOR, so an exchange
// address is the thread's swizzled base XOR a compile-time constant: the
// constant's low five bits by a LOP3, the rest as the access's immediate
// offset (xor_off).
template <int N>
struct MixRowGeo {
  using M = MixGeo<N>;
  static constexpr int V = M::V, P = M::P;
  static_assert(P <= kThreads, "a row within one block");
  static constexpr int ROWS = kThreads / P;  // rows per block
  static constexpr int PITCH = (N + 31) / 32 * 32;
  static constexpr size_t SMEM = (size_t)2 * ROWS * PITCH * sizeof(float);
  static __host__ __device__ constexpr int at(int a) {
    return a ^ (20 * ((a >> 5) & 1)) ^ (24 * ((a >> 6) & 1));
  }
  // where W = 32 / P rows share a warp, bit i of g flips the bits of
  // 4 (7 - log2 W + i)
  static __host__ __device__ constexpr int row_mask(int g) {
    constexpr int NB = P >= 32 ? 0 : ilog2(32 / P);
    int m = 0;
    for (int i = 0; i < NB; ++i) m ^= ((g >> i) & 1) * 4 * (7 - NB + i);
    return m;
  }
};

// x ^ C where x's bits from 5 up are disjoint from C's: the low five bits
// by XOR, the rest added (a compile-time offset of the access)
template <int C>
static __device__ __forceinline__ int xor_off(int x) {
  if constexpr ((C & 31) == 0)
    return x + C;
  else
    return (x ^ (C & 31)) + (C & ~31);
}

template <int N>
static __device__ __forceinline__ void mix_row_sync() {
  if (MixGeo<N>::P > 32)
    __syncthreads();
  else
    __syncwarp();
}

// put of a mixed row: output r of butterfly j = t + q P to d + r NS, d =
// (j div NS) NS R + j mod NS = X + q P R, X = (t div NS) NS R + t mod NS
// (t's part; NS < P); gm the row's mask. The first pass (NS = 1) stores
// its runs of four as float4.
template <int N, int R, int NS>
static __device__ __forceinline__ void put_rows_mix(float* sre, float* sim,
                                                    const float2* v, int t,
                                                    int gm) {
  using G = MixRowGeo<N>;
  constexpr int P = G::P;
  const int x = G::at((t / NS) * NS * R + t % NS) ^ gm;
  unroll<0, G::V / R>([&](auto qc) {
    constexpr int Q = decltype(qc)::value;
    if constexpr (NS == 1 && R == 4) {
      const int a = xor_off<G::at(Q * P * R)>(x);
      *reinterpret_cast<float4*>(sre + a) =
          make_float4(v[4 * Q].x, v[4 * Q + 1].x, v[4 * Q + 2].x,
                      v[4 * Q + 3].x);
      *reinterpret_cast<float4*>(sim + a) =
          make_float4(v[4 * Q].y, v[4 * Q + 1].y, v[4 * Q + 2].y,
                      v[4 * Q + 3].y);
    } else {
      unroll<0, R>([&](auto r) {
        constexpr int K = decltype(r)::value;
        const int a = xor_off<G::at(Q * P * R + K * NS)>(x);
        sre[a] = v[Q * R + K].x;
        sim[a] = v[Q * R + K].y;
      });
    }
  });
}

// get of a mixed row: v[q R + r] = element j + r N/R = t + P (q + r V/R)
template <int N, int R>
static __device__ __forceinline__ void get_rows_mix(const float* sre,
                                                    const float* sim,
                                                    float2* v, int t,
                                                    int gm) {
  using G = MixRowGeo<N>;
  constexpr int P = G::P;
  const int x = G::at(t) ^ gm;
  unroll<0, G::V / R>([&](auto qc) {
    unroll<0, R>([&](auto r) {
      constexpr int Q = decltype(qc)::value, K = decltype(r)::value;
      const int a = xor_off<G::at(P * (Q + K * (G::V / R)))>(x);
      v[Q * R + K] = make_float2(sre[a], sim[a]);
    });
  });
}

template <int N, int PASS, bool INV>
static __device__ __forceinline__ void mix_row_passes(float2* v, float* sre,
                                                      float* sim, int t,
                                                      int gm,
                                                      const float2* tab) {
  using M = MixGeo<N>;
  if constexpr (PASS < M::NPASS) {
    constexpr int R = M::radix(PASS), RP = M::radix(PASS - 1);
    if constexpr (PASS > 1) mix_row_sync<N>();
    put_rows_mix<N, RP, M::stride(PASS - 1)>(sre, sim, v, t, gm);
    mix_row_sync<N>();
    get_rows_mix<N, R>(sre, sim, v, t, gm);
    butterflies<N, R, M::stride(PASS), INV, M::V>(v, t, tab);
    mix_row_passes<N, PASS + 1, INV>(v, sre, sim, t, gm, tab);
  }
}

// The length-N DFT of one mixed row, as core_mix does for a line of the
// column variant: (sre, sim) the row's planes, t the thread's index in
// it, gm = MixRowGeo<N>::row_mask(row in block). On return v holds output
// element t + r P in v[r] (outputs_mix).
template <int N, bool INV, typename Load>
static __device__ __forceinline__ void core_mix_rows(float2* v, float* sre,
                                                     float* sim, int t,
                                                     int gm,
                                                     const float2* tab,
                                                     Load load) {
  using M = MixGeo<N>;
  static_assert(M::radix(0) == 4, "a radix-4 first pass");
  each<N, 4, M::V>(v, t, [&](int e, float2& x) { x = load(e); });
  butterflies<N, 4, 1, INV, M::V>(v, t, tab);
  mix_row_passes<N, 1, INV>(v, sre, sim, t, gm, tab);
}

}  // namespace regs
}  // namespace offt
