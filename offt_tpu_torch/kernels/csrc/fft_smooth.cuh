// fft_smooth.cuh: the register core at the 5-smooth lengths N = R 2^K,
// R = 3^a 5^b > 1, K >= 2, N <= 4096, that no power-of-two or mixed core
// takes (and the odd and twice-odd ones, and the lengths with a factor 7:
// the third and fourth families below). The first family, odd part R of
// 9, 15, 25 or 45 and K >= 3 (72-2304, 120-3840, 200-3200, 360-2880;
// smooth_length), runs as rows
// (rows_smooth: fft_last.cu through fft_last_smooth.cu, the z pass of
// fft_slab.cu), in the column variant (cols_smooth: fft_axis.cu through
// fft_axis_smooth.cu, the y pass of fft_slab.cu), and as the real rows of
// rfft_last.cu and icrfft_last.cu at those half lengths M
// (rows_r2c_smooth, rows_c2r_smooth of real_rows_smooth.cuh:
// real_rows_smooth.cu). The second family, every other such length
// (smooth_more_length: 12, 20, 24, 36, 40, 60, 100, 180 and the odd parts
// 27, 75, 81, 125, 135, 225, 243, 375, 405, 625, 675, 729; 42 lengths,
// 12-4000), runs as rows (fft_last_smooth3.cu, fft_last_smooth5.cu by R0),
// columns (fft_axis_smooth3.cu, fft_axis_smooth5.cu) and real rows at
// those half lengths (real_rows_smooth3.cu, real_rows_smooth5.cu). The
// third family, the odd and twice-odd lengths R 2^K, K = 0 or 1, in
// [16, 4096] (smooth_odd_length: 18-4050, 42 lengths), runs as rows
// (fft_last_smooth_odd3.cu, fft_last_smooth_odd5.cu by R0) and, where
// smooth_odd_col (P <= 128 and planes within a block), as columns
// (fft_axis_smooth_odd3.cu, fft_axis_smooth_odd5.cu), and as real rows at
// those half lengths (real_rows_smooth_odd3.cu, real_rows_smooth_odd5.cu).
// The fourth family, the 7-smooth lengths R 2^K, K >= 2, whose odd part R =
// 3^a 5^b 7^c has a factor 7 (smooth7_length: 28-4032, 56 lengths), runs
// as c2c rows (fft_last_smooth7.cu, fft_last_smooth7x3.cu,
// fft_last_smooth7x5.cu by the odd part) and, where smooth7_col (P <= 128
// and planes within a block), as columns (fft_axis_smooth7.cu,
// fft_axis_smooth7x3.cu, fft_axis_smooth7x5.cu); its real rows keep the
// dense core. Every other length keeps
// its core: the powers of two and R0 2^k (R0 = 3, 5, 2^k >= 16) of
// fft_regs.cuh, the dense core of fft_core.cuh; the real slabs, the
// four-step pair and the cube keep theirs at these lengths too.
//
// Replaces, at those lengths: the dense shared-memory core of fft_core.cuh
// (the port of offt_tpu/kernels/pallas_fft.py _core_apply :428). It
// computes the same function, the length-N DFT in f32 FMA, forward or
// inverse; the roots are the first N rows of tables.core_table; the scale
// is the caller's, applied once at the store.
//
// The decision. fft_regs.cuh's mixed design holds V = 4 R0 values a
// thread on P = N / V threads, a power of two; an odd part of 9 or more
// would ask for 36-2916 values a thread there. Here a thread keeps V0 =
// 4 R0 values (R0 = 5 where 25 divides R or 3 does not, else 3), so P =
// N / V0 = (R / R0) 2^(K-2) threads a line, not a power of two, and each
// further odd factor gets a pass of its own:
// - radix-4 passes (a radix 2 last where K is odd) over 2^(K-2), none at
//   K = 2, then one radix-R0 pass per factor R0 of R / R0, then one pass
//   of the other odd prime per factor of it (9: 3; 25: 5; 15: 5; 45: 3
//   then 5; 675: 5, 3, 3, 3), then one pass of radix V0 (the Good-Thomas
//   3 x 4 or 5 x 4 network of fft_regs.cuh) at stride P, leaving element
//   t + r P in natural order for a coalesced store. Every stride but the
//   last divides P, so butterfly j = t + q P has j mod NS = t mod NS: a
//   thread's butterflies share their twiddles, and every exchange address
//   is the thread's base plus a compile-time constant;
// - a radix-5 pass at V0 = 12 has N / 5 = 2.4 P butterflies: each thread
//   takes three, the third masked where t + 2 P >= N / 5, so a thread
//   holds 15 values at most (SmoothGeo::VMAX); a radix-3 pass at V0 = 20
//   has 6.67 P: seven a thread, the seventh masked, 21 values. Where both
//   3 and 25 divide R (75, 225, 675) R0 = 5 is the cheaper: one masked
//   radix-3 pass for every 3 (5-13% fewer operations than R0 = 3's masked
//   radix-5 passes, regcore.smooth_schedule's count) and fewer threads a
//   line (1500, 1800, 2400 fit the column variant's P <= 128). The R0
//   passes run first, so a first pass at K = 2 is whole but at 60 (15 4:
//   its radix-5 pass masked, loads too);
// - the exchanges keep separate re and im planes. Columns: the lane is
//   fastest and the planes are padded one slot per four elements
//   (ColLay<L, 2>) where a radix-4 pass writes runs of four (the first
//   family, K >= 4), unpadded below (SmoothFlatColLay), L = 32 lanes a
//   block up to 768 threads, then 16, then 8 (to P = 128, 1024 threads),
//   so a warp holds W = 32 / L <= 4 row threads of consecutive t: every put
//   and get takes one wavefront in the first family and two at most in the
//   second (regcore.smooth_ways). Lengths of P > 128 (L = 4: 1920-3840,
//   1620-4000) would take more and stay dense as columns. Rows: 256 / P
//   rows a block (one from P = 256), each row's planes at a pitch of
//   P mod 32 floats and no pad, so element a of row g sits at bank
//   (g P + a) mod 32 and every get (consecutive elements of consecutive
//   threads) takes one wavefront across the rows a warp straddles; the
//   puts of the strided passes take up to four (counted per exchange by
//   regcore.smooth_ways: the radix-4 pass at stride 4 the worst), the
//   first radix-4 pass's float4 puts one or two; at six lengths of K = 2
//   (36, 60, 100, 108, 180, 300) another pitch takes two a get and two a
//   put where P mod 32 would take three to five a put
//   (smooth_row_pitch). Rows and lines straddle warps, so every exchange
//   synchronises the block. At 12 and 20 (P = 1) a thread holds its line
//   whole: one pass, no exchange. Rows of fewer than 6 threads (the
//   second family's 12-100) would read and write runs of 4-20 bytes a
//   thread, P rows a warp (0.16-0.44 of the bound on an H100 at 700 W,
//   slower than the dense core at 20), so they stage the block's rows
//   through the planes, in and out whole (SmoothRowGeo::STAGE; 0.54-0.82,
//   PERF.md).
// - the third family has no factor 4 for a radix-4 pass or a last pass of
//   4 R0: there V0 = 2^K d (smooth_odd_v0: d of 3, 5, 9, 15, 25 dividing R,
//   V0 <= 30, the least by (P > 128, passes, masked butterfly slots,
//   V0)), every pass before the last of radix 3 or 5 over R / d, masked
//   where it does not divide V0, and the last of radix V0 on dft_split
//   (Good-Thomas at 6, 10, 15, 18, 30, Cooley-Tukey with compile-time
//   roots at 9 and 25). P = N / V0 = R / d is odd at every length, 1-243:
//   the rows' gets take one wavefront at P mod 32 and two at the 14
//   lengths of P = 3-27 whose pitch is another residue; the puts of the
//   strided passes take up to three at twelve lengths and four at 675
//   and 1350, at every pitch (regcore.smooth_ways); the columns, unpadded,
//   one at L = 32 and two at most at 16 and 8; rows of fewer than 6
//   threads (18-150) staged. A thread of V0 = 25 or 30 holds up to 30
//   values (27 at 2025's masked radix-3 passes at V0 = 25): 128
//   registers (smooth_regs).
// - the fourth family keeps the first two families' schedule with R0 of 3,
//   5 or 7 (smooth7_r0: the least by (P > 128, passes, masked butterfly
//   slots, V0), as smooth_odd_v0; 7 at the powers of 7) and the odd
//   passes R0's first, then the other primes' in ascending order (PA, PB
//   of SmoothGeo; at the 5-smooth lengths PA = 8 - R0 and PB = 7, no
//   pass): a radix-7 pass on dft7 (constant roots), masked at V0 = 12 (two
//   butterflies a thread, 14 values) and 20 (three, 21); at V0 = 28 the
//   last pass on the Good-Thomas 7 x 4 network (dft28) and a radix-3 or
//   radix-5 pass masked (ten or six butterflies, 30 values, 128
//   registers). P = N / V0 takes every kind: odd (3-125), a multiple of 32
//   (896, 1792, 3584), 1-4 (28-112, staged). Rows keep the pitch of P mod
//   32 but at 28 (n | 1) and P = 7 and 21 (84, 140, 196, 420), where
//   another residue costs the exchanges less (0.52-0.57 of it at P = 7;
//   regcore SMOOTH7_ROW_PITCH); columns take the first family's padded
//   planes from K = 4, every put and get one wavefront or two.

#pragma once

#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

#include "fft_regs.cuh"

namespace offt {
namespace regs {

__host__ __device__ constexpr int odd_part(int n) {
  return n % 2 ? n : odd_part(n / 2);
}

// whether n is a length of the first family as rows (odd part 9, 15, 25,
// 45; K >= 3): fft_last_smooth.cu and the real rows of real_rows_smooth.cu
// (the columns take those of at most 128 threads a line, SmoothColGeo)
__host__ __device__ constexpr bool smooth_length(int n) {
  return n > 0 && n <= 4096 &&
         (odd_part(n) == 9 || odd_part(n) == 15 || odd_part(n) == 25 ||
          odd_part(n) == 45) &&
         n / odd_part(n) >= 8;
}

__host__ __device__ constexpr int count_factor(int r, int f) {
  return r % f ? 0 : 1 + count_factor(r / f, f);
}

__host__ __device__ constexpr bool pow35(int r) {
  return r == 1 || (r % 3 == 0 && pow35(r / 3)) ||
         (r % 5 == 0 && pow35(r / 5));
}

// whether n is a length of this core's schedule: R 2^K <= 4096, K >= 2,
// R = 3^a 5^b > 1
__host__ __device__ constexpr bool smooth_core_length(int n) {
  return n > 0 && n <= 4096 && odd_part(n) > 1 && pow35(odd_part(n)) &&
         n / odd_part(n) >= 4;
}

// whether n is a length of the third family, the odd and twice-odd ones:
// R 2^K, K = 0 or 1, R = 3^a 5^b > 1, 16 <= n <= 4096 (18-4050, 42
// lengths; fft_last_smooth_odd3.cu and fft_last_smooth_odd5.cu as rows,
// fft_axis_smooth_odd3.cu and fft_axis_smooth_odd5.cu as columns,
// real_rows_smooth_odd3.cu and real_rows_smooth_odd5.cu as real rows of
// half length n)
__host__ __device__ constexpr bool smooth_odd_length(int n) {
  return n >= 16 && n <= 4096 && odd_part(n) > 1 && pow35(odd_part(n)) &&
         n / odd_part(n) < 4;
}

// A candidate V0 of the third or fourth family, keyed as
// fused_fft._least_v0 keys it: (P = n / V0 > 128, the odd passes over the
// rest of the odd part, one a prime factor 3, 5 or 7, the masked butterfly
// slots of those passes, ceil(V0 / r) r - V0 each, V0); the least wins.
struct V0Key {
  int col, npass, waste, v0;
};

__host__ __device__ constexpr V0Key v0_key(int n, int v0, int rest) {
  V0Key k{n / v0 > 128, 0, 0, v0};
  for (int r = 3; r <= 7; r += 2) {
    while (rest % r == 0) {
      rest /= r;
      ++k.npass;
      k.waste += (v0 + r - 1) / r * r - v0;
    }
  }
  return k;
}

__host__ __device__ constexpr bool operator<(const V0Key& a,
                                             const V0Key& b) {
  return a.col != b.col       ? a.col < b.col
         : a.npass != b.npass ? a.npass < b.npass
         : a.waste != b.waste ? a.waste < b.waste
                              : a.v0 < b.v0;
}

// V0 = 2^K d at a length of the third family (fused_fft._smooth_odd_values):
// d a divisor of R among 3, 5, 9, 15, 25 with V0 <= 30, the least by
// v0_key
__host__ __device__ constexpr int smooth_odd_v0(int n) {
  const int odd = odd_part(n), two = n / odd;
  const int ds[5] = {3, 5, 9, 15, 25};
  V0Key best{};
  for (int i = 0; i < 5; ++i) {
    const int v0 = two * ds[i];
    if (odd % ds[i] || v0 > 30) continue;
    const V0Key k = v0_key(n, v0, odd / ds[i]);
    if (!best.v0 || k < best) best = k;
  }
  return best.v0;
}

__host__ __device__ constexpr bool pow357(int r) {
  return r == 1 || (r % 3 == 0 && pow357(r / 3)) ||
         (r % 5 == 0 && pow357(r / 5)) || (r % 7 == 0 && pow357(r / 7));
}

// whether n is a length of the fourth family: R 2^K <= 4096, K >= 2, R =
// 3^a 5^b 7^c with c >= 1 (28-4032, 56 lengths; fft_last_smooth7*.cu as
// rows, fft_axis_smooth7*.cu as columns)
__host__ __device__ constexpr bool smooth7_length(int n) {
  return n > 0 && n <= 4096 && odd_part(n) % 7 == 0 && pow357(odd_part(n)) &&
         n / odd_part(n) >= 4;
}

// R0 at a length of the fourth family (fused_fft._smooth7_values): a prime
// of R among 3, 5, 7, V0 = 4 R0 the least by v0_key
__host__ __device__ constexpr int smooth7_r0(int n) {
  const int odd = odd_part(n);
  V0Key best{};
  for (int r0 = 3; r0 <= 7; r0 += 2) {
    if (odd % r0) continue;
    const V0Key k = v0_key(n, 4 * r0, odd / r0);
    if (!best.v0 || k < best) best = k;
  }
  return best.v0 / 4;
}

// whether n is a length of the second family (fft_last_smooth3.cu and
// fft_last_smooth5.cu as rows, fft_axis_smooth3.cu and fft_axis_smooth5.cu
// as columns, real_rows_smooth3.cu and real_rows_smooth5.cu as real rows
// of half length n): a length of the schedule that neither the first
// family nor the mixed rows (R0 2^k, 2^k >= 16: fft_last_mix.cu) take
__host__ __device__ constexpr bool smooth_more_length(int n) {
  return smooth_core_length(n) && !smooth_length(n) &&
         !((odd_part(n) == 3 || odd_part(n) == 5) && n / odd_part(n) >= 16);
}

// whether n is a c2c length of one of the four families (fft_last.cu's
// last_smooth_family, fft_axis.cu's axis_smooth_family)
__host__ __device__ constexpr bool smooth_family_length(int n) {
  return smooth_length(n) || smooth_more_length(n) || smooth_odd_length(n) ||
         smooth7_length(n);
}

// R0 of n's odd part R: 5 where 25 divides R or 3 does not, else 3
__host__ __device__ constexpr int smooth_r0(int n) {
  return odd_part(n) % 25 == 0 || odd_part(n) % 3 ? 5 : 3;
}

// compile-time schedule of N = R 2^K: at K >= 2 (the first, second and
// fourth families) V0 = 4 R0, radix-4 passes (a radix 2 last where K is
// odd) over 2^(K-2), then one radix-R0 pass per factor R0 of R / R0, then
// one of each other odd prime per factor, in ascending order, then radix
// V0 at stride P; at K = 0, 1 (the third) V0 = 2^K D (D =
// smooth_odd_v0(N) / 2^K: 3, 5, 9, 15 or 25), no power-of-two pass, then
// the odd passes over R / D in the same order, then radix V0
template <int N>
struct SmoothGeo {
  static_assert(smooth_core_length(N) || smooth_odd_length(N) ||
                    smooth7_length(N),
                "a smooth length: R 2^K, R = 3^a 5^b 7^c > 1, N <= 4096");
  static constexpr int R = odd_part(N);
  static constexpr int K = ilog2(N / R);
  static constexpr int R0 = smooth7_length(N) ? smooth7_r0(N) : smooth_r0(N);
  static constexpr int V0 = K >= 2 ? 4 * R0 : smooth_odd_v0(N);
  static constexpr int D = K >= 2 ? R0 : V0 >> K;  // V0's odd part
  static constexpr int P = N / V0;                 // threads a line
  static constexpr int NPOW = K >= 2 ? (K - 1) / 2 : 0;  // over 2^(K-2)
  // the other odd primes in ascending order (8 - R0 and 7 where R0 is 3
  // or 5)
  static constexpr int PA = R0 == 3 ? 5 : 3;
  static constexpr int PB = R0 == 7 ? 5 : 7;
  // passes of radix R0, then PA, then PB, one a factor of R / D
  static constexpr int NSAME = count_factor(R / D, R0);
  static constexpr int NA = NSAME + count_factor(R / D, PA);
  static constexpr int NODD = NA + count_factor(R / D, PB);
  static constexpr int NPASS = NPOW + NODD + 1;
  __host__ __device__ static constexpr int radix(int p) {
    return p < NPOW            ? (p == NPOW - 1 && K % 2 ? 2 : 4)
           : p < NPOW + NSAME ? R0
           : p < NPOW + NA    ? PA
           : p < NPOW + NODD  ? PB
                              : V0;
  }
  __host__ __device__ static constexpr int stride(int p) {
    return p == 0 ? 1 : stride(p - 1) * radix(p - 1);
  }
  // butterflies a thread takes in pass p (the last one masked where
  // B P > N / R: a radix-5 pass at V0 = 12, 6, 9, 18, 28, a radix-3 pass
  // at V0 = 20, 5, 10, 25, 28, a radix-7 pass at V0 = 12, 20)
  __host__ __device__ static constexpr int bflies(int p) {
    return (N / radix(p) + P - 1) / P;
  }
  __host__ __device__ static constexpr int vmax(int p = 0) {
    return p == NPASS ? 0
           : radix(p) * bflies(p) > vmax(p + 1) ? radix(p) * bflies(p)
                                                : vmax(p + 1);
  }
  static constexpr int VMAX = vmax();  // complex values a thread holds
  static_assert(stride(NPASS - 1) == P && radix(NPASS - 1) * P == N,
                "the last pass at stride P");
};

// W_R^M as a compile-time constant, in double by Taylor series on the
// angle reduced to [-pi, pi], rounded to f32 once (regcore._root)
__host__ __device__ constexpr double taylor_sin(double x) {
  double term = x, sum = x;
  for (int i = 1; i < 24; ++i) {
    term *= -x * x / ((2.0 * i) * (2.0 * i + 1));
    sum += term;
  }
  return sum;
}

__host__ __device__ constexpr double taylor_cos(double x) {
  double term = 1.0, sum = 1.0;
  for (int i = 1; i < 24; ++i) {
    term *= -x * x / ((2.0 * i - 1) * (2.0 * i));
    sum += term;
  }
  return sum;
}

__host__ __device__ constexpr double root_angle(int m, int r) {
  return 2.0 * 3.14159265358979323846 *
         ((m % r) * 2 > r ? (m % r) - r : (m % r)) / r;
}

// d W_R^M, W in the transform's direction
template <int M, int R, bool INV>
static __device__ __forceinline__ float2 cmul_root(float2 d) {
  constexpr float c = (float)taylor_cos(root_angle(M, R));
  constexpr float s = (float)(INV ? taylor_sin(root_angle(M, R))
                                  : -taylor_sin(root_angle(M, R)));
  return cmul(d, make_float2(c, s));
}

template <int R, bool INV>
static __device__ __forceinline__ void dft_smooth(float2* v);

// The 7-point DFT of x[0..7) in place, with the constant roots c_j, s_j of
// 2 pi j/7: t_j, d_j = x_j +- x_(7-j) (j = 1, 2, 3); X_k, X_(7-k) = a_k -+
// i b_k (forward), a_k = x0 + sum_j cos(2 pi j k/7) t_j, b_k = sum_j
// sin(2 pi j k/7) d_j (regcore._dft7); 96 flops.
template <bool INV>
static __device__ __forceinline__ void dft7(float2* x) {
  constexpr float c1 = 0.62348980185873353f;   // cos 2 pi/7
  constexpr float c2 = -0.22252093395631434f;  // cos 4 pi/7
  constexpr float c3 = -0.90096886790241900f;  // cos 6 pi/7
  constexpr float s1 = 0.78183148246802981f;   // sin 2 pi/7
  constexpr float s2 = 0.97492791218182361f;   // sin 4 pi/7
  constexpr float s3 = 0.43388373911755823f;   // sin 6 pi/7
  const float2 t1 = cadd(x[1], x[6]), t2 = cadd(x[2], x[5]);
  const float2 t3 = cadd(x[3], x[4]);
  const float2 d1 = csub(x[1], x[6]), d2 = csub(x[2], x[5]);
  const float2 d3 = csub(x[3], x[4]);
  const float2 x0 = x[0];
  auto a = [&](float u1, float u2, float u3) {
    return make_float2(fmaf(u3, t3.x, fmaf(u2, t2.x, fmaf(u1, t1.x, x0.x))),
                       fmaf(u3, t3.y, fmaf(u2, t2.y, fmaf(u1, t1.y, x0.y))));
  };
  auto e = [&](float u1, float u2, float u3) {
    return mul_i<INV>(
        make_float2(fmaf(u3, d3.x, fmaf(u2, d2.x, u1 * d1.x)),
                    fmaf(u3, d3.y, fmaf(u2, d2.y, u1 * d1.y))));
  };
  const float2 a1 = a(c1, c2, c3), e1 = e(s1, s2, s3);
  const float2 a2 = a(c2, c3, c1), e2 = e(s2, -s3, -s1);
  const float2 a3 = a(c3, c1, c2), e3 = e(s3, -s1, s2);
  x[0] = cadd(cadd(cadd(x0, t1), t2), t3);
  x[1] = cadd(a1, e1);
  x[6] = csub(a1, e1);
  x[2] = cadd(a2, e2);
  x[5] = csub(a2, e2);
  x[3] = cadd(a3, e3);
  x[4] = csub(a3, e3);
}

// The 28-point DFT of v[0..28) in place by Good-Thomas 7 x 4, as
// fft_regs.cuh's dft_pfa at 12 and 20: input n = (4 n1 + 7 n2) mod 28;
// 7-point DFTs along n1 (for each n2), then 4-point DFTs along n2 (for
// each k1), X[k] where k1 = k mod 7, k2 = k mod 4 put it (a renaming of
// registers).
template <bool INV>
static __device__ __forceinline__ void dft28(float2* v) {
  unroll<0, 4>([&](auto n2c) {
    constexpr int B = 7 * decltype(n2c)::value;
    float2 u[7];
    unroll<0, 7>([&](auto n) {
      u[decltype(n)::value] = v[(B + 4 * decltype(n)::value) % 28];
    });
    dft7<INV>(u);
    unroll<0, 7>([&](auto n) {
      v[(B + 4 * decltype(n)::value) % 28] = u[decltype(n)::value];
    });
  });
  unroll<0, 7>([&](auto k1c) {
    constexpr int B = 4 * decltype(k1c)::value;
    float2 u[4];
    unroll<0, 4>([&](auto n) {
      u[decltype(n)::value] = v[(B + 7 * decltype(n)::value) % 28];
    });
    dft2k<4, INV>(u);
    unroll<0, 4>([&](auto n) {
      v[(B + 7 * decltype(n)::value) % 28] = u[decltype(n)::value];
    });
  });
  float2 t[28];
  unroll<0, 28>([&](auto kc) {
    constexpr int K = decltype(kc)::value;
    t[K] = v[(4 * (K % 7) + 7 * (K % 4)) % 28];
  });
  unroll<0, 28>(
      [&](auto k) { v[decltype(k)::value] = t[decltype(k)::value]; });
}

// The R-point DFT of v[0..R) in place at a composite radix of the third
// family's last pass (6, 9, 10, 15, 18, 25, 30): R = A B, A the least
// prime factor. Where B is coprime to A, Good-Thomas (as dft_pfa, no
// twiddle): A-point DFTs at the inputs (B n1 + A n2) mod R for each n2,
// then B-point DFTs at (B k1 + A n2) mod R for each k1, X[k] where k mod A
// and k mod B left it. Else (9 = 3 3, 25 = 5 5) Cooley-Tukey: A-point DFTs
// at B n1 + n2, the constant twiddles W_R^(n2 k1), B-point DFTs at
// B k1 + n2, X[k1 + A k2] at B k1 + k2. The last renaming is of registers.
template <int R, bool INV>
static __device__ __forceinline__ void dft_split(float2* v) {
  constexpr int A = R % 2 == 0 ? 2 : R % 3 == 0 ? 3 : 5;
  constexpr int B = R / A;
  constexpr bool GT = B % A != 0;
  float2 u[B > A ? B : A];
  unroll<0, B>([&](auto n2c) {
    constexpr int N2 = decltype(n2c)::value;
    unroll<0, A>([&](auto n1c) {
      constexpr int N1 = decltype(n1c)::value;
      u[N1] = v[GT ? (B * N1 + A * N2) % R : B * N1 + N2];
    });
    dft_smooth<A, INV>(u);
    unroll<0, A>([&](auto n1c) {
      constexpr int N1 = decltype(n1c)::value;
      v[GT ? (B * N1 + A * N2) % R : B * N1 + N2] = u[N1];
    });
  });
  unroll<0, A>([&](auto k1c) {
    constexpr int K1 = decltype(k1c)::value;
    unroll<0, B>([&](auto n2c) {
      constexpr int N2 = decltype(n2c)::value;
      if constexpr (GT || K1 == 0 || N2 == 0)
        u[N2] = v[GT ? (B * K1 + A * N2) % R : B * K1 + N2];
      else
        u[N2] = cmul_root<N2 * K1, R, INV>(v[B * K1 + N2]);
    });
    dft_smooth<B, INV>(u);
    unroll<0, B>([&](auto n2c) {
      constexpr int N2 = decltype(n2c)::value;
      v[GT ? (B * K1 + A * N2) % R : B * K1 + N2] = u[N2];
    });
  });
  float2 t[R];
  unroll<0, R>([&](auto kc) {
    constexpr int K = decltype(kc)::value;
    t[K] = v[GT ? (B * (K % A) + A * (K % B)) % R : B * (K % A) + K / A];
  });
  unroll<0, R>([&](auto k) { v[decltype(k)::value] = t[decltype(k)::value]; });
}

// The R-point DFT of a smooth pass: radix 2, 4, 12, 20 (fft_regs.cuh's dft),
// the 3-, 5- and 7-point networks, radix 28 (dft28) and the composite
// radices of dft_split.
template <int R, bool INV>
static __device__ __forceinline__ void dft_smooth(float2* v) {
  if constexpr (R == 3)
    dft3<INV>(v[0], v[1], v[2]);
  else if constexpr (R == 5)
    dft5<INV>(v[0], v[1], v[2], v[3], v[4]);
  else if constexpr (R == 7)
    dft7<INV>(v);
  else if constexpr (R == 28)
    dft28<INV>(v);
  else if constexpr (R == 12 || R == 20 || (R & (R - 1)) == 0)
    dft<R, INV>(v);
  else
    dft_split<R, INV>(v);
}

// Pass PASS's butterflies on the thread's values: butterfly j = t + q P
// takes v[q R .. q R + R), inputs r > 0 twiddled by W_N^(r (t mod NS)
// N / (NS R)) (j mod NS = t mod NS: NS divides P), the same roots for every
// q, so where a thread takes several butterflies it loads them once.
template <int N, int PASS, bool INV>
static __device__ __forceinline__ void smooth_butterflies(
    float2* v, int t, const float2* __restrict__ tab) {
  using S = SmoothGeo<N>;
  constexpr int R = S::radix(PASS), NS = S::stride(PASS);
  constexpr int B = S::bflies(PASS), LIVE = N / R;
  constexpr bool MASKED = B * S::P > LIVE;
  const int base = (t % NS) * (N / (NS * R));
  float2 w[B > 1 && NS > 1 ? R : 1];
  if constexpr (B > 1 && NS > 1) {
    unroll<1, R>([&](auto r) {
      w[decltype(r)::value] = __ldg(tab + decltype(r)::value * base);
    });
  }
  unroll<0, B>([&](auto qc) {
    constexpr int Q = decltype(qc)::value;
    if (!MASKED || Q < B - 1 || t + Q * S::P < LIVE) {
      if constexpr (NS > 1) {
        unroll<1, R>([&](auto r) {
          constexpr int K = decltype(r)::value;
          if constexpr (B > 1)
            v[Q * R + K] = cmul(v[Q * R + K], w[K]);
          else
            v[Q * R + K] = cmul(v[Q * R + K], __ldg(tab + K * base));
        });
      }
      dft_smooth<R, INV>(v + Q * R);
    }
  });
}

// the rows' exchange planes: no pad (the row pitch carries the bank shift)
struct SmoothRowLay {
  static constexpr bool kVec4 = true;
  static __host__ __device__ constexpr int at(int a) { return a; }
};

// the columns' exchange planes below K = 4 in the second family: the lane
// fastest and no pad (no radix-4 pass writes runs of four there)
template <int L>
struct SmoothFlatColLay {
  static constexpr bool kVec4 = false;
  static __host__ __device__ constexpr int at(int a) { return a * L; }
};

// Write pass PASS's outputs: output r of butterfly j = t + q P to
// d + r NS, d = (j div NS) NS R + j mod NS = X + q P R, X = (t div NS) NS R
// + t mod NS. The first radix-4 pass stores its runs of four as float4
// where the layout keeps them whole (Lay::kVec4).
template <int N, int PASS, typename Lay>
static __device__ __forceinline__ void smooth_put(float* sre, float* sim,
                                                  const float2* v, int t) {
  using S = SmoothGeo<N>;
  constexpr int R = S::radix(PASS), NS = S::stride(PASS);
  constexpr int B = S::bflies(PASS), LIVE = N / R;
  constexpr bool MASKED = B * S::P > LIVE;
  const int x = (t / NS) * NS * R + t % NS;
  unroll<0, B>([&](auto qc) {
    constexpr int Q = decltype(qc)::value;
    if (!MASKED || Q < B - 1 || t + Q * S::P < LIVE) {
      if constexpr (NS == 1 && R == 4 && Lay::kVec4) {
        const int a = Lay::at(x + Q * S::P * R);
        *reinterpret_cast<float4*>(sre + a) =
            make_float4(v[4 * Q].x, v[4 * Q + 1].x, v[4 * Q + 2].x,
                        v[4 * Q + 3].x);
        *reinterpret_cast<float4*>(sim + a) =
            make_float4(v[4 * Q].y, v[4 * Q + 1].y, v[4 * Q + 2].y,
                        v[4 * Q + 3].y);
      } else {
        unroll<0, R>([&](auto r) {
          constexpr int K = decltype(r)::value;
          const int a = Lay::at(x + Q * S::P * R + K * NS);
          sre[a] = v[Q * R + K].x;
          sim[a] = v[Q * R + K].y;
        });
      }
    }
  });
}

// Read pass PASS's inputs: v[q R + r] = element j + r N/R, j = t + q P.
template <int N, int PASS, typename Lay>
static __device__ __forceinline__ void smooth_get(const float* sre,
                                                  const float* sim,
                                                  float2* v, int t) {
  using S = SmoothGeo<N>;
  constexpr int R = S::radix(PASS), B = S::bflies(PASS), LIVE = N / R;
  constexpr bool MASKED = B * S::P > LIVE;
  unroll<0, B>([&](auto qc) {
    constexpr int Q = decltype(qc)::value;
    if (!MASKED || Q < B - 1 || t + Q * S::P < LIVE) {
      unroll<0, R>([&](auto r) {
        constexpr int K = decltype(r)::value;
        const int a = Lay::at(t + Q * S::P + K * LIVE);
        v[Q * R + K] = make_float2(sre[a], sim[a]);
      });
    }
  });
}

// SYNC0: the first put waits for the block too (its loads read the
// planes: the staged rows)
template <int N, int PASS, bool INV, typename Lay, bool SYNC0 = false>
static __device__ __forceinline__ void smooth_passes(
    float2* v, float* sre, float* sim, int t,
    const float2* __restrict__ tab) {
  if constexpr (PASS < SmoothGeo<N>::NPASS) {
    if constexpr (PASS > 1 || SYNC0) __syncthreads();
    smooth_put<N, PASS - 1, Lay>(sre, sim, v, t);
    __syncthreads();
    smooth_get<N, PASS, Lay>(sre, sim, v, t);
    smooth_butterflies<N, PASS, INV>(v, t, tab);
    smooth_passes<N, PASS + 1, INV, Lay>(v, sre, sim, t, tab);
  }
}

// The length-N DFT of one line held by its P threads (t the thread's index
// in it; (sre, sim) its exchange planes laid out by Lay; load(e) gives
// input element e, each once). On return v[r] holds output element
// t + r P, r < V0 (outputs_smooth). Every thread of the block must call
// it: the exchanges synchronise the block. SYNC0 where load reads the
// planes.
template <int N, bool INV, typename Lay, bool SYNC0 = false, typename Load>
static __device__ __forceinline__ void core_smooth(
    float2* v, float* sre, float* sim, int t, const float2* __restrict__ tab,
    Load load) {
  using S = SmoothGeo<N>;
  constexpr int R = S::radix(0), B = S::bflies(0), LIVE = N / R;
  // masked where the first pass is a radix-5 one at V0 = 12 (60 = 15 4)
  constexpr bool MASKED = B * S::P > LIVE;
  unroll<0, B>([&](auto qc) {
    constexpr int Q = decltype(qc)::value;
    if (!MASKED || Q < B - 1 || t + Q * S::P < LIVE) {
      unroll<0, R>([&](auto r) {
        constexpr int K = decltype(r)::value;
        v[Q * R + K] = load(t + Q * S::P + K * LIVE);
      });
    }
  });
  smooth_butterflies<N, 0, INV>(v, t, tab);
  smooth_passes<N, 1, INV, Lay, SYNC0>(v, sre, sim, t, tab);
}

template <int N, typename F>
static __device__ __forceinline__ void outputs_smooth(float2* v, int t,
                                                      F f) {
  using S = SmoothGeo<N>;
  unroll<0, S::V0>([&](auto r) {
    f(t + decltype(r)::value * S::P, v[decltype(r)::value]);
  });
}

// ---- the block geometries ----

// Blocks an SM the launch bounds ask for at NT threads a block: as many as
// leave a thread 80 registers (96 where it holds 20 values, 128 where it
// holds more than 21: the third family's V0 of 25 and 30), at least one.
__host__ __device__ constexpr int smooth_regs(int vmax) {
  return vmax > 21 ? 128 : vmax > 15 ? 96 : 80;
}

__host__ __device__ constexpr int smooth_min_blocks(int nt, int vmax) {
  return 65536 / (nt * smooth_regs(vmax)) > 1
             ? 65536 / (nt * smooth_regs(vmax))
             : 1;
}

// The rows' pitch mod 32: P mod 32 (a warp's consecutive threads, whatever
// rows they lie in, meet consecutive banks on a get), but at the second
// family's six lengths of K = 2 where another residue costs fewer
// wavefronts over the exchange (gets and puts two each, against puts of
// three to five; regcore.smooth_row_pitch).
__host__ __device__ constexpr int smooth_row_pitch(int n, int p) {
  return n == 12    ? 13
         : n == 20  ? 21
         : n == 36  ? 9
         : n == 60  ? 25
         : n == 100 ? 25
         : n == 108 ? 27
         : n == 180 ? 8
         : n == 300 ? 11
         // the third family's (regcore.SMOOTH_ODD_ROW_PITCH): P = 1 at
         // 18, 25, 30 (n | 1), and 14 lengths of P = 3-27
         : n == 18  ? 19
         : n == 25  ? 25
         : n == 30  ? 31
         : n == 27 || n == 45 || n == 54 || n == 90 ? 9
         : n == 50 || n == 75 || n == 125 || n == 150 ? 25
         : n == 81 || n == 135 || n == 162 || n == 270 ? 27
         : n == 225 || n == 450 ? 11
         // the fourth family's (regcore.SMOOTH7_ROW_PITCH): P = 1 at 28,
         // P = 7 at 84, 140, 196, P = 21 at 420
         : n == 28  ? 29
         : n == 84 || n == 140 ? 17
         : n == 196 ? 4
         : n == 420 ? 2
                    : p % 32;
}

// Rows: ROWS = 256 / P rows of P threads a block (one from P = 256; at an
// odd P the block's last warp is short), each row's two planes at a pitch
// of N rounded up to smooth_row_pitch. Rows of fewer than 6 threads (the
// second family's 12-100: a thread would read and write runs of 4-20
// bytes of its row, P rows a warp) move in and out through the planes
// (STAGE): the block's rows whole, consecutive threads on consecutive
// elements.
template <int N>
struct SmoothRowGeo {
  using S = SmoothGeo<N>;
  static constexpr int P = S::P;
  static constexpr int ROWS = P >= kThreads ? 1 : kThreads / P;
  static constexpr int NT = ROWS * P;  // threads a block
  static constexpr bool STAGE = P < 6;
  static constexpr int PITCH = pitch_to(N, smooth_row_pitch(N, P));
  static constexpr size_t SMEM =
      S::NPASS > 1 || STAGE ? (size_t)2 * ROWS * PITCH * sizeof(float) : 0;
  static constexpr int MINB = smooth_min_blocks(NT, S::VMAX);
};

// The staged rows' copies: the block's ROWS rows from row0 (rows past
// `rows` zeros in, nothing out) between device memory at `pitch` floats a
// row and the planes (re at s, im ROWS PITCH floats on), thread tid on
// elements tid, tid + NT, ... of the block's ROWS N.
template <int N>
static __device__ __forceinline__ void smooth_stage_in(
    float* s, const float* xr, const float* xi, long long row0,
    long long rows, long long pitch) {
  using G = SmoothRowGeo<N>;
  for (int i = threadIdx.x; i < G::ROWS * N; i += G::NT) {
    const int r = i / N, e = i - r * N;
    const bool ok = row0 + r < rows;
    const long long o = (row0 + r) * pitch + e;
    s[r * G::PITCH + e] = ok ? xr[o] : 0.f;
    s[(G::ROWS + r) * G::PITCH + e] = ok ? xi[o] : 0.f;
  }
}

template <int N>
static __device__ __forceinline__ void smooth_stage_out(
    const float* s, float* yr, float* yi, long long row0, long long rows,
    long long pitch) {
  using G = SmoothRowGeo<N>;
  for (int i = threadIdx.x; i < G::ROWS * N; i += G::NT) {
    const int r = i / N, e = i - r * N;
    if (row0 + r < rows) {
      const long long o = (row0 + r) * pitch + e;
      yr[o] = s[r * G::PITCH + e];
      yi[o] = s[(G::ROWS + r) * G::PITCH + e];
    }
  }
}

// the lanes of a column block at P threads a line: 32 up to 768 threads,
// then 16, then 8 (fused_fft._smooth_col_lanes)
__host__ __device__ constexpr int smooth_col_lanes(int p) {
  return 32 * p <= 768 ? 32 : 16 * p <= 768 ? 16 : 8;
}

// whether n is a column length of the third family: at most 128 threads a
// line, and the block's two planes (n L floats each, unpadded) within the
// 227 KB a block may have (3750: 240 KB at L = 8; fused_fft.
// _SMOOTH_ODD_COL_LENGTHS)
__host__ __device__ constexpr bool smooth_odd_col(int n) {
  return smooth_odd_length(n) && n / smooth_odd_v0(n) <= 128 &&
         8 * n * smooth_col_lanes(n / smooth_odd_v0(n)) <= 232448;
}

// Columns: L = 32 lanes a block up to 768 threads, then 16, then 8 (to
// 1024 threads, P = 128), NT = L P; the lane fastest, the planes padded
// one slot per four elements in the first family and from K = 4 (where a
// radix-4 pass writes runs of four), unpadded below (K = 2, 3 of the
// second family: the pad would put a warp's two or four row threads on
// one bank twice as often, regcore.smooth_ways); no planes at one pass.
template <int N>
struct SmoothColGeo {
  using S = SmoothGeo<N>;
  static constexpr int P = S::P;
  static constexpr int L = smooth_col_lanes(P);
  static_assert(L * P <= 1024, "columns to P = 128");
  static constexpr int NT = L * P;
  using Lay = std::conditional_t<smooth_length(N) || S::K >= 4, ColLay<L, 2>,
                                 SmoothFlatColLay<L>>;
  static constexpr int SIZE = (Lay::at(N - 1) + L + 3) / 4 * 4;
  static constexpr size_t SMEM =
      S::NPASS > 1 ? (size_t)2 * SIZE * sizeof(float) : 0;
  static constexpr int MINB = smooth_min_blocks(NT, S::VMAX);
};

// whether N, a length of the fourth family, is one of its column lengths:
// at most 128 threads a line, and the block's two planes (SMEM, padded from
// K = 4) within the 227 KB a block may have (3024, 3136, 3360, 3584:
// 236-280 KB; fused_fft._SMOOTH7_COL_LENGTHS)
template <int N>
constexpr bool smooth7_col() {
  if constexpr (SmoothGeo<N>::P > 128)
    return false;
  else
    return SmoothColGeo<N>::SMEM <= 232448;
}

// ---- the kernels and their launchers ----

// c2c of contiguous rows at a smooth length N: ROWS rows a block at their
// own input and output pitch, the ragged last block masked (its rows past
// `rows` load zeros and store nothing), times `scale`; under 6 threads a
// row through the planes (SmoothRowGeo::STAGE). Every thread of a row
// reads the whole row (a staged block all its rows) before any writes, so
// it may run in place.
template <int N, bool INV>
__global__ void __launch_bounds__(SmoothRowGeo<N>::NT, SmoothRowGeo<N>::MINB)
rows_smooth(const float* xr, const float* xi, float* yr, float* yi,
            const float2* __restrict__ tab, long long rows, long long ipitch,
            long long opitch, float scale) {
  using G = SmoothRowGeo<N>;
  extern __shared__ __align__(16) float ssmem[];
  const int g = threadIdx.x / G::P;
  const int t = threadIdx.x % G::P;
  const long long row = (long long)blockIdx.x * G::ROWS + g;
  const bool valid = row < rows;
  const long long in = row * ipitch, out = row * opitch;
  float2 v[G::S::VMAX];
  if constexpr (G::STAGE) {
    // the block's rows in whole, the core's loads from the planes, the
    // outputs (scaled) back into them, the rows out whole
    const long long row0 = (long long)blockIdx.x * G::ROWS;
    float* sre = ssmem + g * G::PITCH;
    float* sim = ssmem + (G::ROWS + g) * G::PITCH;
    smooth_stage_in<N>(ssmem, xr, xi, row0, rows, ipitch);
    __syncthreads();
    core_smooth<N, INV, SmoothRowLay, true>(
        v, sre, sim, t, tab,
        [&](int e) { return make_float2(sre[e], sim[e]); });
    __syncthreads();
    outputs_smooth<N>(v, t, [&](int e, float2 y) {
      sre[e] = y.x * scale;
      sim[e] = y.y * scale;
    });
    __syncthreads();
    smooth_stage_out<N>(ssmem, yr, yi, row0, rows, opitch);
  } else {
    core_smooth<N, INV, SmoothRowLay>(
        v, ssmem + g * G::PITCH, ssmem + (G::ROWS + g) * G::PITCH, t, tab,
        [&](int e) {
          return valid ? make_float2(xr[in + e], xi[in + e])
                       : make_float2(0.f, 0.f);
        });
    if (!valid) return;
    outputs_smooth<N>(v, t, [&](int e, float2 y) {
      yr[out + e] = y.x * scale;
      yi[out + e] = y.y * scale;
    });
  }
}

// The column variant at a smooth length N: c2c along the n axis of
// (B, N, Y, Z) (fft_axis.cu's AxisGeom), one line per lane l = y Z + z, a
// block of L consecutive lanes of one b, the ragged last tile masked,
// times `scale`.
template <int N, bool INV>
__global__ void __launch_bounds__(SmoothColGeo<N>::NT, SmoothColGeo<N>::MINB)
cols_smooth(const float* xr, const float* xi, float* yr, float* yi,
            const float2* __restrict__ tab, AxisGeom g, long long tiles,
            float scale) {
  using C = SmoothColGeo<N>;
  extern __shared__ __align__(16) float ssmem[];
  const int l = threadIdx.x % C::L;
  const int t = threadIdx.x / C::L;
  const long long b = blockIdx.x / tiles;
  const long long lane = (blockIdx.x - b * tiles) * C::L + l;
  const bool valid = lane < g.ny * g.nz;
  const long long y = valid ? lane / g.nz : 0;
  const long long z = valid ? lane - y * g.nz : 0;
  const long long in = b * g.isb + y * g.isy + z;
  const long long out = b * g.osb + y * g.osy + z;
  float2 v[C::S::VMAX];
  core_smooth<N, INV, typename C::Lay>(
      v, ssmem + l, ssmem + C::SIZE + l, t, tab, [&](int e) {
        const long long o = in + e * g.isn;
        return valid ? make_float2(xr[o], xi[o]) : make_float2(0.f, 0.f);
      });
  if (!valid) return;
  outputs_smooth<N>(v, t, [&](int e, float2 w) {
    const long long o = out + e * g.osn;
    yr[o] = w.x * scale;
    yi[o] = w.y * scale;
  });
}

template <int N, bool INV>
static cudaError_t launch_rows_smooth(const float* xr, const float* xi,
                                      float* yr, float* yi,
                                      const float2* tab, long long rows,
                                      long long ipitch, long long opitch,
                                      float scale, cudaStream_t stream) {
  using G = SmoothRowGeo<N>;
  auto kernel = rows_smooth<N, INV>;
  cudaError_t err = allow_smem(kernel, G::SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + G::ROWS - 1) / G::ROWS;
  kernel<<<(unsigned)blocks, G::NT, G::SMEM, stream>>>(
      xr, xi, yr, yi, tab, rows, ipitch, opitch, scale);
  return cudaGetLastError();
}

template <int N, bool INV>
static cudaError_t launch_cols_smooth(const float* xr, const float* xi,
                                      float* yr, float* yi,
                                      const float2* tab, const AxisGeom& g,
                                      float scale, cudaStream_t stream) {
  using C = SmoothColGeo<N>;
  auto kernel = cols_smooth<N, INV>;
  cudaError_t err = allow_smem(kernel, C::SMEM);
  if (err != cudaSuccess) return err;
  const long long tiles = (g.ny * g.nz + C::L - 1) / C::L;
  kernel<<<(unsigned)(tiles * g.nb), C::NT, C::SMEM, stream>>>(
      xr, xi, yr, yi, tab, g, tiles, scale);
  return cudaGetLastError();
}

// f(std::integral_constant<int, N>) for n = R 2^K, K from 3, n <= LAST;
// an error for any other n
template <int R, int LAST = 4096, int N = 8 * R, typename F>
static cudaError_t by_smooth_odd(int n, F&& f) {
  if constexpr (N > LAST) {
    return cudaErrorInvalidValue;
  } else {
    if (n == N) return f(std::integral_constant<int, N>());
    return by_smooth_odd<R, LAST, 2 * N>(n, std::forward<F>(f));
  }
}

// f(std::integral_constant<int, N>) for n = R 2^K, K from 2, a
// smooth_more_length of at most MAXP threads a line; an error for any
// other n
template <int R, int MAXP = 4096, int N = 4 * R, typename F>
static cudaError_t by_smooth_more_odd(int n, F&& f) {
  if constexpr (N > 4096) {
    return cudaErrorInvalidValue;
  } else {
    if constexpr (smooth_more_length(N) && N / (4 * smooth_r0(N)) <= MAXP) {
      if (n == N) return f(std::integral_constant<int, N>());
    }
    return by_smooth_more_odd<R, MAXP, 2 * N>(n, std::forward<F>(f));
  }
}

// f(std::integral_constant<int, N>) for n = R or 2 R, a smooth_odd_length
// (COL: a smooth_odd_col); an error for any other n
template <int R, bool COL = false, int N = R, typename F>
static cudaError_t by_smooth_odd_twice(int n, F&& f) {
  if constexpr (N > 2 * R || N > 4096) {
    return cudaErrorInvalidValue;
  } else {
    if constexpr (COL ? smooth_odd_col(N) : smooth_odd_length(N)) {
      if (n == N) return f(std::integral_constant<int, N>());
    }
    return by_smooth_odd_twice<R, COL, 2 * N>(n, std::forward<F>(f));
  }
}

// f(std::integral_constant<int, N>) for n = R 2^K, K from 2, n <= 4096, a
// length of the fourth family (COL: a smooth7_col); an error for any other
// n
template <int R, bool COL = false, int N = 4 * R, typename F>
static cudaError_t by_smooth7(int n, F&& f) {
  if constexpr (N > 4096) {
    return cudaErrorInvalidValue;
  } else {
    if constexpr (!COL || smooth7_col<N>()) {
      if (n == N) return f(std::integral_constant<int, N>());
    }
    return by_smooth7<R, COL, 2 * N>(n, std::forward<F>(f));
  }
}

// f at a length of the fourth family whose odd part is one of Rs, one
// source's share (by_smooth7); an error at any other n
template <bool COL, int... Rs, typename F>
static cudaError_t by_smooth7_parts(int n, F&& f) {
  cudaError_t err = cudaErrorInvalidValue;
  (void)((odd_part(n) == Rs && (err = by_smooth7<Rs, COL>(n, f), true)) ||
         ...);
  return err;
}

// The rows (fft_last_smooth7*.cu) and the columns (fft_axis_smooth7*.cu,
// the wide tile's code alone: `tile` 1 or -1) of the fourth family at the
// odd parts Rs.
template <int... Rs>
static cudaError_t last_smooth7_parts(const float* xr, const float* xi,
                                      float* yr, float* yi,
                                      const float2* tab, long long rows,
                                      int n, long long ipitch,
                                      long long opitch, int inverse,
                                      float scale, cudaStream_t s) {
  return by_smooth7_parts<false, Rs...>(n, [&](auto nc) {
    constexpr int N = decltype(nc)::value;
    return inverse ? launch_rows_smooth<N, true>(xr, xi, yr, yi, tab, rows,
                                                 ipitch, opitch, scale, s)
                   : launch_rows_smooth<N, false>(xr, xi, yr, yi, tab, rows,
                                                  ipitch, opitch, scale, s);
  });
}

template <int... Rs>
static cudaError_t axis_smooth7_parts(const float* xr, const float* xi,
                                      float* yr, float* yi,
                                      const float2* tab, const AxisGeom& g,
                                      int n, int inverse, float scale,
                                      int tile, cudaStream_t s) {
  if (tile >= 0 && tile != 1) return cudaErrorInvalidValue;
  return by_smooth7_parts<true, Rs...>(n, [&](auto nc) {
    constexpr int N = decltype(nc)::value;
    return inverse ? launch_cols_smooth<N, true>(xr, xi, yr, yi, tab, g,
                                                 scale, s)
                   : launch_cols_smooth<N, false>(xr, xi, yr, yi, tab, g,
                                                  scale, s);
  });
}

// f(std::integral_constant<int, M>) at a smooth M; an error at any other
template <typename F>
static cudaError_t by_smooth(int m, F&& f) {
  switch (odd_part(m)) {
    case 9:
      return by_smooth_odd<9>(m, f);
    case 15:
      return by_smooth_odd<15>(m, f);
    case 25:
      return by_smooth_odd<25>(m, f);
    case 45:
      return by_smooth_odd<45>(m, f);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace regs
}  // namespace offt
