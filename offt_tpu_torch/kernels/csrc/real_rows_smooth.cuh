// real_rows_smooth.cuh: the real rows of rfft_last.cu and icrfft_last.cu
// on the register core's smooth rows (fft_smooth.cuh: SmoothRowGeo,
// core_smooth) at any smooth half length M = R 2^K of the three families:
// rows_r2c_smooth and rows_c2r_smooth, the mirror of each other, and
// their launchers. The first family's instances (odd part 9, 15, 25, 45,
// K >= 3) are built by real_rows_smooth.cu, the second family's (every
// other R = 3^a 5^b > 1, K >= 2: 12-4000) by real_rows_smooth3.cu (R0 = 3)
// and real_rows_smooth5.cu (R0 = 5), the third family's (the odd and
// twice-odd M = R 2^K, K = 0, 1: 18-4050) by real_rows_smooth_odd3.cu and
// real_rows_smooth_odd5.cu, so that nvcc builds them beside the others.
//
// Replaces, at those M, the dense core of two Pallas kernels' ports
// behind their C entry points: offt_tpu/kernels/pallas_fft.py
// rfft_last_planar (:1685; rfft_last.cu) and icrfft_last_planar (:2308;
// icrfft_last.cu). The real slabs (rfft_slab.cu, irfft_slab.cu) keep
// their cores at these M.
//
// What bounds it on Hopper: the rows' bytes, 8 read (a sample pair) and 8
// written (a planar complex lane) per lane of the half-spectrum, both
// ways. The dense core did one MAC per root read from shared memory and
// ran these rows at 0.02-0.20 of that bound. Design, as the mixed rows'
// rows_r2c_mix and rows_c2r_mix (real_rows_mix.cu) on the smooth rows'
// schedule and geometry: V0 = 12 values a thread (20 where 25 divides the
// odd part or 3 does not; 2^K d at the third family, smooth_odd_v0), P =
// M / V0 threads a row, not a power of two, 256 / P rows a block (one from
// P = 256; the ragged last block masked), radix-4 passes (a radix 2 where
// K is odd, none at K <= 2), one radix-3 or radix-5 pass per further odd
// factor (masked where it does not divide V0), then the pass of radix V0;
// the row planes unpadded at the pitch of smooth_row_pitch, no swizzle:
// - r2c: loads v[j] = x[2j] + i x[2j+1] as one float2 (8-byte aligned
//   input; a warp on consecutive pairs of its rows); the last pass leaves
//   element t + r P, which goes to the row's planes in natural order;
//   after a barrier each thread untangles the pairs (k, M - k),
//   k = t + i P (i < V0 / 2), and at an even M thread 0 also M/2; at an
//   odd M (V0 and P odd) one more i, masked to k <= (M - 1) / 2, takes the
//   last (P + 1) / 2 pairs, and no lane is its own partner. The run of
//   M - k a warp reads falls, row by row, on slots g P - t mod 32, which
//   may meet twice where the warp starts inside a row. The output rows,
//   times `scale`, are staged at a pitch of at least M + 1 that is P mod
//   32 (SmoothRealGeo::SPITCH; M + 1 at P = 1, smooth_stage_pitch), the
//   stage overlaying the planes, then copied out with consecutive threads
//   on consecutive floats of the block's rows, row r at r `opitch`: at
//   opitch = the lanes (rfft_last's layouts, the only pitch launched) the
//   block's rows are one contiguous run of the output, so the copy writes
//   whole sectors although a numpy row (M + 1 floats) may be odd;
// - c2r: the re-tangle as the core loads (retangle_pair: X[e] and
//   X[e ? M - e : 0], the partner without the power of two's mask; at an
//   odd M no element is its own partner), the inverse core, then x[2j],
//   x[2j + 1] = v[j] as one float2, a warp on runs of P float2 of its
//   rows. The scale rides ab; the core is unscaled;
// - rows of fewer than 6 threads (the second family's 12, 20, 24, 36,
//   40, 60, 100 and the third's 18, 25, 27, 30, 45, 50, 54, 75, 90, 125,
//   150: P = 1-5; SmoothRowGeo::STAGE) would move runs of 8-40 bytes a
//   thread, P rows a warp; as the c2c rows do, they move the block's rows
//   through the planes whole, consecutive threads on consecutive float2 of
//   the block's contiguous rows: the r2c copies its input pairs in (x[2e]
//   to the re plane, x[2e + 1] to the im plane, rows past `rows` zero) and
//   the core loads from there; the c2r re-tangles each element from its
//   two lanes as it copies it in (so the core's loads read one slot each),
//   puts v back into the planes and copies its output pairs out.
// Every put, read and copy of the planes and the stage of the first two
// families takes at most two wavefronts (regcore.r2c_smooth_ways,
// regcore.smooth_stage_ways): one at the second family's rows of one row
// a block (P >= 128: 1620-4000 but 2000, 2400, 2500); two on the V[M - k]
// reads and stage writes and on the copy at the others, on the put and
// the V[k] reads too at the pitches of K = 2 (36, 60, 100, 108, 180,
// 300), and on the staged copies in and out. So do the third family's:
// one at its rows of one row a block (2187, 3375, 3645, 4050), two on the
// V[M - k] reads, the stage writes and the copy at the others (the V[k]
// stage writes too at 25, whose stage pitch M + 1 is even). Each ignores
// the radices and the rows per block of the dense core.

#pragma once

#include "fft_smooth.cuh"
#include "regs_kernels.cuh"

namespace offt {
namespace regs {

// the r2c output stage's pitch mod 32: P mod 32, so rows sharing a warp
// stay P banks apart, but the planes' M + 1 at P = 1 (12 and 20: P mod 32
// took three wavefronts a copy at 12 and 33 floats a row at 20;
// regcore.stage_pitch)
__host__ __device__ constexpr int smooth_stage_pitch(int m, int p) {
  return p == 1 ? m + 1 : p % 32;
}

// the r2c output stage of a smooth row: a pitch of at least M + 1 floats
// (the numpy row); the stage overlays the planes once the untangle has
// read them, so the block takes the larger of the two pitches
template <int M>
struct SmoothRealGeo {
  using G = SmoothRowGeo<M>;
  static constexpr int SPITCH =
      pitch_to(M + 1, smooth_stage_pitch(M, G::P));
  static constexpr int SPAN = SPITCH > G::PITCH ? SPITCH : G::PITCH;
  static constexpr size_t SMEM = (size_t)2 * G::ROWS * SPAN * sizeof(float);
};

// copy the block's nr staged rows of L lanes out, row row0 + r at
// (row0 + r) opitch, the block's NT threads on consecutive floats
template <int M, int L>
static __device__ __forceinline__ void copy_smooth_rows_out(
    const float* sr, const float* si, float* yr, float* yi, long long row0,
    int nr, long long opitch) {
  constexpr int S = SmoothRealGeo<M>::SPITCH, NT = SmoothRowGeo<M>::NT;
  const int tot = nr * L;
  for (int i = threadIdx.x; i < tot; i += NT) {
    const int r = i / L;
    const int c = i - r * L;
    const long long o = (row0 + r) * opitch + c;
    yr[o] = sr[r * S + c];
    yi[o] = si[r * S + c];
  }
}

// The staged r2c rows' copy in (STAGE): the block's ROWS real rows of 2M
// floats from row0 read as M float2 pairs a row, thread tid on pairs
// tid, tid + NT, ... of the block's contiguous rows, pair e of row r to
// r PITCH + e of the re plane (x[2e]) and the im plane (x[2e + 1]); rows
// past `rows` zero.
template <int M>
static __device__ __forceinline__ void smooth_stage_pairs_in(
    float* s, const float* x, long long row0, long long rows) {
  using G = SmoothRowGeo<M>;
  const float2* x2 = reinterpret_cast<const float2*>(x) + row0 * M;
  for (int i = threadIdx.x; i < G::ROWS * M; i += G::NT) {
    const int r = i / M, e = i - r * M;
    const float2 v = row0 + r < rows ? x2[i] : make_float2(0.f, 0.f);
    s[r * G::PITCH + e] = v.x;
    s[(G::ROWS + r) * G::PITCH + e] = v.y;
  }
}

// The staged c2r rows' copy in (STAGE): element e of the block's packed
// planar row r, re-tangled from lanes e and e ? M - e : 0 (retangle_pair,
// the scale in ab), to r PITCH + e of the planes; rows past `rows` zero.
template <int M>
static __device__ __forceinline__ void smooth_stage_retangle_in(
    float* s, const float* xr, const float* xi,
    const float2* __restrict__ ab, long long row0, long long rows) {
  using G = SmoothRowGeo<M>;
  for (int i = threadIdx.x; i < G::ROWS * M; i += G::NT) {
    const int r = i / M, e = i - r * M;
    float2 v = make_float2(0.f, 0.f);
    if (row0 + r < rows) {
      const long long o = (row0 + r) * M;
      const int pe = e ? M - e : 0;
      v = retangle_pair(make_float2(xr[o + e], xi[o + e]),
                        make_float2(xr[o + pe], xi[o + pe]), ab, e);
    }
    s[r * G::PITCH + e] = v.x;
    s[(G::ROWS + r) * G::PITCH + e] = v.y;
  }
}

// The staged c2r rows' copy out (STAGE): element e of the planes' row r
// to the real row row0 + r as the float2 pair (x[2e], x[2e + 1]), thread
// tid on pairs tid, tid + NT, ...; rows past `rows` not written.
template <int M>
static __device__ __forceinline__ void smooth_stage_pairs_out(
    const float* s, float* out, long long row0, long long rows) {
  using G = SmoothRowGeo<M>;
  float2* o2 = reinterpret_cast<float2*>(out) + row0 * M;
  for (int i = threadIdx.x; i < G::ROWS * M; i += G::NT) {
    const int r = i / M, e = i - r * M;
    if (row0 + r < rows)
      o2[i] = make_float2(s[r * G::PITCH + e],
                          s[(G::ROWS + r) * G::PITCH + e]);
  }
}

template <int M>
__global__ void __launch_bounds__(SmoothRowGeo<M>::NT, SmoothRowGeo<M>::MINB)
rows_r2c_smooth(const float* x, float* yr, float* yi,
                const float2* __restrict__ tab, const float2* __restrict__ w,
                long long rows, float scale, int packed, long long opitch) {
  using G = SmoothRowGeo<M>;
  using S = SmoothRealGeo<M>;
  constexpr int P = G::P, V = G::S::V0;
  extern __shared__ __align__(16) float rsmem[];
  const int g = threadIdx.x / P;
  const int t = threadIdx.x % P;
  const long long row0 = (long long)blockIdx.x * G::ROWS;
  float* sre = rsmem + g * G::PITCH;
  float* sim = rsmem + (G::ROWS + g) * G::PITCH;
  float2 v[G::S::VMAX];
  if constexpr (G::STAGE) {
    // the block's input pairs in whole, the core's loads from the planes
    smooth_stage_pairs_in<M>(rsmem, x, row0, rows);
    __syncthreads();
    core_smooth<M, false, SmoothRowLay, true>(
        v, sre, sim, t, tab,
        [&](int e) { return make_float2(sre[e], sim[e]); });
  } else {
    const long long row = row0 + g;
    const bool valid = row < rows;
    const float2* xrow = reinterpret_cast<const float2*>(x) + row * M;
    core_smooth<M, false, SmoothRowLay>(v, sre, sim, t, tab, [&](int e) {
      return valid ? xrow[e] : make_float2(0.f, 0.f);
    });
  }
  __syncthreads();  // every thread has read its last pass's inputs
  outputs_smooth<M>(v, t, [&](int e, float2 y) {  // V in natural order
    sre[e] = y.x;
    sim[e] = y.y;
  });
  __syncthreads();
  // untangle the pairs (k, M - k), k = t + i P over [0, M/2), into
  // registers: lo = X[k], hi = X[M - k] (for k = 0: X[0] + i X[M] packed,
  // else X[0] and X[M]); at an even M thread 0 also takes X[M/2]. At an odd
  // M (the third family's K = 0: V0 and P odd) i < V0 / 2 stops short of
  // (M - 1) / 2: one more i, masked to 2k < M, takes the last (P + 1) / 2
  // pairs, and no lane pairs with itself
  constexpr int NI = (V + 1) / 2;
  const float hs = 0.5f * scale;
  float2 lo[NI], hi[NI];
  unroll<0, NI>([&](auto ic) {
    constexpr int I = decltype(ic)::value;
    const int k = t + I * P;
    if (I == 0 && t == 0) {
      const float a = sre[0], b = sim[0];
      lo[I] = make_float2((a + b) * scale, packed ? (a - b) * scale : 0.f);
      hi[I] = make_float2((a - b) * scale, 0.f);
    } else if (2 * I + 1 < V || 2 * k < M) {
      untangle_at<M>(sre, sim, w, k, k, M - k, hs, lo[I], hi[I]);
    }
  });
  [[maybe_unused]] float2 mid;
  if constexpr (M % 2 == 0) {
    if (t == 0) untangle_at<M>(sre, sim, w, M / 2, M / 2, M / 2, hs, mid, mid);
  }
  float* st_r = rsmem + g * S::SPITCH;
  float* st_i = rsmem + (G::ROWS + g) * S::SPITCH;
  __syncthreads();  // every row has read its V
  unroll<0, NI>([&](auto ic) {
    constexpr int I = decltype(ic)::value;
    const int k = t + I * P;
    if (2 * I + 1 < V || 2 * k < M) {
      st_r[k] = lo[I].x;
      st_i[k] = lo[I].y;
      if (k != 0 || !packed) {
        st_r[M - k] = hi[I].x;  // k = 0: X[M] at lane M of a numpy row
        st_i[M - k] = hi[I].y;
      }
    }
  });
  if constexpr (M % 2 == 0) {
    if (t == 0) {
      st_r[M / 2] = mid.x;
      st_i[M / 2] = mid.y;
    }
  }
  __syncthreads();
  const long long left = rows - row0;
  const int nr = left < G::ROWS ? (int)left : G::ROWS;
  const float* sr = rsmem;
  const float* si = rsmem + G::ROWS * S::SPITCH;
  if (packed)
    copy_smooth_rows_out<M, M>(sr, si, yr, yi, row0, nr, opitch);
  else
    copy_smooth_rows_out<M, M + 1>(sr, si, yr, yi, row0, nr, opitch);
}

template <int M>
__global__ void __launch_bounds__(SmoothRowGeo<M>::NT, SmoothRowGeo<M>::MINB)
rows_c2r_smooth(const float* xr, const float* xi, float* out,
                const float2* __restrict__ tab, const float2* __restrict__ ab,
                long long rows) {
  using G = SmoothRowGeo<M>;
  extern __shared__ __align__(16) float rsmem[];
  const int g = threadIdx.x / G::P;
  const int t = threadIdx.x % G::P;
  const long long row0 = (long long)blockIdx.x * G::ROWS;
  float* sre = rsmem + g * G::PITCH;
  float* sim = rsmem + (G::ROWS + g) * G::PITCH;
  float2 v[G::S::VMAX];
  if constexpr (G::STAGE) {
    // the block's rows in whole, re-tangled as they are copied; the
    // core's loads from the planes, its outputs back into them, the
    // output pairs out whole
    smooth_stage_retangle_in<M>(rsmem, xr, xi, ab, row0, rows);
    __syncthreads();
    core_smooth<M, true, SmoothRowLay, true>(
        v, sre, sim, t, tab,
        [&](int e) { return make_float2(sre[e], sim[e]); });
    __syncthreads();
    outputs_smooth<M>(v, t, [&](int e, float2 y) {
      sre[e] = y.x;
      sim[e] = y.y;
    });
    __syncthreads();
    smooth_stage_pairs_out<M>(rsmem, out, row0, rows);
  } else {
    const long long row = row0 + g;
    const bool valid = row < rows;
    const long long in = row * M;
    auto x = [&](int e) {
      return valid ? make_float2(xr[in + e], xi[in + e])
                   : make_float2(0.f, 0.f);
    };
    core_smooth<M, true, SmoothRowLay>(
        v, sre, sim, t, tab,
        [&](int e) { return retangle_pair(x(e), x(e ? M - e : 0), ab, e); });
    if (!valid) return;
    float2* o = reinterpret_cast<float2*>(out) + row * M;
    outputs_smooth<M>(v, t, [&](int e, float2 y) { o[e] = y; });
  }
}

// the r2c of `rows` real rows at M into rows of `opitch` floats (at least
// the layout's lanes)
template <int M>
static cudaError_t launch_rows_r2c_smooth(const float* x, float* yr,
                                          float* yi, const float2* tab,
                                          const float2* w, long long rows,
                                          float scale, int packed,
                                          long long opitch, cudaStream_t s) {
  using G = SmoothRowGeo<M>;
  constexpr size_t smem = SmoothRealGeo<M>::SMEM;
  auto kernel = rows_r2c_smooth<M>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + G::ROWS - 1) / G::ROWS;
  kernel<<<(unsigned)blocks, G::NT, smem, s>>>(x, yr, yi, tab, w, rows,
                                               scale, packed, opitch);
  return cudaGetLastError();
}

// the c2r of `rows` contiguous packed planar rows at M
template <int M>
static cudaError_t launch_rows_c2r_smooth(const float* xr, const float* xi,
                                          float* out, const float2* tab,
                                          const float2* ab, long long rows,
                                          cudaStream_t s) {
  using G = SmoothRowGeo<M>;
  auto kernel = rows_c2r_smooth<M>;
  cudaError_t err = allow_smem(kernel, G::SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + G::ROWS - 1) / G::ROWS;
  kernel<<<(unsigned)blocks, G::NT, G::SMEM, s>>>(xr, xi, out, tab, ab,
                                                  rows);
  return cudaGetLastError();
}

}  // namespace regs
}  // namespace offt
