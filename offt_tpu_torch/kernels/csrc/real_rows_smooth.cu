// real_rows_smooth.cu: the real rows of rfft_last.cu and icrfft_last.cu at
// the smooth half lengths M = R 2^K whose odd part R is 9, 15, 25 or 45
// (K >= 3, M <= 4096: 72-2304, 120-3840, 200-3200, 360-2880), on the
// register core's smooth rows (fft_smooth.cuh: SmoothRowGeo, core_smooth):
// rows_r2c_smooth and rows_c2r_smooth, the mirror of each other.
//
// Replaces, at those M, the dense core of two Pallas kernels' ports behind
// their C entry points: offt_tpu/kernels/pallas_fft.py rfft_last_planar
// (:1685; rfft_last.cu) and icrfft_last_planar (:2308; icrfft_last.cu).
// The real slabs (rfft_slab.cu, irfft_slab.cu) keep their cores at these
// M. A source of its own so that nvcc builds these instances beside the
// others.
//
// What bounds it on Hopper: the rows' bytes, 8 read (a sample pair) and 8
// written (a planar complex lane) per lane of the half-spectrum, both
// ways. The dense core did one MAC per root read from shared memory and
// ran these rows at 0.04-0.14 of that bound. Design, as the mixed rows'
// rows_r2c_mix and rows_c2r_mix (real_rows_mix.cu) on the smooth rows'
// schedule and geometry: V0 = 12 values a thread (20 at an odd part 25),
// P = M / V0 threads a row, not a power of two, 256 / P rows a block (one
// from P = 256; the ragged last block masked), radix-4 passes (a radix 2
// where K is odd), one radix-3 or radix-5 pass per further odd factor,
// then the Good-Thomas pass of radix V0; the row planes unpadded at a
// pitch of P mod 32 floats (SmoothRowGeo::PITCH), no swizzle:
// - r2c: loads v[j] = x[2j] + i x[2j+1] as one float2 (8-byte aligned
//   input; a warp on consecutive pairs of its rows); the last pass leaves
//   element t + r P, which goes to the row's planes in natural order (a
//   warp on consecutive slots of consecutive rows: one wavefront); after
//   a barrier each thread untangles the pairs (k, M - k), k = t + i P
//   (i < V0 / 2), and thread 0 also M/2. V[k] takes one wavefront as the
//   put; the run of M - k a warp reads falls, row by row, on slots
//   g P - t mod 32, which may meet twice where the warp starts inside a
//   row: two wavefronts at most (regcore.r2c_smooth_ways). The output
//   rows, times `scale`, are staged at a pitch of at least M + 1 that is
//   P mod 32 (SmoothRealGeo::SPITCH), then copied out with consecutive
//   threads on consecutive floats of the block's rows, row r at
//   r `opitch`: at opitch = the lanes (rfft_last's layouts, the only
//   pitch launched) the block's rows are one contiguous run of the output,
//   so the copy writes whole sectors although a numpy row (M + 1 floats)
//   is odd and a block of P = 6 holds 42 rows;
// - c2r: the re-tangle as the core loads (retangle_pair: X[e] and
//   X[e ? M - e : 0], the partner without the power of two's mask), the
//   inverse core, then x[2j], x[2j + 1] = v[j] as one float2, a warp on
//   runs of P float2 of its rows. The scale rides ab; the core is
//   unscaled.
// Each ignores the radices and the rows per block of the dense core.

#include "fft_smooth.cuh"
#include "regs_kernels.cuh"

namespace offt {
namespace regs {

// the r2c output stage of a smooth row: a pitch of at least M + 1 floats
// (the numpy row) that is P mod 32, as the exchange planes', so rows
// sharing a warp stay P banks apart; the stage overlays the planes
template <int M>
struct SmoothRealGeo {
  using G = SmoothRowGeo<M>;
  static constexpr int SPITCH = pitch_to(M + 1, G::P % 32);
  static_assert(SPITCH >= G::PITCH, "the stage covers the planes");
  static constexpr size_t SMEM =
      (size_t)2 * G::ROWS * SPITCH * sizeof(float);
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
  const long long row = (long long)blockIdx.x * G::ROWS + g;
  const bool valid = row < rows;
  float* sre = rsmem + g * G::PITCH;
  float* sim = rsmem + (G::ROWS + g) * G::PITCH;
  const float2* xrow = reinterpret_cast<const float2*>(x) + row * M;
  float2 v[G::S::VMAX];
  core_smooth<M, false, SmoothRowLay>(v, sre, sim, t, tab, [&](int e) {
    return valid ? xrow[e] : make_float2(0.f, 0.f);
  });
  __syncthreads();  // every thread has read its last pass's inputs
  outputs_smooth<M>(v, t, [&](int e, float2 y) {  // V in natural order
    sre[e] = y.x;
    sim[e] = y.y;
  });
  __syncthreads();
  // untangle the pairs (k, M - k), k = t + i P over [0, M/2), into
  // registers: lo = X[k], hi = X[M - k] (for k = 0: X[0] + i X[M] packed,
  // else X[0] and X[M]); thread 0 also takes X[M/2]
  const float hs = 0.5f * scale;
  float2 lo[V / 2], hi[V / 2], mid;
  unroll<0, V / 2>([&](auto ic) {
    constexpr int I = decltype(ic)::value;
    const int k = t + I * P;
    if (I == 0 && t == 0) {
      const float a = sre[0], b = sim[0];
      lo[I] = make_float2((a + b) * scale, packed ? (a - b) * scale : 0.f);
      hi[I] = make_float2((a - b) * scale, 0.f);
    } else {
      untangle_at<M>(sre, sim, w, k, k, M - k, hs, lo[I], hi[I]);
    }
  });
  if (t == 0) untangle_at<M>(sre, sim, w, M / 2, M / 2, M / 2, hs, mid, mid);
  float* st_r = rsmem + g * S::SPITCH;
  float* st_i = rsmem + (G::ROWS + g) * S::SPITCH;
  __syncthreads();  // every row has read its V
  unroll<0, V / 2>([&](auto ic) {
    constexpr int I = decltype(ic)::value;
    const int k = t + I * P;
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
  const long long row = (long long)blockIdx.x * G::ROWS + g;
  const bool valid = row < rows;
  const long long in = row * M;
  auto x = [&](int e) {
    return valid ? make_float2(xr[in + e], xi[in + e])
                 : make_float2(0.f, 0.f);
  };
  float2 v[G::S::VMAX];
  core_smooth<M, true, SmoothRowLay>(
      v, rsmem + g * G::PITCH, rsmem + (G::ROWS + g) * G::PITCH, t, tab,
      [&](int e) { return retangle_pair(x(e), x(e ? M - e : 0), ab, e); });
  if (!valid) return;
  float2* o = reinterpret_cast<float2*>(out) + row * M;
  outputs_smooth<M>(v, t, [&](int e, float2 y) { o[e] = y; });
}

}  // namespace regs

cudaError_t rfft_smooth(const float* x, float* yr, float* yi,
                        const float2* tab, const float2* w, long long rows,
                        int m, float scale, int packed, long long opitch,
                        cudaStream_t s) {
  if (opitch < m + !packed) return cudaErrorInvalidValue;
  return regs::by_smooth(m, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    using G = regs::SmoothRowGeo<M>;
    constexpr size_t smem = regs::SmoothRealGeo<M>::SMEM;
    auto kernel = regs::rows_r2c_smooth<M>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const long long blocks = (rows + G::ROWS - 1) / G::ROWS;
    kernel<<<(unsigned)blocks, G::NT, smem, s>>>(x, yr, yi, tab, w, rows,
                                                 scale, packed, opitch);
    return cudaGetLastError();
  });
}

cudaError_t icrfft_smooth(const float* xr, const float* xi, float* out,
                          const float2* tab, const float2* ab, long long rows,
                          int m, cudaStream_t s) {
  return regs::by_smooth(m, [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    using G = regs::SmoothRowGeo<M>;
    auto kernel = regs::rows_c2r_smooth<M>;
    cudaError_t err = allow_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return err;
    const long long blocks = (rows + G::ROWS - 1) / G::ROWS;
    kernel<<<(unsigned)blocks, G::NT, G::SMEM, s>>>(xr, xi, out, tab, ab,
                                                    rows);
    return cudaGetLastError();
  });
}

}  // namespace offt
