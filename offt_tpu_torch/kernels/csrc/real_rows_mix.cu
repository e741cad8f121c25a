// real_rows_mix.cu: the real rows of rfft_last.cu and icrfft_last.cu at
// the mixed half lengths M = R0 2^k, R0 = 3 or 5: 3 2^k in [48, 1536] and
// 3072, 5 2^k in [80, 2560], on the register core's mixed rows
// (MixRowGeo, core_mix_rows): rows_r2c_mix and rows_c2r_mix, the mirror
// of each other.
//
// Replaces, at those M, the dense core of four Pallas kernels' ports
// behind their C entry points: offt_tpu/kernels/pallas_fft.py
// rfft_last_planar (:1685; rfft_last.cu) and icrfft_last_planar (:2308;
// icrfft_last.cu), and the rows of rfft_slab_yz (:1944; rfft_slab.cu,
// whose two grids write them at the slab's pitch M + zpad) and of
// irfft_slab_yz (:2160; irfft_slab.cu, reading its planar scratch). A
// source of its own so that nvcc builds these instances beside the
// others.
//
// What bounds it on Hopper: the rows' bytes, 8 read (a sample pair) and
// 8 written (a planar complex lane) per lane of the half-spectrum, both
// ways. The dense core did one MAC per root read from shared memory and
// ran these rows at about 0.06 of that bound. Design, as the
// power-of-two rows_r2c and rows_c2r with the mixed rows' geometry: V =
// 4 R0 values a thread, P = M / V threads a row, 256 / P rows a block
// (the ragged last block masked), radix-4 passes (one radix 2 where
// log2 P is odd) and a last Good-Thomas pass of radix 12 or 20, the
// exchange planes swizzled (MixRowGeo::at ^ row_mask):
// - r2c: loads v[j] = x[2j] + i x[2j+1] as one float2 (8-byte aligned
//   input; a warp on consecutive pairs of a row, whole 32-byte sectors
//   at every P); the last pass leaves element t + r P, which goes to the
//   row's planes in natural order at the swizzled base of t XOR that of
//   r P (one wavefront, as a get); after a barrier each thread untangles
//   the pairs (k, M - k), k = t + i P, and thread 0 also M/2. V[k] comes
//   from the swizzled base, V[M - k] from the map at run time: the run of
//   M - k a warp reads crosses an aligned run of 32 floats, whose swizzle
//   differs, so it takes two wavefronts (regcore.r2c_mix_ways). The
//   output rows, times `scale`, are staged at a pitch of at least M + 1
//   (one slot past MixRowGeo::PITCH where that is M), rows sharing a warp
//   P banks apart, then copied out with consecutive threads on
//   consecutive floats of the block's rows, row r at r `opitch`. At
//   opitch = the lanes (rfft_last's layouts) the block's rows are one
//   contiguous run of the output, so the copy writes whole sectors
//   although a numpy row (M + 1 floats) is odd. At the slab's pitch
//   M + zpad (zpad = 8) a warp's 32 floats split where a row ends, and
//   the pad lanes between two rows are skipped: M is a multiple of 16,
//   so each piece is a whole number of aligned 8-float runs and every
//   row starts 32-byte aligned (M + 8 a multiple of 8); the stores stay
//   whole sectors, two runs a warp where a row ends inside it;
// - c2r: the re-tangle as the core loads (retangle_pair: X[e] and
//   X[e ? M - e : 0], the partner index without the power of two's mask),
//   the inverse core, then x[2j], x[2j + 1] = v[j] as one float2, a warp
//   on runs of 2 P float2 (32 bytes at P = 4): whole sectors, so the
//   short rows need no stage. The scale rides ab; the core is unscaled.
// Each ignores the radices and the rows per block of the dense core.

#include "regs_kernels.cuh"

namespace offt {
namespace regs {

// the r2c output stage of a mixed row: a pitch of at least M + 1 floats
// (the numpy row), rows sharing a warp (P < 32) P banks apart
template <int M>
struct MixRealGeo {
  using G = MixRowGeo<M>;
  static constexpr int SPITCH = G::P >= 32 ? M + 1 : pitch_to(M + 1, G::P);
  static constexpr size_t STAGE = (size_t)2 * G::ROWS * SPITCH * sizeof(float);
  static constexpr size_t SMEM = STAGE > G::SMEM ? STAGE : G::SMEM;
};

// copy the block's nr staged rows of L lanes out, row row0 + r at
// (row0 + r) opitch
template <int M, int L>
static __device__ __forceinline__ void copy_rows_out(const float* sr,
                                                     const float* si,
                                                     float* yr, float* yi,
                                                     long long row0, int nr,
                                                     long long opitch) {
  constexpr int S = MixRealGeo<M>::SPITCH;
  const int tot = nr * L;
  for (int i = threadIdx.x; i < tot; i += kThreads) {
    const int r = i / L;
    const int c = i - r * L;
    const long long o = (row0 + r) * opitch + c;
    yr[o] = sr[r * S + c];
    yi[o] = si[r * S + c];
  }
}

template <int M>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rows_r2c_mix(const float* x, float* yr, float* yi,
             const float2* __restrict__ tab, const float2* __restrict__ w,
             long long rows, float scale, int packed, long long opitch) {
  using G = MixRowGeo<M>;
  using S = MixRealGeo<M>;
  constexpr int P = G::P, V = G::V;
  extern __shared__ __align__(16) float rsmem[];
  const int g = threadIdx.x / P;
  const int t = threadIdx.x % P;
  const long long row = (long long)blockIdx.x * G::ROWS + g;
  const bool valid = row < rows;
  float* sre = rsmem + g * G::PITCH;
  float* sim = rsmem + (G::ROWS + g) * G::PITCH;
  const int gm = G::row_mask(g);
  const float2* xrow = reinterpret_cast<const float2*>(x) + row * M;
  float2 v[V];
  core_mix_rows<M, false>(v, sre, sim, t, gm, tab, [&](int e) {
    return valid ? xrow[e] : make_float2(0.f, 0.f);
  });
  mix_row_sync<M>();
  // V in natural order: element t + r P at (at(t) ^ gm) ^ at(r P)
  const int xb = G::at(t) ^ gm;
  unroll<0, V>([&](auto rc) {
    constexpr int R = decltype(rc)::value;
    const int a = xor_off<G::at(R * P)>(xb);
    sre[a] = v[R].x;
    sim[a] = v[R].y;
  });
  mix_row_sync<M>();
  // untangle the pairs (k, M - k), k = t + i P over [0, M/2), into
  // registers: lo = X[k], hi = X[M - k] (for k = 0: X[0] + i X[M] packed,
  // else X[0] and X[M]); thread 0 also takes X[M/2]
  const float hs = 0.5f * scale;
  float2 lo[V / 2], hi[V / 2], mid;
  unroll<0, V / 2>([&](auto ic) {
    constexpr int I = decltype(ic)::value;
    const int k = t + I * P;
    const int pa = xor_off<G::at(I * P)>(xb);
    if (I == 0 && t == 0) {
      const float a = sre[pa], b = sim[pa];
      lo[I] = make_float2((a + b) * scale, packed ? (a - b) * scale : 0.f);
      hi[I] = make_float2((a - b) * scale, 0.f);
    } else {
      untangle_at<M>(sre, sim, w, k, pa, G::at(M - k) ^ gm, hs, lo[I],
                     hi[I]);
    }
  });
  if (t == 0) {
    const int pm = G::at(M / 2) ^ gm;
    untangle_at<M>(sre, sim, w, M / 2, pm, pm, hs, mid, mid);
  }
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
    copy_rows_out<M, M>(sr, si, yr, yi, row0, nr, opitch);
  else
    copy_rows_out<M, M + 1>(sr, si, yr, yi, row0, nr, opitch);
}

template <int M>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
rows_c2r_mix(const float* xr, const float* xi, float* out,
             const float2* __restrict__ tab, const float2* __restrict__ ab,
             long long rows) {
  using G = MixRowGeo<M>;
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
  float2 v[G::V];
  core_mix_rows<M, true>(v, rsmem + g * G::PITCH,
                         rsmem + (G::ROWS + g) * G::PITCH, t,
                         G::row_mask(g), tab, [&](int e) {
                           return retangle_pair(x(e), x(e ? M - e : 0), ab,
                                                e);
                         });
  if (!valid) return;
  float2* o = reinterpret_cast<float2*>(out) + row * M;
  outputs_mix<M>(v, t, [&](int e, float2 y) { o[e] = y; });
}

}  // namespace regs

cudaError_t rfft_mix(const float* x, float* yr, float* yi, const float2* tab,
                     const float2* w, long long rows, int m, float scale,
                     int packed, long long opitch, cudaStream_t s) {
  if (opitch < m + !packed) return cudaErrorInvalidValue;
  auto run = [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    using G = regs::MixRowGeo<M>;
    constexpr size_t smem = regs::MixRealGeo<M>::SMEM;
    auto kernel = regs::rows_r2c_mix<M>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    const long long blocks = (rows + G::ROWS - 1) / G::ROWS;
    kernel<<<(unsigned)blocks, kThreads, smem, s>>>(x, yr, yi, tab, w, rows,
                                                    scale, packed, opitch);
    return cudaGetLastError();
  };
  return m % 3 == 0 ? regs::by_mixed<3, 48, 3072>(m, run)
                    : regs::by_mixed<5>(m, run);
}

cudaError_t icrfft_mix(const float* xr, const float* xi, float* out,
                       const float2* tab, const float2* ab, long long rows,
                       int m, cudaStream_t s) {
  auto run = [&](auto mc) {
    constexpr int M = decltype(mc)::value;
    using G = regs::MixRowGeo<M>;
    auto kernel = regs::rows_c2r_mix<M>;
    cudaError_t err = allow_smem(kernel, G::SMEM);
    if (err != cudaSuccess) return err;
    const long long blocks = (rows + G::ROWS - 1) / G::ROWS;
    kernel<<<(unsigned)blocks, kThreads, G::SMEM, s>>>(xr, xi, out, tab, ab,
                                                       rows);
    return cudaGetLastError();
  };
  return m % 3 == 0 ? regs::by_mixed<3, 48, 3072>(m, run)
                    : regs::by_mixed<5>(m, run);
}

}  // namespace offt
