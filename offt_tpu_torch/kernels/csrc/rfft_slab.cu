// rfft_slab.cu: r2c along z, then c2c along y, of each x-row of real
// (P, Y, N) f32; the packed planar half-spectrum (P, Y, M + zpad),
// M = N/2, plane 0 carrying X[0] + i X[M]. Unscaled.
//
// Replaces: offt_tpu/kernels/pallas_fft.py rfft_slab_yz (:1944,
// pallas_call :1975, _rfft_slab_kernel :1886). The TPU kernel untangled
// with a dense (2M, 2M) matrix product for M <= 128 and with a second
// half-length transform above it, both because Mosaic has no reversal
// primitive. Here a block reads V[(M - k) mod M] from shared memory
// directly, so one O(M) untangle serves every M.
//
// What bounds it on Hopper: bytes, 8 read (one sample pair) and 8 written
// per output lane when the slab is read and written once, twice that
// when it goes through device memory between its passes. Three layouts,
// as in fft_slab.cu, chosen by the wrapper:
// - Y and M powers of two in [16, 4096] (fused_fft._reg_slab(Y, M)) run
//   the register core (regs_kernels.cuh): the r2c rows read as float2
//   pairs (the input must be 8-byte aligned: the wrapper checks), the
//   M-point core, V in natural order to the exchange planes and the
//   untangle from there; then y on the column variant;
//   - 2^14 to 2^17 elements with M >= 128, Y >= 64 (_cluster_slab; the
//     256^3 slab, Y = 256, M = 128, clusters of 8; the 512^3 one, 1 MB,
//     clusters of 16): one grid of clusters holding each x-row's packed
//     slab in shared memory (ClusterSlab): the untangle writes into the
//     block's slab planes, the cluster syncs, the y lanes read across the
//     cluster and write the output once;
//   - other register slabs: two grids, rows_r2c writing the packed rows
//     at pitch M + zpad, then cols_c2c in place.
// - every other shape: the dense core of fft_core.cuh in one launch: a
//   block owns one x-row, reads Tz real rows at a time as float2 pairs,
//   runs the M-point core, untangles in place (r2c_untangle) and writes the
//   packed rows; it synchronises; then the y columns are read back from
//   the output and transformed in place (slab_cols, shared with
//   fft_slab.cu).
//
// Cost probes of the register core (`phases`, never set by a main path),
// of the cluster layout at Y = 512, M = 256: noy (the y transform
// compiled out), nount (the untangle left out: V itself goes on to y)
// and copy (the transforms and the untangle compiled out: the layout's
// traffic alone); `grids` is the two-grid layout, chosen by the wrapper.

#include "fft_core.cuh"
#include "regs_kernels.cuh"

namespace offt {

__global__ void __launch_bounds__(kThreads)
rfft_slab_kernel(const float* x, float* yr, float* yi,
                 const float2* __restrict__ tabz,
                 const float2* __restrict__ taby,
                 const float2* __restrict__ w, int ny, long long out_pitch,
                 Core cz, Core cy, int Tz, int Ty, size_t tile_elems) {
  extern __shared__ float smem[];
  float* re = smem;
  float* im = smem + tile_elems;
  float2* rootz = reinterpret_cast<float2*>(im + tile_elems);
  float2* rooty = rootz + cz.nroot;
  load_roots(cz, tabz, rootz);
  load_roots(cy, taby, rooty);
  const int m = cz.n;
  const long long row = blockIdx.x;
  const float* x_row = x + row * ny * 2LL * m;
  float* yr_row = yr + row * ny * out_pitch;
  float* yi_row = yi + row * ny * out_pitch;
  // z: Tz real rows of the slab at a time
  const int TPz = Tz | 1;
  for (int y0 = 0; y0 < ny; y0 += Tz) {
    const int valid = ny - y0 < Tz ? ny - y0 : Tz;
    load_real_rows(x_row + y0 * 2LL * m, 2LL * m, m, Tz, TPz, valid, re, im);
    core_run(re, im, Tz, TPz, cz, tabz, rootz);
    r2c_untangle(re, im, Tz, TPz, cz, w);
    store_rows(yr_row + y0 * out_pitch, yi_row + y0 * out_pitch, out_pitch,
               cz, Tz, TPz, valid, re, im);
    __syncthreads();
  }
  // y: Ty consecutive z lanes at a time, read back from the output
  slab_cols(yr_row, yi_row, out_pitch, ny, m, Ty, cy, taby, rooty, re, im);
}

// The packed half-spectrum slab of each x-row in a cluster's shared
// memory (ClusterSlab over (Y, M)): each block runs the r2c rows it keeps
// (float2 pairs, the M-point core, V to the exchange planes, the
// untangle into its slab planes); the cluster syncs; each block runs its
// y lanes from the cluster's planes to the output. Unscaled. ZC, UNT,
// YC = false: the cost probes with the z transform, the untangle or the
// y transform compiled out.
template <int LY, int LM, bool ZC = true, bool UNT = true, bool YC = true>
__global__ void __launch_bounds__(kThreads,
                                  regs::ClusterSlab<LY, LM>::MINB)
rslab_cluster(const float* x, float* yr, float* yi,
              const float2* __restrict__ tabz,
              const float2* __restrict__ taby, const float2* __restrict__ w,
              long long opitch) {
  using S = regs::ClusterSlab<LY, LM>;
  using G = regs::Geo<LM>;
  constexpr int M = G::N;
  extern __shared__ __align__(16) float csm[];
  float* slab_re = csm;
  float* slab_im = csm + S::PLANE;
  float* ex = csm + 2 * S::PLANE;
  auto cluster = cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long p = blockIdx.x / S::C;
  const int g = threadIdx.x / G::P;
  const int t = threadIdx.x % G::P;
  float* sre = ex + g * G::PITCH;
  float* sim = ex + (G::ROWS + g) * G::PITCH;
  float2 v[regs::kE];
  for (int r0 = 0; r0 < S::YB; r0 += G::ROWS) {
    const int yl = r0 + g;
    const float2* xrow = reinterpret_cast<const float2*>(x) +
                         (p * S::Y + rank * S::YB + yl) * M;
    auto keep = [&](int e, float2& y) {  // V in natural order
      sre[regs::phys(e)] = y.x;
      sim[regs::phys(e)] = y.y;
    };
    if constexpr (ZC) {
      regs::core<LM, false>(v, sre, sim, t, tabz,
                            [&](int e) { return xrow[e]; });
      regs::row_sync<M>();
      regs::outputs<LM>(v, t, keep);
    } else {
      regs::each<M, regs::kE>(v, t, [&](int e, float2& y) { y = xrow[e]; });
      regs::each<M, regs::kE>(v, t, keep);
    }
    regs::row_sync<M>();
    // the pairs (k, M - k), k = t + i P over [0, M/2), and X[M/2] by
    // thread 0, into the block's slab row; lane 0 the packed X[0] + i X[M]
    float* dr = slab_re + yl * S::SP;
    float* di = slab_im + yl * S::SP;
    auto pair = [&](int k, float2& xk, float2& xmk) {
      if constexpr (UNT) {
        regs::untangle_pair<M>(sre, sim, w, k, 0.5f, xk, xmk);
      } else {  // V[k] and V[M - k] themselves
        xk = make_float2(sre[regs::phys(k)], sim[regs::phys(k)]);
        xmk = make_float2(sre[regs::phys(M - k)], sim[regs::phys(M - k)]);
      }
    };
    regs::unroll<0, regs::kE / 2>([&](auto ic) {
      const int k = t + decltype(ic)::value * G::P;
      if (k == 0) {
        const float a = sre[0], b = sim[0];  // phys(0) == 0
        dr[0] = UNT ? a + b : a;
        di[0] = UNT ? a - b : b;
      } else {
        float2 xk, xmk;
        pair(k, xk, xmk);
        dr[k] = xk.x;
        di[k] = xk.y;
        dr[M - k] = xmk.x;
        di[M - k] = xmk.y;
      }
    });
    if (t == 0) {
      float2 mid;
      pair(M / 2, mid, mid);
      dr[M / 2] = mid.x;
      di[M / 2] = mid.y;
    }
    __syncthreads();  // every row has read the exchange planes
  }
  cluster.sync();
  regs::cluster_cols<LY, LM, false, YC>(slab_re, slab_im, ex, taby,
                                          yr + p * S::Y * opitch,
                                          yi + p * S::Y * opitch, opitch,
                                          1.f, rank);
  cluster.sync();
}

// the register slab's phases (fused_fft._RSLAB_PHASES)
enum RSlabPhases { kFull = 0, kNoY = 1, kCopy = 3, kNoUntangle = 4 };

static cudaError_t rslab_regs(const float* x, float* yr, float* yi,
                              const float2* tabz, const float2* taby,
                              const float2* w, long long rows, int ny, int m,
                              long long op, int cluster, int phases,
                              cudaStream_t s) {
  using namespace regs;
  if (cluster && phases == kFull) {
    return by_log(ny, [&](auto ly) {
      return by_log(m, [&](auto lm) {
        constexpr int LY = decltype(ly)::value, LM = decltype(lm)::value;
        using S = ClusterSlab<LY, LM>;
        if constexpr (S::OK) {
          return launch_cluster<S>(rslab_cluster<LY, LM>, rows, s, x, yr, yi,
                                   tabz, taby, w, op);
        } else {
          return cudaErrorInvalidValue;
        }
      });
    });
  }
  // z rows: P * Y of them; y lines in place, M lanes per x-row
  const AxisGeom gy{rows, 1, m, ny * op, op, 0, ny * op, op, 0};
  const long long zrows = rows * ny;
  if (phases == kFull) {
    // two grids: the r2c rows, P * Y of them; then the y lines in place,
    // M lanes per x-row
    const AxisGeom gy{rows, 1, m, ny * op, op, 0, ny * op, op, 0};
    cudaError_t err = by_log(m, [&](auto lz) {
      return launch_rows_r2c<decltype(lz)::value>(x, yr, yi, tabz, w,
                                                  rows * ny, op, 1.f, 1, s);
    });
    if (err != cudaSuccess) return err;
    return by_log(ny, [&](auto ly) {
      return launch_cols<decltype(ly)::value, false>(yr, yi, yr, yi, taby,
                                                     gy, 1.f, s);
    });
  }
  // the probes, of the cluster layout at Y = 512, M = 256
  using S = ClusterSlab<9, 8>;
  if (!cluster || ny != 512 || m != 256) return cudaErrorInvalidValue;
  switch (phases) {
    case kNoY:
      return launch_cluster<S>(rslab_cluster<9, 8, true, true, false>, rows,
                               s, x, yr, yi, tabz, taby, w, op);
    case kNoUntangle:
      return launch_cluster<S>(rslab_cluster<9, 8, true, false, true>, rows,
                               s, x, yr, yi, tabz, taby, w, op);
    case kCopy:
      return launch_cluster<S>(rslab_cluster<9, 8, false, false, false>,
                               rows, s, x, yr, yi, tabz, taby, w, op);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace offt

// reg != 0: the register core (Y and M powers of two in [16, 4096]; the
// first rows of the tables, `cluster` and `phases` are read, the radices
// and tiles are not), in a cluster's shared memory (cluster != 0, the
// shapes of ClusterSlab::OK) or in two grids; else the dense core
// (radices, Tz, Ty).
extern "C" int offt_rfft_slab(const void* x, void* yr, void* yi,
                              const void* tabz, const void* taby,
                              const void* w, long long rows, int ny, int m,
                              long long out_pitch, int nsz, int rz0, int rz1,
                              int rz2, int nsy, int ry0, int ry1, int ry2,
                              int Tz, int Ty, int reg, int cluster,
                              int phases, void* stream) {
  using namespace offt;
  if (reg) {
    return (int)rslab_regs((const float*)x, (float*)yr, (float*)yi,
                           (const float2*)tabz, (const float2*)taby,
                           (const float2*)w, rows, ny, m, out_pitch, cluster,
                           phases, (cudaStream_t)stream);
  }
  if (cluster || phases != 0 || Ty < 1 || kThreads % Ty != 0)
    return (int)cudaErrorInvalidValue;
  Core cz = make_core(m, nsz, rz0, rz1, rz2);
  Core cy = make_core(ny, nsy, ry0, ry1, ry2);
  const size_t zt = (size_t)m * (Tz | 1);
  const size_t yt = (size_t)ny * Ty;
  const size_t tile = zt > yt ? zt : yt;
  const size_t smem = core_smem(tile, cz.nroot + cy.nroot);
  cudaError_t err = allow_smem(rfft_slab_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  rfft_slab_kernel<<<(unsigned)rows, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)yr, (float*)yi, (const float2*)tabz,
      (const float2*)taby, (const float2*)w, ny, out_pitch, cz, cy, Tz, Ty,
      tile);
  return (int)cudaGetLastError();
}
