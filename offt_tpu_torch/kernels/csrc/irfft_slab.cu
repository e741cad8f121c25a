// irfft_slab.cu: inverse c2c along y, then c2r along z, of each x-row of
// a packed planar (P, Y, M + pad) half-spectrum, in one launch; the real
// (P, Y, N) result, N = 2M.
//
// Replaces: offt_tpu/kernels/pallas_fft.py irfft_slab_yz (:2160,
// _crfft_slab_kernel :2092). The TPU kernel re-tangled with a dense
// (2M, 2M) matrix for M <= 128 and with two inverse half-length
// transforms of diagonally scaled inputs above it (Mosaic has no
// reversal); here the block reads X[(M - k) mod M] from shared memory,
// so one O(M) re-tangle serves every M (c2r_retangle in fft_core.cuh).
//
// What bounds it on Hopper: bytes, 8 read (one complex input lane) and 8
// written (two real outputs) per lane when the slab is read and written
// once, twice that when it goes through device memory between its
// passes. Three layouts, the mirror of rfft_slab.cu's, chosen by the
// wrapper; the scale rides the re-tangle table (row 0 included) and every
// core is unscaled:
// - Y and M powers of two in [16, 4096] (fused_fft._reg_slab(Y, M)) run
//   the register core (regs_kernels.cuh): y first on the column variant,
//   inverse, the side plane added to lane 0 as it loads; then the c2r rows
//   (rows_c2r: the re-tangle as the M-point core loads, float2 stores);
//   - 2^14 to 2^15 elements with M >= 128, Y >= 64
//     (fused_fft._cluster_irslab, IrCluster below; the 256^3 slab in
//     clusters of 8): one grid of clusters holding each x-row's slab in
//     shared memory
//     (ClusterSlab): each block runs its share of the y lanes from the
//     device input and writes element y of each line into the block that
//     keeps row y (distributed shared memory, 32-bit addresses), the
//     cluster syncs, each block runs the c2r rows it keeps out to the
//     real output: the slab is read from device memory once and written
//     once;
//   - other register slabs: two grids through a planar (P, Y, M) scratch
//     the wrapper allocates (the input is not the plan's to overwrite):
//     cols_c2c from the input, then rows_c2r from the scratch.
// - every other shape: the dense core of fft_core.cuh in one launch: one
//   block owns one x-row, and its output row is the intermediate. The y
//   pass goes first: Ty consecutive z lanes at a time are read from the
//   pitched input (lanes past M are skipped), the optional Nyquist side
//   plane is added to lane 0 as + i*side, the inverse y core runs, and the
//   result is written into the block's own output row as interleaved
//   complex: a real row of 2M floats holds exactly M complex values. The
//   block synchronises; then the z pass reads Tz of those rows whole into
//   shared memory (as float2 pairs), re-tangles them, runs the inverse
//   M-point core and writes x[2j] = Re v[j], x[2j+1] = Im v[j] over the
//   same rows. Each tile is read entirely before any of it is written, so
//   the update in place is safe.

#include "fft_core.cuh"
#include "regs_kernels.cuh"

namespace offt {

__global__ void __launch_bounds__(kThreads)
irfft_slab_kernel(const float* xr, const float* xi,
                  const float* __restrict__ side_r,
                  const float* __restrict__ side_i, float* out,
                  const float2* __restrict__ tabz,
                  const float2* __restrict__ taby,
                  const float2* __restrict__ ab, int ny, long long in_pitch,
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
  const float* xr_row = xr + row * ny * in_pitch;
  const float* xi_row = xi + row * ny * in_pitch;
  float* o_row = out + row * ny * 2LL * m;
  // y: Ty consecutive z lanes at a time, into the output as complex
  const int t = threadIdx.x % Ty;
  const int step = blockDim.x / Ty;
  for (int z0 = 0; z0 < m; z0 += Ty) {
    const int z = z0 + t;
    const bool valid = z < m;
    load_cols(xr_row, xi_row, in_pitch, z, valid, ny, Ty, re, im);
    if (side_r != nullptr && z == 0) {
      // plane 0 + i * side: the thread that loaded lane 0 updates it
      for (int k = threadIdx.x / Ty; k < ny; k += step) {
        re[k * Ty] -= side_i[row * ny + k];
        im[k * Ty] += side_r[row * ny + k];
      }
    }
    core_run(re, im, Ty, Ty, cy, taby, rooty);
    if (valid) {
      for (int k = threadIdx.x / Ty; k < ny; k += step) {
        const int p = core_pos(cy, k) * Ty + t;
        *reinterpret_cast<float2*>(o_row + k * 2LL * m + 2 * z) =
            make_float2(re[p], im[p]);
      }
    }
    __syncthreads();
  }
  // z: Tz rows at a time, re-tangled, inverse M-point core, interleaved
  const int TPz = Tz | 1;
  for (int y0 = 0; y0 < ny; y0 += Tz) {
    const int valid = ny - y0 < Tz ? ny - y0 : Tz;
    float* rows = o_row + y0 * 2LL * m;
    load_real_rows(rows, 2LL * m, m, Tz, TPz, valid, re, im);
    c2r_retangle(re, im, Tz, TPz, m, ab);
    core_run(re, im, Tz, TPz, cz, tabz, rootz);
    store_real_rows(rows, 2LL * m, cz, Tz, TPz, valid, re, im);
    __syncthreads();
  }
}

// The slab of each x-row in a cluster's shared memory (ClusterSlab over
// (Y, M)): block rank b runs the y lanes [b ZB, (b + 1) ZB), L at a time,
// from the device input (pitch ipitch, lanes past M never read; lane 0
// plus i side), inverse, writing element y of each line into row y mod YB
// of block y div YB; the cluster syncs; each block runs its YB c2r rows
// from its slab planes to the real output. After that sync no block reads
// another's shared memory, so none waits for the others to leave.
template <int LY, int LM>
__global__ void __launch_bounds__(kThreads,
                                  regs::ClusterSlab<LY, LM>::MINB)
irslab_cluster(const float* xr, const float* xi,
               const float* __restrict__ side_r,
               const float* __restrict__ side_i, float* out,
               const float2* __restrict__ tabz,
               const float2* __restrict__ taby,
               const float2* __restrict__ ab, long long ipitch) {
  using S = regs::ClusterSlab<LY, LM>;
  using C = regs::ColGeo<LY>;
  using G = regs::Geo<LM>;
  constexpr int M = G::N;
  extern __shared__ __align__(16) float csm[];
  float* slab_re = csm;
  float* slab_im = csm + S::PLANE;
  float* ex = csm + 2 * S::PLANE;
  auto cluster = cooperative_groups::this_cluster();
  const int rank = (int)cluster.block_rank();
  const long long p = blockIdx.x / S::C;
  float2 v[regs::kE];
  cluster.sync();  // every block has started: its shared memory exists
  {
    const int l = threadIdx.x % C::L;
    const int t = threadIdx.x / C::L;
    const unsigned re0 = (unsigned)__cvta_generic_to_shared(slab_re);
    const unsigned im0 = (unsigned)__cvta_generic_to_shared(slab_im);
    const float* ar = xr + p * S::Y * ipitch;
    const float* ai = xi + p * S::Y * ipitch;
    for (int z0 = rank * S::ZB; z0 < (rank + 1) * S::ZB; z0 += C::L) {
      const int z = z0 + l;
      regs::core<LY, true, typename C::Lay>(
          v, ex + l, ex + C::SIZE + l, t, taby, [&](int e) {
            float2 x = make_float2(ar[e * ipitch + z], ai[e * ipitch + z]);
            if (side_r != nullptr && z == 0) {  // + i (side_r + i side_i)
              x.x -= side_i[p * S::Y + e];
              x.y += side_r[p * S::Y + e];
            }
            return x;
          });
      regs::outputs<LY>(v, t, [&](int e, float2 w) {
        const unsigned at = 4u * ((e % S::YB) * S::SP + z);
        regs::st_cluster(re0 + at, e / S::YB, w.x);
        regs::st_cluster(im0 + at, e / S::YB, w.y);
      });
      __syncthreads();  // every lane has read the exchange planes
    }
  }
  cluster.sync();
  const int g = threadIdx.x / G::P;
  const int t = threadIdx.x % G::P;
  float* sre = ex + g * G::PITCH;
  float* sim = ex + (G::ROWS + g) * G::PITCH;
  for (int r0 = 0; r0 < S::YB; r0 += G::ROWS) {
    const int yl = r0 + g;
    const float* dr = slab_re + yl * S::SP;
    const float* di = slab_im + yl * S::SP;
    regs::c2r_core<LM>(v, sre, sim, t, tabz, ab, [&](int e) {
      return make_float2(dr[e], di[e]);
    });
    float2* o = reinterpret_cast<float2*>(out) +
                (p * S::Y + rank * S::YB + yl) * M;
    regs::outputs<LM>(v, t, [&](int e, float2 w) { o[e] = w; });
    __syncthreads();  // every row has read the exchange planes
  }
}

// The shapes that take irslab_cluster (fused_fft._cluster_irslab): those
// of ClusterSlab::OK where ptxas spills nothing, 2^14 to 2^15 elements.
// At 2^16 and 2^17 it spills 8 to 156 bytes at its 128 registers
// (offt_tpu_torch/bench/ptxas_spills.py), and at the 512^3 slab two grids
// ran faster than its clusters of 16: those run two grids.
template <int LY, int LM>
constexpr bool IrCluster = regs::ClusterSlab<LY, LM>::OK && LY + LM <= 15;

static cudaError_t irslab_regs(const float* xr, const float* xi,
                               const float* side_r, const float* side_i,
                               float* out, float* sr, float* si,
                               const float2* tabz, const float2* taby,
                               const float2* ab, long long rows, int ny,
                               int m, long long ip, int cluster,
                               cudaStream_t s) {
  using namespace regs;
  if (cluster) {
    return by_log(ny, [&](auto ly) {
      return by_log(m, [&](auto lm) {
        constexpr int LY = decltype(ly)::value, LM = decltype(lm)::value;
        if constexpr (IrCluster<LY, LM>) {
          using S = ClusterSlab<LY, LM>;
          return launch_cluster<S>(irslab_cluster<LY, LM>, rows, s, xr, xi,
                                   side_r, side_i, out, tabz, taby, ab, ip);
        } else {
          return cudaErrorInvalidValue;
        }
      });
    });
  }
  if (sr == nullptr || si == nullptr) return cudaErrorInvalidValue;
  // two grids: the y lines, M lanes per x-row, into the (P, Y, M) scratch;
  // then the c2r rows, P * Y of them
  const AxisGeom gy{rows, 1, m, ny * ip, ip, 0, (long long)ny * m, m, 0};
  cudaError_t err = by_log(ny, [&](auto ly) {
    return launch_cols<decltype(ly)::value, true, kThreads, true>(
        xr, xi, sr, si, taby, gy, 1.f, s, side_r, side_i);
  });
  if (err != cudaSuccess) return err;
  return by_log(m, [&](auto lm) {
    return launch_rows_c2r<decltype(lm)::value>(sr, si, out, tabz, ab,
                                                rows * ny, m, s);
  });
}

}  // namespace offt

// reg != 0: the register core (Y and M powers of two in [16, 4096]; the
// first rows of both tables, ab and `cluster` are read, the radices and
// tiles are not), in a cluster's shared memory (cluster != 0, the shapes
// of IrCluster) or in two grids through the scratch (sr, si) of
// rows * ny * m floats each; else the dense core (radices, Tz, Ty).
extern "C" int offt_irfft_slab(const void* xr, const void* xi,
                               const void* side_r, const void* side_i,
                               void* out, void* sr, void* si,
                               const void* tabz, const void* taby,
                               const void* ab, long long rows, int ny, int m,
                               long long in_pitch, int nsz, int rz0, int rz1,
                               int rz2, int nsy, int ry0, int ry1, int ry2,
                               int Tz, int Ty, int reg, int cluster,
                               void* stream) {
  using namespace offt;
  if ((side_r == nullptr) != (side_i == nullptr))
    return (int)cudaErrorInvalidValue;
  if (reg) {
    return (int)irslab_regs(
        (const float*)xr, (const float*)xi, (const float*)side_r,
        (const float*)side_i, (float*)out, (float*)sr, (float*)si,
        (const float2*)tabz, (const float2*)taby, (const float2*)ab, rows,
        ny, m, in_pitch, cluster, (cudaStream_t)stream);
  }
  if (cluster || Ty < 1 || kThreads % Ty != 0)
    return (int)cudaErrorInvalidValue;
  Core cz = make_core(m, nsz, rz0, rz1, rz2);
  Core cy = make_core(ny, nsy, ry0, ry1, ry2);
  const size_t zt = (size_t)m * (Tz | 1);
  const size_t yt = (size_t)ny * Ty;
  const size_t tile = zt > yt ? zt : yt;
  const size_t smem = core_smem(tile, cz.nroot + cy.nroot);
  cudaError_t err = allow_smem(irfft_slab_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  irfft_slab_kernel<<<(unsigned)rows, kThreads, smem,
                      (cudaStream_t)stream>>>(
      (const float*)xr, (const float*)xi, (const float*)side_r,
      (const float*)side_i, (float*)out, (const float2*)tabz,
      (const float2*)taby, (const float2*)ab, ny, in_pitch, cz, cy, Tz, Ty,
      tile);
  return (int)cudaGetLastError();
}
