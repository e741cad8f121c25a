// fft_slab.cu: c2c along z, then along y, of each x-row of planar
// (P, Y, Z) f32.
//
// Replaces: offt_tpu/kernels/pallas_fft.py fft_slab_yz (:1404,
// pallas_call :1448, _slab_kernel :1374). The TPU kernel held a whole
// (Y, Z) slab in VMEM; a 256^2 planar slab is 512 KB and one block has
// 227 KB of shared memory.
//
// What bounds it on Hopper: bytes, 16 a complex element when the slab is
// read once and written once, 32 when it goes through device memory
// between its z and y passes. Three layouts, chosen by the wrapper:
// - Y and Z powers of two in [16, 4096] or mixed lengths R0 2^k
//   (fused_fft._reg_slab) run the register core (regs_kernels.cuh): z on
//   its rows, y on its column variant, `scale` at the y store;
//   - 2^14 to 2^17 elements with Z >= 128, Y >= 64 (_cluster_slab; the
//     256^3 slab): one grid of clusters of C <= 16 blocks, each x-row's
//     slab held in the cluster's shared memory (ClusterSlab): each block
//     runs the z rows it keeps from device memory into its planes, the
//     cluster syncs, each block runs its share of the y lanes reading the
//     other blocks' planes (distributed shared memory, 32-bit addresses)
//     and writes the output: the slab is read and written once;
//   - other register slabs (the 512^3 one: 2 MB, twice what a cluster of
//     16 would hold at 8192 elements a block; every slab with a mixed
//     length, the 320^3 one among them): two grids, rows_c2c (rows_mix at
//     a mixed Z, fft_last_mix.cu) from the input (pitch in_pitch) to the
//     output (pitch out_pitch), unscaled, then cols_c2c (cols_mix at a
//     mixed Y, fft_axis_mix.cu, on the lane tile fft_axis routes) in
//     place on the output. Where the
//     z-transformed slab lives between the passes was measured
//     (bench/probe_slabparts.py): one block per x-row running both passes
//     (the `fused` probe) reads its own z writes back with 396 slabs of
//     512 KB in flight, four times the 50 MB L2, and took 1.7x two grids.
// - every other slab: the dense core of fft_core.cuh in one launch: a
//   block owns one x-row, runs the z pencils through shared memory Tz rows
//   at a time (as fft_last does), writes them to the output at its padded
//   pitch, synchronises, and reads the y columns back in Ty-wide tiles (as
//   fft_axis does), transforms them and writes them in place. Its scale
//   rides the y tables.
//
// Options: out_pitch = Z + zpad leaves zpad pad lanes per row unwritten;
// in_pitch > Z skips input pad lanes (z_true); x == y runs in place (every
// layout reads an x-row's elements before it writes any of them, and no
// two blocks or clusters share one).
//
// Cost probes of the register core (`phases`, never set by a main path),
// at Y = Z = 256, forward: zonly, yonly and copy (the cluster layout with
// the y, the z or both transforms compiled out) and fused (one block per
// x-row, the slab read back from the output); `grids` is the two-grid
// layout, chosen by the wrapper.

#include "fft_core.cuh"
#include "regs_kernels.cuh"

namespace offt {

struct SlabGeom {
  int ny, nz;
  long long in_pitch, out_pitch;
};

__global__ void __launch_bounds__(kThreads)
fft_slab_kernel(const float* xr, const float* xi, float* yr, float* yi,
                const float2* __restrict__ tabz,
                const float2* __restrict__ taby, SlabGeom g, Core cz, Core cy,
                int Tz, int Ty, size_t tile_elems) {
  extern __shared__ float smem[];
  float* re = smem;
  float* im = smem + tile_elems;
  float2* rootz = reinterpret_cast<float2*>(im + tile_elems);
  float2* rooty = rootz + cz.nroot;
  load_roots(cz, tabz, rootz);
  load_roots(cy, taby, rooty);
  const long long row = blockIdx.x;
  const float* xr_row = xr + row * g.ny * g.in_pitch;
  const float* xi_row = xi + row * g.ny * g.in_pitch;
  float* yr_row = yr + row * g.ny * g.out_pitch;
  float* yi_row = yi + row * g.ny * g.out_pitch;
  // z: Tz rows of the slab at a time
  const int TPz = Tz | 1;
  for (int y0 = 0; y0 < g.ny; y0 += Tz) {
    const int valid = g.ny - y0 < Tz ? g.ny - y0 : Tz;
    load_rows(xr_row + y0 * g.in_pitch, xi_row + y0 * g.in_pitch,
              g.in_pitch, g.nz, Tz, TPz, valid, re, im);
    core_run(re, im, Tz, TPz, cz, tabz, rootz);
    store_rows(yr_row + y0 * g.out_pitch, yi_row + y0 * g.out_pitch,
               g.out_pitch, cz, Tz, TPz, valid, re, im);
    __syncthreads();
  }
  // y: Ty consecutive z lanes at a time, read back from the output
  slab_cols(yr_row, yi_row, g.out_pitch, g.ny, g.nz, Ty, cy, taby, rooty, re,
            im);
}

// One x-row a block: the z rows of its slab on the row core, then its y
// lines read back from the output on the column variant; forward,
// unscaled, Y = Z = 2^LOG. The `fused` cost probe.
template <int LOG>
__global__ void __launch_bounds__(kThreads, regs::kMinBlocks)
slab_fused(const float* xr, const float* xi, float* yr, float* yi,
           const float2* __restrict__ tab, long long ipitch,
           long long opitch) {
  using G = regs::Geo<LOG>;
  using C = regs::ColGeo<LOG>;
  constexpr int N = G::N;
  static_assert(G::P >= regs::kStagedBelow && N % G::ROWS == 0,
                "unstaged rows, whole row groups");
  extern __shared__ __align__(16) float fsmem[];
  const long long p = blockIdx.x;
  const float* ar = xr + p * N * ipitch;
  const float* ai = xi + p * N * ipitch;
  float* br = yr + p * N * opitch;
  float* bi = yi + p * N * opitch;
  float2 v[regs::kE];
  {
    const int g = threadIdx.x / G::P;
    const int t = threadIdx.x % G::P;
    float* sre = fsmem + g * G::PITCH;
    float* sim = fsmem + (G::ROWS + g) * G::PITCH;
    for (int y0 = 0; y0 < N; y0 += G::ROWS) {
      const long long in = (y0 + g) * ipitch, out = (y0 + g) * opitch;
      regs::core<LOG, false>(v, sre, sim, t, tab, [&](int e) {
        return make_float2(ar[in + e], ai[in + e]);
      });
      regs::outputs<LOG>(v, t, [&](int e, float2 y) {
        br[out + e] = y.x;
        bi[out + e] = y.y;
      });
      __syncthreads();
    }
  }
  {
    const int l = threadIdx.x % C::L;
    const int t = threadIdx.x / C::L;
    float* sre = fsmem + l;
    float* sim = fsmem + C::SIZE + l;
    for (int z0 = 0; z0 < N; z0 += C::L) {
      float* cr = br + z0 + l;
      float* ci = bi + z0 + l;
      regs::core<LOG, false, typename C::Lay>(v, sre, sim, t, tab,
                                              [&](int e) {
        return make_float2(cr[e * opitch], ci[e * opitch]);
      });
      regs::outputs<LOG>(v, t, [&](int e, float2 y) {
        cr[e * opitch] = y.x;
        ci[e * opitch] = y.y;
      });
      __syncthreads();
    }
  }
}

// The slab of each x-row in a cluster's shared memory (ClusterSlab): each
// block runs the z rows it keeps, from device memory into its planes;
// the cluster syncs; each block runs its y lanes from the cluster's planes
// to the output, times `scale`. ZC / YC = false: the cost probes with the
// z or the y transform compiled out.
template <int LY, int LZ, bool INV, bool ZC = true, bool YC = true>
__global__ void __launch_bounds__(kThreads,
                                  regs::ClusterSlab<LY, LZ>::MINB)
slab_cluster(const float* xr, const float* xi, float* yr, float* yi,
             const float2* __restrict__ tabz,
             const float2* __restrict__ taby, long long ipitch,
             long long opitch, float scale) {
  using S = regs::ClusterSlab<LY, LZ>;
  using G = regs::Geo<LZ>;
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
    const long long in = (p * S::Y + rank * S::YB + yl) * ipitch;
    auto load = [&](int e) { return make_float2(xr[in + e], xi[in + e]); };
    auto keep = [&](int e, float2& w) {
      slab_re[yl * S::SP + e] = w.x;
      slab_im[yl * S::SP + e] = w.y;
    };
    if constexpr (ZC) {
      regs::core<LZ, INV>(v, sre, sim, t, tabz, load);
      regs::outputs<LZ>(v, t, keep);
    } else {
      regs::each<S::Z, regs::kE>(v, t, [&](int e, float2& x) { x = load(e); });
      regs::each<S::Z, regs::kE>(v, t, keep);
    }
    __syncthreads();  // every row has read the exchange planes
  }
  cluster.sync();
  regs::cluster_cols<LY, LZ, INV, YC>(slab_re, slab_im, ex, taby,
                                      yr + p * S::Y * opitch,
                                      yi + p * S::Y * opitch, opitch, scale,
                                      rank);
  cluster.sync();
}

// the register slab's phases (fused_fft._SLAB_PHASES)
enum SlabPhases { kFull = 0, kZOnly = 1, kYOnly = 2, kCopy = 3, kFused = 5 };

static cudaError_t slab_regs(const float* xr, const float* xi, float* yr,
                             float* yi, const float2* tabz,
                             const float2* taby, long long rows, int ny,
                             int nz, long long ip, long long op, int inverse,
                             float scale, int cluster, int phases,
                             cudaStream_t s) {
  using namespace regs;
  if (cluster && phases == kFull) {
    return by_log(ny, [&](auto ly) {
      return by_log(nz, [&](auto lz) {
        constexpr int LY = decltype(ly)::value, LZ = decltype(lz)::value;
        using S = ClusterSlab<LY, LZ>;
        if constexpr (S::OK) {
          return inverse
                     ? launch_cluster<S>(slab_cluster<LY, LZ, true>, rows, s,
                                         xr, xi, yr, yi, tabz, taby, ip, op,
                                         scale)
                     : launch_cluster<S>(slab_cluster<LY, LZ, false>, rows,
                                         s, xr, xi, yr, yi, tabz, taby, ip,
                                         op, scale);
        } else {
          return cudaErrorInvalidValue;
        }
      });
    });
  }
  if (phases == kFull) {
    // two grids: z rows, P * Y of them, in at ip, out at op; then the y
    // lines in place on the output, Z lanes per x-row
    const AxisGeom gy{rows, 1, nz, ny * op, op, 0, ny * op, op, 0};
    cudaError_t err;
    if (nz & (nz - 1)) {
      err = last_mix(xr, xi, yr, yi, tabz, rows * ny, nz, ip, op, inverse,
                     1.f, s);
    } else {
      err = by_log(nz, [&](auto lz) {
        constexpr int LZ = decltype(lz)::value;
        return inverse ? launch_rows<LZ, true>(xr, xi, yr, yi, tabz,
                                               rows * ny, ip, op, 1.f, s)
                       : launch_rows<LZ, false>(xr, xi, yr, yi, tabz,
                                                rows * ny, ip, op, 1.f, s);
      });
    }
    if (err != cudaSuccess) return err;
    if (ny & (ny - 1))
      return axis_mix(yr, yi, yr, yi, taby, gy, ny, inverse, scale, -1, s);
    return by_log(ny, [&](auto ly) {
      constexpr int LY = decltype(ly)::value;
      return inverse ? launch_cols<LY, true>(yr, yi, yr, yi, taby, gy, scale,
                                             s)
                     : launch_cols<LY, false>(yr, yi, yr, yi, taby, gy,
                                              scale, s);
    });
  }
  // the probes: forward, at Y = Z = 256, of the cluster layout (fused: of
  // the one-block-a-row layout)
  using S = ClusterSlab<8, 8>;
  if (inverse || ny != 256 || nz != 256) return cudaErrorInvalidValue;
  switch (phases) {
    case kZOnly:
      return launch_cluster<S>(slab_cluster<8, 8, false, true, false>, rows,
                               s, xr, xi, yr, yi, tabz, taby, ip, op, scale);
    case kYOnly:
      return launch_cluster<S>(slab_cluster<8, 8, false, false, true>, rows,
                               s, xr, xi, yr, yi, tabz, taby, ip, op, scale);
    case kCopy:
      return launch_cluster<S>(slab_cluster<8, 8, false, false, false>, rows,
                               s, xr, xi, yr, yi, tabz, taby, ip, op, scale);
    case kFused: {
      constexpr size_t smem = Geo<8>::SMEM > ColGeo<8>::SMEM
                                  ? Geo<8>::SMEM
                                  : ColGeo<8>::SMEM;
      cudaError_t err = allow_smem(slab_fused<8>, smem);
      if (err != cudaSuccess) return err;
      slab_fused<8><<<(unsigned)rows, kThreads, smem, s>>>(xr, xi, yr, yi,
                                                           tabz, ip, op);
      return cudaGetLastError();
    }
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace offt

// reg != 0: the register core (Y and Z powers of two in [16, 4096] or
// mixed lengths; the first rows of both tables, `inverse`, `scale`,
// `cluster` and `phases` are read, the radices and tiles are not), in a
// cluster's shared memory (cluster != 0, the shapes of ClusterSlab::OK) or
// in two grids; else the dense core (radices, Tz, Ty; the scale is in the
// y table).
extern "C" int offt_fft_slab(const void* xr, const void* xi, void* yr,
                             void* yi, const void* tabz, const void* taby,
                             long long rows, int ny, int nz,
                             long long in_pitch, long long out_pitch,
                             int nsz, int rz0, int rz1, int rz2, int nsy,
                             int ry0, int ry1, int ry2, int Tz, int Ty,
                             int inverse, float scale, int reg, int cluster,
                             int phases, void* stream) {
  using namespace offt;
  if (reg) {
    return (int)slab_regs((const float*)xr, (const float*)xi, (float*)yr,
                          (float*)yi, (const float2*)tabz,
                          (const float2*)taby, rows, ny, nz, in_pitch,
                          out_pitch, inverse, scale, cluster, phases,
                          (cudaStream_t)stream);
  }
  if (cluster || phases != 0 || Ty < 1 || kThreads % Ty != 0)
    return (int)cudaErrorInvalidValue;
  Core cz = make_core(nz, nsz, rz0, rz1, rz2);
  Core cy = make_core(ny, nsy, ry0, ry1, ry2);
  const size_t zt = (size_t)nz * (Tz | 1);
  const size_t yt = (size_t)ny * Ty;
  const size_t tile = zt > yt ? zt : yt;
  const size_t smem = core_smem(tile, cz.nroot + cy.nroot);
  cudaError_t err = allow_smem(fft_slab_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  SlabGeom g{ny, nz, in_pitch, out_pitch};
  fft_slab_kernel<<<(unsigned)rows, kThreads, smem,
                    (cudaStream_t)stream>>>(
      (const float*)xr, (const float*)xi, (float*)yr, (float*)yi,
      (const float2*)tabz, (const float2*)taby, g, cz, cy, Tz, Ty, tile);
  return (int)cudaGetLastError();
}
