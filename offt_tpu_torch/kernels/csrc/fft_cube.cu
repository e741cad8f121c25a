// fft_cube.cu: c2c along all three axes of batched planar f32 cubes
// (B, X, Y, Z), X*Y*Z <= 2^21, in one cooperative launch.
//
// Replaces: offt_tpu/kernels/pallas_fft.py fft3d_cube (:1156,
// _cube_kernel :1117). The TPU kernel held one whole cube in VMEM and
// turned it with in-register transpose sandwiches; none of that carries
// over. What it computes does: the x, y and z transforms of each cube,
// the inverse's 1/(XYZ) and out_scale on the last z stage.
//
// What bounds it on Hopper: one read of the input and one write of the
// output (16 bytes per complex element), against the three cores' MACs.
// A cube is at most 16 MiB of planar pairs: it does not fit one SM's
// shared memory as it fit VMEM, but it fits the 50 MB L2. Design: one
// cooperative launch of as many blocks as are co-resident walks the
// batch one cube at a time, in phases separated by grid-wide barriers:
//   x: column tiles of T lanes (as fft_axis), read from the input and
//      written to the work buffer;
//   y: column tiles along y, in place on the work buffer;
//   z: row tiles of whole z lines, in place, the scale on the last stage.
// Only the x phase reads device memory cold; y and z read back what the
// phase before wrote, from L2. A z line too long for one block's shared
// memory (Z up to 32768 at three stages) splits the z core in two:
//   z1: its first stage (radix r0) along stride L = Z / r0 as column
//       tiles, times the twiddle W_Z^(k j), in place on the work buffer;
//   z2: the remaining stages on the r0 contiguous rows of L, each row k1
//       written at k1 + r0 * k', the natural order, into the output.
// z2 cannot run in place, so with the split the x phase writes a one-cube
// scratch buffer and z2 writes the output.
//
// Every block reaches every barrier: a block with no tile in a phase
// goes straight to it. The host sizes the grid by the occupancy API, so
// that all blocks are resident, as a cooperative launch requires. The
// barrier is cooperative_groups' grid.sync(), which needs no relocatable
// device code since CUDA 11, so the source builds with the common nvcc
// line.

#include <cooperative_groups.h>

#include "fft_core.cuh"

namespace cg = cooperative_groups;

namespace offt {

struct CubeGeom {
  long long nb;    // cubes
  int nx, ny, nz;  // cube extents
  int tx, ty;      // lanes per column tile of the x and y phases
  int tz;          // rows per row tile of the z phase (no split)
  int zsplit;      // 1: the z1 / z2 sub-phases
  int t1, t2;      // split: lanes per z1 tile, rows per z2 tile
};

__global__ void __launch_bounds__(kThreads)
fft_cube_kernel(const float* xr, const float* xi, float* yr, float* yi,
                float* sr, float* si, const float2* __restrict__ tabx,
                const float2* __restrict__ taby,
                const float2* __restrict__ tabz,
                const float2* __restrict__ tabz2, CubeGeom g, Core cx,
                Core cy, Core cz, Core cz1, Core cz2, int tile_elems) {
  extern __shared__ float smem[];
  cg::grid_group grid = cg::this_grid();
  float* re = smem;
  float* im = smem + tile_elems;
  float2* rootx = reinterpret_cast<float2*>(im + tile_elems);
  float2* rooty = rootx + cx.nroot;
  float2* rootz = rooty + cy.nroot;  // no split: cz's roots
  float2* root1 = rootz;             // split: z1's radix-r0 roots,
  float2* root2 = root1 + cz1.n;     // then z2's
  load_roots(cx, tabx, rootx);
  load_roots(cy, taby, rooty);
  if (g.zsplit) {
    for (int i = threadIdx.x; i < cz1.n; i += blockDim.x)
      root1[i] = __ldg(tabz + g.nz + i);  // stage 0's rows of the Z table
    load_roots(cz2, tabz2, root2);
  } else {
    load_roots(cz, tabz, rootz);
  }
  const long long vol = (long long)g.nx * g.ny * g.nz;
  const long long plane = (long long)g.ny * g.nz;
  const long long lines = (long long)g.nx * g.ny;
  float* wr = g.zsplit ? sr : yr;  // the work buffer of phases x, y, z(1)
  float* wi = g.zsplit ? si : yi;
  for (long long b = 0; b < g.nb; ++b) {
    const float* ir = xr + b * vol;
    const float* ii = xi + b * vol;
    float* cr = wr + (g.zsplit ? 0 : b * vol);
    float* ci = wi + (g.zsplit ? 0 : b * vol);
    // ---- x: lanes l = y * Z + z, element n at n * Y * Z + l ----
    {
      const int T = g.tx;
      const long long tiles = (plane + T - 1) / T;
      for (long long i = blockIdx.x; i < tiles; i += gridDim.x) {
        const long long l = i * T + threadIdx.x % T;
        const bool valid = l < plane;
        load_cols(ir, ii, plane, l, valid, g.nx, T, re, im);
        core_run(re, im, T, T, cx, tabx, rootx);
        store_cols(cr, ci, plane, l, valid, cx, T, re, im);
        __syncthreads();
      }
    }
    grid.sync();
    // ---- y: per x plane, lanes z, element n at n * Z + z ----
    {
      const int T = g.ty;
      const long long per = (g.nz + T - 1) / T;
      const long long tiles = (long long)g.nx * per;
      for (long long i = blockIdx.x; i < tiles; i += gridDim.x) {
        const long long xrow = i / per;
        const long long z = (i - xrow * per) * T + threadIdx.x % T;
        const bool valid = z < g.nz;
        float* pr = cr + xrow * plane;
        float* pi = ci + xrow * plane;
        load_cols(pr, pi, g.nz, z, valid, g.ny, T, re, im);
        core_run(re, im, T, T, cy, taby, rooty);
        store_cols(pr, pi, g.nz, z, valid, cy, T, re, im);
        __syncthreads();
      }
    }
    grid.sync();
    if (!g.zsplit) {
      // ---- z: whole contiguous lines, in place ----
      const int T = g.tz;
      const int TP = T | 1;
      const long long tiles = (lines + T - 1) / T;
      for (long long i = blockIdx.x; i < tiles; i += gridDim.x) {
        const long long row0 = i * T;
        const long long left = lines - row0;
        const int valid = left < T ? (int)left : T;
        float* pr = cr + row0 * g.nz;
        float* pi = ci + row0 * g.nz;
        load_rows(pr, pi, g.nz, g.nz, T, TP, valid, re, im);
        core_run(re, im, T, TP, cz, tabz, rootz);
        store_rows(pr, pi, g.nz, cz, T, TP, valid, re, im);
        __syncthreads();
      }
    } else {
      // ---- z1: stage 0 along stride L, times W_Z^(k j), in place ----
      const int r0 = cz1.n;
      const int L = cz2.n;
      {
        const int T = g.t1;
        const long long lanes = lines * L;
        const long long tiles = (lanes + T - 1) / T;
        const int t = threadIdx.x % T;
        const int step = blockDim.x / T;
        for (long long i = blockIdx.x; i < tiles; i += gridDim.x) {
          const long long l = i * T + t;
          const bool valid = l < lanes;
          const long long line = l / L;
          const int j = (int)(l - line * L);
          const long long loff = line * g.nz + j;
          load_cols(cr, ci, L, loff, valid, r0, T, re, im);
          core_run(re, im, T, T, cz1, tabz, root1);
          // one stage: output k sits at k; the twiddle rides the store
          for (int k = threadIdx.x / T; k < r0; k += step) {
            if (valid) {
              const float2 w = __ldg(tabz + k * j);
              const float ar = re[k * T + t], ai = im[k * T + t];
              cr[loff + (long long)k * L] = ar * w.x - ai * w.y;
              ci[loff + (long long)k * L] = ar * w.y + ai * w.x;
            }
          }
          __syncthreads();
        }
      }
      grid.sync();
      // ---- z2: rows k1 of L, written at k1 + r0 * k' of the output ----
      {
        const int T = g.t2;
        const int TP = T | 1;
        const long long rows = lines * r0;
        const long long tiles = (rows + T - 1) / T;
        float* orr = yr + b * vol;
        float* oi = yi + b * vol;
        for (long long i = blockIdx.x; i < tiles; i += gridDim.x) {
          const long long row0 = i * T;
          const long long left = rows - row0;
          const int valid = left < T ? (int)left : T;
          load_rows(cr + row0 * L, ci + row0 * L, L, L, T, TP, valid, re,
                    im);
          core_run(re, im, T, TP, cz2, tabz2, root2);
          // row t fastest: neighbouring threads write neighbouring k1
          const int tot = L * T;
          for (int e = threadIdx.x; e < tot; e += blockDim.x) {
            const int k = e / T;
            const int tt = e - k * T;
            if (tt < valid) {
              const long long gr = row0 + tt;
              const long long line = gr / r0;
              const long long k1 = gr - line * r0;
              const long long o = line * g.nz + k1 + (long long)r0 * k;
              const int p = core_pos(cz2, k) * TP + tt;
              orr[o] = re[p];
              oi[o] = im[p];
            }
          }
          __syncthreads();
        }
      }
    }
    // the next cube's x phase may overwrite the scratch buffer; without
    // the split it writes another cube's output, so no barrier is needed
    if (g.zsplit && b + 1 < g.nb) grid.sync();
  }
}

}  // namespace offt

extern "C" int offt_fft_cube(const void* xr, const void* xi, void* yr,
                             void* yi, void* sr, void* si, const void* tabx,
                             const void* taby, const void* tabz,
                             const void* tabz2, long long nb, int nx, int ny,
                             int nz, int nsx, int rx0, int rx1, int rx2,
                             int nsy, int ry0, int ry1, int ry2, int nsz,
                             int rz0, int rz1, int rz2, int tx, int ty,
                             int tz, int zsplit, int t1, int t2,
                             void* stream) {
  using namespace offt;
  if (tx < 1 || kThreads % tx || ty < 1 || kThreads % ty)
    return (int)cudaErrorInvalidValue;
  Core cx = make_core(nx, nsx, rx0, rx1, rx2);
  Core cy = make_core(ny, nsy, ry0, ry1, ry2);
  Core cz = make_core(nz, nsz, rz0, rz1, rz2);
  Core cz1 = cz, cz2 = cz;
  const long long lines = (long long)nx * ny;
  long long tiles = 0;
  size_t tile_elems = 0;
  int nroot = cx.nroot + cy.nroot;
  if (zsplit) {
    if (nsz < 2 || t1 < 1 || kThreads % t1) return (int)cudaErrorInvalidValue;
    const int L = nz / rz0;
    cz1 = make_core(rz0, 1, rz0, 1, 1);
    cz2 = make_core(L, nsz - 1, rz1, rz2, 1);
    nroot += cz1.n + cz2.nroot;
    tile_elems = (size_t)rz0 * t1;
    const size_t e2 = (size_t)L * (t2 | 1);
    if (e2 > tile_elems) tile_elems = e2;
    const long long a = (lines * L + t1 - 1) / t1;
    const long long c = (lines * rz0 + t2 - 1) / t2;
    tiles = a > c ? a : c;
  } else {
    nroot += cz.nroot;
    tile_elems = (size_t)nz * (tz | 1);
    tiles = (lines + tz - 1) / tz;
  }
  const size_t ex = (size_t)nx * tx, ey = (size_t)ny * ty;
  if (ex > tile_elems) tile_elems = ex;
  if (ey > tile_elems) tile_elems = ey;
  const long long plane = (long long)ny * nz;
  const long long tx_tiles = (plane + tx - 1) / tx;
  const long long ty_tiles = (long long)nx * ((nz + ty - 1) / ty);
  if (tx_tiles > tiles) tiles = tx_tiles;
  if (ty_tiles > tiles) tiles = ty_tiles;
  const size_t smem = core_smem(tile_elems, nroot);
  cudaError_t err = allow_smem(fft_cube_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                      fft_cube_kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  long long grid = (long long)per_sm * sms;
  if (tiles < grid) grid = tiles;
  if (grid < 1) grid = 1;
  CubeGeom g{nb, nx, ny, nz, tx, ty, tz, zsplit, t1, t2};
  const float* a0 = (const float*)xr;
  const float* a1 = (const float*)xi;
  float* a2 = (float*)yr;
  float* a3 = (float*)yi;
  float* a4 = (float*)sr;
  float* a5 = (float*)si;
  const float2* a6 = (const float2*)tabx;
  const float2* a7 = (const float2*)taby;
  const float2* a8 = (const float2*)tabz;
  const float2* a9 = (const float2*)tabz2;
  int te = (int)tile_elems;
  void* args[] = {&a0, &a1, &a2, &a3, &a4, &a5, &a6, &a7, &a8, &a9,
                  &g,  &cx, &cy, &cz, &cz1, &cz2, &te};
  err = cudaLaunchCooperativeKernel((const void*)fft_cube_kernel,
                                    dim3((unsigned)grid), dim3(kThreads),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
