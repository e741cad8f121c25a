// fft_axis.cu: c2c along a strided (non-last) axis of planar f32.
//
// Replaces three Pallas kernels of offt_tpu/kernels/pallas_fft.py:
// fft_sublane (:900), _sublane_nd (:993) and fft_x_from_padded (:1509).
//
// The array is seen as (B, N, Y, Z): batch b, transform index n, and a
// lane l = y * Z + z over the Y * Z positions each transform runs at.
// Element (b, n, y, z) lies at b*sb + n*sn + y*sy + z, with separate
// strides for input and output. So one kernel reads the Z-padded
// intermediate of the slab kernel (sy = Z + pad) and writes the unpadded
// result, runs with equal layouts, or runs aliased (in place): a block
// reads its whole tile before it writes any of it, and no two blocks
// share an element.
//
// What bounds it on Hopper: one read and one write of the planar pair
// (16 bytes per complex element), against the core's r1 + r2 complex MACs
// per element.
// Design: a block owns an (N x T) tile of T consecutive lanes, so a warp
// reads and writes runs of consecutive addresses along the last axis,
// and the tile lands in shared memory column-wise as the core wants it.
// A ragged last tile is masked.

#include "fft_core.cuh"

namespace offt {

__global__ void __launch_bounds__(kThreads)
fft_axis_kernel(const float* xr, const float* xi, float* yr, float* yi,
                const float2* __restrict__ tab, AxisGeom g, Core c, int T,
                long long tiles) {
  extern __shared__ float smem[];
  const int n = c.n;
  float* re = smem;
  float* im = smem + (size_t)n * T;
  float2* sroot = reinterpret_cast<float2*>(im + (size_t)n * T);
  load_roots(c, tab, sroot);
  const long long b = blockIdx.x / tiles;
  const long long l = (blockIdx.x - b * tiles) * T + threadIdx.x % T;
  const bool valid = l < g.ny * g.nz;
  const long long y = l / g.nz;
  const long long z = l - y * g.nz;
  load_cols(xr, xi, g.isn, b * g.isb + y * g.isy + z, valid, n, T, re, im);
  core_run(re, im, T, T, c, tab, sroot);
  store_cols(yr, yi, g.osn, b * g.osb + y * g.osy + z, valid, c, T, re, im);
}

}  // namespace offt

extern "C" int offt_fft_axis(const void* xr, const void* xi, void* yr,
                             void* yi, const void* tab, long long nb, int n,
                             long long ny, long long nz, long long isb,
                             long long isn, long long isy, long long osb,
                             long long osn, long long osy, int ns, int r0,
                             int r1, int r2, int T, void* stream) {
  using namespace offt;
  if (T < 1 || kThreads % T != 0) return (int)cudaErrorInvalidValue;
  Core c = make_core(n, ns, r0, r1, r2);
  AxisGeom g{nb, ny, nz, isb, isn, isy, osb, osn, osy};
  const size_t smem = core_smem((size_t)n * T, c.nroot);
  cudaError_t err = allow_smem(fft_axis_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = (ny * nz + T - 1) / T;
  fft_axis_kernel<<<(unsigned)(tiles * nb), kThreads, smem,
                    (cudaStream_t)stream>>>(
      (const float*)xr, (const float*)xi, (float*)yr, (float*)yi,
      (const float2*)tab, g, c, T, tiles);
  return (int)cudaGetLastError();
}
