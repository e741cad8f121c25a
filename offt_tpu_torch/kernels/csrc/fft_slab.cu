// fft_slab.cu: c2c along z, then along y, of each x-row of planar
// (P, Y, Z) f32, in one launch.
//
// Replaces: offt_tpu/kernels/pallas_fft.py fft_slab_yz (:1404,
// _slab_kernel :1374). The TPU kernel held a whole (Y, Z) slab in VMEM;
// a 256^2 planar slab is 512 KB and one block has 227 KB of shared
// memory, so the slab passes through shared memory in tiles instead.
//
// What bounds it on Hopper: bytes. The z pass reads the slab once from
// device memory and writes it once; the y pass reads those writes back
// and writes them again. Design: one block owns one x-row. It runs the z
// pencils through shared memory Tz rows at a time (as fft_last does) and
// writes them to the output at its padded pitch; it synchronises; then
// it reads the y columns back in Ty-wide tiles (as fft_axis does),
// transforms them and writes them in place. The read-back of a row the
// block has just written comes from L2 while the slabs in flight fit it
// (132 SMs' worth of 256^2 slabs is about 66 MB against 50 MB of L2), so
// the second pass costs L2 traffic rather than device-memory traffic
// until the slabs outgrow L2.
//
// Options: out_pitch = Z + zpad leaves zpad pad lanes per row unwritten;
// in_pitch > Z skips input pad lanes (z_true); x == y runs in place (the
// block reads each z tile before it writes it, and owns its row).
// The scale rides the y tables.

#include "fft_core.cuh"

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

}  // namespace offt

extern "C" int offt_fft_slab(const void* xr, const void* xi, void* yr,
                             void* yi, const void* tabz, const void* taby,
                             long long rows, int ny, int nz,
                             long long in_pitch, long long out_pitch,
                             int nsz, int rz0, int rz1, int rz2, int nsy,
                             int ry0, int ry1, int ry2, int Tz, int Ty,
                             void* stream) {
  using namespace offt;
  if (Ty < 1 || kThreads % Ty != 0) return (int)cudaErrorInvalidValue;
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
