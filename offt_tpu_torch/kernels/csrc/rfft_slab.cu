// rfft_slab.cu: r2c along z, then c2c along y, of each x-row of real
// (P, Y, N) f32, in one launch; the packed planar half-spectrum
// (P, Y, M + zpad), M = N/2, plane 0 carrying X[0] + i X[M].
//
// Replaces: offt_tpu/kernels/pallas_fft.py rfft_slab_yz (:1944,
// _rfft_slab_kernel :1886). The TPU kernel untangled with a dense
// (2M, 2M) matrix product for M <= 128 and with a second half-length
// transform above it, both because Mosaic has no reversal primitive.
// Here the block reads V[(M - k) mod M] from shared memory directly, so
// one O(M) untangle serves every M (r2c_untangle in fft_core.cuh).
//
// What bounds it on Hopper: as fft_slab.cu, the dense DFT core's
// instruction issue; the real input is half the bytes of a planar pair.
// Design: one block owns one x-row. It reads Tz real rows at a time as
// float2 pairs (v[j] = x[2j] + i x[2j+1], coalesced), runs the M-point
// forward core, untangles in place, and writes the packed rows to the
// output at its padded pitch; it synchronises; then the y columns are read
// back from the output and transformed in place (slab_cols, shared with
// fft_slab.cu). Unscaled.

#include "fft_core.cuh"

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

}  // namespace offt

extern "C" int offt_rfft_slab(const void* x, void* yr, void* yi,
                              const void* tabz, const void* taby,
                              const void* w, long long rows, int ny, int m,
                              long long out_pitch, int nsz, int rz0, int rz1,
                              int rz2, int nsy, int ry0, int ry1, int ry2,
                              int Tz, int Ty, void* stream) {
  using namespace offt;
  if (Ty < 1 || kThreads % Ty != 0) return (int)cudaErrorInvalidValue;
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
