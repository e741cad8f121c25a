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
// What bounds it on Hopper: the dense DFT core's instruction issue, as in
// fft_slab.cu. Design: one block owns one x-row, and its output row is
// the intermediate. The y pass goes first: Ty consecutive z lanes at a
// time are read from the pitched input (lanes past M are skipped), the
// optional Nyquist side plane is added to lane 0 as + i*side, the inverse
// y core runs, and the result is written into the block's own output row
// as interleaved complex: a real row of 2M floats holds exactly M complex
// values. The block synchronises; then the z pass reads Tz of those rows
// whole into shared memory (as float2 pairs), re-tangles them, runs the
// inverse M-point core and writes x[2j] = Re v[j], x[2j+1] = Im v[j] over
// the same rows. Each tile is read entirely before any of it is written,
// so the update in place is safe. The scale rides the re-tangle table
// (row 0 included); both cores are unscaled.

#include "fft_core.cuh"

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

}  // namespace offt

extern "C" int offt_irfft_slab(const void* xr, const void* xi,
                               const void* side_r, const void* side_i,
                               void* out, const void* tabz, const void* taby,
                               const void* ab, long long rows, int ny, int m,
                               long long in_pitch, int nsz, int rz0, int rz1,
                               int rz2, int nsy, int ry0, int ry1, int ry2,
                               int Tz, int Ty, void* stream) {
  using namespace offt;
  if (Ty < 1 || kThreads % Ty != 0) return (int)cudaErrorInvalidValue;
  if ((side_r == nullptr) != (side_i == nullptr))
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
