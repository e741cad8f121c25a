// assemble_mp1.cu: the packed planar half-spectrum (R, Y, M) plus the
// split planes a (k = 0) and b (k = M), each (R, Y), into the numpy
// layout (R, Y, M + 1) in one pass.
//
// Replaces: offt_tpu/kernels/pallas_fft.py _assemble_mp1 (:2012,
// _asm_mp1_kernel :2001), which the TPU needed because XLA's own
// concatenate into a 129-lane layout was slow there.
//
// What bounds it on Hopper: bytes, one read and one write of the planar
// pair. Design: one thread per output element over a grid-stride loop;
// neighbouring threads take neighbouring output elements, so both the
// writes and the reads of the packed rows are runs of consecutive
// addresses. It is CUDA and not Triton, though Triton would serve an
// elementwise copy as well: the package has one build path (nvcc into a
// library loaded with ctypes), and a second toolchain for a copy kernel is
// not worth it.

#include "fft_core.cuh"

namespace offt {

__global__ void __launch_bounds__(kThreads)
assemble_mp1_kernel(const float* __restrict__ yr,
                    const float* __restrict__ yi,
                    const float* __restrict__ ar,
                    const float* __restrict__ ai,
                    const float* __restrict__ br,
                    const float* __restrict__ bi, float* __restrict__ o_r,
                    float* __restrict__ o_i, long long planes, int m) {
  const long long total = planes * (m + 1);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += stride) {
    const long long q = e / (m + 1);
    const int k = (int)(e - q * (m + 1));
    float vr, vi;
    if (k == 0) {
      vr = ar[q];
      vi = ai[q];
    } else if (k == m) {
      vr = br[q];
      vi = bi[q];
    } else {
      vr = yr[q * m + k];
      vi = yi[q * m + k];
    }
    o_r[e] = vr;
    o_i[e] = vi;
  }
}

}  // namespace offt

extern "C" int offt_assemble_mp1(const void* yr, const void* yi,
                                 const void* ar, const void* ai,
                                 const void* br, const void* bi, void* o_r,
                                 void* o_i, long long planes, int m,
                                 void* stream) {
  using namespace offt;
  const long long total = planes * (m + 1);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) return (int)cudaSuccess;
  assemble_mp1_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)yr, (const float*)yi, (const float*)ar, (const float*)ai,
      (const float*)br, (const float*)bi, (float*)o_r, (float*)o_i, planes,
      m);
  return (int)cudaGetLastError();
}
