// fourstep_mix.cu: the two kernels of fourstep.cu at the mixed lengths
// N = R0 2^k, R0 = 3 or 5, 16 <= 2^k <= 512 (48-1536 and 80-2560), on
// the register core: step 1 on the column variant (cols_twiddle_mix),
// step 3 on the mixed rows with a transposing store (rows_transposed_mix).
//
// Replaces, at those lengths, the dense core of the four-step pair's two
// Pallas kernels (offt_tpu/kernels/fourstep.py _step1_twiddle :166,
// _step3_transposed :213), behind the C entry points of fourstep.cu. A
// source of its own so that nvcc builds these instances beside the
// power-of-two ones, not after them.
//
// What bounds them on Hopper: as fourstep.cu, one read and one write of
// the planar pair (step 1 also reads the 8-byte twiddle). Each kernel
// routes on its own length, so a split such as 3 2^18 = (1024, 768) runs
// step 1 at a power of two and step 3 here. Design:
// - step 1 is cols_mix (fft_axis_mix.cu: V = 4 R0 values a thread,
//   P = N / V threads a line, radix-4 passes and a last Good-Thomas pass
//   of radix V, the exchange planes padded one slot per four elements),
//   unscaled, with output n of lane l stored times tw[n lanes + l], as
//   cols_twiddle_block does: each table load at the lane the data has, so
//   it coalesces as the data does. The table carries every scale. Lane
//   tile: the one cols_mix takes at the same P (mix_col_threads; the
//   strided-axis kernel's, fused_fft._axis_tile): narrow, 256 threads, to
//   P = 8; wide, 32 lanes up to 1024 threads, above.
// - step 3 is rows_mix's rows (MixRowGeo: the swizzled exchange planes,
//   row_mask) over R consecutive rows (b, k1) a block, then the outputs
//   (element t + r P, natural order) into a stage [k][c] swizzled as
//   TrStage::at swizzles it (P is a power of two, so its bank arithmetic
//   carries over with N in place of 2^LOG) and each k's run of R floats
//   stored at tr_base(r, N, n1) + k n1 (store_runs), each row finding its
//   own batch. Layout (fourstep._step3_layout): 256 / P rows in 256
//   threads below P = 32 (64 rows at 48 and 80), 8 rows in 8 P threads
//   from P = 32 (384, 640: 256; 768, 1280: 512; 1536, 2560: 1024). The
//   stage holds 2 N R floats: 48 KB and 80 KB at 768 and 1280, 96 KB and
//   160 KB at 1536 and 2560; 160 KB leaves one block an SM (2 at 80 KB).
//
// The radices, T and `block` are not read. An unsupported length returns
// cudaErrorInvalidValue (3072 and lengths with a factor 3^2, 5^2 or 15
// stay on the dense core: the wrappers route them there).

#include "regs_kernels.cuh"

namespace offt {
namespace regs {

// Step 1 at a mixed length: cols_mix's lines on the (B, N, Y, Z)
// geometry, unscaled, and output n of lane l stored times tw[n * lanes +
// l] (lanes = Y Z).
template <int N, bool INV, int NT>
__global__ void __launch_bounds__(NT, col_min_blocks(NT))
cols_twiddle_mix(const float* xr, const float* xi, float* yr, float* yi,
                 const float2* __restrict__ tab,
                 const float2* __restrict__ tw, AxisGeom g, long long tiles) {
  using C = MixColGeo<N, NT>;
  extern __shared__ __align__(16) float csmem[];
  const int l = threadIdx.x % C::L;
  const int t = threadIdx.x / C::L;
  const long long b = blockIdx.x / tiles;
  const long long lanes = g.ny * g.nz;
  const long long lane = (blockIdx.x - b * tiles) * C::L + l;
  const bool valid = lane < lanes;
  const long long y = valid ? lane / g.nz : 0;
  const long long z = valid ? lane - y * g.nz : 0;
  const long long in = b * g.isb + y * g.isy + z;
  const long long out = b * g.osb + y * g.osy + z;
  float2 v[MixGeo<N>::V];
  core_mix<N, INV, typename C::Lay>(
      v, csmem + l, csmem + C::SIZE + l, t, tab, [&](int e) {
        const long long o = in + e * g.isn;
        return valid ? make_float2(xr[o], xi[o]) : make_float2(0.f, 0.f);
      });
  if (!valid) return;
  outputs_mix<N>(v, t, [&](int e, float2 w) {
    const float2 m = __ldg(tw + e * lanes + lane);
    const long long o = out + e * g.osn;
    yr[o] = w.x * m.x - w.y * m.y;
    yi[o] = w.x * m.y + w.y * m.x;
  });
}

// The block of step 3 at a mixed length: R = NT / P rows, each in its
// own exchange planes at MixRowGeo's pitch, and the stage over them.
template <int N, int NT>
struct MixTrGeo : TrStage<N, MixGeo<N>::P, NT> {
  using G = MixRowGeo<N>;
  using S = TrStage<N, G::P, NT>;
  static constexpr size_t EX = (size_t)2 * S::R * G::PITCH * sizeof(float);
  static constexpr size_t SMEM = EX > S::ST ? EX : S::ST;
};

// threads of a block of step 3 at P threads a row: 256 (256 / P rows) to
// P = 32, then 8 rows
__host__ __device__ constexpr int mix_tr_threads(int p) {
  return p <= 32 ? kThreads : 8 * p;
}

// Step 3 at a mixed length: the block's rows through core_mix_rows, their
// outputs into the stage at TrStage::at, then store_runs.
template <int N, bool INV, int NT>
__global__ void __launch_bounds__(NT, col_min_blocks(NT))
rows_transposed_mix(const float* __restrict__ xr,
                    const float* __restrict__ xi, float* __restrict__ yr,
                    float* __restrict__ yi, const float2* __restrict__ tab,
                    long long rows, long long n1) {
  using T = MixTrGeo<N, NT>;
  using G = typename T::G;
  extern __shared__ __align__(16) float tsmem[];
  const int g = threadIdx.x / T::P;
  const int t = threadIdx.x % T::P;
  const long long row0 = (long long)blockIdx.x * T::R;
  const long long row = row0 + g;
  const bool valid = row < rows;
  const long long in = row * N;
  float2 v[G::V];
  core_mix_rows<N, INV>(v, tsmem + g * G::PITCH,
                        tsmem + (T::R + g) * G::PITCH, t, G::row_mask(g),
                        tab, [&](int e) {
                          return valid ? make_float2(xr[in + e], xi[in + e])
                                       : make_float2(0.f, 0.f);
                        });
  __syncthreads();  // every row has read its exchange planes
  outputs_mix<N>(v, t, [&](int e, float2 y) {
    const int a = T::at(e, g);
    tsmem[a] = y.x;
    tsmem[N * T::R + a] = y.y;
  });
  __syncthreads();
  store_runs<T, NT, 1>(yr, yi, tsmem, row0, rows, n1, 0, threadIdx.x);
}

}  // namespace regs

namespace {

template <int N, bool INV>
cudaError_t step1_mix_n(const float* xr, const float* xi, float* yr,
                        float* yi, const float2* tab, const float2* tw,
                        const AxisGeom& g, int tile, cudaStream_t s) {
  using namespace regs;
  constexpr int NT = mix_col_threads(MixGeo<N>::P);
  // the tile codes of fourstep.cu's Step1Tile: 0 narrow, 1 wide
  if (tile != (NT == kThreads ? 0 : 1)) return cudaErrorInvalidValue;
  using C = MixColGeo<N, NT>;
  auto kernel = cols_twiddle_mix<N, INV, NT>;
  cudaError_t err = allow_smem(kernel, C::SMEM);
  if (err != cudaSuccess) return err;
  const long long tiles = (g.ny * g.nz + C::L - 1) / C::L;
  kernel<<<(unsigned)(tiles * g.nb), NT, C::SMEM, s>>>(xr, xi, yr, yi, tab,
                                                       tw, g, tiles);
  return cudaGetLastError();
}

template <int N, bool INV>
cudaError_t step3_mix_n(const float* xr, const float* xi, float* yr,
                        float* yi, const float2* tab, long long rows,
                        long long n1, cudaStream_t s) {
  using namespace regs;
  constexpr int NT = mix_tr_threads(MixGeo<N>::P);
  using T = MixTrGeo<N, NT>;
  auto kernel = rows_transposed_mix<N, INV, NT>;
  cudaError_t err = allow_smem(kernel, T::SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + T::R - 1) / T::R;
  kernel<<<(unsigned)blocks, NT, T::SMEM, s>>>(xr, xi, yr, yi, tab, rows,
                                               n1);
  return cudaGetLastError();
}

template <typename F>
cudaError_t by_mixed_length(int n, F&& f) {
  return n % 3 == 0 ? regs::by_mixed<3>(n, f) : regs::by_mixed<5>(n, f);
}

}  // namespace

cudaError_t step1_mix(const float* xr, const float* xi, float* yr, float* yi,
                      const float2* tab, const float2* tw, const AxisGeom& g,
                      int n1, int inverse, int tile, cudaStream_t s) {
  return by_mixed_length(n1, [&](auto nc) {
    constexpr int N = decltype(nc)::value;
    return inverse ? step1_mix_n<N, true>(xr, xi, yr, yi, tab, tw, g, tile, s)
                   : step1_mix_n<N, false>(xr, xi, yr, yi, tab, tw, g, tile,
                                           s);
  });
}

cudaError_t step3_mix(const float* xr, const float* xi, float* yr, float* yi,
                      const float2* tab, long long rows, int n1, int n2,
                      int inverse, cudaStream_t s) {
  return by_mixed_length(n2, [&](auto nc) {
    constexpr int N = decltype(nc)::value;
    return inverse ? step3_mix_n<N, true>(xr, xi, yr, yi, tab, rows, n1, s)
                   : step3_mix_n<N, false>(xr, xi, yr, yi, tab, rows, n1, s);
  });
}

}  // namespace offt
