// fft_cube_regs.cu: the register cube, c2c along all three axes of batched
// planar f32 cubes (B, X, Y, Z), X*Y*Z <= 2^21, in one cooperative launch
// (fused_fft._reg_cube: X and Y powers of two in [16, 4096] or shorter
// than 16, Z a power of two in [128, 32768]; every other cube runs the
// dense kernel of fft_cube.cu).
//
// Replaces: offt_tpu/kernels/pallas_fft.py fft3d_cube (:1156,
// _cube_kernel :1117), as fft_cube.cu does, on the register core.
//
// What bounds it on Hopper: one read of the input and one write of the
// output, 16 bytes a complex element. A cube of up to 16 MiB of planar
// pairs does not fit an SM, but it fits the 50 MB L2. Design (fft_cube.cu
// gave it; this kernel keeps its skeleton and replaces what runs in it):
// one cooperative launch of as many 256-thread blocks as are co-resident
// (the occupancy API at this call's shared memory) walks the batch G cubes
// at a time (fused_fft._cube_group: as many as a 16 MiB share of the L2
// holds, 8 bytes an element), in phases parted by grid-wide barriers; each
// phase covers all G cubes, so a small cube pays its barriers once a group
// and not once a cube. The phases are the register core's bodies
// (regs_kernels.cuh, each block walking many of their blocks), z first:
//   z: the rows (rows_block), read from the input (contiguous rows, the
//      one phase that reads device memory cold), written to the output;
//   y: the column variant (cols_block) along Y at stride Z, in place;
//   x: the column variant along X at stride Y Z, in place, the scale at
//      the store.
// y and x read back from L2 what the phase before wrote. A z past 4096
// (8192-32768) runs the four-step pair's bodies on fourstep.pick_split(Z)
// = (n1, n2) instead of the rows:
//   z1: step 1 (cols_twiddle_block) along n1 at stride n2, times the
//       four-step twiddle, from the input into a scratch pair of G cubes;
//   z2: step 3 (rows_transposed_block) on the rows of n2, written
//       transposed into the output's natural order.
// Each group writes only its own cubes of the output, and the scratch pair
// is not read after z2, behind two barriers, so no barrier parts two
// groups. An x or y shorter than 16 (the 8s of 8 x 8 x 32768, or X = 3)
// runs one thread a line: its values in registers, the radix-2 network of
// the register core at 2, 4 and 8, else the DFT's sums on the table's
// roots. Each phase picks its body by a device-side switch over the
// lengths (one kernel a direction, not one a shape): 6 row bodies (Z
// 128-4096), step 1 at n1 = 64, 128 and step 3 at n2 = 128, 256 (the
// splits of 8192-32768), 9 column bodies and 15 short ones for each of y
// and x. Every block reaches every barrier; a block with no tile in a
// phase goes straight to it. A tile's block synchronises before the next
// tile reuses the exchange planes. The radices are not read. Measured
// against this form on an H100 (PERF.md): x first ran 8 x 128^3 3%
// slower, z and y as one phase in the clusters of fft_slab.cu 5% slower,
// streaming cache hints 1.5% slower, an L2 prefetch of the next group's
// input during y and x 7% slower.

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "fft_core.cuh"
#include "regs_kernels.cuh"

namespace offt {
namespace {

namespace cg = cooperative_groups;

// the lengths the phases' bodies are built for (log2)
constexpr int kColLo = 4, kColHi = 12;  // x, y: 16 - 4096
constexpr int kRowLo = 7, kRowHi = 12;  // z as rows: 128 - 4096
constexpr int kN1Lo = 6, kN1Hi = 7;     // step 1: n1 = 64, 128
constexpr int kN2Lo = 7, kN2Hi = 8;     // step 3: n2 = 128, 256
constexpr int kShortMax = 15;           // x, y: 1 - 15, a thread a line
constexpr int kStep3Threads = kThreads;
static_assert(regs::tr_threads<kN2Lo>() == kStep3Threads &&
                  regs::tr_threads<kN2Hi>() == kStep3Threads,
              "step 3's blocks at n2 = 128, 256 are 256 threads");

struct CubeArgs {
  const float* xr;
  const float* xi;
  float* yr;
  float* yi;
  float* sr;  // the split z's scratch pair, G cubes
  float* si;
  const float2* tabx;  // core tables (the first N rows, W_N^k): x, y
  const float2* taby;
  const float2* tabz;  // z's, or step 1's (n1) with the split
  const float2* tab2;  // step 3's (n2)
  const float2* tw;    // the four-step twiddle (n1, n2)
  long long nb;        // cubes
  long long group;     // G
  int nx, ny, nz, n1, n2;
  int lx, ly, lz, l1, l2;  // log2 of the register lengths; 0: short / none
  float scale;
  // the phases' (B, N, Y, Z) geometries over a group (B is not read): x
  // (lanes Y Z, stride Y Z), y (lanes Z, stride Z, a B per x-plane), z1
  // (lanes n2, stride n2, a B per z line)
  AxisGeom gx, gy, g1;
  int phases;  // a cost probe: each group stops after step 1 (1), z (2)
               // or z and y (3); 0 runs every phase
};

// f(std::integral_constant<int, K>) for the k in [LO, HI] that matches:
// the phases' switches on the card, their needs on the host
#pragma nv_exec_check_disable
template <int LO, int HI, typename F>
static __host__ __device__ __forceinline__ void on_int(int k, F&& f) {
  if constexpr (LO <= HI) {
    if (k == LO)
      f(std::integral_constant<int, LO>());
    else
      on_int<LO + 1, HI>(k, f);
  }
}

// Each tile's thread index is opaque to the compiler: with threadIdx.x the
// compiler hoisted every body's thread-invariant values (exchange-plane
// bases, lanes) out of the group loop, so that all of them stayed live
// across all the bodies, and the kernel spilled at 80 registers and at
// 128. (Phase functions of their own, __noinline__, spilled nothing at
// 128 but read their arguments through a generic pointer and ran 8 x 128^3
// in 0.343 ms, against this form's 0.256; PERF.md.)
static __device__ __forceinline__ unsigned opaque(unsigned v) {
  asm volatile("" : "+r"(v));
  return v;
}

// The N-point DFT (N <= 15) of one line held by one thread, each output
// k handed to put(k, value): the register core's radix-2 network at 2, 4
// and 8, else the sums on the N roots W_N^k (tab, the first N rows of the
// core table of N), loaded once, an output put as soon as it is summed.
template <int N, bool INV, typename Put>
static __device__ __forceinline__ void dft_short(float2* v,
                                                 const float2* tab, Put put) {
  if constexpr (N == 2 || N == 4 || N == 8) {
    regs::dft<N, INV>(v);
    regs::unroll<0, N>([&](auto k) { put(k, v[decltype(k)::value]); });
  } else {
    float2 w[N];
    regs::unroll<1, N>([&](auto j) {
      w[decltype(j)::value] = __ldg(tab + decltype(j)::value);
    });
    regs::unroll<0, N>([&](auto kc) {
      constexpr int K = decltype(kc)::value;
      float2 s = v[0];
      regs::unroll<1, N>([&](auto jc) {
        constexpr int J = decltype(jc)::value;
        if constexpr (J * K % N == 0) {
          s = regs::cadd(s, v[J]);
        } else {
          const float2 r = w[J * K % N];
          s.x = fmaf(v[J].x, r.x, fmaf(-v[J].y, r.y, s.x));
          s.y = fmaf(v[J].x, r.y, fmaf(v[J].y, r.x, s.y));
        }
      });
      put(kc, s);
    });
  }
}

// One column phase over nb x-planes or cubes (g.nb is not read): c2c
// along n of g from (xr, xi) into (yr, yi), which may be the same, the
// scale at the store, on the column variant (lg = log2 n) or, lg = 0, a
// thread a line (n < 16), which reads its line whole before it writes.
template <bool INV>
static __device__ __forceinline__ void col_phase(
    int n, int lg, const float* xr, const float* xi, float* yr, float* yi,
    const float2* tab, const AxisGeom& g, long long nb, float scale) {
  const long long lanes = g.nz;
  if (lg == 0) {
    const long long per = (lanes + kThreads - 1) / kThreads;
    on_int<1, kShortMax>(n, [&](auto nc) {
      constexpr int N = decltype(nc)::value;
      for (long long i = blockIdx.x; i < per * nb; i += gridDim.x) {
        const long long b = i / per;
        const long long l = (i - b * per) * kThreads + opaque(threadIdx.x);
        if (l >= lanes) continue;
        const long long o = b * g.isb + l;
        float2 v[N];
        regs::unroll<0, N>([&](auto j) {
          const long long e = o + decltype(j)::value * g.isn;
          v[decltype(j)::value] = make_float2(xr[e], xi[e]);
        });
        dft_short<N, INV>(v, tab, [&](auto k, float2 y) {
          const long long e = o + decltype(k)::value * g.osn;
          yr[e] = y.x * scale;
          yi[e] = y.y * scale;
        });
      }
    });
    return;
  }
  on_int<kColLo, kColHi>(lg, [&](auto lc) {
    constexpr int LOG = decltype(lc)::value;
    using C = regs::ColGeo<LOG>;
    const long long tiles = (lanes + C::L - 1) / C::L;
    for (long long i = blockIdx.x; i < tiles * nb; i += gridDim.x) {
      regs::cols_block<LOG, INV>(xr, xi, yr, yi, tab, g, tiles, scale,
                                 nullptr, nullptr, (unsigned)i,
                                 opaque(threadIdx.x));
      __syncthreads();
    }
  });
}

// blocks an SM the kernel's register budget allows: at three (80
// registers, the bodies' budget in their own kernels) it spilled 1068
// bytes and ran 8 x 128^3 1.25x slower (PERF.md)
constexpr int kCubeMinBlocks = 2;

template <bool INV>
__global__ void __launch_bounds__(kThreads, kCubeMinBlocks)
cube_regs(const __grid_constant__ CubeArgs a) {
  cg::grid_group grid = cg::this_grid();
  const long long vol = (long long)a.nx * a.ny * a.nz;
  for (long long c0 = 0; c0 < a.nb; c0 += a.group) {
    const long long gc = a.nb - c0 < a.group ? a.nb - c0 : a.group;
    const long long lines = gc * a.nx * a.ny;
    const float* xr = a.xr + c0 * vol;
    const float* xi = a.xi + c0 * vol;
    float* yr = a.yr + c0 * vol;
    float* yi = a.yi + c0 * vol;
    if (!a.l1) {
      // z: the input's rows into the output
      on_int<kRowLo, kRowHi>(a.lz, [&](auto lc) {
        constexpr int LOG = decltype(lc)::value;
        using G = regs::Geo<LOG>;
        const long long blocks = (lines + G::ROWS - 1) / G::ROWS;
        for (long long i = blockIdx.x; i < blocks; i += gridDim.x) {
          regs::rows_block<LOG, INV>(xr, xi, yr, yi, a.tabz, lines, a.nz,
                                     a.nz, 1.f, (unsigned)i,
                                     opaque(threadIdx.x));
          __syncthreads();
        }
      });
    } else {
      // z1: step 1 along n1 (stride n2) from the input, times the
      // twiddle, into the scratch pair
      on_int<kN1Lo, kN1Hi>(a.l1, [&](auto lc) {
        constexpr int LOG = decltype(lc)::value;
        using C = regs::ColGeo<LOG>;
        const long long tiles = (a.n2 + C::L - 1) / C::L;
        for (long long i = blockIdx.x; i < tiles * lines; i += gridDim.x) {
          regs::cols_twiddle_block<LOG, INV, kThreads>(
              xr, xi, a.sr, a.si, a.tabz, a.tw, a.g1, tiles, (unsigned)i,
              opaque(threadIdx.x));
          __syncthreads();
        }
      });
      grid.sync();
      if (a.phases == 1) continue;
      // z2: step 3 on the scratch pair's rows of n2, transposed into the
      // output
      on_int<kN2Lo, kN2Hi>(a.l2, [&](auto lc) {
        constexpr int LOG = decltype(lc)::value;
        using T = regs::TrGeo<LOG, kStep3Threads>;
        const long long rows = lines * a.n1;
        const long long blocks = (rows + T::R - 1) / T::R;
        for (long long i = blockIdx.x; i < blocks; i += gridDim.x) {
          regs::rows_transposed_block<LOG, INV, kStep3Threads, 1>(
              a.sr, a.si, yr, yi, a.tab2, rows, a.n1, (unsigned)i,
              opaque(threadIdx.x));
          __syncthreads();
        }
      });
    }
    grid.sync();
    if (a.phases == 2) continue;
    // y, in place
    col_phase<INV>(a.ny, a.ly, yr, yi, yr, yi, a.taby, a.gy, gc * a.nx, 1.f);
    grid.sync();
    if (a.phases == 3) continue;
    // x, in place, the scale at the store; the next group's z writes
    // other cubes, so no barrier follows
    col_phase<INV>(a.nx, a.lx, yr, yi, yr, yi, a.tabx, a.gx, gc, a.scale);
  }
}

// log2 n for a power of two in [lo, hi]; -1 for any other n
int log_in(int n, int lo, int hi) {
  const int l = regs::ilog2(n);
  return (n == 1 << l && l >= lo && l <= hi) ? l : -1;
}

// a column phase over nb families of `lanes` lanes at length 2^lg (0:
// short): its shared memory into smem, its tiles into tiles
void col_needs(int lg, long long lanes, long long nb, size_t& smem,
               long long& tiles) {
  long long t = nb * ((lanes + kThreads - 1) / kThreads);
  on_int<kColLo, kColHi>(lg, [&](auto lc) {
    using C = regs::ColGeo<decltype(lc)::value>;
    smem = std::max<size_t>(smem, C::SMEM);  // 0 at 16: no exchange
    t = nb * ((lanes + C::L - 1) / C::L);
  });
  if (t > tiles) tiles = t;
}

}  // namespace
}  // namespace offt

// The register cube on nb cubes (nx, ny, nz), G = group a phase. x and y:
// a power of two in [16, 4096] or a length in [1, 15], tabx and taby their
// core tables. No split (n1 = 0): nz a power of two in [128, 4096], tabz
// its core table. Split: nz = n1 n2, n1 in {64, 128}, n2 in {128, 256},
// tabz and tab2 their core tables, tw the four-step twiddle, (sr, si) a
// scratch pair of G cubes. `scale` rides x's store. `phases` (a cost
// probe) stops each group after step 1 of the split z (1), after z (2) or
// after z and y (3); 0 runs all. `info` (host memory, 3 ints)
// receives the cooperative grid, the blocks an SM and the shared memory
// of a block.
extern "C" int offt_fft_cube_regs(
    const void* xr, const void* xi, void* yr, void* yi, void* sr, void* si,
    const void* tabx, const void* taby, const void* tabz, const void* tab2,
    const void* tw, long long nb, int nx, int ny, int nz, int n1, int n2,
    long long group, int inverse, float scale, int phases, void* info,
    void* stream) {
  using namespace offt;
  CubeArgs a{};
  a.xr = (const float*)xr;
  a.xi = (const float*)xi;
  a.yr = (float*)yr;
  a.yi = (float*)yi;
  a.sr = (float*)sr;
  a.si = (float*)si;
  a.tabx = (const float2*)tabx;
  a.taby = (const float2*)taby;
  a.tabz = (const float2*)tabz;
  a.tab2 = (const float2*)tab2;
  a.tw = (const float2*)tw;
  a.nb = nb;
  a.group = group;
  a.nx = nx;
  a.ny = ny;
  a.nz = nz;
  a.n1 = n1;
  a.n2 = n2;
  a.scale = scale;
  a.phases = phases;
  a.lx = nx <= kShortMax ? 0 : log_in(nx, kColLo, kColHi);
  a.ly = ny <= kShortMax ? 0 : log_in(ny, kColLo, kColHi);
  const bool split = n1 != 0;
  if (nb < 1 || group < 1 || nx < 1 || ny < 1 || a.lx < 0 || a.ly < 0)
    return (int)cudaErrorInvalidValue;
  if (split) {
    a.l1 = log_in(n1, kN1Lo, kN1Hi);
    a.l2 = log_in(n2, kN2Lo, kN2Hi);
    if (a.l1 < 0 || a.l2 < 0 || (long long)n1 * n2 != nz || !sr || !si ||
        !tab2 || !tw)
      return (int)cudaErrorInvalidValue;
  } else {
    a.lz = log_in(nz, kRowLo, kRowHi);
    if (a.lz < 0) return (int)cudaErrorInvalidValue;
  }
  const long long plane = (long long)ny * nz;
  const long long vol = nx * plane;
  a.gx = AxisGeom{0, 1, plane, vol, plane, 0, vol, plane, 0};
  a.gy = AxisGeom{0, 1, nz, plane, nz, 0, plane, nz, 0};
  a.g1 = AxisGeom{0, 1, n2, nz, n2, 0, nz, n2, 0};
  // each phase's shared memory and blocks of work over one group
  const long long g = group < nb ? group : nb;
  const long long lines = g * nx * ny;
  size_t smem = 0;
  long long tiles = 0;
  col_needs(a.lx, plane, g, smem, tiles);
  col_needs(a.ly, nz, g * nx, smem, tiles);
  if (!split) {
    on_int<kRowLo, kRowHi>(a.lz, [&](auto lc) {
      using G = regs::Geo<decltype(lc)::value>;
      if (G::SMEM > smem) smem = G::SMEM;
      const long long t = (lines + G::ROWS - 1) / G::ROWS;
      if (t > tiles) tiles = t;
    });
  } else {
    on_int<kN1Lo, kN1Hi>(a.l1, [&](auto lc) {
      using C = regs::ColGeo<decltype(lc)::value>;
      if (C::SMEM > smem) smem = C::SMEM;
      const long long t = lines * ((n2 + C::L - 1) / C::L);
      if (t > tiles) tiles = t;
    });
    on_int<kN2Lo, kN2Hi>(a.l2, [&](auto lc) {
      using T = regs::TrGeo<decltype(lc)::value, kStep3Threads>;
      if (T::SMEM > smem) smem = T::SMEM;
      const long long t = (lines * n1 + T::R - 1) / T::R;
      if (t > tiles) tiles = t;
    });
  }
  const void* kernel = inverse ? (const void*)cube_regs<true>
                               : (const void*)cube_regs<false>;
  cudaError_t err = inverse ? allow_smem(cube_regs<true>, smem)
                            : allow_smem(cube_regs<false>, smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  long long grid = (long long)per_sm * sms;
  if (tiles < grid) grid = tiles;
  if (grid < 1) grid = 1;
  if (info) {
    int* out = (int*)info;
    out[0] = (int)grid;
    out[1] = per_sm;
    out[2] = (int)smem;
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kernel, dim3((unsigned)grid),
                                    dim3(kThreads), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
