// fft_core.cuh: the length-N DFT that the kernels of this package run on
// a tile held in shared memory (all but the row kernels on power-of-two
// lengths, which run fft_regs.cuh), and the tile loads and stores.
//
// Replaces: offt_tpu/kernels/pallas_fft.py _core_apply (:428) with
// _sublane_core_loop (:503), _sublane_core_vpu (:711) and
// _sublane_core_merge (:757). The MXU+VPU split of the reference is the
// same arithmetic and has no second path here.
//
// What it computes: for each of T pencils stored column-wise in shared
// memory (element n of pencil t at [n * TP + t]), the DFT over n in 1-3
// dense radix stages with the (r, L/r) twiddle between them, f32 FMA
// throughout. The natural output index is kn = k1 + r1*k2 + r1*r2*k3, as
// in the reference. A stage's r-term sums run in blocks of kSumBlock
// inputs, each block summed from zero and then added to the output: in
// one chain of 2r FMAs each rounding scales with the partial sum so far,
// which grows with r, and a 64- or 128-term stage strayed two to three
// times further from the exact sum. Stages of r <= kSumBlock are one
// block, the single chain they always were.
//
// What bounds it on Hopper: each dense stage costs r complex MACs per
// element (4 FMAs each), so a (16, 16) core is 128 FMAs per element, plus
// the shared-memory reads that feed them. Design: every thread computes
// R outputs of one radix group from a single pass over the group's r
// inputs, so each input load from shared memory feeds R complex MACs;
// the stage roots sit in shared memory and every lane of a warp reads
// the same root (a broadcast). The stage is done in place: a round of
// whole groups is read into registers, the block synchronises, and the
// round is written back over its own inputs. One tile buffer therefore
// suffices, and a 16384-point pencil fits one block.
//
// Layout: in place, the positions end digit-reversed (stage s writes
// output k of a group into the slot of input k), so the natural index
// kn is found at core_pos(kn); the stores below apply that map on their
// way to device memory.

#pragma once

#include <cuda_runtime.h>

namespace offt {

constexpr int kThreads = 256;     // threads per block of every kernel
constexpr int kOutPerThread = 8;  // R: outputs a thread computes per pass
constexpr int kSumBlock = 16;     // inputs summed apart before each add

struct Core {
  int n;      // transform length
  int ns;     // stage count, 1-3
  int r[3];   // radices (unused entries 1)
  int nroot;  // sum of radices: stage-root rows after the n twiddle rows
};

static inline Core make_core(int n, int ns, int r0, int r1, int r2) {
  Core c;
  c.n = n;
  c.ns = ns;
  c.r[0] = r0;
  c.r[1] = ns > 1 ? r1 : 1;
  c.r[2] = ns > 2 ? r2 : 1;
  c.nroot = c.r[0] + (ns > 1 ? c.r[1] : 0) + (ns > 2 ? c.r[2] : 0);
  return c;
}

// Position, within the tile, of natural output index kn after the core.
static __device__ __forceinline__ int core_pos(const Core& c, int kn) {
  const int k1 = kn % c.r[0];
  const int rest = kn / c.r[0];
  const int k2 = rest % c.r[1];
  const int k3 = rest / c.r[1];
  return (k1 * c.r[1] + k2) * c.r[2] + k3;
}

// Copy the stage-root rows of a table (after its n twiddle rows) into
// shared memory. Call from every thread; core_run synchronises first.
static __device__ __forceinline__ void load_roots(const Core& c,
                                                  const float2* tab,
                                                  float2* sroot) {
  for (int i = threadIdx.x; i < c.nroot; i += blockDim.x)
    sroot[i] = __ldg(tab + c.n + i);
}

// The DFT of T pencils in place in (re, im); pencil stride TP >= T.
// tab: the table in device memory (twiddle rows read through the
// read-only cache); sroot: the stage roots in shared memory.
// Synchronises on entry and on exit, so the tile is consistent across
// the block on both sides.
static __device__ void core_run(float* re, float* im, int T, int TP,
                                const Core& c, const float2* tab,
                                const float2* sroot) {
  constexpr int R = kOutPerThread;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  __syncthreads();
  int roff = 0;
  int Ls = c.n;  // remaining length before this stage
  for (int s = 0; s < c.ns; ++s) {
    const int r = c.r[s];
    const int Ln = Ls / r;
    const int kb = (r + R - 1) / R;     // thread slots per group
    const int gpr = nt / kb;            // groups per round
    const int ngroups = (c.n / r) * T;  // (block, j, t) groups
    const bool last = (s == c.ns - 1);
    const int twstride = c.n / Ls;
    const float2* w = sroot + roff;
    const int gl = tid % gpr;
    const int kblk = tid / gpr;
    const int k0 = kblk * R;
    for (int g0 = 0; g0 < ngroups; g0 += gpr) {
      const int g = g0 + gl;
      const bool active = kblk < kb && g < ngroups;
      float ar[R], ai[R];
      float br[R], bi[R];  // the current block's sums
      int blk = 0, j = 0, t = 0;
      if (active) {
        t = g % T;
        const int q = g / T;
        j = q % Ln;
        blk = q / Ln;
        const int base = blk * Ls + j;
        int idx[R];
        int step[R];
#pragma unroll
        for (int u = 0; u < R; ++u) {
          ar[u] = 0.f;
          ai[u] = 0.f;
          br[u] = 0.f;
          bi[u] = 0.f;
          idx[u] = 0;
          step[u] = (k0 + u < r) ? k0 + u : 0;
        }
        for (int i0 = 0; i0 < r; i0 += kSumBlock) {
          const int i1 = min(i0 + kSumBlock, r);
          for (int i = i0; i < i1; ++i) {
            const int p = (base + i * Ln) * TP + t;
            const float xr = re[p];
            const float xi = im[p];
#pragma unroll
            for (int u = 0; u < R; ++u) {
              const float2 wv = w[idx[u]];
              br[u] = fmaf(wv.x, xr, fmaf(-wv.y, xi, br[u]));
              bi[u] = fmaf(wv.x, xi, fmaf(wv.y, xr, bi[u]));
              idx[u] += step[u];
              if (idx[u] >= r) idx[u] -= r;
            }
          }
#pragma unroll
          for (int u = 0; u < R; ++u) {
            ar[u] += br[u];
            ai[u] += bi[u];
            br[u] = 0.f;
            bi[u] = 0.f;
          }
        }
        if (!last) {
#pragma unroll
          for (int u = 0; u < R; ++u) {
            const int k = k0 + u;
            if (k < r) {
              const float2 tw = __ldg(tab + k * j * twstride);
              const float yr = ar[u] * tw.x - ai[u] * tw.y;
              const float yi = ar[u] * tw.y + ai[u] * tw.x;
              ar[u] = yr;
              ai[u] = yi;
            }
          }
        }
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int u = 0; u < R; ++u) {
          const int k = k0 + u;
          if (k < r) {
            const int p = (blk * Ls + k * Ln + j) * TP + t;
            re[p] = ar[u];
            im[p] = ai[u];
          }
        }
      }
      __syncthreads();
    }
    roff += r;
    Ls = Ln;
  }
}

// ---- row tiles: T pencils that are contiguous rows of device memory ----
// Row t (t < valid) starts at x + t * pitch. The loads walk each row in
// order, so a warp reads consecutive addresses; the tile's pencil stride
// TP is odd, so the transposing shared-memory store spreads over banks.

static __device__ __forceinline__ void load_rows(const float* xr,
                                                 const float* xi,
                                                 long long pitch, int n,
                                                 int T, int TP, int valid,
                                                 float* re, float* im) {
  const int tot = n * T;
  for (int e = threadIdx.x; e < tot; e += blockDim.x) {
    const int t = e / n;
    const int k = e - t * n;
    float a = 0.f, b = 0.f;
    if (t < valid) {
      a = xr[t * pitch + k];
      b = xi[t * pitch + k];
    }
    re[k * TP + t] = a;
    im[k * TP + t] = b;
  }
}

static __device__ __forceinline__ void store_rows(float* yr, float* yi,
                                                  long long pitch,
                                                  const Core& c, int T,
                                                  int TP, int valid,
                                                  const float* re,
                                                  const float* im) {
  const int n = c.n;
  const int tot = n * T;
  for (int e = threadIdx.x; e < tot; e += blockDim.x) {
    const int t = e / n;
    const int k = e - t * n;
    if (t < valid) {
      const int p = core_pos(c, k) * TP + t;
      yr[t * pitch + k] = re[p];
      yi[t * pitch + k] = im[p];
    }
  }
}

// ---- column tiles: T lanes of a strided transform axis ----
// T divides blockDim.x, so each thread serves one lane t = tid % T for
// the whole tile; the caller passes that lane's offset and whether it
// exists. Element k of the lane lies at loff + k * sn. Neighbouring
// threads hold neighbouring lanes, so a warp reads runs of consecutive
// addresses when the lanes are consecutive in memory.

static __device__ __forceinline__ void load_cols(const float* xr,
                                                 const float* xi,
                                                 long long sn, long long loff,
                                                 bool valid, int n, int T,
                                                 float* re, float* im) {
  const int t = threadIdx.x % T;
  const int step = blockDim.x / T;
  for (int k = threadIdx.x / T; k < n; k += step) {
    float a = 0.f, b = 0.f;
    if (valid) {
      a = xr[loff + k * sn];
      b = xi[loff + k * sn];
    }
    re[k * T + t] = a;
    im[k * T + t] = b;
  }
}

static __device__ __forceinline__ void store_cols(float* yr, float* yi,
                                                  long long sn,
                                                  long long loff, bool valid,
                                                  const Core& c, int T,
                                                  const float* re,
                                                  const float* im) {
  const int t = threadIdx.x % T;
  const int step = blockDim.x / T;
  for (int k = threadIdx.x / T; k < c.n; k += step) {
    if (valid) {
      const int p = core_pos(c, k) * T + t;
      yr[loff + k * sn] = re[p];
      yi[loff + k * sn] = im[p];
    }
  }
}

// The c2c along y of a slab row held at `pitch` in device memory, in
// place: T consecutive z lanes at a time, read back, transformed and
// written over themselves (the y pass of the slab kernels). The caller
// synchronises before, so the block's own writes to the row are visible.
static __device__ void slab_cols(float* yr_row, float* yi_row,
                                 long long pitch, int ny, int nz, int T,
                                 const Core& cy, const float2* taby,
                                 const float2* rooty, float* re, float* im) {
  for (int z0 = 0; z0 < nz; z0 += T) {
    const int z = z0 + (int)(threadIdx.x % T);
    const bool valid = z < nz;
    load_cols(yr_row, yi_row, pitch, z, valid, ny, T, re, im);
    core_run(re, im, T, T, cy, taby, rooty);
    store_cols(yr_row, yi_row, pitch, z, valid, cy, T, re, im);
    __syncthreads();
  }
}

// ---- real rows: 2n floats of device memory seen as n complex values ----
// v[j] = x[2j] + i x[2j+1], one float2 access per element, so a warp
// moves 256 consecutive bytes. `pitch` (floats) and the row base must be
// even, for 8-byte alignment.

static __device__ __forceinline__ void load_real_rows(const float* x,
                                                      long long pitch, int n,
                                                      int T, int TP,
                                                      int valid, float* re,
                                                      float* im) {
  const int tot = n * T;
  for (int e = threadIdx.x; e < tot; e += blockDim.x) {
    const int t = e / n;
    const int k = e - t * n;
    float2 v = make_float2(0.f, 0.f);
    if (t < valid) v = *reinterpret_cast<const float2*>(x + t * pitch + 2 * k);
    re[k * TP + t] = v.x;
    im[k * TP + t] = v.y;
  }
}

// Store the core's output interleaved: x[2k] = Re, x[2k+1] = Im of the
// natural index k.
static __device__ __forceinline__ void store_real_rows(float* x,
                                                       long long pitch,
                                                       const Core& c, int T,
                                                       int TP, int valid,
                                                       const float* re,
                                                       const float* im) {
  const int n = c.n;
  const int tot = n * T;
  for (int e = threadIdx.x; e < tot; e += blockDim.x) {
    const int t = e / n;
    const int k = e - t * n;
    if (t < valid) {
      const int p = core_pos(c, k) * TP + t;
      *reinterpret_cast<float2*>(x + t * pitch + 2 * k) =
          make_float2(re[p], im[p]);
    }
  }
}

// ---- the r2c untangle and the c2r re-tangle, in place on a tile ----
// Both pair index k with (M - k) mod M. One thread owns a pair and writes
// both of its members, so the update in place has no race; k = 0 (and
// k = M/2 for even M) pair with themselves and are written twice with the
// same value by the same thread.

// After core_run of v[j] = x[2j] + i x[2j+1] (the tile digit-reversed):
// X[k] = E - i W^k O with E, O = (V[k] +- conj V[M-k]) / 2, W^k = w[k]
// (tables.rfft_table); row 0 becomes the packed
// X[0] + i X[M] = (Re V0 + Im V0) + i (Re V0 - Im V0).
static __device__ void r2c_untangle(float* re, float* im, int T, int TP,
                                    const Core& c, const float2* w) {
  const int m = c.n;
  const int tot = (m / 2 + 1) * T;
  __syncthreads();
  for (int e = threadIdx.x; e < tot; e += blockDim.x) {
    const int k = e / T;
    const int t = e - k * T;
    const int pa = core_pos(c, k) * TP + t;
    if (k == 0) {
      const float a = re[pa], b = im[pa];
      re[pa] = a + b;
      im[pa] = a - b;
      continue;
    }
    const int pb = core_pos(c, m - k) * TP + t;
    const float ar = re[pa], ai = im[pa];  // V[k]
    const float br = re[pb], bi = im[pb];  // V[M-k]
    // X[k] from A = V[k], B = conj V[M-k]; X[M-k] from A' = V[M-k],
    // B' = conj V[k]: E' = conj E, O' = -conj O
    const float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
    const float orr = 0.5f * (ar - br), oi = 0.5f * (ai + bi);
    const float2 wk = __ldg(w + k);
    const float2 wm = __ldg(w + (m - k));
    re[pa] = er + wk.x * oi + wk.y * orr;
    im[pa] = ei - wk.x * orr + wk.y * oi;
    re[pb] = er + wm.x * oi - wm.y * orr;
    im[pb] = -ei + wm.x * orr + wm.y * oi;
  }
  __syncthreads();
}

// Before the inverse core, on a tile in natural order:
// V[k] = a[k] X[k] + b[k] conj X[(M-k) mod M], ab[2k] = a[k],
// ab[2k+1] = b[k] (tables.crfft_table, the scale folded in).
static __device__ void c2r_retangle(float* re, float* im, int T, int TP,
                                    int m, const float2* ab) {
  const int tot = (m / 2 + 1) * T;
  __syncthreads();
  for (int e = threadIdx.x; e < tot; e += blockDim.x) {
    const int k = e / T;
    const int t = e - k * T;
    const int kb = k ? m - k : 0;
    const int pa = k * TP + t;
    const int pb = kb * TP + t;
    const float xr = re[pa], xi = im[pa];  // X[k]
    const float yr = re[pb], yi = im[pb];  // X[(M-k) mod M]
    const float2 a = __ldg(ab + 2 * k), b = __ldg(ab + 2 * k + 1);
    const float2 a2 = __ldg(ab + 2 * kb), b2 = __ldg(ab + 2 * kb + 1);
    const float vr = a.x * xr - a.y * xi + b.x * yr + b.y * yi;
    const float vi = a.x * xi + a.y * xr + b.y * yr - b.x * yi;
    const float ur = a2.x * yr - a2.y * yi + b2.x * xr + b2.y * xi;
    const float ui = a2.x * yi + a2.y * yr + b2.y * xr - b2.x * xi;
    re[pb] = ur;
    im[pb] = ui;
    re[pa] = vr;
    im[pa] = vi;
  }
  __syncthreads();
}

// A strided-axis transform's geometry: the array seen as (B, N, Y, Z),
// element (b, n, y, z) at b*sb + n*sn + y*sy + z, input and output strides
// apart (fft_axis.cu; the register core's column variant, cols_c2c).
struct AxisGeom {
  long long nb;         // batch count
  long long ny, nz;     // lanes = ny * nz
  long long isb, isn, isy;
  long long osb, osn, osy;
};

// Dynamic shared memory of a kernel: the tile plus `nroot_total` roots.
static inline size_t core_smem(size_t tile_elems, int nroot_total) {
  return tile_elems * 2 * sizeof(float) + nroot_total * sizeof(float2);
}

// Raise the kernel's dynamic shared-memory ceiling when above 48 KB.
template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace offt
