// probe_mma.cu: the stage product's throughput and error on Hopper, by
// precision tier: R dependent iterations of
//     acc <- sum_k G_k w_k(acc) + c acc
// on B independent (128, L) f32 operands, one a block.
//
// Replaces: docs/receipts/probe_mxuwidth.py mk(mode, R).kern (:50,
// pallas_call :81), the v5e probe of the stack6 stacked-dot construct
// (the inner loop of every reference kernel, pallas_fft.py:134-215). No
// path of the port runs it: bench/probe_mxuwidth.py times it.
//
// Tiers (`tier`):
// - 0 stack6, one accumulator chained over K = 768 (the reference's
//   `concat`; the k-steps of the six blocks on one row group of acc side
//   by side): G is (128, 768) bf16, w = (x0, x1, x2, x0, x1, x0), the
//   3-word bf16 split of acc (x0 = bf16(acc), x1 = bf16(acc - x0), x2 =
//   bf16(acc - x0 - x1)), so that a table stacked (g0, g0, g0, g1, g1, g2)
//   gives the six significant terms of an f32 product;
// - 1 stack6 as six K = 128 products in six accumulators, summed
//   ((((p0 + p1) + p2) + p3) + p4) + p5 (the reference's `six`);
// - 2 3xtf32: G (128, 128) f32, hi = tf32(G), lo = tf32(G - hi), the same
//   split of acc, gl ah + gh al + gh ah;
// - 3 tf32: one product of tf32(G) and tf32(acc);
// - 4 fma: the f32 product on the CUDA cores, in the form of
//   fft_core.cuh's MAC loop: a thread computes 8 outputs of one lane from
//   one pass over its 128 inputs in shared memory, the table rows read
//   as broadcasts.
// tf32(x) keeps the top 10 bits of the mantissa (x & 0xffffe000): a
// value the tensor cores take exactly, and what the plain version masks.
//
// What bounds it: operations, at the tier's peak (989 TFLOP/s bf16, 495
// TF32, 67 f32); the operands stay on chip for all R iterations. Design
// (tiers 0-3): mma.sync (m16n8k16 bf16, m16n8k8 tf32, f32 sums) on the
// transposed product acc^T G^T: a warp holds 16 lanes of acc as the
// accumulator fragments of its (16 x 128) tile, 64 registers a thread,
// and those fragments are already the A operand of the next product (the
// k index permuted within each 8 to match, G's B fragments read in that
// order), so acc never leaves the registers; G lives in shared memory,
// its rows padded 8 words so that a warp's 64-bit fragment loads take
// one wavefront a half-warp. A block of 8 warps holds 128 lanes; a wider
// operand runs in chunks of 128 lanes in turn (the lanes are independent,
// so this is the same function). Tier 4 keeps a chunk of 128 lanes in two
// shared-memory planes (the iteration reads one and writes the other).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace offt {
namespace probe {

constexpr int kWarps = 8;
constexpr int kBlock = 32 * kWarps;
constexpr int kRows = 128;          // rows of acc: the products' K
constexpr int kLanes = 16 * kWarps;  // lanes a block holds at once
constexpr int kTiles = kRows / 8;   // n8 tiles of a warp's 128 outputs
// G's row pitch in shared memory, 32-bit words: the row plus 8 words,
// so that rows g and g + 1 of a fragment load start 8 banks apart
constexpr int kPitch6 = 768 / 2 + 8;
constexpr int kPitch = kRows + 8;
constexpr int kFmaPitch = kLanes + 4;   // tier 4's planes

enum Tier { kStack6 = 0, kSix = 1, k3xTF32 = 2, kTF32 = 3, kFMA = 4 };

static __device__ __forceinline__ uint32_t tf32_bits(float x) {
  return __float_as_uint(x) & 0xffffe000u;
}

static __device__ __forceinline__ float tf32(float x) {
  return __uint_as_float(tf32_bits(x));
}

// word w of the 3-word bf16 split of x
static __device__ __forceinline__ float word(float x, int w) {
  const float x0 = __bfloat162float(__float2bfloat16_rn(x));
  if (w == 0) return x0;
  const float r = x - x0;
  const float x1 = __bfloat162float(__float2bfloat16_rn(r));
  if (w == 1) return x1;
  return __bfloat162float(__float2bfloat16_rn(r - x1));
}

// two bf16 values in one register, lo in the low half (exact: a and b are
// bf16 values already)
static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

static __device__ __forceinline__ void mma_bf16(float (&d)[4],
                                                const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

static __device__ __forceinline__ void mma_tf32(float (&d)[4],
                                                const uint32_t (&a)[4],
                                                uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The warp's state: st[j][0..3] = acc at (row 8j + 2q, lane g), (8j + 2q
// + 1, g), (8j + 2q, g + 8), (8j + 2q + 1, g + 8), g = lane / 4, q = lane
// % 4: the accumulator fragment of n8 tile j of acc^T G^T.

// stack6: k-step s (16 rows of the stacked K = 768) of the product into
// acc (16 tiles): word (0, 1, 2, 0, 1, 0)[s / 8] of rows 16 (s % 8) .. + 15 of acc, the
// fragments of tiles 2 (s % 8) and 2 (s % 8) + 1.
template <int S>
static __device__ __forceinline__ void stack6_step(
    float (&acc)[kTiles][4], const float (&st)[kTiles][4],
    const uint32_t* gs, int g, int q) {
  constexpr int W = (S / 8) == 0 || (S / 8) == 3 || (S / 8) == 5 ? 0
                    : (S / 8) == 1 || (S / 8) == 4               ? 1
                                                                 : 2;
  constexpr int T = 2 * (S % 8);
  const uint32_t a[4] = {pack(word(st[T][0], W), word(st[T][1], W)),
                         pack(word(st[T][2], W), word(st[T][3], W)),
                         pack(word(st[T + 1][0], W), word(st[T + 1][1], W)),
                         pack(word(st[T + 1][2], W), word(st[T + 1][3], W))};
#pragma unroll
  for (int j = 0; j < kTiles; ++j) {
    const uint2 b = *reinterpret_cast<const uint2*>(
        gs + (8 * j + g) * kPitch6 + 8 * S + 2 * q);
    mma_bf16(acc[j], a, b.x, b.y);
  }
}

template <int S, int END>
static __device__ __forceinline__ void stack6_steps(
    float (&acc)[kTiles][4], const float (&st)[kTiles][4],
    const uint32_t* gs, int g, int q) {
  if constexpr (S < END) {
    stack6_step<S>(acc, st, gs, g, q);
    stack6_steps<S + 1, END>(acc, st, gs, g, q);
  }
}

// the chained stack6 (tier 0): the 48 k-steps of the stacked K with the
// six blocks' steps on the same 16 rows of acc side by side (step 8 b + r
// for r = 0 .. 7, b = 0 .. 5), so that a row group's three words are
// live for six steps only (block by block they stay live across the
// blocks and spill)
template <int R>
static __device__ __forceinline__ void stack6_rows(
    float (&acc)[kTiles][4], const float (&st)[kTiles][4],
    const uint32_t* gs, int g, int q) {
  if constexpr (R < 8) {
    stack6_step<R>(acc, st, gs, g, q);
    stack6_step<8 + R>(acc, st, gs, g, q);
    stack6_step<16 + R>(acc, st, gs, g, q);
    stack6_step<24 + R>(acc, st, gs, g, q);
    stack6_step<32 + R>(acc, st, gs, g, q);
    stack6_step<40 + R>(acc, st, gs, g, q);
    stack6_rows<R + 1>(acc, st, gs, g, q);
  }
}

// the stack6 block of rows [128 B, 128 B + 128) of the stacked K
template <int B>
static __device__ __forceinline__ void stack6_block(
    float (&acc)[kTiles][4], const float (&st)[kTiles][4],
    const uint32_t* gs, int g, int q) {
  stack6_steps<8 * B, 8 * B + 8>(acc, st, gs, g, q);
}

template <int B>
static __device__ __forceinline__ void six_blocks(
    float (&sum)[kTiles][4], const float (&st)[kTiles][4],
    const uint32_t* gs, int g, int q) {
  if constexpr (B < 6) {
    float p[kTiles][4];
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
    stack6_block<B>(p, st, gs, g, q);
#pragma unroll
    for (int j = 0; j < kTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sum[j][e] = B == 0 ? p[j][e] : sum[j][e] + p[j][e];
    six_blocks<B + 1>(sum, st, gs, g, q);
  }
}

// tf32 tiers: k-step s (rows 8s .. 8s + 7 of acc, tile s's fragment; the
// hardware's k slot q holds row 8s + 2q, slot q + 4 row 8s + 2q + 1)
template <int TIER>
static __device__ __forceinline__ void tf32_steps(
    float (&acc)[kTiles][4], const float (&st)[kTiles][4],
    const uint32_t* gh, const uint32_t* gl, int g, int q) {
#pragma unroll
  for (int s = 0; s < kTiles; ++s) {
    const uint32_t ah[4] = {tf32_bits(st[s][0]), tf32_bits(st[s][2]),
                            tf32_bits(st[s][1]), tf32_bits(st[s][3])};
    uint32_t al[4];
    if constexpr (TIER == k3xTF32) {
      al[0] = tf32_bits(st[s][0] - __uint_as_float(ah[0]));
      al[1] = tf32_bits(st[s][2] - __uint_as_float(ah[1]));
      al[2] = tf32_bits(st[s][1] - __uint_as_float(ah[2]));
      al[3] = tf32_bits(st[s][3] - __uint_as_float(ah[3]));
    }
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int at = (8 * j + g) * kPitch + 8 * s + 2 * q;
      const uint2 bh = *reinterpret_cast<const uint2*>(gh + at);
      if constexpr (TIER == k3xTF32) {
        const uint2 bl = *reinterpret_cast<const uint2*>(gl + at);
        mma_tf32(acc[j], ah, bl.x, bl.y);
        mma_tf32(acc[j], al, bh.x, bh.y);
      }
      mma_tf32(acc[j], ah, bh.x, bh.y);
    }
  }
}

template <int TIER>
__global__ void __launch_bounds__(kBlock, 1)
probe_mma_tc(const float* __restrict__ x, float* __restrict__ y,
             const uint32_t* __restrict__ gtab, int L, int R, float c) {
  extern __shared__ __align__(16) uint32_t gs[];
  // G into shared memory: stack6 the bf16 words of each k-step in
  // fragment order (word q and q + 4 of the step side by side); the tf32
  // tiers hi (and lo) planes
  if constexpr (TIER == kStack6 || TIER == kSix) {
    for (int i = threadIdx.x; i < kRows * 384; i += kBlock) {
      const int m = i / 384, w = i % 384, s = w / 8, k = w % 8;
      gs[m * kPitch6 + 8 * s + 2 * (k % 4) + k / 4] = gtab[i];
    }
  } else {
    for (int i = threadIdx.x; i < kRows * kRows; i += kBlock) {
      const int m = i / kRows, k = i % kRows;
      const float v = __uint_as_float(gtab[i]);
      gs[m * kPitch + k] = tf32_bits(v);
      if constexpr (TIER == k3xTF32)
        gs[kRows * kPitch + m * kPitch + k] = tf32_bits(v - tf32(v));
    }
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;
  const float* xb = x + (long long)blockIdx.x * kRows * L;
  float* yb = y + (long long)blockIdx.x * kRows * L;
  for (int c0 = 0; c0 < L; c0 += kLanes) {
    const int l0 = c0 + 16 * warp + g;
    float st[kTiles][4];
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int r = 8 * j + 2 * q;
      st[j][0] = xb[r * L + l0];
      st[j][1] = xb[(r + 1) * L + l0];
      st[j][2] = xb[r * L + l0 + 8];
      st[j][3] = xb[(r + 1) * L + l0 + 8];
    }
    for (int it = 0; it < R; ++it) {
      float acc[kTiles][4];
      if constexpr (TIER == kSix) {
        six_blocks<0>(acc, st, gs, g, q);
      } else {
#pragma unroll
        for (int j = 0; j < kTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
        if constexpr (TIER == kStack6) {
          stack6_rows<0>(acc, st, gs, g, q);
        } else {
          tf32_steps<TIER>(acc, st, gs, gs + kRows * kPitch, g, q);
        }
      }
#pragma unroll
      for (int j = 0; j < kTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = acc[j][e] + c * st[j][e];
    }
#pragma unroll
    for (int j = 0; j < kTiles; ++j) {
      const int r = 8 * j + 2 * q;
      yb[r * L + l0] = st[j][0];
      yb[(r + 1) * L + l0] = st[j][1];
      yb[r * L + l0 + 8] = st[j][2];
      yb[(r + 1) * L + l0 + 8] = st[j][3];
    }
  }
}

// tier 4: f32 FMAs. A chunk of 128 lanes in plane `cur` (acc[k][l] at
// k kFmaPitch + l); G transposed in shared memory (gt[k][m]); thread
// (lane l = tid % 128, rows 8 h .. 8 h + 7 for h = tid / 128 + 2 u) runs
// y[m][l] = sum_k gt[k][m] acc[k][l] over k in order, then + c acc[m][l],
// into the other plane.
__global__ void __launch_bounds__(kBlock, 1)
probe_mma_fma(const float* __restrict__ x, float* __restrict__ y,
              const float* __restrict__ gtab, int L, int R, float c) {
  extern __shared__ __align__(16) float fs[];
  float* gt = fs;                          // [k][m], kRows x kRows
  float* plane[2] = {fs + kRows * kRows,
                     fs + kRows * kRows + kRows * kFmaPitch};
  for (int i = threadIdx.x; i < kRows * kRows; i += kBlock) {
    const int m = i / kRows, k = i % kRows;
    gt[k * kRows + m] = gtab[i];
  }
  const int l = threadIdx.x % kLanes;
  const int h0 = threadIdx.x / kLanes;     // 0 or 1
  const float* xb = x + (long long)blockIdx.x * kRows * L;
  float* yb = y + (long long)blockIdx.x * kRows * L;
  constexpr int kOut = 8;                  // fft_core.cuh's kOutPerThread
  for (int c0 = 0; c0 < L; c0 += kLanes) {
    __syncthreads();
    for (int k = h0; k < kRows; k += 2)
      plane[0][k * kFmaPitch + l] = xb[k * L + c0 + l];
    int cur = 0;
    for (int it = 0; it < R; ++it) {
      __syncthreads();
      const float* a = plane[cur];
      float* o = plane[cur ^ 1];
      for (int h = h0; h < kRows / kOut; h += 2) {
        float v[kOut];
#pragma unroll
        for (int u = 0; u < kOut; ++u) v[u] = 0.f;
#pragma unroll 4
        for (int k = 0; k < kRows; ++k) {
          const float xk = a[k * kFmaPitch + l];
          const float4 w0 =
              *reinterpret_cast<const float4*>(gt + k * kRows + kOut * h);
          const float4 w1 = *reinterpret_cast<const float4*>(
              gt + k * kRows + kOut * h + 4);
          v[0] = fmaf(w0.x, xk, v[0]);
          v[1] = fmaf(w0.y, xk, v[1]);
          v[2] = fmaf(w0.z, xk, v[2]);
          v[3] = fmaf(w0.w, xk, v[3]);
          v[4] = fmaf(w1.x, xk, v[4]);
          v[5] = fmaf(w1.y, xk, v[5]);
          v[6] = fmaf(w1.z, xk, v[6]);
          v[7] = fmaf(w1.w, xk, v[7]);
        }
#pragma unroll
        for (int u = 0; u < kOut; ++u) {
          const int m = kOut * h + u;
          o[m * kFmaPitch + l] = v[u] + c * a[m * kFmaPitch + l];
        }
      }
      cur ^= 1;
    }
    __syncthreads();
    for (int k = h0; k < kRows; k += 2)
      yb[k * L + c0 + l] = plane[cur][k * kFmaPitch + l];
  }
}

}  // namespace probe
}  // namespace offt

// x, y: (B, 128, L) f32, L a multiple of 128; g: (128, 768) bf16 for
// tiers 0-1, (128, 128) f32 for tiers 2-4. One block an operand.
extern "C" int offt_probe_mma(const void* x, void* y, const void* g,
                              long long b, int L, int R, float c, int tier,
                              void* stream) {
  using namespace offt::probe;
  if (b < 1 || L < kLanes || L % kLanes || R < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  float* yf = (float*)y;
  const uint32_t* gw = (const uint32_t*)g;
  size_t smem = 0;
  cudaError_t err = cudaSuccess;
  // the tensor-core tiers: one block an operand, G's planes in shared
  // memory
  auto go = [&](auto kernel, size_t bytes) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return;
    kernel<<<(unsigned)b, kBlock, bytes, s>>>(xf, yf, gw, L, R, c);
    err = cudaGetLastError();
  };
  switch (tier) {
    case kStack6:
      go(probe_mma_tc<kStack6>, (size_t)kRows * kPitch6 * 4);
      break;
    case kSix:
      go(probe_mma_tc<kSix>, (size_t)kRows * kPitch6 * 4);
      break;
    case k3xTF32:
      go(probe_mma_tc<k3xTF32>, (size_t)2 * kRows * kPitch * 4);
      break;
    case kTF32:
      go(probe_mma_tc<kTF32>, (size_t)kRows * kPitch * 4);
      break;
    case kFMA:
      smem = ((size_t)kRows * kRows + 2 * (size_t)kRows * kFmaPitch) * 4;
      err = cudaFuncSetAttribute(
          probe_mma_fma, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) break;
      probe_mma_fma<<<(unsigned)b, kBlock, smem, s>>>(
          xf, yf, (const float*)g, L, R, c);
      err = cudaGetLastError();
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return (int)err;
}
