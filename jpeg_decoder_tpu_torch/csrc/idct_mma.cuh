// The split-TF32 tensor-core IDCT product shared by K2 (dequant_idct.cu) and
// K4 (fused_recon.cu), for Hopper (sm_90a).
//
// One warp takes 32 staged coefficient rows (int16, natural order, one block
// each) to their pixel sums against a [64, 64] basis with the quantization
// table folded in (B = diag(q) @ basis, params.folded_basis). fp32 operands
// do not fit TF32 (11 significant bits), so each is split into a TF32 high
// part and a low part and three `mma.sync.m16n8k8` TF32 products, hi*hi +
// hi*lo + lo*hi, accumulate in fp32 per k-step of 8 coefficients:
// - a basis value's high part is the value rounded to the nearest TF32 (ties
//   away from zero), its low part the remainder rounded the same way
//   (load_frags stages both as ready-made B fragments);
// - an int16 coefficient splits exactly: the high part has its low 13
//   mantissa bits cleared, the low part is the rest (at most 5 significant
//   bits, nonzero only for magnitudes >= 2048);
// - a warp skips the lo*hi product of a k-step where none of its 32 rows has
//   a low part. The skipped product would add exact zeros, so the sum is
//   bit-identical either way, whichever rows share the warp.
// Each output element is then the same sequence of mma instructions on the
// same operands wherever its block sits in a warp, so every kernel that runs
// warp_product and idct_pixel gets K2's pixels bit for bit. Nothing here
// reads or sets torch's allow_tf32: the split is the kernel's own arithmetic.
// The epilogue's floor and float -> int conversion run as one exact add on
// the FP32 pipe, not as FRND and F2I in the conversion unit (16 a clock per
// SM on sm_90).

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace jdt_idct {

constexpr int kCoefStride = 72;    // int16 per staged row: 144 B, a multiple
                                   // of 16 for cp.async, conflict-free reads
constexpr int kWarpRows = 32;      // blocks per warp: 2 m16 tiles
constexpr int kFragsPerBasis = 64 * 32;           // 64 fragments x 32 lanes
constexpr int kBasisBytes = kFragsPerBasis * 16;  // as float4 {hi, hi, lo, lo}
constexpr uint32_t kTf32Mask = 0xFFFFE000u;       // clears 13 mantissa bits

__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & kTf32Mask);
}

// Round to the nearest TF32, ties away from zero.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & kTf32Mask);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending));
}

// kBases folded bases, float32 [kBases][64][64] contiguous, as B fragments
// of m16n8k8 in s_frag[kBases * kFragsPerBasis]: entry (m, kk, nt, lane
// (g, t)) holds B[8kk + t][8nt + g] and B[8kk + t + 4][8nt + g] of basis m,
// each split into hi and lo: {b0.hi, b1.hi, b0.lo, b1.lo}. All of a
// thread's loads are issued before the first is used.
template <int kThreads, int kBases>
__device__ __forceinline__ void load_frags(const float* __restrict__ basis,
                                           float4* s_frag, int tid) {
  constexpr int kPer = kBases * kFragsPerBasis / kThreads;
  static_assert(kPer * kThreads == kBases * kFragsPerBasis,
                "whole fragment entries per thread");
  float b[kPer][2];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * kThreads;
    const int lane = i & 31;
    const int f = (i >> 5) & 63;
    const int col = 8 * (f & 7) + (lane >> 2);
    const int row = 8 * (f >> 3) + (lane & 3);
    const float* m = basis + (i / kFragsPerBasis) * 64 * 64;
    b[j][0] = __ldg(m + row * 64 + col);
    b[j][1] = __ldg(m + (row + 4) * 64 + col);
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const float h0 = tf32_rna(b[j][0]);
    const float h1 = tf32_rna(b[j][1]);
    s_frag[tid + j * kThreads] =
        make_float4(h0, h1, tf32_rna(b[j][0] - h0), tf32_rna(b[j][1] - h1));
  }
}

// One warp: 32 staged coefficient rows (stride kCoefStride) times one
// basis's fragments -> acc[m][n][j], the sum of row 16m + g + 8 (j >> 1),
// pixel column 8n + 2t + (j & 1), for NT n-tiles over KT k-steps.
template <int NT, int KT>
__device__ __forceinline__ void warp_product(const int16_t* s_coef,
                                             const float4* s_frag, int lane,
                                             float (&acc)[2][NT][4]) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][n][j] = 0.0f;

#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    uint32_t ahi[2][4], alo[2][4];
    bool any_lo = false;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int16_t* r0 = s_coef + (m * 16 + g) * kCoefStride + kk * 8 + t;
      const int16_t* r1 = r0 + 8 * kCoefStride;
      const float x[4] = {
          static_cast<float>(r0[0]), static_cast<float>(r1[0]),
          static_cast<float>(r0[4]), static_cast<float>(r1[4])};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float hi = tf32_hi(x[j]);
        const float lo = x[j] - hi;      // exact, at most 5 significant bits
        ahi[m][j] = __float_as_uint(hi);
        alo[m][j] = __float_as_uint(lo);
        any_lo |= lo != 0.0f;
      }
    }
    const bool need_lo = __any_sync(0xFFFFFFFFu, any_lo);
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const float4 b = s_frag[(kk * 8 + n) * 32 + lane];
      bh[n][0] = __float_as_uint(b.x);
      bh[n][1] = __float_as_uint(b.y);
      bl[n][0] = __float_as_uint(b.z);
      bl[n][1] = __float_as_uint(b.w);
    }
    // Every accumulator takes hi*hi, then hi*lo, then lo*hi; the 2 NT
    // accumulators take each product in turn, so no mma waits on the one
    // issued just before it (asm volatile keeps this order).
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int m = 0; m < 2; ++m)
        mma_tf32(acc[m][n], ahi[m], bh[n][0], bh[n][1]);
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int m = 0; m < 2; ++m)
        mma_tf32(acc[m][n], ahi[m], bl[n][0], bl[n][1]);
    if (need_lo) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int m = 0; m < 2; ++m)
          mma_tf32(acc[m][n], alo[m], bh[n][0], bh[n][1]);
    }
  }
}

// K2's epilogue, floor(y + 128.5) clamped to [0, 255]: the same value as
// floor(clamp(y + 128.5, 0, 255)), whose floor is the low byte of the bits
// of u + 2^23 rounded down (ulp 1 there).
__device__ __forceinline__ uint32_t idct_pixel(float y) {
  const float u = fminf(fmaxf(y + 128.5f, 0.0f), 255.0f);
  return __float_as_uint(__fadd_rd(u, 8388608.0f)) & 0xFFu;
}

// The card's SM count, for grids of persistent CTAs (132 if unreadable).
inline int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess
        || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
               != cudaSuccess)
      sms = 132;
  }
  return sms;
}

}  // namespace jdt_idct
