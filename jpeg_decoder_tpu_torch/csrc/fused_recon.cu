// K4: 4:4:4 YCbCr coefficient stores -> planar RGB pixels in one kernel, for
// Hopper (sm_90a).
//
// Replaces the TPU probe kernel tools/experiments/fused_recon_probe.py
// `make_kernel` (its stage 2, the real fused kernel): int16 [bh, bw, 64]
// natural-order stores per component, float32 [3, 64] dequant factors and
// the [64, 64] 8x8 IDCT basis -> uint8 [3, bh * 8, width]: per block row,
// dequant + IDCT, the block -> raster shuffle, then YCbCr -> RGB in x2^20
// fixed point. Rows are not cropped; columns stop at width.
//
// The IDCT keeps the arithmetic of the first K2 design: float(coef) * q
// rounded first, then fmaf over c = 0..63 in order from 0, floorf(y +
// 128.5f), clamp to [0, 255]. K2 (csrc/dequant_idct.cu) has since moved to a
// split-TF32 tensor-core product with q folded into the basis, which rounds
// in other places, so K4 is no longer bit-equal to K2 + blocks_to_plane +
// ops/color.py's ycbcr_to_rgb: it is held within 3 of that path (1 in the
// IDCT, times up to 1.772 through color), as of its plain version.
//
// What bounds it on this card: like K2, fp32 FMA issue (8192 FLOPs per
// block against 128 bytes of coefficients in and 64 bytes out per
// component). Fusing removes the two uint8 planes written and read again
// between K2, blocks_to_plane and color (3 + 3 + 3 bytes per pixel) and
// four launches per component.
//
// What the design does about it: one CTA of 256 threads per tile of 16
// blocks of one block row. It stages the basis (16 KB), the 3 x 64 dequant
// factors and the three dequantized tiles (12 KB) in shared memory; thread t
// owns pixel p = t % 64 of blocks t / 64 + 4j, j < 4, in all three
// components, so each basis value read feeds 12 FMAs and the coefficient
// reads are warp-wide broadcasts. The pixels go to a raster tile in shared
// memory (3 x 8 rows x 128 columns); each thread then converts 4 consecutive
// pixels of one row and stores 4 bytes per channel, a warp 128 bytes of a
// row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;                  // blocks per CTA
constexpr int kCols = kTile * 8;           // pixel columns per CTA
constexpr int kRows = kThreads / 64;       // blocks advanced per j step
constexpr int kPerThread = kTile / kRows;  // blocks per thread and component

__device__ __forceinline__ int fixed20(int v) {
  return min(max(v >> 20, 0), 255);
}

__global__ void __launch_bounds__(kThreads)
fused_recon_kernel(const int16_t* __restrict__ y,
                   const int16_t* __restrict__ cb,
                   const int16_t* __restrict__ cr,
                   const float* __restrict__ q,
                   const float* __restrict__ basis, int bh, int bw, int width,
                   uint8_t* __restrict__ out) {
  __shared__ float s_basis[64 * 64];
  __shared__ float s_coef[3][kTile * 64];
  __shared__ float s_q[3 * 64];
  __shared__ uint8_t s_px[3][8][kCols];

  const int brow = blockIdx.y;
  const int b0 = blockIdx.x * kTile;
  const int nb = min(kTile, bw - b0);
  for (int i = threadIdx.x; i < 64 * 64; i += kThreads) s_basis[i] = basis[i];
  if (threadIdx.x < 3 * 64) s_q[threadIdx.x] = q[threadIdx.x];
  __syncthreads();
  const int64_t base = (static_cast<int64_t>(brow) * bw + b0) * 64;
  for (int i = threadIdx.x; i < 3 * kTile * 64; i += kThreads) {
    const int comp = i / (kTile * 64);
    const int k = i - comp * (kTile * 64);
    const int16_t* src = comp == 0 ? y : (comp == 1 ? cb : cr);
    s_coef[comp][k] = k / 64 < nb ? static_cast<float>(src[base + k]) *
                                        s_q[comp * 64 + (k & 63)]
                                  : 0.0f;
  }
  __syncthreads();

  const int p = threadIdx.x & 63;
  const int row = threadIdx.x >> 6;
  float acc[3][kPerThread];
#pragma unroll
  for (int comp = 0; comp < 3; ++comp)
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) acc[comp][j] = 0.0f;
  for (int c = 0; c < 64; ++c) {
    const float m = s_basis[c * 64 + p];
#pragma unroll
    for (int comp = 0; comp < 3; ++comp)
#pragma unroll
      for (int j = 0; j < kPerThread; ++j)
        acc[comp][j] =
            fmaf(s_coef[comp][(row + kRows * j) * 64 + c], m, acc[comp][j]);
  }
#pragma unroll
  for (int comp = 0; comp < 3; ++comp)
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const float v =
          fminf(fmaxf(floorf(acc[comp][j] + 128.5f), 0.0f), 255.0f);
      s_px[comp][p >> 3][(row + kRows * j) * 8 + (p & 7)] =
          static_cast<uint8_t>(v);
    }
  __syncthreads();

  // 8 rows x kCols columns, 4 columns per thread: kThreads work items.
  const int r8 = threadIdx.x / (kCols / 4);
  const int xl = (threadIdx.x % (kCols / 4)) * 4;
  const int x0 = b0 * 8 + xl;
  if (x0 >= width) return;
  int o[3][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int yy = s_px[0][r8][xl + k] * (1 << 20) + (1 << 19);
    const int vb = s_px[1][r8][xl + k] - 128;
    const int vr = s_px[2][r8][xl + k] - 128;
    o[0][k] = fixed20(yy + 1470104 * vr);
    o[1][k] = fixed20(yy - 360857 * vb - 748830 * vr);
    o[2][k] = fixed20(yy + 1858077 * vb);
  }
  const int64_t plane_px = static_cast<int64_t>(bh) * 8 * width;
  const int64_t at = (static_cast<int64_t>(brow) * 8 + r8) * width + x0;
  const bool whole = (width & 3) == 0;   // 4-byte aligned, never ragged
#pragma unroll
  for (int comp = 0; comp < 3; ++comp) {
    uint8_t* dst = out + comp * plane_px + at;
    if (whole) {
      *reinterpret_cast<uchar4*>(dst) =
          make_uchar4(o[comp][0], o[comp][1], o[comp][2], o[comp][3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x0 + k < width) dst[k] = static_cast<uint8_t>(o[comp][k]);
    }
  }
}

static_assert(kThreads == 8 * (kCols / 4), "one thread per 4 output pixels");
static_assert(kTile % kRows == 0, "whole j steps per tile");

}  // namespace

extern "C" int jdt_fused_recon(const void* y, const void* cb, const void* cr,
                               const void* q, const void* basis, int bh,
                               int bw, int width, void* out, void* stream) {
  if (bh < 0 || bh > 65535 || bw < 0 || width < 0 || width > bw * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || bw == 0 || width == 0) return 0;
  const dim3 grid((bw + kTile - 1) / kTile, bh);
  fused_recon_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(y), static_cast<const int16_t*>(cb),
      static_cast<const int16_t*>(cr), static_cast<const float*>(q),
      static_cast<const float*>(basis), bh, bw, width,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
