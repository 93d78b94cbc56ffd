// K2: dequantize + IDCT of natural-order coefficient blocks, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel jpeg_decoder_tpu/ops/pallas_kernels.py `_kernel_fn`
// (`dequant_idct_kernel`, driven by `dequantize_and_idct_blocks_pallas`):
//   out[b, p] = u8(clip(floor(sum_c (coef[b, c] * q[c]) * basis[c, p] + 128.5),
//                       0, 255))
// in fp32, with the cast after the clamp. `basis` is the [64, 64] coefficient
// -> pixel matrix; for scaled decodes (4x4, 2x2, 1x1) it is the zero-padded
// Dugad-Ahuja basis and only the first n_out = scale * scale columns are
// computed and stored, so `out` is [n_blocks, n_out].
//
// What bounds it on this card: 2 * 64 * 64 = 8192 FLOPs per block against
// 128 bytes of coefficients in and 64 bytes out, ~43 FLOP/byte, above the
// fp32 CUDA-core ridge (~20 FLOP/byte at 67 TFLOP/s and 3.35 TB/s): fp32
// FMA issue bounds it, provided the basis is not re-read per block.
//
// What the design does about it: one CTA of 256 threads takes a tile of 64
// blocks. It stages the basis (16 KB), the 64 dequant factors and the
// dequantized tile (16 KB) in shared memory; thread t owns pixel p = t % 64
// of blocks t / 64 + 4j, j < 16, so each basis value read from shared memory
// feeds 16 FMAs and the coefficient reads are warp-wide broadcasts. Plain
// CUDA-core FMAs in a fixed order c = 0..63, no tensor cores: TF32 would
// break the fp32 contract (a 3xTF32 split or wgmma is later work).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;                  // blocks per CTA
constexpr int kRows = kThreads / 64;       // blocks advanced per j step
constexpr int kPerThread = kTile / kRows;  // 16 accumulators

__global__ void __launch_bounds__(kThreads)
dequant_idct_kernel(const int16_t* __restrict__ coef, int n_blocks,
                    const float* __restrict__ q,
                    const float* __restrict__ basis, int n_out,
                    uint8_t* __restrict__ out) {
  __shared__ float s_basis[64 * 64];
  __shared__ float s_coef[kTile * 64];
  __shared__ float s_q[64];

  for (int i = threadIdx.x; i < 64 * 64; i += kThreads) s_basis[i] = basis[i];
  if (threadIdx.x < 64) s_q[threadIdx.x] = q[threadIdx.x];
  __syncthreads();
  const int64_t tile0 = static_cast<int64_t>(blockIdx.x) * kTile;
  for (int i = threadIdx.x; i < kTile * 64; i += kThreads) {
    const int64_t blk = tile0 + i / 64;
    s_coef[i] = blk < n_blocks
                    ? static_cast<float>(coef[tile0 * 64 + i]) * s_q[i & 63]
                    : 0.0f;
  }
  __syncthreads();

  const int p = threadIdx.x & 63;
  const int row = threadIdx.x >> 6;
  if (p >= n_out) return;

  float acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0.0f;
  for (int c = 0; c < 64; ++c) {
    const float m = s_basis[c * 64 + p];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      acc[j] = fmaf(s_coef[(row + kRows * j) * 64 + c], m, acc[j]);
  }
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int64_t blk = tile0 + row + kRows * j;
    if (blk < n_blocks) {
      const float y = fminf(fmaxf(floorf(acc[j] + 128.5f), 0.0f), 255.0f);
      out[blk * n_out + p] = static_cast<uint8_t>(y);
    }
  }
}

}  // namespace

extern "C" int jdt_dequant_idct(const void* coef, int n_blocks, const void* q,
                                const void* basis, int n_out, void* out,
                                void* stream) {
  if (n_out < 1 || n_out > 64) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks <= 0) return 0;
  const int grid = (n_blocks + kTile - 1) / kTile;
  dequant_idct_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(coef), n_blocks,
      static_cast<const float*>(q), static_cast<const float*>(basis), n_out,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
