// K2: dequantize + IDCT of natural-order coefficient blocks, every component
// of an image in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel jpeg_decoder_tpu/ops/pallas_kernels.py `_kernel_fn`
// (`dequant_idct_kernel`, driven by `dequantize_and_idct_blocks_pallas`):
//   out[b, p] = u8(clip(floor(sum_c (coef[b, c] * q[c]) * basis[c, p] + 128.5),
//                       0, 255))
// in fp32, with the cast after the clamp. `basis` is the [64, 64] coefficient
// -> pixel matrix; for scaled decodes (4x4, 2x2, 1x1) it is the zero-padded
// Dugad-Ahuja basis and only the first n_out = scale * scale columns are
// computed and stored, so `out` is [n_blocks, n_out]. The quantization
// table arrives folded into the basis, B = diag(q) @ basis, rounded to fp32
// once per product (params.folded_basis), so the kernel computes coef @ B.
// Its contract is its plain version's, `dequant_idct_plain`, within 1: the
// two round in different places, so a value next to a .5 boundary may land
// one step apart.
//
// What bounds it on this card: at large_420 (80,640 blocks, three
// components) it reads 10.3 MB of coefficients and writes 5.2 MB of pixels,
// 4.6 us at 3.35 TB/s; its 660.6 MFLOP would take 9.9 us on the fp32 CUDA
// cores (67 TFLOP/s). The first design (one launch per component, fp32
// FMAs in a fixed order, each of 1,260 CTAs re-reading the 16 KB basis)
// took 45.4 us for the three launches, at ~22% of the fp32 peak.
//
// What the design does about it:
// - one launch per image, or per group of images: a table of up to 64
//   segments (coefficients, block count, folded basis, output, scale; one
//   per component and image, the wrapper merging neighbours that share a
//   basis) rides in the kernel's arguments, 2.6 KB of the 4 KB parameter
//   space; a tile finds its segment by binary search over the segments'
//   first tiles. A tile's rows go through the same mma sequence whatever
//   segment or neighbours they have (idct_mma.cuh), so a group's launch
//   gives every image the bits of its own launch;
// - tensor cores with a split-precision product (idct_mma.cuh, shared with
//   K4): both operands split into TF32 hi and lo parts, three
//   `mma.sync.m16n8k8` TF32 products, hi*hi + hi*lo + lo*hi, accumulated in
//   fp32, the lo*hi one skipped per warp and k-step where no coefficient
//   reaches 2048. The error is the basis remainder's bits below about
//   2^-23 of its value, well inside the fp32 contract;
// - persistent CTAs, two per SM: each walks 128-block tiles (four warps of
//   32 blocks, two m16 tiles each) in a grid-stride loop, keeps the folded
//   basis of the current component in shared memory as ready-made B
//   fragments (hi and lo, one 16-byte load per fragment), reloading it only
//   when its tiles cross into the next component, and pulls the next
//   tile's coefficients with cp.async (16-byte chunks, zero-filled past the
//   last block) while it computes the current one;
// - scales 4, 2 and 1 run the same code with fewer n-tiles (n_out / 8,
//   rounded up) and k-steps (the scaled basis is zero past coefficient row
//   8 * (scale - 1) + scale - 1);
// - pixels go through a per-warp staging buffer in shared memory and out as
//   16-byte stores (32 blocks x n_out bytes, contiguous in `out`).

#include <cstdint>
#include <cuda_runtime.h>

#include "idct_mma.cuh"

namespace {

using namespace jdt_idct;

constexpr int kMaxSegs = 64;   // 16 images x 4 components
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = kWarps * kWarpRows;  // blocks per CTA tile
constexpr int kCoefBytes = kTileRows * kCoefStride * 2;
constexpr int kOutBytes = kWarps * kWarpRows * 64;
constexpr int kSmemBytes = kBasisBytes + 2 * kCoefBytes + kOutBytes;

struct Comp {
  const int16_t* coef;   // [n_blocks, 64] natural order
  const float* basis;    // [64, 64]: diag(q) @ basis, zero past n_out columns
  uint8_t* out;          // [n_blocks, scale * scale]
  int n_blocks;
  int scale;             // 8, 4, 2 or 1
  int tile0;             // the segment's first CTA tile
};

struct Args {
  Comp comp[kMaxSegs];
  int ncomp;             // segments
  int n_tiles;
};
static_assert(sizeof(Args) <= 4096, "the classic kernel parameter limit");

// The segment of a tile: the last one whose first tile is at or before it
// (segments of no blocks share their successor's tile0 and lose to it).
__device__ __forceinline__ int comp_of(const Args& a, int tile) {
  int lo = 0, hi = a.ncomp - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.comp[mid].tile0 <= tile) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Start the copy of one CTA tile's coefficients (128 rows of 128 B) into
// `dst`; rows past the component's last block are zero-filled.
__device__ __forceinline__ void issue_tile(const Args& a, int tile,
                                           int16_t* dst, int tid) {
  const Comp& cp = a.comp[comp_of(a, tile)];
  const int64_t row0 = static_cast<int64_t>(tile - cp.tile0) * kTileRows;
#pragma unroll
  for (int j = 0; j < kTileRows * 8 / kThreads; ++j) {
    const int q = tid + j * kThreads;
    const int row = q >> 3;
    const int part = q & 7;
    const bool live = row0 + row < cp.n_blocks;
    const int16_t* src =
        live ? cp.coef + (row0 + row) * 64 + part * 8 : cp.coef;
    cp_async16(dst + row * kCoefStride + part * 8, src, live ? 16 : 0);
  }
}

// One warp: 32 staged coefficient rows -> 32 x n_out pixels in `s_out`.
template <int NT, int KT>
__device__ __forceinline__ void warp_tile(const int16_t* s_coef,
                                          const float4* s_frag, uint8_t* s_out,
                                          int n_out, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  float acc[2][NT][4];
  warp_product<NT, KT>(s_coef, s_frag, lane, acc);
  // acc[m][n][j] is row 16m + g + 8 (j >> 1), column 8n + 2t + (j & 1).
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = m * 16 + g + 8 * (j >> 1);
        const int col = n * 8 + 2 * t + (j & 1);
        if (col < n_out)
          s_out[row * n_out + col] =
              static_cast<uint8_t>(idct_pixel(acc[m][n][j]));
      }
}

__global__ void __launch_bounds__(kThreads, 2)
dequant_idct_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* s_frag = reinterpret_cast<float4*>(smem);
  int16_t* s_coef = reinterpret_cast<int16_t*>(smem + kBasisBytes);
  uint8_t* s_out = smem + kBasisBytes + 2 * kCoefBytes;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  uint8_t* w_out = s_out + warp * kWarpRows * 64;

  int tile = blockIdx.x;
  if (tile >= a.n_tiles) return;
  int loaded = -1;
  issue_tile(a, tile, s_coef, tid);
  cp_async_commit();
  for (int i = 0; tile < a.n_tiles; ++i, tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < a.n_tiles)
      issue_tile(a, next, s_coef + ((i + 1) & 1) * kTileRows * kCoefStride,
                 tid);
    cp_async_commit();            // an empty group on the last tile
    cp_async_wait<1>();           // this tile's copy has landed
    __syncthreads();
    const int c = comp_of(a, tile);
    if (c != loaded) {            // every warp is past the previous tile
      load_frags<kThreads, 1>(a.comp[c].basis, s_frag, tid);
      loaded = c;
      __syncthreads();
    }
    const Comp& cp = a.comp[c];
    const int n_out = cp.scale * cp.scale;
    const int16_t* w_coef = s_coef + (i & 1) * kTileRows * kCoefStride
                            + warp * kWarpRows * kCoefStride;
    switch (cp.scale) {
      case 8: warp_tile<8, 8>(w_coef, s_frag, w_out, n_out, lane); break;
      case 4: warp_tile<2, 4>(w_coef, s_frag, w_out, n_out, lane); break;
      case 2: warp_tile<1, 2>(w_coef, s_frag, w_out, n_out, lane); break;
      default: warp_tile<1, 1>(w_coef, s_frag, w_out, n_out, lane); break;
    }
    __syncwarp();
    const int64_t row0 = static_cast<int64_t>(tile - cp.tile0) * kTileRows
                         + warp * kWarpRows;
    const int64_t live = cp.n_blocks - row0;
    if (live > 0) {
      uint8_t* dst = cp.out + row0 * n_out;
      // 32 * n_out bytes, a multiple of 32: 16-byte stores where the
      // segment's output starts 16-byte aligned (an image's slab of a
      // scaled decode may not).
      if (live >= kWarpRows && (reinterpret_cast<uintptr_t>(cp.out) & 15)
                                   == 0) {
        const int chunks = kWarpRows * n_out / 16;
        for (int q = lane; q < chunks; q += 32)
          reinterpret_cast<int4*>(dst)[q] =
              reinterpret_cast<const int4*>(w_out)[q];
      } else {                    // this warp's rows only
        const int rows = live < kWarpRows ? static_cast<int>(live)
                                          : kWarpRows;
        const int bytes = rows * n_out;
        for (int q = lane; q < bytes; q += 32) dst[q] = w_out[q];
      }
    }
    __syncthreads();              // buffers free for the next prefetch
  }
}

}  // namespace

// One launch for `ncomp` segments (1..64): per segment its int16 [n, 64]
// coefficients (16-byte aligned), float32 [64, 64] folded basis, uint8
// [n, scale^2] output, block count n and scale.
extern "C" int jdt_dequant_idct(const void* const* coefs,
                                const void* const* bases, void* const* outs,
                                const int* n_blocks, const int* scales,
                                int ncomp, void* stream) {
  if (ncomp < 1 || ncomp > kMaxSegs)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.ncomp = ncomp;
  int tiles = 0;
  for (int i = 0; i < ncomp; ++i) {
    const int s = scales[i];
    if ((s != 1 && s != 2 && s != 4 && s != 8) || n_blocks[i] < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (reinterpret_cast<uintptr_t>(coefs[i]) & 15)
      return static_cast<int>(cudaErrorMisalignedAddress);
    a.comp[i] = {static_cast<const int16_t*>(coefs[i]),
                 static_cast<const float*>(bases[i]),
                 static_cast<uint8_t*>(outs[i]), n_blocks[i], s, tiles};
    tiles += (n_blocks[i] + kTileRows - 1) / kTileRows;
  }
  a.n_tiles = tiles;
  if (tiles == 0) return 0;
  // The opt-in holds for one device: keep one flag per card (a mesh
  // may launch on several).
  static uint64_t configured = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) dev = 64;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(configured & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        dequant_idct_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= bit;
  }
  const int grid = min(tiles, 2 * jdt_idct::sm_count());
  dequant_idct_kernel<<<grid, kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
