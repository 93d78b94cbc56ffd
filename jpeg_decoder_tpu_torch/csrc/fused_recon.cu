// K4: 4:4:4 YCbCr coefficient stores -> planar RGB pixels in one kernel, for
// Hopper (sm_90a).
//
// Replaces the TPU probe kernel tools/experiments/fused_recon_probe.py
// `make_kernel` (its stage 2, the real fused kernel): int16 [bh, bw, 64]
// natural-order stores per component and the three components' [64, 64]
// IDCT bases with their quantization tables folded in (B = diag(q) @ basis,
// as K2 takes them) -> uint8 [3, bh * 8, width]: per block row, dequant +
// IDCT, the block -> raster shuffle, then YCbCr -> RGB in x2^20 fixed point
// (ops/color.py's constants). Rows are not cropped; columns stop at width.
//
// The IDCT is K2's: the split-TF32 tensor-core product of idct_mma.cuh,
// the same instructions on the same operands for every pixel, so K4 is
// bit-equal to K2 + blocks_to_plane + ycbcr_to_rgb (the decoder's unfused
// path), and within 3 of its plain fp32 version (1 in the IDCT, times up to
// 1.772 through color).
//
// What bounds it on this card: at the probe's shape (3 x [210, 256, 64],
// 161,280 blocks) it reads 20.6 MB of coefficients and writes 10.3 MB of
// pixels, 9.24 us at 3.35 TB/s; the split product's three TF32 products
// (3.96 GFLOP) would take 8.0 us at 495 TFLOP/s, the same work in fp32 on
// the CUDA cores (1.32 GFLOP) 19.7 us. The first design (one CTA per 16
// blocks of a block row, fp32 FMAs, every one of 3,360 CTAs copying the 16
// KB basis: 55 MB of L2 reads) took 108 us. In practice the tensor-core
// product sets the pace: on an H100, mma.sync alone reaches about 70% of
// the TF32 peak, and the two products per k-step that K2's bits require
// (lo*hi is never needed below 2048) take about half of each warp's time
// at ~80% of that rate (tools/experiments/k4_phase_probe.py).
//
// What the design does about it:
// - persistent CTAs, one per SM: each stages the three folded bases once,
//   as ready-made hi/lo B fragments (96 KB of shared memory), and every
//   warp reads its component's from there;
// - the CTA's 12 warps form 4 independent groups of 3, one warp per
//   component, each with its own named barrier, double buffer and tile
//   stream (32 consecutive blocks of one block row, 256 pixel columns), so
//   one group's color and stores overlap another's tensor-core product,
//   and the work splits into 32-block tiles across 528 groups;
// - a tile's coefficients arrive by cp.async (16-byte chunks, zero-filled
//   past bw) into the group's other buffer while the current tile
//   computes;
// - each warp runs K2's warp_product on its two m16 tiles and writes its
//   pixels, two bytes per store, over its own coefficient rows as a
//   raster tile (8 rows x 256 columns): the block -> raster shuffle, with
//   no uint8 plane in device memory;
// - color as K3 does it: each thread converts 16 consecutive pixels of one
//   row in int32 fixed point and stores each channel as wide as the width
//   and the output's base allow (16 B where width % 16 == 0), bytewise on
//   the ragged edge.

#include <cstdint>
#include <cuda_runtime.h>

#include "idct_mma.cuh"

namespace {

using namespace jdt_idct;

constexpr int kGroups = 4;                     // warp groups per CTA
constexpr int kGroupThreads = 3 * 32;          // one warp per component
constexpr int kThreads = kGroups * kGroupThreads;
constexpr int kTileBlocks = kWarpRows;         // of one block row
constexpr int kTileCols = kTileBlocks * 8;     // one warp's raster row
constexpr int kWarpBytes = kWarpRows * kCoefStride * 2;
constexpr int kBufBytes = 3 * kWarpBytes;
constexpr int kSmemBytes = 3 * kBasisBytes + kGroups * 2 * kBufBytes;
constexpr int kVec = 16;                       // pixels per color item

static_assert(8 * kTileCols <= kWarpBytes,
              "a warp's raster fits over its coefficient rows");
static_assert(kSmemBytes <= 232448, "one CTA's shared memory on sm_90");

#ifdef K4_PHASE_PROBE
// tools/experiments/k4_phase_probe.py builds with this defined: the clock64
// cycles each warp spends in its phases (0: the tile's copy wait and
// barrier, and the next prefetch; 1: the product; 2: the raster; 3: the
// raster barrier; 4: color; 5: the prologue), summed over all warps, then
// the number of warps and the longest warp's span.
__device__ unsigned long long k4_probe[8];
__device__ __forceinline__ void lap(long long& acc, long long& tk) {
  const long long t = clock64();
  acc += t - tk;
  tk = t;
}
#define K4_PROBE(...) __VA_ARGS__
#else
#define K4_PROBE(...)
#endif

struct ReconArgs {
  const int16_t* y;
  const int16_t* cb;
  const int16_t* cr;
  const float* bases;    // [3][64][64]: diag(q_c) @ basis
  uint8_t* out;          // [3][bh * 8][width]
  int bw, width;
  int tiles_per_row, n_tiles;
  int out_align;         // the widest of 16, 8, 4, 1 dividing out and width
  int64_t plane;         // bh * 8 * width
};

__device__ __forceinline__ int fixed20(int v) {
  return min(max(v >> 20, 0), 255);
}

__device__ __forceinline__ int byte_of(const uint4& v, int k) {
  const uint32_t w = k < 4 ? v.x : k < 8 ? v.y : k < 12 ? v.z : v.w;
  return (w >> ((k & 3) * 8)) & 0xFF;
}

// A barrier over one warp group's threads (barrier 0 is __syncthreads').
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + group), "n"(kGroupThreads)
               : "memory");
}

// Store 16 bytes (4 words) of one channel row at dst, `n` of them valid.
__device__ __forceinline__ void store16(uint8_t* dst, const uint32_t* o,
                                        int n, int align) {
  if (n >= 16) {
    if (align >= 16) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
      return;
    }
    if (align >= 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(o[0], o[1]);
      *reinterpret_cast<uint2*>(dst + 8) = make_uint2(o[2], o[3]);
      return;
    }
    if (align >= 4) {
#pragma unroll
      for (int k = 0; k < 4; ++k) reinterpret_cast<uint32_t*>(dst)[k] = o[k];
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < 16; ++k)
    if (k < n) dst[k] = static_cast<uint8_t>(o[k >> 2] >> ((k & 3) * 8));
}

// Start the copy of one tile's coefficients into `dst` (gt: the thread's
// index in its group): staged row 32 c + r is block r of the tile in
// component c; rows past bw are zero-filled.
__device__ __forceinline__ void issue_tile(const ReconArgs& a, int tile,
                                           int16_t* dst, int gt) {
  const int brow = tile / a.tiles_per_row;
  const int b0 = (tile - brow * a.tiles_per_row) * kTileBlocks;
  const int64_t row_base = static_cast<int64_t>(brow) * a.bw;
#pragma unroll
  for (int j = 0; j < 3 * kTileBlocks * 8 / kGroupThreads; ++j) {
    const int q = gt + j * kGroupThreads;
    const int row = q >> 3;
    const int part = q & 7;
    const int c = row / kTileBlocks;
    const int bx = b0 + row % kTileBlocks;
    const int16_t* store = c == 0 ? a.y : c == 1 ? a.cb : a.cr;
    const bool live = bx < a.bw;
    const int16_t* src = live ? store + (row_base + bx) * 64 + part * 8
                              : store;
    cp_async16(dst + row * kCoefStride + part * 8, src, live ? 16 : 0);
  }
}

// The warp's pixels -> its raster tile over its own coefficient rows:
// row r (0..7) of its 32 blocks at w_buf + r * kTileCols. acc[m][n][j] is
// block 16m + g + 8 (j >> 1), pixel row n, column 2t + (j & 1).
__device__ __forceinline__ void put_raster(const float (&acc)[2][8][4],
                                           unsigned char* w_buf, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int blk = 16 * m + g + 8 * h;
        const uint32_t v = idct_pixel(acc[m][n][2 * h])
                           | idct_pixel(acc[m][n][2 * h + 1]) << 8;
        *reinterpret_cast<uint16_t*>(w_buf + n * kTileCols + blk * 8 + 2 * t) =
            static_cast<uint16_t>(v);
      }
}

// The tile's raster in `buf` -> RGB, 16 pixels of one row per item.
__device__ __forceinline__ void color_tile(const ReconArgs& a,
                                           const unsigned char* buf, int tile,
                                           int gt) {
  constexpr int kItemsPerRow = kTileCols / kVec;
  const int brow = tile / a.tiles_per_row;
  const int x0 = (tile - brow * a.tiles_per_row) * kTileCols;
  for (int it = gt; it < 8 * kItemsPerRow; it += kGroupThreads) {
    const int r = it / kItemsPerRow;
    const int xl = (it % kItemsPerRow) * kVec;
    const int n = a.width - (x0 + xl);
    if (n <= 0) continue;
    const unsigned char* src = buf + r * kTileCols + xl;
    const uint4 yv = *reinterpret_cast<const uint4*>(src);
    const uint4 bv = *reinterpret_cast<const uint4*>(src + kWarpBytes);
    const uint4 rv = *reinterpret_cast<const uint4*>(src + 2 * kWarpBytes);
    uint32_t o[3][4] = {};
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int yy = byte_of(yv, k) * (1 << 20) + (1 << 19);
      const int vb = byte_of(bv, k) - 128;
      const int vr = byte_of(rv, k) - 128;
      const int sh = (k & 3) * 8;
      o[0][k >> 2] |= static_cast<uint32_t>(fixed20(yy + 1470104 * vr)) << sh;
      o[1][k >> 2] |=
          static_cast<uint32_t>(fixed20(yy - 360857 * vb - 748830 * vr)) << sh;
      o[2][k >> 2] |= static_cast<uint32_t>(fixed20(yy + 1858077 * vb)) << sh;
    }
    uint8_t* dst = a.out + (static_cast<int64_t>(brow) * 8 + r) * a.width
                   + x0 + xl;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      store16(dst + c * a.plane, o[c], n, a.out_align);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_recon_kernel(const ReconArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x;
  const int group = tid / kGroupThreads;
  const int gt = tid - group * kGroupThreads;
  const int warp = gt >> 5;
  const int lane = tid & 31;
  const float4* w_frag = reinterpret_cast<const float4*>(smem)
                         + warp * kFragsPerBasis;   // warp w: component w
  unsigned char* g_buf = smem + 3 * kBasisBytes + group * 2 * kBufBytes;
  const int stride = kGroups * gridDim.x;
  K4_PROBE(long long ph[6] = {0, 0, 0, 0, 0, 0}; long long tk = clock64();
           const long long t0 = tk;)

  // Group g of CTA b takes tiles b + g * gridDim.x, then every stride-th.
  int tile = blockIdx.x + group * gridDim.x;
  if (tile < a.n_tiles)
    issue_tile(a, tile, reinterpret_cast<int16_t*>(g_buf), gt);
  cp_async_commit();
  load_frags<kThreads, 3>(a.bases, reinterpret_cast<float4*>(smem), tid);
  __syncthreads();                // the fragments are in
  K4_PROBE(lap(ph[5], tk);)
  for (int i = 0; tile < a.n_tiles; ++i, tile += stride) {
    unsigned char* buf = g_buf + (i & 1) * kBufBytes;
    cp_async_wait<0>();           // this tile's copy has landed
    group_sync(group);            // ... for the whole group, and every
                                  // thread of it is past the last tile
    const int next = tile + stride;
    if (next < a.n_tiles)
      issue_tile(a, next,
                 reinterpret_cast<int16_t*>(g_buf + ((i + 1) & 1) * kBufBytes),
                 gt);
    cp_async_commit();            // an empty group on the last tile
    K4_PROBE(lap(ph[0], tk);)
    unsigned char* w_buf = buf + warp * kWarpBytes;
    float acc[2][8][4];
    warp_product<8, 8>(reinterpret_cast<const int16_t*>(w_buf), w_frag, lane,
                       acc);
    __syncwarp();                 // every lane has read its coefficients
    K4_PROBE(lap(ph[1], tk);)
    put_raster(acc, w_buf, lane);
    K4_PROBE(lap(ph[2], tk);)
    group_sync(group);            // the whole tile's raster is in
    K4_PROBE(lap(ph[3], tk);)
    color_tile(a, buf, tile, gt);
    K4_PROBE(lap(ph[4], tk);)
  }
  K4_PROBE(if (lane == 0) {
    for (int k = 0; k < 6; ++k)
      atomicAdd(&k4_probe[k], static_cast<unsigned long long>(ph[k]));
    atomicAdd(&k4_probe[6], 1ull);
    atomicMax(&k4_probe[7], static_cast<unsigned long long>(clock64() - t0));
  })
}

int widest(uintptr_t v) {
  return v % 16 == 0 ? 16 : v % 8 == 0 ? 8 : v % 4 == 0 ? 4 : 1;
}

}  // namespace

#ifdef K4_PHASE_PROBE
extern "C" int jdt_k4_probe_read(void* dst) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, k4_probe, sizeof(k4_probe)));
}

extern "C" int jdt_k4_probe_reset() {
  const unsigned long long zero[8] = {};
  return static_cast<int>(cudaMemcpyToSymbol(k4_probe, zero, sizeof(zero)));
}
#endif

// y, cb, cr: int16 [bh, bw, 64] stores, each 16-byte aligned; bases: float32
// [3, 64, 64] folded bases; out: uint8 [3, bh * 8, width].
extern "C" int jdt_fused_recon(const void* y, const void* cb, const void* cr,
                               const void* bases, int bh, int bw, int width,
                               void* out, void* stream) {
  if (bh < 0 || bw < 0 || width < 0
      || static_cast<int64_t>(width) > static_cast<int64_t>(bw) * 8)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bh == 0 || bw == 0 || width == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(y) | reinterpret_cast<uintptr_t>(cb)
       | reinterpret_cast<uintptr_t>(cr)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int tiles_per_row = (bw + kTileBlocks - 1) / kTileBlocks;
  const int64_t n_tiles = static_cast<int64_t>(bh) * tiles_per_row;
  if (n_tiles >= (1LL << 31) - (1LL << 20))
    return static_cast<int>(cudaErrorInvalidValue);
  ReconArgs a;
  a.y = static_cast<const int16_t*>(y);
  a.cb = static_cast<const int16_t*>(cb);
  a.cr = static_cast<const int16_t*>(cr);
  a.bases = static_cast<const float*>(bases);
  a.out = static_cast<uint8_t*>(out);
  a.bw = bw;
  a.width = width;
  a.tiles_per_row = tiles_per_row;
  a.n_tiles = static_cast<int>(n_tiles);
  a.out_align = widest(reinterpret_cast<uintptr_t>(out)
                       | static_cast<uintptr_t>(width));
  a.plane = static_cast<int64_t>(bh) * 8 * width;
  // The opt-in holds for one device: keep one flag per card (a mesh
  // may launch on several).
  static uint64_t configured = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) dev = 64;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(configured & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_recon_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= bit;
  }
  const int grid = min((a.n_tiles + kGroups - 1) / kGroups,
                       jdt_idct::sm_count());
  fused_recon_kernel<<<grid, kThreads, kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
