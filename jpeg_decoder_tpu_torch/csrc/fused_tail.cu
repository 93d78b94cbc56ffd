// K3: fused chroma upsampling + color conversion into the planar layout, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel jpeg_decoder_tpu/ops/pallas_kernels.py
// `_fused_tail_kernel` (driven by `fused_tail_pallas`): uint8 component
// planes -> uint8 planar [C_out, out_h, out_w]. Per component, by mode:
//   full  (h1v1)  plane[r][x]
//   v2    (h1v2)  (3 * near[x] + far[x] + 2) >> 2
//   h2    (h2v1)  H2 taps over t = 4 * plane[r][j]
//   h2v2          H2 taps over t = 3 * near[j] + far[j]
// where near is row r / 2 and far row r / 2 - 1 (r even) or r / 2 + 1 (r odd),
// clamped to [0, hc), and the H2 taps of output column x = 2j + parity are
//   even: (3 t[j] + t[j-1] + 8) >> 4,  (t[0] + 2) >> 2 at j = 0
//   odd:  (3 t[j] + t[j+1] + 8) >> 4,  (t[wc-1] + 2) >> 2 at j = wc - 1
// with j clamped to [0, wc). Then YCbCr / YCCK in x2^20 fixed point
// (ops/color.py's constants) or CMYK inversion. int32 math, arithmetic
// shifts, clamp before the uint8 cast.
//
// The TPU kernel needs XLA to materialize near/far row planes, split the
// full-resolution planes by column parity and interleave the (even, odd)
// outputs afterwards: Mosaic's layouts ask for it. Here none of that
// exists: the kernel reads the block-padded IDCT planes in place, each with
// its own row pitch, and writes the interleaved columns itself.
//
// What it replaces: one thread per output row and 4 columns, 64-bit index
// division, one clamped byte load per tap (~20 loads for 4 pixels at
// 4:2:0), chroma rows read again by the warps of both output rows they
// serve (15.1 us at large_420's planes on an H100: 1.0 TB/s).
//
// What bounds it on this card: memory. It moves about 1.5 bytes in and 3
// out per pixel (~15.5 MB at 3.4 Mpix 4:2:0), 4.6 us at 3.35 TB/s, with ~40
// integer operations per pixel.
//
// What the design does about it:
// - A 2-D grid, 32-bit indices: blockIdx.y runs over output row pairs,
//   x over 16-column tiles; one thread computes 2 output rows x 16
//   columns, so with V2 modes the chroma rows i - 1, i and i + 1 serve both
//   output rows 2i and 2i + 1 from registers.
// - Vector loads: 16 B of a full-resolution row, 8 B of an H2 chroma row,
//   in the widest vector the plane's pitch and base alignment allow (only
//   8 is guaranteed); the H2 taps' j - 1 and j + 8 come from the adjacent
//   lanes by __shfl_sync (lanes 0 and 31 load theirs). A vector that would
//   leave its row reads byte by byte, clamped as the taps are.
// - Vector stores: 16 B per channel and row where the output row pitch
//   allows, else the widest that does; the ragged last tile of a row stores
//   bytewise.
// - (full, h2v2, h2v2) and (full, h2v1, h2v1) YCbCr and YCbCr 4:4:4 are
//   compiled with their modes fixed; every other mode and transform (YCCK,
//   CMYK, h1v2, 4 components) runs the same tiles with the modes read at
//   run time.
// - A group of images of one geometry is one launch: blockIdx.z runs over
//   the images, each plane and the output stepping by a per-image byte
//   stride (64-bit), so every image's tiles run the code of a one-image
//   launch on its own planes, and give its bytes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileX = 32;   // tiles of a block along a row: one warp
constexpr int kTileY = 4;    // row pairs of a block: one per warp
constexpr int kCols = 16;    // output columns of a tile
constexpr int kMaxComp = 4;
constexpr unsigned kFull = 0xffffffffu;

// ops/kernels.py TAIL_MODES and TAIL_TRANSFORMS
enum Mode { kFullRes = 0, kV2 = 1, kH2 = 2, kH2V2 = 3 };
enum Transform { kYCbCr = 0, kCMYK = 1, kYCCK = 2 };
// Compile-time layouts; kAny reads the modes and transform at run time.
enum Layout { kAny = 0, k420 = 1, k422 = 2, k444 = 3 };

struct Plane {
  const uint8_t* p;
  long long stride;  // bytes from one image's plane to the next's
  int pitch;         // bytes per row
  int mode;
  int align;   // the widest of 16, 8, 4, 1 dividing the base, the pitch and
               // the image stride
};

struct TailArgs {
  Plane c[kMaxComp];
  int ncomp, transform, hc, wc, out_h, out_w;
  int out_align;   // the widest of 16, 8, 4, 1 dividing out_w and out
};

template <int L>
__device__ __forceinline__ int mode_of(const TailArgs& a, int c) {
  if constexpr (L == k420) return c == 0 ? kFullRes : kH2V2;
  else if constexpr (L == k422) return c == 0 ? kFullRes : kH2;
  else if constexpr (L == k444) return kFullRes;
  else return a.c[c].mode;
}

__device__ __forceinline__ int byte_of(const uint32_t* w, int k) {
  return (w[k >> 2] >> ((k & 3) * 8)) & 0xFF;
}

// 16 bytes of plane row `row` from column x0, as 4 words. Where the vector
// would leave the row, byte by byte at min(x, lim - 1).
__device__ __forceinline__ void load16(const Plane& pl, int row, int x0,
                                       int lim, uint32_t* w) {
  const uint8_t* src = pl.p + row * pl.pitch;
  if (x0 + 16 <= pl.pitch && pl.align >= 4) {
    if (pl.align >= 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(src + x0);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if (pl.align >= 8) {
      const uint2 u = *reinterpret_cast<const uint2*>(src + x0);
      const uint2 v = *reinterpret_cast<const uint2*>(src + x0 + 8);
      w[0] = u.x; w[1] = u.y; w[2] = v.x; w[3] = v.y;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        w[k] = *reinterpret_cast<const uint32_t*>(src + x0 + 4 * k);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k)
    w[k >> 2] |= static_cast<uint32_t>(src[min(x0 + k, lim - 1)])
                 << ((k & 3) * 8);
}

// 8 bytes of chroma row `row` from column j0, as 2 words; the same rule.
__device__ __forceinline__ void load8(const Plane& pl, int row, int j0,
                                      int lim, uint32_t* w) {
  const uint8_t* src = pl.p + row * pl.pitch;
  if (j0 + 8 <= pl.pitch && pl.align >= 4) {
    if (pl.align >= 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(src + j0);
      w[0] = v.x; w[1] = v.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(src + j0);
      w[1] = *reinterpret_cast<const uint32_t*>(src + j0 + 4);
    }
    return;
  }
  w[0] = w[1] = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    w[k >> 2] |= static_cast<uint32_t>(src[min(j0 + k, lim - 1)])
                 << ((k & 3) * 8);
}

// One component's rows for a tile, by mode, in 12 words:
//   full   w[0..3] row r0, w[4..7] row r1
//   v2     w[0..3] chroma row i, w[4..7] row i - 1, w[8..11] row i + 1
//   h2     rows ri = 0, 1 (r0, r1): 8 bytes at w[2 ri], j0 - 1 at
//          w[6 + ri], j0 + 8 at w[9 + ri]
//   h2v2   the same with ri = 0, 1, 2 for chroma rows i, i - 1, i + 1
// (rows clamped to the plane, chroma row i = r0 / 2).
template <int M>
__device__ __forceinline__ void load_comp(const TailArgs& a, const Plane& pl,
                                          int pair, int x0, uint32_t* w) {
  const int r0 = 2 * pair, r1 = min(r0 + 1, a.out_h - 1);
  const int up = max(pair - 1, 0), dn = min(pair + 1, a.hc - 1);
  if constexpr (M == kFullRes) {
    load16(pl, r0, x0, a.out_w, w);
    load16(pl, r1, x0, a.out_w, w + 4);
  } else if constexpr (M == kV2) {
    load16(pl, pair, x0, a.out_w, w);
    load16(pl, up, x0, a.out_w, w + 4);
    load16(pl, dn, x0, a.out_w, w + 8);
  } else {
    constexpr int kRows = M == kH2 ? 2 : 3;
    const int rows[3] = {M == kH2 ? r0 : pair, M == kH2 ? r1 : up, dn};
    const int j0 = x0 >> 1, last = a.wc - 1;
    const int lane = threadIdx.x;
    const uint8_t* base = pl.p;
#pragma unroll
    for (int ri = 0; ri < kRows; ++ri) {
      load8(pl, rows[ri], j0, a.wc, w + 2 * ri);
      const uint8_t* row = base + rows[ri] * pl.pitch;
      int left = __shfl_up_sync(kFull, byte_of(w + 2 * ri, 7), 1);
      int right = __shfl_down_sync(kFull, byte_of(w + 2 * ri, 0), 1);
      if (lane == 0) left = row[min(max(j0 - 1, 0), last)];
      if (lane == kTileX - 1) right = row[min(j0 + 8, last)];
      w[6 + ri] = left;
      w[9 + ri] = right;
    }
  }
}

template <int L>
__device__ __forceinline__ void load_any(const TailArgs& a, int c, int pair,
                                         int x0, uint32_t* w) {
  switch (mode_of<L>(a, c)) {
    case kFullRes: load_comp<kFullRes>(a, a.c[c], pair, x0, w); break;
    case kV2: load_comp<kV2>(a, a.c[c], pair, x0, w); break;
    case kH2: load_comp<kH2>(a, a.c[c], pair, x0, w); break;
    default: load_comp<kH2V2>(a, a.c[c], pair, x0, w); break;
  }
}

// H2 taps input t at local column jl (-1 .. 8) of chroma row pair (ri_n,
// ri_f): 4 * near for h2, 3 * near + far for h2v2.
template <int M>
__device__ __forceinline__ int h2_t(const uint32_t* w, int o, int jl) {
  auto b = [&](int ri) {
    return jl < 0 ? static_cast<int>(w[6 + ri])
         : jl > 7 ? static_cast<int>(w[9 + ri]) : byte_of(w + 2 * ri, jl);
  };
  if constexpr (M == kH2) return 4 * b(o);
  else return 3 * b(0) + b(1 + o);
}

// The component's value at output row o (0: r0, 1: r1), tile column kk.
template <int M>
__device__ __forceinline__ int comp_value(const TailArgs& a, const uint32_t* w,
                                          int o, int kk, int j0) {
  if constexpr (M == kFullRes) {
    return byte_of(w + 4 * o, kk);
  } else if constexpr (M == kV2) {
    return (3 * byte_of(w, kk) + byte_of(w + 4 * (1 + o), kk) + 2) >> 2;
  } else {
    const int jl = kk >> 1;
    const int t = h2_t<M>(w, o, jl);
    if ((kk & 1) == 0)
      return j0 + jl == 0 ? (t + 2) >> 2
                          : (3 * t + h2_t<M>(w, o, jl - 1) + 8) >> 4;
    return j0 + jl >= a.wc - 1 ? (t + 2) >> 2
                               : (3 * t + h2_t<M>(w, o, jl + 1) + 8) >> 4;
  }
}

template <int L>
__device__ __forceinline__ int value_any(const TailArgs& a, int c,
                                         const uint32_t* w, int o, int kk,
                                         int j0) {
  switch (mode_of<L>(a, c)) {
    case kFullRes: return comp_value<kFullRes>(a, w, o, kk, j0);
    case kV2: return comp_value<kV2>(a, w, o, kk, j0);
    case kH2: return comp_value<kH2>(a, w, o, kk, j0);
    default: return comp_value<kH2V2>(a, w, o, kk, j0);
  }
}

__device__ __forceinline__ int fixed20(int v) {
  return min(max(v >> 20, 0), 255);
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
    if (k < n) dst[k] = static_cast<uint8_t>(byte_of(o, k));
}

template <int L>
__global__ void __launch_bounds__(kTileX * kTileY)
fused_tail_kernel(TailArgs a, uint8_t* __restrict__ out) {
  const long long img = blockIdx.z;
#pragma unroll
  for (int c = 0; c < kMaxComp; ++c) a.c[c].p += img * a.c[c].stride;
  out += img * (static_cast<long long>(a.ncomp) * a.out_h * a.out_w);
  const int pair = blockIdx.y * kTileY + threadIdx.y;
  if (2 * pair >= a.out_h) return;   // whole warps: the shuffles stay full
  // Lanes past the row's end stay for the shuffles and store nothing.
  const int x0 = (blockIdx.x * kTileX + threadIdx.x) * kCols;
  const int j0 = x0 >> 1;
  const int ncomp = L == kAny ? a.ncomp : 3;
  const int transform = L == kAny ? a.transform : kYCbCr;

  uint32_t w[kMaxComp][12];
#pragma unroll
  for (int c = 0; c < kMaxComp; ++c)
    if (c < ncomp) load_any<L>(a, c, pair, x0, w[c]);

  const int plane = a.out_h * a.out_w;
#pragma unroll
  for (int o = 0; o < 2; ++o) {
    const int r = 2 * pair + o;
    if (r >= a.out_h) break;
    uint32_t packed[kMaxComp][4] = {};
#pragma unroll
    for (int kk = 0; kk < kCols; ++kk) {
      int v[kMaxComp] = {0, 0, 0, 0};
#pragma unroll
      for (int c = 0; c < kMaxComp; ++c)
        if (c < ncomp) v[c] = value_any<L>(a, c, w[c], o, kk, j0);
      int px[kMaxComp];
      if (transform == kCMYK) {
#pragma unroll
        for (int c = 0; c < kMaxComp; ++c) px[c] = 255 - v[c];
      } else {
        const int yy = v[0] * (1 << 20) + (1 << 19);
        const int cb = v[1] - 128;
        const int cr = v[2] - 128;
        px[0] = fixed20(yy + 1470104 * cr);
        px[1] = fixed20(yy - 360857 * cb - 748830 * cr);
        px[2] = fixed20(yy + 1858077 * cb);
        px[3] = 255 - v[3];   // YCCK's K; unused for YCbCr
      }
#pragma unroll
      for (int c = 0; c < kMaxComp; ++c)
        packed[c][kk >> 2] |= static_cast<uint32_t>(px[c] & 0xFF)
                              << ((kk & 3) * 8);
    }
    const int n = a.out_w - x0;
    if (n <= 0) continue;
#pragma unroll
    for (int c = 0; c < kMaxComp; ++c)
      if (c < ncomp)
        store16(out + c * plane + r * a.out_w + x0, packed[c], n,
                a.out_align);
  }
}

int widest(uintptr_t v) {
  return v % 16 == 0 ? 16 : v % 8 == 0 ? 8 : v % 4 == 0 ? 4 : 1;
}

}  // namespace

// p0..p3: the planes of image 0. meta: int64[12] on the host: the mode codes
// of components 0..3, their row pitches in bytes, then the byte strides from
// one image's plane to the next's. Entries past ncomp are ignored. out:
// [n_images, ncomp, out_h, out_w]. Every image's planes, and its output,
// must hold fewer than 2^31 bytes; n_images is 1..65535.
extern "C" int jdt_fused_tail(const void* p0, const void* p1, const void* p2,
                              const void* p3, const void* meta, int ncomp,
                              int transform, int hc, int wc, int out_h,
                              int out_w, int n_images, void* out,
                              void* stream) {
  if (ncomp < 3 || ncomp > kMaxComp || transform < kYCbCr ||
      transform > kYCCK || hc < 1 || wc < 1 || n_images < 1 ||
      n_images > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_h <= 0 || out_w <= 0) return 0;
  const long long limit = 1LL << 31;
  if (static_cast<long long>(ncomp) * out_h * out_w >= limit)
    return static_cast<int>(cudaErrorInvalidValue);
  TailArgs a;
  const void* planes[kMaxComp] = {p0, p1, p2, p3};
  const long long* m = static_cast<const long long*>(meta);
  for (int c = 0; c < kMaxComp; ++c) {
    Plane& pl = a.c[c];
    pl.p = static_cast<const uint8_t*>(planes[c]);
    pl.mode = c < ncomp ? static_cast<int>(m[c]) : kFullRes;
    const long long pitch = c < ncomp ? m[kMaxComp + c] : 0;
    pl.stride = c < ncomp ? m[2 * kMaxComp + c] : 0;
    if (c < ncomp && (pl.mode < kFullRes || pl.mode > kH2V2 ||
                      pl.p == nullptr || pitch < 1 || pl.stride < 0 ||
                      (max(out_h, hc) + 1) * pitch >= limit))
      return static_cast<int>(cudaErrorInvalidValue);
    pl.pitch = static_cast<int>(pitch);
    pl.align = widest(reinterpret_cast<uintptr_t>(pl.p) |
                      static_cast<uintptr_t>(pl.pitch) |
                      static_cast<uintptr_t>(pl.stride));
  }
  a.ncomp = ncomp;
  a.transform = transform;
  a.hc = hc;
  a.wc = wc;
  a.out_h = out_h;
  a.out_w = out_w;
  a.out_align = widest(static_cast<uintptr_t>(out_w) |
                       reinterpret_cast<uintptr_t>(out));
  const int tiles = (out_w + kCols - 1) / kCols;
  const dim3 block(kTileX, kTileY);
  const dim3 grid((tiles + kTileX - 1) / kTileX,
                  ((out_h + 1) / 2 + kTileY - 1) / kTileY, n_images);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint8_t*>(out);
  const int m0 = a.c[0].mode, m1 = a.c[1].mode, m2 = a.c[2].mode;
  const bool ycc3 = ncomp == 3 && transform == kYCbCr && m0 == kFullRes &&
                    m1 == m2;
  if (ycc3 && m1 == kH2V2)
    fused_tail_kernel<k420><<<grid, block, 0, s>>>(a, o);
  else if (ycc3 && m1 == kH2)
    fused_tail_kernel<k422><<<grid, block, 0, s>>>(a, o);
  else if (ycc3 && m1 == kFullRes)
    fused_tail_kernel<k444><<<grid, block, 0, s>>>(a, o);
  else
    fused_tail_kernel<kAny><<<grid, block, 0, s>>>(a, o);
  return static_cast<int>(cudaGetLastError());
}
