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
// What bounds it on this card: memory and its launch. It moves about 1.5
// bytes in and 3 out per pixel (~15 MB at 3.4 Mpix 4:2:0), a few
// microseconds at 3.35 TB/s, with ~40 integer operations per pixel.
//
// What the design does about it: one launch per image; each thread owns one
// output row and a run of 4 output columns, so a warp reads and writes 128
// consecutive bytes of a row and stores 4 bytes per thread and channel.
// Neighbouring threads share the chroma bytes they read through L1.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxComp = 4;

enum Mode { kFull = 0, kV2 = 1, kH2 = 2, kH2V2 = 3 };   // ops/kernels.py TAIL_MODES
enum Transform { kYCbCr = 0, kCMYK = 1, kYCCK = 2 };    // TAIL_TRANSFORMS

struct TailArgs {
  const uint8_t* plane[kMaxComp];
  int mode[kMaxComp];
  int pitch[kMaxComp];     // bytes per plane row
  int ncomp, transform, hc, wc, out_h, out_w;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// The component's value at output row r, columns x0 .. x0 + 3 (x0 % 4 == 0).
// Columns at or past out_w are computed from clamped reads and not stored.
__device__ __forceinline__ void component4(const TailArgs& a, int c, int r,
                                           int x0, int v[4]) {
  const uint8_t* p = a.plane[c];
  const int pitch = a.pitch[c];
  const int mode = a.mode[c];
  if (mode == kFull) {
    const uint8_t* row = p + static_cast<int64_t>(r) * pitch;
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = row[min(x0 + k, a.out_w - 1)];
    return;
  }
  int rn = r, rf = r;
  if (mode != kH2) {
    rn = r >> 1;
    rf = clampi((r & 1) ? rn + 1 : rn - 1, 0, a.hc - 1);
  }
  const uint8_t* near = p + static_cast<int64_t>(rn) * pitch;
  const uint8_t* far = p + static_cast<int64_t>(rf) * pitch;
  if (mode == kV2) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int x = min(x0 + k, a.out_w - 1);
      v[k] = (3 * near[x] + far[x] + 2) >> 2;
    }
    return;
  }
  const int j0 = x0 >> 1;
  const int last = a.wc - 1;
  int t[4];   // t at columns j0 - 1, j0, j0 + 1, j0 + 2, clamped
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = clampi(j0 - 1 + k, 0, last);
    t[k] = 3 * near[j] + far[j];
  }
  v[0] = j0 == 0 ? (t[1] + 2) >> 2 : (3 * t[1] + t[0] + 8) >> 4;
  v[1] = j0 >= last ? (t[1] + 2) >> 2 : (3 * t[1] + t[2] + 8) >> 4;
  v[2] = (3 * t[2] + t[1] + 8) >> 4;
  v[3] = j0 + 1 >= last ? (t[2] + 2) >> 2 : (3 * t[2] + t[3] + 8) >> 4;
}

__device__ __forceinline__ int fixed20(int v) {
  return clampi(v >> 20, 0, 255);
}

__global__ void __launch_bounds__(kThreads)
fused_tail_kernel(TailArgs a, uint8_t* __restrict__ out) {
  const int groups = (a.out_w + 3) >> 2;
  const int64_t idx =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<int64_t>(groups) * a.out_h) return;
  const int r = static_cast<int>(idx / groups);
  const int x0 = static_cast<int>(idx - static_cast<int64_t>(r) * groups) * 4;

  int v[kMaxComp][4] = {};
#pragma unroll
  for (int c = 0; c < kMaxComp; ++c)
    if (c < a.ncomp) component4(a, c, r, x0, v[c]);

  int o[kMaxComp][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (a.transform == kCMYK) {
#pragma unroll
      for (int c = 0; c < kMaxComp; ++c) o[c][k] = 255 - v[c][k];
      continue;
    }
    const int yy = v[0][k] * (1 << 20) + (1 << 19);
    const int cb = v[1][k] - 128;
    const int cr = v[2][k] - 128;
    o[0][k] = fixed20(yy + 1470104 * cr);
    o[1][k] = fixed20(yy - 360857 * cb - 748830 * cr);
    o[2][k] = fixed20(yy + 1858077 * cb);
    o[3][k] = 255 - v[3][k];   // YCCK's K; unused for YCbCr
  }

  const int64_t plane_px = static_cast<int64_t>(a.out_h) * a.out_w;
  const bool whole = (a.out_w & 3) == 0;   // 4-byte aligned, never ragged
#pragma unroll
  for (int c = 0; c < kMaxComp; ++c) {
    if (c >= a.ncomp) break;
    uint8_t* dst = out + c * plane_px + static_cast<int64_t>(r) * a.out_w + x0;
    if (whole) {
      *reinterpret_cast<uchar4*>(dst) =
          make_uchar4(o[c][0], o[c][1], o[c][2], o[c][3]);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x0 + k < a.out_w) dst[k] = static_cast<uint8_t>(o[c][k]);
    }
  }
}

}  // namespace

// meta: int32[8] on the host: the mode codes of components 0..3, then their
// row pitches in bytes. Entries past ncomp are ignored.
extern "C" int jdt_fused_tail(const void* p0, const void* p1, const void* p2,
                              const void* p3, const void* meta, int ncomp,
                              int transform, int hc, int wc, int out_h,
                              int out_w, void* out, void* stream) {
  if (ncomp < 3 || ncomp > kMaxComp || transform < kYCbCr ||
      transform > kYCCK || hc < 1 || wc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_h <= 0 || out_w <= 0) return 0;
  TailArgs a;
  const void* planes[kMaxComp] = {p0, p1, p2, p3};
  const int* m = static_cast<const int*>(meta);
  for (int c = 0; c < kMaxComp; ++c) {
    a.plane[c] = static_cast<const uint8_t*>(planes[c]);
    a.mode[c] = c < ncomp ? m[c] : kFull;
    a.pitch[c] = c < ncomp ? m[kMaxComp + c] : 0;
    if (c < ncomp && (a.mode[c] < kFull || a.mode[c] > kH2V2 ||
                      a.plane[c] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  a.ncomp = ncomp;
  a.transform = transform;
  a.hc = hc;
  a.wc = wc;
  a.out_h = out_h;
  a.out_w = out_w;
  const int64_t items = static_cast<int64_t>((out_w + 3) / 4) * out_h;
  const int64_t grid = (items + kThreads - 1) / kThreads;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  fused_tail_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
