// T1: the interleaved tail. Block pixels of every component -> the decoded
// image (chroma upsampling + color conversion, the block -> plane layout
// folded into the reads), for one image, a group of images of one geometry
// or one stripe, in one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package the tail is jnp code that
// XLA fuses inside the compiled reconstruction, jpeg_decoder_tpu/ops/
// pipeline.py `_reconstruct` (`blocks_to_plane`, `upsample_component`,
// `color_convert_image`) and the stripe body jpeg_decoder_tpu/parallel/
// stripes.py `build_stripe_local_recon`. Its plain version is
// jpeg_decoder_tpu_torch/ops/kernels.py `interleaved_tail_plain`, and the
// kernel is bit-equal to it. Per component and output pixel (r, c), with
// plane(i, x) = px[(i / s) * bw + x / s][i % s][x % s] (the block layout K2
// and E1 write) and g = row0 + r the pixel's row in the image:
//   h1v1     plane(r, c)
//   h2v1     j = c / 2; plane(r, j) at c = 0, c = 2 iw - 1 or iw = 1, else
//            (3 plane(r, j) + plane(r, j -/+ 1) + 2) >> 2 (c even / odd)
//   h1v2     (3 near(c) + far(c) + 2) >> 2
//   h2v2     t(j) = 3 near(j) + far(j); (t(j) + 2) >> 2 at the same edges,
//            else (3 t(j) + t(j -/+ 1) + 8) >> 4
//   generic  plane(clamp(g / vs - base, 0, rows - 1), c / hs)
// where near is the image's row g / 2 and far its row g / 2 - 1 (g even) or
// g / 2 + 1 (g odd) clamped to [0, ih - 1]; image row i is local index
// j = clamp(i - base + 1, 0, rows + 1) of the stripe's plane with its two
// one-row halos, j = 0 the halo above, rows + 1 the one below. Off the
// stripes (row0 = base = 0, no halos) j stays inside the plane. Then YCbCr
// / YCCK in x2^20 fixed point (host/ops/color.py's constants), CMYK and
// YCCK's K inverted, RGB and NONE copied, gray the one channel: int32
// arithmetic with no overflow (the largest intermediate, 255 * 2^20 + 2^19
// + 1858077 * 127, is below 2^31), an arithmetic >> 20, the clamp before
// the uint8 cast.
//
// The output is described per channel by a byte offset, a column stride
// and a row pitch, plus an image stride: one description covers [N, H, W,
// C] (interleaved), [N, H, W * C] (NONE's planar-within-row) and [N, C, H,
// W] (the stream's "planar" layout).
//
// What bounds it on this card: memory. At large_420 it reads 5.16 MB of
// block pixels and writes 10.32 MB of RGB, 4.62 us at 3.35 TB/s, with ~40
// integer operations a pixel.
//
// What the design does about it (simple first): one launch replaces the
// ~75 eager ops of blocks_to_plane, the upsampling and the color (and their
// intermediate planes in device memory); a thread makes kRun pixels of one
// output row, computes each component's near and far row addresses once,
// and reads its taps as single bytes through the read-only cache (the
// neighbouring threads' taps share cache lines); the pixels are stored as
// bytes, which the L2 merges. Shared-memory row tiles and wide stores are
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// BT.601 in x2^20 fixed point; their values are those of
// jpeg_decoder_tpu_torch/host/ops/color.py, which a CPU test reads against
// this file.
constexpr int32_t kFixed = 20;
constexpr int32_t kHalf = 524288;           // 1 << 19
constexpr int32_t kC1_402 = 1470104;
constexpr int32_t kC0_344 = 360857;
constexpr int32_t kC0_714 = 748830;
constexpr int32_t kC1_772 = 1858077;

constexpr int kMaxComp = 4;
constexpr int kRun = 4;          // output columns of a thread
constexpr int kThreadsX = 32;
constexpr int kThreadsY = 8;
constexpr int kCompMeta = 12;    // int64 values per component (entry below)

// ops/kernels.py T1_MODES and T1_TRANSFORMS
enum Mode { kH1V1 = 0, kH2V1 = 1, kH1V2 = 2, kH2V2 = 3, kGeneric = 4 };
enum Transform { kGray = 0, kNone = 1, kRGB = 2, kYCbCr = 3, kCMYK = 4,
                 kYCCK = 5 };

struct Comp {
  const uint8_t* px;    // image 0's block pixels [n_c, s, s]
  const uint8_t* top;   // image 0's halo row above the stripe, or null
  const uint8_t* bot;   // image 0's halo row below the stripe, or null
  long long img_stride, top_stride, bot_stride;   // bytes per image
  int bw, log2s, rows, iw, ih, mode, hs, vs, base;
};

struct Chan {
  long long off, col, pitch;   // bytes: channel offset, column, row
};

struct Args {
  Comp c[kMaxComp];
  Chan o[kMaxComp];
  uint8_t* out;
  long long out_stride;        // bytes per image
  int ncomp, transform, out_h, out_w, row0;
};

// One row of samples: in block layout of 2^l x 2^l blocks, or linear (l = 0:
// a halo row, or a plane of scale 1).
struct Row {
  const uint8_t* p;
  int l;
  __device__ __forceinline__ int at(int x) const {
    return __ldg(p + ((static_cast<long long>(x >> l) << (2 * l))
                      | (x & ((1 << l) - 1))));
  }
};

__device__ __forceinline__ Row plane_row(const Comp& cp, long long img,
                                         int i) {
  const int l = cp.log2s;
  const long long blk = static_cast<long long>(i >> l) * cp.bw;
  return Row{cp.px + img * cp.img_stride + (blk << (2 * l))
                 + ((i & ((1 << l) - 1)) << l),
             l};
}

// Image row i of a V2 component: its plane's local row, or a halo.
__device__ __forceinline__ Row v2_row(const Comp& cp, long long img, int i) {
  const int lo = cp.top ? 0 : 1;
  const int hi = cp.bot ? cp.rows + 1 : cp.rows;
  const int j = min(max(i - cp.base + 1, lo), hi);
  if (j == 0) return Row{cp.top + img * cp.top_stride, 0};
  if (j == cp.rows + 1) return Row{cp.bot + img * cp.bot_stride, 0};
  return plane_row(cp, img, j - 1);
}

__device__ __forceinline__ int sample(const Comp& cp, const Row& a,
                                      const Row& b, int c) {
  switch (cp.mode) {
    case kH1V1:
      return a.at(c);
    case kH2V1: {
      const int j = c >> 1;
      const int s0 = a.at(j);
      if (cp.iw == 1 || c == 0 || c == 2 * cp.iw - 1) return s0;
      return (3 * s0 + a.at((c & 1) ? j + 1 : j - 1) + 2) >> 2;
    }
    case kH1V2:
      return (3 * a.at(c) + b.at(c) + 2) >> 2;
    case kH2V2: {
      const int j = c >> 1;
      const int t = 3 * a.at(j) + b.at(j);
      if (cp.iw == 1 || c == 0 || c == 2 * cp.iw - 1) return (t + 2) >> 2;
      const int k = (c & 1) ? j + 1 : j - 1;
      return (3 * t + 3 * a.at(k) + b.at(k) + 8) >> 4;
    }
    default:   // kGeneric: a is the source row
      return a.at(c / cp.hs);
  }
}

__device__ __forceinline__ uint8_t fixed20(int32_t v) {
  const int32_t x = v >> kFixed;   // arithmetic: v may be negative
  return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
}

__global__ void __launch_bounds__(kThreadsX * kThreadsY)
interleaved_tail_kernel(const Args a) {
  const int r = blockIdx.y * kThreadsY + threadIdx.y;
  const int c0 = (blockIdx.x * kThreadsX + threadIdx.x) * kRun;
  if (r >= a.out_h || c0 >= a.out_w) return;
  const long long img = blockIdx.z;
  const int g = a.row0 + r;

  Row ra[kMaxComp], rb[kMaxComp];
#pragma unroll
  for (int k = 0; k < kMaxComp; ++k) {
    if (k >= a.ncomp) continue;
    const Comp& cp = a.c[k];
    if (cp.mode == kH1V2 || cp.mode == kH2V2) {
      const int near = g >> 1;
      const int far = min(max((g & 1) ? near + 1 : near - 1, 0), cp.ih - 1);
      ra[k] = v2_row(cp, img, near);
      rb[k] = v2_row(cp, img, far);
    } else if (cp.mode == kGeneric) {
      ra[k] = plane_row(cp, img,
                        min(max(g / cp.vs - cp.base, 0), cp.rows - 1));
      rb[k] = ra[k];
    } else {
      ra[k] = plane_row(cp, img, r);
      rb[k] = ra[k];
    }
  }

  uint8_t* out = a.out + img * a.out_stride;
  const int c_end = min(c0 + kRun, a.out_w);
  for (int c = c0; c < c_end; ++c) {
    int v[kMaxComp] = {0, 0, 0, 0};
#pragma unroll
    for (int k = 0; k < kMaxComp; ++k)
      if (k < a.ncomp) v[k] = sample(a.c[k], ra[k], rb[k], c);
    uint8_t px[kMaxComp];
    if (a.transform == kYCbCr || a.transform == kYCCK) {
      const int32_t y = v[0] * (1 << kFixed) + kHalf;
      const int32_t cb = v[1] - 128;
      const int32_t cr = v[2] - 128;
      px[0] = fixed20(y + kC1_402 * cr);
      px[1] = fixed20(y - kC0_344 * cb - kC0_714 * cr);
      px[2] = fixed20(y + kC1_772 * cb);
      px[3] = static_cast<uint8_t>(255 - v[3]);
    } else if (a.transform == kCMYK) {
#pragma unroll
      for (int k = 0; k < kMaxComp; ++k)
        px[k] = static_cast<uint8_t>(255 - v[k]);
    } else {   // gray, NONE, RGB: the samples as they are
#pragma unroll
      for (int k = 0; k < kMaxComp; ++k) px[k] = static_cast<uint8_t>(v[k]);
    }
#pragma unroll
    for (int k = 0; k < kMaxComp; ++k) {
      if (k >= a.ncomp) continue;
      const Chan& o = a.o[k];
      out[o.off + r * o.pitch + c * o.col] = px[k];
    }
  }
}

}  // namespace

// One launch for `images` images (1..65535) of one geometry, on `stream`;
// allocates nothing, returns cudaGetLastError().
// pixels: host void*[ncomp], image 0's uint8 block pixels per component.
// halos: host void*[2 * ncomp], image 0's halo rows above and below per
//   component (null off the stripes, and for components that need none).
// comp_meta: host int64[ncomp][kCompMeta]: image stride, top and bottom
//   halo image strides (bytes), blocks per block row, scale (1, 2, 4, 8),
//   plane rows, size_width, size_height, mode (Mode), h_scale, v_scale, and
//   the stripe's first plane row in the image (0 off the stripes).
// out_meta: host int64[ncomp * 3 + 1]: per channel its byte offset, column
//   stride and row pitch, then the image stride.
// transform: Transform; row0: the first output row's row in the image.
extern "C" int jdt_interleaved_tail(const void* const* pixels,
                                    const void* const* halos,
                                    const long long* comp_meta, int ncomp,
                                    int transform, int out_h, int out_w,
                                    int row0, int images, void* out,
                                    const long long* out_meta, void* stream) {
  if (ncomp < 1 || ncomp > kMaxComp || transform < kGray
      || transform > kYCCK || images < 1 || images > 65535 || out_h < 0
      || out_w < 0 || row0 < 0 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (out_h == 0 || out_w == 0) return 0;
  Args a = {};
  for (int k = 0; k < ncomp; ++k) {
    const long long* m = comp_meta + k * kCompMeta;
    Comp& cp = a.c[k];
    const long long s = m[4];
    int l = 0;
    while ((1LL << l) < s && l < 3) ++l;
    cp.px = static_cast<const uint8_t*>(pixels[k]);
    cp.top = static_cast<const uint8_t*>(halos[2 * k]);
    cp.bot = static_cast<const uint8_t*>(halos[2 * k + 1]);
    cp.img_stride = m[0];
    cp.top_stride = m[1];
    cp.bot_stride = m[2];
    cp.bw = static_cast<int>(m[3]);
    cp.log2s = l;
    cp.rows = static_cast<int>(m[5]);
    cp.iw = static_cast<int>(m[6]);
    cp.ih = static_cast<int>(m[7]);
    cp.mode = static_cast<int>(m[8]);
    cp.hs = static_cast<int>(m[9]);
    cp.vs = static_cast<int>(m[10]);
    cp.base = static_cast<int>(m[11]);
    if (cp.px == nullptr || (1LL << l) != s || m[3] < 1 || m[5] < 1
        || m[6] < 1 || m[7] < 1 || m[8] < kH1V1 || m[8] > kGeneric
        || m[9] < 1 || m[10] < 1 || m[11] < 0 || m[0] < 0
        || m[5] * m[3] * s >= (1LL << 31))
      return static_cast<int>(cudaErrorInvalidValue);
    a.o[k] = {out_meta[3 * k], out_meta[3 * k + 1], out_meta[3 * k + 2]};
  }
  a.out = static_cast<uint8_t*>(out);
  a.out_stride = out_meta[3 * ncomp];
  a.ncomp = ncomp;
  a.transform = transform;
  a.out_h = out_h;
  a.out_w = out_w;
  a.row0 = row0;
  const int runs = (out_w + kRun - 1) / kRun;
  const dim3 block(kThreadsX, kThreadsY);
  const long long gy = (out_h + kThreadsY - 1) / kThreadsY;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((runs + kThreadsX - 1) / kThreadsX,
                  static_cast<unsigned>(gy), static_cast<unsigned>(images));
  interleaved_tail_kernel<<<grid, block, 0,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
