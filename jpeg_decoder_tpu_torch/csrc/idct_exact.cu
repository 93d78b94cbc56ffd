// E1: the exact tier's dequantize + int32 IDCT (stb fixed point, scales
// 8/4/2/1) of natural-order coefficient blocks, every component of an image
// or a group of images in one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package the exact tier is jnp code,
// jpeg_decoder_tpu/ops/idct.py `dequantize_and_idct_blocks` (`_idct8x8`,
// `_idct4x4`, `_idct2x2`, `_idct1x1`), which XLA fuses into the compiled
// reconstruction (ops/pipeline.py `_reconstruct`, parallel/stripes.py). Its
// plain version is jpeg_decoder_tpu_torch/ops/idct.py
// `dequantize_and_idct_blocks`, and the kernel is bit-equal to it:
//   s = c * q                       (int32, wrapping mod 2^32)
//   scale 8: a butterfly over the rows of each column (x_scale 512, >> 10),
//            a column whose raw coefficients of rows 1-7 are all zero taken
//            as s[0][col] * 4 instead; then a butterfly over the columns of
//            each row (x_scale kXScaleRow, >> 17);
//   scale 4: Dugad-Ahuja on the top-left 4x4, (... + 512) >> 10 between the
//            passes, the bias kBias4 and >> 17 after the second;
//   scale 2: the 2x2 on the top-left 2x2, bias kBias2, >> 3;
//   scale 1: (s[0][0] + 1024) / 8, truncating toward zero;
//   out = u8(clamp(v, 0, 255)), [n, scale * scale].
// Every +, - and * runs in uint32_t, where wrapping is defined (signed
// overflow is not, and the compiler may assume it never happens); a value
// is cast to int32_t only for >>, which must be arithmetic, and the clamp.
//
// What bounds it on this card: at large_420 (80,640 blocks, three
// components, scale 8) it reads 10.3 MB of coefficients and writes 5.2 MB of
// pixels, 4.6 us at 3.35 TB/s, and does about 1,300 int32 operations a block
// (the count is in chip_smoke.py, E1_OPS_PER_BLOCK), 3.1 us at 132 SMs x 64
// INT32 lanes x 1.98 GHz with a multiply-add (IMAD), three-input add or
// shift-add taken as two: it is bound by bytes.
//
// What the design does about it (simple first: one block's rows on 8
// threads, no tensor cores, branch-free):
// - one launch per image, group or stripe: a table of up to 64 segments
//   (coefficients, table, output, block count, scale; one per component and
//   image, the wrapper merging neighbours that share a table tensor) rides
//   in the kernel's arguments; a CTA of 256 threads takes 32 blocks of one
//   segment and finds the segment by binary search over the segments' first
//   CTAs;
// - thread t of a block loads row t as one 16-byte vector, dequantizes it
//   with row t of the table and stages it in shared memory (a block's 8 x 8
//   int32 at a pitch of 72 words, so the 4 blocks of a warp read a column
//   without bank conflicts); the shortcut's test, "rows 1-7 of column t are
//   zero", is an OR of the 8 rows' nonzero masks over the block's 8 lanes
//   (three shuffles);
// - thread t then runs column t's pass and writes it back in place (no
//   other thread reads that column), the warp synchronises, and thread t
//   runs row t's pass and stores its 8 pixels as one 8-byte store. Scales
//   4, 2 and 1 run on the first 4, 1 and 1 threads of a block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// Fixed-point constants of the stb IDCT, scaled by 2^12, and the rounding
// terms; their values are those of jpeg_decoder_tpu_torch/host/ops/idct.py,
// which a CPU test reads against this file.
constexpr int32_t kC0_541 = 2217;
constexpr int32_t kCM1_847 = -7567;
constexpr int32_t kC0_765 = 3135;
constexpr int32_t kC1_175 = 4816;
constexpr int32_t kC0_298 = 1223;
constexpr int32_t kC2_053 = 8410;
constexpr int32_t kC3_072 = 12586;
constexpr int32_t kC1_501 = 6149;
constexpr int32_t kCM0_899 = -3685;
constexpr int32_t kCM2_562 = -10497;
constexpr int32_t kCM1_961 = -8034;
constexpr int32_t kCM0_390 = -1597;
constexpr int32_t kXScaleCol = 512;         // 8x8 first pass
constexpr int32_t kXScaleRow = 16842752;    // 65536 + (128 << 17)
constexpr int32_t kRound4 = 512;            // 4x4 between the passes
constexpr int32_t kBias4 = 16842752;        // (1 << 16) + (128 << 17)
constexpr int32_t kBias2 = 1028;            // (1 << 2) + (128 << 3)
constexpr int32_t kDc1 = 1024;              // 128 * 8

constexpr int kMaxSegs = 64;       // 16 images x 4 components
constexpr int kThreads = 256;
constexpr int kBlocks = kThreads / 8;       // 8x8 blocks per CTA
constexpr int kPitch = 72;                  // int32 words per staged block

struct Seg {
  const int16_t* coef;   // [n_blocks, 64] natural order
  const int32_t* q;      // [64] natural order
  uint8_t* out;          // [n_blocks, scale * scale]
  int n_blocks;
  int scale;             // 8, 4, 2 or 1
  int cta0;              // the segment's first CTA
};

struct Args {
  Seg seg[kMaxSegs];
  int nseg;
};
static_assert(sizeof(Args) <= 4096, "the classic kernel parameter limit");

__device__ __forceinline__ uint32_t u(int32_t v) {
  return static_cast<uint32_t>(v);
}

__device__ __forceinline__ uint32_t sar(uint32_t v, int n) {
  return static_cast<uint32_t>(static_cast<int32_t>(v) >> n);
}

__device__ __forceinline__ uint32_t clamp_u8(uint32_t v) {
  const int32_t x = static_cast<int32_t>(v);
  return static_cast<uint32_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
}

// The segment of a CTA: the last one whose first CTA is at or before it
// (segments of no blocks share their successor's cta0 and lose to it).
__device__ __forceinline__ int seg_of(const Args& a, int cta) {
  int lo = 0, hi = a.nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (a.seg[mid].cta0 <= cta) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// One 1-D pass of the 8x8 IDCT on v[0..7] in place: the even butterfly
// (`_kernel_x`) with `x_scale`, the odd one (`_kernel_t`), then the eight
// sums and differences shifted right by `shift`.
__device__ __forceinline__ void pass8(uint32_t (&v)[8], uint32_t x_scale,
                                      int shift) {
  // Even part, from v[0], v[2], v[4], v[6].
  const uint32_t p1e = (v[2] + v[6]) * u(kC0_541);
  const uint32_t t2e = p1e + v[6] * u(kCM1_847);
  const uint32_t t3e = p1e + v[2] * u(kC0_765);
  const uint32_t t0e = (v[0] + v[4]) << 12;
  const uint32_t t1e = (v[0] - v[4]) << 12;
  const uint32_t x0 = t0e + t3e + x_scale;
  const uint32_t x3 = t0e - t3e + x_scale;
  const uint32_t x1 = t1e + t2e + x_scale;
  const uint32_t x2 = t1e - t2e + x_scale;
  // Odd part, from t0 = v[7], t1 = v[5], t2 = v[3], t3 = v[1].
  uint32_t t0 = v[7], t1 = v[5], t2 = v[3], t3 = v[1];
  uint32_t p3 = t0 + t2;
  uint32_t p4 = t1 + t3;
  uint32_t p1 = t0 + t3;
  uint32_t p2 = t1 + t2;
  const uint32_t p5 = (p3 + p4) * u(kC1_175);
  t0 *= u(kC0_298);
  t1 *= u(kC2_053);
  t2 *= u(kC3_072);
  t3 *= u(kC1_501);
  p1 = p5 + p1 * u(kCM0_899);
  p2 = p5 + p2 * u(kCM2_562);
  p3 *= u(kCM1_961);
  p4 *= u(kCM0_390);
  t3 += p1 + p4;
  t2 += p2 + p3;
  t1 += p2 + p4;
  t0 += p1 + p3;
  v[0] = sar(x0 + t3, shift);
  v[1] = sar(x1 + t2, shift);
  v[2] = sar(x2 + t1, shift);
  v[3] = sar(x3 + t0, shift);
  v[4] = sar(x3 - t0, shift);
  v[5] = sar(x2 - t1, shift);
  v[6] = sar(x1 - t2, shift);
  v[7] = sar(x0 - t3, shift);
}

__global__ void __launch_bounds__(kThreads)
idct_exact_kernel(const Args a) {
  __shared__ __align__(16) uint32_t s_blk[kBlocks * kPitch];
  const Seg& sg = a.seg[seg_of(a, blockIdx.x)];
  const int t = threadIdx.x & 7;             // the row, then the column
  const int b = threadIdx.x >> 3;            // the block within the CTA
  const int64_t blk =
      static_cast<int64_t>(blockIdx.x - sg.cta0) * kBlocks + b;
  const bool live = blk < sg.n_blocks;
  uint32_t* s = s_blk + b * kPitch;

  // Row t: load, dequantize, stage; its nonzero-column mask for the
  // shortcut (row 0 does not count).
  int4 raw = make_int4(0, 0, 0, 0);
  if (live) raw = *reinterpret_cast<const int4*>(sg.coef + blk * 64 + t * 8);
  const int16_t* c = reinterpret_cast<const int16_t*>(&raw);
  uint32_t row[8];
  uint32_t nonzero = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    row[k] = u(c[k]) * u(__ldg(sg.q + t * 8 + k));
    nonzero |= (c[k] != 0 ? 1u : 0u) << k;
  }
  if (t == 0) nonzero = 0;
  reinterpret_cast<uint4*>(s + t * 8)[0] =
      make_uint4(row[0], row[1], row[2], row[3]);
  reinterpret_cast<uint4*>(s + t * 8)[1] =
      make_uint4(row[4], row[5], row[6], row[7]);
  // OR over the block's 8 lanes (aligned groups of 8 in the warp).
  nonzero |= __shfl_xor_sync(0xffffffffu, nonzero, 1);
  nonzero |= __shfl_xor_sync(0xffffffffu, nonzero, 2);
  nonzero |= __shfl_xor_sync(0xffffffffu, nonzero, 4);
  __syncwarp();

  const int scale = sg.scale;
  if (scale == 8) {
    // Column t over the rows, in place; then row t over the columns.
    uint32_t v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = s[k * 8 + t];
    const uint32_t dc = v[0] << 2;
    pass8(v, u(kXScaleCol), 10);
    const bool ac_zero = ((nonzero >> t) & 1u) == 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) s[k * 8 + t] = ac_zero ? dc : v[k];
    __syncwarp();
    const uint4 lo = reinterpret_cast<const uint4*>(s + t * 8)[0];
    const uint4 hi = reinterpret_cast<const uint4*>(s + t * 8)[1];
    uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    pass8(w, u(kXScaleRow), 17);
    if (live) {
      uint2 px;
      px.x = clamp_u8(w[0]) | clamp_u8(w[1]) << 8 | clamp_u8(w[2]) << 16
             | clamp_u8(w[3]) << 24;
      px.y = clamp_u8(w[4]) | clamp_u8(w[5]) << 8 | clamp_u8(w[6]) << 16
             | clamp_u8(w[7]) << 24;
      *reinterpret_cast<uint2*>(sg.out + blk * 64 + t * 8) = px;
    }
  } else if (scale == 4) {
    // Dugad-Ahuja 4x4: column t < 4 over rows 0-3, then row t < 4.
    if (t < 4) {
      const uint32_t s0 = s[t], s1 = s[8 + t], s2 = s[16 + t], s3 = s[24 + t];
      const uint32_t x0 = (s0 + s2) << 2;
      const uint32_t x2 = (s0 - s2) << 2;
      const uint32_t p1 = (s1 + s3) * u(kC0_541);
      const uint32_t t0 = sar(p1 + s3 * u(kCM1_847) + u(kRound4), 10);
      const uint32_t t2 = sar(p1 + s1 * u(kC0_765) + u(kRound4), 10);
      s[t] = x0 + t2;
      s[8 + t] = x2 + t0;
      s[16 + t] = x2 - t0;
      s[24 + t] = x0 - t2;
    }
    __syncwarp();
    if (t < 4 && live) {
      const uint32_t s0 = s[t * 8], s1 = s[t * 8 + 1], s2 = s[t * 8 + 2],
                     s3 = s[t * 8 + 3];
      const uint32_t x0 = ((s0 + s2) << 12) + u(kBias4);
      const uint32_t x2 = ((s0 - s2) << 12) + u(kBias4);
      const uint32_t p1 = (s1 + s3) * u(kC0_541);
      const uint32_t t0 = p1 + s3 * u(kCM1_847);
      const uint32_t t2 = p1 + s1 * u(kC0_765);
      uint8_t* o = sg.out + blk * 16 + t * 4;
      o[0] = static_cast<uint8_t>(clamp_u8(sar(x0 + t2, 17)));
      o[1] = static_cast<uint8_t>(clamp_u8(sar(x2 + t0, 17)));
      o[2] = static_cast<uint8_t>(clamp_u8(sar(x2 - t0, 17)));
      o[3] = static_cast<uint8_t>(clamp_u8(sar(x0 - t2, 17)));
    }
  } else if (scale == 2) {
    if (t == 0 && live) {
      const uint32_t x0 = s[0] + s[8] + u(kBias2);
      const uint32_t x2 = s[0] - s[8] + u(kBias2);
      const uint32_t x1 = s[1] + s[9];
      const uint32_t x3 = s[1] - s[9];
      uint8_t* o = sg.out + blk * 4;
      o[0] = static_cast<uint8_t>(clamp_u8(sar(x0 + x1, 3)));
      o[1] = static_cast<uint8_t>(clamp_u8(sar(x0 - x1, 3)));
      o[2] = static_cast<uint8_t>(clamp_u8(sar(x2 + x3, 3)));
      o[3] = static_cast<uint8_t>(clamp_u8(sar(x2 - x3, 3)));
    }
  } else if (t == 0 && live) {
    // Division by 8 truncating toward zero, as -((-v) >> 3) for v < 0.
    const uint32_t v = s[0] + u(kDc1);
    const uint32_t q = static_cast<int32_t>(v) >= 0 ? sar(v, 3)
                                                    : 0u - sar(0u - v, 3);
    sg.out[blk] = static_cast<uint8_t>(clamp_u8(q));
  }
}

}  // namespace

// One launch for `nseg` segments (1..64): per segment its int16 [n, 64]
// coefficients (16-byte aligned), int32 [64] table, uint8 [n, scale^2]
// output (8-byte aligned at scale 8), block count n and scale. Runs on
// `stream`, allocates nothing, returns cudaGetLastError().
extern "C" int jdt_idct_exact(const void* const* coefs,
                              const void* const* qts, void* const* outs,
                              const int* n_blocks, const int* scales,
                              int nseg, void* stream) {
  if (nseg < 1 || nseg > kMaxSegs)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a = {};
  a.nseg = nseg;
  int64_t ctas = 0;
  for (int i = 0; i < nseg; ++i) {
    const int s = scales[i];
    if ((s != 1 && s != 2 && s != 4 && s != 8) || n_blocks[i] < 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if ((reinterpret_cast<uintptr_t>(coefs[i]) & 15)
        || (reinterpret_cast<uintptr_t>(qts[i]) & 3)
        || (s == 8 && (reinterpret_cast<uintptr_t>(outs[i]) & 7)))
      return static_cast<int>(cudaErrorMisalignedAddress);
    a.seg[i] = {static_cast<const int16_t*>(coefs[i]),
                static_cast<const int32_t*>(qts[i]),
                static_cast<uint8_t*>(outs[i]), n_blocks[i], s,
                static_cast<int>(ctas)};
    ctas += (n_blocks[i] + kBlocks - 1) / kBlocks;
  }
  if (ctas == 0) return 0;
  if (ctas > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  idct_exact_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
