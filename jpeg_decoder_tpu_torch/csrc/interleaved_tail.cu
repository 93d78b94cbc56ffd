// T1: the interleaved tail. Block pixels of every component -> the decoded
// image (chroma upsampling + color conversion, the block -> plane layout
// folded into the loads), for one image, a group of images of one geometry
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
// What bounds it on this card: memory, on paper. At large_420 it reads
// 5.16 MB of block pixels and writes 10.32 MB of RGB, 4.62 us at 3.35
// TB/s, with ~40 integer operations a pixel. The first design (a thread
// per 4 pixels of a row, up to 9 single-byte taps a pixel read in block
// layout, bytes stored 3 apart) took 49.5 us: a warp's taps of one row
// fell on 16 blocks 64 B apart and its stores on ~12 sectors for 32 B, so
// load and store transactions bounded it. This design takes ~10.8 us
// there, and its parts add up rather than overlap: with every CTA of the
// launch resident at once, the plans and barriers take ~2.3 us, the loads
// ~1.9 more, the stores ~2.1 and the 4:2:0 filters and color ~4.4, which
// issue instructions, not bytes, bound (tools/experiments/t1_breakdown.py;
// PERF.md, PR 14).
//
// What the design does about it:
// - Tiles. A CTA of kThreads = 128 threads makes a tile of kTH = 32 output
//   rows by kTW = 128 columns of one image (blockIdx: x the column tile, y
//   the row band, z the image): two MCU rows of 4:2:0 at scale 8, four of
//   4:2:2 and 4:4:4. A thread makes kRun = 16 pixels of each of kRowsPer =
//   2 adjacent rows.
// - Loads into shared memory. Thread k < N first works out component k's
//   staged rows and columns (`tile_of`: the V1 rows of the band; V2's near
//   rows with the far row above and below, from the neighbouring block
//   rows or, on a stripe, the `top`/`bot` halo, the image row clamped to
//   [0, ih - 1] as before, and a stripe's padding rows' far row; generic's
//   rows; the columns widened to whole blocks, and for H2 by one block on
//   each side, the apron) and plans the copies as segments (`plan_rows`:
//   the rows of one block row, or one halo row). Warp w then copies the
//   segments numbered w mod 4 (`stage`). A block row's span in block
//   layout is contiguous, so at scales 8 and 4 with an s-aligned slab a
//   lane copies one row of one block (s bytes) by cp.async, consecutive
//   lanes on consecutive pieces (256 B of one span a warp instruction),
//   every copy of the tile in flight before one wait; scales 2 and 1 (a
//   block row of 4 or 1 bytes), a slab off an s-byte boundary (a group
//   sliced at an odd offset) and the halo rows take single-byte loads. The
//   staged rows are deblocked, at a pitch of kPitch = 144 bytes (16 mod
//   64): the 8-byte pieces of 16 lanes land on 16 different bank pairs,
//   and a row read in order is conflict-free.
// - Taps from shared memory. A full-resolution row is one 16-byte read per
//   thread; an H2 row one 8-byte read and its neighbours j0 - 1 and j0 + 8
//   as bytes; the V2 pair of an output row is its near and far staged rows,
//   staged once for every output row of the tile that reads them. For
//   YCbCr's chroma the filters take 128 off inside their shift, and the
//   clamp to [0, 255] is one __vimin_s32_relu. The edge rules (c = 0, c =
//   2 iw - 1, iw = 1) are tested only in a run that holds one of them.
// - Wide stores. Interleaved rows that lie wholly in the image and start
//   16-byte aligned leave through the warp's buffer: a quarter warp holds
//   one row's 8 runs (384 B at 3 channels) and writes them as contiguous
//   16-byte vectors, a full 128-byte line an instruction (a run's own three
//   16-byte stores would fall 48 bytes apart). Otherwise a run stores its
//   pixels as 16-byte vectors where it is whole and aligned (16 B per
//   channel for NONE, planar and gray are contiguous across a quarter warp
//   already), else as 4-byte words, else byte by byte (the ragged last run
//   of a row, an odd pitch).
// - Compile-time variants for the main path's geometries at scale 8: 4:2:0
//   (h1v1, h2v2, h2v2), 4:2:2 (h1v1, h2v1, h2v1) and 4:4:4 YCbCr, and gray,
//   each for the interleaved and the per-channel layouts. Every other case
//   (other scales, h1v2, generic, four components, CMYK, YCCK, RGB, NONE)
//   runs the same tiles with its modes, scales and transform read at run
//   time.
// - Limits: 64-bit image offsets; 1..65535 images on gridDim.z; at most
//   65535 row bands (2,097,120 rows). ptxas (nvcc 12.9, sm_90a): the 4:2:0,
//   4:2:2 and 4:4:4 variants 48-56 registers, gray 32, the run-time
//   variants 40-63; no spills; 17,364-23,520 bytes of shared memory a CTA
//   at three components (the staged rows 13,824, the plans 3,456, the
//   warps' line buffers 6,144 when interleaved), 23,152-31,344 at four.

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
constexpr int kTW = 128;         // output columns of a tile
constexpr int kTH = 32;          // output rows of a tile
constexpr int kRowsPer = 2;      // output rows of a thread
constexpr int kRun = 16;         // output columns of a thread
constexpr int kRunsX = kTW / kRun;
constexpr int kThreads = kRunsX * kTH / kRowsPer;
constexpr int kWarps = kThreads / 32;   // a power of two
constexpr int kApron = 16;       // staged column of a tile's first column
constexpr int kPitch = 144;      // bytes per staged row
constexpr int kCompMeta = 12;    // int64 values per component (entry below)

// ops/kernels.py T1_MODES and T1_TRANSFORMS
enum Mode { kH1V1 = 0, kH2V1 = 1, kH1V2 = 2, kH2V2 = 3, kGeneric = 4 };
enum Transform { kGray = 0, kNone = 1, kRGB = 2, kYCbCr = 3, kCMYK = 4,
                 kYCCK = 5 };
// Compile-time geometries at scale 8 (4:2:0, 4:2:2 and 4:4:4 YCbCr, gray);
// kAny reads the modes, scales and transform at run time.
enum Layout { kAny = 0, k420 = 1, k422 = 2, k444 = 3, kGrayOnly = 4 };

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
  int vec_rows;   // interleaved rows start 16-byte aligned in every image
};

// Where a tile lies: output rows r0 .. r0 + nr - 1 and columns c0 .. c0 +
// nc - 1 of image img.
struct Place {
  int img, r0, c0, nr, nc;
};

// The source rows and columns one component's tile stages: rows jlo ..
// jlo + n - 1 (plane rows; for V2 the local index j over [halo; plane;
// halo]) at staged rows 0 .. n - 1, and for V2 past the image's last row
// (a stripe's padding rows, whose far row is row ih - 1 however far their
// near rows lie) that row's index jx at staged row n (jx = -1: none);
// columns xs .. xe (whole blocks; for H2 one block more on each side, the
// apron), column x staged at kApron + x - x0.
struct Tile {
  int jlo, n, jx, x0, xs, xe;
};

template <int L>
__device__ __forceinline__ int mode_of(const Args& a, int k) {
  if constexpr (L == k420) return k == 0 ? kH1V1 : kH2V2;
  else if constexpr (L == k422) return k == 0 ? kH1V1 : kH2V1;
  else if constexpr (L == k444 || L == kGrayOnly) return kH1V1;
  else return a.c[k].mode;
}

template <int L>
__device__ __forceinline__ int log2s_of(const Comp& cp) {
  if constexpr (L == kAny) return cp.log2s;
  else return 3;
}

__device__ __forceinline__ bool is_v2(int mode) {
  return mode == kH1V2 || mode == kH2V2;
}

__device__ __forceinline__ bool is_h2(int mode) {
  return mode == kH2V1 || mode == kH2V2;
}

// Image row i of a V2 component -> its local index j.
__device__ __forceinline__ int v2_index(const Comp& cp, int i) {
  const int lo = cp.top ? 0 : 1;
  const int hi = cp.bot ? cp.rows + 1 : cp.rows;
  return min(max(i - cp.base + 1, lo), hi);
}

__device__ __forceinline__ int generic_row(const Comp& cp, int g) {
  return min(max(g / cp.vs - cp.base, 0), cp.rows - 1);
}

__device__ __forceinline__ Tile tile_of(const Comp& cp, int mode, int l,
                                        int row0, const Place& p) {
  Tile t;
  t.jx = -1;
  const int g0 = row0 + p.r0, g1 = row0 + p.r0 + p.nr - 1;
  if (is_v2(mode)) {
    // near rows g / 2 and the rows one beyond them; a far row clamped to
    // ih - 1 below them is the extra row
    const int a = g0 >> 1, b = g1 >> 1;
    t.jlo = v2_index(cp, max(a - 1, 0));
    t.n = v2_index(cp, b + 1) - t.jlo + 1;
    const int jx = v2_index(cp, cp.ih - 1);
    if (jx < t.jlo) t.jx = jx;
  } else if (mode == kGeneric) {
    t.jlo = generic_row(cp, g0);
    t.n = generic_row(cp, g1) - t.jlo + 1;
  } else {
    t.jlo = p.r0;
    t.n = p.nr;
  }
  int lo = p.c0, hi = p.c0 + p.nc - 1;
  if (is_h2(mode)) {
    lo >>= 1;
    hi >>= 1;
  } else if (mode == kGeneric) {
    lo /= cp.hs;
    hi /= cp.hs;
  }
  const int s = 1 << l;
  t.x0 = lo & -s;
  t.xs = t.x0;
  t.xe = hi | (s - 1);
  if (is_h2(mode)) {
    t.xs = max(t.xs - s, 0);
    t.xe = min(t.xe + s, (cp.bw << l) - 1);
  }
  return t;
}

__device__ __forceinline__ void cp_async(uint8_t* dst, const uint8_t* src,
                                         int l) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (l == 3)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// A run of source rows to stage: `nr` rows (ra .. ra + nr - 1 of a block
// row) of `nb` blocks from `src` (its first row's first piece), at staged
// offset `dst`; or (nr = 0) one linear row of `nb` bytes, a stripe's halo.
// `bytes`: single-byte loads (scales 2 and 1, a slab off an s-byte
// boundary, the halos), else one cp.async of s bytes a piece.
struct Seg {
  const uint8_t* src;
  int dst, nb, nr, l, bytes;
};

constexpr int kSegsPerComp = 36;   // block rows of 32 staged rows at s = 1,
                                   // the extra row, two halos

// The segments of local rows j0 .. j0 + n - 1 of one component (its block
// pixels at `base` and halo rows at `top` / `bot` in this image), columns
// xs .. xe, staged from row tr0 at column col, appended to `out`.
__device__ __forceinline__ int plan_rows(const Comp& cp, const uint8_t* base,
                                         const uint8_t* top,
                                         const uint8_t* bot, bool v2, int l,
                                         int xs, int xe, int col, int j0,
                                         int n, int tr0, int k, Seg* out,
                                         int m) {
  const int s = 1 << l;
  const int off = v2 ? 1 : 0;
  const int nb = (xe - xs + 1) >> l, bx0 = xs >> l;
  const int plo = max(j0 - off, 0);
  const int phi = min(j0 + n - 1 - off, cp.rows - 1);
  const int bytes = l < 2 || (reinterpret_cast<uintptr_t>(base) & (s - 1));
  const int comp = k * kTH * kPitch;
  for (int kb = plo >> l; kb <= (phi >> l); ++kb) {
    const int ktop = kb << l;
    const int ra = max(plo, ktop) - ktop;
    const int nr = min(phi, ktop + s - 1) - ktop - ra + 1;
    if (nr < 1) continue;
    Seg g;
    g.src = base + ((static_cast<long long>(kb) * cp.bw + bx0) << (2 * l))
          + (ra << l);
    g.dst = comp + (ktop + ra + off - j0 + tr0) * kPitch + col;
    g.nb = nb;
    g.nr = nr;
    g.l = l;
    g.bytes = bytes;
    out[m++] = g;
  }
  if (v2 && j0 == 0)
    out[m++] = Seg{top + xs, comp + tr0 * kPitch + col, xe - xs + 1, 0, 0, 1};
  if (v2 && j0 + n - 1 == cp.rows + 1)
    out[m++] = Seg{bot + xs, comp + (tr0 + n - 1) * kPitch + col,
                   xe - xs + 1, 0, 0, 1};
  return m;
}

// Copy every planned segment into the staged tiles at `sm`: warp w takes
// the segments whose number is w mod kWarps, its lanes consecutive
// pieces (s bytes of one row of one block, whole block rows in memory
// order) or bytes. Copies by cp.async are left in flight. Not inlined:
// inlined into the kernel, the build for sm_90a staged wrong rows and read
// out of bounds on the card (right at ptxas -O0, and on the host).
__device__ __noinline__ void stage(const Seg* segs, const int* counts,
                                   int ncomp, uint8_t* sm, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  int total = 0;
  for (int k = 0; k < ncomp; ++k) total += counts[k];
  for (int g = warp; g < total; g += kWarps) {
    int k = 0, j = g;
    while (j >= counts[k]) j -= counts[k++];
    const Seg sg = segs[k * kSegsPerComp + j];
    uint8_t* dst = sm + sg.dst;
    const int l = sg.l, s = 1 << l;
    if (sg.nr == 0) {   // a linear row
      for (int q = lane; q < sg.nb; q += 32) dst[q] = __ldg(sg.src + q);
    } else if (!sg.bytes) {
      // b = q / nr by a reciprocal, exact for q < 2^16 / nr
      const int inv = (65536 + sg.nr - 1) / sg.nr;
      const int np = sg.nb * sg.nr;
      for (int q = lane; q < np; q += 32) {
        const int b = (q * inv) >> 16, rr = q - b * sg.nr;
        cp_async(dst + rr * kPitch + (b << l),
                 sg.src + (b << (2 * l)) + (rr << l), l);
      }
    } else {
      const int inv = (65536 + sg.nr - 1) / sg.nr;
      const int nbytes = (sg.nb * sg.nr) << l;
      for (int q = lane; q < nbytes; q += 32) {
        const int rest = q >> l, x = q & (s - 1);
        const int b = (rest * inv) >> 16, rr = rest - b * sg.nr;
        dst[rr * kPitch + (b << l) + x] =
            __ldg(sg.src + (b << (2 * l)) + (rr << l) + x);
      }
    }
  }
}

__device__ __forceinline__ uint32_t byte_of(uint32_t w, int k) {
  return __byte_perm(w, 0, 0x4440 | k);
}

__device__ __forceinline__ int byte16(const uint32_t* w, int i) {
  return static_cast<int>(byte_of(w[i >> 2], i & 3));
}

// Four bytes (each 0 .. 255) in one word, a first.
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

__device__ __forceinline__ int fixed20(int32_t v) {
  // max(min(v >> 20, 255), 0): arithmetic shift, v may be negative
  return __vimin_s32_relu(v >> kFixed, 255);
}

// One component's samples for output columns c .. c + 15 of one row, less
// kBias (128 for YCbCr's chroma, else 0): `rn` / `rf` the staged near and
// far rows (the row itself off V2), each indexed by the source column.
// at<E>(i) is pixel i's; E: the run holds one of the H2 edges (c = 0,
// c = 2 iw - 1, iw = 1).
template <int M, int kBias>
struct Samples {
  uint32_t w[4];   // h1v1, h1v2, generic: the 16 samples
  // j0 - 1 .. j0 + 8: h2v2 t = 3 near + far, kept as t - (4 kBias - 2) so
  // that (3 t + t(j -/+ 1) + 8) >> 4 less kBias is (3 u + u(j -/+ 1)) >> 4
  // and (t + 2) >> 2 less kBias is u >> 2; h2v1 the row less kBias
  int u[10];
  int c, last, iw1;

  __device__ __forceinline__ Samples(const Comp& cp, const uint8_t* rn,
                                     const uint8_t* rf, int c_)
      : c(c_), last(2 * cp.iw - 1), iw1(cp.iw == 1) {
    if constexpr (M == kH1V1) {
      const uint4 v = *reinterpret_cast<const uint4*>(rn + c);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else if constexpr (M == kH1V2) {
      const uint4 a = *reinterpret_cast<const uint4*>(rn + c);
      const uint4 b = *reinterpret_cast<const uint4*>(rf + c);
      const uint32_t na[4] = {a.x, a.y, a.z, a.w};
      const uint32_t fb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        int v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = (3 * static_cast<int>(byte_of(na[g], k))
                  + static_cast<int>(byte_of(fb[g], k)) + 2) >> 2;
        w[g] = pack4(v[0], v[1], v[2], v[3]);
      }
    } else if constexpr (M == kH2V1 || M == kH2V2) {
      constexpr int kOff = M == kH2V2 ? 4 * kBias - 2 : kBias;
      const int j0 = c >> 1;
      const uint2 m = *reinterpret_cast<const uint2*>(rn + j0);
      u[0] = rn[j0 - 1];
      u[9] = rn[j0 + 8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        u[k + 1] = static_cast<int>(byte_of(k < 4 ? m.x : m.y, k & 3));
      if constexpr (M == kH2V2) {
        const uint2 f = *reinterpret_cast<const uint2*>(rf + j0);
        u[0] = 3 * u[0] + rf[j0 - 1];
        u[9] = 3 * u[9] + rf[j0 + 8];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          u[k + 1] = 3 * u[k + 1]
                   + static_cast<int>(byte_of(k < 4 ? f.x : f.y, k & 3));
      }
#pragma unroll
      for (int k = 0; k < 10; ++k) u[k] -= kOff;
    } else {   // kGeneric: nearest neighbour, column c / hs
      int x = c / cp.hs, rem = c - x * cp.hs;
#pragma unroll
      for (int k = 0; k < 4; ++k) w[k] = 0;
#pragma unroll
      for (int i = 0; i < kRun; ++i) {
        w[i >> 2] |= static_cast<uint32_t>(rn[x]) << (8 * (i & 3));
        if (++rem == cp.hs) {
          rem = 0;
          ++x;
        }
      }
    }
  }

  // True when the H2 edges do not fall in this run.
  __device__ __forceinline__ bool interior() const {
    return c > 0 && c + kRun - 1 < last;
  }

  template <bool E>
  __device__ __forceinline__ int at(int i) const {
    if constexpr (M == kH2V1 || M == kH2V2) {
      const int jl = (i >> 1) + 1;
      const int nb = (i & 1) ? u[jl + 1] : u[jl - 1];
      if constexpr (E) {
        if (c + i == 0 || c + i == last || iw1)
          return M == kH2V2 ? u[jl] >> 2 : u[jl];
      }
      return M == kH2V2 ? (3 * u[jl] + nb) >> 4 : (3 * u[jl] + nb + 2) >> 2;
    } else {
      return byte16(w, i) - kBias;
    }
  }
};

// The staged near and far rows of component k for output row r (g = row0
// + r in the image), indexed by source column.
__device__ __forceinline__ void rows_of(const Comp& cp, int mode,
                                        const Tile& t, const uint8_t* sm,
                                        int g, int r, const uint8_t*& rn,
                                        const uint8_t*& rf) {
  int tn, tf;
  if (is_v2(mode)) {
    const int near = g >> 1;
    const int far = min(max((g & 1) ? near + 1 : near - 1, 0), cp.ih - 1);
    tn = v2_index(cp, near) - t.jlo;
    tf = v2_index(cp, far) - t.jlo;
    if (tf < 0) tf = t.n;   // the extra row
  } else {
    tn = tf = (mode == kGeneric ? generic_row(cp, g) : r) - t.jlo;
  }
  const uint8_t* col0 = sm + kApron - t.x0;
  rn = col0 + tn * kPitch;
  rf = col0 + tf * kPitch;
}

// Channels px[0 .. N - 1] of one pixel from its samples v.
template <int N>
__device__ __forceinline__ void convert(int transform, const int* v,
                                        int* px) {
  if constexpr (N >= 3) {
    if (transform == kYCbCr || transform == kYCCK) {
      const int32_t y = v[0] * (1 << kFixed) + kHalf;
      const int32_t cb = v[1] - 128;
      const int32_t cr = v[2] - 128;
      px[0] = fixed20(y + kC1_402 * cr);
      px[1] = fixed20(y - kC0_344 * cb - kC0_714 * cr);
      px[2] = fixed20(y + kC1_772 * cb);
      if constexpr (N == 4) px[3] = 255 - v[3];
      return;
    }
  }
  if (transform == kCMYK) {
#pragma unroll
    for (int k = 0; k < N; ++k) px[k] = 255 - v[k];
  } else {   // gray, NONE, RGB: the samples as they are
#pragma unroll
    for (int k = 0; k < N; ++k) px[k] = v[k];
  }
}

// YCbCr with compile-time modes (k420, k422, k444): 16 pixels into o,
// interleaved (P: word 3 g + m holds bytes 12 g + 4 m ..) or by channel
// (word 4 k + g holds channel k of pixels 4 g .. 4 g + 3).
template <int MC, bool E, bool P>
__device__ __forceinline__ void ycc_run(const Samples<kH1V1, 0>& y,
                                        const Samples<MC, 128>& cb,
                                        const Samples<MC, 128>& cr,
                                        uint32_t* o) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    int ch[3][4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = 4 * g + q;
      const int32_t yy = y.template at<false>(i) * (1 << kFixed) + kHalf;
      const int32_t b = cb.template at<E>(i);
      const int32_t r = cr.template at<E>(i);
      ch[0][q] = fixed20(yy + kC1_402 * r);
      ch[1][q] = fixed20(yy - kC0_344 * b - kC0_714 * r);
      ch[2][q] = fixed20(yy + kC1_772 * b);
    }
    if constexpr (P) {
      o[3 * g] = pack4(ch[0][0], ch[1][0], ch[2][0], ch[0][1]);
      o[3 * g + 1] = pack4(ch[1][1], ch[2][1], ch[0][2], ch[1][2]);
      o[3 * g + 2] = pack4(ch[2][2], ch[0][3], ch[1][3], ch[2][3]);
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        o[4 * k + g] = pack4(ch[k][0], ch[k][1], ch[k][2], ch[k][3]);
    }
  }
}

template <int L>
__device__ __forceinline__ void comp_any(const Args& a, int k,
                                         const uint8_t* rn, const uint8_t* rf,
                                         int c, uint32_t* w) {
  const Comp& cp = a.c[k];
  switch (mode_of<L>(a, k)) {
    case kH1V1: {
      const Samples<kH1V1, 0> s(cp, rn, rf, c);
#pragma unroll
      for (int m = 0; m < 4; ++m) w[m] = s.w[m];
      break;
    }
    case kH1V2: {
      const Samples<kH1V2, 0> s(cp, rn, rf, c);
#pragma unroll
      for (int m = 0; m < 4; ++m) w[m] = s.w[m];
      break;
    }
    case kGeneric: {
      const Samples<kGeneric, 0> s(cp, rn, rf, c);
#pragma unroll
      for (int m = 0; m < 4; ++m) w[m] = s.w[m];
      break;
    }
    case kH2V1: {
      const Samples<kH2V1, 0> s(cp, rn, rf, c);
#pragma unroll
      for (int g = 0; g < 4; ++g)
        w[g] = pack4(s.template at<true>(4 * g),
                     s.template at<true>(4 * g + 1),
                     s.template at<true>(4 * g + 2),
                     s.template at<true>(4 * g + 3));
      break;
    }
    default: {
      const Samples<kH2V2, 0> s(cp, rn, rf, c);
#pragma unroll
      for (int g = 0; g < 4; ++g)
        w[g] = pack4(s.template at<true>(4 * g),
                     s.template at<true>(4 * g + 1),
                     s.template at<true>(4 * g + 2),
                     s.template at<true>(4 * g + 3));
      break;
    }
  }
}

// Output row r, columns c .. c + 15 of image img: 16 pixels, interleaved
// (P: channel k at byte k of N) or by channel, from words o as ycc_run
// lays them out.
template <bool P, int N>
__device__ __forceinline__ void store_run(const Args& a, int img, int r,
                                          int c, const uint32_t* o) {
  uint8_t* out = a.out + img * a.out_stride;
  const bool whole = c + kRun <= a.out_w;
  if constexpr (P) {
    uint8_t* d = out + a.o[0].off + r * a.o[0].pitch
               + static_cast<long long>(c) * N;
    const uintptr_t at = reinterpret_cast<uintptr_t>(d);
    if (whole && at % 16 == 0) {
#pragma unroll
      for (int m = 0; m < N; ++m)
        reinterpret_cast<uint4*>(d)[m] =
            make_uint4(o[4 * m], o[4 * m + 1], o[4 * m + 2], o[4 * m + 3]);
    } else if (whole && at % 4 == 0) {
#pragma unroll
      for (int m = 0; m < 4 * N; ++m) reinterpret_cast<uint32_t*>(d)[m] = o[m];
    } else {
#pragma unroll
      for (int i = 0; i < kRun; ++i)
        if (c + i < a.out_w) {
#pragma unroll
          for (int k = 0; k < N; ++k)
            d[N * i + k] = static_cast<uint8_t>(byte16(o, N * i + k));
        }
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const Chan& ch = a.o[k];
      uint8_t* d = out + ch.off + r * ch.pitch + c * ch.col;
      const uintptr_t at = reinterpret_cast<uintptr_t>(d);
      if (whole && ch.col == 1 && at % 16 == 0) {
        *reinterpret_cast<uint4*>(d) =
            make_uint4(o[4 * k], o[4 * k + 1], o[4 * k + 2], o[4 * k + 3]);
      } else if (whole && ch.col == 1 && at % 4 == 0) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          reinterpret_cast<uint32_t*>(d)[m] = o[4 * k + m];
      } else {
#pragma unroll
        for (int i = 0; i < kRun; ++i)
          if (c + i < a.out_w)
            d[i * ch.col] = static_cast<uint8_t>(byte16(o, kRun * k + i));
      }
    }
  }
}

// One run of a staged tile: output row r, 16 columns from c, into o as
// ycc_run lays it out.
template <int L, bool P, int N>
__device__ __forceinline__ void run(const Args& a, const Tile* tl,
                                    const uint8_t* sm, int r, int c,
                                    uint32_t* o) {
  const int g = a.row0 + r;
  const uint8_t* rn[N];
  const uint8_t* rf[N];
#pragma unroll
  for (int k = 0; k < N; ++k)
    rows_of(a.c[k], mode_of<L>(a, k), tl[k], sm + k * kTH * kPitch, g, r,
            rn[k], rf[k]);
  if constexpr (L == kGrayOnly) {
    const Samples<kH1V1, 0> y(a.c[0], rn[0], rf[0], c);
#pragma unroll
    for (int m = 0; m < 4; ++m) o[m] = y.w[m];
  } else if constexpr (L == k420 || L == k422 || L == k444) {
    constexpr int MC = L == k420 ? kH2V2 : L == k422 ? kH2V1 : kH1V1;
    const Samples<kH1V1, 0> y(a.c[0], rn[0], rf[0], c);
    const Samples<MC, 128> cb(a.c[1], rn[1], rf[1], c);
    const Samples<MC, 128> cr(a.c[2], rn[2], rf[2], c);
    if (MC == kH1V1 || cb.interior())
      ycc_run<MC, false, P>(y, cb, cr, o);
    else
      ycc_run<MC, true, P>(y, cb, cr, o);
  } else {
    uint32_t w[N][4];
#pragma unroll
    for (int k = 0; k < N; ++k) comp_any<L>(a, k, rn[k], rf[k], c, w[k]);
#pragma unroll
    for (int m = 0; m < 4 * N; ++m) o[m] = 0;
#pragma unroll
    for (int i = 0; i < kRun; ++i) {
      int v[N], px[N];
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] = byte16(w[k], i);
      convert<N>(a.transform, v, px);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const int b = P ? N * i + k : kRun * k + i;
        o[b >> 2] |= static_cast<uint32_t>(px[k]) << (8 * (b & 3));
      }
    }
  }
}

// L: the geometry; P: the output is interleaved, channel k at byte k of N
// (else each channel stores apart); N: the components. A CTA makes one
// tile (blockIdx: x the column tile, y the row band, z the image): thread
// k < N works out component k's staged rows and columns and plans their
// copies, the CTA issues them, and each thread makes its 16 pixels once
// they have landed.
template <int L, bool P, int N>
__global__ void __launch_bounds__(kThreads)
interleaved_tail_kernel(const Args a) {
  __shared__ __align__(16) uint8_t smem[N][kTH * kPitch];
  __shared__ Tile tiles[N];
  __shared__ Seg segs[N * kSegsPerComp];
  __shared__ int counts[N];
  // Per warp, its rows' interleaved pixels on their way out.
  __shared__ __align__(16) uint8_t wbuf[P ? kWarps : 1][P ? 4 * kTW * N : 16];
  const int tid = threadIdx.x;
  Place p;
  p.img = blockIdx.z;
  p.r0 = blockIdx.y * kTH;
  p.c0 = blockIdx.x * kTW;
  p.nr = min(kTH, a.out_h - p.r0);
  p.nc = min(kTW, a.out_w - p.c0);
  if (tid < N) {
    const Comp& cp = a.c[tid];
    const int mode = mode_of<L>(a, tid), l = log2s_of<L>(cp);
    const Tile t = tile_of(cp, mode, l, a.row0, p);
    const long long img = p.img;
    const uint8_t* base = cp.px + img * cp.img_stride;
    const uint8_t* top = cp.top + img * cp.top_stride;
    const uint8_t* bot = cp.bot + img * cp.bot_stride;
    const int col = kApron + t.xs - t.x0;
    Seg* out = segs + tid * kSegsPerComp;
    int m = plan_rows(cp, base, top, bot, is_v2(mode), l, t.xs, t.xe, col,
                      t.jlo, t.n, 0, tid, out, 0);
    if (t.jx >= 0)
      m = plan_rows(cp, base, top, bot, is_v2(mode), l, t.xs, t.xe, col,
                    t.jx, 1, t.n, tid, out, m);
    tiles[tid] = t;
    counts[tid] = m;
  }
  __syncthreads();
  stage(segs, counts, N, smem[0], tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int r = p.r0 + kRowsPer * (tid / kRunsX);
  const int c = p.c0 + (tid % kRunsX) * kRun;
  // Interleaved rows wholly inside the image and 16-byte aligned leave by
  // way of the warp's buffer: a quarter warp holds one row's 8 runs (384 B
  // at N = 3) and writes it as contiguous 16-byte vectors, a full 128-byte
  // line an instruction, where the runs' own 16-byte stores would fall 48
  // bytes apart.
  const bool lines = P && a.vec_rows && p.nc == kTW;
#pragma unroll
  for (int h = 0; h < kRowsPer; ++h) {
    const bool live = r + h < a.out_h && c < a.out_w;
    uint32_t o[4 * N] = {};
    if (live) run<L, P, N>(a, tiles, smem[0], r + h, c, o);
    if (lines) {
      const int lane = tid & 31, quarter = lane >> 3;
      uint8_t* row = wbuf[tid >> 5] + quarter * kTW * N;
#pragma unroll
      for (int m = 0; m < N; ++m)
        reinterpret_cast<uint4*>(row + (lane & 7) * 16 * N)[m] =
            make_uint4(o[4 * m], o[4 * m + 1], o[4 * m + 2], o[4 * m + 3]);
      __syncwarp();
      if (live) {
        uint4* dst = reinterpret_cast<uint4*>(
            a.out + p.img * a.out_stride + a.o[0].off + (r + h) * a.o[0].pitch
            + static_cast<long long>(p.c0) * N);
#pragma unroll
        for (int m = 0; m < N; ++m)
          dst[8 * m + (lane & 7)] =
              reinterpret_cast<const uint4*>(row)[8 * m + (lane & 7)];
      }
      __syncwarp();
    } else if (live) {
      store_run<P, N>(a, p.img, r + h, c, o);
    }
  }
}

template <int L, bool P, int N>
void launch(const Args& a, dim3 grid, cudaStream_t stream) {
  interleaved_tail_kernel<L, P, N><<<grid, kThreads, 0, stream>>>(a);
}

template <bool P>
void launch_any(const Args& a, dim3 grid, cudaStream_t stream) {
  if (a.ncomp == 1) launch<kAny, P, 1>(a, grid, stream);
  else if (a.ncomp == 3) launch<kAny, P, 3>(a, grid, stream);
  else launch<kAny, P, 4>(a, grid, stream);
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
// transform: Transform (gray with 1 component, NONE with 3 or 4, RGB and
//   YCbCr with 3, CMYK and YCCK with 4); row0: the first output row's row
//   in the image.
extern "C" int jdt_interleaved_tail(const void* const* pixels,
                                    const void* const* halos,
                                    const long long* comp_meta, int ncomp,
                                    int transform, int out_h, int out_w,
                                    int row0, int images, void* out,
                                    const long long* out_meta, void* stream) {
  const bool paired = transform == kGray ? ncomp == 1
      : transform == kNone ? ncomp == 3 || ncomp == 4
      : transform == kRGB || transform == kYCbCr ? ncomp == 3
      : (transform == kCMYK || transform == kYCCK) && ncomp == 4;
  if (!paired || images < 1 || images > 65535 || out_h < 0 || out_w < 0
      || row0 < 0 || out == nullptr)
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
  const long long gy = (out_h + kTH - 1) / kTH;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((out_w + kTW - 1) / kTW, static_cast<unsigned>(gy),
                  static_cast<unsigned>(images));
  // Interleaved: channel k at byte k of ncomp, one row pitch.
  bool packed = true;
  for (int k = 0; k < ncomp; ++k)
    packed = packed && a.o[k].off == k && a.o[k].col == ncomp
             && a.o[k].pitch == a.o[0].pitch;
  const int m0 = a.c[0].mode, m1 = a.c[1].mode, m2 = a.c[2].mode;
  bool s8 = true;
  for (int k = 0; k < ncomp; ++k) s8 = s8 && a.c[k].log2s == 3;
  const bool ycc = s8 && ncomp == 3 && transform == kYCbCr && m0 == kH1V1
                   && m1 == m2;
  a.vec_rows = packed
      && (reinterpret_cast<uintptr_t>(a.out) + a.o[0].off) % 16 == 0
      && a.o[0].pitch % 16 == 0 && a.out_stride % 16 == 0;
  const auto st = static_cast<cudaStream_t>(stream);
  if (ycc && m1 == kH2V2)
    packed ? launch<k420, true, 3>(a, grid, st)
           : launch<k420, false, 3>(a, grid, st);
  else if (ycc && m1 == kH2V1)
    packed ? launch<k422, true, 3>(a, grid, st)
           : launch<k422, false, 3>(a, grid, st);
  else if (ycc && m1 == kH1V1)
    packed ? launch<k444, true, 3>(a, grid, st)
           : launch<k444, false, 3>(a, grid, st);
  else if (s8 && ncomp == 1 && m0 == kH1V1 && packed)
    launch<kGrayOnly, true, 1>(a, grid, st);
  else
    packed ? launch_any<true>(a, grid, st) : launch_any<false>(a, grid, st);
  return static_cast<int>(cudaGetLastError());
}
