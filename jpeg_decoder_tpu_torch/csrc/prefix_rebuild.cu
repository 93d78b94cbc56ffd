// P1: the prefix rebuild. The prefix interchange's staged wire (per block
// its DC, int16, and its zigzag AC slots 1..15, int8; then a list of
// residuals, each a flat coefficient index and an int16 value) -> the
// coefficient stores, int16 [blocks, 64] in natural order, for one image or
// a group of images of one geometry, in two launches, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package the rebuild is jnp code,
// jpeg_decoder_tpu/models/stream.py `_compiled_prefix_pipeline` (and
// `_compiled_prefix_pipeline_batched`), which XLA fuses with the
// reconstruction. Its plain version is jpeg_decoder_tpu_torch/entropy/
// prefix.py `prefix_stores_plain`, and the kernel is bit-equal to it:
//   coefficient z of a block is its DC for z = 0, its AC slot z - 1
//   sign-extended for z in 1..15, and 0 for z in 16..63, stored at natural
//   position n where kZigzagOfNatural[n] == z; then every residual adds
//   its value at its index, in int16 (mod 2^16): duplicates add, an index
//   in [-total, 0) counts from the end (index + total), any other index
//   outside [0, total) is dropped. That is `.at[idx].add(mode="drop")`.
//
// What bounds it on this card: bytes. At large_420 (80,640 blocks, a
// residual list of 44,032 entries) it reads 0.16 MB of DC, 1.21 MB of AC
// and 0.26 MB of residuals and writes 10.32 MB of stores: 3.6 us at
// 3.35 TB/s, with a few integer operations a coefficient.
//
// What the design does about it:
// - The base pass (prefix_base_kernel): a CTA of kThreads = 256 threads
//   takes a tile of kRows = 256 blocks. The tile's AC bytes (3,840, a
//   multiple of 16, so every tile starts on a 16-byte boundary when the
//   AC array does) come into shared memory as 240 16-byte loads, or byte by
//   byte for a ragged last tile or an unaligned array; no pointer into a
//   15-byte AC row is ever cast to a vector type. A thread owns one of the
//   eight 16-byte pieces of a 128-byte output row (natural positions
//   8p .. 8p + 7), looks up their zigzag slots once from __constant__
//   memory, and stores its piece of eight rows as whole 16-byte vectors:
//   a quarter warp writes a row's full line.
// - The residual pass (prefix_resid_kernel): a thread per entry. CUDA has
//   no 16-bit atomicAdd, so the add goes into the aligned 32-bit word that
//   holds the element by an atomicCAS loop that changes only that half:
//   adding v << 16 would wrap right for the high half, but a carry out of
//   the low half would reach the high one.
// - Ordering: the residuals are not sorted by block, so a residual may hit
//   a block that another CTA has not written yet. The two passes are two
//   launches in stream order; nothing depends on the order in which CTAs
//   run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;                  // blocks of a base tile
constexpr int kAc = 15;                     // AC slots a block: zigzag 1..15
constexpr int kPrefix = kAc + 1;            // PREFIX_K of host/staging.py
constexpr int kPieces = 8;                  // 16-byte vectors of a row
constexpr int kRowsPerPass = kThreads / kPieces;
constexpr int kPasses = kRows / kRowsPerPass;
constexpr int kTileAc = kRows * kAc;        // AC bytes of a tile
static_assert(kTileAc % 16 == 0, "tiles start on 16-byte boundaries");
static_assert(kTileAc / 16 <= kThreads, "one 16-byte load a thread");

// The zigzag index of natural position n (host/staging.py
// `_ZIGZAG_OF_NATURAL`).
__constant__ unsigned char kZigzagOfNatural[64] = {
    0,  1,  5,  6,  14, 15, 27, 28, 2,  4,  7,  13, 16, 26, 29, 42,
    3,  8,  12, 17, 25, 30, 41, 43, 9,  11, 18, 24, 31, 40, 44, 53,
    10, 19, 23, 32, 39, 45, 52, 54, 20, 22, 33, 38, 46, 51, 55, 60,
    21, 34, 37, 47, 50, 56, 59, 61, 35, 36, 48, 49, 57, 58, 62, 63};

struct Smem {
  alignas(16) signed char ac[kTileAc];
  int16_t dc[kRows];
};

__global__ void __launch_bounds__(kThreads)
prefix_base_kernel(const int16_t* __restrict__ dc,
                   const signed char* __restrict__ ac, uint4* out,
                   long long blocks, int ac_aligned) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const long long b0 = static_cast<long long>(blockIdx.x) * kRows;
  const int cnt = blocks - b0 < kRows ? static_cast<int>(blocks - b0)
                                      : kRows;
  const signed char* src = ac + b0 * kAc;
  if (ac_aligned && cnt == kRows) {
    if (tid < kTileAc / 16)
      reinterpret_cast<uint4*>(sm.ac)[tid] =
          reinterpret_cast<const uint4*>(src)[tid];
  } else {
    for (int i = tid; i < cnt * kAc; i += kThreads) sm.ac[i] = src[i];
  }
  if (tid < cnt) sm.dc[tid] = dc[b0 + tid];
  __syncthreads();

  const int piece = tid & (kPieces - 1);
  int zz[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) zz[k] = kZigzagOfNatural[piece * 8 + k];
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const int row = pass * kRowsPerPass + (tid >> 3);
    if (row >= cnt) continue;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int z = zz[k];
      const int v = z == 0 ? sm.dc[row]
                    : z < kPrefix ? sm.ac[row * kAc + z - 1] : 0;
      w[k >> 1] |= (static_cast<uint32_t>(v) & 0xffffu) << ((k & 1) * 16);
    }
    out[(b0 + row) * kPieces + piece] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

__global__ void __launch_bounds__(kThreads)
prefix_resid_kernel(const int* __restrict__ idx,
                    const int16_t* __restrict__ vals, long long n,
                    unsigned* words, long long total) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i >= n) return;
  long long k = idx[i];
  if (k < 0) k += total;
  if (k < 0 || k >= total) return;
  const uint32_t v = static_cast<uint16_t>(vals[i]);
  if (v == 0) return;
  unsigned* word = words + (k >> 1);
  const int shift = static_cast<int>(k & 1) * 16;
  const uint32_t mask = 0xffffu << shift;
  unsigned old = *word;
  unsigned assumed;
  do {
    assumed = old;
    const uint32_t half = ((assumed >> shift) + v) & 0xffffu;
    old = atomicCAS(word, assumed, (assumed & ~mask) | (half << shift));
  } while (old != assumed);
}

}  // namespace

// The base pass: out[b, :] for every block b of `blocks` (an image's or a
// group's, flattened), from dc int16 [blocks] and ac int8 [blocks, 15].
// out: int16 [blocks, 64], on a 16-byte boundary.
extern "C" int jdt_prefix_base(const void* dc, const void* ac,
                               long long blocks, void* out, void* stream) {
  if (blocks < 0 || blocks * 64 >= (1LL << 31)
      || (blocks > 0 && (dc == nullptr || ac == nullptr || out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(out) & 15)
      || (reinterpret_cast<uintptr_t>(dc) & 1))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (blocks == 0) return 0;
  const long long tiles = (blocks + kRows - 1) / kRows;
  prefix_base_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(dc), static_cast<const signed char*>(ac),
      static_cast<uint4*>(out), blocks,
      (reinterpret_cast<uintptr_t>(ac) & 15) == 0);
  return static_cast<int>(cudaGetLastError());
}

// The residual pass, after the base pass on the same stream: out[idx[i]] +=
// vals[i] (int16, wrapping) for each of the n entries, with `.at[].add(
// mode="drop")`'s reading of the index against `total` = blocks * 64.
// idx int32 [n], vals int16 [n]; out on a 4-byte boundary.
extern "C" int jdt_prefix_resid(const void* idx, const void* vals,
                                long long n, void* out, long long total,
                                void* stream) {
  if (n < 0 || total < 0 || total >= (1LL << 31) || total % 64
      || (n > 0 && (idx == nullptr || vals == nullptr || out == nullptr))
      || n >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(out) & 3)
      || (reinterpret_cast<uintptr_t>(idx) & 3)
      || (reinterpret_cast<uintptr_t>(vals) & 1))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n == 0 || total == 0) return 0;
  const long long grid = (n + kThreads - 1) / kThreads;
  prefix_resid_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const int16_t*>(vals), n,
      static_cast<unsigned*>(out), total);
  return static_cast<int>(cudaGetLastError());
}
