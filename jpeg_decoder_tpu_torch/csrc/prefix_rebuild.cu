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
//   sign-extended for z in 1..15, and 0 for z in 16..63, stored at the
//   natural position of zigzag slot z; then every residual adds
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
//   takes one tile of kRows = 128 blocks (630 CTAs at large_420, fewer
//   than the card holds at once, so the whole pass is one wave).
// - The tile's 1,920 AC bytes and 256 DC bytes come into shared memory by
//   16-byte cp.async copies (element by element for a ragged last tile or
//   an array off its 16-byte boundary; no pointer into a 15-byte AC row is
//   ever cast to a vector type), in flight while the CTA zeroes its staged
//   rows.
// - The tile's stores are built in shared memory, then stored as 16-byte
//   vectors of whole 128-byte rows, a quarter warp a row. A thread owns
//   one zigzag slot z < 16 (its natural position read once from
//   __constant__ memory) and writes it in every sixteenth row: one 2-byte
//   store a value, no lookup per coefficient. The other 48 slots of every
//   row (all of pieces 5-7, most of 0-4) stay as zeroed.
// - The residual pass (prefix_resid_kernel), in a second launch: a thread
//   an entry. CUDA has no 16-bit atomicAdd, so the add goes into the
//   aligned 32-bit word that holds the element: a high half adds v << 16
//   (its carry leaves the word); a low half adds v, and where that carried
//   into the high half (seen in the old word the add returns) a second add
//   of 0xffff0000 takes the carry back. Every add is exact mod 2^32, so
//   the word ends right in whatever order the adds land.
// - Ordering: the residuals are not sorted by block, so a residual may hit
//   a tile that another CTA writes. The two launches in stream order keep
//   every base store before every residual add. One cooperative launch
//   with a grid barrier between the passes would order them too; on an
//   H100 it took longer, its barrier over the CTAs of a whole image
//   costing more than the second launch (tools/experiments/
//   p1d1_breakdown.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;                  // blocks of a tile
constexpr int kAc = 15;                     // AC slots a block: zigzag 1..15
constexpr int kPrefix = kAc + 1;            // PREFIX_K of host/staging.py
constexpr int kPieces = 8;                  // 16-byte vectors of a row
constexpr int kTileAc = kRows * kAc;        // AC bytes of a tile
static_assert(kTileAc % 16 == 0, "tiles start on 16-byte boundaries");
static_assert(kTileAc / 16 <= kThreads, "one 16-byte copy a thread");
static_assert(kRows <= kThreads, "one DC value a thread");
static_assert(kThreads % kPrefix == 0, "a thread a slot of a row");

// The natural position of zigzag slot z < kPrefix (host/staging.py
// `_ZIGZAG_OF_NATURAL`, inverted).
__constant__ unsigned char kNaturalOfZigzag[kPrefix] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5};

struct Args {
  const int16_t* dc;       // [blocks]
  const signed char* ac;   // [blocks, 15]
  const int* idx;          // [n]
  const int16_t* vals;     // [n]
  uint4* out;              // [blocks, 8]
  long long blocks, n;
  int ac_vec, dc_vec;      // the array on a 16-byte boundary
};

struct Smem {
  alignas(16) signed char ac[kTileAc];
  alignas(16) int16_t dc[kRows];
  alignas(16) int16_t rows[kRows * 64];   // the tile's stores
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts bringing tile t's AC and DC values into shared memory: 16-byte
// cp.async copies where the tile is whole and its array on a 16-byte
// boundary, else element by element.
__device__ __forceinline__ void load_tile(const Args& a, long long t,
                                          int cnt, Smem& sm, int tid) {
  const signed char* ac = a.ac + t * kTileAc;
  const int16_t* dc = a.dc + t * kRows;
  if (a.ac_vec && cnt == kRows) {
    if (tid < kTileAc / 16) cp_async16(sm.ac + tid * 16, ac + tid * 16);
  } else {
    for (int i = tid; i < cnt * kAc; i += kThreads) sm.ac[i] = ac[i];
  }
  if (a.dc_vec && cnt == kRows) {
    if (tid < kRows * 2 / 16) cp_async16(sm.dc + tid * 8, dc + tid * 8);
  } else if (tid < cnt) {
    sm.dc[tid] = dc[tid];
  }
}

// out[k] += v in int16, `.at[].add(mode="drop")`'s reading of k against
// total = blocks * 64, by 32-bit adds on the word that holds it.
__device__ __forceinline__ void add_residual(unsigned* words, long long k,
                                             int v, long long total) {
  if (k < 0) k += total;
  if (k < 0 || k >= total) return;
  const uint32_t add = static_cast<uint16_t>(v);
  if (add == 0) return;
  unsigned* word = words + (k >> 1);
  if (k & 1) {
    atomicAdd(word, add << 16);
    return;
  }
  const unsigned old = atomicAdd(word, add);
  if ((old & 0xffffu) + add > 0xffffu) atomicAdd(word, 0xffff0000u);
}

__global__ void __launch_bounds__(kThreads)
prefix_base_kernel(const __grid_constant__ Args a) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const long long t = blockIdx.x;
  const long long left = a.blocks - t * kRows;
  const int cnt = left < kRows ? static_cast<int>(left) : kRows;
  load_tile(a, t, cnt, sm, tid);
  uint4* rows = reinterpret_cast<uint4*>(sm.rows);
  for (int q = tid; q < kRows * kPieces; q += kThreads)
    rows[q] = make_uint4(0u, 0u, 0u, 0u);
  const int z = tid % kPrefix;
  const int natural = kNaturalOfZigzag[z];
  cp_async_wait_all();
  __syncthreads();
  // Not unrolled: unrolled, the pass took ~0.3 us longer on an H100
  // (tools/experiments/p1d1_breakdown.py).
#pragma unroll 1
  for (int row = tid / kPrefix; row < cnt; row += kThreads / kPrefix)
    sm.rows[row * 64 + natural] = z == 0 ? sm.dc[row]
                                         : sm.ac[row * kAc + z - 1];
  __syncthreads();
  uint4* out = a.out + t * kRows * kPieces;
  for (int q = tid; q < cnt * kPieces; q += kThreads)
    __stwb(out + q, rows[q]);
}

__global__ void __launch_bounds__(kThreads)
prefix_resid_kernel(const __grid_constant__ Args a) {
  const long long i = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  if (i < a.n)
    add_residual(reinterpret_cast<unsigned*>(a.out), a.idx[i], a.vals[i],
                 a.blocks * 64);
}

}  // namespace

// The rebuild of `blocks` blocks (an image's or a group's, flattened) from
// dc int16 [blocks] and ac int8 [blocks, 15], then out[idx[i]] += vals[i]
// (int16, wrapping) for each of the n residual entries, with `.at[].add(
// mode="drop")`'s reading of an index against total = blocks * 64.
// idx int32 [n], vals int16 [n]; out int16 [blocks, 64] on a 16-byte
// boundary. The residual pass is launched only where there are
// residuals.
extern "C" int jdt_prefix_rebuild(const void* dc, const void* ac,
                                  long long blocks, const void* idx,
                                  const void* vals, long long n, void* out,
                                  void* stream) {
  if (blocks < 0 || blocks * 64 >= (1LL << 31) || n < 0 || n >= (1LL << 31)
      || (blocks > 0 && (dc == nullptr || ac == nullptr || out == nullptr))
      || (n > 0 && (idx == nullptr || vals == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(out) & 15)
      || (reinterpret_cast<uintptr_t>(dc) & 1)
      || (reinterpret_cast<uintptr_t>(idx) & 3)
      || (reinterpret_cast<uintptr_t>(vals) & 1))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (blocks == 0) return 0;
  Args a = {};
  a.dc = static_cast<const int16_t*>(dc);
  a.ac = static_cast<const signed char*>(ac);
  a.idx = static_cast<const int*>(idx);
  a.vals = static_cast<const int16_t*>(vals);
  a.out = static_cast<uint4*>(out);
  a.blocks = blocks;
  a.n = n;
  a.ac_vec = (reinterpret_cast<uintptr_t>(ac) & 15) == 0;
  a.dc_vec = (reinterpret_cast<uintptr_t>(dc) & 15) == 0;
  const long long tiles = (blocks + kRows - 1) / kRows;
  prefix_base_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  const cudaError_t base = cudaGetLastError();
  if (base != cudaSuccess || n == 0) return static_cast<int>(base);
  const unsigned resid_ctas =
      static_cast<unsigned>((n + kThreads - 1) / kThreads);
  prefix_resid_kernel<<<resid_ctas, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
