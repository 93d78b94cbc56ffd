// A1: the assembly. Stream-order natural coefficient blocks (the output of
// K1, DC columns holding wrap16 differences) -> one int16 store per scan
// component in raster block order, with the DC prefix sums taken, for one
// image, a group of images of one plan or one stripe, in one launch, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package the assembly is jnp code,
// jpeg_decoder_tpu/entropy/device_scan.py `build_assembler_nat` (with
// `_dc_carry` for a stripe), which XLA compiles inside the bits sweep. Its
// plain version is jpeg_decoder_tpu_torch/entropy/assemble.py
// `assemble_nat_plain` (`assemble_structured`, `assemble_general`), and
// the kernel is bit-equal to it. Per scan component c and image n, over the
// component's blocks j = 0 .. n_c - 1 in stream order:
//   row(j)  the stream block: (j / bpm) * plen + slot0 + j % bpm (the
//           closed form of `plan.structured`), or stream_idx[j] (general);
//   dst(j)  the raster block: ((j / bpm) / cols_d * vs + (j % bpm) / hs) * W
//           + (j / bpm) % cols_d * hs + (j % bpm) % hs, or raster_of[j]
//           (general: the inverse of raster_src; -1 where no raster block
//           takes j);
//   reset(j) j > 0 and a restart segment starts at j: j % seg_blocks == 0
//           (seg_blocks > 0), or seg_first[j] == j (general);
//   dc(j)   the sum of nat[row(i)][0] over i from the last reset at or
//           before j (else from 0, plus the carry where the component takes
//           one) to j, mod 2^16;
//   store[dst(j)] = nat[row(j)] with element 0 replaced by dc(j), and every
//   raster block no j reaches (the grid's padding past the decoded MCUs)
//   zero. Sums run in uint32_t, where wrapping is defined; only their low
//   16 bits are kept, which is the reference's int32 sum narrowed to int16.
//
// What bounds it on this card: bytes. At large_420 it reads 10.32 MB of
// nat and writes 10.32 MB of stores, 6.16 us at 3.35 TB/s, with a few
// integer operations a block.
//
// What the design does about it:
// - Tiles. A CTA of kThreads = 256 threads takes a tile of kRows = 256
//   consecutive blocks of one (image, component) sequence, or kRows padding
//   rows. A quarter warp moves one 128-byte row as eight 16-byte vectors, at
//   both ends (load and store) a whole line; a thread holds its kPasses = 8
//   vectors in registers from the load to the store.
// - The DC prefix across CTAs, in one launch: decoupled look-back. A CTA's
//   tile is the next ticket of a counter (atomicAdd), not blockIdx, so
//   every tile's predecessors in its sequence have started. The CTA scans
//   its tile's DC (a segmented scan: warp shuffles, then the 8 warps'
//   aggregates), publishes its aggregate (flag A) or, when it knows it, its
//   inclusive prefix (flag P: the first tile of a sequence, or a tile with a
//   reset inside), then warp 0 reads the statuses of up to 32 predecessors
//   at a time, adds the aggregates back to the nearest P, and the CTA
//   publishes its own P. A status word is (epoch << 32 | flag << 16 | the
//   16-bit value), stored with release and read with acquire semantics: the
//   wrapper passes a new epoch for every launch, so a word left by an
//   earlier launch never reads as valid and the buffer needs no clearing
//   between launches. The last CTA to take a ticket sets the counter back
//   to 0 for the next launch on the stream.
// - The epoch on the card, for a launch captured in a CUDA graph (whose
//   replays would repeat a baked-in host epoch): the wrapper passes epoch
//   0, and word 0 of the buffer holds the epoch in its high 32 bits and
//   the ticket counter in its low 32. A CTA's 64-bit atomicAdd of 1
//   returns its ticket and the launch's epoch together; the CTA that takes
//   the last ticket stores the next epoch (mod 2^32) with the counter 0 in
//   one atomic. Such a buffer serves one launch site of one graph, the same
//   tiles at every replay, every data tile publishes, so a word a launch
//   reads holds this launch's epoch or the last one's
//   (`_build.DeviceEpochs`): the wrap needs no clearing.
// - The carry of a stripe (the DC sum of every earlier stripe) is the
//   initial prefix of a sequence whose component takes one; only its low
//   16 bits matter.
// - Padding rows are tiles of their own after every data tile: they store
//   zeros and take no part in the scan.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 256;                  // blocks of a tile
constexpr int kPieces = 8;                  // 16-byte vectors of a block
constexpr int kRowsPerPass = kThreads / kPieces;
constexpr int kPasses = kRows / kRowsPerPass;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxComp = 4;                 // components of one scan
constexpr int kCompMeta = 14;               // int64 fields a component
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kFlagA = 1ull << 16;   // aggregate
constexpr unsigned long long kFlagP = 2ull << 16;   // inclusive prefix
static_assert(kRows == kThreads, "a thread scans the DC of one row");

struct Comp {
  uint4* out;              // image 0's store, [rows, 64] int16
  const int* stream_idx;   // general: [n_c] stream block of j
  const int* raster_of;    // general: [n_c] raster block of j, or -1
  const int* seg_first;    // general: [n_c] first j of j's segment
  const int* pad_rows;     // general: [npad] the raster blocks no j takes
  long long rows;          // raster blocks of one image's store
  long long data_tiles;    // tiles of one image's sequence
  long long pad_tiles;
  int n_c, npad, takes_carry, seg_blocks;
  int plen, slot0, bpm, vs, hs, w, cols_d, r_rows, c_cols;
};

struct Args {
  const uint4* nat;        // [images, n_blocks, 64] int16
  long long n_blocks;
  long long data_per_image, pad_per_image;
  long long data_tiles;    // images * data_per_image: the first tickets
  long long total_tiles;
  const long long* carry;  // carry[c * carry_sc + n * carry_sn], or null
  long long carry_sc, carry_sn;
  unsigned long long* status;   // [data_tiles] status words
  unsigned long long* word0;    // the ticket counter (low half), 0 between
                                // launches; the epoch (high half) when
                                // host_epoch is 0
  unsigned long long host_epoch;  // this launch's epoch, or 0
  int general;
  Comp c[kMaxComp];
};

struct Smem {
  long long ticket;
  unsigned long long epoch;     // this launch's epoch << 32
  uint32_t dc[kRows];           // the rows' DC, then their prefix sums
  uint32_t warp_val[kWarps];
  uint32_t warp_flag[kWarps];
  uint32_t agg_val, agg_flag, excl;
};

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// The raster block of padding row i of a structured component: first the
// columns right of the decoded grid in its rows, then the rows below it.
__device__ __forceinline__ int pad_row(const Comp& cp, int general, int i) {
  if (general) return cp.pad_rows[i];
  const int wd = cp.w - cp.c_cols;
  const int right = cp.r_rows * wd;
  if (i < right) return i / wd * cp.w + cp.c_cols + i % wd;
  return cp.r_rows * cp.w + (i - right);
}

// The exclusive prefix, mod 2^16, of tile `k + 1` of a sequence whose first
// tile is `first`: warp 0 reads the statuses of tiles k, k - 1, ... k - 31
// (a lane each, waiting for its tile to publish), adds the aggregates up to
// the nearest inclusive prefix, and moves 32 tiles back while there is
// none. The first tile of a sequence always publishes a prefix.
__device__ __forceinline__ uint32_t look_back(
    const unsigned long long* status, long long k, long long first,
    unsigned long long epoch, int lane) {
  uint32_t sum = 0;
  for (;;) {
    const long long idx = k - lane;
    uint32_t v = 0;
    bool p = true;
    if (idx >= first) {
      unsigned long long s = load_acquire(status + idx);
      while ((s & 0xffffffff00000000ull) != epoch
             || !(s & (kFlagA | kFlagP))) {
        __nanosleep(32);
        s = load_acquire(status + idx);
      }
      v = static_cast<uint32_t>(s & 0xffffu);
      p = (s & kFlagP) != 0;
    }
    const unsigned pm = __ballot_sync(kFull, p);
    const int stop = pm ? __ffs(pm) - 1 : 31;
    uint32_t mine = lane <= stop ? v : 0u;
    for (int o = 16; o > 0; o >>= 1) mine += __shfl_xor_sync(kFull, mine, o);
    sum += mine;
    if (pm) return sum & 0xffffu;
    k -= 32;
  }
}

__global__ void __launch_bounds__(kThreads, 3)
assemble_kernel(const __grid_constant__ Args a) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int piece = tid & (kPieces - 1);
  if (tid == 0) {
    const unsigned long long w = atomicAdd(a.word0, 1ull);
    const unsigned t = static_cast<unsigned>(w);
    const unsigned long long e = a.host_epoch ? a.host_epoch : w >> 32;
    if (t == a.total_tiles - 1)
      atomicExch(a.word0, a.host_epoch ? 0ull : ((e + 1) & 0xffffffffull)
                                                    << 32);
    sm.ticket = t;
    sm.epoch = e << 32;
  }
  __syncthreads();
  const long long ticket = sm.ticket;
  const unsigned long long epoch = sm.epoch;

  if (ticket >= a.data_tiles) {               // a tile of padding rows
    long long p = ticket - a.data_tiles;
    const long long n = p / a.pad_per_image;
    p -= n * a.pad_per_image;
    int c = 0;
    while (p >= a.c[c].pad_tiles) p -= a.c[c].pad_tiles, ++c;
    const Comp& cp = a.c[c];
    uint4* out = cp.out + n * cp.rows * kPieces;
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int pass = 0; pass < kPasses; ++pass) {
      const int i = static_cast<int>(p) * kRows + pass * kRowsPerPass
                    + (tid >> 3);
      if (i < cp.npad)
        out[static_cast<long long>(pad_row(cp, a.general, i)) * kPieces
            + piece] = zero;
    }
    return;
  }

  const long long n = ticket / a.data_per_image;
  long long t = ticket - n * a.data_per_image;
  int c = 0;
  while (t >= a.c[c].data_tiles) t -= a.c[c].data_tiles, ++c;
  const Comp& cp = a.c[c];
  const int j0 = static_cast<int>(t) * kRows;
  const int cnt = cp.n_c - j0 < kRows ? cp.n_c - j0 : kRows;
  const uint4* nat = a.nat + n * a.n_blocks * kPieces;

  // Every row of the tile into registers, its DC into shared memory.
  uint4 v[kPasses];
  int dst[kPasses];
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    const int row = pass * kRowsPerPass + (tid >> 3);
    dst[pass] = -1;
    if (row < cnt) {
      const int j = j0 + row;
      int src;
      if (a.general) {
        src = cp.stream_idx[j];
        dst[pass] = cp.raster_of[j];
      } else {
        const int mcu = j / cp.bpm;
        const int k = j - mcu * cp.bpm;
        const int kv = k / cp.hs;
        const int my = mcu / cp.cols_d;
        src = mcu * cp.plen + cp.slot0 + k;
        dst[pass] = (my * cp.vs + kv) * cp.w
                    + (mcu - my * cp.cols_d) * cp.hs + (k - kv * cp.hs);
      }
      v[pass] = nat[static_cast<long long>(src) * kPieces + piece];
      if (piece == 0) sm.dc[row] = v[pass].x & 0xffffu;
    }
  }
  __syncthreads();

  // Segmented inclusive scan of the tile's DC, row `tid` a thread: within
  // the warp, then over the warps before it.
  uint32_t val = 0;
  unsigned flag = 0;
  if (tid < cnt) {
    const int j = j0 + tid;
    val = sm.dc[tid];
    flag = j > 0 && (a.general ? cp.seg_first[j] == j
                     : cp.seg_blocks > 0 && j % cp.seg_blocks == 0);
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t pv = __shfl_up_sync(kFull, val, d);
    const unsigned pf = __shfl_up_sync(kFull, flag, d);
    if (lane >= d) {
      if (!flag) val += pv;
      flag |= pf;
    }
  }
  if (lane == 31) {
    sm.warp_val[warp] = val;
    sm.warp_flag[warp] = flag;
  }
  __syncthreads();
  uint32_t pre = 0;
  unsigned pre_flag = 0;
  for (int w = 0; w < warp; ++w) {
    pre = sm.warp_flag[w] ? sm.warp_val[w] : pre + sm.warp_val[w];
    pre_flag |= sm.warp_flag[w];
  }
  if (!flag) val += pre;
  flag |= pre_flag;
  if (tid == kThreads - 1) {       // rows past cnt add 0 and no reset
    sm.agg_val = val & 0xffffu;
    sm.agg_flag = flag;
  }
  __syncthreads();

  // Publish, look back, publish the inclusive prefix.
  if (warp == 0) {
    const uint32_t agg = sm.agg_val;
    const bool agg_flag = sm.agg_flag != 0;
    unsigned long long* mine = a.status + ticket;
    uint32_t excl;
    if (t == 0) {
      excl = 0;
      if (cp.takes_carry && a.carry != nullptr)
        excl = static_cast<uint32_t>(static_cast<unsigned long long>(
            a.carry[c * a.carry_sc + n * a.carry_sn])) & 0xffffu;
      if (lane == 0)
        store_release(mine, epoch | kFlagP
                      | ((agg_flag ? agg : excl + agg) & 0xffffu));
    } else {
      if (lane == 0)
        store_release(mine, epoch | (agg_flag ? kFlagP : kFlagA) | agg);
      excl = look_back(a.status, ticket - 1, ticket - t, epoch, lane);
      if (lane == 0 && !agg_flag)
        store_release(mine, epoch | kFlagP | ((excl + agg) & 0xffffu));
    }
    if (lane == 0) sm.excl = excl;
  }
  __syncthreads();
  if (tid < cnt) sm.dc[tid] = (flag ? val : sm.excl + val) & 0xffffu;
  __syncthreads();

  uint4* out = cp.out + n * cp.rows * kPieces;
#pragma unroll
  for (int pass = 0; pass < kPasses; ++pass) {
    if (dst[pass] < 0) continue;
    uint4 x = v[pass];
    if (piece == 0)
      x.x = (x.x & 0xffff0000u) | sm.dc[pass * kRowsPerPass + (tid >> 3)];
    out[static_cast<long long>(dst[pass]) * kPieces + piece] = x;
  }
}

}  // namespace

// comp_meta: kCompMeta int64 per component: n_c, rows, takes_carry,
// seg_blocks, plen, slot0, bpm, vs, hs, W, cols_d, rows_d * vs,
// cols_d * hs, npad. maps (general only): host void*[4 * ncomp], per
// component stream_idx, raster_of, seg_first, pad_rows (int32 on the
// card). out: one allocation, the components' [images, rows, 64] stores
// one after another. status: int64 [1 + status_words], word 0 the ticket
// counter (0 between launches; its high half the epoch when epoch is 0),
// the rest the tiles' status words; epoch: nonzero and new for every
// launch on this buffer, or 0: the epoch in word 0 (the buffer's launches
// all take it so).
extern "C" int jdt_assemble(const void* nat, long long n_blocks, int images,
                            int ncomp, const long long* comp_meta,
                            int general, const void* const* maps,
                            const void* carry, long long carry_sc,
                            long long carry_sn, void* out, void* status,
                            long long status_words, unsigned epoch,
                            void* stream) {
  if (ncomp < 1 || ncomp > kMaxComp || images < 1 || n_blocks < 0
      || n_blocks >= (1LL << 31)
      || (nat == nullptr && n_blocks > 0) || out == nullptr
      || status == nullptr || (general && maps == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(nat) & 15)
      || (reinterpret_cast<uintptr_t>(out) & 15)
      || (reinterpret_cast<uintptr_t>(status) & 7))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Args a = {};
  a.nat = static_cast<const uint4*>(nat);
  a.n_blocks = n_blocks;
  a.general = general != 0;
  a.carry = static_cast<const long long*>(carry);
  a.carry_sc = carry_sc;
  a.carry_sn = carry_sn;
  a.word0 = static_cast<unsigned long long*>(status);
  a.status = static_cast<unsigned long long*>(status) + 1;
  a.host_epoch = epoch;
  uint4* base = static_cast<uint4*>(out);
  for (int c = 0; c < ncomp; ++c) {
    const long long* m = comp_meta + c * kCompMeta;
    Comp& cp = a.c[c];
    if (m[0] < 0 || m[1] < 0 || m[13] < 0 || m[0] >= (1LL << 31)
        || m[1] >= (1LL << 31) || m[13] > m[1] || m[3] < 0
        || (!general && (m[4] < 1 || m[5] < 0 || m[6] < 1 || m[7] < 1
                         || m[8] < 1 || m[6] != m[7] * m[8]
                         || m[5] + m[6] > m[4] || m[10] < 1 || m[9] < m[12]
                         || m[11] * m[9] > m[1]
                         || m[0] / m[6] * m[4] > n_blocks)))
      return static_cast<int>(cudaErrorInvalidValue);
    cp.out = base;
    base += images * m[1] * kPieces;
    cp.n_c = static_cast<int>(m[0]);
    cp.rows = m[1];
    cp.takes_carry = m[2] != 0;
    cp.seg_blocks = static_cast<int>(m[3]);
    cp.plen = static_cast<int>(m[4]);
    cp.slot0 = static_cast<int>(m[5]);
    cp.bpm = static_cast<int>(m[6]);
    cp.vs = static_cast<int>(m[7]);
    cp.hs = static_cast<int>(m[8]);
    cp.w = static_cast<int>(m[9]);
    cp.cols_d = static_cast<int>(m[10]);
    cp.r_rows = static_cast<int>(m[11]);
    cp.c_cols = static_cast<int>(m[12]);
    cp.npad = static_cast<int>(m[13]);
    if (general) {
      cp.stream_idx = static_cast<const int*>(maps[4 * c]);
      cp.raster_of = static_cast<const int*>(maps[4 * c + 1]);
      cp.seg_first = static_cast<const int*>(maps[4 * c + 2]);
      cp.pad_rows = static_cast<const int*>(maps[4 * c + 3]);
    }
    cp.data_tiles = (m[0] + kRows - 1) / kRows;
    cp.pad_tiles = (m[13] + kRows - 1) / kRows;
    a.data_per_image += cp.data_tiles;
    a.pad_per_image += cp.pad_tiles;
  }
  a.data_tiles = images * a.data_per_image;
  a.total_tiles = a.data_tiles + images * a.pad_per_image;
  if (a.total_tiles == 0) return 0;
  if (a.total_tiles >= (1LL << 31) || a.data_tiles > status_words)
    return static_cast<int>(cudaErrorInvalidValue);
  assemble_kernel<<<static_cast<unsigned>(a.total_tiles), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
