// U1: the delta-wire unpack. The 4 B/chunk delta wire (pack_delta: a word
// per chunk, `delta << 9 | budget << 4 | slot`) -> per chunk its entry bit
// `ab` (inclusive cumsum of the deltas) and its first stream block `base`
// (exclusive cumsum of the budgets), both int32, for one scan or a group's
// merged wire, in one launch, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: in the JAX package this is the vector part of
// jnp code, jpeg_decoder_tpu/entropy/pallas_decode.py
// `unpack_delta_classes` (`ab = cumsum(dm >>> 9)`, `basev = cumsum(budget)
// - budget`), which XLA compiles inside the bits sweep. Its plain version
// is jpeg_decoder_tpu_torch/entropy/chunk_decode.py `unpack_delta_plain`,
// and the kernel is bit-equal to it: the shifts are logical (uint32_t), and
// the sums wrap mod 2^32 like the reference's int32 cumsum (pack_delta
// refuses streams of 2^26 words, so `ab` stays below 2^31 and nothing
// wraps on a real wire).
//
// What bounds it on this card: the launch, and past a few tiles the bytes.
// A scan's wire (large_420: 6,144 entries, 24.6 KB in, 49.2 KB out) is far
// below the few microseconds any launch takes; a group's merged wire grows
// with the group (16 large_420 images: ~98,000 entries), and 2^20 entries
// move 12.6 MB, 3.76 us at 3.35 TB/s.
//
// What the design does about it: a single-pass scan across CTAs by
// decoupled look-back, as A1 (csrc/assemble.cu) runs its DC prefix.
// - Tiles. A CTA of kThreads = 256 threads takes a tile of kTile = 8,192
//   consecutive entries (kPer = 32 a thread), so a scan's wire is one tile
//   and a long wire runs on as many SMs as it has tiles. One tile keeps
//   the main path's launch free of the status buffer, its lock and its
//   epoch (so a CUDA graph could capture it); tiles of 2,048 entries read
//   2.9 us against 3.1 at large_420 and 3.4 against 4.4 at 65,536 entries,
//   but 8.3 against 7.0 at 2^20, on an H100
//   (tools/experiments/a1_breakdown.py times them). Its words come in by 16-byte loads, a warp reading 512
//   consecutive bytes, into shared memory; each thread takes kPer
//   consecutive entries from there and sums them, a warp scans the thread
//   sums by shuffles and warp 0 scans the warp sums. Shared memory holds a
//   pad of 4 words after every 32 (`slot`), so a quarter warp's 16-byte
//   accesses, at both the coalesced and the per-thread layout, touch 32
//   different banks. `ab`, then `base`, go back through shared memory to
//   16-byte stores. A pointer off 16 bytes, or the last tile's ragged end,
//   takes word loads and stores instead.
// - One tile (a scan's wire): one CTA, which reads and writes no status
//   word and takes no ticket.
// - More tiles: a CTA's tile is the next ticket of a counter (atomicAdd),
//   not blockIdx, so every tile's predecessors have started and nothing
//   assumes that the CTAs are resident together. Warp 0 publishes the
//   tile's aggregate of both sums (flag A; the first tile its inclusive
//   prefix, flag P) as soon as the warp sums are scanned, then reads the
//   statuses of up to 32 predecessors at a time, adds the aggregates back
//   to the nearest P of each sum, and publishes the tile's inclusive
//   prefixes. Both sums are full 32-bit values, so a tile has a status
//   word per sum: (epoch << 34 | flag << 32 | the value). A reader waits
//   until both words carry this launch's epoch and a flag, and then takes
//   each sum from its own word: a word already turned P holds the
//   inclusive prefix, not the aggregate. A word carries all that is read
//   through it, so the words are stored and loaded relaxed, at gpu scope,
//   with no fence: release stores and acquire loads (A1's) took 5.9-6.0
//   us against 4.4-4.5 at 65,536 entries on an H100, in two runs. The
//   wrapper passes a new epoch (1 .. 2^30 - 1) for every launch, so a
//   word of an earlier launch never reads as valid and the buffer needs
//   no clearing between launches; the last CTA to take a ticket sets the
//   counter back to 0 for the next launch on the stream.
// - The epoch on the card (the wrapper passes epoch 0, as a launch
//   captured in a CUDA graph must: a replay would repeat a baked-in host
//   epoch). Word 0 of the buffer holds the epoch in its high 32 bits and
//   the ticket counter in its low 32; a CTA's 64-bit atomicAdd of 1
//   returns its ticket and the launch's epoch together, and the CTA that
//   takes the last ticket stores the next epoch, mod 2^30, with the
//   counter 0 in one atomic. Such a buffer serves one launch site of one
//   graph, the same tile count at every replay, and every tile publishes
//   both words, so every word a launch reads holds this launch's epoch or
//   the last one's (`_build.DeviceEpochs`): the wrap needs no clearing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 32;                     // entries a thread
constexpr int kTile = kThreads * kPer;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = kPer / 4;              // 16-byte vectors a thread
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kFlagA = 1ull << 32;   // aggregate
constexpr unsigned long long kFlagP = 2ull << 32;   // inclusive prefix
constexpr unsigned long long kFlags = 3ull << 32;
constexpr unsigned long long kEpochMask = ~0ull << 34;
constexpr unsigned long long kEpochs = 1ull << 30;  // epochs, mod this
static_assert(kPer % 4 == 0 && kWarps <= 32, "U1's tile shape");

struct Smem {
  alignas(16) uint32_t buf[kTile + kTile / 8];
  uint32_t warp_ab[kWarps];
  uint32_t warp_base[kWarps];
  unsigned ticket;
  unsigned long long epoch;   // this launch's epoch << 34
};

// Entry i of the tile in shared memory: a pad of 4 words after every 32.
__device__ __forceinline__ int slot(int i) { return i + ((i >> 5) << 2); }

__device__ __forceinline__ unsigned long long load_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ bool valid(unsigned long long s,
                                      unsigned long long epoch) {
  return (s & kEpochMask) == epoch && (s & kFlags) != 0;
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// One sum's step of the look-back over a window of 32 tiles (lane l holds
// tile k - l): adds the values up to the nearest P to `sum`; true while
// no window has held a P.
__device__ __forceinline__ bool look_step(uint32_t v, bool p, int lane,
                                          uint32_t& sum) {
  const unsigned pm = __ballot_sync(kFull, p);
  const int stop = pm ? __ffs(pm) - 1 : 31;
  sum += warp_sum(lane <= stop ? v : 0u);
  return pm == 0;
}

// The exclusive prefixes of both sums for tile `k + 1`: warp 0 reads the
// statuses of tiles k, k - 1, ... k - 31 (a lane each, waiting until both
// of its tile's words are this launch's), and moves 32 tiles back while a
// sum has met no P. Tile 0 always publishes P.
__device__ __forceinline__ void look_back(const unsigned long long* status,
                                          long long k,
                                          unsigned long long epoch, int lane,
                                          uint32_t& pre_ab,
                                          uint32_t& pre_base) {
  pre_ab = pre_base = 0;
  bool open_ab = true, open_base = true;
  while (open_ab || open_base) {
    const long long idx = k - lane;
    uint32_t v_ab = 0, v_base = 0;
    bool p_ab = true, p_base = true;
    if (idx >= 0) {
      const unsigned long long* w = status + 2 * idx;
      unsigned long long s_ab = load_relaxed(w);
      unsigned long long s_base = load_relaxed(w + 1);
      while (!valid(s_ab, epoch) || !valid(s_base, epoch)) {
        __nanosleep(32);
        s_ab = load_relaxed(w);
        s_base = load_relaxed(w + 1);
      }
      v_ab = static_cast<uint32_t>(s_ab);
      v_base = static_cast<uint32_t>(s_base);
      p_ab = (s_ab & kFlagP) != 0;
      p_base = (s_base & kFlagP) != 0;
    }
    if (open_ab) open_ab = look_step(v_ab, p_ab, lane, pre_ab);
    if (open_base) open_base = look_step(v_base, p_base, lane, pre_base);
    k -= 32;
  }
}

// The tile's values, kPer consecutive entries a thread in `v`, to
// out[t0 + i] for i < cnt, through shared memory.
__device__ __forceinline__ void store_tile(Smem& sm, const uint32_t* v,
                                           uint32_t* out, long long t0,
                                           int cnt, bool vec, int tid) {
#pragma unroll
  for (int k = 0; k < kVecs; ++k)
    *reinterpret_cast<uint4*>(sm.buf + slot(tid * kPer + 4 * k)) =
        make_uint4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int i = 4 * (k * kThreads + tid);
    const uint4 x = *reinterpret_cast<const uint4*>(sm.buf + slot(i));
    if (vec && i + 4 <= cnt) {
      *reinterpret_cast<uint4*>(out + t0 + i) = x;
    } else {
      if (i < cnt) out[t0 + i] = x.x;
      if (i + 1 < cnt) out[t0 + i + 1] = x.y;
      if (i + 2 < cnt) out[t0 + i + 2] = x.z;
      if (i + 3 < cnt) out[t0 + i + 3] = x.w;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
unpack_delta_kernel(const uint32_t* __restrict__ dm, long long n,
                    uint32_t* __restrict__ ab, uint32_t* __restrict__ base,
                    unsigned long long* status, unsigned long long* word0,
                    unsigned long long host_epoch, unsigned tiles,
                    int vec) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  unsigned tile = 0;
  unsigned long long epoch = 0;
  if (tiles > 1) {
    if (tid == 0) {
      // Word 0: the epoch on the card (high half; 0 with a host epoch)
      // and the ticket counter (low half).
      const unsigned long long w = atomicAdd(word0, 1ull);
      const unsigned t = static_cast<unsigned>(w);
      const unsigned long long e = host_epoch ? host_epoch : w >> 32;
      if (t == tiles - 1)
        atomicExch(word0, host_epoch ? 0ull : ((e + 1) % kEpochs) << 32);
      sm.ticket = t;
      sm.epoch = e << 34;
    }
    __syncthreads();
    tile = sm.ticket;
    epoch = sm.epoch;
  }
  const long long t0 = static_cast<long long>(tile) * kTile;
  const int cnt = n - t0 < kTile ? static_cast<int>(n - t0) : kTile;

#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const int i = 4 * (k * kThreads + tid);
    uint4 x;
    if (vec && i + 4 <= cnt) {
      x = *reinterpret_cast<const uint4*>(dm + t0 + i);
    } else {
      x.x = i < cnt ? dm[t0 + i] : 0u;
      x.y = i + 1 < cnt ? dm[t0 + i + 1] : 0u;
      x.z = i + 2 < cnt ? dm[t0 + i + 2] : 0u;
      x.w = i + 3 < cnt ? dm[t0 + i + 3] : 0u;
    }
    *reinterpret_cast<uint4*>(sm.buf + slot(i)) = x;
  }
  __syncthreads();
  uint32_t d[kPer], b[kPer];
  uint32_t sum_d = 0, sum_b = 0;
#pragma unroll
  for (int k = 0; k < kVecs; ++k) {
    const uint4 x =
        *reinterpret_cast<const uint4*>(sm.buf + slot(tid * kPer + 4 * k));
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      d[4 * k + j] = w[j] >> 9;
      b[4 * k + j] = (w[j] >> 4) & 31u;
      sum_d += d[4 * k + j];
      sum_b += b[4 * k + j];
    }
  }
  // Inclusive scans of the thread sums within the warp.
  uint32_t inc_d = sum_d, inc_b = sum_b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t pd = __shfl_up_sync(kFull, inc_d, o);
    const uint32_t pb = __shfl_up_sync(kFull, inc_b, o);
    if (lane >= o) {
      inc_d += pd;
      inc_b += pb;
    }
  }
  if (lane == 31) {
    sm.warp_ab[warp] = inc_d;
    sm.warp_base[warp] = inc_b;
  }
  __syncthreads();
  if (warp == 0) {
    // The warp sums' inclusive scan; lane 31 then holds the tile's sums.
    const uint32_t wd = lane < kWarps ? sm.warp_ab[lane] : 0u;
    const uint32_t wb = lane < kWarps ? sm.warp_base[lane] : 0u;
    uint32_t xd = wd, xb = wb;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t pd = __shfl_up_sync(kFull, xd, o);
      const uint32_t pb = __shfl_up_sync(kFull, xb, o);
      if (lane >= o) {
        xd += pd;
        xb += pb;
      }
    }
    uint32_t pre_d = 0, pre_b = 0;
    if (tiles > 1) {
      const uint32_t tot_d = __shfl_sync(kFull, xd, 31);
      const uint32_t tot_b = __shfl_sync(kFull, xb, 31);
      unsigned long long* mine = status + 2ull * tile;
      const unsigned long long flag = tile == 0 ? kFlagP : kFlagA;
      if (lane == 0) store_relaxed(mine, epoch | flag | tot_d);
      if (lane == 1) store_relaxed(mine + 1, epoch | flag | tot_b);
      if (tile > 0) {
        look_back(status, static_cast<long long>(tile) - 1, epoch, lane,
                  pre_d, pre_b);
        if (lane == 0) store_relaxed(mine, epoch | kFlagP | (pre_d + tot_d));
        if (lane == 1)
          store_relaxed(mine + 1, epoch | kFlagP | (pre_b + tot_b));
      }
    }
    if (lane < kWarps) {       // each warp's exclusive prefix in the wire
      sm.warp_ab[lane] = pre_d + xd - wd;
      sm.warp_base[lane] = pre_b + xb - wb;
    }
  }
  __syncthreads();
  uint32_t run_d = sm.warp_ab[warp] + inc_d - sum_d;
  uint32_t run_b = sm.warp_base[warp] + inc_b - sum_b;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    run_d += d[k];
    d[k] = run_d;            // inclusive
    const uint32_t next = run_b + b[k];
    b[k] = run_b;            // exclusive
    run_b = next;
  }
  store_tile(sm, d, ab, t0, cnt, vec, tid);
  __syncthreads();
  store_tile(sm, b, base, t0, cnt, vec, tid);
}

}  // namespace

// dm, ab, base: int32 [n] on the card (uint32 bit patterns). status: int64
// [1 + status_words], word 0 the ticket counter (0 between launches; its
// high half the epoch when epoch is 0), then two status words a tile;
// read only when the wire has more than one tile of kTile entries (else it
// may be null). epoch: 1 .. 2^30 - 1, new for every launch on this buffer,
// or 0: the epoch in word 0 (the buffer's launches all take it so).
extern "C" int jdt_unpack_delta(const void* dm, long long n, void* ab,
                                void* base, void* status,
                                long long status_words, unsigned epoch,
                                void* stream) {
  if (n < 0 || (n > 0 && (dm == nullptr || ab == nullptr
                          || base == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const long long tiles = (n + kTile - 1) / kTile;
  if (tiles >= (1LL << 31)
      || (tiles > 1 && (status == nullptr || epoch >= (1u << 30)
                        || status_words < 2 * tiles)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tiles > 1 && (reinterpret_cast<uintptr_t>(status) & 7))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int vec = ((reinterpret_cast<uintptr_t>(dm)
                    | reinterpret_cast<uintptr_t>(ab)
                    | reinterpret_cast<uintptr_t>(base)) & 15) == 0;
  unsigned long long* words = static_cast<unsigned long long*>(status);
  unpack_delta_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dm), n, static_cast<uint32_t*>(ab),
      static_cast<uint32_t*>(base), tiles > 1 ? words + 1 : nullptr, words,
      static_cast<unsigned long long>(epoch), static_cast<unsigned>(tiles),
      vec);
  return static_cast<int>(cudaGetLastError());
}
