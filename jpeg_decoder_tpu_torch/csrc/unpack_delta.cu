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
// What bounds it on this card: the launch and the latency of one CTA. At
// large_420 the wire has 6,144 entries: 24.6 KB in, 49.2 KB out, 0.02 us
// at 3.35 TB/s, far below the few microseconds any launch takes.
//
// What the design does about it: one CTA of kThreads = 1024 threads walks
// the wire in rounds of kRound = 8,192 entries (one round for a scan's
// wire, which holds a chunk per up to 31 blocks), with a running carry of
// both sums from one round to the next. A round's words come in by
// coalesced loads (all of them in flight at once) to shared memory; each
// thread then takes kPer = 8 consecutive entries from there and sums them,
// a warp scans the thread sums by shuffles, warp 0 scans the 32 warp
// sums, and each thread works out its entries' prefixes; `ab`, then
// `base`, go back through shared memory to coalesced stores. Shared memory
// is addressed with a pad word after every 32 (`slot`), so that a lane
// reading its 8 consecutive entries and a warp reading 32 consecutive ones
// both touch 32 different banks. One CTA is right at every size the wire
// takes; it is only fast while the wire is short.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kPer = 8;                      // entries a thread per round
constexpr int kRound = kThreads * kPer;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

struct Smem {
  uint32_t buf[kRound + kRound / 32];
  uint32_t warp_ab[kWarps];
  uint32_t warp_base[kWarps];
  uint32_t total_ab, total_base;
};

__device__ __forceinline__ int slot(int i) { return i + (i >> 5); }

// The round's values v[k] of entries tid * kPer + k to their entries in
// `out` (r0 + i for i < n - r0), through shared memory.
__device__ __forceinline__ void store_round(Smem& sm, const uint32_t* v,
                                            uint32_t* out, long long r0,
                                            long long n, int tid) {
#pragma unroll
  for (int k = 0; k < kPer; ++k) sm.buf[slot(tid * kPer + k)] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int i = k * kThreads + tid;
    if (r0 + i < n) out[r0 + i] = sm.buf[slot(i)];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
unpack_delta_kernel(const uint32_t* __restrict__ dm, long long n,
                    uint32_t* __restrict__ ab, uint32_t* __restrict__ base) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  uint32_t carry_ab = 0, carry_base = 0;
  for (long long r0 = 0; r0 < n; r0 += kRound) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int i = k * kThreads + tid;
      sm.buf[slot(i)] = r0 + i < n ? dm[r0 + i] : 0u;
    }
    __syncthreads();
    uint32_t d[kPer], b[kPer];
    uint32_t sum_d = 0, sum_b = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const uint32_t word = sm.buf[slot(tid * kPer + k)];
      d[k] = word >> 9;
      b[k] = (word >> 4) & 31u;
      sum_d += d[k];
      sum_b += b[k];
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
    if (warp == 0) {         // exclusive scan of the warp sums, in place
      const uint32_t wd = sm.warp_ab[lane], wb = sm.warp_base[lane];
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
      sm.warp_ab[lane] = xd - wd;
      sm.warp_base[lane] = xb - wb;
      if (lane == 31) {
        sm.total_ab = xd;
        sm.total_base = xb;
      }
    }
    __syncthreads();
    uint32_t run_d = carry_ab + sm.warp_ab[warp] + inc_d - sum_d;
    uint32_t run_b = carry_base + sm.warp_base[warp] + inc_b - sum_b;
    carry_ab += sm.total_ab;
    carry_base += sm.total_base;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      run_d += d[k];
      d[k] = run_d;          // inclusive
      const uint32_t next = run_b + b[k];
      b[k] = run_b;          // exclusive
      run_b = next;
    }
    store_round(sm, d, ab, r0, n, tid);
    store_round(sm, b, base, r0, n, tid);
  }
}

}  // namespace

// dm, ab, base: int32 [n] on the card (uint32 bit patterns).
extern "C" int jdt_unpack_delta(const void* dm, long long n, void* ab,
                                void* base, void* stream) {
  if (n < 0 || (n > 0 && (dm == nullptr || ab == nullptr
                          || base == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  unpack_delta_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(dm), n, static_cast<uint32_t*>(ab),
      static_cast<uint32_t*>(base));
  return static_cast<int>(cudaGetLastError());
}
