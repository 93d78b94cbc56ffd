// D1: a stripe's DC totals. Stream-order natural coefficient blocks (the
// output of K1, DC columns holding wrap16 differences) of `images` images of
// one structured plan -> for each image and scan component the sum of its
// blocks' DC differences, int64 [images, ncomp], in one launch, for Hopper
// (sm_90a). For one MCU-row stripe of an image these are the values the
// later stripes' DC carry sums (jpeg_decoder_tpu_torch/parallel/
// stripe_bits.py).
//
// Replaces no Pallas kernel: in the JAX package the totals are jnp code,
// `cum[-1]` of jpeg_decoder_tpu/entropy/device_scan.py `_dc_carry`, which
// XLA compiles inside the striped sweep. Its plain version is
// jpeg_decoder_tpu_torch/entropy/assemble.py `dc_totals_plain`, and the
// kernel is bit-equal to it: for image i and component c (slots s0_c ..
// s0_c + bpm_c - 1 of each MCU of plen blocks), the sum over MCUs m and
// slots k of nat[i][m * plen + k][0], sign-extended, in 64 bits (the carry
// keeps its high bits; A1 takes it whole).
//
// What bounds it on this card: the launch. A large_420 stripe at 4 has
// 20,736 blocks; its DC column is one 32-byte sector a block (the least the
// card reads of a 128-byte row), 0.66 MB or 0.2 us at 3.35 TB/s, below the
// ~0.85 us a launch costs.
//
// What the design does about it: the loads spread over the SMs, each in
// flight before any add, and one round of atomics after them. One launch,
// no zero fill before it, no ticket. A thread takes one block's DC value
// (a CTA kThreads = 256 blocks of one image: 81 CTAs a large_420 stripe at
// 4) with the one load it makes, and finds the block's component from its
// slot in the MCU against the components' (s0, bpm) held in the launch's
// arguments. The CTA sums by component over each warp (__reduce_add_sync,
// int32: 256 int16 values cannot overflow it) and over its 8 warps in
// shared memory. Then a thread per component adds (1 << kCountShift) +
// the CTA's sum into an int64 accumulator of (image, component) by one
// 64-bit atomicAdd that returns the old value: the accumulator holds
// arrivals << 42 plus the sum so far (|sum| < 2^40 for any image the
// wrapper takes, so the two never mix: a negative sum borrows from the
// arrivals and rounding to the nearest multiple of 2^42 gives them back).
// The add that brings the arrivals to the image's CTA count is the last
// for that (image, component): its thread writes the total to `out` and
// sets the accumulator back to 0 for the next launch on the stream (no
// other CTA touches it again in this launch).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxComp = 4;                 // components of one scan
constexpr int kCountShift = 42;             // accumulator: arrivals, sum
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int16_t* nat;        // [images, n_blocks, 64]
  long long n_blocks;        // n_mcus * plen
  long long ctas_per_image;
  long long* out;            // [images, ncomp]
  unsigned long long* acc;   // [images, ncomp], 0 between launches
  int plen, ncomp;
  int s0[kMaxComp], bpm[kMaxComp];
};

struct Smem {
  int warp[kWarps][kMaxComp];
};

__global__ void __launch_bounds__(kThreads)
dc_totals_kernel(const __grid_constant__ Args a) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long img = blockIdx.x / a.ctas_per_image;
  const long long j = (blockIdx.x - img * a.ctas_per_image) * kThreads + tid;

  int v = 0, comp = -1;
  if (j < a.n_blocks) {
    v = a.nat[(img * a.n_blocks + j) * 64];
    const int slot = static_cast<int>(j) % a.plen;
#pragma unroll
    for (int c = 0; c < kMaxComp; ++c)
      if (c < a.ncomp
          && static_cast<unsigned>(slot - a.s0[c])
             < static_cast<unsigned>(a.bpm[c]))
        comp = c;
  }
#pragma unroll
  for (int c = 0; c < kMaxComp; ++c) {
    if (c >= a.ncomp) break;
    const int s = __reduce_add_sync(kFull, comp == c ? v : 0);
    if (lane == 0) sm.warp[warp][c] = s;
  }
  __syncthreads();
  if (tid >= a.ncomp) return;
  long long sum = 0;
  for (int w = 0; w < kWarps; ++w) sum += sm.warp[w][tid];
  const unsigned long long add =
      (1ull << kCountShift) + static_cast<unsigned long long>(sum);
  unsigned long long* acc = a.acc + img * a.ncomp + tid;
  const long long now = static_cast<long long>(atomicAdd(acc, add) + add);
  const long long arrived = (now + (1ll << (kCountShift - 1))) >> kCountShift;
  if (arrived == a.ctas_per_image) {
    a.out[img * a.ncomp + tid] = now - (arrived << kCountShift);
    *acc = 0;
  }
}

}  // namespace

// The status words a launch for `images` images of `ncomp` components
// uses past word 0 (which D1 leaves alone): an int64 accumulator per
// (image, component).
extern "C" long long jdt_dc_totals_status_words(int images, int ncomp) {
  return static_cast<long long>(images) * ncomp;
}

// comp_meta: 2 int64 per component: s0, bpm (the plan's structured specs).
// out: int64 [images, ncomp]. status: int64 [1 + status_words], the
// accumulators (`jdt_dc_totals_status_words`) past word 0, all 0 between
// launches.
extern "C" int jdt_dc_totals(const void* nat, long long n_mcus, int plen,
                             int images, int ncomp,
                             const long long* comp_meta, void* out,
                             void* status, long long status_words,
                             void* stream) {
  if (ncomp < 1 || ncomp > kMaxComp || images < 1 || n_mcus < 0
      || plen < 1 || n_mcus * plen >= (1LL << 31) / 64
      || (nat == nullptr && n_mcus > 0) || out == nullptr
      || status == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(nat) & 1)
      || (reinterpret_cast<uintptr_t>(out) & 7)
      || (reinterpret_cast<uintptr_t>(status) & 7))
    return static_cast<int>(cudaErrorMisalignedAddress);
  Args a = {};
  a.nat = static_cast<const int16_t*>(nat);
  a.plen = plen;
  a.n_blocks = n_mcus * plen;
  a.ncomp = ncomp;
  for (int c = 0; c < ncomp; ++c) {
    const long long s0 = comp_meta[2 * c], bpm = comp_meta[2 * c + 1];
    if (s0 < 0 || bpm < 1 || s0 + bpm > plen)
      return static_cast<int>(cudaErrorInvalidValue);
    a.s0[c] = static_cast<int>(s0);
    a.bpm[c] = static_cast<int>(bpm);
  }
  a.ctas_per_image = a.n_blocks > 0 ? (a.n_blocks + kThreads - 1) / kThreads
                                    : 1;
  const long long ctas = images * a.ctas_per_image;
  if (ctas >= (1LL << 31)
      || jdt_dc_totals_status_words(images, ncomp) > status_words)
    return static_cast<int>(cudaErrorInvalidValue);
  a.out = static_cast<long long*>(out);
  a.acc = static_cast<unsigned long long*>(status) + 1;
  dc_totals_kernel<<<static_cast<unsigned>(ctas), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
