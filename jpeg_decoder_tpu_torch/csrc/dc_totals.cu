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
// What the design does about it: one launch, no zero fill before it. A CTA
// of kThreads = 256 threads takes kThreads MCUs of one image, a thread one
// MCU (its plen DC values are independent loads, all in flight at once),
// sums them per component in registers, then over the warp by shuffles and
// over the CTA's 8 warps in shared memory, and stores its partial sums.
// Then it takes a ticket from a counter; the CTA that takes the last one
// adds the partials of every image (a warp per (image, component), loads
// that bypass L1) and sets the counter back to 0 for the next launch on
// the stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxComp = 4;                 // components of one scan
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int16_t* nat;      // [images, n_blocks, 64]
  long long n_blocks;      // n_mcus * plen
  long long n_mcus;
  long long ctas_per_image;
  long long ctas;
  long long* out;          // [images, ncomp]
  long long* partial;      // [ctas, ncomp]
  unsigned* counter;       // 0 between launches
  int plen, ncomp, images;
  int s0[kMaxComp], bpm[kMaxComp];
};

struct Smem {
  long long warp[kWarps][kMaxComp];
  int last;
};

__global__ void __launch_bounds__(kThreads)
dc_totals_kernel(const __grid_constant__ Args a) {
  __shared__ Smem sm;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long cta = blockIdx.x;
  const long long img = cta / a.ctas_per_image;
  const long long m = (cta - img * a.ctas_per_image) * kThreads + tid;

  long long s[kMaxComp] = {0, 0, 0, 0};
  if (m < a.n_mcus) {
    const int16_t* mcu = a.nat + (img * a.n_blocks + m * a.plen) * 64;
#pragma unroll
    for (int c = 0; c < kMaxComp; ++c) {
      if (c >= a.ncomp) break;
      for (int k = 0; k < a.bpm[c]; ++k) s[c] += mcu[(a.s0[c] + k) * 64];
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxComp; ++c) {
    if (c >= a.ncomp) break;
    for (int o = 16; o > 0; o >>= 1) s[c] += __shfl_xor_sync(kFull, s[c], o);
    if (lane == 0) sm.warp[warp][c] = s[c];
  }
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < a.ncomp; ++c) {
      long long t = 0;
      for (int w = 0; w < kWarps; ++w) t += sm.warp[w][c];
      __stcg(a.partial + cta * a.ncomp + c, t);
    }
    __threadfence();
    sm.last = atomicAdd(a.counter, 1u) == a.ctas - 1;
  }
  __syncthreads();
  if (!sm.last) return;
  __threadfence();

  // The last CTA: each (image, component) total, a warp each.
  for (long long p = warp; p < static_cast<long long>(a.images) * a.ncomp;
       p += kWarps) {
    const long long i = p / a.ncomp;
    const int c = static_cast<int>(p - i * a.ncomp);
    long long t = 0;
    for (long long k = lane; k < a.ctas_per_image; k += 32)
      t += __ldcg(a.partial + (i * a.ctas_per_image + k) * a.ncomp + c);
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(kFull, t, o);
    if (lane == 0) a.out[p] = t;
  }
  if (tid == 0) atomicExch(a.counter, 0u);
}

}  // namespace

// comp_meta: 2 int64 per component: s0, bpm (the plan's structured specs).
// out: int64 [images, ncomp]. status: int64 [1 + status_words], word 0 the
// ticket counter (0 between launches), the rest room for the partial sums,
// ncomp a CTA.
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
  a.n_mcus = n_mcus;
  a.plen = plen;
  a.n_blocks = n_mcus * plen;
  a.ncomp = ncomp;
  a.images = images;
  for (int c = 0; c < ncomp; ++c) {
    const long long s0 = comp_meta[2 * c], bpm = comp_meta[2 * c + 1];
    if (s0 < 0 || bpm < 1 || s0 + bpm > plen)
      return static_cast<int>(cudaErrorInvalidValue);
    a.s0[c] = static_cast<int>(s0);
    a.bpm[c] = static_cast<int>(bpm);
  }
  a.ctas_per_image = n_mcus > 0 ? (n_mcus + kThreads - 1) / kThreads : 1;
  a.ctas = images * a.ctas_per_image;
  if (a.ctas >= (1LL << 31) || a.ctas * ncomp > status_words)
    return static_cast<int>(cudaErrorInvalidValue);
  a.out = static_cast<long long*>(out);
  a.counter = static_cast<unsigned*>(status);
  a.partial = static_cast<long long*>(status) + 1;
  dc_totals_kernel<<<static_cast<unsigned>(a.ctas), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
