// L1: lossless (SOF3) predictor recurrence over whole planes, as one
// anti-diagonal wavefront per component, for Hopper (sm_90a).
//
// The port of jpeg_decoder_tpu/ops/predictors.py
// `reconstruct_lossless_wavefront` (and of the Rc row chain in
// `reconstruct_lossless_device`): a jnp `lax.scan` that XLA runs as one
// device loop. It replaces no Pallas kernel. Eager PyTorch would launch ~15
// small kernels on each of the H + W - 1 diagonals (~60,000 launches for a
// 2048 x 2048 plane), so the loop runs inside one kernel.
//
// What it computes, for every sample (y, x), in the order of the
// diagonals k = y + x: the prediction from Ra = r[y][x-1], Rb = r[y-1][x]
// and Rc = r[y-1][x-1] (Table H.1: 0 none, 1 Ra, 2 Rb, 3 Rc, 4 Ra+Rb-Rc,
// 5 Ra+((Rb-Rc)>>1), 6 Rb+((Ra-Rc)>>1), 7 (Ra+Rb)/2), with the edge rules
// of the reference (row 0 predicts Ra, column 0 predicts Rb, (0, 0) the
// default prediction), then r = (((pred + d) & 0xFFFF) << pt) & 0xFFFF.
// Differences arrive reduced to [0, 2^16); the stored samples go out as
// int32 in [0, 2^16).
//
// What bounds it on this card: the dependence chain, not bytes or
// operations. Diagonal k needs diagonals k-1 and k-2, so a plane takes
// H + W - 1 dependent steps of a few loads and integer ops each; the plane
// itself (16 MB for 2048 x 2048) moves once.
//
// The design: one CTA of up to 1024 threads per component; thread t owns
// rows y = t (mod blockDim). The kernel walks the diagonals with one
// __syncthreads() between them and reads Ra/Rb/Rc from the output plane
// written in the two diagonals before (global memory; the barrier makes
// those writes visible to the block, and the neighbours are L1/L2 hits).
// The simplest correct form; keeping the last two diagonals in shared
// memory and spreading a plane over several CTAs is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 1024;

// (Rb - Rc) >> 1 on a negative difference must be an arithmetic shift (the
// reference's jnp and numpy `>>` on int32); nvcc's signed >> is one.
static_assert((-3 >> 1) == -2, "signed >> must be arithmetic");

__device__ __forceinline__ int32_t interior_prediction(int predictor,
                                                       int32_t ra, int32_t rb,
                                                       int32_t rc) {
  switch (predictor) {
    case 0: return 0;
    case 1: return ra;
    case 2: return rb;
    case 3: return rc;
    case 4: return ra + rb - rc;
    case 5: return ra + ((rb - rc) >> 1);
    case 6: return rb + ((ra - rc) >> 1);
    default: return (ra + rb) / 2;   // both in [0, 2^16): floor division
  }
}

__global__ void __launch_bounds__(kMaxThreads)
lossless_recur_kernel(const int32_t* __restrict__ diffs, int h, int w,
                      int predictor, int pt, int32_t dflt,
                      int32_t* out) {
  const int64_t plane = static_cast<int64_t>(h) * w;
  const int32_t* d = diffs + blockIdx.x * plane;
  int32_t* r = out + blockIdx.x * plane;
  const int bd = blockDim.x;
  const int n_diag = h + w - 1;

  for (int k = 0; k < n_diag; ++k) {
    // Rows that cross diagonal k: y in [y_lo, y_hi]; this thread takes the
    // ones congruent to threadIdx.x mod blockDim.
    const int y_lo = max(0, k - w + 1);
    const int y_hi = min(h - 1, k);
    int y = y_lo + (static_cast<int>(threadIdx.x) - y_lo % bd + bd) % bd;
    for (; y <= y_hi; y += bd) {
      const int x = k - y;
      const int64_t i = static_cast<int64_t>(y) * w + x;
      int32_t pred;
      if (y == 0) {
        pred = x == 0 ? dflt : r[i - 1];
      } else if (x == 0) {
        pred = r[i - w];
      } else {
        pred = interior_prediction(predictor, r[i - 1], r[i - w],
                                   r[i - w - 1]);
      }
      const uint32_t v = static_cast<uint32_t>(pred + d[i]) & 0xFFFFu;
      r[i] = static_cast<int32_t>((v << pt) & 0xFFFFu);
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int jdt_lossless_recur(const void* diffs, int ncomp, int h, int w,
                                  int predictor, int pt, int dflt, void* out,
                                  void* stream) {
  if (ncomp < 1 || h < 1 || w < 1 || predictor < 0 || predictor > 7 ||
      pt < 0 || pt > 15)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = min(kMaxThreads, (h + 31) / 32 * 32);
  lossless_recur_kernel<<<ncomp, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(diffs), h, w, predictor, pt,
      static_cast<int32_t>(dflt), static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
