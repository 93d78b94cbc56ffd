// L1: lossless (SOF3) predictor recurrence over whole planes, as a
// register-pipelined wavefront per component, for Hopper (sm_90a).
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
// What it replaces: one CTA per component walking the anti-diagonals with a
// __syncthreads() between them, every Ra/Rb/Rc read back from the output
// plane in global memory and the differences read skewed across rows
// (~2.4 us a diagonal, 9.9 ms for a 2048 x 2048 plane on an H100).
//
// What bounds it on this card: the dependence chain. Sample (y, x) needs
// (y, x-1) and (y-1, x), so a plane takes at least H + W - 1 dependent
// steps; here one step is one warp shuffle and a few integer operations.
// Handing a band's last row down to the next band adds a lag of kLag + 1
// strips per band, and each phase of kStrip steps pays a fixed cost (the
// copies, the handoff, the lanes' branches) that 8 warps on an SM cannot
// hide. The plane's bytes (8 per sample) are far below both.
//
// The design:
// - A warp owns a band of 32 rows, lane l row y0 + l, and walks it skewed:
//   at step t lane l computes column x = t - l. Ra is the lane's own value
//   from step t-1, Rb lane l-1's value from step t-1 (__shfl_up_sync), Rc
//   the Rb the lane received one step earlier. The chain never leaves
//   registers; no neighbour is read back from memory.
// - The bands of a component spread over a cluster of up to 8 CTAs (one
//   SM each, all resident at once, so no CTA waits on one that is not
//   running), about 8 warps to a CTA: band b goes to warp b mod nwarps of
//   the cluster, and the bands b .. b + nwarps - 1 with b a multiple of
//   nwarps make a round. (One CTA of 24 warps per component was
//   issue-bound on its SM, 2x slower at 2048 x 2048.)
// - Lane 0's row above is the last row of the band above. Inside a round,
//   lane 31 of the warp above sends it strip by strip (16 samples) into
//   this warp's inbox, a ring of 8 strips in this warp's shared memory,
//   possibly in another CTA, by st.async: the bytes complete the slot's
//   `full` mbarrier, which lane 0 armed, so no fence is needed. Lane 0
//   takes the strip into registers and frees the slot by a remote arrive
//   on the producer's `empty` mbarrier, which lane 31 waits on before it
//   writes the slot again. (Counters with cluster-scope fences instead
//   cost a few thousand cycles a phase.) Across a round (warp nwarps - 1
//   to warp 0, which may still be on the band before) the last row goes
//   whole into one row in rank 0's shared memory, and warp 0 waits for
//   all of it: a ring there could fill while warp 0 is busy and stall
//   every warp in a cycle. That row is never overwritten early: warp
//   nwarps - 1 of the next round reaches strip q only after warp 0 has
//   taken strip q + 2 nwarps.
// - Each warp stages its differences in a ring of 4 strips x 32 rows in
//   shared memory: strip s + 1 is fetched by cp.async (16 B a lane where
//   the rows allow, else 4 B) while the warp computes strip s. A lane reads
//   the 16 skewed differences of a phase before its first step, so no
//   memory access sits on the chain, and writes its 16 samples back in
//   their place after the last; a finished strip goes back to global
//   memory as whole row segments. The row pitch of 68 words keeps the
//   skewed reads of the 32 lanes in 32 banks.
// - The predictor is a template parameter; phases whose 16 steps touch no
//   edge (not row 0, not column 0, no column or row past the plane) run a
//   loop without the edge selects.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBand = 32;       // rows of a band: one per lane
constexpr int kStrip = 16;      // columns of a strip: the steps of a phase
constexpr int kRingCols = 4 * kStrip;   // the staging ring: 4 strips
constexpr int kPitch = kRingCols + 4;   // staging row pitch in words
// Lane 31 finishes strip q in phase q + kLag: it runs 31 columns behind.
constexpr int kLag = (kBand - 1 + kStrip - 1) / kStrip;
constexpr int kStripBytes = kStrip * 2;   // a strip of uint16 samples
constexpr int kHandoff = 8;     // strips in a warp's inbox ring
constexpr int kMaxWarps = 24;   // per CTA
constexpr int kMaxCtas = 8;     // per cluster: the portable limit
constexpr int kWarpsPerSm = 8;  // bands per CTA before the cluster grows
constexpr int kMaxSmem = 232448;   // an H100 block's dynamic shared memory
constexpr unsigned kFull = 0xffffffffu;

static_assert((kPitch - 1) % 2 == 1 && kPitch % 4 == 0,
              "skewed reads need an odd pitch - 1; 16 B copies a pitch of 4");
static_assert(kLag + 2 <= 4, "phase s touches strips s - kLag .. s + 1");
// (Rb - Rc) >> 1 on a negative difference must be an arithmetic shift (the
// reference's jnp and numpy `>>` on int32); nvcc's signed >> is one.
static_assert((-3 >> 1) == -2, "signed >> must be arithmetic");

template <int P>
__device__ __forceinline__ int32_t interior_prediction(int32_t ra, int32_t rb,
                                                       int32_t rc) {
  if constexpr (P == 0) return 0;
  else if constexpr (P == 1) return ra;
  else if constexpr (P == 2) return rb;
  else if constexpr (P == 3) return rc;
  else if constexpr (P == 4) return ra + rb - rc;
  else if constexpr (P == 5) return ra + ((rb - rc) >> 1);
  else if constexpr (P == 6) return rb + ((ra - rc) >> 1);
  else return (ra + rb) >> 1;   // both in [0, 2^16): floor division by 2
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

#ifdef L1_STEP_PROBE
// tools/experiments/l1_step_probe.py builds with this defined. Per band of
// component 0 (up to 4096): the clock64 cycles of its edge-free phases,
// their steps, the cycles lane 0 waited on the barriers, and clock64 at
// the band's start and end; then lane 0's cycles in the take of the row
// above, in the copy wait, in the store, and lane 31's in the handoff.
constexpr int kProbeBands = 4096;
__device__ long long l1_probe[kProbeBands][10];
#define L1_PROBE(...) __VA_ARGS__
#else
#define L1_PROBE(...)
#endif

struct Band {
  const int32_t* d;   // the component's differences
  int32_t* r;         // its samples
  int32_t* tile;      // this warp's staging ring, [32][kPitch]
  int h, w, y0, rows, lane;
  bool vec;           // 16 B copies: w % 4 == 0 and both planes aligned
};

// cp.async strip q (columns kStrip q .. kStrip q + kStrip - 1) of the
// band's differences
// into its ring slot; nothing past the plane.
__device__ __forceinline__ void fetch_strip(const Band& b, int q) {
  const int c0 = q * kStrip;
  if (c0 >= b.w) return;
  int32_t* slot = b.tile + (c0 & (kRingCols - 1));
  if (b.vec) {
#pragma unroll
    for (int j = 0; j < kStrip / 4; ++j) {
      const int idx = j * 32 + b.lane;
      const int row = idx / (kStrip / 4), c = idx % (kStrip / 4) * 4;
      if (row < b.rows && c0 + c < b.w)
        cp_async16(slot + row * kPitch + c,
                   b.d + (b.y0 + row) * b.w + c0 + c);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kStrip; ++j) {
      const int idx = j * 32 + b.lane;
      const int row = idx / kStrip, c = idx % kStrip;
      if (row < b.rows && c0 + c < b.w)
        cp_async4(slot + row * kPitch + c, b.d + (b.y0 + row) * b.w + c0 + c);
    }
  }
}

// Store the finished strip q of the band's samples as row segments.
__device__ __forceinline__ void store_strip(const Band& b, int q) {
  const int c0 = q * kStrip;
  if (c0 >= b.w) return;
  const int32_t* slot = b.tile + (c0 & (kRingCols - 1));
  if (b.vec) {
#pragma unroll
    for (int j = 0; j < kStrip / 4; ++j) {
      const int idx = j * 32 + b.lane;
      const int row = idx / (kStrip / 4), c = idx % (kStrip / 4) * 4;
      if (row < b.rows && c0 + c < b.w)
        *reinterpret_cast<int4*>(b.r + (b.y0 + row) * b.w + c0 + c) =
            *reinterpret_cast<const int4*>(slot + row * kPitch + c);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kStrip; ++j) {
      const int idx = j * 32 + b.lane;
      const int row = idx / kStrip, c = idx % kStrip;
      if (row < b.rows && c0 + c < b.w)
        b.r[(b.y0 + row) * b.w + c0 + c] = slot[row * kPitch + c];
    }
  }
}

// The kStrip steps of phase s: lane l computes columns kStrip s - l ..
// kStrip s - l + kStrip - 1 of its row y. Its differences come from the
// staging ring before the
// first step, so no memory access sits on the chain; the results go back
// in their place after the last, and stay in `rv` (lane 31 hands them
// down). Lane 0's Rb is strip s of the row above, packed in `ab` (two
// samples a word). `val` is Ra, `rc` Rc, both carried from step to step.
template <int P, bool kEdge>
__device__ __forceinline__ void phase(const Band& b, int s, int y, int pt,
                                      int32_t dflt, const uint32_t* ab,
                                      int32_t& val, int32_t& rc,
                                      int32_t* rv) {
  const int x0 = kStrip * s - b.lane;
  const int c0 = x0 & (kRingCols - 1);
  int32_t* row = b.tile + b.lane * kPitch;
#pragma unroll
  for (int i = 0; i < kStrip; ++i) rv[i] = row[(c0 + i) & (kRingCols - 1)];
#pragma unroll
  for (int i = 0; i < kStrip; ++i) {
    const int x = x0 + i;
    int32_t rb = __shfl_up_sync(kFull, val, 1);
    if (b.lane == 0) rb = (ab[i >> 1] >> ((i & 1) * 16)) & 0xFFFF;
    int32_t pred = interior_prediction<P>(val, rb, rc);
    if constexpr (kEdge) {
      if (x == 0) pred = y == 0 ? dflt : rb;
      else if (y == 0) pred = val;
    }
    const uint32_t v = static_cast<uint32_t>(pred + rv[i]) & 0xFFFFu;
    // Outside the plane this is garbage; only lanes outside it read it.
    val = static_cast<int32_t>((v << pt) & 0xFFFFu);
    rv[i] = val;
    rc = rb;
  }
#pragma unroll
  for (int i = 0; i < kStrip; ++i)
    if (!kEdge || (x0 + i >= 0 && x0 + i < b.w && y < b.h))
      row[(c0 + i) & (kRingCols - 1)] = rv[i];
}

// Shared-memory addresses as PTX takes them.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The same address in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned remote_addr(unsigned local,
                                                unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(local), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(count));
}

// Arrive on a local barrier and expect `bytes` more of st.async data.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Arrive on a barrier in another CTA of the cluster.
__device__ __forceinline__ void mbar_arrive_remote(unsigned cluster_bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n"
               ::"r"(cluster_bar) : "memory");
}

// Wait for the phase of `parity` to complete. More than ~2^28 polls
// (seconds) means a broken schedule: the launch fails with an error
// instead of holding the card. Returns the cycles waited under the probe.
__device__ __forceinline__ long long mbar_wait(uint64_t* bar,
                                               unsigned parity) {
  L1_PROBE(const long long t0 = clock64();)
  const unsigned a = smem_addr(bar);
  for (unsigned polls = 0;; ++polls) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) break;
    if (polls >> 28) __trap();
  }
  L1_PROBE(return clock64() - t0;)
  return 0;
}

// A strip of kStrip uint16 into another CTA's shared memory, 16 bytes a
// store, the bytes counted on its barrier `cluster_bar`.
__device__ __forceinline__ void st_async_strip(unsigned cluster_dst,
                                               unsigned cluster_bar,
                                               const uint32_t* v) {
#pragma unroll
  for (int i = 0; i < kStrip / 8; ++i)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
        "[%0], {%2, %3, %4, %5}, [%1];\n"
        ::"r"(cluster_dst + 16 * i), "r"(cluster_bar), "r"(v[4 * i]),
          "r"(v[4 * i + 1]), "r"(v[4 * i + 2]), "r"(v[4 * i + 3])
        : "memory");
}

// Per warp, after its staging tile: the inbox ring the warp of the band
// above writes (kHandoff strips), a `full` barrier per slot (this warp
// arrives expecting a strip's bytes; the producer's st.async completes it)
// and an `empty` barrier per slot of the warp below's inbox (the warp
// below arrives when it has taken the strip).
struct WarpSmem {
  int32_t tile[kBand * kPitch];
  uint16_t inbox[kHandoff * kStrip];
  uint64_t full[kHandoff];
  uint64_t empty[kHandoff];
};
constexpr int kWarpSmemBytes = sizeof(WarpSmem);
static_assert(kWarpSmemBytes % 16 == 0, "each warp's tile stays 16 B aligned");

template <int P>
__global__ void __launch_bounds__(kMaxWarps * 32)
lossless_recur_kernel(const int32_t* __restrict__ diffs, int h, int w, int pt,
                      int32_t dflt, int32_t* __restrict__ out, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned nctas, rank;
  asm("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(nctas));
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  const int nw = blockDim.x >> 5;                 // warps of this CTA
  const int nwc = nw * static_cast<int>(nctas);   // warps of the cluster
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gw = static_cast<int>(rank) * nw + warp;
  WarpSmem* ws = reinterpret_cast<WarpSmem*>(smem);
  WarpSmem& me = ws[warp];
  // After the warps: the row handed across rounds (used in rank 0, which
  // holds warp 0) and its barrier, armed for the whole row.
  uint64_t* cross_full =
      reinterpret_cast<uint64_t*>(smem + nw * kWarpSmemBytes);
  uint16_t* cross = reinterpret_cast<uint16_t*>(cross_full + 2);
  const int nb = (h + kBand - 1) / kBand;
  const int nst = (w + kStrip - 1) / kStrip;   // strips of a row
  const unsigned cross_bytes = nst * kStripBytes;
  if (lane == 0) {
    for (int j = 0; j < kHandoff; ++j) {
      mbar_init(&me.full[j], 1);
      mbar_init(&me.empty[j], 1);
    }
    if (warp == 0) mbar_init(cross_full, 1);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) {      // arm use 0 of every slot
    for (int j = 0; j < kHandoff; ++j)
      mbar_expect(&me.full[j], kStripBytes);
    if (warp == 0 && rank == 0) mbar_expect(cross_full, cross_bytes);
  }
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");

  const int plane = h * w;
  Band b;
  b.d = diffs + blockIdx.y * plane;
  b.r = out + blockIdx.y * plane;
  b.tile = me.tile;
  b.h = h;
  b.w = w;
  b.lane = lane;
  b.vec = vec != 0;
  // The warp below (its inbox and full barriers) and the warp above (its
  // empty barriers), in whichever CTA they are; the row across rounds.
  const int below = (gw + 1) % nwc, above = (gw + nwc - 1) % nwc;
  const unsigned below_inbox = remote_addr(
      smem_addr(ws[below % nw].inbox), below / nw);
  const unsigned below_full = remote_addr(
      smem_addr(ws[below % nw].full), below / nw);
  const unsigned above_empty = remote_addr(
      smem_addr(ws[above % nw].empty), above / nw);
  const unsigned cross0 = remote_addr(smem_addr(cross), 0);
  const unsigned cross0_full = remote_addr(smem_addr(cross_full), 0);

  for (int band = gw; band < nb; band += nwc) {
    b.y0 = band * kBand;
    b.rows = min(kBand, h - b.y0);
    const int y = b.y0 + lane;
    const int round = band / nwc;
    const bool has_above = band > 0, has_below = band + 1 < nb;
    const bool above_crosses = gw == 0;          // from the previous round
    const bool below_crosses = gw == nwc - 1;    // into the next round
    // Strips are numbered over a warp's bands (its producer's, inside a
    // round): strip k sits in inbox slot k % kHandoff, its use k / kHandoff.
    const int k0 = round * nst;
    L1_PROBE(long long probe[10] = {0, 0, 0, clock64()};)

    if (lane == 0 && has_above && above_crosses) {
      // The whole row of the previous round, then re-arm for the next.
      const long long waited = mbar_wait(cross_full, (round - 1) & 1);
      L1_PROBE(probe[2] += waited;)
      (void)waited;
      mbar_expect(cross_full, cross_bytes);
    }
    // Lane 0 takes strip q of the row above into `ab`, then frees its slot.
    uint32_t ab[kStrip / 2] = {};
    auto take_above = [&](int q) {
      const uint32_t* src = reinterpret_cast<const uint32_t*>(cross) +
                            q * kStrip / 2;
      if (!above_crosses) {
        const int k = k0 + q, j = k % kHandoff;
        const long long waited = mbar_wait(&me.full[j], (k / kHandoff) & 1);
        L1_PROBE(probe[2] += waited;)
        (void)waited;
        src = reinterpret_cast<const uint32_t*>(me.inbox + j * kStrip);
      }
#pragma unroll
      for (int j = 0; j < kStrip / 2; ++j) ab[j] = src[j];
      if (!above_crosses) {
        const int j = (k0 + q) % kHandoff;
        mbar_expect(&me.full[j], kStripBytes);   // arm the slot's next use
        mbar_arrive_remote(above_empty + j * 8);
      }
    };

    fetch_strip(b, 0);
    if (lane == 0 && has_above) take_above(0);
    cp_async_wait_all();
    __syncwarp();
    int32_t val = 0, rc = 0, last31 = 0;
    for (int s = 0; s < nst + kLag; ++s) {
      fetch_strip(b, s + 1);
      int32_t rv[kStrip];
      const bool edge_free = has_above && b.rows == kBand && s >= kLag &&
                             kStrip * s + kStrip <= w;
      if (edge_free) {
        L1_PROBE(const long long t0 = clock64();)
        phase<P, false>(b, s, y, pt, dflt, ab, val, rc, rv);
        L1_PROBE(__syncwarp(); probe[0] += clock64() - t0;
                 probe[1] += kStrip;)
      } else {
        phase<P, true>(b, s, y, pt, dflt, ab, val, rc, rv);
      }
      L1_PROBE(const long long t1 = clock64();)
      // Lane 31 made strip q = s - kLag of the band's last row: its column
      // kStrip q in the last phase, the rest in this one. It sends the
      // strip to the inbox of the warp below once that warp has taken what
      // the slot held (or into the row across rounds).
      if (lane == kBand - 1 && has_below && s >= kLag) {
        const int q = s - kLag;
        uint32_t v[kStrip / 2];
        v[0] = (static_cast<uint32_t>(last31) & 0xFFFFu) |
               (static_cast<uint32_t>(rv[0]) << 16);
#pragma unroll
        for (int j = 1; j < kStrip / 2; ++j)
          v[j] = (static_cast<uint32_t>(rv[2 * j - 1]) & 0xFFFFu) |
                 (static_cast<uint32_t>(rv[2 * j]) << 16);
        if (below_crosses) {
          st_async_strip(cross0 + q * kStripBytes, cross0_full, v);
        } else {
          const int k = k0 + q, j = k % kHandoff;
          if (k >= kHandoff) {
            const long long waited =
                mbar_wait(&me.empty[j], (k / kHandoff - 1) & 1);
            L1_PROBE(probe[2] += waited;)
            (void)waited;
          }
          st_async_strip(below_inbox + j * kStripBytes, below_full + j * 8,
                         v);
        }
      }
      L1_PROBE(probe[8] += clock64() - t1;)
      last31 = rv[kStrip - 1];
      L1_PROBE(const long long t2 = clock64();)
      cp_async_wait_all();
      __syncwarp();
      L1_PROBE(const long long t3 = clock64(); probe[6] += t3 - t2;)
      if (lane == 0 && has_above && s + 1 < nst) take_above(s + 1);
      L1_PROBE(const long long t4 = clock64(); probe[5] += t4 - t3;)
      // Strip s - kLag is final: lane 31 left it during this phase.
      if (s >= kLag) store_strip(b, s - kLag);
      __syncwarp();   // the slot just stored is fetched into next phase
      L1_PROBE(probe[7] += clock64() - t4;)
    }
    L1_PROBE(if (blockIdx.y == 0 && band < kProbeBands) {
      probe[4] = clock64();
      if (lane == 0)
        for (int i = 0; i < 8; ++i) l1_probe[band][i] = probe[i];
      if (lane == kBand - 1) l1_probe[band][8] = probe[8];
    })
  }
  // No CTA leaves while another may still write its memory.
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The cluster for a plane: `ctas` CTAs (one SM each, at most kMaxCtas, the
// portable cluster size) of `nw` warps, about kWarpsPerSm bands to a CTA;
// more bands than warps go round by round. The row handed across rounds
// needs shared memory: fewer warps where it would not fit.
bool plan(int h, int w, int* ctas, int* nw, int* smem_bytes) {
  const int nb = (h + kBand - 1) / kBand;
  *ctas = min(kMaxCtas, (nb + kWarpsPerSm - 1) / kWarpsPerSm);
  for (int n = min(kMaxWarps, (nb + *ctas - 1) / *ctas); n >= 1; --n) {
    const long long bytes = static_cast<long long>(n) * kWarpSmemBytes + 16 +
                            (w + kStrip - 1) / kStrip * kStripBytes;
    if (bytes <= kMaxSmem) {
      *nw = n;
      *smem_bytes = static_cast<int>(bytes);
      return true;
    }
  }
  return false;
}

template <int P>
int launch(const int32_t* diffs, int ncomp, int h, int w, int pt,
           int32_t dflt, int32_t* out, cudaStream_t stream) {
  int ctas, nw, smem_bytes;
  if (!plan(h, w, &ctas, &nw, &smem_bytes) || ncomp > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      lossless_recur_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (w % 4 == 0) &&
                  ((reinterpret_cast<uintptr_t>(diffs) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, ncomp);
  cfg.blockDim = dim3(nw * 32);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lossless_recur_kernel<P>, diffs, h, w, pt,
                           dflt, out, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifdef L1_STEP_PROBE
extern "C" int jdt_l1_probe_read(void* dst) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(dst, l1_probe, sizeof(l1_probe)));
}
#endif

extern "C" int jdt_lossless_recur(const void* diffs, int ncomp, int h, int w,
                                  int predictor, int pt, int dflt, void* out,
                                  void* stream) {
  if (ncomp < 1 || h < 1 || w < 1 || predictor < 0 || predictor > 7 ||
      pt < 0 || pt > 15 ||
      static_cast<long long>(ncomp) * h * w >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* d = static_cast<const int32_t*>(diffs);
  auto* r = static_cast<int32_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const int32_t df = static_cast<int32_t>(dflt);
  switch (predictor) {
    case 0: return launch<0>(d, ncomp, h, w, pt, df, r, s);
    case 1: return launch<1>(d, ncomp, h, w, pt, df, r, s);
    case 2: return launch<2>(d, ncomp, h, w, pt, df, r, s);
    case 3: return launch<3>(d, ncomp, h, w, pt, df, r, s);
    case 4: return launch<4>(d, ncomp, h, w, pt, df, r, s);
    case 5: return launch<5>(d, ncomp, h, w, pt, df, r, s);
    case 6: return launch<6>(d, ncomp, h, w, pt, df, r, s);
    default: return launch<7>(d, ncomp, h, w, pt, df, r, s);
  }
}
