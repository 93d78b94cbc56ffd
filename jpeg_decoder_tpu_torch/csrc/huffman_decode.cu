// K1: anchored-chunk Huffman decode of a baseline JPEG scan, a serial walk
// per chunk then a parallel decode of its segments, for Hopper (sm_90a).
//
// Replaces the TPU kernel jpeg_decoder_tpu/entropy/pallas_decode.py
// `_build_decode_kernel` (driven by `build_pallas_sweep`). Same inputs as the
// delta wire carries them (pallas_decode.pack_delta): the scan's unstuffed
// bit stream as big-endian uint32 words, and per chunk its entry bit `ab`,
// MCU-pattern slot, block budget (<= K_CAP = 24) and first stream block.
// Scans the delta wire declines arrive on the 12 B/chunk anchor wire (`ab`,
// `budget << 4 | slot`, `base` as the reference's XLA engine takes them),
// with up to 8 table rows (4 (DC, AC) pairs, SOF1) and any s_max.
// Transcoded scans (entropy/transcode.py: progressive and quirk streams
// re-encoded on the host) use one synthetic table pair whose alphabet goes
// past baseline: DC categories up to 16, AC sizes up to 15.
// Each chunk runs the same per-symbol state machine as the Pallas kernel for
// at most `s_max` steps: the code length and symbol, receive/extend (F.12),
// and the DC/AC/ZRL/EOB state over its blocks. The output is `nat`, int16
// [n_blocks, 64] natural-order coefficients in stream block order, bit-equal
// to `decode_chunks_plain`.
//
// What bounds it on this card: the bytes are few (large_420: 0.36 MB of
// words in, 10.3 MB of `nat` out, 3.2 us at 3.35 TB/s). A chunk is a serial
// chain of ~100 symbol steps, so the time is the longest chunk's steps
// times the cycles of one step, and a warp step costs every code path any
// of its 32 lanes takes in it, at several cycles per dependent instruction
// (tools/experiments/k1_step_probe.py measures the phases). The first port
// (one thread per chunk doing everything, CTAs of 128: 56.6 us on large_420
// plus a 10.3 MB memset of `nat` before it) paid in every step for two
// global loads for the window, a 16-compare maxcode chain whose dependent
// shared-memory loads some lane needed in most steps, the receive/extend
// and coefficient store of every symbol, and divergent stores.
//
// What the design does about it: it splits the serial part from the rest.
// - Phase 1, one warp per CTA, one lane per chunk (32 chunks a CTA): the
//   lane walks its chunk taking from each symbol only what the walk needs,
//   the bits it uses and its zigzag advance, from a walk table
//   (params.walk_tables) whose entry covers two symbols when the 11-bit
//   window holds both whole and the first leaves the block open, and keeps
//   the decoder state (bit position, k, block, MCU slot, symbol index) at
//   about every seg-th symbol, seg = ceil(s_max / 16). The step is one
//   stretch of predicated code: only a code longer than the table and an
//   advance past 32 bits (only a malformed table gets one) branch. At most
//   64 registers a thread keep two CTAs on an SM, so large_420's 192 CTAs
//   run in one wave.
// - Meanwhile the CTA's other 15 warps zero its rows of `nat` with 16-byte
//   stores: from the first block of its first chunk (0 for the first CTA)
//   to that of the next CTA's (n_blocks after the last). With first blocks
//   that do not decrease in stream order, which both wires guarantee (the
//   delta wire's bases are a cumsum of budgets; the anchor wire's come from
//   the prescan's stream-ordered anchors), these ranges tile [0, n_blocks):
//   no memset, and rows no chunk covers or an s_max cut leaves unreached
//   stay zero.
// - Phase 2, one thread per segment (16 per chunk, 512 a CTA): from its
//   checkpoint the thread decodes the segment's symbols (seg, or one more)
//   in full, receive/extend included, and stores each coefficient into
//   `nat`. These threads run in parallel, so the full step's cost is paid
//   ~seg times, not ~100.
// - The lookahead table per table row (params.lookahead_tables), for the
//   decode: the next kLutBits = 11 bits of the window give the code length,
//   the symbol, the bits used and the zigzag advance in one shared-memory
//   load; codes
//   longer than 11 bits, rare enough that a warp seldom meets one, walk the
//   F.16 maxcode chain from length 12 (in a call off the main path), which
//   keeps "no length matches -> 16" bit for bit.
// - The bits live in registers: two stream words and the 32-bit window at
//   bit b of them (one funnel shift); when b passes 32 the words move up
//   and a third word, requested steps earlier, takes the free place.
// - Tables and checkpoints are addressed as 32-bit shared-space addresses
//   kept in registers, so the compiler does not rebuild them from the
//   CTA's shared window (a slow special-register read) every step.
// A one-pass redesign that assembled each block in shared memory and wrote
// it as one 128-byte row ran slower (PERF.md): the row flushes ran in
// nearly every warp step, since some lane finished a block in most of
// them.
//
// Bit-exactness with the slot formulation: a slot starts at byte ab >> 3
// and the chunk enters at bit ab & 7, so slot bit q is stream bit
// (ab & ~7) + q; the delta wire pads the stream with zero words past the
// last chunk, and reads past `n_words` return 0 here as well.

#include <cstdint>
#include <cuda_runtime.h>

#ifdef K1_STEP_PROBE
// tools/experiments/k1_step_probe.py builds with this defined: per chunk,
// the cycles of the table staging, of the walk (phase 1) and of the
// segment decode (phase 2), and the walk's steps.
__device__ long long k1_probe_cycles[3 * 65536];
__device__ int k1_probe_steps[65536];
#endif

namespace {

constexpr int kChunks = 32;     // chunks per CTA: one warp walks them
constexpr int kSegs = 16;       // segments per chunk, one thread each
constexpr int kThreads = kChunks * kSegs;
constexpr int kMaxTabs = 8;     // 4 (DC, AC) pairs
constexpr int kMaxPattern = 16;   // two bits per slot fill one word
constexpr int kLutBits = 11;
constexpr int kLutSize = 1 << kLutBits;
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr uint32_t kWalkDouble = 1u << 27;   // params.WALK_DOUBLE

__device__ __forceinline__ int64_t clamp64(int64_t v, int64_t lo, int64_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ uint32_t load_word(const uint32_t* __restrict__ w,
                                              uint32_t i, uint32_t n) {
  return i < n ? __ldg(w + i) : 0u;
}

// A shared-space address, kept in a register: the opaque move stops the
// compiler from recomputing it (from the CTA's shared window, a slow
// special-register read) inside the decode loop.
__device__ __forceinline__ uint32_t smem(const void* p) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("mov.b32 %0, %0;" : "+r"(a));
  return a;
}

__device__ __forceinline__ uint32_t ld_u32(uint32_t a) {
  uint32_t v;
  asm("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

// st.shared.u32 when `on` is nonzero: a predicated store, no branch.
__device__ __forceinline__ void st_u32_if(uint32_t on, uint32_t a,
                                          uint32_t v) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %0, 0;\n@q st.shared.u32 [%1], %2;\n}"
      :: "r"(on), "r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ uint32_t ld_u8(uint32_t a) {
  uint32_t v;
  asm("ld.shared.u8 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

// The bit reader: the window is the 32 bits at bit `b` (< 32) of w0:w1;
// w2 is the word after them, already requested, and `widx` its index.
struct Bits {
  uint32_t w0, w1, w2;
  uint32_t widx;
  uint32_t b;
};

__device__ __forceinline__ void seek(Bits& s, const uint32_t* __restrict__ w,
                                     uint32_t n, uint32_t p) {
  const uint32_t i = p >> 5;
  s.w0 = load_word(w, i, n);
  s.w1 = load_word(w, i + 1, n);
  s.widx = i + 2;
  s.w2 = load_word(w, s.widx, n);
  s.b = p & 31;
}

// w = words[i] when `on` is nonzero (and 0 for i past the stream); else w
// stays: a predicated load, no branch.
__device__ __forceinline__ void load_word_if(
    uint32_t on, uint32_t& w, const uint32_t* __restrict__ words, uint32_t i,
    uint32_t n) {
  const uint32_t in = on & (i < n ? 1u : 0u);
  if (on) w = 0u;
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.u32 q, %1, 0;\n"
      "@q ld.global.nc.u32 %0, [%2];\n}"
      : "+r"(w) : "r"(in), "l"(words + i));
}

// A code longer than kLutBits: the first L with code_L <= maxcode[L-1]
// (F.16) from L = 12 on; 16 caps codes that match no length, as in the
// Pallas chain. Returns the table entry's form: symbol | length << 8.
__device__ __noinline__ uint32_t long_code(uint32_t win, int tab,
                                           const int32_t* s_maxcode,
                                           const int32_t* s_delta,
                                           const uint8_t* s_values) {
  const uint32_t win16 = win >> 16;
  const int4 m2 = *reinterpret_cast<const int4*>(s_maxcode + tab * 16 + 8);
  const int4 m3 = *reinterpret_cast<const int4*>(s_maxcode + tab * 16 + 12);
  const int32_t mc[5] = {m2.w, m3.x, m3.y, m3.z, m3.w};   // L = 12..16
  int length = kLutBits + 1;
  bool run_fail = true;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const int32_t code_l = static_cast<int32_t>(win16 >> (4 - j));
    run_fail = run_fail && (code_l > mc[j]);
    length += run_fail ? 1 : 0;
  }
  length = min(length, 16);
  const int32_t code = static_cast<int32_t>(win16 >> (16 - length));
  const int vidx = min(max(code + s_delta[tab * 16 + length - 1], 0), 255);
  return s_values[tab * 256 + vidx] | (static_cast<uint32_t>(length) << 8);
}

// The lookahead entry of a symbol: symbol | length << 8 | used << 13 |
// dk << 22, with `used` the bits it takes with its magnitude and `dk` its
// advance of the zigzag position: 1 for DC, r + 1 for an AC coefficient,
// 16 for ZRL, 64 for EOB (so k >= 64 ends the block).
__device__ __forceinline__ uint32_t entry_of(uint32_t sym_len, bool is_dc) {
  const uint32_t value = sym_len & 0xFF;
  const uint32_t r = value >> 4;
  const uint32_t s = value & 15;
  const uint32_t mag = is_dc ? value : s;
  const uint32_t dk = is_dc ? 1 : (s != 0 ? r + 1 : (r == 15 ? 16 : 64));
  return sym_len | (((sym_len >> 8) + mag) << 13) | (dk << 22);
}

// The entry for the window: one table load (lut0: the table's shared
// address), or the maxcode chain for a code longer than kLutBits.
__device__ __forceinline__ uint32_t lookup(uint32_t win, int row,
                                           uint32_t lut0,
                                           const int32_t* s_maxcode,
                                           const int32_t* s_delta,
                                           const uint8_t* s_values) {
  uint32_t e = ld_u32(lut0 + 4 * (row + (win >> (32 - kLutBits))));
  if (e == 0) {
    const int tab = row >> kLutBits;
    e = entry_of(long_code(win, tab, s_maxcode, s_delta, s_values),
                 (tab & 1) == 0);
  }
  return e;
}

// Advance the reader by `used` bits (p is the absolute bit position after).
__device__ __forceinline__ void advance(Bits& bits, uint32_t used, uint32_t p,
                                        const uint32_t* __restrict__ words,
                                        uint32_t nw) {
  if (used <= 32) {
    const uint32_t b = bits.b + used;
    const uint32_t adv = b >= 32 ? 1u : 0u;
    bits.b = b - 32 * adv;
    bits.w0 = adv ? bits.w1 : bits.w0;
    bits.w1 = adv ? bits.w2 : bits.w1;
    bits.widx += adv;
    load_word_if(adv, bits.w2, words, bits.widx, nw);
  } else {
    seek(bits, words, nw, p);
  }
}

// Two CTAs an SM at least: 192 CTAs (large_420) then run in one wave.
__global__ void __launch_bounds__(kThreads, 2)
huffman_decode_kernel(const uint32_t* __restrict__ words, int n_words,
                      const uint32_t* __restrict__ dm,
                      const int32_t* __restrict__ ab,
                      const int32_t* __restrict__ base, int n_items,
                      const int32_t* __restrict__ maxcode,
                      const int32_t* __restrict__ delta,
                      const uint32_t* __restrict__ values,
                      const int4* __restrict__ lut,
                      const int4* __restrict__ walk, int n_tab,
                      const int32_t* __restrict__ pattern, int plen,
                      const int32_t* __restrict__ unzig, int s_max, int seg,
                      int16_t* __restrict__ nat, int n_blocks) {
  __shared__ __align__(16) int32_t s_maxcode[kMaxTabs * 16];
  __shared__ int32_t s_delta[kMaxTabs * 16];
  __shared__ __align__(16) uint8_t s_values[kMaxTabs * 256];
  __shared__ uint8_t s_unzig[64];
  // The walk's checkpoints: the state before step j * seg of each chunk.
  __shared__ uint32_t s_at[kChunks][kSegs];     // bit position
  // k | blk << 8 | slot << 16 | step << 20
  __shared__ uint32_t s_state[kChunks][kSegs];
  __shared__ int s_steps[kChunks];              // the chunk's steps
  __shared__ int s_marks[kChunks];              // its checkpoints
  // Dynamic: the lookahead table, then the walk table (n_tab rows each).
  extern __shared__ __align__(16) uint32_t s_lut[];
  uint32_t* s_walk = s_lut + n_tab * kLutSize;

#ifdef K1_STEP_PROBE
  const long long probe_t0 = clock64();
#endif
  const int tid = threadIdx.x;
  const uint32_t nw = static_cast<uint32_t>(n_words);
  const int item0 = blockIdx.x * kChunks;

  // Stage the tables (every thread's loads go out before its stores).
  {
    constexpr int kLutPer = kMaxTabs * kLutSize / 4 / kThreads;
    int4 e[kLutPer];
#pragma unroll
    for (int j = 0; j < kLutPer; ++j) {
      const int i = tid + j * kThreads;
      if (i < n_tab * kLutSize / 4) e[j] = __ldg(walk + i);
    }
#pragma unroll
    for (int j = 0; j < kLutPer; ++j) {
      const int i = tid + j * kThreads;
      if (i < n_tab * kLutSize / 4) reinterpret_cast<int4*>(s_walk)[i] = e[j];
    }
#pragma unroll
    for (int j = 0; j < kLutPer; ++j) {
      const int i = tid + j * kThreads;
      if (i < n_tab * kLutSize / 4) e[j] = __ldg(lut + i);
    }
    uint32_t v = 0;
    int32_t mc = 0, dl = 0, zz = 0;
    if (tid < n_tab * 64) v = __ldg(values + tid);
    if (tid < n_tab * 16) {
      mc = __ldg(maxcode + tid);
      dl = __ldg(delta + tid);
    }
    if (tid < 64) zz = __ldg(unzig + tid);
#pragma unroll
    for (int j = 0; j < kLutPer; ++j) {
      const int i = tid + j * kThreads;
      if (i < n_tab * kLutSize / 4) reinterpret_cast<int4*>(s_lut)[i] = e[j];
    }
    // values arrive packed 4 per word, little-endian (prescan._pack_values).
    if (tid < n_tab * 64) reinterpret_cast<uint32_t*>(s_values)[tid] = v;
    if (tid < n_tab * 16) {
      s_maxcode[tid] = mc;
      s_delta[tid] = dl;
    }
    if (tid < 64) s_unzig[tid] = static_cast<uint8_t>(zz);
  }
  // The MCU pattern of table pairs (each < 4), two bits per slot.
  uint32_t pairs = 0;
#pragma unroll
  for (int i = 0; i < kMaxPattern; ++i)
    if (i < plen) pairs |= static_cast<uint32_t>(__ldg(pattern + i) & 3)
                           << (2 * i);
  __syncthreads();
#ifdef K1_STEP_PROBE
  const long long probe_ta = clock64();
#endif

  if (tid < kChunks) {
    // Phase 1, one thread per chunk: walk the symbols, taking from the walk
    // table only the bits they use and their zigzag advance, two symbols a
    // step where the window holds both, and keep the state at about every
    // seg-th symbol.
    const int item = item0 + tid;
    const uint32_t meta = item < n_items ? dm[item] : 0u;
    const int budget = (meta >> 4) & 31;   // 0: terminator, pad or no item
    int slot = meta & 15;
    uint32_t p = budget > 0 ? static_cast<uint32_t>(ab[item]) : 0u;
    Bits bits;
    seek(bits, words, nw, p);
    int k = 0, blk = 0, t = 0, until = 0, marks = 0;
    const uint32_t lut0 = smem(s_lut);
    const uint32_t walk0 = smem(s_walk);
    uint32_t at = smem(&s_at[tid][0]);         // the next checkpoint's slots
    uint32_t state = smem(&s_state[tid][0]);
    int row_dc = static_cast<int>((pairs >> (2 * slot)) & 3) * 2 * kLutSize;
    while (t < s_max && blk < budget) {
      const uint32_t mark = t >= until ? 1u : 0u;
      st_u32_if(mark, at, p);
      st_u32_if(mark, state, k | (blk << 8) | (slot << 16) | (t << 20));
      at += 4 * mark;
      state += 4 * mark;
      marks += mark;
      until += mark ? seg : 0;
      const uint32_t win = __funnelshift_l(bits.w1, bits.w0, bits.b);
      const int row = row_dc + (k == 0 ? 0 : kLutSize);
      uint32_t we = ld_u32(walk0 + 4 * (row + (win >> (32 - kLutBits))));
      if (we == 0) {   // a code longer than kLutBits: one symbol
        const uint32_t e =
            lookup(win, row, lut0, s_maxcode, s_delta, s_values);
        we = ((e >> 13) & 511) | ((e >> 22) << 9);
      }
      const int dk1 = static_cast<int>((we >> 9) & 127);
      const bool two = (we & kWalkDouble) && k + dk1 < 64 && t + 1 < s_max;
      const uint32_t used = two ? (we >> 16) & 15 : we & 511;
      p += used;
      advance(bits, used, p, words, nw);
      k += two ? static_cast<int>((we >> 20) & 127) : dk1;
      t += two ? 2 : 1;
      const bool done = k >= 64;
      k = done ? 0 : k;
      blk += done ? 1 : 0;
      const int slot_next = slot + 1 >= plen ? 0 : slot + 1;
      slot = done ? slot_next : slot;
      row_dc = static_cast<int>((pairs >> (2 * slot)) & 3) * 2 * kLutSize;
    }
    s_steps[tid] = t;
    s_marks[tid] = marks;
  } else {
    // Meanwhile the other warps zero this CTA's rows of nat: from the first
    // block of its first chunk (0 for the first CTA) to that of the next
    // CTA's (n_blocks after the last). With first blocks that do not
    // decrease in stream order these ranges tile [0, n_blocks), rows no
    // chunk covers and rows an s_max cut leaves unreached included.
    const int64_t lo = blockIdx.x == 0 ? 0 : static_cast<int64_t>(base[item0]);
    const int64_t hi = item0 + kChunks < n_items
                           ? static_cast<int64_t>(base[item0 + kChunks])
                           : static_cast<int64_t>(n_blocks);
    const int64_t r0 = clamp64(lo, 0, n_blocks);
    const int64_t r1 = clamp64(hi, r0, n_blocks);
    const int4 z = make_int4(0, 0, 0, 0);
    int4* rows = reinterpret_cast<int4*>(nat);
    for (int64_t i = r0 * 8 + (tid - kChunks); i < r1 * 8;
         i += kThreads - kChunks)
      rows[i] = z;
  }
  __syncthreads();
#ifdef K1_STEP_PROBE
  const long long probe_t1 = clock64();
#endif

  // Phase 2, one thread per segment (from one checkpoint to the next, or to
  // the walk's end): decode its symbols one by one from the checkpoint's
  // state and store the coefficients.
  const int c = tid / kSegs;
  const int j = tid % kSegs;
  const int item = item0 + c;
  if (item < n_items && j < s_marks[c]) {
    const uint32_t st = s_state[c][j];
    const int t0 = static_cast<int>(st >> 20);
    const int t1 = j + 1 < s_marks[c]
                       ? static_cast<int>(s_state[c][j + 1] >> 20)
                       : s_steps[c];
    const int64_t blk0 = base[item];
    uint32_t p = s_at[c][j];
    int k = st & 0xFF;
    int blk = (st >> 8) & 0xFF;
    int slot = (st >> 16) & 0xF;
    Bits bits;
    seek(bits, words, nw, p);
    const uint32_t unzig0 = smem(s_unzig);
    const uint32_t lut0 = smem(s_lut);
    int row_dc = static_cast<int>((pairs >> (2 * slot)) & 3) * 2 * kLutSize;
    for (int t = t0; t < t1; ++t) {
      const uint32_t win = __funnelshift_l(bits.w1, bits.w0, bits.b);
      const bool is_dc = k == 0;
      const uint32_t e = lookup(win, row_dc + (is_dc ? 0 : kLutSize), lut0,
                                s_maxcode, s_delta, s_values);
      const int length = static_cast<int>((e >> 8) & 31);
      const int value = static_cast<int>(e & 0xFF);

      // receive/extend (F.12). Baseline scans keep mag <= 11 (DC) or 15
      // (AC); transcoded scans reach DC category 16, where a 16-bit code
      // plus 16 magnitude bits fill the window exactly (mshift == 0) and
      // the wrap16 store below keeps the DC difference mod 2^16. length +
      // mag <= 32 for every symbol of a valid scan; the cap at 31 only
      // keeps the shifts defined on other input.
      const int r = value >> 4;
      const int s = value & 15;
      const int mag = is_dc ? value : s;
      const int magm = min(max(mag, 1), 31);
      const int mshift = max(32 - length - magm, 0);
      const uint32_t mbits = (win >> mshift) & ((1u << magm) - 1u);
      const uint32_t half = 1u << (magm - 1);
      uint32_t ext = mbits < half ? mbits - 2u * half + 1u : mbits;
      ext = mag == 0 ? 0u : ext;

      // An AC symbol of size 0 is ZRL (r == 15) or EOB: no coefficient.
      // wrap16: DC diffs and AC values alike.
      const int64_t row = blk0 + blk;
      if ((is_dc || s != 0) && row >= 0 && row < n_blocks) {
        const int kc = is_dc ? 0 : min(k + r, 63);
        nat[row * 64 + ld_u8(unzig0 + kc)] =
            static_cast<int16_t>(static_cast<uint16_t>(ext & 0xFFFFu));
      }

      const uint32_t used = (e >> 13) & 511;
      p += used;
      advance(bits, used, p, words, nw);
      k += static_cast<int>(e >> 22);
      if (k >= 64) {
        k = 0;
        ++blk;
        slot = slot + 1 >= plen ? 0 : slot + 1;
        row_dc = static_cast<int>((pairs >> (2 * slot)) & 3) * 2 * kLutSize;
      }
    }
  }
#ifdef K1_STEP_PROBE
  if (tid < kChunks && item0 + tid < n_items && item0 + tid < 65536) {
    k1_probe_cycles[3 * (item0 + tid)] = probe_ta - probe_t0;
    k1_probe_cycles[3 * (item0 + tid) + 1] = probe_t1 - probe_ta;
    k1_probe_cycles[3 * (item0 + tid) + 2] = clock64() - probe_t1;
    k1_probe_steps[item0 + tid] = s_steps[tid];
  }
#endif
}

}  // namespace

#ifdef K1_STEP_PROBE
extern "C" int jdt_k1_probe_read(void* cycles, void* steps) {
  const cudaError_t err = cudaMemcpyFromSymbol(cycles, k1_probe_cycles,
                                               sizeof(k1_probe_cycles));
  return static_cast<int>(err != cudaSuccess
                              ? err
                              : cudaMemcpyFromSymbol(steps, k1_probe_steps,
                                                     sizeof(k1_probe_steps)));
}
#endif

extern "C" int jdt_huffman_decode(const void* words, int n_words,
                                  const void* dm, const void* ab,
                                  const void* base, int n_items,
                                  const void* maxcode, const void* delta,
                                  const void* values, const void* lut,
                                  const void* walk, int n_tab,
                                  const void* pattern, int plen,
                                  const void* unzig, int s_max, void* nat,
                                  int n_blocks, void* stream) {
  if (n_tab < 1 || n_tab > kMaxTabs || plen < 1 || plen > kMaxPattern
      || s_max < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(nat) | reinterpret_cast<uintptr_t>(lut)
       | reinterpret_cast<uintptr_t>(walk)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_items <= 0) {   // no chunk writes nat: it is all zeros
    return n_blocks > 0
               ? static_cast<int>(cudaMemsetAsync(
                     nat, 0, static_cast<size_t>(n_blocks) * 128,
                     static_cast<cudaStream_t>(stream)))
               : 0;
  }
  // The opt-in holds for one device: keep one flag per card (a mesh
  // may launch on several).
  static uint64_t configured = 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) dev = 64;
  const uint64_t bit = dev < 64 ? uint64_t{1} << dev : 0;
  if (!(configured & bit)) {   // past 48 KB a kernel must opt in
    const cudaError_t err = cudaFuncSetAttribute(
        huffman_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        2 * kMaxTabs * kLutSize * 4);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= bit;
  }
  const int seg = (s_max + kSegs - 1) / kSegs;   // kSegs * seg >= s_max
  const int grid = (n_items + kChunks - 1) / kChunks;
  huffman_decode_kernel<<<grid, kThreads, 2 * n_tab * kLutSize * 4,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words,
      static_cast<const uint32_t*>(dm), static_cast<const int32_t*>(ab),
      static_cast<const int32_t*>(base), n_items,
      static_cast<const int32_t*>(maxcode), static_cast<const int32_t*>(delta),
      static_cast<const uint32_t*>(values), static_cast<const int4*>(lut),
      static_cast<const int4*>(walk), n_tab,
      static_cast<const int32_t*>(pattern), plen,
      static_cast<const int32_t*>(unzig), s_max, seg,
      static_cast<int16_t*>(nat), n_blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* jdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
