// K1: anchored-chunk Huffman decode of a baseline JPEG scan, one thread per
// chunk, for Hopper (sm_90a).
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
// at most `s_max` steps: a 32-bit window from two words, the code length by
// the F.16 maxcode chain, the symbol through the delta/values tables,
// receive/extend (F.12), and the DC/AC/ZRL/EOB state over its blocks.
//
// What bounds it on this card: a chunk is a serial chain of dependent
// symbol steps (~100 per chunk), so latency, not bandwidth or FLOPs, is the
// limit. The stream is read twice per step per thread (words[p>>5] and the
// next word) from L2/L1; coefficient stores are scattered 2-byte writes.
//
// What the design does about it: thousands of chunks run as independent
// threads, so the SMs hide each thread's latency behind the others; the
// tables (< 2 KB) and the zigzag map sit in shared memory. On the TPU the
// kernel had to gather each chunk's bytes into per-chunk slots, emit dense
// one-hot rows and compact them afterwards because Mosaic has no cheap
// gather or scatter; here a thread reads the stream at its own bit offset
// and stores each coefficient straight into nat[(base + blk) * 64 +
// unzig[k]]. Every (block, position) is written at most once in a baseline
// scan, so plain stores are exact and need no atomics. The caller zero-fills
// `nat`.
//
// Bit-exactness with the slot formulation: a slot starts at byte ab >> 3
// and the chunk enters at bit ab & 7, so slot bit q is stream bit
// (ab & ~7) + q; the delta wire pads the stream with zero words past the
// last chunk, and reads past `n_words` return 0 here as well.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxTabs = 8;   // 4 (DC, AC) pairs
constexpr int kMaxPattern = 16;

__global__ void __launch_bounds__(kThreads)
huffman_decode_kernel(const uint32_t* __restrict__ words, int n_words,
                      const uint32_t* __restrict__ dm,
                      const int32_t* __restrict__ ab,
                      const int32_t* __restrict__ base, int n_items,
                      const int32_t* __restrict__ maxcode,
                      const int32_t* __restrict__ delta,
                      const uint32_t* __restrict__ values, int n_tab,
                      const int32_t* __restrict__ pattern, int plen,
                      const int32_t* __restrict__ unzig, int s_max,
                      int16_t* __restrict__ nat, int n_blocks) {
  __shared__ int32_t s_maxcode[kMaxTabs * 16];
  __shared__ int32_t s_delta[kMaxTabs * 16];
  __shared__ uint8_t s_values[kMaxTabs * 256];
  __shared__ int32_t s_pattern[kMaxPattern];
  __shared__ uint8_t s_unzig[64];

  for (int i = threadIdx.x; i < n_tab * 16; i += blockDim.x) {
    s_maxcode[i] = maxcode[i];
    s_delta[i] = delta[i];
  }
  // values arrive packed 4 per word, little-endian (device_scan._pack_values).
  for (int i = threadIdx.x; i < n_tab * 64; i += blockDim.x) {
    const uint32_t w = values[i];
    s_values[4 * i + 0] = w & 0xFF;
    s_values[4 * i + 1] = (w >> 8) & 0xFF;
    s_values[4 * i + 2] = (w >> 16) & 0xFF;
    s_values[4 * i + 3] = w >> 24;
  }
  for (int i = threadIdx.x; i < kMaxPattern; i += blockDim.x)
    s_pattern[i] = i < plen ? pattern[i] : 0;
  for (int i = threadIdx.x; i < 64; i += blockDim.x) s_unzig[i] = unzig[i];
  __syncthreads();

  const int item = blockIdx.x * blockDim.x + threadIdx.x;
  if (item >= n_items) return;
  const uint32_t meta = dm[item];
  const int budget = (meta >> 4) & 31;   // 0: terminator or pad entry
  int slot = meta & 15;
  if (budget == 0) return;
  const int blk0 = base[item];
  uint32_t p = static_cast<uint32_t>(ab[item]);
  int k = 0;
  int blk = 0;

  for (int t = 0; t < s_max && blk < budget; ++t) {
    // 32-bit window at bit p; b == 0 must not shift by 32 (undefined).
    const uint32_t widx = p >> 5;
    const uint32_t b = p & 31;
    const uint32_t w0 = widx < static_cast<uint32_t>(n_words) ? words[widx] : 0u;
    const uint32_t w1 =
        widx + 1 < static_cast<uint32_t>(n_words) ? words[widx + 1] : 0u;
    const uint32_t win = b == 0 ? w0 : (w0 << b) | (w1 >> (32 - b));
    const uint32_t win16 = win >> 16;

    const bool is_dc = k == 0;
    const int tab = s_pattern[slot] * 2 + (is_dc ? 0 : 1);

    // Code length: the first L with code_L <= maxcode[L-1] (F.16); 16 caps
    // codes that match no length, as in the Pallas chain.
    const int32_t* mc = s_maxcode + tab * 16;
    int length = 1;
    bool run_fail = true;
#pragma unroll
    for (int L = 1; L <= 16; ++L) {
      const int32_t code_l = static_cast<int32_t>(win16 >> (16 - L));
      run_fail = run_fail && (code_l > mc[L - 1]);
      length += run_fail ? 1 : 0;
    }
    length = min(length, 16);

    const int32_t code = static_cast<int32_t>(win16 >> (16 - length));
    const int vidx = min(max(code + s_delta[tab * 16 + length - 1], 0), 255);
    const int value = s_values[tab * 256 + vidx];

    // receive/extend (F.12). Baseline scans keep mag <= 11 (DC) or 15 (AC);
    // transcoded scans reach DC category 16, where a 16-bit code plus 16
    // magnitude bits fill the window exactly (mshift == 0) and the wrap16
    // store below keeps the DC difference mod 2^16. length + mag <= 32 for
    // every symbol of a valid scan; the cap at 31 only keeps the shifts
    // defined on other input.
    const int r = value >> 4;
    const int s = value & 15;
    const int mag = is_dc ? value : s;
    const int magm = min(max(mag, 1), 31);
    const int mshift = max(32 - length - magm, 0);
    const uint32_t mbits = (win >> mshift) & ((1u << magm) - 1u);
    const uint32_t half = 1u << (magm - 1);
    uint32_t ext = mbits < half ? mbits - 2u * half + 1u : mbits;
    if (mag == 0) ext = 0;

    const bool is_zrl = !is_dc && s == 0 && r == 15;
    const bool is_eob = !is_dc && s == 0 && r != 15;
    if (is_dc || (!is_zrl && !is_eob)) {
      const int kc = is_dc ? 0 : min(k + r, 63);
      const int blk_abs = blk0 + blk;
      if (blk_abs < n_blocks)   // wrap16: DC diffs and AC values alike
        nat[static_cast<int64_t>(blk_abs) * 64 + s_unzig[kc]] =
            static_cast<int16_t>(static_cast<uint16_t>(ext & 0xFFFFu));
    }

    p += static_cast<uint32_t>(length + mag);
    const int k_next = is_dc ? 1 : (is_zrl ? k + 16 : (is_eob ? 64 : k + r + 1));
    const bool done = is_eob || k_next >= 64;
    k = done ? 0 : k_next;
    if (done) {
      ++blk;
      slot = slot + 1 >= plen ? 0 : slot + 1;
    }
  }
}

}  // namespace

extern "C" int jdt_huffman_decode(const void* words, int n_words,
                                  const void* dm, const void* ab,
                                  const void* base, int n_items,
                                  const void* maxcode, const void* delta,
                                  const void* values, int n_tab,
                                  const void* pattern, int plen,
                                  const void* unzig, int s_max, void* nat,
                                  int n_blocks, void* stream) {
  if (n_tab < 1 || n_tab > kMaxTabs || plen < 1 || plen > kMaxPattern)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_items <= 0) return 0;
  const int grid = (n_items + kThreads - 1) / kThreads;
  huffman_decode_kernel<<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), n_words,
      static_cast<const uint32_t*>(dm), static_cast<const int32_t*>(ab),
      static_cast<const int32_t*>(base), n_items,
      static_cast<const int32_t*>(maxcode), static_cast<const int32_t*>(delta),
      static_cast<const uint32_t*>(values), n_tab,
      static_cast<const int32_t*>(pattern), plen,
      static_cast<const int32_t*>(unzig), s_max, static_cast<int16_t*>(nat),
      n_blocks);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* jdt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
