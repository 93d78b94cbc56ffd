// Copy of jpeg_decoder_tpu/entropy/cpp/entropy.cc at commit 0c2d0ea.
//
// Host entropy kernel: JPEG bitstream -> coefficient / difference tensors.
//
// Native tier of the TPU decode engine (the analog of the reference's
// src/arch/* SIMD tier, but aimed at the one stage a TPU cannot run: the
// bit-serial Huffman decode). Semantics are exactly those of the Python
// oracle in ../scan_python.py, which in turn mirrors:
//   - bit reservoir + unstuffing:  src/huffman.rs:14-160
//   - baseline/progressive scans:  src/decoder.rs:794-1298
//   - lossless difference scan:    src/decoder/lossless.rs:11-106
//
// Exposed via a C ABI (ctypes); all tables arrive as flat arrays prepared by
// ../huffman.py. When a scan uses restart intervals, segments are decoded in
// parallel with std::thread (the format guarantees full decoder-state reset at
// RSTn: F.2.1.3.1 / G.1.2.2).
//
// Build: g++ -O3 -march=native -shared -fPIC -std=c++17 -o libjtentropy.so entropy.cc -lpthread

#include <array>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cstdio>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

constexpr int kLutBits = 8;

// Zigzag index -> natural index (src/decoder.rs:27-36).
static const uint8_t UNZIGZAG[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

struct HuffTable {          // mirrors jpeg_decoder_tpu.huffman.HuffmanTable
  const uint8_t* lut_value;     // [256]
  const uint8_t* lut_size;      // [256]
  const int32_t* delta;         // [16]
  const int32_t* maxcode;       // [16]
  const uint8_t* values;        // [n]
  const int16_t* ac_lut_value;  // [256] or null
  const uint8_t* ac_lut_run_size;  // [256] or null
  // 10-bit fused decode(+receive+extend) LUTs; fast_bits[p]==0 => miss.
  const int16_t* fast_value;    // [1024]
  const uint8_t* fast_run;      // [1024]
  const uint8_t* fast_bits;     // [1024]
  const uint32_t* fast_packed;  // [1024]: value(u16) | run<<16 | bits<<20
  // Fused 1-or-2-symbol AC LUT over 10-bit windows (huffman.py
  // _build_fast2_lut): val1(i16) | val2(i16)<<16 | run1<<32 | run2<<36 |
  // pair_consumed<<40 | eob<<45 | pair_minbits<<46 | pair<<51 | c1<<52.
  // Null for DC tables; entry 0 = miss.
  const uint64_t* fast2;        // [1024] or null
};

constexpr int kFastBits = 10;

static const bool kNoFastDC = std::getenv("JT_NO_FAST_DC") != nullptr;
static const bool kNoFastAC = std::getenv("JT_NO_FAST_AC") != nullptr;

struct ScanComp {
  int32_t h_samp;        // MCU horizontal samples (1 for non-interleaved)
  int32_t v_samp;        // MCU vertical samples
  int32_t block_width;   // component block grid width
  int16_t* store;        // [block_h*block_w*64] natural order, or null (dummy)
  const HuffTable* dc;   // may be null
  const HuffTable* ac;   // may be null
  int64_t store_elems;   // total int16 elements in store (for fallback zeroing)
};

struct ScanParams {
  int64_t pos;             // in/out: cursor position
  int32_t ncomp;
  int32_t is_progressive;
  int32_t max_mcu_x, max_mcu_y;
  int32_t image_w, image_h;
  int32_t ss, se;          // spectral selection [ss, se)
  int32_t ah, al;
  int32_t restart_interval;
  int32_t nthreads;
  int32_t out_marker;      // out: terminating marker byte or -1
};

enum Err { OK = 0, ERR_FORMAT = 1, ERR_IO = 2 };

struct Error {
  int code = OK;
  char msg[160] = {0};
  void format(const char* m) {
    code = ERR_FORMAT;
    std::snprintf(msg, sizeof msg, "%s", m);
  }
  void io() { code = ERR_IO; }
  explicit operator bool() const { return code != OK; }
};

inline int16_t wrap16(int32_t v) { return static_cast<int16_t>(v); }

// Two's-complement left shift of a possibly negative value (the successive-
// approximation scaling `coeff << Al`): shifting a negative int32 is UB
// before C++20, so route through uint32 — identical bits, defined behavior
// (the reference's Rust `<<` wraps the same way).
inline int32_t shl32(int32_t v, int32_t n) {
  return static_cast<int32_t>(static_cast<uint32_t>(v) << n);
}

// ---------------------------------------------------------------------------
// Bit reservoir (semantics of src/huffman.rs:14-160)
//
// Templated on the byte-feed policy: Stuffed reads the raw entropy stream
// (FF00 unstuffing, marker capture, EOF errors); the !Stuffed (raw) variant
// reads pre-unstuffed bytes produced by jt_prescan_baseline — no FF logic,
// zero-fill past the end (the prescan's guard bytes bound every overrun) —
// which is what lets anchored parallel decode start mid-stream at a bit
// offset the prescan recorded.
// ---------------------------------------------------------------------------
template <bool Stuffed>
struct BitReaderT {
  const uint8_t* data;
  size_t len;
  size_t pos;
  uint64_t bits = 0;
  int num_bits = 0;
  int marker = -1;  // captured marker byte, -1 none

  BitReaderT(const uint8_t* d, size_t l, size_t p) : data(d), len(l), pos(p) {}

  void reset() { bits = 0; num_bits = 0; }

  // Exact consumed-bit offset from stream start (raw mode; every loaded bit
  // is accounted for in num_bits, including zero fill past len).
  int64_t bit_offset() const {
    return static_cast<int64_t>(pos) * 8 - num_bits;
  }

  bool read_bits_raw() {
    while (num_bits <= 56) {
      if (pos + 8 <= len) {
        uint64_t w;
        std::memcpy(&w, data + pos, 8);
        int take = (64 - num_bits) >> 3;
        uint64_t be = __builtin_bswap64(w);
        bits |= (be & (~0ULL << (8 * (8 - take)))) >> num_bits;
        num_bits += 8 * take;
        pos += take;
        continue;
      }
      uint8_t byte = pos < len ? data[pos] : 0;
      pos++;
      bits |= static_cast<uint64_t>(byte) << (56 - num_bits);
      num_bits += 8;
    }
    return true;
  }

  bool read_bits(Error& err) {
    if (!Stuffed) return read_bits_raw();
    while (num_bits <= 56) {
      uint8_t byte;
      if (marker >= 0) {
        byte = 0;  // post-marker: zero fill
      } else {
        // Fast path: when the next 8 bytes contain no 0xFF, insert exactly as
        // many whole bytes as the reference's byte-loop would (fill to >56
        // bits) in one step. Byte-consumption counts and EOF/marker timing
        // stay identical to the slow path.
        if (pos + 8 <= len) {
          uint64_t w;
          std::memcpy(&w, data + pos, 8);
          uint64_t z = ~w;  // 0xFF bytes -> 0x00
          if (!((z - 0x0101010101010101ULL) & w & 0x8080808080808080ULL)) {
            int take = (64 - num_bits) >> 3;
            uint64_t be = __builtin_bswap64(w);
            bits |= (be & (~0ULL << (8 * (8 - take)))) >> num_bits;
            num_bits += 8 * take;
            pos += take;
            continue;
          }
        }
        if (pos >= len) { err.io(); return false; }
        byte = data[pos++];
        if (byte == 0xFF) {
          if (pos >= len) { err.io(); return false; }
          uint8_t next = data[pos++];
          if (next != 0x00) {
            while (next == 0xFF) {
              if (pos >= len) { err.io(); return false; }
              next = data[pos++];
            }
            if (next == 0x00) {
              err.format("FF 00 found where marker was expected");
              return false;
            }
            marker = next;
            continue;
          }
        }
      }
      bits |= static_cast<uint64_t>(byte) << (56 - num_bits);
      num_bits += 8;
    }
    return true;
  }

  inline uint32_t peek(int count) const {
    return static_cast<uint32_t>((bits >> (64 - count)) & ((1u << count) - 1));
  }
  inline void consume(int count) { bits <<= count; num_bits -= count; }

  // F.2.2.3 Figure F.16 (src/huffman.rs:31-58)
  int decode(const HuffTable* t, Error& err) {
    if (num_bits < 16 && !read_bits(err)) return -1;
    uint32_t idx = static_cast<uint32_t>(bits >> 56);
    int size = t->lut_size[idx];
    if (size > 0) {
      consume(size);
      return t->lut_value[idx];
    }
    uint32_t b16 = static_cast<uint32_t>(bits >> 48);
    for (int i = kLutBits; i < 16; i++) {
      int32_t code = static_cast<int32_t>(b16 >> (15 - i));
      if (code <= t->maxcode[i]) {
        consume(i + 1);
        return t->values[code + t->delta[i]];
      }
    }
    err.format("failed to decode huffman code");
    return -1;
  }

  // Fused fast-AC (src/huffman.rs:60-78). Returns true with
  // (*value, *run) set, false when the LUT can't resolve (or on error).
  bool decode_fast_ac(const HuffTable* t, int16_t* value, int* run, Error& err) {
    if (!t->ac_lut_run_size) return false;
    if (num_bits < kLutBits && !read_bits(err)) return false;
    uint32_t idx = static_cast<uint32_t>(bits >> 56);
    uint8_t run_size = t->ac_lut_run_size[idx];
    if (run_size == 0) return false;
    consume(run_size & 0x0F);
    *value = t->ac_lut_value[idx];
    *run = run_size >> 4;
    return true;
  }

  int get_bits(int count, Error& err) {
    if (num_bits < count && !read_bits(err)) return -1;
    uint32_t v = peek(count);
    consume(count);
    return static_cast<int>(v);
  }

  // F.2.2.1 receive + extend (src/huffman.rs:93-96,165-173)
  int receive_extend(int count, Error& err) {
    int v = get_bits(count, err);
    if (err) return 0;
    int vt = 1 << (count - 1);
    return v < vt ? v - (1 << count) + 1 : v;
  }

  int take_marker(Error& err) {
    if (!read_bits(err)) return -1;
    int m = marker;
    marker = -1;
    return m;
  }
};

using BitReader = BitReaderT<true>;      // stuffed entropy stream
using RawBitReader = BitReaderT<false>;  // prescan-unstuffed bytes

// Marker display names matching markers.py::name (for error-string parity
// with the Python oracle).
void marker_name(int m, char* out, size_t n) {
  if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) {
    std::snprintf(out, n, "SOF%d", m - 0xC0);
  } else if (m >= 0xD0 && m <= 0xD7) {
    std::snprintf(out, n, "RST%d", m - 0xD0);
  } else if (m >= 0xE0 && m <= 0xEF) {
    std::snprintf(out, n, "APP%d", m - 0xE0);
  } else if (m >= 0xF0 && m <= 0xFD) {
    std::snprintf(out, n, "JPG%d", m - 0xF0);
  } else {
    const char* s = nullptr;
    switch (m) {
      case 0x01: s = "TEM"; break; case 0xC4: s = "DHT"; break;
      case 0xC8: s = "JPG"; break; case 0xCC: s = "DAC"; break;
      case 0xD8: s = "SOI"; break; case 0xD9: s = "EOI"; break;
      case 0xDA: s = "SOS"; break; case 0xDB: s = "DQT"; break;
      case 0xDC: s = "DNL"; break; case 0xDD: s = "DRI"; break;
      case 0xDE: s = "DHP"; break; case 0xDF: s = "EXP"; break;
      case 0xFE: s = "COM"; break; default: break;
    }
    if (s) std::snprintf(out, n, "%s", s);
    else std::snprintf(out, n, "RES(0x%02X)", m);
  }
}

// Tolerant inter-segment marker scan (src/decoder.rs:766-791).
int read_marker(const uint8_t* data, size_t len, size_t* pos) {
  for (;;) {
    while (*pos < len && data[*pos] != 0xFF) (*pos)++;
    if (*pos >= len) return -1;
    (*pos)++;  // consume 0xFF
    while (*pos < len && data[*pos] == 0xFF) (*pos)++;
    if (*pos >= len) return -1;
    uint8_t byte = data[(*pos)++];
    if (byte != 0x00) return byte;
  }
}

// ---------------------------------------------------------------------------
// DCT-mode block decoders
// ---------------------------------------------------------------------------
// Block sinks: where decoded coefficients land. Dense writes natural-order
// int16[64] slices (progressive needs read-modify). Prefix writes the
// streaming interchange format directly — first K zigzag slots densely, the
// rest appended to a COO residual — skipping the 64-coefficient store
// entirely (one fewer 20MB-class write+read+zero per image; the host stage is
// memory-bandwidth-bound).
struct DenseBlock {
  int16_t* p;  // null = dummy
  inline void set_zz(int z, int32_t v) const { if (p) p[UNZIGZAG[z]] = wrap16(v); }
  inline int16_t get_nat(int i) const { return p ? p[i] : static_cast<int16_t>(0); }
  inline void set_nat(int i, int32_t v) const { if (p) p[i] = wrap16(v); }
};

struct ResidBuf {
  int32_t* idx;
  int16_t* vals;
  int64_t count;
  int64_t cap;
};

struct PrefixBlock {
  // Compact interchange layout per block: DC as int16 (slot 0), the next K-1
  // zigzag slots as saturated int8 with int16 correction entries in the
  // residual for the rare |v| > 127 case, everything beyond K as residual
  // COO. ~0.8 bytes/coefficient-slot on the wire vs 2 for dense int16.
  int16_t* dc_slot;    // this block's DC, or null = dummy
  int8_t* ac_slots;    // K-1 int8 AC prefix slots
  int32_t k;
  int64_t flat_base;   // global dense element offset of this block
  ResidBuf* resid;

  inline void append_resid(int z, int32_t v) const {
    if (v != 0 && resid->count < resid->cap) {
      resid->idx[resid->count] = static_cast<int32_t>(flat_base + UNZIGZAG[z]);
      resid->vals[resid->count] = static_cast<int16_t>(v);
      resid->count++;
    }
  }

  inline void set_zz(int z, int32_t v) const {
    if (!dc_slot) return;
    int16_t w = wrap16(v);
    if (z == 0) {
      *dc_slot = w;
    } else if (z < k) {
      int32_t sat = w < -128 ? -128 : (w > 127 ? 127 : w);
      ac_slots[z - 1] = static_cast<int8_t>(sat);
      append_resid(z, static_cast<int32_t>(w) - sat);
    } else {
      append_resid(z, w);
    }
  }
  // Refinement accessors are never exercised in prefix mode (baseline only);
  // present so the template instantiates.
  inline int16_t get_nat(int) const { return 0; }
  inline void set_nat(int, int32_t) const {}
};

// F.2.2 sequential / first-pass progressive
// (src/decoder.rs:1086-1172)
template <class Rdr, class Blk>
bool decode_block(Rdr& r, Blk blk, const HuffTable* dc,
                  const HuffTable* ac, int ss, int se, int al,
                  uint32_t* eob_run, int16_t* dc_pred, Error& err) {
  if (ss == 0) {
    // Fused decode+receive+extend via the 10-bit LUT when enough bits are
    // buffered (refill trigger matches the canonical path, so marker/EOF
    // timing is unchanged).
    if (r.num_bits < 16 && !r.read_bits(err)) return false;
    int32_t diff;
    uint32_t packed = kNoFastDC ? 0 : dc->fast_packed[r.peek(kFastBits)];
    if (packed >> 20) {
      diff = static_cast<int16_t>(packed & 0xFFFF);
      r.consume(packed >> 20);
    } else {
      int value = r.decode(dc, err);
      if (err) return false;
      diff = 0;
      if (value != 0) {
        if (value > 11) {
          err.format("invalid DC difference magnitude category");
          return false;
        }
        diff = r.receive_extend(value, err);
        if (err) return false;
      }
    }
    *dc_pred = wrap16(static_cast<int32_t>(*dc_pred) + diff);
    blk.set_zz(0, shl32(static_cast<int32_t>(*dc_pred), al));
  }

  int index = ss > 1 ? ss : 1;
  if (index < se && *eob_run > 0) {
    (*eob_run)--;
    return true;
  }

  while (index < se) {
    // Fused 1-or-2-symbol AC fast path (huffman.py _build_fast2_lut): ONE
    // 10-bit lookup resolves the next coefficient, and — when the following
    // symbol (a coefficient or an EOB with rr=0) fits the same window,
    // ~1/3 of AC symbols on photographic content — both at once.
    // Exactness: the oracle's refill trigger is <16 buffered bits, so the
    // single is gated at >=16 (taking it with 10-15 bits buffered would
    // skip a refill the oracle performs, and with it the oracle's
    // EOF/marker behavior) and the pair at >=16+c1 (per-entry minbits) so
    // no refill the oracle performs between the two symbols is skipped
    // either. Run-overflow (index + run >= se) falls through to the exact
    // path: the reference's slow path breaks there WITHOUT consuming the
    // magnitude bits (while its 8-bit fast path consumes them), so the
    // shortcut is only an exact shortcut in the no-overflow case.
    if (!kNoFastAC && r.num_bits >= 16 && ac->fast2) {
      const uint64_t e = ac->fast2[r.peek(kFastBits)];
      if (e) {
        if (e & (1ULL << 56)) {    // EOB(rr=0): end of block
          r.consume((e >> 52) & 0xF);
          *eob_run = 0;
          break;
        }
        const int idx1 = index + static_cast<int>((e >> 32) & 0xF);
        if ((e & (1ULL << 51)) &&
            r.num_bits >= static_cast<int>((e >> 46) & 0x1F)) {
          if (e & (1ULL << 45)) {  // coeff + EOB(rr=0)
            if (idx1 + 1 < se) {
              r.consume((e >> 40) & 0x1F);
              blk.set_zz(idx1, shl32(static_cast<int32_t>(
                  static_cast<int16_t>(e & 0xFFFF)), al));
              *eob_run = 0;
              break;
            }
          } else {                 // coeff + coeff
            const int idx2 = idx1 + 1 + static_cast<int>((e >> 36) & 0xF);
            if (idx2 < se) {
              r.consume((e >> 40) & 0x1F);
              blk.set_zz(idx1, shl32(static_cast<int32_t>(
                  static_cast<int16_t>(e & 0xFFFF)), al));
              blk.set_zz(idx2, shl32(static_cast<int32_t>(
                  static_cast<int16_t>((e >> 16) & 0xFFFF)), al));
              index = idx2 + 1;
              continue;
            }
          }
        }
        if (idx1 < se) {           // single coefficient (old fast_packed path)
          r.consume((e >> 52) & 0xF);
          blk.set_zz(idx1, shl32(static_cast<int32_t>(
              static_cast<int16_t>(e & 0xFFFF)), al));
          index = idx1 + 1;
          continue;
        }
      }
    }
    int16_t fav;
    int run;
    if (r.decode_fast_ac(ac, &fav, &run, err)) {
      index += run;
      if (index >= se) break;
      blk.set_zz(index, shl32(static_cast<int32_t>(fav), al));
      index++;
    } else {
      if (err) return false;
      int byte = r.decode(ac, err);
      if (err) return false;
      int rr = byte >> 4;
      int s = byte & 0x0F;
      if (s == 0) {
        if (rr == 15) {
          index += 16;
        } else {
          uint32_t eob = (1u << rr) - 1;
          if (rr > 0) {
            int extra = r.get_bits(rr, err);
            if (err) return false;
            eob += static_cast<uint32_t>(extra);
          }
          *eob_run = eob;
          break;
        }
      } else {
        index += rr;
        if (index >= se) break;
        int v = r.receive_extend(s, err);
        if (err) return false;
        blk.set_zz(index, shl32(static_cast<int32_t>(v), al));
        index++;
      }
    }
  }
  return true;
}

// G.1.2.3 correction-bit pass (src/decoder.rs:1260-1298)
template <class Rdr, class Blk>
int refine_non_zeroes(Rdr& r, Blk blk, int start, int end, int zrl,
                      int bit, Error& err) {
  int last = end - 1;
  int zero_run_length = zrl;
  for (int i = start; i < end; i++) {
    int idx = UNZIGZAG[i];
    int16_t coeff = blk.get_nat(idx);
    if (coeff == 0) {
      if (zero_run_length == 0) return i;
      zero_run_length--;
    } else {
      int b = r.get_bits(1, err);
      if (err) return -1;
      if (b == 1 && (coeff & bit) == 0) {
        int32_t nv = coeff > 0 ? coeff + bit : coeff - bit;
        if (nv < -32768 || nv > 32767) {
          err.format("Coefficient overflow");
          return -1;
        }
        blk.set_nat(idx, nv);
      }
    }
  }
  return last;
}

// G.1.2 refinement scan (src/decoder.rs:1174-1258)
template <class Rdr, class Blk>
bool decode_block_sa(Rdr& r, Blk blk, const HuffTable* ac, int ss,
                     int se, int al, uint32_t* eob_run, Error& err) {
  int bit = 1 << al;
  if (ss == 0) {
    int b = r.get_bits(1, err);
    if (err) return false;
    if (b == 1) blk.set_nat(0, blk.get_nat(0) | bit);
    return true;
  }

  if (*eob_run > 0) {
    (*eob_run)--;
    refine_non_zeroes(r, blk, ss, se, 64, bit, err);
    return !err;
  }

  int index = ss;
  while (index < se) {
    int byte = r.decode(ac, err);
    if (err) return false;
    int rr = byte >> 4;
    int s = byte & 0x0F;
    int zero_run_length = rr;
    int value = 0;
    if (s == 0) {
      if (rr != 15) {
        uint32_t eob = (1u << rr) - 1;
        if (rr > 0) {
          int extra = r.get_bits(rr, err);
          if (err) return false;
          eob += static_cast<uint32_t>(extra);
        }
        *eob_run = eob;
        zero_run_length = 64;
      }
    } else if (s == 1) {
      int b = r.get_bits(1, err);
      if (err) return false;
      value = b == 1 ? bit : -bit;
    } else {
      err.format("unexpected huffman code");
      return false;
    }

    index = refine_non_zeroes(r, blk, index, se, zero_run_length, bit, err);
    if (err) return false;
    if (value != 0) blk.set_zz(index, value);
    index++;
  }
  return true;
}

// ---------------------------------------------------------------------------
// Scan decode (serial over an MCU index range)
// ---------------------------------------------------------------------------
struct McuRange {          // [first, last) in decoded-MCU sequence order
  int64_t first, last;
};

// Decoded-MCU grid size under the reference's mcu*8 >= image clip quirk
// (src/decoder.rs:910-917). The ONLY definition — the quirk
// decides which blocks exist, so every enumeration (serial decode, anchored
// spans, DC fixup, MCU counting) must share it.
inline int64_t scan_cols(const ScanParams& sp) {
  int64_t cols = 0;
  for (int32_t x = 0; x < sp.max_mcu_x; x++) {
    if (static_cast<int64_t>(x) * 8 >= sp.image_w) break;
    cols++;
  }
  return cols;
}

inline int64_t scan_rows(const ScanParams& sp) {
  int64_t rows = 0;
  for (int32_t y = 0; y < sp.max_mcu_y; y++) {
    if (static_cast<int64_t>(y) * 8 >= sp.image_h) break;
    rows++;
  }
  return rows;
}

// Decode MCUs [range) assuming reader is positioned at the range start with
// fresh state. Restart markers are handled only when crossing interval
// boundaries inside the range (serial mode); parallel mode passes ranges that
// never cross a boundary.
template <class Rdr, class MakeBlk>
bool decode_mcu_range(Rdr& r, const ScanParams& sp, const ScanComp* comps,
                      McuRange range, bool handle_restarts, MakeBlk&& make_blk,
                      Error& err, int16_t* dc_pred_out = nullptr) {
  const bool progressive = sp.is_progressive != 0;
  const bool interleaved = sp.ncomp > 1;
  int16_t dc_pred[4] = {0, 0, 0, 0};
  uint32_t eob_run = 0;
  int expected_rst = 0;
  uint32_t mcus_left = static_cast<uint32_t>(sp.restart_interval);

  // The reference's decoded-MCU enumeration with its row/column breaks
  // always covers a rectangle, so a range maps directly to
  // (y, x) = (seq / cols, seq % cols).
  const int64_t cols = scan_cols(sp);
  if (cols == 0) return true;

  for (int64_t seq = range.first; seq < range.last; seq++) {
    {
      const int32_t mcu_y = static_cast<int32_t>(seq / cols);
      const int32_t mcu_x = static_cast<int32_t>(seq % cols);

      if (handle_restarts && sp.restart_interval > 0) {
        if (mcus_left == 0) {
          int m = r.take_marker(err);
          if (err) return false;
          if (m < 0) {
            char buf[96];
            std::snprintf(buf, sizeof buf, "no marker found where RST%d was expected",
                          expected_rst);
            err.format(buf);
            return false;
          }
          if (m < 0xD0 || m > 0xD7) {
            char name[24];
            marker_name(m, name, sizeof name);
            char buf[96];
            std::snprintf(buf, sizeof buf,
                          "found marker %s inside scan where RST%d was expected",
                          name, expected_rst);
            err.format(buf);
            return false;
          }
          if (m - 0xD0 != expected_rst) {
            char buf[96];
            std::snprintf(buf, sizeof buf, "found RST%d where RST%d was expected",
                          m - 0xD0, expected_rst);
            err.format(buf);
            return false;
          }
          r.reset();
          dc_pred[0] = dc_pred[1] = dc_pred[2] = dc_pred[3] = 0;
          eob_run = 0;
          expected_rst = (expected_rst + 1) % 8;
          mcus_left = static_cast<uint32_t>(sp.restart_interval);
        }
        mcus_left--;
      }

      for (int32_t i = 0; i < sp.ncomp; i++) {
        const ScanComp& c = comps[i];
        for (int32_t v = 0; v < c.v_samp; v++) {
          for (int32_t h = 0; h < c.h_samp; h++) {
            int64_t by = static_cast<int64_t>(mcu_y) * c.v_samp + v;
            int64_t bx = static_cast<int64_t>(mcu_x) * c.h_samp + h;
            auto blk = make_blk(i, by * c.block_width + bx);
            bool ok;
            if (sp.ah == 0) {
              ok = decode_block(r, blk, c.dc, c.ac, sp.ss, sp.se, sp.al,
                                &eob_run, &dc_pred[i], err);
            } else {
              ok = decode_block_sa(r, blk, c.ac, sp.ss, sp.se, sp.al,
                                   &eob_run, err);
            }
            if (!ok) return false;
          }
        }
      }
    }
  }
  if (dc_pred_out) {
    for (int i = 0; i < 4; i++) dc_pred_out[i] = dc_pred[i];
  }
  return true;
}

// Scan the entropy stream for RSTn positions delimiting `nseg` restart
// segments starting at `start`. Returns true when the expected modulo-8
// sequence was found in full (irregular streams fall back to serial decode).
bool scan_restart_segments(const uint8_t* data, size_t len, size_t start,
                           int64_t nseg, std::vector<size_t>* seg_start) {
  seg_start->clear();
  seg_start->push_back(start);
  size_t p = start;
  int expect = 0;
  while (static_cast<int64_t>(seg_start->size()) < nseg && p + 1 < len) {
    if (data[p] == 0xFF) {
      uint8_t m = data[p + 1];
      if (m >= 0xD0 && m <= 0xD7) {
        if (m - 0xD0 != expect) return false;
        expect = (expect + 1) % 8;
        seg_start->push_back(p + 2);
        p += 2;
        continue;
      }
      if (m != 0x00 && m != 0xFF) break;  // real marker: end of scan data
      p += 2;
      continue;
    }
    p++;
  }
  return static_cast<int64_t>(seg_start->size()) == nseg;
}

int64_t count_decoded_mcus(const ScanParams& sp) {
  return scan_rows(sp) * scan_cols(sp);
}

// ---------------------------------------------------------------------------
// Host reconstruction tier: exact integer dequant+IDCT, upsampling, and color
// conversion for the CPU (numpy-backend) path. Bit-identical to the
// reference's scalar kernels (src/idct.rs, upsampler.rs,
// decoder.rs color fns) and to this package's vectorized oracle.
// ---------------------------------------------------------------------------

// stb constants x 2^12 (match ops/idct.py's f32-derived values).
enum : int32_t {
  K0541 = 2217, KM1847 = -7567, K0765 = 3135, K1175 = 4816,
  K0298 = 1223, K2053 = 8410, K3072 = 12586, K1501 = 6149,
  KM0899 = -3685, KM2562 = -10497, KM1961 = -8034, KM0390 = -1597,
};

static inline uint8_t clamp_u8(int32_t x) {
  return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
}

// 8x8 exact stb IDCT with the reference's zero-AC-column shortcut
// (src/idct.rs:241-370). All arithmetic wraps (unsigned mul).
static void idct8_block(const int16_t* c, const uint16_t* q, uint8_t* out,
                        int64_t stride) {
  int32_t temp[64];
  auto M = [](int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
  };
  for (int i = 0; i < 8; i++) {
    if (c[i + 8] == 0 && c[i + 16] == 0 && c[i + 24] == 0 && c[i + 32] == 0 &&
        c[i + 40] == 0 && c[i + 48] == 0 && c[i + 56] == 0) {
      int32_t dc = shl32(M(c[i], q[i]), 2);
      for (int k = 0; k < 8; k++) temp[i + 8 * k] = dc;
    } else {
      int32_t s0 = M(c[i], q[i]), s1 = M(c[i + 8], q[i + 8]);
      int32_t s2 = M(c[i + 16], q[i + 16]), s3 = M(c[i + 24], q[i + 24]);
      int32_t s4 = M(c[i + 32], q[i + 32]), s5 = M(c[i + 40], q[i + 40]);
      int32_t s6 = M(c[i + 48], q[i + 48]), s7 = M(c[i + 56], q[i + 56]);
      int32_t p1 = M(s2 + s6, K0541);
      int32_t t2 = p1 + M(s6, KM1847), t3 = p1 + M(s2, K0765);
      int32_t t0 = shl32(s0 + s4, 12), t1 = shl32(s0 - s4, 12);
      int32_t x0 = t0 + t3 + 512, x3 = t0 - t3 + 512;
      int32_t x1 = t1 + t2 + 512, x2 = t1 - t2 + 512;
      int32_t u0 = s7, u1 = s5, u2 = s3, u3 = s1;
      int32_t q3 = u0 + u2, q4 = u1 + u3, q1 = u0 + u3, q2 = u1 + u2;
      int32_t q5 = M(q3 + q4, K1175);
      u0 = M(u0, K0298); u1 = M(u1, K2053); u2 = M(u2, K3072); u3 = M(u3, K1501);
      q1 = q5 + M(q1, KM0899); q2 = q5 + M(q2, KM2562);
      q3 = M(q3, KM1961); q4 = M(q4, KM0390);
      u3 += q1 + q4; u2 += q2 + q3; u1 += q2 + q4; u0 += q1 + q3;
      temp[i] = (x0 + u3) >> 10;      temp[i + 56] = (x0 - u3) >> 10;
      temp[i + 8] = (x1 + u2) >> 10;  temp[i + 48] = (x1 - u2) >> 10;
      temp[i + 16] = (x2 + u1) >> 10; temp[i + 40] = (x2 - u1) >> 10;
      temp[i + 24] = (x3 + u0) >> 10; temp[i + 32] = (x3 - u0) >> 10;
    }
  }
  const int32_t X_SCALE = 65536 + (128 << 17);
  for (int r = 0; r < 8; r++) {
    const int32_t* s = temp + r * 8;
    uint8_t* o = out + r * stride;
    int32_t p1 = M(s[2] + s[6], K0541);
    int32_t t2 = p1 + M(s[6], KM1847), t3 = p1 + M(s[2], K0765);
    int32_t t0 = shl32(s[0] + s[4], 12), t1 = shl32(s[0] - s[4], 12);
    int32_t x0 = t0 + t3 + X_SCALE, x3 = t0 - t3 + X_SCALE;
    int32_t x1 = t1 + t2 + X_SCALE, x2 = t1 - t2 + X_SCALE;
    int32_t u0 = s[7], u1 = s[5], u2 = s[3], u3 = s[1];
    int32_t q3 = u0 + u2, q4 = u1 + u3, q1 = u0 + u3, q2 = u1 + u2;
    int32_t q5 = M(q3 + q4, K1175);
    u0 = M(u0, K0298); u1 = M(u1, K2053); u2 = M(u2, K3072); u3 = M(u3, K1501);
    q1 = q5 + M(q1, KM0899); q2 = q5 + M(q2, KM2562);
    q3 = M(q3, KM1961); q4 = M(q4, KM0390);
    u3 += q1 + q4; u2 += q2 + q3; u1 += q2 + q4; u0 += q1 + q3;
    o[0] = clamp_u8((x0 + u3) >> 17); o[7] = clamp_u8((x0 - u3) >> 17);
    o[1] = clamp_u8((x1 + u2) >> 17); o[6] = clamp_u8((x1 - u2) >> 17);
    o[2] = clamp_u8((x2 + u1) >> 17); o[5] = clamp_u8((x2 - u1) >> 17);
    o[3] = clamp_u8((x3 + u0) >> 17); o[4] = clamp_u8((x3 - u0) >> 17);
  }
}

static void idct4_block(const int16_t* c, const uint16_t* q, uint8_t* out,
                        int64_t stride) {
  int32_t temp[16];
  auto M = [](int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
  };
  for (int i = 0; i < 4; i++) {
    int32_t s0 = M(c[i], q[i]), s1 = M(c[i + 8], q[i + 8]);
    int32_t s2 = M(c[i + 16], q[i + 16]), s3 = M(c[i + 24], q[i + 24]);
    int32_t x0 = shl32(s0 + s2, 2), x2 = shl32(s0 - s2, 2);
    int32_t p1 = M(s1 + s3, K0541);
    int32_t t0 = (p1 + M(s3, KM1847) + 512) >> 10;
    int32_t t2 = (p1 + M(s1, K0765) + 512) >> 10;
    temp[i] = x0 + t2; temp[i + 12] = x0 - t2;
    temp[i + 4] = x2 + t0; temp[i + 8] = x2 - t0;
  }
  const int32_t FINAL = 17;
  for (int r = 0; r < 4; r++) {
    const int32_t* s = temp + r * 4;
    uint8_t* o = out + r * stride;
    int32_t x0 = shl32(s[0] + s[2], 12), x2 = shl32(s[0] - s[2], 12);
    int32_t p1 = M(s[1] + s[3], K0541);
    int32_t t0 = p1 + M(s[3], KM1847), t2 = p1 + M(s[1], K0765);
    x0 += (1 << 16) + (128 << 17); x2 += (1 << 16) + (128 << 17);
    o[0] = clamp_u8((x0 + t2) >> FINAL); o[3] = clamp_u8((x0 - t2) >> FINAL);
    o[1] = clamp_u8((x2 + t0) >> FINAL); o[2] = clamp_u8((x2 - t0) >> FINAL);
  }
}

static void idct2_block(const int16_t* c, const uint16_t* q, uint8_t* out,
                        int64_t stride) {
  auto M = [](int32_t a, int32_t b) {
    return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
  };
  int32_t s00 = M(c[0], q[0]), s10 = M(c[8], q[8]);
  int32_t s01 = M(c[1], q[1]), s11 = M(c[9], q[9]);
  int32_t x0 = s00 + s10 + 4 + (128 << 3), x2 = s00 - s10 + 4 + (128 << 3);
  int32_t x1 = s01 + s11, x3 = s01 - s11;
  out[0] = clamp_u8((x0 + x1) >> 3); out[1] = clamp_u8((x0 - x1) >> 3);
  out[stride] = clamp_u8((x2 + x3) >> 3); out[stride + 1] = clamp_u8((x2 - x3) >> 3);
}

static void idct1_block(const int16_t* c, const uint16_t* q, uint8_t* out,
                        int64_t) {
  int32_t v = static_cast<int32_t>(
      static_cast<uint32_t>(c[0]) * static_cast<uint32_t>(q[0]) + 1024u);
  out[0] = clamp_u8(v / 8);  // trunc division, matching Wrapping<i32>/8
}

// Color constants x 2^20 (match ops/color.py).
enum : int32_t { C1402 = 1470104, C0344 = 360857, C0714 = 748830, C1772 = 1858077 };

static inline void ycbcr_px(int32_t y, int32_t cb, int32_t cr, uint8_t* o) {
  int32_t yy = y * (1 << 20) + (1 << 19);
  cb -= 128; cr -= 128;
  auto cl = [](int32_t v) {
    v >>= 20; return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  };
  o[0] = cl(yy + C1402 * cr);
  o[1] = cl(yy - C0344 * cb - C0714 * cr);
  o[2] = cl(yy + C1772 * cb);
}

struct UpsampleSpec {           // mirrors the ctypes struct in native_impl
  const uint8_t* plane;
  int64_t stride;
  int32_t width, height;        // component.size
  int32_t mode;                 // 0 h1v1, 1 h2v1, 2 h1v2, 3 h2v2, 4 generic
  int32_t h_scale, v_scale;
};

// One output row of one component into `line` (reference row semantics,
// src/upsampler.rs:107-250).
static void upsample_row(const UpsampleSpec& s, int32_t row, int32_t out_w,
                         uint8_t* line) {
  const int32_t w = s.width;
  if (s.mode == 0) {  // h1v1
    std::memcpy(line, s.plane + static_cast<int64_t>(row) * s.stride, out_w);
    return;
  }
  if (s.mode == 1) {  // h2v1
    const uint8_t* in = s.plane + static_cast<int64_t>(row) * s.stride;
    if (w == 1) { line[0] = in[0]; if (out_w > 1) line[1] = in[0]; return; }
    uint8_t tmp0 = in[0];
    line[0] = tmp0;
    if (out_w > 1) line[1] = static_cast<uint8_t>((in[0] * 3u + in[1] + 2) >> 2);
    for (int32_t i = 1; i < w - 1; i++) {
      uint32_t sample = 3u * in[i] + 2;
      if (2 * i < out_w) line[2 * i] = static_cast<uint8_t>((sample + in[i - 1]) >> 2);
      if (2 * i + 1 < out_w) line[2 * i + 1] = static_cast<uint8_t>((sample + in[i + 1]) >> 2);
    }
    if (2 * (w - 1) < out_w)
      line[2 * (w - 1)] = static_cast<uint8_t>((in[w - 1] * 3u + in[w - 2] + 2) >> 2);
    if (2 * (w - 1) + 1 < out_w) line[2 * (w - 1) + 1] = in[w - 1];
    return;
  }
  // V2 modes: near/far rows.
  int32_t near = row / 2;
  int32_t far = (row % 2 == 0) ? near - 1 : near + 1;
  if (far < 0) far = 0;
  if (far > s.height - 1) far = s.height - 1;
  const uint8_t* in_n = s.plane + static_cast<int64_t>(near) * s.stride;
  const uint8_t* in_f = s.plane + static_cast<int64_t>(far) * s.stride;
  if (s.mode == 2) {  // h1v2
    for (int32_t i = 0; i < out_w; i++)
      line[i] = static_cast<uint8_t>((3u * in_n[i] + in_f[i] + 2) >> 2);
    return;
  }
  if (s.mode == 3) {  // h2v2
    if (w == 1) {
      uint8_t v = static_cast<uint8_t>((3u * in_n[0] + in_f[0] + 2) >> 2);
      line[0] = v; if (out_w > 1) line[1] = v;
      return;
    }
    uint32_t t1 = 3u * in_n[0] + in_f[0];
    line[0] = static_cast<uint8_t>((t1 + 2) >> 2);
    for (int32_t i = 1; i < w; i++) {
      uint32_t t0 = t1;
      t1 = 3u * in_n[i] + in_f[i];
      if (2 * i - 1 < out_w) line[2 * i - 1] = static_cast<uint8_t>((3 * t0 + t1 + 8) >> 4);
      if (2 * i < out_w) line[2 * i] = static_cast<uint8_t>((3 * t1 + t0 + 8) >> 4);
    }
    if (2 * w - 1 < out_w) line[2 * w - 1] = static_cast<uint8_t>((t1 + 2) >> 2);
    return;
  }
  // generic NN
  const uint8_t* in = s.plane + static_cast<int64_t>(row / s.v_scale) * s.stride;
  int32_t idx = 0;
  for (int32_t i = 0; i < w && idx < out_w; i++)
    for (int32_t k = 0; k < s.h_scale && idx < out_w; k++) line[idx++] = in[i];
}

}  // namespace

extern "C" {

// Exact dequant+IDCT of a full component block grid into a u8 plane.
void jt_idct_component(const int16_t* coeffs, const uint16_t* qt, int64_t bw,
                       int64_t bh, int32_t scale, uint8_t* plane,
                       int64_t stride, int32_t nthreads) {
  auto run = [&](int64_t b0, int64_t b1) {
    for (int64_t b = b0; b < b1; b++) {
      int64_t by = b / bw, bx = b % bw;
      uint8_t* out = plane + by * scale * stride + bx * scale;
      const int16_t* c = coeffs + b * 64;
      switch (scale) {
        case 8: idct8_block(c, qt, out, stride); break;
        case 4: idct4_block(c, qt, out, stride); break;
        case 2: idct2_block(c, qt, out, stride); break;
        default: idct1_block(c, qt, out, stride); break;
      }
    }
  };
  int64_t n = bw * bh;
  if (nthreads > 1 && n > 4096) {
    std::vector<std::thread> ts;
    int64_t chunk = (n + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
      int64_t a = t * chunk, b = std::min(n, a + chunk);
      if (a < b) ts.emplace_back(run, a, b);
    }
    for (auto& th : ts) th.join();
  } else {
    run(0, n);
  }
}

// Upsample + color-convert a whole image.
// transform: 0 raw/planar-rows, 1 rgb, 2 ycbcr, 3 cmyk, 4 ycck.
void jt_upsample_color(const UpsampleSpec* comps, int32_t ncomp,
                       int32_t transform, int32_t out_w, int32_t out_h,
                       uint8_t* out, int32_t nthreads) {
  auto run = [&](int32_t r0, int32_t r1) {
    std::vector<std::vector<uint8_t>> lines(ncomp);
    for (auto& l : lines) l.resize(out_w);
    for (int32_t row = r0; row < r1; row++) {
      for (int32_t ci = 0; ci < ncomp; ci++)
        upsample_row(comps[ci], row, out_w, lines[ci].data());
      uint8_t* o = out + static_cast<int64_t>(row) * out_w * ncomp;
      switch (transform) {
        case 0:  // raw: per-row planar concatenation (color_no_convert)
          for (int32_t ci = 0; ci < ncomp; ci++)
            std::memcpy(o + static_cast<int64_t>(ci) * out_w,
                        lines[ci].data(), out_w);
          break;
        case 1:  // rgb passthrough interleave
          for (int32_t i = 0; i < out_w; i++)
            for (int32_t ci = 0; ci < ncomp; ci++) o[i * ncomp + ci] = lines[ci][i];
          break;
        case 2:  // ycbcr
          for (int32_t i = 0; i < out_w; i++)
            ycbcr_px(lines[0][i], lines[1][i], lines[2][i], o + i * 3);
          break;
        case 3:  // cmyk (Adobe inverted)
          for (int32_t i = 0; i < out_w; i++)
            for (int32_t ci = 0; ci < 4; ci++)
              o[i * 4 + ci] = static_cast<uint8_t>(255 - lines[ci][i]);
          break;
        default:  // ycck
          for (int32_t i = 0; i < out_w; i++) {
            ycbcr_px(lines[0][i], lines[1][i], lines[2][i], o + i * 4);
            o[i * 4 + 3] = static_cast<uint8_t>(255 - lines[3][i]);
          }
          break;
      }
    }
  };
  if (nthreads > 1 && static_cast<int64_t>(out_h) * out_w > 128 * 1024) {
    std::vector<std::thread> ts;
    int32_t chunk = (out_h + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
      int32_t a = t * chunk, b = std::min(out_h, a + chunk);
      if (a < b) ts.emplace_back(run, a, b);
    }
    for (auto& th : ts) th.join();
  } else {
    run(0, out_h);
  }
}

// ABI handshake: Python refuses to use a library whose struct layouts don't
// match its ctypes mirrors (guards against stale .so builds mid-upgrade).
int64_t jt_abi_version() { return 15; }

// 4 B/chunk delta-wire metadata pack (ABI 15): one pass over the prescan's
// anchor arrays emitting the per-chunk u32 (anchor-bit delta 23 | block
// budget 5 | entry slot 4), the budget-0 terminator word, and per-class
// (count, max symbols) for the slot-size classes. Byte-identical to the
// numpy mirror in entropy/pallas_decode.py::pack_delta (differentially
// tested); returns 1 (fallback) on any field overflow or ordering quirk —
// the caller degrades the scan to the words-packed wire.
//   a_block has n+1 entries (prescan emits the closing block count);
//   dm must hold n+1 words; cls_count/cls_syms hold 8 each.
int jt_pack_delta(const uint32_t* a_bits, const int32_t* a_block,
                  const int32_t* a_slot, const uint32_t* c_end,
                  const int32_t* c_syms, int64_t n,
                  uint32_t* dm, int32_t* cls_count, int32_t* cls_syms) {
  static const int32_t kCls[7] = {32, 48, 64, 96, 128, 256, 512};
  if (n <= 0 || a_block[0] != 0) return 1;
  for (int i = 0; i < 8; i++) { cls_count[i] = 0; cls_syms[i] = 0; }
  const uint32_t end_last = c_end[n - 1];
  uint32_t prev = 0;
  for (int64_t i = 0; i < n; i++) {
    const uint32_t ab = a_bits[i];
    const int64_t d = (int64_t)ab - (int64_t)prev;
    if (d < 0 || d >= (1 << 23)) return 1;
    const int32_t budget = a_block[i + 1] - a_block[i];
    const int32_t slot0 = a_slot[i];
    if (budget < 1 || budget > 31 || slot0 < 0 || slot0 > 15) return 1;
    const uint32_t next = (i + 1 < n) ? a_bits[i + 1] : end_last;
    if ((int64_t)next < (int64_t)ab) return 1;
    const int32_t span = (int32_t)((next >> 3) - (ab >> 3)) + 9;
    // The delta-implied window must cover the recorded symbol span.
    if ((int32_t)((c_end[i] >> 3) - (ab >> 3)) + 9 > span) return 1;
    int ci = 0;
    while (ci < 7 && span > kCls[ci]) ci++;
    if (ci == 7) return 1;
    cls_count[ci]++;
    if (c_syms[i] > cls_syms[ci]) cls_syms[ci] = c_syms[i];
    dm[i] = ((uint32_t)d << 9) | ((uint32_t)budget << 4) | (uint32_t)slot0;
    prev = ab;
  }
  const int64_t dlast = (int64_t)end_last - (int64_t)a_bits[n - 1];
  if (dlast < 0 || dlast >= (1 << 23)) return 1;
  dm[n] = (uint32_t)dlast << 9;
  return 0;
}


// Returns Err code; on ERR_FORMAT err_msg (len >=160) holds the message.
// sp->pos is advanced; sp->out_marker receives the pending marker (-1 none).
int jt_decode_scan_dct(const uint8_t* data, uint64_t len, ScanParams* sp,
                       const ScanComp* comps, char* err_msg) {
  Error err;
  sp->out_marker = -1;

  const int64_t total_mcus = count_decoded_mcus(*sp);
  bool parallel_done = false;
  auto dense_blk = [&](int32_t i, int64_t block_index) {
    const ScanComp& c = comps[i];
    return DenseBlock{c.store ? c.store + block_index * 64 : nullptr};
  };


  if (sp->restart_interval > 0 && sp->nthreads > 1 &&
      total_mcus > 4 * sp->restart_interval) {
    // Segment-parallel path: split at RSTn byte positions. Entropy data for
    // segment k starts right after the k-th RST marker. Fall back to serial
    // on any irregularity.
    int64_t nseg = (total_mcus + sp->restart_interval - 1) / sp->restart_interval;
    std::vector<size_t> seg_start;  // byte pos where each segment's data begins
    if (scan_restart_segments(data, len, static_cast<size_t>(sp->pos), nseg,
                              &seg_start)) {
      int nt = sp->nthreads;
      std::vector<std::thread> threads;
      std::atomic<int64_t> next_seg{0};
      std::atomic<bool> irregular{false};
      for (int t = 0; t < nt; t++) {
        threads.emplace_back([&]() {
          for (;;) {
            int64_t s = next_seg.fetch_add(1);
            if (s >= nseg || irregular.load(std::memory_order_relaxed)) return;
            BitReader r(data, len, seg_start[s]);
            McuRange range{s * sp->restart_interval,
                           std::min<int64_t>((s + 1) * sp->restart_interval,
                                             total_mcus)};
            Error e;
            if (!decode_mcu_range(r, *sp, comps, range, /*restarts=*/false, dense_blk, e)) {
              irregular.store(true);
              return;
            }
            if (s < nseg - 1) {
              // Faithful restart validation: the segment must end with the
              // expected RSTn reachable by a reservoir refill, exactly as the
              // reference's take_marker would see it
              // (src/decoder.rs:920-952).
              int m = r.take_marker(e);
              if (e || m != 0xD0 + static_cast<int>(s % 8)) {
                irregular.store(true);
                return;
              }
            }
          }
        });
      }
      for (auto& th : threads) th.join();

      if (irregular.load()) {
        // Any anomaly: wipe partial writes and rerun serially so error
        // semantics (and partial-decode state) match the reference exactly.
        for (int32_t i = 0; i < sp->ncomp; i++) {
          if (comps[i].store) {
            std::memset(comps[i].store, 0,
                        static_cast<size_t>(comps[i].store_elems) * sizeof(int16_t));
          }
        }
      } else {
        // Finish: position a reader at the start of the final segment's data
        // and skim to the scan-terminating marker like the serial path.
        BitReader r(data, len, seg_start[nseg - 1]);
        McuRange last{(nseg - 1) * sp->restart_interval, total_mcus};
        Error e2;
        if (!decode_mcu_range(r, *sp, comps, last, false, dense_blk, e2)) {
          if (e2.code == ERR_FORMAT && err_msg) std::snprintf(err_msg, 160, "%s", e2.msg);
          return e2.code;
        }
        int marker = r.take_marker(e2);
        if (e2) {
          if (e2.code == ERR_FORMAT && err_msg) std::snprintf(err_msg, 160, "%s", e2.msg);
          return e2.code;
        }
        while (marker >= 0xD0 && marker <= 0xD7) {
          marker = read_marker(data, len, &r.pos);
        }
        sp->out_marker = marker;
        sp->pos = static_cast<int64_t>(r.pos);
        parallel_done = true;
      }
    }
  }

  if (!parallel_done) {
    BitReader r(data, len, static_cast<size_t>(sp->pos));
    if (!decode_mcu_range(r, *sp, comps, McuRange{0, total_mcus},
                          /*restarts=*/true, dense_blk, err)) {
      if (err.code == ERR_FORMAT && err_msg) std::snprintf(err_msg, 160, "%s", err.msg);
      return err.code;
    }
    // End-of-scan marker recovery (src/decoder.rs:1063-1066).
    int marker = r.take_marker(err);
    if (err) {
      if (err.code == ERR_FORMAT && err_msg) std::snprintf(err_msg, 160, "%s", err.msg);
      return err.code;
    }
    while (marker >= 0xD0 && marker <= 0xD7) {
      marker = read_marker(data, len, &r.pos);
    }
    sp->out_marker = marker;
    sp->pos = static_cast<int64_t>(r.pos);
  }
  return OK;
}

// Prefix-mode scan decode: baseline (non-progressive) scans emit the
// zigzag-prefix + COO-residual interchange format directly, with no dense
// coefficient store. pcomps aligns with comps; resid_count is cumulative
// across scans (in/out).
struct PrefixComp {
  int16_t* dc;      // [nblocks] int16 DC plane (zero-initialized), or null = dummy
  int8_t* ac;       // [nblocks, K-1] int8 AC prefix (zero-initialized)
  int64_t base;     // global dense element offset of this component
  int64_t nblocks;  // block count (for wipe on parallel fallback)
};

int jt_decode_scan_dct_prefix(const uint8_t* data, uint64_t len, ScanParams* sp,
                              const ScanComp* comps, const PrefixComp* pcomps,
                              int32_t prefix_k, int32_t* resid_idx,
                              int16_t* resid_vals, int64_t resid_cap,
                              int64_t* resid_count, char* err_msg) {
  Error err;
  sp->out_marker = -1;
  const int64_t total_mcus = count_decoded_mcus(*sp);

  auto make_prefix_blk = [&](ResidBuf* resid) {
    return [=](int32_t i, int64_t block_index) {
      const PrefixComp& pc = pcomps[i];
      return PrefixBlock{
          pc.dc ? pc.dc + block_index : nullptr,
          pc.ac ? pc.ac + block_index * (prefix_k - 1) : nullptr,
          prefix_k,
          pc.base + block_index * 64,
          resid};
    };
  };

  // Restart-segment parallel path (streaming variant): per-thread residual
  // regions keep appends race-free; any anomaly (validation failure, region
  // overflow) wipes the outputs and falls back to the exact serial decode.
  if (sp->restart_interval > 0 && sp->nthreads > 1 &&
      total_mcus > 4 * sp->restart_interval) {
    int64_t nseg = (total_mcus + sp->restart_interval - 1) / sp->restart_interval;
    std::vector<size_t> seg_start;
    if (scan_restart_segments(data, len, static_cast<size_t>(sp->pos), nseg,
                              &seg_start)) {
      int nt = sp->nthreads;
      int64_t region = (resid_cap - *resid_count) / nt;
      std::vector<ResidBuf> regions(nt);
      for (int t = 0; t < nt; t++) {
        regions[t] = ResidBuf{resid_idx + *resid_count + t * region,
                              resid_vals + *resid_count + t * region, 0, region};
      }
      std::vector<std::thread> threads;
      std::atomic<int64_t> next_seg{0};
      std::atomic<bool> irregular{false};
      // The final segment is decoded on the caller thread afterwards so its
      // reader can finish the scan (marker skim); threads take 0..nseg-2.
      for (int t = 0; t < nt; t++) {
        threads.emplace_back([&, t]() {
          auto blk = make_prefix_blk(&regions[t]);
          for (;;) {
            int64_t s = next_seg.fetch_add(1);
            if (s >= nseg - 1 || irregular.load(std::memory_order_relaxed)) return;
            BitReader r(data, len, seg_start[s]);
            McuRange range{s * sp->restart_interval,
                           std::min<int64_t>((s + 1) * sp->restart_interval,
                                             total_mcus)};
            Error e;
            if (!decode_mcu_range(r, *sp, comps, range, /*restarts=*/false,
                                  blk, e)) {
              irregular.store(true);
              return;
            }
            int m = r.take_marker(e);
            if (e || m != 0xD0 + static_cast<int>(s % 8) ||
                regions[t].count >= regions[t].cap) {
              irregular.store(true);
              return;
            }
          }
        });
      }
      for (auto& th : threads) th.join();

      bool ok = !irregular.load();
      ResidBuf last_resid{resid_idx, resid_vals, *resid_count, resid_cap};
      if (ok) {
        // Compact per-thread regions into the contiguous prefix (order is
        // irrelevant: the device scatter accepts unsorted entries).
        int64_t k = *resid_count;
        for (int t = 0; t < nt; t++) {
          if (regions[t].idx != resid_idx + k && regions[t].count > 0) {
            std::memmove(resid_idx + k, regions[t].idx,
                         regions[t].count * sizeof(int32_t));
            std::memmove(resid_vals + k, regions[t].vals,
                         regions[t].count * sizeof(int16_t));
          }
          k += regions[t].count;
        }
        last_resid.count = k;

        // Final segment on this thread, then the scan-finish marker skim.
        auto blk = make_prefix_blk(&last_resid);
        BitReader r(data, len, seg_start[nseg - 1]);
        McuRange range{(nseg - 1) * sp->restart_interval, total_mcus};
        Error e2;
        if (decode_mcu_range(r, *sp, comps, range, false, blk, e2)) {
          int marker = r.take_marker(e2);
          if (!e2) {
            while (marker >= 0xD0 && marker <= 0xD7) {
              marker = read_marker(data, len, &r.pos);
            }
            sp->out_marker = marker;
            sp->pos = static_cast<int64_t>(r.pos);
            *resid_count = last_resid.count;
            return OK;
          }
        }
        ok = false;  // last segment failed: fall back serially
      }

      if (!ok) {
        // Wipe partial prefix writes; residual region entries beyond the
        // incoming count are simply abandoned (count not advanced).
        for (int32_t i = 0; i < sp->ncomp; i++) {
          if (pcomps[i].dc) {
            std::memset(pcomps[i].dc, 0,
                        static_cast<size_t>(pcomps[i].nblocks) * sizeof(int16_t));
          }
          if (pcomps[i].ac) {
            std::memset(pcomps[i].ac, 0,
                        static_cast<size_t>(pcomps[i].nblocks) * (prefix_k - 1));
          }
        }
      }
    }
  }

  ResidBuf resid{resid_idx, resid_vals, *resid_count, resid_cap};
  auto prefix_blk = make_prefix_blk(&resid);

  BitReader r(data, len, static_cast<size_t>(sp->pos));
  if (!decode_mcu_range(r, *sp, comps, McuRange{0, total_mcus},
                        /*restarts=*/true, prefix_blk, err)) {
    if (err.code == ERR_FORMAT && err_msg) std::snprintf(err_msg, 160, "%s", err.msg);
    return err.code;
  }
  int marker = r.take_marker(err);
  if (err) {
    if (err.code == ERR_FORMAT && err_msg) std::snprintf(err_msg, 160, "%s", err.msg);
    return err.code;
  }
  while (marker >= 0xD0 && marker <= 0xD7) {
    marker = read_marker(data, len, &r.pos);
  }
  sp->out_marker = marker;
  sp->pos = static_cast<int64_t>(r.pos);
  *resid_count = resid.count;
  return OK;
}

// ---------------------------------------------------------------------------
// Anchored parallel decode (non-DRI intra-image entropy parallelism).
//
// jt_prescan_baseline's symbol-length walk records bitstream anchors at
// block boundaries. Threads re-decode disjoint MCU spans of the unstuffed
// stream starting at MCU-aligned anchors with DC predictors seeded to zero;
// because the DC plane is a plain mod-2^16 running sum of diffs
// (src/decoder.rs:1098-1101 + wrapping add), each span's
// true values are its local values plus the sum of all earlier spans' diff
// totals — applied afterwards as one constant per (span, component). AC
// coefficients carry no cross-block state in sequential scans (EOB-run codes
// make the prescan fall back), so spans are otherwise independent. Output is
// byte-identical to the serial decode; any anomaly wipes and reports
// fallback so the caller reruns serially.
// ---------------------------------------------------------------------------
}  // extern "C" — the span helpers below include a template (C++ linkage)

namespace {

struct AnchorSpan {
  int64_t mcu0, mcu1;  // [mcu0, mcu1)
  int64_t bit0;        // start bit offset into the unstuffed buffer
  int64_t bit1;        // expected end bit (-1: unchecked, last span)
};

// Partition the anchor list into ~even MCU-aligned spans (anchors with
// slot 0 at an MCU boundary). Empty result = not enough split points.
std::vector<AnchorSpan> build_anchor_spans(
    const uint32_t* anchor_bits, const int32_t* anchor_block,
    const int32_t* anchor_slot, int64_t n_anchors, int64_t blocks_per_mcu,
    int64_t total_mcus, int nt) {
  std::vector<AnchorSpan> spans;
  if (n_anchors == 0 || blocks_per_mcu <= 0) return spans;
  if (anchor_block[0] != 0 || anchor_slot[0] != 0) return spans;

  std::vector<std::pair<int64_t, int64_t>> cand;  // (mcu, bit)
  cand.reserve(n_anchors / 4 + 1);
  for (int64_t i = 0; i < n_anchors; i++) {
    if (anchor_slot[i] == 0 && anchor_block[i] % blocks_per_mcu == 0) {
      cand.emplace_back(anchor_block[i] / blocks_per_mcu,
                        static_cast<int64_t>(anchor_bits[i]));
    }
  }
  if (cand.size() < 2) return spans;

  int64_t prev_mcu = 0, prev_bit = cand[0].second;
  size_t ci = 0;
  for (int t = 1; t < nt; t++) {
    int64_t target = total_mcus * t / nt;
    while (ci < cand.size() && cand[ci].first < target) ci++;
    if (ci >= cand.size()) break;
    if (cand[ci].first <= prev_mcu || cand[ci].first >= total_mcus) continue;
    spans.push_back({prev_mcu, cand[ci].first, prev_bit, cand[ci].second});
    prev_mcu = cand[ci].first;
    prev_bit = cand[ci].second;
  }
  spans.push_back({prev_mcu, total_mcus, prev_bit, -1});
  return spans;
}

// Iterate the block indices of MCUs [m0, m1) in decode order, invoking
// fn(comp_index, block_index) — the same enumeration decode_mcu_range uses.
template <class Fn>
void walk_span_blocks(const ScanParams& sp, const ScanComp* comps,
                      int64_t m0, int64_t m1, int64_t cols, Fn&& fn) {
  for (int64_t seq = m0; seq < m1; seq++) {
    const int32_t mcu_y = static_cast<int32_t>(seq / cols);
    const int32_t mcu_x = static_cast<int32_t>(seq % cols);
    for (int32_t i = 0; i < sp.ncomp; i++) {
      const ScanComp& c = comps[i];
      for (int32_t v = 0; v < c.v_samp; v++) {
        for (int32_t h = 0; h < c.h_samp; h++) {
          int64_t by = static_cast<int64_t>(mcu_y) * c.v_samp + v;
          int64_t bx = static_cast<int64_t>(mcu_x) * c.h_samp + h;
          fn(i, by * c.block_width + bx);
        }
      }
    }
  }
}

}  // namespace

// Anchored parallel prefix decode over prescan output. Returns OK, or
// ANCHORED_FALLBACK (caller reruns the serial stuffed-stream path; outputs
// are wiped). `ubytes` is the prescan's unstuffed+guarded buffer; anchors are
// its outputs. Only baseline sequential non-DRI scans are eligible.
enum { ANCHORED_FALLBACK = 3 };

extern "C" {

int jt_decode_scan_dct_prefix_anchored(
    const uint8_t* ubytes, int64_t ulen, ScanParams* sp, const ScanComp* comps,
    const PrefixComp* pcomps, int32_t prefix_k, const uint32_t* anchor_bits,
    const int32_t* anchor_block, const int32_t* anchor_slot, int64_t n_anchors,
    int32_t* resid_idx, int16_t* resid_vals, int64_t resid_cap,
    int64_t* resid_count) {
  if (sp->is_progressive || sp->restart_interval > 0 || sp->ss != 0 ||
      sp->ah != 0 || sp->ncomp > 4) {
    return ANCHORED_FALLBACK;
  }
  const int64_t total_mcus = count_decoded_mcus(*sp);
  const int64_t cols = scan_cols(*sp);
  if (cols == 0 || total_mcus == 0) return ANCHORED_FALLBACK;
  int64_t blocks_per_mcu = 0;
  for (int32_t i = 0; i < sp->ncomp; i++) {
    blocks_per_mcu += static_cast<int64_t>(comps[i].h_samp) * comps[i].v_samp;
  }
  int nt = sp->nthreads < 8 ? sp->nthreads : 8;
  if (nt < 2 || total_mcus < 8 * nt) return ANCHORED_FALLBACK;

  auto spans = build_anchor_spans(anchor_bits, anchor_block, anchor_slot,
                                  n_anchors, blocks_per_mcu, total_mcus, nt);
  const int ns = static_cast<int>(spans.size());
  if (ns < 2) return ANCHORED_FALLBACK;

  const int64_t region = (resid_cap - *resid_count) / ns;
  std::vector<ResidBuf> regions(ns);
  std::vector<std::array<int16_t, 4>> dc_totals(ns, {0, 0, 0, 0});
  for (int t = 0; t < ns; t++) {
    regions[t] = ResidBuf{resid_idx + *resid_count + t * region,
                          resid_vals + *resid_count + t * region, 0, region};
  }

  std::atomic<bool> irregular{false};
  auto run_span = [&](int t) {
    const AnchorSpan& s = spans[t];
    auto blk = [&, t](int32_t i, int64_t block_index) {
      const PrefixComp& pc = pcomps[i];
      return PrefixBlock{
          pc.dc ? pc.dc + block_index : nullptr,
          pc.ac ? pc.ac + block_index * (prefix_k - 1) : nullptr,
          prefix_k,
          pc.base + block_index * 64,
          &regions[t]};
    };
    RawBitReader r(ubytes, static_cast<size_t>(ulen),
                   static_cast<size_t>(s.bit0 >> 3));
    Error e;
    r.read_bits(e);
    r.consume(static_cast<int>(s.bit0 & 7));
    if (!decode_mcu_range(r, *sp, comps, McuRange{s.mcu0, s.mcu1},
                          /*handle_restarts=*/false, blk, e,
                          dc_totals[t].data()) ||
        regions[t].count >= regions[t].cap ||
        (s.bit1 >= 0 && r.bit_offset() != s.bit1)) {
      irregular.store(true);
    }
  };

  {
    std::vector<std::thread> threads;
    for (int t = 1; t < ns; t++) threads.emplace_back(run_span, t);
    run_span(0);
    for (auto& th : threads) th.join();
  }

  if (irregular.load()) {
    for (int32_t i = 0; i < sp->ncomp; i++) {
      if (pcomps[i].dc) {
        std::memset(pcomps[i].dc, 0,
                    static_cast<size_t>(pcomps[i].nblocks) * sizeof(int16_t));
      }
      if (pcomps[i].ac) {
        std::memset(pcomps[i].ac, 0,
                    static_cast<size_t>(pcomps[i].nblocks) * (prefix_k - 1));
      }
    }
    return ANCHORED_FALLBACK;
  }

  // Compact per-thread residual regions (order is irrelevant downstream).
  int64_t k = *resid_count;
  for (int t = 0; t < ns; t++) {
    if (regions[t].idx != resid_idx + k && regions[t].count > 0) {
      std::memmove(resid_idx + k, regions[t].idx,
                   regions[t].count * sizeof(int32_t));
      std::memmove(resid_vals + k, regions[t].vals,
                   regions[t].count * sizeof(int16_t));
    }
    k += regions[t].count;
  }
  *resid_count = k;

  // DC fixup: span t's plane values need the sum of earlier spans' diff
  // totals added (mod 2^16). One constant per (span, component); applied
  // in parallel with the same span partition (disjoint writes).
  std::array<int32_t, 4> cum = {0, 0, 0, 0};
  std::vector<std::array<int16_t, 4>> offs(ns);
  for (int t = 0; t < ns; t++) {
    for (int i = 0; i < 4; i++) {
      offs[t][i] = wrap16(cum[i]);
      cum[i] += dc_totals[t][i];
    }
  }
  auto fix_span = [&](int t) {
    const auto& off = offs[t];
    walk_span_blocks(*sp, comps, spans[t].mcu0, spans[t].mcu1, cols,
                     [&](int32_t i, int64_t bi) {
                       if (pcomps[i].dc) {
                         pcomps[i].dc[bi] = wrap16(
                             static_cast<int32_t>(pcomps[i].dc[bi]) + off[i]);
                       }
                     });
  };
  {
    std::vector<std::thread> threads;
    for (int t = 2; t < ns; t++) threads.emplace_back(fix_span, t);
    fix_span(1);  // span 0's offset is zero
    for (auto& th : threads) th.join();
  }
  return OK;
}

// Lossless phase-1: Huffman differences (src/decoder/lossless.rs:49-106).
// diffs: int32 [ncomp, h, w] (component-major). Returns Err code.
// leftover_out receives the stale restart counter for the phase-2 quirk.
int jt_decode_scan_lossless(const uint8_t* data, uint64_t len, int64_t* pos_io,
                            int32_t ncomp, const HuffTable* const* dc_tables,
                            int32_t width, int32_t height,
                            int32_t restart_interval, int32_t* out_marker,
                            int32_t* leftover_out, int32_t* diffs,
                            char* err_msg) {
  Error err;
  *out_marker = -1;
  BitReader r(data, len, static_cast<size_t>(*pos_io));
  uint32_t mcus_left = static_cast<uint32_t>(restart_interval);
  int expected_rst = 0;
  const int64_t plane = static_cast<int64_t>(width) * height;

  for (int64_t y = 0; y < height; y++) {
    for (int64_t x = 0; x < width; x++) {
      if (restart_interval > 0) {
        if (mcus_left == 0) {
          int m = r.take_marker(err);
          if (err) goto fail;
          if (m < 0) {
            char buf[96];
            std::snprintf(buf, sizeof buf, "no marker found where RST%d was expected",
                          expected_rst);
            err.format(buf);
            goto fail;
          }
          if (m < 0xD0 || m > 0xD7) {
            char name[24];
            marker_name(m, name, sizeof name);
            char buf[96];
            std::snprintf(buf, sizeof buf,
                          "found marker %s inside scan where RST%d was expected",
                          name, expected_rst);
            err.format(buf);
            goto fail;
          }
          if (m - 0xD0 != expected_rst) {
            char buf[96];
            std::snprintf(buf, sizeof buf, "found RST%d where RST%d was expected",
                          m - 0xD0, expected_rst);
            err.format(buf);
            goto fail;
          }
          r.reset();
          expected_rst = (expected_rst + 1) % 8;
          mcus_left = static_cast<uint32_t>(restart_interval);
        }
        mcus_left--;
      }
      for (int32_t i = 0; i < ncomp; i++) {
        int value = r.decode(dc_tables[i], err);
        if (err) goto fail;
        int32_t diff;
        if (value == 0) {
          diff = 0;
        } else if (value <= 15) {
          diff = r.receive_extend(value, err);
          if (err) goto fail;
        } else if (value == 16) {
          diff = 32768;
        } else {
          err.format("invalid DC difference magnitude category");
          goto fail;
        }
        diffs[i * plane + y * width + x] = diff;
      }
    }
  }

  {
    int marker = r.take_marker(err);
    if (err) goto fail;
    while (marker >= 0xD0 && marker <= 0xD7) {
      marker = read_marker(data, len, &r.pos);
    }
    *out_marker = marker;
    *pos_io = static_cast<int64_t>(r.pos);
    *leftover_out = static_cast<int32_t>(mcus_left);
  }
  return OK;

fail:
  if (err.code == ERR_FORMAT && err_msg) std::snprintf(err_msg, 160, "%s", err.msg);
  return err.code;
}

// Lossless phase-2 scalar reconstruction
// (src/decoder/lossless.rs:108-226), incl. the stale
// restart-flag quirk (restart_all applies default prediction everywhere).
// predictor: Table H.1 selection 0-7. out: uint16 [h, w].
void jt_reconstruct_lossless(const int32_t* diffs, int32_t height, int32_t width,
                             int32_t predictor, int32_t point_transform,
                             int32_t precision, int32_t restart_all,
                             uint16_t* out) {
  const int pt = point_transform;
  const int32_t guarded_default =
      precision > 1 + pt ? (1 << (precision - pt - 1)) : 0;

  // NB dispatch order matches the reference: the predictor-1 (Ra) fast path
  // is checked FIRST (src/decoder/lossless.rs:108) and never
  // applies the restart default — restart_all only affects the general path.
  if (predictor == 1) {
    // Fast path (src/decoder/lossless.rs:108-138): NB its
    // first-pixel default is 1 << (P - Pt - 1) WITHOUT the precision guard.
    const int32_t default1 = 1 << (precision - pt - 1);
    int32_t result = ((default1 + diffs[0]) & 0xFFFF);
    out[0] = static_cast<uint16_t>(result << pt);
    uint16_t prev = out[0];
    for (int64_t y = 1; y < height; y++) {
      int32_t v = ((static_cast<int32_t>(prev) + diffs[y * width]) & 0xFFFF);
      out[y * width] = static_cast<uint16_t>(v << pt);
      prev = out[y * width];
    }
    for (int64_t y = 0; y < height; y++) {
      for (int64_t x = 1; x < width; x++) {
        int32_t p = out[y * width + x - 1];
        int32_t v = ((p + diffs[y * width + x]) & 0xFFFF);
        out[y * width + x] = static_cast<uint16_t>(v << pt);
      }
    }
    return;
  }

  if (restart_all) {
    // General path with the stale restart flag set: predict() returns the
    // guarded default for EVERY pixel (lossless.rs:200-206).
    for (int64_t i = 0; i < static_cast<int64_t>(height) * width; i++) {
      out[i] = static_cast<uint16_t>(
          ((guarded_default + diffs[i]) & 0xFFFF) << pt);
    }
    return;
  }

  for (int64_t y = 0; y < height; y++) {
    for (int64_t x = 0; x < width; x++) {
      int32_t prediction;
      if (x == 0 && y == 0) {
        prediction = guarded_default;
      } else if (y == 0) {
        prediction = out[x - 1];
      } else if (x == 0) {
        prediction = out[(y - 1) * width];
      } else {
        int32_t ra = out[y * width + x - 1];
        int32_t rb = out[(y - 1) * width + x];
        int32_t rc = out[(y - 1) * width + x - 1];
        switch (predictor) {
          case 0: prediction = 0; break;
          case 2: prediction = rb; break;
          case 3: prediction = rc; break;
          case 4: prediction = ra + rb - rc; break;
          case 5: prediction = ra + ((rb - rc) >> 1); break;
          case 6: prediction = rb + ((ra - rc) >> 1); break;
          case 7: prediction = (ra + rb) / 2; break;
          default: prediction = ra; break;
        }
      }
      int32_t v = ((prediction + diffs[y * width + x]) & 0xFFFF);
      out[y * width + x] = static_cast<uint16_t>(v << pt);
    }
  }
}

// Single-pass sparse (COO) packing of a coefficient store: writes global
// indices (base + i) and values of nonzero coefficients. Returns nnz (capped
// at cap). Feeds the decode-to-device streaming path without numpy
// temporaries.
int64_t jt_pack_coo(const int16_t* store, int64_t n, int64_t base,
                    int32_t* idx_out, int16_t* vals_out, int64_t cap) {
  int64_t k = 0;
  int64_t i = 0;
  // Word-at-a-time skip over zero runs (coefficient tensors are ~90% zero).
  while (i + 4 <= n && k < cap) {
    uint64_t w;
    std::memcpy(&w, store + i, 8);
    if (w == 0) { i += 4; continue; }
    for (int j = 0; j < 4 && k < cap; j++, i++) {
      if (store[i] != 0) {
        idx_out[k] = static_cast<int32_t>(base + i);
        vals_out[k] = store[i];
        k++;
      }
    }
  }
  for (; i < n && k < cap; i++) {
    if (store[i] != 0) {
      idx_out[k] = static_cast<int32_t>(base + i);
      vals_out[k] = store[i];
      k++;
    }
  }
  return k;
}

// memset helper so pooled store buffers can be cleared without touching
// Python-side page-faulting paths.
void jt_zero(void* p, int64_t bytes) { std::memset(p, 0, static_cast<size_t>(bytes)); }

// Zigzag-prefix packing: for each 8x8 block, emit its first K coefficients in
// zigzag order (where JPEG energy concentrates) densely, plus a sparse COO
// residual for nonzeros beyond the prefix. The device rebuilds the natural-
// order tensor with a static column permutation (no large scatter) + a tiny
// residual scatter — the host<->device interchange format of the streaming
// path. Returns the residual count.
int64_t jt_pack_prefix(const int16_t* store, int64_t nblocks, int32_t K,
                       int64_t base, int16_t* dc_out, int8_t* ac_out,
                       int32_t* resid_idx, int16_t* resid_vals,
                       int64_t resid_cap) {
  int64_t r = 0;
  for (int64_t b = 0; b < nblocks; b++) {
    const int16_t* blk = store + b * 64;
    dc_out[b] = blk[0];
    int8_t* ac = ac_out + b * (K - 1);
    for (int32_t j = 1; j < K; j++) {
      int32_t w = blk[UNZIGZAG[j]];
      int32_t sat = w < -128 ? -128 : (w > 127 ? 127 : w);
      ac[j - 1] = static_cast<int8_t>(sat);
      if (w != sat && r < resid_cap) {
        resid_idx[r] = static_cast<int32_t>(base + b * 64 + UNZIGZAG[j]);
        resid_vals[r] = static_cast<int16_t>(w - sat);
        r++;
      }
    }
    for (int32_t j = K; j < 64; j++) {
      int16_t v = blk[UNZIGZAG[j]];
      if (v != 0 && r < resid_cap) {
        resid_idx[r] = static_cast<int32_t>(base + b * 64 + UNZIGZAG[j]);
        resid_vals[r] = v;
        r++;
      }
    }
  }
  return r;
}

// ---------------------------------------------------------------------------
// Baseline prescan for the device entropy engine (entropy/device_scan.py):
// unstuff + symbol-length walk emitting bitstream anchors. Port of the Python
// prescan (same 16-bit-window LUTs, same fallback policy); must stay
// byte/anchor-identical to it — tests compare both.
// ---------------------------------------------------------------------------

struct PrescanParams {
  int64_t pos;              // in: scan start; out: cursor after scan
  int32_t ncomp;
  int32_t max_mcu_x, max_mcu_y;
  int32_t image_w, image_h;
  int32_t restart_interval;
  int32_t s_target, k_cap, s_max;
  int32_t pattern_len;
  int32_t pattern[16];      // slot -> scan component index
  // outputs
  int64_t out_len;          // bytes written to out (padded layout)
  int64_t n_anchors;
  int32_t n_blocks;
  int32_t pending_marker;   // terminating marker byte or -1
  int32_t nthreads;         // in: restart segments walked in parallel
  int32_t uniform_tables;   // in: all scan components share (dc, ac) tables
  int32_t spec_min_bytes;   // in: speculative-split threshold; 0 = default
                            // (256 KiB), <0 disables the speculative walk
};

enum PrescanStatus { PRESCAN_OK = 0, PRESCAN_FALLBACK = 1 };

namespace {

// Unstuff one segment starting at `pos`: copy until a marker (removing
// stuffed 0x00, skipping fill 0xFFs). Returns false on EOF (fallback).
// On return: *seg_len = bytes written, *pos = after the marker, *marker set.
bool unstuff_segment(const uint8_t* data, int64_t n, int64_t* pos,
                     uint8_t* out, int64_t out_cap, int64_t* seg_len,
                     int32_t* marker) {
  int64_t i = *pos;
  int64_t w = 0;
  for (;;) {
    if (i >= n) return false;  // EOF without marker: host path errors
    // Bulk-copy the run up to the next 0xFF (memchr/memcpy are SIMD in
    // glibc — the byte loop was a measurable slice of prescan time).
    const void* f = std::memchr(data + i, 0xFF, static_cast<size_t>(n - i));
    if (f == nullptr) return false;  // EOF without marker
    const int64_t run = static_cast<const uint8_t*>(f) - (data + i);
    if (w + run > out_cap) return false;
    std::memcpy(out + w, data + i, static_cast<size_t>(run));
    w += run;
    i += run;
    if (i + 1 >= n) return false;
    int64_t j = i + 1;
    while (j < n && data[j] == 0xFF) j++;
    if (j >= n) return false;
    uint8_t nxt = data[j];
    if (nxt == 0x00) {
      if (j == i + 1) {  // plain stuffing FF 00 -> 0xFF
        if (w >= out_cap) return false;
        out[w++] = 0xFF;
        i += 2;
        continue;
      }
      return false;  // fill FFs then 00: oracle raises FormatError
    }
    *marker = nxt;
    *pos = j + 1;
    *seg_len = w;
    return true;
  }
}

inline uint32_t win32_at(const uint8_t* seg, int64_t bitpos) {
  // Unaligned 8-byte load (reads up to 7 bytes past the bit position's byte;
  // callers guarantee >= 8 bytes of zero guard after every segment).
  uint64_t v;
  std::memcpy(&v, seg + (bitpos >> 3), 8);
  v = __builtin_bswap64(v);
  return static_cast<uint32_t>(v >> (32 - (bitpos & 7)));
}

// Micro-LUT entry flags shared by the serial walk, the speculative walk, and
// the 16-bit cold path (see the table build in jt_prescan_baseline).
enum : uint16_t { P_MISS = 1 << 15, P_FB = 1 << 14, P_END = 1 << 13,
                  P_COEFF = 1 << 12 };

// Cold path for codes longer than 10 bits: resolve via the 16-bit LUT and
// re-encode as a micro-LUT entry.
inline uint16_t prescan_slow(const uint32_t* lut16, bool is_dc, uint32_t win) {
  uint32_t e = lut16[win >> 16];
  int len = (e >> 8) & 0x1F;
  if (len == 0) return P_FB;
  int val = e & 0xFF;
  if (is_dc) return val > 11 ? P_FB : static_cast<uint16_t>(len + val);
  int s = val & 0x0F;
  if (s == 0) {
    if (val == 0xF0) return static_cast<uint16_t>((16 << 6) | len);
    if (val == 0) return static_cast<uint16_t>(P_END | len);
    return P_FB;
  }
  return static_cast<uint16_t>(P_COEFF | (((val >> 4) + 1) << 6) | (len + s));
}

// Seekable 64-bit reservoir + one-block symbol-length decode, bit-identical
// to the serial walk in jt_prescan_baseline (same micro-LUT hot path, same
// 16-bit cold path, same bit_limit discipline). seek() may be called at any
// bit position; reads stay within the segment's 24-byte zero guard plus the
// caller-allocated slack, exactly like the serial reservoir.
struct BlockWalker {
  const uint8_t* sb;
  int64_t bit_limit;
  const uint32_t* luts;
  const uint16_t* micro;
  uint64_t buf = 0;
  int navail = 0;
  int64_t rb = 0;
  int64_t p = 0;

  inline void refill() {
    while (navail <= 32) {
      uint32_t w;
      std::memcpy(&w, sb + rb, 4);
      buf |= static_cast<uint64_t>(__builtin_bswap32(w)) << (32 - navail);
      navail += 32;
      rb += 4;
    }
  }
  void seek(int64_t bitpos) {
    p = bitpos;
    const int64_t rb0 = (bitpos >> 5) << 2;
    rb = rb0;
    buf = 0;
    navail = 0;
    refill();
    const int drop = static_cast<int>(bitpos - rb0 * 8);
    buf <<= drop;
    navail -= drop;
  }

  // Decode one block's symbol lengths with component ci's tables; returns
  // the symbol count, or -1 where the serial walk bails (invalid code,
  // coefficient overshoot, bit_limit overrun).
  int decode_block(int32_t ci) {
    const uint32_t* dc_lut = luts + (static_cast<int64_t>(ci) * 2) * 65536;
    const uint32_t* ac_lut = dc_lut + 65536;
    const uint16_t* dcp = micro + (static_cast<size_t>(ci) * 2) * 1024;
    const uint16_t* acp = dcp + 1024;
    if (p > bit_limit) return -1;
    refill();
    uint16_t e = dcp[buf >> 54];
    if (e & P_MISS)
      e = prescan_slow(dc_lut, true, static_cast<uint32_t>(buf >> 32));
    if (e & P_FB) return -1;
    int syms = 1;
    {
      const int c = e & 63;
      buf <<= c;
      navail -= c;
      p += c;
    }
    int32_t k = 1;
    while (k < 64) {
      if (p > bit_limit) return -1;
      refill();
      e = acp[buf >> 54];
      if (e & P_MISS)
        e = prescan_slow(ac_lut, false, static_cast<uint32_t>(buf >> 32));
      if (e & P_FB) return -1;
      {
        const int c = e & 63;
        buf <<= c;
        navail -= c;
        p += c;
      }
      syms++;
      if (e & P_END) break;
      const int32_t kadv = (e >> 6) & 0x3F;
      if (e & P_COEFF) {
        if (k + kadv - 1 >= 64) return -1;
        k += kadv;
      } else {
        k += 16;  // ZRL
      }
    }
    return syms;
  }
};

// ---------------------------------------------------------------------------
// Speculative parallel prescan of ONE entropy segment (the non-DRI case).
//
// A non-DRI scan is a single bit-serial segment, so the per-segment task
// parallelism above degenerates to one thread — and the host walk becomes the
// production bottleneck (the device decodes a large_image-class scan in ~7 ms
// while one host core walks symbols for ~6.5 ms). Huffman streams
// self-synchronize: a decoder started at an arbitrary bit position converges
// to the true symbol trajectory after a short wander (validated exhaustively
// on real tables in tools/experiments/selfsync_prototype.py). This machinery
// exploits that to walk one segment with T threads while producing outputs
// byte-identical to the serial walk:
//
//   Phase A (parallel): split the segment into T byte spans. Thread 0 walks
//   span 0 from the true entry state. Each thread t>=1 runs speculative
//   candidate walks from its span start at bit offsets 0..7 (x slot-phase
//   guesses when scan components use distinct Huffman tables), recording one
//   (start_bit, nsyms) record per decoded block. A per-span open-addressing
//   hash over block-start states (bit position, slot phase) dedups work:
//   a candidate stepping into a state any earlier candidate visited merges
//   and stops, so the span is walked essentially once.
//
//   Phase B (serial, per-block not per-symbol): an exact stitcher consumes
//   blocks in stream order. It looks up its current state in the span's
//   hash; on a hit it splices the entire recorded chain — valid because the
//   walk from a given (bit, phase) state is a deterministic function of the
//   segment bytes — and on a miss it decodes one block itself and retries.
//   Anchor/chunk placement is replayed over the merged block stream with the
//   serial walk's exact policy, so speculation quality only moves time,
//   never bytes. Genuine stream errors surface exactly as in the serial
//   walk (the spliced chains and the stitcher's own decodes are both exact).
//
// The reference decodes this segment strictly sequentially
// (src/decoder.rs:910-1015); nothing here changes decode
// semantics — it only parallelizes the anchor prescan.

struct SpecRec {
  uint32_t start_bit;
  uint16_t syms;
  uint16_t cand;
};

enum SpecKind : uint8_t { SPEC_MERGE, SPEC_STOP, SPEC_DEAD };

struct SpecCand {
  int32_t first = 0, n = 0;
  int32_t merge_rec = -1;
  int64_t end_p = 0;  // SPEC_STOP/SPEC_DEAD: start bit of the next unwalked
                      // (or undecodable) block
  uint8_t kind = SPEC_DEAD;
};

struct SpecSpan {
  std::vector<SpecRec> recs;
  std::vector<SpecCand> cands;
  std::vector<uint64_t> table;  // entry = key<<24 | (rec_index+1); 0 = empty
  uint64_t mask = 0;
  size_t used = 0;

  void init(size_t est, size_t hashed) {
    size_t cap = 64;
    while (cap < hashed * 2) cap <<= 1;
    table.assign(cap, 0);
    mask = cap - 1;
    recs.reserve(est * 2 + 1024);
  }
  static inline uint64_t mix(uint64_t k) {
    k *= 0x9E3779B97F4A7C15ull;
    return k ^ (k >> 29);
  }
  // Returns the existing record index on hit; -1 when absent (*slot set for
  // a later store); -2 when the table is too loaded to accept inserts.
  int64_t probe(uint64_t key, size_t* slot) {
    size_t i = static_cast<size_t>(mix(key)) & mask;
    for (;;) {
      const uint64_t e = table[i];
      if (e == 0) {
        if (used * 10 >= table.size() * 9) return -2;
        *slot = i;
        return -1;
      }
      if ((e >> 24) == key) return static_cast<int64_t>((e & 0xFFFFFF) - 1);
      i = (i + 1) & mask;
    }
  }
  void store(size_t slot, uint64_t key, uint32_t rec) {
    table[slot] = (key << 24) | (rec + 1);
    used++;
  }
};

// Phase A: walk one span's candidates. `exact_start` marks thread 0, whose
// single candidate starts from the true state (bit 0, phase 0).
void spec_walk_span(const uint8_t* sb, int64_t bit_limit, const uint32_t* luts,
                    const uint16_t* micro, const int32_t* pattern,
                    int64_t plen, bool uniform, bool exact_start,
                    int64_t span_begin_bit, int64_t span_end_bit,
                    int64_t est_blocks, SpecSpan* out) {
  // Merges and stitch handoffs all happen within a few blocks of the span
  // start (measured: candidates merge in <10 blocks), so only the first
  // HASH_LIMIT block-start states per candidate go into the dedup hash —
  // hashing every block cost ~25% of the walk for no coverage gain. The
  // chain records themselves always cover the full walk.
  constexpr int64_t HASH_LIMIT = 4096;
  out->init(static_cast<size_t>(est_blocks),
            static_cast<size_t>(HASH_LIMIT * 2));
  BlockWalker w{sb, bit_limit, luts, micro};
  const int n_off = exact_start ? 1 : 8;
  const int n_ph =
      (exact_start || uniform) ? 1 : static_cast<int>(std::min<int64_t>(plen, 16));
  const int64_t rec_cap = est_blocks * 2 + 4096;
  bool have_full = false;  // some candidate already covered a long stretch
  for (int o = 0; o < n_off; o++) {
    for (int ph = 0; ph < n_ph; ph++) {
      if (static_cast<int64_t>(out->recs.size()) > rec_cap) return;
      SpecCand c;
      c.first = static_cast<int32_t>(out->recs.size());
      int64_t phase = ph;
      w.seek(span_begin_bit + o);
      int64_t budget = have_full ? 768 : (int64_t{1} << 60);
      int64_t local = 0;
      uint8_t kind;
      for (;;) {
        if (w.p >= span_end_bit || budget-- <= 0 ||
            out->recs.size() >= (1u << 24) - 2) {
          kind = SPEC_STOP;
          c.end_p = w.p;
          break;
        }
        size_t slot = 0;
        bool hashed = false;
        if (local < HASH_LIMIT) {
          const uint64_t key =
              (static_cast<uint64_t>(w.p) << 4) |
              (uniform ? 0 : static_cast<uint64_t>(phase));
          const int64_t hit = out->probe(key, &slot);
          if (hit >= 0) {
            kind = SPEC_MERGE;
            c.merge_rec = static_cast<int32_t>(hit);
            break;
          }
          if (hit == -1) {
            hashed = true;
            // Store before decoding: the key/slot pair stays valid because
            // only this thread touches the table and the record index is
            // reserved now; a failed decode leaves a dangling entry, but its
            // candidate is marked SPEC_DEAD so chains resolve it safely.
            out->store(slot, key, static_cast<uint32_t>(out->recs.size()));
          }
        }
        const uint32_t sbit = static_cast<uint32_t>(w.p);
        const int syms = w.decode_block(pattern[phase]);
        if (syms < 0) {
          kind = SPEC_DEAD;
          c.end_p = sbit;
          if (hashed) {
            // Un-store: the record was never pushed.
            out->table[slot] = 0;
            out->used--;
          }
          break;
        }
        out->recs.push_back(SpecRec{sbit, static_cast<uint16_t>(syms),
                                    static_cast<uint16_t>(out->cands.size())});
        local++;
        phase = phase + 1 == plen ? 0 : phase + 1;
      }
      c.n = static_cast<int32_t>(out->recs.size()) - c.first;
      c.kind = kind;
      out->cands.push_back(c);
      if (kind == SPEC_STOP && c.n >= 1024) have_full = true;
    }
  }
}

}  // namespace

// luts: [ncomp][2][65536] uint32 (value | len<<8), DC row then AC row.
// out capacity must be >= input span + 24 bytes per segment + 32.
int jt_prescan_baseline(const uint8_t* data, int64_t n, PrescanParams* pp,
                        const uint32_t* luts, uint8_t* out, int64_t out_cap,
                        uint32_t* anchor_bits, int32_t* anchor_block,
                        int32_t* anchor_slot, uint32_t* chunk_end,
                        int32_t* chunk_syms, int64_t anchors_cap) {
  const int GUARD = 24;  // provisional zero guard per segment (bytes)

  // Hot-path micro-LUTs over 10-bit windows (2KB/table, L1-resident; the
  // full 16-bit LUTs are 256KB each and thrash the cache). Entry encodes
  // everything the length-only walk needs (P_* flags at namespace scope);
  // codes longer than 10 bits (rare) take the 16-bit cold path. Built per
  // call — 1K entries/table is noise.
  // kadv in bits 11..6, consumed bits in 5..0. Plain local (NOT thread_local):
  // the parallel per-segment walk reads it from worker threads, which must
  // see the instance built here, not their own empty thread-local copy.
  std::vector<uint16_t> micro(static_cast<size_t>(pp->ncomp) * 2 * 1024, 0);
  for (int32_t c = 0; c < pp->ncomp; c++) {
    const uint32_t* dc16 = luts + (static_cast<int64_t>(c) * 2) * 65536;
    const uint32_t* ac16 = dc16 + 65536;
    uint16_t* dcp = micro.data() + (static_cast<size_t>(c) * 2) * 1024;
    uint16_t* acp = dcp + 1024;
    for (int w = 0; w < 1024; w++) {
      uint32_t e = dc16[w << 6];
      int len = (e >> 8) & 0x1F;
      if (len == 0 || len > 10) {
        dcp[w] = P_MISS;
      } else {
        int cat = e & 0xFF;
        dcp[w] = cat > 11 ? P_FB : static_cast<uint16_t>(len + cat);
      }
      e = ac16[w << 6];
      len = (e >> 8) & 0x1F;
      if (len == 0 || len > 10) {
        acp[w] = P_MISS;
      } else {
        int val = e & 0xFF;
        int s = val & 0x0F;
        if (s == 0) {
          if (val == 0xF0) acp[w] = static_cast<uint16_t>((16 << 6) | len);
          else if (val == 0) acp[w] = static_cast<uint16_t>(P_END | len);
          else acp[w] = P_FB;  // EOB run in a sequential scan
        } else {
          int r = val >> 4;
          acp[w] = static_cast<uint16_t>(
              P_COEFF | ((r + 1) << 6) | (len + s));
        }
      }
    }
  }
  // Fixed per-segment layout: every segment is followed by GUARD (24) zero
  // bytes and the next segment starts exactly GUARD past the data. The walk's
  // 128-bit overrun bound plus the 8-byte window read reach at most
  // len + 24 bytes, so concurrent walks never see a neighbor's bytes and the
  // zero-fill semantics match the Python mirror bit for bit. Fixing the pad
  // (the old layout used the observed overrun) is what makes the layout
  // computable before any symbol is walked — the precondition for walking
  // restart segments in parallel.
  const int64_t PAD = GUARD;

  // Clipped decoded-MCU grid (the reference's mcu*8 >= image quirk).
  int64_t rows = 0, cols = 0;
  for (int32_t y = 0; y < pp->max_mcu_y; y++) {
    if (static_cast<int64_t>(y) * 8 >= pp->image_h) break;
    rows++;
  }
  for (int32_t x = 0; x < pp->max_mcu_x; x++) {
    if (static_cast<int64_t>(x) * 8 >= pp->image_w) break;
    cols++;
  }
  const int64_t total_mcus = rows * cols;
  if (total_mcus <= 0 || pp->pattern_len <= 0) return PRESCAN_FALLBACK;
  const int64_t RI = pp->restart_interval;
  const int64_t nseg = RI > 0 ? (total_mcus + RI - 1) / RI : 1;
  const int64_t plen = pp->pattern_len;

  // Phase 1 (serial, memcpy-bound): unstuff every segment into its final
  // position, validating the RSTn sequence between segments.
  struct Seg { int64_t base, len; int32_t marker; };
  std::vector<Seg> segs;
  segs.reserve(static_cast<size_t>(nseg));
  int64_t pos = pp->pos;
  int64_t write_off = 0;
  for (int64_t i = 0; i < nseg; i++) {
    Seg sg{write_off, 0, -1};
    if (!unstuff_segment(data, n, &pos, out + sg.base,
                         out_cap - sg.base - GUARD, &sg.len, &sg.marker))
      return PRESCAN_FALLBACK;
    std::memset(out + sg.base + sg.len, 0, GUARD);
    write_off = sg.base + sg.len + PAD;
    if (i + 1 < nseg &&
        (!(sg.marker >= 0xD0 && sg.marker <= 0xD7) ||
         (sg.marker - 0xD0) != (i % 8)))
      return PRESCAN_FALLBACK;
    segs.push_back(sg);
  }

  // The anchored wire carries bit offsets as uint32 (anchor_bits/chunk_end
  // here, AnchoredScan on the Python side): any layout of 2^29 bytes or more
  // would wrap them silently. Far beyond any real scan — but route such
  // streams to the host path instead of mis-anchoring.
  if (write_off >= (int64_t{1} << 29)) return PRESCAN_FALLBACK;

  // Phase 2s: speculative parallel walk for a single long segment (the
  // non-DRI case, where the per-segment parallelism below degenerates to one
  // thread). Outputs are byte-identical to the serial walk — see the design
  // note at spec_walk_span. On genuine stream errors this returns
  // PRESCAN_FALLBACK exactly where the serial walk would.
  {
    int spec_T = pp->nthreads > 0 ? pp->nthreads : 1;
    if (spec_T > 8) spec_T = 8;
    const int64_t spec_min =
        pp->spec_min_bytes == 0 ? (int64_t{1} << 18)
                                : static_cast<int64_t>(pp->spec_min_bytes);
    const int64_t total_blocks = total_mcus * plen;
    int T = 0;
    if (segs.size() == 1 && pp->spec_min_bytes >= 0 && spec_T > 1 &&
        segs[0].len >= spec_min && segs[0].len < (int64_t{1} << 29) &&
        total_blocks < (1 << 24)) {
      const int64_t min_span = std::max<int64_t>(spec_min / 4, 4096);
      T = static_cast<int>(
          std::min<int64_t>(spec_T, segs[0].len / min_span));
      if (T > 8) T = 8;
    }
    if (T >= 2) {
      const Seg& sg = segs[0];
      const uint8_t* sb = out + sg.base;  // base == 0 for one segment
      const int64_t bit_limit = sg.len * 8 + 128;
      const bool uniform = pp->uniform_tables != 0;
      std::vector<SpecSpan> spans(T);
      std::vector<int64_t> begin_bits(T + 1);
      for (int t = 0; t <= T; t++) begin_bits[t] = (sg.len * t / T) * 8;
      const int64_t est = total_blocks / T + 1024;
      {
        std::vector<std::thread> ths;
        for (int t = 1; t < T; t++)
          ths.emplace_back([&, t]() {
            spec_walk_span(sb, bit_limit, luts, micro.data(), pp->pattern,
                           plen, uniform, false, begin_bits[t],
                           begin_bits[t + 1], est, &spans[t]);
          });
        spec_walk_span(sb, bit_limit, luts, micro.data(), pp->pattern, plen,
                       uniform, true, 0, begin_bits[1], est, &spans[0]);
        for (auto& th : ths) th.join();
      }

      // Phase B: exact stitch + anchor replay (per block, not per symbol).
      int64_t n_anch = 0;
      int64_t syms_since = pp->s_target;  // force an anchor at segment entry
      int64_t blocks_since = 0;
      int64_t max_syms = 0;
      bool chunk_open = false;
      bool fb = false;
      auto close_chunk2 = [&](int64_t at_bit) {
        if (chunk_open) {
          if (syms_since > max_syms) max_syms = syms_since;
          chunk_end[n_anch - 1] = static_cast<uint32_t>(at_bit);
          chunk_syms[n_anch - 1] = static_cast<int32_t>(syms_since);
          chunk_open = false;
        }
      };
      auto append = [&](uint32_t sbit, int64_t syms, int64_t blk) -> bool {
        if (syms_since >= pp->s_target || blocks_since >= pp->k_cap) {
          close_chunk2(sbit);
          if (n_anch + 1 > anchors_cap) return false;
          anchor_bits[n_anch] = sbit;
          anchor_block[n_anch] = static_cast<int32_t>(blk);
          anchor_slot[n_anch] = static_cast<int32_t>(blk % plen);
          n_anch++;
          chunk_open = true;
          syms_since = 0;
          blocks_since = 0;
        }
        syms_since += syms;
        blocks_since++;
        return true;
      };
      auto span_of = [&](int64_t pbit) -> int {
        int t = T - 1;
        while (t > 0 && pbit < begin_bits[t]) t--;
        return t;
      };
      BlockWalker w{sb, bit_limit, luts, micro.data()};
      int64_t cur_p = 0;
      int64_t blk = 0;
      int64_t exact_blocks = 0;
      bool synced = false;
      while (blk < total_blocks && !fb) {
        SpecSpan& sp = spans[span_of(cur_p)];
        const uint64_t key = (static_cast<uint64_t>(cur_p) << 4) |
                             (uniform ? 0 : static_cast<uint64_t>(blk % plen));
        size_t slot = 0;
        const int64_t rec = sp.probe(key, &slot);
        if (rec >= 0) {
          // Splice the recorded chain: exact because the walk from a given
          // (bit, phase) state is deterministic over the same bytes.
          int64_t i = rec;
          for (;;) {
            const SpecCand& c = sp.cands[sp.recs[i].cand];
            const int64_t cend = c.first + c.n;
            while (i < cend && blk < total_blocks) {
              if (!append(sp.recs[i].start_bit, sp.recs[i].syms, blk)) {
                fb = true;
                break;
              }
              blk++;
              cur_p = (i + 1 < cend)
                          ? static_cast<int64_t>(sp.recs[i + 1].start_bit)
                          : (c.kind == SPEC_MERGE
                                 ? static_cast<int64_t>(
                                       sp.recs[c.merge_rec].start_bit)
                                 : c.end_p);
              i++;
            }
            if (fb || blk >= total_blocks) break;
            if (c.kind == SPEC_MERGE) {
              i = c.merge_rec;
              continue;
            }
            break;  // STOP/DEAD: resume lookups (or exact decode) at cur_p
          }
          synced = false;
          continue;
        }
        if (!synced || w.p != cur_p) {
          w.seek(cur_p);
          synced = true;
        }
        const uint32_t sbit = static_cast<uint32_t>(cur_p);
        const int syms = w.decode_block(pp->pattern[blk % plen]);
        if (syms < 0 || !append(sbit, syms, blk)) {
          fb = true;
          break;
        }
        blk++;
        exact_blocks++;
        cur_p = w.p;
      }
      if (std::getenv("JT_SPEC_DEBUG")) {
        for (int t = 0; t < T; t++) {
          std::fprintf(stderr, "[spec] span %d: recs=%zu cands=%zu kinds=",
                       t, spans[t].recs.size(), spans[t].cands.size());
          for (const auto& c : spans[t].cands)
            std::fprintf(stderr, "%c%d,", "MSD"[c.kind], c.n);
          std::fprintf(stderr, "\n");
        }
        std::fprintf(stderr, "[spec] stitch: total=%lld exact=%lld\n",
                     static_cast<long long>(total_blocks),
                     static_cast<long long>(exact_blocks));
      }
      if (fb || cur_p > bit_limit) return PRESCAN_FALLBACK;
      close_chunk2(cur_p);
      if (max_syms > pp->s_max) return PRESCAN_FALLBACK;

      // Trailing-RST tolerance (_finish_scan), as in the serial epilogue.
      int32_t marker = sg.marker;
      while (marker >= 0xD0 && marker <= 0xD7) {
        size_t sp2 = static_cast<size_t>(pos);
        marker = read_marker(data, static_cast<size_t>(n), &sp2);
        pos = static_cast<int64_t>(sp2);
        if (marker < 0) {
          marker = -1;
          break;
        }
      }
      pp->pos = pos;
      pp->out_len = write_off;
      pp->n_anchors = n_anch;
      pp->n_blocks = static_cast<int32_t>(total_blocks);
      pp->pending_marker = marker;
      return PRESCAN_OK;
    }
  }

  // Phase 2: symbol-length walk, one task per restart segment. Anchors and
  // chunks never span a segment (a forced anchor opens every segment), so
  // per-segment results merge by concatenation in segment order.
  struct WalkOut {
    std::vector<uint32_t> a_bits, c_end;
    std::vector<int32_t> a_block, a_slot, c_syms;
    int64_t max_syms = 0;
    bool ok = false;
  };
  std::vector<WalkOut> results(segs.size());

  auto walk_segment = [&](size_t si) {
    const Seg& sg = segs[si];
    WalkOut& res = results[si];
    const int64_t mcu0 = RI > 0 ? static_cast<int64_t>(si) * RI : 0;
    const int64_t mcu1 =
        RI > 0 ? std::min<int64_t>(mcu0 + RI, total_mcus) : total_mcus;
    const uint8_t* sb = out + sg.base;
    const int64_t bit_limit = sg.len * 8 + 128;

    int64_t p = 0;
    int64_t syms_since = pp->s_target;  // force an anchor at segment entry
    int64_t blocks_since = 0;

    // 64-bit reservoir: bits [p, p+navail) left-aligned in `buf`. Replaces
    // the per-symbol 8-byte window reload — the load+bswap+shift sat on the
    // symbol dependency chain (measured ~1.5x walk cost). Lookups only ever
    // read bits [p, p+32), exactly the bits the old window exposed, so
    // results are bit-identical; refill may buffer up to 3 bytes past the
    // 24-byte zero guard (next segment's bytes / tail slack — never looked
    // up, caller allocates the slack).
    uint64_t buf = 0;
    int navail = 0;
    int64_t rb = 0;  // next unread byte in sb
    auto refill = [&]() {
      while (navail <= 32) {
        uint32_t w;
        std::memcpy(&w, sb + rb, 4);
        buf |= static_cast<uint64_t>(__builtin_bswap32(w)) << (32 - navail);
        navail += 32;
        rb += 4;
      }
    };

    auto close_chunk = [&]() {
      if (!res.a_bits.empty() && res.c_end.size() < res.a_bits.size()) {
        if (syms_since > res.max_syms) res.max_syms = syms_since;
        res.c_end.push_back(static_cast<uint32_t>(sg.base * 8 + p));
        res.c_syms.push_back(static_cast<int32_t>(syms_since));
      }
    };

    // Cold path for codes longer than 10 bits: prescan_slow (shared with the
    // speculative walker).
    auto slow = prescan_slow;

    for (int64_t seq = mcu0; seq < mcu1; seq++) {
      for (int32_t slot = 0; slot < plen; slot++) {
        int32_t ci = pp->pattern[slot];
        const uint32_t* dc_lut = luts + (static_cast<int64_t>(ci) * 2) * 65536;
        const uint32_t* ac_lut = dc_lut + 65536;
        const uint16_t* dcp =
            micro.data() + (static_cast<size_t>(ci) * 2) * 1024;
        const uint16_t* acp = dcp + 1024;

        if (syms_since >= pp->s_target || blocks_since >= pp->k_cap) {
          close_chunk();
          res.a_bits.push_back(static_cast<uint32_t>(sg.base * 8 + p));
          res.a_block.push_back(static_cast<int32_t>(seq * plen + slot));
          res.a_slot.push_back(slot);
          syms_since = 0;
          blocks_since = 0;
        }

        // Overrun bound shared with the Python prescan: reads may extend at
        // most 128 bits into a segment's zero-fill, else the host path
        // reproduces the oracle exactly.
        if (p > bit_limit) return;
        refill();
        uint16_t e = dcp[buf >> 54];
        if (e & P_MISS) e = slow(dc_lut, true,
                                 static_cast<uint32_t>(buf >> 32));
        if (e & P_FB) return;
        {
          const int c = e & 63;
          buf <<= c;
          navail -= c;
          p += c;
        }
        syms_since++;

        int32_t k = 1;
        while (k < 64) {
          if (p > bit_limit) return;
          refill();
          e = acp[buf >> 54];
          if (e & P_MISS) e = slow(ac_lut, false,
                                   static_cast<uint32_t>(buf >> 32));
          if (e & P_FB) return;
          {
            const int c = e & 63;
            buf <<= c;
            navail -= c;
            p += c;
          }
          syms_since++;
          if (e & P_END) break;
          int32_t kadv = (e >> 6) & 0x3F;
          if (e & P_COEFF) {
            if (k + kadv - 1 >= 64) return;  // overshoot
            k += kadv;
          } else {
            k += 16;  // ZRL
          }
        }
        blocks_since++;
      }
    }
    if (p > bit_limit) return;
    // Restart-boundary underrun: the oracle's take_marker is one read_bits
    // refill (reads bytes while num_bits <= 56) + marker.take()
    // (src/huffman.rs:123-160). Unconsumed data bytes before
    // the RSTn are absorbed into the reservoir (then discarded by reset());
    // the refill reaches the 0xFF marker iff the unconsumed data is <= 56
    // bits — beyond that the reservoir fills first and take_marker returns
    // None ("no marker found where RSTn was expected",
    // src/decoder.rs:944-951), error semantics only the host
    // path reproduces. MJPEG-style pad bytes (one byte, 8 bits) are within
    // the 56-bit window and decode on-device. Final segments are exempt
    // (trailing bytes ride the tolerant end-of-scan marker scan).
    if (si + 1 < segs.size() && sg.len * 8 - p > 56) return;
    close_chunk();
    res.ok = true;
  };

  int nt = pp->nthreads > 0 ? pp->nthreads : 1;
  if (nt > static_cast<int>(segs.size())) nt = static_cast<int>(segs.size());
  if (nt > 8) nt = 8;
  if (nt > 1) {
    std::atomic<size_t> next{0};
    auto worker = [&]() {
      for (;;) {
        size_t i = next.fetch_add(1);
        if (i >= segs.size()) break;
        walk_segment(i);
      }
    };
    std::vector<std::thread> threads;
    for (int t = 1; t < nt; t++) threads.emplace_back(worker);
    worker();
    for (auto& th : threads) th.join();
  } else {
    for (size_t i = 0; i < segs.size(); i++) walk_segment(i);
  }

  // Merge in segment order.
  int64_t n_anchors = 0;
  int64_t max_chunk_syms = 0;
  for (size_t si = 0; si < segs.size(); si++) {
    WalkOut& r = results[si];
    if (!r.ok || r.c_end.size() != r.a_bits.size()) return PRESCAN_FALLBACK;
    const int64_t k = static_cast<int64_t>(r.a_bits.size());
    if (n_anchors + k > anchors_cap) return PRESCAN_FALLBACK;
    std::memcpy(anchor_bits + n_anchors, r.a_bits.data(), k * 4);
    std::memcpy(anchor_block + n_anchors, r.a_block.data(), k * 4);
    std::memcpy(anchor_slot + n_anchors, r.a_slot.data(), k * 4);
    std::memcpy(chunk_end + n_anchors, r.c_end.data(), k * 4);
    std::memcpy(chunk_syms + n_anchors, r.c_syms.data(), k * 4);
    if (r.max_syms > max_chunk_syms) max_chunk_syms = r.max_syms;
    n_anchors += k;
  }
  if (max_chunk_syms > pp->s_max) return PRESCAN_FALLBACK;

  // Trailing-RST tolerance (_finish_scan): skip RST markers after the scan.
  int32_t marker = segs.back().marker;
  while (marker >= 0xD0 && marker <= 0xD7) {
    size_t sp = static_cast<size_t>(pos);
    marker = read_marker(data, static_cast<size_t>(n), &sp);
    pos = static_cast<int64_t>(sp);
    if (marker < 0) { marker = -1; break; }
  }

  pp->pos = pos;
  pp->out_len = write_off;
  pp->n_anchors = n_anchors;
  pp->n_blocks = static_cast<int32_t>(total_mcus * plen);
  pp->pending_marker = marker;
  return PRESCAN_OK;
}

// ---------------------------------------------------------------------------
// Transcode: coefficient store -> anchored-chunk symbol stream (the bits
// interchange for host-decoded scans — progressive, quirk baselines).
// Bit-for-bit identical to the Python mirror (entropy/transcode.py
// transcode_scan): same MCU walk (incl. the mcu*8 >= image clip), same
// chunking policy, same canonical codes, same final-byte zero padding.

struct TranscodeParams {
  int32_t ncomp;
  int32_t interleaved;       // 0: single-component frame (grid = comp blocks)
  int32_t max_mcu_x, max_mcu_y;
  int32_t image_w, image_h;
  int32_t pattern_len;
  int32_t s_target, k_cap;
  int32_t max_span_bytes, worst_block_bytes;
  int64_t out_cap;
  int64_t out_len;           // out: bitstream bytes (incl. final partial)
  int64_t n_anchors;         // out
  int32_t n_blocks;          // out
  int32_t pattern[64];       // component index per MCU slot
  int32_t comp_bw[4];        // block grid width per component
  int32_t comp_hs[4], comp_vs[4];
  int64_t comp_off[4];       // int16 element offset into `stores`
};

enum TranscodeStatus { TC_OK = 0, TC_FALLBACK = 1, TC_GROW = 2 };

int jt_transcode_scan(const int16_t* stores, TranscodeParams* tp,
                      const uint32_t* dc_code, const uint8_t* dc_len,
                      const uint32_t* ac_code, const uint8_t* ac_len,
                      uint8_t* out, uint32_t* anchor_bits,
                      int32_t* anchor_block, int32_t* anchor_slot,
                      uint32_t* chunk_end, int32_t* chunk_syms) {
  uint64_t acc = 0;
  int nbits = 0;
  int64_t nbytes = 0;
  auto put = [&](uint32_t v, int count) {
    acc = (acc << count) | (v & ((count == 32 ? ~0u : ((1u << count) - 1))));
    nbits += count;
    while (nbits >= 8) {
      nbits -= 8;
      out[nbytes++] = static_cast<uint8_t>(acc >> nbits);
    }
    acc &= (1u << nbits) - 1;
  };
  auto bitpos = [&]() -> int64_t { return nbytes * 8 + nbits; };

  int64_t n_anchors = 0, n_closed = 0;
  int64_t syms_since = 0, blocks_since = 0;
  int64_t block_i = 0;
  int32_t preds[4] = {0, 0, 0, 0};

  auto close_chunk = [&]() {
    if (n_anchors > 0 && n_closed < n_anchors) {
      chunk_end[n_closed] = static_cast<uint32_t>(bitpos());
      chunk_syms[n_closed] = static_cast<int32_t>(syms_since);
      n_closed++;
    }
  };

  // One block; returns TC_OK / TC_FALLBACK.
  auto encode_block = [&](int comp, int64_t by, int64_t bx,
                          int32_t slot) -> int {
    int64_t p = bitpos();
    if (n_anchors == 0 || syms_since >= tp->s_target
        || blocks_since >= tp->k_cap
        || (p / 8 - anchor_bits[n_anchors - 1] / 8) + tp->worst_block_bytes
           > tp->max_span_bytes) {
      close_chunk();
      anchor_bits[n_anchors] = static_cast<uint32_t>(p);
      anchor_block[n_anchors] = static_cast<int32_t>(block_i);
      anchor_slot[n_anchors] = slot;
      n_anchors++;
      syms_since = 0;
      blocks_since = 0;
    }

    const int16_t* row = stores + tp->comp_off[comp]
        + (by * tp->comp_bw[comp] + bx) * 64;

    int32_t dc = row[0];
    int32_t diff = static_cast<int16_t>(
        static_cast<uint16_t>(dc - preds[comp]));
    preds[comp] = dc;
    uint32_t mag = diff < 0 ? static_cast<uint32_t>(-(int64_t)diff)
                            : static_cast<uint32_t>(diff);
    int cat = mag ? 32 - __builtin_clz(mag) : 0;
    int ln = dc_len[cat];
    if (ln == 0) return TC_FALLBACK;
    uint32_t mb = diff < 0
        ? static_cast<uint32_t>(diff + (1 << cat) - 1) & ((1u << cat) - 1)
        : static_cast<uint32_t>(diff);
    put((dc_code[cat] << cat) | mb, ln + cat);
    syms_since++;

    int prev = 0;
    for (int z = 1; z < 64; z++) {
      int32_t v = row[UNZIGZAG[z]];
      if (v == 0) continue;
      int run = z - prev - 1;
      prev = z;
      while (run >= 16) {
        put(ac_code[0xF0], ac_len[0xF0]);
        syms_since++;
        run -= 16;
      }
      uint32_t m = v < 0 ? static_cast<uint32_t>(-(int64_t)v)
                         : static_cast<uint32_t>(v);
      int s = 32 - __builtin_clz(m);
      if (s > 15) return TC_FALLBACK;
      int sym = (run << 4) | s;
      uint32_t bits = v > 0
          ? static_cast<uint32_t>(v)
          : static_cast<uint32_t>(v + (1 << s) - 1) & ((1u << s) - 1);
      put((ac_code[sym] << s) | bits, ac_len[sym] + s);
      syms_since++;
    }
    if (prev != 63) {
      put(ac_code[0], ac_len[0]);    // EOB
      syms_since++;
    }
    blocks_since++;
    block_i++;
    return TC_OK;
  };

  const int64_t guard = tp->worst_block_bytes + 32;
  for (int32_t my = 0; my < tp->max_mcu_y; my++) {
    if (static_cast<int64_t>(my) * 8 >= tp->image_h) break;
    for (int32_t mx = 0; mx < tp->max_mcu_x; mx++) {
      if (static_cast<int64_t>(mx) * 8 >= tp->image_w) break;
      if (nbytes + guard > tp->out_cap) return TC_GROW;
      if (tp->interleaved) {
        int32_t slot = 0;
        for (int c = 0; c < tp->ncomp; c++) {
          for (int v = 0; v < tp->comp_vs[c]; v++) {
            for (int h = 0; h < tp->comp_hs[c]; h++) {
              if (encode_block(c, static_cast<int64_t>(my) * tp->comp_vs[c] + v,
                               static_cast<int64_t>(mx) * tp->comp_hs[c] + h,
                               slot) != TC_OK)
                return TC_FALLBACK;
              slot++;
            }
          }
        }
      } else {
        if (encode_block(0, my, mx, 0) != TC_OK) return TC_FALLBACK;
      }
    }
  }
  close_chunk();
  if (nbits > 0) {
    out[nbytes++] = static_cast<uint8_t>((acc << (8 - nbits)) & 0xFF);
  }

  tp->out_len = nbytes;
  tp->n_anchors = n_anchors;
  tp->n_blocks = static_cast<int32_t>(block_i);
  return TC_OK;
}

// Fill one slot-size class of the Pallas bits-interchange layout.
//
// Replaces pallas_decode.pack_classes's numpy fancy-gather (measured ~7ms per
// megapixel-class image — the single hottest host-staging step after the
// prescan walk). `words` is the unstuffed big-endian-packed u32 stream
// (AnchoredScan.words); item i's slot covers bytes starts[i]..+4*slot_words,
// so word w of the slot is the 32-bit big-endian window at byte
// starts[i]+4*w — two word loads and a constant per-item shift, no byte
// gather. Out-of-range words read as 0 (matches the python path's zero fill
// past the padded stream). Output is the kernel's transposed tile layout:
// word w of item i lands at out[w*nb + i]; pad items (i >= n_items) are
// zeroed here so callers can pass an uninitialised buffer.
void jt_pack_slots(const uint32_t* words, int64_t n_words,
                   const int64_t* starts, int64_t n_items, int64_t nb,
                   int32_t slot_words, uint32_t* out, int32_t nthreads) {
  auto run = [&](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; i++) {
      const int64_t s = starts[i];
      const int64_t b0 = s >> 2;
      const int m = static_cast<int>(s & 3) * 8;
      uint32_t* col = out + i;
      if (m == 0) {
        if (b0 >= 0 && b0 + slot_words <= n_words) {
          const uint32_t* src = words + b0;
          for (int32_t w = 0; w < slot_words; w++) col[w * nb] = src[w];
        } else {
          for (int32_t w = 0; w < slot_words; w++) {
            const int64_t idx = b0 + w;
            col[w * nb] = (idx >= 0 && idx < n_words) ? words[idx] : 0;
          }
        }
      } else {
        if (b0 >= 0 && b0 + slot_words + 1 <= n_words) {
          const uint32_t* src = words + b0;
          uint32_t a = src[0];
          for (int32_t w = 0; w < slot_words; w++) {
            const uint32_t b = src[w + 1];
            col[w * nb] = (a << m) | (b >> (32 - m));
            a = b;
          }
        } else {
          for (int32_t w = 0; w < slot_words; w++) {
            const int64_t idx = b0 + w;
            const uint32_t a =
                (idx >= 0 && idx < n_words) ? words[idx] : 0;
            const uint32_t b =
                (idx + 1 >= 0 && idx + 1 < n_words) ? words[idx + 1] : 0;
            col[w * nb] = (a << m) | (b >> (32 - m));
          }
        }
      }
    }
  };
  if (nthreads > 1 && n_items > 4096) {
    std::vector<std::thread> ts;
    const int64_t chunk = (n_items + nthreads - 1) / nthreads;
    for (int t = 0; t < nthreads; t++) {
      const int64_t a = t * chunk, b = std::min(n_items, a + chunk);
      if (a < b) ts.emplace_back(run, a, b);
    }
    for (auto& th : ts) th.join();
  } else {
    run(0, n_items);
  }
  // Zero the pad tail of every word row (real columns were all written).
  for (int32_t w = 0; w < slot_words; w++) {
    std::memset(out + w * nb + n_items, 0,
                static_cast<size_t>(nb - n_items) * 4);
  }
}

}  // extern "C"
