"""Copy of `jpeg_decoder_tpu/huffman.py` at commit 0c2d0ea.

Canonical Huffman table derivation and decode LUTs.

Capability parity with `src/huffman.rs:175-285` (table build) and
`:295-346` (OpenDML MJPEG default tables). The decode-time state machine lives in
the entropy layer (Python oracle in `entropy/scan_python.py`, C++ host kernel in
`entropy/cpp/`); this module only derives the *tables*, stored as flat numpy
arrays so they can be handed to the C++ kernel without any conversion:

- ``lut_value``/``lut_size``  : 256-entry fast path for codes of <= 8 bits
  (value, code length); size 0 means "fall back to the canonical search".
- ``maxcode``/``delta``       : per-length canonical decode parameters
  (F.2.2.3 Figure F.15; delta[i] = VALPTR(i) - MINCODE(i)).
- ``ac_lut_value``/``ac_lut_run_size`` : fused AC fast path that also performs
  the F.12 receive/extend, for AC codes whose code+magnitude bits fit in 8 bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .errors import FormatError

LUT_BITS = 8


def extend(value: int, count: int) -> int:
    """F.2.2.1 Figure F.12 sign extension (`src/huffman.rs:165-173`)."""
    vt = 1 << (count - 1)
    if value < vt:
        return value - (1 << count) + 1
    return value


FAST_BITS = 10  # width of the fused decode+extend LUTs (native fast path)


@dataclasses.dataclass
class HuffmanTable:
    """Derived decode tables for one DC or AC Huffman table."""

    is_ac: bool
    values: np.ndarray          # uint8[n]
    delta: np.ndarray           # int32[16]
    maxcode: np.ndarray         # int32[16]
    lut_value: np.ndarray       # uint8[256]
    lut_size: np.ndarray        # uint8[256]
    ac_lut_value: np.ndarray | None = None   # int16[256]
    ac_lut_run_size: np.ndarray | None = None  # uint8[256]: (run << 4) | total_bits
    # 10-bit fused LUTs (native fast path; exact shortcuts, bits==0 => miss):
    # DC: value = diff (already extended); AC: value + run, both with total
    # consumed bit count.
    fast_value: np.ndarray | None = None     # int16[1024]
    fast_run: np.ndarray | None = None       # uint8[1024] (AC only, else zeros)
    fast_bits: np.ndarray | None = None      # uint8[1024]
    # Single-load packing for the native kernel: value(u16)|run<<16|bits<<20.
    fast_packed: np.ndarray | None = None    # uint32[1024]
    # Fused 2-symbol decode LUT over 12-bit windows (AC tables only): one
    # lookup resolves TWO consecutive AC symbols — coeff+coeff or
    # coeff+EOB(rr=0) — when both codes AND both magnitude-bit fields fit the
    # window. Entry 0 = miss. See _build_fast2_lut for the packing.
    fast2: np.ndarray | None = None          # uint64[4096] or None

    @classmethod
    def build(cls, bits: "list[int] | np.ndarray", values: "bytes | np.ndarray",
              is_ac: bool) -> "HuffmanTable":
        """Derive canonical codes and LUTs from a DHT (bits, values) spec.

        Annex C derivation per `src/huffman.rs:191-285`.
        Raises FormatError on an over-subscribed code length table.
        Memoized: identical (bits, values, class) specs — ubiquitous across
        images from the same encoder — share one table object.
        """
        key = (bytes(bits), bytes(values), is_ac)
        cached = _BUILD_CACHE.get(key)
        if cached is not None:
            return cached
        table = cls._build_uncached(list(bits), values, is_ac)
        if len(_BUILD_CACHE) > 512:
            _BUILD_CACHE.clear()
        _BUILD_CACHE[key] = table
        return table

    @classmethod
    def _build_uncached(cls, bits, values, is_ac: bool) -> "HuffmanTable":
        assert len(bits) == 16
        values = np.frombuffer(bytes(values), dtype=np.uint8).copy()

        # Figure C.1: huffsize — the code length of each value, in order.
        huffsize: list[int] = []
        for i, count in enumerate(bits):
            huffsize.extend([i + 1] * count)
        if not huffsize:
            raise FormatError("encountered table with zero length in DHT")

        # Figure C.2: huffcode — canonical code assignment.
        huffcode = [0] * len(huffsize)
        code = 0
        code_size = huffsize[0]
        for i, size in enumerate(huffsize):
            while code_size < size:
                code <<= 1
                code_size += 1
            if code >= (1 << size):
                raise FormatError("bad huffman code length")
            huffcode[i] = code
            code += 1

        # Figure F.15 canonical decode parameters.
        delta = np.zeros(16, dtype=np.int32)
        maxcode = np.full(16, -1, dtype=np.int32)
        j = 0
        for i in range(16):
            if bits[i] != 0:
                delta[i] = j - huffcode[j]
                j += bits[i]
                maxcode[i] = huffcode[j - 1]

        # 8-bit prefix LUT.
        lut_value = np.zeros(1 << LUT_BITS, dtype=np.uint8)
        lut_size = np.zeros(1 << LUT_BITS, dtype=np.uint8)
        for i, size in enumerate(huffsize):
            if size > LUT_BITS:
                continue
            bits_remaining = LUT_BITS - size
            start = huffcode[i] << bits_remaining
            lut_value[start:start + (1 << bits_remaining)] = values[i]
            lut_size[start:start + (1 << bits_remaining)] = size

        ac_lut_value = None
        ac_lut_run_size = None
        if is_ac:
            # Fused AC fast path: decode + receive_extend in one 8-bit lookup
            # (`src/huffman.rs:224-243`).
            ac_lut_value = np.zeros(1 << LUT_BITS, dtype=np.int16)
            ac_lut_run_size = np.zeros(1 << LUT_BITS, dtype=np.uint8)
            for i in range(1 << LUT_BITS):
                value = int(lut_value[i])
                size = int(lut_size[i])
                run_length = value >> 4
                magnitude = value & 0x0F
                if magnitude > 0 and size + magnitude <= LUT_BITS:
                    raw = ((i << size) & 0xFF) >> (LUT_BITS - magnitude)
                    ac_lut_value[i] = extend(raw, magnitude)
                    ac_lut_run_size[i] = (run_length << 4) | (size + magnitude)

        fast_value, fast_run, fast_bits = _build_fast_lut(
            huffcode, huffsize, values, is_ac)
        fast_packed = ((fast_value.astype(np.uint32) & 0xFFFF)
                       | (fast_run.astype(np.uint32) << 16)
                       | (fast_bits.astype(np.uint32) << 20))
        fast2 = _build_fast2_lut(huffcode, huffsize, values) if is_ac else None

        return cls(
            is_ac=is_ac,
            values=values,
            delta=delta,
            maxcode=maxcode,
            lut_value=lut_value,
            lut_size=lut_size,
            ac_lut_value=ac_lut_value,
            ac_lut_run_size=ac_lut_run_size,
            fast_value=fast_value,
            fast_run=fast_run,
            fast_bits=fast_bits,
            fast_packed=fast_packed,
            fast2=fast2,
        )


_BUILD_CACHE: dict = {}


def _build_fast_lut(huffcode, huffsize, values: np.ndarray, is_ac: bool):
    """Fused decode(+receive+extend) LUTs over FAST_BITS-wide prefixes.

    Exact shortcuts for the native kernel: an entry resolves a full
    (symbol, magnitude-bits) pair when code size + magnitude fits the window.
    DC entries hold the extended diff; AC entries hold the extended value and
    the zero run. bits == 0 marks a miss (fall back to the canonical path).
    Vectorized so per-table build cost stays in the tens of microseconds.
    """
    n = 1 << FAST_BITS
    fast_value = np.zeros(n, np.int16)
    fast_run = np.zeros(n, np.uint8)
    fast_bits = np.zeros(n, np.uint8)

    prefixes = np.arange(n, dtype=np.uint32)
    for i, (code, size) in enumerate(zip(huffcode, huffsize)):
        if size > FAST_BITS:
            continue
        sym = int(values[i])
        magnitude = sym & 0x0F if is_ac else sym
        if is_ac:
            run = sym >> 4
            if magnitude == 0 or size + magnitude > FAST_BITS:
                continue
        else:
            run = 0
            if magnitude > 11 or size + magnitude > FAST_BITS:
                continue
        span = FAST_BITS - size - magnitude  # free low bits
        base = code << (FAST_BITS - size)
        if magnitude == 0:
            # DC category 0: diff is zero, consumes just the code.
            sl = slice(base, base + (1 << (FAST_BITS - size)))
            fast_value[sl] = 0
            fast_run[sl] = run
            fast_bits[sl] = size
            continue
        mag_vals = np.arange(1 << magnitude, dtype=np.int32)
        extended = np.where(mag_vals < (1 << (magnitude - 1)),
                            mag_vals - (1 << magnitude) + 1, mag_vals)
        # Each (code, magnitude bits) pair covers 2^span consecutive entries.
        start = base + (mag_vals << span)
        for rep in range(1 << span):
            idx = start + rep
            fast_value[idx] = extended.astype(np.int16)
            fast_run[idx] = run
            fast_bits[idx] = size + magnitude
    return fast_value, fast_run, fast_bits


def _build_fast2_lut(huffcode, huffsize, values: np.ndarray) -> np.ndarray:
    """Fused 1-or-2-symbol AC decode LUT over FAST_BITS (10-bit) windows.

    The native kernel's single AC lookup: every window that resolves a first
    coefficient (code1+mag1 <= 10, exactly the fast_packed population) gets an
    entry; when the NEXT symbol also fits the same window — a coefficient or
    an EOB with rr == 0 — the entry additionally carries it, so one load
    resolves two symbols (~1/3 of AC symbols on photographic content pair
    up). uint64 entry packing:

        bits  0..15  val1 (int16, extended)
        bits 16..31  val2 (int16, extended; 0 for the EOB case)
        bits 32..35  run1
        bits 36..39  run2
        bits 40..44  pair consumed bits c1+c2 (<= FAST_BITS)
        bit  45      second symbol is EOB(rr=0)
        bits 46..50  pair minimum buffered bits: 16 + c1
        bit  51      pair-capable entry
        bits 52..55  c1 (single-symbol consumed bits)
        bit  56      first symbol is EOB(rr=0): consume c1, end the block
                     (EOB is ~1/5 of AC symbols — every block ends with one
                     unless coefficient 63 is occupied — and the fast tier
                     otherwise sends it down the canonical path)

    Entry 0 = miss. Exactness: the oracle (scan_python / reference
    decoder.rs) refills before a symbol only when fewer than 16 bits are
    buffered, so the kernel takes the single at num_bits >= 16 (the old
    fast_packed gate) and the pair at num_bits >= 16 + c1 — no oracle refill
    is ever skipped, and consumption, marker and EOF timing are identical.
    The kernel-side user is entropy.cc::decode_block.
    """
    n = 1 << FAST_BITS
    # Single-symbol tables at window width: coefficient entries + EOB length.
    val1 = np.zeros(n, np.int16)
    run1 = np.zeros(n, np.uint8)
    bits1 = np.zeros(n, np.uint8)
    eob1 = np.zeros(n, np.uint8)    # consumed bits of an EOB(rr=0) code
    for i, (code, size) in enumerate(zip(huffcode, huffsize)):
        if size > FAST_BITS:
            continue
        sym = int(values[i])
        base = code << (FAST_BITS - size)
        if sym == 0x00:
            eob1[base:base + (1 << (FAST_BITS - size))] = size
            continue
        mag = sym & 0x0F
        if mag == 0 or size + mag > FAST_BITS:
            continue  # ZRL / EOB-run / oversize: never fused
        run = sym >> 4
        mag_vals = np.arange(1 << mag, dtype=np.int32)
        extended = np.where(mag_vals < (1 << (mag - 1)),
                            mag_vals - (1 << mag) + 1, mag_vals)
        span = FAST_BITS - size - mag
        start = base + (mag_vals << span)
        for rep in range(1 << span):
            idx = start + rep
            val1[idx] = extended.astype(np.int16)
            run1[idx] = run
            bits1[idx] = size + mag
    # Pair fusion: shift out symbol 1, decode symbol 2 from the remainder.
    w = np.arange(n, dtype=np.int64)
    c1 = bits1.astype(np.int64)
    shifted = (w << c1) & (n - 1)
    rem = FAST_BITS - c1
    c2 = bits1[shifted].astype(np.int64)
    e2 = eob1[shifted].astype(np.int64)
    has1 = c1 > 0
    coeff2 = has1 & (c2 > 0) & (c2 <= rem)
    eobs2 = has1 & (e2 > 0) & (e2 <= rem)  # prefix-free: disjoint from coeff2

    def u64(a):
        return a.astype(np.uint64)

    v1 = u64(val1.view(np.uint16))
    v2 = u64(val1[shifted].view(np.uint16))
    r1 = u64(run1)
    r2 = u64(run1[shifted])
    minb = u64(16 + c1)
    single = v1 | (r1 << np.uint64(32)) | (u64(c1) << np.uint64(52))
    out = np.where(has1, single, np.uint64(0))
    eobs1 = eob1.astype(np.int64) > 0
    out[eobs1] = ((u64(eob1.astype(np.int64)) << np.uint64(52))
                  | np.uint64(1 << 56))[eobs1]
    pair_coeff = ((v2 << np.uint64(16)) | (r2 << np.uint64(36))
                  | (u64(c1 + c2) << np.uint64(40)) | (minb << np.uint64(46))
                  | np.uint64(1 << 51))
    pair_eob = ((u64(c1 + e2) << np.uint64(40)) | np.uint64(1 << 45)
                | (minb << np.uint64(46)) | np.uint64(1 << 51))
    out[coeff2] |= pair_coeff[coeff2]
    out[eobs2] |= pair_eob[eobs2]
    return out


# OpenDML K.3 default tables for MJPEG streams that omit DHT
# (`src/huffman.rs:295-346`).
_MJPEG_DC_LUMA_BITS = [0x00, 0x01, 0x05, 0x01, 0x01, 0x01, 0x01, 0x01,
                       0x01, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00]
_MJPEG_DC_LUMA_VALUES = bytes(range(12))
_MJPEG_DC_CHROMA_BITS = [0x00, 0x03, 0x01, 0x01, 0x01, 0x01, 0x01, 0x01,
                         0x01, 0x01, 0x01, 0x00, 0x00, 0x00, 0x00, 0x00]
_MJPEG_DC_CHROMA_VALUES = bytes(range(12))
_MJPEG_AC_LUMA_BITS = [0x00, 0x02, 0x01, 0x03, 0x03, 0x02, 0x04, 0x03,
                       0x05, 0x05, 0x04, 0x04, 0x00, 0x00, 0x01, 0x7D]
_MJPEG_AC_LUMA_VALUES = bytes([
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07,
    0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0,
    0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49,
    0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69,
    0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7,
    0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5,
    0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
])
_MJPEG_AC_CHROMA_BITS = [0x00, 0x02, 0x01, 0x02, 0x04, 0x04, 0x03, 0x04,
                         0x07, 0x05, 0x04, 0x04, 0x00, 0x01, 0x02, 0x77]
_MJPEG_AC_CHROMA_VALUES = bytes([
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71,
    0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0,
    0x15, 0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48,
    0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68,
    0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3,
    0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8,
    0xF9, 0xFA,
])


def fill_default_mjpeg_tables(scan, dc_tables: list, ac_tables: list) -> None:
    """Install OpenDML K.3 defaults for table slots a MJPEG scan uses but never
    defined (`src/huffman.rs:295-346`; triggered per
    `src/decoder.rs:817-823`). Mutates the table lists in place."""
    if dc_tables[0] is None and 0 in scan.dc_table_indices:
        dc_tables[0] = HuffmanTable.build(_MJPEG_DC_LUMA_BITS, _MJPEG_DC_LUMA_VALUES, is_ac=False)
    if dc_tables[1] is None and 1 in scan.dc_table_indices:
        dc_tables[1] = HuffmanTable.build(_MJPEG_DC_CHROMA_BITS, _MJPEG_DC_CHROMA_VALUES, is_ac=False)
    if ac_tables[0] is None and 0 in scan.ac_table_indices:
        ac_tables[0] = HuffmanTable.build(_MJPEG_AC_LUMA_BITS, _MJPEG_AC_LUMA_VALUES, is_ac=True)
    if ac_tables[1] is None and 1 in scan.ac_table_indices:
        ac_tables[1] = HuffmanTable.build(_MJPEG_AC_CHROMA_BITS, _MJPEG_AC_CHROMA_VALUES, is_ac=True)
