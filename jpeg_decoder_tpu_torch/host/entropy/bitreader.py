"""Copy of `jpeg_decoder_tpu/entropy/bitreader.py` at commit 0c2d0ea.

Bit-reservoir reader over the entropy-coded segment.

Semantics-parity with the reference's `HuffmanDecoder` bit plumbing
(`src/huffman.rs:14-160`): a 64-bit MSB-first reservoir,
0xFF00 byte-unstuffing, in-band marker capture (after which the reservoir is
fed zero bits), and F.12 receive/extend. Decode-time table search mirrors
F.2.2.3 Figure F.16 (`src/huffman.rs:31-58`).

This is the oracle implementation; the C++ host kernel implements the same
state machine natively.
"""

from __future__ import annotations

from ..errors import FormatError, IoError
from ..huffman import LUT_BITS, HuffmanTable

_MASK64 = (1 << 64) - 1


class BitReader:
    """MSB-first bit reservoir over an in-memory buffer, advancing `cursor.pos`."""

    __slots__ = ("data", "cursor", "bits", "num_bits", "marker")

    def __init__(self, cursor):
        self.data = cursor.data
        self.cursor = cursor
        self.bits = 0
        self.num_bits = 0
        self.marker = None  # captured marker byte, or None

    # -- reservoir -----------------------------------------------------------

    def reset(self) -> None:
        """Restart-boundary reset (`src/huffman.rs:98-101`)."""
        self.bits = 0
        self.num_bits = 0

    def compact(self) -> None:
        """Streaming-mode compaction point: discard consumed cursor bytes and
        resync the cached buffer. Callers must be between `_read_bits` calls
        (cursor.pos authoritative), e.g. at MCU-row boundaries."""
        self.cursor.compact()
        self.data = self.cursor.data

    def _grow(self, pos: int):
        """Slow path on buffer exhaustion: pull more bytes from the cursor's
        source (the reference reads its `io::Read` inside the bit loop,
        `src/huffman.rs:123-160`; this is the analog for
        streaming cursors). Returns the refreshed (data, len)."""
        cursor = self.cursor
        if cursor.data is not self.data:
            self.data = cursor.data  # external compaction happened
        if len(self.data) <= pos:
            cursor._ensure(pos + 1)
            self.data = cursor.data
        return self.data, len(self.data)

    def _read_bits(self) -> None:
        """Refill reservoir to >56 bits (`src/huffman.rs:123-160`)."""
        data = self.data
        cursor = self.cursor
        pos = cursor.pos
        n = len(data)
        bits = self.bits
        num_bits = self.num_bits
        marker = self.marker

        while num_bits <= 56:
            if marker is not None:
                byte = 0  # After a marker: feed zero bits.
            else:
                if pos >= n:
                    cursor.pos = pos
                    self.bits, self.num_bits = bits, num_bits
                    data, n = self._grow(pos)
                    if pos >= n:
                        raise IoError()
                byte = data[pos]
                pos += 1

                if byte == 0xFF:
                    if pos >= n:
                        cursor.pos = pos
                        self.bits, self.num_bits = bits, num_bits
                        data, n = self._grow(pos)
                        if pos >= n:
                            raise IoError()
                    next_byte = data[pos]
                    pos += 1
                    if next_byte != 0x00:
                        # End of entropy data: skip fill 0xFFs, capture marker.
                        while next_byte == 0xFF:
                            if pos >= n:
                                cursor.pos = pos
                                self.bits, self.num_bits = bits, num_bits
                                data, n = self._grow(pos)
                                if pos >= n:
                                    raise IoError()
                            next_byte = data[pos]
                            pos += 1
                        if next_byte == 0x00:
                            cursor.pos = pos
                            self.bits, self.num_bits = bits, num_bits
                            raise FormatError("FF 00 found where marker was expected")
                        marker = next_byte
                        continue

            bits |= byte << (56 - num_bits)
            num_bits += 8

        cursor.pos = pos
        self.bits = bits & _MASK64
        self.num_bits = num_bits
        self.marker = marker

    def _peek_bits(self, count: int) -> int:
        return (self.bits >> (64 - count)) & ((1 << count) - 1)

    def _consume_bits(self, count: int) -> None:
        self.bits = (self.bits << count) & _MASK64
        self.num_bits -= count

    # -- decoding ------------------------------------------------------------

    def decode(self, table: HuffmanTable) -> int:
        """Decode one Huffman symbol (F.16; `src/huffman.rs:31-58`)."""
        if self.num_bits < 16:
            self._read_bits()

        idx = (self.bits >> 56) & 0xFF
        size = table.lut_size[idx]
        if size > 0:
            self._consume_bits(int(size))
            return int(table.lut_value[idx])

        bits16 = self.bits >> 48
        maxcode = table.maxcode
        for i in range(LUT_BITS, 16):
            code = bits16 >> (15 - i)
            if code <= maxcode[i]:
                self._consume_bits(i + 1)
                return int(table.values[code + int(table.delta[i])])

        raise FormatError("failed to decode huffman code")

    def decode_fast_ac(self, table: HuffmanTable):
        """Fused AC decode+extend fast path (`src/huffman.rs:60-78`).

        Returns (value, run) or None when the fast LUT can't resolve it.
        """
        if self.num_bits < LUT_BITS:
            self._read_bits()
        idx = (self.bits >> 56) & 0xFF
        run_size = int(table.ac_lut_run_size[idx])
        if run_size != 0:
            self._consume_bits(run_size & 0x0F)
            return int(table.ac_lut_value[idx]), run_size >> 4
        return None

    def get_bits(self, count: int) -> int:
        if self.num_bits < count:
            self._read_bits()
        value = self._peek_bits(count)
        self._consume_bits(count)
        return value

    def receive_extend(self, count: int) -> int:
        """F.2.2.1 receive+extend (`src/huffman.rs:93-96,165-173`)."""
        value = self.get_bits(count)
        vt = 1 << (count - 1)
        if value < vt:
            return value - (1 << count) + 1
        return value

    def take_marker(self):
        """Refill (capturing any in-band marker) and take it
        (`src/huffman.rs:103-105`)."""
        self._read_bits()
        marker = self.marker
        self.marker = None
        return marker
