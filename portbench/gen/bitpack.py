"""Entropy-coded segments from (code, length) symbol arrays, in NumPy.

Each symbol is at most 32 bits. A symbol's bits land at its bit offset in
a stream of 32-bit words: shifted into a 64-bit window, its high half
adds into word `offset // 32` and its low half into the next. The
symbols' bits never overlap, so adding is OR-ing, and a word's sum stays
below 2^32, exact in float64 (`np.bincount` weights).
"""

from __future__ import annotations

import numpy as np


def pack(values: np.ndarray, nbits: np.ndarray) -> bytes:
    """MSB-first concatenation of `values[i]` in `nbits[i]` bits (each
    1..32), padded with 1 bits to a byte (B.1.1.5), then byte-stuffed
    (0x00 after every 0xFF, B.1.1.5)."""
    v = np.asarray(values, np.uint64)
    n = np.asarray(nbits, np.int64)
    if len(n) and (n.min() < 0 or n.max() > 32):
        raise ValueError("a symbol is longer than 32 bits")
    total = int(n.sum())
    pad = -total % 8
    if pad:
        v = np.append(v, np.uint64((1 << pad) - 1))
        n = np.append(n, pad)
        total += pad
    pos = np.cumsum(n) - n
    word = pos >> 5
    window = v << (64 - (pos & 31) - n).astype(np.uint64)
    words = (np.bincount(word, (window >> np.uint64(32)).astype(np.float64),
                         total // 32 + 2)
             + np.bincount(word + 1,
                           (window & np.uint64(0xFFFFFFFF)).astype(np.float64),
                           total // 32 + 2))
    raw = words.astype(np.uint64).astype(">u4").view(np.uint8)[:total // 8]
    return np.insert(raw, np.flatnonzero(raw == 0xFF) + 1, 0).tobytes()


def segment(marker: int, payload: bytes) -> bytes:
    """A marker segment: FF marker, the 16-bit length, the payload."""
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def categories(v: np.ndarray) -> tuple:
    """The magnitude category (SSSS) of each int64 difference or
    coefficient, and its extra bits (F.1.2.1: a negative value as its
    one's complement in SSSS bits)."""
    cat = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    extra = np.where(v >= 0, v, v + (1 << cat) - 1)
    return cat, extra


def canonical_codes(bits, values) -> tuple:
    """Annex C: (code, length) per symbol value, [256] each, from a DHT's
    16 counts and its values (0 length: no code)."""
    code = np.zeros(256, np.int64)
    length = np.zeros(256, np.int64)
    nxt, k = 0, 0
    for size in range(1, 17):
        for _ in range(bits[size - 1]):
            code[values[k]] = nxt
            length[values[k]] = size
            nxt += 1
            k += 1
        nxt <<= 1
    return code, length
