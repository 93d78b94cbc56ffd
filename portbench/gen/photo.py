"""Baseline 4:2:0 JPEG photos from seeded pixels, in NumPy: the inputs of
the configurations whose generator is "photo".

Each photo is `textured_parts` waves and grain (`grained`), converted to
YCbCr (JFIF), its chroma averaged over 2x2, cut into 8x8 blocks,
transformed by the orthonormal DCT, quantised by the Annex K tables
scaled as libjpeg scales them for the configuration's quality, and coded
with the Annex K Huffman tables (K.3), one interleaved scan, no restart
interval. The quantised
coefficients are kept: the plain reference reconstructs from them, never
from the stream.
"""

from __future__ import annotations

import concurrent.futures as cf

import numpy as np

from .bitpack import canonical_codes, categories, pack, segment
from .textured import THREADS, grained, rng_for, textured_parts

# Annex K.1, natural (row-major) order.
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.full(64, 99)
CHROMA_Q[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25, 32]] = [
    17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66, 99]

# Annex K.3 (copied from the port's host copy of the OpenDML defaults,
# `host/huffman.py`, which are these tables).
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def _zigzag() -> np.ndarray:
    """ZIGZAG[k]: the natural index of zigzag position k (Figure A.6)."""
    cells = sorted(((r, c) for r in range(8) for c in range(8)),
                   key=lambda rc: (rc[0] + rc[1],
                                   rc[0] if (rc[0] + rc[1]) % 2 else rc[1]))
    return np.array([r * 8 + c for r, c in cells])


ZIGZAG = _zigzag()
# Draws of a photo's content before its size class is given up, and
# secant steps of its grain's strength a draw.
MAX_DRAWS = 16
NOISE_STEPS = 4
# Entropy-coded bytes a pixel per unit of grain (the first step's slope;
# about the textured content's at quality 90) and the strengths allowed.
BYTES_PER_NOISE = 0.031
NOISE_MIN, NOISE_MAX = 0.05, 40.0
# The orthonormal 8-point DCT-II: F = C X C^T.
_U = np.arange(8)
DCT = np.cos((2 * _U[None, :] + 1) * _U[:, None] * np.pi / 16) / 2
DCT[0] /= np.sqrt(2)


def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's `jpeg_quality_scaling` and `jpeg_add_quant_table` with
    force_baseline: uint16[64], natural order, each in [1, 255]."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255).astype(np.uint16)


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[H, W] (multiples of 8) -> [H/8, W/8, 64] raster blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3) \
        .reshape(h // 8, w // 8, 64)


def _quantised(plane: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """Level shift, DCT and quantise every block: int16 [bh, bw, 64]."""
    b = _blocks(plane).reshape(-1, 8, 8).astype(np.float64) - 128.0
    f = (DCT @ b @ DCT.T).reshape(plane.shape[0] // 8, plane.shape[1] // 8,
                                  64)
    return np.rint(f / qt.astype(np.float64)).astype(np.int16)


def encode_420(rgb: np.ndarray, quality: int) -> tuple:
    """(JPEG bytes, [Y, Cb, Cr] int16 [bh, bw, 64] natural-order quantised
    coefficients of the coded block grids, [luma, chroma, chroma]
    uint16[64] tables, the entropy-coded segment's bytes) of a baseline
    4:2:0 JFIF JPEG of `rgb` (uint8 [H, W, 3])."""
    h, w, _ = rgb.shape
    mh, mw = -(-h // 16), -(-w // 16)
    px = np.pad(rgb, ((0, mh * 16 - h), (0, mw * 16 - w), (0, 0)),
                mode="edge").astype(np.float32)
    r, g, b = px[..., 0], px[..., 1], px[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128

    def half(p):
        return p.reshape(mh * 8, 2, mw * 8, 2).mean((1, 3))

    lq = quality_table(LUMA_Q, quality)
    cq = quality_table(CHROMA_Q, quality)
    coefs = [_quantised(y, lq), _quantised(half(cb), cq),
             _quantised(half(cr), cq)]
    scan = _scan_bits(coefs, mh, mw)
    jfif = b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    dqt = b"".join(bytes([i]) + q[ZIGZAG].astype(np.uint8).tobytes()
                   for i, q in enumerate((lq, cq)))
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") \
        + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    dht = b"".join(bytes([cls << 4 | i, *bits, *vals])
                   for cls, i, (bits, vals) in ((0, 0, DC_LUMA),
                                                (1, 0, AC_LUMA),
                                                (0, 1, DC_CHROMA),
                                                (1, 1, AC_CHROMA)))
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    data = (b"\xff\xd8" + segment(0xE0, jfif) + segment(0xDB, dqt)
            + segment(0xC0, sof) + segment(0xC4, dht) + segment(0xDA, sos)
            + scan + b"\xff\xd9")
    return data, coefs, [lq, cq, cq], len(scan)


def _scan_bits(coefs: list, mh: int, mw: int) -> bytes:
    """The interleaved scan of the three components (MCU: four Y blocks,
    Cb, Cr), Huffman coded: per block its DC difference, then per
    nonzero AC coefficient in zigzag order ZRLs for each 16 zeros before
    it and its (run, size) symbol, then EOB unless the block ends on a
    nonzero coefficient."""
    y = coefs[0].reshape(mh, 2, mw, 2, 64).transpose(0, 2, 1, 3, 4) \
        .reshape(mh * mw, 4, 64)
    blocks = np.concatenate([y, coefs[1].reshape(-1, 1, 64),
                             coefs[2].reshape(-1, 1, 64)], 1)
    zz = blocks.reshape(-1, 64)[:, ZIGZAG].astype(np.int64)
    comp = np.tile([0, 0, 0, 0, 1, 2], mh * mw)
    table = np.minimum(comp, 1)
    dc_codes = [canonical_codes(*DC_LUMA), canonical_codes(*DC_CHROMA)]
    ac_codes = [canonical_codes(*AC_LUMA), canonical_codes(*AC_CHROMA)]
    dc_code = np.stack([c for c, _ in dc_codes])
    dc_len = np.stack([n for _, n in dc_codes])
    ac_code = np.stack([c for c, _ in ac_codes])
    ac_len = np.stack([n for _, n in ac_codes])

    keys, vals, lens = [], [], []
    # DC differences, per component in scan order.
    diff = np.empty(len(zz), np.int64)
    for c in range(3):
        m = comp == c
        diff[m] = np.diff(zz[m, 0], prepend=0)
    cat, extra = categories(diff)
    n = len(zz)
    keys.append(np.arange(n) * 256)
    vals.append(dc_code[table, cat] << cat | extra)
    lens.append(dc_len[table, cat] + cat)
    # AC coefficients: runs, ZRLs, (run, size) symbols.
    blk, k = np.nonzero(zz[:, 1:])
    k = k + 1
    coef = zz[blk, k]
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, 0, np.roll(k, 1))
    run = k - prev - 1
    cat, extra = categories(coef)
    t = table[blk]
    sym = (run & 15) << 4 | cat
    keys.append(blk * 256 + 2 * k)
    vals.append(ac_code[t, sym] << cat | extra)
    lens.append(ac_len[t, sym] + cat)
    zrl = np.repeat(np.arange(len(blk)), run >> 4)
    keys.append(blk[zrl] * 256 + 2 * k[zrl] - 1)
    vals.append(ac_code[t[zrl], 0xF0])
    lens.append(ac_len[t[zrl], 0xF0])
    # EOB where the last coefficient is zero.
    final = np.ones(len(blk), bool)
    final[:-1] = blk[:-1] != blk[1:]
    last = np.zeros(n, np.int64)
    last[blk[final]] = k[final]
    eob = np.flatnonzero(last < 63)
    keys.append(eob * 256 + 200)
    vals.append(ac_code[table[eob], 0x00])
    lens.append(ac_len[table[eob], 0x00])

    order = np.argsort(np.concatenate(keys), kind="stable")
    lens = np.concatenate(lens)[order]
    if (lens <= 0).any():
        raise ValueError("a symbol has no code in the Annex K tables")
    return pack(np.concatenate(vals)[order], lens)


def photo(config: dict, seed: int, index: int) -> dict:
    """Photo `index` of the pool of `seed`: {"jpeg", "coefs", "qts",
    "scan_bytes", "blocks" (coded 8x8 blocks), "out_bytes" (the
    interleaved image's)}. Photo i is of the configuration's size class i
    % len(size_classes): its content (waves and grain) comes from the
    seed, and its grain's strength is found by secant steps from the
    class's `noise` until its entropy-coded bytes lie in the class's
    `scan_bytes`, so every seed gives the same sizes in the same places
    of the pool, other content; a content the steps miss is drawn
    again."""
    h, w = config["height"], config["width"]
    cls = config["size_classes"][index % len(config["size_classes"])]
    lo, hi = cls["scan_bytes"]
    target = (lo + hi) / 2
    for attempt in range(MAX_DRAWS):
        waves, grain = textured_parts(h, w, 3,
                                      rng_for(seed, 1, index, attempt))
        noise, seen = cls["noise"], []
        for _step in range(NOISE_STEPS):
            data, coefs, qts, scan = encode_420(
                grained(waves, grain, noise), config["quality"])
            if lo <= scan <= hi:
                return {"jpeg": data, "coefs": coefs, "qts": qts,
                        "scan_bytes": scan,
                        "blocks": sum(c.shape[0] * c.shape[1]
                                      for c in coefs),
                        "out_bytes": h * w * 3}
            seen.append((noise, scan))
            noise = _next_noise(seen, target, h * w)
    raise ValueError(f"no photo of {lo}-{hi} entropy-coded bytes in "
                     f"{MAX_DRAWS} draws: the class misses the content")


def _next_noise(seen: list, target: float, pixels: int) -> float:
    """The next grain strength toward `target` bytes: the secant through
    the last two (noise, bytes), or from one by `BYTES_PER_NOISE`."""
    (n1, b1) = seen[-1]
    slope = BYTES_PER_NOISE * pixels
    if len(seen) > 1:
        n0, b0 = seen[-2]
        if b1 != b0 and n1 != n0:
            slope = max((b1 - b0) / (n1 - n0), slope / 8)
    return min(max(n1 + (target - b1) / slope, NOISE_MIN), NOISE_MAX)


def generate(config: dict, traffic: dict, seed: int) -> list:
    """The cell's pool of `traffic["pool"]` distinct photos (`photo`),
    made on a few threads (NumPy releases the interpreter lock)."""
    with cf.ThreadPoolExecutor(THREADS) as pool:
        return list(pool.map(lambda i: photo(config, seed, i),
                             range(traffic["pool"])))
