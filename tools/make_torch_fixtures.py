"""Write the seeded JPEG fixtures that the PyTorch port's tests and
`chip_smoke.py` decode (tests/fixtures/torch_port/).

Every image is a numpy array made from a fixed seed and encoded by PIL, so
the files can be regenerated bit for bit on the same PIL/libjpeg build:

    python tools/make_torch_fixtures.py            # rewrite the fixtures
    python tools/make_torch_fixtures.py --check    # verify they still match

The set covers the main path's shapes: one ~3.4 Mpix 4:2:0 image (the
`large_image.jpg` class), one 512x512 4:2:0 image (and the same array at
q92, a second quality variant of one geometry), and small 4:4:4, 4:2:2,
grayscale, restart-interval (DRI), subsampled CMYK and RGB-stored images
with edges that are not MCU multiples; two progressive ones, the large
image's own array and a small 4:2:2 image; and six 4:2:0 images of the
mixed sizes of an ImageNet-class data set (at most 0.25 Mpix each). One
more, `stripe_420.jpg`, is pure noise by the recipe of the JAX package's
stripe tests (`tests/test_stripe_bits.py:38-69`, case "420": random pixels
in [0, 255), seed 101, q80): its 8-stripe split starts stripes inside
chunks, which the card tests of the stripe wire need. And `q100/
q100_420.jpg`, a 4:2:0 image at quality 100, whose residuals fill the
prefix wire's zigzag slots 16-63. And `optimized/tower_420_opt.jpg`,
tower_420's array at q86 with per-image optimised Huffman tables, which
shares tower_420's graph key.

Lossless (SOF3) streams are not committed: `sof3_jpeg` writes them at run
time from seeded samples (`sof3_samples`), with numpy alone (no PIL, no
JAX), so `chip_smoke.py` can make a 2048 x 2048 16-bit one on a machine
without PIL. Nor are `requantized` variants of a fixture: images of other
content that share every compile key of the fixture, made with numpy
alone.
"""

from __future__ import annotations

import argparse
import io
import sys
from pathlib import Path

import numpy as np

OUT_DIR = (Path(__file__).resolve().parent.parent
           / "tests" / "fixtures" / "torch_port")

# name -> (width, height, mode, PIL save options, texture noise sigma, seed)
FIXTURES = {
    "large_420.jpg": (2048, 1680, "RGB", {"subsampling": 2}, 3.3, 0),
    "tower_420.jpg": (512, 512, "RGB", {"subsampling": 2}, 3.3, 1),
    # tower_420's array at q92: the same geometry, other tables and bits
    # (a second quality variant, as the multi-process harness alternates).
    "tower_420_q92.jpg": (512, 512, "RGB", {"subsampling": 2, "quality": 92},
                          3.3, 1),
    "small_444.jpg": (203, 141, "RGB", {"subsampling": 0}, 4.0, 2),
    "small_422.jpg": (237, 157, "RGB", {"subsampling": 1}, 4.0, 3),
    "small_gray.jpg": (171, 117, "L", {}, 4.0, 4),
    "small_dri.jpg": (250, 190, "RGB",
                      {"subsampling": 2, "restart_marker_rows": 1}, 4.0, 5),
    # CMYK with h2v2 on 3 of its 4 components (PIL subsamples all but the
    # first), and RGB stored as RGB (no color transform, 4:4:4).
    "small_cmyk_420.jpg": (221, 149, "CMYK", {"subsampling": 2}, 4.0, 6),
    "small_rgb_444.jpg": (189, 133, "RGB",
                          {"subsampling": 0, "keep_rgb": True}, 4.0, 7),
    # large_420's array, progressive; a small progressive 4:2:2 image.
    "large_420_progressive.jpg": (2048, 1680, "RGB",
                                  {"subsampling": 2, "progressive": True},
                                  3.3, 0),
    "small_422_progressive.jpg": (197, 131, "RGB",
                                  {"subsampling": 1, "progressive": True},
                                  4.0, 8),
    # ImageNet-class mixed sizes (at most 0.25 Mpix), 4:2:0: one encoder's
    # images, which a batch decodes in one Huffman sweep.
    **{f"mixed_{w}x{h}.jpg": (w, h, "RGB", {"subsampling": 2}, 3.3, 20 + i)
       for i, (w, h) in enumerate(((500, 375), (375, 500), (500, 333),
                                   (333, 500), (448, 448), (320, 240)))},
}
QUALITY = 85
# name -> (width, height, PIL save options, seed): random pixels, q80.
NOISE_FIXTURES = {
    "stripe_420.jpg": (648, 488, {"subsampling": 2}, 101),
}
# The textured recipe at quality 100, in a directory of its own (the tools
# that take every fixture of the directory above as a seed leave it out):
# every quantizer is 1, so residuals fill zigzag slots 16-63, the part of
# the prefix interchange's wire that the prefix rebuild (P1) scatters.
FIXTURES["q100/q100_420.jpg"] = (256, 192, "RGB",
                                 {"subsampling": 2, "quality": 100}, 4.0, 9)
# tower_420's array with Huffman tables optimised for the image (PIL
# `optimize=True`, as mozjpeg does by default), in a directory of its own:
# at quality 86 its plan, wire buckets and class shapes are tower_420's, so
# it shares tower_420's compiled-dispatch key (`models/graphs.py`) while its
# Huffman and quantisation tables differ.
FIXTURES["optimized/tower_420_opt.jpg"] = (
    512, 512, "RGB", {"subsampling": 2, "quality": 86, "optimize": True},
    3.3, 1)


def textured(h: int, w: int, channels: int, noise: float,
             seed: int) -> np.ndarray:
    """A photo-like synthetic image: low-frequency gradients, a few random
    plane waves and Gaussian grain. Pure noise would compress ~10x worse
    than a photograph; this lands near real-photo bits per pixel at q85."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, channels), np.float32)
    for c in range(channels):
        acc = 128 + 60 * (np.sin(x / w * np.pi * (1 + c))
                          * np.cos(y / h * np.pi * (2 - c * 0.5)))
        for _ in range(6):
            fx, fy = rng.uniform(-0.08, 0.08, 2)
            phase = rng.uniform(0, 2 * np.pi)
            acc += rng.uniform(5, 20) * np.sin(fx * x + fy * y + phase)
        img[..., c] = acc
    img += rng.normal(0, noise, img.shape).astype(np.float32)
    out = np.clip(img, 0, 255).astype(np.uint8)
    return out[..., 0] if channels == 1 else out


def encode(name: str) -> bytes:
    from PIL import Image

    if name in NOISE_FIXTURES:
        w, h, opts, seed = NOISE_FIXTURES[name]
        rng = np.random.default_rng(seed)
        arr = rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG", quality=80, **opts)
        return buf.getvalue()
    w, h, mode, opts, noise, seed = FIXTURES[name]
    arr = textured(h, w, {"L": 1, "CMYK": 4}.get(mode, 3), noise, seed)
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG",
                                    **{"quality": QUALITY, **opts})
    return buf.getvalue()


# Lossless DC table: code lengths by frequency rank of the 17 difference
# categories (0-16). Kraft sum 0.875 - 2^-16 < 1, so no code is all ones.
_SOF3_RANK_LENGTHS = (2, 2, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                      16)


def _predict(v: np.ndarray, predictor: int, pt: int, precision: int
             ) -> np.ndarray:
    """H.1.2.1 predictions of every stored sample `v` (int64 [H, W]) from
    its neighbours, with the reference's edge rules: (0, 0) the default,
    row 0 Ra, column 0 Rb (`ops/predictors.py::_reconstruct_scalar`)."""
    ra = np.zeros_like(v)
    rb = np.zeros_like(v)
    rc = np.zeros_like(v)
    ra[:, 1:] = v[:, :-1]
    rb[1:, :] = v[:-1, :]
    rc[1:, 1:] = v[:-1, :-1]
    interior = {0: np.zeros_like(v), 1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                7: (ra + rb) // 2}[predictor]
    pred = interior.copy()
    pred[0, :] = ra[0, :]
    pred[1:, 0] = rb[1:, 0]
    pred[0, 0] = 1 << (precision - pt - 1) if precision > 1 + pt else 0
    return pred


def _pack_bits(vals: np.ndarray, nbits: np.ndarray) -> np.ndarray:
    """MSB-first concatenation of `vals[i]` in `nbits[i]` (<= 32) bits,
    1-padded to a byte (B.1.1.5); uint8 out. In slices, to bound memory."""
    out = []
    step = 1 << 18
    for lo in range(0, len(vals), step):
        v = vals[lo:lo + step].astype(np.uint64)
        n = nbits[lo:lo + step].astype(np.int64)
        start = np.cumsum(n) - n
        sym = np.repeat(np.arange(len(n)), n)
        j = np.arange(int(n.sum())) - start[sym]
        shift = (n[sym] - 1 - j).astype(np.uint64)
        out.append(((v[sym] >> shift) & np.uint64(1)).astype(np.uint8))
    bits = np.concatenate(out) if out else np.zeros(0, np.uint8)
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.uint8)])
    return np.packbits(bits)


def sof3_samples(h: int, w: int, ncomp: int = 1, precision: int = 16,
                 pt: int = 0, seed: int = 0) -> np.ndarray:
    """Seeded photo-like samples for `sof3_jpeg`: uint16 [H, W] (one
    component) or [H, W, C], each below 2^(precision - pt): smooth
    gradients and waves with grain, the content of a radiograph."""
    peak = (1 << (precision - pt)) - 1
    arr = textured(h, w, ncomp, 4.0, seed).astype(np.float64) / 255.0
    rng = np.random.default_rng(seed + 1)
    arr = arr * peak + rng.normal(0, peak / 400.0, arr.shape)
    return np.clip(np.rint(arr), 0, peak).astype(np.uint16)


def sof3_jpeg(samples: np.ndarray, predictor: int = 1, pt: int = 0,
              precision: int = 16) -> bytes:
    """A lossless (SOF3) JPEG of `samples` (uint16 [H, W] or [H, W, C], each
    below 2^(precision - pt)), one interleaved scan with selection value
    `predictor` (0-7) and point transform `pt`: the decoder's stored
    samples are `samples << pt`. One DC table covers categories 0-16
    (SSSS 16, the difference 32768, carries no extra bits, H.1.2.2); the
    scan is byte-stuffed. Numpy only."""
    u = np.asarray(samples)
    if u.ndim == 2:
        u = u[..., None]
    h, w, ncomp = u.shape
    if not 2 <= precision <= 16 or not 0 <= pt < precision \
            or not 0 <= predictor <= 7 or int(u.max()) >> (precision - pt):
        raise ValueError("samples, precision, predictor or pt out of range")
    diffs = np.empty((h, w, ncomp), np.int64)
    for c in range(ncomp):
        v = u[..., c].astype(np.int64) << pt
        diffs[..., c] = (u[..., c].astype(np.int64)
                         - _predict(v, predictor, pt, precision)) & 0xFFFF
    d = diffs.reshape(-1)                   # pixel-major, component-minor
    signed = np.where(d >= 32768, d - 65536, d)
    cat = np.where(signed == -32768, 16,
                   np.ceil(np.log2(np.abs(signed) + 1)).astype(np.int64))
    extra = np.where(signed >= 0, signed, signed + (1 << cat) - 1)
    extra = np.where(cat == 16, 0, extra)        # in [0, 2^cat)

    counts = np.bincount(cat, minlength=17)
    order = sorted(range(17), key=lambda c: (-counts[c], c))
    length = np.zeros(17, np.int64)
    length[order] = _SOF3_RANK_LENGTHS
    huffval = sorted(range(17), key=lambda c: (length[c], c))
    bits = np.bincount(length, minlength=17)[1:]
    code = np.zeros(17, np.int64)
    nxt, prev_len = 0, length[huffval[0]]
    for c in huffval:                          # canonical codes (Annex C)
        nxt <<= int(length[c] - prev_len)
        prev_len = length[c]
        code[c] = nxt
        nxt += 1
    sym_bits = length[cat] + np.where(cat == 16, 0, cat)
    sym_vals = (code[cat] << np.where(cat == 16, 0, cat)) | extra
    scan = _pack_bits(sym_vals, sym_bits)
    scan = np.insert(scan, np.flatnonzero(scan == 0xFF) + 1, 0)   # stuffing

    def segment(marker: int, payload: bytes) -> bytes:
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
            + payload

    dht = bytes([0x00, *bits.tolist(), *huffval])
    sof = bytes([precision]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") \
        + bytes([ncomp]) + b"".join(bytes([c + 1, 0x11, 0])
                                    for c in range(ncomp))
    sos = bytes([ncomp]) + b"".join(bytes([c + 1, 0x00])
                                    for c in range(ncomp)) \
        + bytes([predictor, 0, pt])
    return (b"\xff\xd8" + segment(0xC4, dht) + segment(0xC3, sof)
            + segment(0xDA, sos) + scan.tobytes() + b"\xff\xd9")


def requantized(data: bytes, step: int) -> bytes:
    """`data` (a baseline or progressive JPEG) with `step` added to every
    entry of its quantisation tables (DQT), each kept in [1, 255] (8-bit
    tables) or [1, 65535]: the same entropy-coded coefficients, so the
    same plans, wires and compile keys on every interchange, and other
    pixels (step 0 leaves the image as it is). Numpy only."""
    out, i = bytearray(data[:2]), 2
    while i < len(data):
        if data[i] != 0xFF:
            raise ValueError(f"no marker at byte {i}")
        marker = data[i + 1]
        length = int.from_bytes(data[i + 2:i + 4], "big")
        seg = bytearray(data[i:i + 2 + length])
        if marker == 0xDB:
            j = 4
            while j < len(seg):
                wide = seg[j] >> 4
                size = 2 if wide else 1
                q = np.frombuffer(bytes(seg[j + 1:j + 1 + 64 * size]),
                                  ">u2" if wide else np.uint8)
                q = np.clip(q.astype(np.int64) + step, 1,
                            65535 if wide else 255)
                seg[j + 1:j + 1 + 64 * size] = q.astype(
                    ">u2" if wide else np.uint8).tobytes()
                j += 1 + 64 * size
        out += seg
        i += 2 + length
        if marker == 0xDA:              # the scan and all after it as is
            out += data[i:]
            break
    return bytes(out)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="compare with the files on disk instead of writing")
    args = ap.parse_args(argv)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    bad = 0
    for name in (*FIXTURES, *NOISE_FIXTURES):
        data = encode(name)
        path = OUT_DIR / name
        if args.check:
            same = path.exists() and path.read_bytes() == data
            bad += not same
            print(f"{name}: {'ok' if same else 'DIFFERS'}")
        else:
            path.parent.mkdir(exist_ok=True)
            path.write_bytes(data)
            print(f"{name}: {len(data)} bytes")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
