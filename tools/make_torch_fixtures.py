"""Write the seeded JPEG fixtures that the PyTorch port's tests and
`chip_smoke.py` decode (tests/fixtures/torch_port/).

Every image is a numpy array made from a fixed seed and encoded by PIL, so
the files can be regenerated bit for bit on the same PIL/libjpeg build:

    python tools/make_torch_fixtures.py            # rewrite the fixtures
    python tools/make_torch_fixtures.py --check    # verify they still match

The set covers the main path's shapes: one ~3.4 Mpix 4:2:0 image (the
`large_image.jpg` class), one 512x512 4:2:0 image, and small 4:4:4, 4:2:2,
grayscale, restart-interval (DRI), subsampled CMYK and RGB-stored images
with edges that are not MCU multiples.
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
}
QUALITY = 85


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

    w, h, mode, opts, noise, seed = FIXTURES[name]
    arr = textured(h, w, {"L": 1, "CMYK": 4}.get(mode, 3), noise, seed)
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", quality=QUALITY, **opts)
    return buf.getvalue()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--check", action="store_true",
                    help="compare with the files on disk instead of writing")
    args = ap.parse_args(argv)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    bad = 0
    for name in FIXTURES:
        data = encode(name)
        path = OUT_DIR / name
        if args.check:
            same = path.exists() and path.read_bytes() == data
            bad += not same
            print(f"{name}: {'ok' if same else 'DIFFERS'}")
        else:
            path.write_bytes(data)
            print(f"{name}: {len(data)} bytes")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
