#!/usr/bin/env python
"""jpg -> png converter CLI on the PyTorch port, the counterpart of
examples/decode.py: prints ImageInfo and metadata presence, converts CMYK
to RGB for viewing, narrows 16-bit gray to 8 bits, writes a PNG.

Usage: python examples/decode_torch.py input.jpg [output.png]
       [--backend torch|numpy|auto] [--device cuda|cpu]
       [--precision exact|fast] [--scale WxH] [--streaming]

--backend torch (the default) reconstructs on --device (default "cuda",
the card; a CUDA device where there is none raises), numpy on the host,
auto by the reference's 128 x 128 rule. --streaming decodes from the file
handle with bounded buffering instead of loading the input up front. The
PNG (8-bit gray or RGB, filter 0) is written with zlib and numpy alone.
"""

import argparse
import struct
import sys
import zlib

import numpy as np

sys.path.insert(0, __file__.rsplit("/", 2)[0])

from jpeg_decoder_tpu_torch import Decoder, PixelFormat  # noqa: E402

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def cmyk_to_rgb(px: np.ndarray) -> np.ndarray:
    f = px.astype(np.float32) / 255.0
    c, m, y, k = f[..., 0], f[..., 1], f[..., 2], f[..., 3]
    c = c * (1 - k) + k
    m = m * (1 - k) + k
    y = y * (1 - k) + k
    return (np.stack([(1 - c), (1 - m), (1 - y)], axis=-1) * 255).astype(np.uint8)


def viewable(pixels: np.ndarray, pixel_format) -> np.ndarray:
    """8-bit gray or RGB for the PNG: CMYK through `cmyk_to_rgb`, L16 by
    its high byte (examples/decode.py:62-65)."""
    if pixel_format == PixelFormat.CMYK32:
        return cmyk_to_rgb(pixels)
    if pixel_format == PixelFormat.L16:
        return (pixels >> 8).astype(np.uint8)
    return pixels


def png_bytes(pixels: np.ndarray) -> bytes:
    """A PNG of uint8 [H, W] (gray) or [H, W, 3] (RGB), every row filter 0
    (None)."""
    if pixels.dtype != np.uint8 or not (
            pixels.ndim == 2 or (pixels.ndim == 3 and pixels.shape[2] == 3)):
        raise ValueError(f"PNG wants uint8 [H, W] or [H, W, 3], got "
                         f"{pixels.dtype} {pixels.shape}")
    h, w = pixels.shape[:2]
    rows = np.zeros((h, 1 + pixels[0].size), np.uint8)   # filter byte 0
    rows[:, 1:] = pixels.reshape(h, -1)

    def chunk(tag: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + tag + body
                + struct.pack(">I", zlib.crc32(tag + body)))

    color = 0 if pixels.ndim == 2 else 2
    return (PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def read_png(blob: bytes) -> np.ndarray:
    """The pixels of a PNG that `png_bytes` wrote (8-bit gray or RGB, filter
    0 on every row)."""
    if blob[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(blob):
        n, tag = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + n]
        if zlib.crc32(tag + body) != struct.unpack(
                ">I", blob[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"bad CRC in {tag!r}")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = header[:4]
    ch = {0: 1, 2: 3}[color]
    if depth != 8:
        raise ValueError(f"bit depth {depth}")
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, -1)
    if rows[:, 0].any():
        raise ValueError("a row uses a filter other than 0")
    px = rows[:, 1:].reshape(h, w, ch)
    return px[..., 0] if ch == 1 else px


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output", nargs="?", default=None)
    ap.add_argument("--backend", default="torch",
                    choices=["torch", "numpy", "auto"])
    ap.add_argument("--device", default="cuda",
                    help="torch device of the torch/auto backends")
    ap.add_argument("--precision", default="exact", choices=["exact", "fast"])
    ap.add_argument("--scale", default=None, help="WxH requested size (1/8..1 IDCT scaling)")
    ap.add_argument("--streaming", action="store_true",
                    help="bounded-memory decode straight off the file handle")
    args = ap.parse_args(argv)

    kw = dict(backend=args.backend, precision=args.precision,
              device=args.device)
    with open(args.input, "rb") as f:
        if args.streaming:
            decoder = Decoder(f, streaming=True, **kw)
        else:
            decoder = Decoder(f.read(), **kw)
        if args.scale:
            w, h = map(int, args.scale.lower().split("x"))
            print("scaled to:", decoder.scale(w, h))
        pixels = decoder.decode_array()
    info = decoder.info()
    print(f"{info.width}x{info.height} {info.pixel_format.value} "
          f"{info.coding_process.value}")
    print("exif:", decoder.exif_data() is not None,
          " xmp:", decoder.xmp_data() is not None,
          " icc:", decoder.icc_profile() is not None)

    out = args.output or (args.input.rsplit(".", 1)[0] + ".png")
    with open(out, "wb") as f:
        f.write(png_bytes(viewable(pixels, info.pixel_format)))
    print("wrote", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
