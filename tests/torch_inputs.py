"""Seeded inputs shared by the PyTorch port's tests (tests/test_torch_*.py).

Images are numpy arrays from `np.random.default_rng(seed)` encoded by PIL,
the recipes of tests/test_pallas_decode.py (`_synth_jpeg`) and
tests/test_prescan_parity.py (`_make_dri_jpeg`); the committed fixtures
come from tools/make_torch_fixtures.py.
"""

from __future__ import annotations

import io
from pathlib import Path

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parent / "fixtures" / "torch_port"
SMALL_FIXTURES = ("small_444.jpg", "small_422.jpg", "small_gray.jpg",
                  "small_dri.jpg", "small_cmyk_420.jpg", "small_rgb_444.jpg")


def synth_jpeg(w: int, h: int, seed: int = 0, mode: str = "RGB",
               subsampling: int = 2, quality: int = 85,
               restart_rows: int = 0, progressive: bool = False) -> bytes:
    """Random-pixel JPEG; subsampling 0/1/2 = 4:4:4/4:2:2/4:2:0."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    shape = (h, w, 3) if mode == "RGB" else (h, w)
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    opts = {"quality": quality}
    if mode == "RGB":
        opts["subsampling"] = subsampling
    if restart_rows:
        opts["restart_marker_rows"] = restart_rows
    if progressive:
        opts["progressive"] = True
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "JPEG", **opts)
    return buf.getvalue()


# name -> (width, height, mode, subsampling, restart rows, seed)
ENTROPY_CASES = {
    "444": (48, 40, "RGB", 0, 0, 11),
    "422": (56, 40, "RGB", 1, 0, 12),
    "420": (72, 56, "RGB", 2, 0, 13),
    "gray": (64, 48, "L", 0, 0, 14),
    "dri420": (80, 64, "RGB", 2, 1, 15),
    "dri_gray": (64, 40, "L", 0, 2, 16),
}


def entropy_case(name: str) -> bytes:
    w, h, mode, sub, rows, seed = ENTROPY_CASES[name]
    return synth_jpeg(w, h, seed, mode, sub, restart_rows=rows)


def fixture(name: str) -> bytes:
    return (FIXTURE_DIR / name).read_bytes()


def oracle_stores(data: bytes) -> list:
    """Host oracle coefficient stores, flat int16 per frame component."""
    from jpeg_decoder_tpu import Decoder

    d = Decoder(data, backend="numpy")
    d._decode_entropy_only()
    return [d._pending_render[i][0].reshape(-1)
            for i in range(len(d.frame.components))]


# K3 (fused upsample + color) geometries beyond the fixtures':
# name -> (comp_modes, transform, out_h, out_w, chroma_dims).
TAIL_CASES = {
    "420_odd": (("h1v1", "h2v2", "h2v2"), "ycbcr", 101, 167, (51, 84)),
    "420_even": (("h1v1", "h2v2", "h2v2"), "ycbcr", 100, 166, (50, 83)),
    "422": (("h1v1", "h2v1", "h2v1"), "ycbcr", 57, 90, (57, 45)),
    "440_h1v2": (("h1v1", "h1v2", "h1v2"), "ycbcr", 90, 130, (45, 130)),
    "444": (("h1v1",) * 3, "ycbcr", 41, 67, None),
    "ycck_420": (("h1v1", "h2v2", "h2v2", "h1v1"), "ycck", 63, 77,
                 (32, 39)),
    "ycck_h1v2": (("h1v1", "h1v2", "h1v2", "h1v1"), "ycck", 31, 45,
                  (16, 45)),
    "cmyk_444": (("h1v1",) * 4, "cmyk", 35, 53, None),
    "cmyk_h2v2_on_3": (("h1v1", "h2v2", "h2v2", "h2v2"), "cmyk", 75, 111,
                       (38, 56)),
    "width1_h2v2": (("h1v1", "h2v2", "h2v2"), "ycbcr", 9, 2, (5, 1)),
    "width1_h2v1": (("h1v1", "h2v1", "h2v1"), "ycbcr", 7, 1, (7, 1)),
    "height1_h2v2": (("h1v1", "h2v2", "h2v2"), "ycbcr", 1, 13, (1, 7)),
}


def tail_planes(name: str, seed: int = 0) -> list:
    """Seeded uint8 planes for TAIL_CASES[name], block-padded (rows and
    columns rounded up to 8, plus 8 spare rows) like the IDCT's."""
    modes, _transform, out_h, out_w, chroma = TAIL_CASES[name]
    hc, wc = chroma if chroma is not None else (out_h, out_w)
    rng = np.random.default_rng(seed)
    planes = []
    for m in modes:
        h = out_h if m == "h1v1" else hc
        w = wc if m.startswith("h2") else out_w
        planes.append(rng.integers(0, 256, (-(-h // 8) * 8 + 8,
                                            -(-w // 8) * 8)).astype(np.uint8))
    return planes
