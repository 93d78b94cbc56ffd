"""Seeded inputs shared by the PyTorch port's tests (tests/test_torch_*.py).

Images are numpy arrays from `np.random.default_rng(seed)` encoded by PIL,
the recipes of tests/test_pallas_decode.py (`_synth_jpeg`) and
tests/test_prescan_parity.py (`_make_dri_jpeg`); the committed fixtures
come from tools/make_torch_fixtures.py. Two byte-level recipes need
neither PIL nor JAX, so `chip_smoke.py` uses them too:
`three_table_pairs` (an SOF1 edit that gives Cr its own tables) and
`quirk_jpeg` (a baseline scan the device prescan defers to the host); so
does `adversarial_blocks`, the exact IDCT's integer corners.
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


def adversarial_blocks(seed: int, n: int = 600):
    """int16 [n, 64] blocks and a 16-bit table for the exact IDCT:
    full-range values, small in-range ones, zeroed AC columns and rows,
    DC-only blocks."""
    rng = np.random.default_rng(seed)
    coef = rng.integers(-32768, 32768, (n, 64)).astype(np.int16)
    small = rng.integers(-64, 64, (n // 3, 64)).astype(np.int16)
    coef[: n // 3] = small
    grid = coef.reshape(n, 8, 8)
    grid[n // 3: n // 2, 1:, rng.integers(0, 8)] = 0      # one zero AC column
    grid[n // 2: 2 * n // 3, 1:, :] = 0                   # every column
    grid[2 * n // 3: 3 * n // 4, :, 1:] = 0               # zero AC rows
    qt = rng.integers(1, 65536, 64).astype(np.uint16)
    qt[:8] = rng.integers(1, 100, 8)
    return coef, qt


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


# K3 at odd sizes, by layout: (comp_modes, transform, chroma_dims) from
# (out_h, out_w, hc, wc) with hc, wc the halved sizes rounded up.
ODD_TAIL_LAYOUTS = {
    "420": lambda h, w, hc, wc: (("h1v1", "h2v2", "h2v2"), "ycbcr", (hc, wc)),
    "422": lambda h, w, hc, wc: (("h1v1", "h2v1", "h2v1"), "ycbcr", (h, wc)),
    "444": lambda h, w, hc, wc: (("h1v1",) * 3, "ycbcr", None),
    "ycck": lambda h, w, hc, wc: (("h1v1", "h1v2", "h1v2", "h1v1"), "ycck",
                                  (hc, w)),
    "cmyk": lambda h, w, hc, wc: (("h1v1", "h2v2", "h2v2", "h2v2"), "cmyk",
                                  (hc, wc)),
}


def odd_tail_case(layout: str, out_h: int, out_w: int, offset: int, rng,
                  device) -> tuple:
    """The arguments of `fused_tail` for one ODD_TAIL_LAYOUTS layout at one
    size: seeded uint8 planes on `device`, a row taller than needed, whose
    pitch is 8 mod 16 (offset 0; block padding promises 8, not 16), or
    16 mod 16 with the data starting 8 bytes into its buffer (offset 8)."""
    import torch

    modes, transform, chroma = ODD_TAIL_LAYOUTS[layout](
        out_h, out_w, -(-out_h // 2), -(-out_w // 2))
    planes = []
    for m in modes:
        rows = (out_h if m == "h1v1" else chroma[0]) + 1
        cols = chroma[1] if m.startswith("h2") else out_w
        cols = -(-cols // 16) * 16 + 8 - offset
        buf = torch.from_numpy(rng.integers(
            0, 256, rows * cols + offset).astype(np.uint8)).to(device)
        planes.append(buf[offset:].view(rows, cols))
    return planes, modes, chroma, transform, out_h, out_w


def _segments(data: bytes):
    """(marker, payload start, payload end) of each marker segment from
    SOI up to and including the first SOS."""
    pos = 2
    while True:
        if data[pos] != 0xFF:
            raise ValueError(f"no marker at byte {pos}")
        marker = data[pos + 1]
        end = pos + 2 + int.from_bytes(data[pos + 2:pos + 4], "big")
        yield marker, pos + 4, end
        if marker == 0xDA:
            return
        pos = end


def three_table_pairs(data: bytes) -> bytes:
    """A 3-component baseline JPEG re-signalled so that its scan holds 3
    distinct (DC, AC) table pairs (6 table rows), the image unchanged:
    SOF0 becomes SOF1 (extended sequential allows 4 tables per class), a
    DHT adds copies of DC table 1 and AC table 1 as table 2, and the Cr
    selector byte of the SOS becomes 0x22. Encoders that give Cr its own
    tables write such scans."""
    tables = {}
    out = bytearray(data[:2])
    for marker, lo, hi in _segments(data):
        seg = bytearray(data[lo - 4:hi])
        if marker == 0xC4:
            i = lo
            while i < hi:
                n = sum(data[i + 1:i + 17])
                tables[data[i]] = data[i:i + 17 + n]
                i += 17 + n
        elif marker == 0xC0:
            seg[1] = 0xC1
        elif marker == 0xDA:
            if seg[4] != 3:
                raise ValueError("the recipe needs a 3-component scan")
            copies = b"".join(bytes([cls << 4 | 2]) + tables[cls << 4 | 1][1:]
                              for cls in (0, 1))
            out += b"\xff\xc4" + (len(copies) + 2).to_bytes(2, "big") + copies
            seg[4 + 1 + 2 * 2 + 1] = 0x22      # third component: Td 2, Ta 2
            out += seg + data[hi:]
            return bytes(out)
        out += seg
    raise ValueError("no SOS")


def quirk_jpeg(seed: int = 0) -> bytes:
    """A 40x24 grayscale baseline JPEG that the host decodes and the device
    prescan defers (PrescanFallback), so the bits path host-decodes and
    transcodes it: some blocks end with an AC run past coefficient 63
    (the reference stops the block there, reading no magnitude bits), and
    one uses an EOB run (EOB1) in a sequential scan, which skips the AC
    coefficients of the next block. Fixed-length codes: 4 bits for the 12
    DC categories, 8 bits for 176 AC symbols."""
    w, h = 40, 24
    rng = np.random.default_rng(seed)
    ac_syms = ([0x00, 0xF0] + [r << 4 | s for r in range(16)
                               for s in range(1, 11)]
               + [r << 4 for r in range(1, 15)])
    ac_code = {sym: i for i, sym in enumerate(ac_syms)}
    bits: list = []

    def put(value: int, n: int) -> None:
        bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))

    def put_value(v: int, cat: int) -> None:
        put(v if v >= 0 else v + (1 << cat) - 1, cat)

    pred = 0
    skip_ac = False
    for b in range((w // 8) * (h // 8)):
        dc = int(rng.integers(-60, 60))
        diff, pred = dc - pred, dc
        cat = abs(diff).bit_length()
        put(cat, 4)
        put_value(diff, cat)
        if skip_ac:                 # inside the EOB run: no AC symbols
            skip_ac = False
            continue
        k = 1
        positions = sorted(rng.choice(np.arange(1, 40), 4, replace=False))
        if b % 3 == 0:              # a last one late enough to overshoot
            positions.append(int(rng.integers(48, 63)))
        for pos in positions:
            run = int(pos) - k
            while run >= 16:
                put(ac_code[0xF0], 8)
                run -= 16
            v = int(rng.integers(1, 300)) * int(rng.choice([-1, 1]))
            size = abs(v).bit_length()
            put(ac_code[run << 4 | size], 8)
            put_value(v, size)
            k = int(pos) + 1
        if b % 3 == 0:
            put(ac_code[15 << 4 | 3], 8)   # k + 15 > 63: the block ends
        elif b == 4:
            put(ac_code[0x10], 8)          # EOB1, run bit 0: one more block
            put(0, 1)
            skip_ac = True
        else:
            put(ac_code[0x00], 8)          # EOB
    bits.extend([1] * (-len(bits) % 8))
    scan = np.packbits(np.asarray(bits, np.uint8))
    scan = np.insert(scan, np.flatnonzero(scan == 0xFF) + 1, 0)

    def segment(marker: int, payload: bytes) -> bytes:
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
            + payload

    dqt = bytes([0]) + bytes(rng.integers(1, 20, 64).tolist())
    dc_dht = bytes([0x00] + [0, 0, 0, 12] + [0] * 12 + list(range(12)))
    ac_dht = bytes([0x10] + [0] * 7 + [len(ac_syms)] + [0] * 8 + ac_syms)
    sof = bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big") \
        + bytes([1, 1, 0x11, 0])
    sos = bytes([1, 1, 0x00, 0, 63, 0])
    return (b"\xff\xd8" + segment(0xDB, dqt) + segment(0xC4, dc_dht)
            + segment(0xC4, ac_dht) + segment(0xC0, sof)
            + segment(0xDA, sos) + scan.tobytes() + b"\xff\xd9")


def stripe_jpeg(h: int, w: int, mode: str = "RGB", seed: int = 0,
                **save_kw) -> bytes:
    """The recipe of tests/test_stripe_bits.py (`_jpeg`): random pixels in
    [0, 255), PIL quality 80, `save_kw` passed to PIL (subsampling,
    restart_marker_blocks)."""
    from PIL import Image

    rng = np.random.default_rng(seed)
    if mode == "L":
        im = Image.fromarray(rng.integers(0, 255, (h, w)).astype(np.uint8),
                             "L")
    else:
        im = Image.fromarray(rng.integers(0, 255, (h, w, 3))
                             .astype(np.uint8))
    buf = io.BytesIO()
    im.save(buf, format="JPEG", quality=80, **save_kw)
    return buf.getvalue()


# The reference's stripe cases (tests/test_stripe_bits.py:55-69), plus one
# whose last stripes hold no chunk (9 MCU rows over 8 stripes of 2):
# (name, seed, h, w, mode, n_stripes, save_kw).
STRIPE_CASES = [
    ("420", 101, 488, 648, "RGB", 8, dict(subsampling=2)),
    ("444", 102, 333, 500, "RGB", 8, dict(subsampling=0)),
    ("422", 103, 256, 256, "RGB", 8, dict(subsampling=1)),
    ("gray", 104, 300, 400, "L", 8, {}),
    ("420-dri-aligned", 105, 512, 512, "RGB", 4,
     dict(subsampling=2, restart_marker_blocks=4)),
    ("420-dri-one-seg-per-stripe", 106, 512, 512, "RGB", 4,
     dict(subsampling=2, restart_marker_blocks=256)),
    ("444-small", 107, 64, 64, "RGB", 8, dict(subsampling=0)),
    ("420-mesh4-odd", 108, 100, 90, "RGB", 4, dict(subsampling=2)),
    ("444-empty-stripes", 109, 72, 64, "RGB", 8, dict(subsampling=0)),
]


def stripe_case(name: str) -> tuple:
    """(jpeg bytes, n_stripes) of one STRIPE_CASES entry."""
    _name, seed, h, w, mode, n, kw = next(c for c in STRIPE_CASES
                                          if c[0] == name)
    return stripe_jpeg(h, w, mode, seed, **kw), n


# T1 (the interleaved tail): sampling factors (h, v) per component. The
# upsampler modes follow from them (`choose_upsampler`): 444 h1v1, 422
# h2v1, 440 h1v2, 420 h2v2, the g* layouts generic at h_scale x v_scale
# 3x1, 1x4, 2x3, 4x4 and 4x2; mixed4 takes h1v1, h2v2, h1v2 and h2v1 in
# one image, generic4 h1v1, generic 4x4, h2v2 and generic 1x4; gray is one
# component (the crop, whatever its factors).
T1_LAYOUTS = {
    "444": ((1, 1), (1, 1), (1, 1)),
    "422": ((2, 1), (1, 1), (1, 1)),
    "440": ((1, 2), (1, 1), (1, 1)),
    "420": ((2, 2), (1, 1), (1, 1)),
    "g31": ((3, 1), (1, 1), (1, 1)),
    "g14": ((1, 4), (1, 1), (1, 1)),
    "g23": ((2, 3), (1, 1), (1, 1)),
    "g44": ((4, 4), (1, 1), (1, 1)),
    "g42": ((4, 2), (1, 1), (1, 1)),
    "mixed4": ((2, 2), (1, 1), (2, 1), (1, 2)),
    "generic4": ((4, 4), (1, 1), (2, 2), (4, 1)),
    "gray": ((1, 1),),
    "gray22": ((2, 2),),
}
_T1_TRANSFORMS = {1: (None,), 3: ("NONE", "RGB", "YCBCR"),
                  4: ("NONE", "CMYK", "YCCK")}
_T1_SIZES = ((37, 53), (17, 23), (29, 61), (45, 31), (23, 9), (13, 40))


def _t1_cases() -> list:
    """(layout, transform name or None, height, width, scale, images):
    every layout with every transform its component count takes, the
    scale, size and image count cycling; then the edges: width-1 and
    height-1 chroma, outputs of one row or column, odd sizes, scale 1."""
    cases = []
    for layout, factors in T1_LAYOUTS.items():
        for t in _T1_TRANSFORMS[len(factors)]:
            k = len(cases)
            h, w = _T1_SIZES[k % len(_T1_SIZES)]
            cases.append((layout, t, h, w, (8, 4, 2, 1)[k % 4],
                          (1, 3)[k % 2]))
    cases += [
        ("420", "YCBCR", 2, 2, 8, 3), ("420", "YCBCR", 1, 1, 8, 1),
        ("420", "YCBCR", 2, 1, 8, 1), ("420", "YCBCR", 1, 2, 8, 3),
        ("420", "YCBCR", 3, 3, 8, 1), ("420", "YCBCR", 9, 9, 1, 3),
        ("420", "RGB", 17, 15, 2, 1), ("422", "YCBCR", 1, 2, 8, 1),
        ("422", "YCBCR", 5, 1, 8, 3), ("440", "YCBCR", 2, 1, 8, 1),
        ("440", "YCBCR", 2, 5, 8, 3), ("440", "YCBCR", 9, 7, 4, 1),
        ("mixed4", "YCCK", 3, 3, 8, 1), ("mixed4", "CMYK", 19, 33, 1, 3),
        ("g44", "YCBCR", 5, 5, 8, 1), ("g14", "RGB", 3, 1, 8, 3),
        ("generic4", "YCCK", 7, 9, 2, 1), ("gray", None, 1, 1, 8, 1),
        ("gray22", None, 21, 3, 4, 3),
    ]
    # The kernel's tiles (16 rows x 128 columns, 16-pixel runs): widths one
    # below, at and one above the run and the tile, heights across a tile,
    # the last tile's one chroma column (258 wide: chroma 129), scales 1
    # and 2 (image strides not 16-byte aligned), groups of 3.
    cases += [
        ("420", "YCBCR", 16, 15, 8, 3), ("420", "YCBCR", 17, 16, 8, 1),
        ("420", "YCBCR", 15, 17, 8, 3), ("420", "YCBCR", 31, 127, 8, 1),
        ("420", "YCBCR", 16, 128, 8, 3), ("420", "YCBCR", 33, 129, 8, 1),
        ("422", "YCBCR", 17, 129, 8, 3), ("444", "YCBCR", 15, 128, 8, 1),
        ("gray", None, 33, 127, 8, 3), ("420", "YCBCR", 9, 258, 8, 1),
        ("440", "YCBCR", 31, 257, 8, 3), ("420", "YCBCR", 37, 75, 1, 3),
        ("444", "RGB", 31, 45, 2, 3), ("mixed4", "YCCK", 33, 130, 4, 1),
    ]
    return cases


T1_CASES = _t1_cases()


def t1_geometry(layout: str, height: int, width: int, scale: int = 8,
                transform=None, precision: str = "exact"):
    """The `ImageGeometry` a frame of T1_LAYOUTS[layout] at height x width
    decoded at IDCT scale `scale` gets (the parser's sizes and block grid,
    then `geometry_from_frame`); `transform` a name of the port's
    `ColorTransform`, or None for the gray crop."""
    from types import SimpleNamespace

    from jpeg_decoder_tpu_torch.host.ops.color import ColorTransform
    from jpeg_decoder_tpu_torch.host.ops.pipeline import geometry_from_frame
    from jpeg_decoder_tpu_torch.host.parser import (Dimensions,
                                                    update_component_sizes)

    comps = [SimpleNamespace(horizontal_sampling_factor=h,
                             vertical_sampling_factor=v, dct_scale=scale)
             for h, v in T1_LAYOUTS[layout]]
    update_component_sizes(Dimensions(width, height), comps)
    frame = SimpleNamespace(components=comps, output_size=Dimensions(
        -(-width * scale // 8), -(-height * scale // 8)))
    return geometry_from_frame(
        frame, None if transform is None else ColorTransform[transform],
        precision)


def t1_args(geometry) -> tuple:
    """`interleaved_tail`'s (comps, transform, out_h, out_w) for a whole
    image of `geometry`: the gray crop takes the component's size."""
    out_h, out_w = geometry.out_height, geometry.out_width
    if geometry.transform is None:
        comp = geometry.components[0]
        out_h, out_w = comp.size_height, comp.size_width
    return geometry.components, geometry.transform, out_h, out_w


def t1_pixels(geometry, images: int, seed: int, device="cpu") -> list:
    """Seeded uint8 block pixels [images, n_c, s, s] per component of
    `geometry`, on `device`."""
    import torch

    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.integers(
        0, 256, (images, c.blocks_wide * c.blocks_high, c.dct_scale,
                 c.dct_scale), dtype=np.uint8)).to(device)
        for c in geometry.components]


# A1 (the assembly): plans of the fields the assembly reads, for what the
# fixtures never give it: block grids padded past the decoded MCUs,
# restart segments that cross the kernel's 256-block tiles, sequences of
# more than 32 tiles (more than one look-back window), tile-edge counts,
# four components, and general maps that no closed form describes.
class A1Plan:
    """A ScanPlan's assembly fields (`n_blocks`, `ncomp`,
    `restart_interval`, `stream_idx`, `raster_src`, `seg_first`,
    `structured`) for components `comps` [(vs, hs, extra rows, extra
    columns)] of an interleaved scan over a rows_d x cols_d MCU grid, each
    store padded by its extra block rows and columns, built as
    `ScanPlan._derive_structured` reads them. `general` drops the closed
    form; `scramble` (a seed) instead makes general maps no closed form
    has: each component's stream blocks in a seeded order, restart
    segments of seeded lengths, a seeded raster placement with padding, and
    one raster block that two stream blocks claim (raster_src keeps the
    later one)."""

    def __init__(self, comps, rows_d: int, cols_d: int,
                 restart_interval: int = 0, general: bool = False,
                 scramble=None):
        plen = sum(vs * hs for vs, hs, _r, _c in comps)
        n_mcus = rows_d * cols_d
        self.n_blocks = n_mcus * plen
        self.ncomp = len(comps)
        self.restart_interval = restart_interval
        self.stream_idx, self.raster_src, self.seg_first = [], [], []
        specs, slot0 = [], 0
        rng = np.random.default_rng(scramble)
        for vs, hs, extra_r, extra_c in comps:
            bpm = vs * hs
            n_c = n_mcus * bpm
            hc, wc = rows_d * vs + extra_r, cols_d * hs + extra_c
            s_idx = (np.arange(n_mcus)[:, None] * plen + slot0
                     + np.arange(bpm)[None, :]).reshape(-1)
            pos = np.arange(n_c).reshape(rows_d, cols_d, vs, hs).transpose(
                0, 2, 1, 3)
            grid = np.full((hc, wc), n_c, np.int64)
            grid[:rows_d * vs, :cols_d * hs] = pos.reshape(rows_d * vs,
                                                           cols_d * hs)
            seg_blocks = restart_interval * bpm
            first = (np.arange(n_c) // seg_blocks * seg_blocks
                     if seg_blocks else np.zeros(n_c, np.int64))
            if scramble is not None:
                s_idx = rng.permutation(s_idx)
                cuts = np.flatnonzero(rng.random(n_c) < 0.004) \
                    if restart_interval else np.zeros(0, np.int64)
                starts = np.union1d([0], cuts)
                first = starts[np.searchsorted(starts, np.arange(n_c),
                                               side="right") - 1]
                raster = rng.permutation(hc * wc)[:n_c]
                raster[-1] = raster[0]          # two claim one block
                grid = np.full(hc * wc, n_c, np.int64)
                grid[raster] = np.arange(n_c)
            self.stream_idx.append(s_idx.astype(np.int32))
            self.raster_src.append(grid.reshape(-1))
            self.seg_first.append(first.astype(np.int64))
            specs.append((slot0, bpm, vs, hs, hc, wc, seg_blocks))
            slot0 += bpm
        self.structured = None if general or scramble is not None else (
            (n_mcus, rows_d, cols_d, plen), tuple(specs))
        self._key = (tuple(comps), rows_d, cols_d, restart_interval,
                     general, scramble)

    def __hash__(self):
        return hash(self._key)

    def __eq__(self, other):
        return isinstance(other, A1Plan) and self._key == other._key


# (label, comps, rows_d, cols_d, restart interval, images, carry?,
# branch: "structured", "general" (the same maps without the closed form)
# or a scramble seed).
A1_CASES = [
    ("420-padded", ((2, 2, 2, 3), (1, 1, 1, 2), (1, 1, 1, 2)), 5, 7, 0, 2,
     True, "structured"),
    ("420-padded-general", ((2, 2, 2, 3), (1, 1, 1, 2), (1, 1, 1, 2)), 5, 7,
     0, 2, True, "general"),
    ("422-dri5-padded", ((1, 2, 1, 1), (1, 1, 0, 1), (1, 1, 0, 1)), 9, 11, 5,
     3, True, "structured"),
    ("cmyk4-padded", ((2, 2, 1, 0), (1, 1, 0, 1), (1, 1, 1, 1),
                      (2, 2, 0, 2)), 6, 5, 0, 1, True, "structured"),
    ("gray-dri7-36-tiles", ((1, 1, 0, 0),), 100, 90, 7, 1, True,
     "structured"),
    ("gray-carry-36-tiles", ((1, 1, 3, 2),), 100, 90, 0, 3, True,
     "structured"),
    ("gray-256", ((1, 1, 0, 0),), 16, 16, 0, 2, True, "structured"),
    ("gray-257", ((1, 1, 0, 0),), 1, 257, 0, 1, True, "structured"),
    ("gray-255-dri255", ((1, 1, 1, 0),), 15, 17, 255, 2, True, "general"),
    ("420-dri3-general", ((2, 2, 1, 1), (1, 1, 0, 0), (1, 1, 0, 0)), 8, 9, 3,
     2, True, "general"),
    ("scrambled", ((2, 1, 1, 2), (1, 1, 2, 1), (1, 1, 0, 3)), 12, 13, 0, 2,
     True, 5),
    ("scrambled-dri", ((1, 1, 2, 2), (1, 1, 0, 0)), 40, 30, 4, 2, False, 6),
]


def a1_case(case) -> tuple:
    """(plan, nat int16 [images, n_blocks, 64] with full-range values,
    carry int64 [ncomp, images] with high bits set, or None) of one
    A1_CASES entry, from numpy's seeded generator."""
    label, comps, rows_d, cols_d, ri, images, with_carry, branch = case
    plan = A1Plan(comps, rows_d, cols_d, ri, general=branch == "general",
                  scramble=branch if isinstance(branch, int) else None)
    rng = np.random.default_rng(len(label) * 131 + images)
    nat = rng.integers(-32768, 32768, (images, plan.n_blocks, 64),
                       dtype=np.int16)
    carry = rng.integers(-2 ** 62, 2 ** 62, (len(comps), images),
                         dtype=np.int64) if with_carry else None
    return plan, nat, carry


# P1 (the prefix rebuild) on seeded wires: (images, blocks an image,
# residual entries), around its 256-block tiles.
P1_SHAPES = [(1, 1, 0), (1, 1, 40), (1, 255, 300), (1, 256, 300),
             (1, 257, 1000), (2, 300, 5000), (3, 513, 2048)]


def p1_case(images: int, blocks: int, entries: int, seed: int) -> tuple:
    """Seeded inputs of the prefix rebuild (P1), numpy (dc, ac, resid_idx,
    resid_vals): every DC and AC value, residual indices over
    [-total - 70, total + 70) (negative ones inside and below the range,
    the staging's sink `total`, indices past it), every fifth entry on one
    index (duplicates whose sum wraps), both halves of one word."""
    rng = np.random.default_rng(seed)
    total = images * blocks * 64
    dc = rng.integers(-32768, 32768, (images, blocks), dtype=np.int16)
    ac = rng.integers(-128, 128, (images, blocks, 15), dtype=np.int8)
    idx = rng.integers(-total - 70, total + 70, entries).astype(np.int32)
    vals = rng.integers(-32768, 32768, entries, dtype=np.int16)
    if entries >= 10:
        idx[::5] = idx[1]
        idx[2], idx[3], idx[4] = total, total - 1, total - 2
        idx[6], idx[7] = -1, -total
    return dc, ac, idx, vals


def whole_geometry(blocks: int):
    """A geometry of one component of `blocks` blocks: the prefix rebuild's
    stores of seeded wires as one [images, blocks, 64] tensor."""
    comp = type("Component", (), {"blocks_high": 1, "blocks_wide": blocks})
    return type("Geometry", (), {"components": (comp,)})
