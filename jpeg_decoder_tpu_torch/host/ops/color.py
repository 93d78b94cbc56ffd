"""Copy of `jpeg_decoder_tpu/ops/color.py` at commit 0c2d0ea.

Color-space conversion, bit-exact BT.601 fixed point, vectorized per image.

Parity with the reference's line converters (`src/decoder.rs:
1339-1508`): the same x2^20 libjpeg-turbo constants and rounding, applied to
whole [H, W] channel planes at once instead of row-by-row function pointers.
Transform-validity rules (which (component count, transform) pairs are legal)
mirror `choose_color_convert_func`.
"""

from __future__ import annotations

import enum

import numpy as np

from ..errors import FormatError, UnsupportedError, UnsupportedFeature


class ColorTransform(enum.Enum):
    """Requested/inferred color pipeline (`src/decoder.rs:77-98`)."""

    NONE = "None"
    UNKNOWN = "Unknown"
    GRAYSCALE = "Grayscale"
    RGB = "RGB"
    YCBCR = "YCbCr"
    CMYK = "CMYK"
    YCCK = "YCCK"
    JCS_BG_YCC = "JcsBgYcc"
    JCS_BG_RGB = "JcsBgRgb"


_FIXED = 20
_HALF = (1 << _FIXED) // 2


def _f2f20(x: float) -> int:
    """trunc(f32(x) * 2^20 + 0.5) matching `src/decoder.rs:1502-1504`."""
    return int(np.float32(np.float32(x) * np.float32(1 << _FIXED)) + np.float32(0.5))


_C1_402 = _f2f20(1.40200)
_C0_344 = _f2f20(0.34414)
_C0_714 = _f2f20(0.71414)
_C1_772 = _f2f20(1.77200)


def ycbcr_to_rgb(y, cb, cr, xp=np):
    """BT.601 YCbCr -> RGB (`src/decoder.rs:1489-1508`).

    Inputs are uint8 arrays of identical shape; returns (r, g, b) uint8.
    """
    y = y.astype(xp.int32) * (1 << _FIXED) + _HALF
    cb = cb.astype(xp.int32) - 128
    cr = cr.astype(xp.int32) - 128

    r = y + _C1_402 * cr
    g = y - _C0_344 * cb - _C0_714 * cr
    b = y + _C1_772 * cb

    def clamp(v):
        return xp.clip(v >> _FIXED, 0, 255).astype(xp.uint8)

    return clamp(r), clamp(g), clamp(b)


def validate_transform(component_count: int, transform: ColorTransform) -> None:
    """The (component count, transform) legality table from
    `src/decoder.rs:1339-1389`. Raises on invalid pairs."""
    if component_count not in (3, 4):
        raise FormatError(f"invalid component count {component_count} for color conversion")
    if transform in (ColorTransform.JCS_BG_YCC, ColorTransform.JCS_BG_RGB):
        raise UnsupportedError(UnsupportedFeature.COLOR_TRANSFORM, transform.value)
    if transform == ColorTransform.UNKNOWN:
        raise FormatError("Unknown colour transform")
    if transform == ColorTransform.NONE:
        return
    valid = {
        3: (ColorTransform.RGB, ColorTransform.YCBCR),
        4: (ColorTransform.CMYK, ColorTransform.YCCK),
    }
    if transform not in valid[component_count]:
        raise FormatError(
            f"Invalid number of channels ({component_count}) for {transform.value} data")


def color_convert_image(channels: list, transform: ColorTransform, xp=np):
    """Convert upsampled channel planes ([H, W] uint8 each) to interleaved output.

    Returns uint8 [H, W, C_out]. Parity with the reference line converters:
    - RGB: interleave as-is (`src/decoder.rs:1391-1404`)
    - YCbCr: BT.601 (`:1406-1437`)
    - CMYK: inverted Adobe (`:1458-1474`)
    - YCCK: YCbCr on CMY + inverted K (`:1439-1456`)
    - NONE: raw interleave (`:1476-1484`)
    """
    n = len(channels)
    validate_transform(n, transform)

    if transform == ColorTransform.NONE:
        # The reference's `color_no_convert` copies each component's line in
        # sequence per output row (planar-within-row layout, NOT interleaved;
        # `src/decoder.rs:1476-1484`).
        return xp.concatenate(channels, axis=1)
    if transform == ColorTransform.RGB:
        return xp.stack(channels, axis=-1)
    if transform == ColorTransform.YCBCR:
        r, g, b = ycbcr_to_rgb(channels[0], channels[1], channels[2], xp=xp)
        return xp.stack([r, g, b], axis=-1)
    if transform == ColorTransform.CMYK:
        inverted = [255 - c.astype(xp.int32) for c in channels]
        return xp.stack(inverted, axis=-1).astype(xp.uint8)
    if transform == ColorTransform.YCCK:
        r, g, b = ycbcr_to_rgb(channels[0], channels[1], channels[2], xp=xp)
        k = (255 - channels[3].astype(xp.int32)).astype(xp.uint8)
        return xp.stack([r, g, b, k], axis=-1)
    raise FormatError(f"unsupported transform {transform}")
