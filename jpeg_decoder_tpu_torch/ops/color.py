"""Color conversion in PyTorch, bit-exact BT.601 fixed point.

Port of `jpeg_decoder_tpu/ops/color.py::color_convert_image` with the same
x2^20 constants and rounding (imported, not recomputed) and the same
(component count, transform) validation. int32 arithmetic: the largest
intermediate, 255 * 2^20 + 2^19 + 1858077 * 127, stays below 2^31.
"""

from __future__ import annotations

import torch

from ..host.errors import FormatError
from ..host.ops.color import (_C0_344, _C0_714, _C1_402, _C1_772, _FIXED,
                              _HALF, ColorTransform, validate_transform)


def ycbcr_to_rgb(y, cb, cr):
    y = y.to(torch.int32) * (1 << _FIXED) + _HALF
    cb = cb.to(torch.int32) - 128
    cr = cr.to(torch.int32) - 128

    def clamp(v):
        return (v >> _FIXED).clamp(0, 255).to(torch.uint8)

    return (clamp(y + _C1_402 * cr), clamp(y - _C0_344 * cb - _C0_714 * cr),
            clamp(y + _C1_772 * cb))


def color_convert_image(channels: list, transform: ColorTransform):
    """uint8 [..., H, W] planes -> uint8 [..., H, W, C_out] (for NONE:
    [..., H, W * C], the reference's planar-within-row layout); a leading
    axis runs over images."""
    validate_transform(len(channels), transform)
    if transform == ColorTransform.NONE:
        return torch.cat(channels, dim=-1)
    if transform == ColorTransform.RGB:
        return torch.stack(channels, dim=-1)
    if transform == ColorTransform.YCBCR:
        return torch.stack(ycbcr_to_rgb(*channels[:3]), dim=-1)
    if transform == ColorTransform.CMYK:
        return torch.stack([255 - c.to(torch.int32) for c in channels],
                           dim=-1).to(torch.uint8)
    if transform == ColorTransform.YCCK:
        k = (255 - channels[3].to(torch.int32)).to(torch.uint8)
        return torch.stack([*ycbcr_to_rgb(*channels[:3]), k], dim=-1)
    raise FormatError(f"unsupported transform {transform}")
