"""Tail modules of the PyTorch port (jpeg_decoder_tpu_torch/ops/idct.py
blocks_to_plane, ops/upsample.py, ops/color.py) against the JAX package's
numpy implementations on seeded random planes. The port takes its own
`ColorTransform` and raises its own errors (its host copy,
`jpeg_decoder_tpu_torch/host/`); the tests match them to the reference's by
name and message.

Tolerance: bit-equal — both sides are the same integer arithmetic.
"""

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu.errors import FormatError, JpegError
from jpeg_decoder_tpu.ops.color import ColorTransform
from jpeg_decoder_tpu.ops.color import color_convert_image as ref_color
from jpeg_decoder_tpu.ops.idct import blocks_to_plane as ref_b2p
from jpeg_decoder_tpu.ops.upsample import upsample_component as ref_up
from jpeg_decoder_tpu_torch.host.errors import JpegError as PortJpegError
from jpeg_decoder_tpu_torch.host.ops.color import \
    ColorTransform as PortColorTransform
from jpeg_decoder_tpu_torch.ops.color import color_convert_image
from jpeg_decoder_tpu_torch.ops.idct import blocks_to_plane
from jpeg_decoder_tpu_torch.ops.upsample import upsample_component


@pytest.mark.parametrize("s,bw,bh", [(8, 5, 3), (4, 7, 2), (2, 1, 4),
                                      (1, 9, 6)])
def test_blocks_to_plane_bit_equal(s, bw, bh):
    rng = np.random.default_rng(s * 100 + bw)
    px = rng.integers(0, 256, (bw * bh, s, s)).astype(np.uint8)
    got = blocks_to_plane(torch.from_numpy(px), bw, bh).numpy()
    np.testing.assert_array_equal(got, ref_b2p(px, bw, bh))


# (mode, input_width, input_height, out_rows, out_width, h_scale, v_scale)
UPSAMPLE_CASES = [
    ("h1v1", 37, 21, 21, 37, 1, 1),
    ("h2v1", 19, 21, 21, 37, 2, 1),
    ("h2v1", 1, 5, 5, 2, 2, 1),
    ("h1v2", 37, 11, 21, 37, 1, 2),
    ("h1v2", 9, 1, 1, 9, 1, 2),
    ("h2v2", 19, 11, 21, 37, 2, 2),
    ("h2v2", 20, 12, 24, 40, 2, 2),
    ("h2v2", 1, 3, 6, 1, 2, 2),
    ("generic", 10, 7, 21, 37, 4, 3),
    ("generic", 13, 21, 21, 37, 3, 1),
]


@pytest.mark.parametrize("case", UPSAMPLE_CASES,
                         ids=[f"{c[0]}-{c[1]}x{c[2]}" for c in UPSAMPLE_CASES])
def test_upsample_component_bit_equal(case):
    mode, iw, ih, out_rows, out_w, hs, vs = case
    rng = np.random.default_rng(iw * 31 + ih)
    # IDCT planes are block-padded: wider and taller than the component.
    plane = rng.integers(0, 256, (-(-max(ih, out_rows) // 8) * 8 + 8,
                                  -(-max(iw, out_w) // 8) * 8 + 8)
                         ).astype(np.uint8)
    got = upsample_component(torch.from_numpy(plane), mode, iw, ih, out_rows,
                             out_w, hs, vs)
    ref = ref_up(plane, mode, input_width=iw, input_height=ih,
                 out_rows=out_rows, out_width=out_w, h_scale=hs, v_scale=vs)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("transform,n", [
    (ColorTransform.YCBCR, 3), (ColorTransform.RGB, 3),
    (ColorTransform.CMYK, 4), (ColorTransform.YCCK, 4),
    (ColorTransform.NONE, 3)])
def test_color_convert_bit_equal(transform, n):
    rng = np.random.default_rng(n * 10 + len(transform.value))
    chans = [rng.integers(0, 256, (23, 41)).astype(np.uint8)
             for _ in range(n)]
    # Include the extremes of every channel.
    for c in chans:
        c[0, :4] = (0, 255, 0, 255)
    got = color_convert_image([torch.from_numpy(c) for c in chans],
                              PortColorTransform[transform.name])
    np.testing.assert_array_equal(got.numpy(), ref_color(chans, transform))


@pytest.mark.parametrize("transform,n", [
    (ColorTransform.CMYK, 3), (ColorTransform.YCBCR, 2),
    (ColorTransform.JCS_BG_YCC, 3), (ColorTransform.UNKNOWN, 3)])
def test_color_convert_rejects_like_reference(transform, n):
    chans = [np.zeros((2, 2), np.uint8)] * n
    with pytest.raises(JpegError) as ref_err:
        ref_color(chans, transform)
    with pytest.raises(PortJpegError) as port_err:
        color_convert_image([torch.from_numpy(c) for c in chans],
                            PortColorTransform[transform.name])
    assert issubclass(type(ref_err.value), (FormatError, JpegError))
    assert type(port_err.value).__name__ == type(ref_err.value).__name__
    assert str(port_err.value) == str(ref_err.value)
