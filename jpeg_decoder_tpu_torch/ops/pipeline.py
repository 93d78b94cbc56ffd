"""Reconstruction: coefficient stores -> image tensor, on the stores' device.

Port of `jpeg_decoder_tpu/ops/pipeline.py::_reconstruct` for the fast
precision: per component dequant + IDCT (kernel K2) and block -> plane,
then chroma upsampling and color conversion. Geometry comes from the
reference's `ImageGeometry` / `geometry_from_frame`, reused by import.
"""

from __future__ import annotations

import torch

from ..params import DeviceParams
from .color import color_convert_image
from .idct import blocks_to_plane, dequantize_and_idct_blocks_fast
from .upsample import upsample_component


def reconstruct(geometry, stores, qts, params: DeviceParams) -> torch.Tensor:
    """`stores`: int16 [blocks_high * blocks_wide, 64] per component;
    `qts`: uint16[64] natural-order numpy tables. Returns uint8 [H, W] for
    one component, else [H, W, C]."""
    if geometry.precision != "fast":
        raise NotImplementedError(
            "precision 'exact' (the stb int32 IDCT) is not ported yet")
    planes = []
    for comp, store, qt in zip(geometry.components, stores, qts):
        pixels = dequantize_and_idct_blocks_fast(
            store, params.qt(qt), params.basis(comp.dct_scale),
            scale=comp.dct_scale)
        planes.append(blocks_to_plane(pixels, comp.blocks_wide,
                                      comp.blocks_high))
    if geometry.transform is None:
        comp = geometry.components[0]
        return planes[0][:comp.size_height, :comp.size_width]
    channels = [
        upsample_component(plane, comp.upsampler_mode,
                           input_width=comp.size_width,
                           input_height=comp.size_height,
                           out_rows=geometry.out_height,
                           out_width=geometry.out_width,
                           h_scale=comp.h_scale, v_scale=comp.v_scale)
        for comp, plane in zip(geometry.components, planes)]
    return color_convert_image(channels, geometry.transform)
