"""Reconstruction: coefficient stores -> image tensor, on the stores' device.

Port of `jpeg_decoder_tpu/ops/pipeline.py::_reconstruct` (`reconstruct`:
per component dequant + IDCT and block -> plane, then chroma upsampling
and color conversion, interleaved out) and of
`jpeg_decoder_tpu/ops/pallas_kernels.py::reconstruct_planar_pallas`
(`reconstruct_planar_pallas`: the planes, then kernel K3, planar out).
Geometry comes from `ImageGeometry` / `geometry_from_frame`, and the
planar tail's coverage rule from `pallas_tail_mode`, all in the port's
host copy (`host/ops/pipeline.py`, `host/ops/tail.py`).

The IDCT tier follows `geometry.precision` as `_reconstruct` does: "fast"
runs kernel K2 (one launch for every component), anything else the exact
int32 IDCT. The planar tail runs
K2 at either precision, as the reference's `reconstruct_planar_pallas`
runs its fp32 Pallas IDCT whatever the precision.
"""

from __future__ import annotations

import torch

from ..host.ops.tail import _TAIL_TRANSFORMS, pallas_tail_mode

from ..params import DeviceParams
from .color import color_convert_image
from .idct import blocks_to_plane, dequantize_and_idct_blocks
from .kernels import dequant_idct_multi, fused_tail
from .upsample import upsample_component


def fast_pixels(geometry, stores, qts, params: DeviceParams) -> list:
    """Kernel K2 over every component of one image, in one launch: uint8
    [N, s, s] block pixels per component."""
    comps = geometry.components
    scales = [c.dct_scale for c in comps]
    pixels = dequant_idct_multi(
        [s.reshape(-1, 64) for s in stores],
        [params.qt(qt) for qt in qts],
        [params.basis(s) for s in scales], scales,
        folded=[params.folded(qt, s) for qt, s in zip(qts, scales)])
    return [px.reshape(-1, s, s) for px, s in zip(pixels, scales)]


def _planes(geometry, stores, qts, params: DeviceParams,
            fp32: bool = False) -> list:
    """IDCT + block -> plane per component: block-padded uint8 planes. K2
    when `fp32` or at precision "fast", else the exact int32 IDCT."""
    comps = geometry.components
    if fp32 or geometry.precision == "fast":
        pixels = fast_pixels(geometry, stores, qts, params)
    else:
        pixels = [dequantize_and_idct_blocks(store, params.qt_exact(qt),
                                             comp.dct_scale)
                  for comp, store, qt in zip(comps, stores, qts)]
    return [blocks_to_plane(px, comp.blocks_wide, comp.blocks_high)
            for comp, px in zip(comps, pixels)]


def reconstruct(geometry, stores, qts, params: DeviceParams) -> torch.Tensor:
    """`stores`: int16 [blocks_high * blocks_wide, 64] per component;
    `qts`: uint16[64] natural-order numpy tables. Returns uint8 [H, W] for
    one component, else [H, W, C]."""
    planes = _planes(geometry, stores, qts, params)
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


def reconstruct_planar_pallas(geometry, stores, qts,
                              params: DeviceParams) -> torch.Tensor:
    """Planar reconstruction for the geometries `pallas_tail_mode` admits:
    uint8 [H, W] for one component ("gray", a crop), [C, H, W] for RGB
    4:4:4 ("stack") and through kernel K3 for YCbCr / CMYK / YCCK with any
    h1/h2 x v1/v2 chroma it admits ("fused"). Other geometries raise: the
    decoder sends them to layout "planar". The IDCT is K2 at either
    precision, as in the reference."""
    mode = pallas_tail_mode(geometry)
    if mode is None:
        raise ValueError("the planar tail does not cover this geometry "
                         "(pallas_tail_mode is None)")
    planes = _planes(geometry, stores, qts, params, fp32=True)
    comps = geometry.components
    out_h, out_w = geometry.out_height, geometry.out_width
    if mode == "gray":
        return planes[0][:comps[0].size_height, :comps[0].size_width]
    if mode == "stack":
        return torch.stack([p[:out_h, :out_w] for p in planes], dim=0)
    chroma_dims = next(((c.size_height, c.size_width) for c in comps
                        if c.upsampler_mode != "h1v1"), None)
    with torch.profiler.record_function("fused_tail"):
        return fused_tail(planes, tuple(c.upsampler_mode for c in comps),
                          chroma_dims,
                          _TAIL_TRANSFORMS[geometry.transform.value],
                          out_h, out_w)
