"""Reconstruction: coefficient stores -> image tensors, on the stores' device.

Port of `jpeg_decoder_tpu/ops/pipeline.py::_reconstruct` (`reconstruct`:
per component dequant + IDCT, then kernel T1, which reads the block pixels
in place and makes the upsampled, color-converted image, interleaved or
planar out) and of
`jpeg_decoder_tpu/ops/pallas_kernels.py::reconstruct_planar_pallas`
(`reconstruct_planar_pallas`: the planes, then kernel K3, planar out).
Geometry comes from `ImageGeometry` / `geometry_from_frame`, and the
planar tail's coverage rule from `pallas_tail_mode`, all in the port's
host copy (`host/ops/pipeline.py`, `host/ops/tail.py`).

Both take a group of N images of one geometry, the reference's vmapped
reconstruction (`stream.py:1012`): per component an int16 [N, n_c, 64]
store (each image's [n_c, 64] slab contiguous) and one tuple of
quantization tables per image (the same geometry does not mean the same
tables), and run every op once for the group; one image is a group of
one.

The IDCT tier follows `geometry.precision` as `_reconstruct` does: "fast"
runs kernel K2, anything else kernel E1, the exact int32 IDCT; each takes
every component of every image in one launch. The planar tail runs K2 at
either precision, as the reference's `reconstruct_planar_pallas` runs its
fp32 Pallas IDCT whatever the precision.
"""

from __future__ import annotations

import torch

from ..host.ops.tail import _TAIL_TRANSFORMS, pallas_tail_mode

from ..params import DeviceParams
from ..utils.timing import span
from .idct import blocks_to_plane
from .kernels import (dequant_idct_batch, fused_tail, idct_exact_batch,
                      interleaved_tail)


def fast_pixels_batch(geometry, stores, qts_b, params: DeviceParams) -> list:
    """Kernel K2 over every component of N images in one launch: uint8
    [N, n_c, s, s] block pixels per component."""
    scales = [c.dct_scale for c in geometry.components]
    pixels = dequant_idct_batch(
        stores,
        [[params.qt(qts[c]) for qts in qts_b] for c in range(len(scales))],
        [params.basis(s) for s in scales], scales,
        folded=[[params.folded(qts[c], s) for qts in qts_b]
                for c, s in enumerate(scales)])
    return [px.reshape(*px.shape[:2], s, s) for px, s in zip(pixels, scales)]


def fast_pixels(geometry, stores, qts, params: DeviceParams) -> list:
    """Kernel K2 over every component of one image, in one launch: uint8
    [N, s, s] block pixels per component."""
    return [px[0] for px in fast_pixels_batch(
        geometry, [s.reshape(1, -1, 64) for s in stores], [qts], params)]


def exact_pixels_batch(geometry, stores, qts_b,
                       params: DeviceParams) -> list:
    """Kernel E1, the exact int32 IDCT, over every component of N images
    in one launch: uint8 [N, n_c, s, s] block pixels per component."""
    scales = [c.dct_scale for c in geometry.components]
    pixels = idct_exact_batch(
        stores, [[params.qt_exact(qts[c]) for qts in qts_b]
                 for c in range(len(scales))], scales)
    return [px.reshape(*px.shape[:2], s, s) for px, s in zip(pixels, scales)]


def _pixels(geometry, stores, qts_b, params: DeviceParams,
            fp32: bool = False) -> list:
    """IDCT per component: uint8 [N, n_c, s, s] block pixels. K2 when
    `fp32` or at precision "fast", else E1, the exact int32 IDCT; either in
    one launch for the group."""
    if fp32 or geometry.precision == "fast":
        return fast_pixels_batch(geometry, stores, qts_b, params)
    return exact_pixels_batch(geometry, stores, qts_b, params)


def _planes(geometry, stores, qts_b, params: DeviceParams,
            fp32: bool = False) -> list:
    """IDCT + block -> plane per component: block-padded uint8 planes
    [N, rows, cols], for K3."""
    return [blocks_to_plane(px, comp.blocks_wide, comp.blocks_high)
            for comp, px in zip(geometry.components,
                                _pixels(geometry, stores, qts_b, params,
                                        fp32))]


def reconstruct(geometry, stores, qts_b, params: DeviceParams,
                planar: bool = False) -> torch.Tensor:
    """`stores`: int16 [N, blocks_high * blocks_wide, 64] per component;
    `qts_b`: per image, its uint16[64] natural-order numpy tables. Returns
    uint8 [N, H, W] for one component, [N, H, W * C] for the NONE
    transform, else [N, H, W, C], or [N, C, H, W] with `planar`: the IDCT
    (K2 or E1), then one T1 launch."""
    pixels = _pixels(geometry, stores, qts_b, params)
    out_h, out_w = geometry.out_height, geometry.out_width
    if geometry.transform is None:
        comp = geometry.components[0]
        out_h, out_w = comp.size_height, comp.size_width
    return interleaved_tail(pixels, geometry.components, geometry.transform,
                            out_h, out_w, planar=planar)


def reconstruct_planar_pallas(geometry, stores, qts_b,
                              params: DeviceParams) -> torch.Tensor:
    """Planar reconstruction of N images for the geometries
    `pallas_tail_mode` admits: uint8 [N, H, W] for one component ("gray", a
    crop), [N, C, H, W] for RGB 4:4:4 ("stack") and through one launch of
    kernel K3 for YCbCr / CMYK / YCCK with any h1/h2 x v1/v2 chroma it
    admits ("fused"). Other geometries raise: the decoder sends them to
    layout "planar". The IDCT is K2 at either precision, as in the
    reference."""
    mode = pallas_tail_mode(geometry)
    if mode is None:
        raise ValueError("the planar tail does not cover this geometry "
                         "(pallas_tail_mode is None)")
    planes = _planes(geometry, stores, qts_b, params, fp32=True)
    comps = geometry.components
    out_h, out_w = geometry.out_height, geometry.out_width
    if mode == "gray":
        return planes[0][:, :comps[0].size_height, :comps[0].size_width]
    if mode == "stack":
        return torch.stack([p[:, :out_h, :out_w] for p in planes], dim=1)
    chroma_dims = next(((c.size_height, c.size_width) for c in comps
                        if c.upsampler_mode != "h1v1"), None)
    with span("fused_tail"):
        return fused_tail(planes, tuple(c.upsampler_mode for c in comps),
                          chroma_dims,
                          _TAIL_TRANSFORMS[geometry.transform.value],
                          out_h, out_w)
