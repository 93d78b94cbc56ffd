"""Copy of `jpeg_decoder_tpu/ops/pipeline.py` at commit 0c2d0ea, without
the jitted pipeline, its compile cache and the Pallas tier.

Reconstruction on the host: coefficient stores -> final image array
(dequantize + IDCT of every block of every component, chroma upsampling,
color conversion), in numpy or, in exact mode, the native library. The
port's device stage reads `ImageGeometry` and `geometry_from_frame` from
here; the host oracle decodes through `reconstruct_image`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .color import ColorTransform, color_convert_image
from .idct import blocks_to_plane, dequantize_and_idct_blocks
from .upsample import upsample_component


@dataclasses.dataclass(frozen=True)
class ComponentGeometry:
    """Static per-component reconstruction parameters."""

    blocks_wide: int
    blocks_high: int
    dct_scale: int
    size_width: int
    size_height: int
    upsampler_mode: str
    h_scale: int
    v_scale: int


@dataclasses.dataclass(frozen=True)
class ImageGeometry:
    """Static per-image reconstruction parameters (the jit cache key)."""

    components: Tuple[ComponentGeometry, ...]
    out_width: int
    out_height: int
    transform: Optional[ColorTransform]  # None for single-component crop path
    # "exact": bit-identical integer kernels (the reference's
    # platform_independent contract). "fast": fp32 MXU IDCT, within reftest
    # tolerance (the reference's default-SIMD contract).
    precision: str = "exact"


def _reconstruct(geometry: ImageGeometry, stores, qts, xp):
    """Trace the full reconstruction. `stores` are int16 [N_i, 64] per
    component, `qts` uint16[64] per component (natural order)."""
    from .idct import dequantize_and_idct_blocks_fast

    planes = []
    for comp, store, qt in zip(geometry.components, stores, qts):
        if geometry.precision == "fast":
            pixels = dequantize_and_idct_blocks_fast(
                store, qt, xp=xp, scale=comp.dct_scale)
        else:
            pixels = dequantize_and_idct_blocks(store, qt, comp.dct_scale, xp=xp)
        planes.append(blocks_to_plane(pixels, comp.blocks_wide, comp.blocks_high, xp=xp))

    if geometry.transform is None:
        comp = geometry.components[0]
        return planes[0][:comp.size_height, :comp.size_width]

    channels = [
        upsample_component(
            plane, comp.upsampler_mode,
            input_width=comp.size_width, input_height=comp.size_height,
            out_rows=geometry.out_height, out_width=geometry.out_width,
            h_scale=comp.h_scale, v_scale=comp.v_scale, xp=xp)
        for comp, plane in zip(geometry.components, planes)
    ]
    return color_convert_image(channels, geometry.transform, xp=xp)


def reconstruct_image(geometry: ImageGeometry, stores, qts):
    """Run the reconstruction pipeline on the host (numpy, or the native
    library in exact mode).
    Returns a numpy uint8 array ([H, W] or [H, W, C], or [H, W*C] for the
    raw/None transform layout).
    """
    if geometry.precision == "exact":
        native_out = _reconstruct_native_host(geometry, stores, qts)
        if native_out is not None:
            return native_out
    return _reconstruct(geometry, stores, qts, np)


def _reconstruct_native_host(geometry: ImageGeometry, stores, qts):
    """C++ host reconstruction (exact mode): scalar kernels bit-identical to
    the vectorized oracle, threaded over blocks/rows. Returns None when the
    native library is unavailable (callers fall back to numpy)."""
    from ..entropy.native import get_native
    native = get_native()
    if native is None or not hasattr(native, "idct_component"):
        return None

    planes = []
    for comp, store, qt in zip(geometry.components, stores, qts):
        store = np.ascontiguousarray(store, np.int16)
        planes.append(native.idct_component(
            store, qt, comp.blocks_wide, comp.blocks_high, comp.dct_scale))

    if geometry.transform is None:
        comp = geometry.components[0]
        return planes[0][:comp.size_height, :comp.size_width]

    # Raise the same errors the vectorized path would for invalid pairs.
    from .color import validate_transform
    validate_transform(len(planes), geometry.transform)
    tname = geometry.transform.value
    if tname not in ("None", "RGB", "YCbCr", "CMYK", "YCCK"):
        return None

    specs = [
        (comp.size_width, comp.size_height, comp.upsampler_mode,
         comp.h_scale, comp.v_scale)
        for comp in geometry.components
    ]
    return native.upsample_color(planes, specs, tname, geometry.out_width,
                                 geometry.out_height, len(planes))


def geometry_from_frame(frame, transform: Optional[ColorTransform],
                        precision: str = "exact") -> ImageGeometry:
    """Distill a parsed FrameInfo into the static geometry key."""
    from .upsample import choose_upsampler

    h_max = max(c.horizontal_sampling_factor for c in frame.components)
    v_max = max(c.vertical_sampling_factor for c in frame.components)
    out_w = frame.output_size.width
    out_h = frame.output_size.height

    comps = []
    for c in frame.components:
        if transform is None:
            mode, hs, vs = "h1v1", 1, 1
        else:
            mode, hs, vs = choose_upsampler(
                (c.horizontal_sampling_factor, c.vertical_sampling_factor),
                (h_max, v_max), out_w, out_h)
        comps.append(ComponentGeometry(
            blocks_wide=c.block_size.width,
            blocks_high=c.block_size.height,
            dct_scale=c.dct_scale,
            size_width=c.size.width,
            size_height=c.size.height,
            upsampler_mode=mode,
            h_scale=hs,
            v_scale=vs,
        ))

    return ImageGeometry(
        components=tuple(comps),
        out_width=out_w,
        out_height=out_h,
        transform=transform,
        precision=precision,
    )
