"""Copy of the host helpers of `jpeg_decoder_tpu/ops/pallas_kernels.py`
(`:267-308`) at commit 0c2d0ea: which planar tail a geometry takes.

The Pallas kernels of that module are not copied; the port's kernel K3
(`ops/kernels.py::fused_tail`) takes their place.
"""

from __future__ import annotations

from .color import ColorTransform


_TAIL_TRANSFORMS = {"YCbCr": "ycbcr", "CMYK": "cmyk", "YCCK": "ycck"}


def pallas_tail_mode(geometry):
    """Fully-Pallas planar tail support. Returns "gray" (single component,
    crop only), "stack" (RGB / full-res raw interleave: no kernel needed,
    the planar layout is the IDCT output itself), "fused" (the
    upsample+color kernel covers it), or None (XLA fallback)."""
    comps = geometry.components
    if len(comps) == 1 and geometry.transform is None:
        return "gray"
    if geometry.transform == ColorTransform.RGB \
            and all(c.upsampler_mode == "h1v1" for c in comps):
        return "stack"
    name = getattr(geometry.transform, "value", None)
    transform = _TAIL_TRANSFORMS.get(name)
    if transform is None:
        return None
    if any(c.upsampler_mode not in ("h1v1", "h1v2", "h2v1", "h2v2")
           for c in comps):
        return None
    # All subsampled components must share one chroma geometry, and mixing
    # h2 with h1v2 would give the "full" components two different parity
    # layouts — reject to the XLA tail.
    h2 = any(c.upsampler_mode.startswith("h2") for c in comps)
    sub_dims = set()
    for c in comps:
        if c.upsampler_mode != "h1v1":
            if h2 and c.upsampler_mode == "h1v2":
                return None
            sub_dims.add((c.size_height, c.size_width))
    if len(sub_dims) > 1:
        return None
    return "fused"


def is_420_ycbcr(geometry) -> bool:
    """Back-compat predicate: any geometry the Pallas planar tail covers."""
    return pallas_tail_mode(geometry) is not None
