"""The port's reconstruction kernels, each beside its plain PyTorch version.

Every wrapper dispatches on the device of its inputs: CPU tensors run the
plain version, CUDA tensors launch the CUDA kernel, anything else raises.

K2 `dequant_idct_batch` (and its one-image form `dequant_idct_multi`, its
one-component form `dequant_idct`): dequantize + IDCT of coefficient
blocks, counterpart of
`jpeg_decoder_tpu/ops/pallas_kernels.py::dequantize_and_idct_blocks_pallas`
(the TPU kernel `_kernel_fn`):
    pixels = u8(clip(floor((coef * q) @ basis + 128.5), 0, 255))
in fp32, on int16 [N, 64] natural-order blocks. Scales 8/4/2/1 share one
kernel through the zero-padded [64, 64] basis (`params.idct_basis`); only
the first scale * scale pixel columns are computed. Every component of
every image of a group goes in one launch, through a table of segments
(one per component and image, neighbours that share a table merged).

Kernel `csrc/dequant_idct.cu`: tensor cores on a split-precision TF32
product of the coefficients and the basis with q folded in
(`params.folded_basis`). It and the plain version round in different
places, so they may differ by 1 where a value lands next to a .5 boundary.
`split_tf32_product` is the kernel's arithmetic in torch, for the CPU tests.

E1 `idct_exact_batch`: the exact tier's dequantize + int32 IDCT (stb
fixed point, scales 8/4/2/1) over every component of a group of images, in
one launch on the same kind of segment table as K2's. Counterpart of
`jpeg_decoder_tpu/ops/idct.py::dequantize_and_idct_blocks`, jnp code that
XLA compiles into the JAX package's reconstruction (not a Pallas kernel).
Kernel `csrc/idct_exact.cu`; wrapping int32 math, bit-equal to its plain
version, `ops/idct.py::dequantize_and_idct_blocks`.

K3 `fused_tail`: chroma upsampling + color conversion into the planar
layout, counterpart of `jpeg_decoder_tpu/ops/pallas_kernels.py::
fused_tail_pallas` (the TPU kernel `_fused_tail_kernel`), for one image or
a group of images of one geometry in one launch. Kernel
`csrc/fused_tail.cu`; integer math, bit-equal to its plain version.

T1 `interleaved_tail`: block pixels of every component -> the decoded
image (chroma upsampling, color conversion, the block -> plane layout in
its reads) for one image, a group of images of one geometry or one stripe,
in one launch. Counterpart of the jnp tail that XLA compiles into the JAX
package's reconstruction (`jpeg_decoder_tpu/ops/pipeline.py::_reconstruct`
and the stripe body of `parallel/stripes.py::build_stripe_local_recon`),
not a Pallas kernel. Kernel `csrc/interleaved_tail.cu`; integer math,
bit-equal to its plain version, `interleaved_tail_plain`.

K4 `fused_recon`: 4:4:4 YCbCr coefficient stores -> planar RGB in one
kernel (an fp32 IDCT, block -> raster, color), counterpart of the TPU probe
`tools/experiments/fused_recon_probe.py::make_kernel`. Kernel
`csrc/fused_recon.cu`; its IDCT is K2's split-TF32 product
(`csrc/idct_mma.cuh`) on the same folded bases (`fused_recon_bases`), so on
the card it is bit-equal to K2 + `blocks_to_plane` + color
(`fused_recon_plain(..., k2=dequant_idct)`), and within 3 of its plain
version (the IDCTs round in different places: 1 in the IDCT, times up to
1.772 through color).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .. import _build
from ..host.ops.color import validate_transform
from ..host.ops.upsample import GENERIC, H1V1, H1V2, H2V1, H2V2
from ..utils.timing import span
from . import idct
from .color import color_convert_image, ycbcr_to_rgb
from .upsample import (_h2_horizontal, _v2_near_far, h2v2_combine,
                       upsample_component)


K2_MAX_COMPONENTS = 4      # one image: a CMYK image
MAX_SEGMENTS = 64          # one launch's segment table (K2, E1): 16 x 4


def _check_tensor(name, t, dtype, dev) -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


def _check_coef(coef, scale: int, dev) -> None:
    """coef: int16 [..., N, 64] whose [N, 64] slabs are each contiguous (a
    leading axis runs over images), at an IDCT scale of 8/4/2/1."""
    _check_tensor("coef", coef, torch.int16, dev)
    if coef.dim() not in (2, 3) or coef.shape[-1] != 64:
        raise ValueError(f"coef must be [N, 64] or [images, N, 64], got "
                         f"{tuple(coef.shape)}")
    if coef.numel() and (coef.shape[-2] > 1 and coef.stride(-2) != 64
                         or coef.stride(-1) != 1):
        raise ValueError("each image's coefficients must be contiguous")
    if scale not in (1, 2, 4, 8):
        raise ValueError(f"unsupported IDCT scale {scale}")
    if coef.shape[:-1].numel() >= 2 ** 31 // 64:
        raise ValueError("too many blocks for one launch")


def _check_inputs(coef, q, basis, scale: int, dev=None) -> None:
    """K2's inputs: `_check_coef`, and float32 q [64] and basis [64, 64]."""
    dev = coef.device if dev is None else dev
    _check_coef(coef, scale, dev)
    for name, t in (("q", q), ("basis", basis)):
        _check_tensor(name, t, torch.float32, dev)
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.shape != (64,) or basis.shape != (64, 64):
        raise ValueError("q must be [64] and basis [64, 64]")


def dequant_idct_batch(coefs, qs, bases, scales, folded=None) -> list:
    """K2 over every component of a group of images, one launch (per
    MAX_SEGMENTS segments). Per component c: coefs[c] int16 [N, n_c, 64]
    natural-order blocks of N images (each image's [n_c, 64] slab
    contiguous; the slabs need not be adjacent), qs[c] a list of N float32
    [64] dequant factors (the images' tables may differ), bases[c] the
    float32 [64, 64] basis of scales[c], and optionally folded[c], the N
    bases with q folded in (`params.folded`; computed on the device when
    not given) -> per component uint8 [N, n_c, scales[c] ** 2].

    The segment table (`_segments`) holds one segment per (component,
    image), neighbours that share one folded basis tensor merged; the
    kernel reloads a basis only where a tile's segment changes. The plain
    version runs segment by segment, unmerged: a batched call on the CPU
    gives the per-image calls' bits."""
    if not len(coefs) == len(qs) == len(bases) == len(scales) >= 1:
        raise ValueError("one q list, basis and scale per component")
    dev = coefs[0].device
    n = coefs[0].shape[0]
    for coef, qc, basis, scale in zip(coefs, qs, bases, scales):
        if coef.dim() != 3 or coef.shape[0] != n or len(qc) != n:
            raise ValueError("coefs[c] must be [N, n_c, 64] with N tables, "
                             "one N for every component")
        for q in qc:
            _check_inputs(coef, q, basis, scale, dev)
    if folded is not None and (len(folded) != len(coefs)
                               or any(len(fc) != n for fc in folded)):
        raise ValueError("folded must hold N bases for every component")
    if dev.type == "cpu":
        return [torch.stack([dequant_idct_plain(coef[i], qc[i], basis, scale)
                             for i in range(n)])
                for coef, qc, basis, scale in zip(coefs, qs, bases, scales)]
    if dev.type != "cuda":
        raise ValueError(f"no K2 implementation for device {dev}")
    if folded is None:
        folded = [[q[:, None] * basis for q in qc]
                  for qc, basis in zip(qs, bases)]
    for f in (f for fc in folded for f in fc):
        if f.device != dev or f.dtype != torch.float32 \
                or f.shape != (64, 64) or not f.is_contiguous():
            raise ValueError("folded bases must be contiguous float32 "
                             f"[64, 64] on {dev}")
    if any(c.data_ptr() % 16 or n > 1 and c.stride(0) % 8 for c in coefs):
        raise ValueError("K2 reads coefficients in 16-byte chunks: each "
                         "store must start 16-byte aligned")
    outs = [torch.empty((n, c.shape[1], s * s), dtype=torch.uint8,
                        device=dev) for c, s in zip(coefs, scales)]
    _launch_segments("dequant_idct", _segments(coefs, folded, outs, scales),
                     dev)
    return outs


def _segments(coefs, tables, outs, scales) -> list:
    """The segment table of a batched launch (K2, E1): one segment per
    (component, image) with blocks, in that order, as [coefficient
    pointer, table tensor, output pointer, blocks, scale]. A segment merges
    into the one before it where both share one table tensor (`params`
    caches tables by content) and scale, and their coefficients and
    outputs lie back to back, so images of one encoder at one quality take
    one segment per component, as one image does."""
    segs = []
    for coef, tabs, out, scale in zip(coefs, tables, outs, scales):
        rows = coef.shape[1]
        for i in range(coef.shape[0]):
            tab = tabs[i]
            seg = [coef.data_ptr() + coef.stride(0) * 2 * i, tab,
                   out.data_ptr() + out.stride(0) * i, rows, scale]
            last = segs[-1] if segs else None
            if last is not None and last[1].data_ptr() == tab.data_ptr() \
                    and last[4] == scale \
                    and last[0] + last[3] * 128 == seg[0] \
                    and last[2] + last[3] * scale * scale == seg[2]:
                last[3] += rows
            elif rows:
                segs.append(seg)
    return segs


def _launch_segments(name: str, segs: list, dev) -> None:
    """Launch kernel `name` (`jdt_<name>`: coefficient, table and output
    pointers, block counts, scales, segments, stream) once per MAX_SEGMENTS
    segments, on `dev`'s current stream."""
    lib = _build.load()
    fn = getattr(lib, f"jdt_{name}")
    for lo in range(0, len(segs), MAX_SEGMENTS):
        part = segs[lo:lo + MAX_SEGMENTS]
        ptrs = ctypes.c_void_p * len(part)
        ints = ctypes.c_int * len(part)
        with torch.cuda.device(dev):
            err = fn(ptrs(*[s[0] for s in part]),
                     ptrs(*[s[1].data_ptr() for s in part]),
                     ptrs(*[s[2] for s in part]),
                     ints(*[s[3] for s in part]), ints(*[s[4] for s in part]),
                     len(part), torch.cuda.current_stream(dev).cuda_stream)
            _build.count_launch(name)
        _build.check(lib, err, name)


def idct_exact_batch(coefs, qts, scales) -> list:
    """E1, the exact tier's dequantize + int32 IDCT, over every component
    of a group of images: one launch (per MAX_SEGMENTS segments). Per
    component c: coefs[c] int16 [N, n_c, 64] natural-order blocks of N
    images (each image's [n_c, 64] slab contiguous; the slabs need not be
    adjacent), qts[c] a list of N int32 [64] natural-order tables
    (`params.qt_exact`) and scales[c] in 8/4/2/1 -> per component uint8
    [N, n_c, scales[c] ** 2].

    Segments as K2's (`_segments`): one per (component, image), neighbours
    that share a table tensor merged. The plain version,
    `idct.dequantize_and_idct_blocks`, runs segment by segment; the kernel
    computes every block on its own, so a batched launch gives each image
    the bits of its own."""
    if not len(coefs) == len(qts) == len(scales) >= 1:
        raise ValueError("one table list and scale per component")
    dev = coefs[0].device
    n = coefs[0].shape[0]
    for coef, qc, scale in zip(coefs, qts, scales):
        _check_coef(coef, scale, dev)
        if coef.dim() != 3 or coef.shape[0] != n or len(qc) != n:
            raise ValueError("coefs[c] must be [N, n_c, 64] with N tables, "
                             "one N for every component")
        for q in qc:
            _check_tensor("q", q, torch.int32, dev)
            if q.shape != (64,) or not q.is_contiguous():
                raise ValueError("q must be contiguous int32 [64]")
    if dev.type == "cpu":
        return [torch.stack([
                    idct.dequantize_and_idct_blocks(coef[i], qc[i], scale)
                    .reshape(-1, scale * scale) for i in range(n)])
                for coef, qc, scale in zip(coefs, qts, scales)]
    if dev.type != "cuda":
        raise ValueError(f"no E1 implementation for device {dev}")
    if any(c.data_ptr() % 16 or n > 1 and c.stride(0) % 8 for c in coefs):
        raise ValueError("E1 reads coefficients in 16-byte rows: each "
                         "store must start 16-byte aligned")
    outs = [torch.empty((n, c.shape[1], s * s), dtype=torch.uint8,
                        device=dev) for c, s in zip(coefs, scales)]
    _launch_segments("idct_exact", _segments(coefs, qts, outs, scales), dev)
    return outs


def dequant_idct_multi(coefs, qs, bases, scales, folded=None) -> list:
    """K2 over the components of one image in one launch: per component
    int16 [N_i, 64] coefficients, float32 [64] dequant factors, float32
    [64, 64] basis and its scale -> uint8 [N_i, scale_i ** 2] pixels.
    `folded[i]`, the basis with q folded in (`params.folded_basis`), is
    computed on the device when not given."""
    n = len(coefs)
    if not 1 <= n <= K2_MAX_COMPONENTS \
            or not len(qs) == len(bases) == len(scales) == n:
        raise ValueError(f"1..{K2_MAX_COMPONENTS} components, with one q, "
                         "basis and scale each")
    for coef in coefs:
        if coef.dim() != 2:
            raise ValueError(f"coef must be [N, 64], got {tuple(coef.shape)}")
    outs = dequant_idct_batch([c[None] for c in coefs], [[q] for q in qs],
                              bases, scales,
                              None if folded is None else [[f] for f in folded])
    return [o[0] for o in outs]


def dequant_idct(coef, q, basis, scale: int = 8) -> torch.Tensor:
    """int16 [N, 64] coefficients, float32 [64] dequant factors, float32
    [64, 64] basis -> uint8 [N, scale * scale] pixels: K2 on one
    component."""
    return dequant_idct_multi([coef], [q], [basis], [scale])[0]


def dequant_idct_plain(coef, q, basis, scale: int = 8) -> torch.Tensor:
    """Plain PyTorch version of K2: one fp32 matmul. On the card it must run
    in full fp32 (no TF32), as the reference runs at Precision.HIGHEST."""
    if coef.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                         or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError("the fp32 reference needs TF32 matmuls off")
    n_out = scale * scale
    y = (coef.to(torch.float32) * q) @ basis[:, :n_out]
    return torch.floor(y + 128.5).clamp_(0, 255).to(torch.uint8)


def _tf32_hi(x: torch.Tensor) -> torch.Tensor:
    """float32 -> its TF32 part: the low 13 mantissa bits cleared."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32, ties away from zero."""
    return ((x.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def split_tf32_product(coef, folded, scale: int = 8) -> torch.Tensor:
    """K2's arithmetic in torch: the coefficients (exact as hi + lo, the
    low 13 mantissa bits cleared for hi) times the folded basis split into
    TF32 hi and lo parts (each rounded to nearest), as the three products
    hi*hi + hi*lo + lo*hi summed in fp32, then K2's epilogue. Its sums run
    in another order than the tensor cores', so it models the scheme's
    error, not the kernel's bits."""
    n_out = scale * scale
    x = coef.to(torch.float32)
    x_hi = _tf32_hi(x)
    x_lo = x - x_hi
    b = folded[:, :n_out].contiguous()
    b_hi = _tf32_rna(b)
    b_lo = _tf32_rna(b - b_hi)
    y = x_hi @ b_hi + x_hi @ b_lo + x_lo @ b_hi
    return torch.floor(y + 128.5).clamp_(0, 255).to(torch.uint8)


# K3: the upsampler modes it takes and the color transforms, in the
# kernel's codes (csrc/fused_tail.cu).
TAIL_MODES = ("h1v1", "h1v2", "h2v1", "h2v2")
TAIL_TRANSFORMS = ("ycbcr", "cmyk", "ycck")
_TAIL_COMPONENTS = {"ycbcr": 3, "cmyk": 4, "ycck": 4}


def _check_tail(planes, comp_modes, chroma_dims, transform, out_h,
                out_w) -> None:
    """Reject what `fused_tail_pallas` is not defined on: the plain version
    and the kernel then read only inside the planes."""
    if transform not in TAIL_TRANSFORMS:
        raise ValueError(f"unknown tail transform {transform!r}")
    if len(planes) != _TAIL_COMPONENTS[transform] \
            or len(comp_modes) != len(planes):
        raise ValueError(f"{transform} takes {_TAIL_COMPONENTS[transform]} "
                         f"planes and modes, got {len(planes)} and "
                         f"{len(comp_modes)}")
    if any(m not in TAIL_MODES for m in comp_modes):
        raise ValueError(f"unsupported upsampler modes {comp_modes}")
    h2 = any(m.startswith("h2") for m in comp_modes)
    if h2 and "h1v2" in comp_modes:
        raise ValueError("h1v2 mixed with h2 modes (pallas_tail_mode "
                         "rejects it)")
    if out_h < 1 or out_w < 1:
        raise ValueError(f"empty output {out_h}x{out_w}")
    if chroma_dims is None:
        if any(m != "h1v1" for m in comp_modes):
            raise ValueError("subsampled modes need chroma_dims")
        hc, wc = out_h, out_w
    else:
        hc, wc = chroma_dims
    dev = planes[0].device
    lead = planes[0].shape[:-2]
    for p, m in zip(planes, comp_modes):
        if p.device != dev or p.dtype != torch.uint8 \
                or p.dim() not in (2, 3) or p.shape[:-2] != lead \
                or not p.is_contiguous():
            raise ValueError("planes must be contiguous uint8 [rows, cols], "
                             "or [images, rows, cols] with one image count, "
                             "on one device")
        rows, cols = p.shape[-2:]
        need_h = out_h if m == "h1v1" else hc
        need_w = wc if m.startswith("h2") else out_w
        covers_h = {"h1v1": True, "h2v1": hc >= out_h}.get(m, 2 * hc >= out_h)
        covers_w = 2 * wc >= out_w if m.startswith("h2") else True
        if rows < need_h or cols < need_w or min(need_h, need_w) < 1 \
                or not (covers_h and covers_w):
            raise ValueError(f"{m} plane {tuple(p.shape)} with chroma "
                             f"{hc}x{wc} does not cover {out_h}x{out_w}")
    if lead and not 1 <= lead[0] <= 65535:
        raise ValueError(f"{lead[0]} images: K3 takes 1..65535 in a launch")


def fused_tail(planes, comp_modes, chroma_dims, transform: str, out_h: int,
               out_w: int) -> torch.Tensor:
    """uint8 component planes (block-padded IDCT output, full rows),
    [rows, cols] each, or [N, rows, cols] for N images of one geometry ->
    uint8 planar [C_out, out_h, out_w], or [N, C_out, out_h, out_w] from one
    launch. `comp_modes[i]` in TAIL_MODES, `chroma_dims` = (hc, wc) shared
    by every subsampled component (None when all are h1v1), `transform` in
    TAIL_TRANSFORMS; the arguments of `fused_tail_pallas`."""
    _check_tail(planes, comp_modes, chroma_dims, transform, out_h, out_w)
    dev = planes[0].device
    if dev.type == "cpu":
        return fused_tail_plain(planes, comp_modes, chroma_dims, transform,
                                out_h, out_w)
    if dev.type != "cuda":
        raise ValueError(f"no K3 implementation for device {dev}")
    hc, wc = chroma_dims if chroma_dims is not None else (out_h, out_w)
    lead = tuple(planes[0].shape[:-2])
    out = torch.empty((*lead, len(planes), out_h, out_w), dtype=torch.uint8,
                      device=dev)
    ptrs = [p.data_ptr() for p in planes] + [0] * (4 - len(planes))
    # Per component: mode code, row pitch and image stride in bytes.
    pad = [0] * (4 - len(planes))
    meta = (ctypes.c_longlong * 12)(
        *[TAIL_MODES.index(m) for m in comp_modes], *pad,
        *[p.shape[-1] for p in planes], *pad,
        *[p.stride(0) if lead else 0 for p in planes], *pad)
    lib = _build.load()
    with torch.cuda.device(dev):
        err = lib.jdt_fused_tail(
            *ptrs, ctypes.addressof(meta), len(planes),
            TAIL_TRANSFORMS.index(transform), hc, wc, out_h, out_w,
            lead[0] if lead else 1, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.count_launch("fused_tail")
    _build.check(lib, err, "fused_tail")
    return out


def _tail_color(transform: str, chans) -> list:
    """`pallas_kernels.py::_tail_color`: int32 planes -> uint8 planes."""
    if transform == "cmyk":
        return [(255 - c).to(torch.uint8) for c in chans]
    rgb = list(ycbcr_to_rgb(*chans[:3]))
    if transform == "ycck":
        rgb.append((255 - chans[3]).to(torch.uint8))
    return rgb


def fused_tail_plain(planes, comp_modes, chroma_dims, transform: str,
                     out_h: int, out_w: int) -> torch.Tensor:
    """Plain PyTorch version of K3, after `fused_tail_pallas`: V2 near/far
    rows (`near_far`), the V2 triangle taps, the H2 taps with the
    quarter-weight edges and the column interleave (`h2taps` and the final
    stack, which `upsample.h2v2_combine` computes in one step), then
    `_tail_color`, all over the leading image axis where there is one. A
    full-resolution component's column-parity split is the identity once
    the interleave is undone, so it is read as is; the row-tile padding
    changes no value and is left out."""
    hc, wc = chroma_dims if chroma_dims is not None else (out_h, out_w)
    chans = []
    for p, m in zip(planes, comp_modes):
        if m == "h1v1":
            chans.append(p[..., :out_h, :out_w].to(torch.int32))
            continue
        if m.endswith("v2"):
            near, far = _v2_near_far(p, hc, out_h)
        else:
            near = far = p[..., :hc, :][..., :out_h, :].to(torch.int32)
        if m == "h1v2":
            chans.append((3 * near[..., :out_w] + far[..., :out_w] + 2) >> 2)
        else:
            chans.append(h2v2_combine(near[..., :wc], far[..., :wc], wc)
                         [..., :out_w].to(torch.int32))
    return torch.stack(_tail_color(transform, chans), dim=-3)


# T1: the upsampler modes and the transforms (`ColorTransform.value`, None
# for the gray crop) in the kernel's codes (csrc/interleaved_tail.cu).
T1_MODES = (H1V1, H2V1, H1V2, H2V2, GENERIC)
T1_TRANSFORMS = (None, "None", "RGB", "YCbCr", "CMYK", "YCCK")
_T1_META = 12       # int64 values per component in the kernel's table


class TailStripe(NamedTuple):
    """Where one stripe's output rows lie in the image
    (`parallel/stripes.py`): `row0` its first output row in the image, and
    per component `bases[c]`, its plane's first row in the component, and
    `halos[c]`, the (top, bottom) rows beside that plane, uint8 [N, 1,
    cols] each (`mesh.halo_rows`; zeros where the stripe has no neighbour),
    or None for a component whose mode reads no neighbour row."""
    row0: int
    bases: tuple
    halos: tuple


def _check_interleaved_tail(pixels, comps, transform, out_h: int,
                            out_w: int, stripe) -> None:
    """Reject what T1 is not defined on, so that neither the kernel nor its
    plain version reads outside the pixels or halos: every mode reads
    inside the plane's rows and columns (a stripe's V2 rows through its
    halos, its generic rows clamped), and the H2 and generic modes cover
    out_w."""
    n = len(pixels)
    if not 1 <= n <= 4 or len(comps) != n:
        raise ValueError(f"1..4 components with a geometry each, got {n} "
                         f"and {len(comps)}")
    if transform is None:
        if n != 1:
            raise ValueError("the gray crop takes one component")
    else:
        validate_transform(n, transform)
        if transform.value not in T1_TRANSFORMS:
            raise ValueError(f"T1 has no transform {transform}")
    if out_h < 1 or out_w < 1:
        raise ValueError(f"empty output {out_h}x{out_w}")
    if stripe is not None and (stripe.row0 < 0 or len(stripe.bases) != n
                               or len(stripe.halos) != n
                               or min(stripe.bases) < 0):
        raise ValueError("a stripe needs row0 >= 0 and a base >= 0 and "
                         "halos per component")
    dev = pixels[0].device
    images = pixels[0].shape[0] if pixels[0].dim() == 4 else 0
    if not 1 <= images <= 65535:
        raise ValueError(f"{images} images: T1 takes 1..65535 in a launch")
    for i, (px, comp) in enumerate(zip(pixels, comps)):
        _check_tensor("pixels", px, torch.uint8, dev)
        s = px.shape[-1]
        if px.dim() != 4 or px.shape[0] != images or px.shape[2] != s \
                or s not in (1, 2, 4, 8):
            raise ValueError("pixels must be uint8 [N, n_c, s, s], one N, "
                             f"s in 8/4/2/1; got {tuple(px.shape)}")
        if px.stride(3) != 1 or px.stride(2) != s or px.stride(1) != s * s:
            raise ValueError("each image's block pixels must be contiguous")
        bw, mode = comp.blocks_wide, comp.upsampler_mode
        if bw < 1 or px.shape[1] < bw or px.shape[1] % bw:
            raise ValueError(f"{px.shape[1]} blocks are no grid "
                             f"{bw} blocks wide")
        rows, cols = px.shape[1] // bw * s, bw * s
        if rows * cols >= 2 ** 31:
            raise ValueError("a plane of 2^31 samples or more")
        iw, ih, hs, vs = (comp.size_width, comp.size_height, comp.h_scale,
                          comp.v_scale)
        if mode not in T1_MODES or min(iw, ih, hs, vs) < 1:
            raise ValueError(f"unsupported component {comp}")
        need_rows, need_cols, covers = out_h, out_w, True
        if mode == H2V1:
            need_cols, covers = iw, out_w <= 2 * iw
        elif mode == GENERIC:
            need_rows = 1 if stripe is not None else -(-out_h // vs)
            need_cols, covers = iw, out_w <= iw * hs
        elif mode in (H1V2, H2V2):
            need_cols = out_w if mode == H1V2 else iw
            covers = mode == H1V2 or out_w <= 2 * iw
            if stripe is None:
                need_rows, covers = ih, covers and out_h <= 2 * ih
            else:
                need_rows = 1
                halo = stripe.halos[i]
                if halo is None or len(halo) != 2 or any(
                        h.device != dev or h.dtype != torch.uint8
                        or tuple(h.shape) != (images, 1, cols)
                        or h.stride(-1) != 1 for h in halo):
                    raise ValueError(f"a stripe's {mode} component needs "
                                     "(top, bottom) uint8 [N, 1, "
                                     f"{cols}] halos on {dev}")
        if rows < need_rows or cols < need_cols or not covers:
            raise ValueError(f"{mode} plane {rows}x{cols} of a {iw}x{ih} "
                             f"component does not cover {out_h}x{out_w}")


def _t1_output(pixels, transform, out_h: int, out_w: int, planar: bool):
    """T1's output tensor and its per-channel (byte offset, column stride,
    row pitch), as `interleaved_tail` documents the layouts."""
    n, images = len(pixels), pixels[0].shape[0]
    dev = pixels[0].device
    if transform is None:
        return (torch.empty((images, out_h, out_w), dtype=torch.uint8,
                            device=dev), [(0, 1, out_w)])
    if transform.value == "None":
        return (torch.empty((images, out_h, out_w * n), dtype=torch.uint8,
                            device=dev),
                [(k * out_w, 1, n * out_w) for k in range(n)])
    if planar:
        return (torch.empty((images, n, out_h, out_w), dtype=torch.uint8,
                            device=dev),
                [(k * out_h * out_w, 1, out_w) for k in range(n)])
    return (torch.empty((images, out_h, out_w, n), dtype=torch.uint8,
                        device=dev), [(k, n, n * out_w) for k in range(n)])


def interleaved_tail(pixels, comps, transform, out_h: int, out_w: int,
                     planar: bool = False, stripe: TailStripe = None
                     ) -> torch.Tensor:
    """T1: per component c, pixels[c] uint8 [N, n_c, s, s] block pixels of
    N images (each image's slab contiguous; the slabs need not be
    adjacent), comps[c] its `ComponentGeometry` (mode, blocks_wide, size,
    scales), `transform` a `ColorTransform` (None: the gray crop of one
    component) -> uint8 [N, out_h, out_w, C] ([N, out_h, out_w] gray,
    [N, out_h, out_w * C] for NONE's planar-within-row layout), or with
    `planar` [N, C, out_h, out_w] where the interleaved result has a
    channel axis. With `stripe` the output rows are rows row0.. of the
    image, read from the stripe's planes and halos. One launch on a CUDA
    tensor; the plain version on the CPU."""
    _check_interleaved_tail(pixels, comps, transform, out_h, out_w, stripe)
    dev = pixels[0].device
    with span("interleaved_tail"):
        if dev.type == "cpu":
            return interleaved_tail_plain(pixels, comps, transform, out_h,
                                          out_w, planar, stripe)
        if dev.type != "cuda":
            raise ValueError(f"no T1 implementation for device {dev}")
        n, images = len(pixels), pixels[0].shape[0]
        out, chans = _t1_output(pixels, transform, out_h, out_w, planar)
        if stripe is None:
            stripe = TailStripe(0, (0,) * n, (None,) * n)
        halos = [h for pair in stripe.halos
                 for h in (pair if pair is not None else (None, None))]
        meta = []
        for px, comp, base, top, bot in zip(pixels, comps, stripe.bases,
                                            halos[::2], halos[1::2]):
            s, bw = px.shape[-1], comp.blocks_wide
            meta += [px.stride(0), 0 if top is None else top.stride(0),
                     0 if bot is None else bot.stride(0), bw, s,
                     px.shape[1] // bw * s, comp.size_width,
                     comp.size_height, T1_MODES.index(comp.upsampler_mode),
                     comp.h_scale, comp.v_scale, base]
        out_meta = [v for ch in chans for v in ch] + [out.stride(0)]
        ptrs = ctypes.c_void_p * n
        lib = _build.load()
        with torch.cuda.device(dev):
            err = lib.jdt_interleaved_tail(
                ptrs(*[px.data_ptr() for px in pixels]),
                (ctypes.c_void_p * (2 * n))(
                    *[0 if h is None else h.data_ptr() for h in halos]),
                (ctypes.c_longlong * (_T1_META * n))(*meta), n,
                T1_TRANSFORMS.index(None if transform is None
                                    else transform.value),
                out_h, out_w, stripe.row0, images,
                out.data_ptr(),
                (ctypes.c_longlong * len(out_meta))(*out_meta),
                torch.cuda.current_stream(dev).cuda_stream)
            _build.count_launch("interleaved_tail")
        _build.check(lib, err, "interleaved_tail")
        return out


def _stripe_channel(plane, comp, rows: int, out_w: int, row0: int,
                    base: int, halo) -> torch.Tensor:
    """One component's rows row0 .. row0 + rows - 1 of the image from a
    stripe's plane [N, lp, cols] (its first row `base` in the component)
    and its halos: the stripe body of
    `jpeg_decoder_tpu/parallel/stripes.py::build_stripe_local_recon`. V2
    rows are indexed globally and read through [top; plane; bottom];
    generic rows are stripe-local."""
    mode, iw, ih = comp.upsampler_mode, comp.size_width, comp.size_height
    r_g = row0 + torch.arange(rows, device=plane.device)
    if mode == H1V1:
        return plane[..., :rows, :out_w]
    if mode == H2V1:
        return _h2_horizontal(plane[..., :rows, :iw].to(torch.int32),
                              iw)[..., :out_w].to(torch.uint8)
    if mode in (H1V2, H2V2):
        lp = plane.shape[-2]
        ext = torch.cat([halo[0], plane, halo[1]], dim=-2)
        near_g = r_g // 2
        far_g = torch.where(r_g % 2 == 0, near_g - 1,
                            near_g + 1).clamp(0, ih - 1)
        near_l = (near_g - base + 1).clamp(0, lp + 1)
        far_l = (far_g - base + 1).clamp(0, lp + 1)
        width = out_w if mode == H1V2 else iw
        near = ext[..., near_l, :width].to(torch.int32)
        far = ext[..., far_l, :width].to(torch.int32)
        if mode == H1V2:
            return ((3 * near + far + 2) >> 2).to(torch.uint8)
        return h2v2_combine(near, far, iw)[..., :out_w]
    if mode == GENERIC:     # nearest neighbour: stripe-local
        src = (r_g // comp.v_scale - base).clamp(0, plane.shape[-2] - 1)
        return plane[..., src, :iw].repeat_interleave(
            comp.h_scale, dim=-1)[..., :out_w]
    raise ValueError(f"unknown upsampler mode {mode}")


def interleaved_tail_plain(pixels, comps, transform, out_h: int, out_w: int,
                           planar: bool = False, stripe: TailStripe = None
                           ) -> torch.Tensor:
    """Plain PyTorch version of T1: `idct.blocks_to_plane` per component,
    then `upsample.upsample_component` (one image or group) or the stripe
    body (`_stripe_channel`), then `color.color_convert_image` (the gray
    crop: the one channel), and for `planar` the channel axis moved ahead
    of the rows."""
    planes = [idct.blocks_to_plane(px, c.blocks_wide,
                                   px.shape[1] // c.blocks_wide)
              for px, c in zip(pixels, comps)]
    if stripe is None:
        channels = [upsample_component(
            plane, c.upsampler_mode, input_width=c.size_width,
            input_height=c.size_height, out_rows=out_h, out_width=out_w,
            h_scale=c.h_scale, v_scale=c.v_scale)
            for c, plane in zip(comps, planes)]
    else:
        channels = [_stripe_channel(plane, c, out_h, out_w, stripe.row0,
                                    base, halo)
                    for c, plane, base, halo in zip(
                        comps, planes, stripe.bases, stripe.halos)]
    out = channels[0] if transform is None \
        else color_convert_image(channels, transform)
    if planar and out.dim() == 4:
        return out.permute(0, 3, 1, 2).contiguous()
    return out


def _check_recon(y, cb, cr, qts, basis, width: int) -> None:
    dev = y.device
    for name, t in (("y", y), ("cb", cb), ("cr", cr)):
        if t.device != dev or t.dtype != torch.int16 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int16 on {dev}")
        if t.dim() != 3 or t.shape[2] != 64 or t.shape != y.shape:
            raise ValueError("K4 takes 4:4:4 YCbCr: three [bh, bw, 64] "
                             f"stores of one shape, got {tuple(t.shape)} "
                             f"for {name} and {tuple(y.shape)} for y")
    for name, t, shape in (("qts", qts, (3, 64)), ("basis", basis, (64, 64))):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be contiguous float32 {shape}")
    bh, bw, _ = y.shape
    if not 1 <= width <= bw * 8 or bh < 1:
        raise ValueError(f"width {width} outside 1..{bw * 8}, or no blocks")


def fused_recon_bases(qts, basis) -> torch.Tensor:
    """K4's folded bases, float32 [3, 64, 64]: row c of `basis` times
    qts[i, c], the fp32 products K2's wrapper forms (`q[:, None] * basis`)
    and `params.folded_basis` computes."""
    return (qts[:, :, None] * basis).contiguous()


def fused_recon(y, cb, cr, qts, basis, width: int = None) -> torch.Tensor:
    """4:4:4 YCbCr stores, int16 [bh, bw, 64] each (natural order), float32
    [3, 64] dequant factors and the 8x8 [64, 64] basis -> uint8 planar RGB
    [3, bh * 8, width]: rows uncropped, columns cut to `width` (default
    bw * 8), as the TPU probe defines it."""
    width = y.shape[1] * 8 if width is None else width
    _check_recon(y, cb, cr, qts, basis, width)
    if y.device.type == "cpu":
        return fused_recon_plain(y, cb, cr, qts, basis, width)
    if y.device.type != "cuda":
        raise ValueError(f"no K4 implementation for device {y.device}")
    if any(s.data_ptr() % 16 for s in (y, cb, cr)):
        raise ValueError("K4 reads coefficients in 16-byte chunks: each "
                         "store must start 16-byte aligned")
    bh, bw, _ = y.shape
    bases = fused_recon_bases(qts, basis)
    out = torch.empty((3, bh * 8, width), dtype=torch.uint8, device=y.device)
    lib = _build.load()
    with torch.cuda.device(y.device):
        err = lib.jdt_fused_recon(
            y.data_ptr(), cb.data_ptr(), cr.data_ptr(), bases.data_ptr(),
            bh, bw, width, out.data_ptr(),
            torch.cuda.current_stream(y.device).cuda_stream)
        _build.count_launch("fused_recon")
    _build.check(lib, err, "fused_recon")
    return out


def fused_recon_plain(y, cb, cr, qts, basis, width: int = None,
                      k2=dequant_idct_plain) -> torch.Tensor:
    """Plain PyTorch version of K4, the probe's reference "X": per component
    `k2` (dequant + IDCT), `blocks_to_plane`, then `ycbcr_to_rgb` and a
    planar stack. `k2=dequant_idct` gives the unfused path of the decoder,
    which the kernel matches bit for bit on the card."""
    bh, bw, _ = y.shape
    width = bw * 8 if width is None else width
    planes = [idct.blocks_to_plane(k2(s.reshape(-1, 64), q, basis)
                                   .reshape(-1, 8, 8), bw, bh)[:, :width]
              for s, q in zip((y, cb, cr), qts)]
    return torch.stack(ycbcr_to_rgb(*planes), dim=0)
