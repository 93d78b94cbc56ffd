"""Copy of `jpeg_decoder_tpu/ops/upsample.py` at commit 0c2d0ea.

Chroma upsampling, bit-exact with the reference filters, vectorized per plane.

The reference upsamples one output row at a time through per-component strategy
objects (`src/upsampler.rs:107-250`). Here each strategy is a
whole-plane array transform: the row-at-a-time structure becomes a gather of
`row_near`/`row_far` index vectors plus shifted-array arithmetic, which XLA
fuses into the color-conversion consumer. Filter taps are the reference's
exactly: (3a+b+2)>>2 for the triangle filters and (3t1+t0+8)>>4 for H2V2.
"""

from __future__ import annotations

import numpy as np

from ..errors import UnsupportedError, UnsupportedFeature

H1V1 = "h1v1"
H2V1 = "h2v1"
H1V2 = "h1v2"
H2V2 = "h2v2"
GENERIC = "generic"


def choose_upsampler(sampling_factors, max_sampling_factors, output_width: int,
                     output_height: int):
    """Pick the per-component strategy (`src/upsampler.rs:76-105`).

    Returns (mode, h_scale, v_scale); h/v scales only meaningful for GENERIC.
    Raises UnsupportedError for non-integer ratios.
    """
    h_max, v_max = max_sampling_factors
    hs, vs = sampling_factors
    h1 = hs == h_max or output_width == 1
    v1 = vs == v_max or output_height == 1
    h2 = hs * 2 == h_max
    v2 = vs * 2 == v_max

    if h1 and v1:
        return H1V1, 1, 1
    if h2 and v1:
        return H2V1, 2, 1
    if h1 and v2:
        return H1V2, 1, 2
    if h2 and v2:
        return H2V2, 2, 2
    if h_max % hs != 0 or v_max % vs != 0:
        raise UnsupportedError(UnsupportedFeature.NON_INTEGER_SUBSAMPLING_RATIO)
    return GENERIC, h_max // hs, v_max // vs


def _near_far_rows(xp, out_rows: int, input_height: int):
    """The V2 filters' vertical sample pair per output row
    (`src/upsampler.rs:174-177`): row_near = row/2 truncated;
    row_far = previous row for even rows, next row for odd rows, clamped to
    [0, input_height-1] (the f32 `as usize` saturates at 0 for row 0)."""
    rows = xp.arange(out_rows)
    near = rows // 2
    far = xp.where(rows % 2 == 0, near - 1, near + 1)
    far = xp.clip(far, 0, input_height - 1)
    return near, far


def _h2_horizontal(xp, rows_u32, input_width: int):
    """H2V1 horizontal triangle filter over [..., input_width] rows
    (`src/upsampler.rs:145-162`). Returns [..., 2*input_width]."""
    if input_width == 1:
        return xp.concatenate([rows_u32, rows_u32], axis=-1)

    sample = rows_u32 * 3 + 2
    left = xp.concatenate([rows_u32[..., :1], rows_u32[..., :-1]], axis=-1)
    right = xp.concatenate([rows_u32[..., 1:], rows_u32[..., -1:]], axis=-1)
    even = (sample + left) >> 2    # out[2i] pairs with in[i-1]
    odd = (sample + right) >> 2    # out[2i+1] pairs with in[i+1]
    out = xp.stack([even, odd], axis=-1).reshape(rows_u32.shape[:-1] + (2 * input_width,))
    # Edge samples are copied verbatim.
    out = _set_col(out, 0, rows_u32[..., 0])
    out = _set_col(out, -1, rows_u32[..., -1])
    return out


def _set_col(arr, col: int, values):
    """Backend-agnostic `arr[..., col] = values` (jax arrays are immutable)."""
    if hasattr(arr, "at") and not isinstance(arr, np.ndarray):
        return arr.at[..., col].set(values)
    arr[..., col] = values
    return arr


def h1v2_combine(xp, near_rows, far_rows):
    """V2 vertical triangle filter given pre-gathered near/far rows (uint32).
    Exposed separately so the mesh-striped path can feed halo-exchanged rows."""
    return ((3 * near_rows + far_rows + 2) >> 2).astype(xp.uint8)


def h2v2_combine(xp, near_rows, far_rows, input_width: int):
    """H2V2 filter given pre-gathered near/far rows (uint32 [..., input_width]).
    Returns uint8 [..., 2*input_width]. Taps from
    `src/upsampler.rs:215-227`."""
    t = 3 * near_rows + far_rows
    if input_width == 1:
        col = ((3 * near_rows[..., 0] + far_rows[..., 0] + 2) >> 2).astype(xp.uint8)
        return xp.stack([col, col], axis=-1)
    t_prev = xp.concatenate([t[..., :1], t[..., :-1]], axis=-1)
    even = (3 * t + t_prev + 8) >> 4         # out[2i] from (t[i], t[i-1])
    t_next = xp.concatenate([t[..., 1:], t[..., -1:]], axis=-1)
    odd = (3 * t + t_next + 8) >> 4          # out[2i+1] from (t[i], t[i+1])
    out = xp.stack([even, odd], axis=-1).reshape(t.shape[:-1] + (2 * input_width,))
    # First and last output samples use the quarter-weight edge formula.
    out = _set_col(out, 0, (t[..., 0] + 2) >> 2)
    out = _set_col(out, -1, (t[..., -1] + 2) >> 2)
    return out.astype(xp.uint8)


def upsample_component(plane, mode: str, input_width: int, input_height: int,
                       out_rows: int, out_width: int, h_scale: int = 1,
                       v_scale: int = 1, xp=np):
    """Upsample a component plane to [out_rows, out_width] uint8.

    `plane` is the uint8 IDCT output plane (stride = block grid width * scale),
    which may be wider/taller than (input_width, input_height); exactly like the
    reference's row_stride-based indexing, extra columns are read where the
    filters need look-ahead and extra rows are never touched.
    """
    p = xp.asarray(plane)

    if mode == H1V1:
        # `src/upsampler.rs:119-132`
        return p[:out_rows, :out_width]

    if mode == H2V1:
        rows = p[:out_rows, :input_width].astype(xp.uint32)
        return _h2_horizontal(xp, rows, input_width)[:, :out_width].astype(xp.uint8)

    if mode == H1V2:
        # `src/upsampler.rs:165-189`
        near_rows, far_rows = _v2_near_far(xp, p[:, :out_width], input_height,
                                           out_rows)
        return h1v2_combine(xp, near_rows, far_rows)

    if mode == H2V2:
        # `src/upsampler.rs:191-228`
        near_rows, far_rows = _v2_near_far(xp, p[:, :input_width], input_height,
                                           out_rows)
        return h2v2_combine(xp, near_rows, far_rows, input_width)[:, :out_width]

    if mode == GENERIC:
        # Nearest-neighbor integer scaling (`src/upsampler.rs:230-250`).
        in_rows = -(-out_rows // v_scale)
        rep = xp.repeat(p[:in_rows, :input_width], v_scale, axis=0)[:out_rows]
        out = xp.repeat(rep, h_scale, axis=-1)
        return out[:, :out_width]

    raise ValueError(f"unknown upsampler mode {mode}")


def _v2_near_far(xp, p, input_height: int, out_rows: int):
    """V2 vertical sample pairs as shift/interleave ops (no dynamic gathers —
    row gathers lower terribly on TPU; ~10x slower than this formulation).

    Equivalent to `_near_far_rows` + fancy indexing: output row r has
    near = in[r//2] and far = in[clip(r//2 -/+ 1, 0, ih-1)] (minus for even r,
    plus for odd r).
    """
    p2 = p[:input_height].astype(xp.uint32)
    near = xp.repeat(p2, 2, axis=0)[:out_rows]
    down = xp.concatenate([p2[:1], p2[:-1]], axis=0)   # in[i-1], clamped at 0
    up = xp.concatenate([p2[1:], p2[-1:]], axis=0)     # in[i+1], clamped at ih-1
    far = xp.stack([down, up], axis=1).reshape((2 * input_height,) + p2.shape[1:])
    return near, far[:out_rows]
