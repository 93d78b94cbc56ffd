"""Chroma upsampling in PyTorch, bit-exact with the reference filters.

Port of `jpeg_decoder_tpu/ops/upsample.py::upsample_component` and its
helpers, every mode: h1v1 (copy), h2v1 and h1v2 (triangle filters,
(3a + b + 2) >> 2), h2v2 ((3 t1 + t0 + 8) >> 4 over vertical sums t) and
generic (nearest-neighbour integer scaling). Integer torch ops on int32;
the values stay below 2^12, so no step overflows. Planes are the last two
axes: a leading axis runs over the images of a batch.
"""

from __future__ import annotations

import torch

from ..host.ops.upsample import GENERIC, H1V1, H1V2, H2V1, H2V2


def _h2_horizontal(rows: torch.Tensor, input_width: int) -> torch.Tensor:
    """H2V1 horizontal filter over int32 [..., input_width] rows."""
    if input_width == 1:
        return torch.cat([rows, rows], dim=-1)
    sample = rows * 3 + 2
    left = torch.cat([rows[..., :1], rows[..., :-1]], dim=-1)
    right = torch.cat([rows[..., 1:], rows[..., -1:]], dim=-1)
    out = torch.stack([(sample + left) >> 2, (sample + right) >> 2], dim=-1)
    out = out.reshape(*rows.shape[:-1], 2 * input_width)
    out[..., 0] = rows[..., 0]            # edge samples copied verbatim
    out[..., -1] = rows[..., -1]
    return out


def _v2_near_far(p: torch.Tensor, input_height: int, out_rows: int):
    """Output row r reads near = in[r // 2] and far = in[r // 2 - 1] (even r)
    or in[r // 2 + 1] (odd r), clamped to the plane; rows are axis -2."""
    p2 = p[..., :input_height, :].to(torch.int32)
    near = p2.repeat_interleave(2, dim=-2)[..., :out_rows, :]
    down = torch.cat([p2[..., :1, :], p2[..., :-1, :]], dim=-2)
    up = torch.cat([p2[..., 1:, :], p2[..., -1:, :]], dim=-2)
    far = torch.stack([down, up], dim=-2).reshape(
        *p2.shape[:-2], 2 * input_height, p2.shape[-1])
    return near, far[..., :out_rows, :]


def h2v2_combine(near: torch.Tensor, far: torch.Tensor,
                 input_width: int) -> torch.Tensor:
    t = 3 * near + far
    if input_width == 1:
        col = ((t[..., 0] + 2) >> 2).to(torch.uint8)
        return torch.stack([col, col], dim=-1)
    t_prev = torch.cat([t[..., :1], t[..., :-1]], dim=-1)
    t_next = torch.cat([t[..., 1:], t[..., -1:]], dim=-1)
    out = torch.stack([(3 * t + t_prev + 8) >> 4, (3 * t + t_next + 8) >> 4],
                      dim=-1).reshape(*t.shape[:-1], 2 * input_width)
    out[..., 0] = (t[..., 0] + 2) >> 2
    out[..., -1] = (t[..., -1] + 2) >> 2
    return out.to(torch.uint8)


def upsample_component(plane: torch.Tensor, mode: str, input_width: int,
                       input_height: int, out_rows: int, out_width: int,
                       h_scale: int = 1, v_scale: int = 1) -> torch.Tensor:
    """Upsample uint8 component planes (block-padded IDCT output, [..., rows,
    cols]) to uint8 [..., out_rows, out_width]; see the reference for the
    row-stride semantics (look-ahead reads extra columns, never extra
    rows)."""
    p = plane
    if mode == H1V1:
        return p[..., :out_rows, :out_width]
    if mode == H2V1:
        rows = p[..., :out_rows, :input_width].to(torch.int32)
        return _h2_horizontal(rows, input_width)[..., :out_width] \
            .to(torch.uint8)
    if mode == H1V2:
        near, far = _v2_near_far(p[..., :out_width], input_height, out_rows)
        return ((3 * near + far + 2) >> 2).to(torch.uint8)
    if mode == H2V2:
        near, far = _v2_near_far(p[..., :input_width], input_height, out_rows)
        return h2v2_combine(near, far, input_width)[..., :out_width]
    if mode == GENERIC:
        in_rows = -(-out_rows // v_scale)
        rep = p[..., :in_rows, :input_width].repeat_interleave(
            v_scale, dim=-2)[..., :out_rows, :]
        return rep.repeat_interleave(h_scale, dim=-1)[..., :out_width]
    raise ValueError(f"unknown upsampler mode {mode}")
