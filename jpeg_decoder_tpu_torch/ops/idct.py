"""IDCT stage of the port: the exact (stb int32) and fast (fp32) tiers, and
block -> plane layout.

Mirrors `jpeg_decoder_tpu/ops/idct.py`:
- `dequantize_and_idct_blocks` is the exact tier's plain version,
  `_idct8x8` / `_idct4x4` / `_idct2x2` / `_idct1x1` as torch int32 ops over
  all blocks at once, with the fixed-point constants imported from the
  host copy (`host/ops/idct.py`), not retyped.
  Bit-equal to the numpy and jnp versions: int32 `*`, `+` and `-` wrap
  modulo 2^32 on the CPU and on CUDA as they do there, `>>` is arithmetic,
  and `<< n` is written `* 2**n`, the same value mod 2^32.
  The decode paths reach it through kernel E1 (`ops/kernels.py::
  idct_exact_batch`, `csrc/idct_exact.cu`): on the card the exact tier is
  one E1 launch per image, group or stripe, and this function is E1's
  plain version, which the CPU runs and the tests hold the kernel to.
- `dequantize_and_idct_blocks_fast` runs kernel K2 (`ops/kernels.py`)
  where the reference runs `dequantize_and_idct_blocks_fast` or, on a TPU,
  the Pallas kernel; same contract: within the reftest tolerance of the
  exact integer IDCT, not bit-identical to it.
- `blocks_to_plane` is the same reshape/transpose.

The exact tier is jnp code in the reference, not a Pallas kernel, which
XLA compiles into the reconstruction; eager torch would run ~130 launches
a component, so the card runs it as the hand-written E1.
"""

from __future__ import annotations

import torch

from ..host.ops.idct import (_C0_298, _C0_541, _C0_765, _C1_175, _C1_501,
                             _C2_053, _C3_072, _CM0_390, _CM0_899, _CM1_847,
                             _CM1_961, _CM2_562, _X_SCALE_ROW)

from . import kernels


def _kernel_x(s0, s2, s4, s6, x_scale: int):
    """Even-index butterfly (reference `_kernel_x`)."""
    p1 = (s2 + s6) * _C0_541
    t2 = p1 + s6 * _CM1_847
    t3 = p1 + s2 * _C0_765
    t0 = (s0 + s4) * 4096            # << 12
    t1 = (s0 - s4) * 4096
    return t0 + t3 + x_scale, t1 + t2 + x_scale, t1 - t2 + x_scale, \
        t0 - t3 + x_scale


def _kernel_t(s1, s3, s5, s7):
    """Odd-index butterfly (reference `_kernel_t`)."""
    t0, t1, t2, t3 = s7, s5, s3, s1
    p3 = t0 + t2
    p4 = t1 + t3
    p1 = t0 + t3
    p2 = t1 + t2
    p5 = (p3 + p4) * _C1_175
    t0 = t0 * _C0_298
    t1 = t1 * _C2_053
    t2 = t2 * _C3_072
    t3 = t3 * _C1_501
    p1 = p5 + p1 * _CM0_899
    p2 = p5 + p2 * _CM2_562
    p3 = p3 * _CM1_961
    p4 = p4 * _CM0_390
    return t0 + p1 + p3, t1 + p2 + p4, t2 + p2 + p3, t3 + p1 + p4


def _butterfly_out(x, t, shift: int, dim: int):
    x0, x1, x2, x3 = x
    t0, t1, t2, t3 = t
    return torch.stack([(x0 + t3) >> shift, (x1 + t2) >> shift,
                        (x2 + t1) >> shift, (x3 + t0) >> shift,
                        (x3 - t0) >> shift, (x2 - t1) >> shift,
                        (x1 - t2) >> shift, (x0 - t3) >> shift], dim=dim)


def _clamp_u8(v):
    return v.clamp(0, 255).to(torch.uint8)


def _idct8x8(s, coeff):
    """`s`: dequantized int32 [N, 8(row), 8(col)]; `coeff` the raw ones."""
    temp = _butterfly_out(
        _kernel_x(s[:, 0], s[:, 2], s[:, 4], s[:, 6], 512),
        _kernel_t(s[:, 1], s[:, 3], s[:, 5], s[:, 7]), 10, dim=1)
    # The zero-AC-column shortcut tests the raw coefficients and differs
    # from the full path for |DC * q| >= 2^19 (reference comment, :128-136).
    col_ac_zero = (coeff[:, 1:, :] == 0).all(dim=1)          # [N, 8]
    temp = torch.where(col_ac_zero[:, None, :], (s[:, 0, :] * 4)[:, None, :],
                       temp)
    out = _butterfly_out(
        _kernel_x(temp[..., 0], temp[..., 2], temp[..., 4], temp[..., 6],
                  _X_SCALE_ROW),
        _kernel_t(temp[..., 1], temp[..., 3], temp[..., 5], temp[..., 7]),
        17, dim=-1)
    return _clamp_u8(out)


def _idct4x4(s):
    """Dugad-Ahuja 4x4; `s` int32 [N, 4, 4], the top-left coefficients."""
    s0, s1, s2, s3 = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
    x0 = (s0 + s2) * 4
    x2 = (s0 - s2) * 4
    p1 = (s1 + s3) * _C0_541
    t0 = (p1 + s3 * _CM1_847 + 512) >> 10
    t2 = (p1 + s1 * _C0_765 + 512) >> 10
    temp = torch.stack([x0 + t2, x2 + t0, x2 - t0, x0 - t2], dim=1)

    s0, s1, s2, s3 = temp[..., 0], temp[..., 1], temp[..., 2], temp[..., 3]
    bias = (1 << 16) + (128 << 17)
    x0 = (s0 + s2) * 4096 + bias
    x2 = (s0 - s2) * 4096 + bias
    p1 = (s1 + s3) * _C0_541
    t0 = p1 + s3 * _CM1_847
    t2 = p1 + s1 * _C0_765
    return _clamp_u8(torch.stack([(x0 + t2) >> 17, (x2 + t0) >> 17,
                                  (x2 - t0) >> 17, (x0 - t2) >> 17], dim=-1))


def _idct2x2(s):
    """Dugad-Ahuja 2x2; `s` int32 [N, 2, 2]."""
    bias = (1 << 2) + (128 << 3)
    x0 = s[:, 0, 0] + s[:, 1, 0] + bias
    x2 = s[:, 0, 0] - s[:, 1, 0] + bias
    x1 = s[:, 0, 1] + s[:, 1, 1]
    x3 = s[:, 0, 1] - s[:, 1, 1]
    r0 = torch.stack([(x0 + x1) >> 3, (x0 - x1) >> 3], dim=-1)
    r1 = torch.stack([(x2 + x3) >> 3, (x2 - x3) >> 3], dim=-1)
    return _clamp_u8(torch.stack([r0, r1], dim=-2))


def _idct1x1(s00):
    """DC only. Division truncates toward zero for a negative sum, as the
    reference's Wrapping<i32> division does; `>>` alone would floor."""
    v = s00 + 1024
    q = torch.where(v >= 0, v >> 3, -((-v) >> 3))
    return _clamp_u8(q)[:, None, None]


def dequantize_and_idct_blocks(coefficients, q, scale: int = 8
                               ) -> torch.Tensor:
    """Exact tier, bit-equal to the reference's `dequantize_and_idct_blocks`:
    int16 natural-order blocks, [M, 64] with the int32 [64] natural-order
    quantization table (`params.qt_exact`), or [N, M, 64] for N images with
    one table each, int32 [N, 64] -> uint8 [M, scale, scale] or [N, M,
    scale, scale]. The ops run once over all N images."""
    if q.dtype != torch.int32 or q.shape[-1] != 64 \
            or q.dim() not in (1, coefficients.dim() - 1):
        raise TypeError("q must be int32 [64] (params.qt_exact), or [N, 64] "
                        "for [N, M, 64] blocks")
    lead = coefficients.shape[:-1]
    c = coefficients.to(torch.int32)
    s = c * (q if q.dim() == 1 else q[:, None, :])   # wrapping dequantize
    c, s = c.reshape(-1, 8, 8), s.reshape(-1, 8, 8)
    if scale == 8:
        px = _idct8x8(s, c)
    elif scale == 4:
        px = _idct4x4(s[:, :4, :4])
    elif scale == 2:
        px = _idct2x2(s[:, :2, :2])
    elif scale == 1:
        px = _idct1x1(s[:, 0, 0])
    else:
        raise ValueError(f"Unsupported IDCT scale {scale}/8")
    return px.reshape(*lead, scale, scale)


def dequantize_and_idct_blocks_fast(coefficients, q, basis,
                                    scale: int = 8) -> torch.Tensor:
    """int16 [N, 64] natural-order blocks, float32 [64] dequant factors and
    the [64, 64] basis for `scale` (params.idct_basis) -> uint8
    [N, scale, scale]."""
    coef = coefficients.reshape(-1, 64)
    return kernels.dequant_idct(coef, q, basis, scale).reshape(-1, scale,
                                                           scale)


def blocks_to_plane(block_pixels: torch.Tensor, blocks_wide: int,
                    blocks_high: int) -> torch.Tensor:
    """[..., N, s, s] block pixels -> [..., blocks_high * s, blocks_wide * s]
    planes (a leading axis runs over images)."""
    *lead, n, s, _ = block_pixels.shape
    if n != blocks_wide * blocks_high:
        raise ValueError(f"{n} blocks for a {blocks_wide}x{blocks_high} grid")
    return (block_pixels.reshape(*lead, blocks_high, blocks_wide, s, s)
            .transpose(-3, -2)
            .reshape(*lead, blocks_high * s, blocks_wide * s))
