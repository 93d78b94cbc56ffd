"""IDCT stage of the port: the fast (fp32) tier and block -> plane layout.

Mirrors `jpeg_decoder_tpu/ops/idct.py`:
- `dequantize_and_idct_blocks_fast` runs kernel K2 (`ops/kernels.py`)
  where the reference runs `dequantize_and_idct_blocks_fast` or, on a TPU,
  the Pallas kernel; same contract: within the reftest tolerance of the
  exact integer IDCT, not bit-identical to it.
- `blocks_to_plane` is the same reshape/transpose.

The exact stb int32 IDCT (`dequantize_and_idct_blocks`) is not ported yet.
"""

from __future__ import annotations

import torch

from . import kernels


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
    """[N, s, s] block pixels -> [blocks_high * s, blocks_wide * s] plane."""
    n, s, _ = block_pixels.shape
    if n != blocks_wide * blocks_high:
        raise ValueError(f"{n} blocks for a {blocks_wide}x{blocks_high} grid")
    return (block_pixels.reshape(blocks_high, blocks_wide, s, s)
            .transpose(1, 2)
            .reshape(blocks_high * s, blocks_wide * s))
