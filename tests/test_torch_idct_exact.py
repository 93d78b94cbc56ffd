"""The port's exact (stb int32) IDCT against the JAX package's
`dequantize_and_idct_blocks`, with numpy and with jnp: bit-equal at every
scale, on inputs that reach the integer corners.

- seeded adversarial magnitudes: |coef| up to 32767 times 16-bit
  quantization tables, so products and butterflies wrap modulo 2^32;
- all-zero AC columns under large DC, where the reference's shortcut
  (`idct.py:128-136`, tested on the raw coefficients) gives another value
  than the full butterfly once |DC * q| >= 2^19;
- negative DC at 1x1, where the reference truncates toward zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_decoder_tpu.ops.idct import dequantize_and_idct_blocks as ref_idct
from jpeg_decoder_tpu_torch.ops.idct import dequantize_and_idct_blocks

from torch_inputs import adversarial_blocks as _adversarial


def _port(coef, qt, scale):
    return dequantize_and_idct_blocks(
        torch.from_numpy(coef), torch.from_numpy(qt.astype(np.int32)),
        scale).numpy()


@pytest.mark.parametrize("scale", [8, 4, 2, 1])
@pytest.mark.parametrize("seed", [0, 1])
def test_exact_idct_bit_equal_to_numpy(scale, seed):
    coef, qt = _adversarial(seed)
    want = ref_idct(coef, qt, scale)
    got = _port(coef, qt, scale)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("scale", [8, 4, 2, 1])
def test_exact_idct_bit_equal_to_jnp(scale):
    coef, qt = _adversarial(10 + scale, n=300)
    want = np.asarray(ref_idct(jnp.asarray(coef), jnp.asarray(qt), scale,
                               xp=jnp))
    np.testing.assert_array_equal(_port(coef, qt, scale), want)


def test_zero_ac_column_shortcut_under_large_dc():
    """Blocks whose AC is all zero in every column but whose dequantized
    row-0 values reach past 2^19: the shortcut's `dc << 2` and the full
    path's `((dc << 12) + 512) >> 10` wrap differently there, and the port
    must take the shortcut. Every other block keeps one AC value, so its
    column runs the full butterfly."""
    rng = np.random.default_rng(5)
    n = 800
    coef = np.zeros((n, 8, 8), np.int16)
    coef[:, 0, :] = rng.integers(-32768, 32768, (n, 8))
    coef[::2, 3, 5] = rng.integers(-900, 900, n // 2)
    qt = np.ones(64, np.uint16)
    qt[:8] = rng.integers(16, 65536, 8)
    coef = coef.reshape(n, 64)
    want = ref_idct(coef, qt, 8)
    np.testing.assert_array_equal(_port(coef, qt, 8), want)

    # The inputs reach the divergence: without the shortcut the numpy
    # butterfly gives other pixels.
    import jpeg_decoder_tpu.ops.idct as ref_mod
    c = coef.astype(np.int32).reshape(-1, 8, 8)
    s = c * qt.astype(np.int32).reshape(8, 8)
    no_shortcut = ref_mod._idct8x8(np, s, np.ones_like(c))
    assert (no_shortcut != want).any(axis=(1, 2)).sum() > n // 4


def test_negative_dc_1x1_truncates_toward_zero():
    """Negative DC sums at 1x1, small and wrapped (16-bit table). The port
    keeps the reference's two-branch truncation; the clamp to 0..255 then
    gives the same byte for either rounding, which this pins too."""
    qt = np.full(64, 3, np.uint16)
    coef = np.zeros((2040 + 512, 64), np.int16)
    coef[:2040, 0] = np.arange(-2000, 40)
    coef[2040:, 0] = np.linspace(-32768, 32767, 512).astype(np.int16)
    want = ref_idct(coef, qt, 1)
    np.testing.assert_array_equal(_port(coef, qt, 1), want)
    qt[0] = 65535
    np.testing.assert_array_equal(_port(coef, qt, 1), ref_idct(coef, qt, 1))
