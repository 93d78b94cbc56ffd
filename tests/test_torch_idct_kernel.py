"""K2 module of the PyTorch port (jpeg_decoder_tpu_torch/ops/kernels.py and
ops/idct.py) against the JAX package's fast IDCT tiers and exact IDCT.

On the CPU `dequant_idct` runs the kernel's plain PyTorch version.
Tolerances:
- |diff| <= 1 against the Pallas kernel (interpret mode) and against
  `dequantize_and_idct_blocks_fast(xp=jnp)`: all three are fp32 with the
  same epilogue and sum the 64 products in different orders, which moves a
  value across a rounding boundary by at most 1;
- |diff| <= 3 against the exact integer IDCT, the repo's fast-tier
  contract, on stores decoded from real JPEGs (the exact kernel wraps
  int32 on adversarial magnitudes, so random coefficients are not a fair
  input there).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_decoder_tpu import Decoder
from jpeg_decoder_tpu.ops.idct import (dequantize_and_idct_blocks,
                                       dequantize_and_idct_blocks_fast)
from jpeg_decoder_tpu.ops.pallas_kernels import \
    dequantize_and_idct_blocks_pallas
from jpeg_decoder_tpu_torch.ops.idct import dequantize_and_idct_blocks_fast \
    as port_fast
from jpeg_decoder_tpu_torch.ops.kernels import dequant_idct
from jpeg_decoder_tpu_torch.params import idct_basis, quant_table

from torch_inputs import ENTROPY_CASES, entropy_case


def _port(dense, qt, scale):
    out = port_fast(torch.from_numpy(dense), quant_table(qt, "cpu"),
                    idct_basis(scale, "cpu"), scale=scale)
    assert out.dtype == torch.uint8
    return out.numpy()


def _diff(a, b):
    d = np.abs(a.astype(np.int32) - np.asarray(b).astype(np.int32))
    return int(d.max()), int((d > 0).sum())


@pytest.mark.parametrize("scale", [8, 4, 2, 1])
def test_k2_within_1_of_jax_fast_tiers(scale):
    rng = np.random.default_rng(40 + scale)
    dense = rng.integers(-1000, 1000, (1100, 64)).astype(np.int16)
    qt = rng.integers(1, 255, 64).astype(np.uint16)
    port = _port(dense, qt, scale)
    assert port.shape == (1100, scale, scale)
    pallas = dequantize_and_idct_blocks_pallas(
        jnp.asarray(dense), jnp.asarray(qt), interpret=True, scale=scale)
    fast = dequantize_and_idct_blocks_fast(dense, qt, xp=jnp, scale=scale)
    for name, ref in (("pallas", pallas), ("fast", fast)):
        worst, count = _diff(port, ref)
        print(f"scale {scale} vs {name}: max |diff| {worst}, "
              f"{count} of {port.size} pixels differ")
        assert worst <= 1, (name, worst, count)


@pytest.mark.parametrize("scale", [8, 4, 2, 1])
def test_k2_within_3_of_exact_on_decoded_stores(scale):
    for case in ENTROPY_CASES:
        d = Decoder(entropy_case(case), backend="numpy")
        d._decode_entropy_only()
        for store, qt in d._pending_render.values():
            blocks = store.reshape(-1, 64)
            exact = dequantize_and_idct_blocks(blocks, qt, scale)
            worst, count = _diff(_port(blocks, qt, scale), exact)
            assert worst <= 3, (case, worst, count)


def test_k2_dispatch_and_checks():
    coef = torch.zeros((5, 64), dtype=torch.int16)
    q = quant_table(np.ones(64, np.uint16), "cpu")
    basis = idct_basis(8, "cpu")
    assert dequant_idct(coef, q, basis).eq(128).all()
    with pytest.raises(TypeError):
        dequant_idct(coef.to(torch.int32), q, basis)
    with pytest.raises(ValueError):
        dequant_idct(coef[:, :32], q, basis)
    with pytest.raises(ValueError):
        dequant_idct(coef, q, basis, scale=3)
    with pytest.raises(ValueError, match="no K2 implementation"):
        dequant_idct(coef.to("meta"), q.to("meta"), basis.to("meta"))
