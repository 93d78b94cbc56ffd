"""Batched dispatch of the PyTorch port against the JAX package's
`DeviceStreamDecoder` on CPU JAX, and against the port's own one-image
decode (the building blocks and grouping rules: tests/test_torch_batch.py).

- Every layout x precision x interchange: `decode_stream(batch_size=4)`
  gives every image bit-equal to batch_size=1 (the same integer ops, and
  K2's plain version segment by segment, so the same fp32 products), and
  within the JAX decode's tolerances: pixels 3 and gray 1 at precision
  "fast" (both run an fp32 IDCT, summed in other orders), 0 at "exact"
  (planar-pallas runs the fp32 IDCT at either precision, as in the
  reference). The JAX reference is its `decode_stream(batch_size=4)` on
  the prefix interchange, whose groups run its vmapped jnp pipeline: the
  reference's two interchanges carry the same coefficient stores into the
  same reconstruction, and on the CPU its bits interchange decodes one
  image at a time through an XLA entropy engine that compiles per size,
  so one JAX decode per layout and precision serves both of the port's
  interchanges.
- Lossless groups against the JAX `decode_stream(batch_size=4)`, its
  vmapped jnp pipeline: bit-equal.
"""

import functools

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu.models.stream import \
    DeviceStreamDecoder as JaxStreamDecoder

from test_torch_batch import (_assert_bit_equal, _decode,  # noqa: F401
                              _one_torch_thread, _sof3, _stream)


@functools.lru_cache(maxsize=None)
def _jax_reference(layout: str, precision: str) -> tuple:
    return tuple(np.asarray(r) for r in JaxStreamDecoder(
        host_threads=2, layout=layout, precision=precision,
        interchange="prefix").decode_stream(_stream(), batch_size=4))


@pytest.mark.parametrize("interchange", ["bits", "prefix"])
@pytest.mark.parametrize("precision", ["fast", "exact"])
@pytest.mark.parametrize("layout", ["interleaved", "planar",
                                    "planar-pallas"])
def test_batch_bit_equal_to_batch_1_and_within_jax(layout, precision,
                                                   interchange):
    stream = _stream()
    kw = {"layout": layout, "precision": precision,
          "interchange": interchange}
    batched = _decode(stream, 4, **kw)
    _assert_bit_equal(batched, _decode(stream, 1, **kw))
    ref = _jax_reference(layout, precision)
    # planar-pallas runs the fp32 IDCT at either precision (reference).
    exact = precision == "exact" and layout != "planar-pallas"
    for img, r in zip(batched, ref):
        assert tuple(img.shape) == r.shape
        d = np.abs(img.numpy().astype(np.int32) - r.astype(np.int32)).max()
        assert d <= (0 if exact else 1 if img.dim() == 2 else 3), d


@pytest.mark.parametrize("predictor,ncomp,precision", [
    (1, 1, 16), (3, 3, 12), (6, 1, 16), (7, 3, 8)])
def test_lossless_groups_equal_jax_batch(predictor, ncomp, precision):
    stream = [_sof3(predictor, ncomp, precision, s) for s in range(5)]
    batched = _decode(stream, 4)
    _assert_bit_equal(batched, _decode(stream, 1))
    ref = JaxStreamDecoder(host_threads=2).decode_stream(stream,
                                                         batch_size=4)
    for img, r in zip(batched, ref):
        np.testing.assert_array_equal(img.to(torch.int32).numpy(),
                                      np.asarray(r).astype(np.int32))
