"""`DeviceStreamDecoder.decode_stream(on_error=...)` of the PyTorch port
against the JAX package's, on the CPU: the stream of
tests/test_jax_backend.py::test_stream_error_isolation, a good image, a
malformed one and the good one again.

- on_error="none": the port returns [image, None, image], each image bit-equal
  to the port's own one-image decode, with the None in the slot where the
  JAX `DeviceStreamDecoder` on CPU JAX puts it;
- on_error="raise": the port raises its own JpegError (the host copy's
  class, `jpeg_decoder_tpu_torch.host.errors`, matched by class name).
Both interchanges: the failure comes from staging, which differs between
them.
"""

import numpy as np
import pytest
import torch

from jpeg_decoder_tpu.models.stream import \
    DeviceStreamDecoder as JaxStreamDecoder
from jpeg_decoder_tpu_torch import DeviceStreamDecoder
from jpeg_decoder_tpu_torch.host.errors import JpegError as PortJpegError

from torch_inputs import fixture

BAD = b"\xff\xd8 definitely not a jpeg"


def _stream():
    good = fixture("small_444.jpg")
    return good, [good, BAD, good]


@pytest.mark.parametrize("interchange", ["bits", "prefix"])
def test_on_error_none_isolates_the_malformed_item(interchange):
    good, stream = _stream()
    with DeviceStreamDecoder(device="cpu", host_threads=2,
                             interchange=interchange) as dec:
        outs = dec.decode_stream(stream, on_error="none")
        single = dec.decode_stream([good])[0]
    assert [o is None for o in outs] == [False, True, False]
    for img in (outs[0], outs[2]):
        assert img.dtype == torch.uint8
        torch.testing.assert_close(img, single, rtol=0, atol=0)
    ref = JaxStreamDecoder(host_threads=2, interchange=interchange) \
        .decode_stream(stream, on_error="none")
    assert [r is None for r in ref] == [o is None for o in outs]
    assert np.asarray(ref[0]).shape == tuple(outs[0].shape)


@pytest.mark.parametrize("interchange", ["bits", "prefix"])
def test_on_error_raise_raises_the_ports_jpeg_error(interchange):
    _good, stream = _stream()
    with DeviceStreamDecoder(device="cpu", host_threads=2,
                             interchange=interchange) as dec:
        with pytest.raises(PortJpegError) as err:
            dec.decode_stream(stream, on_error="raise")
        assert "JpegError" in [c.__name__ for c in type(err.value).__mro__]
        assert type(err.value).__module__.startswith("jpeg_decoder_tpu_torch")
        # The default is "raise"; the decoder still decodes afterwards.
        with pytest.raises(PortJpegError):
            dec.decode_stream(stream)
        assert dec.decode_stream(stream[:1])[0].dtype == torch.uint8
