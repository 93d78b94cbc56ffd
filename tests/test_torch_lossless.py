"""The port's lossless (SOF3) path against the JAX package on CPU JAX, bit
for bit:
- the closed forms (`ops/predictors.py::reconstruct_lossless_device`) vs
  the jnp `reconstruct_lossless_device` and the host oracle
  `reconstruct_lossless`, predictors 0-4, restart_all included;
- kernel L1's plain version (`lossless_recur_plain`, reached through
  `reconstruct_lossless_wavefront` on CPU tensors) vs the jnp wavefront
  and the oracle, all 8 predictors at point transforms 0, 1 and 3;
- SOF3 streams from the seeded numpy writer
  (`tools/make_torch_fixtures.py::sof3_jpeg`) at precision 8, 12 and 16,
  one and three components, through `DeviceStreamDecoder(device="cpu")`
  vs the JAX `DeviceStreamDecoder` and the host decode; Ra with a point
  transform raises the same typed FormatError in both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jpeg_decoder_tpu import Decoder
from jpeg_decoder_tpu.errors import FormatError
from jpeg_decoder_tpu.models.stream import \
    DeviceStreamDecoder as JaxStreamDecoder
from jpeg_decoder_tpu.ops import predictors as ref
from jpeg_decoder_tpu.parser import Predictor
from jpeg_decoder_tpu_torch import DeviceStreamDecoder
from jpeg_decoder_tpu_torch.host.errors import FormatError as PortFormatError
from jpeg_decoder_tpu_torch.ops import predictors as port
from tools.make_torch_fixtures import sof3_jpeg, sof3_samples

SHAPES = [(1, 1), (1, 37), (37, 1), (24, 31)]


def _diffs(shape, seed):
    """int32 differences as the staging ships them: uint16 patterns, from
    small steps and full-range values."""
    rng = np.random.default_rng(seed)
    d = rng.integers(-40, 40, shape)
    d[::3] = rng.integers(0, 65536, d[::3].shape)
    return (d & 0xFFFF).astype(np.int32)


def _oracle(d, predictor, pt, precision, restart_all=False):
    return ref.reconstruct_lossless(d, predictor, pt, precision, restart_all)


@pytest.mark.parametrize("predictor", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_closed_forms_match_jnp_and_oracle(shape, predictor):
    d = _diffs(shape, predictor * 10 + shape[1])
    p = Predictor(predictor)
    for precision in (8, 16):
        got = port.reconstruct_lossless_device(torch.from_numpy(d), p, 0,
                                               precision, False)
        assert got.dtype == torch.int32 and tuple(got.shape) == shape
        want = np.asarray(ref.reconstruct_lossless_device(
            jnp.asarray(d), p, 0, precision, False, jnp))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(),
                                      _oracle(d, p, 0, precision))


@pytest.mark.parametrize("predictor", range(8))
def test_restart_all_quirk_matches_jnp_and_oracle(predictor):
    """The stale restart flag: Ra chains anyway, every other predictor
    takes the default prediction at every sample."""
    d = _diffs((9, 13), 50 + predictor)
    p = Predictor(predictor)
    for pt in ((0,) if p == Predictor.RA else (0, 2)):
        got = port.reconstruct_planes(torch.from_numpy(d)[None], p, pt, 12,
                                      True)[0]
        want = np.asarray(ref.reconstruct_lossless_device(
            jnp.asarray(d), p, pt, 12, True, jnp))
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(),
                                      _oracle(d, p, pt, 12, True))


@pytest.mark.parametrize("pt", [0, 1, 3])
@pytest.mark.parametrize("predictor", range(8))
def test_l1_plain_matches_jnp_wavefront_and_oracle(predictor, pt):
    d = _diffs((13, 17), 100 + predictor * 4 + pt)
    p = Predictor(predictor)
    got = port.reconstruct_lossless_wavefront(torch.from_numpy(d), p, pt, 16)
    want = np.asarray(ref.reconstruct_lossless_wavefront(
        jnp.asarray(d), p, pt, 16, jnp))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _oracle(d, p, pt, 16))


def test_l1_plain_runs_components_independently():
    d = np.stack([_diffs((7, 11), s) for s in (1, 2, 3)])
    got = port.lossless_recur_plain(torch.from_numpy(d), 6, 1, 1 << 10)
    for c in range(3):
        np.testing.assert_array_equal(
            got[c].numpy(), _oracle(d[c], Predictor.RA_RB_RC_3, 1, 12))


# (h, w, components, precision, pt, predictor)
STREAMS = [
    (17, 23, 1, 8, 0, 1), (17, 23, 1, 8, 2, 6), (12, 9, 3, 8, 0, 7),
    (20, 14, 1, 12, 1, 5), (11, 16, 3, 12, 0, 4), (16, 16, 1, 12, 3, 3),
    (19, 21, 1, 16, 0, 1), (19, 21, 1, 16, 0, 6), (10, 13, 3, 16, 2, 2),
    (13, 10, 1, 16, 0, 0),
]


def _stream_id(case):
    h, w, c, prec, pt, pred = case
    return f"{h}x{w}x{c}-P{prec}-pt{pt}-sel{pred}"


@pytest.mark.parametrize("case", STREAMS, ids=_stream_id)
def test_sof3_streams_bit_equal_to_jax(case):
    h, w, ncomp, precision, pt, predictor = case
    samples = sof3_samples(h, w, ncomp, precision, pt, seed=h * w)
    data = sof3_jpeg(samples, predictor, pt, precision)
    with DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
        got = dec.decode_stream([data])[0]
    want = np.asarray(JaxStreamDecoder(host_threads=1, interchange="bits")
                      .decode_stream([data])[0])
    dtype = torch.uint8 if precision == 8 else torch.uint16
    assert got.dtype == dtype and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    stored = samples.astype(np.int64) << pt
    np.testing.assert_array_equal(got.numpy().astype(np.int64), stored)
    # The host's decode_array reshapes multi-component samples as bytes,
    # which holds at 8 bits only.
    if ncomp == 1 or precision == 8:
        np.testing.assert_array_equal(got.numpy(),
                                      Decoder(data).decode_array())


def test_ra_with_point_transform_raises_like_jax():
    data = sof3_jpeg(sof3_samples(6, 7, 1, 8, 2, seed=3), 1, 2, 8)
    with pytest.raises(FormatError, match="Ra with point transform") as ji:
        JaxStreamDecoder(host_threads=1,
                         interchange="bits").decode_stream([data])
    with DeviceStreamDecoder(device="cpu", host_threads=1) as dec:
        with pytest.raises(PortFormatError) as pi:
            dec.decode_stream([data])
    assert str(pi.value) == str(ji.value)
